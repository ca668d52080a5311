"""One process of a multi-process scheduler-fed library recheck.

    python -m torrent_tpu_torch.tools.fabric_verify TORRENTS DATA [flags]

The port's ``fabric-verify`` subcommand of the reference's CLI, with the
same flags, result file and exit codes: 0 when every piece is valid, 2
when some are not (or on a usage error), ``fabric.FAULT_EXIT_CODE`` when
``--die-after-units`` ends the process. Each process runs a started
``HashPlaneScheduler`` and feeds its shard of the library through
``parallel/bulk.verify_library_fabric``. Its divergences from the
reference:

- ``--hasher gpu|cpu`` (default ``gpu``, the card; ``--device cpu`` runs
  the plain PyTorch planes) in place of ``cpu|tpu``;
- ``--init-method tcp://HOST:PORT`` and ``--backend`` (``torch.distributed``,
  which enables the all-gather heartbeat) in place of ``--coordinator``;
- no ``--cpu-devices`` (a JAX CPU-rig knob).

``--num-processes/--process-id`` WITHOUT ``--init-method`` run over the
shared-filesystem heartbeat (``--heartbeat-dir``) with no collective at
all — the mode that survives a killed worker via lapse adoption.
"""

from __future__ import annotations

import argparse
import asyncio
import glob
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    sp = argparse.ArgumentParser(
        prog="fabric_verify",
        description="one process of a multi-process scheduler-fed library recheck",
    )
    sp.add_argument("torrents", help="directory of .torrent files")
    sp.add_argument("data", help="data root (per-torrent subdir or flat)")
    sp.add_argument("--hasher", choices=("gpu", "cpu"), default="gpu",
                    help="gpu: the scheduler's device planes on --device; cpu: hashlib")
    sp.add_argument("--device", default=None,
                    help="the device planes' device (default: this rank's CUDA device; "
                    "'cpu' runs the plain PyTorch planes)")
    sp.add_argument("--batch-target", type=int, default=256,
                    help="scheduler pieces-per-launch target")
    sp.add_argument("--init-method", metavar="tcp://HOST:PORT",
                    help="torch.distributed rendezvous (enables the all-gather heartbeat)")
    sp.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend (default: nccl on CUDA, gloo on the CPU)")
    sp.add_argument("--num-processes", type=int, default=None)
    sp.add_argument("--process-id", type=int, default=None)
    sp.add_argument("--heartbeat-dir", default=None, metavar="DIR",
                    help="shared-filesystem heartbeat transport (lapse "
                    "adoption; no process group needed)")
    sp.add_argument("--heartbeat-interval", type=float, default=0.5)
    sp.add_argument("--lapse-after", type=float, default=5.0,
                    help="seconds of heartbeat silence before a peer's "
                    "units are adopted (file transport)")
    sp.add_argument("--unit-mb", type=int, default=0,
                    help="work-unit size bound in MiB (0 = default 64)")
    sp.add_argument("--result-file", default=None,
                    help="also write the JSON result line here (atomic)")
    sp.add_argument("--obs-port", type=int, default=None, metavar="PORT",
                    help="serve GET /v1/fleet + /metrics on this loopback "
                    "port while the sweep runs (0 = ephemeral)")
    sp.add_argument("--obs-port-file", default=None, metavar="FILE",
                    help="write the bound obs-server port here (atomic; "
                    "for --obs-port 0 callers)")
    sp.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="inject deterministic hash-plane faults "
                    "(sched/faults.py spec, e.g. 'latency_ms=200' to "
                    "throttle h2d, 'forge_receipts=1' to lie at the "
                    "verdict layer)")
    sp.add_argument("--byzantine-f", type=int, default=0, metavar="F",
                    help="lying processes tolerated: f+1 replicas verify "
                    "each unit, verdicts carry Merkle receipt roots, "
                    "claims are audit-sampled, coverage needs f+1 "
                    "matching receipts (0 = trusted fast path)")
    sp.add_argument("--audit-rate", type=float, default=0.05,
                    help="per-(peer,unit,piece,round) audit probability "
                    "at --byzantine-f > 0 (deterministic given the plan "
                    "fingerprint + --audit-seed)")
    sp.add_argument("--audit-seed", type=int, default=0,
                    help="audit-sampling seed (same seed = bit-identical "
                    "audit schedule)")
    # deterministic worker-death injection for tests
    sp.add_argument("--die-after-units", type=int, default=None,
                    help=argparse.SUPPRESS)
    return sp


async def fabric_verify(args) -> int:
    """One process of the sweep; returns the exit code."""
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.storage.storage import FsStorage, Storage

    nproc, pid = args.num_processes, args.process_id
    if (nproc is None) != (pid is None):
        print("error: --num-processes and --process-id go together", file=sys.stderr)
        return 2
    if args.init_method:
        if nproc is None:
            print("error: --init-method needs --num-processes and --process-id", file=sys.stderr)
            return 2
        from torrent_tpu_torch.parallel.distributed import initialize

        # the group's tensors live where the planes do: gloo on the host
        group_device = args.device if args.hasher == "gpu" else "cpu"
        initialize(args.init_method, nproc, pid, backend=args.backend, device=group_device)
    if nproc is not None and nproc > 1 and not (args.init_method or args.heartbeat_dir):
        print(
            "error: multi-process fabric needs a transport: --init-method "
            "(torch.distributed all-gather) or --heartbeat-dir (shared "
            "filesystem)",
            file=sys.stderr,
        )
        return 2
    if args.die_after_units is not None and not args.heartbeat_dir:
        print("error: --die-after-units needs --heartbeat-dir (file transport)", file=sys.stderr)
        return 2

    torrent_files = sorted(glob.glob(os.path.join(args.torrents, "*.torrent")))
    if not torrent_files:
        print(f"error: no .torrent files in {args.torrents!r}", file=sys.stderr)
        return 1
    items = []
    for tf in torrent_files:
        with open(tf, "rb") as f:
            meta = parse_metainfo(f.read())
        if meta is None:
            print(f"skipping {tf}: not a v1 .torrent (fabric is sha1-plane)", file=sys.stderr)
            continue
        stem = os.path.splitext(os.path.basename(tf))[0]
        root = os.path.join(args.data, stem)
        if not os.path.isdir(root):
            root = args.data
        items.append((Storage(FsStorage(root), meta.info), meta.info))
    if not items:
        print("error: nothing to verify", file=sys.stderr)
        return 1

    from torrent_tpu_torch.fabric import FabricConfig
    from torrent_tpu_torch.obs.attrib import attribute
    from torrent_tpu_torch.obs.ledger import pipeline_ledger
    from torrent_tpu_torch.parallel.bulk import verify_library_fabric
    from torrent_tpu_torch.sched import FaultPlan, HashPlaneScheduler, SchedulerConfig

    plane_factory = None
    forge_receipts = False
    if args.fault_plan:
        try:
            fault_plan = FaultPlan.parse(args.fault_plan)
            forge_receipts = fault_plan.forge_receipts
            plane_factory = fault_plan.plane_factory(hasher=args.hasher, device=args.device)
        except ValueError as e:
            print(f"error: bad --fault-plan: {e}", file=sys.stderr)
            return 2
    sched = await HashPlaneScheduler(
        SchedulerConfig(batch_target=args.batch_target, plane_factory=plane_factory),
        hasher=args.hasher,
        device=args.device,
    ).start()
    cfg = FabricConfig(
        heartbeat_interval=args.heartbeat_interval,
        lapse_after=args.lapse_after,
        fault_exit_after_units=args.die_after_units,
        byzantine_f=args.byzantine_f,
        audit_rate=args.audit_rate,
        audit_seed=args.audit_seed,
        forge_receipts=forge_receipts,
    )
    executors: list = []
    obs_server = None
    if args.obs_port is not None:
        from torrent_tpu_torch.obs.fleet import FleetObsServer

        obs_server = await FleetObsServer(
            lambda: executors[0] if executors else None, sched
        ).start(args.obs_port)
        print(f"obs server on 127.0.0.1:{obs_server.port}", file=sys.stderr)
        if args.obs_port_file:
            tmp = args.obs_port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(obs_server.port))
            os.replace(tmp, args.obs_port_file)
    led_prev = pipeline_ledger().snapshot()
    try:
        res = await verify_library_fabric(
            items,
            sched,
            nproc=nproc,
            pid=pid,
            heartbeat_dir=args.heartbeat_dir,
            fabric_config=cfg,
            unit_bytes=(args.unit_mb << 20) if args.unit_mb else None,
            executor_out=executors,
        )
    finally:
        if obs_server is not None:
            obs_server.close()
        await sched.close()
    led_rep = attribute(pipeline_ledger().snapshot(), prev=led_prev)
    snap = executors[0].metrics_snapshot()
    payload = {
        "pid": snap["pid"],
        "nproc": snap["nproc"],
        "plan": snap["plan_fingerprint"],
        "bitfields": ["".join("1" if b else "0" for b in bf) for bf in res.bitfields],
        "n_valid": int(sum(bf.sum() for bf in res.bitfields)),
        "n_pieces": res.n_pieces,
        "shard_units": snap["shard_units"],
        "shard_bytes": snap["shard_bytes"],
        "units_done": snap["units_done"],
        "units_adopted": snap["units_adopted"],
        "pieces_verified": snap["pieces_verified"],
        "sentinel_checks": snap["sentinel_checks"],
        "sentinel_mismatches": snap["sentinel_mismatches"],
        "byzantine_f": snap["byzantine_f"],
        "quorum_need": snap["quorum_need"],
        "audit_checks": snap["audit_checks"],
        "audit_mismatches": snap["audit_mismatches"],
        "convictions": snap["convictions"],
        "distrusted": snap["distrusted"],
        "stragglers": snap["stragglers"],
        "seconds": res.seconds,
        # this process's pipeline-ledger breakdown and its final view of
        # the fleet — which peer limited the sweep, and which stage in it
        "ledger": {
            "wall_s": led_rep["wall_s"],
            "stages": led_rep["stages"],
            "bottleneck": led_rep["bottleneck"],
            "overlap": led_rep.get("overlap"),
        },
        "fleet": executors[0].fleet_snapshot(),
        "sched": {
            k: sched.metrics_snapshot()[k]
            for k in ("launches", "cpu_fallback_launches", "launch_failures")
        },
    }
    line = json.dumps(payload)
    if args.result_file:
        # atomic: a process group's transport may log to stdout
        # concurrently and garble a printed line
        tmp = args.result_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(line)
        os.replace(tmp, args.result_file)
    print(line)
    return 0 if payload["n_valid"] == payload["n_pieces"] else 2


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return asyncio.run(fabric_verify(args))
    finally:
        from torrent_tpu_torch.parallel.distributed import shutdown

        shutdown()


if __name__ == "__main__":
    sys.exit(main())
