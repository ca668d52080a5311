"""``python -m torrent_tpu_torch.bridge``: the bridge's command line.

The reference's bridge ``main`` with the same flags and exit codes,
except ``--hasher gpu|cpu`` (default gpu, the card), ``--device``, and
no ``--sha256-backend`` (the device alone picks the sha256 plane). A
host without CUDA fails at start-up under the defaults; pass
``--device cpu`` for the plain PyTorch planes or ``--hasher cpu`` for
hashlib. ``--fault-plan`` needs ``--dev`` or ``TORRENT_TPU_DEV=1``.
"""

from __future__ import annotations

import asyncio

from torrent_tpu_torch.bridge.service import __doc__ as _service_doc
from torrent_tpu_torch.bridge.service import serve_bridge
from torrent_tpu_torch.sched import FaultPlan


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m torrent_tpu_torch.bridge", description=_service_doc
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8421)
    parser.add_argument(
        "--hasher", choices=("gpu", "cpu"), default="gpu",
        help="gpu: the CUDA kernels on --device; cpu: hashlib "
        "(default %(default)s)",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device for --hasher gpu: cuda (the default; a host "
        "without CUDA fails at start-up), cuda:N, or cpu for the plain "
        "PyTorch planes",
    )
    parser.add_argument(
        "--batch-target", type=int, default=256,
        help="pieces per device launch the scheduler aims to fill",
    )
    parser.add_argument(
        "--flush-deadline-ms", type=float, default=20.0,
        help="max ms a lone queued piece waits before a partial flush",
    )
    parser.add_argument(
        "--max-queue-mb", type=int, default=256,
        help="global admission bound on queued piece bytes (429 beyond)",
    )
    parser.add_argument(
        "--tenant-max-mb", type=int, default=128,
        help="per-tenant admission bound on queued piece bytes",
    )
    parser.add_argument(
        "--autopilot", action="store_true",
        help="arm the scheduler autopilot (sched/control.py): adaptive "
        "lane batch targets/flush deadlines, admission budgets that "
        "follow the limiting stage, and hysteresis-guarded backend "
        "steering, driven by the pipeline ledger's attribution. "
        "GET /v1/control serves the decisions either way",
    )
    parser.add_argument(
        "--autopilot-interval", type=float, default=1.0, metavar="S",
        help="seconds between controller decisions (default %(default)s)",
    )
    parser.add_argument(
        "--slo", nargs="?", const=True, default=None, metavar="SPEC",
        help="arm the timeline sampler + SLO engine (obs/timeline, "
        "obs/slo): declarative objectives evaluated over a bounded "
        "sample ring, e.g. 'availability=0.999;p99_ms=50:queue_wait;"
        "floor_mibps=10;integrity=on' (no SPEC = the default "
        "availability+integrity contract). Serves GET /v1/timeline, "
        "/v1/slo and torrent_tpu_slo_*//timeline_* metrics; "
        "/v1/health reflects breaches either way",
    )
    parser.add_argument(
        "--timeline-interval", type=float, default=1.0, metavar="S",
        help="seconds between timeline samples when --slo is armed "
        "(default %(default)s)",
    )
    parser.add_argument(
        "--fault-plan", default=None, metavar="SPEC",
        help="inject deterministic hash-plane faults (sched/faults.py spec, "
        "e.g. 'fail_first=3;latency_ms=5'); dev/test mode only",
    )
    parser.add_argument(
        "--dev", action="store_true",
        help="dev/test mode: unlocks chaos knobs like --fault-plan",
    )
    args = parser.parse_args(argv)

    fault_plan = None
    if args.fault_plan:
        # chaos knobs must not leak into production invocations: require
        # an explicit dev-mode opt-in (flag or env), and fail closed
        import os
        import sys

        if not (args.dev or os.environ.get("TORRENT_TPU_DEV", "") in ("1", "true")):
            print(
                "error: --fault-plan is a dev/test chaos knob; pass --dev "
                "or set TORRENT_TPU_DEV=1 to use it",
                file=sys.stderr,
            )
            return 2
        try:
            fault_plan = FaultPlan.parse(args.fault_plan)
        except ValueError as e:
            print(f"error: bad --fault-plan: {e}", file=sys.stderr)
            return 2

    autopilot = None
    if args.autopilot:
        from torrent_tpu_torch.sched.control import ControlConfig

        autopilot = ControlConfig(interval_s=args.autopilot_interval)

    async def go():
        server = await serve_bridge(
            args.host,
            args.port,
            args.hasher,
            device=args.device,
            batch_target=args.batch_target,
            flush_deadline_ms=args.flush_deadline_ms,
            max_queue_mb=args.max_queue_mb,
            tenant_max_mb=args.tenant_max_mb,
            fault_plan=fault_plan,
            autopilot=autopilot,
            slo=args.slo,
            timeline_interval_s=args.timeline_interval,
        )
        print(f"bridge listening on {args.host}:{server.port}")
        await server.wait_closed()

    asyncio.run(go())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
