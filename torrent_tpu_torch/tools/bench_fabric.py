"""Fabric scaling measurement: spawn N fabric-verify worker processes over
the shared-directory heartbeat transport against one synthetic library
and report wall-clock GiB/s. One JSON line per run on stdout: {"nproc",
"rep", "seconds", "gib_per_sec", "pieces", "valid", "plan", "hasher",
"per_process", "fleet_bottleneck"}.

    python -m torrent_tpu_torch.tools.bench_fabric --workdir DIR --nproc 2 \\
        [--reps 3] [--torrents 8] [--mb-per-torrent 64] [--piece-kb 1024] \\
        [--hasher gpu|cpu] [--device DEV] [--batch-target 256]

``per_process`` embeds every worker's pipeline-ledger breakdown (stage
busy/bytes/utilization, bottleneck verdict, overlap) straight from its
result record, and ``fleet_bottleneck`` is worker 0's two-level fleet
verdict (limiting process → its limiting stage).

The library is built once (deterministic seed, authored with hashlib)
and reused across runs; each run gets a fresh heartbeat dir. Workers are
plain OS processes running ``python -m torrent_tpu_torch fabric-verify``
with no process group. ``--hasher gpu`` (the default) hashes on
``--device`` (default the card, every worker sharing it; resolved before
the library is built, so a host without CUDA raises
``utils.device.DeviceUnavailable`` and starts no worker), ``cpu`` with
hashlib.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

# the directory that holds the package: workers import it from there
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_library(root: str, n_torrents: int, mb_per: int, piece_kb: int):
    from torrent_tpu_torch.tools.make_torrent import make_torrent

    tdir = os.path.join(root, "torrents")
    ddir = os.path.join(root, "data")
    if glob.glob(os.path.join(tdir, "*.torrent")):
        return tdir, ddir  # reuse the previously built library
    os.makedirs(tdir, exist_ok=True)
    rng = np.random.default_rng(5)
    plen = piece_kb << 10
    for t in range(n_torrents):
        droot = os.path.join(ddir, f"fab{t}")
        os.makedirs(droot, exist_ok=True)
        payload = os.path.join(droot, "payload.bin")
        size = (mb_per << 20) + (t + 1) * (plen // 3)  # ragged tails differ
        with open(payload, "wb") as f:
            # chunked writes keep resident memory bounded
            left = size
            while left > 0:
                n = min(left, 64 << 20)
                f.write(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
                left -= n
        with open(os.path.join(tdir, f"fab{t}.torrent"), "wb") as f:
            f.write(
                make_torrent(
                    payload, "http://bench.invalid/announce", piece_length=plen, hasher="cpu"
                )
            )
    return tdir, ddir


def run_once(tdir, ddir, hb, nproc, hasher, batch_target, device=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    extra = ["--device", device] if device else []
    t0 = time.perf_counter()
    workers = [
        subprocess.Popen(
            [
                sys.executable, "-m", "torrent_tpu_torch", "fabric-verify",
                tdir, ddir, "--hasher", hasher, *extra,
                "--num-processes", str(nproc), "--process-id", str(p),
                "--heartbeat-dir", hb, "--batch-target", str(batch_target),
                "--result-file", os.path.join(hb, f"result_{p}.json"),
            ],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        )
        for p in range(nproc)
    ]
    try:
        for p, w in enumerate(workers):
            _, err = w.communicate(timeout=3600)
            if w.returncode != 0:
                raise RuntimeError(f"worker {p} rc={w.returncode}: {err[-1500:]}")
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.communicate()
    seconds = time.perf_counter() - t0
    with open(os.path.join(hb, "result_0.json")) as f:
        rec = json.load(f)
    if rec["n_valid"] != rec["n_pieces"]:
        raise RuntimeError(f"incomplete verify: {rec['n_valid']}/{rec['n_pieces']}")
    # per-process ledger/overlap breakdowns: every worker's result file
    # embeds its own attribution report (fabric-verify writes it)
    per_process = []
    for p in range(nproc):
        if p == 0:
            wrec = rec  # already loaded (and rate-checked) above
        else:
            try:
                with open(os.path.join(hb, f"result_{p}.json")) as f:
                    wrec = json.load(f)
            except (OSError, ValueError):
                continue
        led = wrec.get("ledger") or {}
        per_process.append(
            {
                "pid": wrec.get("pid", p),
                "pieces_verified": wrec.get("pieces_verified"),
                "units_done": wrec.get("units_done"),
                "units_adopted": wrec.get("units_adopted"),
                "wall_s": led.get("wall_s"),
                "stages": led.get("stages"),
                "bottleneck": led.get("bottleneck"),
                "overlap": led.get("overlap"),
            }
        )
    rec["per_process"] = per_process
    return seconds, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True, help="library + heartbeat scratch")
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--torrents", type=int, default=8)
    ap.add_argument("--mb-per-torrent", type=int, default=64)
    ap.add_argument("--piece-kb", type=int, default=1024)
    ap.add_argument("--hasher", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--device", default=None,
                    help="torch device of --hasher gpu (default: cuda)")
    ap.add_argument("--batch-target", type=int, default=256)
    args = ap.parse_args(argv)
    if args.hasher == "gpu":
        from torrent_tpu_torch.utils.device import resolve_device

        resolve_device(args.device)  # the card, or DeviceUnavailable

    tdir, ddir = build_library(
        args.workdir, args.torrents, args.mb_per_torrent, args.piece_kb
    )
    total_bytes = sum(
        os.path.getsize(p)
        for p in glob.glob(os.path.join(ddir, "*", "payload.bin"))
    )
    for rep in range(args.reps):
        hb = os.path.join(args.workdir, f"hb_{args.nproc}_{rep}")
        os.makedirs(hb, exist_ok=True)
        seconds, rec = run_once(
            tdir, ddir, hb, args.nproc, args.hasher, args.batch_target, args.device
        )
        fleet = rec.get("fleet") or {}
        print(
            json.dumps(
                {
                    "nproc": args.nproc,
                    "rep": rep,
                    "seconds": round(seconds, 3),
                    "gib_per_sec": round(total_bytes / seconds / 2**30, 4),
                    "pieces": rec["n_pieces"],
                    "valid": rec["n_valid"],
                    "plan": rec["plan"],
                    "hasher": args.hasher,
                    "per_process": rec.get("per_process", []),
                    "fleet_bottleneck": fleet.get("bottleneck"),
                }
            ),
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
