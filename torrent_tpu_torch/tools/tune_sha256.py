"""On-card sweep of the Hopper SHA-256 rows kernel's block size — leaf
plane.

The v2 (BEP 52) hash plane hashes 16 KiB leaf blocks, a much shorter
chain (257 compression blocks) than the SHA-1 plane's 256 KiB pieces,
one thread a row. This tool ranks builds of ``csrc/sha256.cu`` with
other rows-kernel blocks (``ops/sha256_cuda.py::KNOBS``:
``TT_SHA256_ROW_THREADS``, whole warps from 32 to 1024) by the time of
one leaf launch on the card, with ``tools/tune_sha1.py``'s discipline:
every variant built from the checkout's source (one ``nvcc`` each, all
started together) into ``build/torrent_tpu_torch/variants/``; random
leaves made and padded on the card; every variant's digests of the whole
batch bit-exact against hashlib before it is timed; ``--iters`` launches
on distinct device-resident inputs timed by CUDA events. The production
library, its wrappers and its launch counters are never touched.

Each variant prints one JSON line, ranked by time (ms a launch, leaves/s
as ``pieces_per_sec``, GB/s, the operations bound and the share of it
reached, ptxas' registers and spills, build seconds); a ``best`` line
ends the sweep with the winner's ``nvcc`` ``-D`` flag. Production keeps
the source's default (32); a change of default cites this tool's record.

Usage::

    python -m torrent_tpu_torch.tools.tune_sha256 [--block-kb 16] [--batch 32768]
        [--grid 32,64,128] [--iters 8]

There is no CPU mode: without CUDA the tool raises
``utils.device.DeviceUnavailable``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

from torrent_tpu_torch.tools.tune_sha1 import best_line, sweep

DEFAULT_GRID = "32,64,128,256"


def parse_grid(spec: str) -> list[dict]:
    """``32,64,128`` → full knob sets (``row_threads``), duplicates
    dropped. ValueError on an entry that is not a whole number of warps
    from 32 to 1024: nothing is compiled."""
    from torrent_tpu_torch.ops import sha256_cuda

    out: list[dict] = []
    for part in spec.split(","):
        part = part.strip()
        if not part.isdigit():
            raise ValueError(f"grid entry {part!r} is not a thread count")
        knobs = sha256_cuda.check_knobs(row_threads=int(part))
        if knobs not in out:
            out.append(knobs)
    return out


def run_sweep(block_kb: int, batch: int, grid: list[dict], iters: int) -> list[dict]:
    """The SHA-256 sweep at ``batch`` leaves of ``block_kb`` KiB; returns
    the ranked records (see ``tune_sha1.sweep``)."""
    from torrent_tpu_torch.ops import sha256_cuda
    from torrent_tpu_torch.ops.work import SHA256_BLOCK_OPS

    return sweep(
        sha256_cuda, grid, msg_bytes=block_kb * 1024, rows=batch, iters=iters,
        digest=hashlib.sha256, kernel="sha256_rows_kernel", seed=20261018,
        block_ops=SHA256_BLOCK_OPS,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--block-kb", type=int, default=16)
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--grid", default=DEFAULT_GRID, help="row threads,... (default %(default)s)")
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    try:
        grid = parse_grid(args.grid)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    records = run_sweep(args.block_kb, args.batch, grid, args.iters)
    for rec in records:
        print(json.dumps(rec), flush=True)
    print(json.dumps(best_line(records, block_kb=args.block_kb, batch=args.batch)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
