"""On-card sweep of the Hopper SHA-1 kernel's launch-design knobs.

Ranks builds of ``csrc/sha1.cu`` with other compile-time knobs
(``ops/sha1_cuda.py::KNOBS``: the stages of the W+K ring, the stages of
each schedule warp's raw ring, and the schedule warps per 32 pieces) by
the time of one launch on the card:

- **Every variant is built from the checkout's source**, one ``nvcc``
  each, all started together, into ``build/torrent_tpu_torch/variants/``
  (``load_variant``). A combination that the source's static_asserts
  would refuse (a W+K stage with two producers, shared memory over
  232,448 bytes) is rejected before ``nvcc`` runs. The production
  library, its wrapper and its launch counter are never touched.
- **Data lives on the card.** The batch is random words made on the
  card (host-order ``int32`` rows, the form the verifier uploads),
  padded as ``ops/padding.py`` pads them.
- **Bit-exact before timed.** Every variant's digests of the whole batch
  are held against hashlib, row by row, before its time is taken; a
  mismatch, a failed build or a failed launch fails the tool.
- **Every timed launch is distinct.** ``--iters`` launches on
  device-resident copies of the batch, each with its own salt XORed into
  the message words, timed by CUDA events after a warm-up launch.

Each variant prints one JSON line, ranked by time: its knobs and ``-D``
flags, ms a launch, pieces/s, GB/s, the operations bound (the integer
instructions of a 64-byte block over the peak rate, ``ops/work.py``) and the
share of it the launch reaches, its registers, spills and static shared
memory from ptxas, its dynamic shared memory, and its build seconds. A
``best`` line ends the sweep with the winner's ``nvcc`` ``-D`` flags.
Production keeps the source's defaults; a change of default cites this
tool's record.

Usage::

    python -m torrent_tpu_torch.tools.tune_sha1 [--piece-kb 256] [--batch 4096]
        [--grid 4.3.2,2.2.2,8.3.2] [--iters 8]

A grid entry is ``wk.raw.sched``. There is no CPU mode: without CUDA the
tool raises ``utils.device.DeviceUnavailable``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

DEFAULT_GRID = "4.3.2,2.2.2,8.3.2,4.2.2,8.4.4"
# device memory the distinct timed inputs may take together
DISTINCT_BYTES = 16 << 30


def parse_grid(spec: str) -> list[dict]:
    """``4.3.2,2.2.2`` → full knob sets (``wk_stages``, ``raw_stages``,
    ``schedule_warps``), duplicates dropped. ValueError on an entry that
    is not ``wk.raw.sched`` or that the kernel would refuse: nothing is
    compiled."""
    from torrent_tpu_torch.ops import sha1_cuda

    out: list[dict] = []
    for part in spec.split(","):
        fields = part.strip().split(".")
        if len(fields) != 3 or not all(f.isdigit() for f in fields):
            raise ValueError(f"grid entry {part!r} is not wk.raw.sched")
        wk, raw, sched = (int(f) for f in fields)
        knobs = sha1_cuda.check_knobs(wk_stages=wk, raw_stages=raw, schedule_warps=sched)
        if knobs not in out:
            out.append(knobs)
    return out


def pad_words(msg_bytes: int) -> tuple[np.ndarray, int]:
    """The padding after a message of exactly ``msg_bytes`` bytes (a
    multiple of 64), out to ``ops/padding.py``'s padded row, as host-order
    ``int32`` words; and the message's block count. SHA-1 and SHA-256 pad
    alike: 0x80, zeros, the 64-bit big-endian bit length."""
    from torrent_tpu_torch.ops.padding import num_blocks_for, padded_len_for

    if msg_bytes % 64:
        raise ValueError(f"message length {msg_bytes} is not a multiple of 64")
    tail = np.zeros(padded_len_for(msg_bytes) - msg_bytes, dtype=np.uint8)
    tail[0] = 0x80
    tail[56:64] = np.frombuffer((msg_bytes * 8).to_bytes(8, "big"), dtype=np.uint8)
    return tail.view(np.int32), int(num_blocks_for(msg_bytes))


def random_batch(dev, rows: int, msg_bytes: int, seed: int):
    """``rows`` random messages of ``msg_bytes`` bytes, made and padded on
    the card: (``int32[rows, padded/4]``, ``int32[rows]`` block counts)."""
    import torch

    tail, nblk = pad_words(msg_bytes)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    words = msg_bytes // 4
    data = torch.empty((rows, words + tail.size), dtype=torch.int32, device=dev)
    data[:, :words] = torch.randint(
        -(1 << 31), 1 << 31, (rows, words), dtype=torch.int32, device=dev, generator=g
    )
    data[:, words:] = torch.from_numpy(tail).to(dev)
    return data, torch.full((rows,), nblk, dtype=torch.int32, device=dev)


def hashlib_words(data, msg_bytes: int, digest) -> np.ndarray:
    """hashlib's digest of every row's message, as big-endian ``uint32``
    state words ``[rows, digest_size / 4]``."""
    host = data[:, : msg_bytes // 4].contiguous().cpu().numpy().view(np.uint8)
    out = b"".join(digest(row.tobytes()).digest() for row in host)
    return np.frombuffer(out, dtype=">u4").astype(np.uint32).reshape(host.shape[0], -1)


def build_all(mod, grid: list[dict]) -> list:
    """Every knob set's variant, one ``nvcc`` each, all started together
    (forced, so each has its ptxas report and build seconds)."""
    with ThreadPoolExecutor(max_workers=max(1, len(grid))) as pool:
        futures = [pool.submit(mod.load_variant, True, **knobs) for knobs in grid]
        return [f.result() for f in futures]


def time_launches(launch, bufs: list, nblocks, iters: int) -> float:
    """Milliseconds a launch: one warm-up, then ``iters`` launches cycling
    over ``bufs`` between two CUDA events."""
    import torch

    launch(bufs[0], nblocks)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(iters):
        launch(bufs[k % len(bufs)], nblocks)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def sweep(mod, grid: list[dict], *, msg_bytes: int, rows: int, iters: int, digest,
          kernel: str, seed: int, block_ops: int, extra=None) -> list[dict]:
    """Build, check and time every variant of ``mod`` (``ops.sha1_cuda``
    or ``ops.sha256_cuda``, whose 64-byte block takes ``block_ops``
    integer instructions) on ``rows`` random messages of ``msg_bytes``;
    returns one record a variant, ranked by ms. ``extra(variant)`` adds
    fields to a variant's record."""
    import torch

    from torrent_tpu_torch.native.build import define_flags, knob_defines, ptxas_resources
    from torrent_tpu_torch.ops.sha1_torch import words_to_numpy
    from torrent_tpu_torch.ops.work import INT32_PEAK, bound_ms
    from torrent_tpu_torch.utils.device import resolve_device

    dev = resolve_device(None)  # the card, or DeviceUnavailable: no CPU mode
    variants = build_all(mod, grid)
    data, nblocks = random_batch(dev, rows, msg_bytes, seed)
    want = hashlib_words(data, msg_bytes, digest)
    words = msg_bytes // 4
    n_bufs = max(1, min(iters, DISTINCT_BYTES // (data.numel() * 4)))
    bufs = []
    for k in range(n_bufs):
        buf = data.clone()
        buf[:, :words] ^= 0x5A5A0000 + k + 1
        bufs.append(buf)
    nblk = int(nblocks[0])
    ops = rows * nblk * block_ops
    # each block read once, each count read once, each digest written once
    bound, bound_by = bound_ms(ops, rows * (nblk * 64 + 4 + want.shape[1] * 4))
    ops_ms = ops / INT32_PEAK * 1e3
    defaults = mod.check_knobs()
    records = []
    for variant in variants:
        got = words_to_numpy(variant.launch(data, nblocks))
        bad = np.flatnonzero((got != want).any(axis=1))
        if bad.size:
            raise RuntimeError(
                f"variant {variant.knobs}: {bad.size} of {rows} rows differ from hashlib "
                f"(first row {int(bad[0])})"
            )
        ms = time_launches(variant.launch, bufs, nblocks, iters)
        res = ptxas_resources(variant.report, kernel)
        rec = {
            "knobs": variant.knobs,
            "defines": define_flags(knob_defines(mod.KNOBS, variant.knobs)),
            "default": variant.knobs == defaults,
            "library": variant.library.name,
            "ms": round(ms, 4),
            "pieces_per_sec": round(rows / (ms / 1e3), 1),
            "gb_per_sec": round(rows * msg_bytes / (ms / 1e3) / 1e9, 2),
            "bound_ms": round(bound, 4),
            "bound_by": bound_by,
            "ops_bound_share": round(ops_ms / ms, 4),
            "registers": res["registers"],
            "spill_stores": res["spill_stores"],
            "static_smem_bytes": res["smem_bytes"],
            "build_s": round(variant.build_s, 2),
            "rows_checked": rows,
            "distinct_inputs": n_bufs,
            **(extra(variant) if extra else {}),
        }
        records.append(rec)
    del bufs, data
    torch.cuda.empty_cache()
    records.sort(key=lambda r: r["ms"])
    for rank, rec in enumerate(records, 1):
        rec["rank"] = rank
    return records


def run_sweep(piece_kb: int, batch: int, grid: list[dict], iters: int) -> list[dict]:
    """The SHA-1 sweep at ``batch`` pieces of ``piece_kb`` KiB; returns the
    ranked records (see :func:`sweep`)."""
    from torrent_tpu_torch.ops import sha1_cuda
    from torrent_tpu_torch.ops.work import SHA1_BLOCK_OPS

    return sweep(
        sha1_cuda, grid, msg_bytes=piece_kb * 1024, rows=batch, iters=iters,
        digest=hashlib.sha1, kernel="sha1_rows_kernel", seed=20261017, block_ops=SHA1_BLOCK_OPS,
        extra=lambda v: {"dynamic_smem_bytes": v.lib.tt_sha1_smem_bytes()},
    )


def best_line(records: list[dict], **shape) -> dict:
    """The sweep's last line: the fastest variant and its ``nvcc`` flags
    (production keeps the source's defaults)."""
    import torch

    best = records[0]
    return {
        "best": best, "nvcc_defines": best["defines"], **shape,
        "device": torch.cuda.get_device_name(0),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--piece-kb", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--grid", default=DEFAULT_GRID, help="wk.raw.sched,... (default %(default)s)")
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    try:
        grid = parse_grid(args.grid)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    records = run_sweep(args.piece_kb, args.batch, grid, args.iters)
    for rec in records:
        print(json.dumps(rec), flush=True)
    print(json.dumps(best_line(records, piece_kb=args.piece_kb, batch=args.batch)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
