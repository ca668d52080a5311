"""Time the merkle reduction on one GPU at the shapes the BEP 52 paths give it.

    python3 torrent_tpu_torch/tools/time_merkle.py [--root DIR] [--reps N] [--label NAME]

Times ``models/merkle.py::_merkle_reduce_fused`` (and the one-level
``sha256_pairs``) of the checkout at ``DIR``, by default the checkout this
file is in. Pointed at an unpacked older commit, it times that commit's
route with the same harness, so two commits compare in one run on one
card. ``chip_smoke.py`` phase 6 calls :func:`time_shapes` on its own
checkout.

Each shape gets three times, all from CUDA events on random words made
on the card:

- ``synced_ms``: one call after ``torch.cuda.synchronize()``, the median
  of ``--reps``: what a recheck batch waits for, the host's launch work
  included;
- ``back_to_back_ms``: the mean of ``--reps`` calls queued without a
  synchronise in between, as chip_smoke's ``time_kernel`` times kernels;
- ``device_ms``: one call queued behind a spin of the card
  (``torch.cuda._sleep``), so the host has queued all of it before its
  first launch starts: the kernels' own time and the gaps between them,
  the median of ``--reps``.

Every shape's first tree is checked against :func:`hashlib_roots`. The
chain floor comes from the slope between one-tree launches of different
heights, so the fixed cost of a launch (and of the first level's load)
drops out: 1 level (2 leaves) against 6 levels (64 leaves), every level
one warp's work, and 1 against 9 (512 leaves), whose first levels span
more warps. It is given in cycles per level at the SM clock
``nvidia-smi`` reads while the card spins, beside the intercept (the
device time of a launch less its levels). Lines start with ``time:`` and
end with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import os
import runpy
import statistics
import subprocess
import sys

import numpy as np

# (label, trees, leaves per tree): a v2 recheck batch of 256 pieces of
# 1 MiB; an authoring launch's piece grid; the piece layer of a 2 GiB file
# and of a 100 GiB file at 1 MiB pieces (more levels than one launch
# takes); one piece alone, the chain probe; and the chain probe's
# neighbours in height, one launch each, for the chain floor's slope
SHAPES = (
    ("recheck batch", 256, 64),
    ("authoring piece grid", 2048, 64),
    ("2 GiB file layer", 1, 2048),
    ("chain probe", 1, 64),
    ("100 GiB file layer", 1, 131072),
    ("chain probe, 1 level", 1, 2),
    ("chain probe, 9 levels", 1, 512),
)
# (low, high): the chain floor's slopes, between probes of SHAPES
SLOPES = (("chain probe, 1 level", "chain probe"), ("chain probe, 1 level", "chain probe, 9 levels"))
PAIRS = 65536  # one merkle level of a 2 GiB file's leaf grid
REPS = 30
SPIN_CYCLES = 1_000_000  # ~0.5 ms: longer than the host takes to queue a call


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()


def sm_clock_under_load(torch) -> str:
    """The SM clock while the card spins (an idle card clocks down)."""
    torch.cuda._sleep(2_000_000_000)
    clock = smi("clocks.sm")
    torch.cuda.synchronize()
    return clock


def time_call(torch, fn, reps: int = REPS) -> dict:
    """``fn()``'s synced, back-to-back and device times in ms."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    synced, device = [], []
    for spin, out in ((0, synced), (SPIN_CYCLES, device)):
        for _ in range(reps):
            a, b = ev(), ev()
            torch.cuda.synchronize()
            if spin:
                torch.cuda._sleep(spin)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
    a, b = ev(), ev()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return {
        "synced_ms": statistics.median(synced),
        "back_to_back_ms": a.elapsed_time(b) / reps,
        "device_ms": statistics.median(device),
    }


def hashlib_roots(grid: np.ndarray) -> list[bytes]:
    """hashlib's pair-fold of each tree of ``[B, L, 8]`` digest words
    (uint32 bits, any 32-bit integer dtype): the roots as 32-byte digests."""
    roots = []
    for tree in np.asarray(grid).view(np.uint32):
        raw = tree.astype(">u4").tobytes()
        nodes = [raw[i : i + 32] for i in range(0, len(raw), 32)]
        while len(nodes) > 1:
            nodes = [hashlib.sha256(nodes[i] + nodes[i + 1]).digest() for i in range(0, len(nodes), 2)]
        roots.append(nodes[0])
    return roots


def _launch_count(sha256_cuda) -> int:
    """Launches so far of the checkout's merkle route: the pair wrapper
    and, where the checkout has it, the merkle wrapper."""
    fns = (getattr(sha256_cuda, "sha256_pairs_cuda", None), getattr(sha256_cuda, "sha256_merkle_cuda", None))
    return sum(f.launches for f in fns if f is not None)


@functools.cache
def _work() -> dict:
    """``ops/work.py`` of the checkout this file is in, loaded by path: the
    bounds stay the same whichever ``--root`` is timed, and a root that
    predates the module still times."""
    return runpy.run_path(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ops", "work.py"))


def bound_ms(ops: int, nbytes: int) -> tuple[float, str]:
    """The least time in ms for ``ops`` integer instructions moving
    ``nbytes``, and which of the two bounds it (``ops/work.py``)."""
    return _work()["bound_ms"](ops, nbytes)


def time_shapes(reps: int = REPS, label: str = "") -> list[dict]:
    """Time the importable checkout's merkle route at :data:`SHAPES` and
    one :data:`PAIRS`-pair level; prints a ``time:`` line per shape and
    returns the records. Raises if a root disagrees with hashlib."""
    import torch

    from torrent_tpu_torch.models import merkle
    from torrent_tpu_torch.ops import sha256_cuda

    dev = torch.device("cuda", 0)
    card = f"[{smi('name,power.limit')}]"
    tag = f" ({label})" if label else ""
    g = torch.Generator(device=dev)
    records = []
    for name, b, l in SHAPES:
        g.manual_seed(b * 1_000_003 + l)
        levels = l.bit_length() - 1
        words = torch.randint(0, 256, (b * l * 32,), dtype=torch.uint8, device=dev, generator=g)
        grid = words.view(torch.int32).view(b, l, 8)
        before = _launch_count(sha256_cuda)
        roots = merkle._merkle_reduce_fused(grid, levels)
        launches = _launch_count(sha256_cuda) - before
        # a one-node "tree" folds to the node itself: the root's bytes
        if hashlib_roots(roots[:1, None].cpu().numpy()) != hashlib_roots(grid[:1].cpu().numpy()):
            raise RuntimeError(f"merkle {name}: root of tree 0 disagrees with hashlib")
        times = time_call(torch, lambda: merkle._merkle_reduce_fused(grid, levels), reps)
        bound, by = bound_ms(b * (l - 1) * _work()["MERKLE_PAIR_OPS"], b * l * 32 + b * 32)
        rec = dict(name=name, shape=[b, l, 8], levels=levels, launches=launches, bound_ms=bound, bound_by=by, **times)
        records.append(rec)
        print(
            f"time: merkle{tag} [{b}, {l}, 8] {name} levels={levels} launches={launches} "
            f"synced_ms={times['synced_ms']:.4f} back_to_back_ms={times['back_to_back_ms']:.4f} "
            f"device_ms={times['device_ms']:.4f} bound_ms={bound:.4f} ({by}) {card}",
            flush=True,
        )
    by_name = {r["name"]: r for r in records}
    clock = sm_clock_under_load(torch)
    mhz = float(clock.split()[0])
    for low, high in SLOPES:
        lo, hi = by_name[low], by_name[high]
        slope_ms = (hi["device_ms"] - lo["device_ms"]) / (hi["levels"] - lo["levels"])
        cycles = slope_ms * 1e-3 * mhz * 1e6
        intercept_ms = lo["device_ms"] - lo["levels"] * slope_ms
        hi.update(chain_cycles_per_level=cycles, chain_ms_per_level=slope_ms, intercept_ms=intercept_ms, sm_clock=clock)
        print(
            f"time: merkle{tag} chain floor {cycles:.0f} cycles per level, levels {lo['levels']} to {hi['levels']} "
            f"({hi['device_ms']:.4f} - {lo['device_ms']:.4f} ms over {hi['levels'] - lo['levels']} levels "
            f"= {slope_ms:.5f} ms a level, intercept {intercept_ms:.4f} ms, at SM clock {clock}) {card}",
            flush=True,
        )
    g.manual_seed(PAIRS)
    pair_words = torch.randint(0, 256, (PAIRS * 64,), dtype=torch.uint8, device=dev, generator=g)
    pair_words = pair_words.view(torch.int32).view(PAIRS, 16)
    times = time_call(torch, lambda: merkle.sha256_pairs(pair_words), reps)
    bound, by = bound_ms(PAIRS * _work()["MERKLE_PAIR_OPS"], PAIRS * (64 + 32))
    records.append(dict(name="pair level", shape=[PAIRS, 16], levels=1, launches=1, bound_ms=bound, bound_by=by, **times))
    print(
        f"time: sha256_pairs{tag} {PAIRS} pairs synced_ms={times['synced_ms']:.4f} "
        f"back_to_back_ms={times['back_to_back_ms']:.4f} device_ms={times['device_ms']:.4f} "
        f"bound_ms={bound:.4f} ({by}) {card}",
        flush=True,
    )
    return records


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here, help="checkout whose torrent_tpu_torch to time")
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--label", default="", help="tag printed on every line")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_merkle: needs a GPU (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    time_shapes(args.reps, args.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
