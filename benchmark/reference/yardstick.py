"""The frozen yardstick: operation, byte and peak model of the hash
kernels, and the arithmetic that reads a profiler trace.

Peaks: the published NVIDIA H100 SXM figures, 132 SMs at a 1.98 GHz
boost clock (Hopper architecture white paper) and 3.35 TB/s of HBM3
(data sheet), both at the card's full 700 W power limit.

Pipe model. Every operation counted below is a 32-bit integer
instruction. On Hopper an integer add can issue on the 64-lane INT32
pipe or, as an ``IMAD``, on the 128-lane FMA pipe, and logic ops and
shifts have their own units; whatever the mix, each of the SM's four
sub-partitions dispatches at most one warp instruction (32 lanes) a
clock. So 128 lane-operations a clock per SM bounds every mix of pipes,
and ``PEAK_INT_OPS_PER_S`` is that dispatch limit. A share read against
it cannot pass 100% for any implementation that executes at least the
counted instructions.

Operation counts (the fewest instructions a 64-byte block needs as
Hopper issues them: ``LOP3`` merges a three-input logic op, ``IADD3`` a
three-term add, ``SHF`` is one rotate):

- SHA-1 613 a block: 16 byteswaps; 64 schedule words of two ``LOP3``
  and one rotate; 80 rounds of a rotate, a ``LOP3``, two ``IADD3`` and
  a rotate; 5 feed-forward adds.
- SHA-256 1,400 a block: 16 byteswaps; 48 schedule words of 10; 64
  rounds of 14; 8 feed-forward adds.
- A merkle pair 2,288: the 64-byte pair block without byteswaps (1,384)
  and the padding block, whose schedule is constant (904).

Bytes: each input byte read once and each digest written once. What
these inputs need is counted, never what a launch pads: blocks of the
real pieces and leaves, pairs of the real trees.
"""

from __future__ import annotations

SMS = 132
BOOST_HZ = 1.98e9
LANE_OPS_PER_SM_PER_CLOCK = 128  # 4 sub-partitions x one 32-lane warp instruction a clock
PEAK_INT_OPS_PER_S = LANE_OPS_PER_SM_PER_CLOCK * SMS * BOOST_HZ
HBM_BYTES_PER_S = 3.35e12

SHA1_OPS_PER_BLOCK = 16 + 64 * 3 + 80 * 5 + 5
SHA256_OPS_PER_BLOCK = 16 + 48 * 10 + 64 * 14 + 8
MERKLE_OPS_PER_PAIR = (48 * 10 + 64 * 14 + 8) + (64 * 14 + 8)

PIPE_MODEL = (
    "dispatch-bound: 128 lane-ops/clock/SM (4 x 32-lane warp instructions), "
    "any mix of INT32 and FMA (IMAD) pipes; 132 SMs at 1.98 GHz; HBM 3.35 TB/s"
)


def md_blocks(nbytes: int) -> int:
    """64-byte blocks of a SHA-1 or SHA-256 message of ``nbytes`` (with its
    0x80 byte and 8-byte length)."""
    return (nbytes + 9 + 63) // 64


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operation
    and the memory bound."""
    return max(ops / PEAK_INT_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def sha1_work(lengths) -> tuple[int, int]:
    """(operations, bytes) of SHA-1 over messages of these lengths."""
    ops = sum(md_blocks(n) for n in lengths) * SHA1_OPS_PER_BLOCK
    return ops, sum(lengths) + 20 * len(lengths)


def sha256_work(lengths) -> tuple[int, int]:
    """(operations, bytes) of SHA-256 over messages of these lengths."""
    ops = sum(md_blocks(n) for n in lengths) * SHA256_OPS_PER_BLOCK
    return ops, sum(lengths) + 32 * len(lengths)


def merkle_work(trees: list[int]) -> tuple[int, int]:
    """(operations, bytes) of reducing trees of these leaf widths (powers
    of two) to their roots: width - 1 pairs each; the leaves read once
    and each root written once."""
    pairs = sum(w - 1 for w in trees)
    return pairs * MERKLE_OPS_PER_PAIR, 32 * sum(trees) + 32 * len(trees)


def union_s(spans) -> float:
    """Seconds covered by the union of ``(start_us, end_us)`` spans (the
    arithmetic of ``torrent_tpu_torch/obs/profiler.py::_union_s``)."""
    total = 0.0
    start = end = None
    for a, b in sorted(spans):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total / 1e6


def merged(spans) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` spans as disjoint sorted spans."""
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]
