"""The work of the hash kernels, and the H100 rates that bound it.

The tools that time the kernels (``tools/time_merkle.py``,
``tools/tune_sha1.py``, ``tools/tune_sha256.py``) and ``chip_smoke.py``
give each launch the least time this work can take on the card, and the
share of it a launch reaches. The counts are the least integer
instructions a block needs, counted as Hopper issues them; the design
notes of ``csrc/sha1.cu`` and ``csrc/sha256.cu`` cite them. Plain
numbers only: the module imports nothing, so a tool can load it by path.
"""

from __future__ import annotations

# SHA-1, one 64-byte block: 16 byteswaps (PRMT); 64 schedule words of two
# LOP3 (a 4-way XOR) and one rotate (SHF); 80 rounds of one rotate for a,
# one LOP3 for ch/parity/maj, two IADD3 for the five-term sum and one
# rotate for b; 5 feed-forward adds. 16 + 192 + 400 + 5.
SHA1_BLOCK_OPS = 16 + 64 * 3 + 80 * 5 + 5
# SHA-256, one 64-byte block: 16 byteswaps (PRMT); 48 schedule words of 10
# (sigma0 and sigma1 each two rotates (SHF), one shift (SHR) and one 3-way
# XOR (LOP3), plus two IADD3 for the four-term sum); 64 rounds of 14
# (Sigma0 and Sigma1 each three SHF and one LOP3, ch and maj one LOP3
# each, four adds for t1, e and a); 8 feed-forward adds. 16 + 480 + 896 + 8.
SHA256_BLOCK_OPS = 16 + 48 * 10 + 64 * 14 + 8
# One merkle pair: the pair block without byteswaps, then the padding
# block, whose schedule is a compile-time constant (rounds and adds only).
MERKLE_PAIR_OPS = (48 * 10 + 64 * 14 + 8) + (64 * 14 + 8)
# H100 SXM peak INT32 rate: 64 INT32 lanes per SM (Hopper white paper)
# x 132 SMs x 1.98 GHz boost clock, at the full 700 W power limit.
INT32_PEAK = 64 * 132 * 1.98e9
# H100 SXM HBM3 rate in bytes a second (NVIDIA data sheet).
HBM_PEAK = 3.35e12


def bound_ms(ops: int, nbytes: int) -> tuple[float, str]:
    """The least time in ms for ``ops`` integer instructions moving
    ``nbytes`` through HBM, and which of the two bounds it
    (``"operations"`` or ``"bytes"``)."""
    t_ops = ops / INT32_PEAK * 1e3
    t_bytes = nbytes / HBM_PEAK * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
