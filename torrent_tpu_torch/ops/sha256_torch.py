"""Batched SHA-256 in plain PyTorch — the oracle for the CUDA kernel.

Same contract as the reference's ``torrent_tpu/ops/sha256_jax.py::
sha256_pieces_jax``: rows the host already padded (ops/padding.py) plus a
per-row block count go in, the eight big-endian state words of each row
come out. ``nblocks=0`` marks a sentinel row whose chain never runs (its
output is the IV); a row's chain stops at its own count, so one call
takes a ragged batch. Input is ``uint8[B, padded]`` or the host-order
``uint32[B, padded/4]`` form passed as ``int32``; output is ``int32[B, 8]``
holding the uint32 bit patterns (``sha1_torch.words_to_numpy`` gives
``uint32[B, 8]``).

:func:`sha256_pairs_torch` is one merkle level, the contract of the
reference's ``models/merkle.py::sha256_pairs``: ``int32[M, 16]``
big-endian child-pair words → ``int32[M, 8]``, the compression of the
pair block followed by the constant padding block of a 64-byte message.
:func:`sha256_merkle_torch` is a whole reduction, the reference's
``_merkle_reduce_fused`` on the flattened grid: ``int32[N, 8]`` node words
→ ``int32[N / 2**levels, 8]`` roots, one pair level at a time.

The arithmetic runs in int64 masked to 32 bits, as in ``sha1_torch``.
A rotate takes the word doubled into 64 bits (``x | x << 32``) and
shifted right, so each Sigma is one doubling and three shifts. The
schedule of a chunk of blocks is expanded for all of them at once; the
64 rounds run block after block, as the chain demands. CPU tensors take
this path in ``ops/sha256_cuda.py``; on the GPU it is only the yardstick
the kernel is checked against.
"""

from __future__ import annotations

import torch

from torrent_tpu_torch.ops.sha1_torch import _to_int32_bits, check_batch

# FIPS 180-4 §5.3.3 / §4.2.2 constants.
IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)
K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)
_M32 = 0xFFFFFFFF
# blocks whose schedules are expanded together: bounds the int64
# temporaries to B * 32 * 64 * 8 bytes (537 MB at a 32768-leaf launch)
_CHUNK_BLOCKS = 32


def _rotr_sum(x, r1: int, r2: int, r3: int):
    """``rotr(x, r1) ^ rotr(x, r2) ^ rotr(x, r3)`` for words in [0, 2**32)."""
    y = x | (x << 32)  # bits 32-63 repeat the word; bits r..r+31 = rotr(x, r)
    return ((y >> r1) ^ (y >> r2) ^ (y >> r3)) & _M32


def _small_sigma(x, r1: int, r2: int, s: int):
    y = x | (x << 32)
    return ((y >> r1) ^ (y >> r2) ^ (x >> s)) & _M32


def _expand(w: list) -> list:
    """16 message words → the 64 schedule words with ``K[t]`` added
    (each in [0, 2**33); the rounds mask their sums)."""
    w = list(w)
    for t in range(16, 64):
        w.append(
            (_small_sigma(w[t - 2], 17, 19, 10) + w[t - 7]
             + _small_sigma(w[t - 15], 7, 18, 3) + w[t - 16]) & _M32
        )
    return [wt + K[t] for t, wt in enumerate(w)]


def _compress(state, wk):
    """One SHA-256 compression; ``wk`` holds the 64 values ``w[t] + K[t]``
    (int64 tensors of shape ``[B]``, or Python ints for a constant block)."""
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        t1 = h + _rotr_sum(e, 6, 11, 25) + (g ^ (e & (f ^ g))) + wk[t]
        t2 = _rotr_sum(a, 2, 13, 22) + ((a & b) | (c & (a ^ b)))
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + t2) & _M32
    return tuple((s + x) & _M32 for s, x in zip(state, (a, b, c, d, e, f, g, h)))


def _iv(bsz: int, device) -> tuple:
    return tuple(torch.full((bsz,), v, dtype=torch.int64, device=device) for v in IV)


def sha256_pieces_torch(data: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Batched SHA-256: ``(u8[B, P] | int32[B, P/4], int32[B]) → int32[B, 8]``.

    Runs on the tensors' device; the result holds uint32 bit patterns.
    """
    row_bytes = check_batch(data, nblocks)
    u8 = data.view(torch.uint8) if data.dtype == torch.int32 else data
    bsz = u8.shape[0]
    state = _iv(bsz, u8.device)
    if bsz == 0:
        return _to_int32_bits(torch.stack(state, dim=1))
    nb = nblocks.to(torch.int64).clamp(0, row_bytes // 64)
    last = int(nb.max())  # blocks past every row's chain are never hashed
    always = int(nb.min())  # blocks that every row's chain runs
    for c0 in range(0, last, _CHUNK_BLOCKS):
        c1 = min(c0 + _CHUNK_BLOCKS, last)
        q = u8[:, c0 * 64 : c1 * 64].reshape(bsz, c1 - c0, 16, 4).to(torch.int64)
        words = (q[..., 0] << 24) | (q[..., 1] << 16) | (q[..., 2] << 8) | q[..., 3]
        wk = torch.stack(_expand(words.unbind(2)), dim=2)  # [B, chunk, 64]
        for j in range(c1 - c0):
            new = _compress(state, wk[:, j].unbind(1))
            if c0 + j < always:
                state = new
            else:
                keep = c0 + j < nb
                state = tuple(torch.where(keep, n, o) for n, o in zip(new, state))
    return _to_int32_bits(torch.stack(state, dim=1))


# the padding block of every 64-byte message: 0x80, zeros, bit length 512
_PAD_WK = tuple(_expand([0x80000000] + [0] * 14 + [512]))


def check_pairs(words: torch.Tensor) -> None:
    """Validate one merkle level against the pair contract."""
    if words.dim() != 2 or words.shape[1] != 16:
        raise ValueError(f"pair words must be [M, 16], got shape {tuple(words.shape)}")
    if words.dtype != torch.int32:
        raise TypeError(f"pair words must be int32-viewed uint32, got {words.dtype}")


def sha256_pairs_torch(words: torch.Tensor) -> torch.Tensor:
    """One merkle level: ``int32[M, 16]`` child-pair words → ``int32[M, 8]``."""
    check_pairs(words)
    w = words.to(torch.int64) & _M32
    state = _compress(_iv(words.shape[0], words.device), _expand(w.unbind(1)))
    state = _compress(state, _PAD_WK)
    return _to_int32_bits(torch.stack(state, dim=1))


def check_merkle(words: torch.Tensor, levels: int) -> None:
    """Validate a merkle reduction against its contract: ``int32[N, 8]``
    node words, an int ``levels >= 0``, and ``N`` divisible by
    ``2**levels`` (whole trees only)."""
    if words.dim() != 2 or words.shape[1] != 8:
        raise ValueError(f"merkle words must be [N, 8], got shape {tuple(words.shape)}")
    if words.dtype != torch.int32:
        raise TypeError(f"merkle words must be int32-viewed uint32, got {words.dtype}")
    if isinstance(levels, bool) or not isinstance(levels, int) or levels < 0:
        raise ValueError(f"levels must be an int >= 0, got {levels!r}")
    if words.shape[0] % (1 << levels):
        raise ValueError(f"{words.shape[0]} nodes are not whole trees of 2**{levels}")


def sha256_merkle_torch(words: torch.Tensor, levels: int) -> torch.Tensor:
    """Merkle roots: ``int32[N, 8]`` → ``int32[N / 2**levels, 8]``, each run
    of ``2**levels`` consecutive nodes folded by ``levels`` pair levels."""
    check_merkle(words, levels)
    for _ in range(levels):
        words = sha256_pairs_torch(words.reshape(-1, 16))
    return words
