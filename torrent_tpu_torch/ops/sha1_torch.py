"""Batched SHA-1 in plain PyTorch — the oracle for the CUDA kernel.

Same contract as the reference's ``torrent_tpu/ops/sha1_jax.py::
sha1_pieces_jax``: rows the host already padded (ops/padding.py) plus a
per-row block count go in, the five big-endian state words of each row
come out. ``nblocks=0`` marks a sentinel row whose chain never runs (its
output is the IV); a row's chain stops at its own count, so one call
takes a ragged batch.

Input is ``uint8[B, padded]`` or the host-order ``uint32[B, padded/4]``
form, passed as ``int32`` (torch has no general ``uint32`` arithmetic;
the bits are the same). Output is ``int32[B, 5]`` holding the uint32
bit patterns; :func:`words_to_numpy` gives ``uint32[B, 5]``.

torch's ``uint32`` has thin op coverage, so the arithmetic runs in
int64 and is masked with ``& 0xFFFFFFFF``. The message schedule of a
chunk of blocks is expanded for all of them at once; the 80 rounds
run block after block, as the chain demands. CPU tensors take this
path in ``ops/sha1_cuda.py``; on the GPU it is only the yardstick the
kernel is checked against.
"""

from __future__ import annotations

import numpy as np
import torch

# FIPS 180-4 constants.
IV = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)
K = (0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6)
_M32 = 0xFFFFFFFF
# blocks whose schedules are expanded together: bounds the int64
# temporaries to B * 64 * 80 * 8 bytes (168 MB at B = 4096)
_CHUNK_BLOCKS = 64


def check_batch(data: torch.Tensor, nblocks: torch.Tensor) -> int:
    """Validate a batch against the SHA-1 contract; returns the row bytes."""
    if data.dim() != 2:
        raise ValueError(f"data must be [B, row], got shape {tuple(data.shape)}")
    if data.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"data must be uint8 or int32-viewed uint32, got {data.dtype}")
    row_bytes = data.shape[1] * data.element_size()
    if row_bytes % 64:
        raise ValueError(f"row of {row_bytes} bytes is not whole 64-byte blocks")
    if nblocks.shape != (data.shape[0],):
        raise ValueError(f"nblocks must be [{data.shape[0]}], got {tuple(nblocks.shape)}")
    if nblocks.dtype != torch.int32:
        raise TypeError(f"nblocks must be int32, got {nblocks.dtype}")
    if nblocks.device != data.device:
        raise ValueError(f"nblocks on {nblocks.device}, data on {data.device}")
    return row_bytes


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) & _M32) | (x >> (32 - n))


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) → int32 tensors with the same bits."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def _schedule(chunk_u8: torch.Tensor) -> torch.Tensor:
    """``uint8[B, nc*64]`` → int64 ``[B, nc, 80]``: each block's schedule
    words ``w[t]`` with the round constant ``K[t // 20]`` already added."""
    b = chunk_u8.shape[0]
    q = chunk_u8.reshape(b, -1, 16, 4).to(torch.int64)
    w = list(((q[..., 0] << 24) | (q[..., 1] << 16) | (q[..., 2] << 8) | q[..., 3]).unbind(2))
    for t in range(16, 80):
        w.append(_rotl(w[t - 3] ^ w[t - 8] ^ w[t - 14] ^ w[t - 16], 1))
    return torch.stack([wt + K[t // 20] for t, wt in enumerate(w)], dim=2)


def _compress(state, wk):
    """One SHA-1 compression; ``wk`` is int64 ``[B, 80]`` (w[t] + K)."""
    a, b, c, d, e = state
    for t in range(80):
        if t < 20:
            f = d ^ (b & (c ^ d))
        elif t < 40 or t >= 60:
            f = b ^ c ^ d
        else:
            f = (b & c) | (d & (b ^ c))
        tmp = (_rotl(a, 5) + f + e + wk[:, t]) & _M32
        e, d, c, b, a = d, c, _rotl(b, 30), a, tmp
    return tuple((s + x) & _M32 for s, x in zip(state, (a, b, c, d, e)))


def sha1_pieces_torch(data: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Batched SHA-1: ``(u8[B, P] | int32[B, P/4], int32[B]) → int32[B, 5]``.

    Runs on the tensors' device; the result holds uint32 bit patterns.
    """
    row_bytes = check_batch(data, nblocks)
    u8 = data.view(torch.uint8) if data.dtype == torch.int32 else data
    bsz = u8.shape[0]
    state = tuple(
        torch.full((bsz,), v, dtype=torch.int64, device=u8.device) for v in IV
    )
    if bsz == 0:
        return _to_int32_bits(torch.stack(state, dim=1))
    nb = nblocks.to(torch.int64).clamp(0, row_bytes // 64)
    last = int(nb.max())  # blocks past every row's chain are never hashed
    always = int(nb.min())  # blocks that every row's chain runs
    for c0 in range(0, last, _CHUNK_BLOCKS):
        c1 = min(c0 + _CHUNK_BLOCKS, last)
        wk = _schedule(u8[:, c0 * 64 : c1 * 64])
        for j in range(c1 - c0):
            new = _compress(state, wk[:, j])
            if c0 + j < always:
                state = new
            else:
                keep = c0 + j < nb
                state = tuple(torch.where(keep, n, o) for n, o in zip(new, state))
    return _to_int32_bits(torch.stack(state, dim=1))


def words_to_numpy(words) -> np.ndarray:
    """Device ``int32[B, 5]`` digest words → host ``uint32[B, 5]``; a
    list of such tensors (a grid's row blocks, in order) is joined."""
    if isinstance(words, (list, tuple)):
        return np.concatenate([words_to_numpy(w) for w in words])
    return words.cpu().numpy().view(np.uint32)
