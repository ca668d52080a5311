"""Host-side SHA1 message padding/packing for batched device hashing.

SHA1 (FIPS 180-4) processes 64-byte blocks; a message of ``n`` bytes is
padded with ``0x80``, zeros, then the 64-bit big-endian bit length, to a
multiple of 64. For a batch of pieces (equal-capacity rows, possibly
ragged true lengths — the last piece of a torrent is short) we pad every
row in place with vectorized numpy and hand the device one dense
``uint8[B, padded_len]`` plus an ``int32[B]`` block count; the kernels mask
the chain per-row beyond its own block count, so one launch takes a
whole ragged batch. The layout is the reference package's
(torrent_tpu/ops/padding.py), byte for byte, so both packages hash the
same staged rows.

This replaces the reference's per-piece ``crypto.subtle.digest`` calls
(tools/make_torrent.ts:28-32, metainfo.ts:141-143) with one batched launch.
"""

from __future__ import annotations

import numpy as np


def padded_len_for(piece_len: int) -> int:
    """Padded byte length for messages of up to ``piece_len`` bytes.

    The SHA minimum is ``((len + 8) // 64 + 1) * 64`` — at least one byte
    of 0x80 marker plus the 8-byte length field beyond the message. On
    top of that the row is rounded up to a 128-byte multiple, as in the
    reference; on the GPU this keeps every row 16-byte aligned, which the
    CUDA kernel's vector loads need (ops/sha1_cuda.py checks it). Rows
    never exceed ``num_blocks_for`` blocks on device: the ghost tail
    block sits beyond every row's block count and is never hashed.
    """
    n = ((piece_len + 8) // 64 + 1) * 64
    return (n + 127) // 128 * 128


def num_blocks_for(length) -> np.ndarray:
    """Per-message SHA1 block count (works on scalars or arrays)."""
    return (np.asarray(length, dtype=np.int64) + 8) // 64 + 1


def alloc_padded(n: int, piece_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Allocate a zeroed padded batch buffer and its data-region view.

    Returns ``(padded, data_view)`` where ``padded`` is
    ``uint8[n, padded_len]`` and ``data_view = padded[:, :piece_len]`` —
    ``Storage.read_batch`` can fill the view directly, avoiding a copy.
    """
    padded = np.zeros((n, padded_len_for(piece_len)), dtype=np.uint8)
    return padded, padded[:, :piece_len]


def pad_in_place(padded: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Write SHA1 padding into ``padded`` rows; returns int32 block counts.

    ``padded[i, :lengths[i]]`` must hold the message and everything after
    it must be zero (alloc_padded guarantees this; for reused buffers the
    caller zeroes tails). Fully vectorized — O(B) fancy-indexed stores, no
    per-piece Python loop.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    b, padded_len = padded.shape
    if lengths.shape != (b,):
        raise ValueError("lengths must be [B]")
    if np.any(lengths < 0) or np.any((lengths + 8) // 64 * 64 + 64 > padded_len):
        raise ValueError("length too large for padded buffer")
    rows = np.arange(b)
    padded[rows, lengths] = 0x80
    nblocks = num_blocks_for(lengths)
    base = nblocks * 64 - 8  # offset of the 64-bit bit-length field
    bitlen = (lengths.astype(np.uint64)) * 8
    for k in range(8):
        padded[rows, base + k] = ((bitlen >> np.uint64(56 - 8 * k)) & np.uint64(0xFF)).astype(
            np.uint8
        )
    return nblocks.astype(np.int32)


def pad_pieces(pieces: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Pack a ragged list of byte strings into a padded batch.

    Convenience path for authoring/tests; the verify plane uses
    ``alloc_padded`` + ``Storage.read_batch`` + ``pad_in_place`` to avoid
    the extra copies.
    """
    if not pieces:
        return np.zeros((0, 64), dtype=np.uint8), np.zeros(0, dtype=np.int32)
    max_len = max(len(p) for p in pieces)
    padded, view = alloc_padded(len(pieces), max_len)
    lengths = np.array([len(p) for p in pieces], dtype=np.int64)
    for i, p in enumerate(pieces):
        view[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
    nblocks = pad_in_place(padded, lengths)
    return padded, nblocks


def digests_to_words(digests: list[bytes] | tuple[bytes, ...], words: int = 5) -> np.ndarray:
    """Fixed-width digests → ``uint32[B, words]`` big-endian words.

    ``words=5`` is SHA1 (20-byte digests), ``words=8`` SHA-256. The
    expected-hash side of on-device comparison: ``info.pieces`` uploaded
    once per torrent.
    """
    arr = np.frombuffer(b"".join(digests), dtype=">u4").reshape(len(digests), words)
    return arr.astype(np.uint32)


def words_to_digests(words: np.ndarray) -> list[bytes]:
    """``uint32[B, W]`` state words → digests (width follows the array)."""
    be = np.asarray(words, dtype=np.uint32).astype(">u4")
    return [be[i].tobytes() for i in range(be.shape[0])]
