"""Batched merkle trees over SHA-256 — the BEP 52 (BitTorrent v2) plane.

v2 hashes files as merkle trees with 16 KiB leaf blocks: leaves are
SHA-256 of each block, interior nodes are SHA-256 of the 64-byte
concatenation of their children, a file's ``pieces root`` is the tree
root, and for files larger than one piece the per-piece subtree roots
are published as the ``piece layers`` (BEP 52 "file tree" / "piece
layers").

Digests never leave word form: leaves come out of the SHA-256 plane as
``uint32[N, 8]`` big-endian words, and each merkle level is one batched
compression of the 16-word pair concatenation plus a constant padding
block, ``sha256_pairs: int32[M, 16] → int32[M, 8]``. The trees of a
``[B, L, 8]`` grid are contiguous, so a whole reduction
(:func:`_merkle_reduce_fused`) uploads its grid once and reduces every
level of every tree in one launch of the merkle kernel of
``csrc/sha256.cu`` (two for trees taller than its 9-level cap), as the
reference jits every level into one dispatch, and brings back only the
roots. On the CPU the same call runs the plain version, one level at a
time. The reference keys this route on ``jax.default_backend()``; here
the route is the tensor's device.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from torrent_tpu_torch.compat import to_device
from torrent_tpu_torch.ops.padding import digests_to_words
from torrent_tpu_torch.ops.padding import words_to_digests as words32_to_digests
from torrent_tpu_torch.ops.sha1_torch import words_to_numpy
from torrent_tpu_torch.ops.sha256_cuda import sha256_merkle_cuda, sha256_pairs_cuda
from torrent_tpu_torch.utils.device import resolve_device

__all__ = [
    "sha256_pairs",
    "merkle_level",
    "merkle_root",
    "zero_chain",
    "digests_to_words32",
    "words32_to_digests",
    "pad_leaves",
    "piece_roots_from_leaves",
    "file_root_from_piece_roots",
    "small_file_root",
    "piece_root_cpu",
]


def sha256_pairs(words: torch.Tensor) -> torch.Tensor:
    """One merkle level: ``int32[M, 16]`` child-pair words → ``int32[M, 8]``.

    The 64-byte message is exactly one block; the second (padding) block
    is the constant ``0x80 || zeros || bitlen=512``. Runs on the tensor's
    device: the pair kernel on a GPU, the plain version on the CPU.
    """
    return sha256_pairs_cuda(words)


def _merkle_reduce_fused(words: torch.Tensor, levels: int) -> torch.Tensor:
    """``int32[B, 2**levels, 8]`` → roots ``int32[B, 8]``: every pair level
    of every tree on the tensor's device, in one merkle launch up to the
    kernel's height cap."""
    b, m, _ = words.shape
    if m != 1 << levels:
        raise ValueError(f"{m} leaves per tree is not 2**{levels}")
    return sha256_merkle_cuda(words.contiguous().view(b * m, 8), levels).view(b, 8)


def merkle_level(words: np.ndarray, device=None) -> np.ndarray:
    """Host wrapper: ``u32[..., M, 8]`` → ``u32[..., M/2, 8]``.

    Leading batch axes are flattened into the pair batch so one call
    reduces a whole level of MANY trees at once.
    """
    *lead, m, _ = words.shape
    if m % 2:
        raise ValueError("merkle level must have an even node count")
    pairs = np.ascontiguousarray(words, dtype=np.uint32).reshape(-1, 16)
    out = words_to_numpy(sha256_pairs(to_device(pairs, resolve_device(device))))
    return out.reshape(*lead, m // 2, 8)


def merkle_root(words: np.ndarray, device=None) -> np.ndarray:
    """``u32[..., L, 8]`` (L a power of two) → root ``u32[..., 8]``.

    The grid goes to ``device`` once (None means the GPU), all log2(L)
    levels reduce there in one merkle launch up to the kernel's height
    cap, and only the roots come back.
    """
    *lead, l, _ = words.shape
    if l & (l - 1):
        raise ValueError("leaf count must be a power of two")
    if l == 1:
        return np.asarray(words)[..., 0, :]
    flat = np.ascontiguousarray(words, dtype=np.uint32).reshape(-1, l, 8)
    roots = _merkle_reduce_fused(to_device(flat, resolve_device(device)), l.bit_length() - 1)
    return words_to_numpy(roots).reshape(*lead, 8)


@functools.lru_cache(maxsize=None)
def zero_chain(levels: int) -> tuple[bytes, ...]:
    """``zero_chain(k)[i]`` = root digest of a full zero-leaf subtree of
    height ``i`` (index 0 = the 32-byte zero leaf itself), up to height
    ``levels``. Host-side hashlib — computed once per geometry."""
    out = [b"\x00" * 32]
    for _ in range(levels):
        out.append(hashlib.sha256(out[-1] + out[-1]).digest())
    return tuple(out)


def digests_to_words32(digests) -> np.ndarray:
    """32-byte SHA-256 digests → ``u32[N, 8]`` big-endian words."""
    return digests_to_words(digests, words=8)


def pad_leaves(leaf_words: np.ndarray, target: int) -> np.ndarray:
    """Pad ``u32[n, 8]`` leaf words with zero-hash leaves up to ``target``."""
    n = leaf_words.shape[0]
    if n == target:
        return leaf_words
    padded = np.zeros((target, 8), dtype=np.uint32)
    padded[:n] = leaf_words
    return padded


def piece_roots_from_leaves(
    leaf_words: np.ndarray, leaves_per_piece: int, device=None
) -> np.ndarray:
    """Leaf words ``u32[n_leaves, 8]`` → per-piece roots ``u32[n_pieces, 8]``.

    The final piece's missing leaves are zero-hash-padded (BEP 52). All
    pieces reduce together, in one merkle launch.
    """
    if leaves_per_piece & (leaves_per_piece - 1):
        raise ValueError("leaves_per_piece must be a power of two")
    n = leaf_words.shape[0]
    n_pieces = -(-n // leaves_per_piece)
    grid = np.zeros((n_pieces, leaves_per_piece, 8), dtype=np.uint32)
    grid.reshape(-1, 8)[:n] = leaf_words
    return merkle_root(grid, device)


def file_root_from_piece_roots(
    piece_root_words: np.ndarray, leaves_per_piece: int, device=None
) -> bytes:
    """Piece roots → the file's ``pieces root`` digest.

    The piece-root layer is padded to the next power of two with the root
    of an all-zero piece subtree (NOT the zero leaf — BEP 52's "remaining
    leaf hashes ... set to zero" composes upward through the full-height
    zero subtree).
    """
    n = piece_root_words.shape[0]
    target = 1 << max(0, (n - 1).bit_length())
    if target != n:
        height = leaves_per_piece.bit_length() - 1
        zero_root = zero_chain(height)[height]
        pad = np.tile(digests_to_words32([zero_root]), (target - n, 1))
        piece_root_words = np.concatenate([piece_root_words, pad], axis=0)
    return words32_to_digests(merkle_root(piece_root_words, device)[None, :])[0]


def small_file_root(leaf_words: np.ndarray, device=None) -> bytes:
    """Root for a file no larger than one piece: leaves zero-padded to the
    next power of two of the file's own block count."""
    n = leaf_words.shape[0]
    target = max(1, 1 << max(0, (n - 1).bit_length()))
    return words32_to_digests(merkle_root(pad_leaves(leaf_words, target), device)[None, :])[0]


def piece_root_cpu(data: bytes, pad_leaves: int) -> bytes:
    """Merkle root of one piece's data: SHA-256 16 KiB leaf hashes padded
    with ZERO digests (BEP 52 "remaining leaf hashes ... set to zero" —
    the pad is the zero VALUE, not the hash of zero bytes) up to
    ``pad_leaves`` (a power of two), pairs folded to the root.

    ``pad_leaves`` is blocks-per-piece for pieces of multi-piece files,
    or the file's own next-power-of-two block count for single-piece
    files — the per-piece expected digest in session/v2.py either way.
    Host-side hashlib: the streaming CPU recheck's oracle.
    """
    from torrent_tpu_torch.codec.metainfo_v2 import BLOCK

    if pad_leaves < 1 or pad_leaves & (pad_leaves - 1):
        raise ValueError("pad_leaves must be a power of two >= 1")
    leaves = [
        hashlib.sha256(data[i : i + BLOCK]).digest()
        for i in range(0, len(data), BLOCK)
    ] or [hashlib.sha256(b"").digest()]
    if len(leaves) > pad_leaves:
        raise ValueError(f"piece has {len(leaves)} leaves > pad target {pad_leaves}")
    leaves += [b"\x00" * 32] * (pad_leaves - len(leaves))
    while len(leaves) > 1:
        leaves = [
            hashlib.sha256(leaves[i] + leaves[i + 1]).digest()
            for i in range(0, len(leaves), 2)
        ]
    return leaves[0]
