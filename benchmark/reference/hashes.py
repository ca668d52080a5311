"""Plain digests of the generated bytes: v1 pieces (SHA-1, BEP 3) and
v2 leaves, piece roots and file roots (SHA-256 merkle trees, BEP 52).

``hashlib`` releases the interpreter lock on large inputs, so the bulk
helpers hash pieces on a few threads.
"""

from __future__ import annotations

import hashlib
from concurrent.futures import ThreadPoolExecutor

LEAF = 16 * 1024  # BEP 52 leaf block
ZERO = b"\x00" * 32  # BEP 52 pads a tree with leaves whose hash is zero
THREADS = 8


def map_threads(fn, items: list) -> list:
    if len(items) < 2 * THREADS:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(THREADS) as pool:
        return list(pool.map(fn, items, chunksize=max(1, len(items) // (4 * THREADS))))


def sha1_pieces(buf, piece_length: int) -> list[bytes]:
    """SHA-1 of each ``piece_length`` slice of ``buf`` (the last may be short)."""
    mv = memoryview(buf)
    return map_threads(lambda s: hashlib.sha1(mv[s : s + piece_length]).digest(), list(range(0, len(mv), piece_length)))


def merkle_root(nodes: list[bytes], width: int) -> bytes:
    """Root of a tree over ``nodes`` padded with zero hashes to ``width``
    (a power of two) nodes."""
    if width < 1 or width & (width - 1) or len(nodes) > width:
        raise ValueError(f"{len(nodes)} nodes do not fit a tree of width {width}")
    level = list(nodes) + [ZERO] * (width - len(nodes))
    while len(level) > 1:
        level = [hashlib.sha256(level[i] + level[i + 1]).digest() for i in range(0, len(level), 2)]
    return level[0]


def leaf_hashes(data) -> list[bytes]:
    """SHA-256 of each 16 KiB block; the last block is hashed as it is, short."""
    mv = memoryview(data)
    return [hashlib.sha256(mv[i : i + LEAF]).digest() for i in range(0, len(mv), LEAF)] or [hashlib.sha256(b"").digest()]


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def v2_piece_roots(buf, piece_length: int) -> list[bytes]:
    """The piece layer of one file larger than a piece: each piece's
    subtree root over ``piece_length / LEAF`` leaves, the last piece's
    padded with zero leaves."""
    mv = memoryview(buf)
    per_piece = piece_length // LEAF
    return map_threads(
        lambda s: merkle_root(leaf_hashes(mv[s : s + piece_length]), per_piece),
        list(range(0, len(mv), piece_length)),
    )


def v2_file_root(piece_roots: list[bytes], piece_length: int) -> bytes:
    """``pieces root`` of a multi-piece file: the tree over all its leaves
    padded with zero leaves to a power of two, computed from the piece
    layer (a whole zero piece subtree has the root of ``piece_length /
    LEAF`` zero leaves)."""
    zero_piece = merkle_root([], piece_length // LEAF)
    width = next_pow2(len(piece_roots))
    level = list(piece_roots) + [zero_piece] * (width - len(piece_roots))
    while len(level) > 1:
        level = [hashlib.sha256(level[i] + level[i + 1]).digest() for i in range(0, len(level), 2)]
    return level[0]


def v2_small_file_root(data) -> bytes:
    """``pieces root`` of a file no larger than one piece: its leaves
    padded with zero leaves to the next power of two of its own count."""
    leaves = leaf_hashes(data)
    return merkle_root(leaves, next_pow2(len(leaves)))
