"""Piece/block geometry (reference layer L5: piece.ts, 65 LoC).

``BLOCK_SIZE`` is the 16 KiB transfer unit (piece.ts:6). The last piece of
a torrent is short unless the total length divides evenly — the formula at
piece.ts:16-19 gets the ``length % piece_length == 0`` edge right only via
an ``||`` fallback; here it's explicit.
"""

from __future__ import annotations

from torrent_tpu_torch.codec.metainfo import InfoDict

BLOCK_SIZE = 16 * 1024  # piece.ts:6


def piece_length(info: InfoDict, index: int) -> int:
    """Actual byte length of piece ``index`` (last piece may be short).

    v2 session infos (session/v2.py) carry explicit per-piece sizes —
    in BEP 52's file-aligned piece space the LAST PIECE OF EVERY FILE
    may be short, not just the torrent's final piece."""
    if index < 0 or index >= info.num_pieces:
        raise IndexError(f"piece index {index} out of range [0, {info.num_pieces})")
    sizes = getattr(info, "piece_sizes", None)
    if sizes is not None:
        return sizes[index]
    if index < info.num_pieces - 1:
        return info.piece_length
    rem = info.length - info.piece_length * (info.num_pieces - 1)
    return rem


def num_blocks(info: InfoDict, index: int) -> int:
    """Number of 16 KiB transfer blocks in piece ``index``."""
    plen = piece_length(info, index)
    return (plen + BLOCK_SIZE - 1) // BLOCK_SIZE


def block_length(info: InfoDict, index: int, offset: int) -> int:
    """Length of the block at ``offset`` within piece ``index``."""
    plen = piece_length(info, index)
    return min(BLOCK_SIZE, plen - offset)


def validate_requested_block(info: InfoDict, index: int, offset: int, length: int) -> bool:
    """Bounds-check an inbound ``request`` message (piece.ts:21-37).

    Rejects out-of-range piece indices, non-positive or over-sized lengths
    (spec caps requests at BLOCK_SIZE), and ranges past the piece end.
    """
    if index < 0 or index >= info.num_pieces:
        return False
    if length <= 0 or length > BLOCK_SIZE:
        return False
    if offset < 0:
        return False
    return offset + length <= piece_length(info, index)


def validate_received_block(info: InfoDict, index: int, offset: int, length: int) -> bool:
    """Geometry-check an inbound ``piece`` block (piece.ts:39-65).

    A valid block starts on a BLOCK_SIZE boundary and is exactly
    BLOCK_SIZE long, except the final block of a piece which is exactly
    the remainder.
    """
    if index < 0 or index >= info.num_pieces:
        return False
    if offset < 0 or offset % BLOCK_SIZE != 0:
        return False
    plen = piece_length(info, index)
    if offset >= plen:
        return False
    expected = min(BLOCK_SIZE, plen - offset)
    return length == expected
