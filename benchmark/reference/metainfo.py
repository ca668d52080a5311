"""Plain metainfo authoring: single-file v1 (BEP 3) and pure v2 (BEP 52)
torrents, as bytes the port parses like any ``.torrent``."""

from __future__ import annotations

from benchmark.reference.bencode import bencode
from benchmark.reference.hashes import v2_file_root

ANNOUNCE = b"http://127.0.0.1:1/announce"  # never contacted: a recheck announces nothing


def v1_single_file(name: str, length: int, piece_length: int, digests: list[bytes]) -> bytes:
    """A v1 torrent of one file of ``length`` bytes with these SHA-1 piece digests."""
    if len(digests) != -(-length // piece_length):
        raise ValueError(f"{len(digests)} digests for {length} bytes at {piece_length}")
    info = {b"name": name, b"length": length, b"piece length": piece_length, b"pieces": b"".join(digests)}
    return bencode({b"announce": ANNOUNCE, b"info": info})


def v2_single_file(name: str, length: int, piece_length: int, piece_roots: list[bytes], small_root: bytes | None = None) -> bytes:
    """A pure v2 torrent of one file: its file tree entry and, for a file
    larger than one piece, its piece layer (``piece_roots``). A file no
    larger than a piece takes its own root (``small_root``) and no layer."""
    if length > piece_length:
        root = v2_file_root(piece_roots, piece_length)
        layers = {root: b"".join(piece_roots)}
    else:
        root, layers = small_root, {}
    info = {
        b"name": name,
        b"meta version": 2,
        b"piece length": piece_length,
        b"file tree": {name: {b"": {b"length": length, b"pieces root": root}}},
    }
    return bencode({b"announce": ANNOUNCE, b"info": info, b"piece layers": layers})

