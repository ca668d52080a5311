"""BitTorrent v2 (BEP 52) metainfo: file trees, piece layers, sha256 roots.

The reference is v1-only (`metainfo.ts` knows nothing of BEP 52) — this
module is beyond-parity surface. v2 replaces the flat ``pieces`` blob
with a per-file SHA-256 merkle tree:

- ``info["meta version"] = 2`` and ``info["file tree"]`` — a nested dict
  of path components; each file node is ``{b"": {length, pieces root}}``.
- top-level ``piece layers`` — for every file larger than one piece, the
  subtree roots at piece height, concatenated 32-byte digests keyed by
  the file's ``pieces root``.
- the v2 infohash is SHA-256 over the raw bencoded info span (truncated
  to 20 bytes on the wire where v1 compatibility demands it).

Pure codec here (parse/encode/validate); the batched hashing/verify
pipeline lives in ``models/v2.py``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from torrent_tpu_torch.codec.bencode import BencodeError, bdecode_with_info_span, bencode

SHA256_LEN = 32
BLOCK = 16384  # BEP 52 leaf block size


@dataclass(frozen=True)
class V2File:
    path: tuple[str, ...]
    length: int
    pieces_root: bytes  # 32-byte SHA-256 merkle root

    def num_pieces(self, piece_length: int) -> int:
        return max(1, -(-self.length // piece_length)) if self.length else 0


@dataclass(frozen=True)
class InfoDictV2:
    name: str
    piece_length: int
    files: tuple[V2File, ...]
    private: bool = False  # BEP 27 — inside info, affects the infohash

    @property
    def length(self) -> int:
        return sum(f.length for f in self.files)


@dataclass(frozen=True)
class MetainfoV2:
    announce: str | None
    info: InfoDictV2
    info_hash_v2: bytes  # 32-byte SHA-256 over the raw info span
    # file's pieces_root -> per-piece subtree roots (files > piece_length)
    piece_layers: dict[bytes, tuple[bytes, ...]] = field(repr=False, default_factory=dict)
    raw: dict = field(repr=False, default_factory=dict)

    @property
    def truncated_info_hash(self) -> bytes:
        """20-byte truncation used where v1-shaped infohashes are needed
        (tracker/DHT wire compatibility, BEP 52 §"infohash")."""
        return self.info_hash_v2[:20]


def valid_path_component(name: str) -> bool:
    """A BEP 52 path component: a plain UTF-8 name that cannot escape a
    target directory when joined."""
    if name in ("", ".", "..") or any(c in name for c in ("/", "\\", "\x00")):
        return False
    try:
        name.encode("utf-8")
    except UnicodeEncodeError:  # surrogateescape names from os.walk
        return False
    return True


def _walk_file_tree(node: dict, prefix: tuple[str, ...], out: list[V2File]) -> bool:
    """Depth-first over the nested ``file tree`` dict. Returns False on a
    malformed node (the whole parse then fails closed)."""
    for key, child in node.items():
        if not isinstance(key, bytes) or not isinstance(child, dict):
            return False
        if key == b"":
            return False  # a file marker may not appear amid siblings here
        name = key.decode("utf-8", "replace")
        # fail closed on hostile path components: anything that could
        # escape a target directory when joined rejects the whole torrent
        if not valid_path_component(name):
            return False
        marker = child.get(b"")
        if marker is not None:
            if set(child.keys()) != {b""} or not isinstance(marker, dict):
                return False
            length = marker.get(b"length")
            root = marker.get(b"pieces root")
            if not isinstance(length, int) or length < 0:
                return False
            if length > 0 and (not isinstance(root, bytes) or len(root) != SHA256_LEN):
                return False
            out.append(
                V2File(
                    path=prefix + (name,),
                    length=length,
                    pieces_root=root if isinstance(root, bytes) else b"\x00" * SHA256_LEN,
                )
            )
        else:
            if not _walk_file_tree(child, prefix + (name,), out):
                return False
    return True


def parse_v2_info_dict(info) -> InfoDictV2 | None:
    """Shape-validate a decoded BEP 52 info dict (bytes-keyed) alone.

    The info-only entry point for magnet joins, where the dict arrives
    via ut_metadata and the piece layers come separately over BEP 52
    hash transfer. Fail-closed: None on any malformation.
    """
    if not isinstance(info, dict) or info.get(b"meta version") != 2:
        return None
    name = info.get(b"name")
    plen = info.get(b"piece length")
    tree = info.get(b"file tree")
    if (
        not isinstance(name, bytes)
        or not isinstance(plen, int)
        or plen < BLOCK
        or plen & (plen - 1)  # must be a power of two (BEP 52)
        or not isinstance(tree, dict)
    ):
        return None
    files: list[V2File] = []
    if not _walk_file_tree(tree, (), files):
        return None
    return InfoDictV2(
        name=name.decode("utf-8", "replace"),
        piece_length=plen,
        files=tuple(files),
        private=info.get(b"private") == 1,
    )


def parse_metainfo_v2(data: bytes) -> MetainfoV2 | None:
    """Parse a v2 (or hybrid) .torrent; None on anything malformed.

    Mirrors the fail-closed contract of ``parse_metainfo``
    (metainfo.ts:145-147): no exceptions escape for bad input.
    """
    try:
        root, info_span = bdecode_with_info_span(data)
    except BencodeError:
        return None
    if not isinstance(root, dict) or info_span is None:
        return None
    span_start, span_end = info_span
    info = root.get(b"info")
    parsed_info = parse_v2_info_dict(info)
    if parsed_info is None:
        return None
    plen = parsed_info.piece_length
    files = parsed_info.files

    layers_raw = root.get(b"piece layers", {})
    if not isinstance(layers_raw, dict):
        return None
    piece_layers: dict[bytes, tuple[bytes, ...]] = {}
    for k, v in layers_raw.items():
        if (
            not isinstance(k, bytes)
            or len(k) != SHA256_LEN
            or not isinstance(v, bytes)
            or len(v) % SHA256_LEN
        ):
            return None
        piece_layers[k] = tuple(v[i : i + SHA256_LEN] for i in range(0, len(v), SHA256_LEN))

    # every multi-piece file must have its layer, with the right count
    for f in files:
        if f.length > plen:
            layer = piece_layers.get(f.pieces_root)
            if layer is None or len(layer) != f.num_pieces(plen):
                return None

    announce = root.get(b"announce")
    return MetainfoV2(
        announce=announce.decode("utf-8", "replace") if isinstance(announce, bytes) else None,
        info=parsed_info,
        info_hash_v2=hashlib.sha256(data[span_start:span_end]).digest(),
        piece_layers=piece_layers,
        raw=root,
    )


def encode_metainfo_v2(
    info: InfoDictV2,
    piece_layers: dict[bytes, tuple[bytes, ...]],
    announce: str | None = None,
    comment: str | None = None,
    announce_list: list[list[str]] | None = None,
    web_seeds: list[str] | None = None,
    v1_pieces: list[bytes] | None = None,
    v1_files: list[dict] | None = None,
    v1_length: int | None = None,
) -> bytes:
    """Bencode a v2 (or, with the ``v1_*`` fields, hybrid) .torrent.

    ``comment``/``announce_list`` (BEP 12) / ``web_seeds`` (BEP 19) are
    top-level fields exactly as in v1; ``info.private`` (BEP 27) goes
    inside the info dict so it is covered by the infohash. Passing
    ``v1_pieces`` plus ``v1_files`` (multi-file, with BEP 47 pad entries)
    or ``v1_length`` (single-file) adds the v1 generation's fields to the
    same info dict — the BEP 52 upgrade path, one blob both client
    generations read, two infohashes (sha1/sha256 of the same span).
    """
    tree: dict = {}
    for f in info.files:
        node = tree
        for part in f.path:
            node = node.setdefault(part.encode(), {})
        marker: dict = {b"length": f.length}
        if f.length > 0:
            marker[b"pieces root"] = f.pieces_root
        node[b""] = marker
    info_dict: dict = {
        b"meta version": 2,
        b"name": info.name.encode(),
        b"piece length": info.piece_length,
        b"file tree": tree,
    }
    if v1_pieces is not None:
        info_dict[b"pieces"] = b"".join(v1_pieces)
        if v1_files is not None:
            info_dict[b"files"] = v1_files
        else:
            info_dict[b"length"] = v1_length or 0
    if info.private:
        info_dict[b"private"] = 1
    root: dict = {b"info": info_dict}
    if piece_layers:
        root[b"piece layers"] = {
            k: b"".join(v) for k, v in piece_layers.items()
        }
    if announce:
        root[b"announce"] = announce.encode()
    if comment:
        root[b"comment"] = comment.encode()
    if announce_list:
        root[b"announce-list"] = [[t.encode() for t in tier] for tier in announce_list]
    if web_seeds:
        root[b"url-list"] = [u.encode() for u in web_seeds]
    return bencode(root)
