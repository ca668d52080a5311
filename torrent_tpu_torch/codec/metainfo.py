""".torrent metainfo parsing (reference layer L2: metainfo.ts, 148 LoC).

Parses and shape-validates a ``.torrent`` file into typed dataclasses:
normalizes ``piece length`` → ``piece_length``, splits the ``pieces`` blob
into 20-byte SHA1 digests (metainfo.ts:111), sums multi-file lengths
(metainfo.ts:125), and computes the BEP 3 infohash.

Infohash design note: the reference re-bencodes the decoded info dict and
hashes that (metainfo.ts:141-143), which only matches because its codec
preserves key order. Here the decoder reports the *byte span* of the raw
``info`` value (codec/bencode.py:bdecode_with_info_span) and the hash is
taken over the original bytes — correct for any foreign torrent regardless
of key order or duplicate quirks.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from torrent_tpu_torch.codec import valid
from torrent_tpu_torch.codec.bencode import BencodeError, bdecode, bdecode_with_info_span
from torrent_tpu_torch.utils.bytesio import partition

SHA1_LEN = 20


def parse_url_list(ul) -> tuple[str, ...]:
    """BEP 19 ``url-list``: a single URL string or a list of them.

    Shared by the v1 ``Metainfo`` and v2 ``session.v2.V2SessionMeta``
    web_seeds properties — one normalization for both planes."""
    if isinstance(ul, bytes):
        ul = [ul]
    if not isinstance(ul, list):
        return ()
    return tuple(
        u.decode("utf-8", "replace") for u in ul if isinstance(u, bytes) and u
    )


@dataclass(frozen=True)
class FileEntry:
    """One file of a multi-file torrent (metainfo.ts MultiFileFields).

    ``pad`` marks a BEP 47 padding file (``attr`` contains ``p``): its
    bytes are zeros that exist only to piece-align the next real file
    (hybrid torrents always carry them). Pad spans occupy piece space
    but are never written to or read from disk (storage/storage.py).
    """

    length: int
    path: tuple[str, ...]  # path components, decoded UTF-8
    pad: bool = False


@dataclass(frozen=True)
class InfoDict:
    """Normalized info dict (metainfo.ts:44-60).

    ``files`` is None for single-file torrents; ``length`` is always the
    total payload size (summed for multi-file, metainfo.ts:125).
    """

    name: str
    piece_length: int
    pieces: tuple[bytes, ...]  # 20-byte SHA1 digests
    length: int
    files: tuple[FileEntry, ...] | None = None

    @property
    def num_pieces(self) -> int:
        return len(self.pieces)

    @property
    def is_multi_file(self) -> bool:
        return self.files is not None


@dataclass(frozen=True)
class Metainfo:
    """Parsed .torrent (metainfo.ts Metainfo)."""

    announce: str
    info: InfoDict
    info_hash: bytes  # 20-byte SHA1 over the raw bencoded info dict
    # Raw decoded top-level dict (bytes keys) for extra fields like
    # `comment`, `creation date`, `announce-list` — preserved, not dropped.
    raw: dict = field(repr=False, default_factory=dict)

    @property
    def web_seeds(self) -> tuple[str, ...]:
        """BEP 19 ``url-list`` (single string or list of strings)."""
        return parse_url_list(self.raw.get(b"url-list"))

    @property
    def http_seeds(self) -> tuple[str, ...]:
        """BEP 17 ``httpseeds`` — the older Hoffman-style HTTP seeding
        where the server speaks ``?info_hash=...&piece=N`` instead of
        byte-range file GETs."""
        return parse_url_list(self.raw.get(b"httpseeds"))

    @property
    def similar(self) -> tuple[bytes, ...]:
        """BEP 38 ``similar``: infohashes of torrents likely to share
        identical files with this one. Read from the info dict (where an
        author binds them into the infohash) and the top level (where a
        downstream publisher may add more); order-preserving union."""
        return parse_similar(self.raw)

    @property
    def update_url(self) -> str | None:
        """BEP 39 ``update-url``: where an updated version of this
        torrent can be fetched. Info-dict placement wins (infohash-bound
        — a middleman can't redirect updates without changing the
        identity); top-level accepted as the mutable fallback."""
        return parse_update_url(self.raw)

    @property
    def collections(self) -> tuple[str, ...]:
        """BEP 38 ``collections``: publisher-chosen group names; torrents
        sharing a collection are candidates for local-file reuse."""
        return parse_collections(self.raw)


def parse_any_metainfo(data: bytes):
    """``(meta, info_hash)`` for a v1 .torrent; None when it does not
    parse. A pure-v2 (BEP 52) torrent raises ``NotImplementedError``:
    the v2 plane is a later slice of this package."""
    m = parse_metainfo(data)
    if m is not None:
        return m, m.info_hash
    # BEP 52 v2 torrents need codec/metainfo_v2.py, which this package
    # has not ported yet; a v2 torrent must not read as "not a torrent"
    try:
        decoded = bdecode(data)
    except BencodeError:
        return None
    info = decoded.get(b"info") if isinstance(decoded, dict) else None
    if isinstance(info, dict) and info.get(b"meta version") == 2:
        raise NotImplementedError("BEP 52 (v2) metainfo is not ported yet")
    return None


def _hint_sources(raw: dict):
    info = raw.get(b"info")
    return ((info if isinstance(info, dict) else {}), raw)


def parse_similar(raw: dict) -> tuple[bytes, ...]:
    """BEP 38 ``similar`` from a decoded top-level dict (shared by the v1
    ``Metainfo`` and the v2 session wrapper): info placement first, then
    top level, deduped in order."""
    out: list[bytes] = []
    for src in _hint_sources(raw):
        v = src.get(b"similar")
        if isinstance(v, list):
            for h in v:
                if isinstance(h, bytes) and len(h) in (20, 32) and h not in out:
                    out.append(h)
    return tuple(out)


def parse_collections(raw: dict) -> tuple[str, ...]:
    """BEP 38 ``collections`` from a decoded top-level dict."""
    out: list[str] = []
    for src in _hint_sources(raw):
        v = src.get(b"collections")
        if isinstance(v, list):
            for c in v:
                if isinstance(c, bytes):
                    s = c.decode("utf-8", "replace")
                    if s and s not in out:
                        out.append(s)
    return tuple(out)


def parse_update_url(raw: dict) -> str | None:
    """BEP 39 ``update-url`` from a decoded top-level dict; info-dict
    placement wins over top level."""
    for src in _hint_sources(raw):
        v = src.get(b"update-url")
        if isinstance(v, bytes) and v:
            return v.decode("utf-8", "replace")
    return None


_FILE_SHAPE = valid.obj(
    {
        b"length": valid.num(),
        b"path": valid.arr(valid.bstr()),
    }
)

_INFO_SHAPE = valid.obj(
    {
        b"name": valid.bstr(),
        b"piece length": valid.num(),
        b"pieces": valid.multiple_len_bytes(SHA1_LEN),
        b"length": valid.optional(valid.num()),
        b"files": valid.optional(valid.arr(_FILE_SHAPE)),
    }
)

_METAINFO_SHAPE = valid.obj(
    {
        b"announce": valid.bstr(),
        b"info": _INFO_SHAPE,
    }
)


def parse_metainfo(data: bytes) -> Metainfo | None:
    """Parse .torrent bytes; returns None on any failure (metainfo.ts:145-147).

    Exactly one of ``info.length`` / ``info.files`` must be present
    (single- vs multi-file mode); geometry is sanity-checked: the digest
    count must match ``ceil(length / piece_length)``.
    """
    try:
        decoded, info_span = bdecode_with_info_span(data)
    except BencodeError:
        return None
    if not _METAINFO_SHAPE(decoded):
        return None
    raw_info = decoded[b"info"]
    has_length = raw_info.get(b"length") is not None
    has_files = raw_info.get(b"files") is not None
    if has_length == has_files:  # both or neither
        return None
    if info_span is None:
        return None

    try:
        name = raw_info[b"name"].decode("utf-8")
    except UnicodeDecodeError:
        return None
    piece_length = raw_info[b"piece length"]
    if piece_length <= 0:
        return None
    pieces = tuple(partition(raw_info[b"pieces"], SHA1_LEN))

    files: tuple[FileEntry, ...] | None = None
    if has_files:
        entries = []
        total = 0
        for f in raw_info[b"files"]:
            if f[b"length"] < 0 or not f[b"path"]:
                return None
            try:
                path = tuple(p.decode("utf-8") for p in f[b"path"])
            except UnicodeDecodeError:
                return None
            attr = f.get(b"attr")
            entries.append(
                FileEntry(
                    length=f[b"length"],
                    path=path,
                    # BEP 47: attr is a string of flag chars; 'p' = pad
                    pad=isinstance(attr, bytes) and b"p" in attr,
                )
            )
            total += f[b"length"]
        files = tuple(entries)
        length = total
    else:
        length = raw_info[b"length"]
        if length < 0:
            return None

    expected_pieces = (length + piece_length - 1) // piece_length
    if expected_pieces != len(pieces):
        return None

    try:
        announce = decoded[b"announce"].decode("utf-8")
    except UnicodeDecodeError:
        return None

    start, end = info_span
    info_hash = hashlib.sha1(data[start:end]).digest()

    return Metainfo(
        announce=announce,
        info=InfoDict(
            name=name,
            piece_length=piece_length,
            pieces=pieces,
            length=length,
            files=files,
        ),
        info_hash=info_hash,
        raw=decoded,
    )


def metainfo_from_info_bytes(
    info_bytes: bytes, announce: str = "", announce_list: list[list[str]] | None = None
) -> Metainfo | None:
    """Build a full ``Metainfo`` from a bare serialized info dict.

    The magnet-link path (BEP 9): after ut_metadata delivers the verified
    info-dict bytes, wrap them in a minimal torrent envelope. The
    re-encode of the decoded dict is byte-exact (decode preserves key
    order), so the computed ``info_hash`` matches ``sha1(info_bytes)``.
    """
    from torrent_tpu_torch.codec.bencode import bencode

    envelope: dict = {b"announce": announce.encode("utf-8")}
    if announce_list:
        envelope[b"announce-list"] = [
            [t.encode("utf-8") for t in tier] for tier in announce_list
        ]
    try:
        envelope[b"info"] = bdecode(info_bytes)
    except BencodeError:
        return None
    return parse_metainfo(bencode(envelope, sort_keys=False))
