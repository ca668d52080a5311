"""Pure-v2 (BEP 52) swarm support: session-facing geometry adapter.

A copy of the reference's ``session/v2.py``. The reference's session
runtime speaks one flat piece space: ``info.pieces[i]`` is the expected
digest of piece ``i`` and bytes live at ``i * piece_length``. BitTorrent
v2 replaces that with per-file SHA-256 merkle trees — so this module
projects the v2 world into the flat space the way BEP 52 itself does for
the wire protocol:

- files are laid out in file-tree order, each starting on a piece
  boundary (v2 pieces NEVER span files — the gap after a file's last
  piece is virtual, never on disk and never on the wire);
- the expected digest of a piece is its merkle subtree root: the file's
  ``piece layers`` entry for multi-piece files, or the file's
  ``pieces root`` itself for files no larger than one piece;
- each piece carries its leaf-pad target (``piece_pad_leaves``): blocks
  per piece for multi-piece files, the file's own next-power-of-two
  block count for single-piece files (BEP 52's two padding rules).

``V2SessionMeta`` then duck-types ``codec.metainfo.Metainfo`` —
``info_hash`` is the truncated SHA-256 (what BEP 52 puts in the 68-byte
handshake and tracker announces), and ``raw`` keeps ``info`` +
``piece layers``. In this package the adapter feeds ``Storage``'s
piece-aligned layout, ``parallel/verify.py``'s v2 recheck and the
session (``Torrent``, and ``session/metadata.py`` for btmh magnets).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from torrent_tpu_torch.codec.metainfo import FileEntry
from torrent_tpu_torch.codec.metainfo_v2 import BLOCK, InfoDictV2, MetainfoV2


class V2Error(ValueError):
    pass


@dataclass(frozen=True)
class V2SessionInfo:
    """InfoDict-compatible view of a v2 torrent (flat piece space)."""

    name: str
    piece_length: int
    pieces: tuple[bytes, ...]  # 32-byte expected merkle roots per piece
    length: int  # piece-space span: last file's aligned start + its length
    payload_length: int  # true byte total (sum of file lengths)
    files: tuple[FileEntry, ...] | None
    piece_sizes: tuple[int, ...]  # actual byte length of each piece
    piece_pad_leaves: tuple[int, ...]  # merkle leaf-pad target per piece

    # flags the generic layers key off (storage alignment, piece sizes,
    # 32-byte digests) — class-level so dataclass equality ignores them
    v2 = True
    piece_aligned = True

    @property
    def num_pieces(self) -> int:
        return len(self.pieces)

    @property
    def is_multi_file(self) -> bool:
        return self.files is not None


@dataclass(frozen=True)
class V2SessionMeta:
    """Metainfo-compatible wrapper carrying the v2 identities."""

    announce: str
    info: V2SessionInfo
    info_hash: bytes  # 20-byte TRUNCATED sha-256 (wire/registry key)
    info_hash_v2: bytes  # full 32-byte infohash
    meta_v2: MetainfoV2 | None = field(repr=False, default=None)
    raw: dict = field(repr=False, default_factory=dict)

    @property
    def web_seeds(self) -> tuple[str, ...]:
        """BEP 19 ``url-list``. v2's aligned piece space makes webseeds
        WORK with the generic per-segment fetcher: pieces never span
        files, piece sizes never reach into the alignment gaps, so every
        piece maps to exactly one ranged GET inside one file's URL."""
        from torrent_tpu_torch.codec.metainfo import parse_url_list

        return parse_url_list(self.raw.get(b"url-list"))

    @property
    def http_seeds(self) -> tuple[str, ...]:
        """BEP 17 ``httpseeds`` (piece-keyed GETs) — same parsing as v1."""
        from torrent_tpu_torch.codec.metainfo import parse_url_list

        return parse_url_list(self.raw.get(b"httpseeds"))

    @property
    def similar(self) -> tuple[bytes, ...]:
        """BEP 38 hints (the CLI writes them at the top level for v2)."""
        from torrent_tpu_torch.codec.metainfo import parse_similar

        return parse_similar(self.raw)

    @property
    def collections(self) -> tuple[str, ...]:
        from torrent_tpu_torch.codec.metainfo import parse_collections

        return parse_collections(self.raw)

    @property
    def update_url(self) -> str | None:
        """BEP 39 — so ``check_for_update`` works for v2 torrents too."""
        from torrent_tpu_torch.codec.metainfo import parse_update_url

        return parse_update_url(self.raw)


def _pad_target(length: int) -> int:
    """Leaf-pad target for a file no larger than one piece: the next
    power of two of its OWN block count (BEP 52)."""
    nblocks = max(1, -(-length // BLOCK))
    return 1 << max(0, (nblocks - 1).bit_length())


def v2_session_info(
    info: InfoDictV2, piece_layers: dict[bytes, tuple[bytes, ...]]
) -> V2SessionInfo:
    """Flatten a v2 info dict + layers into session piece geometry."""
    plen = info.piece_length
    lpp = plen // BLOCK
    pieces: list[bytes] = []
    sizes: list[int] = []
    pads: list[int] = []
    entries: list[FileEntry] = []
    span_end = 0
    pos = 0  # aligned piece-space cursor
    for f in info.files:
        entries.append(FileEntry(length=f.length, path=f.path))
        if f.length == 0:
            continue
        n = -(-f.length // plen)
        if n == 1:
            pieces.append(f.pieces_root)
            sizes.append(f.length)
            pads.append(_pad_target(f.length))
        else:
            layer = piece_layers.get(f.pieces_root)
            if layer is None or len(layer) != n:
                raise V2Error(
                    f"file {'/'.join(f.path)}: piece layer missing or wrong length"
                )
            pieces.extend(layer)
            sizes.extend([plen] * (n - 1))
            sizes.append(f.length - (n - 1) * plen)
            pads.extend([lpp] * n)
        span_end = pos + f.length
        pos += n * plen
    single = len(entries) == 1 and entries[0].path == (info.name,)
    return V2SessionInfo(
        name=info.name,
        piece_length=plen,
        pieces=tuple(pieces),
        length=span_end,
        payload_length=info.length,
        files=None if single else tuple(entries),
        piece_sizes=tuple(sizes),
        piece_pad_leaves=tuple(pads),
    )


def v2_session_meta(meta: MetainfoV2) -> V2SessionMeta:
    """Session wrapper for a parsed v2 ``.torrent``."""
    return V2SessionMeta(
        announce=meta.announce or "",
        info=v2_session_info(meta.info, meta.piece_layers),
        info_hash=meta.truncated_info_hash,
        info_hash_v2=meta.info_hash_v2,
        meta_v2=meta,
        raw=meta.raw,
    )


def v2_session_meta_from_parts(
    info_bytes: bytes,
    info_hash_v2: bytes,
    piece_layers: dict[bytes, tuple[bytes, ...]],
    announce: str = "",
) -> V2SessionMeta:
    """Session wrapper from a magnet join: fetched info-dict bytes
    (already SHA-256-validated against the btmh topic) + hash-transfer
    piece layers (each already proven against its ``pieces root``)."""
    from torrent_tpu_torch.codec.bencode import bdecode
    from torrent_tpu_torch.codec.metainfo_v2 import parse_v2_info_dict

    decoded = bdecode(info_bytes, strict=False)
    parsed = parse_v2_info_dict(decoded if isinstance(decoded, dict) else None)
    if parsed is None:
        raise V2Error("fetched info dict is not a valid BEP 52 info dict")
    raw: dict = {b"info": decoded}
    if piece_layers:
        raw[b"piece layers"] = {r: b"".join(l) for r, l in piece_layers.items()}
    meta = MetainfoV2(
        announce=announce or None,
        info=parsed,
        info_hash_v2=info_hash_v2,
        piece_layers=dict(piece_layers),
        raw=raw,
    )
    return V2SessionMeta(
        announce=announce,
        info=v2_session_info(parsed, dict(piece_layers)),
        info_hash=info_hash_v2[:20],
        info_hash_v2=info_hash_v2,
        meta_v2=meta,
        raw=raw,
    )


def multi_piece_roots(info: InfoDictV2) -> list[tuple[bytes, int]]:
    """``(pieces_root, n_pieces)`` for every file larger than one piece —
    the set a magnet joiner must fetch piece layers for."""
    plen = info.piece_length
    out = []
    for f in info.files:
        if f.length > plen:
            out.append((f.pieces_root, -(-f.length // plen)))
    return out
