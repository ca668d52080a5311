"""BEP 10 extension protocol + BEP 9 ut_metadata metadata exchange.

The reference stops at the nine BEP 3 messages (protocol.ts:69-161) and
lists magnet links as roadmap (README.md:39). This module supplies the
wire layer that makes them work:

- **BEP 10**: reserved-bit 20 in the handshake advertises support; message
  id 20 carries ``(ext_id, bencoded payload)``. Ext id 0 is the extended
  handshake ``{m: {name: id, ...}, metadata_size?, v?}`` through which
  peers agree on ids for concrete extensions.
- **BEP 9 (ut_metadata)**: the info dict, serialized, split into 16 KiB
  pieces, exchanged via ``{msg_type: request(0)|data(1)|reject(2),
  piece: n}`` dicts; a ``data`` payload is the dict immediately followed
  by the raw piece bytes. The fetched blob is SHA1-verified against the
  magnet's info hash before use.

The session layer (session/torrent.py) serves ut_metadata requests from
any torrent with a full metainfo, so every seeder is a metadata provider;
session/metadata.py drives the fetching side for magnet joins.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

from torrent_tpu_torch.codec.bencode import BencodeError, bdecode, bdecode_prefix, bencode
from torrent_tpu_torch.net.types import (
    pack_compact_v4 as _pack_compact_v4,
    pack_compact_v6 as _pack_compact_v6,
    unpack_compact_v4 as _unpack_compact_v4,
    unpack_compact_v6 as _unpack_compact_v6,
)

# BEP 9: metadata is exchanged in 16 KiB pieces.
METADATA_PIECE_SIZE = 16 * 1024
# Upper bound we'll accept for a peer-advertised metadata_size: a 64 MiB
# info dict is far beyond any real torrent (multi-TB torrents with tiny
# pieces stay under ~10 MiB of piece hashes).
MAX_METADATA_SIZE = 64 * 1024 * 1024

# Extended-handshake message names → our local ext ids. Id 0 is reserved
# for the handshake itself by BEP 10.
UT_METADATA = b"ut_metadata"
UT_PEX = b"ut_pex"
UT_HOLEPUNCH = b"ut_holepunch"
LT_DONTHAVE = b"lt_donthave"
LOCAL_EXT_IDS = {UT_METADATA: 1, UT_PEX: 2, UT_HOLEPUNCH: 3, LT_DONTHAVE: 4}

# Reserved-byte mask: bit 20 counting from the MSB of the 8-byte field,
# i.e. byte 5, value 0x10 (BEP 10).
EXTENSION_RESERVED_BYTE = 5
EXTENSION_RESERVED_BIT = 0x10


class MsgType:
    """ut_metadata msg_type values (BEP 9)."""

    REQUEST = 0
    DATA = 1
    REJECT = 2


def supports_extensions(reserved: bytes) -> bool:
    return len(reserved) == 8 and bool(reserved[EXTENSION_RESERVED_BYTE] & EXTENSION_RESERVED_BIT)


def extension_reserved() -> bytes:
    r = bytearray(8)
    r[EXTENSION_RESERVED_BYTE] |= EXTENSION_RESERVED_BIT
    return bytes(r)


@dataclass
class ExtensionState:
    """Per-peer BEP 10 negotiation state."""

    enabled: bool = False  # peer set reserved bit 20
    handshaken: bool = False  # we received their ext handshake
    ut_metadata_id: int = 0  # peer's id for ut_metadata (0 = unsupported)
    metadata_size: int = 0  # peer-advertised info-dict size in bytes
    ut_pex_id: int = 0  # peer's id for ut_pex (BEP 11; 0 = unsupported)
    ut_holepunch_id: int = 0  # peer's id for ut_holepunch (BEP 55)
    lt_donthave_id: int = 0  # peer's id for lt_donthave (BEP 54)
    listen_port: int = 0  # peer-advertised 'p' — its real dialable port


def encode_extended_handshake(
    metadata_size: int | None = None,
    version: str = "",
    listen_port: int = 0,
    exclude: tuple[bytes, ...] = (),
) -> bytes:
    """Payload for extended message id 0 (our side of the negotiation).

    ``listen_port`` is BEP 10's ``p`` key — without it an inbound peer's
    dialable port is unknowable (its TCP source port is ephemeral) and
    PEX gossip about it would be dead addresses. ``exclude`` drops
    extensions from the advertised ``m`` dict (BEP 27 private torrents
    must not advertise ut_pex).
    """
    d: dict = {
        b"m": {name: eid for name, eid in LOCAL_EXT_IDS.items() if name not in exclude}
    }
    if metadata_size is not None:
        d[b"metadata_size"] = metadata_size
    if version:
        d[b"v"] = version.encode()
    if 0 < listen_port < 65536:
        d[b"p"] = listen_port
    return bencode(d)


def decode_extended_handshake(payload: bytes, state: ExtensionState) -> None:
    """Apply a peer's extended handshake to its negotiation state.

    Malformed handshakes degrade to "no extensions" rather than raising:
    BEP 10 is advisory and a bad dict just means we won't use them.
    """
    try:
        d = bdecode(payload)
    except BencodeError:
        return
    if not isinstance(d, dict):
        return
    state.handshaken = True
    m = d.get(b"m")
    if isinstance(m, dict):
        mid = m.get(UT_METADATA)
        if isinstance(mid, int) and 0 < mid < 256:
            state.ut_metadata_id = mid
        pid = m.get(UT_PEX)
        if isinstance(pid, int) and 0 < pid < 256:
            state.ut_pex_id = pid
        hid = m.get(UT_HOLEPUNCH)
        if isinstance(hid, int) and 0 < hid < 256:
            state.ut_holepunch_id = hid
        did = m.get(LT_DONTHAVE)
        if isinstance(did, int) and 0 < did < 256:
            state.lt_donthave_id = did
    size = d.get(b"metadata_size")
    if isinstance(size, int) and 0 < size <= MAX_METADATA_SIZE:
        state.metadata_size = size
    lp = d.get(b"p")
    if isinstance(lp, int) and 0 < lp < 65536:
        state.listen_port = lp


# ------------------------------------------------------------ ut_metadata


def num_metadata_pieces(metadata_size: int) -> int:
    return max(1, math.ceil(metadata_size / METADATA_PIECE_SIZE))


def encode_metadata_request(piece: int) -> bytes:
    return bencode({b"msg_type": MsgType.REQUEST, b"piece": piece})


def encode_metadata_data(piece: int, total_size: int, data: bytes) -> bytes:
    return bencode({b"msg_type": MsgType.DATA, b"piece": piece, b"total_size": total_size}) + data


def encode_metadata_reject(piece: int) -> bytes:
    return bencode({b"msg_type": MsgType.REJECT, b"piece": piece})


@dataclass(frozen=True)
class MetadataMessage:
    msg_type: int
    piece: int
    total_size: int = 0
    data: bytes = b""


def decode_metadata_message(payload: bytes) -> MetadataMessage | None:
    """Parse a ut_metadata payload; None if malformed.

    BEP 9's framing quirk: a ``data`` message is a bencoded dict with the
    raw piece bytes appended immediately after the dict's final ``e`` —
    so the decoder must report how much of the buffer the dict consumed.
    """
    try:
        d, consumed = bdecode_prefix(payload)
    except BencodeError:
        return None
    if not isinstance(d, dict):
        return None
    msg_type = d.get(b"msg_type")
    piece = d.get(b"piece")
    if not isinstance(msg_type, int) or not isinstance(piece, int) or piece < 0:
        return None
    total_size = d.get(b"total_size", 0)
    if not isinstance(total_size, int) or total_size < 0:
        total_size = 0
    return MetadataMessage(
        msg_type=msg_type, piece=piece, total_size=total_size, data=payload[consumed:]
    )


class MetadataAssembler:
    """Collects ut_metadata data pieces and verifies the finished dict.

    One per magnet fetch; feed ``MetadataMessage``s with
    ``add(msg)`` and poll ``complete`` / ``result(info_hash)``.
    """

    def __init__(self, metadata_size: int):
        if not 0 < metadata_size <= MAX_METADATA_SIZE:
            raise ValueError(f"implausible metadata_size {metadata_size}")
        self.size = metadata_size
        self.n_pieces = num_metadata_pieces(metadata_size)
        self._pieces: dict[int, bytes] = {}

    @property
    def complete(self) -> bool:
        return len(self._pieces) == self.n_pieces

    def missing(self) -> list[int]:
        return [i for i in range(self.n_pieces) if i not in self._pieces]

    def add(self, msg: MetadataMessage) -> bool:
        """Ingest a DATA message; True if it advanced the assembly."""
        if msg.msg_type != MsgType.DATA or not 0 <= msg.piece < self.n_pieces:
            return False
        want = (
            self.size - msg.piece * METADATA_PIECE_SIZE
            if msg.piece == self.n_pieces - 1
            else METADATA_PIECE_SIZE
        )
        data = msg.data[:want] if len(msg.data) > want else msg.data
        if len(data) != want or msg.piece in self._pieces:
            return False
        self._pieces[msg.piece] = data
        return True

    def result(self, info_hash: bytes) -> bytes | None:
        """The verified info-dict bytes, or None if hash check fails."""
        if not self.complete:
            return None
        blob = b"".join(self._pieces[i] for i in range(self.n_pieces))
        if hashlib.sha1(blob).digest() != info_hash:
            self._pieces.clear()  # poisoned; refetch from scratch
            return None
        return blob

    def result_v2(self, info_hash_v2: bytes) -> bytes | None:
        """v2 variant: verify against the full 32-byte SHA-256 infohash
        (btmh magnets carry no SHA-1 to check against)."""
        if not self.complete:
            return None
        blob = b"".join(self._pieces[i] for i in range(self.n_pieces))
        if hashlib.sha256(blob).digest() != info_hash_v2:
            self._pieces.clear()
            return None
        return blob


# -------------------------------------------------------------- ut_pex


def encode_pex(added, dropped=()) -> bytes:
    """BEP 11 ut_pex payload: compact added/dropped peer deltas, v4 in
    ``added``/``dropped`` and v6 in ``added6``/``dropped6`` (each packer
    skips the other family, so callers pass mixed sets)."""
    packed_added = _pack_compact_v4(added)
    packed_added6 = _pack_compact_v6(added)
    d = {
        b"added": packed_added,
        b"added.f": bytes(len(packed_added) // 6),  # no flags
        b"dropped": _pack_compact_v4(dropped),
    }
    if packed_added6:
        d[b"added6"] = packed_added6
        d[b"added6.f"] = bytes(len(packed_added6) // 18)
    dropped6 = _pack_compact_v6(dropped)
    if dropped6:
        d[b"dropped6"] = dropped6
    return bencode(d)


@dataclass(frozen=True)
class PexMessage:
    added: tuple[tuple[str, int], ...]
    dropped: tuple[tuple[str, int], ...]


def decode_pex(payload: bytes) -> PexMessage | None:
    """Parse a ut_pex payload (v4 + v6 fields); None if malformed
    (total, never raises)."""
    try:
        d = bdecode(payload)
    except BencodeError:
        return None
    if not isinstance(d, dict):
        return None
    added = d.get(b"added", b"")
    dropped = d.get(b"dropped", b"")
    added6 = d.get(b"added6", b"")
    dropped6 = d.get(b"dropped6", b"")
    if not all(isinstance(x, bytes) for x in (added, dropped, added6, dropped6)):
        return None
    return PexMessage(
        added=tuple(_unpack_compact_v4(added)) + tuple(_unpack_compact_v6(added6)),
        dropped=tuple(_unpack_compact_v4(dropped))
        + tuple(_unpack_compact_v6(dropped6)),
    )


def metadata_piece(info_bytes: bytes, piece: int) -> bytes | None:
    """Server side: slice piece ``piece`` out of a serialized info dict."""
    n = num_metadata_pieces(len(info_bytes))
    if not 0 <= piece < n:
        return None
    return info_bytes[piece * METADATA_PIECE_SIZE : (piece + 1) * METADATA_PIECE_SIZE]


# ------------------------------------------------------------ ut_holepunch


class HolepunchType:
    """BEP 55 message types."""

    RENDEZVOUS = 0x00
    CONNECT = 0x01
    ERROR = 0x02


class HolepunchError:
    """BEP 55 error codes (carried in ERROR messages)."""

    NO_SUCH_PEER = 0x01
    NOT_CONNECTED = 0x02
    NO_SUPPORT = 0x03
    NO_SELF = 0x04


@dataclass(frozen=True)
class HolepunchMessage:
    """One BEP 55 frame: <type u8><addr_type u8><addr><port u16>[<err u32>].

    The NAT-traversal rendezvous: a peer connected to both endpoints
    relays simultaneous CONNECT messages so both sides dial at once and
    punch their NAT mappings open. addr_type 0x00 = IPv4, 0x01 = IPv6.
    """

    msg_type: int
    addr: tuple[str, int]
    err_code: int = 0


def encode_holepunch(msg: HolepunchMessage) -> bytes:
    import socket as _socket

    host, port = msg.addr
    try:
        packed = _socket.inet_pton(_socket.AF_INET, host)
        addr_type = 0x00
    except OSError:
        packed = _socket.inet_pton(_socket.AF_INET6, host)
        addr_type = 0x01
    out = bytes((msg.msg_type, addr_type)) + packed + port.to_bytes(2, "big")
    if msg.msg_type == HolepunchType.ERROR:
        out += msg.err_code.to_bytes(4, "big")
    return out


def decode_holepunch(payload: bytes) -> HolepunchMessage | None:
    """Parse a ut_holepunch payload; None if malformed (never raises)."""
    import socket as _socket

    if len(payload) < 2:
        return None
    msg_type, addr_type = payload[0], payload[1]
    if msg_type not in (
        HolepunchType.RENDEZVOUS,
        HolepunchType.CONNECT,
        HolepunchType.ERROR,
    ):
        return None
    alen = 4 if addr_type == 0x00 else 16 if addr_type == 0x01 else None
    if alen is None or len(payload) < 2 + alen + 2:
        return None
    try:
        host = _socket.inet_ntop(
            _socket.AF_INET if alen == 4 else _socket.AF_INET6,
            payload[2 : 2 + alen],
        )
    except (OSError, ValueError):
        return None
    port = int.from_bytes(payload[2 + alen : 4 + alen], "big")
    err = 0
    if msg_type == HolepunchType.ERROR:
        if len(payload) < 8 + alen:
            return None
        err = int.from_bytes(payload[4 + alen : 8 + alen], "big")
    return HolepunchMessage(msg_type=msg_type, addr=(host, port), err_code=err)


# ------------------------------------------------------------ lt_donthave


def encode_donthave(index: int) -> bytes:
    """BEP 54 payload: the piece index we no longer have, 4 bytes BE.

    The inverse of a Have — BEP 3 has no way to retract an announced
    piece, so a seed that loses data (disk error under an announced
    piece) can only mislead peers without this.
    """
    return index.to_bytes(4, "big")


def decode_donthave(payload: bytes) -> int | None:
    """Parse a lt_donthave payload; None if malformed (never raises)."""
    if len(payload) != 4:
        return None
    return int.from_bytes(payload, "big")
