"""Peer wire protocol (ref L4: protocol.ts, 271 LoC) on asyncio streams.

The 68-byte handshake is split into send / read-infohash / read-peerid
phases so an accepting client can route on the info hash (and drop
unknown torrents) *before* replying (protocol.ts:36-67, client.ts:85-104).

All nine standard messages (BEP 3) are length-prefixed; ``read_message``
demuxes with bounds checks, skips unknown ids **iteratively** (the
reference recursed, unbounded on hostile streams — SURVEY §8.12), and
returns ``None`` on EOF/reset (protocol.ts:267-270).
"""

from __future__ import annotations

import asyncio
import enum
import struct
from dataclasses import dataclass

from torrent_tpu_torch.net.constants import PROTOCOL_STRING
from torrent_tpu_torch.utils.bitfield import Bitfield
from torrent_tpu_torch.utils.bytesio import read_int, write_int

# Pre-compiled packers for the bulk-transfer hot path: Piece/Request
# dominate a fast swarm (one of each per 16 KiB block), and the profile
# showed the generic read_int/write_int pairs as measurable per-message
# cost at 100+ MiB/s. Cold messages keep the readable generic forms.
_II = struct.Struct(">II")
_III = struct.Struct(">III")
_PIECE_HDR = struct.Struct(">IBII")  # frame len | id | index | begin
_REQ_FRAME = struct.Struct(">IBIII")  # frame len | id | index | begin | length


class ProtocolError(Exception):
    pass


class MsgId(enum.IntEnum):
    """(protocol.ts:11-23). KEEPALIVE is a length-0 frame, no id byte."""

    CHOKE = 0
    UNCHOKE = 1
    INTERESTED = 2
    NOT_INTERESTED = 3
    HAVE = 4
    BITFIELD = 5
    REQUEST = 6
    PIECE = 7
    CANCEL = 8
    # BEP 6 fast extension (reserved bit 0x04 in byte 7); the reference
    # stops at the nine BEP 3 messages (protocol.ts:202-209)
    SUGGEST_PIECE = 13
    HAVE_ALL = 14
    HAVE_NONE = 15
    REJECT_REQUEST = 16
    ALLOWED_FAST = 17
    EXTENDED = 20  # BEP 10 extension protocol (net/extension.py)
    # BEP 52 merkle hash transfer (v2/hybrid swarms; models/hashes.py)
    HASH_REQUEST = 21
    HASHES = 22
    HASH_REJECT = 23


# Sanity cap on inbound frames: a piece message is 9 + 16 KiB; bitfields
# for even million-piece torrents are ~128 KiB. Anything past 256 KiB+16
# is hostile or corrupt.
MAX_MESSAGE_LEN = 256 * 1024 + 16


@dataclass(frozen=True)
class KeepAlive:
    pass


@dataclass(frozen=True)
class Choke:
    pass


@dataclass(frozen=True)
class Unchoke:
    pass


@dataclass(frozen=True)
class Interested:
    pass


@dataclass(frozen=True)
class NotInterested:
    pass


@dataclass(frozen=True)
class Have:
    index: int


@dataclass(frozen=True)
class BitfieldMsg:
    raw: bytes


@dataclass(frozen=True)
class Request:
    index: int
    begin: int
    length: int


@dataclass(frozen=True)
class Piece:
    index: int
    begin: int
    block: bytes


@dataclass(frozen=True)
class Cancel:
    index: int
    begin: int
    length: int


@dataclass(frozen=True)
class SuggestPiece:
    """BEP 6: a hint that ``index`` would be a good next pick (e.g. the
    sender has it cached)."""

    index: int


@dataclass(frozen=True)
class HaveAll:
    """BEP 6: replaces an all-ones bitfield as the opening message."""


@dataclass(frozen=True)
class HaveNone:
    """BEP 6: replaces an all-zeros bitfield as the opening message."""


@dataclass(frozen=True)
class RejectRequest:
    """BEP 6: explicit refusal of one outstanding Request. With the fast
    extension a choke no longer silently voids requests — every dropped
    request is rejected individually."""

    index: int
    begin: int
    length: int


@dataclass(frozen=True)
class AllowedFast:
    """BEP 6: grants the receiver permission to request ``index`` even
    while choked (bootstraps fresh leechers past the first unchoke)."""

    index: int


@dataclass(frozen=True)
class HashRequest:
    """BEP 52: ask for merkle hashes of the file rooted at ``pieces_root``.

    ``base_layer`` counts up from the 16 KiB leaf layer; ``index`` /
    ``length`` span a run of hashes there; ``proof_layers`` uncle hashes
    chain the run's subtree root toward ``pieces_root``.
    """

    pieces_root: bytes
    base_layer: int
    index: int
    length: int
    proof_layers: int


@dataclass(frozen=True)
class Hashes:
    """BEP 52 response: the request's five fields + the hash payload
    (``length`` run hashes then ``proof_layers`` uncles, 32 bytes each)."""

    pieces_root: bytes
    base_layer: int
    index: int
    length: int
    proof_layers: int
    hashes: bytes

    def hash_list(self) -> list[bytes]:
        return [self.hashes[i : i + 32] for i in range(0, len(self.hashes), 32)]


@dataclass(frozen=True)
class HashReject:
    """BEP 52: refusal of one HashRequest (fields echo the request)."""

    pieces_root: bytes
    base_layer: int
    index: int
    length: int
    proof_layers: int


@dataclass(frozen=True)
class Extended:
    """BEP 10 frame: <id 20><ext_id u8><payload>. ext_id 0 = ext handshake."""

    ext_id: int
    payload: bytes


PeerMsg = (
    KeepAlive | Choke | Unchoke | Interested | NotInterested | Have | BitfieldMsg | Request | Piece | Cancel
    | SuggestPiece | HaveAll | HaveNone | RejectRequest | AllowedFast
    | HashRequest | Hashes | HashReject | Extended
)


def _hash_fields(msg) -> bytes:
    return (
        msg.pieces_root
        + write_int(msg.base_layer, 4)
        + write_int(msg.index, 4)
        + write_int(msg.length, 4)
        + write_int(msg.proof_layers, 4)
    )


def _parse_hash_fields(payload: bytes):
    if len(payload) < 48:
        raise ProtocolError("short BEP 52 hash message")
    return (
        payload[:32],
        read_int(payload, 4, 32),
        read_int(payload, 4, 36),
        read_int(payload, 4, 40),
        read_int(payload, 4, 44),
    )

# BEP 6 handshake advertisement: bit 0x04 of reserved byte 7.
FAST_RESERVED_BYTE = 7
FAST_RESERVED_BIT = 0x04


def supports_fast(reserved: bytes) -> bool:
    return len(reserved) == 8 and bool(reserved[FAST_RESERVED_BYTE] & FAST_RESERVED_BIT)


def merge_reserved(*parts: bytes) -> bytes:
    """OR together reserved-byte masks (BEP 10 | BEP 6 | ...)."""
    out = bytearray(8)
    for p in parts:
        for i, byte in enumerate(p):
            out[i] |= byte
    return bytes(out)


def fast_reserved() -> bytes:
    r = bytearray(8)
    r[FAST_RESERVED_BYTE] |= FAST_RESERVED_BIT
    return bytes(r)


# ============================================================= handshake


def handshake_bytes(info_hash: bytes, peer_id: bytes, reserved: bytes = b"\x00" * 8) -> bytes:
    """pstrlen + pstr + 8 reserved + info_hash + peer_id (protocol.ts:25-34).

    ``reserved`` carries feature bits — bit 20 (byte 5, 0x10) advertises
    the BEP 10 extension protocol (net/extension.py).
    """
    if len(info_hash) != 20 or len(peer_id) != 20:
        raise ProtocolError("info_hash and peer_id must be 20 bytes")
    if len(reserved) != 8:
        raise ProtocolError("reserved must be 8 bytes")
    return bytes([len(PROTOCOL_STRING)]) + PROTOCOL_STRING + reserved + info_hash + peer_id


async def send_handshake(
    writer: asyncio.StreamWriter,
    info_hash: bytes,
    peer_id: bytes,
    reserved: bytes = b"\x00" * 8,
) -> None:
    writer.write(handshake_bytes(info_hash, peer_id, reserved))
    await writer.drain()


async def read_handshake_head(reader: asyncio.StreamReader) -> tuple[bytes, bytes]:
    """Phase 1: through the info hash; returns ``(info_hash, reserved)``
    (protocol.ts:48-61 startReceiveHandshake — the reference discards the
    reserved bytes; we keep them for BEP 10 feature negotiation)."""
    try:
        pstrlen = (await reader.readexactly(1))[0]
        pstr = await reader.readexactly(pstrlen)
        if pstr != PROTOCOL_STRING:
            raise ProtocolError(f"unknown protocol string {pstr!r}")
        reserved = await reader.readexactly(8)
        return await reader.readexactly(20), reserved
    except asyncio.IncompleteReadError as e:
        raise ProtocolError("handshake truncated") from e


async def read_handshake_peer_id(reader: asyncio.StreamReader) -> bytes:
    """Phase 2 (protocol.ts:63-67 endReceiveHandshake)."""
    try:
        return await reader.readexactly(20)
    except asyncio.IncompleteReadError as e:
        raise ProtocolError("handshake truncated") from e


# ============================================================== encoders


def _frame(msg_id: int, payload: bytes = b"") -> bytes:
    return write_int(1 + len(payload), 4) + bytes([msg_id]) + payload


def encode_message(msg: PeerMsg) -> bytes:
    """Encode any message (protocol.ts:69-161's sendX family, data-first)."""
    match msg:
        case KeepAlive():
            return write_int(0, 4)
        case Choke():
            return _frame(MsgId.CHOKE)
        case Unchoke():
            return _frame(MsgId.UNCHOKE)
        case Interested():
            return _frame(MsgId.INTERESTED)
        case NotInterested():
            return _frame(MsgId.NOT_INTERESTED)
        case Have(index):
            return _frame(MsgId.HAVE, write_int(index, 4))
        case BitfieldMsg(raw):
            return _frame(MsgId.BITFIELD, raw)
        case Request(index, begin, length):
            return _REQ_FRAME.pack(13, MsgId.REQUEST, index, begin, length)
        case Piece(index, begin, block):
            # one-shot header pack + a single concat copy of the block
            return _PIECE_HDR.pack(9 + len(block), MsgId.PIECE, index, begin) + block
        case Cancel(index, begin, length):
            return _frame(MsgId.CANCEL, write_int(index, 4) + write_int(begin, 4) + write_int(length, 4))
        case SuggestPiece(index):
            return _frame(MsgId.SUGGEST_PIECE, write_int(index, 4))
        case HaveAll():
            return _frame(MsgId.HAVE_ALL)
        case HaveNone():
            return _frame(MsgId.HAVE_NONE)
        case RejectRequest(index, begin, length):
            return _frame(
                MsgId.REJECT_REQUEST,
                write_int(index, 4) + write_int(begin, 4) + write_int(length, 4),
            )
        case AllowedFast(index):
            return _frame(MsgId.ALLOWED_FAST, write_int(index, 4))
        case HashRequest():
            return _frame(MsgId.HASH_REQUEST, _hash_fields(msg))
        case Hashes():
            return _frame(MsgId.HASHES, _hash_fields(msg) + msg.hashes)
        case HashReject():
            return _frame(MsgId.HASH_REJECT, _hash_fields(msg))
        case Extended(ext_id, payload):
            return _frame(MsgId.EXTENDED, bytes([ext_id]) + payload)
    raise ProtocolError(f"cannot encode {msg!r}")


def raise_if_closing(writer) -> None:
    """Writes into a closing transport are silently dropped by asyncio
    (with a logged "socket.send() raised exception." per call) — turn
    them into the ConnectionResetError every caller already handles."""
    closing = getattr(writer, "is_closing", None)  # test fakes lack it
    if closing is not None and closing():
        raise ConnectionResetError("peer connection is closing")


async def send_message(writer: asyncio.StreamWriter, msg: PeerMsg) -> None:
    # the serve plane's zero-copy egress holds this lock across its
    # header-write + sendfile pair (asyncio forbids transport.write
    # while a sendfile is in flight) — every other sender on the same
    # connection must serialize behind it. Absent on leecher-only and
    # test writers: plain writes already append atomically.
    lock = getattr(writer, "_tt_send_lock", None)
    if lock is not None:
        async with lock:
            raise_if_closing(writer)
            writer.write(encode_message(msg))
            await writer.drain()
        return
    raise_if_closing(writer)
    writer.write(encode_message(msg))
    await writer.drain()


def send_bitfield(writer: asyncio.StreamWriter, bitfield: Bitfield) -> None:
    """Queued write (no drain): first message after handshake
    (protocol.ts:108-115)."""
    writer.write(encode_message(BitfieldMsg(bitfield.to_bytes())))


# =============================================================== decoder


def decode_message(msg_id: int, payload: bytes) -> PeerMsg | None:
    """Payload → message; None for unknown ids (caller skips)."""
    # hot path first: Piece/Request dominate a bulk transfer
    if msg_id == MsgId.PIECE and len(payload) >= 8:
        index, begin = _II.unpack_from(payload)
        return Piece(index, begin, payload[8:])
    if msg_id == MsgId.REQUEST and len(payload) == 12:
        return Request(*_III.unpack(payload))
    if msg_id == MsgId.CHOKE and not payload:
        return Choke()
    if msg_id == MsgId.UNCHOKE and not payload:
        return Unchoke()
    if msg_id == MsgId.INTERESTED and not payload:
        return Interested()
    if msg_id == MsgId.NOT_INTERESTED and not payload:
        return NotInterested()
    if msg_id == MsgId.HAVE and len(payload) == 4:
        return Have(index=read_int(payload, 4))
    if msg_id == MsgId.BITFIELD:
        return BitfieldMsg(raw=payload)
    if msg_id == MsgId.CANCEL and len(payload) == 12:
        return Cancel(*_III.unpack(payload))
    if msg_id == MsgId.SUGGEST_PIECE and len(payload) == 4:
        return SuggestPiece(index=read_int(payload, 4))
    if msg_id == MsgId.HAVE_ALL and not payload:
        return HaveAll()
    if msg_id == MsgId.HAVE_NONE and not payload:
        return HaveNone()
    if msg_id == MsgId.REJECT_REQUEST and len(payload) == 12:
        return RejectRequest(
            read_int(payload, 4, 0), read_int(payload, 4, 4), read_int(payload, 4, 8)
        )
    if msg_id == MsgId.ALLOWED_FAST and len(payload) == 4:
        return AllowedFast(index=read_int(payload, 4))
    if msg_id == MsgId.HASH_REQUEST and len(payload) == 48:
        return HashRequest(*_parse_hash_fields(payload))
    if msg_id == MsgId.HASHES and len(payload) >= 48 and (len(payload) - 48) % 32 == 0:
        return Hashes(*_parse_hash_fields(payload), hashes=payload[48:])
    if msg_id == MsgId.HASH_REJECT and len(payload) == 48:
        return HashReject(*_parse_hash_fields(payload))
    if msg_id == MsgId.EXTENDED and len(payload) >= 1:
        return Extended(ext_id=payload[0], payload=payload[1:])
    if msg_id in set(MsgId):
        raise ProtocolError(f"malformed payload for message id {msg_id}")
    return None


async def read_message(reader: asyncio.StreamReader) -> PeerMsg | None:
    """Read one frame; None on clean EOF / connection error
    (protocol.ts:211-271). Loops over unknown ids instead of recursing.
    """
    while True:
        try:
            length = int.from_bytes(await reader.readexactly(4), "big")
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            return None
        if length == 0:
            return KeepAlive()
        if length > MAX_MESSAGE_LEN:
            raise ProtocolError(f"frame of {length} bytes exceeds cap")
        try:
            body = await reader.readexactly(length)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            return None
        if body[0] == MsgId.PIECE and length >= 9:
            # slice the block ONCE out of the frame: the generic path
            # (payload = body[1:], block = payload[8:]) memcpys every
            # 16 KiB block twice — measurable at 100+ MiB/s
            index, begin = _II.unpack_from(body, 1)
            return Piece(index, begin, body[9:])
        msg = decode_message(body[0], body[1:])
        if msg is not None:
            return msg
        # unknown message id: skip and read the next frame


# ======================================================= BEP 6 fast sets


def allowed_fast_set(ip: str, info_hash: bytes, num_pieces: int, k: int = 10) -> list[int]:
    """The canonical BEP 6 allowed-fast generation.

    Both endpoints can derive the same set from (peer ip, info hash), so
    grants survive reconnects and need no negotiation: iterate
    ``x = SHA1(x)`` seeded with the /24-masked address + info hash and
    harvest 4-byte big-endian words mod ``num_pieces`` until ``k``
    distinct indices accumulate. IPv6 peers are masked to /64 (the spec
    defines the v4 form; /64 is the conventional per-host prefix).
    """
    import hashlib
    import ipaddress

    if num_pieces <= 0:
        return []
    k = min(k, num_pieces)
    try:
        addr = ipaddress.ip_address(ip)
    except ValueError:
        return []
    if addr.version == 4:
        masked = (int(addr) & 0xFFFFFF00).to_bytes(4, "big")
    else:
        masked = (int(addr) >> 64 << 64).to_bytes(16, "big")
    x = masked + info_hash
    out: list[int] = []
    seen: set[int] = set()
    while len(out) < k:
        x = hashlib.sha1(x).digest()
        for i in range(0, 20, 4):
            if len(out) >= k:
                break
            j = read_int(x, 4, i) % num_pieces
            if j not in seen:
                seen.add(j)
                out.append(j)
    return out
