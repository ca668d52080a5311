"""Tracker wire types (reference: types.ts, 99 LoC)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


def unpack_compact_v4(blob: bytes) -> list[tuple[str, int]]:
    """Decode 6-byte compact IPv4 (ip, port) entries (BEP 23 layout).

    The one shared decoder for PEX, DHT values, and anything else that
    speaks compact-v4 — port-0 entries are dropped everywhere (they are
    undialable; hostile senders pad with them). Junk tail bytes ignored.
    """
    out = []
    for i in range(0, len(blob) - len(blob) % 6, 6):
        port = int.from_bytes(blob[i + 4 : i + 6], "big")
        if port == 0:
            continue
        ip = ".".join(str(b) for b in blob[i : i + 4])
        out.append((ip, port))
    return out


def pack_compact_v4(addrs) -> bytes:
    """Encode (ip, port) pairs as 6-byte compact IPv4 entries; non-v4
    addresses (after v4-mapped normalization) and invalid ports are
    skipped — the shared packer for PEX, tracker responses, and anything
    else that emits compact-v4."""
    out = bytearray()
    for ip, port in addrs:
        try:
            octets = bytes(int(x) for x in normalize_peer_host(ip).split("."))
        except ValueError:
            continue
        if len(octets) == 4 and 0 < port < 65536:
            out += octets + port.to_bytes(2, "big")
    return bytes(out)


def unpack_compact_v6(blob: bytes) -> list[tuple[str, int]]:
    """Decode 18-byte compact IPv6 (ip, port) entries (BEP 7 layout).

    The shared v6 sibling of :func:`unpack_compact_v4` — same contract:
    port-0 entries dropped (undialable padding), junk tail ignored.
    v4-mapped entries normalize to dotted quad so dial dedup and family
    routing see one canonical form everywhere."""
    import socket

    out = []
    for i in range(0, len(blob) - len(blob) % 18, 18):
        port = int.from_bytes(blob[i + 16 : i + 18], "big")
        if port == 0:
            continue
        ip = socket.inet_ntop(socket.AF_INET6, blob[i : i + 16])
        out.append((normalize_peer_host(ip), port))
    return out


def pack_compact_v6(addrs) -> bytes:
    """Encode (ip, port) pairs as 18-byte compact IPv6 entries; non-v6
    addresses (v4-mapped ones normalize OUT to the v4 family) and
    invalid ports are skipped (callers pass mixed sets)."""
    import socket

    out = bytearray()
    for ip, port in addrs:
        ip = normalize_peer_host(ip)
        if ":" not in ip or not 0 < port < 65536:
            continue
        try:
            out += socket.inet_pton(socket.AF_INET6, ip) + port.to_bytes(2, "big")
        except OSError:
            continue
    return bytes(out)


def normalize_peer_host(host: str) -> str:
    """Collapse IPv4-mapped IPv6 text (``::ffff:a.b.c.d`` from dual-stack
    listeners) to the plain dotted quad, so family-specific consumers
    (compact packers, PEX field routing) classify the peer correctly."""
    import ipaddress

    try:
        addr = ipaddress.ip_address(host)
    except ValueError:
        return host
    mapped = getattr(addr, "ipv4_mapped", None)
    return str(mapped) if mapped is not None else host


class AnnounceEvent(str, enum.Enum):
    """Announce event (types.ts:3-15)."""

    STARTED = "started"
    STOPPED = "stopped"
    COMPLETED = "completed"
    EMPTY = "empty"


class UdpTrackerAction(enum.IntEnum):
    """BEP 15 action codes (types.ts:94-99)."""

    CONNECT = 0
    ANNOUNCE = 1
    SCRAPE = 2
    ERROR = 3


# BEP 15 event encoding (types.ts:18-23). `empty` is 0 on the wire.
UDP_EVENT_CODE: dict[AnnounceEvent, int] = {
    AnnounceEvent.EMPTY: 0,
    AnnounceEvent.COMPLETED: 1,
    AnnounceEvent.STARTED: 2,
    AnnounceEvent.STOPPED: 3,
}
UDP_CODE_EVENT = {v: k for k, v in UDP_EVENT_CODE.items()}


@dataclass
class AnnounceInfo:
    """Everything a tracker announce needs (types.ts:41-67)."""

    info_hash: bytes  # 20 bytes
    peer_id: bytes  # 20 bytes
    port: int
    uploaded: int = 0
    downloaded: int = 0
    left: int = 0
    event: AnnounceEvent = AnnounceEvent.EMPTY
    num_want: int | None = None
    ip: str | None = None
    key: bytes | None = None  # random per-session id for NAT'd peers
    compact: bool = True  # request compact peer lists (BEP 23)


@dataclass(frozen=True)
class AnnouncePeer:
    """One peer from an announce response (types.ts:32-39)."""

    ip: str
    port: int
    peer_id: bytes | None = None  # absent in compact responses


@dataclass
class AnnounceResponse:
    """Parsed announce response (tracker.ts:253-278)."""

    interval: int
    peers: list[AnnouncePeer] = field(default_factory=list)
    complete: int | None = None  # seeders
    incomplete: int | None = None  # leechers
    warning: str | None = None
    min_interval: int | None = None
    tracker_id: bytes | None = None
    # BEP 24: the address the tracker saw us announce from — the session
    # uses it to learn its public IP for BEP 40 dial ordering
    external_ip: str | None = None


@dataclass(frozen=True)
class ScrapeEntry:
    """Per-torrent scrape stats (types.ts:69-78)."""

    info_hash: bytes
    complete: int
    downloaded: int
    incomplete: int
    name: str | None = None
