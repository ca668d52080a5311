"""BEP 34: DNS tracker preferences.

A tracker operator publishes a TXT record at the tracker's hostname:

    BITTORRENT UDP:6969 TCP:6969

The keyword alone denies BitTorrent service at that name; otherwise the
``PROTO:port`` entries give the allowed endpoints in preference order.
Clients that honor the record try those endpoints — in order — instead
of whatever scheme/port the (possibly stale) .torrent carries.

No DNS library ships in this image, so the TXT lookup is a minimal
RFC 1035 client over UDP: one question, recursion desired, answers
parsed with compression-pointer-safe name walking and hard bounds.
Resolution failures fail OPEN (no preferences — announce as published):
BEP 34 is an operator hint, not a gate, and a broken resolver must not
take a working tracker down. Opt-in via ``ClientConfig`` — nothing
changes unless enabled.

The reference has no counterpart (rclarey/torrent implements no BEP 34).
"""

from __future__ import annotations

import asyncio
import random
import time
from urllib.parse import urlsplit, urlunsplit

from torrent_tpu_torch.utils.log import get_logger

log = get_logger("net.dnsprefs")

QTYPE_TXT = 16
QCLASS_IN = 1
MAX_DNS_PACKET = 4096
DEFAULT_TTL = 300.0  # cache seconds (we don't parse record TTLs)
DENY = "deny"  # sentinel: "BITTORRENT" keyword alone — no service here
# one hostile TXT record must not mint thousands of announce candidates
# (each would get a full per-tracker timeout in the rotation): honor the
# first few preferences only
MAX_PREF_ENDPOINTS = 4


def _encode_qname(name: str) -> bytes:
    out = bytearray()
    for label in name.strip(".").split("."):
        raw = label.encode("idna") if not label.isascii() else label.encode()
        if not 0 < len(raw) < 64:
            raise ValueError(f"bad DNS label {label!r}")
        out.append(len(raw))
        out += raw
    out.append(0)
    return bytes(out)


def build_txt_query(name: str, txid: int) -> bytes:
    header = (
        txid.to_bytes(2, "big")
        + b"\x01\x00"  # RD
        + b"\x00\x01"  # QDCOUNT
        + b"\x00\x00\x00\x00\x00\x00"
    )
    return header + _encode_qname(name) + QTYPE_TXT.to_bytes(2, "big") + QCLASS_IN.to_bytes(2, "big")


def _skip_name(buf: bytes, i: int) -> int:
    """Offset just past the (possibly compressed) name at ``i``."""
    hops = 0
    while True:
        if i >= len(buf):
            raise ValueError("truncated name")
        n = buf[i]
        if n == 0:
            return i + 1
        if n & 0xC0 == 0xC0:  # compression pointer: 2 bytes, then done
            if i + 2 > len(buf):
                raise ValueError("truncated pointer")
            return i + 2
        i += 1 + n
        hops += 1
        if hops > 128:
            raise ValueError("name loop")


def parse_txt_response(buf: bytes, txid: int) -> list[str]:
    """TXT strings from a DNS answer (one string per record, its
    length-prefixed segments concatenated). Raises ValueError on
    malformed/mismatched packets."""
    if len(buf) < 12:
        raise ValueError("short DNS packet")
    if int.from_bytes(buf[0:2], "big") != txid:
        raise ValueError("transaction id mismatch")
    if not buf[2] & 0x80:
        raise ValueError("not a response")
    rcode = buf[3] & 0x0F
    if rcode not in (0, 3):  # NOERROR / NXDOMAIN
        raise ValueError(f"DNS rcode {rcode}")
    qd = int.from_bytes(buf[4:6], "big")
    an = int.from_bytes(buf[6:8], "big")
    i = 12
    for _ in range(qd):
        i = _skip_name(buf, i) + 4
    out: list[str] = []
    for _ in range(an):
        i = _skip_name(buf, i)
        if i + 10 > len(buf):
            raise ValueError("truncated answer")
        rtype = int.from_bytes(buf[i : i + 2], "big")
        rdlen = int.from_bytes(buf[i + 8 : i + 10], "big")
        i += 10
        if i + rdlen > len(buf):
            raise ValueError("truncated rdata")
        if rtype == QTYPE_TXT:
            j, parts = i, []
            while j < i + rdlen:
                n = buf[j]
                j += 1
                if j + n > i + rdlen:  # segment may not cross its rdata
                    raise ValueError("truncated TXT segment")
                parts.append(buf[j : j + n])
                j += n
            out.append(b"".join(parts).decode("utf-8", "replace"))
        i += rdlen
    return out


def parse_bep34(txts: list[str]):
    """BEP 34 record → ordered ``[(proto, port), ...]``, the DENY
    sentinel, or None when no record applies."""
    for txt in txts:
        fields = txt.split()
        if not fields or fields[0] != "BITTORRENT":
            continue
        if len(fields) == 1:
            return DENY
        prefs = []
        for f in fields[1:]:
            proto, _, port_s = f.partition(":")
            if proto.upper() not in ("UDP", "TCP") or not port_s.isdigit():
                continue  # unknown tokens are skipped, not fatal
            port = int(port_s)
            if 0 < port < 65536:
                prefs.append((proto.upper(), port))
            if len(prefs) >= MAX_PREF_ENDPOINTS:
                break
        return prefs or DENY  # keyword + only-garbage = deny (fail safe)
    return None


class _UdpOnce(asyncio.DatagramProtocol):
    def __init__(self):
        self.reply: asyncio.Future = asyncio.get_running_loop().create_future()

    def datagram_received(self, data, addr):
        if not self.reply.done():
            self.reply.set_result(data)

    def error_received(self, exc):
        if not self.reply.done():
            self.reply.set_exception(exc)


async def query_txt(
    name: str, server: tuple[str, int], timeout: float = 3.0
) -> list[str]:
    """One TXT query against ``server``; raises on failure/timeout."""
    txid = random.randrange(0x10000)
    query = build_txt_query(name, txid)
    loop = asyncio.get_running_loop()
    transport, proto = await loop.create_datagram_endpoint(
        _UdpOnce, remote_addr=server
    )
    try:
        transport.sendto(query)
        raw = await asyncio.wait_for(proto.reply, timeout)
    finally:
        transport.close()
    return parse_txt_response(raw[:MAX_DNS_PACKET], txid)


def system_nameserver() -> tuple[str, int] | None:
    """First ``nameserver`` from /etc/resolv.conf (the one resolver a
    minimal client can honestly claim to use)."""
    try:
        with open("/etc/resolv.conf") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2 and parts[0] == "nameserver":
                    return (parts[1], 53)
    except OSError:
        pass
    return None


class TrackerPrefs:
    """BEP 34 preference cache + URL rewriting.

    ``apply(url)`` returns the announce URLs to try for ``url``, in
    preference order: the BEP 34 endpoints when a record exists, the
    original URL when none (or on any resolver trouble), and ``[]``
    when the record denies service at that name.
    """

    def __init__(
        self,
        server: tuple[str, int] | None = None,
        ttl: float = DEFAULT_TTL,
        timeout: float = 3.0,
    ):
        self.server = server or system_nameserver()
        self.ttl = ttl
        self.timeout = timeout
        self._cache: dict[str, tuple[float, object]] = {}

    async def lookup(self, host: str):
        """Cached BEP 34 verdict for ``host``: prefs list, DENY, or None.

        The cache holds the in-flight task from the first miss, so fifty
        torrents cold-starting against one tracker host share ONE query
        instead of firing fifty identical ones."""
        now = time.monotonic()
        hit = self._cache.get(host)
        if hit and now - hit[0] < self.ttl:
            return await asyncio.shield(hit[1])
        task = asyncio.ensure_future(self._lookup_uncached(host))
        self._cache[host] = (now, task)
        return await asyncio.shield(task)

    async def _lookup_uncached(self, host: str):
        if self.server is None:
            return None
        try:
            return parse_bep34(await query_txt(host, self.server, self.timeout))
        except (ValueError, OSError, asyncio.TimeoutError) as e:
            log.debug("BEP 34 lookup for %s failed open: %s", host, e)
            return None  # fail open

    async def apply(self, url: str) -> list[str]:
        parts = urlsplit(url)
        host = parts.hostname
        if not host or parts.scheme not in ("http", "https", "udp"):
            return [url]
        import ipaddress

        try:
            ipaddress.ip_address(host)
            return [url]  # records live at NAMES; IPs announce as-is
        except ValueError:
            pass
        verdict = await self.lookup(host)
        if verdict is None:
            return [url]
        if verdict == DENY:
            log.info("BEP 34: %s denies BitTorrent service; skipping %s", host, url)
            return []
        out = []
        for proto, port in verdict:
            netloc = f"{host}:{port}"
            if proto == "UDP":
                out.append(urlunsplit(("udp", netloc, parts.path or "/announce", parts.query, "")))
            else:
                scheme = parts.scheme if parts.scheme in ("http", "https") else "http"
                out.append(urlunsplit((scheme, netloc, parts.path or "/announce", parts.query, "")))
        return out or [url]
