"""Tracker client: HTTP(S) + UDP announce and scrape (ref L3a: tracker.ts).

Protocol-dispatching ``announce``/``scrape`` (tracker.ts:402-420, 214-240)
rebuilt on asyncio:

- HTTP: hand-rolled GET over asyncio streams so binary query params
  (info_hash, peer_id) are %-escaped exactly once and never re-normalized
  by a URL library (the reference has the same concern, tracker.ts:320-328).
  Compact (BEP 23) and full peer lists both parse (tracker.ts:242-318).
- UDP (BEP 15): connect → announce/scrape with transaction-id matching,
  15·2ⁿ s exponential backoff capped at 8 attempts, and 60 s connection-id
  reuse (tracker.ts:79-172). Deliberate fixes vs the reference (SURVEY
  §8.5, §8.8): ephemeral source ports (no fixed :6961 collision between
  concurrent announces), ``event`` omitted from HTTP queries when EMPTY,
  and ``compact`` honored instead of hard-coded.
"""

from __future__ import annotations

import asyncio
import random
import ssl as ssl_mod
import time
from urllib.parse import urljoin, urlsplit

from torrent_tpu_torch.codec import valid
from torrent_tpu_torch.codec.bencode import BencodeError, bdecode
from torrent_tpu_torch.net.constants import (
    DEFAULT_NUM_WANT,
    HTTP_TIMEOUT,
    UDP_BACKOFF_BASE,
    UDP_CONNECT_MAGIC,
    UDP_CONNECTION_ID_TTL,
    UDP_MAX_ATTEMPTS,
    UDP_MIN_ANNOUNCE_RESP,
    UDP_MIN_CONNECT_RESP,
    UDP_MIN_ERROR_RESP,
    UDP_MIN_SCRAPE_RESP,
)
from torrent_tpu_torch.net.types import (
    UDP_EVENT_CODE,
    AnnounceEvent,
    AnnounceInfo,
    AnnouncePeer,
    AnnounceResponse,
    ScrapeEntry,
    UdpTrackerAction,
)
from torrent_tpu_torch.utils.bytesio import encode_binary_data, read_int, write_int


class TrackerError(Exception):
    """Any tracker failure: transport, protocol, or `failure reason`."""


# ===================================================================== HTTP


HTTP_MAX_REDIRECTS = 5
_REDIRECT_STATUSES = frozenset({301, 302, 303, 307, 308})


async def _read_chunked(
    reader: asyncio.StreamReader, max_bytes: int | None = None
) -> bytes:
    """Decode a Transfer-Encoding: chunked body (RFC 9112 §7.1)."""
    chunks = []
    total = 0
    while True:
        size_line = await reader.readline()
        if not size_line:
            raise TrackerError("HTTP tracker sent truncated chunked body")
        # Chunk extensions (";ext=val") are legal; strip them.
        size_text = size_line.split(b";", 1)[0].strip()
        try:
            size = int(size_text, 16)
        except ValueError:
            raise TrackerError(f"bad chunk size line {size_line!r}")
        if size == 0:
            # Drain optional trailer fields up to the blank line.
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
            return b"".join(chunks)
        total += size
        if max_bytes is not None and total > max_bytes:
            raise TrackerError(f"HTTP body exceeds {max_bytes} bytes")
        chunks.append(await reader.readexactly(size))
        await reader.readexactly(2)  # CRLF after each chunk


async def _http_get_once(
    url: str, proxy=None, max_bytes: int | None = None
) -> tuple[int, bytes, str | None]:
    """One GET hop → (status, body, location). Raw path passed verbatim."""
    parts = urlsplit(url)
    if parts.scheme not in ("http", "https"):
        raise TrackerError(f"unsupported scheme {parts.scheme!r}")
    host = parts.hostname or ""
    port = parts.port or (443 if parts.scheme == "https" else 80)
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    ssl_ctx = ssl_mod.create_default_context() if parts.scheme == "https" else None

    if proxy is not None:
        from torrent_tpu_torch.net.socks import open_connection as socks_open

        reader, writer = await socks_open(proxy, host, port, ssl=ssl_ctx)
    else:
        reader, writer = await asyncio.open_connection(host, port, ssl=ssl_ctx)
    try:
        req = (
            f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
            f"User-Agent: torrent-tpu/0.1\r\nAccept: */*\r\nConnection: close\r\n\r\n"
        )
        writer.write(req.encode("latin-1"))
        await writer.drain()
        status_line = await reader.readline()
        pieces = status_line.split(None, 2)
        if len(pieces) < 2 or not pieces[1].isdigit():
            raise TrackerError(f"bad HTTP status line {status_line!r}")
        status = int(pieces[1])
        content_length = None
        chunked = False
        location = None
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            lower = line.lower()
            if lower.startswith(b"content-length:"):
                try:
                    content_length = int(line.split(b":", 1)[1].strip())
                except ValueError:
                    raise TrackerError("bad Content-Length")
            elif lower.startswith(b"transfer-encoding:"):
                chunked = b"chunked" in lower.split(b":", 1)[1]
            elif lower.startswith(b"location:"):
                location = line.split(b":", 1)[1].strip().decode("latin-1")
        if chunked:
            # Chunked wins over Content-Length (RFC 9112 §6.3); the
            # reference got both framings free from fetch (tracker.ts:26-31).
            body = await _read_chunked(reader, max_bytes)
        elif content_length is not None:
            if max_bytes is not None and content_length > max_bytes:
                raise TrackerError(f"HTTP body exceeds {max_bytes} bytes")
            body = await reader.readexactly(content_length)
        else:
            # Connection: close → EOF delimits; cap DURING the read — the
            # body is attacker-paced and buffering it all before a size
            # check would be the memory DoS the cap exists to stop
            parts_ = []
            got = 0
            while True:
                chunk = await reader.read(65536)
                if not chunk:
                    break
                got += len(chunk)
                if max_bytes is not None and got > max_bytes:
                    raise TrackerError(f"HTTP body exceeds {max_bytes} bytes")
                parts_.append(chunk)
            body = b"".join(parts_)
        return status, body, location
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass


async def _http_get(
    url: str,
    timeout: float = HTTP_TIMEOUT,
    proxy=None,
    max_bytes: int | None = 32 << 20,
) -> bytes:
    """HTTP/1.1 GET returning the body, following up to HTTP_MAX_REDIRECTS
    3xx hops and decoding chunked transfer-encoding. ``max_bytes``
    bounds the body AS IT STREAMS (no tracker or update-url response
    has business being this large; the peer is untrusted)."""

    async def go() -> bytes:
        current = url
        for _ in range(HTTP_MAX_REDIRECTS + 1):
            status, body, location = await _http_get_once(
                current, proxy=proxy, max_bytes=max_bytes
            )
            if status in _REDIRECT_STATUSES:
                if not location:
                    raise TrackerError(f"HTTP {status} redirect without Location")
                current = urljoin(current, location)
                continue
            if status != 200:
                raise TrackerError(f"tracker returned HTTP {status}")
            return body
        raise TrackerError(f"too many HTTP redirects (>{HTTP_MAX_REDIRECTS})")

    try:
        return await asyncio.wait_for(go(), timeout)
    except asyncio.TimeoutError:
        raise TrackerError(f"HTTP tracker timed out after {timeout}s")
    except OSError as e:
        raise TrackerError(f"HTTP tracker connection failed: {e}")
    except asyncio.IncompleteReadError:
        raise TrackerError("HTTP tracker sent truncated body")


def _announce_query(info: AnnounceInfo) -> str:
    """Build the announce query string (tracker.ts:320-349)."""
    params = [
        ("info_hash", encode_binary_data(info.info_hash)),
        ("peer_id", encode_binary_data(info.peer_id)),
        ("port", str(info.port)),
        ("uploaded", str(info.uploaded)),
        ("downloaded", str(info.downloaded)),
        ("left", str(info.left)),
        ("compact", "1" if info.compact else "0"),
        ("numwant", str(info.num_want if info.num_want is not None else DEFAULT_NUM_WANT)),
    ]
    if info.event != AnnounceEvent.EMPTY:  # spec: omit when empty (§8.8 fix)
        params.append(("event", info.event.value))
    if info.ip:
        params.append(("ip", info.ip))
    if info.key:
        params.append(("key", encode_binary_data(info.key)))
    return "&".join(f"{k}={v}" for k, v in params)


def _parse_compact_peers(blob: bytes) -> list[AnnouncePeer]:
    """6-byte ip4+port entries (tracker.ts:242-251, BEP 23)."""
    if len(blob) % 6 != 0:
        raise TrackerError("compact peers blob not a multiple of 6")
    peers = []
    for i in range(0, len(blob), 6):
        ip = ".".join(str(b) for b in blob[i : i + 4])
        peers.append(AnnouncePeer(ip=ip, port=read_int(blob, 2, i + 4)))
    return peers


def _parse_compact_peers6(blob: bytes) -> list[AnnouncePeer]:
    """18-byte ip6+port entries (BEP 7 ``peers6`` — beyond the reference,
    which is IPv4-only). Framing stays strict (a misaligned blob is a
    broken tracker); entries decode through the shared v6 codec, which
    drops undialable port-0 padding."""
    from torrent_tpu_torch.net.types import unpack_compact_v6

    if len(blob) % 18 != 0:
        raise TrackerError("compact peers6 blob not a multiple of 18")
    return [AnnouncePeer(ip=ip, port=port) for ip, port in unpack_compact_v6(blob)]


_FULL_PEER_SHAPE = valid.obj(
    {b"ip": valid.bstr(), b"port": valid.num(), b"peer id": valid.optional(valid.bstr())}
)


def _parse_http_announce(body: bytes) -> AnnounceResponse:
    """bdecode + validate an announce body (tracker.ts:280-318)."""
    try:
        data = bdecode(body, strict=False)
    except BencodeError as e:
        raise TrackerError(f"malformed announce response: {e}")
    if not isinstance(data, dict):
        raise TrackerError("announce response is not a dict")
    if b"failure reason" in data:
        reason = data[b"failure reason"]
        raise TrackerError(
            f"tracker failure: {reason.decode('utf-8', 'replace') if isinstance(reason, bytes) else reason}"
        )
    interval = data.get(b"interval")
    if not valid.is_int(interval):
        raise TrackerError("announce response missing interval")
    raw_peers = data.get(b"peers")
    raw6 = data.get(b"peers6")
    if isinstance(raw_peers, bytes):
        peers = _parse_compact_peers(raw_peers)
    elif isinstance(raw_peers, list):
        peers = []
        for p in raw_peers:
            if not _FULL_PEER_SHAPE(p):
                raise TrackerError("malformed peer entry in announce response")
            peers.append(
                AnnouncePeer(
                    ip=p[b"ip"].decode("utf-8", "replace"),
                    port=p[b"port"],
                    peer_id=p.get(b"peer id"),
                )
            )
    elif isinstance(raw6, bytes):
        peers = []  # IPv6-only tracker (BEP 7): peers6 alone is valid
    else:
        raise TrackerError("announce response missing peers")
    if isinstance(raw6, bytes):
        peers.extend(_parse_compact_peers6(raw6))
    warning = data.get(b"warning message")
    # BEP 24: trackers may echo the announcer's address, either as a
    # 4/16-byte packed value or text. Text is tried first — a textual
    # address of exactly 4 or 16 chars (e.g. "1::1") must not be
    # misread as packed bytes. The session layer decides whether to
    # trust the value (net/tracker only parses).
    ext = data.get(b"external ip")
    external_ip = None
    if isinstance(ext, bytes):
        import ipaddress

        try:
            external_ip = str(ipaddress.ip_address(ext.decode("ascii")))
        except (ValueError, UnicodeDecodeError):
            if len(ext) in (4, 16):
                try:
                    external_ip = str(ipaddress.ip_address(ext))
                except ValueError:
                    pass
    return AnnounceResponse(
        interval=interval,
        peers=peers,
        external_ip=external_ip,
        complete=data.get(b"complete") if valid.is_int(data.get(b"complete")) else None,
        incomplete=data.get(b"incomplete") if valid.is_int(data.get(b"incomplete")) else None,
        warning=warning.decode("utf-8", "replace") if isinstance(warning, bytes) else None,
        min_interval=data.get(b"min interval")
        if valid.is_int(data.get(b"min interval"))
        else None,
        tracker_id=data.get(b"tracker id") if isinstance(data.get(b"tracker id"), bytes) else None,
    )


async def _announce_http(url: str, info: AnnounceInfo, proxy=None) -> AnnounceResponse:
    sep = "&" if urlsplit(url).query else "?"
    return _parse_http_announce(
        await _http_get(url + sep + _announce_query(info), proxy=proxy)
    )


_SCRAPE_FILE_SHAPE = valid.obj(
    {b"complete": valid.num(), b"downloaded": valid.num(), b"incomplete": valid.num()}
)


async def _scrape_http(url: str, info_hashes: list[bytes], proxy=None) -> list[ScrapeEntry]:
    sep = "&" if urlsplit(url).query else "?"
    query = "&".join("info_hash=" + encode_binary_data(h) for h in info_hashes)
    body = await _http_get(url + (sep + query if query else ""), proxy=proxy)
    try:
        data = bdecode(body, strict=False)
    except BencodeError as e:
        raise TrackerError(f"malformed scrape response: {e}")
    if not isinstance(data, dict):
        raise TrackerError("scrape response is not a dict")
    if b"failure reason" in data:
        reason = data[b"failure reason"]
        raise TrackerError(
            f"tracker failure: {reason.decode('utf-8', 'replace') if isinstance(reason, bytes) else reason}"
        )
    files = data.get(b"files")
    if not isinstance(files, dict):
        raise TrackerError("scrape response missing files dict")
    out = []
    for h, st in files.items():
        # bytes-keyed decode handles raw 20-byte hash keys natively — the
        # reference needed a special decoder for this (bencode.ts:168-202).
        if not isinstance(h, bytes) or not _SCRAPE_FILE_SHAPE(st):
            raise TrackerError("malformed scrape files entry")
        name = st.get(b"name")
        out.append(
            ScrapeEntry(
                info_hash=h,
                complete=st[b"complete"],
                downloaded=st[b"downloaded"],
                incomplete=st[b"incomplete"],
                name=name.decode("utf-8", "replace") if isinstance(name, bytes) else None,
            )
        )
    return out


def scrape_url_for(announce_url: str) -> str:
    """Derive the scrape URL per convention (tracker.ts:222-231).

    The last path segment must be ``announce[...]`` and becomes
    ``scrape[...]``; otherwise scrape is unsupported for this tracker.
    """
    parts = urlsplit(announce_url)
    segments = (parts.path or "/").split("/")
    if not segments[-1].startswith("announce"):
        raise TrackerError(f"cannot derive scrape URL from {announce_url!r}")
    segments[-1] = "scrape" + segments[-1][len("announce") :]
    path = "/".join(segments)
    netloc = parts.netloc
    rebuilt = f"{parts.scheme}://{netloc}{path}"
    if parts.query:
        rebuilt += "?" + parts.query
    return rebuilt


# ====================================================================== UDP


class _UdpRpc(asyncio.DatagramProtocol):
    """One UDP tracker exchange endpoint with transaction matching."""

    def __init__(self):
        self.transport: asyncio.DatagramTransport | None = None
        self._waiters: dict[int, asyncio.Future] = {}

    def connection_made(self, transport):
        self.transport = transport

    def datagram_received(self, data, addr):
        if len(data) < 8:
            return
        tid = read_int(data, 4, 4)
        fut = self._waiters.pop(tid, None)
        if fut is not None and not fut.done():
            fut.set_result(data)

    def error_received(self, exc):
        for fut in self._waiters.values():
            if not fut.done():
                fut.set_exception(TrackerError(f"UDP socket error: {exc}"))
        self._waiters.clear()

    async def request(self, packet: bytes, tid: int, addr, timeout: float) -> bytes:
        fut = asyncio.get_running_loop().create_future()
        self._waiters[tid] = fut
        try:
            assert self.transport is not None
            self.transport.sendto(packet, addr)
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            raise TrackerError("UDP tracker timed out")
        finally:
            self._waiters.pop(tid, None)


# (host, port) → (connection_id, minted_at). 60 s reuse per BEP 15
# (tracker.ts:116-120 caches the same way).
_conn_cache: dict[tuple[str, int], tuple[int, float]] = {}


def _check_error_packet(data: bytes, tid: int) -> None:
    action = read_int(data, 4, 0)
    if action == UdpTrackerAction.ERROR:
        if len(data) < UDP_MIN_ERROR_RESP:
            raise TrackerError("malformed UDP error packet")
        raise TrackerError(f"tracker error: {data[8:].decode('utf-8', 'replace')}")


async def _udp_call(
    url: str, build_request: "callable", parse_response: "callable", max_attempts: int | None = None
):
    """The one reusable UDP RPC primitive (tracker.ts:79-172 `withConnect`).

    connect (cached 60 s) → request, with per-attempt timeout 15·2ⁿ and a
    fresh transaction id each try. A stale connection id is re-minted.
    """
    parts = urlsplit(url)
    host, port = parts.hostname, parts.port
    if not host or not port:
        raise TrackerError(f"bad UDP tracker URL {url!r}")
    attempts = max_attempts if max_attempts is not None else UDP_MAX_ATTEMPTS

    loop = asyncio.get_running_loop()
    try:
        transport, proto = await loop.create_datagram_endpoint(
            _UdpRpc, remote_addr=(host, port)
        )
    except OSError as e:  # DNS failure / unroutable host must be retryable
        raise TrackerError(f"UDP tracker unreachable: {e}") from e
    addr = None  # connected socket: sendto uses default peer
    try:
        last_err: Exception | None = None
        for attempt in range(attempts):
            timeout = UDP_BACKOFF_BASE * (2**attempt)
            try:
                key = (host, port)
                cached = _conn_cache.get(key)
                now = time.monotonic()
                if cached and now - cached[1] < UDP_CONNECTION_ID_TTL:
                    conn_id = cached[0]
                else:
                    tid = random.getrandbits(32)
                    pkt = (
                        write_int(UDP_CONNECT_MAGIC, 8)
                        + write_int(UdpTrackerAction.CONNECT, 4)
                        + write_int(tid, 4)
                    )
                    resp = await proto.request(pkt, tid, addr, timeout)
                    _check_error_packet(resp, tid)
                    if len(resp) < UDP_MIN_CONNECT_RESP or read_int(resp, 4, 0) != 0:
                        raise TrackerError("malformed UDP connect response")
                    conn_id = read_int(resp, 8, 8)
                    _conn_cache[key] = (conn_id, now)
                tid = random.getrandbits(32)
                resp = await proto.request(build_request(conn_id, tid), tid, addr, timeout)
                _check_error_packet(resp, tid)
                return parse_response(resp)
            except TrackerError as e:
                last_err = e
                _conn_cache.pop((host, port), None)
                # Server-reported errors are final — except a stale
                # connection id, which just means "connect again".
                if "tracker error" in str(e) and "connection id" not in str(e):
                    raise
        raise TrackerError(f"UDP tracker failed after {attempts} attempts: {last_err}")
    finally:
        transport.close()


async def _announce_udp(url: str, info: AnnounceInfo) -> AnnounceResponse:
    """BEP 15 announce: 98-byte request (tracker.ts:353-399)."""

    def build(conn_id: int, tid: int) -> bytes:
        ip_bytes = b"\x00\x00\x00\x00"
        if info.ip:
            try:
                ip_bytes = bytes(int(p) for p in info.ip.split("."))
            except ValueError:
                pass
        key = info.key if info.key and len(info.key) == 4 else b"\x00\x00\x00\x00"
        return (
            write_int(conn_id, 8)
            + write_int(UdpTrackerAction.ANNOUNCE, 4)
            + write_int(tid, 4)
            + info.info_hash
            + info.peer_id
            + write_int(info.downloaded, 8)
            + write_int(info.left, 8)
            + write_int(info.uploaded, 8)
            + write_int(UDP_EVENT_CODE[info.event], 4)
            + ip_bytes
            + key
            + write_int(
                (info.num_want if info.num_want is not None else DEFAULT_NUM_WANT)
                & 0xFFFFFFFF,
                4,
            )
            + write_int(info.port, 2)
        )

    def parse(resp: bytes) -> AnnounceResponse:
        if len(resp) < UDP_MIN_ANNOUNCE_RESP or read_int(resp, 4, 0) != UdpTrackerAction.ANNOUNCE:
            raise TrackerError("malformed UDP announce response")
        interval = read_int(resp, 4, 8)
        leechers = read_int(resp, 4, 12)
        seeders = read_int(resp, 4, 16)
        peers = _parse_compact_peers(resp[20:]) if len(resp) > 20 else []
        return AnnounceResponse(
            interval=interval, peers=peers, complete=seeders, incomplete=leechers
        )

    return await _udp_call(url, build, parse)


async def _scrape_udp(url: str, info_hashes: list[bytes]) -> list[ScrapeEntry]:
    """BEP 15 scrape (tracker.ts:174-207)."""

    def build(conn_id: int, tid: int) -> bytes:
        return (
            write_int(conn_id, 8)
            + write_int(UdpTrackerAction.SCRAPE, 4)
            + write_int(tid, 4)
            + b"".join(info_hashes)
        )

    def parse(resp: bytes) -> list[ScrapeEntry]:
        if len(resp) < UDP_MIN_SCRAPE_RESP or read_int(resp, 4, 0) != UdpTrackerAction.SCRAPE:
            raise TrackerError("malformed UDP scrape response")
        body = resp[8:]
        if len(body) < 12 * len(info_hashes):
            raise TrackerError("truncated UDP scrape response")
        out = []
        for i, h in enumerate(info_hashes):
            base = i * 12
            out.append(
                ScrapeEntry(
                    info_hash=h,
                    complete=read_int(body, 4, base),
                    downloaded=read_int(body, 4, base + 4),
                    incomplete=read_int(body, 4, base + 8),
                )
            )
        return out

    return await _udp_call(url, build, parse)


# ================================================================= dispatch

# announce-client latency family (log2 buckets, shared obs registry):
# the swarm tier's "how slow are MY trackers" series, labeled by scheme
# and outcome so a failing UDP rotation is visible on any /metrics scrape
ANNOUNCE_CLIENT_FAMILY = "torrent_tpu_announce_client_seconds"


# the only schemes the dispatcher speaks; anything else (a hostile
# announce-list minting one junk scheme per entry) folds into "other"
# so the label set stays bounded like every other family
_ANNOUNCE_SCHEMES = frozenset({"http", "https", "udp"})


def _observe_announce(scheme: str, ok: bool, seconds: float) -> None:
    """Record one announce round-trip into the shared histogram
    registry. Lazy import + never raises: the tracker client must work
    (and fail) identically if the obs plane is torn down mid-run."""
    try:
        from torrent_tpu_torch.obs.hist import histograms

        histograms().get(
            ANNOUNCE_CLIENT_FAMILY,
            help="Tracker announce round-trip latency (client side)",
            scheme=scheme if scheme in _ANNOUNCE_SCHEMES else "other",
            ok="true" if ok else "false",
        ).observe(seconds)
    except Exception:  # pragma: no cover - defensive
        pass


async def announce(url: str, info: AnnounceInfo, proxy=None) -> AnnounceResponse:
    """Announce to a tracker; dispatches on URL scheme (tracker.ts:402-420).

    With a SOCKS5 ``proxy``, UDP trackers are refused rather than dialed
    around the tunnel (a CONNECT proxy cannot carry them). Every attempt
    — success or failure — observes its round-trip into the
    :data:`ANNOUNCE_CLIENT_FAMILY` log2 latency family."""
    scheme = urlsplit(url).scheme
    t0 = time.monotonic()
    ok = False
    try:
        if scheme in ("http", "https"):
            res = await _announce_http(url, info, proxy=proxy)
        elif scheme == "udp":
            if proxy is not None:
                raise TrackerError(
                    "udp tracker skipped: SOCKS5 proxy cannot carry UDP"
                )
            res = await _announce_udp(url, info)
        else:
            raise TrackerError(f"unsupported tracker scheme {scheme!r}")
        ok = True
        return res
    finally:
        _observe_announce(scheme, ok, time.monotonic() - t0)


async def scrape(url: str, info_hashes: list[bytes], proxy=None) -> list[ScrapeEntry]:
    """Scrape tracker stats; dispatches on URL scheme (tracker.ts:214-240)."""
    scheme = urlsplit(url).scheme
    if scheme in ("http", "https"):
        return await _scrape_http(scrape_url_for(url), info_hashes, proxy=proxy)
    if scheme == "udp":
        if proxy is not None:
            raise TrackerError("udp tracker skipped: SOCKS5 proxy cannot carry UDP")
        return await _scrape_udp(url, info_hashes)
    raise TrackerError(f"unsupported tracker scheme {scheme!r}")
