"""Tracker server: HTTP + UDP listeners muxed into one request stream
(ref L3b: server/tracker.ts, 654 LoC).

``TrackerServer`` async-iterates parsed, validated announce/scrape request
objects from both listeners (the reference muxes with MuxAsyncIterator,
server/tracker.ts:599-613; here both listeners feed one asyncio.Queue).
Each request object carries its own ``respond``/``reject`` — policy lives
in the consumer (e.g. server/in_memory.py), transport here.

HTTP side (server/tracker.ts:439-485): raw %-escape parsing of binary
query params *before* any URL-decoding mangles them (parseParams,
server/tracker.ts:328-359), ``X-Forwarded-For`` honored, param
validation, optional info-hash allowlist, compact & full announce bodies.
A ``/stats`` route returns live counters (the reference routes it but
never implemented it, server/tracker.ts:477-479).

UDP side (server/tracker.ts:487-597): connect-magic check, random 8-byte
connection ids expired after 2 min, announce/scrape packet parsing.
Deliberate fix vs the reference (SURVEY §8.13): a request that fails
validation gets an error reply and is **dropped** — the reference sent
the error but then fell through and yielded the request anyway.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field

from torrent_tpu_torch.codec.bencode import bencode
from torrent_tpu_torch.net.constants import (
    DEFAULT_ANNOUNCE_INTERVAL,
    DEFAULT_NUM_WANT,
    UDP_CONNECT_MAGIC,
)

MAX_NUM_WANT = 500  # bounds compact responses well under one UDP datagram
from torrent_tpu_torch.net.types import (
    UDP_CODE_EVENT,
    AnnounceEvent,
    UdpTrackerAction,
)
from torrent_tpu_torch.utils.bytesio import decode_binary_data, read_int, write_int

UDP_CONNECTION_TTL = 120  # seconds (server/tracker.ts:516)


# ============================================================== requests


@dataclass
class AnnounceRequest:
    """A validated announce, transport-agnostic (server/tracker.ts:33-60)."""

    info_hash: bytes
    peer_id: bytes
    ip: str
    port: int
    uploaded: int
    downloaded: int
    left: int
    event: AnnounceEvent
    num_want: int
    compact: bool = True
    key: bytes | None = None

    async def respond(self, interval: int, complete: int, incomplete: int, peers):
        raise NotImplementedError

    async def reject(self, reason: str):
        raise NotImplementedError


@dataclass
class ScrapeRequest:
    """A scrape for zero or more info hashes (server/tracker.ts:225-232)."""

    info_hashes: list[bytes]

    async def respond(self, files):
        """files: iterable of (info_hash, complete, downloaded, incomplete)."""
        raise NotImplementedError

    async def reject(self, reason: str):
        raise NotImplementedError


# ------------------------------------------------------------------ HTTP


def _pack_peers_compact(peers) -> bytes:
    """BEP 23 compact peers via the shared v4 packer: IPv6 peers ride
    peers6 instead, port-0 (firewalled) announces are never packed (every
    receiver's decoder drops them anyway), v4-mapped text normalizes."""
    from torrent_tpu_torch.net.types import pack_compact_v4

    return pack_compact_v4((p.ip, p.port) for p in peers)


def _pack_peers_compact6(peers) -> bytes:
    """BEP 7 ``peers6`` via the shared compact-v6 codec (net/types.py)."""
    from torrent_tpu_torch.net.types import pack_compact_v6

    return pack_compact_v6((p.ip, p.port) for p in peers)


@dataclass
class HttpAnnounceRequest(AnnounceRequest):
    _writer: asyncio.StreamWriter | None = None

    async def respond(self, interval: int, complete: int, incomplete: int, peers):
        """Compact or full bencoded body (server/tracker.ts:98-138)."""
        if self.compact:
            peers_val: object = _pack_peers_compact(peers)
        else:
            peers_val = [
                {
                    b"ip": p.ip.encode(),
                    b"port": p.port,
                    **({b"peer id": p.peer_id} if p.peer_id else {}),
                }
                for p in peers
            ]
        reply = {
            b"interval": interval,
            b"complete": complete,
            b"incomplete": incomplete,
            b"peers": peers_val,
        }
        if self.compact:
            peers6 = _pack_peers_compact6(peers)
            if peers6:
                reply[b"peers6"] = peers6  # BEP 7
        body = bencode(reply)
        await _http_reply(self._writer, 200, body)

    async def reject(self, reason: str):
        # bencoded `failure reason` with HTTP 200, per convention
        # (server/_helpers.ts:9-18).
        await _http_reply(self._writer, 200, bencode({b"failure reason": reason}))


@dataclass
class HttpScrapeRequest(ScrapeRequest):
    _writer: asyncio.StreamWriter | None = None

    async def respond(self, files):
        body = bencode(
            {
                b"files": {
                    h: {b"complete": c, b"downloaded": d, b"incomplete": i}
                    for h, c, d, i in files
                }
            }
        )
        await _http_reply(self._writer, 200, body)

    async def reject(self, reason: str):
        await _http_reply(self._writer, 200, bencode({b"failure reason": reason}))


async def _http_reply(
    writer: asyncio.StreamWriter,
    status: int,
    body: bytes,
    content_type: str = "text/plain",
):
    if writer is None or writer.is_closing():
        return
    head = (
        f"HTTP/1.1 {status} OK\r\nContent-Type: {content_type}\r\n"
        f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
    )
    try:
        writer.write(head.encode("latin-1") + body)
        await writer.drain()
    except (ConnectionError, OSError):
        pass
    finally:
        writer.close()


def _parse_query_raw(query: str) -> dict[str, list[bytes]]:
    """Binary-safe query parsing (server/tracker.ts:328-359).

    Splits on & and = *before* %-decoding so 20-byte info hashes survive;
    repeated keys accumulate (scrape takes many info_hash params).
    """
    params: dict[str, list[bytes]] = {}
    if not query:
        return params
    for part in query.split("&"):
        if not part:
            continue
        key, _, value = part.partition("=")
        try:
            params.setdefault(key, []).append(decode_binary_data(value))
        except ValueError:
            continue  # bad escape: drop the param, validation will catch it
    return params


def _validate_announce_params(params: dict[str, list[bytes]], peer_ip: str):
    """→ dict of fields or an error string (server/tracker.ts:361-397)."""

    def one(key: str) -> bytes | None:
        vals = params.get(key)
        return vals[0] if vals else None

    info_hash = one("info_hash")
    if info_hash is None or len(info_hash) != 20:
        return "invalid info_hash"
    peer_id = one("peer_id")
    if peer_id is None or len(peer_id) != 20:
        return "invalid peer_id"
    fields: dict = {"info_hash": info_hash, "peer_id": peer_id}
    for key, required in (
        ("port", True),
        ("uploaded", True),
        ("downloaded", True),
        ("left", True),
        ("numwant", False),
    ):
        raw = one(key)
        if raw is None:
            if required:
                return f"missing {key}"
            continue
        try:
            fields[key] = int(raw)
        except ValueError:
            return f"invalid {key}"
        if fields[key] < 0:
            return f"invalid {key}"
    if not 0 < fields["port"] < 65536:
        return "invalid port"
    event_raw = one("event")
    if event_raw is None or event_raw == b"":
        fields["event"] = AnnounceEvent.EMPTY
    else:
        try:
            fields["event"] = AnnounceEvent(event_raw.decode("ascii"))
        except (ValueError, UnicodeDecodeError):
            return "invalid event"
    ip_raw = one("ip")
    fields["ip"] = ip_raw.decode("latin-1") if ip_raw else peer_ip
    fields["compact"] = one("compact") != b"0"
    fields["key"] = one("key")
    return fields


# ============================================================== server


@dataclass
class ServeOptions:
    """(server/tracker.ts:615-630). Port 0 = ephemeral; None disables."""

    http_port: int | None = 8000
    udp_port: int | None = 6969
    host: str = "0.0.0.0"
    interval: int = DEFAULT_ANNOUNCE_INTERVAL
    filter_list: set[bytes] | None = None  # allowed info hashes


class TrackerServer:
    """Async-iterable of validated tracker requests from HTTP + UDP."""

    def __init__(self, opts: ServeOptions):
        self.opts = opts
        self._queue: asyncio.Queue = asyncio.Queue()
        self._http_server: asyncio.AbstractServer | None = None
        self._udp_transport: asyncio.DatagramTransport | None = None
        self._closed = False
        # live counters served by /stats
        self.stats = {"announce": 0, "scrape": 0, "rejected": 0}
        # optional /metrics provider (set by the sharded announce plane:
        # server/shard.run_sharded_tracker wires render_tracker_metrics)
        self.metrics_provider = None
        # optional /v1/health provider (zero-arg → the obs/slo
        # build_health dict; run_sharded_tracker wires pump liveness so
        # the tracker is deployable behind a real load balancer)
        self.health_provider = None
        # UDP connection ids: id → minted_at (server/tracker.ts:512-516)
        self._conn_ids: dict[int, float] = {}

    # ------------------------------------------------------------ startup

    async def start(self):
        if self.opts.http_port is not None:
            self._http_server = await asyncio.start_server(
                self._handle_http, self.opts.host, self.opts.http_port
            )
        if self.opts.udp_port is not None:
            loop = asyncio.get_running_loop()
            self._udp_transport, _ = await loop.create_datagram_endpoint(
                lambda: _UdpListener(self),
                local_addr=(self.opts.host, self.opts.udp_port),
            )
        return self

    @property
    def http_port(self) -> int | None:
        if self._http_server is None:
            return None
        return self._http_server.sockets[0].getsockname()[1]

    @property
    def udp_port(self) -> int | None:
        if self._udp_transport is None:
            return None
        return self._udp_transport.get_extra_info("sockname")[1]

    def close(self):
        self._closed = True
        if self._http_server:
            self._http_server.close()
        if self._udp_transport:
            self._udp_transport.close()
        self._queue.put_nowait(None)  # wake the iterator

    # ------------------------------------------------------------ iterate

    def __aiter__(self):
        return self

    async def __anext__(self):
        if self._closed and self._queue.empty():
            raise StopAsyncIteration
        item = await self._queue.get()
        if item is None:
            raise StopAsyncIteration
        return item

    def drain_nowait(self, max_items: int = 256) -> list:
        """Everything already queued, without awaiting — the sharded
        pump's batch-drain: one cycle picks up a whole burst of parsed
        requests so announces can be processed per shard, not per
        datagram. The close sentinel is put back for the iterator."""
        out: list = []
        while len(out) < max_items:
            try:
                item = self._queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            if item is None:
                self._queue.put_nowait(None)
                break
            out.append(item)
        return out

    # ---------------------------------------------------------------- HTTP

    async def _handle_http(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            request_line = (await asyncio.wait_for(reader.readline(), 30)).decode("latin-1")
        except (asyncio.TimeoutError, UnicodeDecodeError):
            writer.close()
            return
        parts = request_line.split()
        if len(parts) < 2 or parts[0] != "GET":
            await _http_reply(writer, 400, b"bad request")
            return
        target = parts[1]
        # read headers; honor X-Forwarded-For (server/tracker.ts:348-350)
        peer_ip = writer.get_extra_info("peername", ("", 0))[0]
        while True:
            try:
                line = await asyncio.wait_for(reader.readline(), 30)
            except asyncio.TimeoutError:
                writer.close()
                return
            if line in (b"\r\n", b"\n", b""):
                break
            if line.lower().startswith(b"x-forwarded-for:"):
                peer_ip = line.split(b":", 1)[1].strip().split(b",")[0].decode("latin-1")

        path, _, query = target.partition("?")
        # route on the last path segment (server/tracker.ts:444)
        route = path.rstrip("/").rsplit("/", 1)[-1]
        if route == "announce":
            await self._http_announce(query, peer_ip, writer)
        elif route == "scrape":
            await self._http_scrape(query, writer)
        elif route == "stats":
            body = bencode({k.encode(): v for k, v in sorted(self.stats.items())})
            await _http_reply(writer, 200, body)
        elif route == "health" and self.health_provider is not None:
            # liveness + readiness (obs/slo.build_health): answering at
            # all is liveness; 200 only when ready, 503 with the
            # reasons otherwise — the standard LB probe contract
            try:
                health = self.health_provider()
            except Exception:  # a probe bug must not kill the listener
                await _http_reply(writer, 500, b"health probe failed")
                return
            import json as _json

            await _http_reply(
                writer,
                200 if health.get("ready") else 503,
                _json.dumps(health, sort_keys=True).encode(),
                content_type="application/json",
            )
        elif route == "metrics" and self.metrics_provider is not None:
            try:
                body = self.metrics_provider().encode()
            except Exception:  # a render bug must not kill the listener
                await _http_reply(writer, 500, b"metrics render failed")
                return
            await _http_reply(
                writer, 200, body,
                content_type="text/plain; version=0.0.4; charset=utf-8",
            )
        else:
            await _http_reply(writer, 404, b"not found")

    async def _http_announce(self, query: str, peer_ip: str, writer):
        fields = _validate_announce_params(_parse_query_raw(query), peer_ip)
        if isinstance(fields, str):
            self.stats["rejected"] += 1
            await _http_reply(writer, 200, bencode({b"failure reason": fields}))
            return
        if self.opts.filter_list is not None and fields["info_hash"] not in self.opts.filter_list:
            self.stats["rejected"] += 1
            await _http_reply(
                writer, 200, bencode({b"failure reason": "torrent not in allowlist"})
            )
            return
        self.stats["announce"] += 1
        req = HttpAnnounceRequest(
            info_hash=fields["info_hash"],
            peer_id=fields["peer_id"],
            ip=fields["ip"],
            port=fields["port"],
            uploaded=fields["uploaded"],
            downloaded=fields["downloaded"],
            left=fields["left"],
            event=fields["event"],
            num_want=min(fields.get("numwant", DEFAULT_NUM_WANT), MAX_NUM_WANT),
            compact=fields["compact"],
            key=fields["key"],
            _writer=writer,
        )
        await self._queue.put(req)

    async def _http_scrape(self, query: str, writer):
        params = _parse_query_raw(query)
        hashes = params.get("info_hash", [])
        if any(len(h) != 20 for h in hashes):
            self.stats["rejected"] += 1
            await _http_reply(writer, 200, bencode({b"failure reason": "invalid info_hash"}))
            return
        if self.opts.filter_list is not None:
            hashes = [h for h in hashes if h in self.opts.filter_list]
        self.stats["scrape"] += 1
        await self._queue.put(HttpScrapeRequest(info_hashes=hashes, _writer=writer))

    # ---------------------------------------------------------------- UDP

    def _mint_connection_id(self) -> int:
        now = time.monotonic()
        for cid, t in list(self._conn_ids.items()):
            if now - t > UDP_CONNECTION_TTL:
                del self._conn_ids[cid]
        cid = random.getrandbits(63)
        self._conn_ids[cid] = now
        return cid

    def _connection_id_valid(self, cid: int) -> bool:
        t = self._conn_ids.get(cid)
        return t is not None and time.monotonic() - t <= UDP_CONNECTION_TTL


class _UdpListener(asyncio.DatagramProtocol):
    def __init__(self, server: TrackerServer):
        self.server = server
        self.transport: asyncio.DatagramTransport | None = None

    def connection_made(self, transport):
        self.transport = transport

    def _send_error(self, tid: bytes, reason: str, addr):
        # UDP error packet (server/_helpers.ts:20-36)
        self.server.stats["rejected"] += 1
        self.transport.sendto(
            write_int(UdpTrackerAction.ERROR, 4) + tid + reason.encode(), addr
        )

    def datagram_received(self, data: bytes, addr):
        srv = self.server
        if len(data) < 16:
            return
        action = read_int(data, 4, 8)
        tid = data[12:16]
        if action == UdpTrackerAction.CONNECT:
            if read_int(data, 8, 0) != UDP_CONNECT_MAGIC:
                return  # not a BitTorrent connect; drop silently
            cid = srv._mint_connection_id()
            self.transport.sendto(
                write_int(UdpTrackerAction.CONNECT, 4) + tid + write_int(cid, 8), addr
            )
            return
        if not srv._connection_id_valid(read_int(data, 8, 0)):
            self._send_error(tid, "expired connection id", addr)
            return
        if action == UdpTrackerAction.ANNOUNCE:
            if len(data) < 98:
                self._send_error(tid, "truncated announce", addr)
                return
            event_code = read_int(data, 4, 80)
            event = UDP_CODE_EVENT.get(event_code)
            if event is None:
                self._send_error(tid, "invalid event", addr)
                return
            port = read_int(data, 2, 96)
            if port == 0:
                self._send_error(tid, "invalid port", addr)
                return
            info_hash = data[16:36]
            if srv.opts.filter_list is not None and info_hash not in srv.opts.filter_list:
                self._send_error(tid, "torrent not in allowlist", addr)
                return
            ip_raw = data[84:88]
            ip = (
                ".".join(str(b) for b in ip_raw)
                if ip_raw != b"\x00\x00\x00\x00"
                else addr[0]
            )
            # BEP 15 num_want is signed; -1/any negative means "default".
            # Cap the rest so a compact response always fits one datagram.
            raw_num_want = read_int(data, 4, 92)
            if raw_num_want >= 1 << 31:
                num_want = DEFAULT_NUM_WANT
            else:
                num_want = min(raw_num_want, MAX_NUM_WANT)
            srv.stats["announce"] += 1
            req = UdpAnnounceRequest(
                info_hash=info_hash,
                peer_id=data[36:56],
                ip=ip,
                port=port,
                downloaded=read_int(data, 8, 56),
                left=read_int(data, 8, 64),
                uploaded=read_int(data, 8, 72),
                event=event,
                num_want=num_want,
                key=data[88:92],
                _transport=self.transport,
                _addr=addr,
                _tid=tid,
            )
            srv._queue.put_nowait(req)
        elif action == UdpTrackerAction.SCRAPE:
            body = data[16:]
            if len(body) % 20 != 0:
                self._send_error(tid, "malformed scrape", addr)
                return
            hashes = [body[i : i + 20] for i in range(0, len(body), 20)]
            if srv.opts.filter_list is not None:
                hashes = [h for h in hashes if h in srv.opts.filter_list]
            srv.stats["scrape"] += 1
            srv._queue.put_nowait(
                UdpScrapeRequest(
                    info_hashes=hashes, _transport=self.transport, _addr=addr, _tid=tid
                )
            )
        else:
            self._send_error(tid, "unknown action", addr)


@dataclass
class UdpAnnounceRequest(AnnounceRequest):
    _transport: asyncio.DatagramTransport | None = None
    _addr: tuple = ()
    _tid: bytes = b""

    async def respond(self, interval: int, complete: int, incomplete: int, peers):
        """Announce response packet (server/tracker.ts:187-211)."""
        pkt = (
            write_int(UdpTrackerAction.ANNOUNCE, 4)
            + self._tid
            + write_int(interval, 4)
            + write_int(incomplete, 4)
            + write_int(complete, 4)
            + _pack_peers_compact(peers)
        )
        self._transport.sendto(pkt, self._addr)

    async def reject(self, reason: str):
        self._transport.sendto(
            write_int(UdpTrackerAction.ERROR, 4) + self._tid + reason.encode(), self._addr
        )


@dataclass
class UdpScrapeRequest(ScrapeRequest):
    _transport: asyncio.DatagramTransport | None = None
    _addr: tuple = ()
    _tid: bytes = b""

    async def respond(self, files):
        """Scrape response packet (server/tracker.ts:294-312)."""
        body = b"".join(
            write_int(c, 4) + write_int(d, 4) + write_int(i, 4) for _, c, d, i in files
        )
        self._transport.sendto(
            write_int(UdpTrackerAction.SCRAPE, 4) + self._tid + body, self._addr
        )

    async def reject(self, reason: str):
        self._transport.sendto(
            write_int(UdpTrackerAction.ERROR, 4) + self._tid + reason.encode(), self._addr
        )


async def serve_tracker(opts: ServeOptions | None = None) -> TrackerServer:
    """Bind listeners and return the request stream (server/tracker.ts:633-654)."""
    server = TrackerServer(opts or ServeOptions())
    return await server.start()
