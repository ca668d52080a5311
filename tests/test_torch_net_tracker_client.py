"""Tracker client tests — fake in-process trackers per test.

The reference's strongest suite (tracker_test.ts, 494 LoC) is the model:
fake HTTP trackers assert the exact request and reply with hand-written
bencode (full/compact/malformed/failure variants); fake UDP trackers
implement the connect handshake then canned packets. Rebuilt here as
asyncio servers on ephemeral localhost ports.
"""

import asyncio

import pytest

from torrent_tpu_torch.codec.bencode import bencode
from torrent_tpu_torch.net.tracker import TrackerError, announce, scrape, scrape_url_for
from torrent_tpu_torch.net.types import AnnounceEvent, AnnounceInfo
from torrent_tpu_torch.utils.bytesio import write_int

INFO_HASH = bytes(range(20))
PEER_ID = b"-TT0001-0123456789ab"


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 30))


def make_info(**kw):
    defaults = dict(info_hash=INFO_HASH, peer_id=PEER_ID, port=6881, left=1000)
    defaults.update(kw)
    return AnnounceInfo(**defaults)


class FakeHttpTracker:
    """Replies with canned bytes; records the request line."""

    def __init__(self, body: bytes, status: int = 200):
        self.body = body
        self.status = status
        self.requests: list[str] = []
        self.server = None
        self.port = None

    async def __aenter__(self):
        async def handle(reader, writer):
            line = (await reader.readline()).decode("latin-1").strip()
            self.requests.append(line)
            while (await reader.readline()) not in (b"\r\n", b""):
                pass
            writer.write(
                f"HTTP/1.1 {self.status} X\r\nContent-Length: {len(self.body)}\r\n\r\n".encode()
                + self.body
            )
            await writer.drain()
            writer.close()

        self.server = await asyncio.start_server(handle, "127.0.0.1", 0)
        self.port = self.server.sockets[0].getsockname()[1]
        return self

    async def __aexit__(self, *exc):
        self.server.close()
        await self.server.wait_closed()


class TestHttpAnnounce:
    def test_compact_response_and_request_params(self):
        async def go():
            body = bencode(
                {
                    b"interval": 1800,
                    b"complete": 3,
                    b"incomplete": 7,
                    b"peers": bytes([10, 0, 0, 1]) + write_int(6881, 2) + bytes([10, 0, 0, 2]) + write_int(51413, 2),
                }
            )
            async with FakeHttpTracker(body) as t:
                res = await announce(
                    f"http://127.0.0.1:{t.port}/announce",
                    make_info(event=AnnounceEvent.STARTED, uploaded=5, downloaded=9),
                )
                req = t.requests[0]
                assert "info_hash=%00%01%02%03%04%05%06%07%08%09%0A%0B%0C%0D%0E%0F%10%11%12%13" in req
                assert "peer_id=-TT0001-0123456789ab" in req
                assert "port=6881" in req and "uploaded=5" in req and "downloaded=9" in req
                assert "left=1000" in req and "compact=1" in req and "event=started" in req
                assert res.interval == 1800 and res.complete == 3 and res.incomplete == 7
                assert [(p.ip, p.port) for p in res.peers] == [
                    ("10.0.0.1", 6881),
                    ("10.0.0.2", 51413),
                ]

        run(go())

    def test_event_empty_omitted(self):
        async def go():
            body = bencode({b"interval": 60, b"peers": b""})
            async with FakeHttpTracker(body) as t:
                await announce(f"http://127.0.0.1:{t.port}/announce", make_info())
                assert "event=" not in t.requests[0]

        run(go())

    def test_full_peer_list(self):
        async def go():
            body = bencode(
                {
                    b"interval": 60,
                    b"peers": [
                        {b"ip": b"192.168.0.9", b"port": 1234, b"peer id": b"x" * 20},
                        {b"ip": b"example.com", b"port": 80},
                    ],
                }
            )
            async with FakeHttpTracker(body) as t:
                res = await announce(f"http://127.0.0.1:{t.port}/announce", make_info())
                assert res.peers[0].peer_id == b"x" * 20
                assert res.peers[1].ip == "example.com" and res.peers[1].peer_id is None

        run(go())

    def test_failure_reason(self):
        async def go():
            async with FakeHttpTracker(bencode({b"failure reason": b"unregistered torrent"})) as t:
                with pytest.raises(TrackerError, match="unregistered torrent"):
                    await announce(f"http://127.0.0.1:{t.port}/announce", make_info())

        run(go())

    def test_malformed_response(self):
        async def go():
            async with FakeHttpTracker(b"this is not bencode") as t:
                with pytest.raises(TrackerError, match="malformed"):
                    await announce(f"http://127.0.0.1:{t.port}/announce", make_info())

        run(go())

    def test_http_error_status(self):
        async def go():
            async with FakeHttpTracker(b"nope", status=500) as t:
                with pytest.raises(TrackerError, match="HTTP 500"):
                    await announce(f"http://127.0.0.1:{t.port}/announce", make_info())

        run(go())

    def test_missing_interval(self):
        async def go():
            async with FakeHttpTracker(bencode({b"peers": b""})) as t:
                with pytest.raises(TrackerError, match="interval"):
                    await announce(f"http://127.0.0.1:{t.port}/announce", make_info())

        run(go())

    def test_unsupported_scheme(self):
        with pytest.raises(TrackerError, match="unsupported"):
            run(announce("ftp://example.com/announce", make_info()))

    def test_connection_refused(self):
        with pytest.raises(TrackerError, match="connection failed"):
            run(announce("http://127.0.0.1:1/announce", make_info()))


class TestHttpScrape:
    def test_scrape_url_derivation(self):
        assert scrape_url_for("http://t.example/announce") == "http://t.example/scrape"
        assert (
            scrape_url_for("http://t.example/x/announce.php?k=v")
            == "http://t.example/x/scrape.php?k=v"
        )
        with pytest.raises(TrackerError):
            scrape_url_for("http://t.example/ann")

    def test_scrape_response_binary_keys(self):
        async def go():
            body = bencode(
                {
                    b"files": {
                        INFO_HASH: {b"complete": 5, b"downloaded": 50, b"incomplete": 10}
                    }
                }
            )
            async with FakeHttpTracker(body) as t:
                res = await scrape(f"http://127.0.0.1:{t.port}/announce", [INFO_HASH])
                assert t.requests[0].startswith("GET /scrape?info_hash=%00%01")
                assert res[0].info_hash == INFO_HASH
                assert (res[0].complete, res[0].downloaded, res[0].incomplete) == (5, 50, 10)

        run(go())

    def test_scrape_failure(self):
        async def go():
            async with FakeHttpTracker(bencode({b"failure reason": b"scrape disabled"})) as t:
                with pytest.raises(TrackerError, match="scrape disabled"):
                    await scrape(f"http://127.0.0.1:{t.port}/announce", [INFO_HASH])

        run(go())


class FakeUdpTracker(asyncio.DatagramProtocol):
    """BEP 15 fake: real connect handshake, scripted announce/scrape replies."""

    CONN_ID = 0x1122334455667788

    def __init__(self, mode="announce"):
        self.mode = mode
        self.requests: list[bytes] = []
        self.transport = None

    def connection_made(self, transport):
        self.transport = transport

    def datagram_received(self, data, addr):
        self.requests.append(data)
        action = int.from_bytes(data[8:12], "big")
        tid = data[12:16]
        if action == 0:  # connect
            if data[:8] != write_int(0x41727101980, 8):
                return  # bad magic: drop
            self.transport.sendto(write_int(0, 4) + tid + write_int(self.CONN_ID, 8), addr)
        elif action == 1:
            if self.mode == "announce":
                pkt = (
                    write_int(1, 4) + tid + write_int(1200, 4) + write_int(4, 4) + write_int(2, 4)
                    + bytes([10, 1, 1, 1]) + write_int(7777, 2)
                )
                self.transport.sendto(pkt, addr)
            elif self.mode == "error":
                self.transport.sendto(write_int(3, 4) + tid + b"torrent not allowed", addr)
            elif self.mode == "garbage":
                self.transport.sendto(write_int(9, 4) + tid + b"????", addr)
            # mode == "silent": no reply
        elif action == 2:
            n = (len(data) - 16) // 20
            body = b"".join(write_int(i + 1, 4) + write_int(i + 2, 4) + write_int(i + 3, 4) for i in range(n))
            self.transport.sendto(write_int(2, 4) + tid + body, addr)


async def with_udp_tracker(mode, fn):
    loop = asyncio.get_running_loop()
    transport, proto = await loop.create_datagram_endpoint(
        lambda: FakeUdpTracker(mode), local_addr=("127.0.0.1", 0)
    )
    port = transport.get_extra_info("sockname")[1]
    try:
        return await fn(f"udp://127.0.0.1:{port}", proto)
    finally:
        transport.close()


class TestUdpTracker:
    def setup_method(self):
        from torrent_tpu_torch.net import tracker as trk

        trk._conn_cache.clear()

    def test_announce_roundtrip(self):
        async def go():
            async def fn(url, proto):
                res = await announce(url, make_info(event=AnnounceEvent.STARTED))
                # request 0 = connect, request 1 = announce (98 bytes)
                assert len(proto.requests) == 2
                ann = proto.requests[1]
                assert len(ann) == 98
                assert ann[:8] == write_int(FakeUdpTracker.CONN_ID, 8)
                assert ann[16:36] == INFO_HASH and ann[36:56] == PEER_ID
                assert int.from_bytes(ann[80:84], "big") == 2  # started
                assert res.interval == 1200 and res.complete == 2 and res.incomplete == 4
                assert [(p.ip, p.port) for p in res.peers] == [("10.1.1.1", 7777)]

            await with_udp_tracker("announce", fn)

        run(go())

    def test_connection_id_cached(self):
        async def go():
            async def fn(url, proto):
                await announce(url, make_info())
                await announce(url, make_info())
                # connect happens once; two announces reuse the id
                actions = [int.from_bytes(r[8:12], "big") for r in proto.requests]
                assert actions == [0, 1, 1]

            await with_udp_tracker("announce", fn)

        run(go())

    def test_tracker_error_packet(self):
        async def go():
            async def fn(url, proto):
                with pytest.raises(TrackerError, match="torrent not allowed"):
                    await announce(url, make_info())

            await with_udp_tracker("error", fn)

        run(go())

    def test_scrape(self):
        async def go():
            async def fn(url, proto):
                h2 = bytes(range(20, 40))
                res = await scrape(url, [INFO_HASH, h2])
                assert (res[0].complete, res[0].downloaded, res[0].incomplete) == (1, 2, 3)
                assert (res[1].complete, res[1].downloaded, res[1].incomplete) == (2, 3, 4)
                assert res[1].info_hash == h2

            await with_udp_tracker("announce", fn)

        run(go())

    def test_retry_then_give_up(self, monkeypatch):
        # shrink backoff so the test runs in milliseconds
        from torrent_tpu_torch.net import tracker as trk

        monkeypatch.setattr(trk, "UDP_BACKOFF_BASE", 0.05)

        async def go():
            async def fn(url, proto):
                with pytest.raises(TrackerError, match="after 2 attempts"):
                    await trk._udp_call(
                        url,
                        lambda cid, tid: write_int(cid, 8) + write_int(1, 4) + write_int(tid, 4),
                        lambda r: r,
                        max_attempts=2,
                    )
                # each attempt re-connects (cache cleared on failure) then
                # sends the announce that goes unanswered: 2 × (connect+announce)
                actions = [int.from_bytes(r[8:12], "big") for r in proto.requests]
                assert actions == [0, 1, 0, 1]

            await with_udp_tracker("silent", fn)

        run(go())


class TestBep7Peers6:
    def test_client_parses_peers6(self):
        """BEP 7: 18-byte compact IPv6 entries in the peers6 key."""
        import socket

        async def go():
            v6 = socket.inet_pton(socket.AF_INET6, "2001:db8::7") + write_int(7000, 2)
            body = bencode(
                {
                    b"interval": 60,
                    b"peers": bytes([10, 0, 0, 1]) + write_int(6881, 2),
                    b"peers6": v6,
                }
            )
            async with FakeHttpTracker(body) as t:
                res = await announce(
                    f"http://127.0.0.1:{t.port}/announce", make_info()
                )
                assert [(p.ip, p.port) for p in res.peers] == [
                    ("10.0.0.1", 6881),
                    ("2001:db8::7", 7000),
                ]

        run(go())

    def test_bad_peers6_length_rejected(self):
        async def go():
            body = bencode({b"interval": 60, b"peers": b"", b"peers6": b"short"})
            async with FakeHttpTracker(body) as t:
                with pytest.raises(TrackerError, match="peers6"):
                    await announce(f"http://127.0.0.1:{t.port}/announce", make_info())

        run(go())

    def test_server_packs_peers6_roundtrip(self):
        """Our server's compact response splits v4/v6 peers per BEP 7 and
        our client reassembles them — free integration coverage the
        reference never had."""
        import socket

        from torrent_tpu_torch.server.in_memory import FileInfo, PeerState, run_tracker
        from torrent_tpu_torch.server.tracker import ServeOptions

        async def go():
            server, pump = await run_tracker(
                ServeOptions(http_port=0, udp_port=None, interval=1)
            )
            try:
                ih = bytes(range(20))
                info = FileInfo(complete=2, downloaded=0, incomplete=0)
                info.peers[b"4" * 20] = PeerState(b"4" * 20, "10.1.1.1", 6881, left=0)
                info.peers[b"6" * 20] = PeerState(b"6" * 20, "2001:db8::9", 6882, left=0)
                pump.tracker.files[ih] = info
                res = await announce(
                    f"http://127.0.0.1:{server.http_port}/announce",
                    make_info(info_hash=ih, left=100),
                )
                got = {(p.ip, p.port) for p in res.peers}
                assert ("10.1.1.1", 6881) in got
                assert ("2001:db8::9", 6882) in got
            finally:
                server.close()
                pump.cancel()

        run(go())

    def test_peers6_only_response(self):
        """BEP 7 IPv6-only tracker: no peers key at all is still valid."""
        import socket

        async def go():
            v6 = socket.inet_pton(socket.AF_INET6, "::1") + write_int(9000, 2)
            body = bencode({b"interval": 60, b"peers6": v6})
            async with FakeHttpTracker(body) as t:
                res = await announce(f"http://127.0.0.1:{t.port}/announce", make_info())
                assert [(p.ip, p.port) for p in res.peers] == [("::1", 9000)]

        run(go())


class ScriptedHttpServer:
    """Serves raw pre-scripted HTTP responses, one per connection, in order.

    Unlike FakeHttpTracker this sends whatever bytes the script says —
    used for redirect chains and chunked transfer-encoding, which the
    reference's fetch() handled implicitly (tracker.ts:26-31)."""

    def __init__(self, responses: list[bytes]):
        self.responses = list(responses)
        self.requests: list[str] = []
        self.server = None
        self.port = None

    async def __aenter__(self):
        async def handle(reader, writer):
            line = (await reader.readline()).decode("latin-1").strip()
            self.requests.append(line)
            while (await reader.readline()) not in (b"\r\n", b""):
                pass
            if self.responses:
                writer.write(self.responses.pop(0))
                await writer.drain()
            writer.close()

        self.server = await asyncio.start_server(handle, "127.0.0.1", 0)
        self.port = self.server.sockets[0].getsockname()[1]
        return self

    async def __aexit__(self, *exc):
        self.server.close()
        await self.server.wait_closed()


def _chunked(body: bytes, chunk: int = 7) -> bytes:
    out = b""
    for i in range(0, len(body), chunk):
        part = body[i : i + chunk]
        out += f"{len(part):x}".encode() + b"\r\n" + part + b"\r\n"
    return out + b"0\r\n\r\n"


class TestHttpRobustness:
    """Redirects + chunked bodies from HTTP trackers."""

    def _ok(self, body: bytes) -> bytes:
        return (
            f"HTTP/1.1 200 OK\r\nContent-Length: {len(body)}\r\n\r\n".encode() + body
        )

    def _redirect(self, location: str, status: int = 302) -> bytes:
        return f"HTTP/1.1 {status} Moved\r\nLocation: {location}\r\nContent-Length: 0\r\n\r\n".encode()

    def test_announce_follows_redirect(self):
        async def go():
            body = bencode({b"interval": 60, b"peers": b""})
            # First connection redirects to /announce2 on the same server,
            # second serves the real answer.
            srv = ScriptedHttpServer([b"", self._ok(body)])
            async with srv:
                srv.responses[0] = self._redirect(
                    f"http://127.0.0.1:{srv.port}/announce2"
                )
                res = await announce(f"http://127.0.0.1:{srv.port}/announce", make_info())
                assert res.interval == 60
                assert srv.requests[1].startswith("GET /announce2 ")

        run(go())

    def test_announce_follows_relative_redirect(self):
        async def go():
            body = bencode({b"interval": 42, b"peers": b""})
            srv = ScriptedHttpServer([self._redirect("/a2?x=1", 301), self._ok(body)])
            async with srv:
                res = await announce(f"http://127.0.0.1:{srv.port}/announce", make_info())
                assert res.interval == 42
                assert srv.requests[1].startswith("GET /a2?x=1 ")

        run(go())

    def test_redirect_loop_errors(self):
        async def go():
            srv = ScriptedHttpServer([])
            async with srv:
                loop_resp = self._redirect(f"http://127.0.0.1:{srv.port}/announce")
                srv.responses.extend([loop_resp] * 10)
                with pytest.raises(TrackerError, match="too many HTTP redirects"):
                    await announce(f"http://127.0.0.1:{srv.port}/announce", make_info())

        run(go())

    def test_redirect_without_location_errors(self):
        async def go():
            srv = ScriptedHttpServer(
                [b"HTTP/1.1 302 Moved\r\nContent-Length: 0\r\n\r\n"]
            )
            async with srv:
                with pytest.raises(TrackerError, match="redirect without Location"):
                    await announce(f"http://127.0.0.1:{srv.port}/announce", make_info())

        run(go())

    def test_chunked_announce_body(self):
        async def go():
            body = bencode(
                {b"interval": 90, b"peers": bytes([10, 0, 0, 1]) + write_int(6881, 2)}
            )
            resp = (
                b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n"
                + _chunked(body)
            )
            srv = ScriptedHttpServer([resp])
            async with srv:
                res = await announce(f"http://127.0.0.1:{srv.port}/announce", make_info())
                assert res.interval == 90
                assert [(p.ip, p.port) for p in res.peers] == [("10.0.0.1", 6881)]

        run(go())

    def test_chunked_with_extensions_and_trailer(self):
        async def go():
            body = bencode({b"interval": 30, b"peers": b""})
            # One chunk with an extension, plus a trailer header.
            chunked = (
                f"{len(body):x};name=val\r\n".encode() + body + b"\r\n"
                b"0\r\nX-Trailer: 1\r\n\r\n"
            )
            resp = b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n" + chunked
            srv = ScriptedHttpServer([resp])
            async with srv:
                res = await announce(f"http://127.0.0.1:{srv.port}/announce", make_info())
                assert res.interval == 30

        run(go())

    def test_no_content_length_reads_to_eof(self):
        async def go():
            body = bencode({b"interval": 15, b"peers": b""})
            resp = b"HTTP/1.1 200 OK\r\n\r\n" + body
            srv = ScriptedHttpServer([resp])
            async with srv:
                res = await announce(f"http://127.0.0.1:{srv.port}/announce", make_info())
                assert res.interval == 15

        run(go())

    def test_truncated_chunked_body_errors(self):
        async def go():
            resp = b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\nff\r\nshort"
            srv = ScriptedHttpServer([resp])
            async with srv:
                with pytest.raises(TrackerError, match="truncated"):
                    await announce(f"http://127.0.0.1:{srv.port}/announce", make_info())

        run(go())


class TestHttpBodyCap:
    """The body-size cap is enforced WHILE streaming: a hostile server
    must not balloon RAM for the whole timeout before a length check."""

    def test_content_length_over_cap_rejected_before_read(self):
        async def go():
            from torrent_tpu_torch.net.tracker import _http_get

            hdr = b"HTTP/1.1 200 OK\r\nContent-Length: 99999999\r\n\r\n"
            srv = ScriptedHttpServer([hdr + b"x" * 1024])
            async with srv:
                with pytest.raises(TrackerError, match="exceeds"):
                    await _http_get(
                        f"http://127.0.0.1:{srv.port}/t", max_bytes=65536
                    )

        run(go())

    def test_eof_delimited_body_capped_mid_stream(self):
        async def go():
            from torrent_tpu_torch.net.tracker import _http_get

            # no Content-Length: EOF delimits; body exceeds the cap
            srv = ScriptedHttpServer(
                [b"HTTP/1.1 200 OK\r\n\r\n" + b"y" * (256 * 1024)]
            )
            async with srv:
                with pytest.raises(TrackerError, match="exceeds"):
                    await _http_get(
                        f"http://127.0.0.1:{srv.port}/t", max_bytes=65536
                    )

        run(go())

    def test_chunked_body_capped_mid_stream(self):
        async def go():
            from torrent_tpu_torch.net.tracker import _http_get

            chunk = b"10000\r\n" + b"z" * 65536 + b"\r\n"
            srv = ScriptedHttpServer(
                [
                    b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n"
                    + chunk * 3
                    + b"0\r\n\r\n"
                ]
            )
            async with srv:
                with pytest.raises(TrackerError, match="exceeds"):
                    await _http_get(
                        f"http://127.0.0.1:{srv.port}/t", max_bytes=100_000
                    )

        run(go())

    def test_under_cap_passes(self):
        async def go():
            from torrent_tpu_torch.net.tracker import _http_get

            srv = ScriptedHttpServer(
                [b"HTTP/1.1 200 OK\r\nContent-Length: 5\r\n\r\nhello"]
            )
            async with srv:
                body = await _http_get(
                    f"http://127.0.0.1:{srv.port}/t", max_bytes=65536
                )
                assert body == b"hello"

        run(go())
