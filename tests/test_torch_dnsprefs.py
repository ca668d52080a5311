"""BEP 34 DNS tracker preferences: RFC 1035 TXT client + URL rewriting.

The fake nameserver answers on loopback UDP with hand-built records, so
every path — prefs, deny, no-record, malformed, timeout — runs against
real datagrams.
"""

import asyncio

import pytest

from torrent_tpu_torch.net import dnsprefs as dp

from tests.test_torch_session import run


def _txt_answer(query: bytes, txts: list[bytes], rcode: int = 0) -> bytes:
    """Minimal DNS response echoing the question, one TXT RR per entry."""
    txid = query[0:2]
    qname_end = query.index(b"\x00", 12) + 1 + 4  # qname + qtype/qclass
    question = query[12:qname_end]
    header = (
        txid
        + bytes([0x81, 0x80 | rcode])
        + b"\x00\x01"
        + len(txts).to_bytes(2, "big")
        + b"\x00\x00\x00\x00"
    )
    answers = b""
    for t in txts:
        rdata = bytes([len(t)]) + t
        answers += (
            b"\xc0\x0c"  # compressed pointer to qname
            + dp.QTYPE_TXT.to_bytes(2, "big")
            + dp.QCLASS_IN.to_bytes(2, "big")
            + (300).to_bytes(4, "big")
            + len(rdata).to_bytes(2, "big")
            + rdata
        )
    return header + question + answers


class _FakeDns(asyncio.DatagramProtocol):
    """Maps queried name -> list of TXT payloads (or 'drop')."""

    def __init__(self, table):
        self.table = table
        self.queries: list[str] = []

    def connection_made(self, transport):
        self.transport = transport

    def datagram_received(self, data, addr):
        # decode qname labels
        i, labels = 12, []
        while data[i]:
            n = data[i]
            labels.append(data[i + 1 : i + 1 + n].decode())
            i += 1 + n
        name = ".".join(labels)
        self.queries.append(name)
        entry = self.table.get(name)
        if entry == "drop":
            return
        self.transport.sendto(_txt_answer(data, entry or []), addr)


async def _fake_server(table):
    loop = asyncio.get_running_loop()
    transport, proto = await loop.create_datagram_endpoint(
        lambda: _FakeDns(table), local_addr=("127.0.0.1", 0)
    )
    return transport, proto, transport.get_extra_info("sockname")[:2]


class TestParsing:
    def test_bep34_records(self):
        assert dp.parse_bep34(["BITTORRENT UDP:6969 TCP:8080"]) == [
            ("UDP", 6969),
            ("TCP", 8080),
        ]
        assert dp.parse_bep34(["BITTORRENT"]) == dp.DENY
        assert dp.parse_bep34(["v=spf1 ~all"]) is None
        assert dp.parse_bep34([]) is None
        # garbage tokens skipped; all-garbage fails safe to deny
        assert dp.parse_bep34(["BITTORRENT XDP:1 TCP:70000 TCP:99"]) == [
            ("TCP", 99)
        ]
        assert dp.parse_bep34(["BITTORRENT XDP:1"]) == dp.DENY

    def test_query_roundtrip_against_fake_server(self):
        async def go():
            transport, proto, addr = await _fake_server(
                {"tracker.example": [b"BITTORRENT UDP:1337"]}
            )
            try:
                txts = await dp.query_txt("tracker.example", addr, timeout=5)
                assert txts == ["BITTORRENT UDP:1337"]
            finally:
                transport.close()

        run(go())

    def test_malformed_and_mismatched_packets_rejected(self):
        q = dp.build_txt_query("a.example", 7)
        with pytest.raises(ValueError):
            dp.parse_txt_response(b"\x00\x07\x81\x80", 7)  # short
        with pytest.raises(ValueError):
            dp.parse_txt_response(_txt_answer(q, [b"x"]), 8)  # txid mismatch
        with pytest.raises(ValueError):
            dp.parse_txt_response(q, 7)  # a query, not a response

    def test_endpoint_count_capped(self):
        """One hostile record cannot mint thousands of announce
        candidates (each would burn a per-tracker timeout)."""
        record = "BITTORRENT " + " ".join(f"UDP:{p}" for p in range(1, 500))
        prefs = dp.parse_bep34([record])
        assert len(prefs) == dp.MAX_PREF_ENDPOINTS

    def test_txt_segment_may_not_cross_rdata(self):
        q = dp.build_txt_query("x.example", 9)
        pkt = bytearray(_txt_answer(q, [b"ab"]))
        # rdata is [len=2]'ab'; inflate the segment length past rdlen
        pkt[-3] = 200
        with pytest.raises(ValueError):
            dp.parse_txt_response(bytes(pkt), 9)

    def test_concurrent_lookups_share_one_query(self):
        async def go():
            transport, proto, addr = await _fake_server(
                {"busy.example": [b"BITTORRENT TCP:80"]}
            )
            try:
                prefs = dp.TrackerPrefs(server=addr)
                results = await asyncio.gather(
                    *(prefs.lookup("busy.example") for _ in range(20))
                )
                assert all(r == [("TCP", 80)] for r in results)
                assert proto.queries.count("busy.example") == 1
            finally:
                transport.close()

        run(go())

    def test_disabled_under_socks_proxy(self):
        """BEP 34 lookups are raw host UDP: under a proxy they must not
        run at all (hostname leak around the tunnel)."""
        from torrent_tpu_torch.session.client import Client, ClientConfig

        c = Client(
            ClientConfig(
                dns_tracker_prefs=True, proxy="socks5://127.0.0.1:1080", hasher="cpu"
            )
        )
        assert c.dns_prefs is None
        c2 = Client(ClientConfig(dns_tracker_prefs=True, hasher="cpu"))
        assert c2.dns_prefs is not None

    def test_hostile_packets_never_crash(self):
        import random as _r

        q = dp.build_txt_query("fuzz.example", 3)
        base = _txt_answer(q, [b"BITTORRENT UDP:1 TCP:2", b"other"])
        rng = _r.Random(5)
        for _ in range(3000):
            buf = bytearray(base)
            for _ in range(rng.randrange(1, 6)):
                buf[rng.randrange(len(buf))] = rng.randrange(256)
            cut = rng.randrange(len(buf) + 1)
            try:
                dp.parse_txt_response(bytes(buf[:cut]), 3)
            except ValueError:
                pass  # rejecting is fine; raising anything else is not


class TestTrackerPrefs:
    def test_apply_rewrites_denies_and_caches(self, ):
        async def go():
            transport, proto, addr = await _fake_server(
                {
                    "pref.example": [b"BITTORRENT UDP:1337 TCP:8080"],
                    "deny.example": [b"BITTORRENT"],
                    "plain.example": [b"unrelated TXT"],
                }
            )
            try:
                prefs = dp.TrackerPrefs(server=addr)
                got = await prefs.apply("http://pref.example:6969/announce")
                assert got == [
                    "udp://pref.example:1337/announce",
                    "http://pref.example:8080/announce",
                ]
                assert await prefs.apply("udp://deny.example:1/announce") == []
                # no record: announce exactly as written
                url = "http://plain.example/announce"
                assert await prefs.apply(url) == [url]
                # IPs never get lookups; unknown schemes pass through
                assert await prefs.apply("http://127.0.0.1:9/announce") == [
                    "http://127.0.0.1:9/announce"
                ]
                n = len(proto.queries)
                await prefs.apply("http://pref.example:6969/announce")
                assert len(proto.queries) == n  # cached: no new query
            finally:
                transport.close()

        run(go())

    def test_resolver_failure_fails_open(self):
        async def go():
            transport, proto, addr = await _fake_server(
                {"slow.example": "drop"}
            )
            try:
                prefs = dp.TrackerPrefs(server=addr, timeout=0.3)
                url = "http://slow.example/announce"
                assert await prefs.apply(url) == [url]  # timeout -> as-is
            finally:
                transport.close()

        run(go())

    def test_tracker_rotation_honors_deny_and_rewrite(self, tmp_path):
        """e2e: a TrackerList with BEP 34 prefs skips a denied tracker and
        announces to the rewritten endpoint of the preferred one — against
        a real in-memory tracker bound on the REWRITTEN port."""
        from torrent_tpu_torch.net.multitracker import TrackerList
        from torrent_tpu_torch.net.types import AnnounceInfo
        from torrent_tpu_torch.server.in_memory import run_tracker
        from torrent_tpu_torch.server.tracker import ServeOptions

        async def go():
            server, _ = await run_tracker(
                ServeOptions(http_port=0, udp_port=None, interval=1)
            )
            port = server.http_port
            transport, proto, addr = await _fake_server(
                {
                    "deny.example": [b"BITTORRENT"],
                    # localhost resolves; the TXT rewrite points the
                    # announce at the REAL tracker's port
                    "localhost": [f"BITTORRENT TCP:{port}".encode()],
                }
            )
            try:
                prefs = dp.TrackerPrefs(server=addr)
                tl = TrackerList(
                    "http://deny.example:1/announce",
                    tiers=[
                        ["http://deny.example:1/announce"],
                        ["http://localhost:1/announce"],  # wrong port on wire
                    ],
                    dns_prefs=prefs,
                )
                info = AnnounceInfo(
                    info_hash=b"h" * 20,
                    peer_id=b"p" * 20,
                    port=6881,
                    uploaded=0,
                    downloaded=0,
                    left=0,
                )
                res = await tl.announce(info, per_tracker_timeout=10)
                assert res.interval >= 1  # announced via the rewrite
                # the deny host was consulted (one lookup each) and never
                # announced to; announce succeeded through the rewrite
                assert "deny.example" in proto.queries
                assert "localhost" in proto.queries
            finally:
                transport.close()
                server.close()

        run(go())
