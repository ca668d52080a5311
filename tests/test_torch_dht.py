"""BEP 5 mainline DHT tests — a real multi-node swarm on localhost UDP.

Covers KRPC round-trips, token discipline, routing-table Kademlia rules,
iterative lookup convergence across a 12-node network, and the full
announce → lookup_peers discovery cycle (the trackerless magnet path).
"""

import asyncio

import pytest

from torrent_tpu_torch.net.dht import (
    DHTError,
    DHTNode,
    RoutingTable,
    TokenJar,
    pack_compact_node,
    pack_compact_peer,
    unpack_compact_nodes,
    unpack_compact_peers,
    xor_distance,
)


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def nid(i: int) -> bytes:
    return i.to_bytes(20, "big")


class TestCompactCodecs:
    def test_peer_roundtrip(self):
        blob = pack_compact_peer("10.1.2.3", 51413)
        assert len(blob) == 6
        assert unpack_compact_peers(blob) == [("10.1.2.3", 51413)]
        assert unpack_compact_peers(blob + b"\x01") == [("10.1.2.3", 51413)]  # junk tail

    def test_node_roundtrip(self):
        blob = pack_compact_node(nid(7), "127.0.0.1", 8080)
        assert len(blob) == 26
        assert unpack_compact_nodes(blob) == [(nid(7), "127.0.0.1", 8080)]


class TestRoutingTable:
    def test_update_and_closest(self):
        t = RoutingTable(nid(0))
        for i in range(1, 30):
            t.update(nid(i), "127.0.0.1", 1000 + i)
        close = t.closest(nid(3), count=3)
        assert close[0].node_id == nid(3)
        assert all(
            xor_distance(a.node_id, nid(3)) <= xor_distance(b.node_id, nid(3))
            for a, b in zip(close, close[1:])
        )

    def test_bucket_cap_and_dead_replacement(self):
        own = nid(0)
        t = RoutingTable(own)
        # ids sharing the same top-bit distance land in one bucket
        base = 1 << 100
        for i in range(8):
            t.update(nid(base + i), "127.0.0.1", 2000 + i)
        bucket = t._bucket_of(nid(base))
        assert len(bucket) == 8
        t.update(nid(base + 99), "127.0.0.1", 3000)  # full, all good -> dropped
        assert all(n.node_id != nid(base + 99) for n in bucket)
        for _ in range(3):
            t.note_failure(nid(base + 2))  # kill one
        t.update(nid(base + 99), "127.0.0.1", 3000)
        assert any(n.node_id == nid(base + 99) for n in bucket)
        assert all(n.node_id != nid(base + 2) for n in bucket)

    def test_ignores_self_and_garbage(self):
        t = RoutingTable(nid(5))
        t.update(nid(5), "127.0.0.1", 1)
        t.update(b"short", "127.0.0.1", 1)
        assert len(t) == 0


class TestTokenJar:
    def test_issue_validate_and_ip_binding(self):
        jar = TokenJar()
        tok = jar.issue("1.2.3.4")
        assert jar.valid("1.2.3.4", tok)
        assert not jar.valid("4.3.2.1", tok)
        assert not jar.valid("1.2.3.4", b"bogus!")

    def test_rotation_keeps_previous(self, monkeypatch):
        jar = TokenJar()
        tok = jar.issue("9.9.9.9")
        jar._rotated -= 1000  # force a rotation on next touch
        assert jar.valid("9.9.9.9", tok)  # previous secret still honored
        tok2 = jar.issue("9.9.9.9")
        assert tok2 != tok


class TestKRPC:
    def test_ping_updates_tables(self):
        async def go():
            a = await DHTNode(host="127.0.0.1").start()
            b = await DHTNode(host="127.0.0.1").start()
            try:
                rid = await a.ping(("127.0.0.1", b.port))
                assert rid == b.node_id
                assert len(a.table) == 1  # learned b from the response
                assert len(b.table) == 1  # learned a from the query
            finally:
                a.close()
                b.close()

        run(go())

    def test_find_node_returns_closest(self):
        async def go():
            a = await DHTNode(host="127.0.0.1").start()
            b = await DHTNode(host="127.0.0.1").start()
            try:
                for i in range(1, 12):
                    b.table.update(nid(i), "127.0.0.1", 4000 + i)
                nodes = await a.find_node(("127.0.0.1", b.port), nid(6))
                ids = [n[0] for n in nodes]
                assert nid(6) in ids and len(nodes) <= 8
            finally:
                a.close()
                b.close()

        run(go())

    def test_announce_requires_valid_token(self):
        async def go():
            a = await DHTNode(host="127.0.0.1").start()
            b = await DHTNode(host="127.0.0.1").start()
            ih = nid(0xBEEF)
            try:
                with pytest.raises(DHTError, match="bad token"):
                    await a.announce_peer(("127.0.0.1", b.port), ih, 6881, b"forged")
                peers, _, token = await a.get_peers(("127.0.0.1", b.port), ih)
                assert peers == [] and token is not None
                await a.announce_peer(("127.0.0.1", b.port), ih, 6881, token)
                peers2, _, _ = await a.get_peers(("127.0.0.1", b.port), ih)
                assert peers2 == [("127.0.0.1", 6881)]
            finally:
                a.close()
                b.close()

        run(go())

    def test_malformed_queries_survive(self):
        async def go():
            b = await DHTNode(host="127.0.0.1").start()
            a = await DHTNode(host="127.0.0.1").start()
            try:
                # garbage datagrams must not kill the endpoint
                a._transport.sendto(b"\xff\xfe not bencode", ("127.0.0.1", b.port))
                a._transport.sendto(b"d1:t2:xx1:y1:qe", ("127.0.0.1", b.port))
                await asyncio.sleep(0.05)
                assert await a.ping(("127.0.0.1", b.port)) == b.node_id
                with pytest.raises(DHTError):
                    await a._query(("127.0.0.1", b.port), "get_peers", {b"info_hash": b"short"})
            finally:
                a.close()
                b.close()

        run(go())


class TestNetworkLookups:
    async def _make_network(self, n):
        nodes = [await DHTNode(host="127.0.0.1").start() for _ in range(n)]
        # bootstrap everyone off node 0, mesh-walk to fill tables
        seed = ("127.0.0.1", nodes[0].port)
        for node in nodes[1:]:
            await node.bootstrap([seed])
        for node in nodes:
            await node.lookup_nodes(node.node_id)
        return nodes

    def test_announce_then_discover(self):
        async def go():
            nodes = await self._make_network(12)
            try:
                ih = nid(0xCAFE)
                announcer, seeker = nodes[3], nodes[9]
                accepted = await announcer.announce(ih, 7777)
                assert accepted > 0
                peers = await seeker.lookup_peers(ih)
                assert ("127.0.0.1", 7777) in peers
            finally:
                for n in nodes:
                    n.close()

        run(go())

    def test_trackerless_magnet_download_via_dht(self):
        """The full BEP 5 + BEP 9/10 story: a magnet with ONLY an info
        hash — no trackers, no x.pe — resolved and downloaded through the
        DHT: seeder announces, leecher discovers it, fetches the info
        dict over ut_metadata, then transfers and verifies."""
        import hashlib

        import numpy as np

        from tests.test_torch_session import build_torrent_bytes, fast_config
        from torrent_tpu_torch.codec.magnet import Magnet
        from torrent_tpu_torch.codec.metainfo import parse_metainfo
        from torrent_tpu_torch.session.client import Client, ClientConfig
        from torrent_tpu_torch.session.metadata import MetadataError
        from torrent_tpu_torch.session.torrent import TorrentState
        from torrent_tpu_torch.storage.storage import MemoryStorage, Storage

        async def go():
            boot = await DHTNode(host="127.0.0.1").start()
            rng = np.random.default_rng(31)
            payload = rng.integers(0, 256, size=120_000, dtype=np.uint8).tobytes()
            torrent_bytes = build_torrent_bytes(
                payload, 32768, b"http://127.0.0.1:1/announce", name=b"dht-e2e"
            )
            m = parse_metainfo(torrent_bytes)
            cfg = lambda: ClientConfig(
                host="127.0.0.1",
                enable_dht=True,
                dht_bootstrap=(("127.0.0.1", boot.port),), hasher="cpu",
            )
            seed, leech = Client(cfg()), Client(cfg())
            seed.config.torrent = fast_config(dht_interval=0.5)
            leech.config.torrent = fast_config(dht_interval=0.5)
            await seed.start()
            await leech.start()
            try:
                ss = Storage(MemoryStorage(), m.info)
                for off in range(0, len(payload), 65536):
                    ss.set(off, payload[off : off + 65536])
                t_seed = await seed.add(m, ss)
                assert t_seed.state == TorrentState.SEEDING

                magnet = Magnet(info_hash=m.info_hash)  # hash only!
                t_leech = None
                for _ in range(40):  # seeder's DHT announce is async
                    try:
                        t_leech = await leech.add_magnet(
                            magnet, Storage(MemoryStorage(), m.info)
                        )
                        break
                    except MetadataError:
                        await asyncio.sleep(0.25)
                assert t_leech is not None, "DHT discovery never found the seeder"
                assert t_leech.info.name == "dht-e2e"
                await asyncio.wait_for(t_leech.on_complete.wait(), timeout=30)
                got = t_leech.storage.get(0, len(payload))
                assert hashlib.sha1(got).digest() == hashlib.sha1(payload).digest()
            finally:
                await seed.close()
                await leech.close()
                boot.close()

        run(go())

    def test_lookup_converges_without_values(self):
        async def go():
            nodes = await self._make_network(8)
            try:
                peers = await nodes[1].lookup_peers(nid(0xD00D))
                assert peers == []  # nobody announced; converges, no error
                closest = await nodes[2].lookup_nodes(nid(0xD00D))
                assert closest  # found someone to talk to
            finally:
                for n in nodes:
                    n.close()

        run(go())


class TestHostileInputHardening:
    """Round-1 advisor findings: port-0 padding + response spoofing."""

    def test_port_zero_peers_filtered(self):
        # hostile nodes pad `values` with undialable port-0 entries; the
        # PEX decoder already drops these — the DHT decoder must too
        blob = pack_compact_peer("10.1.2.3", 51413) + pack_compact_peer("9.9.9.9", 0)
        assert unpack_compact_peers(blob) == [("10.1.2.3", 51413)]

    def test_response_from_wrong_address_ignored(self):
        """A 16-bit tid is guessable; only the queried address may answer."""
        from torrent_tpu_torch.codec.bencode import bencode

        async def go():
            node = DHTNode(host="127.0.0.1", port=0)
            loop = asyncio.get_running_loop()
            fut = loop.create_future()
            tid = b"\x00\x07"
            node._pending[tid] = (("10.0.0.1", 7001), fut)
            resp = bencode(
                {b"t": tid, b"y": b"r", b"r": {b"id": nid(0xBEEF)}}
            )
            # spoofed source IP: dropped, future still pending
            node._on_datagram(resp, ("6.6.6.6", 7001))
            assert not fut.done()
            # genuine source resolves it (IP-only match: port-rewriting
            # NATs legitimately answer from a different source port)
            node._on_datagram(resp, ("10.0.0.1", 9999))
            assert fut.done() and fut.result() == {b"id": nid(0xBEEF)}
            # spoofed error replies are dropped the same way
            fut2 = loop.create_future()
            node._pending[b"\x00\x08"] = (("10.0.0.1", 7001), fut2)
            err = bencode({b"t": b"\x00\x08", b"y": b"e", b"e": [201, b"boom"]})
            node._on_datagram(err, ("6.6.6.6", 7001))
            assert not fut2.done()
            node._on_datagram(err, ("10.0.0.1", 7001))
            assert fut2.done() and isinstance(fut2.exception(), DHTError)

        run(go())

    def test_announce_flood_of_fresh_hashes_churns_store(self, monkeypatch):
        """wire-taint/bounded-state hardening: token-valid announces for
        ever-fresh info-hashes must churn peer_store at the hash-count
        cap, not grow it for a full TTL window."""
        from torrent_tpu_torch.net import dht as dht_mod

        monkeypatch.setattr(dht_mod, "MAX_STORED_HASHES", 3)

        async def go():
            a = await DHTNode(host="127.0.0.1").start()
            b = await DHTNode(host="127.0.0.1").start()
            try:
                hashes = [nid(0x1000 + i) for i in range(5)]
                _, _, token = await a.get_peers(("127.0.0.1", b.port), hashes[0])
                for ih in hashes:
                    await a.announce_peer(("127.0.0.1", b.port), ih, 6881, token)
                assert len(b.peer_store) == 3
                # newest survive, oldest evicted in insertion order
                assert hashes[-1] in b.peer_store
                assert hashes[0] not in b.peer_store
                # seed marks never orphan a hash the store dropped
                assert set(b.seed_marks) <= set(b.peer_store)
            finally:
                a.close()
                b.close()

        run(go())


class TestBep42:
    """BEP 42 DHT security: node ids derived from external IPs."""

    def test_generated_id_validates(self):
        from torrent_tpu_torch.net.dht import bep42_node_id, bep42_valid

        for ip in ("93.184.216.34", "8.8.8.8", "2001:4860:4860::8888"):
            nid = bep42_node_id(ip)
            assert bep42_valid(nid, ip), (ip, nid.hex())
            # and fails against a different global IP (w.h.p.)
            assert not bep42_valid(nid, "144.52.10.9")

    def test_private_ips_exempt(self):
        from torrent_tpu_torch.net.dht import bep42_valid, random_node_id

        for ip in ("127.0.0.1", "10.1.2.3", "192.168.0.9", "::1", "fe80::1"):
            assert bep42_valid(random_node_id(), ip)

    def test_known_vector(self):
        """BEP 42's published example: IP 124.31.75.21, r=1 -> id begins
        5fbfbf (first 21 bits)."""
        from torrent_tpu_torch.net.dht import bep42_prefix

        want = bep42_prefix("124.31.75.21", 1)
        assert want is not None
        assert want[0] == 0x5F and want[1] == 0xBF
        assert want[2] & 0xF8 == 0xBF & 0xF8

    def test_enforcing_node_rejects_bad_ids(self):
        import asyncio

        from torrent_tpu_torch.net.dht import DHTNode, bep42_node_id

        async def go():
            n = DHTNode(enforce_bep42=True)
            # a non-compliant id from a global IP is kept out of the table
            n._table_update(b"\x00" * 20, "93.184.216.34", 6881)
            assert len(n.table) == 0
            # a compliant one gets in
            good = bep42_node_id("93.184.216.34")
            n._table_update(good, "93.184.216.34", 6881)
            assert len(n.table) == 1
            # private addresses are exempt either way
            n._table_update(b"\x11" * 20, "10.0.0.5", 6881)
            assert len(n.table) == 2

        asyncio.run(go())

    def test_external_ip_mints_compliant_own_id(self):
        from torrent_tpu_torch.net.dht import DHTNode, bep42_valid

        n = DHTNode(external_ip="93.184.216.34")
        assert bep42_valid(n.node_id, "93.184.216.34")


class TestBep32Ipv6:
    """BEP 32: want/nodes6, v6 values, a live ::1 DHT network."""

    def test_node6_codec_roundtrip(self):
        from torrent_tpu_torch.net.dht import pack_compact_node6, unpack_compact_nodes6

        nid = bytes(range(20))
        blob = pack_compact_node6(nid, "2001:db8::7", 6881)
        assert len(blob) == 38
        assert unpack_compact_nodes6(blob + b"xx") == [(nid, "2001:db8::7", 6881)]

    def test_want_routes_families(self):
        import asyncio

        from torrent_tpu_torch.net.dht import DHTNode

        async def go():
            n = DHTNode()
            n.table.update(b"\x01" * 20, "1.2.3.4", 6881)
            n.table.update(b"\x02" * 20, "2001:db8::2", 6882)
            t = b"\x03" * 20
            both = n._closest_reply(t, ("9.9.9.9", 1), [b"n4", b"n6"])
            assert len(both[b"nodes"]) == 26 and len(both[b"nodes6"]) == 38
            # absent want: reply in the querier's own family
            v4 = n._closest_reply(t, ("9.9.9.9", 1), None)
            assert b"nodes" in v4 and b"nodes6" not in v4
            v6 = n._closest_reply(t, ("2001:db8::9", 1), None)
            assert b"nodes6" in v6 and b"nodes" not in v6

        asyncio.run(go())

    def test_v6_network_announce_and_lookup(self):
        """Three ::1 nodes: bootstrap, announce, lookup — the whole BEP 5
        cycle over IPv6 transport with nodes6 discovery."""
        import asyncio
        import socket

        import pytest as _pytest

        from torrent_tpu_torch.net.dht import DHTNode

        if not socket.has_ipv6:
            _pytest.skip("no IPv6")

        async def go():
            try:
                a = await DHTNode(host="::1").start()
            except OSError:
                _pytest.skip("IPv6 loopback unavailable")
            b = await DHTNode(host="::1").start()
            c = await DHTNode(host="::1").start()
            try:
                await b.bootstrap([("::1", a.port)])
                await c.bootstrap([("::1", a.port)])
                ih = b"\x66" * 20
                n = await c.announce(ih, 7777)
                assert n >= 1
                peers = await b.lookup_peers(ih)
                assert ("::1", 7777) in peers, peers
            finally:
                a.close()
                b.close()
                c.close()

        asyncio.run(asyncio.wait_for(go(), 30))

    def test_unknown_want_falls_back_to_querier_family(self):
        import asyncio

        from torrent_tpu_torch.net.dht import DHTNode

        async def go():
            n = DHTNode()
            n.table.update(b"\x01" * 20, "1.2.3.4", 6881)
            t = b"\x03" * 20
            r = n._closest_reply(t, ("9.9.9.9", 1), [b"n8"])  # future token
            assert b"nodes" in r and len(r[b"nodes"]) == 26
            r2 = n._closest_reply(t, ("9.9.9.9", 1), [])
            assert b"nodes" in r2

        asyncio.run(go())

    def test_per_family_closest_not_starved_by_v4(self):
        """A v6 querier must get the closest v6 nodes even when the K*2
        globally-closest entries are all v4."""
        import asyncio

        from torrent_tpu_torch.net.dht import DHTNode

        async def go():
            # pinned own id: tiny ids spread over low buckets instead of
            # all colliding in one random-MSB bucket and evicting the v6
            n = DHTNode(node_id=(2).to_bytes(20, "big"))
            t = b"\x00" * 20
            for i in range(3, 27):  # 24 v4 nodes very close to target
                n.table.update(i.to_bytes(20, "big"), "1.2.3.%d" % i, 6000 + i)
            far = (1 << 140).to_bytes(20, "big")  # one distant v6 node
            n.table.update(far, "2001:db8::1", 7000)
            r = n._closest_reply(t, ("2001:db8::9", 1), [b"n6"])
            assert len(r[b"nodes6"]) == 38  # found despite v4 dominance

        asyncio.run(go())

    def test_values_are_family_sized_and_never_empty(self):
        """get_peers values pack per family (6/18 B); unpackable scoped
        link-local entries are skipped, not shipped as empty strings —
        exercised over a real socket round-trip."""
        import asyncio
        import time as _time

        from torrent_tpu_torch.net.dht import DHTNode

        async def go():
            b = await DHTNode(host="127.0.0.1").start()
            a = await DHTNode(host="127.0.0.1").start()
            try:
                ih = b"\x44" * 20
                now = _time.monotonic()
                b.peer_store[ih] = {
                    ("1.2.3.4", 6881): now,  # v4 -> 6 bytes
                    ("2001:db8::5", 6882): now,  # v6 -> 18 bytes
                    ("fe80::1%eth0", 6883): now,  # unpackable: skipped
                }
                peers, _, _ = await a.get_peers(("127.0.0.1", b.port), ih)
                assert ("1.2.3.4", 6881) in peers
                assert ("2001:db8::5", 6882) in peers
                assert all(p[1] != 6883 for p in peers)
            finally:
                a.close()
                b.close()

        asyncio.run(asyncio.wait_for(go(), 20))

    def test_dual_stack_socket_dials_plain_v4(self):
        """A '::'-bound node must reach plain-v4 table entries via the
        ::ffff: mapping in _sendto (a raw v4 string on an AF_INET6
        socket gaierrors into a silent RPC-timeout stall)."""
        import asyncio
        import socket as _socket

        import pytest as _pytest

        from torrent_tpu_torch.net.dht import DHTNode

        if not _socket.has_ipv6:
            _pytest.skip("no IPv6")

        async def go():
            v4 = await DHTNode(host="127.0.0.1").start()
            try:
                dual = await DHTNode(host="::").start()
            except OSError:
                _pytest.skip("dual-stack bind unavailable")
            try:
                # table stores the canonical dotted quad; ping must map it
                rid = await dual.ping(("127.0.0.1", v4.port))
                assert rid == v4.node_id
            finally:
                dual.close()
                v4.close()

        asyncio.run(asyncio.wait_for(go(), 20))


class TestMaintenance:
    def test_maintain_once_pings_stale_and_sweeps_store(self):
        import time as _time

        async def go():
            a = await DHTNode(host="127.0.0.1").start()
            b = await DHTNode(host="127.0.0.1").start()
            try:
                await a.ping(("127.0.0.1", b.port))
                # age b's entry past the stale threshold
                entry = next(n for bucket in a.table.buckets for n in bucket)
                entry.last_seen -= 11 * 60
                # an expired peer-store entry to sweep
                ih = b"\x77" * 20
                a.peer_store[ih] = {("1.2.3.4", 1): _time.monotonic() - 10**6}
                pinged = await a.maintain_once()
                assert pinged == 1
                assert entry.last_seen > _time.monotonic() - 5  # refreshed
                assert ih not in a.peer_store  # swept
            finally:
                a.close()
                b.close()

        run(go())

    def test_maintain_once_marks_dead_nodes(self):
        async def go():
            a = await DHTNode(host="127.0.0.1").start()
            b = await DHTNode(host="127.0.0.1").start()
            try:
                await a.ping(("127.0.0.1", b.port))
                entry = next(n for bucket in a.table.buckets for n in bucket)
                entry.last_seen -= 11 * 60
                b.close()  # now unreachable
                import torrent_tpu_torch.net.dht as D

                old = D.RPC_TIMEOUT
                D.RPC_TIMEOUT = 0.3
                try:
                    await a.maintain_once()
                finally:
                    D.RPC_TIMEOUT = old
                assert entry.failed >= 1  # timeout recorded
            finally:
                a.close()

        run(go())


class TestBep43ReadOnly:
    """BEP 43: read-only nodes stay out of routing tables and answer
    no queries."""

    def test_ro_querier_not_tabled_but_served(self):
        async def go():
            ro = await DHTNode(host="127.0.0.1", read_only=True).start()
            srv = await DHTNode(host="127.0.0.1").start()
            try:
                rid = await ro.ping(("127.0.0.1", srv.port))
                assert rid == srv.node_id  # query IS answered...
                assert len(srv.table) == 0  # ...but the sender not tabled
                assert len(ro.table) == 1  # ro still learns from responses
            finally:
                ro.close()
                srv.close()

        run(go())

    def test_read_only_node_answers_nothing(self):
        async def go():
            ro = await DHTNode(host="127.0.0.1", read_only=True).start()
            other = await DHTNode(host="127.0.0.1").start()
            try:
                from torrent_tpu_torch.net.dht import DHTError

                with pytest.raises(DHTError):
                    await other.ping(("127.0.0.1", ro.port))
            finally:
                ro.close()
                other.close()

        run(go())
