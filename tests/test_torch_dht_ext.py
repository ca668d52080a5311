"""BEP 33 (DHT scrape) + BEP 51 (infohash sampling) extensions.

Bloom math is checked against its statistical contract; both protocols
are driven node-to-node and over converged loopback networks, including
the session-side seed flag on completion.
"""

import asyncio

import pytest

from torrent_tpu_torch.net.dht import (
    DHTNode,
    SAMPLE_MAX,
    ScrapeBloom,
)


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def nid(i: int) -> bytes:
    return i.to_bytes(20, "big")


class TestScrapeBloom:
    def test_estimate_tracks_inserted_count(self):
        bf = ScrapeBloom()
        assert bf.estimate() == 0
        for i in range(256):
            bf.insert_ip(f"192.0.{i // 256}.{i % 256}")
        # BEP 33's own tolerance example: estimates land within ~6%
        assert 230 <= bf.estimate() <= 290
        # inserting the same addresses again must not move the estimate
        before = bf.estimate()
        for i in range(256):
            bf.insert_ip(f"192.0.{i // 256}.{i % 256}")
        assert bf.estimate() == before

    def test_union_deduplicates(self):
        a, b = ScrapeBloom(), ScrapeBloom()
        for i in range(100):
            a.insert_ip(f"10.0.0.{i}")
        for i in range(50, 150):
            b.insert_ip(f"10.0.0.{i % 256}" if i < 256 else "10.0.1.1")
        a.union(b)
        est = a.estimate()
        assert 130 <= est <= 175  # 150 distinct, not 200

    def test_v6_uses_first_8_bytes(self):
        a, b = ScrapeBloom(), ScrapeBloom()
        a.insert_ip("2001:db8::1")
        b.insert_ip("2001:db8::2")  # same /64 → same bloom entry
        assert bytes(a) == bytes(b)

    def test_wire_shape(self):
        assert len(bytes(ScrapeBloom())) == 256
        with pytest.raises(ValueError):
            ScrapeBloom(b"\x00" * 10)


class TestBep33Scrape:
    def test_scrape_reply_splits_seeds_from_downloaders(self):
        async def go():
            a = await DHTNode(host="127.0.0.1").start()
            b = await DHTNode(host="127.0.0.1").start()
            try:
                ih = nid(0x33)
                await a.ping(("127.0.0.1", b.port))
                # seed announce from a, leech announce simulated directly
                _, _, token = await a.get_peers(("127.0.0.1", b.port), ih)
                await a.announce_peer(("127.0.0.1", b.port), ih, 7000, token, seed=True)
                import time as _t

                b.peer_store[ih][("10.9.9.9", 7001)] = _t.monotonic()
                sd, pe = await a.scrape_rpc(("127.0.0.1", b.port), ih)
                assert sd is not None and pe is not None
                assert 0.5 <= sd.estimate() <= 1.5  # one seed (127.0.0.1)
                assert 0.5 <= pe.estimate() <= 1.5  # one leech (10.9.9.9)
                # a re-announce without the flag demotes the seed
                _, _, token = await a.get_peers(("127.0.0.1", b.port), ih)
                await a.announce_peer(("127.0.0.1", b.port), ih, 7000, token, seed=False)
                sd2, pe2 = await a.scrape_rpc(("127.0.0.1", b.port), ih)
                assert sd2.estimate() == 0
                assert 1.5 <= pe2.estimate() <= 2.6
            finally:
                a.close()
                b.close()

        run(go())

    def test_swarm_scrape_over_network(self):
        async def go():
            nodes = [await DHTNode(host="127.0.0.1").start() for _ in range(8)]
            seed_addr = ("127.0.0.1", nodes[0].port)
            for n in nodes[1:]:
                await n.bootstrap([seed_addr])
            for n in nodes:
                await n.lookup_nodes(n.node_id)
            try:
                ih = nid(0xBEEF)
                await nodes[2].announce(ih, 7777, seed=True)
                await nodes[3].announce(ih, 7778, seed=False)
                seeds, downs = await nodes[6].scrape_swarm(ih)
                # every announcer is 127.0.0.1, so the blooms see ONE
                # distinct address per category
                assert 0.5 <= seeds <= 1.5
                assert 0.5 <= downs <= 1.5
            finally:
                for n in nodes:
                    n.close()

        run(go())


class TestBep51Sampling:
    def test_sample_reply(self):
        async def go():
            a = await DHTNode(host="127.0.0.1").start()
            b = await DHTNode(host="127.0.0.1").start()
            try:
                import time as _t

                for i in range(10):
                    b.peer_store[nid(i + 1)] = {("1.2.3.4", 1000 + i): _t.monotonic()}
                await a.ping(("127.0.0.1", b.port))
                samples, num, interval, nodes = await a.sample_infohashes(
                    ("127.0.0.1", b.port), nid(0)
                )
                assert num == 10 and len(samples) == 10
                assert set(samples) == {nid(i + 1) for i in range(10)}
                assert interval > 0
                assert all(len(s) == 20 for s in samples)
            finally:
                a.close()
                b.close()

        run(go())

    def test_sample_caps_at_datagram_budget(self):
        async def go():
            a = await DHTNode(host="127.0.0.1").start()
            b = await DHTNode(host="127.0.0.1").start()
            try:
                import time as _t

                for i in range(SAMPLE_MAX + 40):
                    b.peer_store[nid(i + 1)] = {("1.2.3.4", 1): _t.monotonic()}
                await a.ping(("127.0.0.1", b.port))
                samples, num, _, _ = await a.sample_infohashes(
                    ("127.0.0.1", b.port), nid(0)
                )
                assert num == SAMPLE_MAX + 40
                assert len(samples) == SAMPLE_MAX
                assert len(set(samples)) == SAMPLE_MAX  # no repeats
            finally:
                a.close()
                b.close()

        run(go())

    def test_seeding_session_announces_seed_flag(self):
        """A completed torrent's DHT announce must carry seed=1 end to
        end into the remote node's seed marks."""
        import numpy as np

        from tests.test_torch_session import build_torrent_bytes, fast_config
        from torrent_tpu_torch.codec.metainfo import parse_metainfo
        from torrent_tpu_torch.session.client import Client, ClientConfig
        from torrent_tpu_torch.session.torrent import TorrentState
        from torrent_tpu_torch.storage.storage import MemoryStorage, Storage

        async def go():
            boot = await DHTNode(host="127.0.0.1").start()
            payload = (
                np.random.default_rng(51)
                .integers(0, 256, size=65536, dtype=np.uint8)
                .tobytes()
            )
            m = parse_metainfo(
                build_torrent_bytes(payload, 32768, b"http://127.0.0.1:1/a")
            )
            c = Client(
                ClientConfig(
                    host="127.0.0.1",
                    enable_dht=True,
                    dht_bootstrap=(("127.0.0.1", boot.port),), hasher="cpu",
                )
            )
            c.config.torrent = fast_config(dht_interval=0.3)
            await c.start()
            try:
                ss = Storage(MemoryStorage(), m.info)
                ss.set(0, payload)
                t = await c.add(m, ss)
                assert t.state == TorrentState.SEEDING
                for _ in range(40):
                    marks = boot.seed_marks.get(m.info_hash, set())
                    if marks:
                        break
                    await asyncio.sleep(0.25)
                assert marks, "seed flag never reached the DHT store"
            finally:
                await c.close()
                boot.close()

        run(go())
