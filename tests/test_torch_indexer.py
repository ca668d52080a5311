"""The port's DHT indexer (net/indexer.py) — passive harvest, bounded
crawl, and the persistent-tracker story end to end: the reference's
cases with the port's imports.

The flagship scenario: a magnet-only client joins THROUGH the sharded
tracker whose only knowledge of the swarm came from the DHT indexer —
no ``.torrent`` file exists anywhere — then the downloaded data is
rechecked through the hash-plane scheduler. Here the leech verifies
with the ``"gpu"`` hasher on ``device="cpu"`` (the plain PyTorch
SHA-1), and the scheduler's recheck runs the same plane.
"""

import asyncio
import hashlib

import numpy as np

from torrent_tpu_torch.net.dht import DHTNode
from torrent_tpu_torch.net.indexer import DhtIndexer
from torrent_tpu_torch.server.shard import ShardedSwarmStore


def run(coro, timeout=90):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def ih(i: int) -> bytes:
    return hashlib.sha1(b"indexer-swarm-%d" % i).digest()


class TestPassiveHarvest:
    def test_announce_peer_feeds_store_get_peers_censuses(self):
        async def go():
            b = await DHTNode(host="127.0.0.1").start()
            store = ShardedSwarmStore(n_shards=4)
            idx = DhtIndexer(b, store)
            a = await DHTNode(host="127.0.0.1").start()
            a.table.update(b.node_id, "127.0.0.1", b.port)
            try:
                accepted = await a.announce(ih(0), 6881, seed=True)
                assert accepted >= 1
                snap = idx.snapshot()
                # the announce walk's get_peers is a census hit, the
                # validated announce_peer is a live tracker seed
                assert snap["harvested"]["get_peers"] >= 1
                assert snap["harvested"]["announce_peer"] == 1
                assert snap["fed_peers"] == 1 and snap["hashes"] == 1
                # seeded as a SEEDER (BEP 33 seed flag honored)
                assert store.scrape([ih(0)]) == [(ih(0), 1, 0, 0)]
                # a plain lookup (no announce) still censuses the hash
                await a.lookup_peers(ih(1))
                assert idx.snapshot()["hashes"] == 2
                assert store.scrape([ih(1)]) == [(ih(1), 0, 0, 0)]
            finally:
                a.close()
                b.close()

        run(go())

    def test_hash_census_is_bounded_fifo(self):
        node = DHTNode.__new__(DHTNode)  # observer seam only, no socket
        node._observers = []
        node.add_observer = lambda cb: node._observers.append(cb)
        idx = DhtIndexer.__new__(DhtIndexer)
        idx.node = node
        idx.store = None
        idx.max_hashes = 4
        idx._hashes = {}
        idx._blooms = {}
        idx._clock = lambda: 0.0
        idx.harvested = {"get_peers": 0, "announce_peer": 0}
        idx.fed_peers = 0
        for i in range(10):
            idx._note(ih(i))
        assert idx.known_hashes == 4
        assert idx.hashes() == [ih(i) for i in (6, 7, 8, 9)]  # FIFO evicted

    def test_broken_observer_never_drops_queries(self):
        async def go():
            b = await DHTNode(host="127.0.0.1").start()
            b.add_observer(lambda *a: (_ for _ in ()).throw(RuntimeError()))
            a = await DHTNode(host="127.0.0.1").start()
            a.table.update(b.node_id, "127.0.0.1", b.port)
            try:
                # the query still answers despite the raising observer
                peers, nodes, token = await a.get_peers(b.addr, ih(2))
                assert token is not None
            finally:
                a.close()
                b.close()

        run(go())


class TestActiveCrawl:
    def test_crawl_harvests_remote_stores(self):
        """A crawler that never saw any announce traffic discovers the
        swarm via BEP 51 samples and feeds its peers into the store."""

        async def go():
            carrier = await DHTNode(host="127.0.0.1").start()
            announcer = await DHTNode(host="127.0.0.1").start()
            announcer.table.update(carrier.node_id, "127.0.0.1", carrier.port)
            crawler = await DHTNode(host="127.0.0.1").start()
            crawler.table.update(carrier.node_id, "127.0.0.1", carrier.port)
            store = ShardedSwarmStore(n_shards=4)
            idx = DhtIndexer(crawler, store)
            try:
                await announcer.announce(ih(3), 6900)
                res = await idx.crawl_once()
                assert res["queried"] >= 1 and res["sampled"] >= 1
                assert res["fed_peers"] >= 1
                snap = idx.snapshot()
                assert snap["crawls"] == 1 and snap["crawl_lookups"] >= 1
                h, c, d, inc = store.scrape([ih(3)])[0]
                assert c + inc >= 1  # the announcer's peer landed
            finally:
                carrier.close()
                announcer.close()
                crawler.close()

        run(go())

    def test_lookup_budget_overflow_resolves_on_later_crawls(self):
        """Review fix: hashes sampled beyond one crawl's lookup budget
        join the resolve backlog and are drained OLDEST-first by later
        crawls — never permanently starved by the freshness filter."""

        async def go():
            carrier = await DHTNode(host="127.0.0.1").start()
            announcer = await DHTNode(host="127.0.0.1").start()
            announcer.table.update(carrier.node_id, "127.0.0.1", carrier.port)
            crawler = await DHTNode(host="127.0.0.1").start()
            crawler.table.update(carrier.node_id, "127.0.0.1", carrier.port)
            store = ShardedSwarmStore(n_shards=4)
            idx = DhtIndexer(crawler, store)
            try:
                for i in range(3):
                    await announcer.announce(ih(20 + i), 6900 + i)
                # budget 1: the first crawl samples several hashes but
                # resolves only one; the rest wait in the backlog
                res1 = await idx.crawl_once(max_lookups=1)
                assert res1["resolved"] == 1
                backlog = idx.snapshot()["unresolved"]
                assert backlog >= 1
                # later crawls drain the backlog even when the samples
                # are no longer fresh
                for _ in range(4):
                    await idx.crawl_once(max_lookups=2)
                    if idx.snapshot()["unresolved"] == 0:
                        break
                assert idx.snapshot()["unresolved"] == 0
                resolved_swarms = sum(
                    1 for _, c, _, inc in store.scrape([ih(20 + i) for i in range(3)])
                    if c + inc >= 1
                )
                assert resolved_swarms == 3, store.scrape(
                    [ih(20 + i) for i in range(3)]
                )
            finally:
                carrier.close()
                announcer.close()
                crawler.close()

        run(go())

    def test_failed_lookup_returns_to_backlog(self):
        """Review fix: a transient DHTError during resolution re-defers
        the hash to the backlog's end — never permanently dropped behind
        the freshness filter."""
        from torrent_tpu_torch.net.dht import DHTError

        async def go():
            crawler = await DHTNode(host="127.0.0.1").start()
            idx = DhtIndexer(crawler)
            try:
                idx._note(ih(40))
                idx._defer_resolve(ih(40))

                async def boom(info_hash):
                    raise DHTError("transient")

                crawler.lookup_peers = boom
                res = await idx.crawl_once(max_nodes=0, max_lookups=2)
                assert res["resolved"] == 0
                assert list(idx._unresolved) == [ih(40)]  # re-deferred
            finally:
                crawler.close()

        run(go())

    def test_crawl_bounded_by_budget(self):
        async def go():
            crawler = await DHTNode(host="127.0.0.1").start()
            nodes = []
            for _ in range(6):
                n = await DHTNode(host="127.0.0.1").start()
                nodes.append(n)
                crawler.table.update(n.node_id, "127.0.0.1", n.port)
            idx = DhtIndexer(crawler)
            try:
                res = await idx.crawl_once(max_nodes=2, max_lookups=0)
                assert res["queried"] <= 2
                assert idx.snapshot()["crawl_lookups"] == 0
            finally:
                crawler.close()
                for n in nodes:
                    n.close()

        run(go())


class TestPersistentTrackerE2E:
    def test_magnet_via_indexer_tracker_to_sched_recheck(self):
        """Magnet → DHT indexer peer discovery →
        metadata exchange → scheduler recheck, all in-process, with NO
        ``.torrent`` file. The seed is fully trackerless (DHT only);
        the tracker's swarm knowledge comes exclusively from the
        indexer's harvest; the leech knows only the magnet (infohash +
        tracker URL) and rechecks its download through the hash-plane
        scheduler."""
        from tests.test_torch_session import build_torrent_bytes, fast_config
        from torrent_tpu_torch.codec.magnet import Magnet
        from torrent_tpu_torch.codec.metainfo import parse_metainfo
        from torrent_tpu_torch.parallel.bulk import verify_library_sched
        from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig
        from torrent_tpu_torch.server.shard import run_sharded_tracker
        from torrent_tpu_torch.server.tracker import ServeOptions
        from torrent_tpu_torch.session.client import Client, ClientConfig
        from torrent_tpu_torch.session.torrent import TorrentState
        from torrent_tpu_torch.storage.storage import MemoryStorage, Storage

        async def go():
            # the indexer node doubles as the DHT bootstrap; its harvest
            # feeds the sharded store the tracker serves from
            boot = await DHTNode(host="127.0.0.1").start()
            store = ShardedSwarmStore(n_shards=4)
            idx = DhtIndexer(boot, store)
            opts = ServeOptions(http_port=0, udp_port=None, host="127.0.0.1",
                                interval=1)
            server, pump = await run_sharded_tracker(
                opts, store=store, indexer=idx
            )
            announce_url = f"http://127.0.0.1:{server.http_port}/announce"

            rng = np.random.default_rng(61)
            payload = rng.integers(0, 256, size=150_000, dtype=np.uint8).tobytes()
            # metainfo exists only in the seeder's memory — announce is
            # EMPTY, so the seed runs no tracker loop at all
            m = parse_metainfo(
                build_torrent_bytes(payload, 32768, b"", name=b"indexer-e2e")
            )
            seed = Client(ClientConfig(
                host="127.0.0.1", hasher="cpu", enable_dht=True,
                dht_bootstrap=(("127.0.0.1", boot.port),),
            ))
            leech = Client(ClientConfig(host="127.0.0.1", hasher="gpu", device="cpu"))
            seed.config.torrent = fast_config(dht_interval=0.3)
            leech.config.torrent = fast_config(verify_batch_size=4)
            await seed.start()
            await leech.start()
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=8, flush_deadline=0.02),
                hasher="gpu", device="cpu",
            )
            await sched.start()
            try:
                ss = Storage(MemoryStorage(), m.info)
                for off in range(0, len(payload), 65536):
                    ss.set(off, payload[off : off + 65536])
                t_seed = await seed.add(m, ss)
                assert t_seed.state == TorrentState.SEEDING
                names = {t.get_name() for t in t_seed._tasks}
                assert "announce" not in names  # truly trackerless

                # the seed's DHT announce reaches the indexer, which
                # seeds the tracker store — poll until the harvest lands
                for _ in range(80):
                    h, c, d, inc = store.scrape([m.info_hash])[0]
                    if c + inc >= 1:
                        break
                    await asyncio.sleep(0.25)
                else:
                    raise AssertionError(
                        f"indexer never seeded the swarm: {idx.snapshot()}"
                    )
                assert idx.snapshot()["fed_peers"] >= 1
                assert store.metrics_snapshot()["indexed"] >= 1

                # leech: magnet only (infohash + tracker URL) — discovery
                # flows magnet → tracker → indexer-harvested peer
                magnet = Magnet(
                    info_hash=m.info_hash, trackers=(announce_url,)
                )
                t_leech = await leech.add_magnet(
                    magnet, Storage(MemoryStorage(), m.info)
                )
                assert t_leech.info.name == "indexer-e2e"
                assert t_leech.verifier is not None  # the "gpu" ingest
                await asyncio.wait_for(t_leech.on_complete.wait(), timeout=30)

                # scheduler recheck: the downloaded storage re-verified
                # through the hash plane against the FETCHED metadata
                res = await verify_library_sched(
                    [(t_leech.storage, t_leech.metainfo.info)],
                    sched, tenant="recheck",
                )
                assert bool(res.bitfields[0].all()), res.bitfields[0]
                # the tracker really served the join: announce traffic
                # beyond the indexer's seeding shows in the store
                assert store.metrics_snapshot()["announces"] >= 1
            finally:
                await sched.close()
                await seed.close()
                await leech.close()
                server.close()
                await asyncio.wait_for(pump, 5)
                boot.close()

        run(go())
