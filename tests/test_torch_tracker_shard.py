"""Sharded announce plane (the port's server/shard.py).

The reference's cases with the port's imports: unit coverage of the
store (shard routing, O(numwant) reservoir sampling, swap-remove
consistency, server-side reply bounds, per-shard TTL sweeps, batch
processing), service-level coverage over the real HTTP/UDP transports
(the port's client against the port's sharded server) and the tracker
/metrics route. The CLI guard and the doctor smoke are in
tests/test_torch_cli.py and tests/test_torch_doctor.py, the bench rung's
cases in tests/test_torch_bench_cli.py.
"""

import asyncio
import hashlib
import time

import pytest

from torrent_tpu_torch.net.types import AnnounceEvent, AnnounceInfo
from torrent_tpu_torch.server.shard import (
    MAX_SCRAPE_HASHES,
    ShardedSwarmStore,
    ShardedTracker,
    run_sharded_tracker,
)
from torrent_tpu_torch.server.tracker import ServeOptions


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 30))


def ih(i: int) -> bytes:
    return hashlib.sha1(b"shard-test-swarm-%d" % i).digest()


def pid(i: int) -> bytes:
    return (b"P%03d" % i).ljust(20, b"p")


def fill(store, info_hash, n, seeders=0, base_port=7000):
    for i in range(n):
        store.announce(
            info_hash, pid(i), "10.0.0.%d" % (i % 250 + 1), base_port + i,
            left=0 if i < seeders else 1,
        )


class TestStoreUnit:
    def test_announce_lifecycle_and_promotion(self):
        s = ShardedSwarmStore(n_shards=4)
        out = s.announce(ih(0), pid(0), "1.1.1.1", 7001, left=100,
                         event=AnnounceEvent.STARTED)
        assert (out.complete, out.incomplete, out.peers) == (0, 1, [])
        # leecher → seeder promotion counts a completion
        out = s.announce(ih(0), pid(0), "1.1.1.1", 7001, left=0,
                         event=AnnounceEvent.COMPLETED)
        assert (out.complete, out.incomplete) == (1, 0)
        assert s.scrape([ih(0)]) == [(ih(0), 1, 1, 0)]
        # stopped removes the peer and returns no sample
        out = s.announce(ih(0), pid(0), "1.1.1.1", 7001, left=0,
                         event=AnnounceEvent.STOPPED)
        assert (out.complete, out.incomplete, out.peers) == (0, 0, [])
        assert s.metrics_snapshot()["peers"] == 0

    def test_sampling_excludes_self_and_honors_numwant(self):
        s = ShardedSwarmStore(n_shards=2)
        fill(s, ih(1), 40)
        out = s.announce(ih(1), pid(3), "10.0.0.4", 7003, left=1, numwant=10)
        assert len(out.peers) == 10
        assert all(p.peer_id != pid(3) for p in out.peers)
        # distinct draws, valid ports
        assert len({p.peer_id for p in out.peers}) == 10
        assert all(0 < p.port < 65536 for p in out.peers)
        # small swarm: everyone else, never more
        out = s.announce(ih(1), pid(0), "10.0.0.1", 7000, left=1, numwant=500)
        assert len(out.peers) == 39

    def test_swap_remove_keeps_sampling_array_consistent(self):
        s = ShardedSwarmStore(n_shards=1)
        fill(s, ih(2), 10)
        # remove from the middle and the ends via STOPPED
        for i in (0, 5, 9):
            s.announce(ih(2), pid(i), "1.1.1.1", 7000 + i, left=1,
                       event=AnnounceEvent.STOPPED)
        shard = s._shards[0]
        swarm = shard.swarms[ih(2)]
        assert len(swarm.order) == len(swarm.peers) == 7
        # every order slot round-trips through the peer's stored idx
        for idx, peer_id in enumerate(swarm.order):
            assert swarm.peers[peer_id].idx == idx
        out = s.announce(ih(2), b"z" * 20, "2.2.2.2", 9999, left=1, numwant=7)
        assert {p.peer_id for p in out.peers} == set(swarm.order) - {b"z" * 20}

    def test_numwant_clamped_by_cap_and_reply_budget(self):
        s = ShardedSwarmStore(n_shards=1, max_numwant=50, max_reply_bytes=360)
        # budget 360 B / 18 B-per-peer (v6 worst case) = 20 < the cap
        want, clamped = s.clamp_numwant(10**9)
        assert (want, clamped) == (20, True)
        # even the default numwant is bounded by the byte budget
        assert s.clamp_numwant(None) == (20, True)
        fill(s, ih(3), 64)
        out = s.announce(ih(3), b"q" * 20, "3.3.3.3", 8000, left=1,
                         numwant=10**6)
        assert len(out.peers) == 20
        assert s.metrics_snapshot()["numwant_clamped"] >= 1

    def test_negative_numwant_means_default(self):
        from torrent_tpu_torch.net.constants import DEFAULT_NUM_WANT

        s = ShardedSwarmStore(n_shards=1)
        want, clamped = s.clamp_numwant(-1)
        assert want == min(DEFAULT_NUM_WANT, s.max_reply_bytes // 18)
        assert not clamped

    def test_scrape_caps_batch_and_zeros_unknown(self):
        s = ShardedSwarmStore(n_shards=4)
        fill(s, ih(4), 3, seeders=1)
        hashes = [ih(4)] + [ih(100 + i) for i in range(MAX_SCRAPE_HASHES + 20)]
        out = s.scrape(hashes)
        assert len(out) == MAX_SCRAPE_HASHES  # truncated, not unbounded
        assert out[0] == (ih(4), 1, 0, 2)
        assert out[1] == (hashes[1], 0, 0, 0)  # unknown scrapes as zeros

    def test_empty_scrape_walks_all_shards_bounded(self):
        s = ShardedSwarmStore(n_shards=4)
        for i in range(6):
            fill(s, ih(10 + i), 2)
        out = s.scrape([])
        assert {h for h, *_ in out} == {ih(10 + i) for i in range(6)}

    def test_sweep_one_round_robin_evicts_by_ttl(self):
        s = ShardedSwarmStore(n_shards=4, peer_ttl=60)
        fill(s, ih(5), 4)
        shard = s._shards[s.shard_of(ih(5))]
        # age half the peers past the TTL
        with shard._shard_lock:
            swarm = shard.swarms[ih(5)]
            for peer_id in list(swarm.peers)[:2]:
                swarm.peers[peer_id].last_seen = time.monotonic() - 120
        # a full round-robin cycle must visit the aged shard exactly once
        evicted = sum(s.sweep_one() for _ in range(s.n_shards))
        assert evicted == 2
        assert s.metrics_snapshot()["peers"] == 2
        assert s.metrics_snapshot()["evicted"] == 2

    def test_sweep_drops_empty_historyless_swarms(self):
        s = ShardedSwarmStore(n_shards=2, peer_ttl=60)
        s.seed_peer(ih(6), "9.9.9.9", 7001)
        shard = s._shards[s.shard_of(ih(6))]
        with shard._shard_lock:
            for p in shard.swarms[ih(6)].peers.values():
                p.last_seen = time.monotonic() - 120
        s.sweep()
        assert s.metrics_snapshot()["swarms"] == 0

    def test_seed_peer_creates_swarm_and_counts_indexed(self):
        s = ShardedSwarmStore(n_shards=4)
        s.seed_peer(ih(7), "5.5.5.5", 6881, left=0)
        s.seed_peer(ih(7), "5.5.5.6", 6881, left=1)
        snap = s.metrics_snapshot()
        assert snap["indexed"] == 2 and snap["announces"] == 0
        assert s.scrape([ih(7)]) == [(ih(7), 1, 0, 1)]
        # an indexer-seeded peer is handed out to real announcers
        out = s.announce(ih(7), b"n" * 20, "1.2.3.4", 7000, left=1, numwant=5)
        assert {(p.ip, p.port) for p in out.peers} == {
            ("5.5.5.5", 6881), ("5.5.5.6", 6881)
        }

    def test_announce_batch_preserves_order_across_shards(self):
        s = ShardedSwarmStore(n_shards=8)
        items = [
            (ih(i % 5), pid(i), "7.7.7.%d" % (i + 1), 7100 + i, i % 2,
             AnnounceEvent.EMPTY, 10)
            for i in range(24)
        ]
        outs = s.announce_batch(items)
        assert len(outs) == 24 and all(o is not None for o in outs)
        # outcome i reflects swarm i%5's state, proving order held
        for i, out in enumerate(outs):
            c, inc = out.complete, out.incomplete
            sc = s.scrape([items[i][0]])[0]
            assert c <= sc[1] and inc <= sc[3]
        snap = s.metrics_snapshot()
        assert snap["batch"] == {"batches": 1, "announces": 24, "max": 24}
        assert snap["announces"] == 24

    def test_concurrent_multi_swarm_storm_reconciles(self):
        """The announce-storm contract at test scale: threads storm
        distinct swarms; per-shard counts, store totals, and scrape sums
        must all agree afterwards."""
        s = ShardedSwarmStore(n_shards=8)
        hashes = [ih(50 + i) for i in range(16)]

        def worker(wi):
            for k in range(100):
                h = hashes[(wi + k) % len(hashes)]
                p = (b"w%dk%03d" % (wi, k)).ljust(20, b"x")
                s.announce(h, p, "10.2.%d.%d" % (wi, k % 250), 7000 + wi,
                           left=k % 3, numwant=15)

        async def go():
            await asyncio.gather(*(asyncio.to_thread(worker, w) for w in range(6)))

        run(go())
        snap = s.metrics_snapshot()
        assert snap["announces"] == 600
        assert snap["peers"] == 600  # unique (wi, k) announcers
        assert snap["peers"] == sum(sh["peers"] for sh in snap["shards"])
        sc = s.scrape(hashes[:MAX_SCRAPE_HASHES])
        assert sum(c + i for _, c, _, i in sc) == 600
        assert sum(1 for sh in snap["shards"] if sh["peers"]) >= 4

    def test_store_rejects_zero_shards(self):
        with pytest.raises(ValueError):
            ShardedSwarmStore(n_shards=0)

    def test_stopped_for_unknown_hash_leaves_no_ghost_swarm(self):
        """Review fix: a hostile loop of STOPPED announces for random
        hashes must not allocate ghost swarms."""
        s = ShardedSwarmStore(n_shards=4)
        for i in range(16):
            out = s.announce(ih(200 + i), pid(i), "1.1.1.1", 7000, left=0,
                             event=AnnounceEvent.STOPPED)
            assert (out.complete, out.incomplete, out.peers) == (0, 0, [])
        snap = s.metrics_snapshot()
        assert snap["swarms"] == 0 and snap["peers"] == 0

    def test_completed_ghost_swarms_expire_one_ttl_after_activity(self):
        """Review fix: a hostile loop of COMPLETED/left=0 announces to
        random hashes must not allocate PERMANENT swarms — an empty
        swarm is kept at most one TTL past its last announce, even with
        downloaded > 0; a recently-active one keeps its counters."""
        s = ShardedSwarmStore(n_shards=4, peer_ttl=60)
        for i in range(12):
            s.announce(ih(300 + i), pid(i), "6.6.6.6", 7000, left=0,
                       event=AnnounceEvent.COMPLETED)
        # age everything (peers AND swarm activity) past the TTL
        for shard in s._shards:
            with shard._shard_lock:
                for swarm in shard.swarms.values():
                    swarm.last_active = time.monotonic() - 120
                    for p in swarm.peers.values():
                        p.last_seen = time.monotonic() - 120
        assert s.sweep() == 12
        assert s.metrics_snapshot()["swarms"] == 0
        # contrast: a completed swarm whose PEER expired but whose
        # announce activity is recent keeps its lifetime counters
        s.announce(ih(320), pid(0), "6.6.6.7", 7001, left=0,
                   event=AnnounceEvent.COMPLETED)
        shard = s._shards[s.shard_of(ih(320))]
        with shard._shard_lock:
            for p in shard.swarms[ih(320)].peers.values():
                p.last_seen = time.monotonic() - 120
        s.sweep()
        assert s.scrape([ih(320)]) == [(ih(320), 0, 1, 0)]

    def test_expired_peers_not_sampled_before_sweep(self):
        """Review fix: a peer past the TTL awaiting its shard's sweep
        turn is never handed out in announce replies."""
        s = ShardedSwarmStore(n_shards=1, peer_ttl=60)
        fill(s, ih(330), 6)
        shard = s._shards[0]
        with shard._shard_lock:
            swarm = shard.swarms[ih(330)]
            for peer_id in list(swarm.peers)[:3]:
                swarm.peers[peer_id].last_seen = time.monotonic() - 120
        fresh = set(list(swarm.peers)[3:])
        for _ in range(10):
            out = s.announce(ih(330), b"z" * 20, "9.9.9.9", 9000, left=1,
                             numwant=6)
            assert {p.peer_id for p in out.peers} <= fresh | {b"z" * 20}

    def test_incremental_peer_counter_tracks_all_paths(self):
        """Review fix: the per-shard peer gauge is maintained
        incrementally (O(1) snapshots); insert, re-announce, STOPPED,
        and TTL sweep must all keep it exact."""
        s = ShardedSwarmStore(n_shards=2, peer_ttl=60)
        fill(s, ih(210), 6)
        s.announce(ih(210), pid(0), "1.1.1.1", 7000, left=1)  # refresh, not insert
        assert s.metrics_snapshot()["peers"] == 6
        s.announce(ih(210), pid(1), "1.1.1.1", 7001, left=1,
                   event=AnnounceEvent.STOPPED)
        assert s.metrics_snapshot()["peers"] == 5
        shard = s._shards[s.shard_of(ih(210))]
        with shard._shard_lock:
            for p in shard.swarms[ih(210)].peers.values():
                p.last_seen = time.monotonic() - 120
        s.sweep()
        assert s.metrics_snapshot()["peers"] == 0


class _FakeAnnounce:
    """Transport-free AnnounceRequest standing in for the batch path."""

    def __init__(self, info_hash, peer_id, left=1, numwant=5):
        self.info_hash = info_hash
        self.peer_id = peer_id
        self.ip = "8.8.8.8"
        self.port = 7777
        self.left = left
        self.event = AnnounceEvent.EMPTY
        self.num_want = numwant
        self.replies = []

    async def respond(self, interval, complete, incomplete, peers):
        self.replies.append((interval, complete, incomplete, peers))


class TestServiceBatching:
    def test_handle_batch_bulk_replies(self):
        from torrent_tpu_torch.server.tracker import AnnounceRequest

        class _Req(_FakeAnnounce, AnnounceRequest):
            def __init__(self, *a, **kw):
                _FakeAnnounce.__init__(self, *a, **kw)

        store = ShardedSwarmStore(n_shards=4)
        fill(store, ih(30), 10)
        tracker = ShardedTracker(store)
        reqs = [_Req(ih(30), (b"r%d" % i).ljust(20, b"r")) for i in range(8)]
        run(tracker.handle_batch(reqs))
        assert all(len(r.replies) == 1 for r in reqs)
        interval, complete, incomplete, peers = reqs[0].replies[0]
        assert interval == store.interval and len(peers) <= 5
        assert store.metrics_snapshot()["batch"]["announces"] == 8

    def test_drain_nowait_preserves_close_sentinel(self):
        from torrent_tpu_torch.server.tracker import TrackerServer

        async def go():
            srv = TrackerServer(ServeOptions(http_port=None, udp_port=None))
            srv._queue.put_nowait("a")
            srv._queue.put_nowait("b")
            srv._queue.put_nowait(None)  # close sentinel
            assert srv.drain_nowait() == ["a", "b"]
            # the sentinel went back: the iterator still terminates
            srv._closed = True
            with pytest.raises(StopAsyncIteration):
                await srv.__anext__()

        run(go())


class TestServiceIntegration:
    async def _with_service(self, fn, **kw):
        opts = ServeOptions(http_port=0, udp_port=0, host="127.0.0.1",
                            interval=2)
        server, task = await run_sharded_tracker(opts, **kw)
        try:
            return await fn(server, task)
        finally:
            server.close()
            await asyncio.wait_for(task, 5)

    def test_http_and_udp_roundtrip_through_sharded_store(self):
        from torrent_tpu_torch.net.tracker import announce, scrape

        async def go(server, task):
            url = f"http://127.0.0.1:{server.http_port}/announce"
            r1 = await announce(url, AnnounceInfo(
                info_hash=ih(40), peer_id=pid(1), port=7001, left=100,
                event=AnnounceEvent.STARTED))
            assert r1.incomplete == 1 and r1.peers == []
            r2 = await announce(url, AnnounceInfo(
                info_hash=ih(40), peer_id=pid(2), port=7002, left=0,
                event=AnnounceEvent.STARTED))
            assert (r2.complete, r2.incomplete) == (1, 1)
            assert [(p.ip, p.port) for p in r2.peers] == [("127.0.0.1", 7001)]
            udp = f"udp://127.0.0.1:{server.udp_port}"
            r3 = await announce(udp, AnnounceInfo(
                info_hash=ih(40), peer_id=pid(3), port=7003, left=10))
            assert (r3.complete, r3.incomplete) == (1, 2)
            assert len(r3.peers) == 2
            sc = await scrape(url, [ih(40)])
            assert (sc[0].complete, sc[0].incomplete) == (1, 2)
            assert task.store.metrics_snapshot()["announces"] == 3

        run(self._with_service(go))

    def test_udp_burst_is_batch_processed(self):
        """A burst of datagrams queued before the pump wakes must drain
        into per-shard batches, visible in the batch counters."""
        from torrent_tpu_torch.net.tracker import announce

        async def go(server, task):
            udp = f"udp://127.0.0.1:{server.udp_port}"
            await asyncio.gather(*(
                announce(udp, AnnounceInfo(
                    info_hash=ih(41 + i % 3), peer_id=pid(60 + i),
                    port=7100 + i, left=1))
                for i in range(12)
            ))
            snap = task.store.metrics_snapshot()
            assert snap["announces"] == 12
            batch = snap["batch"]
            assert batch["announces"] == 12
            # every announce rode a drained batch; bursts coalesce, so
            # cycles never exceed announces and the counters reconcile
            assert 1 <= batch["batches"] <= 12
            assert batch["max"] >= 1

        run(self._with_service(go))

    def test_metrics_route_serves_tracker_series(self):
        import urllib.request

        from torrent_tpu_torch.net.tracker import announce

        async def go(server, task):
            url = f"http://127.0.0.1:{server.http_port}/announce"
            await announce(url, AnnounceInfo(
                info_hash=ih(42), peer_id=pid(9), port=7009, left=0,
                event=AnnounceEvent.STARTED))

            def get():
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.http_port}/metrics", timeout=10
                ) as r:
                    return r.headers["Content-Type"], r.read().decode()

            ct, body = await asyncio.to_thread(get)
            assert ct.startswith("text/plain")
            assert "torrent_tpu_tracker_announces_total 1" in body
            assert 'torrent_tpu_tracker_shard_peers{shard="' in body
            # the log2 latency family renders alongside
            assert "torrent_tpu_tracker_announce_seconds" in body
            # the whole tracker-side exposition lints like the bridge's
            from test_metrics import prom_lint

            prom_lint(body)

        run(self._with_service(go))

    def test_legacy_stats_route_still_works(self):
        from torrent_tpu_torch.codec.bencode import bdecode
        from torrent_tpu_torch.net.tracker import _http_get, announce

        async def go(server, task):
            url = f"http://127.0.0.1:{server.http_port}/announce"
            await announce(url, AnnounceInfo(
                info_hash=ih(43), peer_id=pid(4), port=7004, left=1))
            body = await _http_get(
                f"http://127.0.0.1:{server.http_port}/stats")
            assert bdecode(body)[b"announce"] == 1

        run(self._with_service(go))



class TestServeMain:
    def test_module_entry_point_serves_health(self):
        """``python -m torrent_tpu_torch.tools.serve`` on free ports (no
        card needed: the deployment runs no hash plane) answers
        ``/v1/health`` ready and serves the tracker series."""
        import json
        import os
        import re
        import subprocess
        import sys
        import urllib.request

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.Popen(
            [sys.executable, "-m", "torrent_tpu_torch.tools.serve", "--host", "127.0.0.1",
             "--http-port", "0", "--udp-port", "0", "--dht-port", "-1", "--interval", "1"],
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        try:
            line = proc.stdout.readline()
            m = re.search(r"tracker http=(\d+) udp=(\d+) shards=8 dht=off slo=off", line)
            assert m, line
            port = int(m.group(1))
            deadline = time.monotonic() + 10
            while True:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/health", timeout=5) as r:
                        health = json.loads(r.read())
                    if health["ready"] or time.monotonic() > deadline:
                        break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                time.sleep(0.1)
            assert health["ready"] and health["live"], health
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                assert b"torrent_tpu_tracker_shards 8" in r.read()
        finally:
            proc.terminate()
            proc.wait(10)
