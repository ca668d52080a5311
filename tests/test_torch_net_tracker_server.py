"""Tracker server tests — including our client against our own server.

The reference never tested its client against its own server (SURVEY §7.6
calls this out as free integration coverage); here the round-trips run
through the real wire paths on localhost ephemeral ports, both HTTP and UDP.
"""

import asyncio

import pytest

from torrent_tpu_torch.codec.bencode import bdecode
from torrent_tpu_torch.net.tracker import TrackerError, announce, scrape
from torrent_tpu_torch.net.types import AnnounceEvent, AnnounceInfo
from torrent_tpu_torch.server.in_memory import InMemoryTracker, PeerState, run_tracker
from torrent_tpu_torch.server.tracker import ServeOptions

H1 = bytes(range(20))
H2 = bytes(range(1, 21))


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 30))


def make_info(peer_id=b"-TT0001-aaaaaaaaaaaa", port=7001, left=100, **kw):
    return AnnounceInfo(info_hash=H1, peer_id=peer_id, port=port, left=left, **kw)


async def with_tracker(fn, **opts_kw):
    opts = ServeOptions(http_port=0, udp_port=0, host="127.0.0.1", **opts_kw)
    server, task = await run_tracker(opts)
    try:
        return await fn(server, task.tracker)
    finally:
        server.close()
        await asyncio.wait_for(task, 5)


class TestHttpIntegration:
    def test_two_peer_swarm(self):
        async def go(server, tracker):
            url = f"http://127.0.0.1:{server.http_port}/announce"
            res1 = await announce(url, make_info(event=AnnounceEvent.STARTED))
            assert res1.peers == [] and res1.incomplete == 1 and res1.complete == 0
            res2 = await announce(
                url, make_info(peer_id=b"-TT0001-bbbbbbbbbbbb", port=7002, left=0)
            )
            assert res2.complete == 1 and res2.incomplete == 1
            assert [(p.ip, p.port) for p in res2.peers] == [("127.0.0.1", 7001)]

        run(with_tracker(go))

    def test_full_peer_list_mode(self):
        async def go(server, tracker):
            url = f"http://127.0.0.1:{server.http_port}/announce"
            await announce(url, make_info(event=AnnounceEvent.STARTED))
            res = await announce(
                url,
                make_info(peer_id=b"-TT0001-cccccccccccc", port=7003, compact=False),
            )
            assert res.peers[0].peer_id == b"-TT0001-aaaaaaaaaaaa"

        run(with_tracker(go))

    def test_stopped_removes_peer(self):
        async def go(server, tracker):
            url = f"http://127.0.0.1:{server.http_port}/announce"
            await announce(url, make_info(event=AnnounceEvent.STARTED))
            assert tracker.files[H1].incomplete == 1
            await announce(url, make_info(event=AnnounceEvent.STOPPED))
            assert tracker.files[H1].incomplete == 0 and not tracker.files[H1].peers

        run(with_tracker(go))

    def test_completed_promotion(self):
        async def go(server, tracker):
            url = f"http://127.0.0.1:{server.http_port}/announce"
            await announce(url, make_info(event=AnnounceEvent.STARTED, left=10))
            await announce(url, make_info(event=AnnounceEvent.COMPLETED, left=0))
            f = tracker.files[H1]
            assert f.complete == 1 and f.incomplete == 0 and f.downloaded == 1

        run(with_tracker(go))

    def test_scrape_known_and_unknown(self):
        async def go(server, tracker):
            url = f"http://127.0.0.1:{server.http_port}/announce"
            await announce(url, make_info(event=AnnounceEvent.STARTED, left=0))
            res = await scrape(url, [H1, H2])
            by_hash = {e.info_hash: e for e in res}
            assert by_hash[H1].complete == 1
            # unknown hash scrapes as zeros instead of failing the batch
            assert by_hash[H2].complete == 0 and by_hash[H2].downloaded == 0

        run(with_tracker(go))

    def test_scrape_empty_returns_all(self):
        # an empty scrape lists every tracked torrent
        # (in_memory_tracker.ts:149-152)
        async def go(server, tracker):
            url = f"http://127.0.0.1:{server.http_port}/announce"
            await announce(url, make_info(event=AnnounceEvent.STARTED, left=0))
            await announce(
                url,
                AnnounceInfo(
                    info_hash=H2,
                    peer_id=b"-TT0001-bbbbbbbbbbbb",
                    port=7002,
                    event=AnnounceEvent.STARTED,
                    left=5,
                ),
            )
            res = await scrape(url, [])
            by_hash = {e.info_hash: e for e in res}
            assert set(by_hash) == {H1, H2}
            assert by_hash[H1].complete == 1
            assert by_hash[H2].incomplete == 1

        run(with_tracker(go))

    def test_invalid_params_failure_reason(self):
        async def go(server, tracker):
            url = f"http://127.0.0.1:{server.http_port}/announce"
            bad = AnnounceInfo(info_hash=b"short", peer_id=b"-TT0001-aaaaaaaaaaaa", port=1)
            with pytest.raises(TrackerError, match="invalid info_hash"):
                await announce(url, bad)
            assert server.stats["rejected"] == 1

        run(with_tracker(go))

    def test_filter_list(self):
        async def go(server, tracker):
            url = f"http://127.0.0.1:{server.http_port}/announce"
            with pytest.raises(TrackerError, match="allowlist"):
                await announce(url, make_info())

        run(with_tracker(go, filter_list={H2}))

    def test_stats_route(self):
        async def go(server, tracker):
            url = f"http://127.0.0.1:{server.http_port}/announce"
            await announce(url, make_info(event=AnnounceEvent.STARTED))
            from torrent_tpu_torch.net.tracker import _http_get

            body = await _http_get(f"http://127.0.0.1:{server.http_port}/stats")
            stats = bdecode(body)
            assert stats[b"announce"] == 1

        run(with_tracker(go))


class TestUdpIntegration:
    def setup_method(self):
        from torrent_tpu_torch.net import tracker as trk

        trk._conn_cache.clear()

    def test_udp_announce_scrape_roundtrip(self):
        async def go(server, tracker):
            url = f"udp://127.0.0.1:{server.udp_port}"
            res1 = await announce(url, make_info(event=AnnounceEvent.STARTED))
            assert res1.incomplete == 1 and res1.peers == []
            res2 = await announce(
                url, make_info(peer_id=b"-TT0001-dddddddddddd", port=7009, left=0)
            )
            assert (res2.complete, res2.incomplete) == (1, 1)
            assert [(p.ip, p.port) for p in res2.peers] == [("127.0.0.1", 7001)]
            sc = await scrape(url, [H1])
            assert sc[0].complete == 1 and sc[0].incomplete == 1

        run(with_tracker(go))

    def test_udp_expired_connection_id(self):
        async def go(server, tracker):
            import torrent_tpu_torch.net.tracker as trk

            url = f"udp://127.0.0.1:{server.udp_port}"
            # poison the client cache with a bogus id; server must reject,
            # client must re-connect on retry and then succeed
            trk._conn_cache[("127.0.0.1", server.udp_port)] = (12345, __import__("time").monotonic())
            res = await announce(url, make_info(event=AnnounceEvent.STARTED))
            assert res.interval > 0

        run(with_tracker(go))


class TestInMemoryTrackerUnit:
    def test_random_selection_excludes_self_and_terminates(self):
        t = InMemoryTracker()
        from torrent_tpu_torch.server.in_memory import FileInfo

        info = FileInfo()
        info.peers[b"a" * 20] = PeerState(peer_id=b"a" * 20, ip="1.1.1.1", port=1, left=0)
        # n+1 == pool size including self — the reference's loop could hang
        sel = t.random_selection(info, b"a" * 20, 1)
        assert sel == []
        info.peers[b"b" * 20] = PeerState(peer_id=b"b" * 20, ip="2.2.2.2", port=2, left=5)
        sel = t.random_selection(info, b"a" * 20, 5)
        assert len(sel) == 1 and sel[0].peer_id == b"b" * 20

    def test_sweep_evicts_idle(self):
        t = InMemoryTracker()
        from torrent_tpu_torch.server.in_memory import FileInfo

        info = FileInfo(complete=1, incomplete=1)
        fresh = PeerState(peer_id=b"f" * 20, ip="1.1.1.1", port=1, left=5)
        # Clearly past the TTL regardless of how recently the host booted
        # (monotonic clocks start near 0 on fresh VMs, so last_seen=0.0 can
        # still be "fresh" when uptime < PEER_TTL).
        import time as _time

        from torrent_tpu_torch.server.in_memory import PEER_TTL

        stale = PeerState(
            peer_id=b"s" * 20, ip="2.2.2.2", port=2, left=0,
            last_seen=_time.monotonic() - PEER_TTL - 1,
        )
        info.peers = {b"f" * 20: fresh, b"s" * 20: stale}
        t.files[H1] = info
        assert t.sweep() == 1
        assert info.complete == 0 and info.incomplete == 1
        assert b"s" * 20 not in info.peers


class TestIpv6Announces:
    def test_v6_announcer_returned_via_peers6(self):
        """A tracker on ::1 records v6 announcers and hands them to the
        next announcer in the BEP 7 peers6 field (full client+server
        e2e over real v6 sockets)."""
        import socket

        import pytest as _pytest

        from torrent_tpu_torch.net.tracker import announce
        from torrent_tpu_torch.net.types import AnnounceEvent, AnnounceInfo
        from torrent_tpu_torch.server.in_memory import run_tracker
        from torrent_tpu_torch.server.tracker import ServeOptions

        if not socket.has_ipv6:
            _pytest.skip("no IPv6")

        async def go():
            try:
                server, pump = await run_tracker(
                    ServeOptions(http_port=0, udp_port=None, host="::1", interval=1)
                )
            except OSError:
                _pytest.skip("IPv6 loopback unavailable")
            url = f"http://[::1]:{server.http_port}/announce"
            ih = b"\x55" * 20
            try:
                await announce(
                    url,
                    AnnounceInfo(
                        info_hash=ih, peer_id=b"-AA0001-000000000001",
                        port=7001, left=0, event=AnnounceEvent.STARTED,
                    ),
                )
                res = await announce(
                    url,
                    AnnounceInfo(
                        info_hash=ih, peer_id=b"-BB0001-000000000002",
                        port=7002, left=100, event=AnnounceEvent.STARTED,
                    ),
                )
                assert ("::1", 7001) in [(p.ip, p.port) for p in res.peers]
            finally:
                server.close()
                await asyncio.wait_for(pump, 5)

        run(go())
