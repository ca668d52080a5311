"""Token-bucket rate limiting: bucket math with a fake clock, session
wiring (no reference counterpart — the reference serves unthrottled,
torrent.ts:158-176)."""

import asyncio


from torrent_tpu_torch.net import protocol as proto
from torrent_tpu_torch.session.client import Client, ClientConfig
from torrent_tpu_torch.utils.ratelimit import TokenBucket
from tests.test_torch_session_fast import _messages, _mk_fast_peer
from tests.test_torch_session_selection import make_multifile_torrent, PLEN
from tests.test_torch_session import run


class _FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


class TestTokenBucket:
    def test_unlimited_never_waits(self):
        async def go():
            b = TokenBucket(0)
            assert b.unlimited
            await asyncio.wait_for(b.take(10**9), timeout=1)

        run(go())

    def test_burst_then_paced(self):
        async def go():
            clock = _FakeClock()
            b = TokenBucket(1000, clock=clock)
            # the initial burst (one second of rate) passes instantly
            await asyncio.wait_for(b.take(1000), timeout=1)
            assert b._tokens == 0
            # the next take must wait for refill: advance the fake clock
            # from a side task while take() sleeps
            async def advance():
                for _ in range(60):
                    await asyncio.sleep(0.01)
                    clock.now += 0.25

            task = asyncio.create_task(advance())
            await asyncio.wait_for(b.take(500), timeout=5)
            task.cancel()
            # the refill consumed at least 0.5 simulated seconds
            assert clock.now >= 1000.5

        run(go())

    def test_oversized_take_carries_deficit(self):
        async def go():
            clock = _FakeClock()
            b = TokenBucket(100, clock=clock)

            async def advance():
                for _ in range(400):
                    await asyncio.sleep(0.005)
                    clock.now += 0.5

            task = asyncio.create_task(advance())
            # 350 bytes at 100 B/s: bucket holds 100, so the take waits
            # for a full bucket then goes 250 into deficit
            await asyncio.wait_for(b.take(350), timeout=5)
            assert b._tokens <= -200
            # the deficit pushes the next take out ~2.5 more sim-seconds
            t_before = clock.now
            await asyncio.wait_for(b.take(100), timeout=5)
            task.cancel()
            assert clock.now - t_before >= 2.0

        run(go())


class TestSessionWiring:
    def test_client_builds_buckets_and_passes_them(self, tmp_path):
        async def go():
            c = Client(ClientConfig(hasher="cpu", port=0, enable_upnp=False, max_upload_bps=12345))
            assert c.upload_bucket.rate == 12345
            assert c.download_bucket.unlimited

        run(go())

    def test_serve_request_consumes_upload_tokens(self):
        async def go():
            t, payload = make_multifile_torrent([2 * PLEN])
            await asyncio.to_thread(t.storage.set, 0, payload)
            for i in range(t.info.num_pieces):
                t.bitfield.set(i)
            taken = []

            class _Spy:
                unlimited = False  # the serve path skips unlimited buckets

                async def take(self, n):
                    taken.append(n)

            t.upload_bucket = _Spy()
            peer = _mk_fast_peer(t)
            peer.am_choking = False
            await t._serve_request(peer, 0, 0, 16384)
            assert taken == [16384]
            assert any(
                isinstance(m, proto.Piece)
                for m in _messages(bytes(peer.writer.data))
            )
            # refused requests must not consume tokens
            peer.am_choking = True
            peer.allowed_fast_out = set()
            await t._serve_request(peer, 0, 16384, 16384)
            assert taken == [16384]

        run(go())

    def test_ingest_consumes_download_tokens(self):
        async def go():
            t, payload = make_multifile_torrent([2 * PLEN])
            taken = []

            class _Spy:
                async def take(self, n):
                    taken.append(n)

            t.download_bucket = _Spy()
            peer = _mk_fast_peer(t)
            await t._ingest_block(peer, 0, 0, payload[:16384])
            assert taken == [16384]

        run(go())


class TestPerTorrentCaps:
    def test_both_layers_debited_on_serve_and_ingest(self):
        async def go():
            t, payload = make_multifile_torrent([2 * PLEN])
            await asyncio.to_thread(t.storage.set, 0, payload)
            for i in range(t.info.num_pieces):
                t.bitfield.set(i)

            taken = {"global_up": [], "own_up": [], "global_down": [], "own_down": []}

            def spy(key):
                class _Spy:
                    unlimited = False

                    async def take(self, n):
                        taken[key].append(n)

                return _Spy()

            t.upload_bucket = spy("global_up")
            t.own_upload_bucket = spy("own_up")
            t.download_bucket = spy("global_down")
            t.own_download_bucket = spy("own_down")
            peer = _mk_fast_peer(t)
            peer.am_choking = False
            await t._serve_request(peer, 0, 0, 16384)
            assert taken["global_up"] == [16384] and taken["own_up"] == [16384]
            t.bitfield = type(t.bitfield)(t.info.num_pieces)  # accept ingest
            await t._ingest_block(peer, 0, 0, payload[:16384])
            assert taken["global_down"] == [16384] and taken["own_down"] == [16384]

        run(go())

    def test_config_builds_per_torrent_buckets(self):
        t, _ = make_multifile_torrent([PLEN], max_upload_bps=777, max_download_bps=0)
        assert t.own_upload_bucket.rate == 777
        assert t.own_download_bucket.unlimited

    def test_tighter_layer_wins(self):
        """With a loose global cap and a tight per-torrent cap, pacing
        follows the tight one. (The refill clock is fake, but a dry
        bucket's internal pause is a real ~1 s asyncio.sleep — hence
        the generous wait_for margin.)"""

        async def go():
            clock = _FakeClock()
            loose = TokenBucket(10_000, clock=clock)
            tight = TokenBucket(1_000, clock=clock)

            async def take_both(n):
                await loose.take(n)
                await tight.take(n)

            await take_both(1_000)  # burst capacity of the tight bucket
            waiter = asyncio.ensure_future(take_both(1_000))
            await asyncio.sleep(0)
            assert not waiter.done()  # tight bucket is dry
            clock.now += 1.0
            await asyncio.wait_for(waiter, 10)

        run(go())
