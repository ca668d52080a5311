"""HTTP streaming while downloading (tools/stream.py + session window).

The stream window steers the picker (unit-level assertions on the
priority array), and the server is driven with a real HTTP client over
a live two-client swarm: whole-file GET mid-download, Range seeks into
not-yet-downloaded regions, suffix ranges, HEAD, and 416s.
"""

import asyncio
import urllib.error
import urllib.request

import numpy as np
import pytest

from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.session.client import Client, ClientConfig
from torrent_tpu_torch.session.torrent import Torrent, TorrentState
from torrent_tpu_torch.storage.storage import MemoryStorage, Storage
from torrent_tpu_torch.tools.stream import StreamServer

from tests.test_torch_session import build_torrent_bytes, fast_config, run, start_tracker
from torrent_tpu_torch.session.client import generate_peer_id


def make_torrent(payload_len=512 * 1024, piece_len=32768):
    rng = np.random.default_rng(60)
    payload = rng.integers(0, 256, size=payload_len, dtype=np.uint8).tobytes()
    m = parse_metainfo(
        build_torrent_bytes(payload, piece_len, b"http://127.0.0.1:1/announce")
    )
    t = Torrent(
        metainfo=m,
        storage=Storage(MemoryStorage(), m.info),
        peer_id=generate_peer_id(),
        port=1234,
        config=fast_config(),
    )
    return t, payload


class TestStreamWindow:
    def test_window_boosts_and_follows(self):
        t, _ = make_torrent()
        t.set_stream_window(0, 4)
        assert list(t._piece_priority[:4]) == [127] * 4
        assert t._piece_priority[4] == 1
        # moving the window restores what it leaves behind
        t.set_stream_window(8 * 32768, 4)
        assert t._piece_priority[0] == 1
        assert list(t._piece_priority[8:12]) == [127] * 4
        t.clear_stream_window()
        assert t._piece_priority.max() == 1

    def test_window_never_widens_selection(self):
        t, _ = make_torrent()
        t._piece_priority[:] = 0
        t._piece_priority[2] = 1
        t._stream_base = None
        t.set_stream_window(0, 8)
        assert t._piece_priority[0] == 0  # deselected stays deselected
        assert t._piece_priority[2] == 127

    def test_selection_change_reapplies_windows_over_new_mask(self):
        t, _ = make_torrent()
        t.set_stream_window(0, 4)

        async def go():
            await t.set_file_priorities({0: 5})
            # the active window rides the new mask: boosted at the front,
            # the new base priority everywhere else
            assert list(t._piece_priority[:4]) == [127] * 4
            assert t._piece_priority[5] == 5
            t.clear_stream_window()
            assert t._piece_priority.max() == 5

        run(go())

    def test_concurrent_reader_windows_union(self):
        """A second reader's window must not wipe the first's boost
        (players open head + tail connections simultaneously)."""
        t, _ = make_torrent()
        t.set_stream_window(0, 2, token="head")
        t.set_stream_window(10 * 32768, 2, token="tail")
        assert list(t._piece_priority[0:2]) == [127] * 2
        assert list(t._piece_priority[10:12]) == [127] * 2
        t.clear_stream_window("head")
        assert t._piece_priority[0] == 1
        assert t._piece_priority[10] == 127
        t.clear_stream_window("tail")
        assert t._stream_base is None and t._piece_priority.max() == 1

    def test_window_advance_is_delta_not_full_rebuild(self):
        t, _ = make_torrent()
        t.set_stream_window(0, 4)
        t._rarity_dirty = False
        t.set_stream_window(100, 4)  # same first piece: total no-op
        assert t._rarity_dirty is False
        t.set_stream_window(32768, 4)  # advance: O(window) delta path,
        assert t._rarity_dirty is False  # no rarity rebuild scheduled
        assert t._piece_priority[0] == 1  # restored
        assert list(t._piece_priority[1:5]) == [127] * 4

    def test_stop_wakes_parked_reader(self):
        t, _ = make_torrent()

        async def go():
            waiter = asyncio.ensure_future(t.wait_piece(2))
            await asyncio.sleep(0.02)
            assert not waiter.done()
            await t.stop()
            with pytest.raises(RuntimeError, match="stopped"):
                await asyncio.wait_for(waiter, 2)

        run(go())

    def test_deselect_wakes_parked_reader_with_error(self):
        t, _ = make_torrent()

        async def go():
            waiter = asyncio.ensure_future(t.wait_piece(2))
            await asyncio.sleep(0.02)
            await t.set_file_priorities({0: 0})
            with pytest.raises(LookupError, match="deselected"):
                await asyncio.wait_for(waiter, 2)

        run(go())

    def test_bulk_recheck_wakes_parked_readers(self, tmp_path):
        t, payload = make_torrent()

        async def go():
            waiter = asyncio.ensure_future(t.wait_piece(0))
            await asyncio.sleep(0.02)
            assert not waiter.done()
            # write the real payload then recheck: bulk bitfield adoption
            for off in range(0, len(payload), 65536):
                t.storage.set(off, payload[off : off + 65536])
            await t.recheck()
            await asyncio.wait_for(waiter, 5)

        run(go())

    def test_wait_piece_parks_until_notify(self):
        t, _ = make_torrent()

        async def go():
            waiter = asyncio.ensure_future(t.wait_piece(3))
            await asyncio.sleep(0.05)
            assert not waiter.done()
            t.bitfield.set(3)
            t._notify_piece(3)
            await asyncio.wait_for(waiter, 2)
            await t.wait_piece(3)  # already-done fast path
            with pytest.raises(IndexError):
                await t.wait_piece(10**9)

        run(go())


def _http_get(url, headers=None, timeout=30):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), resp.read()


class TestStreamServerE2E:
    def _swarm(self):
        async def setup():
            rng = np.random.default_rng(61)
            payload = rng.integers(0, 256, size=2 * 1024 * 1024, dtype=np.uint8).tobytes()
            server, pump, announce_url = await start_tracker()
            m = parse_metainfo(build_torrent_bytes(payload, 32768, announce_url.encode()))
            seed = Client(ClientConfig(host="127.0.0.1", hasher="cpu"))
            leech = Client(ClientConfig(host="127.0.0.1", hasher="cpu"))
            seed.config.torrent = fast_config()
            leech.config.torrent = fast_config()
            await seed.start()
            await leech.start()
            ss = Storage(MemoryStorage(), m.info)
            for off in range(0, len(payload), 65536):
                ss.set(off, payload[off : off + 65536])
            t_seed = await seed.add(m, ss)
            assert t_seed.state == TorrentState.SEEDING
            t_leech = await leech.add(m, Storage(MemoryStorage(), m.info))
            return payload, server, pump, seed, leech, t_leech

        return setup

    def test_full_get_during_download_bit_identical(self):
        async def go():
            payload, server, pump, seed, leech, t = await self._swarm()()
            stream = await StreamServer(t).start()
            try:
                status, headers, body = await asyncio.to_thread(
                    _http_get, f"http://127.0.0.1:{stream.port}/0"
                )
                assert status == 200
                assert headers["Accept-Ranges"] == "bytes"
                assert int(headers["Content-Length"]) == len(payload)
                assert body == payload
            finally:
                stream.close()
                await seed.close()
                await leech.close()
                server.close()
                await asyncio.wait_for(pump, 5)

        run(go(), timeout=90)

    def test_range_seek_into_undownloaded_region(self):
        """A Range request deep into the file must be served (scheduler
        re-pointed) and match the source bytes exactly."""

        async def go():
            payload, server, pump, seed, leech, t = await self._swarm()()
            stream = await StreamServer(t).start()
            try:
                lo, hi = len(payload) - 200_000, len(payload) - 1
                status, headers, body = await asyncio.to_thread(
                    _http_get,
                    f"http://127.0.0.1:{stream.port}/0",
                    {"Range": f"bytes={lo}-{hi}"},
                )
                assert status == 206
                assert headers["Content-Range"] == f"bytes {lo}-{hi}/{len(payload)}"
                assert body == payload[lo : hi + 1]
                # suffix form
                status2, _, tail = await asyncio.to_thread(
                    _http_get,
                    f"http://127.0.0.1:{stream.port}/0",
                    {"Range": "bytes=-4096"},
                )
                assert status2 == 206 and tail == payload[-4096:]
            finally:
                stream.close()
                await seed.close()
                await leech.close()
                server.close()
                await asyncio.wait_for(pump, 5)

        run(go(), timeout=90)

    def test_index_lists_files_with_streamability(self):
        import json

        async def go():
            payload, server, pump, seed, leech, t = await self._swarm()()
            stream = await StreamServer(t).start()
            try:
                status, headers, body = await asyncio.to_thread(
                    _http_get, f"http://127.0.0.1:{stream.port}/"
                )
                assert status == 200
                assert headers["Content-Type"].startswith("application/json")
                idx = json.loads(body)
                assert idx["files"] == [
                    {
                        "index": 0,
                        "path": "swarm-test",
                        "length": len(payload),
                        "streamable": True,
                    }
                ]
                # deselection flips streamability — on a torrent with NO
                # data yet (a completed torrent stays streamable: every
                # piece is on disk)
                t_bare, _ = make_torrent()
                await t_bare.set_file_priorities({0: 0})
                stream2 = await StreamServer(t_bare).start()
                try:
                    _, _, body2 = await asyncio.to_thread(
                        _http_get, f"http://127.0.0.1:{stream2.port}/index.json"
                    )
                    assert json.loads(body2)["files"][0]["streamable"] is False
                finally:
                    stream2.close()
            finally:
                stream.close()
                await seed.close()
                await leech.close()
                server.close()
                await asyncio.wait_for(pump, 5)

        run(go(), timeout=60)

    def test_box_server_streams_many_torrents(self):
        """BoxStreamServer: torrent discovery at /, per-torrent file
        indices, Range streaming routed by infohash."""
        import json

        from torrent_tpu_torch.tools.stream import BoxStreamServer

        async def go():
            rng = np.random.default_rng(65)
            server, pump, announce_url = await start_tracker()
            seed = Client(ClientConfig(host="127.0.0.1", hasher="cpu"))
            seed.config.torrent = fast_config()
            await seed.start()
            box = None
            try:
                metas = []
                for name in (b"alpha.bin", b"beta.bin"):
                    payload = rng.integers(0, 256, size=150_000, dtype=np.uint8).tobytes()
                    m = parse_metainfo(
                        build_torrent_bytes(payload, 32768, announce_url.encode(), name=name)
                    )
                    st = Storage(MemoryStorage(), m.info)
                    st.set(0, payload)
                    await seed.add(m, st)
                    metas.append((m, payload))
                box = await BoxStreamServer(seed).start()
                status, headers, body = await asyncio.to_thread(
                    _http_get, f"http://127.0.0.1:{box.port}/"
                )
                listing = json.loads(body)
                assert {t["name"] for t in listing["torrents"]} == {
                    "alpha.bin", "beta.bin",
                }
                assert all(t["complete"] for t in listing["torrents"])
                for m, payload in metas:
                    ih = m.info_hash.hex()
                    _, _, idx_body = await asyncio.to_thread(
                        _http_get, f"http://127.0.0.1:{box.port}/{ih}/"
                    )
                    files = json.loads(idx_body)["files"]
                    assert files[0]["length"] == len(payload)
                    status, _, got = await asyncio.to_thread(
                        _http_get,
                        f"http://127.0.0.1:{box.port}/{ih}/0",
                        {"Range": "bytes=100-4195"},
                    )
                    assert status == 206 and got == payload[100:4196]
                # unknown torrent → 404
                def missing():
                    try:
                        with urllib.request.urlopen(
                            f"http://127.0.0.1:{box.port}/{'00' * 20}/0", timeout=10
                        ) as r:
                            return r.status
                    except urllib.error.HTTPError as e:
                        return e.code

                assert await asyncio.to_thread(missing) == 404
            finally:
                if box is not None:
                    box.close()
                await seed.close()
                server.close()
                await asyncio.wait_for(pump, 5)

        run(go(), timeout=60)

    def test_deselected_file_is_409_not_a_hang(self):
        """GET for a file excluded from the selection answers immediately
        instead of parking on pieces that will never be scheduled."""

        async def go():
            payload, server, pump, seed, leech, t = await self._swarm()()
            stream = await StreamServer(t).start()
            try:
                await t.set_file_priorities({0: 0})  # exclude everything

                def get():
                    try:
                        with urllib.request.urlopen(
                            f"http://127.0.0.1:{stream.port}/0", timeout=10
                        ) as r:
                            return r.status
                    except urllib.error.HTTPError as e:
                        return e.code

                assert await asyncio.to_thread(get) == 409
            finally:
                stream.close()
                await seed.close()
                await leech.close()
                server.close()
                await asyncio.wait_for(pump, 5)

        run(go(), timeout=60)

    def test_head_and_errors(self):
        async def go():
            payload, server, pump, seed, leech, t = await self._swarm()()
            stream = await StreamServer(t).start()
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{stream.port}/0", method="HEAD"
                )

                def head():
                    with urllib.request.urlopen(req, timeout=30) as r:
                        return r.status, dict(r.headers), r.read()

                status, headers, body = await asyncio.to_thread(head)
                assert status == 200 and body == b""
                assert int(headers["Content-Length"]) == len(payload)

                for path, hdrs, want in (
                    ("/9", {}, 404),
                    ("/zzz", {}, 404),
                    ("/-1", {}, 404),  # negative index must not wrap around
                    ("/0", {"Range": "bytes=99999999-"}, 416),
                ):
                    def bad(p=path, h=hdrs):
                        try:
                            with urllib.request.urlopen(
                                urllib.request.Request(
                                    f"http://127.0.0.1:{stream.port}{p}", headers=h
                                ),
                                timeout=30,
                            ) as r:
                                return r.status
                        except urllib.error.HTTPError as e:
                            return e.code

                    assert await asyncio.to_thread(bad) == want
            finally:
                stream.close()
                await seed.close()
                await leech.close()
                server.close()
                await asyncio.wait_for(pump, 5)

        run(go(), timeout=90)
