"""File-selection / piece-priority tests (no reference counterpart —
the reference downloads all-or-nothing; SURVEY §8.3's missing scheduler).
"""

import asyncio
import hashlib

import numpy as np
import pytest

from torrent_tpu_torch.codec.bencode import bencode
from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.net import protocol as proto
from torrent_tpu_torch.session.client import generate_peer_id
from torrent_tpu_torch.session.torrent import Torrent, TorrentConfig, TorrentState
from torrent_tpu_torch.storage.storage import MemoryStorage, Storage
from tests.test_torch_session_fast import _messages, _mk_fast_peer
from tests.test_torch_session import run


PLEN = 32768


def make_multifile_torrent(file_lens, piece_len=PLEN, **config_kw):
    rng = np.random.default_rng(11)
    payload = rng.integers(0, 256, sum(file_lens), dtype=np.uint8).tobytes()
    pieces = b"".join(
        hashlib.sha1(payload[i : i + piece_len]).digest()
        for i in range(0, len(payload), piece_len)
    )
    data = bencode(
        {
            b"announce": b"http://127.0.0.1:1/announce",
            b"info": {
                b"name": b"sel",
                b"piece length": piece_len,
                b"pieces": pieces,
                b"files": [
                    {b"length": n, b"path": [b"f%d.bin" % i]}
                    for i, n in enumerate(file_lens)
                ],
            },
        }
    )
    m = parse_metainfo(data)
    t = Torrent(
        metainfo=m,
        storage=Storage(MemoryStorage(), m.info),
        peer_id=generate_peer_id(),
        port=1234,
        config=TorrentConfig(**{"hasher": "cpu", **config_kw}),
    )
    return t, payload


class TestPartfile:
    def test_deselected_file_never_appears_on_disk(self, tmp_path):
        """The boundary piece of a selected file spills bytes belonging
        to its deselected neighbor; with FsStorage those bytes go to the
        hidden .parts mirror — no visible stub file — and widening the
        selection promotes the mirror into place."""
        import hashlib
        import os

        from torrent_tpu_torch.codec.bencode import bencode
        from torrent_tpu_torch.storage.storage import FsStorage

        async def go():
            rng = np.random.default_rng(77)
            # f0 = 1.5 pieces, f1 = 1.5 pieces: piece 1 spans both files
            f0 = rng.integers(0, 256, size=PLEN + PLEN // 2, dtype=np.uint8).tobytes()
            f1 = rng.integers(0, 256, size=PLEN + PLEN // 2, dtype=np.uint8).tobytes()
            payload = f0 + f1
            pieces = b"".join(
                hashlib.sha1(payload[i : i + PLEN]).digest()
                for i in range(0, len(payload), PLEN)
            )
            data = bencode(
                {
                    b"announce": b"http://127.0.0.1:1/announce",
                    b"info": {
                        b"name": b"sel",
                        b"piece length": PLEN,
                        b"pieces": pieces,
                        b"files": [
                            {b"length": len(f0), b"path": [b"keep.bin"]},
                            {b"length": len(f1), b"path": [b"skip.bin"]},
                        ],
                    },
                }
            )
            m = parse_metainfo(data)
            t = Torrent(
                metainfo=m,
                storage=Storage(FsStorage(str(tmp_path)), m.info),
                peer_id=generate_peer_id(),
                port=1,
                config=TorrentConfig(hasher="cpu"),
            )
            await t.select_files([0])
            # write the pieces covering file 0 (incl. the spanning piece)
            t.storage.set(0, payload[: 2 * PLEN])
            real = tmp_path / "sel" / "skip.bin"
            assert not real.exists(), "deselected file must not appear"
            parts_dir = tmp_path / ".parts"
            assert parts_dir.is_dir() and any(parts_dir.iterdir())
            # the spilled bytes read back from the mirror transparently
            assert t.storage.get(0, 2 * PLEN) == payload[: 2 * PLEN]
            # widen: the mirror is promoted into the real location
            await t.select_files([0, 1])
            assert real.exists()
            head = real.read_bytes()[: PLEN // 2]
            assert head == f1[: PLEN // 2]  # spill preserved
            # finish the remaining bytes and verify the whole payload
            t.storage.set(2 * PLEN, payload[2 * PLEN :])
            assert t.storage.get(0, len(payload)) == payload
            assert real.read_bytes() == f1

            # deselecting a file with REAL on-disk data keeps its IO in
            # place — verified bytes stay readable, no mirror split-brain
            await t.select_files([0])
            assert t.storage.get(0, len(payload)) == payload
            t.storage.set(2 * PLEN, payload[2 * PLEN :])
            assert real.read_bytes() == f1  # wrote through to the real file

        run(go())

    def test_spill_survives_restart_via_reapplied_selection(self, tmp_path):
        """Fresh process: a new FsStorage knows nothing of the old
        routing, but re-applying the selection (what Client.add's
        wanted_files does before start) promotes any spilled mirror of
        now-wanted files back into place."""
        import hashlib

        from torrent_tpu_torch.codec.bencode import bencode
        from torrent_tpu_torch.storage.storage import FsStorage

        async def go():
            rng = np.random.default_rng(79)
            f0 = rng.integers(0, 256, size=PLEN + PLEN // 2, dtype=np.uint8).tobytes()
            f1 = rng.integers(0, 256, size=PLEN + PLEN // 2, dtype=np.uint8).tobytes()
            payload = f0 + f1
            pieces = b"".join(
                hashlib.sha1(payload[i : i + PLEN]).digest()
                for i in range(0, len(payload), PLEN)
            )
            data = bencode(
                {
                    b"announce": b"http://127.0.0.1:1/announce",
                    b"info": {
                        b"name": b"sel",
                        b"piece length": PLEN,
                        b"pieces": pieces,
                        b"files": [
                            {b"length": len(f0), b"path": [b"keep.bin"]},
                            {b"length": len(f1), b"path": [b"skip.bin"]},
                        ],
                    },
                }
            )
            m = parse_metainfo(data)

            def mk():
                return Torrent(
                    metainfo=m,
                    storage=Storage(FsStorage(str(tmp_path)), m.info),
                    peer_id=generate_peer_id(),
                    port=1,
                    config=TorrentConfig(hasher="cpu"),
                )

            t1 = mk()
            await t1.select_files([0])
            t1.storage.set(0, payload[: 2 * PLEN])  # spill lands in mirror
            assert not (tmp_path / "sel" / "skip.bin").exists()

            # "restart": brand-new storage, selection re-applied wider
            t2 = mk()
            await t2.select_files([0, 1])
            promoted = tmp_path / "sel" / "skip.bin"
            assert promoted.exists()
            assert promoted.read_bytes()[: PLEN // 2] == f1[: PLEN // 2]

        run(go())


class TestPieceMask:
    def test_file_ranges_and_boundary_pieces(self):
        async def go():
            # f0 = 1.5 pieces, f1 = 2 pieces, f2 = tail
            t, _ = make_multifile_torrent([PLEN + PLEN // 2, 2 * PLEN, PLEN // 4])
            assert t.file_ranges() == [
                (0, PLEN + PLEN // 2),
                (PLEN + PLEN // 2, 2 * PLEN),
                (3 * PLEN + PLEN // 2, PLEN // 4),
            ]
            await t.select_files([1])
            # piece 1 straddles f0/f1 → wanted; piece 3 straddles f1/f2 → wanted
            assert t._piece_priority.tolist() == [0, 1, 1, 1]
            await t.select_files([0])
            assert t._piece_priority.tolist() == [1, 1, 0, 0]
            await t.select_files([2])
            assert t._piece_priority.tolist() == [0, 0, 0, 1]

        run(go())

    def test_left_counts_only_wanted(self):
        async def go():
            t, _ = make_multifile_torrent([2 * PLEN, 2 * PLEN - 100])
            assert t.left == 4 * PLEN - 100
            await t.select_files([0])
            assert t.left == 2 * PLEN
            t.bitfield.set(0)
            assert t.left == PLEN
            # short tail only counts when its piece is wanted
            await t.select_files([1])
            assert t.left == 2 * PLEN - 100

        run(go())

    def test_bad_index_raises(self):
        async def go():
            t, _ = make_multifile_torrent([PLEN, PLEN])
            with pytest.raises(IndexError):
                await t.set_file_priorities({7: 1})
            # select_files validates too: an unknown index must not
            # silently produce an all-zero selection + instant "complete"
            with pytest.raises(IndexError):
                await t.select_files([7])
            assert t._piece_priority.any()

        run(go())

    def test_priority_out_of_range_raises(self):
        async def go():
            t, _ = make_multifile_torrent([PLEN, PLEN])
            with pytest.raises(ValueError):
                await t.set_file_priorities({0: 128})  # int8 ceiling
            with pytest.raises(ValueError):
                await t.set_file_priorities({0: -1})

        run(go())

    def test_widening_selection_reopens_download(self):
        async def go():
            t, _ = make_multifile_torrent([2 * PLEN, 2 * PLEN])
            await t.select_files([0])
            t.state = TorrentState.DOWNLOADING
            t.bitfield.set(0)
            t.bitfield.set(1)
            await t._maybe_completed()
            assert t.state == TorrentState.SEEDING and t.on_complete.is_set()
            await t.select_files([0, 1])
            assert t.state == TorrentState.DOWNLOADING
            assert not t.on_complete.is_set()
            # finishing the widened selection completes again
            t.bitfield.set(2)
            t.bitfield.set(3)
            await t._maybe_completed()
            assert t.state == TorrentState.SEEDING and t.on_complete.is_set()

        run(go())


class TestSchedulerIntegration:
    def test_pipeline_requests_only_wanted(self):
        async def go():
            t, _ = make_multifile_torrent([2 * PLEN, 2 * PLEN])
            await t.select_files([1])
            peer = _mk_fast_peer(t)
            peer.peer_choking = False
            peer.bitfield.from_numpy(np.ones(t.info.num_pieces, dtype=bool))
            await t._fill_pipeline(peer)
            reqs = {
                m.index
                for m in _messages(bytes(peer.writer.data))
                if isinstance(m, proto.Request)
            }
            assert reqs and reqs <= {2, 3}

        run(go())

    def test_priority_orders_rarity(self):
        async def go():
            t, _ = make_multifile_torrent([2 * PLEN, 2 * PLEN])
            await t.set_file_priorities({0: 1, 1: 3})
            t._rebuild_rarity()
            # higher-priority file's pieces come first regardless of avail
            assert set(t._rarity_order[:2]) == {2, 3}

        run(go())

    def test_interest_ignores_unwanted(self):
        async def go():
            t, _ = make_multifile_torrent([2 * PLEN, 2 * PLEN])
            await t.select_files([0])
            peer = _mk_fast_peer(t)
            # peer only has the unwanted file's exclusive piece
            peer.bitfield.set(3)
            await t._update_interest(peer)
            assert not peer.am_interested
            # selection change flips interest on immediately
            await t.select_files([1])
            assert peer.am_interested

        run(go())

    def test_completion_on_selection_satisfied(self):
        async def go():
            t, payload = make_multifile_torrent([2 * PLEN, 2 * PLEN])
            await t.select_files([0])
            t.state = TorrentState.DOWNLOADING
            t.bitfield.set(0)
            t.bitfield.set(1)
            await t._maybe_completed()
            assert t.state == TorrentState.SEEDING
            assert t.on_complete.is_set()
            assert t.left == 0

        run(go())

    def test_default_mask_unchanged_behavior(self):
        async def go():
            t, _ = make_multifile_torrent([2 * PLEN, 2 * PLEN])
            t.state = TorrentState.DOWNLOADING
            for i in range(3):
                t.bitfield.set(i)
            await t._maybe_completed()
            assert t.state == TorrentState.DOWNLOADING  # piece 3 still missing
            t.bitfield.set(3)
            await t._maybe_completed()
            assert t.state == TorrentState.SEEDING

        run(go())


class TestSequentialMode:
    def test_sequential_orders_by_index(self):
        async def go():
            t, _ = make_multifile_torrent([4 * PLEN])
            t.config.sequential = True
            t._avail[:] = [1, 9, 9, 1]  # rarity says 0 and 3 first
            t._rebuild_rarity()
            assert t._rarity_order == [0, 1, 2, 3]
            # priorities still outrank the sequential order
            await t.set_file_priorities({0: 1})
            t.bitfield.set(0)
            t._piece_priority[3] = 5
            t._rebuild_rarity()
            assert t._rarity_order == [3, 1, 2]

        run(go())

    def test_rarest_first_default(self):
        async def go():
            t, _ = make_multifile_torrent([4 * PLEN])
            t._avail[:] = [9, 1, 9, 1]
            t._rebuild_rarity()
            assert set(t._rarity_order[:2]) == {1, 3}

        run(go())
