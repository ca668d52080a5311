"""BEP 54 lt_donthave: retracting an announced piece.

The reference's wire layer stops at BEP 3's nine messages
(protocol.ts:69-161), which cannot unsay a Have. BEP 54 adds the
inverse message; here it also powers serve-path self-healing — a seed
whose disk loses an announced piece drops it, tells capable peers, and
re-downloads it instead of refusing requests forever.
"""

import asyncio
import errno

import pytest

from torrent_tpu_torch.net import extension as ext
from torrent_tpu_torch.net import protocol as proto
from torrent_tpu_torch.session.peer import PeerConnection
from torrent_tpu_torch.session.torrent import TorrentState
from torrent_tpu_torch.storage.storage import StorageError

from tests.test_torch_session_fast import _messages
from tests.test_torch_resume import make_torrent_with_store
from tests.test_torch_session import _FakeWriter


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def make_peer(num_pieces, donthave_id=0, peer_id=b"q" * 20):
    p = PeerConnection(
        peer_id=peer_id, reader=None, writer=_FakeWriter(), num_pieces=num_pieces
    )
    p.ext.enabled = True
    p.ext.handshaken = True
    p.ext.lt_donthave_id = donthave_id
    return p


class TestCodec:
    def test_roundtrip(self):
        for idx in (0, 1, 7, 2**31):
            assert ext.decode_donthave(ext.encode_donthave(idx)) == idx

    def test_malformed(self):
        assert ext.decode_donthave(b"") is None
        assert ext.decode_donthave(b"\x00\x01\x02") is None
        assert ext.decode_donthave(b"\x00\x01\x02\x03\x04") is None

    def test_handshake_negotiation(self):
        payload = ext.encode_extended_handshake()
        st = ext.ExtensionState(enabled=True)
        ext.decode_extended_handshake(payload, st)
        assert st.lt_donthave_id == ext.LOCAL_EXT_IDS[ext.LT_DONTHAVE]

    def test_handshake_without_it(self):
        from torrent_tpu_torch.codec.bencode import bencode

        st = ext.ExtensionState(enabled=True)
        ext.decode_extended_handshake(bencode({b"m": {}}), st)
        assert st.lt_donthave_id == 0


class TestReceive:
    def test_clears_peer_bit_and_availability(self):
        async def go():
            t, m, _ = make_torrent_with_store(None, write_payload=False)
            peer = make_peer(m.info.num_pieces)
            t.peers[peer.peer_id] = peer
            await t._handle_message(peer, proto.Have(index=1))
            assert t._avail[1] == 1 and peer.am_interested
            await t._handle_extended(
                peer, ext.LOCAL_EXT_IDS[ext.LT_DONTHAVE], ext.encode_donthave(1)
            )
            assert t._avail[1] == 0
            assert not peer.bitfield.has(1)
            # the only piece it had is gone: interest must flip off
            assert not peer.am_interested

        run(go())

    def test_releases_inflight_blocks_of_retracted_piece(self):
        async def go():
            t, m, _ = make_torrent_with_store(None, write_payload=False)
            peer = make_peer(m.info.num_pieces)
            t.peers[peer.peer_id] = peer
            blk_kept = (2, 0, 16384)
            blk_lost = (1, 0, 16384)
            for blk in (blk_kept, blk_lost):
                peer.inflight.add(blk)
                t._inflight_count[blk] += 1
            peer.bitfield.set(1)
            peer.bitfield.set(2)
            t._avail[1] += 1
            t._avail[2] += 1
            await t._handle_extended(
                peer, ext.LOCAL_EXT_IDS[ext.LT_DONTHAVE], ext.encode_donthave(1)
            )
            # a non-fast BEP 54 peer sends no rejects — the retracted
            # piece's blocks must free up for other peers immediately
            assert blk_lost not in peer.inflight
            assert t._inflight_count[blk_lost] == 0
            assert blk_kept in peer.inflight
            assert t._inflight_count[blk_kept] == 1

        run(go())

    def test_ignores_out_of_range_and_unowned(self):
        async def go():
            t, m, _ = make_torrent_with_store(None, write_payload=False)
            peer = make_peer(m.info.num_pieces)
            t.peers[peer.peer_id] = peer
            for payload in (
                ext.encode_donthave(m.info.num_pieces),  # out of range
                ext.encode_donthave(2),  # never announced
                b"\x01",  # malformed
            ):
                await t._handle_extended(
                    peer, ext.LOCAL_EXT_IDS[ext.LT_DONTHAVE], payload
                )
            assert (t._avail == 0).all()

        run(go())


class TestPieceLossSelfHealing:
    def test_serve_failure_drops_piece_and_broadcasts(self):
        async def go():
            t, m, _ = make_torrent_with_store(None)
            await t.recheck()
            assert t.bitfield.complete
            t.state = TorrentState.SEEDING
            t.on_complete.set()

            capable = make_peer(m.info.num_pieces, donthave_id=9)
            capable.am_choking = False
            capable.fast = True
            # distinct peer_id: _piece_lost's stale-peer guard looks the
            # broadcast target up by id, so a shared id would skip the
            # legacy peer and make its no-Extended assertion vacuous
            legacy = make_peer(m.info.num_pieces, peer_id=b"r" * 20)
            t.peers[capable.peer_id] = capable
            t.peers[legacy.peer_id] = legacy

            def boom(index):
                raise StorageError(f"bad sector under piece {index}")

            t.storage.read_piece = boom
            await t._serve_request(capable, 1, 0, 16384)

            # the piece is re-wanted and the session fell back to downloading
            assert not t.bitfield.has(1)
            assert t.state == TorrentState.DOWNLOADING
            assert not t.on_complete.is_set()

            sent = _messages(bytes(capable.writer.data))
            assert any(
                isinstance(f, proto.Extended)
                and f.ext_id == 9
                and ext.decode_donthave(f.payload) == 1
                for f in sent
            ), sent
            # BEP 6: the in-flight request is rejected explicitly
            assert any(isinstance(f, proto.RejectRequest) for f in sent), sent
            # the legacy peer got no Extended frame (nothing to say in BEP 3)
            assert not any(
                isinstance(f, proto.Extended)
                for f in _messages(bytes(legacy.writer.data))
            )

        run(go())

    def test_transient_serve_error_retries_without_piece_loss(self):
        """fd exhaustion under fanout (EMFILE) is not piece loss: the
        serve path retries once and the piece survives (advisor r3)."""

        async def go():
            t, m, _ = make_torrent_with_store(None)
            await t.recheck()
            t.state = TorrentState.SEEDING
            t.on_complete.set()
            peer = make_peer(m.info.num_pieces)
            peer.am_choking = False
            peer.fast = True
            t.peers[peer.peer_id] = peer

            real = t.storage.read_piece
            calls = []

            def flaky(index):
                calls.append(index)
                if len(calls) == 1:
                    try:
                        raise OSError(errno.EMFILE, "too many open files")
                    except OSError as e:
                        raise StorageError("read failed") from e
                return real(index)

            t.storage.read_piece = flaky
            await t._serve_request(peer, 1, 0, 16384)

            assert calls == [1, 1]  # exactly one retry
            assert t.bitfield.has(1)  # NOT retracted
            assert t.state == TorrentState.SEEDING
            sent = _messages(bytes(peer.writer.data))
            assert any(isinstance(f, proto.Piece) for f in sent), sent

        run(go())

    def test_persistent_error_still_self_heals_after_one_retry(self):
        async def go():
            t, m, _ = make_torrent_with_store(None)
            await t.recheck()
            t.state = TorrentState.SEEDING
            peer = make_peer(m.info.num_pieces)
            peer.am_choking = False
            peer.fast = True
            t.peers[peer.peer_id] = peer
            calls = []

            def always_bad(index):
                calls.append(index)
                try:
                    raise OSError(errno.EIO, "i/o error")
                except OSError as e:
                    raise StorageError("read failed") from e

            t.storage.read_piece = always_bad
            await t._serve_request(peer, 1, 0, 16384)
            assert calls == [1, 1]  # retried, then gave up
            assert not t.bitfield.has(1)
            assert t.state == TorrentState.DOWNLOADING

        run(go())

    def test_missing_file_is_permanent_no_retry(self):
        async def go():
            t, m, _ = make_torrent_with_store(None)
            await t.recheck()
            t.state = TorrentState.SEEDING
            peer = make_peer(m.info.num_pieces)
            peer.am_choking = False
            peer.fast = True
            t.peers[peer.peer_id] = peer
            calls = []

            def gone(index):
                calls.append(index)
                try:
                    raise OSError(errno.ENOENT, "no such file")
                except OSError as e:
                    raise StorageError("no such file") from e

            t.storage.read_piece = gone
            await t._serve_request(peer, 1, 0, 16384)
            assert calls == [1]  # structural: no retry
            assert not t.bitfield.has(1)

        run(go())

    def test_endgame_enters_only_at_the_tail(self):
        """Mid-download contention (every peer-visible block requested
        ELSEWHERE) must not trip endgame — that floods the swarm with a
        cancel broadcast per block; at a genuine tail it must."""

        async def go():
            t, m, _ = make_torrent_with_store(
                None, payload_len=32768 * 24, piece_len=32768,
                write_payload=False,
            )
            peer = make_peer(m.info.num_pieces)
            peer.peer_choking = False
            for i in range(m.info.num_pieces):
                peer.bitfield.set(i)
            t.peers[peer.peer_id] = peer
            # every block is in flight on some OTHER connection
            for i in range(m.info.num_pieces):
                for blk in t._blocks_of(i):
                    t._inflight_add(blk)
            await t._fill_pipeline(peer)
            assert not t._endgame  # 24 wanted pieces: contention, not tail
            assert not peer.inflight
            assert peer.fill_starved

            # now a genuine tail: all but 2 pieces verified
            for i in range(m.info.num_pieces - 2):
                t.bitfield.set(i)
            t._recount_wanted()
            peer.fill_starved = False
            await t._fill_pipeline(peer)
            assert t._endgame  # duplication kicks in
            assert peer.inflight  # duplicated requests issued

        run(go())

    def test_lost_piece_is_idempotent(self):
        async def go():
            t, m, _ = make_torrent_with_store(None)
            await t.recheck()
            await t._piece_lost(1)
            avail_marker = t.bitfield.count()
            await t._piece_lost(1)  # second loss of the same piece: no-op
            assert t.bitfield.count() == avail_marker

        run(go())

    def test_completed_reported_at_most_once(self):
        async def go():
            t, m, _ = make_torrent_with_store(None)
            await t.recheck()
            t.state = TorrentState.DOWNLOADING
            await t._maybe_completed()
            assert t._pending_completed  # first completion: owed to tracker
            t._pending_completed = False  # announce loop sent it

            await t._piece_lost(1)
            assert t.state == TorrentState.DOWNLOADING
            # piece comes back: the latch keeps a second `completed` from
            # inflating tracker snatch counts (BEP 3: at most once)
            t.bitfield.set(1)
            await t._maybe_completed()
            assert t.state == TorrentState.SEEDING
            assert not t._pending_completed

        run(go())


class TestLiveSwarmSelfHealing:
    def test_truncated_seed_heals_through_the_swarm(self, tmp_path):
        """Full-surface drive: real tracker, three real clients, a real
        disk fault. The seed's backing file is truncated under it after
        the verified add; a leech's requests trip serve-path read
        failures, the seed retracts the unreadable pieces over the wire
        (BEP 54) and falls back to downloading; an intact second seed
        then heals both — and the damaged seed's file is byte-identical
        again at the end."""

        async def go():
            import numpy as np

            from torrent_tpu_torch.session.client import Client, ClientConfig
            from tests.test_torch_session import (
                build_torrent_bytes,
                fast_config,
                start_tracker,
            )
            from torrent_tpu_torch.codec.metainfo import parse_metainfo

            rng = np.random.default_rng(54)
            payload = rng.integers(0, 256, size=512 * 1024, dtype=np.uint8).tobytes()
            server, pump, announce_url = await start_tracker()
            meta = parse_metainfo(
                build_torrent_bytes(payload, 32768, announce_url.encode(), name=b"heal.bin")
            )

            for d in ("seed1", "seed2", "leech"):
                (tmp_path / d).mkdir()
            (tmp_path / "seed1" / "heal.bin").write_bytes(payload)
            (tmp_path / "seed2" / "heal.bin").write_bytes(payload)

            cfg = lambda: ClientConfig(hasher="cpu", host="127.0.0.1", enable_upnp=False)
            seed1, seed2, leech = Client(cfg()), Client(cfg()), Client(cfg())
            for c in (seed1, seed2, leech):
                c.config.torrent = fast_config()
                await c.start()
            try:
                t1 = await seed1.add(meta, str(tmp_path / "seed1"))
                assert t1.bitfield.complete  # verified intact at add time

                # the disk fault: half the file vanishes UNDER the
                # running seed (cached fds now see short reads)
                import os

                os.truncate(tmp_path / "seed1" / "heal.bin", 256 * 1024)

                tl = await leech.add(meta, str(tmp_path / "leech"))
                # the leech can only reach pieces the damaged seed can
                # still read; the unreadable ones must be retracted, not
                # refused forever — observed as the seed leaving SEEDING
                for _ in range(300):
                    if t1.state == TorrentState.DOWNLOADING:
                        break
                    await asyncio.sleep(0.05)
                assert t1.state == TorrentState.DOWNLOADING
                assert not t1.bitfield.complete

                # the healer arrives: everyone converges
                t2 = await seed2.add(meta, str(tmp_path / "seed2"))
                assert t2.bitfield.complete
                await asyncio.wait_for(tl.on_complete.wait(), 60)
                await asyncio.wait_for(t1.on_complete.wait(), 60)
                # the damaged seed repaired its own file on disk
                assert (tmp_path / "seed1" / "heal.bin").read_bytes() == payload
            finally:
                for c in (seed1, seed2, leech):
                    await c.close()
                server.close()
                pump.cancel()

        run(go(), timeout=120)


class TestCompletedLatchAcrossRestart:
    def test_resumed_complete_torrent_never_reannounces_completed(self):
        """BEP 3: a torrent that starts complete (fastresume or recheck)
        owes the tracker no `completed` — not even after a BEP 54 piece
        loss and re-fetch in the new session."""

        async def go():
            from torrent_tpu_torch.session.client import generate_peer_id
            from torrent_tpu_torch.session.resume import MemoryResumeStore
            from torrent_tpu_torch.session.torrent import Torrent
            from tests.test_torch_session import fast_config

            store = MemoryResumeStore()
            t, m, _ = make_torrent_with_store(store)
            await t.recheck()
            t._checkpoint()

            t2 = Torrent(
                metainfo=m,
                storage=t.storage,
                peer_id=generate_peer_id(),
                port=1,
                config=fast_config(),
                resume_store=store,
            )
            await t2.start()
            try:
                assert t2.bitfield.complete
                assert t2._completed_reported  # latched by complete start
                await t2._piece_lost(1)
                t2.bitfield.set(1)
                await t2._maybe_completed()
                assert t2.state == TorrentState.SEEDING
                assert not t2._pending_completed
            finally:
                await t2.stop()

        run(go())

    def test_restart_mid_heal_remembers_completed_was_sent(self):
        """A checkpoint taken BETWEEN a piece loss and its re-fetch holds
        an incomplete bitfield — the sent-`completed` fact must ride the
        checkpoint itself, or the restarted session re-announces it."""

        async def go():
            from torrent_tpu_torch.session.client import generate_peer_id
            from torrent_tpu_torch.session.resume import MemoryResumeStore
            from torrent_tpu_torch.session.torrent import Torrent
            from tests.test_torch_session import fast_config

            store = MemoryResumeStore()
            t, m, _ = make_torrent_with_store(store)
            await t.recheck()
            t.state = TorrentState.DOWNLOADING
            await t._maybe_completed()  # the one real completion
            assert t._completed_reported
            t._pending_completed = False  # announce loop sent it
            await t._piece_lost(1)  # checkpoints the incomplete bitfield

            t2 = Torrent(
                metainfo=m,
                storage=t.storage,
                peer_id=generate_peer_id(),
                port=1,
                config=fast_config(),
                resume_store=store,
            )
            assert t2._try_fastresume()
            assert not t2.bitfield.complete  # restarted mid-heal
            assert t2._completed_reported  # carried by the checkpoint
            t2.bitfield.set(1)
            t2.state = TorrentState.DOWNLOADING
            await t2._maybe_completed()
            assert t2.state == TorrentState.SEEDING
            assert not t2._pending_completed  # no second `completed`

        run(go())


class TestDhtReadOnlyPlumbing:
    def test_client_config_reaches_dht_node(self):
        async def go():
            from torrent_tpu_torch.session.client import Client, ClientConfig

            c = Client(
                ClientConfig(
                    host="127.0.0.1",
                    enable_upnp=False,
                    enable_dht=True,
                    dht_read_only=True, hasher="cpu",
                )
            )
            await c.start()
            try:
                assert c.dht is not None and c.dht.read_only
            finally:
                await c.close()

        run(go())


class TestSeedLoopReentrancy:
    def test_respawn_does_not_stack_webseed_loops(self):
        async def go():
            t, m, _ = make_torrent_with_store(None, write_payload=False)
            t.web_seed_urls = ["http://127.0.0.1:1/ws"]
            t._spawn_seed_loops()
            await asyncio.sleep(0)  # let the loop start (then hit backoff)
            t._spawn_seed_loops()  # piece-loss / selection re-open path
            t._spawn_seed_loops()
            alive = [
                task
                for task in t._tasks
                if not task.done() and (task.get_name() or "").startswith("webseed-")
            ]
            assert len(alive) == 1, alive
            for task in alive:
                task.cancel()

        run(go())


class TestCompletedOwedSurvivesCrash:
    def test_queued_but_unsent_completed_is_redelivered(self):
        """Crash between queuing `completed` and the tracker receiving it:
        the restarted session still owes the event (and only that one)."""

        async def go():
            from torrent_tpu_torch.session.client import generate_peer_id
            from torrent_tpu_torch.session.resume import MemoryResumeStore
            from torrent_tpu_torch.session.torrent import Torrent
            from tests.test_torch_session import fast_config

            store = MemoryResumeStore()
            t, m, _ = make_torrent_with_store(store)
            await t.recheck()
            t.state = TorrentState.DOWNLOADING
            await t._maybe_completed()  # queues + checkpoints; announce never runs
            assert t._pending_completed

            def restarted():
                return Torrent(
                    metainfo=m,
                    storage=t.storage,
                    peer_id=generate_peer_id(),
                    port=1,
                    config=fast_config(),
                    resume_store=store,
                )

            t2 = restarted()
            assert t2._try_fastresume()
            assert t2._pending_completed  # still owed after the crash
            assert t2._completed_reported  # but never owed TWICE

            # tracker finally gets it: the announce path clears + persists
            t2._pending_completed = False
            t2._checkpoint()
            t3 = restarted()
            assert t3._try_fastresume()
            assert not t3._pending_completed

        run(go())
