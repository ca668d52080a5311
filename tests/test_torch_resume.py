"""Fastresume checkpoints + BEP 12 multitracker tests."""

import asyncio

import numpy as np
import pytest

from torrent_tpu_torch.codec.bencode import bdecode, bencode
from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.net.multitracker import TrackerList, parse_announce_list
from torrent_tpu_torch.net.tracker import TrackerError
from torrent_tpu_torch.net.types import AnnounceInfo, AnnounceResponse
from torrent_tpu_torch.session.client import generate_peer_id
from torrent_tpu_torch.session.resume import (
    FsResumeStore,
    MemoryResumeStore,
    ResumeData,
)
from torrent_tpu_torch.session.torrent import Torrent, TorrentConfig
from torrent_tpu_torch.storage.storage import MemoryStorage, Storage

from tests.test_torch_session import build_torrent_bytes, fast_config


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class TestResumeData:
    def test_roundtrip(self):
        rd = ResumeData(
            info_hash=bytes(20), num_pieces=12, bitfield=b"\xff\xf0", uploaded=5, downloaded=9
        )
        back = ResumeData.decode(rd.encode())
        assert back == rd

    @pytest.mark.parametrize(
        "mutate",
        [
            lambda d: d.__setitem__(b"version", 99),
            lambda d: d.__setitem__(b"info_hash", b"short"),
            lambda d: d.pop(b"bitfield"),
            lambda d: d.__setitem__(b"bitfield", b"\xff"),  # wrong size
            lambda d: d.__setitem__(b"bitfield", b"\xff\xff"),  # spare bits
        ],
    )
    def test_rejects_bad_data(self, mutate):
        rd = ResumeData(info_hash=bytes(20), num_pieces=12, bitfield=b"\xff\xf0")
        d = bdecode(rd.encode())
        mutate(d)
        assert ResumeData.decode(bencode(d)) is None

    def test_rejects_garbage(self):
        assert ResumeData.decode(b"not bencode") is None


class TestFsResumeStore:
    def test_save_load_delete(self, tmp_path):
        store = FsResumeStore(tmp_path)
        rd = ResumeData(info_hash=b"\x01" * 20, num_pieces=8, bitfield=b"\xaa")
        store.save(rd)
        assert store.load(b"\x01" * 20) == rd
        assert store.load(b"\x02" * 20) is None
        store.delete(b"\x01" * 20)
        assert store.load(b"\x01" * 20) is None

    def test_atomic_overwrite(self, tmp_path):
        store = FsResumeStore(tmp_path)
        h = b"\x03" * 20
        store.save(ResumeData(info_hash=h, num_pieces=8, bitfield=b"\x00"))
        store.save(ResumeData(info_hash=h, num_pieces=8, bitfield=b"\xff"))
        assert store.load(h).bitfield == b"\xff"


def make_torrent_with_store(store, payload_len=131072, piece_len=32768, write_payload=True):
    rng = np.random.default_rng(31)
    payload = rng.integers(0, 256, size=payload_len, dtype=np.uint8).tobytes()
    m = parse_metainfo(build_torrent_bytes(payload, piece_len, b"http://127.0.0.1:1/announce"))
    storage = Storage(MemoryStorage(), m.info)
    if write_payload:
        for off in range(0, payload_len, 65536):
            storage.set(off, payload[off : off + 65536])
    t = Torrent(
        metainfo=m,
        storage=storage,
        peer_id=generate_peer_id(),
        port=1,
        config=fast_config(),
        resume_store=store,
    )
    return t, m, payload


class TestTorrentFastresume:
    def test_checkpoint_then_fastresume_skips_recheck(self):
        async def go():
            store = MemoryResumeStore()
            t, m, payload = make_torrent_with_store(store)
            await t.recheck()
            assert t.bitfield.complete
            t.uploaded = 777
            t._checkpoint()

            # new session over the same storage: must fastresume, not rehash
            t2 = Torrent(
                metainfo=m,
                storage=t.storage,
                peer_id=generate_peer_id(),
                port=1,
                config=fast_config(),
                resume_store=store,
            )
            called = []
            t2.recheck = lambda: called.append(1)  # would fail if awaited
            assert t2._try_fastresume() is True
            assert t2.bitfield.complete and t2.uploaded == 777
            assert not called

        run(go())

    def test_partial_pieces_survive_restart(self):
        """Blocks of an in-flight piece at checkpoint time are re-ingested
        on fastresume: the restarted session finishes the piece from the
        missing blocks only, and verification still gates persistence."""
        from torrent_tpu_torch.session.torrent import _PartialPiece
        from torrent_tpu_torch.storage.piece import BLOCK_SIZE

        async def go():
            store = MemoryResumeStore()
            # payload NOT on disk: a fresh leech mid-download
            t, m, payload = make_torrent_with_store(store, write_payload=False)
            plen = m.info.piece_length
            # piece 1 partially received: blocks 0 (16 KiB each)
            partial = _PartialPiece(index=1, length=plen, buffer=bytearray(plen))
            blk0 = payload[plen : plen + BLOCK_SIZE]
            partial.buffer[0:BLOCK_SIZE] = blk0
            partial.received.add(0)
            t._partials[1] = partial
            t._checkpoint(include_partials=True)

            t2 = Torrent(
                metainfo=m,
                storage=t.storage,
                peer_id=generate_peer_id(),
                port=1,
                config=fast_config(),
                resume_store=store,
            )
            assert t2._try_fastresume() is True
            assert 1 in t2._partials
            p = t2._partials[1]
            assert p.received == {0}
            assert bytes(p.buffer[0:BLOCK_SIZE]) == blk0
            # feed the remaining block via the real ingest path: the piece
            # must complete AND verify from the mixed resumed+wire data
            from tests.test_torch_session_fast import _mk_fast_peer

            peer = _mk_fast_peer(t2)
            await t2._ingest_block(
                peer, 1, BLOCK_SIZE, payload[plen + BLOCK_SIZE : 2 * plen]
            )
            assert t2.bitfield.has(1)
            assert t2.storage.get(plen, plen) == payload[plen : 2 * plen]

            # corrupted resumed data must NOT survive verification
            t3, m3, payload3 = make_torrent_with_store(
                MemoryResumeStore(), write_payload=False
            )
            bad = _PartialPiece(index=0, length=plen, buffer=bytearray(plen))
            bad.received.add(0)  # zeros, not the real bytes
            t3._partials[0] = bad
            t3._checkpoint(include_partials=True)
            t4 = Torrent(
                metainfo=m3,
                storage=t3.storage,
                peer_id=generate_peer_id(),
                port=1,
                config=fast_config(),
                resume_store=t3.resume_store,
            )
            assert t4._try_fastresume() is True
            peer4 = _mk_fast_peer(t4)
            await t4._ingest_block(peer4, 0, BLOCK_SIZE, payload3[BLOCK_SIZE:plen])
            assert not t4.bitfield.has(0)  # hash rejected the poisoned mix

        run(go())

    def test_complete_partial_never_resumes(self):
        """A checkpoint carrying an all-blocks-received partial (old or
        foreign file) must be dropped at re-ingest: nothing would ever
        trigger _finish_piece for it and the download would stall."""
        from torrent_tpu_torch.session.resume import ResumeData
        from torrent_tpu_torch.storage.piece import BLOCK_SIZE

        async def go():
            store = MemoryResumeStore()
            t, m, payload = make_torrent_with_store(store, write_payload=False)
            plen = m.info.piece_length
            n_blocks = plen // BLOCK_SIZE
            mask = bytearray((n_blocks + 7) // 8)
            for b in range(n_blocks):
                mask[b // 8] |= 1 << (b % 8)
            store.save(
                ResumeData(
                    info_hash=m.info_hash,
                    num_pieces=m.info.num_pieces,
                    bitfield=bytes((m.info.num_pieces + 7) // 8),
                    partials={0: (bytes(mask), payload[:plen])},
                )
            )
            t2 = Torrent(
                metainfo=m,
                storage=t.storage,
                peer_id=generate_peer_id(),
                port=1,
                config=fast_config(),
                resume_store=store,
            )
            assert t2._try_fastresume() is True
            assert 0 not in t2._partials  # dropped, will re-fetch

        run(go())

    def test_periodic_checkpoint_stays_small(self):
        """The every-16-pieces checkpoint must NOT serialize partial
        buffers (megabytes of copy/bencode on the event loop) — only the
        stop-time checkpoint carries them."""
        from torrent_tpu_torch.session.torrent import _PartialPiece

        async def go():
            store = MemoryResumeStore()
            t, m, _ = make_torrent_with_store(store, write_payload=False)
            plen = m.info.piece_length
            p = _PartialPiece(index=0, length=plen, buffer=bytearray(plen))
            p.received.add(0)
            t._partials[0] = p
            t._checkpoint()  # periodic form
            assert not store.load(m.info_hash).partials
            t._checkpoint(include_partials=True)  # stop form
            assert 0 in store.load(m.info_hash).partials

        run(go())

    def test_partials_dropped_on_geometry_or_corruption(self):
        from torrent_tpu_torch.session.resume import ResumeData

        rd = ResumeData(
            info_hash=b"\x01" * 20,
            num_pieces=4,
            bitfield=b"\x00",
            partials={2: (b"\x01", b"\x00" * 999)},  # wrong piece length
        )
        raw = rd.encode()
        back = ResumeData.decode(raw)
        assert back is not None and 2 in back.partials
        # corrupt partial section → whole checkpoint rejected (recheck path)
        from torrent_tpu_torch.codec.bencode import bdecode, bencode

        d = bdecode(raw)
        d[b"partials"][b"2"][b"mask"] = 7  # type confusion
        assert ResumeData.decode(bencode(d)) is None

    def test_missing_files_fall_back_to_recheck(self):
        async def go():
            store = MemoryResumeStore()
            t, m, _ = make_torrent_with_store(store)
            await t.recheck()
            t._checkpoint()
            # same checkpoint, but storage is empty now
            empty = Storage(MemoryStorage(), m.info)
            t2 = Torrent(
                metainfo=m,
                storage=empty,
                peer_id=generate_peer_id(),
                port=1,
                config=fast_config(),
                resume_store=store,
            )
            assert t2._try_fastresume() is False

        run(go())

    def test_geometry_mismatch_rejected(self):
        async def go():
            store = MemoryResumeStore()
            t, m, _ = make_torrent_with_store(store)
            store.save(
                ResumeData(info_hash=m.info_hash, num_pieces=999, bitfield=b"\x00" * 125)
            )
            assert t._try_fastresume() is False

        run(go())


class TestMultitracker:
    def test_parse_announce_list(self):
        raw = {
            b"announce-list": [
                [b"http://a/announce", b"http://b/announce"],
                [b"udp://c:80"],
                b"not-a-tier",
                [123],
            ]
        }
        tiers = parse_announce_list(raw)
        assert tiers == [["http://a/announce", "http://b/announce"], ["udp://c:80"]]
        assert parse_announce_list({}) is None

    def test_single_announce_fallback(self):
        tl = TrackerList("http://only/announce", None)
        assert tl.tiers == [["http://only/announce"]]

    def test_failover_and_promotion(self, monkeypatch):
        calls = []

        async def fake_announce(url, info, proxy=None):
            calls.append(url)
            if "bad" in url:
                raise TrackerError("down")
            return AnnounceResponse(interval=60)

        import torrent_tpu_torch.net.multitracker as mt

        monkeypatch.setattr(mt, "announce", fake_announce)
        tl = TrackerList(
            "http://bad1/announce",
            [["http://bad1/announce"], ["http://bad2/announce", "http://good/announce"]],
        )
        # force deterministic order within tier 2
        tl.tiers[1] = ["http://bad2/announce", "http://good/announce"]
        info = AnnounceInfo(info_hash=bytes(20), peer_id=b"p" * 20, port=1)

        res = run(tl.announce(info))
        assert res.interval == 60
        assert calls == ["http://bad1/announce", "http://bad2/announce", "http://good/announce"]
        # responding tracker promoted to front of its tier
        assert tl.tiers[1][0] == "http://good/announce"

        calls.clear()
        run(tl.announce(info))
        assert calls[1] == "http://good/announce"  # tried right after tier 1

    def test_all_fail(self, monkeypatch):
        async def fake_announce(url, info, proxy=None):
            raise TrackerError("nope")

        import torrent_tpu_torch.net.multitracker as mt

        monkeypatch.setattr(mt, "announce", fake_announce)
        tl = TrackerList("http://x/announce", None)
        info = AnnounceInfo(info_hash=bytes(20), peer_id=b"p" * 20, port=1)
        with pytest.raises(TrackerError, match="all trackers failed"):
            run(tl.announce(info))

    def test_torrent_uses_announce_list(self):
        # metainfo with announce-list must feed the TrackerList tiers
        data = bdecode(build_torrent_bytes(b"\x01" * 50_000, 16384, b"http://primary/announce"))
        data[b"announce-list"] = [[b"http://t1/announce"], [b"http://t2/announce"]]
        m = parse_metainfo(bencode(data))
        t = Torrent(
            metainfo=m,
            storage=Storage(MemoryStorage(), m.info),
            peer_id=generate_peer_id(),
            port=1, config=TorrentConfig(hasher="cpu"),
        )
        flat = [u for tier in t.trackers.tiers for u in tier]
        assert "http://t1/announce" in flat and "http://t2/announce" in flat
        assert "http://primary/announce" in flat  # fallback tier


class TestReviewRegressions:
    def test_truncated_file_fails_fastresume(self):
        async def go():
            store = MemoryResumeStore()
            t, m, payload = make_torrent_with_store(store)
            await t.recheck()
            t._checkpoint()
            # same method but the file is truncated short of the last piece
            short = Storage(MemoryStorage(), m.info)
            short.method.set(("t31",), 0, payload[: len(payload) - 1000])
            # name differs; write under the real name
            name = (m.info.name,)
            short.method.files.clear()
            short.method.set(name, 0, payload[: len(payload) - 1000])
            t2 = Torrent(
                metainfo=m,
                storage=short,
                peer_id=generate_peer_id(),
                port=1,
                config=fast_config(),
                resume_store=store,
            )
            assert t2._try_fastresume() is False

        run(go())

    def test_bad_bitfield_does_not_skew_availability(self):
        async def go():
            from torrent_tpu_torch.net import protocol as proto
            from torrent_tpu_torch.session.peer import PeerConnection

            t, m, _ = make_torrent_with_store(None, write_payload=False)

            class W:
                def close(self):
                    pass

                def is_closing(self):
                    return False

                def write(self, data):
                    pass

                async def drain(self):
                    pass

            peer = PeerConnection(
                peer_id=b"p" * 20, reader=None, writer=W(), num_pieces=m.info.num_pieces
            )
            t.peers[peer.peer_id] = peer
            # peer claims piece 1 via have
            await t._handle_message(peer, proto.Have(index=1))
            assert t._avail[1] == 1
            # then sends a malformed bitfield → ProtocolError
            with pytest.raises(proto.ProtocolError):
                await t._handle_message(peer, proto.BitfieldMsg(raw=b"\xff"))
            # handler must not have touched availability; drop decrements once
            assert t._avail[1] == 1
            t._drop_peer(peer)
            assert t._avail[1] == 0

        run(go())

    def test_udp_dns_failure_is_tracker_error(self):
        from torrent_tpu_torch.net.tracker import announce as raw_announce

        info = AnnounceInfo(info_hash=bytes(20), peer_id=b"p" * 20, port=1)
        with pytest.raises(TrackerError, match="unreachable|failed"):
            run(raw_announce("udp://definitely-not-a-host.invalid:6969", info))
