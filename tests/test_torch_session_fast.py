"""BEP 6 fast-extension tests: wire codec, allowed-fast sets, session
semantics (serve-while-choked, explicit rejects, have_all/have_none).

The reference implements only the nine BEP 3 messages
(protocol.ts:202-209); everything here is beyond-parity surface.
"""

import asyncio

import numpy as np
import pytest

from torrent_tpu_torch.net import protocol as proto
from torrent_tpu_torch.session.peer import PeerConnection
from torrent_tpu_torch.session.torrent import _PartialPiece  # noqa: F401 (harness parity)
from tests.test_torch_session import _FakeWriter, run
from tests.test_torch_session import TestSchedulerUnits as _SchedulerHarness


def _messages(buf: bytes):
    """Decode every queued frame in a fake writer's buffer."""
    out, pos = [], 0
    while pos < len(buf):
        length = int.from_bytes(buf[pos : pos + 4], "big")
        pos += 4
        if length == 0:
            out.append(proto.KeepAlive())
            continue
        body = buf[pos : pos + length]
        pos += length
        out.append(proto.decode_message(body[0], body[1:]))
    return out


class TestWireCodec:
    def test_roundtrips(self):
        for msg in [
            proto.SuggestPiece(7),
            proto.HaveAll(),
            proto.HaveNone(),
            proto.RejectRequest(1, 16384, 16384),
            proto.AllowedFast(0),
        ]:
            enc = proto.encode_message(msg)
            assert proto.decode_message(enc[4], enc[5:]) == msg

    def test_malformed_payloads_raise(self):
        with pytest.raises(proto.ProtocolError):
            proto.decode_message(int(proto.MsgId.HAVE_ALL), b"x")
        with pytest.raises(proto.ProtocolError):
            proto.decode_message(int(proto.MsgId.REJECT_REQUEST), b"\0" * 11)
        with pytest.raises(proto.ProtocolError):
            proto.decode_message(int(proto.MsgId.ALLOWED_FAST), b"\0" * 5)

    def test_reserved_bits(self):
        assert proto.supports_fast(proto.fast_reserved())
        assert not proto.supports_fast(b"\x00" * 8)
        merged = proto.merge_reserved(proto.fast_reserved(), b"\x00" * 5 + b"\x10\x00\x00")
        assert proto.supports_fast(merged)
        assert merged[5] == 0x10  # BEP 10 bit survives the merge


class TestAllowedFastSet:
    def test_deterministic_and_in_range(self):
        a = proto.allowed_fast_set("80.4.4.200", b"\xaa" * 20, 1313, 7)
        b = proto.allowed_fast_set("80.4.4.200", b"\xaa" * 20, 1313, 7)
        assert a == b and len(a) == 7 and len(set(a)) == 7
        assert all(0 <= i < 1313 for i in a)

    def test_slash24_masking(self):
        # same /24 → same set; different /24 → (overwhelmingly) different
        a = proto.allowed_fast_set("80.4.4.200", b"\xaa" * 20, 1313, 7)
        same = proto.allowed_fast_set("80.4.4.7", b"\xaa" * 20, 1313, 7)
        other = proto.allowed_fast_set("80.4.5.200", b"\xaa" * 20, 1313, 7)
        assert a == same
        assert a != other

    def test_k_clamped_to_piece_count(self):
        s = proto.allowed_fast_set("10.0.0.1", b"\x01" * 20, 3, 10)
        assert sorted(s) == [0, 1, 2]

    def test_bad_ip_and_ipv6(self):
        assert proto.allowed_fast_set("not-an-ip", b"\x01" * 20, 8, 4) == []
        v6 = proto.allowed_fast_set("2001:db8::1", b"\x01" * 20, 100, 5)
        same64 = proto.allowed_fast_set("2001:db8::ffff", b"\x01" * 20, 100, 5)
        assert v6 == same64 and len(v6) == 5


def _mk_fast_peer(t, pid=b"P" * 20, addr=("10.1.2.3", 6881)):
    peer = PeerConnection(
        peer_id=pid,
        reader=object(),
        writer=_FakeWriter(),
        num_pieces=t.info.num_pieces,
        address=addr,
    )
    peer.fast = True
    t.peers[pid] = peer
    t._avail += peer.bitfield.as_numpy()
    return peer


class TestSessionSemantics:
    def test_add_peer_sends_have_all_and_grants(self):
        async def go():
            t, _ = _SchedulerHarness().make_torrent()
            for i in range(t.info.num_pieces):
                t.bitfield.set(i)
            w = _FakeWriter()
            await t.add_peer(
                b"Q" * 20,
                object(),
                w,
                address=("10.5.5.5", 6881),
                reserved=proto.fast_reserved(),
            )
            msgs = _messages(bytes(w.data))
            assert msgs[0] == proto.HaveAll()
            grants = [m for m in msgs if isinstance(m, proto.AllowedFast)]
            expect = proto.allowed_fast_set(
                "10.5.5.5", t.metainfo.info_hash, t.info.num_pieces
            )
            assert [g.index for g in grants] == expect
            assert t.peers[b"Q" * 20].allowed_fast_out == set(expect)

        run(go())

    def test_add_peer_sends_have_none_when_empty(self):
        async def go():
            t, _ = _SchedulerHarness().make_torrent()
            w = _FakeWriter()
            await t.add_peer(
                b"Q" * 20, object(), w, address=("10.5.5.5", 1), reserved=proto.fast_reserved()
            )
            msgs = _messages(bytes(w.data))
            assert msgs[0] == proto.HaveNone()
            # legacy peer still gets the raw bitfield
            w2 = _FakeWriter()
            await t.add_peer(b"R" * 20, object(), w2, address=("10.5.5.6", 1))
            assert isinstance(_messages(bytes(w2.data))[0], proto.BitfieldMsg)

        run(go())

    def test_have_all_updates_availability_and_interest(self):
        async def go():
            t, _ = _SchedulerHarness().make_torrent()
            peer = _mk_fast_peer(t)
            await t._handle_message(peer, proto.HaveAll())
            assert peer.bitfield.complete
            assert (t._avail == 1).all()
            assert peer.am_interested  # we have nothing, they have all
            await t._handle_message(peer, proto.HaveNone())
            assert peer.bitfield.count() == 0
            assert (t._avail == 0).all()

        run(go())

    def test_have_all_without_fast_is_protocol_error(self):
        async def go():
            t, _ = _SchedulerHarness().make_torrent()
            peer = _mk_fast_peer(t)
            peer.fast = False
            with pytest.raises(proto.ProtocolError):
                await t._handle_message(peer, proto.HaveAll())

        run(go())

    def test_choke_keeps_requests_for_fast_peers(self):
        async def go():
            t, _ = _SchedulerHarness().make_torrent()
            peer = _mk_fast_peer(t)
            blk = (0, 0, 16384)
            peer.inflight.add(blk)
            t._inflight_count[blk] += 1
            await t._handle_message(peer, proto.Choke())
            assert blk in peer.inflight  # BEP 6: rejects come explicitly
            peer.fast = False
            peer.peer_choking = False
            await t._handle_message(peer, proto.Choke())
            assert not peer.inflight  # BEP 3: choke voids requests

        run(go())

    def test_reject_of_choked_issue_withdraws_grant(self):
        """A reject of a request issued *under the grant* burns the grant
        (otherwise the choked pipeline re-requests it forever)."""

        async def go():
            t, _ = _SchedulerHarness().make_torrent()
            peer = _mk_fast_peer(t)
            peer.peer_choking = True
            peer.allowed_fast_in.add(0)
            blk = (0, 0, 16384)
            peer.inflight.add(blk)
            peer.inflight_choked.add(blk)  # issued while choked
            t._inflight_count[blk] += 1
            await t._handle_message(peer, proto.RejectRequest(*blk))
            assert blk not in peer.inflight
            assert t._inflight_count[blk] == 0
            assert 0 not in peer.allowed_fast_in  # no re-request loop

        run(go())

    def test_reject_of_unchoked_issue_keeps_grant(self):
        """The normal BEP 6 choke flow (choke, then reject each pending
        request) must NOT destroy grants — they become useful exactly
        when the peer chokes us."""

        async def go():
            t, _ = _SchedulerHarness().make_torrent()
            peer = _mk_fast_peer(t)
            peer.bitfield.from_numpy(np.ones(t.info.num_pieces, dtype=bool))
            peer.allowed_fast_in.add(0)
            blk = (0, 0, 16384)
            peer.inflight.add(blk)  # issued back when we were unchoked
            t._inflight_count[blk] += 1
            peer.peer_choking = True  # then the peer choked us...
            await t._handle_message(peer, proto.RejectRequest(*blk))  # ...and rejects
            assert 0 in peer.allowed_fast_in
            # and the freed block was immediately re-requested under the grant
            reqs = [
                m
                for m in _messages(bytes(peer.writer.data))
                if isinstance(m, proto.Request)
            ]
            assert any(r.index == 0 for r in reqs)
            assert (0, 0, 16384) in peer.inflight_choked

        run(go())

    def test_persistent_rejector_gets_snubbed(self):
        """An unchoked fast peer that rejects every request must not spin
        the request/reject loop forever — a burst of rejects snubs it."""

        async def go():
            t, _ = _SchedulerHarness().make_torrent()
            peer = _mk_fast_peer(t)
            peer.peer_choking = False
            peer.bitfield.from_numpy(np.ones(t.info.num_pieces, dtype=bool))
            await t._fill_pipeline(peer)
            assert peer.inflight
            for _ in range(4 * t.config.pipeline_depth):
                if not peer.inflight:
                    break
                blk = next(iter(peer.inflight))
                await t._handle_message(peer, proto.RejectRequest(*blk))
            assert peer.snubbed  # the burst tripped the snub gate
            n_frames = len(peer.writer.data)
            await t._fill_pipeline(peer)  # snubbed: no fresh requests
            assert len(peer.writer.data) == n_frames

        run(go())

    def test_choked_fast_path_never_trips_endgame(self):
        """'Every granted piece is busy elsewhere' says nothing about the
        swarm; the choked pipeline must not enable global endgame."""

        async def go():
            t, _ = _SchedulerHarness().make_torrent()
            peer = _mk_fast_peer(t)
            peer.peer_choking = True
            peer.bitfield.from_numpy(np.ones(t.info.num_pieces, dtype=bool))
            peer.allowed_fast_in = {1}
            for blk in t._blocks_of(1):
                t._inflight_count[blk] += 1  # piece 1 busy on another peer
            await t._fill_pipeline(peer)
            assert not t._endgame
            assert not peer.inflight

        run(go())

    def test_have_while_choked_exercises_grant(self):
        """Fast peer grants piece 1, acquires it later, announces Have
        while still choking — the grant must be exercised immediately."""

        async def go():
            t, _ = _SchedulerHarness().make_torrent()
            peer = _mk_fast_peer(t)
            peer.peer_choking = True
            peer.allowed_fast_in = {1}
            await t._handle_message(peer, proto.Have(1))
            reqs = [
                m
                for m in _messages(bytes(peer.writer.data))
                if isinstance(m, proto.Request)
            ]
            assert reqs and all(r.index == 1 for r in reqs)

        run(go())

    def test_allowed_fast_enables_choked_requests(self):
        async def go():
            t, _ = _SchedulerHarness().make_torrent()
            peer = _mk_fast_peer(t)
            peer.peer_choking = True
            peer.bitfield.from_numpy(np.ones(t.info.num_pieces, dtype=bool))
            await t._handle_message(peer, proto.AllowedFast(1))
            reqs = [
                m
                for m in _messages(bytes(peer.writer.data))
                if isinstance(m, proto.Request)
            ]
            assert reqs and all(r.index == 1 for r in reqs)

        run(go())

    def test_choked_pipeline_restricted_to_grants(self):
        async def go():
            t, _ = _SchedulerHarness().make_torrent()
            peer = _mk_fast_peer(t)
            peer.peer_choking = True
            peer.bitfield.from_numpy(np.ones(t.info.num_pieces, dtype=bool))
            peer.allowed_fast_in = {2}
            await t._fill_pipeline(peer)
            reqs = [
                m
                for m in _messages(bytes(peer.writer.data))
                if isinstance(m, proto.Request)
            ]
            assert reqs and {r.index for r in reqs} == {2}

        run(go())

    def test_serve_while_choked_only_for_granted_pieces(self):
        async def go():
            t, payload = _SchedulerHarness().make_torrent()
            # seed the storage + bitfield
            await asyncio.to_thread(t.storage.set, 0, payload)
            for i in range(t.info.num_pieces):
                t.bitfield.set(i)
            peer = _mk_fast_peer(t)
            peer.am_choking = True
            peer.allowed_fast_out = {0}
            await t._serve_request(peer, 0, 0, 16384)
            await t._serve_request(peer, 1, 0, 16384)
            msgs = _messages(bytes(peer.writer.data))
            pieces = [m for m in msgs if isinstance(m, proto.Piece)]
            rejects = [m for m in msgs if isinstance(m, proto.RejectRequest)]
            assert len(pieces) == 1 and pieces[0].index == 0
            assert len(rejects) == 1 and rejects[0].index == 1
            # legacy peer: silent ignore, no reject frame
            peer.fast = False
            peer.writer.data.clear()
            await t._serve_request(peer, 1, 0, 16384)
            assert not peer.writer.data

        run(go())

    def test_suggest_piece_prioritized(self):
        async def go():
            t, _ = _SchedulerHarness().make_torrent()
            peer = _mk_fast_peer(t)
            peer.peer_choking = False
            peer.bitfield.from_numpy(np.ones(t.info.num_pieces, dtype=bool))
            await t._handle_message(peer, proto.SuggestPiece(2))
            assert peer.suggested == [2]
            await t._fill_pipeline(peer)
            reqs = [
                m
                for m in _messages(bytes(peer.writer.data))
                if isinstance(m, proto.Request)
            ]
            assert reqs and reqs[0].index == 2

        run(go())
