"""BEP 11 ut_pex tests: codec properties + live-swarm gossip.

The integration test proves the full loop over real sockets: a peer
address known only to the seeder reaches the leech via a PEX delta, and
the leech dials it.
"""

import asyncio

import numpy as np

from test_torch_session import _FakeWriter, build_torrent_bytes, fast_config, run
from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.net import extension as ext
from torrent_tpu_torch.session.client import Client, ClientConfig
from torrent_tpu_torch.session.peer import PeerConnection
from torrent_tpu_torch.session.torrent import TorrentState
from torrent_tpu_torch.storage.storage import MemoryStorage, Storage


class TestPexCodec:
    def test_roundtrip(self):
        added = [("10.0.0.1", 6881), ("10.0.0.2", 51413)]
        dropped = [("10.0.0.3", 1)]
        msg = ext.decode_pex(ext.encode_pex(added, dropped))
        assert msg.added == tuple(added)
        assert msg.dropped == tuple(dropped)

    def test_bad_ports_skipped_v6_routed_to_added6(self):
        payload = ext.encode_pex([("::1", 6881), ("1.2.3.4", 0), ("5.6.7.8", 70000),
                                  ("9.9.9.9", 9)])
        msg = ext.decode_pex(payload)
        # invalid ports dropped; the v6 peer now rides added6 (BEP 11)
        assert set(msg.added) == {("9.9.9.9", 9), ("::1", 6881)}

    def test_malformed_total(self):
        assert ext.decode_pex(b"junk") is None
        assert ext.decode_pex(ext_bencode({b"added": 5})) is None

    def test_handshake_advertises_pex(self):
        st = ext.ExtensionState(enabled=True)
        ext.decode_extended_handshake(ext.encode_extended_handshake(), st)
        assert st.ut_pex_id == ext.LOCAL_EXT_IDS[ext.UT_PEX]


def ext_bencode(v):
    from torrent_tpu_torch.codec.bencode import bencode

    return bencode(v)


class TestPexGossip:
    def test_pex_delta_reaches_peer_and_gets_dialed(self):
        """Seeder knows an extra address; a PEX round gossips it to the
        leech, which dials it (observed by a live listener)."""

        async def go():
            rng = np.random.default_rng(55)
            payload = rng.integers(0, 256, size=100_000, dtype=np.uint8).tobytes()
            tb = build_torrent_bytes(payload, 32768, b"http://127.0.0.1:1/dead")
            m = parse_metainfo(tb)

            dialed = asyncio.Event()

            async def on_dial(reader, writer):
                dialed.set()
                writer.close()

            extra = await asyncio.start_server(on_dial, "127.0.0.1", 0)
            extra_port = extra.sockets[0].getsockname()[1]

            seed = Client(ClientConfig(hasher="cpu", host="127.0.0.1"))
            leech = Client(ClientConfig(hasher="cpu", host="127.0.0.1"))
            seed.config.torrent = fast_config(pex_interval=0.2)
            leech.config.torrent = fast_config(pex_interval=0.2)
            await seed.start()
            await leech.start()
            try:
                # half-seeded source: both sides stay DOWNLOADING (a
                # completed leech turns seeder and stops dialing, which
                # would mask the PEX-triggered dial this test observes)
                ss = Storage(MemoryStorage(), m.info)
                ss.set(0, payload[:32768])
                t_seed = await seed.add(m, ss)
                assert t_seed.state == TorrentState.DOWNLOADING
                t_leech = await leech.add(m, Storage(MemoryStorage(), m.info))
                # no tracker: hand the leech the seeder directly
                from torrent_tpu_torch.net.types import AnnouncePeer

                t_leech._connect_new_peers(
                    [AnnouncePeer(ip="127.0.0.1", port=seed.port)]
                )
                # wait for the wire connection
                for _ in range(100):
                    if t_seed.peers:
                        break
                    await asyncio.sleep(0.05)
                assert t_seed.peers, "leech never connected to seed"
                # seeder additionally "knows" the extra address (e.g. an
                # inbound peer on another torrentless connection)
                ghost = PeerConnection(
                    peer_id=b"G" * 20,
                    reader=object(),
                    writer=_FakeWriter(),
                    num_pieces=m.info.num_pieces,
                    address=("127.0.0.1", extra_port),
                )
                t_seed.peers[ghost.peer_id] = ghost
                await asyncio.wait_for(dialed.wait(), timeout=15)
            finally:
                await seed.close()
                await leech.close()
                extra.close()

        run(go())


class TestPexAddressHygiene:
    def test_inbound_without_listen_port_not_gossiped(self):
        """An inbound peer's ephemeral source port must not be PEXed; its
        BEP 10 'p' key makes it gossipable."""
        from test_torch_session import TestSchedulerUnits

        t, _ = TestSchedulerUnits().make_torrent()
        inbound = PeerConnection(
            peer_id=b"I" * 20, reader=object(), writer=_FakeWriter(),
            num_pieces=t.info.num_pieces, address=("10.0.0.5", 51234), inbound=True,
        )
        outbound = PeerConnection(
            peer_id=b"O" * 20, reader=object(), writer=_FakeWriter(),
            num_pieces=t.info.num_pieces, address=("10.0.0.6", 6881),
        )
        assert t._dialable_addr(inbound) is None  # ephemeral: withheld
        assert t._dialable_addr(outbound) == ("10.0.0.6", 6881)
        inbound.ext.listen_port = 7000
        assert t._dialable_addr(inbound) == ("10.0.0.5", 7000)

    def test_listen_port_roundtrips_in_handshake(self):
        st = ext.ExtensionState(enabled=True)
        ext.decode_extended_handshake(
            ext.encode_extended_handshake(listen_port=7001), st
        )
        assert st.listen_port == 7001

    def test_snub_expires(self):
        """A snub is a cooldown, not a life sentence — after expiry the
        peer is eligible for requests again even without delivering."""
        import time as _time

        p = PeerConnection(
            peer_id=b"Z" * 20, reader=object(), writer=_FakeWriter(), num_pieces=4
        )
        p.snubbed_until = _time.monotonic() + 100
        assert p.snubbed
        p.snubbed_until = _time.monotonic() - 1
        assert not p.snubbed


class TestPexIpv6:
    """BEP 11 added6/dropped6: v6 peers gossip alongside v4."""

    def test_mixed_family_roundtrip(self):
        from torrent_tpu_torch.net.extension import decode_pex, encode_pex

        added = [("10.0.0.1", 6881), ("2001:db8::7", 51413), ("10.0.0.2", 1)]
        dropped = [("::1", 9000), ("192.168.0.9", 7000)]
        msg = decode_pex(encode_pex(added, dropped))
        assert set(msg.added) == set(added)
        assert set(msg.dropped) == set(dropped)

    def test_v6_only_payload(self):
        from torrent_tpu_torch.codec.bencode import bdecode
        from torrent_tpu_torch.net.extension import decode_pex, encode_pex

        payload = encode_pex([("2001:db8::1", 6881)])
        d = bdecode(payload)
        assert d[b"added"] == b""  # v4 field empty
        assert len(d[b"added6"]) == 18 and d[b"added6.f"] == b"\x00"
        msg = decode_pex(payload)
        assert msg.added == (("2001:db8::1", 6881),)

    def test_malformed_v6_blob_truncates_cleanly(self):
        from torrent_tpu_torch.codec.bencode import bencode
        from torrent_tpu_torch.net.extension import decode_pex

        # 20 bytes = one full 18-byte entry + 2 stray bytes (dropped)
        blob = bencode({b"added": b"", b"added6": b"\x20" * 18 + b"xy"})
        msg = decode_pex(blob)
        assert len(msg.added) == 1

    def test_v6_gossip_end_to_end(self, tmp_path):
        """A v6-connected swarm member is gossiped via added6 and the
        receiver dials it: full loopback over ::1."""
        import asyncio
        import hashlib
        import os
        import socket

        import numpy as np
        import pytest as _pytest

        from tests.test_torch_session import run
        from torrent_tpu_torch.codec.bencode import bencode
        from torrent_tpu_torch.codec.metainfo import parse_metainfo
        from torrent_tpu_torch.server.in_memory import run_tracker
        from torrent_tpu_torch.server.tracker import ServeOptions
        from torrent_tpu_torch.session.client import Client, ClientConfig

        if not socket.has_ipv6:
            _pytest.skip("no IPv6")

        async def go():
            plen = 32768
            payload = np.random.default_rng(81).integers(
                0, 256, 3 * plen, dtype=np.uint8
            ).tobytes()
            digs = [
                hashlib.sha1(payload[i : i + plen]).digest()
                for i in range(0, len(payload), plen)
            ]
            meta = bencode(
                {
                    b"announce": b"http://127.0.0.1:1/announce",  # dead
                    b"info": {
                        b"name": b"p6.bin",
                        b"piece length": plen,
                        b"pieces": b"".join(digs),
                        b"length": len(payload),
                    },
                }
            )
            m = parse_metainfo(meta)
            # A seeds over IPv6; B connects to A; C connects to A (v6).
            # A's PEX gossip must teach B about C (added6) and vice versa.
            try:
                a = Client(ClientConfig(hasher="cpu", port=0, host="::1", enable_upnp=False))
                await a.start()
            except OSError:
                _pytest.skip("IPv6 loopback unavailable")
            b = Client(ClientConfig(hasher="cpu", port=0, host="::1", enable_upnp=False))
            c = Client(ClientConfig(hasher="cpu", port=0, host="::1", enable_upnp=False))
            await b.start()
            await c.start()
            # fast PEX cadence
            for cl in (a, b, c):
                cl.config.torrent.pex_interval = 0.3
            # A is a PARTIAL seed (first 2 of 3 pieces): B and C can never
            # complete, so they stay DOWNLOADING — a completed leech
            # becomes a seed and refuses outbound dials, which would race
            # the gossip round on this tiny payload
            sd = str(tmp_path / "p6s")
            os.makedirs(sd)
            open(os.path.join(sd, "p6.bin"), "wb").write(payload[: 2 * plen])
            try:
                ta = await a.add(m, sd)
                from torrent_tpu_torch.net.types import AnnouncePeer

                db, dc = str(tmp_path / "p6b"), str(tmp_path / "p6c")
                os.makedirs(db)
                os.makedirs(dc)
                tb = await b.add(m, db)
                tc = await c.add(m, dc)
                tb._connect_new_peers([AnnouncePeer(ip="::1", port=a.port)])
                tc._connect_new_peers([AnnouncePeer(ip="::1", port=a.port)])
                # B and C discover each other ONLY via A's v6 PEX gossip
                for _ in range(400):
                    if len(tb.peers) >= 2 and len(tc.peers) >= 2:
                        break
                    await asyncio.sleep(0.05)
                assert len(tb.peers) >= 2, "added6 gossip never connected B-C"
                assert len(tc.peers) >= 2
                # and the gossiped link carries data: both got A's pieces
                for _ in range(400):
                    if tb.bitfield.count() == 2 and tc.bitfield.count() == 2:
                        break
                    await asyncio.sleep(0.05)
                assert tb.bitfield.count() == 2 and tc.bitfield.count() == 2
            finally:
                await a.close()
                await b.close()
                await c.close()

        run(go(), timeout=60)

    def test_port0_v6_padding_dropped(self):
        """Hostile added6 padding with port-0 entries must be discarded —
        the shared v6 decoder mirrors the v4 anti-padding rule (each junk
        entry would otherwise burn a dial slot and a 10 s timeout)."""
        import socket

        from torrent_tpu_torch.codec.bencode import bencode
        from torrent_tpu_torch.net.extension import decode_pex

        good = socket.inet_pton(socket.AF_INET6, "2001:db8::1") + (6881).to_bytes(2, "big")
        pad = socket.inet_pton(socket.AF_INET6, "2001:db8::2") + b"\x00\x00"
        msg = decode_pex(bencode({b"added": b"", b"added6": pad * 5 + good}))
        assert msg.added == (("2001:db8::1", 6881),)

    def test_v4_mapped_peer_gossips_as_v4(self):
        """A dual-stack listener reports v4 peers as ::ffff:a.b.c.d —
        they must ride the v4 added field, not added6 (BEP 11)."""
        from torrent_tpu_torch.net.types import normalize_peer_host

        assert normalize_peer_host("::ffff:93.184.216.34") == "93.184.216.34"
        assert normalize_peer_host("2001:db8::1") == "2001:db8::1"
        assert normalize_peer_host("10.0.0.1") == "10.0.0.1"
        assert normalize_peer_host("not-an-ip") == "not-an-ip"
        from torrent_tpu_torch.codec.bencode import bdecode
        from torrent_tpu_torch.net.extension import encode_pex

        d = bdecode(encode_pex([(normalize_peer_host("::ffff:9.9.9.9"), 6881)]))
        assert len(d[b"added"]) == 6 and not d.get(b"added6")
