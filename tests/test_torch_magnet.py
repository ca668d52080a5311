"""Magnet links + BEP 10 extension protocol + BEP 9 ut_metadata tests.

Covers the reference's unchecked "Magnet Links" roadmap item
(README.md:39): URI parsing, extension wire codec, metadata assembly,
and a full e2e magnet join against a live seeding client.
"""

import asyncio
import hashlib

import numpy as np
import pytest

from torrent_tpu_torch.codec.bencode import bencode
from torrent_tpu_torch.codec.magnet import Magnet, MagnetError, parse_magnet
from torrent_tpu_torch.codec.metainfo import metainfo_from_info_bytes, parse_metainfo
from torrent_tpu_torch.net import extension as ext
from torrent_tpu_torch.session.client import Client, ClientConfig, generate_peer_id
from torrent_tpu_torch.session.metadata import MetadataError, fetch_metadata
from torrent_tpu_torch.session.torrent import TorrentConfig, TorrentState
from torrent_tpu_torch.storage.storage import MemoryStorage, Storage

from tests.test_torch_session import build_torrent_bytes, fast_config, run

IH = bytes(range(20))


class TestMagnetParse:
    def test_hex(self):
        m = parse_magnet(f"magnet:?xt=urn:btih:{IH.hex()}")
        assert m.info_hash == IH and m.display_name is None and m.trackers == ()

    def test_base32(self):
        import base64

        b32 = base64.b32encode(IH).decode()
        assert parse_magnet(f"magnet:?xt=urn:btih:{b32}").info_hash == IH

    def test_full(self):
        uri = (
            f"magnet:?xt=urn:btih:{IH.hex()}&dn=My%20File"
            "&tr=http%3A%2F%2Ft1%2Fannounce&tr=udp%3A%2F%2Ft2%3A6969"
            "&x.pe=127.0.0.1:6881&x.pe=[::1]:6882"
        )
        m = parse_magnet(uri)
        assert m.display_name == "My File"
        assert m.trackers == ("http://t1/announce", "udp://t2:6969")
        assert m.peer_addrs == (("127.0.0.1", 6881), ("::1", 6882))

    def test_roundtrip(self):
        m = Magnet(IH, "x y", ("http://t/a",), (("10.0.0.1", 51413),))
        assert parse_magnet(m.to_uri()) == m

    def test_roundtrip_ipv6(self):
        m = Magnet(IH, peer_addrs=(("::1", 6882), ("2001:db8::7", 51413)))
        uri = m.to_uri()
        assert "x.pe=[::1]:6882" in uri  # bracketed form for external clients
        assert parse_magnet(uri) == m

    @pytest.mark.parametrize(
        "uri",
        [
            "http://not-magnet",
            "magnet:?dn=nohash",
            "magnet:?xt=urn:btih:zz",
            f"magnet:?xt=urn:btih:{IH.hex()}&x.pe=noport",
            f"magnet:?xt=urn:btih:{IH.hex()}&x.pe=h:0",
        ],
    )
    def test_malformed(self, uri):
        with pytest.raises(MagnetError):
            parse_magnet(uri)


class TestExtensionCodec:
    def test_reserved_bit(self):
        r = ext.extension_reserved()
        assert ext.supports_extensions(r)
        assert not ext.supports_extensions(b"\x00" * 8)
        assert not ext.supports_extensions(b"")

    def test_extended_handshake_roundtrip(self):
        payload = ext.encode_extended_handshake(metadata_size=12345, version="tt/0.1")
        st = ext.ExtensionState(enabled=True)
        ext.decode_extended_handshake(payload, st)
        assert st.handshaken and st.metadata_size == 12345
        # our side advertises ut_metadata id 1
        assert st.ut_metadata_id == ext.LOCAL_EXT_IDS[ext.UT_METADATA]

    def test_bad_handshake_degrades(self):
        st = ext.ExtensionState(enabled=True)
        ext.decode_extended_handshake(b"garbage", st)
        assert not st.handshaken and st.ut_metadata_id == 0

    def test_metadata_message_framing(self):
        data = b"\xde\xad" * 100
        payload = ext.encode_metadata_data(piece=0, total_size=200, data=data)
        mm = ext.decode_metadata_message(payload)
        assert mm.msg_type == ext.MsgType.DATA and mm.piece == 0
        assert mm.total_size == 200 and mm.data == data
        req = ext.decode_metadata_message(ext.encode_metadata_request(3))
        assert req.msg_type == ext.MsgType.REQUEST and req.piece == 3
        rej = ext.decode_metadata_message(ext.encode_metadata_reject(7))
        assert rej.msg_type == ext.MsgType.REJECT and rej.piece == 7
        assert ext.decode_metadata_message(b"not bencode") is None

    def test_assembler_multi_piece(self):
        blob = np.random.default_rng(3).integers(0, 256, size=40_000, dtype=np.uint8).tobytes()
        ih = hashlib.sha1(blob).digest()
        asm = ext.MetadataAssembler(len(blob))
        assert asm.n_pieces == 3 and asm.missing() == [0, 1, 2]
        for i in (2, 0, 1):  # out of order
            piece = ext.metadata_piece(blob, i)
            asm.add(ext.MetadataMessage(ext.MsgType.DATA, i, len(blob), piece))
        assert asm.complete
        assert asm.result(ih) == blob

    def test_assembler_rejects_poison(self):
        blob = b"x" * 1000
        asm = ext.MetadataAssembler(len(blob))
        asm.add(ext.MetadataMessage(ext.MsgType.DATA, 0, len(blob), b"y" * 1000))
        assert asm.complete
        assert asm.result(hashlib.sha1(blob).digest()) is None
        assert not asm.complete  # cleared for refetch

    def test_assembler_wrong_sizes(self):
        asm = ext.MetadataAssembler(ext.METADATA_PIECE_SIZE + 10)
        # non-final piece must be exactly 16 KiB
        assert not asm.add(ext.MetadataMessage(ext.MsgType.DATA, 0, 0, b"short"))
        # out-of-range piece index
        assert not asm.add(ext.MetadataMessage(ext.MsgType.DATA, 9, 0, b"x" * 10))
        with pytest.raises(ValueError):
            ext.MetadataAssembler(0)


class TestMetainfoFromInfoBytes:
    def test_roundtrip_hash(self):
        data = build_torrent_bytes(b"p" * 1000, 512, b"http://t/a")
        m = parse_metainfo(data)
        from torrent_tpu_torch.codec.bencode import bdecode

        info_bytes = bencode(bdecode(data)[b"info"], sort_keys=False)
        assert hashlib.sha1(info_bytes).digest() == m.info_hash
        m2 = metainfo_from_info_bytes(info_bytes, announce="http://t/a")
        assert m2 is not None
        assert m2.info_hash == m.info_hash
        assert m2.info == m.info

    def test_garbage(self):
        assert metainfo_from_info_bytes(b"nonsense") is None


class TestMagnetE2E:
    def test_magnet_join_and_download(self):
        """Leech knows only the magnet URI + seeder address (x.pe); it must
        fetch the info dict over ut_metadata, then download and verify."""

        async def go():
            rng = np.random.default_rng(7)
            payload = rng.integers(0, 256, size=150_000, dtype=np.uint8).tobytes()
            torrent_bytes = build_torrent_bytes(
                payload, 32768, b"http://127.0.0.1:1/announce", name=b"magnet-e2e"
            )
            m = parse_metainfo(torrent_bytes)

            seed = Client(ClientConfig(host="127.0.0.1", hasher="cpu"))
            leech = Client(ClientConfig(host="127.0.0.1", hasher="cpu"))
            seed.config.torrent = fast_config()
            leech.config.torrent = fast_config()
            await seed.start()
            await leech.start()
            try:
                seed_storage = Storage(MemoryStorage(), m.info)
                for off in range(0, len(payload), 65536):
                    seed_storage.set(off, payload[off : off + 65536])
                t_seed = await seed.add(m, seed_storage)
                assert t_seed.state == TorrentState.SEEDING

                magnet = Magnet(
                    info_hash=m.info_hash,
                    display_name="magnet-e2e",
                    peer_addrs=(("127.0.0.1", seed.port),),
                )
                t_leech = await leech.add_magnet(
                    magnet, Storage(MemoryStorage(), m.info)
                )
                assert t_leech.metainfo.info_hash == m.info_hash
                assert t_leech.info.name == "magnet-e2e"
                await asyncio.wait_for(t_leech.on_complete.wait(), timeout=30)
                assert t_leech.storage.get(0, len(payload)) == payload
            finally:
                await seed.close()
                await leech.close()

        run(go())

    def test_trackerless_torrent_has_no_announce_loop(self):
        """x.pe-only magnet → empty TrackerList → no announce task hammering
        an empty URL (review finding)."""
        from torrent_tpu_torch.net.multitracker import TrackerList

        assert not TrackerList("")
        assert not TrackerList("", [["", ""]])
        assert TrackerList("http://t/a")

        async def go():
            data = build_torrent_bytes(b"q" * 1000, 512, b"http://x/a")
            from torrent_tpu_torch.codec.bencode import bdecode

            info_bytes = bencode(bdecode(data)[b"info"], sort_keys=False)
            mi = metainfo_from_info_bytes(info_bytes)  # announce=""
            from torrent_tpu_torch.session.torrent import Torrent

            t = Torrent(
                metainfo=mi,
                storage=Storage(MemoryStorage(), mi.info),
                peer_id=generate_peer_id(),
                port=6881,
                config=fast_config(),
            )
            await t.start()
            names = {task.get_name() for task in t._tasks}
            assert "announce" not in names and "choke" in names
            await t.stop()

        run(go())

    def test_magnet_no_sources(self):
        async def go():
            magnet = Magnet(info_hash=IH)
            with pytest.raises(MetadataError, match="no reachable peer sources"):
                await fetch_metadata(magnet, peer_id=generate_peer_id())

        run(go())

    def test_magnet_dead_peer(self):
        async def go():
            magnet = Magnet(info_hash=IH, peer_addrs=(("127.0.0.1", 1),))
            with pytest.raises(MetadataError, match="all metadata sources failed"):
                await fetch_metadata(magnet, peer_id=generate_peer_id(), peer_timeout=1.0)

        run(go())


class TestBtmh:
    def test_hybrid_magnet_carries_both_topics(self):
        from torrent_tpu_torch.codec.magnet import Magnet, parse_magnet

        uri = (
            "magnet:?xt=urn:btih:" + "ab" * 20 + "&xt=urn:btmh:1220" + "cd" * 32
        )
        m = parse_magnet(uri)
        assert m.info_hash == bytes.fromhex("ab" * 20)
        assert m.info_hash_v2 == bytes.fromhex("cd" * 32)
        assert parse_magnet(m.to_uri()) == m

    def test_v2_only_parses_and_needs_a_peer_source(self):
        """btmh-only magnets are accepted (pure-v2 swarm support,
        tests/test_v2_swarm.py has the full e2e); with no peers/trackers
        the join fails with MetadataError, not the old refusal."""
        import asyncio

        from torrent_tpu_torch.codec.magnet import parse_magnet
        from torrent_tpu_torch.session.client import Client, ClientConfig
        from torrent_tpu_torch.session.metadata import MetadataError

        m = parse_magnet("magnet:?xt=urn:btmh:1220" + "ee" * 32)
        assert m.info_hash is None and m.info_hash_v2 is not None

        async def go():
            c = Client(ClientConfig(port=0, enable_upnp=False, hasher="cpu"))
            await c.start()
            try:
                with __import__("pytest").raises(MetadataError):
                    await c.add_magnet(m, "/tmp")
            finally:
                await c.close()

        asyncio.run(asyncio.wait_for(go(), 30))

    def test_unrecognized_multihash_skipped_not_fatal(self):
        import pytest

        from torrent_tpu_torch.codec.magnet import MagnetError, parse_magnet

        # a hybrid magnet's btih must survive an exotic btmh beside it
        m = parse_magnet(
            "magnet:?xt=urn:btih:" + "ab" * 20 + "&xt=urn:btmh:1320" + "cd" * 32
        )
        assert m.info_hash is not None and m.info_hash_v2 is None
        # junk btmh alone leaves no usable topic at all
        with pytest.raises(MagnetError):
            parse_magnet("magnet:?xt=urn:btmh:1220" + "cd" * 16)


class TestBep53SelectOnly:
    def test_parse_and_roundtrip(self):
        from torrent_tpu_torch.codec.magnet import Magnet, parse_magnet

        m = parse_magnet("magnet:?xt=urn:btih:" + "ab" * 20 + "&so=0,2,4-7")
        assert m.select_only == (0, 2, 4, 5, 6, 7)
        # round-trips with run compression
        assert "so=0,2,4-7" in m.to_uri()
        assert parse_magnet(m.to_uri()).select_only == m.select_only
        # no so= -> None (download everything)
        m2 = parse_magnet("magnet:?xt=urn:btih:" + "ab" * 20)
        assert m2.select_only is None

    def test_bad_selection_rejected(self):
        import pytest as _pytest

        from torrent_tpu_torch.codec.magnet import MagnetError, parse_magnet

        for bad in ("x", "3-1", "-2", "1-"):
            with _pytest.raises(MagnetError):
                parse_magnet("magnet:?xt=urn:btih:" + "ab" * 20 + "&so=" + bad)

    def test_magnet_selection_applied_e2e(self, tmp_path):
        """A so= magnet downloads ONLY the selected file."""
        import asyncio
        import hashlib
        import os

        import numpy as np

        from tests.test_torch_session import run
        from torrent_tpu_torch.codec.bencode import bencode
        from torrent_tpu_torch.codec.magnet import Magnet
        from torrent_tpu_torch.codec.metainfo import parse_metainfo
        from torrent_tpu_torch.server.in_memory import run_tracker
        from torrent_tpu_torch.server.tracker import ServeOptions
        from torrent_tpu_torch.session.client import Client, ClientConfig

        async def go():
            plen = 32768
            rng = np.random.default_rng(77)
            fa = rng.integers(0, 256, 2 * plen, dtype=np.uint8).tobytes()
            fb = rng.integers(0, 256, 2 * plen, dtype=np.uint8).tobytes()
            payload = fa + fb
            digs = [
                hashlib.sha1(payload[i : i + plen]).digest()
                for i in range(0, len(payload), plen)
            ]
            server, _ = await run_tracker(
                ServeOptions(http_port=0, udp_port=None, interval=1)
            )
            meta = bencode(
                {
                    b"announce": b"http://127.0.0.1:%d/announce" % server.http_port,
                    b"info": {
                        b"name": b"sel",
                        b"piece length": plen,
                        b"pieces": b"".join(digs),
                        b"files": [
                            {b"length": len(fa), b"path": [b"a.bin"]},
                            {b"length": len(fb), b"path": [b"b.bin"]},
                        ],
                    },
                }
            )
            m = parse_metainfo(meta)
            sd, ld = str(tmp_path / "s"), str(tmp_path / "l")
            os.makedirs(os.path.join(sd, "sel"))
            os.makedirs(ld)
            open(os.path.join(sd, "sel", "a.bin"), "wb").write(fa)
            open(os.path.join(sd, "sel", "b.bin"), "wb").write(fb)
            c1 = Client(ClientConfig(port=0, enable_upnp=False, hasher="cpu"))
            c2 = Client(ClientConfig(port=0, enable_upnp=False, hasher="cpu"))
            await c1.start()
            await c2.start()
            try:
                await c1.add(m, sd)
                magnet = Magnet(
                    info_hash=m.info_hash,
                    trackers=(f"http://127.0.0.1:{server.http_port}/announce",),
                    peer_addrs=(("127.0.0.1", c1.port),),
                    select_only=(1,),  # only b.bin
                )
                t = await asyncio.wait_for(c2.add_magnet(magnet.to_uri(), ld), 60)
                for _ in range(600):
                    if t.status()["wanted_left"] == 0:
                        break
                    await asyncio.sleep(0.05)
                assert t.status()["wanted_left"] == 0, t.status()
                assert (
                    open(os.path.join(ld, "sel", "b.bin"), "rb").read() == fb
                )
                # a.bin was never wanted: absent or incomplete on disk
                a_path = os.path.join(ld, "sel", "a.bin")
                assert not os.path.exists(a_path) or open(a_path, "rb").read() != fa
            finally:
                await c1.close()
                await c2.close()
                server.close()

        run(go(), timeout=60)

    def test_range_bomb_rejected(self):
        from torrent_tpu_torch.codec.magnet import MagnetError, parse_magnet

        with pytest.raises(MagnetError, match="exceeds"):
            parse_magnet(
                "magnet:?xt=urn:btih:" + "ab" * 20 + "&so=0-9999999999"
            )

    def test_empty_selection_roundtrips(self):
        from torrent_tpu_torch.codec.magnet import Magnet, parse_magnet

        m = Magnet(info_hash=IH, select_only=())
        assert "so=" in m.to_uri()
        assert parse_magnet(m.to_uri()).select_only == ()
