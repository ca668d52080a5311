"""BEP 46 mutable torrents: btpk magnets resolved through BEP 44 items.

Codec round-trips plus the full story over a loopback DHT: publisher
signs {"ih": ...} under its key, a subscriber resolves the magnet,
downloads the torrent trackerlessly, and a seq-bumped republish moves
the pointer to new content.
"""

import asyncio
import hashlib
import os

import numpy as np
import pytest

from torrent_tpu_torch.codec.magnet import (
    Magnet,
    MagnetError,
    mutable_magnet_uri,
    parse_magnet,
)
from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.net.dht import DHTNode
from torrent_tpu_torch.session.client import Client, ClientConfig
from torrent_tpu_torch.session.torrent import TorrentState
from torrent_tpu_torch.storage.storage import MemoryStorage, Storage
from torrent_tpu_torch.utils import ed25519 as ed

from tests.test_torch_session import build_torrent_bytes, fast_config, run


PK = bytes(range(32))


class TestBtpkMagnets:
    def test_parse_emit_roundtrip(self):
        uri = mutable_magnet_uri(PK, b"app1")
        assert "xs=urn:btpk:" + PK.hex() in uri
        assert "s=" + b"app1".hex() in uri
        m = parse_magnet(uri)
        assert m.mutable_key == PK and m.mutable_salt == b"app1"
        assert m.info_hash is None and m.info_hash_v2 is None
        assert parse_magnet(m.to_uri()) == m

    def test_saltless_form(self):
        m = parse_magnet(mutable_magnet_uri(PK))
        assert m.mutable_key == PK and m.mutable_salt == b""

    def test_btpk_plus_btih_is_a_hint_pair(self):
        """A magnet may carry both a concrete hash and the mutable key
        (BEP 46's recommended form: immediate join + future updates)."""
        ih = hashlib.sha1(b"x").digest()
        m = parse_magnet(f"magnet:?xt=urn:btih:{ih.hex()}&xs=urn:btpk:{PK.hex()}")
        assert m.info_hash == ih and m.mutable_key == PK

    def test_wire_hash_refuses_unresolved_btpk(self):
        with pytest.raises(MagnetError, match="resolved"):
            parse_magnet(mutable_magnet_uri(PK)).wire_hash

    def test_malformed_sole_pointer_rejected(self):
        with pytest.raises(MagnetError):
            parse_magnet("magnet:?xs=urn:btpk:abcd")  # short
        with pytest.raises(MagnetError):
            parse_magnet("magnet:?xs=urn:btpk:" + "zz" * 32)  # not hex
        with pytest.raises(MagnetError):
            parse_magnet(f"magnet:?xs=urn:btpk:{PK.hex()}&s=nothex!")
        with pytest.raises(MagnetError):
            mutable_magnet_uri(b"short")

    def test_malformed_pointer_beside_btih_is_skipped(self):
        """Same policy as unrecognized btmh shapes: a bad xs= must not
        reject a magnet whose btih topic is fine."""
        ih = hashlib.sha1(b"y").digest()
        m = parse_magnet(f"magnet:?xt=urn:btih:{ih.hex()}&xs=urn:btpk:abcd")
        assert m.info_hash == ih and m.mutable_key is None
        m2 = parse_magnet(
            f"magnet:?xt=urn:btih:{ih.hex()}&xs=urn:btpk:{PK.hex()}&s=nothex!"
        )
        assert m2.info_hash == ih and m2.mutable_key is None


class TestMutableResolution:
    def test_publish_resolve_download_update(self, tmp_path):
        """The whole BEP 46 lifecycle over a real loopback DHT."""

        async def go():
            boot = await DHTNode(host="127.0.0.1").start()
            rng = np.random.default_rng(46)
            payload_v1 = rng.integers(0, 256, size=100_000, dtype=np.uint8).tobytes()
            payload_v2 = rng.integers(0, 256, size=100_000, dtype=np.uint8).tobytes()
            mb_v1 = build_torrent_bytes(
                payload_v1, 32768, b"http://127.0.0.1:1/announce", name=b"rev1"
            )
            mb_v2 = build_torrent_bytes(
                payload_v2, 32768, b"http://127.0.0.1:1/announce", name=b"rev2"
            )
            m1, m2 = parse_metainfo(mb_v1), parse_metainfo(mb_v2)
            secret = os.urandom(32)
            pub = ed.publickey(secret)

            cfg = lambda: ClientConfig(
                host="127.0.0.1",
                enable_dht=True,
                dht_bootstrap=(("127.0.0.1", boot.port),), hasher="cpu",
            )
            publisher, subscriber = Client(cfg()), Client(cfg())
            publisher.config.torrent = fast_config(dht_interval=0.5)
            subscriber.config.torrent = fast_config(dht_interval=0.5)
            await publisher.start()
            await subscriber.start()
            try:
                # publisher seeds rev1 and signs the pointer
                ss = Storage(MemoryStorage(), m1.info)
                for off in range(0, len(payload_v1), 65536):
                    ss.set(off, payload_v1[off : off + 65536])
                t_seed = await publisher.add(m1, ss)
                assert t_seed.state == TorrentState.SEEDING
                target, stored = await publisher.publish_mutable(
                    secret, m1.info_hash, seq=1, salt=b"chan"
                )
                assert stored > 0

                # subscriber joins from the bare btpk URI via add_magnet's
                # auto-detection; DHT peer discovery may lag the announce
                uri = mutable_magnet_uri(pub, b"chan")
                t_leech = None
                for _ in range(40):
                    try:
                        t_leech = await subscriber.add_magnet(
                            uri, Storage(MemoryStorage(), m1.info)
                        )
                        break
                    except Exception:
                        await asyncio.sleep(0.25)
                assert t_leech is not None, "mutable magnet never resolved"
                assert t_leech.info.name == "rev1"
                await asyncio.wait_for(t_leech.on_complete.wait(), timeout=30)
                assert t_leech.storage.get(0, len(payload_v1)) == payload_v1

                # rev2: the pointer moves; a fresh resolve sees the new hash
                _, stored2 = await publisher.publish_mutable(
                    secret, m2.info_hash, seq=2, salt=b"chan"
                )
                assert stored2 > 0
                new_ih = await subscriber.resolve_mutable(uri)
                assert new_ih == m2.info_hash != m1.info_hash
            finally:
                await publisher.close()
                await subscriber.close()
                boot.close()

        run(go(), timeout=90)

    def test_resolve_requires_dht(self):
        async def go():
            c = Client(ClientConfig(host="127.0.0.1", hasher="cpu"))
            await c.start()
            try:
                with pytest.raises(ValueError, match="DHT"):
                    await c.resolve_mutable(mutable_magnet_uri(PK))
                with pytest.raises(ValueError, match="mutable"):
                    await c.resolve_mutable(
                        f"magnet:?xt=urn:btih:{'00' * 20}"
                    )
            finally:
                await c.close()

        run(go())

    def test_resolve_rejects_malformed_pointer(self):
        """An item under the right key whose value isn't {'ih': 20 bytes}
        must not be trusted."""

        async def go():
            boot = await DHTNode(host="127.0.0.1").start()
            c = Client(
                ClientConfig(
                    host="127.0.0.1",
                    enable_dht=True,
                    dht_bootstrap=(("127.0.0.1", boot.port),), hasher="cpu",
                )
            )
            await c.start()
            try:
                secret = os.urandom(32)
                await c.dht.put_mutable(secret, {b"ih": b"short"}, seq=1)
                uri = mutable_magnet_uri(ed.publickey(secret))
                with pytest.raises(ValueError, match="ih"):
                    await c.resolve_mutable(uri)
            finally:
                await c.close()
                boot.close()

        run(go())
