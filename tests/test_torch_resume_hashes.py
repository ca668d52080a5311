"""BEP 52 merkle hash transfer tests (messages 21-23 + models/hashes).

The oracle tree is built with plain hashlib, independently of
models/merkle's device plane, so a serving bug can't hide behind a
matching implementation.
"""

import hashlib

import pytest

from torrent_tpu_torch.codec.metainfo_v2 import BLOCK
from torrent_tpu_torch.models.hashes import (
    HashRequestFields,
    HashTreeCache,
    verify_hash_response,
)
from torrent_tpu_torch.net import protocol as proto


def _oracle_tree(piece_hashes: list[bytes], zero: bytes) -> list[list[bytes]]:
    n = 1 << max(0, (len(piece_hashes) - 1).bit_length())
    level = piece_hashes + [zero] * (n - len(piece_hashes))
    levels = [level]
    while len(level) > 1:
        level = [
            hashlib.sha256(level[i] + level[i + 1]).digest()
            for i in range(0, len(level), 2)
        ]
        levels.append(level)
    return levels


def _mk_cache(n_pieces=11, piece_length=4 * BLOCK):
    # piece layer = layer 2 (4 blocks per piece)
    piece_hashes = [hashlib.sha256(bytes([i]) * 32).digest() for i in range(n_pieces)]
    from torrent_tpu_torch.models.merkle import zero_chain

    height = (piece_length // BLOCK).bit_length() - 1
    zero = zero_chain(height)[height]
    levels = _oracle_tree(piece_hashes, zero)
    root = levels[-1][0]
    cache = HashTreeCache({root: tuple(piece_hashes)}, piece_length)
    return cache, root, levels, zero


class TestServe:
    def test_full_layer_with_proofs_verifies(self):
        cache, root, levels, zero = _mk_cache()
        # request 4 hashes at index 8 with proofs all the way up:
        # padded layer = 16, span level = 2, tree height = 4 → 2 proofs
        req = HashRequestFields(root, cache.base, 8, 4, 2)
        hashes = cache.serve(req)
        assert hashes is not None and len(hashes) == 6
        assert hashes[:3] == levels[0][8:11]  # real hashes
        assert hashes[3] == zero  # zero-padded tail
        assert verify_hash_response(req, hashes)

    def test_tampered_hash_fails_verification(self):
        cache, root, _, _ = _mk_cache()
        req = HashRequestFields(root, cache.base, 0, 4, 2)
        hashes = cache.serve(req)
        assert verify_hash_response(req, hashes)
        bad = [b"\xee" * 32] + hashes[1:]
        assert not verify_hash_response(req, bad)

    def test_whole_layer_no_proofs(self):
        cache, root, levels, _ = _mk_cache()
        req = HashRequestFields(root, cache.base, 0, 16, 0)
        hashes = cache.serve(req)
        assert hashes == levels[0]
        # a full-layer response chains to the root with zero proofs
        assert verify_hash_response(req, hashes)

    def test_rejects(self):
        cache, root, _, _ = _mk_cache()
        base = cache.base
        assert cache.serve(HashRequestFields(b"\x01" * 32, base, 0, 4, 0)) is None
        assert cache.serve(HashRequestFields(root, base + 1, 0, 4, 0)) is None  # wrong layer
        assert cache.serve(HashRequestFields(root, base, 0, 3, 0)) is None  # not pow2
        assert cache.serve(HashRequestFields(root, base, 2, 4, 0)) is None  # misaligned
        assert cache.serve(HashRequestFields(root, base, 64, 4, 0)) is None  # past end
        assert cache.serve(HashRequestFields(root, base, 0, 4, 9)) is None  # too many proofs

    def test_single_piece_file_root(self):
        cache, _, _, _ = _mk_cache()
        single = hashlib.sha256(b"lonely").digest()
        cache.add_single_piece_roots([single])
        req = HashRequestFields(single, cache.base, 0, 1, 0)
        assert cache.serve(req) == [single]
        assert verify_hash_response(req, [single])

    def test_corrupt_layer_never_served(self):
        from torrent_tpu_torch.models.hashes import HashTreeCache

        bad_root = b"\x07" * 32
        cache = HashTreeCache({bad_root: (b"\x01" * 32, b"\x02" * 32)}, 4 * BLOCK)
        assert cache.serve(HashRequestFields(bad_root, cache.base, 0, 2, 0)) is None


class TestWire:
    def test_roundtrips(self):
        root = bytes(range(32))
        for msg in [
            proto.HashRequest(root, 2, 8, 4, 3),
            proto.Hashes(root, 2, 8, 4, 1, hashes=b"\xaa" * 160),
            proto.HashReject(root, 2, 8, 4, 3),
        ]:
            enc = proto.encode_message(msg)
            assert proto.decode_message(enc[4], enc[5:]) == msg

    def test_hash_list(self):
        m = proto.Hashes(b"\x00" * 32, 0, 0, 2, 0, hashes=b"\x01" * 32 + b"\x02" * 32)
        assert m.hash_list() == [b"\x01" * 32, b"\x02" * 32]

    def test_malformed_rejected(self):
        with pytest.raises(proto.ProtocolError):
            proto.decode_message(int(proto.MsgId.HASH_REQUEST), b"\x00" * 47)
        with pytest.raises(proto.ProtocolError):
            proto.decode_message(int(proto.MsgId.HASHES), b"\x00" * 49)


class TestSessionServing:
    def _hybrid_torrent(self, tmp_path):
        """Author a real hybrid torrent and open it as a session Torrent."""
        import numpy as np

        from torrent_tpu_torch.codec.metainfo import parse_metainfo
        from torrent_tpu_torch.models.v2 import build_hybrid
        from torrent_tpu_torch.session.client import generate_peer_id
        from torrent_tpu_torch.session.torrent import Torrent, TorrentConfig
        from torrent_tpu_torch.storage.storage import MemoryStorage, Storage

        payload = np.random.default_rng(4).integers(
            0, 256, 5 * 4 * BLOCK + 777, dtype=np.uint8
        ).tobytes()
        data, meta = build_hybrid(
            [(("h.bin",), payload)],
            name="h.bin",
            piece_length=4 * BLOCK,
            hasher="cpu",
            announce="http://127.0.0.1:1/announce",
        )
        m = parse_metainfo(data)
        assert m is not None
        t = Torrent(
            metainfo=m,
            storage=Storage(MemoryStorage(), m.info),
            peer_id=generate_peer_id(),
            port=1, config=TorrentConfig(hasher="cpu"),
        )
        return t, meta

    def test_serves_and_verifies_own_layers(self, tmp_path):
        import asyncio

        from tests.test_torch_session_fast import _mk_fast_peer, _messages
        from tests.test_torch_session import run
        from torrent_tpu_torch.models.hashes import HashRequestFields, verify_hash_response

        async def go():
            t, meta = self._hybrid_torrent(tmp_path)
            root = next(iter(meta.piece_layers))
            peer = _mk_fast_peer(t)
            cache = t._hash_tree_cache()
            assert cache is not None
            # padded layer size for 6 pieces = 8; proofs to root = 0 at
            # full span, so ask for the whole layer
            await t._handle_message(
                peer, proto.HashRequest(root, cache.base, 0, 8, 0)
            )
            msgs = [
                m for m in _messages(bytes(peer.writer.data))
                if isinstance(m, proto.Hashes)
            ]
            assert msgs, "expected a Hashes response"
            req = HashRequestFields(root, cache.base, 0, 8, 0)
            assert verify_hash_response(req, msgs[0].hash_list())
            # unknown root → reject
            peer.writer.data.clear()
            await t._handle_message(
                peer, proto.HashRequest(b"\x05" * 32, cache.base, 0, 8, 0)
            )
            assert any(
                isinstance(m, proto.HashReject)
                for m in _messages(bytes(peer.writer.data))
            )

        run(go())

    def test_plain_v1_torrent_rejects(self):
        from tests.test_torch_session_fast import _mk_fast_peer, _messages
        from tests.test_torch_session_selection import make_multifile_torrent
        from tests.test_torch_session import run

        async def go():
            t, _ = make_multifile_torrent([4 * BLOCK])
            peer = _mk_fast_peer(t)
            await t._handle_message(
                peer, proto.HashRequest(b"\x09" * 32, 2, 0, 4, 0)
            )
            assert any(
                isinstance(m, proto.HashReject)
                for m in _messages(bytes(peer.writer.data))
            )

        run(go())


class TestVerifyTotality:
    def test_malformed_geometry_returns_false_not_raises(self):
        root = b"\x00" * 32
        h = b"\x01" * 32
        assert not verify_hash_response(HashRequestFields(root, 2, 0, 3, 0), [h] * 3)
        assert not verify_hash_response(HashRequestFields(root, 2, 0, 0, 0), [])
        assert not verify_hash_response(HashRequestFields(root, 2, -4, 4, 0), [h] * 4)
        assert not verify_hash_response(HashRequestFields(root, 2, 0, 4, -1), [h] * 3)

    def test_oversized_run_rejected_in_serve(self):
        cache, root, _, _ = _mk_cache()
        from torrent_tpu_torch.models.hashes import MAX_RUN

        assert cache.serve(
            HashRequestFields(root, cache.base, 0, MAX_RUN * 2, 0)
        ) is None


class TestLayerFetch:
    def test_magnet_style_leech_fetches_layers_from_seed(self, tmp_path):
        """The fetch side: a leech whose metainfo lacks piece layers (the
        ut_metadata case — layers live outside the info dict) pulls them
        from a connected peer, verifies against the trusted pieces root,
        and becomes able to serve hash requests itself."""
        import asyncio
        import os

        import numpy as np

        from tests.test_torch_session import run
        from torrent_tpu_torch.codec.bencode import bdecode, bencode
        from torrent_tpu_torch.codec.metainfo import parse_metainfo
        from torrent_tpu_torch.models.v2 import build_hybrid
        from torrent_tpu_torch.models.hashes import HashRequestFields
        from torrent_tpu_torch.server.in_memory import run_tracker
        from torrent_tpu_torch.server.tracker import ServeOptions
        from torrent_tpu_torch.session.client import Client, ClientConfig

        async def go():
            plen = 4 * BLOCK
            payload = np.random.default_rng(6).integers(
                0, 256, 6 * plen + 99, dtype=np.uint8
            ).tobytes()
            server, _ = await run_tracker(
                ServeOptions(http_port=0, udp_port=None, interval=1)
            )
            announce = "http://127.0.0.1:%d/announce" % server.http_port
            data, meta = build_hybrid(
                [(("lf.bin",), payload)],
                name="lf.bin",
                piece_length=plen,
                hasher="cpu",
                announce=announce,
            )
            stripped = dict(bdecode(data))
            del stripped[b"piece layers"]
            data_stripped = bencode(stripped, sort_keys=False)
            m_full = parse_metainfo(data)
            m_stripped = parse_metainfo(data_stripped)
            assert m_full.info_hash == m_stripped.info_hash  # info untouched

            seed_dir = str(tmp_path / "seedv2")
            os.makedirs(seed_dir)
            open(os.path.join(seed_dir, "lf.bin"), "wb").write(payload)
            c_seed = Client(ClientConfig(hasher="cpu", port=0, enable_upnp=False))
            c_leech = Client(ClientConfig(hasher="cpu", port=0, enable_upnp=False))
            await c_seed.start()
            await c_leech.start()
            try:
                t_seed = await c_seed.add(m_full, seed_dir)
                assert t_seed._hash_tree_cache() is not None
                leech_dir = str(tmp_path / "leechv2")
                os.makedirs(leech_dir)
                t = await c_leech.add(m_stripped, leech_dir)
                assert t._hash_tree_cache() is None  # layers missing
                for _ in range(400):
                    if t.peers:
                        break
                    await asyncio.sleep(0.02)
                assert t.peers, "leech never connected to seed"
                ok = await t.fetch_v2_layers(timeout=10)
                assert ok, "layer fetch failed"
                cache = t._hash_tree_cache()
                assert cache is not None
                # the leech can now serve the full verified layer onward
                root = next(iter(meta.piece_layers))
                served = cache.serve(HashRequestFields(root, cache.base, 0, 8, 0))
                assert served is not None
            finally:
                await c_seed.close()
                await c_leech.close()
                server.close()

        run(go(), timeout=90)

    def test_chunked_fetch_for_large_layers(self, tmp_path):
        """A >MAX_RUN-piece file fetches its layer in proof-chained
        chunks (the whole-layer request would exceed the DoS bound)."""
        import asyncio
        import os

        import numpy as np

        from tests.test_torch_session import run
        from torrent_tpu_torch.codec.bencode import bdecode, bencode
        from torrent_tpu_torch.codec.metainfo import parse_metainfo
        from torrent_tpu_torch.models.v2 import build_hybrid
        from torrent_tpu_torch.models.hashes import MAX_RUN
        from torrent_tpu_torch.server.in_memory import run_tracker
        from torrent_tpu_torch.server.tracker import ServeOptions
        from torrent_tpu_torch.session.client import Client, ClientConfig

        async def go():
            plen = BLOCK  # 16 KiB pieces keep the payload small
            n_pieces = MAX_RUN + 70  # padded 1024 > MAX_RUN -> chunked
            payload = np.random.default_rng(8).integers(
                0, 256, n_pieces * plen - 55, dtype=np.uint8
            ).tobytes()
            server, _ = await run_tracker(
                ServeOptions(http_port=0, udp_port=None, interval=1)
            )
            announce = "http://127.0.0.1:%d/announce" % server.http_port
            data, meta = build_hybrid(
                [(("big.bin",), payload)],
                name="big.bin",
                piece_length=plen,
                hasher="cpu",
                announce=announce,
            )
            stripped = dict(bdecode(data))
            del stripped[b"piece layers"]
            m_full = parse_metainfo(data)
            m_stripped = parse_metainfo(bencode(stripped, sort_keys=False))
            seed_dir = str(tmp_path / "bseed")
            os.makedirs(seed_dir)
            open(os.path.join(seed_dir, "big.bin"), "wb").write(payload)
            c_seed = Client(ClientConfig(hasher="cpu", port=0, enable_upnp=False))
            c_leech = Client(ClientConfig(hasher="cpu", port=0, enable_upnp=False))
            await c_seed.start()
            await c_leech.start()
            try:
                await c_seed.add(m_full, seed_dir)
                leech_dir = str(tmp_path / "bleech")
                os.makedirs(leech_dir)
                t = await c_leech.add(m_stripped, leech_dir)
                for _ in range(400):
                    if t.peers:
                        break
                    await asyncio.sleep(0.02)
                assert t.peers
                ok = await t.fetch_v2_layers(timeout=20)
                assert ok, "chunked layer fetch failed"
                root = next(iter(meta.piece_layers))
                assert t._hash_tree_cache().piece_layers[root] == meta.piece_layers[root]
            finally:
                await c_seed.close()
                await c_leech.close()
                server.close()

        run(go(), timeout=120)
