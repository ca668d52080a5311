"""The port's BEP 52 (v2) plane against the reference, on the CPU.

Cases of tests/test_v2.py and the v2 recheck of tests/test_verify.py run
through ``torrent_tpu_torch`` with ``hasher="gpu", device="cpu"`` (the
plain PyTorch SHA-256 and pair levels) and ``hasher="cpu"`` (hashlib),
and are held against the reference package on the same seeded input:
its ``"tpu"`` hasher (the jax backend on this host) and its ``"cpu"``
hasher. Torrents cross over through ``compat``. Roots, layers, encoded
``.torrent`` bytes and bitfields compare exactly.

Sizes stay small: a full 16 KiB leaf is a 257-block chain, about 1.5 s
for the plain SHA-256, so the corpora hold a few leaves per file and use
16-32 KiB pieces.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from torrent_tpu.codec import metainfo_v2 as ref_mv2
from torrent_tpu.models import merkle as ref_merkle
from torrent_tpu.models import v2 as ref_v2
from torrent_tpu.parallel.verify import verify_pieces as ref_verify_pieces
from torrent_tpu.session import v2 as ref_session_v2
from torrent_tpu.storage.storage import FsStorage as RefFsStorage
from torrent_tpu.storage.storage import MemoryStorage as RefMemoryStorage
from torrent_tpu.storage.storage import Storage as RefStorage
from torrent_tpu_torch.codec import metainfo_v2 as mv2
from torrent_tpu_torch.codec.bencode import bencode
from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.compat import metainfo_v2_from_reference, v2_session_info_from_reference
from torrent_tpu_torch.models import merkle
from torrent_tpu_torch.models import v2
from torrent_tpu_torch.ops.sha256_cuda import make_sha256_fn
from torrent_tpu_torch.parallel.verify import verify_pieces
from torrent_tpu_torch.session import v2 as session_v2
from torrent_tpu_torch.storage.storage import FsStorage, MemoryStorage, Storage

CPU = "cpu"
BLOCK = mv2.BLOCK
PLEN = 2 * BLOCK  # 32 KiB pieces: 2 leaves per piece


def corpus(seed=7):
    rng = np.random.default_rng(seed)
    return [
        (("docs", "a.txt"), rng.bytes(3 * PLEN + 100)),
        (("docs", "b.bin"), rng.bytes(BLOCK // 2)),
        (("big.dat",), rng.bytes(5 * PLEN)),
        (("empty.txt",), b""),
    ]


# ---------------------------------------------------------------- codec


class TestMetainfoV2:
    def test_parse_encode_roundtrip_matches_reference(self):
        ref = ref_v2.build_v2(corpus(), name="v2demo", piece_length=PLEN, hasher="cpu",
                              announce="http://t/a", comment="hi", private=True)
        enc = ref_mv2.encode_metainfo_v2(
            ref.info, ref.piece_layers, announce="http://t/a", comment="hi",
            announce_list=[["http://a/1"], ["http://b/2"]], web_seeds=["http://ws/"],
        )
        port = mv2.parse_metainfo_v2(enc)
        assert port == metainfo_v2_from_reference(ref_mv2.parse_metainfo_v2(enc))
        assert port.truncated_info_hash == port.info_hash_v2[:20]
        again = mv2.encode_metainfo_v2(
            port.info, port.piece_layers, announce="http://t/a", comment="hi",
            announce_list=[["http://a/1"], ["http://b/2"]], web_seeds=["http://ws/"],
        )
        assert again == enc

    def test_hybrid_fields_encode_like_reference(self):
        ref = ref_v2.build_v2(corpus(), name="h", piece_length=PLEN, hasher="cpu")
        info = metainfo_v2_from_reference(ref).info
        kw = dict(v1_pieces=[b"\x01" * 20, b"\x02" * 20],
                  v1_files=[{b"length": 5, b"path": [b"x"]}])
        assert mv2.encode_metainfo_v2(info, {}, **kw) == ref_mv2.encode_metainfo_v2(ref.info, {}, **kw)

    def test_rejects_what_the_reference_rejects(self):
        meta = ref_v2.build_v2([(("f",), b"x" * (2 * PLEN))], name="x", piece_length=PLEN, hasher="cpu")
        good = ref_mv2.encode_metainfo_v2(meta.info, meta.piece_layers)
        cases = [good, b"garbage", b"de", ref_mv2.encode_metainfo_v2(meta.info, {})]
        for evil in ("..", ".", "a/b", "a\\b", "nul\x00"):
            bad_file = dataclasses.replace(meta.info.files[0], path=(evil,))
            cases.append(ref_mv2.encode_metainfo_v2(dataclasses.replace(meta.info, files=(bad_file,)), {}))
        info = {b"meta version": 2, b"name": b"x", b"file tree": {b"f": {b"": {b"length": 1}}}}
        for plen in (3 * BLOCK, BLOCK // 2):
            cases.append(bencode({b"info": {**info, b"piece length": plen}}))
        for data in cases:
            ref = ref_mv2.parse_metainfo_v2(data)
            port = mv2.parse_metainfo_v2(data)
            assert (port is None) == (ref is None)
        assert mv2.parse_metainfo_v2(good) is not None
        assert [mv2.valid_path_component(c) for c in ("ok", "..", "", "a/b")] == [True, False, False, False]

    def test_parse_ignores_v1_torrents(self):
        v1 = bencode({b"announce": b"http://t/a", b"info": {
            b"name": b"x", b"piece length": PLEN, b"length": 5, b"pieces": b"\x00" * 20}})
        assert parse_metainfo(v1) is not None
        assert mv2.parse_metainfo_v2(v1) is None and ref_mv2.parse_metainfo_v2(v1) is None


# ---------------------------------------------------------------- geometry


class TestSessionGeometry:
    def _meta(self):
        files = corpus() + [(("z", "tiny"), b"q" * 7)]
        ref = ref_v2.build_v2(files, name="geo", piece_length=PLEN, hasher="cpu")
        return ref, metainfo_v2_from_reference(ref)

    def test_v2_session_info_matches_reference(self):
        ref, port = self._meta()
        info = session_v2.v2_session_info(port.info, port.piece_layers)
        assert info == v2_session_info_from_reference(
            ref_session_v2.v2_session_info(ref.info, ref.piece_layers)
        )
        assert info.v2 and info.piece_aligned and info.is_multi_file
        assert session_v2.multi_piece_roots(port.info) == ref_session_v2.multi_piece_roots(ref.info)
        assert [session_v2._pad_target(n) for n in (1, BLOCK, BLOCK + 1, 5 * BLOCK)] == [1, 1, 2, 8]

    def test_session_meta_and_parts_match_reference(self):
        ref, port = self._meta()
        meta = session_v2.v2_session_meta(port)
        ref_meta = ref_session_v2.v2_session_meta(ref)
        assert meta.info_hash == ref_meta.info_hash and meta.info_hash_v2 == ref_meta.info_hash_v2
        assert meta.info == v2_session_info_from_reference(ref_meta.info)
        info_bytes = bencode(port.raw[b"info"])
        parts = session_v2.v2_session_meta_from_parts(info_bytes, port.info_hash_v2, port.piece_layers)
        assert parts.info == meta.info
        with pytest.raises(session_v2.V2Error):
            session_v2.v2_session_info(port.info, {})
        with pytest.raises(session_v2.V2Error):
            session_v2.v2_session_meta_from_parts(b"de", port.info_hash_v2, {})

    def test_piece_aligned_segments_match_reference(self):
        ref, port = self._meta()
        info = session_v2.v2_session_info(port.info, port.piece_layers)
        ref_info = ref_session_v2.v2_session_info(ref.info, ref.piece_layers)
        store = Storage(MemoryStorage(), info)
        ref_store = RefStorage(RefMemoryStorage(), ref_info)
        for idx in range(info.num_pieces):
            span = (idx * PLEN, info.piece_sizes[idx])
            assert list(store.segments(*span)) == list(ref_store.segments(*span))
        assert list(store.segments(0, info.length)) == list(ref_store.segments(0, info.length))


# ---------------------------------------------------------------- merkle


class TestMerkle:
    def test_roots_and_layers_match_reference(self):
        # shapes chosen so that every reference pair level is 4, 2 or 1
        # pairs wide: three jit compiles in all
        rng = np.random.default_rng(4)
        leaves = rng.integers(0, 2**32, size=(8, 8), dtype=np.uint32)
        assert (merkle.merkle_root(leaves, CPU) == ref_merkle.merkle_root(leaves)).all()
        roots = merkle.piece_roots_from_leaves(leaves[:7], 4, CPU)
        assert (roots == ref_merkle.piece_roots_from_leaves(leaves[:7], 4)).all()
        for n in (2, 3):
            assert merkle.file_root_from_piece_roots(leaves[:n], 4, CPU) == (
                ref_merkle.file_root_from_piece_roots(leaves[:n], 4)
            )
        assert merkle.small_file_root(leaves[:3], CPU) == ref_merkle.small_file_root(leaves[:3])
        assert merkle.small_file_root(leaves[:1], CPU) == ref_merkle.small_file_root(leaves[:1])
        assert merkle.zero_chain(4) == ref_merkle.zero_chain(4)
        with pytest.raises(ValueError):
            merkle.merkle_root(leaves[:3], CPU)
        with pytest.raises(ValueError):
            merkle.piece_roots_from_leaves(leaves, 3, CPU)

    @pytest.mark.parametrize("size,pad", [(0, 1), (100, 1), (BLOCK + 1, 2), (3 * BLOCK, 4), (3 * BLOCK, 8)])
    def test_piece_root_cpu_matches_reference(self, size, pad):
        data = np.random.default_rng(size).bytes(size)
        assert merkle.piece_root_cpu(data, pad) == ref_merkle.piece_root_cpu(data, pad)

    def test_reductions_launch_once_per_level_per_shape_group(self, monkeypatch):
        # 8 multi-piece files of one layer shape + 8 single-leaf files: the
        # batched reduction is one merkle call per shape group, one pair
        # level for the piece grid (2 leaves per piece) and two for the file
        # layers (4 pieces), not a chain per file (single-leaf roots are the
        # leaf itself)
        rng = np.random.default_rng(43)
        blobs = [rng.bytes(4 * PLEN) for _ in range(8)] + [rng.bytes(5000) for _ in range(8)]
        entries = [(len(b), v2._leaf_words_cpu(b)) for b in blobs]
        calls = []
        real = merkle.sha256_merkle_cuda
        monkeypatch.setattr(
            merkle, "sha256_merkle_cuda", lambda w, h: calls.append((tuple(w.shape), h)) or real(w, h)
        )
        got = v2.roots_batched(entries, PLEN, device=CPU)
        assert calls == [((8 * 4 * 2, 8), 1), ((8 * 4, 8), 2)], calls
        assert got == ref_v2.roots_batched(entries, PLEN, device=False)

    def test_roots_batched_matches_reference(self):
        rng = np.random.default_rng(42)
        sizes = [0, 100, 16384, 20000, PLEN, PLEN + 1, 3 * PLEN + 7, 8 * PLEN]
        blobs = [rng.bytes(s) for s in sizes]
        entries = [
            (len(b), v2._leaf_words_cpu(b) if b else np.zeros((0, 8), np.uint32)) for b in blobs
        ]
        want = ref_v2.roots_batched(entries, PLEN, device=False)
        assert v2.roots_batched(entries, PLEN, hasher="cpu") == want
        assert v2.roots_batched(entries, PLEN, device=CPU) == want
        assert v2.roots_batched_windowed(iter(entries), PLEN, window=3, device=CPU) == want


# ---------------------------------------------------------------- authoring


class TestHashFileV2:
    @pytest.mark.parametrize("size", [1, BLOCK + 1, 3 * PLEN + BLOCK // 2, 5 * PLEN])
    def test_matches_reference(self, size):
        data = np.random.default_rng(size).bytes(size)
        want = ref_v2.hash_file_v2(data, PLEN, hasher="tpu")
        assert want == ref_v2.hash_file_v2(data, PLEN, hasher="cpu")
        assert v2.hash_file_v2(data, PLEN, hasher="gpu", device=CPU) == want
        assert v2.hash_file_v2(data, PLEN, hasher="cpu") == want

    def test_path_sources_stream_and_match_bytes(self, tmp_path):
        data = np.random.default_rng(9).bytes(3 * PLEN + 777)
        fp = tmp_path / "payload.bin"
        fp.write_bytes(data)
        want = ref_v2.hash_file_v2(data, PLEN, hasher="cpu")
        assert v2.hash_file_v2(str(fp), PLEN, hasher="cpu") == want
        assert v2.hash_file_v2(str(fp), PLEN, hasher="gpu", device=CPU) == want
        assert v2.hash_file_v2(b"", PLEN, hasher="gpu", device=CPU) == (b"\x00" * 32, ())

    def test_chunked_leaf_launches(self, monkeypatch):
        # more leaves than one launch holds: the chunks' words land in order
        monkeypatch.setattr(v2, "LEAF_BATCH", 2)
        data = np.random.default_rng(3).bytes(2 * BLOCK + 300)
        words = v2._leaf_words_device(data, CPU)
        assert (words == v2._leaf_words_cpu(data)).all()
        assert (v2._leaf_words_device(b"", CPU) == v2._leaf_words_cpu(b"")).all()


class TestBuild:
    def test_build_v2_bytes_match_reference(self):
        files = corpus()
        kw = dict(name="v2demo", piece_length=PLEN, announce="http://t/a")
        gpu = v2.build_v2(files, hasher="gpu", device=CPU, **kw)
        cpu = v2.build_v2(files, hasher="cpu", **kw)
        ref = ref_v2.build_v2(files, hasher="cpu", **kw)
        assert bencode(gpu.raw) == bencode(cpu.raw) == bencode(ref.raw)
        assert gpu == metainfo_v2_from_reference(ref)

    def test_build_v2_options_match_reference(self):
        files = [(("f",), b"z" * (2 * PLEN))]
        kw = dict(name="x", piece_length=PLEN, hasher="cpu", private=True, comment="hi",
                  announce_list=[["http://a/1"], ["http://b/2"]], web_seeds=["http://ws/"])
        assert bencode(v2.build_v2(files, **kw).raw) == bencode(ref_v2.build_v2(files, **kw).raw)

    def test_build_hybrid_bytes_match_reference(self):
        rng = np.random.default_rng(19)
        files = [(("a.bin",), rng.bytes(BLOCK + 100)), (("b.bin",), rng.bytes(5000))]
        kw = dict(name="hyb", piece_length=BLOCK, announce="http://t/a")
        blob_gpu, meta_gpu = v2.build_hybrid(files, hasher="gpu", device=CPU, **kw)
        blob_cpu, _ = v2.build_hybrid(files, hasher="cpu", **kw)
        blob_ref, meta_ref = ref_v2.build_hybrid(files, hasher="cpu", **kw)
        assert blob_gpu == blob_cpu == blob_ref
        assert meta_gpu == metainfo_v2_from_reference(meta_ref)
        v1 = parse_metainfo(blob_gpu)
        assert [f.pad for f in v1.info.files] == [False, True, False]

    def test_single_file_hybrid_matches_reference(self):
        data = np.random.default_rng(23).bytes(3 * PLEN + 5)
        kw = dict(name="hyb", piece_length=PLEN, hasher="cpu", announce="http://t/a")
        blob, _ = v2.build_hybrid([(("hyb",), data)], **kw)
        assert blob == ref_v2.build_hybrid([(("hyb",), data)], **kw)[0]
        assert parse_metainfo(blob).info.files is None

    def test_bad_arguments_raise_like_reference(self):
        with pytest.raises(ValueError):
            v2.build_v2([(("f",), b"x")], name="x", piece_length=3 * BLOCK, hasher="cpu")
        with pytest.raises(ValueError):
            v2.build_hybrid([(("..",), b"x")], name="x", piece_length=PLEN, hasher="cpu")
        with pytest.raises(ValueError, match="hasher"):
            v2.build_v2([(("f",), b"x")], name="x", piece_length=PLEN, hasher="tpu")


# ---------------------------------------------------------------- rechecks


class TestVerifyV2:
    def test_corrupt_missing_and_resized_files_match_reference(self):
        files = corpus()
        meta = v2.build_v2(files, name="v2demo", piece_length=PLEN, hasher="cpu")
        ref_meta = ref_v2.build_v2(files, name="v2demo", piece_length=PLEN, hasher="cpu")
        lookup = dict(files)
        big = bytearray(lookup[("big.dat",)])
        big[2 * PLEN + 5] ^= 0xFF  # corrupt piece 2 of big.dat
        lookup[("big.dat",)] = bytes(big)
        lookup[("docs", "a.txt")] = lookup[("docs", "a.txt")][:-1]  # resized
        del lookup[("docs", "b.bin")]  # missing
        want = ref_v2.verify_v2(lookup.get, ref_meta, hasher="tpu")
        for port in (
            v2.verify_v2(lookup.get, meta, hasher="gpu", device=CPU),
            v2.verify_v2(lookup.get, meta, hasher="cpu"),
        ):
            assert port.keys() == want.keys()
            assert all((port[p] == want[p]).all() for p in want)
        assert want[("big.dat",)].tolist() == [True, True, False, True, True]
        assert not want[("docs", "a.txt")].any() and not want[("docs", "b.bin")].any()
        assert want[("empty.txt",)].shape == (0,)

    @pytest.mark.parametrize("hasher", ["cpu", "gpu"])
    def test_hostile_layer_fails_its_whole_file(self, hasher):
        # a layer that does not merkle up to the published root fails its
        # whole file, as in the reference; the other files verify
        files = [f for f in corpus() if f[0] != ("docs", "a.txt")]
        meta = v2.build_v2(files, name="v2demo", piece_length=PLEN, hasher="cpu")
        lookup = dict(files)
        root = next(f.pieces_root for f in meta.info.files if f.path == ("big.dat",))
        layer = list(meta.piece_layers[root])
        layer[0] = b"\xaa" * 32
        hostile = dataclasses.replace(meta, piece_layers={**meta.piece_layers, root: tuple(layer)})
        res = v2.verify_v2(lookup.get, hostile, hasher=hasher, device=CPU)
        assert not res[("big.dat",)].any() and res[("docs", "b.bin")].all()
        assert res[("empty.txt",)].shape == (0,)


def v2_torrent(tmp_path=None):
    """(port info, reference info, payload by path) of a seeded two-file
    v2 torrent: a multi-piece file (pad target 2) and a single-piece one
    (pad target 1), with a short last piece."""
    rng = np.random.default_rng(31)
    files = [(("big.bin",), rng.bytes(4 * PLEN + 100)), (("small.bin",), rng.bytes(3000))]
    ref = ref_v2.build_v2(files, name="tor", piece_length=PLEN, hasher="cpu")
    ref_info = ref_session_v2.v2_session_info(ref.info, ref.piece_layers)
    return v2_session_info_from_reference(ref_info), ref_info, dict(files)


class TestVerifyPiecesV2:
    def test_memory_storage_matches_reference(self):
        info, ref_info, payload = v2_torrent()
        store, ref_store = Storage(MemoryStorage(), info), RefStorage(RefMemoryStorage(), ref_info)
        for path, data in payload.items():
            store.method.set(("tor", *path), 0, data)
            ref_store.method.set(("tor", *path), 0, data)
        for s in (store, ref_store):
            s.method.set(("tor", "big.bin"), 3 * PLEN + 7, b"\x00!")  # piece 3
        want = np.asarray(ref_verify_pieces(ref_store, ref_info, hasher="tpu", batch_size=2))
        assert want.tolist() == [True, True, True, False, True, True]
        assert (verify_pieces(store, info, hasher="gpu", device=CPU, batch_size=8) == want).all()
        assert (verify_pieces(store, info, hasher="cpu") == want).all()

    def test_fs_storage_batches_and_subset_match_reference(self, tmp_path):
        info, ref_info, payload = v2_torrent()
        for path, data in payload.items():
            (tmp_path / "tor").mkdir(exist_ok=True)
            (tmp_path / "tor" / path[0]).write_bytes(data)
        (tmp_path / "tor" / "small.bin").unlink()  # missing file: its piece fails
        want = np.asarray(ref_verify_pieces(RefStorage(RefFsStorage(tmp_path), ref_info), ref_info, hasher="cpu"))
        assert want.tolist() == [True] * 5 + [False]
        calls = []
        got = verify_pieces(Storage(FsStorage(tmp_path), info), info, hasher="gpu", device=CPU,
                            batch_size=3, progress_cb=lambda d, t: calls.append((d, t)))
        assert (got == want).all()
        assert calls[-1] == (6, 6)
        (tmp_path / "tor" / "small.bin").write_bytes(payload[("small.bin",)])
        sub = verify_pieces(Storage(FsStorage(tmp_path), info), info, hasher="gpu", device=CPU, indices=[5])
        assert sub.tolist() == [False] * 5 + [True]


# ---------------------------------------------------------------- no GPU


@pytest.fixture
def no_cuda():
    """The raise-not-fall-back contract is checked on hosts without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


class TestEntryPointsRaiseWithoutGpu:
    def test_authoring_and_merkle(self, no_cuda):
        with pytest.raises(RuntimeError, match="CUDA"):
            v2.build_v2([(("f",), b"x")], name="x", piece_length=PLEN)
        with pytest.raises(RuntimeError, match="CUDA"):
            v2.build_hybrid([(("f",), b"x")], name="x", piece_length=PLEN)
        with pytest.raises(RuntimeError, match="CUDA"):
            v2.hash_file_v2(b"x" * 100, PLEN)
        with pytest.raises(RuntimeError, match="CUDA"):
            merkle.merkle_root(np.zeros((2, 8), dtype=np.uint32))
        with pytest.raises(RuntimeError, match="CUDA"):
            make_sha256_fn()

    def test_rechecks(self, no_cuda):
        info, _, payload = v2_torrent()
        meta = v2.build_v2(list(payload.items()), name="tor", piece_length=PLEN, hasher="cpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            v2.verify_v2(payload.get, meta)
        with pytest.raises(RuntimeError, match="CUDA"):
            verify_pieces(Storage(MemoryStorage(), info), info, hasher="gpu")


def test_expected_roots_are_hashlib_roots():
    """The geometry's expected digests are hashlib piece roots."""
    info, _, payload = v2_torrent()
    data = payload[("big.bin",)]
    assert info.pieces[0] == merkle.piece_root_cpu(data[:PLEN], 2)
    assert info.pieces[5] == merkle.piece_root_cpu(payload[("small.bin",)], 1)
    assert info.pieces[5] == hashlib.sha256(payload[("small.bin",)]).digest()
