"""The port's verify plane on the CPU, against hashlib and the reference.

Cases of tests/test_verify.py (corruption, short last piece, multi-file
boundary spanning, missing data, multi-launch authoring, piece-length
mismatch, progress callback, ``last_result``) run through
``torrent_tpu_torch`` with ``device="cpu"``, where the verifier's SHA-1
is the plain PyTorch version. Differentials feed the same seeded torrent
to the reference's ``verify_pieces(hasher="tpu")`` and the port's
``verify_pieces(hasher="gpu", device="cpu")``; the torrent crosses over
through ``compat.info_from_reference``. Bitfields and digests compare
exactly.

Piece lengths are a few KiB (the reference's cases use 16-64 KiB): the
plain SHA-1 costs about 7 ms of CPU per 64-byte block of the chain.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from torrent_tpu.codec.metainfo import FileEntry as RefFileEntry
from torrent_tpu.codec.metainfo import InfoDict as RefInfoDict
from torrent_tpu.codec.metainfo import parse_metainfo as ref_parse_metainfo
from torrent_tpu.parallel.verify import verify_pieces as ref_verify_pieces
from torrent_tpu.storage.storage import FsStorage as RefFsStorage
from torrent_tpu.storage.storage import MemoryStorage as RefMemoryStorage
from torrent_tpu.storage.storage import Storage as RefStorage
from torrent_tpu.tools.make_torrent import make_torrent as ref_make_torrent
from torrent_tpu_torch.codec.metainfo import InfoDict, parse_metainfo
from torrent_tpu_torch.compat import batch_from_numpy, info_from_reference
from torrent_tpu_torch.entry import entry, example_batch
from torrent_tpu_torch.models.verifier import GPUVerifier
from torrent_tpu_torch.ops.padding import digests_to_words, pad_pieces
from torrent_tpu_torch.ops.sha1_cuda import make_sha1_fn
from torrent_tpu_torch.ops.sha1_torch import words_to_numpy
from torrent_tpu_torch.parallel.verify import verify_pieces
from torrent_tpu_torch.storage.storage import FsStorage, MemoryStorage, Storage
from torrent_tpu_torch.tools.make_torrent import make_torrent

CPU = "cpu"


def build_torrent(length, piece_len, files=None, seed=0, name="v"):
    """(info, storage, payload): seeded payload with real hashes, written
    into a port MemoryStorage; ``files`` are (length, path) pairs."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, size=length, dtype=np.uint8).tobytes()
    pieces = tuple(
        hashlib.sha1(payload[i : i + piece_len]).digest() for i in range(0, length, piece_len)
    )
    ref_files = None if files is None else tuple(RefFileEntry(length=n, path=p) for n, p in files)
    ref_info = RefInfoDict(
        name=name, piece_length=piece_len, pieces=pieces, length=length, files=ref_files
    )
    info = info_from_reference(ref_info)
    storage = Storage(MemoryStorage(), info)
    for off in range(0, length, 1 << 16):
        storage.set(off, payload[off : off + (1 << 16)])
    return info, storage, payload, ref_info


class TestVerifyCpuHasher:
    def test_all_valid(self):
        info, storage, _, _ = build_torrent(30_000, 4096)
        bf = verify_pieces(storage, info, hasher="cpu")
        assert bf.all() and bf.shape == (info.num_pieces,)

    def test_corruption_detected(self):
        info, storage, _, _ = build_torrent(30_000, 4096)
        storage.method.set(("v",), 5000, b"\x00CORRUPT\x00")
        bf = verify_pieces(storage, info, hasher="cpu")
        assert not bf[1] and bf[0] and bf[2:].all()

    def test_missing_data(self):
        info, _, _, _ = build_torrent(30_000, 4096)
        assert not verify_pieces(Storage(MemoryStorage(), info), info, hasher="cpu").any()


class TestVerifyGpuHasherOnCpu:
    @pytest.mark.parametrize("batch_size", [3, 8, 64])
    def test_matches_cpu(self, batch_size):
        info, storage, _, _ = build_torrent(40_000, 2048, seed=2)
        storage.method.set(("v",), 2100, b"XX")
        storage.method.set(("v",), 39_000, b"YY")
        cpu = verify_pieces(storage, info, hasher="cpu")
        gpu = verify_pieces(storage, info, hasher="gpu", device=CPU, batch_size=batch_size)
        assert (cpu == gpu).all()
        assert not cpu[1] and not cpu[19] and cpu.sum() == info.num_pieces - 2

    def test_short_last_piece(self):
        info, storage, _, _ = build_torrent(10_000, 4096, seed=3)  # last = 1808 B
        assert verify_pieces(storage, info, hasher="gpu", device=CPU, batch_size=2).all()

    def test_multi_file_boundary_spanning(self):
        files = ((5_000, ("a",)), (8_000, ("b", "c")), (2_123, ("d",)))
        info, storage, _, _ = build_torrent(15_123, 4096, files=files, seed=4)
        assert verify_pieces(storage, info, hasher="gpu", device=CPU, batch_size=2).all()
        storage.method.set(("v", "b", "c"), 7_999, b"!")  # last byte of b/c: piece 3
        bf = verify_pieces(storage, info, hasher="gpu", device=CPU, batch_size=2)
        assert list(np.nonzero(~bf)[0]) == [3]

    def test_missing_data(self):
        info, _, _, _ = build_torrent(20_000, 4096)
        empty = Storage(MemoryStorage(), info)
        assert not verify_pieces(empty, info, hasher="gpu", device=CPU, batch_size=4).any()

    def test_unknown_hasher(self):
        info, storage, _, _ = build_torrent(4096, 4096)
        with pytest.raises(ValueError):
            verify_pieces(storage, info, hasher="tpu")

    def test_v2_info_not_ported(self):
        class V2Info:
            v2 = True
            num_pieces = 1

        with pytest.raises(NotImplementedError):
            verify_pieces(None, V2Info(), hasher="gpu", device=CPU)

    def test_empty_torrent(self):
        info = InfoDict(name="e", piece_length=4096, pieces=(), length=0)
        assert verify_pieces(None, info, hasher="gpu", device=CPU).shape == (0,)


class TestGPUVerifierOnCpu:
    def test_hash_pieces_matches_hashlib(self):
        rng = np.random.default_rng(1)
        pieces = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in (100, 2048, 5)]
        v = GPUVerifier(piece_length=2048, batch_size=8, device=CPU)
        assert v.hash_pieces(pieces) == [hashlib.sha1(p).digest() for p in pieces]

    def test_hash_pieces_multi_launch(self):
        # more pieces than batch_size → chunked launches
        pieces = [bytes([i]) * 100 for i in range(20)]
        v = GPUVerifier(piece_length=128, batch_size=8, device=CPU)
        assert v.hash_pieces(pieces) == [hashlib.sha1(p).digest() for p in pieces]

    def test_piece_too_long_rejected(self):
        v = GPUVerifier(piece_length=64, batch_size=8, device=CPU)
        with pytest.raises(ValueError):
            v.hash_pieces([b"x" * 65])

    def test_piece_length_mismatch_rejected(self):
        info, storage, _, _ = build_torrent(8192, 8192)
        v = GPUVerifier(piece_length=4096, batch_size=8, device=CPU)
        with pytest.raises(ValueError):
            v.verify_storage(storage, info)

    def test_bad_geometry_rejected(self):
        with pytest.raises(ValueError):
            GPUVerifier(piece_length=0, device=CPU)
        with pytest.raises(ValueError):
            GPUVerifier(piece_length=64, device="meta")

    def test_last_result_metrics(self):
        info, storage, _, _ = build_torrent(20_000, 4096, seed=6)
        v = GPUVerifier(piece_length=4096, batch_size=2, device=CPU)
        assert v.verify_storage(storage, info).all()
        r = v.last_result
        assert r.complete and r.n_pieces == info.num_pieces
        assert r.bytes_hashed == 20_000 and r.pieces_per_sec > 0 and r.gib_per_sec > 0

    def test_hash_bytes(self):
        v = GPUVerifier(piece_length=64, batch_size=8, device=CPU)
        assert v.hash_bytes(b"abc") == hashlib.sha1(b"abc").digest()

    def test_progress_callback(self):
        info, storage, _, _ = build_torrent(30_000, 2048, seed=7)
        calls = []
        v = GPUVerifier(piece_length=2048, batch_size=4, device=CPU)
        v.verify_storage(storage, info, progress_cb=lambda done, total: calls.append((done, total)))
        assert calls[-1] == (info.num_pieces, info.num_pieces)
        assert [c[0] for c in calls] == sorted(c[0] for c in calls)

    @pytest.mark.parametrize("io_threads", [1, 3])
    def test_io_striping_and_ragged_tail(self, io_threads):
        info, storage, _, _ = build_torrent(45_000, 2048, seed=8)
        storage.method.set(("v",), 44_500, b"Z")
        v = GPUVerifier(piece_length=2048, batch_size=7, device=CPU)
        bf = v.verify_storage(storage, info, io_threads=io_threads)
        assert list(np.nonzero(~bf)[0]) == [21]

    @pytest.mark.parametrize("as_u32", [False, True])
    def test_raw_steps(self, as_u32):
        rng = np.random.default_rng(9)
        pieces = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in (0, 64, 500, 100)]
        padded, nblocks = pad_pieces(pieces)
        expected = digests_to_words([hashlib.sha1(p).digest() for p in pieces])
        rows = padded.view(np.uint32) if as_u32 else padded
        v = GPUVerifier(piece_length=512, batch_size=4, device=CPU)
        assert (v.digest_batch(rows, nblocks) == expected).all()
        bad = expected.copy()
        bad[2, 0] ^= 1
        assert v.verify_batch(rows, nblocks, bad).tolist() == [True, True, False, True]
        handle = v.upload_batch(rows)
        assert (words_to_numpy(v.digest_uploaded(handle, nblocks)) == expected).all()
        assert v.upload_batch(rows[0]) is None

    def test_upload_copies_the_staging_buffer(self):
        padded, nblocks = pad_pieces([b"abc"])
        v = GPUVerifier(piece_length=64, batch_size=1, device=CPU)
        handle = v.upload_batch(padded)
        padded[:] = 0  # the caller reuses its staging buffer
        words = words_to_numpy(v.digest_uploaded(handle, nblocks))
        assert (words == digests_to_words([hashlib.sha1(b"abc").digest()])).all()


def _reference_and_port_bitfields(info, ref_info, storage_port, storage_ref, batch_size):
    ref = ref_verify_pieces(storage_ref, ref_info, hasher="tpu", batch_size=batch_size)
    port = verify_pieces(storage_port, info, hasher="gpu", device=CPU, batch_size=batch_size)
    return np.asarray(ref), port


class TestAgainstReferenceVerify:
    """The same seeded torrent through both packages' device rechecks."""

    @pytest.mark.parametrize("seed,corrupt", [(10, ()), (11, (1, 9)), (12, (0, 5, 14))])
    def test_single_file_bitfields_identical(self, seed, corrupt):
        info, storage, payload, ref_info = build_torrent(60_000, 4096, seed=seed)
        ref_store = RefStorage(RefMemoryStorage(), ref_info)
        ref_store.set(0, payload)
        for p in corrupt:
            storage.method.set(("v",), p * 4096 + 7, b"\xee")
            ref_store.method.set(("v",), p * 4096 + 7, b"\xee")
        ref, port = _reference_and_port_bitfields(info, ref_info, storage, ref_store, 8)
        assert (ref == port).all()
        assert sorted(np.nonzero(~port)[0]) == sorted(corrupt)

    def test_multi_file_on_disk_bitfields_identical(self, tmp_path):
        rng = np.random.default_rng(13)
        root = tmp_path / "payload"
        for rel, size in (("a.bin", 9_001), ("b/c.bin", 4_095), ("d.bin", 13), ("e/f.bin", 20_000)):
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            (root / rel).write_bytes(rng.integers(0, 256, size=size, dtype=np.uint8).tobytes())
        ref_meta = ref_parse_metainfo(ref_make_torrent(str(root), "http://t/a", piece_length=4096))
        info = info_from_reference(ref_meta.info)
        with open(root / "b" / "c.bin", "r+b") as f:
            f.seek(4_000)
            f.write(b"\x00\x01")
        os.remove(root / "d.bin")
        ref, port = _reference_and_port_bitfields(
            info, ref_meta.info, Storage(FsStorage(tmp_path), info),
            RefStorage(RefFsStorage(tmp_path), ref_meta.info), 4,
        )
        assert (ref == port).all()
        assert not port.all() and port.any()


class TestAuthoring:
    @pytest.mark.parametrize("pad_files", [False, True])
    def test_gpu_hasher_matches_cpu_and_reference(self, tmp_path, pad_files):
        rng = np.random.default_rng(14)
        root = tmp_path / "payload"
        for rel, size in (("a.bin", 10_000), ("sub/b.bin", 3_333), ("z.bin", 1)):
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            (root / rel).write_bytes(rng.integers(0, 256, size=size, dtype=np.uint8).tobytes())
        kw = dict(piece_length=2048, pad_files=pad_files)
        gpu = parse_metainfo(make_torrent(str(root), "http://t/a", hasher="gpu", device=CPU, **kw))
        cpu = parse_metainfo(make_torrent(str(root), "http://t/a", hasher="cpu", **kw))
        ref = ref_parse_metainfo(ref_make_torrent(str(root), "http://t/a", hasher="cpu", **kw))
        assert gpu.info == cpu.info == info_from_reference(ref.info)
        assert gpu.info_hash == cpu.info_hash == ref.info_hash
        bf = verify_pieces(Storage(FsStorage(tmp_path), gpu.info), gpu.info,
                           hasher="gpu", device=CPU, batch_size=4)
        assert bf.all()

    def test_single_file_short_last_piece(self, tmp_path):
        path = tmp_path / "one.bin"
        path.write_bytes(np.random.default_rng(15).bytes(9_000))
        meta = parse_metainfo(
            make_torrent(str(path), "http://t/a", piece_length=4096, hasher="gpu", device=CPU)
        )
        data = path.read_bytes()
        assert meta.info.pieces == tuple(
            hashlib.sha1(data[i : i + 4096]).digest() for i in range(0, 9_000, 4096)
        )

    def test_unknown_hasher(self, tmp_path):
        (tmp_path / "f").write_bytes(b"x")
        with pytest.raises(ValueError):
            make_torrent(str(tmp_path / "f"), "http://t/a", hasher="tpu")


class TestEntryAndCompat:
    def test_entry_forward_step(self):
        forward, (data, nblocks, expected) = entry(device=CPU)
        assert forward(data, nblocks, expected).all()
        data[3, 0] ^= 0xFF
        ok = forward(data, nblocks, expected)
        assert not ok[3] and int(ok.sum()) == len(ok) - 1

    def test_batch_from_numpy_copies_to_the_device(self):
        padded, nblocks, expected = example_batch(n=3)
        data_t, nb_t, exp_t = batch_from_numpy(padded, nblocks, expected, device=CPU)
        assert data_t.dtype == torch.uint8 and nb_t.dtype == torch.int32
        assert exp_t.dtype == torch.int32
        padded[:] = 0  # the tensors do not alias the numpy batch
        assert (make_sha1_fn(CPU)(data_t, nb_t) == exp_t).all()
        u32, _, _ = batch_from_numpy(padded.view(np.uint32), nblocks, expected, device=CPU)
        assert u32.dtype == torch.int32 and u32.shape == (3, padded.shape[1] // 4)


@pytest.fixture
def no_cuda():
    """The raise-not-fall-back contract is checked on hosts without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


class TestEntryPointsRaiseWithoutGpu:
    def test_verifier(self, no_cuda):
        with pytest.raises(RuntimeError, match="CUDA"):
            GPUVerifier(piece_length=64)
        with pytest.raises(RuntimeError, match="CUDA"):
            GPUVerifier(piece_length=64, device="cuda")

    def test_verify_pieces(self, no_cuda):
        info, storage, _, _ = build_torrent(4096, 4096)
        with pytest.raises(RuntimeError, match="CUDA"):
            verify_pieces(storage, info, hasher="gpu")

    def test_make_torrent(self, no_cuda, tmp_path):
        (tmp_path / "f").write_bytes(b"x" * 100)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_torrent(str(tmp_path / "f"), "http://t/a", hasher="gpu")

    def test_entry_and_sha1_fn(self, no_cuda):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_sha1_fn()
        with pytest.raises(RuntimeError, match="CUDA"):
            batch_from_numpy(*example_batch(n=1))
