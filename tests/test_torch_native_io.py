"""Native C++ IO engine tests: differential vs the pure-Python read path.

The engine (native/io_engine.cpp) is the data-loader of the hash plane;
its contract is byte-identical output to ``Storage.read_batch``'s Python
path for every geometry — multi-file spans, short final pieces, missing
files (zero-fill), truncated files, and strided staging views.
"""

import os
import pathlib

import numpy as np
import pytest

from torrent_tpu_torch.codec.bencode import bencode
from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.native.io_engine import (
    NativeIOEngine,
    NativeIOError,
    native_available,
)
from torrent_tpu_torch.storage.storage import FsStorage, Storage

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native toolchain unavailable"
)


def make_multifile(tmp_path, file_lens, piece_len, seed=0):
    rng = np.random.default_rng(seed)
    root = tmp_path / "dl"
    d = root / "t"
    d.mkdir(parents=True)
    blobs = []
    files = []
    for i, ln in enumerate(file_lens):
        blob = rng.integers(0, 256, size=ln, dtype=np.uint8).tobytes()
        (d / f"f{i}.bin").write_bytes(blob)
        blobs.append(blob)
        files.append({b"length": ln, b"path": [f"f{i}.bin".encode()]})
    payload = b"".join(blobs)
    import hashlib

    pieces = b"".join(
        hashlib.sha1(payload[i : i + piece_len]).digest()
        for i in range(0, len(payload), piece_len)
    )
    tor = bencode(
        {
            b"announce": b"http://t/a",
            b"info": {
                b"name": b"t",
                b"piece length": piece_len,
                b"pieces": pieces,
                b"files": files,
            },
        }
    )
    m = parse_metainfo(tor)
    assert m is not None
    return root, m, payload


def python_read(storage, indices):
    """Force the pure-Python path for differential comparison."""
    out = np.zeros((len(indices), storage.info.piece_length), dtype=np.uint8)
    lengths = np.empty(len(indices), dtype=np.int64)
    native = Storage._native_read_batch
    try:
        Storage._native_read_batch = lambda self, i, o, l, rs=None, tracked=None: False
        return storage.read_batch(indices, out=out)
    finally:
        Storage._native_read_batch = native


class TestEngineRaw:
    def test_segments_and_errors(self, tmp_path):
        a = tmp_path / "a.bin"
        a.write_bytes(bytes(range(200)))
        eng = NativeIOEngine(3)
        try:
            out = np.zeros(32, np.uint8)
            eng.read_segments([str(a)], [(0, 10, 0, 16), (0, 100, 16, 16)], out)
            assert bytes(out[:16]) == bytes(range(10, 26))
            assert bytes(out[16:]) == bytes(range(100, 116))
            with pytest.raises(NativeIOError):
                eng.read_segments([str(a)], [(0, 190, 0, 32)], out)  # EOF short
            with pytest.raises(ValueError):
                eng.read_segments([str(a)], [(0, 0, 30, 16)], out)  # overflow
            with pytest.raises(ValueError):
                eng.read_segments([str(a)], [(5, 0, 0, 8)], out)  # bad index
        finally:
            eng.close()

    def test_many_segments_stress(self, tmp_path):
        blob = np.random.default_rng(2).integers(0, 256, size=1 << 20, dtype=np.uint8)
        f = tmp_path / "big.bin"
        f.write_bytes(blob.tobytes())
        eng = NativeIOEngine(8)
        try:
            n, chunk = 2048, 512
            out = np.zeros(n * chunk, np.uint8)
            segs = [(0, (i * 37) % ((1 << 20) - chunk), i * chunk, chunk) for i in range(n)]
            eng.read_segments([str(f)], segs, out)
            for i in (0, 1, 777, n - 1):
                foff = (i * 37) % ((1 << 20) - chunk)
                assert (out[i * chunk : (i + 1) * chunk] == blob[foff : foff + chunk]).all()
        finally:
            eng.close()


class TestStorageNativePath:
    def test_differential_multifile(self, tmp_path):
        root, m, payload = make_multifile(tmp_path, [40_000, 1_000, 25_000], 16384)
        storage = Storage(FsStorage(root), m.info)
        idx = list(range(m.info.num_pieces))
        got, lens = storage.read_batch(idx)
        want, wlens = python_read(Storage(FsStorage(root), m.info), idx)
        assert (lens == wlens).all()
        assert (got == want).all()
        # content is actually right, not just self-consistent
        flat = b"".join(
            got[i, : lens[i]].tobytes() for i in range(m.info.num_pieces)
        )
        assert flat == payload

    def test_differential_missing_file(self, tmp_path):
        root, m, _ = make_multifile(tmp_path, [30_000, 20_000, 30_000], 16384, seed=3)
        os.unlink(root / "t" / "f1.bin")
        idx = list(range(m.info.num_pieces))
        got, _ = Storage(FsStorage(root), m.info).read_batch(idx)
        want, _ = python_read(Storage(FsStorage(root), m.info), idx)
        assert (got == want).all()
        assert got.sum() > 0  # f0/f2 data still present

    def test_differential_truncated_file(self, tmp_path):
        root, m, payload = make_multifile(tmp_path, [50_000], 16384, seed=4)
        p = root / "t" / "f0.bin"
        p.write_bytes(payload[:20_000])  # crash-truncated
        idx = list(range(m.info.num_pieces))
        got, _ = Storage(FsStorage(root), m.info).read_batch(idx)
        want, _ = python_read(Storage(FsStorage(root), m.info), idx)
        assert (got == want).all()

    def test_strided_staging_view(self, tmp_path):
        """read_batch into a padded-buffer view (the verify plane's shape)."""
        root, m, payload = make_multifile(tmp_path, [70_000], 16384, seed=5)
        storage = Storage(FsStorage(root), m.info)
        n = m.info.num_pieces
        padded = np.full((n, 16384 + 64), 0xEE, dtype=np.uint8)
        view = padded[:, :16384]
        view[:] = 0
        storage.read_batch(list(range(n)), out=view)
        flat = b"".join(
            view[i, : min(16384, len(payload) - i * 16384)].tobytes() for i in range(n)
        )
        assert flat == payload
        assert (padded[:, 16384:] == 0xEE).all()  # pad region untouched
