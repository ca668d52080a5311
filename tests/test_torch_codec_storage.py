"""The port's device-free base (codec, byte utils, storage) against the
reference package, on identical seeded inputs.

Everything here compares exactly: these layers move bytes and integers.
"""

import hashlib
import importlib
import os

import numpy as np
import pytest

from torrent_tpu.codec import metainfo as ref_metainfo
from torrent_tpu.storage import piece as ref_piece
from torrent_tpu.storage import storage as ref_storage
from torrent_tpu.utils import bytesio as ref_bytesio
from torrent_tpu_torch.codec import metainfo as mi
from torrent_tpu_torch.compat import info_from_reference
from torrent_tpu_torch.storage import piece, storage
from torrent_tpu_torch.utils import bytesio, env
from torrent_tpu_torch.utils.locks import named_lock

# the codec packages re-export the bencode *function* under the module's name
ref_bencode = importlib.import_module("torrent_tpu.codec.bencode")
bc = importlib.import_module("torrent_tpu_torch.codec.bencode")

VALUES = [
    b"",
    b"spam",
    bytes(range(256)),
    "unicode é",
    0,
    -42,
    2**70,
    [],
    [b"a", 1, [b"b", [2]]],
    {},
    {b"z": 1, b"a": [b"x"], "m": {b"inner": b"\x00\xff"}},
    {b"\x01\x02": b"binary key", b"\x00": 0},
]


def make_torrent_bytes(name=b"test", piece_length=16384, length=40000, files=None,
                       announce=b"http://tr/announce", extra_info=None):
    n_pieces = (length + piece_length - 1) // piece_length
    info = {
        b"name": name,
        b"piece length": piece_length,
        b"pieces": b"".join(hashlib.sha1(bytes([i])).digest() for i in range(n_pieces)),
    }
    if files is not None:
        info[b"files"] = [
            {b"length": ln, b"path": list(p), **({b"attr": b"p"} if pad else {})}
            for ln, p, pad in files
        ]
    else:
        info[b"length"] = length
    if extra_info:
        info.update(extra_info)
    return bc.bencode({b"announce": announce, b"info": info})


class TestBencode:
    @pytest.mark.parametrize("value", VALUES)
    def test_round_trip_and_same_bytes_as_reference(self, value):
        for sort_keys in (True, False):
            data = bc.bencode(value, sort_keys=sort_keys)
            assert data == ref_bencode.bencode(value, sort_keys=sort_keys)
            assert bc.bdecode(data) == ref_bencode.bdecode(data)
        assert bc.bencode(bc.bdecode(bc.bencode(value))) == bc.bencode(value)

    @pytest.mark.parametrize(
        "bad",
        [b"", b"i12", b"i1x2e", b"i03e", b"i-0e", b"5:abc", b"12", b"l i1e", b"li1e",
         b"d3:abc", b"di1ei2ee", b"x", b"99999999999:", b"i1ex"],
    )
    def test_malformed_rejected_like_reference(self, bad):
        with pytest.raises(bc.BencodeError):
            bc.bdecode(bad)
        with pytest.raises(ref_bencode.BencodeError):
            ref_bencode.bdecode(bad)

    @pytest.mark.parametrize("value", [True, 1.5, None, {1: b"x"}])
    def test_unencodable(self, value):
        with pytest.raises(bc.BencodeError):
            bc.bencode(value)

    def test_info_span_and_prefix_match_reference(self):
        info = {b"name": b"f", b"piece length": 1, b"pieces": b"\x01" * 20, b"length": 1}
        data = bc.bencode({b"announce": b"http://t", b"info": info})
        assert bc.bdecode_with_info_span(data) == ref_bencode.bdecode_with_info_span(data)
        assert bc.bdecode_prefix(data + b"tail") == ref_bencode.bdecode_prefix(data + b"tail")


def _same_info(port, ref):
    assert port.name == ref.name
    assert port.piece_length == ref.piece_length
    assert port.pieces == ref.pieces
    assert port.length == ref.length
    if ref.files is None:
        assert port.files is None
    else:
        assert [(f.length, f.path, f.pad) for f in port.files] == [
            (f.length, f.path, f.pad) for f in ref.files
        ]


class TestMetainfo:
    @pytest.mark.parametrize(
        "kwargs",
        [
            {},
            {"length": 16384},
            {"files": [(10, [b"a"], False), (30000, [b"d", b"b"], False), (5, [b"c"], False)]},
            {"files": [(100, [b"a"], False), (16284, [b".pad", b"16284"], True), (9, [b"b"], False)]},
            {"extra_info": {b"private": 1, b"similar": [b"\x02" * 20]}},
        ],
    )
    def test_parse_matches_reference(self, kwargs):
        if "files" in kwargs:
            kwargs = dict(kwargs, length=sum(f[0] for f in kwargs["files"]))
        data = make_torrent_bytes(**kwargs)
        port, ref = mi.parse_metainfo(data), ref_metainfo.parse_metainfo(data)
        assert ref is not None and port is not None
        _same_info(port.info, ref.info)
        assert port.info_hash == ref.info_hash == hashlib.sha1(
            bc.bencode(bc.bdecode(data)[b"info"])
        ).digest()
        assert port.announce == ref.announce
        assert port.similar == ref.similar and port.web_seeds == ref.web_seeds

    @pytest.mark.parametrize(
        "data",
        [
            b"garbage",
            make_torrent_bytes(extra_info={b"files": [{b"length": 1, b"path": [b"x"]}]}),
            make_torrent_bytes(extra_info={b"pieces": b"\x00" * 20}),  # 1 digest, 3 pieces
            make_torrent_bytes(extra_info={b"piece length": 0}),
            make_torrent_bytes(announce=b"\xff\xfe"),
            make_torrent_bytes(length=0),  # no pieces at all
            bc.bencode({b"announce": b"x"}),
        ],
        ids=["garbage", "length-and-files", "piece-count", "piece-length-0", "announce-utf8",
             "no-pieces", "no-info"],
    )
    def test_invalid_returns_none_like_reference(self, data):
        assert mi.parse_metainfo(data) is None
        assert ref_metainfo.parse_metainfo(data) is None

    def test_fixtures_match_reference(self, ref_fixtures):
        for path in sorted(ref_fixtures.glob("*.torrent")):
            data = path.read_bytes()
            port, ref = mi.parse_metainfo(data), ref_metainfo.parse_metainfo(data)
            assert (port is None) == (ref is None), path.name
            if ref is not None:
                _same_info(port.info, ref.info)
                assert port.info_hash == ref.info_hash

    def test_parse_any_metainfo_is_v1_only(self):
        data = make_torrent_bytes()
        meta, ih = mi.parse_any_metainfo(data)
        assert ih == ref_metainfo.parse_any_metainfo(data)[1]
        assert mi.parse_any_metainfo(b"garbage") is None
        v2 = bc.bencode({
            b"announce": b"http://t",
            b"info": {b"meta version": 2, b"name": b"x", b"piece length": 16384,
                      b"file tree": {b"x": {b"": {b"length": 1, b"pieces root": b"\x00" * 32}}}},
        })
        with pytest.raises(NotImplementedError):
            mi.parse_any_metainfo(v2)

    def test_info_from_reference(self):
        files = [(100, [b"a"], False), (16284, [b".pad", b"16284"], True), (9, [b"b"], False)]
        data = make_torrent_bytes(files=files, length=sum(f[0] for f in files))
        ref = ref_metainfo.parse_metainfo(data).info
        carried = info_from_reference(ref)
        assert isinstance(carried, mi.InfoDict)
        assert carried == mi.parse_metainfo(data).info


class TestBytesUtils:
    @pytest.mark.parametrize("blob", [b"", b"\x00\xff abc~-_.", bytes(range(256))])
    def test_binary_escaping_matches_reference(self, blob):
        enc = bytesio.encode_binary_data(blob)
        assert enc == ref_bytesio.encode_binary_data(blob)
        assert bytesio.decode_binary_data(enc) == blob

    @pytest.mark.parametrize("n", [1, 2, 4, 8])
    def test_int_helpers_match_reference(self, n):
        value = (1 << (8 * n)) - 3
        raw = bytesio.write_int(value, n)
        assert raw == ref_bytesio.write_int(value, n)
        assert bytesio.read_int(raw, n) == value

    def test_partition(self):
        data = bytes(range(50))
        assert bytesio.partition(data, 20) == ref_bytesio.partition(data, 20)

    def test_env_knobs(self, monkeypatch):
        monkeypatch.setenv("TT_TEST_INT", "7")
        monkeypatch.setenv("TT_TEST_BOOL", "on")
        assert env.env_int("TT_TEST_INT", 3) == 7
        assert env.env_bool("TT_TEST_BOOL") is True
        monkeypatch.setenv("TT_TEST_INT", "junk")
        assert env.env_int("TT_TEST_INT", 3) == 3

    def test_named_lock_is_a_lock(self):
        lock = named_lock("test.lock")
        with lock:
            assert lock.locked()
        assert not lock.locked()


def _infos(length, piece_length, files=None):
    """The same InfoDict in both packages."""
    ref_files = None
    if files is not None:
        ref_files = tuple(
            ref_metainfo.FileEntry(length=ln, path=p, pad=pad) for ln, p, pad in files
        )
    n = -(-length // piece_length)
    ref = ref_metainfo.InfoDict(
        name="t", piece_length=piece_length, pieces=(b"\x00" * 20,) * n,
        length=length, files=ref_files,
    )
    return info_from_reference(ref), ref


class TestPieceGeometry:
    @pytest.mark.parametrize("length,plen", [(100_000, 16384), (65536, 16384), (1, 16384)])
    def test_piece_and_block_math_matches_reference(self, length, plen):
        info, ref = _infos(length, plen)
        for i in range(info.num_pieces):
            assert piece.piece_length(info, i) == ref_piece.piece_length(ref, i)
            assert piece.num_blocks(info, i) == ref_piece.num_blocks(ref, i)
        with pytest.raises(IndexError):
            piece.piece_length(info, info.num_pieces)


MULTI = [
    (50_000, ("a",), False),
    (0, ("empty",), False),
    (14_000, (".pad", "14000"), True),
    (80_000, ("b", "c"), False),
    (20_123, ("d",), False),
]


def _fill(store_port, store_ref, payload):
    for off in range(0, len(payload), 7000):
        chunk = payload[off : off + 7000]
        store_port.set(off, chunk)
        store_ref.set(off, chunk)


class TestStorage:
    def _pair(self, files, method_port, method_ref, seed=0):
        length = sum(f[0] for f in files) if files else 164_123
        info, ref = _infos(length, 16384, files)
        rng = np.random.default_rng(seed)
        payload = bytearray(rng.integers(0, 256, size=length, dtype=np.uint8).tobytes())
        if files:
            pos = 0
            for ln, _p, pad in files:  # pad spans hold zeros by definition
                if pad:
                    payload[pos : pos + ln] = bytes(ln)
                pos += ln
        sp, sr = storage.Storage(method_port, info), ref_storage.Storage(method_ref, ref)
        _fill(sp, sr, bytes(payload))
        return info, sp, sr, bytes(payload)

    @pytest.mark.parametrize("files", [None, MULTI])
    def test_segments_and_get_match_reference(self, files):
        info, sp, sr, payload = self._pair(files, storage.MemoryStorage(), ref_storage.MemoryStorage())
        for off, ln in [(0, 100), (49_990, 20), (60_000, 70_000), (info.length - 5, 5)]:
            assert list(sp.segments(off, ln)) == list(sr.segments(off, ln))
            assert sp.get(off, ln) == sr.get(off, ln) == payload[off : off + ln]
        for i in range(info.num_pieces):
            assert sp.read_piece(i) == sr.read_piece(i)
        assert sp.exists() == sr.exists()
        with pytest.raises(storage.StorageError):
            sp.get(info.length - 1, 2)

    def test_duplicate_block_suppressed(self):
        info, _ = _infos(40_000, 16384)
        sp = storage.Storage(storage.MemoryStorage(), info)
        assert sp.set(0, b"x" * 10) is True
        assert sp.set(0, b"y" * 10) is False

    @pytest.mark.parametrize("backend", ["memory", "fs"])
    @pytest.mark.parametrize("files", [None, MULTI])
    def test_read_batch_matches_reference(self, backend, files, tmp_path):
        if backend == "fs":
            mp, mr = storage.FsStorage(tmp_path), ref_storage.FsStorage(tmp_path)
        else:
            mp, mr = storage.MemoryStorage(), ref_storage.MemoryStorage()
        info, sp, sr, _ = self._pair(files, mp, mr, seed=3)
        idxs = list(range(info.num_pieces))[::-1]
        out_p, len_p = sp.read_batch(idxs)
        out_r, len_r = sr.read_batch(idxs)
        assert (out_p == out_r).all() and (len_p == len_r).all()

    @pytest.mark.parametrize("backend", ["memory", "fs"])
    def test_read_batch_row_status_and_dirty_pads(self, backend, tmp_path):
        """Missing and truncated files mark their rows; pad spans are
        zeroed even in a dirty reused buffer with zero_fill=False."""
        if backend == "fs":
            mp, mr = storage.FsStorage(tmp_path), ref_storage.FsStorage(tmp_path)
        else:
            mp, mr = storage.MemoryStorage(), ref_storage.MemoryStorage()
        info, sp, sr, _ = self._pair(MULTI, mp, mr, seed=4)
        if backend == "fs":
            os.remove(tmp_path / "t" / "d")
            with open(tmp_path / "t" / "a", "r+b") as f:
                f.truncate(30_000)
        else:
            for m in (mp, mr):
                del m.files[("t", "d")]
                m.files[("t", "a")] = m.files[("t", "a")][:30_000]
        n = info.num_pieces
        results = []
        for s in (sp, sr):
            out = np.full((n, info.piece_length), 0xAB, dtype=np.uint8)
            status = np.zeros(n, dtype=bool)
            _, lengths = s.read_batch(range(n), out=out, row_status=status, zero_fill=False)
            results.append((out, status, lengths))
        (op, stp, lp), (orf, strf, lr) = results
        assert (stp == strf).all() and (lp == lr).all()
        assert not stp.all() and stp.any()
        for row in np.nonzero(stp)[0]:  # rows that read fully agree byte for byte
            assert (op[row, : lp[row]] == orf[row, : lr[row]]).all()
        # the pad span (global [50_000, 64_000)) is zeros in piece 3
        assert not op[3, 50_000 - 3 * 16384 : 64_000 - 3 * 16384].any()

    def test_read_batch_rejects_bad_buffers(self):
        info, _ = _infos(40_000, 16384)
        sp = storage.Storage(storage.MemoryStorage(), info)
        with pytest.raises(storage.StorageError):
            sp.read_batch([0], out=np.zeros((1, 10), dtype=np.uint8))
        with pytest.raises(storage.StorageError):
            sp.read_batch([0], row_status=np.zeros(2, dtype=bool))

    def test_fs_rejects_unsafe_paths(self, tmp_path):
        fs = storage.FsStorage(tmp_path)
        for bad in [("..", "x"), ("a/b",), ("",)]:
            with pytest.raises(storage.StorageError):
                fs.set(bad, 0, b"x")

    def test_native_pool_builds_into_build_dir(self):
        from torrent_tpu_torch.native import build, io_engine

        if not io_engine.native_available():
            pytest.skip("no host C++ toolchain: the pure-Python read path is in use")
        assert build.build().parent == build.BUILD_DIR
        assert build.BUILD_DIR.parts[-2:] == ("build", "torrent_tpu_torch")
