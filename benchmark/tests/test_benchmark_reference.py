"""The plain reference and the frozen yardstick: FIPS 180 and BEP 52
vectors, agreement with the port's own hashlib paths, and the trace
arithmetic. Run with ``python -m pytest benchmark/tests -q``."""

from __future__ import annotations

import ast
import hashlib
import os
from pathlib import Path

import numpy as np
import pytest

from benchmark.reference import hashes, yardstick
from benchmark.reference.bencode import bdecode, bencode
from benchmark.reference.metainfo import v1_single_file, v2_single_file

REFERENCE = Path(__file__).resolve().parent.parent / "reference"

# FIPS 180-4 examples (one block, two blocks)
FIPS = [
    (b"abc", "a9993e364706816aba3e25717850c26c9cd0d89d",
     "ba7816bf8f01cfea414140de5dae2223b00361a396177a9cb410ff61f20015ad"),
    (b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq",
     "84983e441c3bd26ebaae4aa1f95129e5e54670f1",
     "248d6a61d20638b8e5c026930c3e6039a33ce45964ff2167f6ecedd419db06c1"),
]


@pytest.mark.parametrize("msg,sha1,sha256", FIPS)
def test_fips180_vectors(msg, sha1, sha256):
    assert hashes.sha1_pieces(msg, 1 << 20)[0].hex() == sha1
    assert hashes.leaf_hashes(msg)[0].hex() == sha256
    # a single-leaf file's root is its leaf (BEP 52: a tree of one leaf)
    assert hashes.v2_small_file_root(msg).hex() == sha256


def test_sha1_pieces_short_last_piece():
    data = os.urandom(3 * 1000 + 17)
    want = [hashlib.sha1(data[s : s + 1000]).digest() for s in range(0, len(data), 1000)]
    assert hashes.sha1_pieces(data, 1000) == want


def test_bep52_merkle_padding():
    """A tree pads with zero hashes to its width; a file root pads the
    piece layer with the root of a whole zero piece."""
    a, b, c = (hashlib.sha256(bytes([i])).digest() for i in range(3))
    h = lambda x, y: hashlib.sha256(x + y).digest()  # noqa: E731
    z = hashes.ZERO
    assert hashes.merkle_root([a, b, c], 4) == h(h(a, b), h(c, z))
    assert hashes.merkle_root([a], 1) == a
    with pytest.raises(ValueError):
        hashes.merkle_root([a, b, c], 2)
    zero_piece = hashes.merkle_root([], 2)
    assert zero_piece == h(z, z)
    assert hashes.v2_file_root([a, b, c], 2 * hashes.LEAF) == h(h(a, b), h(c, zero_piece))


def test_v2_piece_roots_match_port():
    """The reference's piece layer equals the port's hashlib piece root
    (``models/merkle.py::piece_root_cpu``) for full and short pieces."""
    from torrent_tpu_torch.models.merkle import piece_root_cpu

    plen = 4 * hashes.LEAF
    data = os.urandom(2 * plen + 3 * hashes.LEAF - 5)
    roots = hashes.v2_piece_roots(data, plen)
    assert roots == [piece_root_cpu(data[s : s + plen], 4) for s in range(0, len(data), plen)]


def test_v2_file_root_matches_port_authoring(tmp_path):
    """A v2 torrent authored by the reference names the same pieces root
    and piece layer as the port's ``build_v2`` on hashlib."""
    from torrent_tpu_torch.models.v2 import build_v2

    plen = 2 * hashes.LEAF
    data = os.urandom(5 * plen + 1234)
    roots = hashes.v2_piece_roots(data, plen)
    meta = bdecode(v2_single_file("f.bin", len(data), plen, roots))
    entry = meta[b"info"][b"file tree"][b"f.bin"][b""]
    port = build_v2([(("f.bin",), data)], "f.bin", plen, hasher="cpu")
    assert port.info.files[0].pieces_root == entry[b"pieces root"]
    assert b"".join(port.piece_layers[entry[b"pieces root"]]) == meta[b"piece layers"][entry[b"pieces root"]]


@pytest.mark.parametrize("version", [1, 2])
def test_port_recheck_of_reference_torrent(tmp_path, version):
    """The port parses the reference's torrents, and its hashlib recheck
    agrees with the reference's bitfield after one flipped byte."""
    from torrent_tpu_torch.parallel.verify import verify_pieces
    from torrent_tpu_torch.storage.storage import FsStorage, Storage

    plen = 16384 if version == 1 else 2 * hashes.LEAF
    data = bytearray(os.urandom(7 * plen + 999))
    path = tmp_path / "payload.bin"
    if version == 1:
        from torrent_tpu_torch.codec.metainfo import parse_metainfo

        info = parse_metainfo(v1_single_file("payload.bin", len(data), plen, hashes.sha1_pieces(bytes(data), plen))).info
    else:
        from torrent_tpu_torch.codec.metainfo_v2 import parse_metainfo_v2
        from torrent_tpu_torch.session.v2 import v2_session_info

        m = parse_metainfo_v2(v2_single_file("payload.bin", len(data), plen, hashes.v2_piece_roots(bytes(data), plen)))
        info = v2_session_info(m.info, m.piece_layers)
    data[3 * plen + 5] ^= 0x40
    path.write_bytes(bytes(data))
    bf = verify_pieces(Storage(FsStorage(str(tmp_path)), info), info, hasher="cpu")
    assert list(np.flatnonzero(~bf)) == [3]


def test_bencode_round_trip():
    value = {b"b": [1, -2, b"x"], b"a": {b"k": b""}, "s": 0}
    raw = bencode(value)
    assert raw == b"d1:ad1:k0:e1:bli1ei-2e1:xe1:si0ee"
    assert bdecode(raw) == {b"a": {b"k": b""}, b"b": [1, -2, b"x"], b"s": 0}
    with pytest.raises(ValueError):
        bdecode(raw + b"x")


def test_yardstick_model():
    assert [yardstick.md_blocks(n) for n in (0, 55, 56, 64, 262144)] == [1, 1, 2, 2, 4097]
    assert yardstick.SHA1_OPS_PER_BLOCK == 613
    assert yardstick.SHA256_OPS_PER_BLOCK == 1400
    assert yardstick.MERKLE_OPS_PER_PAIR == 2288
    # the dispatch limit: 128 lane-ops a clock on each of 132 SMs at 1.98 GHz
    assert yardstick.PEAK_INT_OPS_PER_S == pytest.approx(33.45408e12)
    ops, nbytes = yardstick.sha1_work([262144] * 4096)
    assert ops == 4096 * 4097 * 613 and nbytes == 4096 * (262144 + 20)
    # a 4096-row SHA-1 launch of 256 KiB pieces is bound by memory, by a hair
    assert yardstick.least_seconds(ops, nbytes) == pytest.approx(nbytes / yardstick.HBM_BYTES_PER_S)
    ops, nbytes = yardstick.merkle_work([64, 64])
    assert ops == 2 * 63 * 2288 and nbytes == 32 * 128 + 64


def test_union_and_merge():
    spans = [(0, 10), (5, 20), (30, 40), (40, 41)]
    assert yardstick.union_s(spans) == pytest.approx(31e-6)
    assert yardstick.merged(spans) == [(0, 20), (30, 41)]
    assert yardstick.union_s([]) == 0.0


def test_reference_imports_no_port_and_no_jax():
    """``benchmark/reference/`` imports only the standard library, NumPy
    and itself: never torch, JAX, the JAX package or the port."""
    allowed_roots = {"hashlib", "concurrent", "__future__", "numpy", "benchmark"}
    for path in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in allowed_roots, f"{path.name} imports {n}"
                if n.startswith("benchmark"):
                    assert n.startswith("benchmark.reference"), f"{path.name} imports {n}"
