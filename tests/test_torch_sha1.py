"""The port's SHA-1 against the reference, on the CPU.

Cases of tests/test_sha1.py and tests/test_sha1_pallas.py (NIST vectors,
ragged lengths, multi-block chains, sentinel rows, u8 and host-order u32
input) run through ``torrent_tpu_torch``'s plain PyTorch SHA-1 and its
kernel wrapper (which takes CPU tensors to the plain version), and are
held against hashlib, ``sha1_pieces_jax`` and ``sha1_pieces_pallas`` in
interpret mode. Digests and words compare exactly: SHA-1 is integer
arithmetic, so no tolerance applies.

Inputs are made from seeded numpy generators. Sizes stay small (the
plain version runs ~1,400 tensor ops per block), so the 1,000,000-byte
NIST vector runs only in the GPU tests (tests/test_torch_gpu.py).
"""

import hashlib

import numpy as np
import pytest
import torch

from torrent_tpu.ops import padding as ref_padding
from torrent_tpu.ops.sha1_jax import sha1_pieces_jax
from torrent_tpu.ops.sha1_pallas import sha1_pieces_pallas
from torrent_tpu_torch.ops import padding
from torrent_tpu_torch.ops.sha1_cuda import sha1_pieces_cuda
from torrent_tpu_torch.ops.sha1_torch import IV, sha1_pieces_torch, words_to_numpy

NIST = [
    (b"", "da39a3ee5e6b4b0d3255bfef95601890afd80709"),
    (b"abc", "a9993e364706816aba3e25717850c26c9cd0d89d"),
    (
        b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq",
        "84983e441c3bd26ebaae4aa1f95129e5e54670f1",
    ),
]


def rand_pieces(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in lengths]


def torch_words(padded, nblocks, as_u32=False, fn=sha1_pieces_torch):
    data = padded.view(np.uint32).view(np.int32) if as_u32 else padded
    return words_to_numpy(fn(torch.from_numpy(data), torch.from_numpy(nblocks)))


def torch_digests(pieces, as_u32=False, fn=sha1_pieces_torch):
    padded, nblocks = padding.pad_pieces(pieces)
    return padding.words_to_digests(torch_words(padded, nblocks, as_u32, fn))


class TestPadding:
    @pytest.mark.parametrize(
        "n,expect",
        [(0, 128), (55, 128), (56, 128), (64, 128), (119, 128), (120, 256), (262144, 262272),
         (1 << 20, 1048704)],
    )
    def test_padded_len_matches_reference(self, n, expect):
        assert padding.padded_len_for(n) == expect == ref_padding.padded_len_for(n)
        assert int(padding.num_blocks_for(n)) == int(ref_padding.num_blocks_for(n))

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_pad_in_place_matches_reference(self, seed):
        rng = np.random.default_rng(seed)
        lengths = rng.integers(0, 1000, size=9)
        a, _ = padding.alloc_padded(9, 1000)
        b, _ = ref_padding.alloc_padded(9, 1000)
        for i, n in enumerate(lengths):
            row = rng.integers(0, 256, size=n, dtype=np.uint8)
            a[i, :n] = row
            b[i, :n] = row
        assert (padding.pad_in_place(a, lengths) == ref_padding.pad_in_place(b, lengths)).all()
        assert (a == b).all()

    def test_pad_rejects_oversize(self):
        padded, _ = padding.alloc_padded(1, 8)  # 128-byte rows
        with pytest.raises(ValueError):
            padding.pad_in_place(padded, np.array([120]))  # needs 192 > 128

    def test_digest_words_roundtrip(self):
        digs = [hashlib.sha1(bytes([i])).digest() for i in range(7)]
        words = padding.digests_to_words(digs)
        assert (words == ref_padding.digests_to_words(digs)).all()
        assert padding.words_to_digests(words) == digs


class TestNISTVectors:
    @pytest.mark.parametrize("as_u32", [False, True])
    def test_vectors(self, as_u32):
        got = torch_digests([m for m, _ in NIST], as_u32=as_u32)
        assert [d.hex() for d in got] == [h for _, h in NIST]

    @pytest.mark.parametrize("n", [119, 120, 127, 128])
    def test_padding_boundary_straddles(self, n):
        assert torch_digests([b"x" * n]) == [hashlib.sha1(b"x" * n).digest()]


class TestDifferential:
    def test_random_uniform_lengths(self):
        pieces = rand_pieces([1024] * 33, seed=42)
        assert torch_digests(pieces) == [hashlib.sha1(p).digest() for p in pieces]

    @pytest.mark.parametrize("as_u32", [False, True])
    def test_ragged_batch(self, as_u32):
        pieces = rand_pieces([0, 1, 63, 64, 65, 500, 4096, 700], seed=7)
        assert torch_digests(pieces, as_u32) == [hashlib.sha1(p).digest() for p in pieces]

    @pytest.mark.parametrize(
        "lens",
        [
            [0, 1, 55, 56, 63, 64, 65, 119, 120, 127, 128, 300, 1024],
            [320, 64, 256, 130],
            [200, 64, 129, 500, 448, 1, 320, 200],
        ],
    )
    def test_pallas_cases_vs_hashlib(self, lens):
        pieces = rand_pieces(lens, seed=sum(lens))
        assert torch_digests(pieces) == [hashlib.sha1(p).digest() for p in pieces]

    def test_torrent_shaped_batch(self):
        # 16 KiB pieces + a short last piece, like a recheck batch
        rng = np.random.default_rng(3)
        plen = 16 * 1024
        data = rng.integers(0, 256, size=plen * 3 + 12345, dtype=np.uint8).tobytes()
        pieces = [data[i : i + plen] for i in range(0, len(data), plen)]
        assert torch_digests(pieces) == [hashlib.sha1(p).digest() for p in pieces]

    def test_single_piece_batch(self):
        assert torch_digests([b"hello world"]) == [hashlib.sha1(b"hello world").digest()]

    def test_empty_batch(self):
        padded, nblocks = padding.pad_pieces([])
        assert padded.shape[0] == 0
        words = sha1_pieces_torch(
            torch.zeros((0, 64), dtype=torch.uint8), torch.zeros(0, dtype=torch.int32)
        )
        assert words.shape == (0, 5) and words.dtype == torch.int32


class TestAgainstJaxAndPallas:
    """Identical seeded batches through the port and the reference."""

    @pytest.mark.parametrize(
        "rows,max_len,seed",
        [(1, 200, 0), (5, 200, 17), (8, 700, 1), (13, 1024, 2), (32, 300, 3)],
    )
    def test_matches_sha1_pieces_jax(self, rows, max_len, seed):
        rng = np.random.default_rng(seed)
        pieces = rand_pieces(rng.integers(0, max_len, size=rows), seed)
        padded, nblocks = ref_padding.pad_pieces(pieces)
        ref = np.asarray(sha1_pieces_jax(padded, nblocks))
        assert (torch_words(padded, nblocks) == ref).all()
        assert (torch_words(padded, nblocks, as_u32=True) == ref).all()

    @pytest.mark.parametrize("lens,seed", [([0, 1, 55, 56, 63, 64, 65, 130], 11), ([320, 64, 256, 130], 13)])
    def test_matches_sha1_pieces_pallas_interpret(self, lens, seed):
        pieces = rand_pieces(lens, seed)
        padded, nblocks = ref_padding.pad_pieces(pieces)
        ref = np.asarray(sha1_pieces_pallas(padded, nblocks, interpret=True))
        assert (torch_words(padded, nblocks) == ref).all()
        assert padding.words_to_digests(ref) == [hashlib.sha1(p).digest() for p in pieces]

    def test_sentinel_and_out_of_range_counts_match_jax(self):
        # nblocks = 0 never runs (IV out); negative counts run nothing and
        # counts past the row run to its end, in both packages
        pieces = rand_pieces([100, 300, 64, 0, 250], seed=5)
        padded, nblocks = ref_padding.pad_pieces(pieces)
        nblocks = nblocks.copy()
        nblocks[[0, 3]] = 0
        nblocks[1] = -4
        nblocks[2] = 10_000
        ref = np.asarray(sha1_pieces_jax(padded, nblocks))
        got = torch_words(padded, nblocks)
        assert (got == ref).all()
        assert tuple(got[0]) == IV and tuple(got[1]) == IV and tuple(got[3]) == IV


class TestWrapperOnCpu:
    """sha1_pieces_cuda takes CPU tensors to the plain version, uncounted."""

    def test_cpu_tensor_runs_plain_version_and_counts_nothing(self):
        pieces = rand_pieces([0, 77, 640, 1000], seed=9)
        before = sha1_pieces_cuda.launches
        assert torch_digests(pieces, fn=sha1_pieces_cuda) == [hashlib.sha1(p).digest() for p in pieces]
        assert torch_digests(pieces, as_u32=True, fn=sha1_pieces_cuda) == [
            hashlib.sha1(p).digest() for p in pieces
        ]
        assert sha1_pieces_cuda.launches == before

    @pytest.mark.parametrize(
        "data,nblocks,exc",
        [
            (torch.zeros(128, dtype=torch.uint8), torch.zeros(1, dtype=torch.int32), ValueError),
            (torch.zeros((1, 128), dtype=torch.float32), torch.zeros(1, dtype=torch.int32), TypeError),
            (torch.zeros((1, 100), dtype=torch.uint8), torch.zeros(1, dtype=torch.int32), ValueError),
            (torch.zeros((2, 128), dtype=torch.uint8), torch.zeros(3, dtype=torch.int32), ValueError),
            (torch.zeros((2, 128), dtype=torch.uint8), torch.zeros(2, dtype=torch.int64), TypeError),
            (torch.zeros((1, 24), dtype=torch.int32), torch.zeros(1, dtype=torch.int32), ValueError),
        ],
    )
    def test_rejects_what_the_kernel_does_not_take(self, data, nblocks, exc):
        with pytest.raises(exc):
            sha1_pieces_cuda(data, nblocks)
        with pytest.raises(exc):
            sha1_pieces_torch(data, nblocks)
