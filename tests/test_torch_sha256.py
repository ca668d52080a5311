"""The port's SHA-256 and merkle pair levels against the reference, on the CPU.

Cases of tests/test_v2.py's kernel tests (NIST vectors, ragged lengths,
sentinel rows, u8 and host-order u32 input, pair levels, the fused
all-levels reduction) run through ``torrent_tpu_torch``'s plain PyTorch
SHA-256 and its kernel wrappers (which take CPU tensors to the plain
version), and are held against hashlib, ``sha256_pieces_jax``, the
reference's ``sha256_pairs`` and ``_merkle_reduce_fused``, and
``sha256_pieces_pallas`` in interpret mode on short messages (interpret
mode is only practical there). Digests and words compare exactly:
SHA-256 is integer arithmetic, so no tolerance applies.

Inputs are made from seeded numpy generators. The plain version pays
about 6 ms of CPU per 64-byte block of the longest row, so a full 16 KiB
leaf (257 blocks) costs about 1.5 s; the 1,000,000-byte NIST vector runs
only in the GPU tests (tests/test_torch_gpu.py).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torrent_tpu.models.merkle import _merkle_reduce_fused as ref_merkle_reduce_fused
from torrent_tpu.models.merkle import sha256_pairs as ref_sha256_pairs
from torrent_tpu.ops import padding as ref_padding
from torrent_tpu.ops.sha256_jax import sha256_pieces_jax
from torrent_tpu.ops.sha256_pallas import sha256_pieces_pallas
from torrent_tpu_torch.models import merkle
from torrent_tpu_torch.ops import padding
from torrent_tpu_torch.ops import sha256_cuda
from torrent_tpu_torch.ops.sha1_torch import words_to_numpy
from torrent_tpu_torch.ops.sha256_cuda import make_sha256_fn, sha256_pairs_cuda, sha256_pieces_cuda
from torrent_tpu_torch.ops.sha256_torch import IV, sha256_pairs_torch, sha256_pieces_torch

NIST = [
    (b"", "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
    (b"abc", "ba7816bf8f01cfea414140de5dae2223b00361a396177a9cb410ff61f20015ad"),
    (
        b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq",
        "248d6a61d20638b8e5c026930c3e6039a33ce45964ff2167f6ecedd419db06c1",
    ),
]


def rand_pieces(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in lengths]


def torch_words(padded, nblocks, as_u32=False, fn=sha256_pieces_torch):
    data = padded.view(np.uint32).view(np.int32) if as_u32 else padded
    return words_to_numpy(fn(torch.from_numpy(data), torch.from_numpy(nblocks)))


def torch_digests(pieces, as_u32=False, fn=sha256_pieces_torch):
    padded, nblocks = padding.pad_pieces(pieces)
    return padding.words_to_digests(torch_words(padded, nblocks, as_u32, fn))


def pair_words(kids):
    return torch.from_numpy(
        padding.digests_to_words(kids, words=8).reshape(-1, 16).view(np.int32)
    )


REF_PAIRS = 64  # every reference pair call is padded to one shape: one jit compile


def ref_pairs(words: np.ndarray) -> np.ndarray:
    """The reference's ``sha256_pairs`` on ``u32[M <= 64, 16]``."""
    padded = np.zeros((REF_PAIRS, 16), dtype=np.uint32)
    padded[: words.shape[0]] = words
    return np.asarray(ref_sha256_pairs(jnp.asarray(padded)))[: words.shape[0]]


class TestRows:
    @pytest.mark.parametrize("as_u32", [False, True])
    @pytest.mark.parametrize("fn", [sha256_pieces_torch, sha256_pieces_cuda], ids=["plain", "wrapper"])
    def test_nist_vectors(self, as_u32, fn):
        got = torch_digests([m for m, _ in NIST] + [b"a" * 1000], as_u32=as_u32, fn=fn)
        assert [d.hex() for d in got[:3]] == [h for _, h in NIST]
        assert got[3] == hashlib.sha256(b"a" * 1000).digest()

    @pytest.mark.parametrize("n", [55, 56, 63, 64, 119, 120, 127, 128])
    def test_padding_boundary_straddles(self, n):
        assert torch_digests([b"x" * n]) == [hashlib.sha256(b"x" * n).digest()]

    @pytest.mark.parametrize("as_u32", [False, True])
    def test_ragged_batch(self, as_u32):
        pieces = rand_pieces([0, 1, 63, 64, 65, 500, 4096, 700], seed=7)
        assert torch_digests(pieces, as_u32) == [hashlib.sha256(p).digest() for p in pieces]

    def test_empty_batch(self):
        words = sha256_pieces_torch(
            torch.zeros((0, 64), dtype=torch.uint8), torch.zeros(0, dtype=torch.int32)
        )
        assert words.shape == (0, 8) and words.dtype == torch.int32


class TestAgainstJaxAndPallas:
    """Identical seeded batches through the port and the reference."""

    @pytest.mark.parametrize(
        "rows,max_len,seed", [(1, 200, 0), (5, 300, 17), (13, 1024, 2), (32, 500, 3)]
    )
    def test_matches_sha256_pieces_jax(self, rows, max_len, seed):
        rng = np.random.default_rng(seed)
        pieces = rand_pieces(rng.integers(0, max_len, size=rows), seed)
        padded, nblocks = ref_padding.pad_pieces(pieces)
        ref = np.asarray(sha256_pieces_jax(padded, nblocks))
        assert (torch_words(padded, nblocks) == ref).all()
        assert (torch_words(padded, nblocks, as_u32=True, fn=sha256_pieces_cuda) == ref).all()

    def test_full_leaves_match_sha256_pieces_jax(self):
        # BEP 52 leaves: 16 KiB rows are 257-block chains (padded_len_for
        # gives 16,512-byte rows), plus a short tail leaf and a sentinel
        pieces = rand_pieces([16384, 16384, 9000, 16384], seed=23)
        padded, nblocks = ref_padding.pad_pieces(pieces)
        assert padded.shape[1] == padding.padded_len_for(16384) == 16512
        nblocks = nblocks.copy()
        nblocks[3] = 0
        ref = np.asarray(sha256_pieces_jax(padded, nblocks))
        got = torch_words(padded, nblocks, fn=sha256_pieces_cuda)
        assert (got == ref).all()
        assert padding.words_to_digests(got[:3]) == [hashlib.sha256(p).digest() for p in pieces[:3]]
        assert tuple(got[3]) == IV

    @pytest.mark.parametrize("lens,seed", [([0, 3, 55, 56, 64, 120], 11), ([300, 64, 129, 200], 13)])
    def test_matches_sha256_pieces_pallas_interpret(self, lens, seed):
        pieces = rand_pieces(lens, seed)
        padded, nblocks = ref_padding.pad_pieces(pieces)
        ref = np.asarray(sha256_pieces_pallas(padded, nblocks, interpret=True))
        assert (torch_words(padded, nblocks) == ref).all()
        assert padding.words_to_digests(ref) == [hashlib.sha256(p).digest() for p in pieces]

    def test_sentinel_and_out_of_range_counts_match_jax(self):
        # nblocks = 0 never runs (IV out); negative counts run nothing and
        # counts past the row run to its end, in both packages
        pieces = rand_pieces([100, 300, 64, 0, 250], seed=5)
        padded, nblocks = ref_padding.pad_pieces(pieces)
        nblocks = nblocks.copy()
        nblocks[[0, 3]] = 0
        nblocks[1] = -4
        nblocks[2] = 10_000
        ref = np.asarray(sha256_pieces_jax(padded, nblocks))
        got = torch_words(padded, nblocks)
        assert (got == ref).all()
        assert tuple(got[0]) == IV and tuple(got[1]) == IV and tuple(got[3]) == IV


class TestPairs:
    @pytest.mark.parametrize("pairs", [1, 7, 64])
    @pytest.mark.parametrize("fn", [sha256_pairs_torch, sha256_pairs_cuda], ids=["plain", "wrapper"])
    def test_pairs_match_hashlib_and_reference(self, pairs, fn):
        rng = np.random.default_rng(pairs)
        kids = [rng.bytes(32) for _ in range(2 * pairs)]
        words = pair_words(kids)
        got = words_to_numpy(fn(words))
        assert (got == ref_pairs(words.numpy().view(np.uint32))).all()
        assert padding.words_to_digests(got) == [
            hashlib.sha256(kids[i] + kids[i + 1]).digest() for i in range(0, 2 * pairs, 2)
        ]

    @pytest.mark.parametrize("levels", [1, 2, 3, 4, 5, 6])
    def test_fused_reduction_matches_reference_levels(self, levels):
        # the reference reduction, one sha256_pairs level at a time
        rng = np.random.default_rng(50 + levels)
        grid = rng.integers(0, 2**32, size=(2, 1 << levels, 8), dtype=np.uint32)
        ref = grid
        while ref.shape[1] > 1:
            b, m, _ = ref.shape
            ref = ref_pairs(ref.reshape(b * m // 2, 16)).reshape(b, m // 2, 8)
        got = words_to_numpy(merkle._merkle_reduce_fused(torch.from_numpy(grid.view(np.int32)), levels))
        assert (got == ref[:, 0]).all()
        assert (merkle.merkle_root(grid, device="cpu") == ref[:, 0]).all()

    def test_fused_reduction_matches_reference_fused(self):
        levels = 3
        grid = np.random.default_rng(57).integers(0, 2**32, size=(3, 1 << levels, 8), dtype=np.uint32)
        ref = np.asarray(ref_merkle_reduce_fused(jnp.asarray(grid), levels))
        got = words_to_numpy(merkle._merkle_reduce_fused(torch.from_numpy(grid.view(np.int32)), levels))
        assert (got == ref).all()

    def test_merkle_level_matches_hashlib(self):
        rng = np.random.default_rng(8)
        leaves = [rng.bytes(32) for _ in range(8)]
        words = merkle.digests_to_words32(leaves).reshape(2, 4, 8)
        got = merkle.merkle_level(words, device="cpu")
        assert got.shape == (2, 2, 8)
        assert merkle.words32_to_digests(got.reshape(-1, 8)) == [
            hashlib.sha256(leaves[i] + leaves[i + 1]).digest() for i in range(0, 8, 2)
        ]
        with pytest.raises(ValueError, match="even"):
            merkle.merkle_level(words[:, :3], device="cpu")


class TestWrappersOnCpu:
    """The wrappers take CPU tensors to the plain version, uncounted."""

    def test_cpu_tensors_run_plain_version_and_count_nothing(self):
        pieces = rand_pieces([0, 77, 640, 1000], seed=9)
        before = (sha256_pieces_cuda.launches, sha256_pairs_cuda.launches)
        assert torch_digests(pieces, fn=sha256_pieces_cuda) == [hashlib.sha256(p).digest() for p in pieces]
        sha256_pairs_cuda(pair_words([b"\x01" * 32, b"\x02" * 32]))
        assert (sha256_pieces_cuda.launches, sha256_pairs_cuda.launches) == before
        assert make_sha256_fn("cpu") is sha256_pieces_cuda

    @pytest.mark.parametrize(
        "data,nblocks,exc",
        [
            (torch.zeros(128, dtype=torch.uint8), torch.zeros(1, dtype=torch.int32), ValueError),
            (torch.zeros((1, 128), dtype=torch.float32), torch.zeros(1, dtype=torch.int32), TypeError),
            (torch.zeros((1, 100), dtype=torch.uint8), torch.zeros(1, dtype=torch.int32), ValueError),
            (torch.zeros((2, 128), dtype=torch.uint8), torch.zeros(3, dtype=torch.int32), ValueError),
            (torch.zeros((2, 128), dtype=torch.uint8), torch.zeros(2, dtype=torch.int64), TypeError),
        ],
    )
    def test_rows_reject_what_the_kernel_does_not_take(self, data, nblocks, exc):
        with pytest.raises(exc):
            sha256_pieces_cuda(data, nblocks)
        with pytest.raises(exc):
            sha256_pieces_torch(data, nblocks)

    @pytest.mark.parametrize(
        "words,exc",
        [
            (torch.zeros((2, 8), dtype=torch.int32), ValueError),
            (torch.zeros(16, dtype=torch.int32), ValueError),
            (torch.zeros((2, 16), dtype=torch.int64), TypeError),
        ],
    )
    def test_pairs_reject_what_the_kernel_does_not_take(self, words, exc):
        with pytest.raises(exc):
            sha256_pairs_cuda(words)

    def test_op_counts_are_the_stated_recount(self):
        # 16 byteswaps + 48 schedule words x 10 + 64 rounds x 14 + 8 adds
        assert sha256_cuda.OPS_PER_BLOCK == 1400
        assert sha256_cuda.OPS_PER_PAIR == 1384 + 904
