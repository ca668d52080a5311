"""The port's merkle reduction against the reference, on the CPU.

``ops/sha256_torch.py::sha256_merkle_torch`` (the plain version of the
merkle kernel of ``csrc/sha256.cu``), the wrapper ``sha256_merkle_cuda``
on CPU tensors, the launch plan ``merkle_passes`` and the roots of
``models/merkle.py`` are held against the reference's
``_merkle_reduce_fused``, ``merkle_root``, ``piece_roots_from_leaves``,
``file_root_from_piece_roots`` and ``small_file_root`` (jax on the CPU)
and a hashlib pair-fold. Words compare exactly: SHA-256 is integer
arithmetic, so no tolerance applies.

Inputs are made from seeded numpy generators. The reference jits one
program per reduction shape (~3-16 s each on the CPU), so the shapes are
few and the ragged cases keep every pair level a power of two wide.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torrent_tpu.models import merkle as ref_merkle
from torrent_tpu_torch.models import merkle
from torrent_tpu_torch.ops import padding
from torrent_tpu_torch.ops.sha1_torch import words_to_numpy
from torrent_tpu_torch.ops.sha256_cuda import (
    MERKLE_CAP,
    merkle_passes,
    sha256_merkle_cuda,
    sha256_pairs_cuda,
    sha256_pieces_cuda,
)
from torrent_tpu_torch.ops.sha256_torch import check_merkle, sha256_merkle_torch
from torrent_tpu_torch.tools.time_merkle import hashlib_roots

CPU = "cpu"


def rand_grid(b: int, l: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, size=(b, l, 8), dtype=np.uint32)


def as_nodes(grid: np.ndarray) -> torch.Tensor:
    """``u32[B, L, 8]`` → the ``int32[B·L, 8]`` node words the kernel takes."""
    return torch.from_numpy(np.ascontiguousarray(grid).reshape(-1, 8).view(np.int32))


@pytest.mark.parametrize("b,l", [(1, 2), (3, 8), (4, 64), (2, 256)])
def test_plain_merkle_matches_reference_fused(b, l):
    levels = l.bit_length() - 1
    grid = rand_grid(b, l, seed=b * 1000 + l)
    ref = np.asarray(ref_merkle._merkle_reduce_fused(jnp.asarray(grid), levels))
    got = words_to_numpy(sha256_merkle_torch(as_nodes(grid), levels))
    assert got.shape == (b, 8)
    assert (got == ref).all()


@pytest.mark.parametrize("b,l", [(1, 1), (2, 1), (1, 2), (2, 4), (5, 16), (1, 512)])
def test_plain_merkle_matches_hashlib_fold(b, l):
    grid = rand_grid(b, l, seed=7 * b + l)
    got = words_to_numpy(sha256_merkle_torch(as_nodes(grid), l.bit_length() - 1))
    assert padding.words_to_digests(got) == hashlib_roots(grid)


@pytest.mark.parametrize("levels", range(21))
def test_merkle_passes_are_few_capped_and_balanced(levels):
    passes = merkle_passes(levels)
    assert sum(passes) == levels
    assert len(passes) == -(-levels // MERKLE_CAP)
    assert all(1 <= h <= MERKLE_CAP for h in passes)
    assert not passes or max(passes) - min(passes) <= 1
    assert list(passes) == sorted(passes, reverse=True)


def test_merkle_passes_examples():
    assert MERKLE_CAP == 9
    assert merkle_passes(11) == (6, 5)  # a 2 GiB file's 2048-piece layer
    assert merkle_passes(17) == (9, 8)  # a 100 GiB file's 131,072-slot layer
    assert merkle_passes(19) == (7, 6, 6)
    with pytest.raises(ValueError):
        merkle_passes(-1)


def test_cpu_wrapper_runs_plain_version_uncounted_above_the_cap():
    # 2**(cap + 1) leaves: two launches on a card, the plain version here
    levels = MERKLE_CAP + 1
    grid = rand_grid(1, 1 << levels, seed=levels)
    before = (sha256_merkle_cuda.launches, sha256_pairs_cuda.launches, sha256_pieces_cuda.launches)
    got = words_to_numpy(sha256_merkle_cuda(as_nodes(grid), levels))
    fused = words_to_numpy(merkle._merkle_reduce_fused(as_nodes(grid).view(1, 1 << levels, 8), levels))
    after = (sha256_merkle_cuda.launches, sha256_pairs_cuda.launches, sha256_pieces_cuda.launches)
    assert after == before
    ref = ref_merkle.merkle_root(grid[0])
    assert (got[0] == ref).all() and (fused[0] == ref).all()
    words = as_nodes(grid)
    assert sha256_merkle_cuda(words, 0) is words


@pytest.mark.parametrize(
    "words,levels,exc",
    [
        (torch.zeros((8, 8), dtype=torch.int32), -1, ValueError),  # levels < 0
        (torch.zeros((8, 8), dtype=torch.int32), 1.0, ValueError),  # not an int
        (torch.zeros((12, 8), dtype=torch.int32), 3, ValueError),  # 12 nodes, trees of 8
        (torch.zeros((6, 8), dtype=torch.int32), 2, ValueError),  # 6 nodes, trees of 4
        (torch.zeros((8, 16), dtype=torch.int32), 1, ValueError),  # pair rows, not nodes
        (torch.zeros(64, dtype=torch.int32), 1, ValueError),  # flat
        (torch.zeros((8, 8), dtype=torch.int64), 1, TypeError),  # not int32 words
    ],
)
def test_merkle_checks_reject_what_the_kernel_does_not_take(words, levels, exc):
    # check_merkle is the check the CUDA route runs before any launch
    with pytest.raises(exc):
        check_merkle(words, levels)
    with pytest.raises(exc):
        sha256_merkle_cuda(words, levels)


def test_fused_reduction_rejects_a_grid_of_the_wrong_height():
    with pytest.raises(ValueError, match="leaves per tree"):
        merkle._merkle_reduce_fused(torch.zeros((2, 8, 8), dtype=torch.int32), 2)


@pytest.mark.parametrize("n", [1, 3, 5, 7, 13])
def test_roots_match_reference_on_ragged_leaf_counts(n):
    # n leaves at 4 leaves a piece: pieces of 1-4 leaves, layers of 1-4
    # pieces, small files of 1-13 leaves, each zero-padded as BEP 52 says
    leaves = np.random.default_rng(100 + n).integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    got = merkle.piece_roots_from_leaves(leaves, 4, CPU)
    assert (got == ref_merkle.piece_roots_from_leaves(leaves, 4)).all()
    assert merkle.file_root_from_piece_roots(got, 4, CPU) == ref_merkle.file_root_from_piece_roots(got, 4)
    assert merkle.file_root_from_piece_roots(leaves, 4, CPU) == ref_merkle.file_root_from_piece_roots(leaves, 4)
    assert merkle.small_file_root(leaves, CPU) == ref_merkle.small_file_root(leaves)
    l = 1 << (n - 1).bit_length()
    grid = np.zeros((2, 2, l, 8), dtype=np.uint32)
    grid[1, 0, :n] = leaves
    assert (merkle.merkle_root(grid, CPU) == ref_merkle.merkle_root(grid)).all()
