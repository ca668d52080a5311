"""Forward verify step and the grid dry run, the counterparts of the
reference's ``__graft_entry__.entry`` and ``dryrun_multichip``.

``entry()`` returns ``(forward, example_args)``: ``forward`` hashes a
padded batch with the package's SHA-1 (the CUDA kernel for GPU tensors,
the plain version for CPU ones) and compares on the device against the
expected digest words; the example batch is eight seeded 192-byte
pieces, already on the device. ``dryrun_multichip(n)`` runs the sharded
steps over a grid of ``n`` entries (``parallel/mesh.py``) on tiny
shapes and checks them against hashlib.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from torrent_tpu_torch.compat import batch_from_numpy, to_device
from torrent_tpu_torch.ops.padding import digests_to_words, pad_pieces
from torrent_tpu_torch.ops.sha1_cuda import make_sha1_fn


def example_batch(n: int = 8, plen: int = 192, seed: int = 0):
    """Seeded numpy batch: ``(padded, nblocks, expected_words)``."""
    rng = np.random.default_rng(seed)
    pieces = [rng.integers(0, 256, size=plen, dtype=np.uint8).tobytes() for _ in range(n)]
    padded, nblocks = pad_pieces(pieces)
    expected = digests_to_words([hashlib.sha1(p).digest() for p in pieces])
    return padded, nblocks, expected


def entry(device=None):
    """``(forward, example_args)`` on ``device`` (None means the GPU)."""
    sha1 = make_sha1_fn(device)

    def forward(data: torch.Tensor, nblocks: torch.Tensor, expected_words: torch.Tensor):
        return (sha1(data, nblocks) == expected_words).all(dim=1)

    return forward, batch_from_numpy(*example_batch(), device=device)


def _grid_entries(n_devices: int, device=None) -> list:
    """``n_devices`` grid entries: ``device`` repeated, or with None the
    process's cards in turn (one card names itself more than once)."""
    from torrent_tpu_torch.parallel.distributed import local_devices

    cards = [device] if device is not None else local_devices()
    return [cards[i % len(cards)] for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The sharded steps over a grid of ``n_devices`` entries, on tiny
    shapes, each checked against hashlib.

    The grid is ``(2, n/2)`` when ``n`` is even, as the reference's mesh,
    over ``device`` repeated (None: the process's cards in turn, so one
    card makes the whole grid). Steps: the sharded verify of a
    ``2n``-piece batch, all valid, then again with one byte of piece 3
    flipped, which must flag that piece alone; the count of valid pieces
    summed on each entry and over the grid (``psum_valid_count``); 2n
    SHA-256 leaves split over the grid, each entry hashing its block;
    the merkle root of the leaves' largest power-of-two prefix; and 2n
    eight-leaf trees, each entry reducing its block in one fused merkle
    launch. Prints the reference's ``dryrun_multichip OK`` line and
    returns what it checked: ``mesh``, ``batch``, ``valid``, ``leaves``
    (the SHA-256 digests), ``merkle_root``, ``trees`` (``uint32[2n, 8,
    8]``) and ``roots``.
    """
    from torrent_tpu_torch.models.merkle import (
        _merkle_reduce_fused,
        digests_to_words32,
        merkle_root,
        words32_to_digests,
    )
    from torrent_tpu_torch.models.verifier import GPUVerifier
    from torrent_tpu_torch.ops.padding import words_to_digests
    from torrent_tpu_torch.ops.sha1_torch import words_to_numpy
    from torrent_tpu_torch.ops.sha256_cuda import make_sha256_fn
    from torrent_tpu_torch.parallel.distributed import psum_valid_count
    from torrent_tpu_torch.parallel.mesh import make_mesh, row_blocks

    n_hosts = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(_grid_entries(n_devices, device), n_hosts=n_hosts)

    verifier = GPUVerifier(piece_length=192, batch_size=n_devices * 2, mesh=mesh)
    b = verifier.batch_size
    padded, nblocks, expected = example_batch(n=b, plen=192, seed=1)
    ok = verifier.verify_batch(padded, nblocks, expected)
    if ok.shape != (b,) or not ok.all():
        raise RuntimeError("sharded verify step failed")
    flipped = padded.copy()
    flipped[3, 0] ^= 0xFF
    ok2 = verifier.verify_batch(flipped, nblocks, expected)
    if ok2[3] or ok2.sum() != b - 1:
        raise RuntimeError(f"sharded verify flagged {list(np.nonzero(~ok2)[0])}, not [3]")

    # the count of valid pieces: each entry sums its rows where they
    # live, and the parts are added (the reference's psum over the mesh)
    parts = [to_device(ok2[lo:hi], dev) for _, dev, lo, hi in row_blocks(mesh, b)]
    total = int(psum_valid_count(parts).item())
    if total != b - 1:
        raise RuntimeError(f"grid count wrong: {total}")

    # SHA-256 leaves split over the grid, each entry its block
    rng = np.random.default_rng(7)
    leaves = [rng.integers(0, 256, size=160, dtype=np.uint8).tobytes() for _ in range(n_devices * 2)]
    l_padded, l_nblocks = pad_pieces(leaves)
    sha256 = make_sha256_fn(mesh.entries[0])
    words = [
        sha256(to_device(l_padded[lo:hi], dev), to_device(l_nblocks[lo:hi], dev))
        for _, dev, lo, hi in row_blocks(mesh, len(leaves))
    ]
    got = words_to_digests(words_to_numpy(words))
    if got != [hashlib.sha256(x).digest() for x in leaves]:
        raise RuntimeError("sharded sha256 plane wrong")
    n_leaves = 1 << (len(got).bit_length() - 1)  # largest pow2 prefix
    root = words32_to_digests(merkle_root(digests_to_words32(got[:n_leaves])[None, :], device=mesh.entries[0]))[0]
    level = list(got[:n_leaves])
    while len(level) > 1:  # independent hashlib merkle of the same leaves
        level = [hashlib.sha256(level[i] + level[i + 1]).digest() for i in range(0, len(level), 2)]
    if root != level[0]:
        raise RuntimeError("merkle reduction wrong under the grid")

    # fused merkle reduction with the tree batch split over the grid:
    # each entry reduces its own trees in one launch
    levels = 3
    trees = np.stack(
        [digests_to_words32([rng.bytes(32) for _ in range(1 << levels)]) for _ in range(n_devices * 2)]
    )
    roots = words32_to_digests(
        words_to_numpy(
            [_merkle_reduce_fused(to_device(trees[lo:hi], dev), levels) for _, dev, lo, hi in row_blocks(mesh, len(trees))]
        )
    )
    for i, tree_root in enumerate(roots):
        lvl = list(words32_to_digests(trees[i]))
        while len(lvl) > 1:
            lvl = [hashlib.sha256(lvl[j] + lvl[j + 1]).digest() for j in range(0, len(lvl), 2)]
        if tree_root != lvl[0]:
            raise RuntimeError(f"fused sharded merkle wrong at tree {i}")

    print(
        f"dryrun_multichip OK: mesh={mesh.shape}, "
        f"batch={b}, valid={total}/{b}, "
        f"v2_plane=sha256x{len(leaves)} ok, fused_merkle=sharded x{len(trees)} ok"
    )
    return {
        "mesh": mesh.shape, "batch": b, "valid": total, "leaves": got,
        "merkle_root": root, "trees": trees, "roots": roots,
    }
