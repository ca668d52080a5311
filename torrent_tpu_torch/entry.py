"""Forward verify step, the counterpart of the reference's
``__graft_entry__.entry``.

``entry()`` returns ``(forward, example_args)``: ``forward`` hashes a
padded batch with the package's SHA-1 (the CUDA kernel for GPU tensors,
the plain version for CPU ones) and compares on the device against the
expected digest words; the example batch is eight seeded 192-byte
pieces, already on the device.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from torrent_tpu_torch.compat import batch_from_numpy
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
