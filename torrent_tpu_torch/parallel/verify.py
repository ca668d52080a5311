"""Batched piece verification — the resume-recheck / authoring hash plane.

``verify_pieces(storage, info)`` reads pieces in large batches
(``Storage.read_batch``), pads them on the host, and hashes them on the
device — digests compared on the device, one bool per piece returned.

Pipeline shape (per batch of B pieces):

    disk → read_batch → pad_in_place → pinned slot → copy stream ┐
                               SHA-1 kernel on the compute stream │ overlapped:
                               compare vs expected on the device  │ next batch's
                               bool[B] → pinned host ─────────────┘ disk read runs
                                                                    on a host thread

The CPU path (``hasher="cpu"``) is streaming hashlib — the baseline the
device path is measured against. This slice ports the v1 routes of
``torrent_tpu/parallel/verify.py``; its scheduler sessions, the v2
merkle recheck and the multi-process routes come with later slices.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable

import numpy as np

from torrent_tpu_torch.codec.metainfo import InfoDict
from torrent_tpu_torch.storage.piece import piece_length
from torrent_tpu_torch.storage.storage import Storage, StorageError


@dataclass
class VerifyResult:
    """Outcome of a full verify pass."""

    bitfield: np.ndarray  # bool[n_pieces]
    n_pieces: int
    n_valid: int
    bytes_hashed: int
    seconds: float

    @property
    def complete(self) -> bool:
        return self.n_valid == self.n_pieces

    @property
    def pieces_per_sec(self) -> float:
        return self.n_pieces / self.seconds if self.seconds > 0 else float("inf")

    @property
    def gib_per_sec(self) -> float:
        return self.bytes_hashed / self.seconds / 2**30 if self.seconds > 0 else float("inf")


ProgressCb = Callable[[int, int], None]  # (pieces_done, pieces_total)


def verify_pieces_cpu(
    storage: Storage, info: InfoDict, progress_cb: ProgressCb | None = None
) -> np.ndarray:
    """Streaming hashlib recheck — the CPU baseline."""
    n = info.num_pieces
    bitfield = np.zeros(n, dtype=bool)
    for idx in range(n):
        try:
            data = storage.read_piece(idx)
        except (StorageError, OSError):
            continue  # unreadable = failed piece, keep checking the rest
        if len(data) == piece_length(info, idx) and hashlib.sha1(data).digest() == info.pieces[idx]:
            bitfield[idx] = True
        if progress_cb and (idx + 1) % 256 == 0:
            progress_cb(idx + 1, n)
    if progress_cb:
        progress_cb(n, n)
    return bitfield


def verify_pieces_gpu(
    storage: Storage,
    info: InfoDict,
    batch_size: int = 1024,
    device=None,
    progress_cb: ProgressCb | None = None,
    io_threads: int = 4,
) -> np.ndarray:
    """Batched device recheck; overlaps disk reads with device hashing.

    ``device=None`` means the GPU, and a host without one raises.
    """
    from torrent_tpu_torch.models.verifier import GPUVerifier

    verifier = GPUVerifier(
        piece_length=info.piece_length, batch_size=batch_size, device=device
    )
    return verifier.verify_storage(
        storage, info, progress_cb=progress_cb, io_threads=io_threads
    )


def verify_pieces(
    storage: Storage,
    info: InfoDict,
    hasher: str = "cpu",
    progress_cb: ProgressCb | None = None,
    **gpu_kwargs,
) -> np.ndarray:
    """Recheck every piece; returns ``bool[n_pieces]``.

    ``hasher``: ``"cpu"`` (streaming hashlib) or ``"gpu"`` (the batched
    device path, the counterpart of the reference's ``"tpu"``; takes
    ``device``, ``batch_size`` and ``io_threads``). v2 session infos
    raise ``NotImplementedError``: the merkle plane is a later slice.
    """
    if getattr(info, "v2", False):
        raise NotImplementedError("v2 (merkle) recheck is not ported yet")
    if info.num_pieces == 0:
        return np.zeros(0, dtype=bool)
    if hasher == "cpu":
        return verify_pieces_cpu(storage, info, progress_cb)
    if hasher == "gpu":
        return verify_pieces_gpu(storage, info, progress_cb=progress_cb, **gpu_kwargs)
    raise ValueError(f"unknown hasher {hasher!r}")
