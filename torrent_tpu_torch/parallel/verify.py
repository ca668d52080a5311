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
device path is measured against. v2 session infos (``session/v2.py``)
route to the merkle recheck: SHA-256 16 KiB leaves of a whole piece batch
in one kernel launch, then one pair launch per tree level on the device,
and the roots compared there. This ports the single-process routes of
``torrent_tpu/parallel/verify.py``; its scheduler sessions and the
multi-process routes come with later slices.
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


def verify_pieces_v2_cpu(
    storage: Storage, info, progress_cb: ProgressCb | None = None
) -> np.ndarray:
    """Streaming per-piece merkle recheck (session/v2.py geometry)."""
    from torrent_tpu_torch.models.merkle import piece_root_cpu

    n = info.num_pieces
    bitfield = np.zeros(n, dtype=bool)
    for idx in range(n):
        try:
            data = storage.read_piece(idx)
        except (StorageError, OSError):
            continue  # unreadable = failed piece, keep checking the rest
        if (
            len(data) == info.piece_sizes[idx]
            and piece_root_cpu(data, info.piece_pad_leaves[idx]) == info.pieces[idx]
        ):
            bitfield[idx] = True
        if progress_cb and (idx + 1) % 256 == 0:
            progress_cb(idx + 1, n)
    if progress_cb:
        progress_cb(n, n)
    return bitfield


def verify_pieces_v2_gpu(
    storage: Storage,
    info,
    batch_size: int = 256,
    device=None,
    progress_cb: ProgressCb | None = None,
    indices=None,
    **_ignored,
) -> np.ndarray:
    """Batched device merkle recheck of a v2 session info.

    Pieces group by leaf-pad target (multi-piece files all share
    blocks-per-piece, single-piece files use their own pow2 count). Per
    batch of ``batch_size`` pieces: one ``read_batch``, one staged leaf
    grid ``[m, pad]`` (a piece's full blocks are consecutive, so the
    batch moves as one strided copy), one SHA-256 launch over all its
    leaves (256 × 64 = 16384 rows at 1 MiB pieces), log2(pad) pair
    launches on the device, and the roots compared with the expected
    digests there; only ``bool[m]`` comes back. The next batch is read
    on a host thread while the device works.

    ``indices``: optional subset of piece indices to recheck; the
    returned bitfield is always full length, False outside the subset.
    Other keyword arguments of the v1 path (``io_threads``) are accepted
    and ignored, as in the reference.
    """
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from torrent_tpu_torch.compat import to_device
    from torrent_tpu_torch.models.merkle import _merkle_reduce_fused, digests_to_words32
    from torrent_tpu_torch.models.v2 import _host_copy, _LeafPlane

    n = info.num_pieces
    bitfield = np.zeros(n, dtype=bool)
    if n == 0:
        return bitfield
    todo = range(n) if indices is None else indices
    by_pad: dict[int, list[int]] = {}
    for idx in todo:
        by_pad.setdefault(info.piece_pad_leaves[idx], []).append(idx)
    n_todo = sum(len(v) for v in by_pad.values())
    if n_todo == 0:
        return bitfield
    batch_size = max(1, int(batch_size))
    plane = _LeafPlane(min(batch_size, n_todo) * max(by_pad), device)
    plen = info.piece_length
    bufs = [np.empty((min(batch_size, n_todo), plen), dtype=np.uint8) for _ in range(2)]
    expected = digests_to_words32(info.pieces)
    done = 0

    def read(batch, buf):
        return storage.read_batch(batch, out=buf[: len(batch)])

    def finish(batch, ok_len, get_ok) -> None:
        nonlocal done
        bitfield[batch] = ok_len & get_ok().astype(bool)
        done += len(batch)
        if progress_cb:
            progress_cb(done, n_todo)

    with ThreadPoolExecutor(max_workers=1) as loader:
        for pad, group in by_pad.items():
            batches = [group[s : s + batch_size] for s in range(0, len(group), batch_size)]
            fut = loader.submit(read, batches[0], bufs[0])
            pending = None
            for bi, batch in enumerate(batches):
                buf, lengths = fut.result()
                if bi + 1 < len(batches):
                    fut = loader.submit(read, batches[bi + 1], bufs[(bi + 1) % 2])
                ok_len = lengths == np.asarray([info.piece_sizes[p] for p in batch])
                m = len(batch)
                plane.stage_pieces(buf, lengths, pad)
                roots = _merkle_reduce_fused(plane.launch_grid(m, pad), pad.bit_length() - 1)
                want = to_device(expected[batch], plane.device)
                ok = (roots == want).all(dim=1).to(torch.int32)
                if pending is not None:
                    finish(*pending)
                pending = (batch, ok_len, _host_copy(ok))
            finish(*pending)
    return bitfield


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
    (session/v2.py) route to the merkle recheck automatically; the
    reference's multi-process v2 route waits for the multi-GPU slice.
    """
    if info.num_pieces == 0:
        return np.zeros(0, dtype=bool)
    v2 = getattr(info, "v2", False)
    if hasher == "cpu":
        fn = verify_pieces_v2_cpu if v2 else verify_pieces_cpu
        return fn(storage, info, progress_cb)
    if hasher == "gpu":
        fn = verify_pieces_v2_gpu if v2 else verify_pieces_gpu
        return fn(storage, info, progress_cb=progress_cb, **gpu_kwargs)
    raise ValueError(f"unknown hasher {hasher!r}")
