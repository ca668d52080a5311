"""GPUVerifier — the v1 hash plane on one device.

The counterpart of ``torrent_tpu/models/verifier.py::TPUVerifier``, with
the same contracts:

- ``verify_storage`` — full resume-recheck of a torrent: disk →
  ``Storage.read_batch`` → pad → device → masked SHA-1 chain → on-device
  digest compare → ``bool`` bitfield. Disk IO for batch *i+1* overlaps
  the copy and the kernel of batch *i*.
- ``hash_pieces`` / ``hash_bytes`` — authoring-side digests.
- ``verify_batch`` / ``digest_batch`` / ``upload_batch`` /
  ``digest_uploaded`` — the raw steps, in numpy form.

Every batch has ``batch_size`` rows; a ragged tail is filled with
``nblocks=0`` sentinel rows. On a GPU the SHA-1 is the hand-written
kernel (ops/sha1_cuda.py); with ``device="cpu"`` it is the plain PyTorch
version. A verifier runs on one device: the reference's mesh and
``shard_map`` become one verifier a rank of a ``torch.distributed``
group (``parallel/distributed.py``).
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from torrent_tpu_torch.codec.metainfo import InfoDict
from torrent_tpu_torch.compat import to_device, to_device_on_stream
from torrent_tpu_torch.ops.padding import (
    alloc_padded,
    digests_to_words,
    pad_in_place,
    pad_pieces,
    padded_len_for,
    words_to_digests,
)
from torrent_tpu_torch.ops.sha1_cuda import make_sha1_fn
from torrent_tpu_torch.ops.sha1_torch import words_to_numpy
from torrent_tpu_torch.parallel.verify import VerifyResult
from torrent_tpu_torch.storage.storage import Storage
from torrent_tpu_torch.utils.device import resolve_device


class _CpuSlot:
    """Staging slot for ``device="cpu"``: the plain SHA-1 reads the
    staging buffer in place and finishes before ``launch`` returns, so
    the buffer is free again as soon as the result is taken."""

    def __init__(self, b: int, plen: int):
        self.padded, _ = alloc_padded(b, plen)
        self.nblocks = np.zeros(b, dtype=np.int32)
        self.ok_dev = None
        self._ok = None

    def wait_host_free(self) -> None:
        pass

    def launch(self, sha1, expected: torch.Tensor) -> None:
        words = sha1(torch.from_numpy(self.padded), torch.from_numpy(self.nblocks))
        self.ok_dev = (words == expected).all(dim=1)
        self._ok = self.ok_dev.numpy()

    def fetch_ok(self) -> np.ndarray:
        return self._ok


class _CudaSlot:
    """Staging slot for a GPU: pinned host buffers, device buffers, and
    the events that order them.

    ``copy_done`` marks the end of this slot's host→device copy, after
    which the host buffers may be refilled; ``compute_done`` marks the
    end of its kernel, compare and result copy, after which the device
    buffers may be overwritten and the result read. ``ok_dev`` is the
    last launch's ``bool[B]`` on the device, ordered on the compute
    stream (the multi-process route counts it there).
    """

    def __init__(self, b: int, plen: int, device: torch.device, copy_stream):
        padded_len = padded_len_for(plen)
        self._host_data = torch.empty((b, padded_len), dtype=torch.uint8, pin_memory=True)
        self._host_nblocks = torch.zeros(b, dtype=torch.int32, pin_memory=True)
        self._host_ok = torch.zeros(b, dtype=torch.bool, pin_memory=True)
        self.padded = self._host_data.numpy()
        self.nblocks = self._host_nblocks.numpy()
        self._dev_data = torch.empty((b, padded_len), dtype=torch.uint8, device=device)
        self._dev_nblocks = torch.empty(b, dtype=torch.int32, device=device)
        self._device = device
        self._copy_stream = copy_stream
        self._copy_done = torch.cuda.Event()
        self._compute_done = torch.cuda.Event()
        self.ok_dev = None

    def wait_host_free(self) -> None:
        # an event never recorded is complete: the first fill never waits
        self._copy_done.synchronize()

    def launch(self, sha1, expected: torch.Tensor) -> None:
        with torch.cuda.stream(self._copy_stream):
            # the previous kernel on this slot still reads the device buffers
            self._copy_stream.wait_event(self._compute_done)
            self._dev_data.copy_(self._host_data, non_blocking=True)
            self._dev_nblocks.copy_(self._host_nblocks, non_blocking=True)
            self._copy_done.record(self._copy_stream)
        compute = torch.cuda.current_stream(self._device)
        compute.wait_event(self._copy_done)
        words = sha1(self._dev_data, self._dev_nblocks)
        self.ok_dev = (words == expected).all(dim=1)
        self._host_ok.copy_(self.ok_dev, non_blocking=True)
        self._compute_done.record(compute)

    def fetch_ok(self) -> np.ndarray:
        self._compute_done.synchronize()
        return self._host_ok.numpy()


class GPUVerifier:
    def __init__(self, piece_length: int, batch_size: int = 1024, device=None):
        if piece_length <= 0:
            raise ValueError("piece_length must be positive")
        self.device = resolve_device(device)
        self.piece_length = piece_length
        self.batch_size = max(1, int(batch_size))
        self.padded_len = padded_len_for(piece_length)
        self._sha1 = make_sha1_fn(self.device)
        self.last_result: VerifyResult | None = None

    # ------------------------------------------------------------ raw steps

    def verify_batch(
        self, padded: np.ndarray, nblocks: np.ndarray, expected_words: np.ndarray
    ) -> np.ndarray:
        """bool[B]: does each padded row hash to its expected digest words.

        ``padded`` is ``uint8[B, padded_len]`` or host-order
        ``uint32[B, padded_len/4]``; the compare runs on the device."""
        dev = self.device
        words = self._sha1(to_device(padded, dev), to_device(nblocks.astype(np.int32), dev))
        ok = (words == to_device(expected_words.astype(np.uint32), dev)).all(dim=1)
        return ok.cpu().numpy()

    def digest_batch(self, padded: np.ndarray, nblocks: np.ndarray) -> np.ndarray:
        """uint32[B, 5] big-endian digest words for each row."""
        dev = self.device
        return words_to_numpy(
            self._sha1(to_device(padded, dev), to_device(nblocks.astype(np.int32), dev))
        )

    def upload_supported(self, padded) -> bool:
        """Whether :meth:`upload_batch` can take this batch."""
        return isinstance(padded, np.ndarray) and padded.ndim == 2

    def upload_batch(self, padded: np.ndarray, stream=None):
        """Explicit host→device copy; returns a handle for
        :meth:`digest_uploaded`, or None when the batch is not a 2-D
        array. Without ``stream`` the staging buffer may be reused when
        this returns. With ``stream`` (a GPU verifier), the copy runs
        ``non_blocking`` on that stream (``compat.to_device_on_stream``):
        from a pinned buffer it is asynchronous, and the caller orders
        the buffer's reuse and the handle's use on the stream."""
        if not self.upload_supported(padded):
            return None
        if stream is not None and self.device.type == "cuda":
            return to_device_on_stream(padded, stream)
        return to_device(padded, self.device)

    def digest_uploaded(self, handle, nblocks) -> torch.Tensor:
        """Launch the digest on an :meth:`upload_batch` handle without
        fetching, on the current stream: returns the device
        ``int32[B, 5]`` words, and the caller's
        ``sha1_torch.words_to_numpy`` is the device→host copy.
        ``nblocks`` is a numpy array or a tensor already on the device."""
        if not isinstance(nblocks, torch.Tensor):
            nblocks = to_device(np.asarray(nblocks).astype(np.int32), self.device)
        return self._sha1(handle, nblocks)

    # ------------------------------------------------------------ authoring

    def hash_pieces(self, pieces: list[bytes]) -> list[bytes]:
        """SHA1 digests for a ragged list of pieces (authoring path).

        Chunks into fixed ``batch_size`` launches; rows past the last
        piece are ``nblocks=0`` sentinels.
        """
        if not pieces:
            return []
        if any(len(p) > self.piece_length for p in pieces):
            raise ValueError("piece longer than verifier piece_length")
        out: list[bytes] = []
        b = self.batch_size
        for start in range(0, len(pieces), b):
            chunk = pieces[start : start + b]
            padded, view = alloc_padded(b, self.piece_length)
            lengths = np.zeros(b, dtype=np.int64)
            for i, p in enumerate(chunk):
                view[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
                lengths[i] = len(p)
            nblocks = pad_in_place(padded, lengths)
            nblocks[len(chunk) :] = 0  # sentinel rows: skip entirely
            words = self.digest_batch(padded, nblocks)
            out.extend(words_to_digests(words[: len(chunk)]))
        return out

    def hash_bytes(self, data: bytes) -> bytes:
        """Single-message SHA1 on the device."""
        padded, nblocks = pad_pieces([data])
        return words_to_digests(self.digest_batch(padded, nblocks))[0]

    # ------------------------------------------------------------ recheck

    def staging_slots(self) -> list:
        """The two staging slots a recheck alternates: pinned host and
        device buffers ordered by events on a GPU (``_CudaSlot``), plain
        numpy buffers on the CPU (``_CpuSlot``). Each has ``padded`` and
        ``nblocks`` to fill after ``wait_host_free()``, then
        ``launch(sha1, expected)`` and ``fetch_ok()``."""
        b, plen = self.batch_size, self.piece_length
        if self.device.type == "cuda":
            copy_stream = torch.cuda.Stream(self.device)
            return [_CudaSlot(b, plen, self.device, copy_stream) for _ in range(2)]
        return [_CpuSlot(b, plen) for _ in range(2)]

    def verify_storage(
        self,
        storage: Storage,
        info: InfoDict,
        progress_cb=None,
        io_threads: int = 4,
    ) -> np.ndarray:
        """Full recheck → bool[n_pieces]. Disk reads overlap device work.

        Two staging slots alternate: a loader thread fills one (with
        ``io_threads`` striped reads) while the other is copied to the
        device and hashed. On a GPU the slots are pinned buffers, the
        copy runs on its own stream, and events order every reuse: a
        host slot is refilled only after its copy completed, a device
        slot is overwritten only after its kernel completed.
        """
        if info.piece_length != self.piece_length:
            raise ValueError(
                f"verifier built for piece_length={self.piece_length}, "
                f"torrent has {info.piece_length}"
            )
        n = info.num_pieces
        bitfield = np.zeros(n, dtype=bool)
        if n == 0:
            return bitfield
        b = self.batch_size
        plen = self.piece_length
        # expected digests go to the device once per torrent; the tail
        # rows of the last batch compare against zeros and are dropped
        expected = np.zeros((-(-n // b) * b, 5), dtype=np.uint32)
        expected[:n] = digests_to_words(info.pieces)
        expected_dev = to_device(expected, self.device)
        slots = self.staging_slots()
        stripes = max(1, io_threads)
        io_pool = ThreadPoolExecutor(max_workers=stripes) if stripes > 1 else None

        def load(slot, start: int) -> int:
            slot.wait_host_free()
            padded = slot.padded
            view = padded[:, :plen]
            idxs = range(start, min(start + b, n))
            k = len(idxs)
            if io_pool is not None and k > stripes:
                step = (k + stripes - 1) // stripes
                futs = [
                    io_pool.submit(
                        storage.read_batch,
                        idxs[s : s + step],
                        out=view[s : min(s + step, k)],
                    )
                    for s in range(0, k, step)
                ]
                for f in futs:
                    f.result()
            else:
                storage.read_batch(idxs, out=view[:k])
            padded[:, plen:] = 0  # clear pad tail (stale 0x80/bitlen bytes)
            if k < b:
                padded[k:] = 0
            lengths = np.zeros(b, dtype=np.int64)
            lengths[:k] = np.minimum(plen, info.length - np.arange(start, start + k) * plen)
            slot.nblocks[:] = pad_in_place(padded, lengths)
            slot.nblocks[k:] = 0  # sentinel rows
            return k

        # One batch in flight beyond the one being launched: the result of
        # batch i is read after batch i+1 is queued, so the kernel of i+1
        # overlaps the host's wait for i, and host memory stays bounded
        # by the two slots.
        inflight: deque = deque()

        def drain_one():
            start_i, k_i, slot = inflight.popleft()
            bitfield[start_i : start_i + k_i] = slot.fetch_ok()[:k_i]
            if progress_cb:
                progress_cb(min(start_i + b, n), n)

        t0 = time.perf_counter()
        try:
            with ThreadPoolExecutor(max_workers=1) as loader:
                fut = loader.submit(load, slots[0], 0)
                start, cur = 0, 0
                while start < n:
                    k = fut.result()
                    next_start = start + b
                    if next_start < n:
                        fut = loader.submit(load, slots[1 - cur], next_start)
                    slots[cur].launch(self._sha1, expected_dev[start : start + b])
                    inflight.append((start, k, slots[cur]))
                    while len(inflight) > 1:
                        drain_one()
                    start, cur = next_start, 1 - cur
                while inflight:
                    drain_one()
        finally:
            if io_pool is not None:
                io_pool.shutdown(wait=False)
        self.last_result = VerifyResult(
            bitfield=bitfield,
            n_pieces=n,
            n_valid=int(bitfield.sum()),
            bytes_hashed=info.length,
            seconds=time.perf_counter() - t0,
        )
        return bitfield
