"""GPUVerifier — the v1 hash plane on a grid of devices.

The counterpart of ``torrent_tpu/models/verifier.py::TPUVerifier``, with
the same contracts:

- ``verify_storage`` — full resume-recheck of a torrent: disk →
  ``Storage.read_batch`` → pad → device → masked SHA-1 chain → on-device
  digest compare → ``bool`` bitfield. Disk IO for batch *i+1* overlaps
  the copies and the kernels of batch *i*.
- ``hash_pieces`` / ``hash_bytes`` — authoring-side digests.
- ``verify_batch`` / ``digest_batch`` / ``upload_batch`` /
  ``digest_uploaded`` — the raw steps, in numpy form.

A verifier runs on this process's grid (``parallel/mesh.py``): every
card of the process by default, as the reference's mesh takes every
chip. ``batch_size`` rounds up to a multiple of the grid's size, and
each entry hashes its contiguous block of every batch's rows on its own
streams (the reference's ``shard_map`` of the kernel over
``batch_sharding``); the host gets the rows back in order. Every batch
has ``batch_size`` rows; a ragged tail is filled with ``nblocks=0``
sentinel rows. On a GPU the SHA-1 is the hand-written kernel
(ops/sha1_cuda.py); with ``device="cpu"`` it is the plain PyTorch
version.
"""

from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from torrent_tpu_torch.codec.metainfo import InfoDict
from torrent_tpu_torch.compat import to_device, to_device_on_stream
from torrent_tpu_torch.obs.h2d import Copy
from torrent_tpu_torch.obs.ledger import pipeline_ledger
from torrent_tpu_torch.obs.profiler import annotate
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
from torrent_tpu_torch.parallel.mesh import local_grid, round_up_to_multiple, row_blocks
from torrent_tpu_torch.parallel.pipeline import run_batches
from torrent_tpu_torch.parallel.verify import VerifyResult, read_runs, striped
from torrent_tpu_torch.storage.storage import Storage


class _CpuSlot:
    """Staging slot for ``device="cpu"`` entries: the plain SHA-1 reads
    each entry's block of the staging buffer in place and finishes
    before ``launch`` returns, so the buffer is free again as soon as
    the result is taken. Charges the pipeline ledger as
    :class:`_CudaSlot` does."""

    def __init__(self, b: int, plen: int, blocks: list):
        self.padded, _ = alloc_padded(b, plen)
        self.nblocks = np.zeros(b, dtype=np.int32)
        self._blocks = blocks
        self.ok_dev = None
        self._ok = None

    def wait_host_free(self) -> None:
        pass

    def launch(self, sha1, expected: list, g: int, beside: bool | None = None) -> None:
        """Hash batch ``g``: entry ``i`` compares its rows with its
        rows of ``expected[i]`` (every batch's, in order). Nothing is
        copied, so ``beside`` charges nothing."""
        led = pipeline_ledger()
        with led.track("h2d"):  # views of the buffer: nothing moves, no bytes
            rows = [
                (i, hi - lo, torch.from_numpy(self.padded[lo:hi]), torch.from_numpy(self.nblocks[lo:hi]))
                for i, _, lo, hi in self._blocks
            ]
        self.ok_dev = []
        with led.track("launch", self.padded.nbytes):
            for i, w, data, nblocks in rows:
                words = sha1(data, nblocks)
                self.ok_dev.append((words == expected[i][g * w : (g + 1) * w]).all(dim=1))
            self._ok = torch.cat(self.ok_dev).numpy()

    def fetch_ok(self) -> np.ndarray:
        with pipeline_ledger().track("digest", self._ok.size):
            return self._ok


class _CudaEntry:
    """One grid entry's part of a :class:`_CudaSlot`: its device buffers,
    its copy stream and the events that order them; ``copy_start`` and
    ``copy_done`` also time its copy on the card."""

    def __init__(self, rows: int, padded_len: int, device: torch.device, compute):
        self.device = device
        self.data = torch.empty((rows, padded_len), dtype=torch.uint8, device=device)
        self.nblocks = torch.empty(rows, dtype=torch.int32, device=device)
        self.copy = torch.cuda.Stream(device=device)
        self.compute = compute
        self.copy_start = torch.cuda.Event(enable_timing=True)
        self.copy_done = torch.cuda.Event(enable_timing=True)
        self.compute_done = torch.cuda.Event()


class _CudaSlot:
    """Staging slot for a grid of GPUs: one pinned host slab of the whole
    batch, and for each entry its device buffers, copy stream and
    events, on the entry's own compute stream.

    An entry's ``copy_done`` marks the end of its host→device copy of its
    block, after which that block of the host slab may be refilled;
    ``compute_done`` marks the end of its kernel, compare and result
    copy, after which its device buffers may be overwritten and its
    rows of the result read. ``ok_dev`` is the last launch's ``bool``
    rows on each entry's device, ordered on the entry's compute stream
    (the multi-process route counts them there).

    ``launch`` charges the pipeline ledger's ``h2d`` (every entry's copy
    enqueued) and ``launch`` (every entry's kernel and compare), and
    ``fetch_ok`` its ``digest`` (the wait for the verdicts). A launch
    told whether a load runs ``beside`` it has ``fetch_ok`` charge each
    entry's copy, as the card timed it, to ``h2d_beside_load`` or
    ``h2d_alone`` (``obs/h2d.py``).
    """

    def __init__(self, b: int, plen: int, blocks: list, computes: list):
        padded_len = padded_len_for(plen)
        self._host_data = torch.empty((b, padded_len), dtype=torch.uint8, pin_memory=True)
        self._host_nblocks = torch.zeros(b, dtype=torch.int32, pin_memory=True)
        self._host_ok = torch.zeros(b, dtype=torch.bool, pin_memory=True)
        self.padded = self._host_data.numpy()
        self.nblocks = self._host_nblocks.numpy()
        self._blocks = blocks
        self._entries = [_CudaEntry(hi - lo, padded_len, dev, computes[i]) for i, dev, lo, hi in blocks]
        self.ok_dev = None
        self._beside: bool | None = None

    def wait_host_free(self) -> None:
        # an event never recorded is complete: the first fill never waits
        for e in self._entries:
            e.copy_done.synchronize()

    def launch(self, sha1, expected: list, g: int, beside: bool | None = None) -> None:
        """Hash batch ``g``: entry ``i`` copies and hashes its block and
        compares it with its rows of ``expected[i]`` (every batch's, in
        order), all on its own streams. ``beside``: whether a load runs
        beside the copies (None: charge neither copy counter)."""
        led = pipeline_ledger()
        self._beside = beside
        with led.track("h2d", self.padded.nbytes):
            for (_, _, lo, hi), e in zip(self._blocks, self._entries):
                with torch.cuda.stream(e.copy):
                    # the previous kernel on this slot still reads the device buffers
                    e.copy.wait_event(e.compute_done)
                    e.copy_start.record(e.copy)
                    e.data.copy_(self._host_data[lo:hi], non_blocking=True)
                    e.nblocks.copy_(self._host_nblocks[lo:hi], non_blocking=True)
                    e.copy_done.record(e.copy)
        self.ok_dev = []
        with led.track("launch", self.padded.nbytes):
            for (i, _, lo, hi), e in zip(self._blocks, self._entries):
                w = hi - lo
                with torch.cuda.stream(e.compute):
                    e.compute.wait_event(e.copy_done)
                    words = sha1(e.data, e.nblocks)
                    ok = (words == expected[i][g * w : (g + 1) * w]).all(dim=1)
                    self._host_ok[lo:hi].copy_(ok, non_blocking=True)
                    e.compute_done.record(e.compute)
                self.ok_dev.append(ok)

    def fetch_ok(self) -> np.ndarray:
        with pipeline_ledger().track("digest", self._host_ok.numel()):
            for e in self._entries:
                e.compute_done.synchronize()
        if self._beside is not None:
            self._charge_copies(self._beside)
            self._beside = None
        return self._host_ok.numpy()

    def _charge_copies(self, beside: bool) -> None:
        """Each entry's completed copy to the ledger's copy counters."""
        for (_, _, lo, hi), e in zip(self._blocks, self._entries):
            nbytes = self._host_data[lo:hi].nbytes + self._host_nblocks[lo:hi].nbytes
            Copy(e.copy_start, e.copy_done, nbytes, beside).charge()


class GPUVerifier:
    def __init__(
        self,
        piece_length: int,
        batch_size: int = 1024,
        device=None,
        devices=None,
        mesh=None,
    ):
        """``device`` alone is a one-entry grid, ``devices`` a grid of
        those entries, ``mesh`` this process's entries of a
        ``parallel.mesh.Mesh``; with none of them the grid is every card
        of the process (``make_mesh()``), and a host without CUDA
        raises."""
        if piece_length <= 0:
            raise ValueError("piece_length must be positive")
        self.mesh = local_grid(device, devices, mesh)
        self.devices = self.mesh.entries
        self.device = self.devices[0]
        self.piece_length = piece_length
        self.batch_size = round_up_to_multiple(max(int(batch_size), self.mesh.size), self.mesh.size)
        self.padded_len = padded_len_for(piece_length)
        self._sha1 = make_sha1_fn(self.device)
        self._cuda = self.device.type == "cuda"
        # each entry's compute stream (two entries on one card run apart)
        self._streams = [torch.cuda.Stream(device=d) for d in self.devices] if self._cuda else None
        self.last_result: VerifyResult | None = None

    # ------------------------------------------------------------ raw steps

    def _on(self, i: int):
        """Entry ``i``'s compute stream as the current one (its device's)."""
        return torch.cuda.stream(self._streams[i]) if self._cuda else contextlib.nullcontext()

    def _to_grid(self, *arrays) -> tuple[list, int]:
        """The arrays with sentinel (all-zero) rows appended up to a
        multiple of the grid's size, and the live row count."""
        n = arrays[0].shape[0]
        pad = round_up_to_multiple(max(n, 1), self.mesh.size) - n
        if pad:
            arrays = tuple(np.concatenate([a, np.zeros((pad, *a.shape[1:]), dtype=a.dtype)]) for a in arrays)
        return list(arrays), n

    def verify_batch(
        self, padded: np.ndarray, nblocks: np.ndarray, expected_words: np.ndarray
    ) -> np.ndarray:
        """bool[B]: does each padded row hash to its expected digest words.

        ``padded`` is ``uint8[B, padded_len]`` or host-order
        ``uint32[B, padded_len/4]``; each entry compares its rows on its
        device."""
        (padded, nblocks, expected), n = self._to_grid(
            padded, np.asarray(nblocks).astype(np.int32), np.asarray(expected_words).astype(np.uint32)
        )
        oks = []
        for i, dev, lo, hi in row_blocks(self.mesh, len(padded)):
            with self._on(i):
                words = self._sha1(to_device(padded[lo:hi], dev), to_device(nblocks[lo:hi], dev))
                oks.append((words == to_device(expected[lo:hi], dev)).all(dim=1))
        out = []
        for i, ok in enumerate(oks):
            with self._on(i):
                out.append(ok.cpu().numpy())
        return np.concatenate(out)[:n]

    def digest_batch(self, padded: np.ndarray, nblocks: np.ndarray) -> np.ndarray:
        """uint32[B, 5] big-endian digest words for each row."""
        (padded, nblocks), n = self._to_grid(padded, np.asarray(nblocks).astype(np.int32))
        words = []
        for i, dev, lo, hi in row_blocks(self.mesh, len(padded)):
            with self._on(i):
                words.append(self._sha1(to_device(padded[lo:hi], dev), to_device(nblocks[lo:hi], dev)))
        out = []
        for i, w in enumerate(words):
            with self._on(i):
                out.append(words_to_numpy(w))
        return np.concatenate(out)[:n]

    def upload_supported(self, padded) -> bool:
        """Whether :meth:`upload_batch` can take this batch: a 2-D array
        whose rows split evenly over the grid."""
        return (
            isinstance(padded, np.ndarray)
            and padded.ndim == 2
            and padded.shape[0] % self.mesh.size == 0
        )

    def upload_batch(self, padded: np.ndarray, streams=None):
        """Explicit host→device copy of each entry's row block; returns
        the list of per-entry device tensors (the handle for
        :meth:`digest_uploaded`), or None when :meth:`upload_supported`
        refuses the batch. Without ``streams`` the staging buffer may be
        reused when this returns. With ``streams`` (one a grid entry, on
        a GPU grid), each block's copy runs ``non_blocking`` on its entry's
        stream (``compat.to_device_on_stream``): from a pinned buffer it
        is asynchronous, and the caller orders the buffer's reuse and the
        handle's use on the streams."""
        if not self.upload_supported(padded):
            return None
        blocks = row_blocks(self.mesh, padded.shape[0])
        if streams is not None and self._cuda:
            return [to_device_on_stream(padded[lo:hi], streams[i]) for i, _, lo, hi in blocks]
        return [to_device(padded[lo:hi], dev) for _, dev, lo, hi in blocks]

    def digest_uploaded(self, handle, nblocks, streams=None) -> list:
        """Launch the digest on an :meth:`upload_batch` handle without
        fetching: returns each entry's device ``int32[rows, 5]`` words,
        in row order, and the caller's ``sha1_torch.words_to_numpy`` is
        the device→host copy. Entry ``i`` launches on ``streams[i]`` when
        given, else on its device's current stream. ``nblocks`` is a
        numpy array of the batch's counts or a list of each entry's,
        already on its device."""
        if not isinstance(nblocks, (list, tuple)):
            nblocks = np.asarray(nblocks).astype(np.int32)
            rows = sum(h.shape[0] for h in handle)
            nblocks = [to_device(nblocks[lo:hi], dev) for _, dev, lo, hi in row_blocks(self.mesh, rows)]
        words = []
        for i, (data, nbl) in enumerate(zip(handle, nblocks)):
            ctx = torch.cuda.stream(streams[i]) if streams is not None else contextlib.nullcontext()
            with ctx:
                words.append(self._sha1(data, nbl))
        return words

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
        """The two staging slots a recheck alternates, each one pinned
        host slab of the whole batch with every entry's device buffers
        and copy stream, ordered by events on a GPU (``_CudaSlot``), plain
        numpy buffers on the CPU (``_CpuSlot``). Each has ``padded`` and
        ``nblocks`` to fill after ``wait_host_free()``, then
        ``launch(sha1, expected_rows, g)`` and ``fetch_ok()``."""
        b, plen = self.batch_size, self.piece_length
        blocks = row_blocks(self.mesh, b)
        if self._cuda:
            return [_CudaSlot(b, plen, blocks, self._streams) for _ in range(2)]
        return [_CpuSlot(b, plen, blocks) for _ in range(2)]

    def expected_rows(self, expected: np.ndarray) -> list:
        """Each entry's rows of ``expected`` (``uint32[G*B, 5]``, batch
        ``g`` at rows ``g*B``), every batch's in order, on the entry's
        device: what a slot's ``launch`` compares with."""
        b = self.batch_size
        per_batch = expected.reshape(-1, b, 5)
        out = []
        for i, dev, lo, hi in row_blocks(self.mesh, b):
            with self._on(i):
                out.append(to_device(per_batch[:, lo:hi].reshape(-1, 5), dev))
        return out

    def verify_storage(
        self,
        storage: Storage,
        info: InfoDict,
        progress_cb=None,
        io_threads: int = 4,
    ) -> np.ndarray:
        """Full recheck → bool[n_pieces]. Disk reads overlap device work.

        The torrent's pieces in order, ``batch_size`` a batch, each batch
        read in ``io_threads`` concurrent stripes, through the recheck
        loop (:meth:`_recheck`).
        """
        if info.piece_length != self.piece_length:
            raise ValueError(
                f"verifier built for piece_length={self.piece_length}, "
                f"torrent has {info.piece_length}"
            )
        n = info.num_pieces
        if n == 0:
            return np.zeros(n, dtype=bool)
        b = self.batch_size
        plen = self.piece_length
        rows = -(-n // b) * b  # the last batch's tail rows are sentinels, dropped
        lengths = np.zeros(rows, dtype=np.int64)
        lengths[:n] = np.minimum(plen, info.length - np.arange(n) * plen)
        expected = np.zeros((rows, 5), dtype=np.uint32)
        expected[:n] = digests_to_words(info.pieces)
        stripes = max(1, io_threads)
        runs = [striped(storage, range(start, min(start + b, n)), stripes) for start in range(0, n, b)]

        def drained(g: int, ok, slot) -> None:
            if progress_cb:
                progress_cb(min((g + 1) * b, n), n)

        ok, seconds = self._recheck(runs, lengths, expected, io_threads, drained)
        bitfield = ok[:n]
        self.last_result = VerifyResult(
            bitfield=bitfield,
            n_pieces=n,
            n_valid=int(bitfield.sum()),
            bytes_hashed=info.length,
            seconds=seconds,
        )
        return bitfield

    def _recheck(self, runs: list, lengths: np.ndarray, expected: np.ndarray, io_threads: int, drained):
        """The recheck loop of every v1 route, over a row plan.

        ``runs[g]`` are batch ``g``'s reads, ``(storage, piece indices,
        rows)`` with ``rows`` a slice of the batch's rows; they fill its
        first rows, and the rows after them are sentinels (``nblocks=0``).
        ``lengths`` (``int64[G*B]``) and ``expected`` (``uint32[G*B, 5]``,
        zeros, which no digest equals, on sentinel rows) are each row's
        piece length and digest words, batch ``g`` at rows ``g*B``; the
        expected digests go to the device once, in the set-up. Returns
        each row's verdict (``bool[G*B]``) and the seconds of the batches;
        ``drained(g, ok, slot)`` runs on this thread once batch ``g``'s
        verdicts ``ok`` are in, ``slot`` the staging slot it ran on.

        The batches run through ``parallel/pipeline.py``'s loop over two
        staging slots (:meth:`staging_slots`): the loader fills one, its
        runs read at once on ``io_threads`` threads (``read_runs``), while
        the other is copied to the grid and hashed. On a GPU the slots are
        pinned buffers, each entry copies its block on its own stream, and
        events order every reuse: a host slot is refilled only after every
        entry's copy completed, an entry's device buffers are overwritten
        only after its kernel completed.

        The pipeline ledger (``obs/ledger.py``) is charged on the way:
        ``read`` (one entry a batch over its runs) and ``stage`` (the
        padding) on the loader thread, and the slots' ``h2d``, ``launch``,
        ``digest`` and copy counters on this one. While a profiler runs, a
        batch is a ``verify.v1.batch`` region holding those stages'
        ``pipeline.*`` regions and this thread's ``verify.wait_load``; the
        loader's wait for a free slot is a ``verify.wait_host_free``
        region, and the set-up a ``verify.setup`` one.
        """
        b, plen = self.batch_size, self.piece_length
        ok = np.zeros(len(lengths), dtype=bool)
        if not runs:
            return ok, 0.0
        with annotate("verify.setup"):
            expected_dev = self.expected_rows(expected)
            slots = self.staging_slots()
        stripes = max(1, io_threads)
        io_pool = ThreadPoolExecutor(max_workers=stripes) if stripes > 1 else None
        led = pipeline_ledger()

        def load(g: int) -> int:
            slot = slots[g % 2]
            with annotate("verify.wait_host_free"):
                slot.wait_host_free()
            padded = slot.padded
            view = padded[:, :plen]
            read_runs([(storage, idxs, view[rows]) for storage, idxs, rows in runs[g]], io_pool)
            k = sum(len(idxs) for _, idxs, _ in runs[g])
            batch_lengths = lengths[g * b : (g + 1) * b]
            with led.track("stage", int(batch_lengths.sum())):
                padded[:, plen:] = 0  # clear pad tail (stale 0x80/bitlen bytes)
                if k < b:
                    padded[k:] = 0
                slot.nblocks[:] = pad_in_place(padded, batch_lengths)
                slot.nblocks[k:] = 0  # sentinel rows
            return k

        def launch(g: int, k: int, beside: bool) -> tuple[int, int]:
            slots[g % 2].launch(self._sha1, expected_dev, g, beside=beside)
            return g, k

        def drain(pending: tuple[int, int]) -> None:
            g, k = pending
            rows = ok[g * b : g * b + k]
            rows[:] = slots[g % 2].fetch_ok()[:k]
            drained(g, rows, slots[g % 2])

        t0 = time.perf_counter()
        try:
            run_batches(len(runs), load, launch, drain, "verify.v1.batch")
        finally:
            if io_pool is not None:
                io_pool.shutdown(wait=False)
        return ok, time.perf_counter() - t0
