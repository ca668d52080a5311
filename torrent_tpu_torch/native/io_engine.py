"""Python face of the native batched-read engine (io_engine.cpp).

``NativeIOEngine.read_into`` reads many pieces of a torrent into one
staging buffer using the C++ pread thread pool; ``Storage.read_batch``
routes through it automatically when the engine is available (see
storage/storage.py), with the pure-Python path otherwise — identical
semantics either way. ``read_segments`` is the contiguous-buffer form
the v2 plane streams file chunks with (models/v2.py ``_iter_source``).
"""

from __future__ import annotations

import ctypes
import os
import time

import numpy as np

from torrent_tpu_torch.utils.locks import named_lock
from torrent_tpu_torch.utils.log import get_logger

_lib = None
_lib_lock = named_lock("native._lib_lock")
_lib_tried = False


def _get_lib():
    global _lib, _lib_tried
    with _lib_lock:
        if not _lib_tried:
            _lib_tried = True
            from torrent_tpu_torch.native.build import load

            _lib = load()
        return _lib


def native_available() -> bool:
    return _get_lib() is not None


class NativeIOError(OSError):
    pass


class NativeIOEngine:
    """A pread(2) thread pool reading piece batches into staging buffers.

    One engine per process is plenty; the C pool services one batch at a
    time, and concurrent callers queue on ``_lock``.
    """

    def __init__(self, n_threads: int = 8):
        lib = _get_lib()
        if lib is None:
            raise NativeIOError("native io engine unavailable (no toolchain?)")
        self._lib = lib
        self._handle = lib.tt_io_create(int(n_threads))
        self._lock = named_lock("native.io_engine._lock")

    def close(self) -> None:
        if self._handle:
            self._lib.tt_io_destroy(self._handle)
            self._handle = None

    def read_segments(
        self,
        paths: list[str],
        segments: list[tuple[int, int, int, int]],
        out: np.ndarray,
    ) -> None:
        """Read ``(file_index, file_offset, out_offset, length)`` segments.

        ``out`` must be a writable C-contiguous uint8 array; raises
        ``NativeIOError`` if any segment cannot be fully read.
        """
        if out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"] or not out.flags["WRITEABLE"]:
            raise ValueError("out must be a writable C-contiguous uint8 array")
        # the pipeline ledger's "read" stage: one entry a call
        from torrent_tpu_torch.obs.ledger import pipeline_ledger

        with pipeline_ledger().track("read") as tracked:
            self.read_into(paths, segments, out.ctypes.data, out.size, keepalive=out, tracked=tracked)
            tracked.add(sum(int(seg[3]) for seg in segments))

    def read_into(
        self,
        paths: list[str],
        segments,
        base_addr: int,
        extent: int,
        keepalive=None,
        statuses: np.ndarray | None = None,
        tracked=None,
    ) -> int:
        """Segment reads into raw memory ``[base_addr, base_addr+extent)``.

        ``segments`` are ``(file_index, file_offset, out_offset, length)``
        quads whose out_offsets are *memory* offsets into a row-strided
        staging view. ``keepalive`` pins the owning buffer for the
        duration of the call.

        ``statuses``: optional caller-owned ``int32[n_segments]`` array.
        When given, per-segment errnos land there and a failed segment
        does NOT raise (mark-and-continue). Returns the engine rc (0 =
        every segment read fully); without ``statuses`` a nonzero rc
        raises :class:`NativeIOError`.

        ``tracked``: the caller's pipeline-ledger entry (its ``read``),
        from which the wait for this engine's lock is left out: the
        caller charges the read, not the time another caller held the
        pool. Every call, tracked or not (the stripes of a load, which
        pass none), charges that wait to the ledger's ``read_wait``
        counter: its seconds, the bytes the call then read, one op a
        call, outside any occupancy window. While a profiler runs the
        wait is also an ``io.wait_engine`` region.
        """
        seg_arr = np.asarray(segments, dtype=np.int64)
        if seg_arr.size == 0:
            return 0
        if seg_arr.ndim != 2 or seg_arr.shape[1] != 4:
            raise ValueError("segments must be (file_index, file_off, out_off, len) quads")
        ends = seg_arr[:, 2] + seg_arr[:, 3]
        if (seg_arr[:, 3] < 0).any() or (seg_arr[:, 2] < 0).any() or int(ends.max()) > extent:
            raise ValueError("segment exceeds output buffer")
        if (seg_arr[:, 0] < 0).any() or int(seg_arr[:, 0].max()) >= len(paths):
            raise ValueError("segment file index out of range")
        path_arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        raise_on_error = statuses is None
        if statuses is None:
            statuses = np.zeros(seg_arr.shape[0], dtype=np.int32)
        elif statuses.dtype != np.int32 or statuses.shape != (seg_arr.shape[0],):
            raise ValueError("statuses must be int32[n_segments]")
        from torrent_tpu_torch.obs.ledger import pipeline_ledger
        from torrent_tpu_torch.obs.profiler import annotate

        t_wait = time.monotonic()
        region = annotate("io.wait_engine")
        region.__enter__()
        with self._lock:
            waited = time.monotonic() - t_wait
            region.__exit__(None, None, None)
            if tracked is not None:
                tracked.add(0, waited)
            rc = self._lib.tt_io_read_batch(
                self._handle,
                path_arr,
                len(paths),
                seg_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                seg_arr.shape[0],
                ctypes.cast(base_addr, ctypes.POINTER(ctypes.c_uint8)),
                statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
        del keepalive
        pipeline_ledger().record("read_wait", int(seg_arr[statuses == 0, 3].sum()), waited)
        if rc != 0 and raise_on_error:
            bad = np.nonzero(statuses)[0]
            first = int(bad[0]) if bad.size else -1
            raise NativeIOError(
                f"native read failed (rc={rc}) on segment {first}: "
                f"{seg_arr[first].tolist() if first >= 0 else '?'}"
            )
        return int(rc)


_engine = None
_engine_lock = named_lock("native._engine_lock")
_engine_threads: int | None = None
_threads_conflict_warned = False


def get_engine(n_threads: int | None = None):
    """Process-global engine (or None when native IO is unavailable).

    The FIRST caller's ``n_threads`` (or ``TT_IO_THREADS``, default 8)
    sizes the pread pool for the whole process; a later caller asking
    for a different count gets the existing engine, with one warning.
    """
    global _engine, _engine_threads, _threads_conflict_warned
    with _engine_lock:
        if _engine is None and native_available():
            threads = n_threads or int(os.environ.get("TT_IO_THREADS", "8"))
            _engine = NativeIOEngine(threads)
            _engine_threads = threads
        elif (
            _engine is not None
            and n_threads is not None
            and n_threads != _engine_threads
            and not _threads_conflict_warned
        ):
            _threads_conflict_warned = True
            get_logger("native").warning(
                "get_engine(n_threads=%d) ignored: the process-global pread "
                "pool was already built with %s threads (first caller wins; "
                "set TT_IO_THREADS before first use)",
                n_threads, _engine_threads,
            )
        return _engine
