"""Pluggable storage with multi-file piece→file mapping (ref L5: storage.ts).

``StorageMethod`` is the pluggable byte-range backend (storage.ts:16-26);
``Storage`` maps torrent-global byte offsets onto one or more files by
walking the metainfo file table (storage.ts:89-137 ``findAndDo``) — a piece
may span several files in a multi-file torrent.

``read_batch`` reads many pieces into one preallocated numpy buffer,
shaped for the verify plane ``[n_pieces, piece_length]``. Missing/short
files zero-fill (a zero-filled piece simply fails its SHA1 check, which is
exactly the resume-recheck semantics).

This is the verify-plane subset of ``torrent_tpu/storage/storage.py``,
with its BEP 52 piece-aligned file table (``info.piece_aligned``, the v2
session geometry of ``session/v2.py``): the partfile routing of
deselected files, zero-copy egress handles and the written-map resume
helpers belong to the session slice. The reference's pipeline-ledger "read"
accounting is left out on purpose: the ledger is not ported yet.
"""

from __future__ import annotations

import errno
import os
from typing import Iterator, Protocol

import numpy as np

from torrent_tpu_torch.codec.metainfo import InfoDict
from torrent_tpu_torch.storage.piece import piece_length
from torrent_tpu_torch.utils.locks import named_lock


class StorageError(Exception):
    pass


class StorageMethod(Protocol):
    """Pluggable backend over ``(path, offset, length)`` (storage.ts:16-26)."""

    def get(self, path: tuple[str, ...], offset: int, length: int) -> bytes:
        """Read exactly ``length`` bytes; raise StorageError on missing/short."""
        ...

    def set(self, path: tuple[str, ...], offset: int, data: bytes) -> None:
        """Write ``data`` at ``offset``, creating the file/dirs as needed."""
        ...

    def exists(self, path: tuple[str, ...], length: int | None = None) -> bool:
        """Whether the file exists (and, if given, is at least ``length`` long)."""
        ...


class Storage:
    """Maps torrent-global offsets onto the metainfo file table."""

    def __init__(self, method: StorageMethod, info: InfoDict):
        self.method = method
        self.info = info
        # (path, global_start, length) per file; single-file torrents store
        # at [name], multi-file at [name, *entry.path] (storage.ts:41-48).
        # BEP 47 pad files are VIRTUAL zero spans: they occupy piece space
        # (that's their whole purpose) but never touch disk — their table
        # entries carry path=None and get()/set() zero-fill/skip them.
        self._files: list[tuple[tuple[str, ...] | None, int, int]] = []
        if info.files is None:
            self._files.append(((info.name,), 0, info.length))
        elif getattr(info, "piece_aligned", False):
            # BEP 52 piece space: every file starts on a piece boundary;
            # the tail gap after a short last piece is virtual (never on
            # disk, never requested — pieces don't span files in v2)
            plen = info.piece_length
            pos = 0
            for entry in info.files:
                self._files.append(((info.name, *entry.path), pos, entry.length))
                pos += -(-entry.length // plen) * plen
        else:
            pos = 0
            for entry in info.files:
                path = None if entry.pad else (info.name, *entry.path)
                self._files.append((path, pos, entry.length))
                pos += entry.length
        # Exact byte offsets of blocks already written (duplicate-write
        # suppression, storage.ts:39,67-87 — fixed per SURVEY §8.15).
        self._written: set[int] = set()
        self._lock = named_lock("storage.written._lock")

    # ------------------------------------------------------------ mapping

    def segments(self, offset: int, length: int) -> Iterator[tuple[tuple[str, ...], int, int]]:
        """Yield ``(path, file_offset, chunk_len)`` covering the range.

        The file-boundary walk equivalent of storage.ts:89-137.
        """
        if offset < 0 or length < 0 or offset + length > self.info.length:
            raise StorageError(
                f"range [{offset}, {offset + length}) outside torrent of {self.info.length} bytes"
            )
        remaining = length
        for path, start, flen in self._files:
            if remaining == 0:
                break
            if flen == 0:
                continue
            end = start + flen
            if end <= offset or start >= offset + length:
                continue
            seg_start = max(offset, start)
            chunk = min(offset + length, end) - seg_start
            yield path, seg_start - start, chunk
            remaining -= chunk

    # ------------------------------------------------------------ get/set

    def get(self, offset: int, length: int) -> bytes:
        out = bytearray()
        for path, foff, chunk in self.segments(offset, length):
            if path is None:  # BEP 47 pad span: zeros by definition
                out += bytes(chunk)
            else:
                out += self.method.get(path, foff, chunk)
        return bytes(out)

    def set(self, offset: int, data: bytes) -> bool:
        """Write a block; returns False if this offset was already written."""
        with self._lock:
            if offset in self._written:
                return False
            self._written.add(offset)
        try:
            pos = 0
            for path, foff, chunk in self.segments(offset, len(data)):
                if path is not None:  # pad spans are never persisted
                    self.method.set(path, foff, data[pos : pos + chunk])
                pos += chunk
        except Exception:
            # A failed write must not poison duplicate suppression — the
            # peer will re-send the block and the retry must go to disk.
            with self._lock:
                self._written.discard(offset)
            raise
        return True

    def exists(self) -> bool:
        """All files present at full length (resume precondition probe)."""
        return all(
            self.method.exists(path, flen)
            for path, _, flen in self._files
            if path is not None  # pads have no on-disk presence to check
        )

    # ------------------------------------------------------------ batch IO

    def read_piece(self, index: int) -> bytes:
        return self.get(index * self.info.piece_length, piece_length(self.info, index))

    def read_batch(
        self,
        indices,
        out: np.ndarray | None = None,
        row_status: np.ndarray | None = None,
        zero_fill: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Read pieces ``indices`` into ``[n, piece_length]`` uint8 rows.

        Returns ``(buf, lengths)`` where ``lengths[i]`` is the true byte
        length of piece ``indices[i]`` (short for the final piece; the tail
        of its row is zero). Unreadable ranges zero-fill rather than raise —
        the verify plane turns those into hash mismatches.

        ``row_status``: optional caller-owned ``bool[n]``. When given,
        per-row read success lands there (False = any segment of the row
        was missing, short, or torn). ``zero_fill=False`` skips the
        upfront memset of a caller-provided ``out`` (rows may then hold
        stale/partial bytes wherever ``row_status`` is False; only pass it
        together with ``row_status``). BEP 47 pad spans are always written
        as zeros explicitly, so dirty reused buffers can't corrupt
        pad-covering pieces.
        """
        indices = list(indices)
        n = len(indices)
        plen_max = self.info.piece_length
        if out is None:
            out = np.zeros((n, plen_max), dtype=np.uint8)
        else:
            if out.shape != (n, plen_max) or out.dtype != np.uint8:
                raise StorageError("read_batch out buffer has wrong shape/dtype")
            if zero_fill:
                out[:] = 0
        if row_status is not None:
            if row_status.shape != (n,) or row_status.dtype != np.bool_:
                raise StorageError("read_batch row_status must be bool[n]")
            row_status[:] = True
        lengths = np.empty(n, dtype=np.int64)
        if self._native_read_batch(indices, out, lengths, row_status):
            return out, lengths
        # pure-Python path, for backends without the native pread pool
        for row, idx in enumerate(indices):
            plen = piece_length(self.info, idx)
            lengths[row] = plen
            pos = 0
            base = idx * plen_max
            for path, foff, chunk in self.segments(base, plen):
                if path is None:
                    # pad span: zeros by definition — written explicitly
                    # because a zero_fill=False caller (reused staging
                    # buffer) may hand us dirty rows
                    out[row, pos : pos + chunk] = 0
                    pos += chunk
                    continue
                try:
                    data = self.method.get(path, foff, chunk)
                    out[row, pos : pos + len(data)] = np.frombuffer(data, dtype=np.uint8)
                except (StorageError, OSError):
                    # leave zeros; SHA1 mismatch will flag the piece.
                    # OSError too: a file torn mid-recheck can surface a
                    # raw errno from backends that don't wrap, and the
                    # device paths must mark-and-continue like the CPU one
                    if row_status is not None:
                        row_status[row] = False
                pos += chunk
        return out, lengths

    def _native_read_batch(
        self,
        indices,
        out: np.ndarray,
        lengths: np.ndarray,
        row_status: np.ndarray | None = None,
    ) -> bool:
        """Batch read via the C++ pread pool (native/io_engine.cpp).

        Only for filesystem-backed storage; any unreadable range is left
        zeroed (same semantics as the Python path — SHA1 flags the piece).
        Returns False to take the Python path when native IO is
        unavailable. With ``row_status`` given, a failed/short/torn
        segment marks its row False instead of raising or zero-rebuilding.
        """
        if not isinstance(self.method, FsStorage):
            return False
        if out.strides[1] != 1 or out.strides[0] < out.shape[1]:
            return False  # need row-strided uint8 memory
        from torrent_tpu_torch.native.io_engine import NativeIOError, get_engine

        engine = get_engine()
        if engine is None:
            return False
        row_stride = out.strides[0]
        paths: list[str] = []
        sizes: list[int] = []
        findex: dict[tuple[str, ...], int | None] = {}
        quads: list[tuple[int, int, int, int]] = []
        quad_rows: list[int] = []  # row owning each quad (status demux)
        for row, idx in enumerate(indices):
            plen = piece_length(self.info, idx)
            lengths[row] = plen
            pos = 0
            for path, foff, chunk in self.segments(idx * self.info.piece_length, plen):
                if path is None:
                    # pad span: zeros by definition — force them, since a
                    # zero_fill=False caller hands us rows that may hold a
                    # previous batch's bytes
                    out[row, pos : pos + chunk] = 0
                    pos += chunk
                    continue
                fi = findex.get(path, -1)
                if fi == -1:
                    try:
                        ap = self.method._abspath(path)
                        size = os.stat(ap).st_size
                        fi = len(paths)
                        paths.append(ap)
                        sizes.append(size)
                    except (StorageError, OSError):
                        fi = None  # missing file: whole range stays zero
                    findex[path] = fi
                if fi is not None and sizes[fi] - foff >= chunk:
                    quads.append((fi, foff, row * row_stride + pos, chunk))
                    quad_rows.append(row)
                elif row_status is not None:
                    # missing/short file: the row can never be complete
                    row_status[row] = False
                # else: leave the whole segment zeroed — same all-or-nothing
                # semantics as the Python path's short-read StorageError
                pos += chunk
        extent = (out.shape[0] - 1) * row_stride + out.shape[1] if out.shape[0] else 0
        try:
            if row_status is not None:
                statuses = np.zeros(len(quads), dtype=np.int32)
                rc = engine.read_into(
                    paths, quads, out.ctypes.data, extent,
                    keepalive=out, statuses=statuses,
                )
                if rc != 0 and (statuses == errno.ENOENT).any():
                    # a file vanished between our stat() and the engine's
                    # open(): tt_io_read_batch fast-fails WITHOUT submitting
                    # any segment, so the zero statuses of the other rows
                    # are meaningless — re-derive every row on the Python path
                    row_status[:] = True
                    return False
                for q in np.nonzero(statuses)[0]:
                    row_status[quad_rows[int(q)]] = False
            else:
                engine.read_into(paths, quads, out.ctypes.data, extent, keepalive=out)
        except (NativeIOError, ValueError):
            if row_status is None:
                out[:] = 0  # a failed segment can leave partial bytes; the
                return False  # Python path rebuilds from a clean buffer
            row_status[:] = True  # the Python path re-derives every row itself
            return False
        return True


# ---------------------------------------------------------------- backends


class FsStorage:
    """Filesystem backend (storage.ts:140-206 ``fsStorage``).

    Keeps an open-handle cache instead of the reference's open/seek/close
    per call — read_batch hits the same files tens of thousands of times.
    """

    def __init__(self, root: str | os.PathLike):
        self.root = os.fspath(root)
        self._handles: dict[tuple[str, ...], object] = {}
        self._lock = named_lock("storage.fs._lock")

    def _abspath(self, path: tuple[str, ...]) -> str:
        for part in path:
            if part in ("", ".", "..") or "/" in part or "\\" in part or "\x00" in part:
                raise StorageError(f"unsafe path component {part!r}")
        return os.path.join(self.root, *path)

    def _open_read(self, path: tuple[str, ...]):
        with self._lock:
            f = self._handles.get(path)
            if f is None or f.closed:  # type: ignore[union-attr]
                try:
                    f = open(self._abspath(path), "rb")
                except OSError as e:
                    raise StorageError(f"cannot open {path}: {e}") from e
                self._handles[path] = f
            return f

    def get(self, path: tuple[str, ...], offset: int, length: int) -> bytes:
        f = self._open_read(path)
        try:
            # pread is positional and atomic — no lock needed; the lock
            # only guards the handle cache in _open_read.
            data = os.pread(f.fileno(), length, offset)
        except (OSError, ValueError) as e:
            raise StorageError(f"read failed from {path}: {e}") from e
        if len(data) != length:
            raise StorageError(
                f"short read from {path}: wanted {length} at {offset}, got {len(data)}"
            )
        return data

    def set(self, path: tuple[str, ...], offset: int, data: bytes) -> None:
        try:
            abspath = self._abspath(path)
            os.makedirs(os.path.dirname(abspath), exist_ok=True)
            # in-place update without truncating (storage.ts:174-196)
            fd = os.open(abspath, os.O_WRONLY | os.O_CREAT, 0o644)
            try:
                os.pwrite(fd, data, offset)
            finally:
                os.close(fd)
        except OSError as e:
            raise StorageError(f"write failed to {path}: {e}") from e

    def exists(self, path: tuple[str, ...], length: int | None = None) -> bool:
        try:
            st = os.stat(self._abspath(path))
        except OSError:
            return False
        return length is None or st.st_size >= length

    def close(self) -> None:
        with self._lock:
            for f in self._handles.values():
                f.close()  # type: ignore[union-attr]
            self._handles.clear()


class MemoryStorage:
    """In-memory backend for tests and the tracker-less verify benchmarks.

    The Python analogue of the reference tests' sinon mock StorageMethod
    (storage_test.ts:144-148), but fully functional.
    """

    def __init__(self):
        self.files: dict[tuple[str, ...], bytearray] = {}

    def get(self, path: tuple[str, ...], offset: int, length: int) -> bytes:
        buf = self.files.get(path)
        if buf is None:
            raise StorageError(f"no such file {path}")
        if offset + length > len(buf):
            raise StorageError(f"short read from {path}")
        return bytes(buf[offset : offset + length])

    def set(self, path: tuple[str, ...], offset: int, data: bytes) -> None:
        buf = self.files.setdefault(path, bytearray())
        if len(buf) < offset + len(data):
            buf.extend(b"\x00" * (offset + len(data) - len(buf)))
        buf[offset : offset + len(data)] = data

    def exists(self, path: tuple[str, ...], length: int | None = None) -> bool:
        buf = self.files.get(path)
        if buf is None:
            return False
        return length is None or len(buf) >= length
