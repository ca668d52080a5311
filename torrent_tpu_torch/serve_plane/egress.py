"""Zero-copy block egress: sendfile → preadv staging → buffered copy.

The legacy serve path moves every outbound block through userspace
twice: ``pread`` into a piece cache, slice, append to the transport
buffer. For a seeder pushing thousands of blocks a second that copy tax
IS the ceiling. This engine classifies each requested span against the
piece→file table and takes the cheapest road available:

* ``sendfile`` — the span maps contiguously into ONE real file (no pad
  spans, no file boundary): write the 13-byte Piece header, then splice
  the payload kernel→socket via ``loop.sendfile`` (zero userspace
  copies). A pre-send ``fstat`` guard refuses spans past EOF so the
  header can never be committed for bytes that don't exist.
* ``preadv`` — the fd is there but the event loop/transport can't
  splice (or sendfile was found unsupported earlier): one positional
  vectored read into a pooled staging buffer, one transport write. One
  copy, no piece-cache churn, no thread hop.
* ``copy`` — not fs-backed at all (MemoryStorage, pad spans, file
  boundaries): the caller's buffered pipeline serves it and records the
  path itself.

Frame-integrity rule: once the header is written the payload MUST
follow on the same connection — any mid-frame failure raises
``ConnectionResetError`` so the session drops the peer instead of
desyncing the stream. That is also why the header+payload pair runs
under the writer's send lock (``_tt_send_lock``): asyncio forbids
``transport.write`` while a ``sendfile`` is in flight, so every
concurrent sender (choke round, Have broadcast, keepalive) serializes
on the same lock via ``proto.send_message``.

Engine state (the sendfile-support latch, the staging pool) is confined
to the session event loop — no lock; the cross-thread surface is the
telemetry registry, which has its own.
"""

from __future__ import annotations

import asyncio
import os
import struct

from torrent_tpu_torch.net import protocol as proto
from torrent_tpu_torch.storage.storage import StorageError

__all__ = ["EgressEngine"]

# length prefix (9 + payload), msg id PIECE, index, begin
_PIECE_HEADER = struct.Struct(">IBII")

# pooled staging buffers kept for the preadv path (a block is ≤ 128 KiB;
# the pool bounds idle memory at POOL_MAX buffers of the largest size seen)
POOL_MAX = 32


class EgressEngine:
    """Per-torrent zero-copy egress over one :class:`Storage`."""

    def __init__(self, storage, telemetry=None):
        self.storage = storage
        self._tel = telemetry
        # latched False→True the first time the running loop/transport
        # reports sendfile unsupported (uvloop-less exotic platforms,
        # SSL transports): every later block goes straight to preadv
        self._sendfile_broken = False
        self._pool: list[bytearray] = []
        # path -> blocks served (engine-local mirror; the telemetry
        # registry holds the cross-thread copy)
        self.served: dict[str, int] = {"sendfile": 0, "preadv": 0, "copy": 0}

    # --------------------------------------------------------- classify

    def classify(self, offset: int, length: int):
        """Resolve the span to ``(fileobj, file_offset)`` when it maps
        contiguously into one real file the backend can hand an fd for;
        ``None`` sends the caller down the buffered copy path."""
        if length <= 0:
            return None
        span = self.storage.contiguous_span(offset, length)
        if span is None:
            return None
        path, foff = span
        opener = getattr(self.storage.method, "open_read_handle", None)
        if opener is None:
            return None  # no real files behind this backend
        try:
            f = opener(path)
            # EOF guard: committing a Piece header for bytes the file
            # doesn't hold would desync the stream — short files take
            # the copy path, whose read raises a proper StorageError
            if os.fstat(f.fileno()).st_size < foff + length:
                return None
        except (StorageError, OSError, ValueError):
            return None
        return f, foff

    # ------------------------------------------------------------ pread

    def _take_buf(self, length: int) -> bytearray:
        while self._pool:
            buf = self._pool.pop()
            if len(buf) >= length:
                return buf
        return bytearray(max(length, 16384))

    def _put_buf(self, buf: bytearray) -> None:
        if len(self._pool) < POOL_MAX:
            self._pool.append(buf)

    def _pread_into(self, f, foff: int, length: int) -> tuple[bytearray, memoryview]:
        buf = self._take_buf(length)
        view = memoryview(buf)[:length]
        got = os.preadv(f.fileno(), [view], foff)
        if got != length:
            self._put_buf(buf)
            raise StorageError(
                f"short preadv: wanted {length} at {foff}, got {got}"
            )
        return buf, view

    # ------------------------------------------------------------- send

    async def send_block(self, writer, index: int, begin: int, length: int) -> str | None:
        """Send ``Piece(index, begin, <length bytes>)`` zero-copy.

        Returns the path name that served it (``"sendfile"`` /
        ``"preadv"``), or ``None`` when the span isn't eligible and the
        caller must serve through its buffered pipeline. Raises
        ``ConnectionResetError`` on any mid-frame failure (the header
        was committed; the connection must die, not desync).
        """
        offset = index * self.storage.info.piece_length + begin
        span = self.classify(offset, length)
        if span is None:
            return None
        f, foff = span
        header = _PIECE_HEADER.pack(9 + length, proto.MsgId.PIECE, index, begin)
        transport = getattr(writer, "transport", None)
        lock = getattr(writer, "_tt_send_lock", None)
        if lock is None:
            return await self._send_locked(writer, transport, f, foff, length, header)
        async with lock:
            return await self._send_locked(writer, transport, f, foff, length, header)

    async def _send_locked(self, writer, transport, f, foff, length, header) -> str:
        proto.raise_if_closing(writer)
        want_sendfile = not self._sendfile_broken and transport is not None
        writer.write(header)
        if want_sendfile:
            try:
                loop = asyncio.get_running_loop()
                await loop.sendfile(transport, f, foff, length, fallback=False)
                self.served["sendfile"] += 1
                return "sendfile"
            except (asyncio.SendfileNotAvailableError, NotImplementedError):
                # raised by the support probe BEFORE any payload byte
                # moves: the header is already buffered, so stage THIS
                # block via preadv inline and latch the fallback for the
                # rest of the process life
                self._sendfile_broken = True
                return await self._stage_payload(writer, f, foff, length)
            except (OSError, RuntimeError) as e:
                # payload bytes may already be on the wire: the frame is
                # torn and the connection must die, not desync
                raise ConnectionResetError(f"sendfile failed mid-frame: {e}") from e
        return await self._stage_payload(writer, f, foff, length)

    async def _stage_payload(self, writer, f, foff, length) -> str:
        try:
            buf, view = self._pread_into(f, foff, length)
        except (StorageError, OSError, ValueError) as e:
            # header committed, payload unreadable: the stream is torn
            raise ConnectionResetError(f"preadv failed mid-frame: {e}") from e
        try:
            writer.write(bytes(view))
            await writer.drain()
        finally:
            view.release()
            self._put_buf(buf)
        self.served["preadv"] += 1
        return "preadv"
