"""HTTP streaming of a downloading torrent (watch-while-fetching).

Serves one file of a session torrent over HTTP/1.1 with Range support
(the request shape media players emit). The reader position drives the
scheduler: each served chunk re-points the torrent's stream window
(`Torrent.set_stream_window`), so the pieces a player needs next jump
the queue, a mid-file seek re-points instantly, and the rest of the
download proceeds normally behind the window. Reads park on
`Torrent.wait_piece` until the data is verified on disk — bytes that
leave this server have always passed the hash plane.

No reference counterpart (its roadmap stops at a CLI, README.md:24-40);
this composes the existing selection/priority scheduler with a small
asyncio HTTP server, the same pattern popular streaming clients ship.
"""

from __future__ import annotations

import asyncio

from torrent_tpu_torch.storage.storage import StorageError
from torrent_tpu_torch.utils.log import get_logger

log = get_logger("tools.stream")

CHUNK = 256 * 1024  # read/serve granularity; also the window advance step


class BoxStreamServer:
    """Whole-client HTTP streamer (the seeding-box media server):
    ``GET /`` lists torrents, ``GET /<infohash-hex>/`` lists a torrent's
    files, ``GET /<infohash-hex>/<index>`` streams one (Range-capable,
    verified bytes only). Reuses the one-torrent StreamServer per
    registered torrent, routed by infohash."""

    def __init__(self, client, host: str = "127.0.0.1"):
        self.client = client
        self.host = host
        self.port: int | None = None
        self._server: asyncio.AbstractServer | None = None
        self._handlers: set[asyncio.Task] = set()
        self._per_torrent: dict[bytes, StreamServer] = {}

    async def start(self, port: int = 0) -> "BoxStreamServer":
        self._server = await asyncio.start_server(self._accept, self.host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    def _accept(self, reader, writer):
        task = asyncio.ensure_future(self._handle(reader, writer))
        self._handlers.add(task)
        task.add_done_callback(self._handlers.discard)

    def close(self) -> None:
        if self._server is not None:
            self._server.close()
        for task in list(self._handlers):
            task.cancel()
        for sub in self._per_torrent.values():
            sub.torrent.clear_stream_window()

    def _sub(self, torrent) -> "StreamServer":
        key = torrent.metainfo.info_hash
        sub = self._per_torrent.get(key)
        if sub is None or sub.torrent is not torrent:
            # identity check: a removed-and-re-added torrent is a NEW
            # object; serving the cached dead one would park forever
            sub = self._per_torrent[key] = StreamServer(torrent, host=self.host)
        return sub

    async def _handle(self, reader, writer):
        try:
            parsed = await _parse_http_head(reader)
            if parsed is None:
                await _plain_response(writer, 405, b"method not allowed")
                return
            method, path, rng = parsed
            segs = [s for s in path.split("/") if s]
            if not segs:
                import json

                out = [
                    {
                        "info_hash": ih.hex(),
                        "name": t.info.name,
                        "files": sum(1 for _ in content_files(t)),
                        "complete": t.bitfield.complete,
                    }
                    for ih, t in self.client.torrents.items()
                ]
                body = json.dumps({"torrents": out}).encode()
                writer.write(
                    (
                        "HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                        f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
                    ).encode("latin-1")
                    + (body if method != b"HEAD" else b"")
                )
                await writer.drain()
                return
            try:
                torrent = self.client.torrents.get(bytes.fromhex(segs[0]))
            except ValueError:
                torrent = None
            if torrent is None:
                await _plain_response(writer, 404, b"no such torrent")
                return
            # delegate to the per-torrent server with the subpath
            sub = self._sub(torrent)
            subpath = "/" + "/".join(segs[1:]) if len(segs) > 1 else "/"
            await sub.serve_parsed(writer, method, subpath, rng)
        except (
            ConnectionError,
            asyncio.TimeoutError,
            asyncio.LimitOverrunError,
            ValueError,
            OSError,
            RuntimeError,
            LookupError,
            StorageError,
        ):
            pass
        finally:
            writer.close()


def _http_date() -> str:
    from email.utils import formatdate

    return formatdate(usegmt=True)


async def _parse_http_head(reader):
    """→ (method, path-without-query, range-header | None), or None for
    a non-GET/HEAD request line. One parser for both stream servers."""
    request = await asyncio.wait_for(reader.readline(), timeout=30)
    parts = request.split()
    if len(parts) < 2 or parts[0] not in (b"GET", b"HEAD"):
        return None
    method = parts[0]
    path = parts[1].decode("latin-1", "replace").split("?", 1)[0]
    rng = None
    while True:
        line = await asyncio.wait_for(reader.readline(), timeout=30)
        if line in (b"\r\n", b"\n", b""):
            break
        if line.lower().startswith(b"range:"):
            rng = line.split(b":", 1)[1].strip().decode("latin-1", "replace")
    return method, path, rng


async def _plain_response(writer, status: int, body: bytes, extra: str = "") -> None:
    writer.write(
        (
            f"HTTP/1.1 {status} x\r\nContent-Length: {len(body)}\r\n"
            f"{extra}Connection: close\r\n\r\n"
        ).encode("latin-1")
        + body
    )
    await writer.drain()


def content_files(torrent):
    """(index, display_path, start, length) for every non-pad file —
    the single source for what the streamer and the CLI announce."""
    entries = torrent.info.files or ()
    for i, (start, length) in enumerate(torrent.file_ranges()):
        fe = entries[i] if i < len(entries) else None
        if fe is not None and getattr(fe, "pad", False):
            continue  # BEP 47 pads aren't content
        name = "/".join(fe.path) if fe is not None else torrent.info.name
        yield i, name, start, length


class StreamServer:
    """One-torrent HTTP streamer: ``GET /<file_index>`` with Range
    support, backed by the torrent's verified storage. ``GET /`` (or
    ``/index.json``) returns a JSON file index — players and scripts
    discover indices there rather than guessing."""

    def __init__(self, torrent, host: str = "127.0.0.1", window_pieces: int = 16):
        self.torrent = torrent
        self.host = host
        self.window_pieces = window_pieces
        self.port: int | None = None
        self._server: asyncio.AbstractServer | None = None
        self._handlers: set[asyncio.Task] = set()

    async def start(self, port: int = 0) -> "StreamServer":
        self._server = await asyncio.start_server(self._accept, self.host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    def _accept(self, reader, writer):
        # tracked so close() can cancel in-flight streams — a parked
        # reader must not outlive the server
        task = asyncio.ensure_future(self._handle(reader, writer))
        self._handlers.add(task)
        task.add_done_callback(self._handlers.discard)

    def close(self) -> None:
        if self._server is not None:
            self._server.close()
        for task in list(self._handlers):
            task.cancel()
        self.torrent.clear_stream_window()

    # ------------------------------------------------------------ request

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            parsed = await _parse_http_head(reader)
            if parsed is None:
                await self._plain(writer, 405, b"method not allowed")
                return
            await self.serve_parsed(writer, *parsed)
        except (
            ConnectionError,
            asyncio.TimeoutError,
            asyncio.LimitOverrunError,  # oversized request/header line
            ValueError,  # readline on a line past the stream limit
            OSError,
            RuntimeError,  # torrent stopped mid-stream (wait_piece)
            LookupError,  # piece deselected mid-stream (wait_piece)
            StorageError,  # file vanished under a mid-stream read
        ):
            pass
        finally:
            writer.close()

    async def serve_parsed(self, writer, method: bytes, path: str, rng) -> None:
        """Serve one already-parsed request (also the BoxStreamServer's
        delegation point; caller owns closing the writer and catching
        stream-abort exceptions)."""
        if path in ("/", "/index.json"):
            # discovery: players/users can't guess file indices
            await self._index(writer, method)
            return
        try:
            file_index = int(path.lstrip("/") or "0")
            if file_index < 0:
                raise IndexError("negative index")  # no wrap-around files
            start, length = self._file_span(file_index)
        except (ValueError, IndexError):
            await self._plain(writer, 404, b"no such file")
            return
        if not self.torrent.span_servable(start, length):
            # a deselected file's pieces will never be scheduled —
            # parking the reader would hang the connection forever
            await self._plain(writer, 409, b"file not selected for download")
            return
        lo, hi = 0, length - 1
        status = 200
        if rng is not None:
            parsed = self._parse_range(rng, length)
            if parsed is None:
                await self._plain(
                    writer,
                    416,
                    b"bad range",
                    extra=f"Content-Range: bytes */{length}\r\n",
                )
                return
            lo, hi = parsed
            status = 206
        headers = [
            f"HTTP/1.1 {status} {'Partial Content' if status == 206 else 'OK'}",
            f"Date: {_http_date()}",
            "Accept-Ranges: bytes",
            "Content-Type: application/octet-stream",
            f"Content-Length: {hi - lo + 1}",
            "Connection: close",
        ]
        if status == 206:
            headers.append(f"Content-Range: bytes {lo}-{hi}/{length}")
        writer.write(("\r\n".join(headers) + "\r\n\r\n").encode("latin-1"))
        await writer.drain()
        if method == b"HEAD":
            return
        await self._serve_span(writer, start + lo, hi - lo + 1)

    async def _index(self, writer, method: bytes) -> None:
        """JSON file index: [{index, path, length, streamable}]."""
        import json

        t = self.torrent
        out = [
            {
                "index": i,
                "path": name,
                "length": length,
                "streamable": length > 0 and t.span_servable(start, length),
            }
            for i, name, start, length in content_files(t)
        ]
        body = json.dumps({"name": t.info.name, "files": out}).encode()
        writer.write(
            (
                "HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
            ).encode("latin-1")
        )
        if method != b"HEAD":
            writer.write(body)
        await writer.drain()

    async def _plain(self, writer, status: int, body: bytes, extra: str = ""):
        await _plain_response(writer, status, body, extra)

    # ------------------------------------------------------------- plumbing

    def _file_span(self, file_index: int) -> tuple[int, int]:
        """(global start offset, length) of the served file."""
        ranges = self.torrent.file_ranges()
        start, length = ranges[file_index]
        if length == 0:
            raise IndexError("empty file")
        entries = self.torrent.info.files or ()
        if file_index < len(entries) and getattr(entries[file_index], "pad", False):
            # BEP 47 pad spans aren't content; the CLI hides them and a
            # GET must 404, not stream phantom zeros
            raise IndexError("pad file")
        return start, length


    @staticmethod
    def _parse_range(value: str, length: int):
        """``bytes=lo-hi`` / ``bytes=lo-`` / ``bytes=-suffix`` → (lo, hi),
        or None when unsatisfiable. Multi-range requests fall back to the
        first range (players only ever send one)."""
        if not value.startswith("bytes="):
            return None
        spec = value[len("bytes=") :].split(",")[0].strip()
        lo_s, dash, hi_s = spec.partition("-")
        if not dash:
            return None
        try:
            if not lo_s:  # suffix form: last N bytes
                n = int(hi_s)
                if n <= 0:
                    return None
                return max(0, length - n), length - 1
            lo = int(lo_s)
            hi = int(hi_s) if hi_s else length - 1
        except ValueError:
            return None
        if lo < 0 or lo >= length or hi < lo:
            return None
        return lo, min(hi, length - 1)

    async def _serve_span(self, writer, offset: int, length: int) -> None:
        """Stream [offset, offset+length) of the TORRENT byte space,
        waiting for pieces and walking the scheduler window along.

        Each connection holds its own window token, so a player's
        parallel head + tail connections each keep a stable read-ahead
        (the torrent unions them); re-points within the same piece are
        no-ops on the torrent side."""
        t = self.torrent
        plen = t.info.piece_length
        end = offset + length
        pos = offset
        token = object()
        try:
            while pos < end:
                n = min(CHUNK, end - pos)
                first, last = pos // plen, (pos + n - 1) // plen
                # the window must cover every piece this chunk will wait
                # on — small pieces or unaligned ranges can span more
                # pieces than the configured read-ahead, and waiting on
                # an unboosted piece would stall at background priority
                t.set_stream_window(
                    pos, max(self.window_pieces, last - first + 2), token=token
                )
                for piece in range(first, last + 1):
                    await t.wait_piece(piece)
                data = await asyncio.to_thread(t.storage.get, pos, n)
                writer.write(data)
                await writer.drain()
                pos += n
        finally:
            t.clear_stream_window(token)
