"""The port's localhost HTTP bridge (torrent_tpu_torch/bridge), against
hashlib and against the reference's bridge.

The reference's bridge tests, ported: tests/test_bridge.py (streaming
ingest, chunked bodies, the curl client), test_tools.py::TestBridge,
test_sched.py::TestBridgeScheduler, test_faults.py::TestBridgeFaultMapping
and the client-disconnect case, test_obs.py::TestBridgeTracing, the
bridge cases of test_pipeline.py, test_fleet.py, test_fabric.py,
test_control.py and test_swarm_obs.py. Where the reference parametrises
``hasher`` over ``["cpu", "tpu"]`` these run ``["cpu", "gpu"]``, and
``"gpu"`` runs on ``device="cpu"``: the scheduler's plain PyTorch planes,
the CPU counterparts of the card's kernels. The cases the reference runs
on hashlib (``hasher="cpu"``) stay on hashlib.

``TestNoFallback`` holds the card rule on this host: with no device
given, ``hasher="gpu"`` means CUDA, and ``start()`` raises before a
socket opens. ``TestDifferential`` sends the same seeded requests to a
reference bridge (``hasher="tpu"`` on JAX's CPU, as its own tests run
it) and to the port's: the data routes' bodies are byte-equal, every
error path answers the same status and body, ``/v1/info`` differs only
in ``backend``, ``devices`` and ``sha256_backend``, and ``/metrics``
carries the same metric families.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import socket
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from test_metrics import prom_lint
from test_torch_timeline import fresh_globals  # noqa: F401  (a fixture)
from torrent_tpu_torch.bridge.service import BridgeServer, serve_bridge
from torrent_tpu_torch.codec.bencode import bdecode, bencode
from torrent_tpu_torch.sched import ControlConfig


def run(coro, timeout: float = 120.0):
    # a stuck lane fails its test instead of hanging the suite
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _kw(hasher: str) -> dict:
    """The port's counterpart of a reference ``hasher``: "gpu" runs the
    device planes on ``device="cpu"`` (their plain PyTorch versions)."""
    return {"hasher": "gpu", "device": "cpu"} if hasher == "gpu" else {"hasher": hasher}


async def _start(hasher: str, **kw) -> BridgeServer:
    return await serve_bridge(port=0, **_kw(hasher), **kw)


async def _http(port: int, method: str, path: str, headers=None, body: bytes = b"",
                chunked: bool = False):
    """One request; returns ``(status, lower-cased headers, body)``."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    head = [f"{method} {path} HTTP/1.1", "Host: x"]
    for k, v in (headers or {}).items():
        head.append(f"{k}: {v}")
    head.append("Transfer-Encoding: chunked" if chunked else f"Content-Length: {len(body)}")
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode())
    if chunked:
        # deliberately awkward chunk sizes so frames straddle chunk edges
        pos, step = 0, 1000
        while pos < len(body):
            part = body[pos : pos + step]
            writer.write(f"{len(part):x}\r\n".encode() + part + b"\r\n")
            pos += step
            step = step * 2 + 7
        writer.write(b"0\r\n\r\n")
    else:
        writer.write(body)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    hdrs: dict[str, str] = {}
    clen = 0
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b""):
            break
        k, _, v = line.decode("latin-1").partition(":")
        hdrs[k.strip().lower()] = v.strip()
        if k.strip().lower() == "content-length":
            clen = int(v)
    resp = await reader.readexactly(clen)
    writer.close()
    return status, hdrs, resp


async def _post(port, path, headers, body, chunked=False):
    status, _, resp = await _http(port, "POST", path, headers, body, chunked)
    return status, resp


async def _get(port, path):
    status, _, resp = await _http(port, "GET", path)
    return status, resp


def _frames(pieces, expected=None):
    out = bytearray()
    for i, p in enumerate(pieces):
        out += len(p).to_bytes(4, "big") + p
        if expected is not None:
            out += expected[i]
    return bytes(out)


def _mk_pieces(n: int, plen: int) -> list[bytes]:
    # ragged tail: last piece short, one empty-adjacent tiny piece
    pieces = [bytes([i % 251]) * plen for i in range(n - 2)]
    pieces.append(b"x" * (plen // 3 + 1))
    pieces.append(b"y")
    return pieces


def _pieces(n: int, plen: int = 1024, salt: int = 0) -> list[bytes]:
    return [bytes([(i + salt) % 251]) * plen for i in range(n)]


def _sha1(pieces: list[bytes]) -> list[bytes]:
    return [hashlib.sha1(p).digest() for p in pieces]


class _StallPlane:
    """Test plane that blocks until released — pins queue bytes so
    admission-control behaviour is deterministic, no timing involved."""

    def __init__(self):
        import threading

        self.release = threading.Event()

    def run(self, payloads):
        self.release.wait(timeout=30)
        return [hashlib.sha1(p).digest() for p in payloads]


def _rewind_breaker(sched, seconds: float = 1e6) -> None:
    """Expire every lane breaker's cooldown without sleeping."""
    for lane in sched._lanes.values():
        with lane.breaker.lock:
            lane.breaker.opened_at -= seconds


# ------------------------------------------------- tests/test_bridge.py


class TestForeignClientCurl:
    """A NON-Python client feeding the sidecar: curl POSTs
    length-prefixed frames with chunked transfer-encoding — what a Deno
    ``fetch`` with a stream body produces — and the test builds every
    wire byte itself."""

    @pytest.mark.parametrize(
        "algo,h",
        [("sha1", hashlib.sha1), ("sha256", hashlib.sha256)],
    )
    def test_curl_chunked_stream_verify(self, tmp_path, algo, h):
        async def go():
            server = await _start("gpu")
            try:
                plen, n, bad = 4096, 37, 7
                dlen = h(b"").digest_size
                frames = bytearray()
                for i in range(n):
                    # ragged tail piece: wire allows short final frames
                    piece = bytes([i % 251]) * (plen if i < n - 1 else plen // 3 + 1)
                    exp = bytes(dlen) if i == bad else h(piece).digest()
                    frames += len(piece).to_bytes(4, "big") + piece + exp
                body_file = tmp_path / f"frames_{algo}.bin"
                body_file.write_bytes(bytes(frames))
                proc = await asyncio.create_subprocess_exec(
                    "curl", "-s", "-S", "--max-time", "120",
                    "-X", "POST",
                    "-H", f"X-Piece-Length: {plen}",
                    "-H", f"X-Hash-Algo: {algo}",
                    # forces curl into chunked upload (no Content-Length)
                    "-H", "Transfer-Encoding: chunked",
                    "-H", "Content-Type: application/octet-stream",
                    "--data-binary", f"@{body_file}",
                    f"http://127.0.0.1:{server.port}/v1/stream/verify",
                    stdout=asyncio.subprocess.PIPE,
                    stderr=asyncio.subprocess.PIPE,
                )
                out, err = await proc.communicate()
                assert proc.returncode == 0, err.decode()
                rec = bdecode(out)
                assert rec[b"valid"] == n - 1, rec
                ok = rec[b"ok"]
                assert ok[bad] == 0
                assert all(ok[i] == 1 for i in range(n) if i != bad)
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    def test_curl_info_probe(self):
        """The capability probe a foreign client hits first."""

        async def go():
            server = await _start("cpu")
            try:
                proc = await asyncio.create_subprocess_exec(
                    "curl", "-s", "--max-time", "30",
                    f"http://127.0.0.1:{server.port}/v1/info",
                    stdout=asyncio.subprocess.PIPE,
                    stderr=asyncio.subprocess.PIPE,
                )
                out, err = await proc.communicate()
                assert proc.returncode == 0, err.decode()
                info = bdecode(out)
                assert b"backend" in info and b"devices" in info
            finally:
                server.close()
                await server.wait_closed()

        run(go())


class TestStreamingBridge:
    @pytest.mark.parametrize("hasher", ["cpu", "gpu"])
    def test_stream_digests_multi_flush(self, hasher):
        """Piece count > batch_size forces multiple staged device flushes."""

        async def go():
            server = await _start(hasher)
            try:
                plen = 1024
                pieces = _mk_pieces(600, plen)  # batch_size=256 → 3 flushes
                status, resp = await _post(
                    server.port,
                    "/v1/stream/digests",
                    {"X-Piece-Length": str(plen)},
                    _frames(pieces),
                )
                assert status == 200
                digests = bdecode(resp)[b"digests"]
                assert digests == [hashlib.sha1(p).digest() for p in pieces]
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    @pytest.mark.parametrize("hasher", ["cpu", "gpu"])
    def test_stream_verify_chunked(self, hasher):
        """Chunked transfer-encoding with frames straddling chunk edges."""

        async def go():
            server = await _start(hasher)
            try:
                plen = 2048
                pieces = _mk_pieces(300, plen)
                expected = [hashlib.sha1(p).digest() for p in pieces]
                expected[7] = b"\x00" * 20
                expected[299] = b"\xff" * 20
                status, resp = await _post(
                    server.port,
                    "/v1/stream/verify",
                    {"X-Piece-Length": str(plen)},
                    _frames(pieces, expected),
                    chunked=True,
                )
                assert status == 200
                body = bdecode(resp)
                ok = body[b"ok"]
                assert len(ok) == 300
                assert ok[7] == 0 and ok[299] == 0
                assert body[b"valid"] == 298
                assert all(ok[i] == 1 for i in range(300) if i not in (7, 299))
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    @pytest.mark.parametrize("hasher", ["cpu", "gpu"])
    def test_stream_sha256_digests_and_verify(self, hasher):
        """X-Hash-Algo: sha256 switches the stream routes to the v2 plane
        (32-byte digests/expected frames)."""

        async def go():
            server = await _start(hasher)
            try:
                plen = 1024
                pieces = _mk_pieces(300, plen)  # > batch_size → multi-flush
                headers = {"X-Piece-Length": str(plen), "X-Hash-Algo": "sha256"}
                status, resp = await _post(
                    server.port, "/v1/stream/digests", headers, _frames(pieces)
                )
                assert status == 200
                digests = bdecode(resp)[b"digests"]
                assert digests == [hashlib.sha256(p).digest() for p in pieces]

                expected = list(digests)
                expected[11] = b"\x00" * 32
                status, resp = await _post(
                    server.port, "/v1/stream/verify", headers,
                    _frames(pieces, expected), chunked=True,
                )
                assert status == 200
                body = bdecode(resp)
                assert body[b"valid"] == 299 and body[b"ok"][11] == 0
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    def test_buffered_routes_reject_sha256(self):
        """The bencode routes are sha1-only — a sha256 request must fail
        closed, never silently return v1 digests."""

        async def go():
            server = await _start("cpu")
            try:
                status, _ = await _post(
                    server.port, "/v1/digests", {"X-Hash-Algo": "sha256"},
                    bencode({b"pieces": [b"x"]}),
                )
                assert status == 400
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    def test_stream_rejects_bad_algo(self):
        async def go():
            server = await _start("cpu")
            try:
                status, _ = await _post(
                    server.port, "/v1/stream/digests",
                    {"X-Piece-Length": "64", "X-Hash-Algo": "md5"}, _frames([b"a"])
                )
                assert status == 400
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    def test_stream_rejects_oversized_frame(self):
        async def go():
            server = await _start("cpu")
            try:
                body = _frames([b"z" * 100])
                status, resp = await _post(
                    server.port, "/v1/stream/digests", {"X-Piece-Length": "64"}, body
                )
                assert status == 400
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    def test_stream_requires_piece_length(self):
        async def go():
            server = await _start("cpu")
            try:
                status, _ = await _post(
                    server.port, "/v1/stream/digests", {}, _frames([b"a"])
                )
                assert status == 400
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    def test_truncated_chunked_body_is_not_a_clean_200(self):
        """A connection cut mid-chunked-body must not yield 200 over
        partial frames (a silent partial recheck read as complete)."""

        async def go():
            server = await _start("cpu")
            try:
                reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
                body = _frames([b"a" * 64, b"b" * 64])
                part = body[: len(body) // 2]
                writer.write(
                    b"POST /v1/stream/digests HTTP/1.1\r\nHost: x\r\n"
                    b"X-Piece-Length: 64\r\nTransfer-Encoding: chunked\r\n\r\n"
                    + f"{len(part):x}\r\n".encode()
                    + part
                    + b"\r\n"
                )
                await writer.drain()
                writer.write_eof()  # cut the stream: no terminal 0-chunk
                data = await reader.read()
                assert b"200" not in data.split(b"\r\n", 1)[0]
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    def test_stream_empty_body(self):
        async def go():
            server = await _start("cpu")
            try:
                status, resp = await _post(
                    server.port, "/v1/stream/digests", {"X-Piece-Length": "1024"}, b""
                )
                assert status == 200
                assert bdecode(resp)[b"digests"] == []
            finally:
                server.close()
                await server.wait_closed()

        run(go())


# ------------------------------------------ tests/test_tools.py::TestBridge


class TestBridge:
    def test_digests_and_verify(self):
        async def go():
            server = await serve_bridge(port=0, hasher="cpu")
            try:
                pieces = [b"alpha", b"beta" * 1000, b""]
                body = bencode({b"pieces": pieces})
                status, resp = await _post(server.port, "/v1/digests", {}, body)
                assert status == 200
                digests = bdecode(resp)[b"digests"]
                assert digests == [hashlib.sha1(p).digest() for p in pieces]

                expected = list(digests)
                expected[1] = b"\x00" * 20  # corrupt one
                status, resp = await _post(
                    server.port, "/v1/verify", {},
                    bencode({b"pieces": pieces, b"expected": expected}),
                )
                assert status == 200
                assert bdecode(resp)[b"ok"] == b"\x01\x00\x01"

                status, resp = await _post(server.port, "/v1/digests", {}, b"garbage")
                assert status == 400
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    def test_info_route(self):
        async def go():
            server = await serve_bridge(port=0, hasher="cpu")
            try:
                reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
                writer.write(b"GET /v1/info HTTP/1.1\r\nHost: x\r\n\r\n")
                await writer.drain()
                data = await reader.read()
                body = data.split(b"\r\n\r\n", 1)[1]
                info = bdecode(body)
                assert info[b"backend"] == b"cpu" and info[b"devices"] >= 1
                writer.close()
            finally:
                server.close()
                await server.wait_closed()

        run(go())


# ----------------------------- tests/test_sched.py::TestBridgeScheduler


class TestBridgeScheduler:
    def test_concurrent_bridge_clients_coalesce(self):
        """≥8 concurrent bridge clients each submitting small piece
        counts achieve mean batch fill ≥0.9 of the target, with
        flush-reason and batch-fill metrics visible in /metrics."""

        async def go():
            server = await BridgeServer(
                port=0, hasher="cpu", batch_target=64, flush_deadline_ms=500
            ).start()
            try:
                async def client(j):
                    pieces = _pieces(16, 2048, salt=j)
                    status, resp = await _post(
                        server.port,
                        "/v1/digests",
                        {"X-Tenant": f"client{j}"},
                        bencode({b"pieces": pieces}),
                    )
                    assert status == 200
                    got = bdecode(resp)[b"digests"]
                    assert got == [hashlib.sha1(p).digest() for p in pieces]

                # 12 clients × 16 pieces = 192 = 3 full 64-piece launches
                await asyncio.gather(*(client(j) for j in range(12)))
                snap = server.sched.metrics_snapshot()
                assert snap["mean_fill"] >= 0.9, snap
                status, resp = await _get(server.port, "/metrics")
                assert status == 200
                text = resp.decode()
                assert "torrent_tpu_sched_batch_fill_ratio" in text
                assert 'torrent_tpu_sched_flush_total{reason="full"}' in text
                assert 'tenant="client0"' in text
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    def test_queue_full_maps_to_429(self):
        """Typed SchedRejected surfaces as HTTP 429 through the bridge."""

        async def go():
            server = await BridgeServer(
                port=0, hasher="cpu", max_queue_mb=1, tenant_max_mb=1
            ).start()
            try:
                stall = _StallPlane()
                server.sched.config.plane_factory = lambda a, b, t: stall
                # first request fills the 1 MiB budget and stalls in-plane
                big = asyncio.ensure_future(
                    _post(
                        server.port,
                        "/v1/digests",
                        {},
                        bencode({b"pieces": [b"z" * (1 << 20)]}),
                    )
                )
                # wait until the scheduler holds the bytes
                for _ in range(200):
                    if server.sched.metrics_snapshot()["queue_bytes"] > 0:
                        break
                    await asyncio.sleep(0.01)
                status, resp = await _post(
                    server.port,
                    "/v1/digests",
                    {},
                    bencode({b"pieces": [b"y" * (512 << 10)]}),
                )
                assert status == 429, (status, resp)
                assert b"queue full" in resp
                assert server.sched.metrics_snapshot()["shed_total"] == 1
                stall.release.set()
                status, _ = await asyncio.wait_for(big, 10)
                assert status == 200
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    def test_stream_flushes_on_byte_budget(self):
        """A streaming connection's pre-flush batch is per-connection
        memory the admission budget can't see: big-piece streams must
        hand bytes to the scheduler before the piece-count chunk fills."""
        from torrent_tpu_torch.bridge.service import STREAM_FLUSH_BYTES

        async def go():
            server = await BridgeServer(
                port=0, hasher="cpu", batch_target=4096, flush_deadline_ms=50
            ).start()
            try:
                calls: list[int] = []
                orig = server.sched.enqueue

                async def spy(tenant, pieces, **kw):
                    calls.append(sum(len(p) for p in pieces))
                    return await orig(tenant, pieces, **kw)

                server.sched.enqueue = spy
                plen = 1 << 20
                pieces = [bytes([i + 1]) * plen for i in range(6)]
                body = b"".join(len(p).to_bytes(4, "big") + p for p in pieces)
                status, resp = await _post(
                    server.port,
                    "/v1/stream/digests",
                    {"X-Piece-Length": str(plen)},
                    body,
                )
                assert status == 200
                assert bdecode(resp)[b"digests"] == [
                    hashlib.sha1(p).digest() for p in pieces
                ]
                # 6 MiB of 1 MiB pieces with a 4 MiB cap: must have
                # flushed mid-stream, never holding more than cap + one
                # piece locally
                assert len(calls) >= 2, calls
                assert max(calls) <= STREAM_FLUSH_BYTES + plen, calls
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    def test_info_reports_batch_target(self):
        async def go():
            server = await BridgeServer(port=0, hasher="cpu", batch_target=99).start()
            try:
                status, resp = await _get(server.port, "/v1/info")
                assert status == 200
                assert bdecode(resp)[b"batch"] == 99
            finally:
                server.close()
                await server.wait_closed()

        run(go())


# -------------------------- tests/test_faults.py::TestBridgeFaultMapping


class TestBridgeFaultMapping:
    def test_deterministic_failure_maps_to_500_without_retry_after(self):
        """A poisoned (deterministic) payload → 500 with NO Retry-After:
        resubmitting the same payload can never help, so the bridge must
        not invite it (shed stays 429: a different remedy)."""

        async def go():
            server = await BridgeServer(
                port=0, hasher="cpu", fault_plan="payload=bdbdbdbd"
            ).start()
            try:
                status, hdrs, resp = await _http(
                    server.port, "POST", "/v1/digests", {},
                    bencode({b"pieces": [b"\xbd\xbd\xbd\xbd" + b"x" * 60]}),
                )
                assert status == 500, (status, resp)
                assert "retry-after" not in hdrs, hdrs
                assert b"deterministic" in resp
                # a clean request on the same server still succeeds
                pieces = _pieces(4, 512)
                status, _, resp = await _http(
                    server.port, "POST", "/v1/digests", {}, bencode({b"pieces": pieces})
                )
                assert status == 200
                assert bdecode(resp)[b"digests"] == _sha1(pieces)
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    def test_transient_exhausted_maps_to_503_with_retry_after(self):
        """A transient failure that outlives the retry budget (single
        piece: nothing to bisect) → 503 + Retry-After."""

        async def go():
            server = BridgeServer(port=0, hasher="cpu", fault_plan="fail_first=2")
            # launch + its one retry both fail; keep the breaker out of
            # the picture so the CPU plane can't rescue the submission
            server._sched_config.breaker_threshold = 10
            await server.start()
            try:
                status, hdrs, resp = await _http(
                    server.port, "POST", "/v1/digests", {},
                    bencode({b"pieces": [b"q" * 64]}),
                )
                assert status == 503, (status, resp)
                assert hdrs.get("retry-after") == "1", hdrs
                assert b"transient" in resp
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    def test_stream_reports_per_frame_failures(self):
        """A poisoned piece in a stream fails its frame (empty digest +
        failed count) without dropping the connection or the other
        frames' digests."""

        async def go():
            # batch_target=1 -> one piece per frame/submission
            server = await BridgeServer(
                port=0,
                hasher="cpu",
                batch_target=1,
                flush_deadline_ms=20,
                fault_plan="payload=bdbdbdbd",
            ).start()
            try:
                plen = 1024
                pieces = _pieces(4, plen, salt=2)
                pieces[2] = b"\xbd\xbd\xbd\xbd" + b"z" * (plen - 4)
                body = b"".join(len(p).to_bytes(4, "big") + p for p in pieces)
                status, _, resp = await _http(
                    server.port, "POST", "/v1/stream/digests",
                    {"X-Piece-Length": str(plen)}, body,
                )
                assert status == 200, (status, resp)
                out = bdecode(resp)
                assert out[b"failed"] == 1
                digests = out[b"digests"]
                assert digests[2] == b""
                for i in (0, 1, 3):
                    assert digests[i] == hashlib.sha1(pieces[i]).digest()
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    def test_breaker_transitions_visible_in_bridge_metrics(self):
        """Injected device failures trip the breaker, digests keep
        matching hashlib via the CPU plane (a hashlib scheduler's
        degradation; a card's refuses instead), and the transitions
        show up in GET /metrics."""

        async def go():
            server = BridgeServer(port=0, hasher="cpu", fault_plan="fail_first=2")
            server._sched_config.breaker_threshold = 2
            server._sched_config.breaker_cooldown = 300.0
            await server.start()
            try:
                pieces = _pieces(4, 512)
                status, _, resp = await _http(
                    server.port, "POST", "/v1/digests", {}, bencode({b"pieces": pieces})
                )
                assert status == 200, (status, resp)
                assert bdecode(resp)[b"digests"] == _sha1(pieces)
                status, _, resp = await _http(server.port, "GET", "/metrics")
                text = resp.decode()
                assert 'transition="closed->open"} 1' in text, text
                assert "torrent_tpu_sched_breaker_state{" in text
                assert "torrent_tpu_sched_cpu_fallback_launches_total" in text
                _rewind_breaker(server.sched)  # expire cooldown -> probe
                status, _, resp = await _http(
                    server.port, "POST", "/v1/digests", {}, bencode({b"pieces": pieces})
                )
                assert status == 200
                assert bdecode(resp)[b"digests"] == _sha1(pieces)
                status, _, resp = await _http(server.port, "GET", "/metrics")
                text = resp.decode()
                assert 'transition="half_open->closed"} 1' in text, text
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    def test_fault_plan_knob_requires_dev_mode(self, monkeypatch, capsys):
        """--fault-plan is refused outside dev/test mode (no env, no
        --dev), and a bad spec is refused even in dev mode — chaos knobs
        can't leak into production invocations."""
        from torrent_tpu_torch.bridge.__main__ import main

        monkeypatch.delenv("TORRENT_TPU_DEV", raising=False)
        rc = main(["--port", "0", "--fault-plan", "fail_first=1"])
        assert rc == 2
        assert "dev/test" in capsys.readouterr().err
        rc = main(["--port", "0", "--dev", "--fault-plan", "frobnicate=1"])
        assert rc == 2
        assert "bad --fault-plan" in capsys.readouterr().err

    def test_card_breaker_refusal_maps_to_503(self):
        """On a card an open breaker fails the refused launches (a
        transient SchedLaunchError, never hashlib); the bridge answers
        them 503 + Retry-After on the buffered routes and per-frame
        ``failed`` on the stream routes. Forced here on a ``device="cpu"``
        scheduler over hashlib factory planes."""
        from torrent_tpu_torch.sched import FaultPlan

        async def go():
            plan = FaultPlan(fail_first=2)
            server = BridgeServer(port=0, hasher="cpu", batch_target=4)
            server._sched_config.plane_factory = plan.plane_factory(hasher="cpu")
            server._sched_config.breaker_threshold = 2
            server._sched_config.breaker_cooldown = 300.0
            await server.start()
            server.sched._on_card = lambda: True
            try:
                pieces = _pieces(4, 512)
                status, hdrs, resp = await _http(
                    server.port, "POST", "/v1/digests", {}, bencode({b"pieces": pieces})
                )
                assert status == 503, (status, resp)
                assert hdrs.get("retry-after") == "1"
                snap = server.sched.metrics_snapshot()
                assert snap["cpu_fallback_launches"] == 0
                assert next(iter(snap["breakers"].values()))["state"] == "open"
                status, _, resp = await _http(
                    server.port, "POST", "/v1/stream/digests",
                    {"X-Piece-Length": "512"}, _frames(pieces),
                )
                assert status == 200
                out = bdecode(resp)
                assert out[b"failed"] == 4 and out[b"digests"] == [b""] * 4
                assert server.sched.metrics_snapshot()["cpu_fallback_launches"] == 0
            finally:
                server.close()
                await server.wait_closed()

        run(go())


class TestAbandonedSubmission:
    def test_bridge_client_disconnect_recovers(self):
        """A bridge client that vanishes before its response: the
        handler's reply write fails quietly, queued-byte accounting fully
        drains, and the next client is served normally."""

        async def go():
            server = await BridgeServer(port=0, hasher="cpu").start()
            try:
                stall = _StallPlane()
                server.sched.config.plane_factory = lambda a, b, t: stall
                body = bencode({b"pieces": [b"q" * 4096]})
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", server.port
                )
                writer.write(
                    (
                        "POST /v1/digests HTTP/1.1\r\nHost: x\r\n"
                        f"Content-Length: {len(body)}\r\n\r\n"
                    ).encode()
                    + body
                )
                await writer.drain()
                for _ in range(200):
                    if server.sched.metrics_snapshot()["queue_bytes"] > 0:
                        break
                    await asyncio.sleep(0.01)
                writer.close()  # disconnect before the demux
                stall.release.set()
                for _ in range(200):
                    if server.sched.metrics_snapshot()["queue_bytes"] == 0:
                        break
                    await asyncio.sleep(0.01)
                assert server.sched.metrics_snapshot()["queue_bytes"] == 0
                # the plane seam back to normal: next client unaffected
                server.sched.config.plane_factory = None
                pieces = _pieces(4, 512)
                status, _, resp = await _http(
                    server.port, "POST", "/v1/digests", {}, bencode({b"pieces": pieces})
                )
                assert status == 200
                assert bdecode(resp)[b"digests"] == _sha1(pieces)
            finally:
                server.close()
                await server.wait_closed()

        run(go())


# ---------------------------------- tests/test_obs.py::TestBridgeTracing


def span_names(tree):
    def walk(node):
        yield node["name"]
        for c in node["children"]:
            yield from walk(c)

    return [n for root in tree["spans"] for n in walk(root)]


def flat_spans(tree):
    def walk(node):
        yield node
        for c in node["children"]:
            yield from walk(c)

    return [s for root in tree["spans"] for s in walk(root)]


class TestBridgeTracing:
    def test_verify_with_trace_header_yields_span_tree(self):
        """X-Trace-Id: t1 on /v1/verify, then GET /v1/trace?id=t1 shows
        the ordered lifecycle."""

        async def go():
            server = await serve_bridge(port=0, hasher="cpu")
            try:
                pieces = [b"a" * 100, b"b" * 100]
                exp = [hashlib.sha1(p).digest() for p in pieces]
                body = bencode({b"pieces": pieces, b"expected": exp})
                st, hdrs, _ = await _http(
                    server.port, "POST", "/v1/verify",
                    {"X-Trace-Id": "port-t1", "X-Tenant": "deno"}, body,
                )
                assert st == 200
                assert hdrs["x-trace-id"] == "port-t1"  # honored + echoed
                st, hdrs, resp = await _http(server.port, "GET", "/v1/trace?id=port-t1")
                assert st == 200
                assert hdrs["content-type"] == "application/json"
                tree = json.loads(resp)
                names = span_names(tree)
                for stage in ("bridge.request", "sched.enqueue",
                              "sched.admission", "sched.lane_wait",
                              "sched.launch", "sched.digest"):
                    assert stage in names, names
                # ordered with monotonic durations
                spans = flat_spans(tree)
                assert all(s["duration_ms"] >= 0 for s in spans)
                root = tree["spans"][0]
                assert root["name"] == "bridge.request"
                assert root["attrs"]["tenant"] == "deno"
                kids = root["children"][0]["children"]
                starts = [k["start_ms"] for k in kids]
                assert starts == sorted(starts)
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    def test_minted_trace_id_echoed_and_bad_header_replaced(self):
        from torrent_tpu_torch.obs import valid_trace_id

        async def go():
            server = await serve_bridge(port=0, hasher="cpu")
            try:
                st, hdrs, _ = await _http(server.port, "GET", "/v1/info")
                assert st == 200
                minted = hdrs["x-trace-id"]
                assert valid_trace_id(minted)
                st, hdrs, _ = await _http(
                    server.port, "GET", "/v1/info",
                    {"X-Trace-Id": 'evil"id\x01' + "x" * 100},
                )
                assert valid_trace_id(hdrs["x-trace-id"])
                assert hdrs["x-trace-id"] != minted
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    def test_metrics_content_type_and_histogram_series(self):
        async def go():
            server = await serve_bridge(port=0, hasher="cpu")
            try:
                body = bencode({b"pieces": [b"x" * 64]})
                await _http(server.port, "POST", "/v1/digests", {}, body)
                st, hdrs, resp = await _http(server.port, "GET", "/metrics")
                assert st == 200
                assert hdrs["content-type"] == (
                    "text/plain; version=0.0.4; charset=utf-8"
                )
                text = resp.decode()
                for family in (
                    "torrent_tpu_sched_queue_wait_seconds",
                    "torrent_tpu_sched_launch_seconds",
                    "torrent_tpu_bridge_request_seconds",
                ):
                    assert f"# TYPE {family} histogram" in text
                    assert f"{family}_bucket" in text
                    assert f"{family}_sum" in text
                    assert f"{family}_count" in text
                prom_lint(text)
            finally:
                server.close()
                await server.wait_closed()

        run(go())

    def test_trace_listing_and_unknown_id(self):
        async def go():
            server = await serve_bridge(port=0, hasher="cpu")
            try:
                st, _, resp = await _http(server.port, "GET", "/v1/trace")
                assert st == 200
                listing = json.loads(resp)
                assert set(listing) == {"dump_counts", "dumps", "traces"}
                st, _, _ = await _http(server.port, "GET", "/v1/trace?id=absent")
                assert st == 404
            finally:
                server.close()
                await server.wait_closed()

        run(go())


# --------------------- the pipeline, fleet, fabric, control, swarm routes


class TestOperatorRoutes:
    def test_bridge_pipeline_route_names_h2d(self):
        """tests/test_pipeline.py's bridge case: an h2d-throttled plane
        is named the bottleneck on /v1/pipeline and /metrics."""
        from torrent_tpu_torch.obs.ledger import pipeline_ledger

        async def go():
            pipeline_ledger().clear()
            svc = await BridgeServer(
                "127.0.0.1", port=0, hasher="cpu",
                fault_plan="latency_ms=25", batch_target=8,
            ).start()
            try:
                pieces = [bytes([i]) * 1024 for i in range(16)]
                body = bencode({b"pieces": pieces})
                status, _, _ = await _http(svc.port, "POST", "/v1/digests", {}, body)
                assert status == 200
                status, hdrs, resp = await _http(svc.port, "GET", "/v1/pipeline")
                assert status == 200
                assert hdrs["content-type"].startswith("application/json")
                payload = json.loads(resp)
                bn = payload["attribution"]["bottleneck"]
                assert bn["stage"] == "h2d", payload["attribution"]
                assert payload["sched"]["launches"] >= 1
                assert "h2d" in payload["snapshot"]["stages"]
                # /metrics carries the same ledger as Prometheus series
                status, _, resp = await _http(svc.port, "GET", "/metrics")
                assert status == 200
                text = resp.decode()
                assert 'torrent_tpu_pipeline_bottleneck{stage="h2d"} 1' in text
                prom_lint(text)
            finally:
                svc.close()
                await svc.wait_closed()

        run(go())

    def test_fleet_route_idle_and_after_fabric(self, tmp_path):
        """tests/test_fleet.py::TestBridgeFleetRoute."""
        from test_torch_fabric import PLEN, make_library
        from torrent_tpu_torch.tools.make_torrent import make_torrent

        make_library(tmp_path, [30])
        tf = tmp_path / "lib0.torrent"
        tf.write_bytes(
            make_torrent(
                str(tmp_path / "data" / "lib0" / "payload.bin"),
                "http://t.invalid/announce", piece_length=PLEN, hasher="cpu",
            )
        )

        async def go():
            svc = await BridgeServer("127.0.0.1", 0, hasher="cpu").start()
            try:
                # idle: the fleet-of-one from local obs state
                st, resp = await _get(svc.port, "/v1/fleet")
                assert st == 200
                idle = json.loads(resp.decode())
                assert idle["state"] == "local"
                assert idle["nproc"] == 1
                # run a fabric job, then the route serves the executor view
                body = bencode(
                    {
                        b"items": [
                            {
                                b"torrent": str(tf).encode(),
                                b"root": str(tmp_path / "data" / "lib0").encode(),
                            }
                        ]
                    }
                )
                st, _ = await _post(svc.port, "/v1/fabric/verify", {}, body)
                assert st == 202
                for _ in range(200):
                    st, resp = await _get(svc.port, "/v1/fabric/status")
                    if bdecode(resp)[b"state"] == b"done":
                        break
                    await asyncio.sleep(0.05)
                st, resp = await _get(svc.port, "/v1/fleet")
                assert st == 200
                fleet = json.loads(resp.decode())
                assert fleet["state"] == "done"
                assert fleet["reporting"] == 1
                assert fleet["scoreboard"][0]["units_done"] >= 1
                # fleet series ride /metrics while the job exists
                st, resp = await _get(svc.port, "/metrics")
                text = resp.decode()
                assert "torrent_tpu_fleet_reporting 1" in text
                assert "torrent_tpu_fleet_digest_dropped_total 0" in text
            finally:
                svc.close()
                await svc.wait_closed()

        run(go())

    @pytest.mark.parametrize("hasher", ["cpu", "gpu"])
    def test_fabric_verify_and_status(self, tmp_path, hasher):
        """tests/test_fabric.py::TestBridgeFabricRoutes, on hashlib and on
        the device planes (``device="cpu"``)."""
        from test_torch_fabric import make_library

        _, tdir, ddir = make_library(tmp_path, [30], corrupt=(0, 3))
        tf = tdir / "lib0.torrent"
        root = ddir / "lib0"

        async def go():
            svc = await BridgeServer("127.0.0.1", 0, **_kw(hasher)).start()
            try:
                st, resp = await _get(svc.port, "/v1/fabric/status")
                assert st == 200 and bdecode(resp) == {b"state": b"idle"}
                # bad requests fail closed
                st, _ = await _post(svc.port, "/v1/fabric/verify", {}, b"junk")
                assert st == 400
                st, _ = await _post(
                    svc.port, "/v1/fabric/verify", {}, bencode({b"items": []})
                )
                assert st == 400
                body = bencode(
                    {b"items": [{b"torrent": str(tf).encode(), b"root": str(root).encode()}]}
                )
                st, resp = await _post(svc.port, "/v1/fabric/verify", {}, body)
                assert st == 202, resp
                assert bdecode(resp)[b"pieces"] == 30
                for _ in range(400):
                    st, resp = await _get(svc.port, "/v1/fabric/status")
                    d = bdecode(resp)
                    if d[b"state"] == b"done":
                        break
                    await asyncio.sleep(0.05)
                assert d[b"state"] == b"done", d
                assert d[b"result"][b"valid"] == 29  # corrupt piece 3
                assert d[b"result"][b"per_torrent"] == [29]
                assert d[b"fabric"][b"units_done"] >= 1
                assert d[b"fabric"][b"sentinel_mismatches"] == 0
                # fabric gauges flow into /metrics
                st, resp = await _get(svc.port, "/metrics")
                text = resp.decode()
                assert "torrent_tpu_fabric_state" in text
                assert "torrent_tpu_fabric_sentinel_mismatches_total" in text
                assert 'torrent_tpu_sched_tenant_served_pieces_total{tenant="fabric"} 30' in text
            finally:
                svc.close()
                await svc.wait_closed()

        run(go())

    def test_bridge_control_route_and_metrics(self):
        """tests/test_control.py's bridge case."""

        async def go():
            svc = await BridgeServer(
                "127.0.0.1", port=0, hasher="cpu",
                autopilot=ControlConfig(enabled=True, interval_s=0.05),
            ).start()
            try:
                svc.autopilot.tick()
                status, body = await _get(svc.port, "/v1/control")
                assert status == 200
                payload = json.loads(body.decode())
                assert payload["attached"] is True
                assert payload["enabled"] is True
                assert "actuators" in payload
                status, body = await _get(svc.port, "/metrics")
                assert status == 200
                assert b"torrent_tpu_control_enabled 1" in body
                status, body = await _get(svc.port, "/v1/pipeline")
                assert json.loads(body.decode())["control"]["enabled"] is True
            finally:
                svc.close()
                await svc.wait_closed()

            # a bridge WITHOUT an autopilot still answers /v1/control
            svc = await BridgeServer("127.0.0.1", port=0, hasher="cpu").start()
            try:
                status, body = await _get(svc.port, "/v1/control")
                assert status == 200
                payload = json.loads(body.decode())
                assert payload["attached"] is False
                status, body = await _get(svc.port, "/metrics")
                assert b"torrent_tpu_control_enabled" not in body
            finally:
                svc.close()
                await svc.wait_closed()

        run(go())

    def test_bridge_serves_v1_swarm(self):
        """tests/test_swarm_obs.py's bridge case: the shape contract, even
        on an idle hash-plane sidecar."""

        async def go():
            svc = await BridgeServer("127.0.0.1", port=0, hasher="cpu").start()
            try:
                def fetch():
                    with urllib.request.urlopen(
                        f"http://127.0.0.1:{svc.port}/v1/swarm", timeout=10
                    ) as r:
                        assert r.headers["Content-Type"] == "application/json"
                        return json.loads(r.read().decode())

                payload = await asyncio.to_thread(fetch)
                assert set(payload) >= {
                    "counts", "peers", "overflow", "totals", "msgs", "triggers",
                }
            finally:
                svc.close()
                await svc.wait_closed()

        run(go())


# ---------------------------------------------------------- the card rule


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class TestNoFallback:
    def test_gpu_without_a_device_raises_before_listening(self):
        """No CUDA here: ``hasher="gpu"`` with ``device=None`` raises at
        ``start()``, and the port it was given is still free after."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("this host has CUDA: the card rule is the gpu tests'")
        port = _free_port()

        async def go():
            svc = BridgeServer("127.0.0.1", port)
            with pytest.raises(RuntimeError, match="CUDA"):
                await svc.start()
            assert svc._server is None and svc.sched is None
            with socket.socket() as s:
                s.bind(("127.0.0.1", port))  # nothing listens on it

        run(go())

    def test_command_line_defaults_fail_without_cuda(self):
        """``python -m torrent_tpu_torch.bridge`` with its defaults (the
        card) exits non-zero on a host without CUDA, naming it."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("this host has CUDA: the card rule is the gpu tests'")
        proc = subprocess.run(
            [sys.executable, "-m", "torrent_tpu_torch.bridge", "--port", "0"],
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0
        assert "CUDA" in proc.stderr
        assert "listening" not in proc.stdout

    def test_prewarm_builds_the_lanes_only_on_a_card(self):
        """``start()`` warms the common geometries on a card (kernel
        load, staging slots), and nothing elsewhere — forced here on a
        ``device="cpu"`` scheduler."""
        from torrent_tpu_torch.bridge.service import WARM_GEOMETRIES

        async def go():
            svc = await BridgeServer(port=0, hasher="gpu", device="cpu").start()
            try:
                assert svc.sched.metrics_snapshot()["lanes"] == 0
                svc.sched._on_card = lambda: True
                for algo, plen in WARM_GEOMETRIES:
                    await svc.sched.prewarm(algo, plen)
                lanes = svc.sched._lanes
                assert sorted(lanes) == sorted(
                    (algo, svc.sched.bucket_for(plen)) for algo, plen in WARM_GEOMETRIES
                )
                depth = svc.sched.config.pipeline_depth
                for lane in lanes.values():
                    slots = lane.plane._slots
                    assert slots.allocs == depth and slots.outstanding == 0
                # a warmed lane serves its first request with no new slot
                pieces = _pieces(3, 16 << 10)
                status, resp = await _post(
                    svc.port, "/v1/stream/digests",
                    {"X-Piece-Length": str(16 << 10), "X-Hash-Algo": "sha256"},
                    _frames(pieces),
                )
                assert status == 200
                assert bdecode(resp)[b"digests"] == [hashlib.sha256(p).digest() for p in pieces]
                assert lanes[("sha256", 16 << 10)].plane._slots.allocs == depth
            finally:
                svc.close()
                await svc.wait_closed()

        run(go(), timeout=300)


# ---------------------------------------------------------- differential


async def _both(coro_fn):
    """Run ``coro_fn(ref_port, port)`` against a reference bridge on
    JAX's CPU and the port's bridge on ``device="cpu"``."""
    from torrent_tpu.bridge.service import BridgeServer as RefBridge

    ref = await RefBridge(port=0, hasher="tpu").start()
    mine = await BridgeServer(port=0, hasher="gpu", device="cpu").start()
    try:
        await asyncio.gather(ref._probe_task, mine._probe_task)
        return await coro_fn(ref, mine)
    finally:
        for svc in (ref, mine):
            svc.close()
            await svc.wait_closed()


def _seeded_pieces(rng, n: int, lo: int = 2049, hi: int = 4096) -> list[bytes]:
    """``n`` random pieces in one 4 KiB bucket (one compiled geometry in
    the reference), the longest exactly ``hi``."""
    lens = rng.integers(lo, hi + 1, size=n)
    lens[int(rng.integers(0, n))] = hi
    return [rng.integers(0, 256, size=int(k), dtype=np.uint8).tobytes() for k in lens]


def _families(text: str) -> set[str]:
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}


class TestDifferential:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_data_routes_answer_byte_equal(self, seed):
        rng = np.random.default_rng(seed)
        pieces = _seeded_pieces(rng, 40)
        stream_pieces = pieces[:23] + [pieces[23][: int(rng.integers(1, 2048))]]
        sha1 = _sha1(pieces)
        expected = list(sha1)
        for i in rng.choice(len(pieces), size=3, replace=False):
            expected[int(i)] = rng.integers(0, 256, 20, dtype=np.uint8).tobytes()

        requests = [
            ("/v1/digests", {}, bencode({b"pieces": pieces}), False),
            ("/v1/verify", {"X-Tenant": "diff"},
             bencode({b"pieces": pieces, b"expected": expected}), False),
        ]
        for algo, h in (("sha1", hashlib.sha1), ("sha256", hashlib.sha256)):
            exp = [h(p).digest() for p in stream_pieces]
            exp[int(rng.integers(0, len(exp)))] = bytes(len(exp[0]))
            hdr = {"X-Piece-Length": "4096", "X-Hash-Algo": algo}
            requests += [
                ("/v1/stream/digests", hdr, _frames(stream_pieces), False),
                ("/v1/stream/verify", hdr, _frames(stream_pieces, exp), True),
            ]

        async def go(ref, mine):
            bodies = []
            for path, hdr, body, chunked in requests:
                want = await _post(ref.port, path, hdr, body, chunked)
                got = await _post(mine.port, path, hdr, body, chunked)
                assert got == want, path
                assert got[0] == 200, (path, got)
                bodies.append(bdecode(got[1]))
            return bodies

        digests, verify, s1d, s1v, s256d, s256v = run(_both(go), timeout=300)
        assert digests[b"digests"] == sha1
        assert verify[b"ok"] == bytes(int(a == b) for a, b in zip(sha1, expected))
        assert s1d[b"digests"] == _sha1(stream_pieces)
        assert s256d[b"digests"] == [hashlib.sha256(p).digest() for p in stream_pieces]
        assert s1v[b"valid"] == s256v[b"valid"] == len(stream_pieces) - 1

    def test_error_paths_answer_the_same(self):
        big = b"POST /v1/digests HTTP/1.1\r\nHost: x\r\n" + (b"X-Pad: " + b"p" * 1000 + b"\r\n") * 20
        cases = [
            ("POST", "/v1/digests", {}, b"garbage"),
            ("POST", "/v1/digests", {}, bencode({b"nope": 1})),
            ("POST", "/v1/digests", {}, bencode({b"pieces": [1, 2]})),
            ("POST", "/v1/digests", {"X-Hash-Algo": "sha256"}, bencode({b"pieces": [b"x"]})),
            ("POST", "/v1/verify", {}, bencode({b"pieces": [b"x"], b"expected": [b"short"]})),
            ("POST", "/v1/verify", {}, bencode({b"pieces": [b"x"]})),
            ("POST", "/v1/digests", {}, bencode({b"pieces": [b"z" * ((16 << 20) + 1)]})),
            ("POST", "/v1/nowhere", {}, bencode({b"pieces": []})),
            ("GET", "/v1/digests", {}, b""),
            ("GET", "/v1/nowhere", {}, b""),
            ("GET", "/v1/trace?id=absent-port-diff", {}, b""),
            ("POST", "/v1/stream/digests", {}, _frames([b"a"])),
            ("POST", "/v1/stream/digests", {"X-Piece-Length": "zz"}, _frames([b"a"])),
            ("POST", "/v1/stream/digests", {"X-Piece-Length": str((16 << 20) + 1)}, b""),
            ("POST", "/v1/stream/digests", {"X-Piece-Length": "64", "X-Hash-Algo": "md5"}, b""),
            ("POST", "/v1/stream/digests", {"X-Piece-Length": "64"}, _frames([b"z" * 100])),
            ("POST", "/v1/stream/sideways", {"X-Piece-Length": "64"}, b""),
            ("POST", "/v1/stream/digests", {"X-Piece-Length": "1024"}, b""),
            ("POST", "/v1/fabric/verify", {}, b"junk"),
            ("POST", "/v1/fabric/verify", {}, bencode({b"items": []})),
            ("POST", "/v1/fabric/verify", {}, bencode({b"items": [{b"root": b"/"}]})),
            ("POST", "/v1/fabric/verify", {},
             bencode({b"items": [{b"torrent": b"/nonexistent/x.torrent"}]})),
            ("GET", "/v1/fabric/status", {}, b""),
        ]

        async def raw(port, data: bytes) -> bytes:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(data)
            await writer.drain()
            out = await reader.read()
            writer.close()
            return out.split(b"\r\n", 1)[0]

        async def go(ref, mine):
            for method, path, hdr, body in cases:
                want = await _http(ref.port, method, path, hdr, body)
                got = await _http(mine.port, method, path, hdr, body)
                assert (got[0], got[2]) == (want[0], want[2]), (method, path)
                assert want[0] != 500, (method, path, want)
            for data in (
                big + b"\r\n",
                b"POST /v1/digests HTTP/1.1\r\nContent-Length: nan\r\n\r\n",
                b"POST /v1/digests HTTP/1.1\r\nContent-Length: %d\r\n\r\n" % ((1 << 30) + 1),
                b"\r\n",
            ):
                assert await raw(mine.port, data) == await raw(ref.port, data)

        run(_both(go), timeout=300)

    def test_info_and_metric_families(self, fresh_globals):
        from torrent_tpu.utils.metrics import render_tsan_metrics

        async def go(ref, mine):
            body = bencode({b"pieces": _seeded_pieces(np.random.default_rng(3), 8)})
            for svc in (ref, mine):
                assert (await _post(svc.port, "/v1/digests", {"X-Tenant": "fam"}, body))[0] == 200
            want = bdecode((await _get(ref.port, "/v1/info"))[1])
            got = bdecode((await _get(mine.port, "/v1/info"))[1])
            return want, got, (await _get(ref.port, "/metrics"))[1], (
                await _get(mine.port, "/metrics")
            )[1]

        want, got, ref_text, text = run(_both(go), timeout=300)
        differ = {b"backend", b"devices", b"sha256_backend"}
        assert {k: v for k, v in got.items() if k not in differ} == {
            k: v for k, v in want.items() if k not in differ
        }
        assert got[b"backend"] == b"gpu" and got[b"sha256_backend"] == b"torch"
        assert got[b"devices"] == 1
        sanitizer = _families(render_tsan_metrics({}))
        assert _families(text.decode()) == _families(ref_text.decode()) - sanitizer
        prom_lint(text.decode())
