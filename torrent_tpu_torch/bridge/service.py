"""Localhost HTTP bridge to the GPU hash plane.

The north star's topology: a non-Python BitTorrent client (e.g. the
reference's Deno runtime) streams piece buffers to a local sidecar that
hashes them on the card, and gets digests/verdicts back. Wire format is
bencode — the one codec every BitTorrent client already has:

  POST /v1/digests   body {pieces: [bytes, ...]}
                     → {digests: [20-byte sha1, ...]}
  POST /v1/verify    body {pieces: [bytes, ...], expected: [20B, ...]}
                     → {ok: bytes}            (one 0x00/0x01 per piece)
  GET  /v1/info      → {backend, devices, batch} (capability probe)
  GET  /metrics      → scheduler queue/fill/shed counters + per-stage
                       latency histograms (Prometheus text format 0.0.4)
  GET  /v1/trace     → JSON: ?id=<trace> the ordered span tree for that
                       trace; without id, the flight recorder's black-
                       box dumps + known trace ids (obs/)
  GET  /v1/pipeline  → JSON: the pipeline ledger's per-stage snapshot
                       (recv → read → stage → h2d → launch → digest →
                       verdict)
                       plus the bottleneck attributor's verdict — which
                       stage limits the pipeline, achieved vs demanded
                       rate (obs/ledger + obs/attrib; `torrent-tpu top`
                       renders this live)
  GET  /v1/control   → JSON: the scheduler autopilot's last decision,
                       the inputs it saw, and every actuator's current
                       value (sched/control.py; `--autopilot` arms
                       actuation, otherwise the route reports the
                       controller as absent)
  GET  /v1/timeline  → JSON: the bounded ring of periodic obs samples
                       (obs/timeline; `--slo` arms the off-loop
                       sampler), dumpable to TORRENT_TPU_TIMELINE_DIR
                       and replayable offline via `torrent-tpu replay`
  GET  /v1/slo       → JSON: declared objectives, error-budget burn
                       rates (multi-window fast/slow classification),
                       budget remaining, breach state (obs/slo)
  GET  /v1/health    → JSON: liveness + readiness for a load balancer —
                       200 only when the backend probe resolved, no
                       breaker is stuck open past cooldown, the sampler
                       is alive, and no SLO objective is in breach
                       (503 with reasons otherwise)
  GET  /v1/swarm     → JSON: the swarm wire plane's bounded per-peer
                       telemetry (obs/swarm): top-K peers + overflow
                       fold, per-peer message/byte accounting, choke
                       timelines, block-RTT p50/p99, snub and
                       endgame-cancel counters, announce health
                       (`torrent-tpu top --swarm` renders it live; the
                       session MetricsServer answers the same route)

Every request runs under a trace span: an ``X-Trace-Id`` request header
is honored (well-formed tokens only) or a fresh id is minted, the id is
echoed back in the response, and the scheduler threads it through the
ticket lifecycle (enqueue → admission/shed → lane wait → launch/retry/
bisect → digest → verdict) so ``/v1/trace?id=…`` shows where a request
spent its time.

  POST /v1/fabric/verify  body {items: [{torrent, root}, ...]}
                          → 202; starts a scheduler-fed library recheck
                            (fabric/) of sidecar-local paths
  GET  /v1/fabric/status  → {state, fabric: {units_done, adopted, ...}}
                            plus the result summary once done; the same
                            gauges flow into /metrics as
                            torrent_tpu_fabric_* while the job exists
  GET  /v1/fleet     → JSON: this process's view of the FLEET — own obs
                       digest merged with every peer's heartbeat-carried
                       digest (obs/fleet): two-level bottleneck verdict
                       (limiting process → its limiting stage), the
                       straggler scoreboard, per-process attribution.
                       A fleet-of-one from local state when no fabric
                       job runs; torrent_tpu_fleet_* series mirror it
                       on /metrics, `torrent-tpu top --fleet` renders
                       it live

Every route submits into the shared hash-plane scheduler
(``sched/``) instead of owning staging buffers: pieces from many
concurrent clients coalesce into full device batches (one launch serves
everyone), per-tenant deficit round-robin keeps a greedy
client from starving a trickle one, and admission control bounds queue
memory. Clients name themselves with an ``X-Tenant`` header (default
``"default"``). When the queue is over budget a buffered request is shed
with **429** (retry later); a streaming ingest is *delayed* instead —
the blocking submit propagates backpressure to the TCP socket.

Streaming ingest (the north-star topology: a Deno client pushing a
100 GiB recheck must not need 100 GiB resident in the sidecar). The
client declares the torrent's piece length in an ``X-Piece-Length``
header and streams length-prefixed frames; the sidecar chunks them into
scheduler submissions sized to one device launch (flushed early past a
per-connection byte cap). Resident memory is bounded by the scheduler's
admission budget plus one small staging buffer per connection,
independent of body size.
Bodies may be Content-Length or chunked transfer-encoding (what a Deno
``fetch`` with a ReadableStream body produces).

  POST /v1/stream/digests   frames: u32be(len) | piece
                            → {digests: [20B, ...]}
  POST /v1/stream/verify    frames: u32be(len) | piece | 20B expected
                            → {ok: bytes, valid: int}

An ``X-Hash-Algo: sha256`` header switches the stream routes to the v2
hash plane (BEP 52 leaf/merkle hashing feeds on 32-byte digests); the
default is sha1. Digest/expected width follows the algorithm. The
device alone picks each lane's plane: on a card the sha1 lanes run the
hand-written SHA-1 kernel (``csrc/sha1.cu``) and the sha256 lanes the
SHA-256 row kernel (``csrc/sha256.cu``); ``device="cpu"`` runs their
plain PyTorch versions, and ``hasher="cpu"`` is hashlib. Stream chunking
follows the lane's flush target so submissions arrive launch-shaped.

Failure mapping (scheduler fault-tolerance layer, ``sched/scheduler``):
admission shed stays **429**; a launch failure that outlives retry +
bisection surfaces on the buffered routes as **503** with a
``Retry-After`` header when transient, or **500** (no Retry-After) when
deterministic — the payload itself fails the plane, so resubmitting
cannot help. Streaming responses never drop the connection for a
per-frame hash failure — failed frames come back as empty digests (or
``ok=0``) plus a ``failed`` count, so a 100 GiB recheck survives one
poisoned piece:

  {digests: [20B | "" per failed frame, ...], failed: int}
  {ok: bytes, valid: int, failed: int}   (failed ⊆ the ok=0 frames)

``--fault-plan SPEC`` (dev/test mode only — requires ``--dev`` or
``TORRENT_TPU_DEV=1``) injects deterministic faults through
``sched/faults.py`` for manual chaos runs. ``python -m
torrent_tpu_torch.bridge`` (``bridge/__main__.py``) is the command line.

Nothing here hashes on the host behind a card's back: ``hasher="gpu"``
with ``device=None`` means CUDA, and :meth:`BridgeServer.start` raises
on a host without it before the listen socket opens.

Hand-rolled asyncio HTTP — no web framework needed for six routes.
"""

from __future__ import annotations

import asyncio
import json
import time

from torrent_tpu_torch.codec.bencode import BencodeError, bdecode, bencode
from torrent_tpu_torch.obs import (
    flight_recorder,
    histograms,
    render_obs_metrics,
    tracer,
    valid_trace_id,
)
from torrent_tpu_torch.sched import (
    FaultPlan,
    HashPlaneScheduler,
    SchedLaunchError,
    SchedRejected,
    SchedulerConfig,
)
from torrent_tpu_torch.utils.log import get_logger

log = get_logger("bridge")

# request-latency histogram label set stays bounded: unknown paths
# collapse into "other"
_KNOWN_ROUTES = frozenset(
    {
        "/v1/digests", "/v1/verify", "/v1/info", "/v1/trace", "/metrics",
        "/v1/pipeline", "/v1/fleet", "/v1/control",
        "/v1/timeline", "/v1/slo", "/v1/health", "/v1/swarm",
        "/v1/fabric/verify", "/v1/fabric/status",
        "/v1/stream/digests", "/v1/stream/verify",
    }
)
_H_REQUEST = (
    "torrent_tpu_bridge_request_seconds",
    "Bridge HTTP request duration by route",
)

MAX_BODY = 1 << 30  # 1 GiB of piece data per buffered (non-stream) request
# Cap on one streamed frame. 16 MiB is the practical BitTorrent piece-size
# ceiling, and it keeps the scheduler's staging-budget rule honest: the
# biggest lane bucket a client can force is 16 MiB.
MAX_PIECE = 16 << 20
# An endless frame stream must not grow the result lists without bound:
# 4M frames ≈ 80 MB of digests ≈ a 1 TiB torrent at 256 KiB pieces.
MAX_STREAM_FRAMES = 1 << 22
FRAME_TIMEOUT = 60.0  # idle seconds between frame reads before dropping
# Per-connection pre-flush staging cap: frames accumulate locally until
# handed to the scheduler, and those bytes are invisible to its admission
# budget — without this bound N streaming connections of 16 MiB pieces
# hold N × chunk × 16 MiB resident before the first enqueue.
STREAM_FLUSH_BYTES = 4 << 20
# Lanes a card's bridge builds in start(): v1's 256 KiB pieces (the
# recheck's geometry) and BEP 52's 16 KiB sha256 leaves
WARM_GEOMETRIES = (("sha1", 256 << 10), ("sha256", 16 << 10))


class _BodyReader:
    """Incremental body reader: Content-Length or chunked transfer-encoding.

    Exposes ``read_upto(n)`` over the framed body and ``at_eof()`` once
    the body is fully consumed — never holds more than one read's worth
    of bytes beyond the StreamReader's own buffer.
    """

    def __init__(self, reader: asyncio.StreamReader, headers: dict[bytes, bytes]):
        self._r = reader
        te = headers.get(b"transfer-encoding", b"").lower()
        self._chunked = b"chunked" in te
        try:
            self._remaining = int(headers.get(b"content-length", b"0") or 0)
        except ValueError:
            self._remaining = 0
        self._chunk_left = 0  # bytes left in the current chunk (chunked mode)
        self._done = not self._chunked and self._remaining == 0

    async def _next_chunk(self) -> None:
        size_line = await self._r.readline()
        # tolerate the CRLF terminating the previous chunk
        while size_line in (b"\r\n", b"\n"):
            size_line = await self._r.readline()
        if size_line == b"":
            # connection cut mid-body: a truncated chunked stream must NOT
            # read as clean EOF (a 200 over partial frames would be taken
            # as a completed recheck)
            raise asyncio.IncompleteReadError(b"", None)
        size = int(size_line.split(b";", 1)[0].strip(), 16)
        if size == 0:
            # trailer section until blank line
            while True:
                line = await self._r.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
            self._done = True
        self._chunk_left = size

    async def read_upto(self, n: int) -> bytes:
        """Up to ``n`` body bytes; b"" at EOF."""
        if self._done:
            return b""
        if self._chunked:
            if self._chunk_left == 0:
                await self._next_chunk()
                if self._done:
                    return b""
            take = min(n, self._chunk_left)
            data = await self._r.readexactly(take)
            self._chunk_left -= take
            return data
        take = min(n, self._remaining)
        data = await self._r.readexactly(take)
        self._remaining -= take
        if self._remaining == 0:
            self._done = True
        return data

    async def at_eof(self) -> bool:
        if self._done:
            return True
        if self._chunked and self._chunk_left == 0:
            await self._next_chunk()
            return self._done
        return False


class BridgeServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        hasher: str = "gpu",
        device=None,
        batch_target: int = 256,
        flush_deadline_ms: float = 20.0,
        max_queue_mb: int = 256,
        tenant_max_mb: int = 128,
        fault_plan: FaultPlan | str | None = None,
        autopilot=None,
        slo=None,
        timeline_interval_s: float = 1.0,
        timeline_depth: int = 512,
        slo_short_samples: int | None = None,
        slo_long_samples: int | None = None,
    ):
        self.host = host
        self.port = port
        self.hasher = hasher
        # "gpu" hashes on `device` (None = the CUDA card; "cpu" = the
        # plain PyTorch planes the tests use); "cpu" is hashlib
        self.device = device
        self._server: asyncio.AbstractServer | None = None
        self.sched: HashPlaneScheduler | None = None
        # scheduler autopilot (sched/control.py): True = default
        # ControlConfig, a ControlConfig instance = custom knobs,
        # None/False = no controller (bit-identical static behavior)
        self._autopilot_cfg = autopilot
        self.autopilot = None
        # timeline + SLO plane (obs/timeline, obs/slo): armed only when
        # `slo` is set (an objective spec string, a tuple of
        # SloObjective, or True for the default spec) — a run with no
        # objectives configured constructs NONE of this, so behavior is
        # bit-identical to an engine-less build
        self._slo_cfg = slo
        self._timeline_interval_s = timeline_interval_s
        self._timeline_depth = timeline_depth
        self._slo_short_samples = slo_short_samples
        self._slo_long_samples = slo_long_samples
        self.timeline = None
        self.sampler = None
        self.slo_engine = None
        # /v1/info device count, probed off-loop in the background by
        # start(): a device query can block behind a wedged device and
        # must never run on the serving loop
        self._device_count = 0
        self._probe_task: asyncio.Task | None = None
        # one fabric job at a time: {"task", "executors" (the running
        # FabricExecutor appended by verify_library_fabric), "result",
        # "error", "torrents"} — /v1/fabric/* and /metrics read it
        self._fabric: dict | None = None
        # chaos harness: injected faults wrap the planes the scheduler
        # would build anyway (dev/test only — main() gates the CLI knob)
        if isinstance(fault_plan, str):
            fault_plan = FaultPlan.parse(fault_plan)
        self._sched_config = SchedulerConfig(
            batch_target=batch_target,
            flush_deadline=flush_deadline_ms / 1e3,
            max_queue_bytes=max_queue_mb << 20,
            max_tenant_bytes=tenant_max_mb << 20,
            plane_factory=(
                fault_plan.plane_factory(hasher=hasher, device=device)
                if fault_plan
                else None
            ),
        )

    async def start(self) -> "BridgeServer":
        # hasher="gpu" with no device is the card: the scheduler raises
        # here on a host without CUDA, before any socket opens
        self.sched = await HashPlaneScheduler(
            self._sched_config, hasher=self.hasher, device=self.device
        ).start()
        # first-use set-up out of the request path: on a card, the
        # kernel loads and the pinned staging slots of the two common
        # geometries (nothing to warm elsewhere)
        for algo, piece_length in WARM_GEOMETRIES:
            await self.sched.prewarm(algo, piece_length)
        if self._autopilot_cfg:
            from torrent_tpu_torch.sched.control import ControlConfig, SchedulerAutopilot

            cfg = (
                self._autopilot_cfg
                if isinstance(self._autopilot_cfg, ControlConfig)
                else ControlConfig()
            )
            self.autopilot = SchedulerAutopilot(self.sched, cfg).start()
        if self._slo_cfg:
            from torrent_tpu_torch.obs import slo as _slo
            from torrent_tpu_torch.obs.slo import DEFAULT_SLO_SPEC, SloEngine
            from torrent_tpu_torch.obs.timeline import Timeline, TimelineSampler

            objectives = (
                DEFAULT_SLO_SPEC if self._slo_cfg is True else self._slo_cfg
            )
            kwargs = {}
            if self._slo_short_samples is not None:
                kwargs["short_samples"] = self._slo_short_samples
            if self._slo_long_samples is not None:
                kwargs["long_samples"] = self._slo_long_samples
            self.slo_engine = _slo.arm(SloEngine(objectives, **kwargs))
            self.timeline = Timeline(depth=self._timeline_depth)
            self.sampler = TimelineSampler(
                self.timeline,
                interval_s=self._timeline_interval_s,
                scheduler=self.sched,
                sources={
                    "control": self._control_source,
                    "fleet": self._fleet_source,
                    "distrust": self._distrust_source,
                },
                on_sample=self.slo_engine.observe,
                # bound the per-capture copy to the evaluator's window
                on_sample_tail=self.slo_engine.long_samples,
            ).start()

        def _count_devices() -> int:
            # the grid the lanes hash on; hashlib's is the host itself
            return self.sched.mesh.size if self.sched.mesh is not None else 1

        async def _probe() -> None:
            try:
                self._device_count = await asyncio.to_thread(_count_devices)
            except Exception as e:  # /v1/info keeps reporting 0
                log.warning("device-count probe failed: %s", e)

        # fire-and-forget: the probe must neither run on the serving
        # loop NOR gate the listen socket — behind a wedged tunnel every
        # other route keeps serving and /v1/info reports 0 devices until
        # the probe resolves
        self._probe_task = asyncio.ensure_future(_probe())
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("bridge listening on %s:%d", self.host, self.port)
        return self

    def close(self) -> None:
        if self._server:
            self._server.close()

    async def wait_closed(self) -> None:
        if self._server:
            await self._server.wait_closed()
        if self._probe_task is not None and not self._probe_task.done():
            # cancel releases the coroutine; an in-flight device query
            # thread finishes on its own, harmlessly
            self._probe_task.cancel()
            try:
                await self._probe_task
            except (asyncio.CancelledError, Exception):
                pass
        if self._fabric is not None and self._fabric["task"] is not None and not self._fabric["task"].done():
            self._fabric["task"].cancel()
            try:
                await self._fabric["task"]
            except (asyncio.CancelledError, Exception):
                pass
        if self.sampler is not None:
            # off-thread join + final post-mortem dump; release the
            # process-global engine slot — but only if it is still OURS
            # (a later server may have armed its own engine since)
            await asyncio.to_thread(self.sampler.stop)
            from torrent_tpu_torch.obs import slo as _slo

            _slo.disarm(self.slo_engine)
        if self.autopilot is not None:
            await self.autopilot.close()
        if self.sched is not None:
            await self.sched.close()

    # ----------------------------------------------------- timeline sources
    # (run on the sampler THREAD; each is wrapped in a try by the
    # sampler, so a transient race with the serving loop costs one
    # sample field, never the sampler)

    def _control_source(self):
        if self.autopilot is None:
            return None
        last = self.autopilot._last or {}
        bn = (last.get("decision") or {}).get("bottleneck") or {}
        if not bn:
            return None
        return {"stage": bn.get("stage"), "confirmed": bn.get("confirmed")}

    def _fleet_source(self):
        if not (self._fabric and self._fabric["executors"]):
            return None
        bn = self._fabric["executors"][0].fleet_snapshot().get("bottleneck") or {}
        if not bn:
            return None
        return {"pid": bn.get("pid"), "stage": bn.get("stage")}

    def _distrust_source(self):
        if not (self._fabric and self._fabric["executors"]):
            return 0
        snap = self._fabric["executors"][0].metrics_snapshot()
        # every way the fabric loses trust in a verdict feeds the SLO
        # integrity objective: f = 0 sentinel rejections, Byzantine
        # audit mismatches, and receipt convictions
        return (
            snap.get("sentinel_mismatches", 0)
            + snap.get("audit_mismatches", 0)
            + snap.get("convictions", 0)
        )

    # ----------------------------------------------------------- streaming

    @staticmethod
    def _tenant_of(headers) -> str:
        return (headers or {}).get(b"x-tenant", b"default").decode("latin-1")[:64]

    async def _route_stream(self, writer, target: str, headers, body: _BodyReader):
        """Length-prefixed frame ingest through the scheduler.

        Frames are chunked into scheduler submissions sized to one device
        launch; the queue's admission budget bounds resident memory while
        launches overlap further ingest. A full queue *delays* the read
        loop (blocking submit) — backpressure reaches the client's TCP
        socket instead of buffering without bound.
        """
        mode = target.rsplit("/", 1)[-1]
        if mode not in ("digests", "verify"):
            return await self._reply(writer, 404, b"not found")
        try:
            plen = int(headers.get(b"x-piece-length", b"0") or 0)
        except ValueError:
            plen = 0
        if plen <= 0 or plen > MAX_PIECE:
            return await self._reply(writer, 400, b"X-Piece-Length required (1..16MiB)")
        algo = headers.get(b"x-hash-algo", b"sha1").decode("latin-1").lower()
        if algo not in ("sha1", "sha256"):
            return await self._reply(writer, 400, b"X-Hash-Algo must be sha1 or sha256")
        await self._stream_sched(writer, mode, plen, body, algo, self._tenant_of(headers))

    @staticmethod
    async def _read_idle_bounded(body: _BodyReader, n: int) -> bytes:
        """``readexactly(n)`` where the timeout bounds *idle* time, not
        total transfer time — each successful chunk resets the clock, so a
        slow-but-live client streaming a big piece is never dropped."""
        parts, got = [], 0
        while got < n:
            chunk = await asyncio.wait_for(
                body.read_upto(min(n - got, 1 << 18)), FRAME_TIMEOUT
            )
            if not chunk:
                raise asyncio.IncompleteReadError(b"".join(parts), n)
            parts.append(chunk)
            got += len(chunk)
        return b"".join(parts)

    async def _read_frame(
        self, body: _BodyReader, plen: int, with_expected: bool, digest_len: int = 20
    ):
        """One ``len | piece [| expected]`` frame, or None at clean EOF.

        Reads are idle-bounded so a silent client can't pin queue bytes
        forever. Raises ValueError on an oversized frame.
        """
        if await asyncio.wait_for(body.at_eof(), FRAME_TIMEOUT):
            return None
        ln = int.from_bytes(await self._read_idle_bounded(body, 4), "big")
        if ln > plen:
            raise ValueError("frame exceeds X-Piece-Length")
        data = await self._read_idle_bounded(body, ln)
        expected = (
            await self._read_idle_bounded(body, digest_len) if with_expected else None
        )
        return data, expected

    async def _stream_sched(
        self, writer, mode: str, plen: int, body: _BodyReader, algo: str, tenant: str
    ):
        dlen = 32 if algo == "sha256" else 20
        # plane-aware chunking: one submission is one lane flush. The
        # port's lanes are row-exact (no tile snapping), so this is the
        # batch target clamped to the staging budget
        chunk = self.sched.chunk_for(plen, algo)
        futs: list[tuple[asyncio.Future, int]] = []
        batch: list[bytes] = []
        batch_exp: list[bytes] = []
        batch_bytes = 0
        n_frames = 0

        async def flush():
            nonlocal batch, batch_exp, batch_bytes
            fut = await self.sched.enqueue(
                tenant,
                batch,
                expected=batch_exp if mode == "verify" else None,
                algo=algo,
                piece_length=plen,
                wait=True,  # streaming backpressure, not load-shed
            )
            futs.append((fut, len(batch)))
            batch, batch_exp, batch_bytes = [], [], 0

        try:
            while True:
                frame = await self._read_frame(body, plen, mode == "verify", digest_len=dlen)
                if frame is None:
                    break
                n_frames += 1
                if n_frames > MAX_STREAM_FRAMES:
                    return await self._reply(writer, 413, b"too many frames")
                data, exp = frame
                batch.append(data)
                batch_bytes += len(data)
                if exp is not None:
                    batch_exp.append(exp)
                # flush on byte budget too, not just piece count: the
                # pre-flush batch is per-CONNECTION memory the admission
                # budget can't see, so big-piece streams must hand bytes
                # to the scheduler (where wait=True bounds them) early —
                # N connections otherwise hold N × chunk × plen resident
                if len(batch) >= chunk or batch_bytes >= STREAM_FLUSH_BYTES:
                    await flush()
            if batch:
                await flush()
            digests: list[bytes] = []
            ok_flags = bytearray()
            failed = 0
            for fut, npieces in futs:
                # a per-frame hash failure (retry/bisection exhausted)
                # must not drop the whole connection: report the frames
                # as failed and keep streaming the rest of the response
                try:
                    res = await fut
                except SchedLaunchError as e:
                    log.warning("stream frames failed (%d pieces): %s", npieces, e)
                    failed += npieces
                    if mode == "digests":
                        digests.extend([b""] * npieces)
                    else:
                        ok_flags.extend(b"\x00" * npieces)
                    continue
                if mode == "digests":
                    digests.extend(res)
                else:
                    ok_flags.extend(res)
            if mode == "digests":
                payload = bencode({b"digests": digests, b"failed": failed})
            else:
                payload = bencode(
                    {b"ok": bytes(ok_flags), b"valid": sum(ok_flags), b"failed": failed}
                )
            await self._reply(writer, 200, payload)
        except ValueError as e:
            await self._reply(writer, 400, str(e).encode())
        except SchedRejected as e:
            await self._reply(writer, 429, str(e).encode())

    # --------------------------------------------------------------- http

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            request_line = (await asyncio.wait_for(reader.readline(), 60)).split()
            if len(request_line) < 2:
                return await self._reply(writer, 400, b"bad request")
            method, target = request_line[0].decode(), request_line[1].decode()
            headers: dict[bytes, bytes] = {}
            header_bytes = 0
            while True:
                line = await asyncio.wait_for(reader.readline(), 60)
                if line in (b"\r\n", b"\n", b""):
                    break
                header_bytes += len(line)
                if header_bytes > (16 << 10):  # endless header lines ≠ a request
                    return await self._reply(writer, 431, b"headers too large")
                if b":" in line:
                    k, v = line.split(b":", 1)
                    headers[k.strip().lower()] = v.strip()
            # trace ids are minted HERE (or honored from X-Trace-Id when
            # it is a well-formed token): every request runs inside a
            # root span, the scheduler threads it through the ticket
            # lifecycle, and _reply echoes it so the client can fetch
            # the span tree from GET /v1/trace?id=…
            raw_tid = headers.get(b"x-trace-id", b"").decode("latin-1").strip()
            trace_id = raw_tid if valid_trace_id(raw_tid) else tracer().mint()
            path = target.split("?")[0]
            route = path if path in _KNOWN_ROUTES else "other"
            t0 = time.monotonic()
            try:
                with tracer().span(
                    "bridge.request", trace_id=trace_id, method=method,
                    target=path, tenant=self._tenant_of(headers),
                ):
                    if method == "POST" and target.startswith("/v1/stream/"):
                        body_reader = _BodyReader(reader, headers)
                        return await self._route_stream(
                            writer, target, headers, body_reader
                        )
                    try:
                        content_length = int(headers.get(b"content-length", b"0") or 0)
                    except ValueError:
                        return await self._reply(writer, 400, b"bad content-length")
                    if content_length > MAX_BODY:
                        return await self._reply(writer, 413, b"body too large")
                    body = (
                        await reader.readexactly(content_length)
                        if content_length
                        else b""
                    )
                    await self._route(writer, method, target, body, headers)
            finally:
                histograms().get(*_H_REQUEST, route=route).observe(
                    time.monotonic() - t0
                )
        except (asyncio.TimeoutError, asyncio.IncompleteReadError, ConnectionError, OSError):
            writer.close()
        except Exception as e:  # one bad request must not kill the sidecar
            log.error("bridge error: %s", e)
            await self._reply(writer, 500, str(e).encode())

    async def _route(self, writer, method: str, target: str, body: bytes, headers=None):
        if method == "GET" and target == "/v1/info":
            payload = bencode(
                {
                    b"backend": self.hasher.encode(),
                    # probed off-loop in start() — never on the serving loop
                    b"devices": self._device_count,
                    b"batch": self.sched.config.batch_target,
                    # chosen by the scheduler's device alone: 'cuda' on
                    # a card, 'torch' on device="cpu"
                    b"sha256_backend": (
                        b"cpu"
                        if self.hasher == "cpu"
                        else self.sched.sha256_backend().encode()
                    ),
                    b"version": b"torrent-tpu/0.1",
                }
            )
            return await self._reply(writer, 200, payload)
        if method == "GET" and target.split("?")[0] == "/metrics":
            from torrent_tpu_torch.utils.metrics import (
                render_fabric_metrics,
                render_sched_metrics,
            )

            text = render_sched_metrics(self.sched)
            if self._fabric and self._fabric["executors"]:
                from torrent_tpu_torch.utils.metrics import render_fleet_metrics

                ex = self._fabric["executors"][0]
                text += render_fabric_metrics(ex.metrics_snapshot())
                # the swarm-wide view: this process's fleet rollup from
                # its own + heartbeat-carried peer digests
                text += render_fleet_metrics(ex.fleet_snapshot())
            if self.autopilot is not None:
                from torrent_tpu_torch.utils.metrics import render_control_metrics

                text += render_control_metrics(self.autopilot.metrics_snapshot())
            if self.timeline is not None:
                from torrent_tpu_torch.utils.metrics import (
                    render_slo_metrics,
                    render_timeline_metrics,
                )

                # stats(), not snapshot(): a scrape must not copy the
                # whole ring just to report its counters
                tl = self.timeline.stats()
                tl["sampler_alive"] = (
                    self.sampler.alive if self.sampler is not None else False
                )
                text += render_timeline_metrics(tl)
                text += render_slo_metrics(
                    self.slo_engine.report() if self.slo_engine else None
                )
            text += render_obs_metrics()
            from torrent_tpu_torch.analysis import sanitizer

            if sanitizer.is_enabled():
                from torrent_tpu_torch.utils.metrics import render_tsan_metrics

                text += render_tsan_metrics(sanitizer.snapshot())
            # the Prometheus exposition format has its own content type;
            # collectors (and promtool) reject octet-stream
            return await self._reply(
                writer, 200, text.encode(),
                content_type="text/plain; version=0.0.4; charset=utf-8",
            )
        if method == "GET" and target.split("?")[0] == "/v1/trace":
            return await self._trace_route(writer, target)
        if method == "GET" and target.split("?")[0] == "/v1/pipeline":
            return await self._pipeline_route(writer)
        if method == "GET" and target.split("?")[0] == "/v1/fleet":
            return await self._fleet_route(writer)
        if method == "GET" and target.split("?")[0] == "/v1/control":
            return await self._control_route(writer)
        if method == "GET" and target.split("?")[0] == "/v1/timeline":
            return await self._timeline_route(writer)
        if method == "GET" and target.split("?")[0] == "/v1/slo":
            return await self._slo_route(writer)
        if method == "GET" and target.split("?")[0] == "/v1/health":
            return await self._health_route(writer)
        if method == "GET" and target.split("?")[0] == "/v1/swarm":
            return await self._swarm_route(writer)
        if method == "GET" and target == "/v1/fabric/status":
            return await self._reply(writer, 200, bencode(self._fabric_status()))
        if method != "POST":
            return await self._reply(writer, 405, b"method not allowed")
        if target == "/v1/fabric/verify":
            return await self._fabric_verify(writer, body)
        # the buffered hash routes are sha1-only; a sha256 request must
        # fail closed, not silently return v1 digests with a 200 (the
        # algorithm-agnostic /v1/info above is exempt)
        algo = (headers or {}).get(b"x-hash-algo", b"sha1").decode("latin-1").lower()
        if algo != "sha1":
            return await self._reply(
                writer, 400, b"buffered routes are sha1-only; use /v1/stream/* for sha256"
            )
        try:
            req = bdecode(body)
        except BencodeError as e:
            return await self._reply(writer, 400, f"bad bencode: {e}".encode())
        if not isinstance(req, dict) or not isinstance(req.get(b"pieces"), list):
            return await self._reply(writer, 400, b"missing pieces list")
        pieces = req[b"pieces"]
        if not all(isinstance(p, bytes) for p in pieces):
            return await self._reply(writer, 400, b"pieces must be bytestrings")
        if any(len(p) > MAX_PIECE for p in pieces):
            # same cap as the stream routes: an oversized piece would open
            # (and cache) a scheduler lane far beyond the staging budget
            return await self._reply(writer, 413, b"piece exceeds 16MiB cap")
        tenant = self._tenant_of(headers)

        if target == "/v1/digests":
            try:
                digests = await self.sched.submit(tenant, pieces, algo="sha1")
            except SchedRejected as e:
                return await self._reply(writer, 429, str(e).encode())
            except SchedLaunchError as e:
                return await self._reply_launch_failed(writer, e)
            return await self._reply(writer, 200, bencode({b"digests": digests}))
        if target == "/v1/verify":
            expected = req.get(b"expected")
            if (
                not isinstance(expected, list)
                or len(expected) != len(pieces)
                or not all(isinstance(e, bytes) and len(e) == 20 for e in expected)
            ):
                return await self._reply(writer, 400, b"expected must be 20-byte hashes")
            try:
                ok = await self.sched.submit(
                    tenant, pieces, expected=expected, algo="sha1"
                )
            except SchedRejected as e:
                return await self._reply(writer, 429, str(e).encode())
            except SchedLaunchError as e:
                return await self._reply_launch_failed(writer, e)
            return await self._reply(writer, 200, bencode({b"ok": ok}))
        await self._reply(writer, 404, b"not found")

    # ------------------------------------------------------------- fabric

    async def _fabric_verify(self, writer, body: bytes):
        """Start a scheduler-fed library recheck of local torrents.

        Body (bencode): ``{items: [{torrent: PATH, root: PATH}, ...],
        unit_mb?: int}`` — paths are local to the sidecar host, the same
        trust model as the CLI (the bridge binds loopback by default).
        Replies 202 immediately; poll ``GET /v1/fabric/status``. One job
        at a time: a second POST while one runs gets 409.
        """
        from torrent_tpu_torch.codec.metainfo import parse_metainfo
        from torrent_tpu_torch.storage.storage import FsStorage, Storage

        if self._fabric is not None and (
            self._fabric["task"] is None or not self._fabric["task"].done()
        ):
            return await self._reply(writer, 409, b"fabric verify already running")
        try:
            req = bdecode(body)
        except BencodeError as e:
            return await self._reply(writer, 400, f"bad bencode: {e}".encode())
        specs = req.get(b"items") if isinstance(req, dict) else None
        if not isinstance(specs, list) or not specs:
            return await self._reply(writer, 400, b"missing items list")
        for spec in specs:
            if not isinstance(spec, dict) or not isinstance(
                spec.get(b"torrent"), bytes
            ):
                return await self._reply(
                    writer, 400, b"each item needs torrent and root paths"
                )

        # claim the job slot BEFORE the first await: a concurrent POST
        # suspended in load_items must hit the 409 above, not race two
        # sweeps into one record (task=None means "starting" = busy)
        job = self._fabric = {
            "executors": [],
            "result": None,
            "error": None,
            "torrents": len(specs),
            "task": None,
        }

        def load_items():
            # disk reads + parses off the event loop: a long manifest on
            # slow storage must not stall concurrent hash requests
            out = []
            for spec in specs:
                tpath = spec[b"torrent"].decode("utf-8", "surrogateescape")
                root = spec.get(b"root", b".").decode("utf-8", "surrogateescape")
                try:
                    with open(tpath, "rb") as f:
                        meta = parse_metainfo(f.read())
                except OSError as e:
                    raise ValueError(f"cannot read {tpath}: {e}") from e
                if meta is None:
                    raise ValueError(f"not a v1 .torrent: {tpath}")
                out.append((Storage(FsStorage(root), meta.info), meta.info))
            return out

        try:
            items = await asyncio.to_thread(load_items)
        except ValueError as e:
            self._fabric = None  # release the claim: nothing ran
            return await self._reply(writer, 400, str(e).encode())
        unit_mb = req.get(b"unit_mb")
        unit_bytes = (unit_mb << 20) if isinstance(unit_mb, int) and unit_mb > 0 else None
        job["task"] = asyncio.ensure_future(
            self._run_fabric(job, items, unit_bytes)
        )
        total = sum(info.num_pieces for _, info in items)
        return await self._reply(
            writer,
            202,
            bencode({b"state": b"started", b"torrents": len(items), b"pieces": total}),
        )

    async def _run_fabric(self, job: dict, items, unit_bytes) -> None:
        from torrent_tpu_torch.parallel.bulk import verify_library_fabric

        try:
            res = await verify_library_fabric(
                items,
                self.sched,
                unit_bytes=unit_bytes,
                executor_out=job["executors"],
            )
        except Exception as e:  # surfaced via /v1/fabric/status
            log.error("fabric verify failed: %s", e)
            job["error"] = str(e)
            return
        job["result"] = {
            b"valid": sum(int(bf.sum()) for bf in res.bitfields),
            b"pieces": res.n_pieces,
            b"per_torrent": [int(bf.sum()) for bf in res.bitfields],
            b"millis": int(res.seconds * 1000),
        }

    def _fabric_status(self) -> dict:
        job = self._fabric
        if job is None:
            return {b"state": b"idle"}
        out: dict = {b"torrents": job["torrents"]}
        if job["error"] is not None:
            out[b"state"] = b"failed"
            out[b"error"] = job["error"].encode()
        elif job["result"] is not None:
            out[b"state"] = b"done"
            out[b"result"] = job["result"]
        else:
            out[b"state"] = b"running"
        if job["executors"]:
            s = job["executors"][0].metrics_snapshot()
            out[b"fabric"] = {
                b"pid": s["pid"],
                b"nproc": s["nproc"],
                b"plan": s["plan_fingerprint"].encode(),
                b"shard_units": s["shard_units"],
                b"shard_bytes": s["shard_bytes"],
                b"units_done": s["units_done"],
                b"units_adopted": s["units_adopted"],
                b"pieces_verified": s["pieces_verified"],
                b"sentinel_checks": s["sentinel_checks"],
                b"sentinel_mismatches": s["sentinel_mismatches"],
                b"byzantine_f": s.get("byzantine_f", 0),
                b"quorum_need": s.get("quorum_need", 1),
                b"audit_checks": s.get("audit_checks", 0),
                b"audit_mismatches": s.get("audit_mismatches", 0),
                b"convictions": s.get("convictions", 0),
                b"stragglers": s["stragglers"],
                b"heartbeat_age_ms": int(s["heartbeat_age"] * 1000),
                b"degraded": int(s["degraded"]),
            }
        return out

    async def _pipeline_route(self, writer):
        """``GET /v1/pipeline`` — the bottleneck attribution surface.

        Returns the pipeline ledger's since-start per-stage snapshot,
        the attributor's verdict (limiting stage, achieved vs demanded
        rate), and a small scheduler summary so ``torrent-tpu top`` can
        render queue depth next to stage utilization. JSON with sorted
        keys, same operator-surface conventions as ``/v1/trace``; pure
        in-memory reads, safe on the serving loop."""
        from torrent_tpu_torch.obs.attrib import attribute
        from torrent_tpu_torch.obs.ledger import pipeline_ledger

        snap = pipeline_ledger().snapshot()
        sched_snap = self.sched.metrics_snapshot() if self.sched else {}
        body = json.dumps(
            {
                "attribution": attribute(snap),
                "snapshot": snap,
                # autopilot view for `torrent-tpu top`'s decision line
                # (null when no controller is attached)
                "control": (
                    self.autopilot.status() if self.autopilot is not None else None
                ),
                "sched": {
                    "queue_pieces": sched_snap.get("queue_pieces", 0),
                    "queue_bytes": sched_snap.get("queue_bytes", 0),
                    "launches": sched_snap.get("launches", 0),
                    "mean_fill": sched_snap.get("mean_fill", 0.0),
                    "lanes": sched_snap.get("lanes", 0),
                    "cpu_fallback_launches": sched_snap.get(
                        "cpu_fallback_launches", 0
                    ),
                },
            },
            sort_keys=True,
        ).encode()
        return await self._reply(
            writer, 200, body, content_type="application/json"
        )

    async def _fleet_route(self, writer):
        """``GET /v1/fleet`` — this process's view of the fleet.

        While a fabric job runs (or after it finished) the rollup comes
        from the executor: own obs digest + every peer's heartbeat-
        carried digest, two-level bottleneck attribution, straggler
        scoreboard. With no fabric job it degrades to a fleet-of-one
        built from local obs state, so the route (and ``top --fleet``)
        always answers. JSON with sorted keys; pure in-memory reads,
        safe on the serving loop."""
        from torrent_tpu_torch.obs.fleet import local_fleet_snapshot

        if self._fabric and self._fabric["executors"]:
            roll = self._fabric["executors"][0].fleet_snapshot()
        else:
            roll = local_fleet_snapshot(self.sched)
        body = json.dumps(roll, sort_keys=True).encode()
        return await self._reply(
            writer, 200, body, content_type="application/json"
        )

    async def _control_route(self, writer):
        """``GET /v1/control`` — the scheduler autopilot's surface.

        Last decision (bottleneck verdict + actions), the applied
        actuator moves, the inputs the decision saw, and every
        actuator's current value. Always answers: with no autopilot
        attached it reports ``attached: false`` so operators can tell
        "controller off" from "bridge down". JSON with sorted keys;
        pure in-memory reads, safe on the serving loop."""
        if self.autopilot is None:
            payload: dict = {"attached": False, "enabled": False, "decision": None}
        else:
            payload = {"attached": True, **self.autopilot.status()}
        body = json.dumps(payload, sort_keys=True).encode()
        return await self._reply(
            writer, 200, body, content_type="application/json"
        )

    async def _timeline_route(self, writer):
        """``GET /v1/timeline`` — the obs plane's history surface.

        The bounded sample ring (attached: false when no timeline is
        armed), dumpable/replayable via ``torrent-tpu replay``. JSON
        with sorted keys; pure in-memory reads, safe on the serving
        loop."""
        if self.timeline is None:
            payload: dict = {"attached": False, "samples": [], "drops": 0}
        else:
            payload = {"attached": True, **self.timeline.snapshot()}
            payload["sampler_alive"] = (
                self.sampler.alive if self.sampler is not None else False
            )
        body = json.dumps(payload, sort_keys=True).encode()
        return await self._reply(
            writer, 200, body, content_type="application/json"
        )

    async def _slo_route(self, writer):
        """``GET /v1/slo`` — declared objectives, burn rates, budget.

        The engine's last evaluation report (attached: false when no
        objectives are configured — operators can tell "SLO off" from
        "bridge down"). JSON with sorted keys; pure in-memory reads."""
        if self.slo_engine is None:
            payload: dict = {"attached": False, "report": None}
        else:
            payload = {
                "attached": True,
                "objectives": [
                    {"name": o.name, "kind": o.kind, "target": o.target,
                     "family": o.family}
                    for o in self.slo_engine.objectives
                ],
                "report": self.slo_engine.report(),
                "breach_dumps": self.slo_engine.metrics_snapshot()[
                    "breach_dumps"
                ],
            }
        body = json.dumps(payload, sort_keys=True).encode()
        return await self._reply(
            writer, 200, body, content_type="application/json"
        )

    async def _health_route(self, writer):
        """``GET /v1/health`` — liveness + readiness for a real load
        balancer. Always answers (liveness IS the reply); HTTP 200 only
        when READY — the backend probe resolved, no lane breaker stuck
        open past its cooldown, the sampler (when armed) alive, and no
        SLO objective in breach (breach = ``degraded``: live, but
        leave the rotation while the budget burns)."""
        from torrent_tpu_torch.obs.slo import build_health

        probe_ok = self._probe_task is None or self._probe_task.done()
        breakers = (
            self.sched.metrics_snapshot().get("breakers", {})
            if self.sched is not None
            else {}
        )
        health = build_health(
            probe_ok=probe_ok,
            breakers=breakers,
            sampler_alive=(
                self.sampler.alive if self.sampler is not None else None
            ),
            slo_report=(
                self.slo_engine.report() if self.slo_engine is not None else None
            ),
        )
        body = json.dumps(health, sort_keys=True).encode()
        return await self._reply(
            writer, 200 if health["ready"] else 503, body,
            content_type="application/json",
        )

    async def _swarm_route(self, writer):
        """``GET /v1/swarm`` — the swarm wire plane's telemetry surface.

        The process-global :mod:`obs/swarm` registry's bounded snapshot:
        top-K peers + overflow fold, choke timelines, block-RTT
        summaries, announce health, flight-trigger counters. Always
        answers (an idle hash-plane sidecar reports zero peers). JSON
        with sorted keys; pure in-memory reads, safe on the serving
        loop."""
        from torrent_tpu_torch.obs.swarm import swarm_telemetry
        from torrent_tpu_torch.serve_plane.telemetry import serve_telemetry

        payload = swarm_telemetry().snapshot()
        serve_obs = serve_telemetry()
        if serve_obs.active():
            # serving-side entries ride along once this process has
            # actually served (same additive rule as /metrics)
            payload["serve"] = serve_obs.snapshot()
        body = json.dumps(payload, sort_keys=True).encode()
        return await self._reply(
            writer, 200, body, content_type="application/json"
        )

    async def _trace_route(self, writer, target: str):
        """``GET /v1/trace`` — the obs plane's query surface.

        ``?id=<trace>`` returns that trace's ordered span tree (the
        ticket lifecycle a client tagged with ``X-Trace-Id``); without
        an id it returns the flight recorder's black-box dumps plus the
        known trace ids. JSON (sorted keys), not bencode: this is an
        operator/debugging surface, not a data-plane wire format.
        """
        params: dict[str, str] = {}
        for part in target.partition("?")[2].split("&"):
            if "=" in part:
                k, _, v = part.partition("=")
                params[k] = v
        tid = params.get("id")
        if tid:
            tree = tracer().trace_tree(tid)
            if tree is None:
                return await self._reply(
                    writer, 404, b'{"error": "unknown trace id"}',
                    content_type="application/json",
                )
            body = json.dumps(tree, sort_keys=True).encode()
        else:
            rec = flight_recorder()
            body = json.dumps(
                {
                    "dump_counts": rec.counts(),
                    "dumps": rec.dumps(),
                    "traces": tracer().trace_ids(),
                },
                sort_keys=True,
            ).encode()
        return await self._reply(
            writer, 200, body, content_type="application/json"
        )

    async def _reply_launch_failed(self, writer, e: SchedLaunchError):
        # transient retry-exhausted failure: 503 + Retry-After (shed is
        # 429 — different remedy). A deterministic (payload-caused)
        # failure must NOT advertise Retry-After: resubmitting the same
        # payload re-runs the whole retry+bisection cascade forever — 500
        # tells the client the request itself is the problem.
        if e.kind == "transient":
            return await self._reply(
                writer, 503, str(e).encode(), headers={"Retry-After": "1"}
            )
        return await self._reply(writer, 500, str(e).encode())

    async def _reply(
        self,
        writer,
        status: int,
        body: bytes,
        headers=None,
        content_type: str = "application/octet-stream",
    ):
        try:
            head = (
                f"HTTP/1.1 {status} X\r\nContent-Type: {content_type}\r\n"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n"
            )
            # every traced request echoes its trace id, honored or
            # minted, so the client can fetch GET /v1/trace?id=…
            ctx = tracer().current_context()
            if ctx is not None:
                head += f"X-Trace-Id: {ctx[0]}\r\n"
            for k, v in (headers or {}).items():
                head += f"{k}: {v}\r\n"
            head += "\r\n"
            writer.write(head.encode("latin-1") + body)
            await writer.drain()
        except (ConnectionError, OSError):
            pass
        finally:
            writer.close()


async def serve_bridge(
    host: str = "127.0.0.1", port: int = 8421, hasher: str = "gpu", **sched_kwargs
) -> BridgeServer:
    return await BridgeServer(host, port, hasher, **sched_kwargs).start()
