"""Continuous-batching scheduler for the hash plane — the multi-tenant
verify queue that turns a fast single-caller plane into a servable one.

Every entry point used to dispatch its own device batches in isolation
(bridge routes, parallel/verify.py, parallel/bulk.py, session
rechecks), so concurrent small callers each paid a fixed launch cost
on mostly-empty launches (batch fill is the dominant throughput knob).
This subsystem owns all dispatch instead:

    submit ──► admission control ──► per-tenant queues ──► DRR
               (bounded bytes,        (one deque per       assembler
                shed = typed 429)      tenant per lane)       │
                                                              ▼
    awaiting callers ◄── per-launch demux ◄── device launch (full batch
                         (futures resolve      OR deadline flush, so a
                          per submission)      lone 4-piece request is
                                               never stranded)

Work items are grouped into **lanes** keyed ``(algo, piece-length
bucket)`` — the same pow-2 bucketing the bridge used, so a handful of
compiled executables serve any geometry and the compile cache survives
across callers. Each lane runs one assembler task: it flushes a launch
when the batch fills to the lane target **or** when the oldest queued
item's deadline expires (flush reasons: full / deadline / shutdown).

Fairness is deficit round-robin over queued *bytes*: each tenant's
deficit grows by ``drr_quantum × weight`` per assembly pass, so a greedy
bulk tenant cannot starve a trickle CLI verify, and low-priority tenants
(session self-heal rechecks, ``weight < 1``) yield to foreground
traffic without ever being starved.

Admission control bounds queue memory globally and per tenant. A
non-blocking submit over the bound sheds with :class:`SchedRejected`
(the bridge maps it to HTTP 429); a blocking submit waits for space —
that wait is the backpressure a streaming ingest propagates to its TCP
socket. Queue depth, batch-fill ratio, flush reasons, per-tenant served
bytes, and shed counts are exported via ``utils/metrics.py``
(``render_sched_metrics``). The obs plane (``obs/``) rides
the same lifecycle: always-on log2 latency histograms (queue wait,
launch, per-tenant end-to-end) feed ``/metrics`` as real Prometheus
histograms, traced submissions get per-stage spans (enqueue →
admission/shed → lane wait → launch/retry/bisect → digest → verdict),
the flight recorder dumps a black box on breaker-open and
retry-exhausted failures, and device launches are annotated in the
deep-dive profiler timeline via ``obs/profiler.py``. The pipeline
ledger (``obs/ledger.py``) additionally accounts byte/time/occupancy
at every stage boundary — staging-slot copies, device puts (h2d),
launches, D2H fetches, and the verdict demux — feeding the bottleneck
attributor behind ``GET /v1/pipeline`` and ``doctor --bottleneck``.

Failure domains. A launch exception must not fail every co-batched
ticket across all tenants, so dispatch is fault-isolated in two layers:

* **Retry + bisection** (:meth:`HashPlaneScheduler._dispatch`): a
  failed launch is retried once if the error classifies as *transient*
  (device hiccups: on a GPU any ``RuntimeError``, which covers a CUDA
  launch error, an out-of-memory error and a sticky illegal-address
  error — retrying a *deterministic* payload error is
  pointless and skipped), then split in half and each half relaunched,
  recursively to ``bisect_depth``. A single poisoned ticket therefore
  fails alone — its submitter's future gets a classified
  :class:`SchedLaunchError` — while every innocent co-batched ticket
  still receives its digest.
* **Per-lane circuit breaker** (:class:`_LaneBreaker`): consecutive
  transient failures of a lane's primary plane open the lane's breaker.
  On a scheduler that runs on a CUDA card, an open breaker fails the
  launches it refuses with a transient :class:`SchedLaunchError`: the
  work never leaves the card's kernels behind the caller's back. On a
  ``hasher="cpu"`` or ``device="cpu"`` scheduler the lane degrades to
  the hashlib :class:`_CpuPlane` instead (correct but slower, as the
  reference does). After ``breaker_cooldown`` a half-open probe sends
  one launch back to the primary plane; success re-closes the breaker.
  Breaker state and transitions are exported in ``metrics_snapshot()``.

Both layers are driven deterministically in tests by
``sched/faults.py`` (a :class:`FaultPlan` wired through the
``plane_factory`` seam), so every behavior above has a CPU-only test.

Zero-copy ingest. Scheduler-fed read loops check a :class:`StagedSlab`
out of the per-(algo, bucket) ingest pools (:meth:`checkout_staging`),
land disk reads directly in its row-strided view, and submit it with
:meth:`enqueue_staged`: tickets carry :class:`SlotRow` views (no
per-piece ``bytes``), single-slab launches hit the planes'
``run_staged`` form (the slab IS the launch buffer — the ledger's
``stage`` copy stage records zero bytes). Slabs are reference counted
(one ref per ticket, released at demux on every path) and the pools'
``outstanding`` gauge must return to 0.

On a GPU the staging slots are pinned host memory, and the planes order
every reuse on the stream instead of donating buffers (which torch has
no counterpart for): the host→device copy runs ``non_blocking`` on a
per-plane copy stream, the kernel's stream waits on the copy's event,
a device tensor made on one stream and read on another is
``record_stream``-ed, and a slot is checked in (a slab released) only
after its copy event has completed — ``_StagingSlots.checkin`` checks
it. The device lock is held only while the kernel is enqueued, so batch
N+1's copy (the other pipelined worker) overlaps batch N's kernel. The
ledger's ``h2d`` span closes on the copy's event, ``launch`` on the
kernel's completion event, and ``digest`` covers only the device→host
copy of the digest words. The card's own busy time is read from a
``torch.profiler`` trace (``obs/profiler.py``), not from these spans.

The scheduler autopilot (``sched/control.py``) closes the observe→act
loop over these sensors: a periodic controller turns ledger/attribution
snapshot deltas into bounded actuator moves through the seams below —
``set_lane_target`` / ``set_lane_deadline`` (adaptive batching, snapped
via the planes' ``launch_geometry`` hooks), ``set_admission_factor``
(admit no faster than the limiting stage drains), and
``steer_lane_backend`` (hysteresis-guarded backend trials: a lane of a
``device="cpu"`` scheduler may trial hashlib; a card's lanes have no
alternative). With no
autopilot attached every seam stays at its static default and behavior
is bit-identical to the config.

The v2 (sha256) lanes run one plane, :class:`_Sha256CudaPlane`, over
``ops/sha256_cuda.sha256_pieces_cuda``: the hand-written Hopper kernel
on a GPU, the plain PyTorch version when the caller asked for
``device="cpu"``. The kernel takes any row count, so its launches are
row-exact like the SHA-1 plane's: no tile snapping, no sentinel pad
rows, no budget-forced fallback. Admission control charges the padded
staging footprint per queued piece rather than raw payload bytes.
"""

from __future__ import annotations

import asyncio
import hashlib
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

from torrent_tpu_torch.utils.locks import guard_attrs, named_lock
from torrent_tpu_torch.obs.hist import histograms
from torrent_tpu_torch.obs.ledger import pipeline_ledger
from torrent_tpu_torch.obs.recorder import flight_recorder
from torrent_tpu_torch.obs.tracer import tracer
from torrent_tpu_torch.utils.log import get_logger

log = get_logger("sched")

DIGEST_LEN = {"sha1": 20, "sha256": 32}

# latency-histogram families (obs/hist.py): always-on per-stage
# distributions rendered as Prometheus histograms on every scrape
_H_QUEUE_WAIT = (
    "torrent_tpu_sched_queue_wait_seconds",
    "Seconds tickets waited in lane queues before launch assembly",
)
_H_LAUNCH = (
    "torrent_tpu_sched_launch_seconds",
    "Hash-plane launch duration per attempt (staging + device run)",
)
_H_E2E = (
    "torrent_tpu_sched_e2e_seconds",
    "Ticket enqueue-to-verdict seconds, labeled by tenant",
)


class SchedRejected(Exception):
    """Typed admission-control rejection (load shed).

    Carries enough structure for callers to surface a useful 429: the
    reason, the tenant, and the observed/limit byte figures.
    """

    def __init__(self, reason: str, tenant: str, queued_bytes: int = 0, limit_bytes: int = 0):
        super().__init__(
            f"{reason} (tenant={tenant} queued={queued_bytes}B limit={limit_bytes}B)"
        )
        self.reason = reason
        self.tenant = tenant
        self.queued_bytes = queued_bytes
        self.limit_bytes = limit_bytes


class SchedLaunchError(Exception):
    """A submission's pieces could not be hashed after retry/bisection.

    ``kind`` classifies the root cause: ``"transient"`` (device
    error that outlived the retry budget — the caller may retry later;
    the bridge maps this to 503 + Retry-After) or ``"deterministic"``
    (the payload itself makes the plane fail — retrying cannot help).
    """

    def __init__(self, message: str, kind: str, cause: Exception | None = None):
        super().__init__(message)
        self.kind = kind
        self.cause = cause
        self.__cause__ = cause


def classify_error(e: BaseException) -> str:
    """``'deterministic'`` (payload-caused, retry is pointless) or
    ``'transient'`` (device-plane hiccup, worth one retry).

    Fault-injection errors self-classify via ``sched_error_class``;
    otherwise value/shape errors are deterministic and everything else
    (CUDA ``RuntimeError``s — a launch error, out of memory, a sticky
    illegal address — OSError, …) is assumed transient.
    """
    kind = getattr(e, "sched_error_class", None)
    if kind in ("deterministic", "transient"):
        return kind
    if isinstance(e, (ValueError, TypeError, KeyError, IndexError, AssertionError)):
        return "deterministic"
    return "transient"


@dataclass
class SchedulerConfig:
    # pieces per device launch the assembler aims to fill (per-lane
    # targets shrink for big-piece buckets so staging stays bounded)
    batch_target: int = 256
    # seconds the oldest queued item may wait before a partial flush
    flush_deadline: float = 0.02
    # global admission bound: queued + in-flight payload bytes
    max_queue_bytes: int = 256 << 20
    # per-tenant admission bound (a single tenant can't fill the queue)
    max_tenant_bytes: int = 128 << 20
    # DRR byte quantum added to each tenant's deficit per assembly pass
    drr_quantum: int = 1 << 20
    # per-lane staging budget: device batch ≈ budget / padded_len, like
    # the bridge's old staging rule, so a 16 MiB bucket can't OOM
    staging_budget: int = 128 << 20
    # launches allowed in flight per lane: 2 = double-buffer (the next
    # batch assembles and stages while the previous one runs on device,
    # matching the old stream gate's pending depth); 1 = strictly serial
    pipeline_depth: int = 2
    # auto-registered tenants beyond this bound are evicted once idle
    # (explicitly registered tenants are pinned) — bounds the state an
    # attacker can create with fresh X-Tenant values per request
    max_idle_tenants: int = 1024
    # test/extension hook: (algo, bucket, batch) -> plane with
    # .run(payloads) -> list[digest]; None = built-in planes. Code, not
    # state: compat.scheduler_config_from_reference refuses to carry it
    plane_factory: Callable | None = None
    # relaunches of a failed batch before bisection, transient errors
    # only (a deterministic payload error skips straight to bisection)
    launch_retries: int = 1
    # max split-and-relaunch recursion isolating a poisoned ticket: a
    # depth of 12 isolates one piece out of a 4096-piece launch; past
    # the bound the surviving group fails together
    bisect_depth: int = 12
    # consecutive transient failures of a lane's primary plane before
    # its breaker opens (a card's lane then fails launches until the
    # half-open probe; a device="cpu" or hashlib lane degrades to hashlib)
    breaker_threshold: int = 3
    # seconds an open breaker waits before a half-open probe re-admits
    # the primary plane
    breaker_cooldown: float = 30.0


def resolve_sha256_backend(device=None) -> str:
    """``'cuda'`` or ``'torch'``: the sha256 plane of a scheduler on
    ``device`` (None means the GPU, and a host without one raises).

    The device decides, with no knob: the CUDA kernel on a GPU, the
    plain PyTorch version on ``device="cpu"``, so the plain version is
    never chosen on a card behind the caller's back. (The reference
    chooses between its pallas kernel and its lax.scan program here; the
    port has one kernel a device.)
    """
    from torrent_tpu_torch.utils.device import resolve_device

    return "cuda" if resolve_device(device).type == "cuda" else "torch"


class _BreakerOpen(RuntimeError):
    """A card lane's open breaker refused a launch. The scheduler fails
    the launch's tickets with a transient :class:`SchedLaunchError` at
    once (no retry, no bisection: every relaunch would be refused too)."""


class _Tenant:
    __slots__ = (
        "name", "weight", "max_bytes", "queued_bytes", "served_bytes",
        "served_pieces", "shed", "deficit", "pinned",
    )

    def __init__(self, name: str, weight: float = 1.0, max_bytes: int | None = None):
        self.name = name
        self.weight = weight
        self.max_bytes = max_bytes
        self.queued_bytes = 0
        self.served_bytes = 0
        self.served_pieces = 0
        self.shed = 0
        self.deficit = 0
        self.pinned = False  # register_tenant pins; auto-registered may be evicted


class _Submission:
    """One caller request of N pieces; resolves when all N demuxed.

    ``trace`` is the obs span context — ``(trace_id, parent_span_id)``
    captured at enqueue when the caller ran inside a span (bridge
    requests always do) — carried explicitly because lane assembler
    tasks and worker threads never inherit a request's contextvars.
    """

    __slots__ = ("mode", "results", "remaining", "future", "trace", "traced_done")

    def __init__(self, n: int, mode: str, loop: asyncio.AbstractEventLoop):
        self.mode = mode  # 'digest' | 'verify'
        self.results: list = [None] * n
        self.remaining = n
        self.future: asyncio.Future = loop.create_future()
        self.trace: tuple[str, str] | None = None
        # terminal digest/verdict spans recorded (a submission split
        # across launches whose halves fail separately must not get one
        # span per failing demux)
        self.traced_done = False

    def deliver(self, idx: int, value) -> None:
        self.results[idx] = value
        self.remaining -= 1
        if self.remaining == 0 and not self.future.done():
            if self.mode == "verify":
                self.future.set_result(bytes(self.results))
            else:
                self.future.set_result(self.results)


class _Ticket:
    """One piece in the queue: (submission, index, payload, expected).

    ``nbytes`` is the true payload size (DRR fairness, served-bytes
    accounting); ``charged`` is what admission control holds for this
    row — the padded staging footprint on device lanes, so the queue
    bound tracks what the launch actually stages, not the raw bytes.
    """

    __slots__ = ("sub", "idx", "payload", "expected", "tenant", "nbytes",
                 "charged", "ts")

    def __init__(self, sub, idx, payload, expected, tenant, ts, charged=None):
        self.sub = sub
        self.idx = idx
        self.payload = payload
        self.expected = expected
        self.tenant = tenant
        self.nbytes = len(payload)
        self.charged = self.nbytes if charged is None else charged
        self.ts = ts


class _Lane:
    """Assembler state for one (algo, piece-length bucket) geometry."""

    __slots__ = (
        "algo", "bucket", "target", "queues", "rotation", "pending_pieces",
        "event", "task", "plane", "build_lock", "sem", "inflight",
        "breaker", "cpu_plane", "backend", "deadline",
        "launches", "fill_sum", "pad_rows_total",
    )

    def __init__(
        self,
        algo: str,
        bucket: int,
        target: int,
        pipeline_depth: int,
        breaker: "_LaneBreaker",
        backend: str = "device",
    ):
        self.algo = algo
        self.bucket = bucket
        self.target = target
        self.queues: dict[str, deque] = {}
        self.rotation: list[str] = []
        self.pending_pieces = 0
        self.event = asyncio.Event()
        self.task: asyncio.Task | None = None
        self.plane = None  # built lazily off the event loop
        # pipelined launches run _run_plane in concurrent worker threads,
        # so first-use plane construction needs a real lock
        self.build_lock = named_lock("sched.lane.build_lock")
        self.sem = asyncio.Semaphore(max(1, pipeline_depth))
        self.inflight: set[asyncio.Task] = set()
        self.breaker = breaker
        self.cpu_plane = None  # hashlib degradation plane, built lazily
        self.backend = backend  # 'cpu' | 'device' | 'cuda' | 'torch'
        # per-lane flush-deadline override (the autopilot's actuator);
        # None = the SchedulerConfig value, so controller-off behavior
        # is bit-identical to the static config
        self.deadline: float | None = None
        # per-lane observability: launch-fill and pad-row waste gauges
        self.launches = 0
        self.fill_sum = 0.0
        self.pad_rows_total = 0

    def oldest_ts(self) -> float:
        return min(q[0].ts for q in self.queues.values() if q)


class _LaneBreaker:
    """Per-lane circuit breaker over the primary (device) plane.

    closed → open after ``threshold`` consecutive transient failures;
    open → half_open after ``cooldown`` seconds; half_open admits ONE
    probe launch — success closes the breaker, failure re-opens it.
    Launches run in concurrent worker threads (pipeline_depth ≥ 2), so
    every state read/transition holds the lock. Deterministic payload
    failures are not device faults: they release a probe slot but never
    move the state or the failure count.
    """

    __slots__ = (
        "threshold", "cooldown", "state", "failures", "opened_at",
        "probing", "transitions", "lock", "_cells",
    )

    def __init__(self, threshold: int, cooldown: float):
        self.threshold = max(1, threshold)
        self.cooldown = cooldown
        self.state = "closed"
        self.failures = 0
        self.opened_at = 0.0
        self.probing = False  # one half-open probe in flight at a time
        self.transitions: dict[str, int] = {}
        self.lock = named_lock("sched.breaker.lock")
        # dynamic lockset checking (tsan-lite Eraser): the whole
        # state/failures/probing blob is one cell guarded by self.lock
        self._cells = guard_attrs("sched.breaker", "state")

    def _to(self, state: str) -> None:
        key = f"{self.state}->{state}"
        self.transitions[key] = self.transitions.get(key, 0) + 1
        self.state = state

    def acquire_primary(self) -> bool:
        """Whether the next launch may use the primary plane (False =
        degrade to the CPU plane for this launch)."""
        with self.lock:
            self._cells.write("state")  # probing may flip below
            if self.state == "closed":
                return True
            if (
                self.state == "open"
                and time.monotonic() - self.opened_at >= self.cooldown
            ):
                self._to("half_open")
                self.probing = False
            if self.state == "half_open" and not self.probing:
                self.probing = True
                return True
            return False

    def record_success(self) -> None:
        with self.lock:
            self._cells.write("state")
            self.probing = False
            self.failures = 0
            if self.state != "closed":
                self._to("closed")

    def record_failure(self) -> bool:
        """A transient primary-plane failure (deterministic payload
        errors go through :meth:`release_probe` instead). Returns True
        when THIS failure transitioned the breaker to open — the
        caller's flight-recorder trigger point, kept outside the lock
        (dumping under it would nest the obs locks below breaker
        state)."""
        with self.lock:
            self._cells.write("state")
            if self.state == "half_open":
                self.probing = False
                self._to("open")
                self.opened_at = time.monotonic()
                return True
            self.failures += 1
            if self.state == "closed" and self.failures >= self.threshold:
                self._to("open")
                self.opened_at = time.monotonic()
                return True
            return False

    def release_probe(self) -> None:
        with self.lock:
            self._cells.write("state")
            self.probing = False

    def snapshot(self) -> dict:
        with self.lock:
            self._cells.read("state")
            out = {
                "state": self.state,
                "consecutive_failures": self.failures,
                "transitions": dict(self.transitions),
                # readiness semantics (obs/slo.build_health): an open
                # breaker within its cooldown is a transient degradation;
                # one stuck open well past it means the half-open probe
                # path is wedged and the process should leave rotation
                "cooldown": self.cooldown,
            }
            if self.state == "open":
                out["open_age_s"] = max(0.0, time.monotonic() - self.opened_at)
            return out


# --------------------------------------------------------------- planes


def build_builtin_plane(
    hasher: str, algo: str, bucket: int, batch: int, device=None, mesh=None
):
    """The plane the scheduler builds when no ``plane_factory`` is set.

    Module-level so fault injection (``sched/faults.py``) can wrap the
    real planes through the ``plane_factory`` seam without duplicating
    the construction rules. ``hasher="gpu"`` planes run on ``device``
    (None means the GPU; ``"cpu"`` the plain PyTorch versions), which
    alone decides the kernel or plain version; a SHA-1 plane spans
    ``mesh`` when one is given (every card of the process when neither
    is), a SHA-256 plane stays on ``device``, as the reference's v2
    planes have no mesh.
    """
    if hasher == "cpu":
        return _CpuPlane(algo)
    if hasher != "gpu":
        raise ValueError(f"unknown hasher {hasher!r}")
    if algo == "sha256":
        return _Sha256CudaPlane(bucket, batch, device)
    if mesh is not None:
        return _Sha1DevicePlane(bucket, batch, mesh=mesh)
    return _Sha1DevicePlane(bucket, batch, device)


class _StagingSlots:
    """Reusable tail-zeroed staging slots shared by the device planes.

    ``hash_pieces``-style staging allocates + zeroes a fresh
    ``batch × padded_len`` buffer every launch — tens of MiB of memset on
    the hot path. Slots are checked out of a locked free list instead
    (pipelined launches run in concurrent worker threads) and remember
    each row's content extent from the previous launch, so ``stage``
    zeroes only the stale tail ``pad_in_place`` requires.

    ``pinned=True`` (a GPU scheduler) allocates each slot as a pinned
    ``torch.uint8`` tensor behind its numpy view, so the planes' copies
    to the card run asynchronously straight from the slot. Such a copy
    reads the slot until its CUDA event completes: the plane hands the
    event over with :meth:`note_copy`, and :meth:`checkin` waits for it
    if it has not completed yet, counting the early check-in — the
    planes fetch their digests (which follows the copy) before they
    check a slot in, so ``early_checkins`` stays 0.
    """

    def __init__(self, rows: int, piece_len: int, pinned: bool = False):
        self.rows = rows
        self.piece_len = piece_len
        self.pinned = pinned
        self._slots: list[tuple] = []  # (padded, view, ends) free list
        self._lock = named_lock("sched.staging._lock")
        self._cells = guard_attrs("sched.staging", "free_list")
        # leak accounting: every checkout must be balanced by a checkin
        # (asserted by tests and exported via metrics_snapshot)
        self.outstanding = 0
        self.checkouts = 0
        # stream-ordered reuse: the pending host→device copy event of a
        # slot, by id of its padded array, and what checkin found
        self._copies: dict[int, object] = {}
        self.copy_checks = 0
        self.early_checkins = 0
        # first-use cost: slots allocated (pinned on a GPU) and seconds
        self.allocs = 0
        self.alloc_s = 0.0

    def _alloc(self):
        from torrent_tpu_torch.ops.padding import alloc_padded, padded_len_for

        if not self.pinned:
            return alloc_padded(self.rows, self.piece_len)
        import torch

        host = torch.zeros(
            (self.rows, padded_len_for(self.piece_len)),
            dtype=torch.uint8,
            pin_memory=True,
        )
        padded = host.numpy()  # keeps the pinned tensor alive
        return padded, padded[:, : self.piece_len]

    def checkout(self) -> tuple:
        """Raw ``(padded, view, ends)`` slot checkout — the zero-copy
        ingest path fills the slot itself (disk reads land directly in
        ``view``); ``stage`` uses the same checkout for its copy path.
        The caller MUST ``checkin(slot)`` exactly once."""
        import numpy as np

        with self._lock:
            self._cells.write("free_list")
            slot = self._slots.pop() if self._slots else None
            self.outstanding += 1
            self.checkouts += 1
        if slot is None:
            t0 = time.monotonic()
            padded, view = self._alloc()
            slot = (padded, view, np.zeros(self.rows, dtype=np.int64))
            with self._lock:
                self._cells.write("free_list")
                self.allocs += 1
                self.alloc_s += time.monotonic() - t0
        return slot

    def note_copy(self, padded, event) -> None:
        """Record the CUDA event that ends the host→device copy reading
        slot buffer ``padded`` (checked at its :meth:`checkin`)."""
        with self._lock:
            self._cells.write("free_list")
            self._copies[id(padded)] = event

    def stage(self, chunk: list[bytes], rows: int | None = None):
        """Checkout a slot and stage ``chunk`` into its first ``rows``
        rows (default: the whole slot).

        Returns ``(slot, padded, nblocks)`` with ``nblocks`` of length
        ``rows``; rows past ``len(chunk)`` are ``nblocks=0`` sentinels.
        Bounding ``rows`` to the launch skips the staging work for slot
        rows the launch never reads —
        untouched rows keep their recorded extents, so later reuse still
        tail-zeroes them correctly. The caller runs its launch, then
        MUST ``checkin(slot)`` (a finally block) to recycle the buffer.
        """
        import numpy as np

        from torrent_tpu_torch.ops.padding import pad_in_place

        rows = self.rows if rows is None else rows
        # pipeline-ledger "stage" boundary: the host copy into the
        # staging slot (the tracker's lock is leaf-scoped at entry/exit;
        # the copy itself runs outside any obs lock)
        with pipeline_ledger().track(
            "stage", sum(len(c) for c in chunk)
        ):
            slot = self.checkout()
            padded, view, ends = slot
            try:
                lengths = np.zeros(rows, dtype=np.int64)
                for i in range(rows):
                    n = len(chunk[i]) if i < len(chunk) else 0
                    stale = int(ends[i])
                    if stale > n:
                        padded[i, n:stale] = 0
                    if n:
                        view[i, :n] = _payload_ndarray(chunk[i])
                        lengths[i] = n
                nblocks = pad_in_place(padded[:rows], lengths)
                # content extent (message + padding) per row, for the next
                # reuse's tail zeroing — recorded before sentinels clear
                ends[:rows] = nblocks.astype(np.int64) * 64
            except Exception:
                # return the slot instead of leaking it; rows may hold
                # half-staged content past their recorded extents, so mark
                # them full-width — the next reuse tail-zeroes everything
                ends[:rows] = padded.shape[1]
                self.checkin(slot)
                raise
            nblocks[len(chunk) :] = 0  # sentinel rows: skip entirely
            return slot, padded, nblocks

    def checkin(self, slot) -> None:
        with self._lock:
            self._cells.write("free_list")
            event = self._copies.pop(id(slot[0]), None)
        if event is not None:
            done = event.query()
            if not done:
                # never hand out a slot a copy still reads
                event.synchronize()
            with self._lock:
                self._cells.write("free_list")
                self.copy_checks += 1
                self.early_checkins += 0 if done else 1
        with self._lock:
            self._cells.write("free_list")
            self._slots.append(slot)
            self.outstanding -= 1

    def stats(self) -> tuple:
        """(outstanding, checkouts, copy_checks, early_checkins, allocs,
        alloc_s) under the free-list lock — snapshot readers run on
        other threads than the checking-out workers."""
        with self._lock:
            self._cells.read("free_list")
            return (
                self.outstanding, self.checkouts, self.copy_checks,
                self.early_checkins, self.allocs, self.alloc_s,
            )


def _payload_ndarray(p):
    """uint8 ndarray view of a ticket payload — SlotRow rows come back
    as views into their slab (no copy), bytes-likes via frombuffer."""
    import numpy as np

    if type(p) is SlotRow:
        return p.ndview()
    return np.frombuffer(p, dtype=np.uint8)


class SlotRow:
    """One staged row of a :class:`StagedSlab`, used as a ticket payload.

    Quacks enough like ``bytes`` for the scheduler's bookkeeping
    (``len``, ``startswith`` for the fault plane's poisoned-prefix
    probe) while never materializing a bytes object: CPU hashing and
    mixed-batch staging consume the numpy row view directly.
    """

    __slots__ = ("slab", "row")

    def __init__(self, slab: "StagedSlab", row: int):
        self.slab = slab
        self.row = row

    def __len__(self) -> int:
        return int(self.slab.lengths[self.row])

    def ndview(self):
        """uint8[len] view into the slab row (zero-copy)."""
        return self.slab.view[self.row, : len(self)]

    def startswith(self, prefix) -> bool:
        n = len(prefix)
        if n > len(self):
            return False
        return bytes(self.slab.view[self.row, :n]) == bytes(prefix)

    def tobytes(self) -> bytes:
        return self.ndview().tobytes()


class StagedSlab:
    """A checked-out staging slot pre-filled by the zero-copy read path.

    Owns one ``(padded, view, ends)`` slot of a scheduler ingest pool
    plus the per-row ``lengths``/``nblocks`` the read path derived —
    disk reads land directly in ``view``'s row-strided memory, rows
    that failed to read carry ``nblocks=0`` sentinels, and the whole
    slab is handed to :meth:`HashPlaneScheduler.enqueue_staged` without
    ever materializing per-piece ``bytes``.

    Lifecycle is reference counted: the creator (the reader) holds one
    reference from checkout; ``enqueue_staged`` retains one per ticket
    and the scheduler's demux releases them as verdicts resolve. The
    slot returns to its pool exactly when the count hits zero — on
    every path (success, launch failure, shed, reader abort), which is
    what the leak-counter test asserts.
    """

    __slots__ = (
        "pool", "slot", "padded", "view", "ends", "nblocks", "lengths",
        "algo", "bucket", "piece_length", "n_used", "_refs", "_lock",
        "_cells",
    )

    def __init__(self, pool: _StagingSlots, slot: tuple, algo: str,
                 bucket: int, piece_length: int):
        import numpy as np

        self.pool = pool
        self.slot = slot
        self.padded, self.view, self.ends = slot
        self.nblocks = np.zeros(pool.rows, dtype=np.int32)
        self.lengths = np.zeros(pool.rows, dtype=np.int64)
        self.algo = algo
        self.bucket = bucket
        self.piece_length = piece_length
        self.n_used = 0
        self._refs = 1  # the creator's hold
        self._lock = named_lock("sched.slab._lock")
        self._cells = guard_attrs("sched.slab", "refs")

    @property
    def rows_total(self) -> int:
        return self.pool.rows

    def prepare(self, planned_lengths) -> None:
        """Zero each row's stale tail beyond its incoming content extent
        (the reads themselves overwrite ``[0, length)``), so a reused
        slot needs no full-width memset before ``pad_in_place``."""
        import numpy as np

        n = len(planned_lengths)
        self.n_used = n
        self.lengths[:n] = np.asarray(planned_lengths, dtype=np.int64)
        self.lengths[n:] = 0
        for i in range(n):
            stale = int(self.ends[i])
            ln = int(self.lengths[i])
            if stale > ln:
                self.padded[i, ln:stale] = 0

    def finalize(self, ok) -> None:
        """Pad the first ``n_used`` rows in place and sentinel the failed
        ones (``ok[i] is False`` → ``nblocks=0``; mark-and-continue)."""
        import numpy as np

        from torrent_tpu_torch.ops.padding import pad_in_place

        n = self.n_used
        nb = pad_in_place(self.padded[:n], self.lengths[:n])
        # dirty extent per row for the NEXT reuse's tail zeroing: padding
        # extent for hashed rows, the attempted read extent for failed
        # ones (their partial bytes are garbage the sentinel masks)
        self.ends[:n] = np.maximum(nb.astype(np.int64) * 64, self.lengths[:n])
        nb[~np.asarray(ok, dtype=bool)] = 0
        self.nblocks[:n] = nb
        self.nblocks[n:] = 0

    def row(self, i: int):
        return self.view[i, : int(self.lengths[i])]

    def retain(self, n: int = 1) -> None:
        with self._lock:
            self._cells.write("refs")
            self._refs += n

    def release(self, n: int = 1) -> None:
        with self._lock:
            self._cells.write("refs")
            self._refs -= n
            done = self._refs == 0
        if done:
            self.pool.checkin(self.slot)


def _staged_batch(payloads):
    """``(slab, rows)`` when every payload is a SlotRow of ONE slab —
    the zero-copy launch form (the plane reads the pre-staged buffer
    directly); ``None`` for mixed batches, which take the copying
    ``plane.run`` path."""
    first = payloads[0] if payloads else None
    if type(first) is not SlotRow:
        return None
    slab = first.slab
    rows = []
    for p in payloads:
        if type(p) is not SlotRow or p.slab is not slab:
            return None
        rows.append(p.row)
    return slab, rows


def _masked_nblocks(slab: StagedSlab, rows: list[int]):
    """The slab's nblocks up to its last ticket row, with every row
    OUTSIDE ``rows`` sentineled — a launch reads the slab in place, and
    the masked rows' chains never run (the kernels take any row count,
    so the launch stops at the last ticket row)."""
    import numpy as np

    idx = np.asarray(rows, dtype=np.int64)
    nb = np.zeros(int(idx.max()) + 1 if idx.size else 0, dtype=np.int32)
    nb[idx] = slab.nblocks[idx]
    return nb


class _CpuPlane:
    """hashlib fallback plane — the CPU-path parity backend."""

    def __init__(self, algo: str):
        self._h = hashlib.sha256 if algo == "sha256" else hashlib.sha1

    @staticmethod
    def launch_geometry(n_rows: int, bucket: int) -> tuple[int, int]:
        """hashlib stages nothing: no padding, no staging footprint."""
        return n_rows, 0

    def run(self, payloads: list[bytes]) -> list[bytes]:
        h = self._h
        with pipeline_ledger().track("launch", sum(len(p) for p in payloads)):
            # SlotRow payloads hash their numpy row views directly —
            # hashlib takes any contiguous buffer, no bytes materialized
            return [h(_payload_ndarray(p) if type(p) is SlotRow else p).digest()
                    for p in payloads]

    def run_staged(self, slab: StagedSlab, rows: list[int]) -> list[bytes]:
        """Zero-copy form: hash the pre-staged rows in place."""
        h = self._h
        nb = int(slab.lengths[list(rows)].sum())
        with pipeline_ledger().track("launch", nb):
            return [h(slab.row(r)).digest() for r in rows]


class _Events:
    """The CUDA events of one launch's grid entries, waited on as one
    (``_StagingSlots.checkin`` queries and synchronises it)."""

    def __init__(self, events: list):
        self.events = events

    def query(self) -> bool:
        return all(e.query() for e in self.events)

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()


class _DevicePlane:
    """The launch machinery both device planes share: one staged batch
    through the h2d / launch / digest stages of the pipeline ledger, its
    rows split over the plane's grid entries in contiguous blocks
    (:meth:`_blocks`; the SHA-256 plane has one entry).

    On a GPU (stream-ordered reuse, in place of the reference's donated
    jit inputs), each entry on its own copy and compute streams:

    * **h2d** — each entry's rows go to its card ``non_blocking`` on its
      copy stream, from the pinned staging slot; the span closes when
      every entry's copy event completes, and the events are handed to
      the slot's pool (``_StagingSlots.note_copy``), which checks them
      at check-in.
    * **launch** — each entry's compute stream waits on its copy's
      event, the device tensors made on the copy stream are
      ``record_stream``-ed to it, and the kernels are enqueued under
      ``_device_lock`` (held only while enqueueing); the span closes on
      the kernels' completion events. A launch first waits, outside its
      span, for the plane's previous kernels, which the streams would
      run first anyway, so one plane's launch spans never overlap.
    * **digest** — only the device→host copies of the digest words.

    Batch N+1's copy, in the other pipelined worker thread, overlaps
    batch N's kernels. PyTorch's current stream is per thread, so every
    step names the plane's streams itself. Under load the host-clock
    spans also hold the waits of a busy host (the GIL among them); the
    card's own busy time comes from a ``torch.profiler`` trace. With
    ``device="cpu"`` the same stages run the plain PyTorch versions
    synchronously.
    """

    def __init__(self, devices: list, lock_name: str):
        import torch

        self.devices = devices
        self.device = devices[0]
        self._cuda = self.device.type == "cuda"
        self._device_lock = named_lock(lock_name)
        self._last_done = None  # completion events of the latest kernels
        if self._cuda:
            self._copy_streams = [torch.cuda.Stream(d) for d in devices]
            self._compute_streams = [torch.cuda.Stream(d) for d in devices]

    @staticmethod
    def launch_geometry(n_rows: int, bucket: int) -> tuple[int, int]:
        """Row-exact launches (the kernels take any row count); staging
        charges the padded row width."""
        from torrent_tpu_torch.ops.padding import padded_len_for

        return n_rows, n_rows * padded_len_for(bucket)

    def _blocks(self, n_rows: int) -> list:
        """``(entry, device, lo, hi)`` of each entry's rows of a launch."""
        return [(0, self.device, 0, n_rows)]

    def _upload(self, rows, streams) -> list:
        """Each entry's device copy of its block of the staged ``rows``,
        made on its stream of ``streams`` (None on the CPU)."""
        from torrent_tpu_torch.compat import to_device, to_device_on_stream

        if streams is None:
            return [to_device(rows[lo:hi], dev) for _, dev, lo, hi in self._blocks(len(rows))]
        return [to_device_on_stream(rows[lo:hi], streams[i]) for i, _, lo, hi in self._blocks(len(rows))]

    def _kernel(self, datas: list, nblocks: list, streams) -> list:
        """Each entry's digest words of its block, launched on its stream
        of ``streams`` (None on the CPU)."""
        raise NotImplementedError

    def _launch_rows(self, rows, nblocks, nb: int, pool, slot_padded):
        """Hash the staged ``rows`` (a row prefix of ``slot_padded``, a
        buffer of ``pool``) with their block counts; returns the
        ``uint32[len(rows), W]`` digest words on the host."""
        import numpy as np
        import torch

        from torrent_tpu_torch.compat import to_device, to_device_on_stream
        from torrent_tpu_torch.ops.sha1_torch import words_to_numpy

        led = pipeline_ledger()
        blocks = self._blocks(len(rows))
        if not self._cuda:
            with led.track("h2d", nb):
                datas = self._upload(rows, None)
                nbls = [to_device(nblocks[lo:hi], dev) for _, dev, lo, hi in blocks]
            with self._device_lock:
                with led.track("launch", nb):
                    words = self._kernel(datas, nbls, None)
            with led.track("digest", nb):
                return words_to_numpy(words)
        copies, computes = self._copy_streams, self._compute_streams
        with led.track("h2d", nb):
            datas = self._upload(rows, copies)
            nbls, copied = [], []
            for i, _, lo, hi in blocks:
                nbls.append(to_device_on_stream(nblocks[lo:hi], copies[i]))
                event = torch.cuda.Event()
                event.record(copies[i])
                copied.append(event)
            pool.note_copy(slot_padded, _Events(copied))
            for event in copied:
                event.synchronize()
        with self._device_lock:
            prev = self._last_done
        if prev is not None:
            prev.synchronize()
        with led.track("launch", nb):
            with self._device_lock:
                for i, _, _, _ in blocks:
                    computes[i].wait_event(copied[i])
                    datas[i].record_stream(computes[i])
                    nbls[i].record_stream(computes[i])
                words = self._kernel(datas, nbls, computes)
                done = []
                for i, _, _, _ in blocks:
                    event = torch.cuda.Event()
                    event.record(computes[i])
                    done.append(event)
                done = self._last_done = _Events(done)
            done.synchronize()
        with led.track("digest", nb):
            out = []
            for (i, _, _, _), w in zip(blocks, words):
                with torch.cuda.stream(computes[i]):
                    out.append(words_to_numpy(w))
            return np.concatenate(out)

    def run(self, payloads: list[bytes]) -> list[bytes]:
        from torrent_tpu_torch.ops.padding import words_to_digests

        if any(len(p) > self._bucket for p in payloads):
            # a too-long piece would fail mid-stage with the slot
            # checked out
            raise ValueError("piece longer than plane piece_length")
        out: list[bytes] = []
        b = self._slots.rows
        for start in range(0, len(payloads), b):
            chunk = payloads[start : start + b]
            k = len(chunk)
            nb = sum(len(p) for p in chunk)
            m = self._launch_rows_for(k)
            slot, padded, nblocks = self._slots.stage(chunk, m)
            try:
                words = self._launch_rows(
                    padded[:m], nblocks, nb, self._slots, padded
                )
                out.extend(words_to_digests(words[:k]))
            finally:
                self._slots.checkin(slot)
        return out

    def _launch_rows_for(self, k: int) -> int:
        """The rows a launch of ``k`` live rows stages (a grid's launches
        pad to a multiple of its size with sentinel rows)."""
        return k

    def run_staged(self, slab: StagedSlab, rows: list[int]) -> list[bytes]:
        """Zero-copy launch: the pre-staged slab IS the launch buffer —
        no ``_StagingSlots.stage`` copy; rows outside the ticket set are
        masked to ``nblocks=0``, and the launch ends at the last ticket
        row, padded with masked rows to a multiple of the grid's size.
        A slab whose rows do not split evenly over the grid takes the
        copy path (the reference's mesh-divisibility rule)."""
        import numpy as np

        from torrent_tpu_torch.ops.padding import padded_len_for, words_to_digests

        if (
            slab.padded.shape[1] != padded_len_for(self._bucket)
            or slab.rows_total > self._slots.rows
            or slab.rows_total % len(self.devices)
        ):
            # row width / size / grid-divisibility mismatch: copy path
            return self.run([SlotRow(slab, r) for r in rows])
        nb = int(slab.lengths[list(rows)].sum())
        nblocks = _masked_nblocks(slab, rows)
        m = self._launch_rows_for(len(nblocks))
        nblocks = np.concatenate([nblocks, np.zeros(m - len(nblocks), dtype=np.int32)])
        words = self._launch_rows(
            slab.padded[:m], nblocks, nb, slab.pool, slab.padded
        )
        return words_to_digests(words[rows])


class _Sha1DevicePlane(_DevicePlane):
    """SHA-1 device plane: one ``GPUVerifier`` per bucket, over the
    hand-written Hopper kernel (``ops/sha1_cuda.py``) on a GPU and the
    plain PyTorch SHA-1 on ``device="cpu"``, spanning the scheduler's
    grid (``parallel/mesh.py``): each launch's rows split in contiguous
    blocks over the grid's entries, padded with sentinel rows to a
    multiple of its size.

    Stages into reusable per-plane :class:`_StagingSlots` (pinned on a
    GPU) instead of ``hash_pieces`` (which allocates + zeroes a fresh
    buffer every launch). The transfers and the kernels go through the
    verifier's ``upload_batch`` / ``digest_uploaded`` on the plane's
    streams (:class:`_DevicePlane`)."""

    def __init__(self, bucket: int, batch: int, device=None, mesh=None):
        from torrent_tpu_torch.models.verifier import GPUVerifier

        self._verifier = GPUVerifier(
            piece_length=bucket, batch_size=batch, device=device, mesh=mesh
        )
        super().__init__(self._verifier.devices, "sched.sha1_plane._device_lock")
        self._bucket = bucket
        self._slots = _StagingSlots(
            self._verifier.batch_size, bucket, pinned=self._cuda
        )

    def launch_geometry(self, n_rows: int, bucket: int) -> tuple[int, int]:
        """Launches of whole grid blocks: the rows round up to a multiple
        of the grid's size (row-exact on one entry); staging charges the
        padded row width."""
        from torrent_tpu_torch.ops.padding import padded_len_for

        m = self._launch_rows_for(n_rows)
        return m, m * padded_len_for(bucket)

    def _launch_rows_for(self, k: int) -> int:
        from torrent_tpu_torch.parallel.mesh import round_up_to_multiple

        return round_up_to_multiple(k, len(self.devices))

    def _blocks(self, n_rows: int) -> list:
        from torrent_tpu_torch.parallel.mesh import row_blocks

        return row_blocks(self._verifier.mesh, n_rows)

    def _upload(self, rows, streams):
        return self._verifier.upload_batch(rows, streams=streams)

    def _kernel(self, datas, nblocks, streams):
        return self._verifier.digest_uploaded(datas, nblocks, streams=streams)


class _Sha256CudaPlane(_DevicePlane):
    """SHA-256 (BEP 52) plane over ``ops/sha256_cuda.sha256_pieces_cuda``:
    the hand-written Hopper kernel on a GPU, the plain PyTorch version on
    ``device="cpu"``. It replaces the reference's two v2 planes (its
    lax.scan program and its tile-shaped pallas kernel): the CUDA kernel
    takes any row count, so launches are row-exact — no tile snapping,
    no sentinel pad rows, no budget-forced fallback."""

    def __init__(self, bucket: int, batch: int, device=None):
        from torrent_tpu_torch.ops.sha256_cuda import make_sha256_fn
        from torrent_tpu_torch.utils.device import resolve_device

        super().__init__([resolve_device(device)], "sched.sha256_cuda_plane._device_lock")
        self._fn = make_sha256_fn(self.device)  # builds the kernel on a GPU
        self._bucket = bucket
        self._slots = _StagingSlots(batch, bucket, pinned=self._cuda)

    def _kernel(self, datas, nblocks, streams):
        import contextlib

        import torch

        ctx = torch.cuda.stream(streams[0]) if streams is not None else contextlib.nullcontext()
        with ctx:
            return [self._fn(datas[0], nblocks[0])]


# ------------------------------------------------------------ scheduler


class HashPlaneScheduler:
    """The shared verify queue. One instance serves every consumer of a
    process's hash plane; see the module docstring for the data flow."""

    def __init__(
        self,
        config: SchedulerConfig | None = None,
        hasher: str = "gpu",
        device=None,
        devices=None,
        mesh=None,
    ):
        """``hasher="gpu"`` hashes on a grid (``parallel/mesh.py``):
        ``device`` alone, ``devices``, or this process's entries of
        ``mesh``; with none of them every card of the process, and a host
        without one raises here. ``device="cpu"`` is the explicit
        plain-PyTorch path the tests use. The SHA-1 lanes span the grid,
        the SHA-256 lanes run on its first entry (``device``).
        ``hasher="cpu"`` is hashlib (the grid is ignored). These are the
        port's hasher names, as in ``parallel/verify.verify_pieces``."""
        from torrent_tpu_torch.parallel.mesh import local_grid

        if hasher not in ("gpu", "cpu"):
            raise ValueError(f"unknown hasher {hasher!r}: expected 'gpu' or 'cpu'")
        self.config = config or SchedulerConfig()
        self.hasher = hasher
        self.mesh = local_grid(device, devices, mesh) if hasher == "gpu" else None
        self.device = self.mesh.entries[0] if hasher == "gpu" else None
        self._tenants: dict[str, _Tenant] = {}
        self._lanes: dict[tuple[str, int], _Lane] = {}
        self._queued_bytes = 0  # queued + in-flight payload bytes
        self._closing = False
        self._space = asyncio.Event()  # pulsed on every byte release
        # metrics
        self._launches = 0
        self._fill_sum = 0.0
        self._flush_reasons = {"full": 0, "deadline": 0, "shutdown": 0}
        self._shed_total = 0
        # fault-tolerance counters (satellite observability: exported
        # via metrics_snapshot -> render_sched_metrics -> /metrics)
        self._launch_failures = 0
        self._retries = 0
        self._bisections = 0
        self._cpu_fallback_launches = 0
        # the only fault counter touched off the event loop (worker
        # threads, possibly in different lanes) — needs its own lock
        self._counter_lock = named_lock("sched._counter_lock")
        self._counter_cells = guard_attrs("sched.scheduler", "fault_counters")
        self._failed_pieces = 0  # tickets that exhausted retry+bisection
        # rollup of evicted auto-registered tenants so served/shed totals
        # stay monotonic after their per-tenant series disappear
        self._evicted = {"tenants": 0, "served_bytes": 0, "served_pieces": 0, "shed": 0}
        # zero-copy ingest: reader-side staging pools per (algo, bucket)
        # — disk reads land directly in these slots and slot-carrying
        # submissions hand them to the planes without a stage copy.
        # Checked out from worker threads (read paths run off-loop).
        self._ingest_pools: dict[tuple[str, int], _StagingSlots] = {}
        self._ingest_lock = named_lock("sched._ingest_lock")
        # autopilot actuator (sched/control.py): fraction of the
        # configured global admission budget currently admitted. 1.0 =
        # the static config exactly (the comparison short-circuits, so
        # controller-off behavior is bit-identical)
        self._admission_factor = 1.0

    # ------------------------------------------------------------ admin

    async def start(self) -> "HashPlaneScheduler":
        """Bind to the running loop (lanes spawn lazily on first use).

        The device was resolved by the constructor, so ``chunk_for`` and
        enqueue (which call :meth:`_lane_plan` inline) never query it on
        the serving loop. Plane construction (kernel library load,
        staging and stream allocation) happens later, in the launch
        worker threads.
        """
        return self

    async def close(self) -> None:
        """Flush every pending item (reason 'shutdown') and stop lanes."""
        self._closing = True
        for lane in self._lanes.values():
            lane.event.set()
        self._space.set()
        for lane in list(self._lanes.values()):
            if lane.task is not None:
                await lane.task
            if lane.inflight:
                await asyncio.gather(*lane.inflight, return_exceptions=True)

    def register_tenant(
        self, name: str, weight: float = 1.0, max_bytes: int | None = None
    ) -> None:
        """Declare a tenant's scheduling weight / byte bound (idempotent;
        unseen tenants are auto-registered at weight 1.0 on first use)."""
        if weight <= 0:
            raise ValueError("tenant weight must be positive")
        t = self._tenants.get(name)
        if t is None:
            t = self._tenants[name] = _Tenant(name, weight, max_bytes)
        else:
            t.weight = weight
            if max_bytes is not None:
                t.max_bytes = max_bytes
        t.pinned = True

    # ---------------------------------------------------------- helpers

    @staticmethod
    def bucket_for(piece_length: int) -> int:
        """Pow-2 piece-length bucket (shared executable per bucket)."""
        return 1 << (piece_length - 1).bit_length() if piece_length > 1 else 1

    def sha256_backend(self) -> str:
        """The v2 lanes' backend: 'cuda' on a GPU, 'torch' on
        ``device="cpu"``, 'cpu' (hashlib) for ``hasher="cpu"``."""
        return self._plane_backend("sha256")

    def _plane_backend(self, algo: str) -> str:
        """A lane's own backend, from the hasher and the device alone:
        'cpu' (hashlib) for ``hasher="cpu"``, 'cuda' for either algo on a
        card, and on ``device="cpu"`` the plain versions, 'device' for
        sha1 (the reference's name) and 'torch' for sha256."""
        if self.hasher == "cpu":
            return "cpu"
        if self._on_card():
            return "cuda"
        return "torch" if algo == "sha256" else "device"

    def _lane_plan(self, algo: str, bucket: int) -> tuple[str, int]:
        """(backend, flush target) for a lane.

        The target is ``min(batch_target, staging_budget / padded_len)``
        — big-piece buckets shrink the launch so staging stays bounded
        (the bridge's old private-buffer rule). Every plane of the port
        is row-exact (the CUDA kernels take any row count), so unlike the
        reference's pallas lanes nothing snaps to a tile and no bucket
        falls back to another backend (:meth:`_plane_backend`).
        """
        from torrent_tpu_torch.ops.padding import padded_len_for

        cfg = self.config
        afford = max(1, cfg.staging_budget // padded_len_for(bucket))
        base = max(1, min(cfg.batch_target, afford))
        return self._plane_backend(algo), base

    def checkout_staging(
        self, piece_length: int, n_rows: int, algo: str = "sha1"
    ) -> StagedSlab | None:
        """Check a staging slab out for the zero-copy ingest path.

        The read path (``parallel/verify.read_pieces_into``) fills the
        slab's row-strided view directly from disk, pads it in place,
        and submits it via :meth:`enqueue_staged` — no per-piece
        ``bytes``, no ``_StagingSlots.stage`` copy. Returns ``None``
        when this geometry can't take pre-staged submissions (chunk
        bigger than the lane's slab, scheduler closing) — callers then
        fall back to the ``read_pieces_chunk`` byte path. Safe to call
        from worker threads (read loops run off the event loop).

        The caller owns one reference; every path must end in
        ``slab.release()`` (directly, or via ``enqueue_staged``'s
        per-ticket refs resolving through demux).
        """
        if self._closing or algo not in DIGEST_LEN:
            return None
        bucket = self.bucket_for(piece_length)
        key = (algo, bucket)
        with self._ingest_lock:
            pool = self._ingest_pools.get(key)
        if pool is None:
            _, target = self._lane_plan(algo, bucket)
            if algo == "sha1" and self.mesh is not None:
                # whole grid blocks, so a full slab launches zero-copy
                target = -(-target // self.mesh.size) * self.mesh.size
            with self._ingest_lock:
                pool = self._ingest_pools.setdefault(
                    key, _StagingSlots(target, bucket, pinned=self._on_card())
                )
        if n_rows > pool.rows:
            return None
        return StagedSlab(pool, pool.checkout(), algo, bucket, piece_length)

    def _on_card(self) -> bool:
        """Whether this scheduler runs on a CUDA card: its staging memory
        is pinned, and its lanes never leave the kernels for hashlib."""
        return self.device is not None and self.device.type == "cuda"

    def chunk_for(self, piece_length: int, algo: str = "sha1") -> int:
        """Effective batch target for this geometry — the lane flush
        size.
        Stream ingests use it as their submission chunk so one
        submission maps to roughly one launch."""
        return self._lane_plan(algo, self.bucket_for(piece_length))[1]

    async def prewarm(self, algo: str, piece_length: int) -> None:
        """On a card, build the lane of this geometry with its plane (the
        kernel library load) and allocate its pinned staging slots, one
        per pipelined launch, off the event loop — so a server's first
        request of this geometry pays none of it. Elsewhere there is
        nothing to warm (no kernel, no pinned memory) and no lane is
        made. A build failure raises to the caller."""
        if not self._on_card():
            return
        lane = self._lane(algo, piece_length)

        def build() -> None:
            with lane.build_lock:
                if lane.plane is None:
                    lane.plane = self._build_plane(lane)
            plane = getattr(lane.plane, "inner", lane.plane)  # FaultyPlane
            slots = getattr(plane, "_slots", None)
            if slots is not None:
                # every slot taken goes back, also when a later
                # checkout raises
                held = []
                try:
                    for _ in range(self.config.pipeline_depth):
                        held.append(slots.checkout())
                finally:
                    for slot in held:
                        slots.checkin(slot)

        await asyncio.to_thread(build)

    # -------------------------------------------- autopilot actuators
    # (sched/control.py — every setter is a no-op-able, bounded seam;
    # with no autopilot attached none of these ever runs and behavior
    # is bit-identical to the static config)

    def _lane_by_key(self, lane_key: str) -> _Lane | None:
        algo, _, bucket = lane_key.rpartition("/")
        try:
            return self._lanes.get((algo, int(bucket)))
        except ValueError:
            return None

    def set_lane_target(self, lane_key: str, target: int) -> int | None:
        """Set a lane's flush target (autopilot batch actuator).

        The applied value is clamped to the staging budget and snapped
        to what the built plane actually stages via its
        ``launch_geometry`` hook (the port's own planes are row-exact; a
        ``plane_factory`` plane may stage in granules). Returns the
        applied target (None for an unknown lane)."""
        lane = self._lane_by_key(lane_key)
        if lane is None:
            return None
        target = max(1, int(target))
        afford = None
        if self.hasher != "cpu":
            from torrent_tpu_torch.ops.padding import padded_len_for

            afford = max(1, self.config.staging_budget // padded_len_for(lane.bucket))
            target = min(target, afford)
        hook = (
            getattr(lane.plane, "launch_geometry", None)
            if lane.plane is not None
            else None
        )
        if hook is not None:
            rows = int(hook(target, lane.bucket)[0])
            if afford is not None and rows > afford:
                # the hook snaps UP (a granule); a snap past the
                # staging afford must round DOWN to the largest granule
                # multiple instead. When even one granule doesn't fit,
                # the budget beats the granule and the raw afford stands.
                granule = max(1, int(hook(1, lane.bucket)[0]))
                rows = afford // granule * granule
                if rows < 1:
                    rows = afford
            if rows >= 1:
                target = rows
        lane.target = target
        lane.event.set()  # re-evaluate the flush condition now
        return lane.target

    def set_lane_deadline(self, lane_key: str, seconds: float) -> float | None:
        """Per-lane flush-deadline override (autopilot). Returns the
        applied value (None for an unknown lane)."""
        lane = self._lane_by_key(lane_key)
        if lane is None:
            return None
        lane.deadline = max(0.001, float(seconds))
        lane.event.set()
        return lane.deadline

    def set_admission_factor(self, factor: float) -> float:
        """Scale the global admission budget (autopilot). 1.0 restores
        the static config exactly; raising the factor wakes blocked
        submitters."""
        factor = min(1.0, max(0.01, float(factor)))
        raised = factor > self._admission_factor
        self._admission_factor = factor
        if raised:
            self._space.set()
        return factor

    def steer_lane_backend(self, lane_key: str, backend: str) -> str | None:
        """Steer a lane to another backend (autopilot). The plane is
        rebuilt lazily on the next launch; an in-flight launch finishes
        on the old plane (planes are stateless). Returns the new
        backend, or None when unknown lane / already there.

        A lane runs on its own plane (:meth:`_plane_backend`) or on
        hashlib ('cpu'), and on hashlib only where the scheduler does
        not run on a card: a GPU scheduler's lanes have no alternative,
        so no steer moves their work off the kernels."""
        if backend not in ("cpu", "device", "cuda", "torch"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "cpu" and self._on_card():
            raise ValueError("a GPU scheduler's lanes run on the card only")
        lane = self._lane_by_key(lane_key)
        if lane is None:
            return None
        own = self._plane_backend(lane.algo)
        if backend not in ("cpu", own):
            raise ValueError(
                f"lane {lane_key} runs on {own!r} or 'cpu', not {backend!r}"
            )
        if lane.backend == backend:
            return None
        log.info(
            "steering lane %s backend %s -> %s", lane_key, lane.backend, backend
        )
        lane.backend = backend
        lane.plane = None  # next _run_plane rebuilds under build_lock
        return backend

    def control_surface(self) -> dict:
        """Per-lane + admission view the autopilot decides over (pure
        reads; the controller deltas launches/fill_sum itself)."""
        from torrent_tpu_torch.ops.padding import padded_len_for

        cfg = self.config
        lanes: dict[str, dict] = {}
        for (algo, bucket) in sorted(self._lanes):
            lane = self._lanes[(algo, bucket)]
            if self.hasher == "cpu":
                # hashlib stages nothing: growth is bounded only by the
                # controller's own target_max_factor law
                afford = max(lane.target, cfg.batch_target) * 64
            else:
                afford = max(1, cfg.staging_budget // padded_len_for(bucket))
            # launch granule (1 = row-exact): the controller snaps its
            # grow cap to this so it never proposes a target the
            # set_lane_target snap would round back down forever
            hook = (
                getattr(lane.plane, "launch_geometry", None)
                if lane.plane is not None
                else None
            )
            if hook is not None:
                granule = max(1, int(hook(1, bucket)[0]))
            else:
                granule = 1
            lanes[f"{algo}/{bucket}"] = {
                "algo": algo,
                "bucket": bucket,
                "granule": granule,
                "target": lane.target,
                "base_target": self._lane_plan(algo, bucket)[1],
                "afford": afford,
                "deadline": (
                    lane.deadline if lane.deadline is not None else cfg.flush_deadline
                ),
                "base_deadline": cfg.flush_deadline,
                "backend": lane.backend,
                "launches": lane.launches,
                "fill_sum": lane.fill_sum,
                "pending": lane.pending_pieces,
            }
        return {
            "lanes": lanes,
            "admission": {
                "factor": self._admission_factor,
                "max_queue_bytes": cfg.max_queue_bytes,
                "queue_bytes": self._queued_bytes,
            },
        }

    def _lane(self, algo: str, piece_length: int) -> _Lane:
        bucket = self.bucket_for(piece_length)
        key = (algo, bucket)
        lane = self._lanes.get(key)
        if lane is None:
            backend, target = self._lane_plan(algo, bucket)
            lane = _Lane(
                algo,
                bucket,
                target,
                self.config.pipeline_depth,
                _LaneBreaker(
                    self.config.breaker_threshold, self.config.breaker_cooldown
                ),
                backend=backend,
            )
            self._lanes[key] = lane
            lane.task = asyncio.ensure_future(self._lane_loop(lane))
        return lane

    def _tenant(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            t = _Tenant(name)
            self._tenants[name] = t
            if len(self._tenants) > self.config.max_idle_tenants:
                self._prune_tenants()
        return t

    def _prune_tenants(self) -> None:
        """Evict idle auto-registered tenants once past the cardinality
        bound — an attacker sending a fresh X-Tenant per request must not
        grow per-tenant state, /metrics series, or the DRR rotation
        without limit. Pinned (register_tenant) tenants are kept."""
        excess = len(self._tenants) - self.config.max_idle_tenants
        for name, t in list(self._tenants.items()):
            if excess <= 0:
                return
            if t.pinned or t.queued_bytes:
                continue
            # queued_bytes misses zero-length payloads, so check queues too
            if any(lane.queues.get(name) for lane in self._lanes.values()):
                continue
            del self._tenants[name]
            for lane in self._lanes.values():
                if lane.queues.pop(name, None) is not None:
                    lane.rotation.remove(name)
            self._evicted["tenants"] += 1
            self._evicted["served_bytes"] += t.served_bytes
            self._evicted["served_pieces"] += t.served_pieces
            self._evicted["shed"] += t.shed
            excess -= 1

    # ------------------------------------------------------------ submit

    async def enqueue(
        self,
        tenant: str,
        pieces: list[bytes],
        expected: list[bytes] | None = None,
        algo: str = "sha1",
        piece_length: int | None = None,
        wait: bool = False,
    ) -> asyncio.Future:
        """Queue one submission; returns a future resolving to its
        results (digest list, or ok-bytes when ``expected`` is given).

        ``wait=False`` sheds with :class:`SchedRejected` when admission
        control is over budget (the bridge's 429); ``wait=True`` blocks
        until space frees — the backpressure path for streaming ingest.
        """
        if algo not in DIGEST_LEN:
            raise ValueError(f"unknown algo {algo!r}")
        mode = "digest" if expected is None else "verify"
        if expected is not None and len(expected) != len(pieces):
            raise ValueError("expected list must match pieces")
        loop = asyncio.get_running_loop()
        sub = _Submission(len(pieces), mode, loop)
        if not pieces:
            sub.future.set_result(b"" if mode == "verify" else [])
            return sub.future
        # span context captured HERE (the caller's task still holds it);
        # everything downstream runs in lane tasks / worker threads
        ctx = tracer().current_context()
        t_enq = time.monotonic()
        ts = self._tenant(tenant)
        plen = piece_length if piece_length else max(len(p) for p in pieces)
        bucket = self.bucket_for(plen)
        if any(len(p) > bucket for p in pieces):
            raise ValueError("piece exceeds submission piece_length")
        # Admission charges what a device launch actually stages — the
        # padded row footprint (lane-aligned padded_len per piece), not
        # the raw payload bytes; a 1-byte piece in a 16 MiB bucket still
        # pins a 16 MiB staging row. The CPU plane stages nothing, so it
        # keeps raw-byte accounting.
        if self.hasher == "cpu":
            row_cost = 0
            charged = sum(len(p) for p in pieces)
        else:
            from torrent_tpu_torch.ops.padding import padded_len_for

            row_cost = padded_len_for(bucket)
            charged = len(pieces) * row_cost
        try:
            await self._admit(ts, charged, wait)
        except SchedRejected as e:
            if ctx is not None:
                tracer().add_span(
                    ctx[0], "sched.shed", parent_id=ctx[1], t0=t_enq,
                    status="error", tenant=tenant, reason=e.reason,
                    queued_bytes=e.queued_bytes, limit_bytes=e.limit_bytes,
                )
            raise
        t_admitted = time.monotonic()
        lane = self._lane(algo, plen)
        q = lane.queues.get(tenant)
        if q is None:
            q = lane.queues[tenant] = deque()
            lane.rotation.append(tenant)
        now = time.monotonic()
        for i, p in enumerate(pieces):
            q.append(
                _Ticket(
                    sub, i, p, expected[i] if expected else None, tenant, now,
                    charged=row_cost or len(p),
                )
            )
        lane.pending_pieces += len(pieces)
        ts.queued_bytes += charged
        self._queued_bytes += charged
        lane.event.set()
        if ctx is not None:
            t_queued = time.monotonic()
            enq_id = tracer().add_span(
                ctx[0], "sched.enqueue", parent_id=ctx[1], t0=t_enq,
                t1=t_queued, tenant=tenant, algo=algo, mode=mode,
                pieces=len(pieces), charged_bytes=charged,
                lane=f"{algo}/{bucket}",
            )
            tracer().add_span(
                ctx[0], "sched.admission", parent_id=enq_id, t0=t_enq,
                t1=t_admitted, tenant=tenant, wait=wait,
            )
            # later stages (lane wait, launch, digest) hang off the
            # enqueue span — carried by the submission, not contextvars
            sub.trace = (ctx[0], enq_id)
        return sub.future

    async def enqueue_staged(
        self,
        tenant: str,
        slab: StagedSlab,
        rows: list[int],
        expected: list[bytes] | None = None,
        wait: bool = False,
    ) -> asyncio.Future:
        """Slot-carrying submission: queue the pre-staged ``rows`` of a
        :class:`StagedSlab` (from :meth:`checkout_staging`).

        Tickets carry :class:`SlotRow` payloads — zero-copy views into
        the slab — and each holds one slab reference that the demux
        releases on verdict or failure, so the slot returns to its pool
        exactly when the last co-batched ticket resolves. Admission
        charging, DRR fairness, shed, retry/bisection and the breaker's
        CPU fallback all behave exactly as for byte submissions (the
        CPU plane hashes the slab rows in place). On shed/validation
        failure the retained ticket refs are released here; the
        CALLER's own reference is untouched either way.
        """
        payloads = [SlotRow(slab, r) for r in rows]
        slab.retain(len(payloads))  # one ref per ticket, released at demux
        try:
            return await self.enqueue(
                tenant,
                payloads,
                expected=expected,
                algo=slab.algo,
                piece_length=slab.piece_length,
                wait=wait,
            )
        except BaseException:
            slab.release(len(payloads))
            raise

    async def submit(self, tenant: str, pieces, expected=None, algo="sha1",
                     piece_length=None, wait: bool = False):
        """``enqueue`` + await: returns digests (or ok-bytes) directly."""
        fut = await self.enqueue(tenant, pieces, expected, algo, piece_length, wait)
        return await fut

    async def _admit(self, ts: _Tenant, nbytes: int, wait: bool) -> None:
        cfg = self.config
        tenant_limit = ts.max_bytes if ts.max_bytes is not None else cfg.max_tenant_bytes

        def max_queue() -> int:
            # the autopilot's admission actuator scales the GLOBAL budget
            # only (per-tenant limits are policy, not control); at the 1.0
            # default this is exactly the static config. Re-read on every
            # evaluation: a submitter blocked under a shrunken budget must
            # observe the recovered factor when set_admission_factor wakes
            # it, not a bound baked in at entry.
            factor = self._admission_factor
            if factor < 1.0:
                return max(1, int(cfg.max_queue_bytes * factor))
            return cfg.max_queue_bytes

        def over() -> tuple[bool, int, int]:
            # The empty-queue escape exists ONLY for the blocking path: an
            # oversize submission that can never fit must be admitted once
            # the queue drains or wait=True livelocks forever. On the shed
            # path it would let one giant submission blow past both bounds
            # into an idle queue and then 429 everyone else while it drains.
            limit = max_queue()
            if self._queued_bytes + nbytes > limit and not (
                wait and self._queued_bytes == 0
            ):
                return True, self._queued_bytes, limit
            if ts.queued_bytes + nbytes > tenant_limit and not (
                wait and ts.queued_bytes == 0
            ):
                return True, ts.queued_bytes, tenant_limit
            return False, 0, 0

        while True:
            if self._closing:
                ts.shed += 1
                self._shed_total += 1
                raise SchedRejected("scheduler shutting down", ts.name)
            is_over, got, limit = over()
            if not is_over:
                return
            if not wait:
                ts.shed += 1
                self._shed_total += 1
                raise SchedRejected("queue full", ts.name, got, limit)
            # blocking backpressure: wait for the next byte release.
            # clear-then-recheck so a release between over() and wait()
            # can't be lost.
            self._space.clear()
            is_over, _, _ = over()
            if not is_over:
                return
            await self._space.wait()

    # --------------------------------------------------------- assembler

    async def _lane_loop(self, lane: _Lane) -> None:
        cfg = self.config
        while True:
            if lane.pending_pieces == 0:
                if self._closing:
                    return
                lane.event.clear()
                if lane.pending_pieces == 0 and not self._closing:
                    await lane.event.wait()
                continue
            # oldest queued item bounds the wait: flush at target fill
            # or when its deadline expires, whichever comes first (the
            # autopilot may have set a per-lane deadline override)
            flush_after = (
                lane.deadline if lane.deadline is not None else cfg.flush_deadline
            )
            deadline = lane.oldest_ts() + flush_after
            while lane.pending_pieces < lane.target and not self._closing:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                lane.event.clear()
                if lane.pending_pieces >= lane.target or self._closing:
                    break
                try:
                    await asyncio.wait_for(lane.event.wait(), remaining)
                except asyncio.TimeoutError:
                    break
            tickets = self._drr_take(lane)
            if not tickets:
                continue
            reason = (
                "full"
                if len(tickets) >= lane.target
                else ("shutdown" if self._closing else "deadline")
            )
            # pipelined launch: the semaphore bounds in-flight launches
            # (depth 2 = double-buffer) while this loop keeps assembling
            # the next batch during the device run — the host/device
            # overlap the old stream gate had
            await lane.sem.acquire()
            task = asyncio.ensure_future(self._launch(lane, tickets, reason))
            lane.inflight.add(task)
            task.add_done_callback(lambda t, lane=lane: self._launch_done(lane, t))

    def _launch_done(self, lane: _Lane, task: asyncio.Task) -> None:
        lane.inflight.discard(task)
        lane.sem.release()
        if not task.cancelled() and task.exception() is not None:
            # _launch resolves caller futures on every path, so an escape
            # here is a bug — log it rather than dropping it silently
            log.error("sched launch task error: %r", task.exception())

    def _drr_take(self, lane: _Lane) -> list[_Ticket]:
        """Deficit round-robin over queued bytes, up to the lane target."""
        cfg = self.config
        taken: list[_Ticket] = []
        target = lane.target
        while len(taken) < target:
            active = [n for n in lane.rotation if lane.queues.get(n)]
            if not active:
                break
            for name in active:
                q = lane.queues[name]
                t = self._tenants[name]
                t.deficit += max(1, int(cfg.drr_quantum * t.weight))
                while q and len(taken) < target and t.deficit >= q[0].nbytes:
                    tkt = q.popleft()
                    t.deficit -= tkt.nbytes
                    lane.pending_pieces -= 1
                    taken.append(tkt)
                if not q:
                    t.deficit = 0  # classic DRR: no credit hoarding
                if len(taken) >= target:
                    break
        # rotate so the same tenant doesn't always lead the next pass
        if lane.rotation:
            lane.rotation.append(lane.rotation.pop(0))
        return taken

    # ------------------------------------------------------------ launch

    def _build_plane(self, lane: _Lane):
        cfg = self.config
        if lane.backend == "cpu" and self.hasher != "cpu":
            # controller-steered degradation (steer_lane_backend, never
            # on a card): like the breaker's CPU fallback, this bypasses
            # plane_factory — hashlib is the parity floor, not a
            # wrappable device plane
            return _CpuPlane(lane.algo)
        if cfg.plane_factory is not None:
            return cfg.plane_factory(lane.algo, lane.bucket, lane.target)
        return build_builtin_plane(
            self.hasher, lane.algo, lane.bucket, lane.target,
            device=self.device, mesh=self.mesh,
        )

    def _run_plane(
        self, lane: _Lane, payloads: list[bytes], obs_note: dict | None = None
    ) -> list[bytes]:
        """Worker-thread body: build the plane on first use (kernel build
        and load, staging and stream allocation run off the event loop)
        and execute the launch under a profiler region so batches are
        attributable in the timeline.

        The lane breaker gates the primary plane: while it is open, only
        a half-open probe touches the primary. The launches it refuses
        raise :class:`_BreakerOpen` on a card (the tickets fail; nothing
        leaves the kernels) and degrade to the hashlib CPU plane
        elsewhere (correct, slower). Transient
        primary failures feed the breaker; deterministic payload errors
        do not (the device is answering — the payload is the problem).

        ``obs_note`` carries per-launch observability facts back to the
        dispatching coroutine (plane used, breaker-open transition) —
        the flight-recorder trigger and launch-span attrs live THERE so
        no obs lock is ever taken under breaker or counter locks.
        """
        if obs_note is None:
            obs_note = {}
        if not lane.breaker.acquire_primary():
            if self._on_card():
                raise _BreakerOpen(
                    f"lane {lane.algo}/{lane.bucket}: breaker "
                    f"{lane.breaker.snapshot()['state']}, launch refused"
                )
            if lane.cpu_plane is None:  # benign to race: planes are stateless
                lane.cpu_plane = _CpuPlane(lane.algo)
            with self._counter_lock:  # worker threads across lanes race this
                self._counter_cells.write("fault_counters")
                self._cpu_fallback_launches += 1
            obs_note["plane"] = "cpu_fallback"
            return lane.cpu_plane.run(payloads)
        if lane.plane is None:
            # pipelined launches reach here from concurrent worker
            # threads; double-checked lock so the plane compiles once
            with lane.build_lock:
                if lane.plane is None:
                    try:
                        lane.plane = self._build_plane(lane)
                    except Exception as e:
                        # same classification as the launch path: a
                        # deterministic build error (factory misconfig)
                        # must not masquerade as device flakiness
                        if classify_error(e) == "transient":
                            if lane.breaker.record_failure():
                                obs_note["breaker_opened"] = True
                        else:
                            lane.breaker.release_probe()
                        raise
        # pad-row waste: rows this launch stages beyond the live batch
        # (zero on the port's row-exact planes and the hashlib
        # degradation path, which stages nothing). The
        # built plane's own launch_geometry hook is authoritative — a
        # plane_factory plane (faults seam) may stage differently than
        # the lane plan assumed; one exposing no hook is taken as
        # row-exact (FaultyPlane's hook-less default agrees). Charged
        # per actual attempt (retries and bisection halves each
        # re-stage), under the counter lock: worker threads run this.
        hook = getattr(lane.plane, "launch_geometry", None)
        if hook is not None:
            pad = hook(len(payloads), lane.bucket)[0] - len(payloads)
            if pad:
                with self._counter_lock:
                    self._counter_cells.write("fault_counters")
                    lane.pad_rows_total += pad
        # zero-copy launch form: when every ticket is a SlotRow of ONE
        # pre-staged slab and the plane can consume it in place, skip
        # the stage copy entirely (mixed batches — several slabs, or
        # slab rows interleaved with byte payloads — take the copying
        # run path, which stages SlotRow views like any other payload)
        staged = _staged_batch(payloads)
        run_staged = (
            getattr(lane.plane, "run_staged", None) if staged else None
        )
        if run_staged is not None:
            obs_note["staged"] = True
        try:
            if self.hasher == "cpu":
                if run_staged is not None:
                    digests = run_staged(*staged)
                else:
                    digests = lane.plane.run(payloads)
            else:
                from torrent_tpu_torch.obs.profiler import maybe_profile_batch

                with maybe_profile_batch(f"sched_{lane.algo}_launch_b{lane.bucket}"):
                    if run_staged is not None:
                        digests = run_staged(*staged)
                    else:
                        digests = lane.plane.run(payloads)
            # contract check BEFORE record_success: a plane persistently
            # returning the wrong count must feed the breaker (and trip
            # to the CPU plane) instead of resetting it every launch
            if len(digests) != len(payloads):
                raise RuntimeError(
                    f"plane returned {len(digests)} digests for {len(payloads)} pieces"
                )
        except Exception as e:
            if classify_error(e) == "transient":
                if lane.breaker.record_failure():
                    obs_note["breaker_opened"] = True
            else:
                lane.breaker.release_probe()
            raise
        lane.breaker.record_success()
        return digests

    @staticmethod
    def _traced_subs(tickets: list[_Ticket]) -> dict[int, tuple[_Submission, float]]:
        """Distinct traced submissions in a batch with their oldest
        ticket timestamp (one obs span per submission, not per ticket)."""
        out: dict[int, tuple[_Submission, float]] = {}
        for t in tickets:
            if t.sub.trace is None:
                continue
            prev = out.get(id(t.sub))
            if prev is None or t.ts < prev[1]:
                out[id(t.sub)] = (t.sub, t.ts)
        return out

    async def _launch(self, lane: _Lane, tickets: list[_Ticket], reason: str) -> None:
        n = len(tickets)
        fill = n / lane.target
        self._launches += 1
        self._fill_sum += fill
        self._flush_reasons[reason] += 1
        lane.launches += 1
        lane.fill_sum += fill
        lane_name = f"{lane.algo}/{lane.bucket}"
        t_take = time.monotonic()
        # one lock acquisition for the whole launch's queue waits
        histograms().get(*_H_QUEUE_WAIT, lane=lane_name).observe_batch(
            [t_take - t.ts for t in tickets]
        )
        for sub, ts0 in self._traced_subs(tickets).values():
            tracer().add_span(
                sub.trace[0], "sched.lane_wait", parent_id=sub.trace[1],
                t0=ts0, t1=t_take, lane=lane_name, flush=reason, rows=n,
            )
        await self._dispatch(lane, tickets, depth=0)

    async def _dispatch(self, lane: _Lane, tickets: list[_Ticket], depth: int) -> None:
        """Run one (sub-)batch with failure-domain isolation: retry a
        transient failure once, then bisect so a poisoned ticket fails
        alone while innocent co-batched tenants still get digests. Every
        relaunch re-selects the plane, so a breaker that trips mid-
        bisection routes the surviving halves through the CPU plane —
        or, on a card, fails them at once (:class:`_BreakerOpen`)."""
        cfg = self.config
        payloads = [t.payload for t in tickets]
        lane_name = f"{lane.algo}/{lane.bucket}"
        attempts = 0
        while True:
            obs_note: dict = {}
            t0 = time.monotonic()
            try:
                # digest-count contract is checked inside _run_plane, so
                # a persistent violation feeds the breaker there
                digests = await asyncio.to_thread(
                    self._run_plane, lane, payloads, obs_note
                )
            except Exception as e:  # a poisoned launch must not wedge the lane
                t1 = time.monotonic()
                histograms().get(*_H_LAUNCH, lane=lane_name).observe(t1 - t0)
                self._launch_failures += 1
                kind = classify_error(e)
                log.warning(
                    "sched launch failed (%s/%d, %d pieces, depth %d, %s): %s",
                    lane.algo, lane.bucket, len(tickets), depth, kind, e,
                )
                self._obs_launch_spans(
                    tickets, lane_name, t0, t1, depth, attempts, obs_note,
                    status="error", error=e,
                )
                if obs_note.get("breaker_opened"):
                    # black box BEFORE the state evaporates: the dump
                    # carries the breaker snapshot plus the failing
                    # tickets' span trees
                    flight_recorder().trigger(
                        "breaker_open",
                        detail={"lane": lane_name, "kind": kind,
                                "error": str(e)},
                        trace_ids=self._trace_ids(tickets),
                        snapshots={"sched": self.metrics_snapshot()},
                    )
                refused = isinstance(e, _BreakerOpen)
                if not refused and kind == "transient" and attempts < cfg.launch_retries:
                    attempts += 1
                    self._retries += 1
                    continue
                if not refused and len(tickets) > 1 and depth < cfg.bisect_depth:
                    self._bisections += 1
                    mid = len(tickets) // 2
                    await self._dispatch(lane, tickets[:mid], depth + 1)
                    await self._dispatch(lane, tickets[mid:], depth + 1)
                    return
                self._failed_pieces += len(tickets)
                err = SchedLaunchError(
                    f"hash launch failed ({kind}, {len(tickets)} pieces, "
                    f"{attempts} retries): {e}",
                    kind,
                    e,
                )
                self._demux(tickets, None, error=err)
                flight_recorder().trigger(
                    "retry_exhausted",
                    detail={"lane": lane_name, "kind": kind,
                            "pieces": len(tickets), "depth": depth,
                            "retries": attempts, "error": str(e)},
                    trace_ids=self._trace_ids(tickets),
                    snapshots={"sched": self.metrics_snapshot()},
                )
                return
            t1 = time.monotonic()
            histograms().get(*_H_LAUNCH, lane=lane_name).observe(t1 - t0)
            self._obs_launch_spans(
                tickets, lane_name, t0, t1, depth, attempts, obs_note,
                status="ok",
            )
            self._demux(tickets, digests)
            return

    @staticmethod
    def _trace_ids(tickets: list[_Ticket]) -> list[str]:
        out: list[str] = []
        for t in tickets:
            if t.sub.trace is not None and t.sub.trace[0] not in out:
                out.append(t.sub.trace[0])
        return out

    def _obs_launch_spans(
        self, tickets, lane_name, t0, t1, depth, attempt, note, status,
        error=None,
    ) -> None:
        """One sched.launch span per traced submission in the batch
        (retry attempts and bisection halves each record their own,
        distinguished by the attempt/depth attrs)."""
        subs = self._traced_subs(tickets)
        if not subs:
            return
        attrs = {"lane": lane_name, "rows": len(tickets), "depth": depth,
                 "attempt": attempt}
        if note.get("plane") == "cpu_fallback":
            attrs["plane"] = "cpu_fallback"
        if note.get("staged"):
            attrs["staged"] = True
        if note.get("breaker_opened"):
            attrs["breaker_opened"] = True
        if error is not None:
            attrs["error"] = str(error)
            attrs["kind"] = classify_error(error)
        for sub, _ts0 in subs.values():
            tracer().add_span(
                sub.trace[0], "sched.launch", parent_id=sub.trace[1],
                t0=t0, t1=t1, status=status, **attrs,
            )

    def _demux(self, tickets: list[_Ticket], digests, error=None) -> None:
        """Per-launch result demux back to the awaiting submissions,
        releasing queue bytes (and any blocked submitters) as it goes."""
        with pipeline_ledger().track(
            "verdict", sum(t.nbytes for t in tickets)
        ):
            self._demux_inner(tickets, digests, error)

    def _demux_inner(self, tickets: list[_Ticket], digests, error=None) -> None:
        t_now = time.monotonic()
        e2e_by_tenant: dict[str, list[float]] = {}
        done_subs: dict[int, _Submission] = {}
        # slot-carrying tickets: release one slab ref per ticket AFTER
        # delivery (batched per slab; the slot returns to its pool when
        # the last ref drops) — on the error path too, so a launch that
        # outlives retry/bisection can never leak a staging slot
        slab_refs: dict[int, tuple[StagedSlab, int]] = {}
        for i, tkt in enumerate(tickets):
            if type(tkt.payload) is SlotRow:
                slab = tkt.payload.slab
                prev = slab_refs.get(id(slab))
                slab_refs[id(slab)] = (slab, 1 if prev is None else prev[1] + 1)
        for i, tkt in enumerate(tickets):
            # the tenant may have been pruned while a zero-byte ticket was
            # in flight — global accounting and delivery must still happen
            t = self._tenants.get(tkt.tenant)
            if t is not None:
                t.queued_bytes -= tkt.charged
            self._queued_bytes -= tkt.charged
            e2e_by_tenant.setdefault(tkt.tenant, []).append(t_now - tkt.ts)
            if error is not None:
                if not tkt.sub.future.done():
                    tkt.sub.future.set_exception(error)
                if tkt.sub.trace is not None:
                    done_subs.setdefault(id(tkt.sub), tkt.sub)
                continue
            if t is not None:
                t.served_bytes += tkt.nbytes
                t.served_pieces += 1
            d = digests[i]
            if tkt.sub.mode == "verify":
                tkt.sub.deliver(tkt.idx, 1 if d == tkt.expected else 0)
            else:
                tkt.sub.deliver(tkt.idx, d)
            if tkt.sub.trace is not None and tkt.sub.remaining == 0:
                done_subs.setdefault(id(tkt.sub), tkt.sub)
        for slab, n in slab_refs.values():
            slab.release(n)
        for tenant, vals in e2e_by_tenant.items():
            histograms().get(*_H_E2E, tenant=tenant).observe_batch(vals)
        for sub in done_subs.values():
            if sub.traced_done:
                continue
            sub.traced_done = True
            status = "error" if error is not None else "ok"
            attrs: dict = {"mode": sub.mode, "pieces": len(sub.results)}
            if error is not None:
                attrs["error"] = str(error)
            did = tracer().add_span(
                sub.trace[0], "sched.digest", parent_id=sub.trace[1],
                t0=t_now, status=status, **attrs,
            )
            if sub.mode == "verify":
                valid = sum(1 for r in sub.results if r) if error is None else 0
                tracer().add_span(
                    sub.trace[0], "sched.verdict", parent_id=did, t0=t_now,
                    status=status, valid=valid, pieces=len(sub.results),
                )
        self._space.set()  # wake admission waiters

    # ----------------------------------------------------------- metrics

    def _staging_snapshot(self) -> dict:
        # worker threads create pools under _ingest_lock; snapshot the
        # dict under it too so iteration can't race an insert
        with self._ingest_lock:
            pools = list(self._ingest_pools.values())
        # per-pool counters move under each pool's own lock (worker
        # threads mid-checkout); stats() reads them there
        stats = [p.stats()[:2] for p in pools]
        return {
            "pools": len(pools),
            "outstanding": sum(s[0] for s in stats),
            "checkouts": sum(s[1] for s in stats),
        }

    def staging_reuse(self) -> dict:
        """Stream-ordered reuse accounting over every staging pool (the
        ingest pools and the built planes' slots): ``copy_checks`` slots
        checked in after a recorded host→device copy, and
        ``early_checkins`` of those whose copy had not completed yet —
        0 when every path fetches its digests before checking a slot
        in — and the slots allocated (pinned on a GPU) with the seconds
        that took, a first-use cost no ledger stage holds. Kept out of
        :meth:`metrics_snapshot`, whose keys are the reference's."""
        with self._ingest_lock:
            pools = list(self._ingest_pools.values())
        for lane in list(self._lanes.values()):
            plane = getattr(lane.plane, "inner", lane.plane)  # FaultyPlane
            slots = getattr(plane, "_slots", None)
            if slots is not None:
                pools.append(slots)
        stats = [p.stats() for p in pools]
        return {
            "pools": len(pools),
            "outstanding": sum(s[0] for s in stats),
            "copy_checks": sum(s[2] for s in stats),
            "early_checkins": sum(s[3] for s in stats),
            "slots_allocated": sum(s[4] for s in stats),
            "alloc_s": sum(s[5] for s in stats),
        }

    def metrics_snapshot(self) -> dict:
        """Counters for utils/metrics.py's Prometheus rendering."""
        pending = sum(l.pending_pieces for l in self._lanes.values())
        # _cpu_fallback_launches and the per-lane pad counters are
        # bumped from worker threads under _counter_lock; snapshot them
        # under it too (the other fault counters are loop-confined but
        # ride along in the same brief leaf-lock scope)
        with self._counter_lock:
            self._counter_cells.read("fault_counters")
            cpu_fallback_launches = self._cpu_fallback_launches
            pad_rows = {
                key: lane.pad_rows_total for key, lane in self._lanes.items()
            }
        return {
            "queue_pieces": pending,
            "queue_bytes": self._queued_bytes,
            # autopilot admission actuator (1.0 = the static config)
            "admission_factor": self._admission_factor,
            "lanes": len(self._lanes),
            "launches": self._launches,
            "fill_sum": self._fill_sum,
            "mean_fill": (self._fill_sum / self._launches) if self._launches else 0.0,
            "flush_reasons": dict(self._flush_reasons),
            "shed_total": self._shed_total,
            "launch_failures": self._launch_failures,
            "retries": self._retries,
            "bisections": self._bisections,
            "cpu_fallback_launches": cpu_fallback_launches,
            "failed_pieces": self._failed_pieces,
            "breakers": {
                f"{algo}/{bucket}": lane.breaker.snapshot()
                for (algo, bucket), lane in self._lanes.items()
            },
            # per-lane launch-fill and pad-row waste (the port's planes
            # are row-exact, so pad_rows_total stays 0 unless a
            # plane_factory plane stages in granules)
            "lane_stats": {
                f"{algo}/{bucket}": {
                    "backend": lane.backend,
                    "target": lane.target,
                    "deadline": (
                        lane.deadline
                        if lane.deadline is not None
                        else self.config.flush_deadline
                    ),
                    "launches": lane.launches,
                    "mean_fill": (
                        lane.fill_sum / lane.launches if lane.launches else 0.0
                    ),
                    "pad_rows_total": pad_rows.get((algo, bucket), 0),
                }
                for (algo, bucket), lane in self._lanes.items()
            },
            # zero-copy ingest pools: outstanding must return to 0 when
            # no read/launch is in flight (slab-leak test + ops gauge)
            "staging": self._staging_snapshot(),
            "evicted": dict(self._evicted),
            "tenants": {
                name: {
                    "queued_bytes": t.queued_bytes,
                    "served_bytes": t.served_bytes,
                    "served_pieces": t.served_pieces,
                    "shed": t.shed,
                    "weight": t.weight,
                }
                for name, t in self._tenants.items()
            },
        }
