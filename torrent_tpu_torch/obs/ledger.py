"""Always-on pipeline ledger: per-stage byte/time/occupancy accounting.

A fast hash plane can sit inside a slow end-to-end recheck, and without
a ledger the gap (host→device transfer, say) is found only by a human
reconstructing it from bench logs. The ledger makes that attribution
continuous and machine-readable: every stage boundary of the verify
pipeline

    recv → read → stage → h2d → launch → digest → verdict

records monotonic busy-seconds, payload bytes, and occupancy into a
bounded process-global table, and ``obs/attrib.py`` turns any two
snapshots into a bottleneck verdict ("h2d is 96% of pipeline wall
time, 24.9 MiB/s achieved vs 2.1 GiB/s demanded"). Surfaced as
``GET /v1/pipeline``, ``torrent_tpu_pipeline_*`` Prometheus series on
both ``/metrics`` endpoints, ``doctor --bottleneck``, ``torrent-tpu
top``, and embedded in every ``torrent-tpu bench`` record.

Stage boundaries (instrumentation sites):

* ``recv``    — the live-swarm wire stage AHEAD of ``read``: seconds a
  peer loop spent blocked on the socket while requests were in flight
  (plus download-cap pacing waits) and the payload bytes of downloaded
  blocks as they land in the piece-assembly buffers
  (``session/torrent.py``). When the network is the limiting resource,
  this stage owns the wall and ``doctor --bottleneck`` / ``torrent-tpu
  replay`` can finally say so instead of blaming disk.
* ``read``    — storage reads: ``parallel/verify.read_pieces_chunk``
  (byte-path chunks + the fabric sentinel re-hash), one entry a
  ``Storage.read_batch`` call (its zero-fill, segment planning, and the
  native pread pool or the pure-Python walk), and one a
  ``NativeIOEngine.read_segments`` call (the v2 authoring stream); no
  row is charged twice, and a wait for the engine's lock is left out.
* ``stage``   — the staging-slot copy (``sched._StagingSlots.stage``).
  ZERO bytes on the zero-copy ingest path: ``read_pieces_into`` lands
  reads directly in the launch slab, so this stage only records for
  byte-path and mixed-slab launches. On the direct recheck paths, the
  padding of a loaded batch (v1, on the loader thread) and the leaf
  staging (v2).
* ``h2d``     — host→device transfer: the explicit device put on every
  device plane (sha1 included — the zero-copy refactor split its
  previously fused ``digest_batch`` span); ``sched/faults.py``'s
  ``latency_ms`` hook also accounts here (it models a slow
  interconnect), which is what makes bottleneck attribution
  deterministically testable on CPU.
* ``launch``  — the device (or hashlib) hash execution.
* ``digest``  — D2H fetch + digest-word conversion.
* ``verdict`` — the scheduler's per-launch demux back to submitters.

The ledger also integrates cross-stage occupancy overlap — wall
seconds with ≥2 distinct stages simultaneously busy and the
max-concurrent-stages high-water mark — the series that makes
double-buffered ingest (read while h2d while launch) visible.

Design constraints, same as ``obs/hist.py``: scalar-only counters,
bounded cardinality (the six pipeline stages plus a capped overflow of
unknown names folded into ``other``), one :func:`named_lock` that is a
leaf of the lock-order graph and is NEVER held across the timed body —
``track()`` acquires it briefly at stage entry and exit only, so no
device call ever runs under an obs lock.
"""

from __future__ import annotations

import time

from torrent_tpu_torch.utils.locks import guard_attrs, named_lock
from torrent_tpu_torch.utils.metrics import _esc

__all__ = [
    "PIPELINE_STAGES",
    "PipelineLedger",
    "pipeline_ledger",
    "render_pipeline_metrics",
]

# the canonical stage order (pipeline position, used by renderers).
# "egress" is the serving direction — blocks leaving through the seeder
# plane — appended after the verify chain so download attribution
# reports keep their familiar shape.
PIPELINE_STAGES = ("recv", "read", "stage", "h2d", "launch", "digest", "verdict", "egress")

# unknown stage names fold into "other" past this bound — the ledger's
# cardinality must stay fixed no matter what a plane_factory plane does
MAX_STAGES = 16


class _Tracked:
    """One in-flight stage entry: ``with ledger.track("read") as t:``.

    Bytes may be declared up front (``nbytes=``) or accumulated as the
    stage discovers them (``t.add(n)`` — the read loop knows its byte
    count only piece by piece). A wait inside the body that is not the
    stage's own work (for a lock another entry holds) is left out of its
    busy seconds with ``t.add(0, wait_s)``. While a ``torch.profiler``
    runs, the entry is also a ``pipeline.<stage>`` region of its
    timeline (``obs/profiler.py::annotate``); otherwise that costs one
    flag read. The ledger lock is taken briefly at enter and exit; the
    tracked body runs entirely outside it.
    """

    __slots__ = ("_ledger", "stage", "nbytes", "_t0", "_wait_s", "_region")

    def __init__(self, ledger: "PipelineLedger", stage: str, nbytes: int):
        self._ledger = ledger
        self.stage = stage
        self.nbytes = nbytes
        self._t0 = 0.0
        self._wait_s = 0.0
        self._region = None

    def add(self, nbytes: int, wait_s: float = 0.0) -> None:
        self.nbytes += nbytes
        self._wait_s += wait_s

    def __enter__(self) -> "_Tracked":
        if self._ledger._profiling():
            self._region = self._ledger._annotate(f"pipeline.{self.stage}")
            self._region.__enter__()
        self._t0 = time.monotonic()
        self._ledger._enter(self.stage, self._t0)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.monotonic()
        self._ledger._exit(self.stage, self.nbytes, t1 - self._t0 - self._wait_s, t1)
        if self._region is not None:
            self._region.__exit__(exc_type, exc, tb)
            self._region = None


class _Stage:
    __slots__ = ("busy_s", "bytes", "ops", "active", "max_active")

    def __init__(self):
        self.busy_s = 0.0
        self.bytes = 0
        self.ops = 0
        self.active = 0
        self.max_active = 0


class PipelineLedger:
    """Bounded per-process stage table. One global instance
    (:func:`pipeline_ledger`) serves the scheduler, planes, read paths,
    and fabric; tests may construct private ones."""

    def __init__(self):
        from torrent_tpu_torch.obs.profiler import annotate, profiling

        # every stage entry is a named region of a running profiler's timeline
        self._annotate, self._profiling = annotate, profiling
        self._lock = named_lock("obs.ledger._lock")
        # dynamic lockset checking: the stage table + overlap integrator
        # is one cell guarded by _lock (stage entries arrive from worker
        # threads, the loop, and metrics scrapers concurrently)
        self._cells = guard_attrs("obs.ledger", "stages")
        self._stages: dict[str, _Stage] = {}
        # monotonic extent of recorded activity — the attribution wall
        self._t_first: float | None = None
        self._t_last: float | None = None
        # cross-stage overlap: how many DISTINCT stages are occupied at
        # once. Double-buffered ingest is only proven when read, h2d and
        # launch are simultaneously busy — per-stage max_active can't
        # show that, so the ledger integrates it here: seconds with ≥2
        # stages concurrently active, plus the high-water stage count.
        self._stages_active = 0  # stages with active > 0 right now
        self._overlap_t0: float | None = None  # when ≥2 became true
        self._overlap_s = 0.0
        self._max_concurrent_stages = 0

    # ------------------------------------------------------------ record

    def track(self, stage: str, nbytes: int = 0) -> _Tracked:
        """Context manager timing one stage entry (occupancy-aware)."""
        return _Tracked(self, stage, nbytes)

    def record(self, stage: str, nbytes: int, seconds: float) -> None:
        """Post-hoc accounting for a stage whose duration was measured
        by the caller (no occupancy window)."""
        now = time.monotonic()
        with self._lock:
            self._cells.write("stages")
            s = self._stage_locked(stage)
            s.busy_s += max(0.0, seconds)
            s.bytes += nbytes
            s.ops += 1
            self._touch_locked(now - max(0.0, seconds))
            self._touch_locked(now)

    def _stage_locked(self, stage: str) -> _Stage:
        s = self._stages.get(stage)
        if s is None:
            if stage not in PIPELINE_STAGES and len(self._stages) >= MAX_STAGES:
                return self._stages.setdefault("other", _Stage())
            s = self._stages[stage] = _Stage()
        return s

    def _touch_locked(self, t: float) -> None:
        if self._t_first is None or t < self._t_first:
            self._t_first = t
        if self._t_last is None or t > self._t_last:
            self._t_last = t

    def _enter(self, stage: str, t0: float) -> None:
        with self._lock:
            self._cells.write("stages")
            s = self._stage_locked(stage)
            s.active += 1
            if s.active > s.max_active:
                s.max_active = s.active
            if s.active == 1:
                self._stages_active += 1
                if self._stages_active > self._max_concurrent_stages:
                    self._max_concurrent_stages = self._stages_active
                if self._stages_active == 2:
                    self._overlap_t0 = t0
            self._touch_locked(t0)

    def _exit(self, stage: str, nbytes: int, dt: float, t1: float) -> None:
        with self._lock:
            self._cells.write("stages")
            s = self._stage_locked(stage)
            s.active -= 1
            s.busy_s += max(0.0, dt)
            s.bytes += nbytes
            s.ops += 1
            if s.active == 0:
                self._stages_active -= 1
                if self._stages_active == 1 and self._overlap_t0 is not None:
                    self._overlap_s += max(0.0, t1 - self._overlap_t0)
                    self._overlap_t0 = None
            self._touch_locked(t1)

    # ---------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        """Scalar-only copy for attribution, ``/v1/pipeline``, and the
        Prometheus renderer. ``t_first``/``t_last`` are monotonic (never
        wall clock): meaningful only as a difference. ``t_snap`` is the
        snapshot's own monotonic timestamp — delta attribution anchors
        its wall interval there, so idle time BEFORE the snapshot (a
        previous run's tail, setup work) never dilutes the next
        interval's utilization."""
        with self._lock:
            self._cells.read("stages")
            now = time.monotonic()
            overlap_s = self._overlap_s
            if self._overlap_t0 is not None:  # an overlap window is open
                overlap_s += max(0.0, now - self._overlap_t0)
            return {
                "t_first": self._t_first,
                "t_last": self._t_last,
                "t_snap": now,
                "overlap": {
                    "busy_s": overlap_s,
                    "concurrent_stages": self._stages_active,
                    "max_concurrent_stages": self._max_concurrent_stages,
                },
                "stages": {
                    name: {
                        "busy_s": s.busy_s,
                        "bytes": s.bytes,
                        "ops": s.ops,
                        "active": s.active,
                        "max_active": s.max_active,
                    }
                    for name, s in self._stages.items()
                },
            }

    def clear(self) -> None:
        with self._lock:
            self._cells.write("stages")
            self._stages.clear()
            self._t_first = None
            self._t_last = None
            self._stages_active = 0
            self._overlap_t0 = None
            self._overlap_s = 0.0
            self._max_concurrent_stages = 0


def _stage_order(names) -> list[str]:
    """Canonical pipeline order first, unknown stages after (sorted)."""
    known = [s for s in PIPELINE_STAGES if s in names]
    return known + sorted(n for n in names if n not in PIPELINE_STAGES)


def render_pipeline_metrics(ledger: PipelineLedger | None = None) -> str:
    """Prometheus text for the ledger: raw per-stage counters plus the
    attributor's utilization/bottleneck verdict. Appended to both
    ``/metrics`` endpoints via ``obs.render_obs_metrics``. Defensive:
    a fresh (empty) ledger renders headers with no samples."""
    from torrent_tpu_torch.obs.attrib import attribute

    snap = (ledger or pipeline_ledger()).snapshot()
    rep = attribute(snap)
    stages = _stage_order(snap["stages"])
    lines = [
        "# HELP torrent_tpu_pipeline_stage_busy_seconds_total Seconds this pipeline stage was occupied",
        "# TYPE torrent_tpu_pipeline_stage_busy_seconds_total counter",
    ]
    for name in stages:
        lines.append(
            f'torrent_tpu_pipeline_stage_busy_seconds_total{{stage="{_esc(name)}"}} '
            f"{snap['stages'][name]['busy_s']:.6f}"
        )
    lines.append(
        "# HELP torrent_tpu_pipeline_stage_bytes_total Payload bytes that flowed through this stage"
    )
    lines.append("# TYPE torrent_tpu_pipeline_stage_bytes_total counter")
    for name in stages:
        lines.append(
            f'torrent_tpu_pipeline_stage_bytes_total{{stage="{_esc(name)}"}} '
            f"{snap['stages'][name]['bytes']}"
        )
    lines.append(
        "# HELP torrent_tpu_pipeline_stage_ops_total Stage entries (launches, reads, demuxes)"
    )
    lines.append("# TYPE torrent_tpu_pipeline_stage_ops_total counter")
    for name in stages:
        lines.append(
            f'torrent_tpu_pipeline_stage_ops_total{{stage="{_esc(name)}"}} '
            f"{snap['stages'][name]['ops']}"
        )
    lines.append(
        "# HELP torrent_tpu_pipeline_stage_active Concurrent entries currently inside this stage"
    )
    lines.append("# TYPE torrent_tpu_pipeline_stage_active gauge")
    for name in stages:
        lines.append(
            f'torrent_tpu_pipeline_stage_active{{stage="{_esc(name)}"}} '
            f"{snap['stages'][name]['active']}"
        )
    lines.append(
        "# HELP torrent_tpu_pipeline_stage_max_active High-water concurrent entries observed inside this stage"
    )
    lines.append("# TYPE torrent_tpu_pipeline_stage_max_active gauge")
    for name in stages:
        lines.append(
            f'torrent_tpu_pipeline_stage_max_active{{stage="{_esc(name)}"}} '
            f"{snap['stages'][name]['max_active']}"
        )
    lines.append(
        "# HELP torrent_tpu_pipeline_stage_utilization Stage busy-seconds per pipeline wall second "
        "(can exceed 1 with overlapped launches)"
    )
    lines.append("# TYPE torrent_tpu_pipeline_stage_utilization gauge")
    for name in stages:
        st = rep["stages"].get(name, {})
        lines.append(
            f'torrent_tpu_pipeline_stage_utilization{{stage="{_esc(name)}"}} '
            f"{st.get('utilization', 0.0):.6f}"
        )
    # the bottleneck verdict as a labeled 0/1 enum family (alert on the
    # stage whose series is 1)
    bn = (rep.get("bottleneck") or {}).get("stage")
    lines.append(
        "# HELP torrent_tpu_pipeline_bottleneck Limiting stage per the attributor (1 = current bottleneck)"
    )
    lines.append("# TYPE torrent_tpu_pipeline_bottleneck gauge")
    for name in stages:
        lines.append(
            f'torrent_tpu_pipeline_bottleneck{{stage="{_esc(name)}"}} '
            f"{1 if name == bn else 0}"
        )
    # cross-stage occupancy overlap: the double-buffering proof series
    # (read while h2d while launch shows up as overlap seconds plus a
    # max-concurrent-stages high-water mark)
    ov = snap.get("overlap") or {}
    lines += [
        "# HELP torrent_tpu_pipeline_overlap_seconds_total Seconds with two or more pipeline stages concurrently occupied",
        "# TYPE torrent_tpu_pipeline_overlap_seconds_total counter",
        f"torrent_tpu_pipeline_overlap_seconds_total {ov.get('busy_s', 0.0):.6f}",
        "# HELP torrent_tpu_pipeline_concurrent_stages Distinct pipeline stages currently occupied",
        "# TYPE torrent_tpu_pipeline_concurrent_stages gauge",
        f"torrent_tpu_pipeline_concurrent_stages {ov.get('concurrent_stages', 0)}",
        "# HELP torrent_tpu_pipeline_concurrent_stages_max High-water distinct pipeline stages concurrently occupied",
        "# TYPE torrent_tpu_pipeline_concurrent_stages_max gauge",
        f"torrent_tpu_pipeline_concurrent_stages_max {ov.get('max_concurrent_stages', 0)}",
        "# HELP torrent_tpu_pipeline_wall_seconds Monotonic extent of recorded pipeline activity",
        "# TYPE torrent_tpu_pipeline_wall_seconds gauge",
        f"torrent_tpu_pipeline_wall_seconds {rep.get('wall_s', 0.0):.6f}",
    ]
    return "\n".join(lines) + "\n"


_ledger = None
# construction guard: unlike the request-driven tracer/histogram
# singletons, first ledger use can race between a scheduler worker
# thread and the serving loop — a lost construction would silently drop
# one side's stage records
_ledger_guard = named_lock("obs.ledger._guard")


def pipeline_ledger() -> PipelineLedger:
    """The process-wide pipeline ledger (constructed on first use, so
    TSAN enabling in conftest instruments its lock)."""
    global _ledger
    if _ledger is None:
        with _ledger_guard:
            if _ledger is None:
                _ledger = PipelineLedger()
    return _ledger
