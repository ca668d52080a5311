"""Fleet observability: heartbeat-carried obs digests and the swarm
rollup.

The obs plane gives every process deep self-observability (ledger, histograms,
attribution) — but ``/v1/fabric/status`` is local-process only, so
diagnosing a 4-process run meant tailing N ``/metrics`` endpoints by
hand. This module lifts the per-process plane one level up:

* :func:`obs_digest` — a compact, bounded, deterministic summary of ONE
  process's observability state: pipeline-ledger stage deltas since the
  sweep started, mergeable latency-histogram summaries (fixed log2
  buckets, so peers sum them bucket-for-bucket), a scheduler summary
  (breaker states, shed/fault counters, lane fill), and fabric unit
  progress. Carried as the ``"obs"`` field of every fabric heartbeat —
  both transports — and budgeted into ``plan_payload_bytes`` via
  :data:`DIGEST_MAX_BYTES`. Built only from monotonic/counter state:
  the builders sit in the analysis plane's determinism pass exactly
  like ``heartbeat_span_context``.
* :func:`aggregate_fleet` — merges peer digests into a swarm-wide
  rollup with **two-level bottleneck attribution**: the limiting
  process (the one whose recorded activity spans the longest wall —
  the straggler that defines when the fleet finishes), then THAT
  process's limiting stage via ``obs/attrib.attribute`` — "process 0
  limits the fleet, and h2d limits process 0". Plus the **straggler
  scoreboard**: per-pid achieved B/s vs the fleet median, lapse/
  degraded/distrusted status, and adoption debt (units a survivor must
  pick up).
* :class:`FleetObsServer` — a tiny HTTP surface (``GET /v1/fleet`` +
  ``GET /metrics``) any fabric worker can expose
  (``fabric-verify --obs-port``), so ``torrent-tpu top --fleet`` and
  ``doctor --fleet`` can watch a peer's view of the swarm live. The
  bridge serves the same ``/v1/fleet`` route itself.

Size/cardinality budget: a digest is clamped to
:data:`DIGEST_MAX_BYTES` (drop order: histogram summaries, scheduler
summary, stage table — unit progress survives longest), breaker lanes
are capped at :data:`MAX_DIGEST_BREAKER_LANES`, and the Prometheus
rendering (``utils/metrics.render_fleet_metrics``) caps per-pid series.
Everything here is pure functions over plain dicts — no locks, safe on
any serving loop; the only state is what callers pass in.
"""

from __future__ import annotations

import json

from torrent_tpu_torch.obs.attrib import _delta, attribute
from torrent_tpu_torch.obs.hist import histograms
from torrent_tpu_torch.obs.ledger import pipeline_ledger

__all__ = [
    "DIGEST_MAX_BYTES",
    "DIGEST_VERSION",
    "FleetObsServer",
    "aggregate_fleet",
    "build_obs_digest",
    "clamp_digest",
    "digest_bytes",
    "local_fleet_snapshot",
    "obs_digest",
]

DIGEST_VERSION = 1
# worst-case wire size of one digest (json, default separators) — the
# term plan_payload_bytes budgets into the allgather buffer, and the
# bound clamp_digest enforces
DIGEST_MAX_BYTES = 2048
# breaker lanes named individually in a digest; the rest fold into a
# single open-lane count so a lane-happy plane can't grow the payload
MAX_DIGEST_BREAKER_LANES = 6
# histogram families a digest summarizes: the two that attribute queue
# pressure vs device time (short key -> registry family name)
DIGEST_HIST_FAMILIES = (
    ("queue_wait", "torrent_tpu_sched_queue_wait_seconds"),
    ("launch", "torrent_tpu_sched_launch_seconds"),
)
# a reporting process under this fraction of the fleet median achieved
# rate is flagged a straggler on the scoreboard
STRAGGLER_RATIO = 0.5


# --------------------------------------------------------------- builders
# (in the analysis determinism pass's scope: no wall clock, no
# randomness, every dict iteration sorted — digest bytes ride the
# heartbeat exchange and must be bit-stable across re-runs)


# determinism-scope
def digest_bytes(digest: dict) -> int:
    """Wire size of a digest under the heartbeat's JSON encoding."""
    return len(json.dumps(digest, sort_keys=True).encode())


# determinism-scope
def _digest_stages(stages: dict) -> dict:
    out = {}
    for name in sorted(stages):
        s = stages[name]
        if not s.get("ops"):
            continue
        out[name] = {
            "busy_s": round(s.get("busy_s", 0.0), 6),
            "bytes": int(s.get("bytes", 0)),
            "ops": int(s.get("ops", 0)),
        }
    return out


# determinism-scope
def _digest_hist(hist_snaps: dict) -> dict:
    out = {}
    for short in sorted(hist_snaps):
        snap = hist_snaps[short]
        if snap is None:
            continue
        counts, count, total = snap
        if not count:
            continue
        out[short] = {
            "count": int(count),
            "sum": round(float(total), 6),
            # sparse buckets: index -> count, zeros omitted (string keys
            # so the JSON round-trip is exact)
            "buckets": {
                str(i): int(c) for i, c in enumerate(counts) if c
            },
        }
    return out


# determinism-scope
def _digest_sched(sched_snap: dict) -> dict:
    breakers = sched_snap.get("breakers") or {}
    named = {}
    extra_open = 0
    for i, lane in enumerate(sorted(breakers)):
        state = breakers[lane].get("state", "closed")
        if i < MAX_DIGEST_BREAKER_LANES:
            named[lane] = state
        elif state != "closed":
            extra_open += 1
    out = {
        "launches": int(sched_snap.get("launches", 0)),
        "mean_fill": round(float(sched_snap.get("mean_fill", 0.0)), 4),
        "queue_bytes": int(sched_snap.get("queue_bytes", 0)),
        "shed": int(sched_snap.get("shed_total", 0)),
        "launch_failures": int(sched_snap.get("launch_failures", 0)),
        "retries": int(sched_snap.get("retries", 0)),
        "cpu_fallback": int(sched_snap.get("cpu_fallback_launches", 0)),
        "failed_pieces": int(sched_snap.get("failed_pieces", 0)),
        "breakers": named,
    }
    if extra_open:
        out["breakers_open_unnamed"] = extra_open
    return out


# determinism-scope
def build_obs_digest(
    ledger_snap: dict,
    base_snap: dict | None,
    hist_snaps: dict,
    sched_snap: dict,
    unit: dict | None = None,
    slo: dict | None = None,
) -> dict:
    """Assemble one process's obs digest from already-taken snapshots.

    ``ledger_snap``/``base_snap``: ``PipelineLedger.snapshot()`` dicts —
    the digest carries the DELTA (stage busy/bytes/ops and the wall it
    spans), so a long-lived process's earlier traffic never dilutes this
    sweep's attribution. ``hist_snaps``: short-key ->
    ``family_snapshot()`` tuple. ``sched_snap``: the scheduler's
    ``metrics_snapshot()``. ``unit``: fabric unit-progress counters.
    Clamped to :data:`DIGEST_MAX_BYTES` on the way out."""
    stages, wall = _delta(ledger_snap, base_snap)
    ov = ledger_snap.get("overlap") or {}
    bov = (base_snap or {}).get("overlap") or {}
    digest = {
        "v": DIGEST_VERSION,
        "wall_s": round(wall, 6),
        "stages": _digest_stages(stages),
        "overlap": {
            "busy_s": round(
                max(0.0, ov.get("busy_s", 0.0) - bov.get("busy_s", 0.0)), 6
            ),
            "max_concurrent_stages": int(ov.get("max_concurrent_stages", 0)),
        },
        "hist": _digest_hist(hist_snaps),
        "sched": _digest_sched(sched_snap),
        "unit": dict(sorted((unit or {}).items())),
    }
    if slo:
        # the SLO engine's compact budget-health summary (obs/slo
        # digest_summary): tiny and scalar-only, so it survives the
        # clamp alongside unit progress
        digest["slo"] = dict(sorted(slo.items()))
    return clamp_digest(digest)


# determinism-scope
def clamp_digest(digest: dict, max_bytes: int = DIGEST_MAX_BYTES) -> dict:
    """Enforce the digest size bound. Drop order is fixed — histogram
    summaries first (recoverable from /metrics), then the scheduler
    summary, then the stage table — so unit progress and the wall
    survive longest; the floor is the bare envelope."""
    d = dict(digest)
    for field in ("hist", "sched", "stages"):
        if digest_bytes(d) <= max_bytes:
            return d
        d.pop(field, None)
    if digest_bytes(d) <= max_bytes:
        return d
    return {
        "v": d.get("v", DIGEST_VERSION),
        "wall_s": d.get("wall_s", 0.0),
        "unit": d.get("unit") or {},
    }


# determinism-scope
def obs_digest(
    scheduler=None, base: dict | None = None, unit: dict | None = None
) -> dict:
    """This process's obs digest, gathered from the process-global
    ledger and histogram registry (plus ``scheduler`` when given).
    ``base``: a ledger snapshot taken when the sweep started — stage
    counters are reported as deltas against it."""
    reg = histograms()
    hist_snaps = {}
    for short, family in DIGEST_HIST_FAMILIES:
        hist_snaps[short] = reg.family_snapshot(family)
    sched_snap = scheduler.metrics_snapshot() if scheduler is not None else {}
    # worst burn-rate / breach flag from the process's armed SLO engine
    # (obs/slo): None unless objectives were explicitly configured, so
    # an unarmed run's digest bytes are byte-identical to before
    from torrent_tpu_torch.obs import slo as _slo

    engine = _slo.armed()
    return build_obs_digest(
        pipeline_ledger().snapshot(), base, hist_snaps, sched_snap, unit,
        slo=engine.summary() if engine is not None else None,
    )


# -------------------------------------------------------------- aggregate


def digest_to_snapshot(digest: dict) -> dict:
    """Reconstruct a ledger-shaped snapshot from a digest so
    ``obs/attrib.attribute`` runs unchanged on a PEER's counters: the
    digest's wall becomes the snapshot's monotonic extent."""
    wall = float(digest.get("wall_s") or 0.0)
    stages = {}
    for name, s in sorted((digest.get("stages") or {}).items()):
        stages[name] = {
            "busy_s": float(s.get("busy_s", 0.0)),
            "bytes": int(s.get("bytes", 0)),
            "ops": int(s.get("ops", 0)),
            "active": 0,
            "max_active": 0,
        }
    ov = digest.get("overlap") or {}
    return {
        "t_first": 0.0,
        "t_last": wall,
        "t_snap": wall,
        "overlap": {
            "busy_s": float(ov.get("busy_s", 0.0)),
            "concurrent_stages": 0,
            "max_concurrent_stages": int(ov.get("max_concurrent_stages", 0)),
        },
        "stages": stages,
    }


def _median(values: list[float]) -> float | None:
    if not values:
        return None
    vs = sorted(values)
    n = len(vs)
    mid = n // 2
    return vs[mid] if n % 2 else (vs[mid - 1] + vs[mid]) / 2.0


def aggregate_fleet(
    digests: dict[int, dict],
    statuses: dict[int, str] | None = None,
    planned_units: dict[int, int] | None = None,
    nproc: int | None = None,
    digest_drops: int = 0,
) -> dict:
    """Merge per-process obs digests into the swarm-wide rollup.

    Two-level bottleneck attribution: the **limiting process** is the
    one whose recorded pipeline activity spans the longest wall — the
    fleet finishes when its slowest member does, so the longest-running
    shard IS the fleet's critical path (ties break toward higher
    limiting-stage utilization, then lower pid — every key is a total
    order, so the verdict is deterministic). Its **limiting stage**
    comes from running the ledger attributor (``obs/attrib``) over that process's digest.

    The **straggler scoreboard** ranks every pid: achieved B/s vs the
    fleet median, lapse/degraded/distrusted status (from ``statuses``,
    typically the executor's heartbeat view), and adoption debt — the
    planned-but-undone units of an unavailable process that survivors
    must absorb. Pure function: trivially testable with synthetic
    digests, safe on any serving loop."""
    statuses = statuses or {}
    planned_units = planned_units or {}
    pids = sorted(set(digests) | set(statuses) | set(planned_units))
    if nproc is None:
        nproc = (max(pids) + 1) if pids else 0
    reports: dict[int, dict] = {}
    for pid in pids:
        d = digests.get(pid)
        if isinstance(d, dict):
            reports[pid] = attribute(digest_to_snapshot(d))
    rates = [
        reports[p]["pipeline_bps"]
        for p in sorted(reports)
        if reports[p]["pipeline_bps"]
    ]
    median = _median(rates)
    scoreboard = []
    totals = {
        "pieces_verified": 0,
        "units_done": 0,
        "bytes": 0,
        # Byzantine receipt plane (digest keys exist only at f > 0,
        # so these stay 0 on a trusted fabric)
        "audit_checks": 0,
        "audit_mismatches": 0,
        "convictions": 0,
    }
    for pid in sorted(set(range(nproc)) | set(pids)):
        digest = digests.get(pid) if isinstance(digests.get(pid), dict) else {}
        unit = digest.get("unit") or {}
        rep = reports.get(pid)
        status = statuses.get(pid) or ("ok" if rep is not None else "unreported")
        bps = rep["pipeline_bps"] if rep else None
        vs_median = (
            round(bps / median, 3) if bps and median else None
        )
        planned = planned_units.get(pid, int(unit.get("planned", 0)))
        done = int(unit.get("done", 0))
        row = {
            "pid": pid,
            "status": status,
            "achieved_bps": bps,
            "vs_median": vs_median,
            "straggler": bool(
                vs_median is not None and vs_median < STRAGGLER_RATIO
            ),
            "limiting_stage": (
                (rep.get("bottleneck") or {}).get("stage") if rep else None
            ),
            "wall_s": rep["wall_s"] if rep else 0.0,
            "units_done": done,
            "units_planned": planned,
            "units_adopted": int(unit.get("adopted", 0)),
            "pieces_verified": int(unit.get("pieces", 0)),
            "stragglers": int(unit.get("stragglers", 0)),
            "audit_checks": int(unit.get("audits", 0)),
            "audit_mismatches": int(unit.get("audit_miss", 0)),
            "convictions": int(unit.get("convict", 0)),
            "degraded": bool(unit.get("degraded"))
            or status == "degraded",
            # units a survivor must absorb when this process is out
            "adoption_debt": (
                max(0, planned - done)
                if status in ("lapsed", "degraded", "distrusted")
                else 0
            ),
        }
        scoreboard.append(row)
        totals["pieces_verified"] += row["pieces_verified"]
        totals["units_done"] += row["units_done"]
        totals["bytes"] += rep["pipeline_bytes"] if rep else 0
        totals["audit_checks"] += row["audit_checks"]
        totals["audit_mismatches"] += row["audit_mismatches"]
        totals["convictions"] += row["convictions"]
    # fleet bottleneck: longest activity wall wins (the straggler IS the
    # fleet's critical path); ties toward hotter limiting stage, then
    # lower pid (max keeps the first — lowest — pid on full ties)
    active = {
        p: rep for p, rep in reports.items() if rep.get("bottleneck")
    }
    bottleneck = None
    if active:
        limit = max(
            sorted(active),
            key=lambda p: (
                active[p]["wall_s"],
                active[p]["bottleneck"]["utilization"],
            ),
        )
        bn = active[limit]["bottleneck"]
        proc_bps = active[limit]["pipeline_bps"]
        bottleneck = {
            "pid": limit,
            "stage": bn["stage"],
            "utilization": bn["utilization"],
            "achieved_bps": bn["achieved_bps"],
            "process_bps": proc_bps,
            "wall_s": active[limit]["wall_s"],
            "fleet_median_bps": median,
            # headroom if the limiting process ran at the fleet median
            "headroom": (
                round(median / proc_bps, 2)
                if median and proc_bps
                else None
            ),
        }
    fleet_bps = round(sum(rates), 3) if rates else None
    # fleet-wide SLO budget health: the worst heartbeat-carried burn
    # rate across reporting processes (digests only carry an "slo"
    # field when that process armed an engine — obs/slo)
    slo_rows = {
        p: digests[p]["slo"]
        for p in sorted(digests)
        if isinstance(digests.get(p), dict)
        and isinstance(digests[p].get("slo"), dict)
    }
    slo = None
    if slo_rows:
        worst_pid = max(
            sorted(slo_rows), key=lambda p: slo_rows[p].get("burn") or 0.0
        )
        slo = {
            "pid": worst_pid,
            "objective": slo_rows[worst_pid].get("objective"),
            "worst_burn": slo_rows[worst_pid].get("burn"),
            "breaching": sum(
                1 for p in sorted(slo_rows) if slo_rows[p].get("breach")
            ),
        }
    return {
        "v": DIGEST_VERSION,
        "nproc": nproc,
        "reporting": len(reports),
        "bottleneck": bottleneck,
        "scoreboard": scoreboard,
        "slo": slo,
        "processes": {str(p): reports[p] for p in sorted(reports)},
        "totals": {**totals, "fleet_bps": fleet_bps},
        "digest_drops": int(digest_drops),
    }


def local_fleet_snapshot(scheduler=None, pid: int = 0) -> dict:
    """A fleet-of-one rollup from this process's own obs state — what
    the bridge's ``GET /v1/fleet`` serves when no fabric job is running,
    so the route (and ``top --fleet``) always answers."""
    roll = aggregate_fleet({pid: obs_digest(scheduler=scheduler)})
    roll["pid"] = pid
    roll["state"] = "local"
    return roll


# ----------------------------------------------------------------- server


class FleetObsServer:
    """``GET /v1/fleet`` (JSON rollup) + ``GET /metrics`` (Prometheus,
    fleet series included) for one fabric worker process.

    The bridge already serves both routes; this is the same surface for
    CLI workers (``fabric-verify --obs-port``), so ``doctor --fleet``
    can ask worker B which peer limits the fleet while the sweep runs.
    ``executor_ref`` is a zero-arg callable returning the live
    :class:`~torrent_tpu_torch.fabric.FabricExecutor` (or ``None`` before the
    sweep starts — the route then serves the local fleet-of-one).
    Loopback-only by default, same trust model as the bridge."""

    def __init__(self, executor_ref, scheduler=None, host: str = "127.0.0.1"):
        self._executor_ref = executor_ref
        self.scheduler = scheduler
        self.host = host
        self.port: int | None = None
        self._server = None
        self._handlers: set = set()

    def snapshot(self) -> dict:
        ex = self._executor_ref() if callable(self._executor_ref) else None
        if ex is not None:
            return ex.fleet_snapshot()
        return local_fleet_snapshot(self.scheduler)

    async def start(self, port: int = 0) -> "FleetObsServer":
        import asyncio

        self._server = await asyncio.start_server(
            self._accept, self.host, port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    def _accept(self, reader, writer):
        import asyncio

        task = asyncio.ensure_future(self._handle(reader, writer))
        self._handlers.add(task)
        task.add_done_callback(self._handlers.discard)

    def close(self) -> None:
        if self._server is not None:
            self._server.close()
        for task in list(self._handlers):
            task.cancel()

    def _metrics_text(self) -> str:
        from torrent_tpu_torch.obs import render_obs_metrics
        from torrent_tpu_torch.utils.metrics import (
            render_fabric_metrics,
            render_fleet_metrics,
            render_sched_metrics,
        )

        text = ""
        if self.scheduler is not None:
            text += render_sched_metrics(self.scheduler)
        ex = self._executor_ref() if callable(self._executor_ref) else None
        if ex is not None:
            text += render_fabric_metrics(ex.metrics_snapshot())
        text += render_fleet_metrics(self.snapshot())
        text += render_obs_metrics()
        return text

    async def _handle(self, reader, writer):
        import asyncio

        try:
            request = await asyncio.wait_for(reader.readline(), timeout=10)
            while True:
                line = await asyncio.wait_for(reader.readline(), timeout=10)
                if line in (b"\r\n", b"\n", b""):
                    break
            parts = request.split()
            path = parts[1].split(b"?")[0] if len(parts) >= 2 else b""
            if parts and parts[0] == b"GET" and path == b"/v1/fleet":
                body = json.dumps(self.snapshot(), sort_keys=True).encode()
                status, ctype = "200 OK", "application/json"
            elif parts and parts[0] == b"GET" and path == b"/metrics":
                body = self._metrics_text().encode()
                status = "200 OK"
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            else:
                body, status, ctype = b"not found\n", "404 Not Found", "text/plain"
            writer.write(
                (
                    f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
                    f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
                ).encode("latin-1")
                + body
            )
            await writer.drain()
        except (ConnectionError, asyncio.TimeoutError, ValueError, OSError):
            pass
        finally:
            writer.close()
