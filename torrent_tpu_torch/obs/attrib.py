"""Bottleneck attribution over pipeline-ledger snapshots.

Turns the raw per-stage counters of ``obs/ledger.py`` into the verdict
an operator actually wants: *which stage limits the pipeline, and by
how much*. The model is the classic pipelined-stage one, the same
treat-storage-to-accelerator-as-one-pipeline lens as "GPUs as Storage
System Accelerators" (PAPERS.md):

* ``utilization``  — a stage's busy-seconds per second of pipeline wall
  time. Overlapped work (depth-2 launch pipelining, concurrent reader
  threads) can push this above 1.0; that is honest occupancy, not an
  error.
* ``achieved_bps`` — the stage's throughput *while busy*
  (``bytes / busy_s``): what the stage can do.
* ``demanded_bps`` — the fastest achieved rate among the OTHER stages:
  what the rest of the pipeline could feed (or drain) if this stage
  were free. For a true bottleneck ``achieved ≪ demanded``; the ratio
  is the headroom unlocked by fixing it.

The **limiting stage** is the one with the highest utilization (ties
broken toward more bytes — the stage doing real pipeline volume). A
counter (``PipelineLedger.COUNTERS``: the ledger's ``read_wait``, a
wait, and the copy's counters of ``obs/h2d.py``, work a stage already
holds) is reported with the stages but is never the limiting stage, nor
the rate the others demand.
Attribution works on a single since-start snapshot or on the delta
between two (``prev=``) — ``doctor --bottleneck`` and the bench
harness use deltas so one process can attribute several runs.

Pure functions over plain dicts: no locks, no globals, trivially
testable, and safe to call from the bridge's serving loop.
"""

from __future__ import annotations

__all__ = ["attribute", "format_rate", "format_report"]

_EPS = 1e-9


def _delta(cur: dict, prev: dict | None) -> tuple[dict, float]:
    """Per-stage counter deltas and the wall interval they span."""
    pstages = (prev or {}).get("stages", {})
    stages = {}
    for name, s in cur.get("stages", {}).items():
        p = pstages.get(name, {})
        stages[name] = {
            "busy_s": max(0.0, s.get("busy_s", 0.0) - p.get("busy_s", 0.0)),
            "bytes": max(0, s.get("bytes", 0) - p.get("bytes", 0)),
            "ops": max(0, s.get("ops", 0) - p.get("ops", 0)),
            "active": s.get("active", 0),
            "max_active": s.get("max_active", 0),
        }
    t0 = cur.get("t_first")
    t1 = cur.get("t_last")
    if prev is not None:
        # anchor the interval at the moment `prev` was TAKEN (t_snap),
        # not at the previous activity's end (t_last): idle time between
        # a prior run and the snapshot — doctor's setup work, a quiet
        # bridge — must not count into this interval's wall and dilute
        # utilization. Older prev dicts without t_snap fall back.
        anchor = prev.get("t_snap") or prev.get("t_last")
        if anchor is not None:
            t0 = anchor
    wall = 0.0
    if t0 is not None and t1 is not None:
        wall = max(0.0, t1 - t0)
    return stages, wall


def attribute(snapshot: dict, prev: dict | None = None) -> dict:
    """Attribution report for one ledger snapshot (or the delta between
    two). Always returns a complete dict; ``bottleneck`` is ``None``
    when the interval recorded no activity (fresh ledger, idle plane).
    """
    from torrent_tpu_torch.obs.ledger import PipelineLedger

    stages, wall = _delta(snapshot, prev)
    active = {n: s for n, s in stages.items() if s["ops"] > 0 and n not in PipelineLedger.COUNTERS}
    report_stages: dict[str, dict] = {}
    for name, s in stages.items():
        report_stages[name] = {
            "busy_s": round(s["busy_s"], 6),
            "bytes": s["bytes"],
            "ops": s["ops"],
            "active": s["active"],
            "max_active": s["max_active"],
            "utilization": round(s["busy_s"] / wall, 6) if wall > _EPS else 0.0,
            "achieved_bps": (
                round(s["bytes"] / s["busy_s"], 3) if s["busy_s"] > _EPS else None
            ),
        }
    # cross-stage occupancy overlap (the double-buffering visibility
    # series): delta the overlap seconds like any counter; the
    # max-concurrent high-water is since-start (snapshots may predate
    # the field — missing dicts read as zeros)
    ov = snapshot.get("overlap") or {}
    pov = (prev or {}).get("overlap") or {}
    overlap_s = max(0.0, ov.get("busy_s", 0.0) - pov.get("busy_s", 0.0))
    out: dict = {
        "wall_s": round(wall, 6),
        "stages": report_stages,
        "bottleneck": None,
        "pipeline_bytes": stages.get("verdict", {}).get("bytes", 0),
        "pipeline_bps": None,
        "overlap": {
            "busy_s": round(overlap_s, 6),
            "share": round(overlap_s / wall, 6) if wall > _EPS else 0.0,
            "concurrent_stages": ov.get("concurrent_stages", 0),
            "max_concurrent_stages": ov.get("max_concurrent_stages", 0),
        },
    }
    if wall > _EPS and out["pipeline_bytes"]:
        out["pipeline_bps"] = round(out["pipeline_bytes"] / wall, 3)
    if not active or wall <= _EPS:
        return out
    # limiting stage: highest busy share of the wall, ties toward bytes
    limit = max(active, key=lambda n: (active[n]["busy_s"], active[n]["bytes"]))
    achieved = report_stages[limit]["achieved_bps"]
    others = [
        report_stages[n]["achieved_bps"]
        for n in active
        if n != limit and report_stages[n]["achieved_bps"]
    ]
    demanded = max(others) if others else None
    out["bottleneck"] = {
        "stage": limit,
        "utilization": report_stages[limit]["utilization"],
        "achieved_bps": achieved,
        "demanded_bps": demanded,
        # headroom if this stage were as fast as the best other stage
        "headroom": (
            round(demanded / achieved, 2)
            if achieved and demanded and achieved > _EPS
            else None
        ),
    }
    return out


def format_rate(bps: float | None) -> str:
    """Human-readable byte rate (shared by format_report and `top`)."""
    if not bps:
        return "—"
    for unit, div in (("GiB/s", 1 << 30), ("MiB/s", 1 << 20), ("KiB/s", 1 << 10)):
        if bps >= div:
            return f"{bps / div:.1f} {unit}"
    return f"{bps:.0f} B/s"


def format_report(report: dict) -> str:
    """One-paragraph human rendering (doctor --bottleneck, bench logs)."""
    bn = report.get("bottleneck")
    if bn is None:
        return "pipeline idle: no stage activity recorded"
    parts = [
        f"{bn['stage']} limits the pipeline: {bn['utilization'] * 100:.0f}% of "
        f"{report['wall_s']:.2f}s wall, {format_rate(bn['achieved_bps'])} achieved"
    ]
    if bn.get("demanded_bps"):
        parts.append(f"vs {format_rate(bn['demanded_bps'])} demanded")
    if bn.get("headroom"):
        parts.append(f"({bn['headroom']}x headroom)")
    shares = ", ".join(
        f"{name} {st['utilization'] * 100:.0f}%"
        for name, st in sorted(
            report["stages"].items(), key=lambda kv: -kv[1]["busy_s"]
        )
        if st["ops"]
    )
    return " ".join(parts) + (f"; stage shares: {shares}" if shares else "")
