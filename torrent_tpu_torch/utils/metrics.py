"""Prometheus renderers for the scheduler slice.

The counterpart of the reference's ``utils/metrics.py``, carrying only
the renderers of the two snapshots the scheduler slice produces:
``render_sched_metrics`` (a ``HashPlaneScheduler``'s
``metrics_snapshot()``) and ``render_control_metrics`` (the autopilot's).
The session, bridge, serve and swarm renderers come with the serving
slice.
"""

from __future__ import annotations


def _esc(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def render_sched_metrics(sched) -> str:
    """Prometheus rendering of a hash-plane scheduler's counters.

    ``sched`` is a ``torrent_tpu_torch.sched.HashPlaneScheduler`` (anything
    with its ``metrics_snapshot()`` contract). Served by the bridge's
    ``GET /metrics`` and appended to the session exposition when a
    ``MetricsServer`` is given a scheduler. Defensive against partial
    snapshots (a fresh or degraded component may not carry every key):
    a missing counter renders as 0, never a crash mid-scrape."""
    s = sched.metrics_snapshot()
    lines = [
        "# HELP torrent_tpu_sched_queue_pieces Pieces queued awaiting a device launch",
        "# TYPE torrent_tpu_sched_queue_pieces gauge",
        f"torrent_tpu_sched_queue_pieces {s.get('queue_pieces', 0)}",
        "# HELP torrent_tpu_sched_queue_bytes Queued + in-flight payload bytes",
        "# TYPE torrent_tpu_sched_queue_bytes gauge",
        f"torrent_tpu_sched_queue_bytes {s.get('queue_bytes', 0)}",
        "# HELP torrent_tpu_sched_lanes Compiled (algo, piece-bucket) lanes",
        "# TYPE torrent_tpu_sched_lanes gauge",
        f"torrent_tpu_sched_lanes {s.get('lanes', 0)}",
        "# HELP torrent_tpu_sched_launches_total Device launches dispatched",
        "# TYPE torrent_tpu_sched_launches_total counter",
        f"torrent_tpu_sched_launches_total {s.get('launches', 0)}",
        "# HELP torrent_tpu_sched_batch_fill_ratio Mean launch fill vs the lane target",
        "# TYPE torrent_tpu_sched_batch_fill_ratio gauge",
        f"torrent_tpu_sched_batch_fill_ratio {s.get('mean_fill', 0.0):.6f}",
        "# HELP torrent_tpu_sched_shed_total Submissions rejected by admission control",
        "# TYPE torrent_tpu_sched_shed_total counter",
        f"torrent_tpu_sched_shed_total {s.get('shed_total', 0)}",
        "# HELP torrent_tpu_sched_launch_failures_total Device launches that raised",
        "# TYPE torrent_tpu_sched_launch_failures_total counter",
        f"torrent_tpu_sched_launch_failures_total {s.get('launch_failures', 0)}",
        "# HELP torrent_tpu_sched_retries_total Failed launches retried (transient errors)",
        "# TYPE torrent_tpu_sched_retries_total counter",
        f"torrent_tpu_sched_retries_total {s.get('retries', 0)}",
        "# HELP torrent_tpu_sched_bisections_total Failed launches split to isolate a poisoned ticket",
        "# TYPE torrent_tpu_sched_bisections_total counter",
        f"torrent_tpu_sched_bisections_total {s.get('bisections', 0)}",
        "# HELP torrent_tpu_sched_cpu_fallback_launches_total Launches degraded to the CPU plane by an open breaker",
        "# TYPE torrent_tpu_sched_cpu_fallback_launches_total counter",
        f"torrent_tpu_sched_cpu_fallback_launches_total {s.get('cpu_fallback_launches', 0)}",
        "# HELP torrent_tpu_sched_failed_pieces_total Pieces whose hashing exhausted retry and bisection",
        "# TYPE torrent_tpu_sched_failed_pieces_total counter",
        f"torrent_tpu_sched_failed_pieces_total {s.get('failed_pieces', 0)}",
        "# HELP torrent_tpu_sched_evicted_tenants_total Idle auto-registered tenants evicted to bound cardinality",
        "# TYPE torrent_tpu_sched_evicted_tenants_total counter",
        f"torrent_tpu_sched_evicted_tenants_total {s.get('evicted', {}).get('tenants', 0)}",
        "# HELP torrent_tpu_sched_staging_outstanding Zero-copy ingest slabs checked out and not yet returned",
        "# TYPE torrent_tpu_sched_staging_outstanding gauge",
        f"torrent_tpu_sched_staging_outstanding {s.get('staging', {}).get('outstanding', 0)}",
        "# HELP torrent_tpu_sched_staging_checkouts_total Zero-copy ingest slab checkouts",
        "# TYPE torrent_tpu_sched_staging_checkouts_total counter",
        f"torrent_tpu_sched_staging_checkouts_total {s.get('staging', {}).get('checkouts', 0)}",
        "# HELP torrent_tpu_sched_flush_total Launch flushes by reason",
        "# TYPE torrent_tpu_sched_flush_total counter",
    ]
    for reason, n in sorted(s.get("flush_reasons", {}).items()):
        lines.append(f'torrent_tpu_sched_flush_total{{reason="{reason}"}} {n}')
    # per-lane launch fill and tile-padding waste (pallas sub-tile
    # bucketing observability: a tile-snapped lane under load should
    # show fill near 1.0 and a flat pad-rows counter)
    lane_stats = s.get("lane_stats", {})
    lines.append(
        "# HELP torrent_tpu_sched_lane_fill_ratio Mean launch fill vs this lane's target"
    )
    lines.append("# TYPE torrent_tpu_sched_lane_fill_ratio gauge")
    for lane, st in sorted(lane_stats.items()):
        lines.append(
            f'torrent_tpu_sched_lane_fill_ratio{{lane="{_esc(lane)}"}} '
            f"{st.get('mean_fill', 0.0):.6f}"
        )
    lines.append(
        "# HELP torrent_tpu_sched_launch_pad_rows_total Sentinel rows staged "
        "beyond the live batch (tile-bucketed pallas launches)"
    )
    lines.append("# TYPE torrent_tpu_sched_launch_pad_rows_total counter")
    for lane, st in sorted(lane_stats.items()):
        lines.append(
            f'torrent_tpu_sched_launch_pad_rows_total{{lane="{_esc(lane)}"}} '
            f"{st.get('pad_rows_total', 0)}"
        )
    lines.append(
        "# HELP torrent_tpu_sched_lane_target Pieces per launch this lane aims to fill"
    )
    lines.append("# TYPE torrent_tpu_sched_lane_target gauge")
    for lane, st in sorted(lane_stats.items()):
        lines.append(
            f'torrent_tpu_sched_lane_target{{lane="{_esc(lane)}",'
            f'backend="{_esc(st.get("backend", "device"))}"}} {st.get("target", 0)}'
        )
    # breaker lifecycle per lane: state as an enum gauge (0 closed,
    # 1 half-open, 2 open — alert on > 0) plus transition counters
    _breaker_states = {"closed": 0, "half_open": 1, "open": 2}
    lines.append(
        "# HELP torrent_tpu_sched_breaker_state Lane circuit-breaker state "
        "(0=closed device plane live, 1=half-open probing, 2=open CPU degraded)"
    )
    lines.append("# TYPE torrent_tpu_sched_breaker_state gauge")
    for lane, b in sorted(s.get("breakers", {}).items()):
        lines.append(
            f'torrent_tpu_sched_breaker_state{{lane="{_esc(lane)}"}} '
            f"{_breaker_states.get(b.get('state'), 2)}"
        )
    lines.append(
        "# HELP torrent_tpu_sched_breaker_transitions_total Breaker state transitions"
    )
    lines.append("# TYPE torrent_tpu_sched_breaker_transitions_total counter")
    for lane, b in sorted(s.get("breakers", {}).items()):
        for transition, n in sorted(b.get("transitions", {}).items()):
            lines.append(
                "torrent_tpu_sched_breaker_transitions_total"
                f'{{lane="{_esc(lane)}",transition="{_esc(transition)}"}} {n}'
            )
    per_tenant = [
        ("torrent_tpu_sched_tenant_served_bytes_total", "counter",
         "Payload bytes hashed for this tenant", "served_bytes"),
        ("torrent_tpu_sched_tenant_served_pieces_total", "counter",
         "Pieces hashed for this tenant", "served_pieces"),
        ("torrent_tpu_sched_tenant_queued_bytes", "gauge",
         "Queued + in-flight bytes for this tenant", "queued_bytes"),
        ("torrent_tpu_sched_tenant_shed_total", "counter",
         "Submissions shed for this tenant", "shed"),
    ]
    for name, kind, help_text, key in per_tenant:
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        for tenant, t in sorted(s.get("tenants", {}).items()):
            lines.append(f'{name}{{tenant="{_esc(tenant)}"}} {t.get(key, 0)}')
    return "\n".join(lines) + "\n"


def render_control_metrics(snapshot: dict) -> str:
    """Prometheus rendering of the scheduler autopilot's counters.

    ``snapshot`` is ``torrent_tpu_torch.sched.control.SchedulerAutopilot.
    metrics_snapshot()``. Appended to both ``/metrics`` endpoints while
    an autopilot is attached — the series simply don't exist otherwise.
    Defensive against partial snapshots: missing keys render as 0."""
    s = snapshot or {}
    lines = [
        "# HELP torrent_tpu_control_enabled Scheduler autopilot actuation switch (0 = observe-only)",
        "# TYPE torrent_tpu_control_enabled gauge",
        f"torrent_tpu_control_enabled {1 if s.get('enabled') else 0}",
        "# HELP torrent_tpu_control_ticks_total Controller decisions computed",
        "# TYPE torrent_tpu_control_ticks_total counter",
        f"torrent_tpu_control_ticks_total {s.get('ticks', 0)}",
        "# HELP torrent_tpu_control_admission_factor Fraction of the configured admission budget currently admitted",
        "# TYPE torrent_tpu_control_admission_factor gauge",
        f"torrent_tpu_control_admission_factor {s.get('admission_factor', 1.0):.4f}",
        "# HELP torrent_tpu_control_backend_switches_total Lane backend steers applied by the controller",
        "# TYPE torrent_tpu_control_backend_switches_total counter",
        f"torrent_tpu_control_backend_switches_total {s.get('backend_switches', 0)}",
        "# HELP torrent_tpu_control_actions_total Actuator moves applied, by actuator",
        "# TYPE torrent_tpu_control_actions_total counter",
    ]
    for actuator in ("batch_target", "flush_deadline", "admission", "backend"):
        lines.append(
            f'torrent_tpu_control_actions_total{{actuator="{actuator}"}} '
            f"{(s.get('actions') or {}).get(actuator, 0)}"
        )
    # the controller's last confirmed bottleneck as a 0/1 enum family
    from torrent_tpu_torch.obs.ledger import PIPELINE_STAGES

    bn = s.get("bottleneck")
    lines.append(
        "# HELP torrent_tpu_control_bottleneck Stage the controller's last decision named limiting (1 = current)"
    )
    lines.append("# TYPE torrent_tpu_control_bottleneck gauge")
    for stage in PIPELINE_STAGES:
        lines.append(
            f'torrent_tpu_control_bottleneck{{stage="{stage}"}} '
            f"{1 if stage == bn else 0}"
        )
    lanes = s.get("lanes") or {}
    lines.append(
        "# HELP torrent_tpu_control_lane_target Current (possibly adapted) pieces-per-launch target per lane"
    )
    lines.append("# TYPE torrent_tpu_control_lane_target gauge")
    for lane, st in sorted(lanes.items()):
        lines.append(
            f'torrent_tpu_control_lane_target{{lane="{_esc(lane)}",'
            f'backend="{_esc(str(st.get("backend", "device")))}"}} '
            f"{st.get('target', 0)}"
        )
    lines.append(
        "# HELP torrent_tpu_control_lane_flush_deadline_seconds Current (possibly adapted) flush deadline per lane"
    )
    lines.append("# TYPE torrent_tpu_control_lane_flush_deadline_seconds gauge")
    for lane, st in sorted(lanes.items()):
        lines.append(
            f'torrent_tpu_control_lane_flush_deadline_seconds{{lane="{_esc(lane)}"}} '
            f"{st.get('deadline', 0.0):.6f}"
        )
    return "\n".join(lines) + "\n"
