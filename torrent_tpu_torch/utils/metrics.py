"""Prometheus renderers for the scheduler and fabric slices.

The counterpart of the reference's ``utils/metrics.py``, carrying the
renderers of the snapshots the port produces so far:
``render_sched_metrics`` (a ``HashPlaneScheduler``'s
``metrics_snapshot()``), ``render_control_metrics`` (the autopilot's),
``render_fabric_metrics`` (a ``FabricExecutor``'s) and
``render_fleet_metrics`` (a fleet rollup). Each is a copy of the
reference's function of the same name. The session, bridge, serve and
swarm renderers come with the serving slice.
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


def render_fabric_metrics(snapshot: dict) -> str:
    """Prometheus rendering of one process's verify-fabric gauges.

    ``snapshot`` is a ``torrent_tpu_torch.fabric.FabricExecutor.
    metrics_snapshot()`` dict. Appended to the bridge's ``/metrics``
    while a fabric job exists, labeled by the process id so a pod-wide
    scrape distinguishes shards. Defensive against partial snapshots:
    missing keys render as 0, never a crash mid-scrape."""
    s = snapshot
    pid = f'pid="{s.get("pid", 0)}"'
    states = {"idle": 0, "running": 1, "done": 2, "failed": 3}
    lines = [
        "# HELP torrent_tpu_fabric_state Fabric executor state "
        "(0=idle 1=running 2=done 3=failed)",
        "# TYPE torrent_tpu_fabric_state gauge",
        f"torrent_tpu_fabric_state{{{pid}}} {states.get(s.get('state'), 3)}",
        "# HELP torrent_tpu_fabric_shard_bytes Payload bytes planned onto this process",
        "# TYPE torrent_tpu_fabric_shard_bytes gauge",
        f"torrent_tpu_fabric_shard_bytes{{{pid}}} {s.get('shard_bytes', 0)}",
        "# HELP torrent_tpu_fabric_units Work units by disposition for this process",
        "# TYPE torrent_tpu_fabric_units gauge",
        f'torrent_tpu_fabric_units{{{pid},kind="planned"}} {s.get("shard_units", 0)}',
        f'torrent_tpu_fabric_units{{{pid},kind="done"}} {s.get("units_done", 0)}',
        f'torrent_tpu_fabric_units{{{pid},kind="adopted"}} {s.get("units_adopted", 0)}',
        f'torrent_tpu_fabric_units{{{pid},kind="offered"}} {s.get("units_offered", 0)}',
        f'torrent_tpu_fabric_units{{{pid},kind="rebalanced"}} {s.get("units_rebalanced", 0)}',
        f'torrent_tpu_fabric_units{{{pid},kind="total"}} {s.get("units_total", 0)}',
        "# HELP torrent_tpu_fabric_pieces_verified_total Pieces this process verified",
        "# TYPE torrent_tpu_fabric_pieces_verified_total counter",
        f"torrent_tpu_fabric_pieces_verified_total{{{pid}}} {s.get('pieces_verified', 0)}",
        "# HELP torrent_tpu_fabric_inflight_bytes Payload bytes in scheduler futures",
        "# TYPE torrent_tpu_fabric_inflight_bytes gauge",
        f"torrent_tpu_fabric_inflight_bytes{{{pid}}} {s.get('inflight_bytes', 0)}",
        "# HELP torrent_tpu_fabric_heartbeat_age_seconds Seconds since the last successful heartbeat exchange",
        "# TYPE torrent_tpu_fabric_heartbeat_age_seconds gauge",
        f"torrent_tpu_fabric_heartbeat_age_seconds{{{pid}}} {s.get('heartbeat_age', 0.0):.3f}",
        "# HELP torrent_tpu_fabric_sentinel_checks_total Adopted-unit verdicts cross-checked by a sentinel re-hash",
        "# TYPE torrent_tpu_fabric_sentinel_checks_total counter",
        f"torrent_tpu_fabric_sentinel_checks_total{{{pid}}} {s.get('sentinel_checks', 0)}",
        "# HELP torrent_tpu_fabric_sentinel_mismatches_total Foreign verdicts rejected by the sentinel cross-check",
        "# TYPE torrent_tpu_fabric_sentinel_mismatches_total counter",
        f"torrent_tpu_fabric_sentinel_mismatches_total{{{pid}}} {s.get('sentinel_mismatches', 0)}",
        "# HELP torrent_tpu_fabric_audit_checks_total Peer claimed-ok pieces re-hashed by the Byzantine audit sampler",
        "# TYPE torrent_tpu_fabric_audit_checks_total counter",
        f"torrent_tpu_fabric_audit_checks_total{{{pid}}} {s.get('audit_checks', 0)}",
        "# HELP torrent_tpu_fabric_audit_mismatches_total Audited claimed-ok pieces that re-hashed bad (each files conviction evidence)",
        "# TYPE torrent_tpu_fabric_audit_mismatches_total counter",
        f"torrent_tpu_fabric_audit_mismatches_total{{{pid}}} {s.get('audit_mismatches', 0)}",
        "# HELP torrent_tpu_fabric_quorum_convictions_total (publisher, unit) pairs convicted on receipt evidence (structural, audit, evidence, or accusation quorum)",
        "# TYPE torrent_tpu_fabric_quorum_convictions_total counter",
        f"torrent_tpu_fabric_quorum_convictions_total{{{pid}}} {s.get('convictions', 0)}",
        "# HELP torrent_tpu_fabric_quorum_verifies_total Units this process verified as an elected quorum top-up helper",
        "# TYPE torrent_tpu_fabric_quorum_verifies_total counter",
        f"torrent_tpu_fabric_quorum_verifies_total{{{pid}}} {s.get('quorum_verifies', 0)}",
        "# HELP torrent_tpu_fabric_quorum_need Matching receipts required to cover a unit (byzantine_f + 1, clamped to nproc; 1 = the f=0 sentinel fast path)",
        "# TYPE torrent_tpu_fabric_quorum_need gauge",
        f"torrent_tpu_fabric_quorum_need{{{pid}}} {s.get('quorum_need', 1)}",
        "# HELP torrent_tpu_fabric_stragglers_total Units flagged in flight past the straggler threshold",
        "# TYPE torrent_tpu_fabric_stragglers_total counter",
        f"torrent_tpu_fabric_stragglers_total{{{pid}}} {s.get('stragglers', 0)}",
        "# HELP torrent_tpu_fabric_degraded Breaker-stuck degradation flag (unstarted units yielded)",
        "# TYPE torrent_tpu_fabric_degraded gauge",
        f"torrent_tpu_fabric_degraded{{{pid}}} {1 if s.get('degraded') else 0}",
    ]
    return "\n".join(lines) + "\n"


# per-pid series cap for the fleet rendering: a pod bigger than this
# folds the tail pids into one pid="overflow" aggregate, so /metrics
# cardinality is bounded no matter how wide the fleet plans
MAX_FLEET_PIDS = 16

_FLEET_STATUSES = ("ok", "unreported", "degraded", "lapsed", "distrusted")


def render_fleet_metrics(rollup: dict) -> str:
    """Prometheus rendering of a fleet rollup (``obs/fleet.
    aggregate_fleet`` / ``FabricExecutor.fleet_snapshot``).

    Appended to both ``/metrics`` endpoints while a fleet view exists.
    Bounded pid cardinality: the first :data:`MAX_FLEET_PIDS` scoreboard
    rows (pid order) get per-pid series; the rest fold into a single
    ``pid="overflow"`` aggregate (summed units/rates — a bounded scrape
    beats per-pid fidelity past the cap). Defensive against partial
    rollups: missing keys render as 0, never a crash mid-scrape."""
    s = rollup or {}
    rows = [r for r in s.get("scoreboard") or [] if isinstance(r, dict)]
    named = rows[:MAX_FLEET_PIDS]
    folded = rows[MAX_FLEET_PIDS:]
    bn = s.get("bottleneck") or {}
    totals = s.get("totals") or {}
    status_counts = {st: 0 for st in _FLEET_STATUSES}
    for r in rows:
        status_counts[r.get("status") or "unreported"] = (
            status_counts.get(r.get("status") or "unreported", 0) + 1
        )
    lines = [
        "# HELP torrent_tpu_fleet_processes Processes the fabric plan spans",
        "# TYPE torrent_tpu_fleet_processes gauge",
        f"torrent_tpu_fleet_processes {s.get('nproc', 0)}",
        "# HELP torrent_tpu_fleet_reporting Processes whose obs digest this view holds",
        "# TYPE torrent_tpu_fleet_reporting gauge",
        f"torrent_tpu_fleet_reporting {s.get('reporting', 0)}",
        "# HELP torrent_tpu_fleet_status Scoreboard processes by heartbeat status",
        "# TYPE torrent_tpu_fleet_status gauge",
    ]
    for st in _FLEET_STATUSES:
        lines.append(
            f'torrent_tpu_fleet_status{{status="{st}"}} {status_counts.get(st, 0)}'
        )
    lines += [
        "# HELP torrent_tpu_fleet_median_bps Fleet median achieved pipeline bytes/s",
        "# TYPE torrent_tpu_fleet_median_bps gauge",
        "torrent_tpu_fleet_median_bps "
        f"{bn.get('fleet_median_bps') or (totals.get('fleet_bps') or 0.0)}",
        "# HELP torrent_tpu_fleet_bps Summed achieved pipeline bytes/s across reporting processes",
        "# TYPE torrent_tpu_fleet_bps gauge",
        f"torrent_tpu_fleet_bps {totals.get('fleet_bps') or 0.0}",
        "# HELP torrent_tpu_fleet_limiting_process The fleet's limiting process and its limiting stage (1 = current verdict)",
        "# TYPE torrent_tpu_fleet_limiting_process gauge",
    ]
    if bn.get("stage") is not None:
        lines.append(
            "torrent_tpu_fleet_limiting_process"
            f'{{pid="{bn.get("pid", 0)}",stage="{_esc(str(bn["stage"]))}"}} 1'
        )

    def _pid_series(name, kind, help_text, get, fold=sum):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        for r in named:
            lines.append(f'{name}{{pid="{r.get("pid", 0)}"}} {get(r)}')
        if folded:
            lines.append(
                f'{name}{{pid="overflow"}} {fold(get(r) for r in folded)}'
            )

    _pid_series(
        "torrent_tpu_fleet_pid_achieved_bps", "gauge",
        "Achieved pipeline bytes/s per process (digest view)",
        lambda r: r.get("achieved_bps") or 0.0,
    )
    _pid_series(
        "torrent_tpu_fleet_pid_vs_median", "gauge",
        "Achieved rate vs the fleet median (1.0 = median; stragglers < 0.5)",
        lambda r: r.get("vs_median") or 0.0,
        # a ratio doesn't sum: the folded tail reports its WORST member —
        # the actionable straggler signal an alert on < 0.5 still catches
        fold=min,
    )
    _pid_series(
        "torrent_tpu_fleet_pid_adoption_debt", "gauge",
        "Planned-but-undone units of an unavailable process that survivors must absorb",
        lambda r: r.get("adoption_debt") or 0,
    )
    lines.append(
        "# HELP torrent_tpu_fleet_pid_units Work units by disposition per process"
    )
    lines.append("# TYPE torrent_tpu_fleet_pid_units gauge")
    for kind_name, key in (
        ("planned", "units_planned"),
        ("done", "units_done"),
        ("adopted", "units_adopted"),
    ):
        for r in named:
            lines.append(
                "torrent_tpu_fleet_pid_units"
                f'{{pid="{r.get("pid", 0)}",kind="{kind_name}"}} {r.get(key, 0) or 0}'
            )
        if folded:
            lines.append(
                "torrent_tpu_fleet_pid_units"
                f'{{pid="overflow",kind="{kind_name}"}} '
                f"{sum(r.get(key, 0) or 0 for r in folded)}"
            )
    lines += [
        "# HELP torrent_tpu_fleet_digest_dropped_total Heartbeats that shed their obs digest to fit the transport buffer",
        "# TYPE torrent_tpu_fleet_digest_dropped_total counter",
        f"torrent_tpu_fleet_digest_dropped_total {s.get('digest_drops', 0)}",
    ]
    # fleet-wide SLO budget health: the worst heartbeat-carried burn
    # rate across reporting processes (absent when no peer armed an
    # engine — the series simply don't exist)
    slo = s.get("slo")
    if isinstance(slo, dict):
        lines += [
            "# HELP torrent_tpu_fleet_slo_worst_burn_rate Worst short-window error-budget burn rate across the fleet",
            "# TYPE torrent_tpu_fleet_slo_worst_burn_rate gauge",
            "torrent_tpu_fleet_slo_worst_burn_rate"
            f'{{pid="{slo.get("pid", 0)}",objective="{_esc(str(slo.get("objective", "")))}"}} '
            f"{slo.get('worst_burn') or 0.0}",
            "# HELP torrent_tpu_fleet_slo_breaching Reporting processes whose digest carries an active SLO breach",
            "# TYPE torrent_tpu_fleet_slo_breaching gauge",
            f"torrent_tpu_fleet_slo_breaching {slo.get('breaching', 0)}",
        ]
    return "\n".join(lines) + "\n"
