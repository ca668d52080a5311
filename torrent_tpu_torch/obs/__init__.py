"""torrent_tpu_torch.obs — the observability plane of the scheduler slice.

Three tiers over the same ticket lifecycle, cheapest first:

1. **Latency histograms** (``obs/hist``) and the **pipeline ledger**
   (``obs/ledger`` + ``obs/attrib``): always-on fixed-log2-bucket
   per-stage distributions (queue wait, launch, end-to-end per tenant)
   plus byte/time/occupancy accounting at every pipeline stage boundary
   (read → stage → h2d → launch → digest → verdict) feeding a
   bottleneck attributor. On a GPU the h2d, launch and digest spans
   close on CUDA events, when the work is done on the card.
2. **Span tracer** (``obs/tracer``): per-trace span trees threaded
   through the scheduler's ticket lifecycle.
3. **Profiler** (``obs/profiler``): a ``torch.profiler`` capture of the
   first N batches (``TORRENT_TPU_PROFILE``), the deep-dive tier.

Plus the **fleet plane** (``obs/fleet``): a compact deterministic
per-process obs digest carried on every fabric heartbeat, merged into a
swarm-wide rollup with two-level bottleneck attribution (limiting
process → its limiting stage) and a straggler scoreboard — served as
``GET /v1/fleet`` by ``FleetObsServer`` and as ``torrent_tpu_fleet_*``
Prometheus series.

And the **flight recorder** (``obs/recorder``): a bounded ring of
recent spans + component snapshots, dumped as redacted black-box JSON
on breaker-open, retry-exhausted failure or fabric distrust.

Plus the **history tier** (``obs/timeline``): a bounded ring of
periodic whole-plane samples taken by an off-loop sampler thread,
replayable offline; the **SLO engine** (``obs/slo``): declarative
objectives with multi-window error-budget burn rates over that ring,
and the readiness verdict behind ``GET /v1/health``; and the **swarm
wire plane** (``obs/swarm``): the bounded per-peer registry behind
``GET /v1/swarm`` (zero peers until the session slice feeds it).

These are copies of the reference's modules of the same names, served
by the bridge (``bridge/service.py``). Everything here locks via
``utils.locks.named_lock`` (obs locks are leaves of the lock-order
graph) and keeps dumped bytes deterministic: monotonic-only
timestamps, sorted keys.
"""

from torrent_tpu_torch.obs.attrib import attribute, format_report
from torrent_tpu_torch.obs.fleet import (
    DIGEST_MAX_BYTES,
    aggregate_fleet,
    local_fleet_snapshot,
    obs_digest,
)
from torrent_tpu_torch.obs.hist import (
    HistogramRegistry,
    LogHistogram,
    histograms,
    merge_snapshots,
)
from torrent_tpu_torch.obs.ledger import (
    PIPELINE_STAGES,
    PipelineLedger,
    pipeline_ledger,
    render_pipeline_metrics,
)
from torrent_tpu_torch.obs.recorder import FlightRecorder, flight_recorder
from torrent_tpu_torch.obs.swarm import (
    SwarmTelemetry,
    build_swarm_snapshot,
    swarm_telemetry,
)
from torrent_tpu_torch.obs.slo import (
    SloEngine,
    SloObjective,
    build_health,
    evaluate_slo,
    parse_objectives,
)
from torrent_tpu_torch.obs.timeline import (
    Timeline,
    TimelineSampler,
    build_sample,
    replay_report,
)
from torrent_tpu_torch.obs.tracer import (
    Span,
    Tracer,
    fabric_trace_id,
    heartbeat_span_context,
    tracer,
    valid_trace_id,
)

__all__ = [
    "DIGEST_MAX_BYTES",
    "FlightRecorder",
    "HistogramRegistry",
    "LogHistogram",
    "PIPELINE_STAGES",
    "PipelineLedger",
    "SloEngine",
    "SloObjective",
    "Span",
    "SwarmTelemetry",
    "Timeline",
    "TimelineSampler",
    "Tracer",
    "aggregate_fleet",
    "build_swarm_snapshot",
    "attribute",
    "build_health",
    "build_sample",
    "evaluate_slo",
    "parse_objectives",
    "replay_report",
    "fabric_trace_id",
    "flight_recorder",
    "format_report",
    "heartbeat_span_context",
    "histograms",
    "local_fleet_snapshot",
    "merge_snapshots",
    "obs_digest",
    "pipeline_ledger",
    "render_obs_metrics",
    "render_pipeline_metrics",
    "swarm_telemetry",
    "tracer",
    "valid_trace_id",
]


def render_obs_metrics() -> str:
    """The obs plane's /metrics contribution: every latency-histogram
    family, the pipeline ledger's per-stage series + bottleneck verdict,
    the swarm wire-plane families (``torrent_tpu_swarm_*`` + bounded
    ``torrent_tpu_peer_*``), the seeder plane's ``torrent_tpu_serve_*``
    (only once this process has actually served — tracker-only scrapes
    stay lean), and the flight-recorder dump counters. Appended by the
    bridge's ``/metrics`` (and, with the session slice, its
    ``MetricsServer``)."""
    from torrent_tpu_torch.serve_plane.telemetry import serve_telemetry
    from torrent_tpu_torch.utils.metrics import (
        render_serve_metrics,
        render_swarm_metrics,
    )

    serve_obs = serve_telemetry()
    return (
        histograms().render()
        + render_pipeline_metrics()
        + render_swarm_metrics(swarm_telemetry().snapshot())
        + (
            render_serve_metrics(serve_obs.snapshot())
            if serve_obs.active()
            else ""
        )
        + flight_recorder().render_metrics()
    )
