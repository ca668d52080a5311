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

These are copies of the reference's modules of the same names; its SLO,
swarm and timeline planes come with the serving slice, and until then
:func:`render_obs_metrics` composes the families that exist here.
Everything here locks via ``utils.locks.named_lock`` (obs locks are
leaves of the lock-order graph) and keeps dumped bytes deterministic:
monotonic-only timestamps, sorted keys.
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
    "Span",
    "Tracer",
    "aggregate_fleet",
    "attribute",
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
    "tracer",
    "valid_trace_id",
]


def render_obs_metrics() -> str:
    """The obs plane's /metrics contribution: every latency-histogram
    family, the pipeline ledger's per-stage series + bottleneck verdict,
    and the flight-recorder dump counters. The reference also appends
    its swarm and seeder families, which come with the serving slice."""
    return histograms().render() + render_pipeline_metrics() + flight_recorder().render_metrics()
