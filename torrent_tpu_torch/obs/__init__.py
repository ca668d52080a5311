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

Plus the **flight recorder** (``obs/recorder``): a bounded ring of
recent spans + component snapshots, dumped as redacted black-box JSON
on breaker-open and retry-exhausted failures.

These are copies of the reference's modules of the same names; its
fleet, SLO, swarm and timeline planes, and ``render_obs_metrics`` (the
``/metrics`` composition), come with the serving slice.
Everything here locks via ``utils.locks.named_lock`` (obs locks are
leaves of the lock-order graph) and keeps dumped bytes deterministic:
monotonic-only timestamps, sorted keys.
"""

from torrent_tpu_torch.obs.attrib import attribute, format_report
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
    "FlightRecorder",
    "HistogramRegistry",
    "LogHistogram",
    "PIPELINE_STAGES",
    "PipelineLedger",
    "Span",
    "Tracer",
    "attribute",
    "fabric_trace_id",
    "flight_recorder",
    "format_report",
    "heartbeat_span_context",
    "histograms",
    "merge_snapshots",
    "pipeline_ledger",
    "render_pipeline_metrics",
    "tracer",
    "valid_trace_id",
]

