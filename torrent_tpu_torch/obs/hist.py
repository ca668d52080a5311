"""Always-on low-overhead latency histograms (fixed log2 buckets).

The continuous instrument the ingest-gap work needs: per-stage p50/p99
(queue wait, launch, end-to-end per tenant, bridge request) visible on
every scrape, not reconstructed from bench records. Design constraints:

* **Fixed log2 buckets** — ``2^-17 s`` (~7.6 µs) through ``2^6 s``
  (64 s), 24 boundaries plus +Inf. No per-series configuration, so a
  bucket index is one ``bisect`` on a shared tuple and every series is
  mergeable across processes.
* **Batch observation** — the scheduler observes a whole launch's
  queue waits under ONE lock acquisition (``observe_batch``), keeping
  the hot path at amortized nanoseconds per ticket.
* **Bounded label cardinality** — an attacker minting fresh ``X-Tenant``
  values per request must not grow ``/metrics`` without limit: past
  ``max_series`` per family, new label sets fold into a single
  ``overflow`` series.
* **Real Prometheus histograms** — rendered as cumulative ``_bucket``
  series with ``le`` labels, plus ``_sum``/``_count``, under one
  ``# HELP``/``# TYPE histogram`` header per family.

Locks come from :func:`~torrent_tpu_torch.utils.locks.named_lock`;
the registry lock and the per-histogram lock are never nested with any
other named lock.
"""

from __future__ import annotations

from bisect import bisect_left

from torrent_tpu_torch.utils.locks import named_lock
from torrent_tpu_torch.utils.metrics import _esc

__all__ = [
    "BUCKET_BOUNDS",
    "HistogramRegistry",
    "LogHistogram",
    "histograms",
    "merge_snapshots",
]

# 2^-17 s .. 2^6 s: sub-10µs through 64 s, the full range a hash-plane
# stage can plausibly occupy (a CPU-plane 16 MiB piece is ~50 ms; a
# wedged launch hits the +Inf bucket)
BUCKET_BOUNDS: tuple[float, ...] = tuple(2.0**k for k in range(-17, 7))

MAX_SERIES_PER_FAMILY = 256


class LogHistogram:
    """One (family, label-set) series: per-bucket counts + sum/count."""

    __slots__ = ("counts", "count", "sum", "_lock")

    def __init__(self):
        self.counts = [0] * (len(BUCKET_BOUNDS) + 1)  # last = +Inf
        self.count = 0
        self.sum = 0.0
        self._lock = named_lock("obs.hist._lock")

    def observe(self, seconds: float) -> None:
        idx = bisect_left(BUCKET_BOUNDS, seconds)
        with self._lock:
            self.counts[idx] += 1
            self.count += 1
            self.sum += seconds

    def observe_batch(self, values) -> None:
        """All of ``values`` under one lock acquisition — the scheduler
        records a whole launch's ticket waits in one call."""
        if not values:
            return
        idxs = [bisect_left(BUCKET_BOUNDS, v) for v in values]
        total = sum(values)
        with self._lock:
            for idx in idxs:
                self.counts[idx] += 1
            self.count += len(idxs)
            self.sum += total

    def snapshot(self) -> tuple[list[int], int, float]:
        with self._lock:
            return list(self.counts), self.count, self.sum


def merge_snapshots(
    snaps,
) -> tuple[list[int], int, float]:
    """Bucket-aligned sum of :meth:`LogHistogram.snapshot` tuples.

    Because every histogram shares the fixed :data:`BUCKET_BOUNDS`,
    merging series — across label sets, or across PROCESSES (the fleet
    rollup merges digest-carried summaries from every fabric peer) — is
    an elementwise sum; the final +Inf overflow bucket merges like any
    other, so wedged-launch outliers survive aggregation. Rejects
    snapshots whose bucket count diverges (a peer running a different
    build must fail loudly, not mis-bin silently). An empty iterable
    merges to the all-zero snapshot."""
    counts: list[int] | None = None
    count = 0
    total = 0.0
    for c, k, s in snaps:
        if counts is None:
            counts = list(c)
        else:
            if len(c) != len(counts):
                raise ValueError(
                    f"bucket count mismatch: {len(c)} != {len(counts)} "
                    "(snapshots from different BUCKET_BOUNDS builds?)"
                )
            for i, v in enumerate(c):
                counts[i] += v
        count += int(k)
        total += float(s)
    if counts is None:
        counts = [0] * (len(BUCKET_BOUNDS) + 1)
    return counts, count, total


class HistogramRegistry:
    """(family name, labels) -> :class:`LogHistogram`, bounded per
    family, rendered as Prometheus exposition text."""

    def __init__(self, max_series: int = MAX_SERIES_PER_FAMILY):
        self._lock = named_lock("obs.hist._reg_lock")
        self._max_series = max_series
        # family -> {label_items_tuple -> LogHistogram}
        self._families: dict[str, dict[tuple, LogHistogram]] = {}
        self._help: dict[str, str] = {}

    def get(self, name: str, help: str = "", **labels) -> LogHistogram:
        key = tuple(sorted(labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = {}
                self._help[name] = help or name
            h = fam.get(key)
            if h is None:
                if len(fam) >= self._max_series:
                    # cardinality bound: unseen label sets beyond the cap
                    # share one overflow series instead of growing /metrics
                    key = (("overflow", "true"),)
                    h = fam.get(key)
                    if h is not None:
                        return h
                h = fam[key] = LogHistogram()
            return h

    def family_snapshot(self, name: str) -> tuple[list[int], int, float] | None:
        """One merged snapshot for a whole family (every label set summed
        via :func:`merge_snapshots`) — the compact per-process form the
        fleet obs digest carries. ``None`` when the family has never been
        observed, so digests stay minimal on idle planes."""
        with self._lock:
            fam = self._families.get(name)
            hists = [h for _, h in sorted(fam.items())] if fam else []
        # snapshot OUTSIDE the registry lock (same discipline as render:
        # the registry and per-histogram locks are both leaves and are
        # never nested)
        if not hists:
            return None
        return merge_snapshots(h.snapshot() for h in hists)

    def render(self) -> str:
        """Prometheus text exposition for every family: cumulative
        ``_bucket`` series (``le`` ascending, ending at +Inf), then
        ``_sum`` and ``_count`` per label set."""
        with self._lock:
            families = {
                name: (self._help[name], dict(fam))
                for name, fam in sorted(self._families.items())
            }
        lines: list[str] = []
        for name, (help_text, fam) in families.items():
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} histogram")
            for key, h in sorted(fam.items()):
                counts, count, total = h.snapshot()
                base = ",".join(f'{k}="{_esc(str(v))}"' for k, v in key)
                sep = "," if base else ""
                cum = 0
                for bound, c in zip(BUCKET_BOUNDS, counts):
                    cum += c
                    lines.append(
                        f'{name}_bucket{{{base}{sep}le="{bound:.10g}"}} {cum}'
                    )
                lines.append(f'{name}_bucket{{{base}{sep}le="+Inf"}} {count}')
                suffix = f"{{{base}}}" if base else ""
                lines.append(f"{name}_sum{suffix} {total:.9g}")
                lines.append(f"{name}_count{suffix} {count}")
        return "\n".join(lines) + "\n" if lines else ""

    def clear(self) -> None:
        with self._lock:
            self._families.clear()
            self._help.clear()


_registry = None


def histograms() -> HistogramRegistry:
    """The process-wide latency-histogram registry."""
    global _registry
    if _registry is None:
        _registry = HistogramRegistry()
    return _registry
