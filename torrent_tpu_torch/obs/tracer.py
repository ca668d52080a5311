"""Always-on span/event tracer for the ticket lifecycle.

The stack's planes (scheduler, faults/breaker, kernels, fabric,
sanitizer) interact per *ticket*, and without spans an end-to-end
latency can be attributed to a stage only by bench archaeology. The
tracer records one bounded span tree per trace:

* **Trace IDs are minted at the bridge** — an ``X-Trace-Id`` request
  header is honored (and echoed back), otherwise the bridge mints one —
  and threaded through the scheduler ticket lifecycle (enqueue →
  admission/shed → lane wait → launch/retry/bisect → digest/verdict)
  via the submission, not contextvars: lane assembler tasks and worker
  threads are long-lived and never inherit a request's context.
* **Fabric trace IDs are deterministic** (plan fingerprint + pid, see
  :func:`fabric_trace_id`) so every process in a pod names the same
  sweep the same way without exchanging random bytes — the heartbeat
  span context (:func:`heartbeat_span_context`) stays inside the
  analysis plane's determinism pass.
* **Monotonic-only timestamps.** Spans carry ``time.monotonic()``
  start/end; serialization emits offsets relative to the trace's first
  span, so durations are non-negative by construction and no wall-clock
  ever reaches exchanged or dumped bytes.

Bounded everywhere: traces are LRU-evicted past ``max_traces``, spans
per trace are capped (a drop counter replaces the tail), and a small
global ring of recently finished spans feeds the flight recorder.
All mutation is behind a :func:`~torrent_tpu_torch.utils.locks.
named_lock`; no other named lock is ever acquired while holding it.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from collections import OrderedDict, deque

from torrent_tpu_torch.utils.locks import named_lock

__all__ = [
    "Span",
    "Tracer",
    "fabric_trace_id",
    "heartbeat_span_context",
    "tracer",
]

# current (trace_id, span_id) for the running task/thread; to_thread and
# task creation copy the context, so bridge request handlers propagate
# it naturally into their own awaits — but NOT into the scheduler's
# long-lived lane tasks, which is why submissions carry context explicitly
_current: contextvars.ContextVar[tuple[str, str] | None] = contextvars.ContextVar(
    "torrent_tpu_obs_span", default=None
)

MAX_TRACES = 256
MAX_SPANS_PER_TRACE = 256
RECENT_SPANS = 256
MAX_ATTR_STR = 200

_ID_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-"
)


def valid_trace_id(raw: str) -> bool:
    """Client-supplied trace ids are tokens, not free text: 1..64 chars
    of ``[A-Za-z0-9._-]`` (anything else would leak header bytes into
    logs, JSON dumps, and Prometheus exemplars)."""
    return 0 < len(raw) <= 64 and all(c in _ID_OK for c in raw)


def _clean_attr(value):
    """Span attrs are scalars only — payload bytes must never enter the
    trace store (the flight recorder dumps it verbatim)."""
    if isinstance(value, bool) or value is None:
        return value
    if isinstance(value, (int, float)):
        return value
    if isinstance(value, (bytes, bytearray, memoryview)):
        return f"<{len(value)} bytes>"
    s = str(value)
    return s if len(s) <= MAX_ATTR_STR else s[: MAX_ATTR_STR - 1] + "…"


class Span:
    """One stage of one trace: monotonic [t0, t1] plus scalar attrs."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "t0", "t1", "status",
        "attrs",
    )

    def __init__(self, trace_id, span_id, parent_id, name, t0, t1, status, attrs):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.status = status
        self.attrs = attrs

    def to_dict(self, epoch: float | None = None) -> dict:
        """JSON-ready form. ``epoch`` (the trace's first span start)
        turns raw monotonic stamps into relative offsets — the only
        time representation that is meaningful across a dump."""
        base = self.t0 if epoch is None else epoch
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_ms": round((self.t0 - base) * 1e3, 3),
            "duration_ms": round(max(0.0, self.t1 - self.t0) * 1e3, 3),
            "status": self.status,
            "attrs": dict(sorted(self.attrs.items())),
        }


class Tracer:
    """Bounded per-process trace store. One global instance
    (:func:`tracer`) serves the bridge, scheduler, and fabric; tests may
    construct private ones."""

    def __init__(
        self,
        max_traces: int = MAX_TRACES,
        max_spans_per_trace: int = MAX_SPANS_PER_TRACE,
    ):
        self._lock = named_lock("obs.tracer._lock")
        self._max_traces = max_traces
        self._max_spans = max_spans_per_trace
        # trace_id -> list[Span], LRU order (most recently touched last)
        self._traces: OrderedDict[str, list[Span]] = OrderedDict()
        self._dropped: dict[str, int] = {}
        self._recent: deque[Span] = deque(maxlen=RECENT_SPANS)
        self._minted = 0
        self._next_span = 0
        self.spans_total = 0

    # ------------------------------------------------------------- ids

    def mint(self) -> str:
        """A fresh trace id (bridge-side; fabric ids come from
        :func:`fabric_trace_id` so they stay deterministic)."""
        with self._lock:
            self._minted += 1
            n = self._minted
        return f"t{n:x}-{os.urandom(4).hex()}"

    def _span_id(self) -> str:
        # caller holds self._lock
        self._next_span += 1
        return f"s{self._next_span:x}"

    # --------------------------------------------------------- context

    @staticmethod
    def current_context() -> tuple[str, str] | None:
        """(trace_id, span_id) of the active span in this task, or None."""
        return _current.get()

    @contextlib.contextmanager
    def span(self, name: str, trace_id: str | None = None, **attrs):
        """Run a stage under a span. With ``trace_id`` this starts (or
        continues) that trace as a root-or-current child; without one it
        nests under the current context, or no-ops when there is none —
        the zero-cost path for untraced callers."""
        ctx = _current.get()
        parent_id = None
        if trace_id is None:
            if ctx is None:
                yield None
                return
            trace_id, parent_id = ctx
        elif ctx is not None and ctx[0] == trace_id:
            parent_id = ctx[1]
        t0 = time.monotonic()
        with self._lock:
            span_id = self._span_id()
        token = _current.set((trace_id, span_id))
        status = "ok"
        clean = {k: _clean_attr(v) for k, v in attrs.items()}
        try:
            yield span_id
        except BaseException as e:
            status = "error"
            clean["error"] = _clean_attr(repr(e))
            raise
        finally:
            _current.reset(token)
            self._store(
                Span(trace_id, span_id, parent_id, name, t0, time.monotonic(),
                     status, clean)
            )

    def add_span(
        self,
        trace_id: str,
        name: str,
        parent_id: str | None = None,
        t0: float | None = None,
        t1: float | None = None,
        status: str = "ok",
        **attrs,
    ) -> str:
        """Record a finished span explicitly (the scheduler/fabric path:
        stage boundaries are known timestamps, not ``with`` scopes).
        Returns the new span id, usable as a later stage's parent."""
        now = time.monotonic()
        t0 = now if t0 is None else t0
        t1 = max(t0, now if t1 is None else t1)
        clean = {k: _clean_attr(v) for k, v in attrs.items()}
        with self._lock:
            span_id = self._span_id()
        self._store(Span(trace_id, span_id, parent_id, name, t0, t1, status, clean))
        return span_id

    # ----------------------------------------------------------- store

    def _store(self, span: Span) -> None:
        with self._lock:
            self.spans_total += 1
            spans = self._traces.get(span.trace_id)
            if spans is None:
                spans = self._traces[span.trace_id] = []
                while len(self._traces) > self._max_traces:
                    evicted, _ = self._traces.popitem(last=False)
                    self._dropped.pop(evicted, None)
            else:
                self._traces.move_to_end(span.trace_id)
            if len(spans) >= self._max_spans:
                # keyed only by traces live in _traces and popped when
                # they evict — cardinality rides the trace ring's cap
                self._dropped[span.trace_id] = (  # bounded-by: _max_traces
                    self._dropped.get(span.trace_id, 0) + 1
                )
            else:
                spans.append(span)
            self._recent.append(span)

    # ---------------------------------------------------------- output

    def trace_ids(self) -> list[str]:
        with self._lock:
            return list(self._traces)

    def get_trace(self, trace_id: str) -> list[Span]:
        """The trace's finished spans, ordered by start time."""
        with self._lock:
            spans = list(self._traces.get(trace_id, ()))
        return sorted(spans, key=lambda s: (s.t0, s.span_id))

    def trace_tree(self, trace_id: str) -> dict | None:
        """Ordered span tree (JSON-ready): children nested under their
        parents, siblings ordered by start time, offsets relative to
        the trace's first span so durations read monotonically."""
        spans = self.get_trace(trace_id)
        if not spans:
            return None
        epoch = spans[0].t0
        nodes = {s.span_id: {**s.to_dict(epoch), "children": []} for s in spans}
        roots = []
        for s in spans:
            node = nodes[s.span_id]
            parent = nodes.get(s.parent_id) if s.parent_id else None
            (parent["children"] if parent else roots).append(node)
        with self._lock:
            dropped = self._dropped.get(trace_id, 0)
        return {
            "trace_id": trace_id,
            "span_count": len(spans),
            "dropped_spans": dropped,
            "spans": roots,
        }

    def recent_spans(self) -> list[dict]:
        """The global finished-span ring (the flight recorder's 'last N
        things that happened'), oldest first."""
        with self._lock:
            spans = list(self._recent)
        if not spans:
            return []
        epoch = min(s.t0 for s in spans)
        return [s.to_dict(epoch) for s in spans]

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._dropped.clear()
            self._recent.clear()


# ------------------------------------------------------ fabric context


# determinism-scope
def fabric_trace_id(plan_fingerprint: str, pid: int) -> str:
    """Deterministic fabric trace id: every process derives it from the
    plan fingerprint it already agrees on, so no random bytes need to
    cross the heartbeat."""
    return f"fabric-{plan_fingerprint[:12]}-p{pid}"


# determinism-scope
def heartbeat_span_context(trace_id: str, seq: int) -> dict:
    """The span context a fabric heartbeat payload carries. In the
    analysis plane's determinism scope: literal keys, monotonic-free,
    random-free — exchanged bytes must be identical across re-runs."""
    return {"seq": seq, "trace": trace_id}


_tracer = None


def tracer() -> Tracer:
    """The process-wide tracer (constructed on first use, so TSAN
    enabling in conftest instruments its lock)."""
    global _tracer
    if _tracer is None:
        _tracer = Tracer()
    return _tracer
