"""Black-box flight recorder: bounded, always-armed, dump-on-fault.

When the plane misbehaves in production the evidence is usually gone by
the time anyone looks — the queue drained, the breaker re-closed, the
peer was distrusted an hour ago. The recorder keeps the last N finished
spans (the tracer's global ring) armed at all times and, on a trigger,
freezes a redacted JSON dump of them plus the component snapshots the
caller passes in:

* ``breaker_open``      — a lane breaker transitioned to open
* ``retry_exhausted``   — a launch failure outlived retry + bisection
* ``fabric_distrust``   — a sentinel cross-check rejected a peer's verdicts
* ``tsan_cycle``        — the runtime sanitizer observed a lock-order cycle

Each trigger produces exactly one dump (callers sit at the transition
point, not in a polling loop). Dumps are kept in a bounded ring,
served via ``GET /v1/trace`` and ``torrent-tpu trace dump``, surfaced
by ``doctor --trace``, and — when ``TORRENT_TPU_FLIGHT_DIR`` is set —
written to ``blackbox_<seq>.json`` off-thread so a crash right after
the fault still leaves the evidence on disk.

Redaction: span attrs are scalar-only by construction (tracer), and
:func:`_redact` walks every snapshot the caller passes — bytes become
length tags, long strings are truncated, depth is bounded — so piece
payloads or peer tokens can never reach a dump file.

The dump dict is assembled entirely OUTSIDE the recorder lock (and the
lock never wraps a tracer/sanitizer call), keeping the obs locks
leaves of the lock-order graph.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from torrent_tpu_torch.utils.locks import named_lock
from torrent_tpu_torch.utils.log import get_logger
from torrent_tpu_torch.utils.metrics import _esc

log = get_logger("obs.recorder")

# per-process run token in dump filenames: a restarted process must not
# overwrite the PREVIOUS run's crash evidence (the post-mortem case the
# flight dir exists for). Wall clock is fine here — filenames never
# enter exchanged or deterministic bytes.
_RUN_TOKEN = f"{int(time.time()):x}-{os.getpid():x}"

__all__ = ["FlightRecorder", "flight_recorder"]

MAX_DUMPS = 16
MAX_REDACT_DEPTH = 6
MAX_REDACT_ITEMS = 128
MAX_REDACT_STR = 300

_FLIGHT_DIR_ENV = "TORRENT_TPU_FLIGHT_DIR"


def _redact(value, depth: int = 0):
    """JSON-safe, payload-free copy of an arbitrary snapshot dict."""
    if depth >= MAX_REDACT_DEPTH:
        return "<depth>"
    if isinstance(value, bool) or value is None:
        return value
    if isinstance(value, (int, float)):
        return value
    if isinstance(value, (bytes, bytearray, memoryview)):
        return f"<{len(value)} bytes>"
    if isinstance(value, str):
        return value if len(value) <= MAX_REDACT_STR else value[:MAX_REDACT_STR] + "…"
    if isinstance(value, dict):
        return {
            str(k): _redact(v, depth + 1)
            for k, v in list(value.items())[:MAX_REDACT_ITEMS]
        }
    if isinstance(value, (list, tuple, set, frozenset)):
        items = sorted(value, key=repr) if isinstance(value, (set, frozenset)) else value
        return [_redact(v, depth + 1) for v in list(items)[:MAX_REDACT_ITEMS]]
    return _redact(repr(value), depth + 1)


class FlightRecorder:
    """Bounded dump ring. One global instance (:func:`flight_recorder`)
    is shared by the scheduler, fabric, sanitizer, and bridge."""

    def __init__(self, max_dumps: int = MAX_DUMPS):
        self._lock = named_lock("obs.recorder._lock")
        self._dumps: deque[dict] = deque(maxlen=max_dumps)
        self._seq = 0
        self._counts: dict[str, int] = {}

    def trigger(
        self,
        reason: str,
        detail: dict | None = None,
        trace_ids=(),
        snapshots: dict | None = None,
    ) -> dict:
        """Freeze one black-box dump. ``trace_ids`` name the traces
        whose full span lists matter (e.g. the failing ticket's);
        ``snapshots`` carries component state (scheduler counters +
        breakers, fabric gauges) — redacted before storage."""
        from torrent_tpu_torch.obs.tracer import tracer

        tr = tracer()
        dump = {
            "reason": reason,
            "t_mono": round(time.monotonic(), 6),
            "detail": _redact(detail or {}),
            "recent_spans": tr.recent_spans(),
            "traces": {
                tid: tr.trace_tree(tid)
                for tid in list(trace_ids)[:4]
                if tid is not None
            },
            "snapshots": _redact(snapshots or {}),
        }
        # the reference adds the sanitizer's snapshot here when it is
        # enabled; the sanitizer is not ported, so a dump has no "tsan" key
        with self._lock:
            self._seq += 1
            dump["seq"] = self._seq
            self._counts[reason] = self._counts.get(reason, 0) + 1
            self._dumps.append(dump)
        log.warning(
            "flight recorder dump #%d (%s): %d recent spans, %d traces",
            dump["seq"], reason, len(dump["recent_spans"]), len(dump["traces"]),
        )
        directory = os.environ.get(_FLIGHT_DIR_ENV)
        if directory:
            # off-thread: triggers fire from async contexts and worker
            # threads alike; neither may stall on disk
            threading.Thread(
                target=_write_dump, args=(directory, dump), daemon=True
            ).start()
        return dump

    def dumps(self) -> list[dict]:
        """Stored dumps, oldest first."""
        with self._lock:
            return list(self._dumps)

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def render_metrics(self) -> str:
        """Prometheus series for dump counts (appended to /metrics)."""
        counts = self.counts()
        lines = [
            "# HELP torrent_tpu_flight_dumps_total Black-box flight-recorder dumps by trigger reason",
            "# TYPE torrent_tpu_flight_dumps_total counter",
        ]
        for reason, n in sorted(counts.items()):
            lines.append(
                f'torrent_tpu_flight_dumps_total{{reason="{_esc(reason)}"}} {n}'
            )
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        with self._lock:
            self._dumps.clear()
            self._counts.clear()


def _write_dump(directory: str, dump: dict) -> None:
    try:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(
            directory, f"blackbox_{_RUN_TOKEN}_{dump['seq']:04d}.json"
        )
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dump, f, sort_keys=True, indent=1)
        os.replace(tmp, path)
    except OSError as e:  # best-effort: the in-memory ring still has it
        log.warning("flight recorder could not write %s: %s", directory, e)


_recorder = None


def flight_recorder() -> FlightRecorder:
    """The process-wide flight recorder."""
    global _recorder
    if _recorder is None:
        _recorder = FlightRecorder()
    return _recorder
