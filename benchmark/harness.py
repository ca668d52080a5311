"""The harness's general parts: finding a cell's files by name, the
window's hooks (counters, spans, the profiler's annotation), the reading
of a profiler trace, and the result line.

Nothing here knows a particular cell, configuration, traffic mix or
metric: those are files found by the names in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from benchmark.reference.yardstick import merged, union_s

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "torrent_tpu")
WINDOW_ANNOTATION = "bench.window"


# ------------------------------------------------------------ finding files


def load_benchmark(path: Path | None = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str) -> dict:
    entry = find(bench["configs"], name, "configuration")
    with open(ROOT / entry["file"]) as f:
        return json.load(f)


def load_traffic(name: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _load_file(kind: str, name: str):
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str):
    """The module ``drivers/<name>.py``."""
    return _load_file("drivers", name)


def metrics_for(entries: list, cell: str, reported: set | None = None) -> list:
    """The metrics of ``entries`` a cell reports: those that list it under
    ``workloads``, and those without the key (every cell, or for a
    per-layer metric every cell that reports the end-to-end metric it
    ``moves``)."""
    out = []
    for m in entries:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif reported is None or m.get("moves") in reported:
            out.append(m)
    return out


def load_reader(name: str):
    """The ``read(evidence)`` function of ``layer_metrics/<name>.py``."""
    return _load_file("layer_metrics", name).read


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``torrent_tpu_torch`` is not
    ``torrent_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


# ------------------------------------------------------------ the window


@dataclass
class Hooks:
    """What a driver calls around its timed units: ``start()`` just before
    the first, ``end()`` just after the last has completed. With a
    profiler running, the window is the ``bench.window`` annotation of
    the trace; either way the port's pipeline ledger is read at both
    ends, and a driver adds its own evidence to ``evidence``."""

    traced: bool = False
    t0: float = 0.0
    t1: float = 0.0
    ledger0: dict = field(default_factory=dict)
    ledger1: dict = field(default_factory=dict)
    evidence: dict = field(default_factory=dict)
    _annotation: object = None

    def start(self) -> None:
        from torrent_tpu_torch.obs.ledger import pipeline_ledger

        self.ledger0 = pipeline_ledger().snapshot()["stages"]
        if self.traced:
            import torch

            self._annotation = torch.profiler.record_function(WINDOW_ANNOTATION)
            self._annotation.__enter__()
        self.t0 = time.perf_counter()

    def end(self) -> None:
        from torrent_tpu_torch.obs.ledger import pipeline_ledger

        self.t1 = time.perf_counter()
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None
        self.ledger1 = pipeline_ledger().snapshot()["stages"]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def ledger_delta(self) -> dict:
        """Busy seconds, bytes and entries of each ledger stage in the window."""
        out = {}
        for name, s1 in self.ledger1.items():
            s0 = self.ledger0.get(name, {"busy_s": 0.0, "bytes": 0, "ops": 0})
            out[name] = {k: s1[k] - s0[k] for k in ("busy_s", "bytes", "ops")}
        return out


# ------------------------------------------------------------ the trace

_DEVICE_KERNEL = ("kernel",)
_DEVICE_COPY = ("gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")


def read_trace(path: str) -> dict:
    """The device's kernels and copies, and the host's events, of a Chrome
    trace written by ``torch.profiler``, clipped to its ``bench.window``
    annotation. Times in microseconds of the trace's clock."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == WINDOW_ANNOTATION and e.get("cat") == "user_annotation"]
    if not windows:
        raise ValueError("the trace has no bench.window annotation")
    w = windows[0]
    lo, hi = float(w["ts"]), float(w["ts"]) + float(w.get("dur", 0))
    kernels, copies, host = [], [], []
    for e in events:
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        if b <= lo or a >= hi:
            continue
        a, b = max(a, lo), min(b, hi)
        cat = e.get("cat")
        name = e.get("name", "")
        if cat in _DEVICE_KERNEL:
            kernels.append((name, a, b))
        elif cat in _DEVICE_COPY:
            copies.append((name, a, b, int((e.get("args") or {}).get("bytes", 0) or 0)))
        elif cat in _HOST and name != WINDOW_ANNOTATION:
            host.append((name, a, b))
    return {"window_us": (lo, hi), "kernels": kernels, "copies": copies, "host": host}


def device_busy_s(trace: dict) -> float:
    """Seconds of the window in which a kernel or a copy ran."""
    return union_s([(a, b) for _, a, b in trace["kernels"]] + [(a, b) for _, a, b, _ in trace["copies"]])


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    gaps summed by the innermost host event open at each gap's middle
    (``host`` where none was)."""
    ops: dict[str, float] = {}
    for name, a, b in trace["kernels"]:
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
    for name, a, b, _ in trace["copies"]:
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
    lo, hi = trace["window_us"]
    busy = merged([(a, b) for _, a, b in trace["kernels"]] + [(a, b) for _, a, b, _ in trace["copies"]])
    gaps, cursor = [], lo
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if hi > cursor:
        gaps.append((cursor, hi))
    host = sorted(trace["host"], key=lambda e: e[1])
    idle: dict[str, float] = {}
    active: list = []  # host events open at the sweep's point (nesting is shallow)
    i = 0
    for a, b in gaps:  # in time order
        mid = (a + b) / 2
        while i < len(host) and host[i][1] <= mid:
            active.append(host[i])
            i += 1
        active = [e for e in active if e[2] >= mid]
        name = min(active, key=lambda e: e[2] - e[1])[0] if active else "host"
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    by_time = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
    return {"device_ops": by_time(ops), "idle_gaps": by_time(idle)}


# ------------------------------------------------------------ the result


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict, breakdown=None, checks=None) -> str:
    """The contract's last line; ``checks`` (each number compared beside
    its limit) comes last."""
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks or {}
    return json.dumps(out)
