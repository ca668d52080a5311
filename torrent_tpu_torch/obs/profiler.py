"""Deep-dive profiler tier above the always-on tracer.

The obs plane has three tiers: always-on latency histograms
(``obs/hist``), per-ticket span tracing (``obs/tracer``), and — this
module — a ``torch.profiler`` capture of the first N hash batches, the
heavyweight tool for kernel-level work. Every batch is a named
``torch.profiler.record_function`` region, and so is every stage entry
of the pipeline ledger (``pipeline.<stage>``) and every wait the direct
recheck paths annotate (``verify.*``), so they show in any profile the
caller takes: the card's idle gaps carry the program's own names on the
trace's clock. With no profiler running a region costs one flag read
(:func:`profiling`). With capture on, the first N batches are profiled
(CPU and, on a GPU, CUDA activity) and written as one Chrome trace.

Set ``TORRENT_TPU_PROFILE=/some/dir`` to capture;
``TORRENT_TPU_PROFILE_BATCHES`` (default 8) bounds how many batches the
trace spans. Both knobs are read on every call, so enabling capture
after import works. Batches run in any worker thread, while
``torch.profiler`` keeps its host-side state per thread: one thread of
this module's own starts and stops every capture, which records every
thread's host events (``profile_all_threads``, where the installed torch
has it) and the card's activity, traced process-wide. The trace lands in
``<dir>/torrent_tpu_torch_trace.json`` when the N-th batch ends, when
the caller calls :func:`flush_trace`, or at interpreter exit.
:func:`device_busy` reads the card's own kernel and copy time back
from such a trace: the busy share that host-clock spans cannot give,
because spans of concurrent threads overlap and hold the threads'
waits for the GIL.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import sys
import threading

from torrent_tpu_torch.utils.locks import named_lock
from torrent_tpu_torch.utils.log import get_logger

log = get_logger("obs.profiler")

_PROFILE_ENV = "TORRENT_TPU_PROFILE"
_BATCHES_ENV = "TORRENT_TPU_PROFILE_BATCHES"
TRACE_NAME = "torrent_tpu_torch_trace.json"

_prof = None  # the open torch.profiler.profile, while capturing
_trace_done = False  # capture happens once; later batches run unprofiled
_batches_seen = 0
# pipelined launches run in concurrent worker threads
_lock = named_lock("obs.profiler._lock")
_owner_jobs = None  # the queue of the thread that starts and stops captures


def _on_owner(fn):
    """Run ``fn`` on the capture's own daemon thread (started on first
    use, under ``_lock``) and return its result or raise its error. A
    daemon thread, not an executor: an executor refuses work once the
    interpreter is shutting down, where the atexit flush runs."""
    global _owner_jobs
    if _owner_jobs is None:
        jobs = _owner_jobs = queue.SimpleQueue()

        def serve():
            while True:
                job, out, done = jobs.get()
                try:
                    out.append((True, job()))
                except BaseException as e:  # handed back to the caller
                    out.append((False, e))
                done.set()

        threading.Thread(target=serve, name="torrent-tpu-profiler", daemon=True).start()
    out, done = [], threading.Event()
    _owner_jobs.put((fn, out, done))
    done.wait()
    ok, value = out[0]
    if not ok:
        raise value
    return value


def _new_profile(torch):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig

        cfg = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):  # a torch without the option
        return torch.profiler.profile(activities=activities)
    return torch.profiler.profile(activities=activities, experimental_config=cfg)


def profile_dir() -> str | None:
    """Where to write the capture, or None when profiling is off.
    Read from the environment on every call — never cached at import."""
    return os.environ.get(_PROFILE_ENV) or None


def profile_batches() -> int:
    """How many batches the capture spans (invalid values fall back
    to the default rather than raising on the hot path)."""
    raw = os.environ.get(_BATCHES_ENV, "")
    try:
        n = int(raw) if raw else 8
    except ValueError:
        return 8
    return n if n > 0 else 8


def _stop_locked(trace_dir: str) -> str | None:
    """Stop the open capture on its own thread and write it; the trace's
    path, or None when there was none or it failed (logged: a profiler
    or a full disk must not fail the batch)."""
    global _prof, _trace_done
    prof, _prof = _prof, None
    _trace_done = True
    if prof is None:
        return None
    path = os.path.join(trace_dir, TRACE_NAME)
    try:
        _on_owner(prof.stop)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(path)
    except Exception as e:
        log.warning("profiler trace failed: %s", e)
        return None
    log.info("profiler trace written → %s", path)
    return path


def flush_trace(trace_dir: str | None = None) -> str | None:
    """Stop an open capture now and write its trace (idempotent; also
    registered atexit once a capture starts). Returns the trace's path,
    or None when no capture was open or writing it failed."""
    trace_dir = trace_dir or profile_dir()
    with _lock:
        if _prof is None or trace_dir is None:
            return None
        return _stop_locked(trace_dir)


# Chrome-trace categories of the card's own work (CUPTI activity records)
_KERNEL_CATS = ("kernel",)
_COPY_CATS = ("gpu_memcpy", "gpu_memset")


def _union_s(spans: list) -> float:
    """Seconds covered by the union of ``(start_us, end_us)`` spans."""
    total = 0.0
    start = end = None
    for a, b in sorted(spans):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total / 1e6


def device_busy(trace_path: str) -> dict:
    """The card's busy time in a Chrome trace written by this module:
    ``kernel_s`` and ``copy_s`` (the union of each category's device
    intervals), ``busy_s`` (the union of both: time the card was doing
    either), ``span_s`` (first device event's start to last one's end),
    and the events' counts (``kernels``, ``copies``; ``kernel_names``
    counts kernels by name). All zero when the trace holds no device
    events (a CPU-only capture)."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels, copies, names = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in _KERNEL_CATS or cat in _COPY_CATS:
            span = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            if cat in _KERNEL_CATS:
                kernels.append(span)
                names[e.get("name", "")] = names.get(e.get("name", ""), 0) + 1
            else:
                copies.append(span)
    both = kernels + copies
    return {
        "kernel_s": _union_s(kernels),
        "copy_s": _union_s(copies),
        "busy_s": _union_s(both),
        "span_s": (max(b for _, b in both) - min(a for a, _ in both)) / 1e6 if both else 0.0,
        "kernels": len(kernels),
        "copies": len(copies),
        "kernel_names": names,
    }


_autograd_profiler = None  # torch.autograd.profiler, once torch is loaded
_NO_REGION = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a ``torch.profiler`` capture runs in this process, by
    anyone: one flag read, and never an import of torch (a process that
    has not loaded it runs no profiler)."""
    global _autograd_profiler
    flags = _autograd_profiler
    if flags is None:
        torch = sys.modules.get("torch")
        flags = getattr(getattr(torch, "autograd", None), "profiler", None)
        if flags is None:
            return False
        _autograd_profiler = flags
    return flags._is_profiler_enabled


def annotate(name: str):
    """Named region in the profiler's timeline: a
    ``torch.profiler.record_function`` while a profiler runs, else a
    context that does nothing (:func:`profiling`'s one flag read)."""
    if not profiling():
        return _NO_REGION
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def maybe_profile_batch(name: str):
    """A batch: an :func:`annotate` region named ``name``, and the first
    N of them profiled when TORRENT_TPU_PROFILE is set."""
    global _prof, _batches_seen, _trace_done
    trace_dir = profile_dir()
    if trace_dir is None or _trace_done:
        with annotate(name):
            yield
        return
    import torch

    with _lock:
        if _prof is None and not _trace_done:
            try:
                prof = _new_profile(torch)
                _on_owner(prof.start)
            except Exception as e:  # no capture must not fail the batch
                log.warning("profiler capture failed to start: %s", e)
                _trace_done = True
            else:
                _prof = prof
                # runs with fewer than N batches would otherwise exit
                # with the capture open and unwritten
                import atexit

                atexit.register(flush_trace, trace_dir)
                log.info("profiler capture started → %s", trace_dir)
        _batches_seen += 1
    try:
        with annotate(name):
            yield
    finally:
        with _lock:
            if _batches_seen >= profile_batches() and _prof is not None:
                _stop_locked(trace_dir)
                log.info("profiler capture stopped after %d batches", _batches_seen)
