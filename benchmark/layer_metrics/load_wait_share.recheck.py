"""The hashing thread's wait for the storage read (%): the union of the
trace's ``verify.wait_load`` host regions (``parallel/verify.py``: the
wait for the loader thread's ``Storage.read_batch`` of the next batch),
clipped to the window, over the window. Moves ``setup_s`` (set-up runs
one whole recheck to warm up)."""

from benchmark.reference.yardstick import union_s

SPAN = "verify.wait_load"


def read(ev):
    trace = ev.get("trace")
    if trace is None:
        return None
    spans = [(a, b) for name, a, b in trace["host"] if name == SPAN]
    lo, hi = trace["window_us"]
    if not spans or hi <= lo:
        return None
    return 100.0 * union_s(spans) / ((hi - lo) / 1e6)
