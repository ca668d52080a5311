"""Storage read's share of the window (%): seconds in which at least one
``Storage.read_batch`` (``storage/storage.py`` → ``native/io_engine.py``)
was in flight, from the benchmark's own spans around each call, over
the window's seconds. Moves ``setup_s`` (set-up runs one whole
recheck to warm up)."""

from benchmark.reference.yardstick import union_s


def read(ev):
    spans = ev.get("read_spans")
    if not spans:
        return None
    lo, hi = ev["window"]
    inside = [(max(a, lo) * 1e6, min(b, hi) * 1e6) for a, b in spans if b > lo and a < hi]
    return 100.0 * union_s(inside) / (hi - lo)
