"""Host-to-device copy rate (GiB/s): bytes of the trace's HtoD memcpy
events over the union of their intervals (``models/verifier.py``'s
pinned slots, ``models/v2.py::_LeafPlane``). Moves ``card_ms_per_GiB``."""

from benchmark.reference.yardstick import union_s


def read(ev):
    trace = ev.get("trace")
    if trace is None:
        return None
    h2d = [(a, b, n) for name, a, b, n in trace["copies"] if "HtoD" in name and n > 0]
    if not h2d:
        return None
    return sum(n for _, _, n in h2d) / union_s([(a, b) for a, b, _ in h2d]) / 2**30
