"""SHA-1 rows kernel's share of its roofline (%): the least time the
frozen yardstick allows for the whole pieces the window hashed, over
the time of the rows kernel (``csrc/sha1.cu``) in the trace. Moves
``card_ms_per_GiB``."""

from benchmark.reference.yardstick import least_seconds, sha1_work

KERNEL = "sha1_rows_kernel"


def read(ev):
    trace, hashed = ev.get("trace"), ev.get("hashed")
    if trace is None or not hashed or "sha1_lengths" not in hashed:
        return None
    seconds = sum(b - a for name, a, b in trace["kernels"] if KERNEL in name) / 1e6
    if seconds <= 0:
        return None
    ops, nbytes = sha1_work(hashed["sha1_lengths"])
    return 100.0 * hashed["repeats"] * least_seconds(ops, nbytes) / seconds
