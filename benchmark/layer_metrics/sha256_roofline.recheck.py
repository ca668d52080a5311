"""SHA-256 rows kernel's share of its roofline (%): the least time the
frozen yardstick allows for the 16 KiB leaves the window hashed, over
the time of the rows kernel (``csrc/sha256.cu``) in the trace. Moves
``card_ms_per_GiB``."""

from benchmark.reference.yardstick import least_seconds, sha256_work

KERNEL = "sha256_rows_kernel"


def read(ev):
    trace, hashed = ev.get("trace"), ev.get("hashed")
    if trace is None or not hashed or "sha256_lengths" not in hashed:
        return None
    seconds = sum(b - a for name, a, b in trace["kernels"] if KERNEL in name) / 1e6
    if seconds <= 0:
        return None
    ops, nbytes = sha256_work(hashed["sha256_lengths"])
    return 100.0 * hashed["repeats"] * least_seconds(ops, nbytes) / seconds
