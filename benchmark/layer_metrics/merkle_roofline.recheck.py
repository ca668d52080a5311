"""Merkle kernel's share of its roofline (%): the least time the frozen
yardstick allows for the pairs of the pieces' trees the window reduced,
over the time of the merkle kernel (``csrc/sha256.cu``) in the trace.
Moves ``card_ms_per_GiB``."""

from benchmark.reference.yardstick import least_seconds, merkle_work

KERNEL = "sha256_merkle_kernel"


def read(ev):
    trace, hashed = ev.get("trace"), ev.get("hashed")
    if trace is None or not hashed or "merkle_trees" not in hashed:
        return None
    seconds = sum(b - a for name, a, b in trace["kernels"] if KERNEL in name) / 1e6
    if seconds <= 0:
        return None
    ops, nbytes = merkle_work(hashed["merkle_trees"])
    return 100.0 * hashed["repeats"] * least_seconds(ops, nbytes) / seconds
