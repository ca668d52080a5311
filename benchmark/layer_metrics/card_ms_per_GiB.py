"""Card milliseconds a GiB of the window's work holds the device: the
union of the trace's kernel and copy intervals over the window, over the
GiB its units covered (``work_bytes``). An end-to-end metric: what a
card shared by tenants spends on each GiB it verifies, whatever the
host does meanwhile."""

from benchmark.harness import device_busy_s


def read(ev):
    trace, work = ev.get("trace"), ev.get("work_bytes")
    if trace is None or not work:
        return None
    busy = device_busy_s(trace)
    if busy <= 0:
        return None
    return 1e3 * busy / (work / 2**30)
