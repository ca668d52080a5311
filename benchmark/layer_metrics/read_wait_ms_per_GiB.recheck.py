"""Storage read's wait for the native pread pool's lock (ms/GiB), counted
inside the program: the busy seconds the port's pipeline ledger
(``obs/ledger.py``) gives its ``read_wait`` counter in the window (each
``NativeIOEngine.read_into`` call's wait for the pool's one lock, the
stripes of a load included), in milliseconds, over the GiB the window's
units covered (``work_bytes``). A rate, not a share of the window: the
stripes of a load can wait at once. Nothing where the program keeps no
such counter. Moves ``setup_s`` (set-up runs one whole recheck to warm
up)."""


def read(ev):
    stage, work = (ev.get("ledger") or {}).get("read_wait"), ev.get("work_bytes")
    if not stage or stage["ops"] <= 0 or not work:
        return None
    return 1e3 * stage["busy_s"] / (work / 2**30)
