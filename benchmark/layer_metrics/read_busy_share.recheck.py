"""Storage read's busy share of the window (%), counted inside the
program: the busy seconds the port's pipeline ledger (``obs/ledger.py``)
gives its ``read`` stage in the window, over the window's seconds. A
``read`` entry is one ``Storage.read_batch`` call (its zero-fill,
segment planning and preads), less any wait for the pread pool's lock;
``read_share.recheck`` times the same calls from outside. Moves
``setup_s`` (set-up runs one whole recheck to warm up)."""


def read(ev):
    stage = (ev.get("ledger") or {}).get("read")
    if not stage or stage["ops"] <= 0 or not ev.get("window_s"):
        return None
    return 100.0 * stage["busy_s"] / ev["window_s"]
