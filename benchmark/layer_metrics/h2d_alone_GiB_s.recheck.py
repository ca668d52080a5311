"""Host-to-device copy rate with no load beside it (GiB/s), timed inside
the program: the bytes the port's pipeline ledger (``obs/ledger.py``)
gives its ``h2d_alone`` counter in the window over its busy seconds. Each
op is one slot copy (data rows and block counts) timed on the card by two
events on its stream, enqueued while the loader had no load running (the
last batch of a recheck). Nothing where the program keeps no such
counter. Moves ``card_ms_per_GiB``."""


def read(ev):
    stage = (ev.get("ledger") or {}).get("h2d_alone")
    if not stage or stage["ops"] <= 0 or stage["busy_s"] <= 0 or stage["bytes"] <= 0:
        return None
    return stage["bytes"] / stage["busy_s"] / 2**30
