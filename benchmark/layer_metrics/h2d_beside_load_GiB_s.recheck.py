"""Host-to-device copy rate with a load beside it (GiB/s), timed inside
the program: the bytes the port's pipeline ledger (``obs/ledger.py``)
gives its ``h2d_beside_load`` counter in the window over its busy
seconds. Each op is one slot copy (data rows and block counts) timed on
the card by two events on its stream, enqueued while the loader's next
load was running (its reads and zero-fills share the host's memory with
the copy). Nothing where the program keeps no such counter. Moves
``card_ms_per_GiB``."""


def read(ev):
    stage = (ev.get("ledger") or {}).get("h2d_beside_load")
    if not stage or stage["ops"] <= 0 or stage["busy_s"] <= 0 or stage["bytes"] <= 0:
        return None
    return stage["bytes"] / stage["busy_s"] / 2**30
