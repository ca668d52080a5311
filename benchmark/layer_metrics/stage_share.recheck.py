"""Leaf staging's share of the window (%), counted inside the program:
the busy seconds the port's pipeline ledger (``obs/ledger.py``) gives its
``stage`` stage in the window, over the window's seconds. On the v2
recheck a ``stage`` entry is one batch's ``_LeafPlane.stage_pieces``
(``models/v2.py``): the strided copy of the read rows into padded leaf
rows, with its wait for the previous batch's copy to the card. Moves
``setup_s`` (set-up runs one whole recheck to warm up)."""


def read(ev):
    stage = (ev.get("ledger") or {}).get("stage")
    if not stage or stage["ops"] <= 0 or not ev.get("window_s"):
        return None
    return 100.0 * stage["busy_s"] / ev["window_s"]
