"""The window's recheck rate (GiB/s): every byte of every whole recheck
in the window over the window, on the host's clock. The host-bound rate
a user waits on; it spreads with the host from run to run more than a
bound allows, so it is reported per layer. Moves ``setup_s`` (set-up
runs one whole recheck to warm up)."""


def read(ev):
    work = ev.get("work_bytes")
    if not work:
        return None
    return work / ev["window_s"] / 2**30
