"""The native pread pool's lock wait, counted: ``read_wait``.

Every ``NativeIOEngine.read_into`` call charges the seconds it waited
for the engine's lock to the pipeline ledger's ``read_wait`` counter
(bytes: what the call then read; ops: the calls), whether its caller
passed a ``read`` entry or not (the stripes of a v1 load pass none).
The counter is recorded with ``PipelineLedger.record``: it opens no
occupancy window, so the overlap integral, ``max_concurrent_stages``
and the ``active`` counts never see it, and ``obs/attrib.py`` never
takes it for the limiting stage. A tracked caller's ``read`` still
leaves the wait out. While a ``torch.profiler`` runs the wait is an
``io.wait_engine`` region; with none, ``record_function`` is never
entered. All on the CPU, at a few KiB.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch

from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.native.io_engine import get_engine, native_available
from torrent_tpu_torch.obs import ledger as ledger_mod
from torrent_tpu_torch.obs.attrib import attribute, format_report
from torrent_tpu_torch.obs.ledger import PipelineLedger, pipeline_ledger
from torrent_tpu_torch.storage.storage import FsStorage, Storage
from torrent_tpu_torch.tools.make_torrent import make_torrent

pytestmark = pytest.mark.skipif(not native_available(), reason="native toolchain unavailable")

PLEN, PIECES = 1024, 8
HOLD = 0.3  # seconds the test holds the engine's lock


@pytest.fixture
def storage(tmp_path):
    path = tmp_path / "data.bin"
    path.write_bytes(np.random.default_rng(21).bytes(PIECES * PLEN - 99))
    info = parse_metainfo(make_torrent(str(path), "http://t.invalid/announce", piece_length=PLEN, hasher="cpu")).info
    s = Storage(FsStorage(str(tmp_path)), info)
    s.read_batch(range(PIECES))  # builds the engine and opens everything first
    return s


@pytest.fixture
def fresh_ledger(monkeypatch):
    """A ledger of this test's own, in the process-global ledger's place."""
    led = PipelineLedger()
    monkeypatch.setattr(ledger_mod, "_ledger", led)
    return led


def _read_under_held_lock(storage) -> float:
    """Two threads read while the engine's lock is held for ``HOLD``
    seconds: one as a tracked caller (its own ``read`` entry), one as a
    stripe (``track=False``). Returns the wall the two reads took."""
    engine = get_engine()
    held, started = threading.Event(), threading.Event()

    def hold():
        with engine._lock:
            held.set()
            started.wait()
            time.sleep(HOLD)

    holder = threading.Thread(target=hold)
    holder.start()
    held.wait()
    readers = [
        threading.Thread(target=storage.read_batch, args=(range(0, 4),)),
        threading.Thread(target=storage.read_batch, args=(range(4, PIECES),), kwargs={"track": False}),
    ]
    t0 = time.monotonic()
    for r in readers:
        r.start()
    started.set()
    for r in readers + [holder]:
        r.join()
    return time.monotonic() - t0


def test_lock_wait_is_charged_to_read_wait(storage, fresh_ledger):
    wall = _read_under_held_lock(storage)
    s = fresh_ledger.snapshot()["stages"]
    wait = s["read_wait"]
    # both calls waited for the held lock, tracked or not
    assert wait["ops"] == 2
    assert wait["bytes"] == storage.info.length
    assert HOLD <= wait["busy_s"] <= 2 * wall
    # the tracked caller's read entry leaves its wait out
    assert s["read"]["ops"] == 1
    assert s["read"]["busy_s"] < HOLD / 2


def test_read_wait_opens_no_occupancy_window(storage, fresh_ledger):
    _read_under_held_lock(storage)
    snap = fresh_ledger.snapshot()
    assert snap["stages"]["read_wait"]["max_active"] == 0
    assert snap["stages"]["read_wait"]["active"] == 0
    # read alone was ever occupied: no second stage, no overlap
    assert snap["overlap"]["busy_s"] == 0.0
    assert snap["overlap"]["max_concurrent_stages"] == 1


def test_every_call_counts_one_wait(storage, fresh_ledger):
    """An uncontended call waits next to nothing, but is counted."""
    out = np.zeros((3, PLEN), dtype=np.uint8)
    storage.read_batch(range(3), out=out)
    storage.read_batch(range(3, 6), out=out, track=False)
    wait = fresh_ledger.snapshot()["stages"]["read_wait"]
    assert wait["ops"] == 2 and wait["bytes"] == 6 * PLEN
    assert 0.0 <= wait["busy_s"] < 0.5


def _snapshot(stages: dict, wall: float = 10.0) -> dict:
    full = {n: {"busy_s": b, "bytes": nb, "ops": ops, "active": 0, "max_active": 1} for n, (b, nb, ops) in stages.items()}
    return {"t_first": 0.0, "t_last": wall, "t_snap": wall,
            "overlap": {"busy_s": 0.0, "concurrent_stages": 0, "max_concurrent_stages": 2}, "stages": full}


@pytest.mark.parametrize(
    "stages",
    [
        {"read": (2.0, 1 << 30, 2), "launch": (0.5, 1 << 30, 2)},
        {"read": (1.0, 1 << 30, 2), "stage": (3.0, 1 << 30, 2), "h2d": (0.2, 1 << 30, 2)},
        {"h2d": (4.0, 1 << 20, 9), "launch": (4.0, 1 << 30, 9)},
    ],
    ids=["read", "stage", "tie"],
)
def test_attribution_never_names_the_wait(stages):
    """A wait larger than any stage changes neither the limiting stage nor
    the rate the others demand."""
    without = attribute(_snapshot(stages))
    with_wait = attribute(_snapshot(dict(stages, read_wait=(9.0, 1 << 40, 7))))
    assert with_wait["bottleneck"] == without["bottleneck"]
    assert with_wait["bottleneck"]["stage"] != "read_wait"
    assert with_wait["stages"]["read_wait"]["busy_s"] == 9.0
    assert format_report(with_wait).startswith(f"{without['bottleneck']['stage']} limits the pipeline")


def test_attribution_of_a_real_contended_read(storage, fresh_ledger):
    _read_under_held_lock(storage)
    rep = attribute(fresh_ledger.snapshot())
    assert rep["stages"]["read_wait"]["busy_s"] > rep["stages"]["read"]["busy_s"]
    assert rep["bottleneck"]["stage"] == "read"


# ------------------------------------------------------------ the region


class _Spy:
    """Stands in for ``record_function``: counts the regions opened."""

    opened: list = []

    def __init__(self, name, *args):
        self.name = name

    def __enter__(self):
        _Spy.opened.append(self.name)
        return self

    def __exit__(self, *exc):
        return False


def test_no_region_without_a_profiler(storage, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Spy)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _Spy)
    monkeypatch.setattr(_Spy, "opened", [])
    storage.read_batch(range(2), track=False)
    assert _Spy.opened == []


def test_wait_is_a_region_under_a_profiler(storage, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        storage.read_batch(range(2), track=False)
        storage.read_batch(range(2, 4))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    waits = [e for e in events if e["name"] == "io.wait_engine"]
    assert len(waits) == 2
    # the tracked call's wait lies inside its read entry
    (read,) = [e for e in events if e["name"] == "pipeline.read"]
    lo, hi = float(read["ts"]), float(read["ts"]) + float(read["dur"])
    assert any(lo <= float(w["ts"]) and float(w["ts"]) + float(w["dur"]) <= hi for w in waits)


def test_global_ledger_counts_the_wait(storage):
    """The process-global ledger, as the benchmark reads it."""
    before = pipeline_ledger().snapshot()["stages"].get("read_wait", {"ops": 0})["ops"]
    storage.read_batch(range(2), track=False)
    assert pipeline_ledger().snapshot()["stages"]["read_wait"]["ops"] == before + 1
