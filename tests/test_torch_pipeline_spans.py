"""The pipeline ledger's stages on the recheck routes, and their regions
on the profiler's clock.

The v2 recheck (``parallel/verify.py::verify_pieces_v2_gpu``) and every
v1 route through ``models/verifier.py::GPUVerifier``'s recheck loop
(``verify_storage``, ``parallel/distributed.py::verify_storage_distributed``
at world size 1, and ``parallel/bulk.py::verify_library``) charge the
ledger's ``stage``, ``h2d``, ``launch`` and ``digest`` once a batch, and
``read`` once a batch's load: once a ``Storage.read_batch`` call, less
any wait for the pread pool's lock, or once over the concurrent calls of
a striped load (``read_runs``), so that ``read`` never adds up to more
than the wall time. While a ``torch.profiler`` runs, every stage entry is a
``pipeline.<stage>`` region and every batch a ``verify.v1.batch`` /
``verify.v2.batch`` region holding its thread's stages and waits; with
none running, a region costs one flag read and ``record_function`` is
never entered. All on the CPU (plain SHA-1 and SHA-256), at small sizes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.models.v2 import BLOCK, build_v2
from torrent_tpu_torch.models.verifier import GPUVerifier
from torrent_tpu_torch.native.io_engine import get_engine, native_available
from torrent_tpu_torch.obs import profiler
from torrent_tpu_torch.obs.ledger import PipelineLedger, pipeline_ledger
from torrent_tpu_torch.parallel.bulk import verify_library
from torrent_tpu_torch.parallel.distributed import verify_storage_distributed
from torrent_tpu_torch.parallel.verify import verify_pieces_v2_gpu
from torrent_tpu_torch.session.v2 import v2_session_info
from torrent_tpu_torch.storage.storage import FsStorage, MemoryStorage, Storage
from torrent_tpu_torch.tools.make_torrent import make_torrent

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("read", "stage", "h2d", "launch", "digest")
V1_PLEN = 1024  # small pieces: the plain SHA-1 stays quick
V1_PIECES, V1_BATCH, V1_STRIPES = 20, 8, 3  # batches of 8, 8, 4; stripes 3, 3, 2
V2_FILES, V2_BATCH = 7, 3  # single-leaf pieces (one short file each): batches of 3, 3, 1


def _delta(before: dict, after: dict) -> dict:
    zero = {"busy_s": 0.0, "bytes": 0, "ops": 0}
    return {
        s: {k: after.get(s, zero)[k] - before.get(s, zero)[k] for k in zero}
        for s in STAGES
    }


def _counted(storage: Storage) -> list:
    """Wrap ``storage.read_batch`` to count its calls, as the benchmark's
    read spans do."""
    calls, real = [], storage.read_batch

    def read_batch(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    storage.read_batch = read_batch
    return calls


def _v2_torrent(tmp_path):
    """A v2 torrent of short single-piece files (one leaf each) on disk,
    and a fresh storage over it."""
    rng = np.random.default_rng(18)
    files = [((f"f{i}.bin",), rng.bytes(700 + 100 * i)) for i in range(V2_FILES)]
    (tmp_path / "tor").mkdir()
    for (name,), data in files:
        (tmp_path / "tor" / name).write_bytes(data)
    meta = build_v2(files, name="tor", piece_length=2 * BLOCK, hasher="cpu")
    info = v2_session_info(meta.info, meta.piece_layers)
    assert info.num_pieces == V2_FILES
    return Storage(FsStorage(str(tmp_path)), info), info


def _v1_torrent(tmp_path):
    path = tmp_path / "data.bin"
    path.write_bytes(np.random.default_rng(19).bytes(V1_PIECES * V1_PLEN - 77))
    info = parse_metainfo(
        make_torrent(str(path), "http://t.invalid/announce", piece_length=V1_PLEN, hasher="cpu")
    ).info
    return Storage(FsStorage(str(tmp_path)), info), info


def _n_batches(n: int, batch: int) -> int:
    return -(-n // batch)


def _v1_recheck(storage, info, route: str = "direct"):
    if route == "distributed":
        bitfield, _ = verify_storage_distributed(
            storage, info, batch_size=V1_BATCH, device="cpu", io_threads=V1_STRIPES
        )
        return bitfield
    if route == "bulk":
        result = verify_library([(storage, info)], batch_size=V1_BATCH, device="cpu", io_threads=V1_STRIPES)
        return result.bitfields[0]
    verifier = GPUVerifier(piece_length=V1_PLEN, batch_size=V1_BATCH, device="cpu")
    return verifier.verify_storage(storage, info, io_threads=V1_STRIPES)


# ------------------------------------------------------------ the stages


def test_v2_recheck_charges_every_stage_once_a_batch(tmp_path):
    storage, info = _v2_torrent(tmp_path)
    calls = _counted(storage)
    before = pipeline_ledger().snapshot()["stages"]
    bitfield = verify_pieces_v2_gpu(storage, info, batch_size=V2_BATCH, device="cpu")
    d = _delta(before, pipeline_ledger().snapshot()["stages"])
    assert bitfield.all()
    batches = _n_batches(V2_FILES, V2_BATCH)
    assert [d[s]["ops"] for s in ("stage", "h2d", "launch", "digest")] == [batches] * 4
    assert d["read"]["ops"] == len(calls) == batches
    payload = sum(info.piece_sizes)
    assert d["read"]["bytes"] == d["stage"]["bytes"] == payload
    assert d["digest"]["bytes"] == V2_FILES


@pytest.mark.parametrize("route", ["direct", "distributed", "bulk"])
def test_v1_recheck_charges_every_stage_once_a_batch(tmp_path, route):
    storage, info = _v1_torrent(tmp_path)
    calls = _counted(storage)
    before = pipeline_ledger().snapshot()["stages"]
    t0 = time.monotonic()
    bitfield = _v1_recheck(storage, info, route)
    wall = time.monotonic() - t0
    d = _delta(before, pipeline_ledger().snapshot()["stages"])
    assert bitfield.all()
    batches = _n_batches(V1_PIECES, V1_BATCH)
    assert [d[s]["ops"] for s in ("stage", "h2d", "launch", "digest")] == [batches] * 4
    # every batch of more rows than stripes is read in stripes, each its
    # own call, and the stripes of a batch are one read entry; a library
    # reads one run a torrent in a batch
    assert len(calls) == (batches if route == "bulk" else 3 + 3 + 2)
    assert d["read"]["ops"] == batches
    assert d["read"]["bytes"] == d["stage"]["bytes"] == info.length
    assert d["read"]["busy_s"] <= wall


def test_v1_striped_read_stays_within_the_wall(tmp_path):
    """Stripes that read at once are one ``read`` entry: with every piece
    a slow read (0.05 s), an entry a stripe would add up to about twice
    the recheck's wall time."""
    _, info = _v1_torrent(tmp_path)
    storage = Storage(MemoryStorage(), info)
    storage.method.set((info.name,), 0, (tmp_path / "data.bin").read_bytes())
    get = storage.method.get

    def slow_get(*args):
        time.sleep(0.05)
        return get(*args)

    storage.method.get = slow_get
    before = pipeline_ledger().snapshot()["stages"]
    t0 = time.monotonic()
    bitfield = _v1_recheck(storage, info)
    wall = time.monotonic() - t0
    d = _delta(before, pipeline_ledger().snapshot()["stages"])
    assert bitfield.all()
    assert d["read"]["ops"] == _n_batches(V1_PIECES, V1_BATCH)
    assert d["read"]["bytes"] == info.length
    # 20 reads of 0.05 s: 1 s summed over the stripes, about 0.4 s of wall
    assert 0.3 <= d["read"]["busy_s"] <= wall


# ------------------------------------------------------------ the regions


def _regions(prof, tmp_path) -> list[dict]:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(outer: dict, events: list[dict], name: str) -> list[dict]:
    lo, hi = float(outer["ts"]), float(outer["ts"]) + float(outer["dur"])
    return [
        e for e in events
        if e["name"] == name and e["tid"] == outer["tid"]
        and lo <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= hi
    ]


@pytest.mark.parametrize("version", ["v1", "v1-distributed", "v1-bulk", "v2"])
def test_batch_regions_hold_their_stages_on_one_thread(tmp_path, version):
    """Each batch region holds this thread's wait for the loader, and the
    copy and launches of its batch; the fetch of a batch's verdicts lands
    in the next batch's region (the last batch fetches its own too), so
    the card hashes one batch while the host waits for the one before."""
    if version == "v2":
        storage, info = _v2_torrent(tmp_path)
        batches = _n_batches(V2_FILES, V2_BATCH)
        run = lambda: verify_pieces_v2_gpu(storage, info, batch_size=V2_BATCH, device="cpu")  # noqa: E731
        here = ("verify.wait_load", "pipeline.stage", "pipeline.h2d", "pipeline.launch")
    else:
        storage, info = _v1_torrent(tmp_path)
        batches = _n_batches(V1_PIECES, V1_BATCH)
        run = lambda: _v1_recheck(storage, info, version.partition("-")[2] or "direct")  # noqa: E731
        # v1 stages its batches on the loader thread
        here = ("verify.wait_load", "pipeline.h2d", "pipeline.launch")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert run().all()
    events = _regions(prof, tmp_path)
    regions = sorted((e for e in events if e["name"] == f"verify.{version[:2]}.batch"), key=lambda e: float(e["ts"]))
    assert len(regions) == batches
    assert len({e["tid"] for e in regions}) == 1
    for i, region in enumerate(regions):
        for name in here:
            assert len(_inside(region, events, name)) == 1, (i, name)
        digests = len(_inside(region, events, "pipeline.digest"))
        assert digests == (0 if i == 0 else 2 if i == batches - 1 else 1), i
    assert sum(1 for e in events if e["name"] == "verify.setup") == 1
    if version == "v2":
        # the profiler records the thread that started it, not the loader
        assert not [e for e in events if e["name"] == "pipeline.read"]


# ------------------------------------------------------------ the gate


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


def _use(kind: str) -> None:
    if kind == "track":
        with PipelineLedger().track("read", 10) as t:
            t.add(5)
    elif kind == "annotate":
        with profiler.annotate("verify.wait_load"):
            pass
    else:
        with profiler.maybe_profile_batch("verify.v2.batch"):
            pass


@pytest.mark.parametrize("kind", ["track", "annotate", "maybe_profile_batch"])
def test_no_region_without_a_profiler(monkeypatch, kind):
    monkeypatch.delenv("TORRENT_TPU_PROFILE", raising=False)
    monkeypatch.setattr(torch.profiler, "record_function", _Spy)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _Spy)
    monkeypatch.setattr(_Spy, "opened", [])
    assert not profiler.profiling()
    _use(kind)
    assert _Spy.opened == []
    # the same call under a running profiler opens its region
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiler.profiling()
        _use(kind)
    assert _Spy.opened == ["pipeline.read" if kind == "track" else
                           "verify.wait_load" if kind == "annotate" else "verify.v2.batch"]
    assert not profiler.profiling()


def test_gated_track_still_counts():
    led = PipelineLedger()
    with led.track("stage", 7) as t:
        t.add(3, 0.0)
    s = led.snapshot()["stages"]["stage"]
    assert s["ops"] == 1 and s["bytes"] == 10 and s["active"] == 0


def test_left_out_wait_is_not_busy():
    led = PipelineLedger()
    with led.track("read") as t:
        time.sleep(0.05)
        t.add(4, 0.04)
    s = led.snapshot()["stages"]["read"]
    assert s["bytes"] == 4 and 0.005 <= s["busy_s"] < 0.04


def test_the_flag_never_imports_torch():
    """A process that has not loaded torch runs no profiler: the ledger
    and ``annotate`` work there without importing it."""
    code = (
        "import sys\n"
        "from torrent_tpu_torch.obs.ledger import PipelineLedger\n"
        "from torrent_tpu_torch.obs.profiler import annotate, profiling\n"
        "assert 'torch' not in sys.modules, 'imported before the test'\n"
        "led = PipelineLedger()\n"
        "with led.track('read', 3):\n"
        "    with annotate('verify.wait_load'):\n"
        "        pass\n"
        "assert not profiling() and led.snapshot()['stages']['read']['ops'] == 1\n"
        "print('torch' in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "False"


# ------------------------------------------------------------ the read


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_read_batch_is_one_entry_a_call(tmp_path, monkeypatch, native):
    """One ``read`` entry a call, over zero-fill, planning and reads, and
    its bytes counted once, whichever path reads."""
    storage, info = _v1_torrent(tmp_path)
    if not native:
        storage = Storage(MemoryStorage(), info)
        storage.method.set((info.name,), 0, (tmp_path / "data.bin").read_bytes())
    elif not native_available():
        pytest.skip("native toolchain unavailable")
    led = pipeline_ledger()
    before = led.snapshot()["stages"]
    out = np.full((5, V1_PLEN), 0xAB, dtype=np.uint8)
    buf, lengths = storage.read_batch(range(15, 20), out=out)
    d = _delta(before, led.snapshot()["stages"])
    assert d["read"]["ops"] == 1
    assert d["read"]["bytes"] == int(lengths.sum()) == 5 * V1_PLEN - 77
    assert (buf[4, V1_PLEN - 77 :] == 0).all()  # the zero-fill ran inside the entry


@pytest.mark.skipif(not native_available(), reason="native toolchain unavailable")
def test_wait_for_the_engine_lock_is_not_read_time(tmp_path):
    storage, _ = _v1_torrent(tmp_path)
    engine = get_engine()
    storage.read_batch(range(4))  # builds and opens everything first
    led = pipeline_ledger()
    busy0 = led.snapshot()["stages"]["read"]["busy_s"]
    held = threading.Event()

    def hold():
        with engine._lock:
            held.set()
            time.sleep(0.2)

    holder = threading.Thread(target=hold)
    holder.start()
    held.wait()
    t0 = time.monotonic()
    storage.read_batch(range(4))
    assert time.monotonic() - t0 >= 0.15  # the read did wait for the lock
    holder.join()
    assert led.snapshot()["stages"]["read"]["busy_s"] - busy0 < 0.1


@pytest.mark.skipif(not native_available(), reason="native toolchain unavailable")
def test_read_segments_is_one_entry(tmp_path):
    path = tmp_path / "a.bin"
    path.write_bytes(bytes(range(200)))
    led = pipeline_ledger()
    before = led.snapshot()["stages"]
    out = np.zeros(48, dtype=np.uint8)
    get_engine().read_segments([str(path)], [(0, 10, 0, 16), (0, 100, 16, 32)], out)
    d = _delta(before, led.snapshot()["stages"])
    assert d["read"]["ops"] == 1 and d["read"]["bytes"] == 48
    assert out[:16].tolist() == list(range(10, 26))


# ------------------------------------------------------------ the capture


def test_profile_env_captures_the_loader_read(tmp_path, monkeypatch):
    """``TORRENT_TPU_PROFILE`` captures a plain recheck: its own profiler
    records every thread, so the loader's ``pipeline.read`` is there
    beside the batches of the hashing thread."""
    (tmp_path / "data").mkdir()
    storage, info = _v2_torrent(tmp_path / "data")
    monkeypatch.setattr(profiler, "_prof", None)
    monkeypatch.setattr(profiler, "_trace_done", False)
    monkeypatch.setattr(profiler, "_batches_seen", 0)
    monkeypatch.setenv("TORRENT_TPU_PROFILE", str(tmp_path / "prof"))
    monkeypatch.setenv("TORRENT_TPU_PROFILE_BATCHES", "2")
    assert verify_pieces_v2_gpu(storage, info, batch_size=V2_BATCH, device="cpu").all()
    assert profiler._trace_done and profiler._prof is None
    events = json.loads((tmp_path / "prof" / profiler.TRACE_NAME).read_text())["traceEvents"]
    events = [e for e in events if e.get("ph") == "X"]
    batches = [e for e in events if e["name"] == "verify.v2.batch"]
    reads = [e for e in events if e["name"] == "pipeline.read"]
    assert len(batches) == 2 and reads
    assert {e["tid"] for e in reads}.isdisjoint({e["tid"] for e in batches})
