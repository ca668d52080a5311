"""The host-to-device copy's counters (``obs/h2d.py``), on the CPU.

A copy charges one of the pipeline ledger's two copy counters, which
appear in its snapshot, stay within ``MAX_STAGES`` and are never the
attributor's bottleneck. Rechecks on the CPU copy nothing and charge
neither, on every v1 route and the v2 recheck.
"""

from __future__ import annotations

import numpy as np
import pytest

from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.obs import h2d
from torrent_tpu_torch.obs import ledger as ledger_mod
from torrent_tpu_torch.obs.attrib import attribute
from torrent_tpu_torch.obs.ledger import MAX_STAGES, PIPELINE_STAGES, PipelineLedger
from torrent_tpu_torch.storage.storage import FsStorage, Storage
from torrent_tpu_torch.tools.make_torrent import make_torrent

COPY_COUNTERS = ("h2d_alone", "h2d_beside_load")


@pytest.fixture
def fresh_ledger(monkeypatch):
    led = PipelineLedger()
    monkeypatch.setattr(ledger_mod, "_ledger", led)
    return led


# ------------------------------------------------------------ charging the ledger


class FakeEvent:
    def __init__(self, ms=0.0):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


@pytest.mark.parametrize("beside", [True, False])
def test_copy_charges_its_counter(fresh_ledger, beside):
    h2d.Copy(FakeEvent(1.0), FakeEvent(26.0), 1 << 30, beside).charge()
    stages = fresh_ledger.snapshot()["stages"]
    name = "h2d_beside_load" if beside else "h2d_alone"
    assert stages[name]["ops"] == 1 and stages[name]["bytes"] == 1 << 30
    assert stages[name]["busy_s"] == pytest.approx(0.025)
    assert stages[name]["max_active"] == 0  # a counter: no occupancy window
    assert set(stages) == {name}


def test_every_name_fits_the_ledger(fresh_ledger):
    names = PIPELINE_STAGES + COPY_COUNTERS + ("read_wait",)
    assert set(names[len(PIPELINE_STAGES) :]) == PipelineLedger.COUNTERS
    assert len(names) == 11 <= MAX_STAGES
    for name in names:
        fresh_ledger.record(name, 10, 0.5)
    stages = fresh_ledger.snapshot()["stages"]
    assert set(stages) == set(names) and "other" not in stages
    for name in COPY_COUNTERS:
        assert {k: stages[name][k] for k in ("busy_s", "bytes", "ops")} == {"busy_s": 0.5, "bytes": 10, "ops": 1}


def _snapshot(stages: dict, wall: float = 10.0) -> dict:
    full = {n: {"busy_s": b, "bytes": nb, "ops": ops, "active": 0, "max_active": 1} for n, (b, nb, ops) in stages.items()}
    return {"t_first": 0.0, "t_last": wall, "t_snap": wall,
            "overlap": {"busy_s": 0.0, "concurrent_stages": 0, "max_concurrent_stages": 2}, "stages": full}


@pytest.mark.parametrize("counter", COPY_COUNTERS)
@pytest.mark.parametrize(
    "stages",
    [{"read": (2.0, 1 << 30, 2), "launch": (0.5, 1 << 30, 2)}, {"h2d": (0.2, 1 << 30, 2), "stage": (3.0, 1 << 30, 2)}],
    ids=["read", "stage"],
)
def test_attribution_never_names_a_copy_counter(counter, stages):
    """A counter larger than any stage moves neither the limiting stage nor
    the rate the others demand."""
    without = attribute(_snapshot(stages))
    with_counter = attribute(_snapshot(dict(stages, **{counter: (9.0, 1 << 50, 7)})))
    assert with_counter["bottleneck"] == without["bottleneck"]
    assert with_counter["stages"][counter]["busy_s"] == 9.0


# ------------------------------------------------------------ the rechecks on the CPU


@pytest.mark.parametrize("version", ["v1", "v1-distributed", "v1-bulk", "v2"])
def test_cpu_recheck_charges_no_copy_counter(tmp_path, fresh_ledger, version):
    """The plain versions read the staging rows in place: no copy, so
    neither counter, on any route (the multi-process one at world size
    1, without a process group)."""
    from torrent_tpu_torch.models.v2 import build_v2
    from torrent_tpu_torch.parallel.bulk import verify_library
    from torrent_tpu_torch.parallel.distributed import verify_storage_distributed
    from torrent_tpu_torch.parallel.verify import verify_pieces
    from torrent_tpu_torch.session.v2 import v2_session_info

    if version != "v2":
        path = tmp_path / "data.bin"
        path.write_bytes(np.random.default_rng(3).bytes(5 * 1024 - 7))
        info = parse_metainfo(make_torrent(str(path), "http://t.invalid/a", piece_length=1024, hasher="cpu")).info
        kwargs = {"batch_size": 2, "io_threads": 2}
    else:  # 2 pieces of one leaf and a short one: two batches
        path = tmp_path / "payload" / "a.bin"
        path.parent.mkdir()
        path.write_bytes(np.random.default_rng(3).bytes(2 * 16384 + 5))
        meta = build_v2([(("a.bin",), str(path))], "payload", 16384, hasher="cpu")
        info = v2_session_info(meta.info, meta.piece_layers)
        kwargs = {"batch_size": 2}
    storage = Storage(FsStorage(str(tmp_path)), info)
    if version == "v1-distributed":
        bitfield, _ = verify_storage_distributed(storage, info, device="cpu", **kwargs)
    elif version == "v1-bulk":
        bitfield = verify_library([(storage, info)], hasher="gpu", device="cpu", **kwargs).bitfields[0]
    else:
        bitfield = verify_pieces(storage, info, hasher="gpu", device="cpu", **kwargs)
    assert bitfield.all()
    stages = fresh_ledger.snapshot()["stages"]
    assert stages["read"]["ops"] >= 2
    assert not set(stages) & set(COPY_COUNTERS)
