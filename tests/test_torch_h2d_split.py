"""The host-to-device copy's counters (``obs/h2d.py``), on the CPU.

The placement helpers read a fake sysfs tree under ``tmp_path``: cpulist
parsing, the node tree (none without it), a card's node (-1 on hosts of
one and of two nodes), the CPU-to-node map, and the rule that a host of
one node counts every byte as local. ``move_pages`` with no target nodes
runs on a NumPy buffer of this host (skipped where the kernel refuses
it). A copy and a load charge the pipeline ledger's four counters, which
appear in its snapshot, stay within ``MAX_STAGES`` and are never the
attributor's bottleneck. Rechecks on the CPU copy nothing and charge
none of them.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.obs import h2d
from torrent_tpu_torch.obs import ledger as ledger_mod
from torrent_tpu_torch.obs.attrib import attribute
from torrent_tpu_torch.obs.ledger import MAX_STAGES, PIPELINE_STAGES, PipelineLedger
from torrent_tpu_torch.storage.storage import FsStorage, Storage
from torrent_tpu_torch.tools.make_torrent import make_torrent

CARD = "0000:1b:00.0"
COPY_COUNTERS = ("h2d_alone", "h2d_beside_load", "h2d_local", "load_local")


def fake_sysfs(root, cpulists: dict[int, str], card: str | None = None):
    """A sysfs tree with ``node<i>/cpulist`` for each node and, given
    ``card``, the card's ``numa_node``."""
    for node, text in cpulists.items():
        d = root / "devices" / "system" / "node" / f"node{node}"
        d.mkdir(parents=True)
        (d / "cpulist").write_text(text + "\n")
    (root / "devices" / "system" / "node" / "possible").write_text("0\n")  # not a node
    if card is not None:
        d = root / "bus" / "pci" / "devices" / CARD
        d.mkdir(parents=True)
        (d / "numa_node").write_text(card + "\n")
    return str(root)


class FakePages:
    """``HostPages`` with a given status for each sampled page."""

    def __init__(self, status, step=h2d.SAMPLE_BYTES):
        self._status, self.step = status, step

    def status(self):
        return self._status


@pytest.fixture
def fresh_ledger(monkeypatch):
    led = PipelineLedger()
    monkeypatch.setattr(ledger_mod, "_ledger", led)
    return led


# ------------------------------------------------------------ the host's nodes


@pytest.mark.parametrize(
    "text,want",
    [("0-3,8-11", [0, 1, 2, 3, 8, 9, 10, 11]), ("5", [5]), ("", []), ("\n", []), ("0,2-3\n", [0, 2, 3])],
    ids=["ranges", "single", "empty", "newline", "mixed"],
)
def test_parse_cpulist(text, want):
    assert h2d.parse_cpulist(text) == want


def test_numa_nodes_and_the_cpu_map(tmp_path):
    sysfs = fake_sysfs(tmp_path, {0: "0-3,8-11", 1: "4-7,12-15", 2: ""}, card="1")
    assert h2d.numa_nodes(sysfs) == {0: [0, 1, 2, 3, 8, 9, 10, 11], 1: [4, 5, 6, 7, 12, 13, 14, 15], 2: []}
    p = h2d.placement(CARD, sysfs)
    assert p.card == 1 and not p.one_node
    assert [p.cpu_node(c) for c in (0, 4, 9, 15, 99)] == [0, 1, 0, 1, -1]
    assert [p.local(p.cpu_node(c)) for c in (0, 4, 99)] == [False, True, None]


def test_no_sysfs_is_no_placement(tmp_path):
    assert h2d.numa_nodes(str(tmp_path)) is None
    assert h2d.placement(CARD, str(tmp_path)) is None


def test_no_node_tree_is_no_placement(tmp_path, monkeypatch, fresh_ledger):
    """The CPUs' tree and the card's node, but no node tree (a kernel
    that shows the process no NUMA): nothing is known, nothing counted."""
    torch = pytest.importorskip("torch")
    for d, name, text in (("devices/system/cpu", "online", "0-7"), (f"bus/pci/devices/{CARD}", "numa_node", "0")):
        (tmp_path / d).mkdir(parents=True)
        (tmp_path / d / name).write_text(text + "\n")
    assert h2d.numa_nodes(str(tmp_path)) is None
    p = h2d.placement(CARD, str(tmp_path))
    assert p is None
    monkeypatch.setattr(h2d, "device_placement", lambda device: p)
    monkeypatch.setattr(h2d, "current_cpu", lambda: 3)
    h2d.charge_load("card")
    rows, counts = torch.zeros((8, 1000), dtype=torch.uint8), torch.zeros(8, dtype=torch.int32)
    assert h2d.SlabPages(rows, counts).local_bytes("card", 0, 8) is None
    assert fresh_ledger.snapshot()["stages"] == {}


@pytest.mark.parametrize("address,text,want", [(CARD, "1", 1), (CARD, "-1", -1), ("0000:99:00.0", None, -1), (None, None, -1)],
                         ids=["node", "none-given", "no-file", "no-address"])
def test_card_node(tmp_path, address, text, want):
    sysfs = fake_sysfs(tmp_path, {0: "0-1"}, card=text)
    assert h2d.card_node(address, sysfs) == want


def test_card_without_node_on_one_node_counts_everything_local(tmp_path):
    p = h2d.placement(CARD, fake_sysfs(tmp_path, {0: "0-7"}, card="-1"))
    assert p.card == -1 and p.one_node
    assert p.local(0) is True and p.local(p.cpu_node(3)) is True and p.local(-1) is True
    # every byte, with no page sampled
    assert p.local_bytes(FakePages(None), 100, 5000) == 4900


def test_card_without_node_on_two_nodes_counts_nothing(tmp_path):
    p = h2d.placement(CARD, fake_sysfs(tmp_path, {0: "0-3", 1: "4-7"}, card="-1"))
    assert p.local(0) is None and p.local(1) is None
    assert p.local_bytes(FakePages([0, 1]), 0, 4 << 20) is None


def test_local_bytes_on_two_nodes(tmp_path):
    p = h2d.placement(CARD, fake_sysfs(tmp_path, {0: "0-3", 1: "4-7"}, card="1"))
    step = 1000
    pages = FakePages([1, 0, 1, -14], step)  # the last page the kernel cannot place
    assert p.local_bytes(pages, 0, 3500) == 1000 + 1000
    assert p.local_bytes(pages, 500, 2500) == 500 + 500
    assert p.local_bytes(pages, 1000, 2000) == 0
    assert p.local_bytes(FakePages([-14, -14]), 0, 2000) is None
    assert p.local_bytes(FakePages(None), 0, 2000) is None


# ------------------------------------------------------------ this host


def test_move_pages_reports_every_sampled_page():
    buf = np.ones(9 << 20, dtype=np.uint8)  # touched: every page is present
    status = h2d.page_nodes(buf.ctypes.data, buf.nbytes)
    if status is None:
        pytest.skip("move_pages is missing or refused on this host")
    assert len(status) == 5  # one page in every 2 MiB of 9 MiB
    nodes = h2d.numa_nodes()
    assert all(s >= 0 for s in status)
    if nodes is not None:
        assert set(status) <= set(nodes)


def test_host_pages_samples_once(monkeypatch):
    torch = pytest.importorskip("torch")
    calls = []
    monkeypatch.setattr(h2d, "page_nodes", lambda a, n, s: calls.append((a, n, s)) or [0])
    t = torch.zeros(1000, dtype=torch.int32)
    pages = h2d.HostPages(t)
    assert pages.status() == [0] and pages.status() == [0]
    assert calls == [(t.data_ptr(), 4000, h2d.SAMPLE_BYTES)]


def test_slab_pages_count_rows_and_block_counts(tmp_path, monkeypatch):
    torch = pytest.importorskip("torch")
    rows, counts = torch.zeros((8, 1000), dtype=torch.uint8), torch.zeros(8, dtype=torch.int32)
    slab = h2d.SlabPages(rows, counts)
    one = h2d.placement(CARD, fake_sysfs(tmp_path / "one", {0: "0-3"}, card="-1"))
    two = h2d.placement(CARD, fake_sysfs(tmp_path / "two", {0: "0-3", 1: "4-7"}, card="-1"))
    for p, want in ((one, 3 * 1000 + 3 * 4), (two, None), (None, None)):
        monkeypatch.setattr(h2d, "device_placement", lambda device, p=p: p)
        assert slab.local_bytes("card", 2, 5) == want


def test_current_cpu_is_allowed():
    cpu = h2d.current_cpu()
    if cpu is None:
        pytest.skip("sched_getcpu is missing on this host")
    assert cpu in os.sched_getaffinity(0)


def test_no_placement_off_the_card():
    torch = pytest.importorskip("torch")
    assert h2d.device_placement(torch.device("cpu")) is None
    assert h2d.device_placement(None) is None


# ------------------------------------------------------------ charging the ledger


class FakeEvent:
    def __init__(self, ms=0.0):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


@pytest.mark.parametrize("beside", [True, False])
@pytest.mark.parametrize("local", [None, 0, 3 << 29])
def test_copy_charges_its_counter(fresh_ledger, beside, local):
    h2d.Copy(FakeEvent(1.0), FakeEvent(26.0), 1 << 30, local, beside).charge()
    stages = fresh_ledger.snapshot()["stages"]
    name, other = ("h2d_beside_load", "h2d_alone") if beside else ("h2d_alone", "h2d_beside_load")
    assert stages[name]["ops"] == 1 and stages[name]["bytes"] == 1 << 30
    assert stages[name]["busy_s"] == pytest.approx(0.025)
    assert stages[name]["max_active"] == 0  # a counter: no occupancy window
    assert other not in stages
    if local is None:
        assert "h2d_local" not in stages
    else:
        assert stages["h2d_local"] == {"busy_s": 0.0, "bytes": local, "ops": 1, "active": 0, "max_active": 0}


@pytest.mark.parametrize(
    "card,cpulists,cpu,counted",
    [("-1", {0: "0-7"}, 3, True), ("1", {0: "0-3", 1: "4-7"}, 5, True), ("1", {0: "0-3", 1: "4-7"}, 2, False),
     ("-1", {0: "0-3", 1: "4-7"}, 5, False)],
    ids=["one-node", "cards-node", "other-node", "card-unknown"],
)
def test_load_charges_load_local(tmp_path, monkeypatch, fresh_ledger, card, cpulists, cpu, counted):
    p = h2d.placement(CARD, fake_sysfs(tmp_path, cpulists, card=card))
    monkeypatch.setattr(h2d, "device_placement", lambda device: p)
    monkeypatch.setattr(h2d, "current_cpu", lambda: cpu)
    h2d.charge_load("card")
    ops = fresh_ledger.snapshot()["stages"].get("load_local", {"ops": 0})["ops"]
    assert ops == (1 if counted else 0)


def test_load_without_placement_charges_nothing(monkeypatch, fresh_ledger):
    monkeypatch.setattr(h2d, "device_placement", lambda device: None)
    h2d.charge_load("card")
    assert fresh_ledger.snapshot()["stages"] == {}


def test_every_name_fits_the_ledger(fresh_ledger):
    names = PIPELINE_STAGES + COPY_COUNTERS + ("read_wait",)
    assert set(names[len(PIPELINE_STAGES) :]) == PipelineLedger.COUNTERS
    assert len(names) == 13 <= MAX_STAGES
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


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_cpu_recheck_charges_no_copy_counter(tmp_path, fresh_ledger, version):
    """The plain versions read the staging rows in place: no copy, no
    placement, so none of the four counters."""
    from torrent_tpu_torch.models.v2 import build_v2
    from torrent_tpu_torch.parallel.verify import verify_pieces
    from torrent_tpu_torch.session.v2 import v2_session_info

    if version == "v1":
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
    assert verify_pieces(Storage(FsStorage(str(tmp_path)), info), info, hasher="gpu", device="cpu", **kwargs).all()
    stages = fresh_ledger.snapshot()["stages"]
    assert stages["read"]["ops"] >= 2
    assert not set(stages) & set(COPY_COUNTERS)
