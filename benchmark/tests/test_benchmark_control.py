"""What decides ``correct``, held against its control and its faults.

Each cell's run is driven here in full but for the look for a card, at a
size a test run holds: the payload, the reference's verdicts and the
window on the CPU, with the timed call into the port replaced. A sound
stand-in comes out correct; the control (the reference checking a
seeded half and passing the rest, in the program's place) and each
fault a cell can have come out not correct: a step that returns its
state unchanged, half of the work left out and taken as good, and an
answer altered where it is produced. (One card a cell: no exchange
between cards to leave out.) Run with ``python -m pytest benchmark/tests -q``.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness
from benchmark import run as bench_run
from benchmark.drivers.recheck import piece_digest

SEED = 2**31 + 4242


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """``BENCHMARK.json`` with its configurations cut to a few small
    pieces and its traffic to a denser share of flipped pieces, and a
    ``v1-recheck`` cell of SHA-1 pieces beside them, for the driver's
    version-1 path."""
    bench = copy.deepcopy(harness.load_benchmark())
    v1 = dict(harness.load_config(bench, "v2_1m"), name="v1_tiny", version=1, hash="sha1")
    (tmp_path / "v1_tiny.json").write_text(json.dumps(v1))
    bench["configs"].append({"name": "v1_tiny", "source": "a test", "file": str(tmp_path / "v1_tiny.json"), "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "v1-recheck", "config": "v1_tiny", "traffic": "recheck", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "v2-recheck" in m.get("workloads", ()):
            m["workloads"].append("v1-recheck")
    for entry in bench["configs"]:
        cfg = harness.load_config(bench, entry["name"])
        cfg["piece_length"] = 16384 if cfg["version"] == 1 else 2 * 16384
        cfg["total_bytes"] = cfg["piece_length"] * 20 - 777
        cfg["batch_size"] = 8
        path = tmp_path / f"{entry['name']}.json"
        path.write_text(json.dumps(cfg))
        entry["file"] = str(path)
    real = harness.load_traffic

    def traffic(name):
        t = real(name)
        t["flip_share"] = 0.3
        return t

    monkeypatch.setattr(harness, "load_traffic", traffic)
    return bench


# ---------------------------------------------------------------- rechecks


def _sound(root, info, config, device):
    with open(Path(root) / config["file_name"], "rb") as f:
        return np.array([piece_digest(f.read(config["piece_length"]), config) == info.pieces[i] for i in range(info.num_pieces)])


def _unchanged(root, info, config, device):
    return np.zeros(info.num_pieces, dtype=bool)  # the state before any piece was checked


def _half_left_out(root, info, config, device):
    ok = _sound(root, info, config, device)
    ok[len(ok) // 2 :] = True
    return ok


def _altered(root, info, config, device):
    ok = _sound(root, info, config, device)
    ok[3] = not ok[3]
    return ok


@pytest.mark.parametrize("cell", ["v1-recheck", "v2-recheck"])
@pytest.mark.parametrize("program,correct", [(_sound, True), (_unchanged, False), (_half_left_out, False), (_altered, False)])
def test_recheck_faults(tiny, cell, program, correct):
    out = bench_run.run_cell(tiny, cell, SEED, 0.2, device="cpu", program=program)
    assert out["correct"] is correct
    assert (out["checks"]["bitfield_mismatches"]["value"] == 0) is correct


@pytest.mark.parametrize("cell", ["v1-recheck", "v2-recheck"])
def test_recheck_control_fails(tiny, cell):
    out = bench_run.run_cell(tiny, cell, SEED, 0.2, device="cpu", control=True)
    assert out["correct"] is False and out["checks"]["bitfield_mismatches"]["value"] > 0


def test_port_recheck_through_the_driver(tiny):
    """The driver's own timed call, the port's ``verify_pieces`` on its
    plain CPU planes, at a few small pieces: correct, with the storage
    reads timed for ``read_share.recheck`` and the window's rate read."""
    path = Path(harness.find(tiny["configs"], "v1_tiny", "configuration")["file"])
    cfg = json.loads(path.read_text())
    cfg.update(piece_length=1024, total_bytes=1024 * 6 - 100, batch_size=4)
    path.write_text(json.dumps(cfg))
    out = bench_run.run_cell(tiny, "v1-recheck", SEED, 0.1, trace=True, device="cpu")
    assert out["correct"] and out["checks"]["bitfield_mismatches"]["value"] == 0
    assert 0 < out["metrics"]["read_share.recheck"]["value"] <= 100
    assert out["metrics"]["recheck_GiB_s.host"]["value"] > 0
