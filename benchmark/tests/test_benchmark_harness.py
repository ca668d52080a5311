"""The harness: every file found by name, a new cell taken from new
files alone, the names and units of ``BENCHMARK.json``, the result
line, and the check for JAX. Run with ``python -m pytest benchmark/tests -q``."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness
from benchmark import run as bench_run

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SAFE_PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_every_file_found_by_name(bench):
    for cfg in bench["configs"]:
        assert harness.load_config(bench, cfg["name"])["name"] == cfg["name"]
    for cell in bench["workloads"]:
        traffic = harness.load_traffic(cell["traffic"])
        mod = harness.load_driver(traffic["driver"])
        assert hasattr(mod, "Cell")
        reported = {m["name"] for m in harness.metrics_for(bench["end_to_end"], cell["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.metrics_for(bench["per_layer"], cell["name"], reported)
    traced = bench["per_layer"] + [m for m in bench["end_to_end"] if m["source"] == "device_trace"]
    for m in traced:
        assert callable(harness.load_reader(m["name"]))
    # no file of the benchmark that no entry names
    assert {p.stem for p in (harness.BENCH_DIR / "layer_metrics").glob("*.py")} == {m["name"] for m in traced}
    assert {p.stem for p in (harness.BENCH_DIR / "traffic").glob("*.json")} == {w["traffic"] for w in bench["workloads"]}


def test_names_units_and_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and all(SAFE_PATH.match(p) and ".." not in p for p in bench["paths"])
    assert len(bench["command"]) <= 32 and not any(w.startswith("/") for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for cfg in bench["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in cfg["reduced"]) and len(cfg["reduced"]) <= 16
        assert 1 <= len(cfg["source"]) <= 200 and 1 <= len(cfg["why"]) <= 200
        assert cfg["file"].startswith(bench["paths"][0] + "/")
        on_file = harness.load_config(bench, cfg["name"])
        assert on_file["reduced"] == cfg["reduced"]
        assert any(w["config"] == cfg["name"] for w in bench["workloads"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in {x["name"] for x in harness.metrics_for(bench["end_to_end"], cell)}
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(bench)) <= 64 * 1024


def test_layers_named_alike(bench):
    """Metrics of one layer name it letter for letter."""
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def _stub_recheck(root, info, config, device):
    from benchmark.drivers.recheck import piece_digest

    out = []
    with open(Path(root) / config["file_name"], "rb") as f:
        for i in range(info.num_pieces):
            out.append(piece_digest(f.read(config["piece_length"]), config) == info.pieces[i])
    return np.array(out)


def test_new_cell_from_new_files_only(tmp_path, monkeypatch):
    """A cell with its own configuration, traffic, driver and per-layer
    metric runs from new files and new entries alone; no file that was
    there changes."""
    copy = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(copy): p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((copy / "configs" / "v2_1m.json").read_text())
    cfg.update(name="tiny", version=1, hash="sha1", piece_length=16384, total_bytes=16384 * 9 - 5, batch_size=4)
    (copy / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (copy / "drivers" / "recheck_again.py").write_text(
        "from benchmark.drivers.recheck import Cell as _Cell\n\n\n"
        "class Cell(_Cell):\n    pass\n"
    )
    (copy / "traffic" / "recheck_two.json").write_text(json.dumps({"driver": "recheck_again", "flip_share": 0.2}))
    (copy / "layer_metrics" / "rechecks.tiny.py").write_text(
        "def read(ev):\n    return float(ev['hashed']['repeats'])\n"
    )
    bench["configs"].append({"name": "tiny", "source": "a test", "file": str(copy / "configs" / "tiny.json"), "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-recheck", "config": "tiny", "traffic": "recheck_two", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "card_ms_per_GiB":
            m["workloads"].append("tiny-recheck")
    bench["per_layer"].append({"name": "rechecks.tiny", "unit": "rechecks", "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "card_ms_per_GiB", "workloads": ["tiny-recheck"]})
    monkeypatch.setattr(harness, "BENCH_DIR", copy)
    out = bench_run.run_cell(bench, "tiny-recheck", 2**31 + 5, 0.2, device="cpu", program=_stub_recheck)
    # on the CPU no device trace: the card's metric finds nothing to read and is left out
    assert out["correct"] and set(out["metrics"]) == {"setup_s"}
    traced = bench_run.run_cell(bench, "tiny-recheck", 2**31 + 6, 0.2, trace=True, device="cpu", program=_stub_recheck)
    assert traced["correct"] and traced["metrics"]["rechecks.tiny"]["value"] >= 1
    after = {p.relative_to(copy): p.read_bytes() for p in copy.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


def test_card_ms_per_gib_reads_the_device_union():
    """Card milliseconds a GiB: the union of kernels and copies (overlaps
    counted once) over the GiB of the window's work; nothing without a
    trace or without device time."""
    read = harness.load_reader("card_ms_per_GiB")
    trace = {"window_us": (0.0, 1e6), "kernels": [("k", 0.0, 2e3), ("k", 1e3, 3e3)],
             "copies": [("Memcpy HtoD", 5e3, 6e3, 1 << 20)], "host": []}
    assert read({"trace": trace, "work_bytes": 2 * 2**30}) == pytest.approx(2.0)
    assert read({"trace": None, "work_bytes": 2**30}) is None
    assert read({"trace": dict(trace, kernels=[], copies=[]), "work_bytes": 2**30}) is None


def test_result_line_schema():
    line = harness.result_line(
        True, 3, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "memory_peak_bytes": 10},
        breakdown={"device_ops": [["k", 0.1]], "idle_gaps": [["host", 0.2]]},
        checks={"bitfield_mismatches": {"value": 0, "limit": 0}},
    )
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert "breakdown" not in json.loads(harness.result_line(True, 1, 0, {}, {}, checks={}))


def test_no_result_without_card():
    """Without CUDA the run exits 2 and prints no result line."""
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "v2-recheck", "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 2 and proc.stdout == ""


def test_no_result_without_the_port(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and the
    benchmark's files, a run fails before any result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "v2-recheck", "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True,
    )
    assert proc.returncode != 0 and proc.stdout == ""


def test_forbidden_modules_by_whole_top_level_name():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "torrent_tpu", "torrent_tpu.ops.sha1_pallas",
            "torrent_tpu_torch", "torrent_tpu_torch.ops", "jaxtyping", "flaxen", "numpy"]
    assert harness.forbidden_modules(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "torrent_tpu", "torrent_tpu.ops.sha1_pallas"]
    )


def test_harness_loads_no_jax():
    """Importing the harness, every driver and every reader, and the port
    modules the drivers use, loads neither JAX nor the JAX package."""
    code = (
        "import json, sys\n"
        "from benchmark import harness, run\n"
        "b = harness.load_benchmark()\n"
        "for w in b['workloads']: harness.load_driver(harness.load_traffic(w['traffic'])['driver'])\n"
        "for m in b['per_layer']: harness.load_reader(m['name'])\n"
        "import torrent_tpu_torch.parallel.verify, torrent_tpu_torch.session.v2, torrent_tpu_torch.codec.metainfo\n"
        "import torrent_tpu_torch.codec.metainfo_v2, torrent_tpu_torch.storage.storage, torrent_tpu_torch.obs.ledger\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_harness_sources_name_no_jax_package():
    for path in harness.BENCH_DIR.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN, f"{path} imports {n}"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs only on the card")


@pytest.mark.gpu
def test_recheck_on_the_card(card):
    """One short run of the first cell on the card: a result line, correct."""
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "v2-recheck", "--seed", "2147483999", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
