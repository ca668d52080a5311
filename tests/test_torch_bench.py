"""The port's device bench (``torrent_tpu_torch/tools/device_bench.py``):
one JSON line, the reference bench's configs, metric names and record
keys, and no number in place of a missing card.

The reference's ``tests/test_bench.py`` cases that do not test its
wedge-safe relay or its bank-and-replay run here against the port, with
``BENCH_PLATFORM=cpu`` (the plain PyTorch kernels) at pieces of 4 KiB and
batches of 64 rows: the plain SHA-1 costs milliseconds a 64-byte block
of the longest row, whatever the row count. Not ported, as the device
bench has no relay, no device wait and no replay:
``test_relay_success_path_forwards_child_line``,
``test_relay_timeout_emits_unavailable_marker_without_killing_child``,
``test_implicit_child_waits_for_device_never_reports_cpu``,
``test_relay_timeout_replays_banked_record``,
``test_seeded_r2_bank_replays_with_provenance`` and the replay half of
``test_bank_keeps_best_and_replay_labels_honestly``. In their place,
``test_without_cuda_prints_null_record_and_no_number`` holds the port's
rule: without CUDA the bench prints its null marker and measures nothing.

The differential cases run the repo's ``bench.py`` (JAX on the CPU) and
the device bench on the same tiny geometry: the same metric names and
the same record keys, less the port's listed additions.
"""

import json
import os
import statistics
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench.py")

_SMALL = {
    "BENCH_PLATFORM": "cpu",
    "BENCH_TOTAL_MB": "1",
    "BENCH_BATCH": "64",
    "BENCH_PIECE_KB": "4",
}
# v2 at 2 leaves a piece (one merkle level) and 64-leaf launches
_SMALL_V2 = {
    "BENCH_PLATFORM": "cpu",
    "BENCH_CONFIG": "v2",
    "BENCH_TOTAL_MB": "1",
    "BENCH_PIECE_KB": "32",
    "TORRENT_TPU_LEAF_BATCH": "64",
}
# what the port's records add to the reference's keys: the CUDA-event
# runs beside the host clock's, the kernel launches and the card's name
PORT_ONLY_KEYS = {"device_value", "device_runs_pps", "launches", "device_name"}


def _run(cmd, env, timeout=300):
    full = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    full.update(env)
    return subprocess.run(cmd, env=full, capture_output=True, text=True, timeout=timeout, cwd=REPO)


def _run_bench(extra_env, tmp_path, timeout=300):
    env = {**_SMALL, "BENCH_BANK_DIR": str(tmp_path / "bank"), **extra_env}
    return _run([sys.executable, "-m", "torrent_tpu_torch.tools.device_bench"], env, timeout)


def _record(proc):
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_inline_cpu_prints_one_json_line(tmp_path):
    proc = _run_bench({}, tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    assert len(lines) == 1, proc.stdout
    rec = json.loads(lines[0])
    assert rec["metric"] == "sha1_recheck_4KiB_pieces_per_sec"
    assert rec["unit"] == "pieces/s"
    # the plain SHA-1 is ~1000x slower than hashlib on a CPU, so the
    # two-digit ratio rounds to 0.0 here
    assert rec["value"] > 0 and rec["vs_baseline"] >= 0
    assert rec["platform"] == "cpu" and rec["backend"] == "torch"
    # the plain versions run on the CPU: no kernel launched, no card named
    assert rec["launches"] == {"sha1_cuda": 0, "sha256_cuda": 0, "sha256_merkle_cuda": 0}
    assert rec["device_name"] is None and rec["device_runs_pps"] is None
    # CPU records are never banked
    assert not (tmp_path / "bank").exists()


def test_without_cuda_prints_null_record_and_no_number(tmp_path):
    """No BENCH_PLATFORM means the card: on a host without CUDA the bench
    prints its null marker naming CUDA, and no CPU measurement."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    env = {k: v for k, v in _SMALL.items() if k != "BENCH_PLATFORM"}
    module = [sys.executable, "-m", "torrent_tpu_torch.tools.device_bench"]
    for config in ("headline", "v2"):
        proc = _run(module, {**env, "BENCH_CONFIG": config})
        rec = _record(proc)
        assert proc.stdout.count("\n") == 1
        assert rec["value"] is None and rec["vs_baseline"] is None
        assert rec["status"] == "cuda_unavailable"
        assert set(rec) == {"metric", "value", "unit", "vs_baseline", "status"}
    proc = _run_bench({"BENCH_PLATFORM": "tpu"}, tmp_path)
    assert proc.returncode != 0 and "BENCH_PLATFORM" in proc.stderr


def test_e2e_cap_marks_record(tmp_path):
    """BENCH_E2E_MB: the end-to-end pass runs over a sub-range and the
    record carries the honest marker; the plane/baseline fields stay
    full-scale."""
    rec = _record(_run_bench({"BENCH_TOTAL_MB": "2", "BENCH_E2E_MB": "1"}, tmp_path))
    assert rec["e2e_measured_mb"] == 1
    assert rec["value"] > 0 and rec["end_to_end_pps"] > 0


def test_record_carries_median_of_n_fields(tmp_path):
    """Every hash-plane record carries the batch knob, the run count, the
    per-run rates, and the spread."""
    rec = _record(_run_bench({"BENCH_RUNS": "3"}, tmp_path))
    assert rec["batch"] == 64
    assert rec["n_runs"] == 3
    assert len(rec["runs_pps"]) == 3
    assert rec["spread"] >= 0
    # value is the MEDIAN of the runs
    assert abs(rec["value"] - statistics.median(rec["runs_pps"])) <= 0.15


def test_micro_rung_single_batch_and_dispatch_fields(tmp_path):
    """BENCH_NBATCH=1 stages one resident batch and BENCH_DISPATCHES
    launches over it; the record carries both knobs."""
    rec = _record(_run_bench({"BENCH_NBATCH": "1", "BENCH_DISPATCHES": "6"}, tmp_path))
    assert rec["value"] > 0
    assert rec["n_batches"] == 1
    assert rec["n_dispatches"] == 6


def test_baseline_cache_roundtrip(tmp_path):
    """BENCH_BASELINE_CACHE: the first run measures and saves the hashlib
    rate; a later capped run loads it and marks the record as cached."""
    cache = tmp_path / "cpu_baseline.json"
    proc = _run_bench({"BENCH_BASELINE_CACHE": str(cache)}, tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    saved = json.loads(cache.read_text())
    entry = saved["sha1:4096"]
    assert entry["cpu_pps"] > 0 and entry["measured_total_mb"] == 1

    rec = _record(
        _run_bench(
            {"BENCH_BASELINE_CACHE": str(cache), "BENCH_TOTAL_MB": "2", "BENCH_E2E_MB": "1"},
            tmp_path,
        )
    )
    assert rec["baseline_cached"] is True
    assert rec["baseline_measured_total_mb"] == 1
    assert rec["value"] > 0 and rec["vs_baseline"] >= 0
    saved2 = json.loads(cache.read_text())
    assert saved2["sha1:4096"]["measured_total_mb"] == 1


@pytest.mark.parametrize("config", ["multifile", "author", "bulk"])
def test_other_configs_print_their_metric(config, tmp_path):
    """The reference bench's other SHA-1 configs, each one line with its
    metric name and the median-of-N fields."""
    rec = _record(_run_bench({"BENCH_CONFIG": config, "BENCH_BULK_N": "2"}, tmp_path))
    want = {
        "multifile": "sha1_recheck_multifile_4KiB_pieces_per_sec",
        "author": "sha1_author_4KiB_pieces_per_sec",
        "bulk": "sha1_bulk_2x1MB_pieces_per_sec",
    }[config]
    assert rec["metric"] == want
    assert rec["value"] > 0 and rec["end_to_end_pps"] > 0 and rec["n_runs"] == 3


def test_bank_keeps_best(tmp_path, monkeypatch):
    """The bank half of the reference's bank-and-replay case: best value
    kept at the stable name, CPU records and nulls never banked, a wider
    batch never displaced by a narrower one. Nothing reads it back."""
    from torrent_tpu_torch.tools import device_bench

    monkeypatch.setenv("BENCH_BANK_DIR", str(tmp_path))
    rec = {
        "metric": "m_test",
        "value": 100.0,
        "unit": "pieces/s",
        "vs_baseline": 20.0,
        "platform": "cuda",
    }
    device_bench._bank(rec)
    device_bench._bank({**rec, "value": 50.0, "vs_baseline": 10.0})  # worse: kept out
    stable = json.loads((tmp_path / "m_test.json").read_text())
    assert stable["value"] == 100.0 and stable["banked_at_utc"]
    # cpu records and nulls are never banked
    device_bench._bank({**rec, "platform": "cpu", "value": 999.0})
    device_bench._bank({**rec, "value": None})
    assert json.loads((tmp_path / "m_test.json").read_text())["value"] == 100.0
    # a WIDER-batch record is never clobbered by a higher-rate narrow one
    device_bench._bank({**rec, "batch": 8192, "value": 120.0})
    device_bench._bank({**rec, "batch": 512, "value": 999.0})
    assert json.loads((tmp_path / "m_test.json").read_text())["batch"] == 8192
    # every banked record leaves an audit copy beside the stable name
    assert len(list(tmp_path.glob("m_test.*.json"))) >= 1
    # the default bank is under the package's build directory, not .bench/
    monkeypatch.delenv("BENCH_BANK_DIR")
    assert os.path.join("build", "torrent_tpu_torch", "bench_live") in device_bench._bank_dir()


def test_v2_record_carries_median_of_n_fields(tmp_path):
    rec = _record(_run_bench({**_SMALL_V2, "BENCH_RUNS": "3"}, tmp_path))
    assert rec["metric"] == "sha256_v2_author_32KiB_pieces_per_sec"
    assert rec["n_runs"] == 3 and len(rec["runs_pps"]) == 3
    assert rec["batch"] == 64 and rec["n_batches"] >= 3
    assert rec["spread"] >= 0
    assert rec["value"] > 0 and rec["end_to_end_pps"] > 0


# ---------------------------------------------------------- differential


@pytest.mark.parametrize("env", [_SMALL, _SMALL_V2], ids=["headline", "v2"])
def test_same_metric_and_keys_as_the_reference_bench(env, tmp_path):
    """``bench.py`` (JAX on the CPU) and the device bench (plain PyTorch)
    on the same geometry: one line each, the same metric, the same keys
    less the port's additions, and both records from the CPU."""
    ref = _record(_run([sys.executable, BENCH], {**env, "BENCH_NO_REPLAY": "1",
                                                 "BENCH_BANK_DIR": str(tmp_path / "ref")}))
    port = _record(_run_bench(env, tmp_path))
    assert port["metric"] == ref["metric"]
    assert set(port) - PORT_ONLY_KEYS == set(ref)
    assert ref["platform"] == port["platform"] == "cpu"
    for key in ("unit", "batch", "n_runs", "n_batches"):
        assert port[key] == ref[key], key
    assert ref["value"] > 0 and port["value"] > 0
