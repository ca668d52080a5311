"""The readers of the program's own stages and spans: the pipeline
ledger's ``read`` and ``stage`` busy seconds, and the trace's
``verify.wait_load`` regions, on synthetic evidence. Run with
``python -m pytest benchmark/tests -q``."""

from __future__ import annotations

import json

import pytest

from benchmark import harness


def _ledger(**busy):
    return {name: {"busy_s": s, "bytes": 1 << 20, "ops": 4} for name, s in busy.items()}


@pytest.mark.parametrize(
    "metric,stage",
    [("read_busy_share.recheck", "read"), ("stage_share.recheck", "stage")],
)
def test_ledger_share_reads_its_stage_over_the_window(metric, stage):
    read = harness.load_reader(metric)
    ev = {"window_s": 50.0, "ledger": _ledger(read=35.0, stage=12.5, launch=1.0)}
    assert read(ev) == pytest.approx(100.0 * ev["ledger"][stage]["busy_s"] / 50.0)


@pytest.mark.parametrize("metric", ["read_busy_share.recheck", "stage_share.recheck"])
def test_ledger_share_is_none_without_its_stage(metric):
    read = harness.load_reader(metric)
    # the stage never entered in the window, or not charged at all
    assert read({"window_s": 50.0, "ledger": _ledger(launch=1.0)}) is None
    assert read({"window_s": 50.0, "ledger": {"read": {"busy_s": 0.0, "bytes": 0, "ops": 0},
                                              "stage": {"busy_s": 0.0, "bytes": 0, "ops": 0}}}) is None
    assert read({"window_s": 50.0, "ledger": {}}) is None
    assert read({"window_s": 50.0}) is None


def _trace(host):
    return {"window_us": (1_000.0, 11_000.0), "kernels": [], "copies": [], "host": host}


def test_load_wait_share_takes_the_union_clipped_to_the_window():
    """``read_trace`` has clipped the host events to the window already;
    the reader counts overlapping waits once and no other name."""
    read = harness.load_reader("load_wait_share.recheck")
    host = [
        ("verify.wait_load", 1_000.0, 2_000.0),  # crossed the window's start: clipped
        ("verify.wait_load", 4_000.0, 6_000.0),
        ("verify.wait_load", 5_000.0, 7_000.0),  # overlaps the one before: 4,000-7,000
        ("verify.wait_load", 10_500.0, 11_000.0),  # crossed the window's end: clipped
        ("pipeline.stage", 2_000.0, 4_000.0),
        ("verify.v2.batch", 1_000.0, 11_000.0),
    ]
    assert read({"trace": _trace(host)}) == pytest.approx(100.0 * (1_000 + 3_000 + 500) / 10_000)


def test_load_wait_share_reads_the_harness_clipping(tmp_path):
    """The same spans through ``harness.read_trace``: a wait that crosses
    each edge of ``bench.window`` counts only inside it."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 1_000.0, "dur": 10_000.0},
        {"ph": "X", "cat": "user_annotation", "name": "verify.wait_load", "ts": 0.0, "dur": 2_000.0},
        {"ph": "X", "cat": "user_annotation", "name": "verify.wait_load", "ts": 10_000.0, "dur": 5_000.0},
        {"ph": "X", "cat": "user_annotation", "name": "verify.wait_load", "ts": 20_000.0, "dur": 5_000.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    trace = harness.read_trace(str(path))
    read = harness.load_reader("load_wait_share.recheck")
    assert read({"trace": trace}) == pytest.approx(100.0 * (1_000 + 1_000) / 10_000)


def test_load_wait_share_is_none_without_the_span():
    read = harness.load_reader("load_wait_share.recheck")
    assert read({"trace": None}) is None
    assert read({}) is None
    assert read({"trace": _trace([("pipeline.stage", 2_000.0, 4_000.0)])}) is None
