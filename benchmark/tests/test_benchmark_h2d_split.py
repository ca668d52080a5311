"""The readers of the copy's program counters: the pipeline ledger's
``h2d_alone`` and ``h2d_beside_load``, on synthetic evidence. Each reads nothing where its counters are absent or
zero (a program that keeps none, as before they existed). Run with
``python -m pytest benchmark/tests -q``."""

from __future__ import annotations

import pytest

from benchmark import harness

GiB = 2**30


def _stage(busy_s, nbytes, ops):
    return {"busy_s": busy_s, "bytes": nbytes, "ops": ops}


# a v1 window: 190 rechecks, each one copy beside a load and one alone
V1 = {
    "read": _stage(44.0, 380 * GiB, 380),
    "h2d": _stage(0.1, 380 * GiB, 380),
    "h2d_beside_load": _stage(190 * 0.0262, 190 * GiB, 190),
    "h2d_alone": _stage(190 * 0.0208, 190 * GiB, 190),
    "h2d_local": _stage(0.0, 380 * GiB, 380),
    "load_local": _stage(0.0, 0, 380),
}


@pytest.mark.parametrize(
    "metric,counter", [("h2d_alone_GiB_s.recheck", "h2d_alone"), ("h2d_beside_load_GiB_s.recheck", "h2d_beside_load")]
)
def test_copy_rate_is_its_bytes_over_its_card_seconds(metric, counter):
    got = harness.load_reader(metric)({"ledger": V1, "window_s": 51.0})
    assert got == pytest.approx(V1[counter]["bytes"] / V1[counter]["busy_s"] / GiB)
    assert got == pytest.approx(1 / (0.0208 if counter == "h2d_alone" else 0.0262))


def _without(*names):
    return {k: v for k, v in V1.items() if k not in names}


@pytest.mark.parametrize(
    "metric,ledger",
    [
        ("h2d_alone_GiB_s.recheck", _without("h2d_alone")),
        ("h2d_alone_GiB_s.recheck", dict(V1, h2d_alone=_stage(0.0, 0, 0))),
        ("h2d_alone_GiB_s.recheck", dict(V1, h2d_alone=_stage(0.0, GiB, 1))),
        ("h2d_beside_load_GiB_s.recheck", _without("h2d_beside_load")),
        ("h2d_beside_load_GiB_s.recheck", dict(V1, h2d_beside_load=_stage(0.0, 0, 0))),
        ("h2d_beside_load_GiB_s.recheck", dict(V1, h2d_beside_load=_stage(0.0, GiB, 1))),
        # the parent: a ledger with none of the copy's counters
        ("h2d_alone_GiB_s.recheck", _without("h2d_alone", "h2d_beside_load", "h2d_local", "load_local")),
        ("h2d_beside_load_GiB_s.recheck", _without("h2d_alone", "h2d_beside_load", "h2d_local", "load_local")),
    ],
)
def test_nothing_without_the_counters(metric, ledger):
    read = harness.load_reader(metric)
    assert read({"ledger": ledger, "window_s": 51.0}) is None
    assert read({"ledger": {}, "window_s": 51.0}) is None
    assert read({"window_s": 51.0}) is None
