"""The port's scheduler autopilot (torrent_tpu_torch/sched/control.py),
against the reference.

The reference's tests/test_control.py, ported (its
session ``MetricsServer``, ``top``, bridge and ``bench controller``
cases wait for later slices; ROADMAP.md lists them). Covers the
observe→act loop:

* the pure decision core: grow/shrink laws, hysteresis (a flapping
  attribution verdict must leave every actuator untouched), admission
  shrink/recovery, the backend trial protocol (switch once, evaluate,
  revert-and-pin — no oscillation),
  determinism (same snapshot sequence → same decision sequence)
* the scheduler's actuator seams: geometry-snapped ``set_lane_target``,
  per-lane deadlines, the effective admission budget, backend steering
  rebuilding the plane (and the cpu steer bypassing ``plane_factory``
  exactly like the breaker's fallback)
* controller-off bit-identical static behavior
* end to end: under ``sched/faults.py`` throttles (``latency_ms`` h2d,
  the new ``read_latency_ms``) the controller names the limiting stage
  and moves the named actuators toward it
* surfaces: ``torrent_tpu_control_*`` rendering
* ``TestDifferential``: the reference's ``decide`` and the port's give
  the same decisions on the same inputs, up to the backend names
  (the reference's pallas → scan trial is the port's cuda → cpu one)
"""

from __future__ import annotations

import asyncio
import hashlib
import json

import pytest

from torrent_tpu_torch.sched import (
    ControlConfig,
    FaultPlan,
    HashPlaneScheduler,
    SchedRejected,
    SchedulerAutopilot,
    SchedulerConfig,
)
from torrent_tpu_torch.sched.control import build_inputs, decide, initial_state

from test_metrics import prom_lint


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# ------------------------------------------------------- input builders


def mk_inputs(
    stage=None,
    util=0.9,
    headroom=5.0,
    achieved=1_000_000.0,
    launch_bps=5_000_000.0,
    fill=1.0,
    launches=4,
    target=8,
    base_target=8,
    afford=4096,
    deadline=0.02,
    backend="device",
    qw=1.0,
    factor=1.0,
    maxq=1 << 28,
    lane="sha1/262144",
    granule=1,
):
    rep = {
        "wall_s": 1.0,
        "stages": {"launch": {"achieved_bps": launch_bps}},
        "bottleneck": None,
    }
    if stage is not None:
        rep["bottleneck"] = {
            "stage": stage,
            "utilization": util,
            "achieved_bps": achieved,
            "demanded_bps": achieved * headroom if headroom else None,
            "headroom": headroom,
        }
    return {
        "attribution": rep,
        "lanes": {
            lane: {
                "backend": backend,
                "bucket": 262144,
                "granule": granule,
                "target": target,
                "base_target": base_target,
                "afford": afford,
                "deadline": deadline,
                "base_deadline": 0.02,
                "pending": 0,
                "launches": launches,
                "fill": fill,
                # the per-lane rate the backend trial judges against
                "launch_bps": launch_bps,
            }
        },
        "queue_wait_mean_s": qw,
        "admission": {"factor": factor, "max_queue_bytes": maxq, "queue_bytes": 0},
    }


class TestDecideLaws:
    def test_grow_waits_for_hysteresis_then_fires(self):
        cfg = ControlConfig(hysteresis_ticks=2, cooldown_ticks=0)
        state = initial_state()
        d1, state = decide(mk_inputs(stage="h2d"), state, cfg)
        assert d1["actions"] == []  # streak 1 < hysteresis 2
        d2, state = decide(mk_inputs(stage="h2d"), state, cfg)
        kinds = {a["actuator"] for a in d2["actions"]}
        assert "batch_target" in kinds and "admission" in kinds
        bt = next(a for a in d2["actions"] if a["actuator"] == "batch_target")
        assert bt["from"] == 8 and bt["to"] == 16
        assert d2["bottleneck"]["confirmed"] is True

    def test_flapping_verdict_leaves_actuators_stable(self):
        """Acceptance: a synthetic snapshot sequence alternating
        the limiting stage between two stages must produce ZERO actuator
        moves under hysteresis."""
        cfg = ControlConfig(hysteresis_ticks=2, cooldown_ticks=0)
        state = initial_state()
        stages = ["h2d", "read", "h2d", "read", "h2d", "read"]
        for s in stages:
            d, state = decide(mk_inputs(stage=s), state, cfg)
            assert d["actions"] == [], f"flapping verdict moved actuators: {d}"
            assert not (d["bottleneck"] or {}).get("confirmed")

    def test_shrink_on_low_fill_returns_toward_plan(self):
        cfg = ControlConfig(hysteresis_ticks=2, cooldown_ticks=0)
        state = initial_state()
        d, state = decide(
            mk_inputs(stage=None, fill=0.1, target=64, base_target=8),
            state,
            cfg,
        )
        bt = next(a for a in d["actions"] if a["actuator"] == "batch_target")
        assert bt["from"] == 64 and bt["to"] == 32

    def test_grow_bounded_by_afford_and_max_factor(self):
        cfg = ControlConfig(hysteresis_ticks=1, cooldown_ticks=0)
        state = initial_state()
        # afford caps below target*2
        d, state = decide(
            mk_inputs(stage="h2d", target=8, base_target=8, afford=12),
            state,
            cfg,
        )
        bt = next(a for a in d["actions"] if a["actuator"] == "batch_target")
        assert bt["to"] == 12
        # at the max-factor ceiling nothing grows
        state = initial_state()
        d, state = decide(
            mk_inputs(stage="h2d", target=64, base_target=8), state, cfg
        )
        assert not [a for a in d["actions"] if a["actuator"] == "batch_target"]

    def test_grow_cap_snaps_to_granule_no_chatter(self):
        """A tiled lane whose target already sits at the largest
        granule multiple under the cap must not get endless grow
        proposals the scheduler's snap would round straight back."""
        cfg = ControlConfig(hysteresis_ticks=1, cooldown_ticks=0)
        state = initial_state()
        for _ in range(3):
            d, state = decide(
                mk_inputs(stage="h2d", target=2048, base_target=512,
                          afford=3000, granule=1024),
                state, cfg,
            )
            assert not [
                a for a in d["actions"] if a["actuator"] == "batch_target"
            ], d["actions"]

    def test_admission_floor_then_recovery(self):
        cfg = ControlConfig(hysteresis_ticks=1, cooldown_ticks=0)
        state = initial_state()
        # tiny achieved rate vs a big budget: factor goes to the floor
        d, state = decide(
            mk_inputs(stage="h2d", achieved=1000.0), state, cfg
        )
        adm = next(a for a in d["actions"] if a["actuator"] == "admission")
        assert adm["to"] == cfg.admission_floor
        # verdict clears: the budget recovers by doubling
        d, state = decide(mk_inputs(stage=None, factor=0.25), state, cfg)
        adm = next(a for a in d["actions"] if a["actuator"] == "admission")
        assert adm["from"] == 0.25 and adm["to"] == 0.5

    def test_admission_recovers_after_flap_not_just_on_idle(self):
        """A flapping (never-confirming) verdict must not strand the
        admission budget at the floor: recovery keys on the last
        CONFIRMED tick, so after a cooldown of unconfirmed ticks the
        factor climbs back to 1.0 and rests there."""
        cfg = ControlConfig(hysteresis_ticks=2, cooldown_ticks=1)
        state = initial_state()
        # confirm h2d and shrink to the floor
        for _ in range(2):
            d, state = decide(
                mk_inputs(stage="h2d", achieved=1000.0), state, cfg
            )
        assert [a for a in d["actions"] if a["actuator"] == "admission"]
        factor = cfg.admission_floor
        # verdict flaps; after the cooldown recovery fires each tick
        recovered = []
        for s in ("read", "h2d", "read", "h2d", "read"):
            d, state = decide(
                mk_inputs(stage=s, achieved=1000.0, factor=factor), state, cfg
            )
            for a in d["actions"]:
                assert a["actuator"] == "admission"
                factor = a["to"]
                recovered.append(factor)
        assert recovered and recovered[-1] == 1.0
        # at 1.0 the continuing flap produces no further movement
        # (stable endpoint; "h2d" keeps alternating so nothing confirms)
        d, state = decide(mk_inputs(stage="h2d", factor=1.0), state, cfg)
        assert not [a for a in d["actions"] if a["actuator"] == "admission"]

    def test_backend_trial_extends_over_idle_interval(self):
        """A trial evaluated during a zero-traffic interval must not
        phantom-revert: it extends until a with-traffic interval
        actually measures the new backend."""
        cfg = ControlConfig(hysteresis_ticks=1, cooldown_ticks=1)
        state = initial_state()
        d1, state = decide(
            mk_inputs(stage="launch", backend="device", launch_bps=1000.0),
            state, cfg,
        )
        assert [a for a in d1["actions"] if a["actuator"] == "backend"]
        d2, state = decide(
            mk_inputs(stage="launch", backend="cpu"), state, cfg
        )
        # evaluation tick, but the lane saw NO traffic: trial persists
        d3, state = decide(
            mk_inputs(stage=None, backend="cpu", launches=0, fill=None,
                      launch_bps=None),
            state, cfg,
        )
        assert not [a for a in d3["actions"] if a["actuator"] == "backend"]
        assert state["lanes"]["sha1/262144"]["backend_trial"] is not None
        # traffic returns with a 2x better rate: kept and pinned
        d4, state = decide(
            mk_inputs(stage=None, backend="cpu", launch_bps=2000.0),
            state, cfg,
        )
        assert not [a for a in d4["actions"] if a["actuator"] == "backend"]
        assert state["lanes"]["sha1/262144"]["backend_trial"] is None
        assert state["lanes"]["sha1/262144"]["backend_pinned"] is True

    def test_unconfirmed_verdict_never_shrinks_admission(self):
        cfg = ControlConfig(hysteresis_ticks=3, cooldown_ticks=0)
        state = initial_state()
        for _ in range(2):  # streak stays under 3
            d, state = decide(
                mk_inputs(stage="h2d", achieved=1000.0), state, cfg
            )
            assert not [a for a in d["actions"] if a["actuator"] == "admission"]

    def test_backend_trial_revert_and_pin(self):
        """Launch-limited lane: switch once, evaluate after the
        cooldown, revert when nothing improved, then PIN — further
        launch-limited ticks must not oscillate the backend."""
        cfg = ControlConfig(hysteresis_ticks=1, cooldown_ticks=1)
        state = initial_state()
        inp = lambda backend: mk_inputs(  # noqa: E731
            stage="launch", backend=backend, fill=0.5, launch_bps=1000.0
        )
        d1, state = decide(inp("device"), state, cfg)
        sw = [a for a in d1["actions"] if a["actuator"] == "backend"]
        assert sw and sw[0]["to"] == "cpu"
        # cooldown tick: trial still accumulating, no action
        d2, state = decide(inp("cpu"), state, cfg)
        assert not [a for a in d2["actions"] if a["actuator"] == "backend"]
        # evaluation tick: launch_bps did not improve -> revert
        d3, state = decide(inp("cpu"), state, cfg)
        rv = [a for a in d3["actions"] if a["actuator"] == "backend"]
        assert rv and rv[0]["to"] == "device"
        # pinned: persistent launch verdicts change nothing further
        for _ in range(4):
            d, state = decide(inp("device"), state, cfg)
            assert not [a for a in d["actions"] if a["actuator"] == "backend"]

    def test_backend_trial_kept_when_improved(self):
        cfg = ControlConfig(hysteresis_ticks=1, cooldown_ticks=1)
        state = initial_state()
        d1, state = decide(
            mk_inputs(stage="launch", backend="device", launch_bps=1000.0),
            state, cfg,
        )
        assert [a for a in d1["actions"] if a["actuator"] == "backend"]
        d2, state = decide(
            mk_inputs(stage="launch", backend="cpu", launch_bps=1000.0),
            state, cfg,
        )
        # evaluation with a 10x better achieved rate: keep (no revert)
        d3, state = decide(
            mk_inputs(stage="launch", backend="cpu", launch_bps=10_000.0),
            state, cfg,
        )
        assert not [a for a in d3["actions"] if a["actuator"] == "backend"]
        assert state["lanes"]["sha1/262144"]["backend_pinned"] is True

    def test_observe_only_runs_no_backend_trials(self):
        """A disabled (observe-only) controller must not record phantom
        backend trials: the trial protocol interprets the next interval
        as the new backend's performance, which is meaningless when the
        steer was never applied."""
        cfg = ControlConfig(enabled=False, hysteresis_ticks=1, cooldown_ticks=0)
        state = initial_state()
        for _ in range(4):
            d, state = decide(
                mk_inputs(stage="launch", backend="device"), state, cfg
            )
            assert not [a for a in d["actions"] if a["actuator"] == "backend"]
            assert not state["lanes"].get("sha1/262144", {}).get("backend_trial")

    def test_cpu_backend_has_no_alternative(self):
        cfg = ControlConfig(hysteresis_ticks=1, cooldown_ticks=0)
        state = initial_state()
        d, state = decide(
            mk_inputs(stage="launch", backend="cpu"), state, cfg
        )
        assert not [a for a in d["actions"] if a["actuator"] == "backend"]

    def test_decide_is_deterministic(self):
        """Same snapshot sequence → bit-identical decision sequence
        (the property the analysis determinism pass guards)."""
        seq = [
            mk_inputs(stage="h2d"),
            mk_inputs(stage="h2d", target=16),
            mk_inputs(stage=None, fill=0.2, target=32),
            mk_inputs(stage="launch", backend="device"),
        ]
        cfg = ControlConfig(hysteresis_ticks=2, cooldown_ticks=1)

        def fold():
            out, state = [], initial_state()
            for inp in seq:
                d, state = decide(inp, state, cfg)
                out.append(d)
            return json.dumps(out, sort_keys=True)

        assert fold() == fold()

    def test_low_utilization_is_not_a_bottleneck(self):
        cfg = ControlConfig(hysteresis_ticks=1, cooldown_ticks=0)
        state = initial_state()
        d, _ = decide(mk_inputs(stage="h2d", util=0.3), state, cfg)
        assert d["bottleneck"] is None and d["actions"] == []


class TestBuildInputs:
    def test_lane_deltas_and_queue_wait_mean(self):
        surface = {
            "lanes": {
                "sha1/1024": {
                    "backend": "cpu", "bucket": 1024, "target": 8,
                    "base_target": 8,
                    "afford": 512, "deadline": 0.02, "base_deadline": 0.02,
                    "pending": 0, "launches": 10, "fill_sum": 9.0,
                }
            },
            "admission": {"factor": 1.0, "max_queue_bytes": 100, "queue_bytes": 0},
        }
        prev = {
            "lanes": {
                "sha1/1024": {"launches": 6, "fill_sum": 6.0}
            },
            "admission": {},
        }
        led = {"stages": {}, "t_first": 0.0, "t_last": 1.0, "t_snap": 1.0}
        inp = build_inputs(
            led, None, surface, prev,
            qw_snap=([0] * 25, 10, 2.0), prev_qw=([0] * 25, 4, 0.8),
        )
        lane = inp["lanes"]["sha1/1024"]
        assert lane["launches"] == 4
        assert lane["fill"] == pytest.approx(0.75)
        # per-lane launch rate: d_fill × target × bucket / wall
        assert lane["launch_bps"] == pytest.approx(3.0 * 8 * 1024 / 1.0)
        assert inp["queue_wait_mean_s"] == pytest.approx(0.2)

    def test_no_traffic_means_no_fill(self):
        surface = {
            "lanes": {
                "sha1/1024": {
                    "backend": "cpu", "target": 8, "base_target": 8,
                    "afford": 512, "deadline": 0.02, "base_deadline": 0.02,
                    "pending": 0, "launches": 3, "fill_sum": 3.0,
                }
            },
            "admission": {},
        }
        inp = build_inputs({"stages": {}}, None, surface, surface)
        assert inp["lanes"]["sha1/1024"]["launches"] == 0
        assert inp["lanes"]["sha1/1024"]["fill"] is None


# --------------------------------------------------- scheduler actuators


class _GeomPlane:
    """Fake plane with a tile-snapping geometry hook (1024-row granule)."""

    def __init__(self, algo):
        self._h = hashlib.sha256 if algo == "sha256" else hashlib.sha1

    @staticmethod
    def launch_geometry(n_rows: int, bucket: int):
        rows = (n_rows + 1023) // 1024 * 1024
        return rows, rows * bucket

    def run(self, payloads):
        return [self._h(bytes(p)).digest() for p in payloads]


class TestActuatorSeams:
    def test_set_lane_target_snaps_via_geometry_hook(self):
        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=8, flush_deadline=0.01,
                    plane_factory=lambda algo, bucket, batch: _GeomPlane(algo),
                ),
                hasher="cpu",
            )
            await sched.start()
            try:
                pieces = [bytes([i]) * 64 for i in range(4)]
                want = [hashlib.sha1(p).digest() for p in pieces]
                assert await sched.submit("t", pieces) == want  # builds plane
                got = sched.set_lane_target("sha1/64", 100)
                assert got == 1024  # snapped up to the tile granule
                assert sched.set_lane_target("nope/1", 5) is None
            finally:
                await sched.close()

        run(go())

    def test_set_lane_target_snap_never_exceeds_staging_afford(self):
        """The geometry hook snaps UP; when that would overrun the
        staging afford the applied target rounds DOWN to the largest
        granule multiple (or the raw afford when not even one granule
        fits) — the lane plan's own round-down discipline."""
        async def go():
            # afford = 320000 / padded_len(64)=128 -> 2500 rows
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=8, flush_deadline=0.01,
                    staging_budget=320000,
                    plane_factory=lambda algo, bucket, batch: _GeomPlane(algo),
                ),
                hasher="gpu", device="cpu",
            )
            await sched.start()
            try:
                pieces = [bytes([i]) * 64 for i in range(4)]
                want = [hashlib.sha1(p).digest() for p in pieces]
                assert await sched.submit("t", pieces) == want
                # within afford: plain snap up
                assert sched.set_lane_target("sha1/64", 100) == 1024
                # 3000 clamps to afford 2500, snap-up 3072 overruns ->
                # round down to the 1024 granule
                assert sched.set_lane_target("sha1/64", 3000) == 2048
            finally:
                await sched.close()

            # afford (500) smaller than one granule: the budget beats
            # the tiling and the raw afford stands
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=8, flush_deadline=0.01,
                    staging_budget=128 * 500,
                    plane_factory=lambda algo, bucket, batch: _GeomPlane(algo),
                ),
                hasher="gpu", device="cpu",
            )
            await sched.start()
            try:
                pieces = [bytes([i]) * 64 for i in range(4)]
                want = [hashlib.sha1(p).digest() for p in pieces]
                assert await sched.submit("t", pieces) == want
                assert sched.set_lane_target("sha1/64", 2000) == 500
            finally:
                await sched.close()

        run(go())

    def test_set_lane_deadline_and_snapshot(self):
        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=4, flush_deadline=0.01),
                hasher="cpu",
            )
            await sched.start()
            try:
                await sched.submit("t", [b"x" * 64])
                assert sched.set_lane_deadline("sha1/64", 0.25) == 0.25
                snap = sched.metrics_snapshot()
                assert snap["lane_stats"]["sha1/64"]["deadline"] == 0.25
                surface = sched.control_surface()
                assert surface["lanes"]["sha1/64"]["deadline"] == 0.25
            finally:
                await sched.close()

        run(go())

    def test_admission_factor_scales_the_shed_threshold(self):
        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=4, flush_deadline=0.01,
                    max_queue_bytes=1 << 20, max_tenant_bytes=1 << 20,
                ),
                hasher="cpu",
            )
            await sched.start()
            try:
                big = [b"z" * (200 << 10)]  # 200 KiB
                # factor 0.1 -> ~105 KiB effective budget: shed
                assert sched.set_admission_factor(0.1) == 0.1
                with pytest.raises(SchedRejected):
                    await sched.enqueue("t", big)
                # restored: the same submission is admitted
                sched.set_admission_factor(1.0)
                fut = await sched.enqueue("t", big)
                assert await fut == [hashlib.sha1(big[0]).digest()]
            finally:
                await sched.close()

        run(go())

    def test_steer_backend_rebuilds_plane_and_cpu_bypasses_factory(self):
        """The reference steers pallas ↔ scan through the factory; the
        port has one plane a device, so a device="cpu" lane steers
        between its own plane and the hashlib floor, and nowhere else."""
        calls: list[str] = []

        def factory(algo, bucket, batch):
            calls.append(algo)
            return _GeomPlane(algo)

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=4, flush_deadline=0.01, plane_factory=factory,
                ),
                hasher="gpu", device="cpu",
            )
            await sched.start()
            try:
                pieces = [bytes([i + 1]) * 64 for i in range(2)]
                want = [hashlib.sha256(p).digest() for p in pieces]
                got = await sched.submit("t", pieces, algo="sha256",
                                         piece_length=64)
                assert got == want
                assert calls == ["sha256"]
                # the lane is already on its own plane; another lane's
                # plane and the card's are no targets
                assert sched.steer_lane_backend("sha256/64", "torch") is None
                with pytest.raises(ValueError, match="'torch' or 'cpu'"):
                    sched.steer_lane_backend("sha256/64", "cuda")
                with pytest.raises(ValueError, match="'torch' or 'cpu'"):
                    sched.steer_lane_backend("sha256/64", "device")
                # the cpu steer bypasses the factory entirely (hashlib
                # floor, same contract as the breaker's fallback)
                assert sched.steer_lane_backend("sha256/64", "cpu") == "cpu"
                assert sched.steer_lane_backend("sha256/64", "cpu") is None
                got = await sched.submit("t", pieces, algo="sha256",
                                         piece_length=64)
                assert got == want
                assert len(calls) == 1
                # steering back to its own plane rebuilds through the factory
                assert sched.steer_lane_backend("sha256/64", "torch") == "torch"
                got = await sched.submit("t", pieces, algo="sha256",
                                         piece_length=64)
                assert got == want
                assert calls == ["sha256", "sha256"]
                with pytest.raises(ValueError):
                    sched.steer_lane_backend("sha256/64", "warp")
            finally:
                await sched.close()

        run(go())

    def test_card_lanes_refuse_a_cpu_steer(self):
        """On a card (here a device="cpu" scheduler whose ``_on_card``
        is forced true, over hashlib planes from the factory) no lane may
        be steered to hashlib: the steer raises and the lane stays on
        its own backend, 'cuda'."""

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=4, flush_deadline=0.01,
                    plane_factory=lambda algo, bucket, batch: _GeomPlane(algo),
                ),
                hasher="gpu", device="cpu",
            )
            sched._on_card = lambda: True
            try:
                for algo, h in (("sha1", hashlib.sha1), ("sha256", hashlib.sha256)):
                    pieces = [bytes([7]) * 64]
                    got = await sched.submit("t", pieces, algo=algo, piece_length=64)
                    assert got == [h(pieces[0]).digest()]
                    with pytest.raises(ValueError, match="card"):
                        sched.steer_lane_backend(f"{algo}/64", "cpu")
                    lane = sched.metrics_snapshot()["lane_stats"][f"{algo}/64"]
                    assert lane["backend"] == "cuda"
            finally:
                await sched.close()

        run(go())


# ------------------------------------------------- controller off = static


class TestControllerOff:
    def test_disabled_pilot_applies_nothing(self):
        async def go():
            plan = FaultPlan.parse("latency_ms=30")
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=8, flush_deadline=0.02,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            await sched.start()
            pilot = SchedulerAutopilot(
                sched,
                ControlConfig(enabled=False, hysteresis_ticks=1,
                              cooldown_ticks=0),
            )
            try:
                pieces = [bytes([i]) * 512 for i in range(32)]
                want = [hashlib.sha1(p).digest() for p in pieces]
                pilot.tick()
                for _ in range(2):
                    assert await sched.submit("t", pieces) == want
                    last = pilot.tick()
                # decisions ARE computed (observe-only)…
                assert last["decision"]["tick"] >= 2
                # …but nothing is applied and every actuator is static
                assert last["applied"] == []
                snap = sched.metrics_snapshot()
                assert snap["admission_factor"] == 1.0
                lane = snap["lane_stats"]["sha1/512"]
                assert lane["target"] == 8
                assert lane["deadline"] == pytest.approx(0.02)
                for ln in sched._lanes.values():
                    assert ln.deadline is None
            finally:
                await sched.close()

        run(go())


# ------------------------------------------------------- fabric rebalance


class TestRebalance:
    def _executors(self, tmp_path, rebalance_pids=(0,)):
        from test_torch_fabric import make_library

        from torrent_tpu_torch.fabric import FabricConfig, build_fabric_executor
        from torrent_tpu_torch.storage.storage import FsStorage, Storage

        items1, _, _ = make_library(tmp_path, [12, 20, 7])
        items2 = [
            (Storage(FsStorage(s.method.root), info), info)
            for (s, info) in items1
        ]

        def mk_sched():
            return HashPlaneScheduler(
                SchedulerConfig(batch_target=16, flush_deadline=0.01),
                hasher="cpu",
            )

        def mk_exec(items, sched, pid):
            cfg = FabricConfig(
                heartbeat_interval=0.05, lapse_after=5.0,
                rebalance=pid in rebalance_pids, rebalance_after=1,
            )
            return build_fabric_executor(
                items, sched, nproc=2, pid=pid,
                heartbeat_dir=str(tmp_path / "hb"),
                config=cfg, unit_bytes=8 * 16384,
            )

        return items1, items2, mk_sched, mk_exec

    def test_rebalance_offers_pure(self, tmp_path):
        items1, _, mk_sched, mk_exec = self._executors(tmp_path)

        async def go():
            sched = await mk_sched().start()
            try:
                ex = mk_exec(items1, sched, 0)
                mine = sorted(ex._queue)

                def roll(me_straggler, helper_ok=True, helper_straggler=False):
                    return {
                        "scoreboard": [
                            {"pid": 0, "status": "ok",
                             "straggler": me_straggler},
                            {"pid": 1,
                             "status": "ok" if helper_ok else "lapsed",
                             "straggler": helper_straggler},
                        ]
                    }

                # straggler with a healthy helper: offer every pending unit
                assert ex._rebalance_offers(roll(True)) == mine
                # not a straggler: nothing offered
                assert ex._rebalance_offers(roll(False)) == []
                # no healthy helper: nothing offered
                assert ex._rebalance_offers(roll(True, helper_ok=False)) == []
                assert ex._rebalance_offers(
                    roll(True, helper_straggler=True)
                ) == []
            finally:
                await sched.close()

        run(go())

    def test_straggler_offers_and_peer_adopts(self, tmp_path):
        """End to end: worker 0's fleet view names itself a straggler
        (forced — in-process executors share one ledger, so real rate
        divergence can't show up); its unstarted units ride the
        heartbeat offer list and worker 1 adopts them through the
        ordinary adoption path. Coverage stays exact and both global
        bitfields identical."""
        items1, items2, mk_sched, mk_exec = self._executors(tmp_path)

        async def go():
            s0 = await mk_sched().start()
            s1 = await mk_sched().start()
            try:
                e0 = mk_exec(items1, s0, 0)
                e1 = mk_exec(items2, s1, 1)
                e0.fleet_snapshot = lambda: {  # force the verdict
                    "scoreboard": [
                        {"pid": 0, "status": "ok", "straggler": True},
                        {"pid": 1, "status": "ok", "straggler": False},
                    ]
                }
                await asyncio.gather(e0.run(), e1.run())
            finally:
                await s0.close()
                await s1.close()
            return e0, e1

        e0, e1 = run(go())
        snap0, snap1 = e0.metrics_snapshot(), e1.metrics_snapshot()
        assert snap0["units_offered"] >= 1
        assert snap1["units_rebalanced"] >= 1
        assert snap1["units_adopted"] >= snap1["units_rebalanced"]
        for a, b in zip(e0.bitfields(), e1.bitfields()):
            assert (a == b).all()
        total = sum(int(b.sum()) for b in e0.bitfields())
        assert total == e0.plan.total_pieces

    def test_rebalance_off_by_default(self, tmp_path):
        from torrent_tpu_torch.fabric import FabricConfig

        assert FabricConfig().rebalance is False


# ------------------------------------------------------------ end to end


class TestEndToEnd:
    def test_h2d_throttle_grows_target_and_shrinks_admission(self):
        async def go():
            plan = FaultPlan.parse("latency_ms=40")
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=8, flush_deadline=0.02,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            await sched.start()
            pilot = SchedulerAutopilot(
                sched,
                ControlConfig(enabled=True, hysteresis_ticks=1,
                              cooldown_ticks=0),
            )
            try:
                pieces = [bytes([i % 251]) * 1024 for i in range(64)]
                want = [hashlib.sha1(p).digest() for p in pieces]
                pilot.tick()
                last = None
                for _ in range(3):
                    assert await sched.submit("t", pieces) == want
                    last = pilot.tick()
                bn = last["decision"]["bottleneck"]
                assert bn and bn["stage"] == "h2d" and bn["confirmed"]
                snap = sched.metrics_snapshot()
                assert snap["lane_stats"]["sha1/1024"]["target"] > 8
                assert snap["admission_factor"] < 1.0
                # the status surface names the same actuator values
                status = pilot.status()
                assert status["actuators"]["lanes"]["sha1/1024"]["target"] > 8
                assert status["actions_total"].get("batch_target", 0) >= 1
            finally:
                await sched.close()

        run(go())

    def test_read_latency_throttle_names_read(self):
        """Satellite: the new read_latency_ms fault deterministically
        makes `read` the limiting stage, and the controller follows it
        (read is a per-launch cost, so the batch actuator moves too)."""
        async def go():
            plan = FaultPlan.parse("read_latency_ms=40")
            assert plan.read_latency_s == pytest.approx(0.04)
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=8, flush_deadline=0.02,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            await sched.start()
            pilot = SchedulerAutopilot(
                sched,
                ControlConfig(enabled=True, hysteresis_ticks=1,
                              cooldown_ticks=0),
            )
            try:
                pieces = [bytes([i % 251]) * 1024 for i in range(64)]
                want = [hashlib.sha1(p).digest() for p in pieces]
                pilot.tick()
                last = None
                for _ in range(2):
                    assert await sched.submit("t", pieces) == want
                    last = pilot.tick()
                bn = last["decision"]["bottleneck"]
                assert bn and bn["stage"] == "read" and bn["confirmed"]
                assert sched.metrics_snapshot()["lane_stats"]["sha1/1024"][
                    "target"
                ] > 8
            finally:
                await sched.close()

        run(go())

    def test_bad_read_latency_rejected(self):
        with pytest.raises(ValueError):
            FaultPlan.parse("read_latency_ms=-5")
        with pytest.raises(ValueError):
            FaultPlan.parse("read_latency=5")


class TestSurfaces:
    def test_render_control_metrics_lints(self):
        from torrent_tpu_torch.utils.metrics import render_control_metrics

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=4, flush_deadline=0.01),
                hasher="cpu",
            )
            await sched.start()
            pilot = SchedulerAutopilot(sched, ControlConfig(enabled=True))
            try:
                await sched.submit("t", [b"q" * 64])
                pilot.tick()
                text = render_control_metrics(pilot.metrics_snapshot())
            finally:
                await sched.close()
            return text

        text = run(go())
        prom_lint(text)
        assert "torrent_tpu_control_enabled 1" in text
        assert 'torrent_tpu_control_lane_target{lane="sha1/64"' in text
        # defensive on partial/empty snapshots
        prom_lint(render_control_metrics({}))


# ------------------------------------------------------- differential

# the reference's lane backends and their port counterparts: its pallas
# kernel's lane is the port's CUDA lane, and the alternative the
# reference trials for it (scan) is the port's hashlib floor (cpu)
# the reference's lanes whose steering the port keeps: a device lane
# trials hashlib. Its pallas ↔ scan trial has no counterpart (one plane a
# device), so the differential fuzz drives device lanes only
REF_TO_PORT_BACKEND = {"device": "device", "cpu": "cpu"}


def _port_inputs(inputs: dict) -> dict:
    out = dict(inputs)
    out["lanes"] = {
        name: {**lane, "backend": REF_TO_PORT_BACKEND[lane["backend"]]}
        for name, lane in inputs["lanes"].items()
    }
    return out


def _port_decision(decision: dict) -> dict:
    acts = []
    for a in decision["actions"]:
        if a["actuator"] == "backend":
            a = {**a, "from": REF_TO_PORT_BACKEND[a["from"]],
                 "to": REF_TO_PORT_BACKEND[a["to"]]}
        acts.append(a)
    return {**decision, "actions": acts}


def _fuzz_inputs(seed: int, ticks: int = 40):
    """A seeded sequence of decision inputs over two device lanes (two
    piece-length buckets): flapping and persistent verdicts, fill
    swings, idle intervals, admission pressure."""
    import numpy as np

    rng = np.random.default_rng(seed)
    stages = [None, "read", "h2d", "launch", "verdict"]
    stage = "launch"
    seq = []
    for _ in range(ticks):
        if rng.random() < 0.3:
            stage = stages[int(rng.integers(len(stages)))]
        lanes = {}
        for name, backend, bucket in (
            ("sha1/262144", "device", 262144), ("sha1/16384", "device", 16384),
        ):
            idle = rng.random() < 0.15
            base = mk_inputs(
                stage=stage,
                util=float(rng.choice([0.3, 0.7, 0.95])),
                headroom=float(rng.choice([1.2, 3.0, 8.0])),
                achieved=float(rng.integers(1, 1 << 20)) * 64,
                launch_bps=None if idle else float(rng.integers(1, 1 << 24)),
                fill=None if idle else float(rng.random()),
                launches=0 if idle else int(rng.integers(1, 9)),
                target=int(rng.choice([8, 16, 64])),
                backend=backend,
                qw=float(rng.random() * 0.05),
                factor=float(rng.choice([1.0, 0.5, 0.25])),
                lane=name,
            )
            lane = base["lanes"][name]
            lane["bucket"] = bucket
            lanes[name] = lane
        base["lanes"] = lanes
        seq.append(base)
    return seq


class TestDifferential:
    """``control.decide`` of the reference and of the port, fed the same
    inputs, give the same decisions up to the backend-name mapping."""

    @pytest.mark.parametrize("enabled", [True, False], ids=["armed", "observe"])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_decide_sequences_agree(self, seed, enabled):
        from torrent_tpu.sched import control as ref_control
        from torrent_tpu_torch.compat import control_config_from_reference

        ref_cfg = ref_control.ControlConfig(
            enabled=enabled, hysteresis_ticks=2, cooldown_ticks=1
        )
        cfg = control_config_from_reference(ref_cfg)
        assert cfg == ControlConfig(enabled=enabled, hysteresis_ticks=2, cooldown_ticks=1)
        ref_state, state = ref_control.initial_state(), initial_state()
        backend_moves = 0
        for inputs in _fuzz_inputs(seed):
            ref_d, ref_state = ref_control.decide(inputs, ref_state, ref_cfg)
            d, state = decide(_port_inputs(inputs), state, cfg)
            assert d == _port_decision(ref_d)
            backend_moves += sum(a["actuator"] == "backend" for a in d["actions"])
        if enabled and seed == 0:
            assert backend_moves  # the sequence exercises the trial protocol

    def test_build_inputs_agree(self):
        """The same ledger snapshots and control surfaces give the same
        decision inputs (attribution, lane deltas, queue-wait mean)."""
        from torrent_tpu.sched import control as ref_control
        from torrent_tpu_torch.obs.ledger import PipelineLedger

        led = PipelineLedger()
        prev = led.snapshot()
        led.record("h2d", 8 << 20, 0.5)
        led.record("launch", 8 << 20, 0.2)
        with led.track("read", 4 << 20):
            pass
        cur = led.snapshot()
        lane = {"algo": "sha1", "bucket": 16384, "granule": 1, "target": 64,
                "base_target": 64, "afford": 8000, "deadline": 0.02,
                "base_deadline": 0.02, "backend": "device", "pending": 3}
        psurf = {"lanes": {"sha1/16384": {**lane, "launches": 2, "fill_sum": 1.5}},
                 "admission": {"factor": 1.0, "max_queue_bytes": 1 << 28}}
        surf = {"lanes": {"sha1/16384": {**lane, "launches": 7, "fill_sum": 5.25}},
                "admission": {"factor": 0.5, "max_queue_bytes": 1 << 28}}
        qw0, qw1 = ([], 4, 0.2), ([], 10, 0.5)
        got = build_inputs(cur, prev, surf, psurf, qw1, qw0)
        want = ref_control.build_inputs(cur, prev, surf, psurf, qw1, qw0)
        assert got == want
        assert got["lanes"]["sha1/16384"]["launches"] == 5

    def test_no_backend_trial_leaves_the_card_or_the_plain_plane(self):
        """Where the reference trials scan → pallas or pallas → scan, the
        port's lanes on the card ('cuda') and its plain sha256 lanes
        ('torch', device="cpu" only) trial nothing, while a device lane
        fed the same persistent launch-bound verdicts trials hashlib."""
        from torrent_tpu.sched import control as ref_control
        from torrent_tpu_torch.sched.control import ALT_BACKEND

        assert ALT_BACKEND == {"device": "cpu"}
        cfg = ControlConfig(hysteresis_ticks=1, cooldown_ticks=0)
        ref_cfg = ref_control.ControlConfig(hysteresis_ticks=1, cooldown_ticks=0)

        def trials(decide_fn, state, config, backend):
            moves = []
            for _ in range(6):
                d, state = decide_fn(mk_inputs(stage="launch", backend=backend), state, config)
                moves += [a["to"] for a in d["actions"] if a["actuator"] == "backend"]
            return moves

        for backend in ("cuda", "torch"):
            assert trials(decide, initial_state(), cfg, backend) == []
        assert trials(decide, initial_state(), cfg, "device")[:1] == ["cpu"]
        for ref_backend, alt in (("scan", "pallas"), ("pallas", "scan")):
            got = trials(ref_control.decide, ref_control.initial_state(), ref_cfg, ref_backend)
            assert got[:1] == [alt]
