"""The port's fleet observability plane (torrent_tpu_torch/obs/fleet and
its fabric integration), against the reference.

The reference's tests/test_fleet.py, ported (its session metrics
endpoint, bridge route, ``top`` and CLI-result cases wait for later
slices): heartbeat-carried obs digests, mergeable histogram snapshots,
the swarm rollup's two-level bottleneck attribution and straggler
scoreboard, overflow hardening of the all-gather heartbeat, and the
``FleetObsServer`` surface. ``TestDifferential`` feeds both packages'
``build_obs_digest``, ``aggregate_fleet`` and ``render_fleet_metrics``
the same inputs and compares the outputs byte for byte.
"""

from __future__ import annotations

import asyncio
import copy
import json
import os

import numpy as np
import pytest

from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.fabric import (
    AllgatherHeartbeat,
    FabricConfig,
    build_fabric_executor,
    plan_library,
    plan_payload_bytes,
)
from torrent_tpu_torch.obs.fleet import (
    DIGEST_MAX_BYTES,
    aggregate_fleet,
    build_obs_digest,
    clamp_digest,
    digest_bytes,
    local_fleet_snapshot,
    obs_digest,
)
from torrent_tpu_torch.obs.hist import (
    BUCKET_BOUNDS,
    HistogramRegistry,
    merge_snapshots,
)
from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig
from torrent_tpu_torch.storage.storage import FsStorage, Storage
from torrent_tpu_torch.tools.make_torrent import make_torrent

PLEN = 16384


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def make_library(tmp_path, sizes_pieces, seed=7):
    rng = np.random.default_rng(seed)
    ddir = tmp_path / "data"
    items = []
    for t, npieces in enumerate(sizes_pieces):
        root = ddir / f"lib{t}"
        root.mkdir(parents=True)
        size = (npieces - 1) * PLEN + PLEN // 2
        payload = root / "payload.bin"
        payload.write_bytes(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        meta = parse_metainfo(
            make_torrent(str(payload), "http://t.invalid/announce", piece_length=PLEN, hasher="cpu")
        )
        items.append((Storage(FsStorage(str(root)), meta.info), meta.info))
    return items


def cpu_sched():
    return HashPlaneScheduler(
        SchedulerConfig(batch_target=16, flush_deadline=0.01), hasher="cpu"
    )


class TestMergeSnapshots:
    def test_bucket_aligned_sum(self):
        n = len(BUCKET_BOUNDS) + 1
        a = [0] * n
        b = [0] * n
        a[3], a[5] = 2, 1
        b[3], b[-1] = 4, 7  # -1 = the +Inf overflow bucket
        counts, count, total = merge_snapshots(
            [(a, 3, 0.5), (b, 11, 2.25)]
        )
        assert counts[3] == 6 and counts[5] == 1
        assert counts[-1] == 7, "+Inf overflow bucket must survive the merge"
        assert count == 14
        assert total == pytest.approx(2.75)

    def test_empty_merges_to_zero(self):
        counts, count, total = merge_snapshots([])
        assert counts == [0] * (len(BUCKET_BOUNDS) + 1)
        assert count == 0 and total == 0.0

    def test_alignment_mismatch_rejected(self):
        n = len(BUCKET_BOUNDS) + 1
        with pytest.raises(ValueError):
            merge_snapshots([([0] * n, 0, 0.0), ([0] * (n - 1), 0, 0.0)])

    def test_family_snapshot_merges_label_sets(self):
        reg = HistogramRegistry()
        reg.get("fam", help="x", lane="a").observe(0.001)
        reg.get("fam", help="x", lane="b").observe(0.002)
        reg.get("fam", help="x", lane="b").observe(1e9)  # +Inf bucket
        snap = reg.family_snapshot("fam")
        assert snap is not None
        counts, count, total = snap
        assert count == 3
        assert counts[-1] == 1  # the wedged outlier survives
        assert reg.family_snapshot("nope") is None


class TestDigest:
    def _ledger_snap(self, stages, wall=10.0):
        return {
            "t_first": 0.0,
            "t_last": wall,
            "t_snap": wall,
            "overlap": {"busy_s": 1.0, "concurrent_stages": 0,
                        "max_concurrent_stages": 2},
            "stages": {
                name: {"busy_s": b, "bytes": y, "ops": o,
                       "active": 0, "max_active": 1}
                for name, (b, y, o) in stages.items()
            },
        }

    def test_build_shape_and_delta(self):
        base = self._ledger_snap({"read": (1.0, 100, 1)}, wall=5.0)
        cur = self._ledger_snap(
            {"read": (3.0, 300, 3), "h2d": (4.0, 50, 2)}, wall=9.0
        )
        d = build_obs_digest(cur, base, {}, {}, {"done": 2, "planned": 4})
        assert d["v"] == 1
        # delta against base: read busy 3-1=2, bytes 300-100=200
        assert d["stages"]["read"] == {"busy_s": 2.0, "bytes": 200, "ops": 2}
        assert d["stages"]["h2d"]["busy_s"] == 4.0
        # wall anchored at the base snapshot (t_snap=5.0 .. t_last=9.0)
        assert d["wall_s"] == pytest.approx(4.0)
        assert d["unit"] == {"done": 2, "planned": 4}

    def test_size_bound_and_clamp_order(self):
        # a pathological digest: hundreds of histogram buckets + lanes
        big_hist = {
            f"fam{i}": ([1] * (len(BUCKET_BOUNDS) + 1), 25, 1.0)
            for i in range(20)
        }
        sched_snap = {
            "breakers": {
                f"sha1/{1 << k}": {"state": "open"} for k in range(20)
            },
            "launches": 5,
        }
        cur = self._ledger_snap({s: (1.0, 10, 1) for s in
                                 ("read", "stage", "h2d", "launch",
                                  "digest", "verdict")})
        d = build_obs_digest(cur, None, big_hist, sched_snap, {})
        assert digest_bytes(d) <= DIGEST_MAX_BYTES
        # clamp drops hist first, keeps unit/wall longest
        huge = {"v": 1, "wall_s": 1.0, "unit": {"done": 1},
                "hist": {"x": {"buckets": {str(i): i for i in range(500)}}},
                "sched": {"launches": 1}, "stages": {}}
        clamped = clamp_digest(huge, max_bytes=200)
        assert "hist" not in clamped
        assert clamped["unit"] == {"done": 1}

    def test_digest_deterministic_bytes(self):
        cur = self._ledger_snap({"read": (1.5, 100, 2)})
        snaps = {"queue_wait": ([0] * (len(BUCKET_BOUNDS) + 1), 0, 0.0)}
        a = build_obs_digest(cur, None, snaps, {"launches": 3}, {"done": 1})
        b = build_obs_digest(cur, None, snaps, {"launches": 3}, {"done": 1})
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)

    def test_obs_digest_live_registry(self):
        d = obs_digest()
        assert d["v"] == 1
        assert digest_bytes(d) <= DIGEST_MAX_BYTES

    def test_breaker_lane_cap(self):
        sched_snap = {
            "breakers": {f"sha1/{k}": {"state": "open"} for k in range(10)}
        }
        d = build_obs_digest(
            self._ledger_snap({}), None, {}, sched_snap, {}
        )
        assert len(d["sched"]["breakers"]) == 6
        assert d["sched"]["breakers_open_unnamed"] == 4


class TestAggregate:
    def _digests(self):
        # process 0: h2d-throttled straggler — long wall, h2d-dominated
        a = {
            "v": 1, "wall_s": 10.0,
            "stages": {
                "read": {"busy_s": 0.5, "bytes": 1 << 26, "ops": 4},
                "h2d": {"busy_s": 9.5, "bytes": 1 << 26, "ops": 4},
                "verdict": {"busy_s": 0.1, "bytes": 1 << 26, "ops": 4},
            },
            "overlap": {"busy_s": 0.2, "max_concurrent_stages": 2},
            "unit": {"done": 3, "planned": 3, "adopted": 0, "pieces": 96},
        }
        # process 1: healthy — short wall, launch-bound
        b = {
            "v": 1, "wall_s": 1.0,
            "stages": {
                "read": {"busy_s": 0.2, "bytes": 1 << 26, "ops": 4},
                "launch": {"busy_s": 0.7, "bytes": 1 << 26, "ops": 4},
                "verdict": {"busy_s": 0.05, "bytes": 1 << 26, "ops": 4},
            },
            "overlap": {"busy_s": 0.1, "max_concurrent_stages": 2},
            "unit": {"done": 2, "planned": 2, "adopted": 0, "pieces": 64},
        }
        return {0: a, 1: b}

    def test_two_level_bottleneck(self):
        roll = aggregate_fleet(self._digests())
        bn = roll["bottleneck"]
        assert bn["pid"] == 0, "the long-wall straggler limits the fleet"
        assert bn["stage"] == "h2d", "and h2d limits the straggler"
        assert bn["utilization"] == pytest.approx(0.95)
        assert bn["fleet_median_bps"] is not None
        assert roll["reporting"] == 2

    def test_straggler_scoreboard(self):
        roll = aggregate_fleet(self._digests())
        rows = {r["pid"]: r for r in roll["scoreboard"]}
        # pid 0 moved the same bytes over 10x the wall: far below median
        assert rows[0]["straggler"] is True
        assert rows[1]["straggler"] is False
        assert rows[0]["vs_median"] < 0.5 < rows[1]["vs_median"]
        assert rows[0]["limiting_stage"] == "h2d"
        assert rows[1]["limiting_stage"] == "launch"

    def test_statuses_and_adoption_debt(self):
        digests = self._digests()
        digests[0]["unit"]["done"] = 1  # lapsed mid-shard
        roll = aggregate_fleet(
            digests,
            statuses={0: "lapsed", 1: "ok", 2: "unreported"},
            planned_units={0: 3, 1: 2, 2: 4},
            nproc=3,
        )
        rows = {r["pid"]: r for r in roll["scoreboard"]}
        assert rows[0]["status"] == "lapsed"
        assert rows[0]["adoption_debt"] == 2  # 3 planned - 1 done
        assert rows[1]["adoption_debt"] == 0
        assert rows[2]["status"] == "unreported"
        assert rows[2]["achieved_bps"] is None
        assert roll["nproc"] == 3 and roll["reporting"] == 2

    def test_empty_fleet(self):
        roll = aggregate_fleet({})
        assert roll["bottleneck"] is None
        assert roll["scoreboard"] == []
        assert roll["totals"]["fleet_bps"] is None

    def test_local_fleet_snapshot(self):
        roll = local_fleet_snapshot()
        assert roll["state"] == "local"
        assert roll["nproc"] == 1
        assert len(roll["scoreboard"]) == 1


class TestOverflowHardening:
    def test_allgather_drops_digest_first_and_counts(self):
        """A payload over the buffer budget sheds its obs digest FIRST
        (counted), keeping verdict bits publishable; only a still-
        oversized payload degrades to the minimal envelope. Outside a
        process group the all-gather is the identity gather (one row),
        so the size/drop logic runs exactly as in a group."""
        payload = {
            "pid": 0, "seq": 3, "t": 1.0, "fp": "abc", "degraded": False,
            "done": {"0": "ff" * 40}, "inflight": [], "distrust": [],
            "redone": [],
            "obs": {"v": 1, "wall_s": 1.0,
                    "stages": {"read": {"busy_s": 1.0, "bytes": 1, "ops": 1}}},
        }
        without_obs = len(
            json.dumps({k: v for k, v in payload.items() if k != "obs"}).encode()
        )
        hb = AllgatherHeartbeat(1, 0, max_bytes=without_obs + 8)
        peers = hb.exchange(dict(payload))
        assert peers == {}  # solo cluster: no peers
        assert hb.digest_drops == 1, "digest drop must be counted, not silent"
        # roomy buffer: nothing dropped
        hb2 = AllgatherHeartbeat(1, 0, max_bytes=1 << 16)
        hb2.exchange(dict(payload))
        assert hb2.digest_drops == 0

    def test_plan_payload_budgets_worst_case_digest(self, tmp_path):
        items = make_library(tmp_path, [12, 20])
        plan = plan_library([i for _, i in items], 2, unit_bytes=8 * PLEN)
        assert plan_payload_bytes(plan) >= 4096 + DIGEST_MAX_BYTES


class TestExecutorFleet:
    def test_heartbeats_carry_digests_and_fleet_view(self, tmp_path):
        """Two in-process executors over one heartbeat dir: both ends
        hold the peer's digest, both fleet views report 2 processes,
        and every heartbeat payload (digest attached) stays within the
        plan's allgather budget."""
        items1 = make_library(tmp_path, [12, 20, 7])
        items2 = [
            (Storage(FsStorage(s.method.root), info), info)
            for (s, info) in items1
        ]

        async def go():
            s0 = await cpu_sched().start()
            s1 = await cpu_sched().start()
            cfg = FabricConfig(heartbeat_interval=0.05, lapse_after=3.0)
            try:
                e0 = build_fabric_executor(
                    items1, s0, nproc=2, pid=0,
                    heartbeat_dir=str(tmp_path / "hb"), config=cfg,
                    unit_bytes=8 * PLEN,
                )
                e1 = build_fabric_executor(
                    items2, s1, nproc=2, pid=1,
                    heartbeat_dir=str(tmp_path / "hb"), config=cfg,
                    unit_bytes=8 * PLEN,
                )
                await asyncio.gather(e0.run(), e1.run())
            finally:
                await s0.close()
                await s1.close()
            return e0, e1

        e0, e1 = run(go())
        for me, peer_pid in ((e0, 1), (e1, 0)):
            peer_payload = me._peer_seen[peer_pid]
            assert isinstance(peer_payload.get("obs"), dict), (
                "heartbeat did not carry the obs digest"
            )
            assert digest_bytes(peer_payload["obs"]) <= DIGEST_MAX_BYTES
            fl = me.fleet_snapshot()
            assert fl["nproc"] == 2 and fl["reporting"] == 2
            assert {r["pid"] for r in fl["scoreboard"]} == {0, 1}
            assert fl["bottleneck"] is not None
            assert fl["digest_drops"] == 0
            # the whole payload (digest included) fits the budgeted
            # allgather buffer for this plan
            budget = plan_payload_bytes(me.plan)
            assert len(json.dumps(peer_payload).encode()) <= budget
        assert e0.metrics_snapshot()["digest_drops"] == 0
        # regression: once the sweep is done peers legitimately stop
        # heartbeating — a later scrape must NOT flip them to "lapsed"
        # (with spurious adoption debt) just because their last
        # heartbeat aged past the lapse window
        import time as _time

        seq, _ = e0._peer_advance[1]
        e0._peer_advance[1] = (seq, _time.monotonic() - 999)
        rows = {r["pid"]: r for r in e0.fleet_snapshot()["scoreboard"]}
        assert rows[1]["status"] == "ok", rows[1]
        assert rows[1]["adoption_debt"] == 0

    def test_digest_disabled_by_config(self, tmp_path):
        items = make_library(tmp_path, [6])

        async def go():
            sched = await cpu_sched().start()
            cfg = FabricConfig(
                heartbeat_interval=0.05, lapse_after=0.3,
                carry_obs_digest=False,
            )
            try:
                ex = build_fabric_executor(
                    items, sched, nproc=2, pid=0,
                    heartbeat_dir=str(tmp_path / "hb"), config=cfg,
                    unit_bytes=8 * PLEN,
                )
                await ex.run()
            finally:
                await sched.close()
            return ex

        ex = run(go())
        # lone survivor: its own heartbeat files carry no obs field
        hb_file = tmp_path / "hb" / "fabric_hb_0.json"
        payload = json.loads(hb_file.read_text())
        assert "obs" not in payload
        # the fleet view still answers from local state
        assert ex.fleet_snapshot()["reporting"] >= 1

    def test_solo_executor_fleet_view(self, tmp_path):
        items = make_library(tmp_path, [6])

        async def go():
            sched = await cpu_sched().start()
            try:
                ex = build_fabric_executor(
                    items, sched, nproc=1, pid=0, unit_bytes=8 * PLEN
                )
                await ex.run()
            finally:
                await sched.close()
            return ex

        ex = run(go())
        fl = ex.fleet_snapshot()
        assert fl["nproc"] == 1 and fl["reporting"] == 1
        assert fl["scoreboard"][0]["units_done"] == fl["scoreboard"][0][
            "units_planned"
        ]


class TestFleetObsServer:
    def test_serves_fleet_and_metrics(self):
        from test_metrics import prom_lint

        from torrent_tpu_torch.obs.fleet import FleetObsServer

        async def go():
            import urllib.request

            srv = await FleetObsServer(lambda: None).start(0)
            try:
                def fetch(path):
                    with urllib.request.urlopen(
                        f"http://127.0.0.1:{srv.port}{path}", timeout=10
                    ) as r:
                        return r.read().decode()

                fleet = json.loads(await asyncio.to_thread(fetch, "/v1/fleet"))
                assert fleet["state"] == "local"
                text = await asyncio.to_thread(fetch, "/metrics")
                prom_lint(text)
                assert "torrent_tpu_fleet_reporting" in text
            finally:
                srv.close()

        run(go())




class TestDifferential:
    """The same inputs through both packages' fleet plane."""

    def _inputs(self):
        base = TestDigest()._ledger_snap({"read": (1.0, 100, 1)}, wall=5.0)
        cur = TestDigest()._ledger_snap(
            {"read": (3.0, 300, 3), "h2d": (4.0, 50, 2), "launch": (0.5, 50, 2)}, wall=9.0
        )
        n = len(BUCKET_BOUNDS) + 1
        hist = {"queue_wait": ([1] * n, n, 0.75), "launch": ([0] * (n - 1) + [2], 2, 9.0)}
        sched = {
            "breakers": {f"sha1/{1 << k}": {"state": "open" if k % 2 else "closed"} for k in range(9)},
            "launches": 5, "cpu_fallback_launches": 1, "shed": 2,
        }
        return cur, base, hist, sched

    def test_build_obs_digest_agrees(self):
        from torrent_tpu.obs.fleet import build_obs_digest as ref_build

        cur, base, hist, sched = self._inputs()
        for unit in ({}, {"done": 2, "planned": 4, "adopted": 1, "pieces": 64}):
            mine = build_obs_digest(cur, base, hist, sched, unit)
            ref = ref_build(cur, base, hist, sched, unit)
            assert json.dumps(mine, sort_keys=True) == json.dumps(ref, sort_keys=True)
            assert json.dumps(clamp_digest(mine, 300), sort_keys=True) == json.dumps(
                ref_build.__globals__["clamp_digest"](ref, 300), sort_keys=True
            )

    def test_aggregate_and_render_agree(self):
        from torrent_tpu.obs.fleet import aggregate_fleet as ref_aggregate
        from torrent_tpu.utils.metrics import render_fleet_metrics as ref_render

        from torrent_tpu_torch.utils.metrics import render_fleet_metrics

        digests = TestAggregate()._digests()
        cases = [
            dict(),
            dict(statuses={0: "lapsed", 1: "ok", 2: "unreported"}, planned_units={0: 3, 1: 2, 2: 4}, nproc=3),
        ]
        for kw in cases:
            mine = aggregate_fleet(copy.deepcopy(digests), **kw)
            ref = ref_aggregate(copy.deepcopy(digests), **kw)
            assert json.dumps(mine, sort_keys=True) == json.dumps(ref, sort_keys=True)
            assert render_fleet_metrics(mine) == ref_render(ref)
        # a wide fleet folds its tail pids into one overflow series
        wide = {p: dict(digests[p % 2], unit=dict(digests[p % 2]["unit"])) for p in range(20)}
        mine, ref = aggregate_fleet(wide), ref_aggregate(wide)
        assert render_fleet_metrics(mine) == ref_render(ref)
        assert 'pid="overflow"' in render_fleet_metrics(mine)

    def test_render_fabric_metrics_agrees(self, tmp_path):
        from torrent_tpu.utils.metrics import render_fabric_metrics as ref_render

        from torrent_tpu_torch.utils.metrics import render_fabric_metrics

        items = make_library(tmp_path, [6, 9])

        async def go():
            sched = await cpu_sched().start()
            try:
                ex = build_fabric_executor(items, sched, nproc=1, pid=0, unit_bytes=8 * PLEN)
                await ex.run()
            finally:
                await sched.close()
            return ex

        ex = run(go())
        snap = ex.metrics_snapshot()
        assert render_fabric_metrics(snap) == ref_render(snap)
        assert render_fabric_metrics({}) == ref_render({})
        fleet = ex.fleet_snapshot()
        from torrent_tpu.utils.metrics import render_fleet_metrics as ref_fleet

        from torrent_tpu_torch.utils.metrics import render_fleet_metrics

        assert render_fleet_metrics(fleet) == ref_fleet(fleet)
