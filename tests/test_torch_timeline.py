"""The port's timeline, SLO and swarm-telemetry planes
(torrent_tpu_torch/obs/timeline.py, obs/slo.py, obs/swarm.py,
serve_plane/telemetry.py) and their Prometheus renderers, against the
reference.

The reference's tests/test_timeline.py (ring, sampler, replay, SLO
evaluation, engine, armed slot, health, the bridge's timeline/SLO/health
routes, the fault-burst acceptance scenario, the sharded tracker's and
the serve recipe's health, the fleet budget rollup), the device-free
registry classes of tests/test_swarm_obs.py, and the timeline, SLO,
swarm and serve renderer cases of tests/test_metrics.py, ported. The
bridge cases run ``hasher="cpu"`` (hashlib), as the reference's do: the
acceptance scenario relies on the breaker's hashlib degradation, which a
CPU scheduler keeps.

``TestDifferential`` then holds the copies against the reference on the
same seeded inputs: a reference timeline carried across by
``compat.timeline_from_reference`` replays and evaluates to equal
reports, both renderers print the same text, and both packages raise
the same exception on the reference-side fault the copy keeps
(``replay_report`` on a sample whose ``sched`` is not a dict).
"""

import asyncio
import hashlib
import json
import os

import numpy as np
import pytest

from test_metrics import prom_lint
from torrent_tpu_torch.obs.recorder import flight_recorder
from torrent_tpu_torch.obs.slo import (
    FAST_BURN,
    SloEngine,
    build_health,
    default_objectives,
    digest_summary,
    evaluate_slo,
    parse_objectives,
)
from torrent_tpu_torch.obs.swarm import (
    ANNOUNCE_STREAK,
    MAX_TRACKED_PEERS,
    TOP_PEERS,
    SwarmTelemetry,
    build_swarm_snapshot,
    swarm_telemetry,
)
from torrent_tpu_torch.obs.timeline import (
    Timeline,
    TimelineSampler,
    build_sample,
    replay_report,
)


def run(coro, timeout=90):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def mk_sample(t, pieces=0, shed=0, failed=0, breaker_opens=0, races=0,
              h2d_busy=0.0, h2d_bytes=0, verdict_bytes=0, verdict_ops=0,
              hist=None):
    """Synthetic cumulative-counter sample, bypassing build_sample."""
    stages = {}
    if h2d_busy:
        stages["h2d"] = {"busy_s": h2d_busy, "bytes": h2d_bytes,
                         "ops": max(1, int(h2d_busy * 10))}
    if verdict_ops:
        stages["verdict"] = {"busy_s": 0.01 * verdict_ops,
                             "bytes": verdict_bytes, "ops": verdict_ops}
    return {
        "v": 1,
        "t": float(t),
        "stages": stages,
        "overlap_s": 0.0,
        "sched": {"pieces": pieces, "shed": shed, "failed_pieces": failed},
        "hist": hist or {},
        "integrity": {"breaker_opens": breaker_opens, "open_lanes": 0,
                      "races": races, "distrust": 0},
    }


# ------------------------------------------------------------------- ring


class TestTimelineRing:
    def test_push_bound_and_drop_counter(self):
        tl = Timeline(depth=4)
        for i in range(7):
            tl.push(mk_sample(i))
        snap = tl.snapshot()
        assert snap["seq"] == 7
        assert snap["drops"] == 3
        assert len(snap["samples"]) == 4
        # oldest fell off; seq stamps survive
        assert [s["seq"] for s in snap["samples"]] == [4, 5, 6, 7]
        assert snap["depth"] == 4

    def test_clear_resets(self):
        tl = Timeline(depth=4)
        tl.push(mk_sample(1))
        tl.clear()
        snap = tl.snapshot()
        assert snap["seq"] == 0 and not snap["samples"] and snap["drops"] == 0


class TestBuildSample:
    def test_deterministic_and_compact(self):
        led = {"stages": {"read": {"busy_s": 1.0, "bytes": 10, "ops": 2},
                          "idle": {"busy_s": 0.0, "bytes": 0, "ops": 0}},
               "overlap": {"busy_s": 0.5}}
        sched = {
            "tenants": {"b": {"served_pieces": 3}, "a": {"served_pieces": 7}},
            "shed_total": 2,
            "failed_pieces": 1,
            "admission_factor": 0.5,
            "breakers": {
                "sha1/1": {"state": "open",
                           "transitions": {"closed->open": 2,
                                           "open->half_open": 1}},
            },
        }
        s1 = build_sample(12.5, led, sched_snap=sched)
        s2 = build_sample(12.5, led, sched_snap=sched)
        assert s1 == s2
        assert json.dumps(s1, sort_keys=True) == json.dumps(s2, sort_keys=True)
        assert s1["t"] == 12.5
        assert s1["sched"]["pieces"] == 10
        assert s1["sched"]["shed"] == 2
        assert s1["sched"]["admission_factor"] == 0.5
        # zero-op stages dropped (digest cardinality discipline)
        assert "idle" not in s1["stages"]
        assert s1["integrity"] == {"breaker_opens": 2, "open_lanes": 1,
                                   "races": 0, "distrust": 0}

    def test_pieces_counter_survives_tenant_eviction(self):
        """The availability denominator stays CUMULATIVE across tenant
        eviction: the scheduler moves an evicted tenant's served_pieces
        into the `evicted` blob, and the sample must count them — a
        dropping counter would make a real burst invisible (events
        delta clamps to 0) or a benign eviction page falsely."""
        before = {"tenants": {"a": {"served_pieces": 900},
                              "b": {"served_pieces": 100}},
                  "evicted": {"served_pieces": 0}}
        after = {"tenants": {"b": {"served_pieces": 110}},
                 "evicted": {"served_pieces": 900}}
        s0 = build_sample(1.0, {}, sched_snap=before)
        s1 = build_sample(2.0, {}, sched_snap=after)
        assert s0["sched"]["pieces"] == 1000
        assert s1["sched"]["pieces"] == 1010  # monotone across eviction

    def test_optional_fields_absent_when_off(self):
        s = build_sample(1.0, {})
        assert "control" not in s and "fleet" not in s and "tracker" not in s
        s = build_sample(1.0, {}, control={"stage": "h2d", "confirmed": True},
                         tracker={"announces": 5, "peers": 2, "swarms": 1})
        assert s["control"] == {"stage": "h2d", "confirmed": True}
        assert s["tracker"]["announces"] == 5


class TestSampler:
    def test_sample_once_captures_scheduler(self):
        from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig

        async def go():
            sched = HashPlaneScheduler(SchedulerConfig(), hasher="cpu")
            await sched.start()
            try:
                await sched.submit("tl", [b"x" * 64])
                tl = Timeline(depth=8)
                sampler = TimelineSampler(tl, scheduler=sched)
                sample = sampler.sample_once()
                assert sample["sched"]["pieces"] >= 1
                assert tl.snapshot()["seq"] == 1
            finally:
                await sched.close()

        run(go())

    def test_thread_lifecycle_and_alive(self):
        tl = Timeline(depth=8)
        sampler = TimelineSampler(tl, interval_s=0.01)
        assert not sampler.alive
        sampler.start()
        assert sampler.alive
        sampler.stop()
        assert not sampler.alive

    def test_broken_source_never_kills_a_sample(self):
        tl = Timeline(depth=8)

        def boom():
            raise RuntimeError("source down")

        sampler = TimelineSampler(tl, sources={"tracker": boom})
        sample = sampler.sample_once()
        assert "tracker" not in sample  # dropped, not fatal
        assert tl.snapshot()["seq"] == 1

    def test_dump_writes_replayable_file(self, tmp_path):
        tl = Timeline(depth=8)
        sampler = TimelineSampler(tl, dump_dir=str(tmp_path))
        sampler.sample_once()
        sampler.sample_once()
        path = sampler.dump()
        assert path and os.path.exists(path)
        with open(path) as f:
            payload = json.load(f)
        assert len(payload["samples"]) == 2
        assert replay_report(payload)["samples"] == 2

    def test_on_sample_hook_failure_tolerated(self):
        tl = Timeline(depth=8)
        calls = []

        def hook(snap):
            calls.append(len(snap["samples"]))
            raise RuntimeError("engine down")

        sampler = TimelineSampler(tl, on_sample=hook)
        sampler.sample_once()
        assert calls == [1]


# ----------------------------------------------------------------- replay


class TestReplay:
    def test_interval_and_overall_attribution(self):
        # h2d monotonically busiest: every interval and the overall
        # verdict must name it — the same answer the live attributor
        # gives over the same deltas
        samples = [
            mk_sample(t, h2d_busy=0.9 * t, h2d_bytes=1000 * t,
                      verdict_bytes=100 * t, verdict_ops=t)
            for t in range(1, 6)
        ]
        rep = replay_report({"samples": samples, "drops": 2})
        assert rep["samples"] == 5 and rep["drops"] == 2
        assert len(rep["intervals"]) == 4
        assert all(i["limiting"] == "h2d" for i in rep["intervals"])
        assert rep["overall"]["bottleneck"]["stage"] == "h2d"
        # ages count back from the newest sample
        assert rep["intervals"][-1]["age_s"] == 0.0
        assert rep["intervals"][0]["age_s"] == 3.0

    def test_empty_and_hostile_payloads(self):
        assert replay_report({})["samples"] == 0
        assert replay_report({"samples": None})["intervals"] == []
        rep = replay_report({"samples": [{"t": "x"}, 3, {"stages": "nope"}]})
        assert rep["samples"] == 2  # non-dicts filtered
        assert rep["overall"] is None or rep["overall"]["bottleneck"] is None

    def test_slo_evaluation_rides_along(self):
        samples = [mk_sample(1, pieces=10), mk_sample(2, pieces=10, failed=30)]
        rep = replay_report(
            {"samples": samples}, objectives=parse_objectives("availability=0.99")
        )
        assert rep["slo"]["objectives"]["availability"]["breach"]


# ----------------------------------------------------------------- SLO


class TestEvaluateSlo:
    def _avail(self, samples, target=0.999, short=4, long=16):
        return evaluate_slo(
            samples, parse_objectives(f"availability={target}"),
            short_samples=short, long_samples=long,
        )["objectives"]["availability"]

    def test_clean_ring_is_ok(self):
        samples = [mk_sample(t, pieces=10 * t) for t in range(1, 8)]
        obj = self._avail(samples)
        assert obj["classification"] == "ok" and not obj["breach"]
        assert obj["budget_remaining"] == 1.0

    def test_burst_is_fast_burn_breach(self):
        samples = [mk_sample(1, pieces=10), mk_sample(2, pieces=10, failed=10)]
        obj = self._avail(samples)
        assert obj["classification"] == "fast_burn" and obj["breach"]
        assert obj["budget_remaining"] == 0.0
        assert obj["burn_rate"] >= FAST_BURN

    def test_breach_clears_when_short_window_runs_clean(self):
        burst = [mk_sample(1, pieces=10), mk_sample(2, pieces=10, failed=10)]
        assert self._avail(burst)["breach"]
        # healthy samples push the errors out of the 4-sample short
        # window; the long window still shows the burn (slow_burn /
        # budget spent) but the page-now condition clears
        healthy = burst + [
            mk_sample(2 + i, pieces=10 + 10 * i, failed=10) for i in range(1, 6)
        ]
        obj = self._avail(healthy)
        assert not obj["breach"]
        assert obj["classification"] in ("ok", "slow_burn")

    def test_burn_rate_monotone_in_error_count(self):
        def burn(failed):
            samples = [mk_sample(1, pieces=100),
                       mk_sample(2, pieces=200, failed=failed)]
            return self._avail(samples)["burn_rate"]

        rates = [burn(f) for f in (0, 1, 5, 20, 80)]
        assert rates == sorted(rates)
        assert rates[0] == 0.0 and rates[-1] > rates[1]

    def test_integrity_event_burns_instantly_then_clears(self):
        objs = parse_objectives("integrity=on")
        burst = [mk_sample(1), mk_sample(2, breaker_opens=1)]
        rep = evaluate_slo(burst, objs, short_samples=3, long_samples=16)
        obj = rep["objectives"]["integrity"]
        assert obj["breach"] and obj["classification"] == "fast_burn"
        assert obj["budget_remaining"] == 0.0
        # the event ages out of the short window -> breach clears
        healthy = burst + [mk_sample(2 + i, breaker_opens=1) for i in range(1, 5)]
        obj = evaluate_slo(healthy, objs, short_samples=3, long_samples=16)[
            "objectives"]["integrity"]
        assert not obj["breach"]

    def test_latency_objective_over_log2_buckets(self):
        objs = parse_objectives("p99_ms=8:queue_wait")  # 0.008 s target
        # bucket 10 covers (2^-8, 2^-7] ≈ (3.9ms, 7.8ms]: under target;
        # bucket 16 covers (2^-2, 2^-1]: way over target
        fast = {"queue_wait": {"count": 100, "sum": 0.1,
                               "buckets": {"10": 100}}}
        slow = {"queue_wait": {"count": 200, "sum": 30.0,
                               "buckets": {"10": 100, "16": 100}}}
        ok = evaluate_slo(
            [mk_sample(1), mk_sample(2, hist=fast)], objs,
            short_samples=4, long_samples=16,
        )["objectives"]["latency_queue_wait"]
        assert not ok["breach"] and ok["classification"] == "ok"
        bad = evaluate_slo(
            [mk_sample(1), mk_sample(2, hist=slow)], objs,
            short_samples=4, long_samples=16,
        )["objectives"]["latency_queue_wait"]
        assert bad["breach"]
        assert bad["p99_s"] and bad["p99_s"] > 0.008

    def test_throughput_floor_counts_only_active_intervals(self):
        objs = parse_objectives("floor_mibps=1")
        # idle ring: no verdict ops -> never burns
        idle = [mk_sample(t) for t in range(1, 6)]
        obj = evaluate_slo(idle, objs, short_samples=4, long_samples=16)[
            "objectives"]["throughput"]
        assert not obj["breach"] and obj["events"] == 0
        # active but slow: 100 B/s << 1 MiB/s floor on every interval
        slow = [mk_sample(t, verdict_bytes=100 * t, verdict_ops=t)
                for t in range(1, 6)]
        obj = evaluate_slo(slow, objs, short_samples=4, long_samples=16)[
            "objectives"]["throughput"]
        assert obj["breach"] and obj["events"] == 4

    def test_hostile_samples_never_crash(self):
        hostile = [
            {"t": float("nan"), "sched": "zap", "stages": 7},
            {"t": "later", "hist": {"queue_wait": {"buckets": {"x": "y"}}}},
            {},
            {"t": -5, "integrity": None},
        ]
        rep = evaluate_slo(hostile, default_objectives())
        assert set(rep["objectives"]) == {"availability", "integrity"}

    def test_latency_overflow_bucket_reports_no_infinity(self):
        """Observations past the top log2 bound land in the overflow
        bucket; the report must carry p99_s=None + p99_overflow=True,
        never float('inf') — json.dumps would emit the non-RFC token
        `Infinity` and break strict /v1/slo parsers exactly when
        latency is pathological."""
        objs = parse_objectives("p99_ms=8:queue_wait")
        from torrent_tpu_torch.obs.hist import BUCKET_BOUNDS

        overflow_idx = str(len(BUCKET_BOUNDS))
        hist = {"queue_wait": {"count": 100, "sum": 9000.0,
                               "buckets": {overflow_idx: 100}}}
        rep = evaluate_slo(
            [mk_sample(1), mk_sample(2, hist=hist)], objs,
            short_samples=4, long_samples=16,
        )
        obj = rep["objectives"]["latency_queue_wait"]
        assert obj["p99_s"] is None and obj["p99_overflow"]
        assert obj["breach"]
        # the whole report round-trips through strict JSON
        assert "Infinity" not in json.dumps(rep)

    def test_latency_evaluation_total_on_hostile_bucket_keys(self):
        """Non-canonical bucket keys ('07', ' 7', negatives) in a
        hand-edited/corrupt dump must not crash the latency evaluator
        (the replay CLI feeds arbitrary JSON straight through it)."""
        objs = parse_objectives("p99_ms=50:queue_wait")
        hist = {"queue_wait": {"count": 10, "sum": 1.0,
                               "buckets": {"07": 4, " 7": 2, "-3": 1,
                                           "x": 1, "16": 2}}}
        rep = evaluate_slo(
            [mk_sample(1), mk_sample(2, hist=hist)], objs,
            short_samples=4, long_samples=16,
        )
        obj = rep["objectives"]["latency_queue_wait"]
        assert obj["classification"] in ("ok", "slow_burn", "fast_burn")
        assert obj["p99_s"] is None or obj["p99_s"] > 0

    def test_spec_parse_errors(self):
        with pytest.raises(ValueError):
            parse_objectives("availability=1.5")
        with pytest.raises(ValueError):
            parse_objectives("frobnicate=1")
        with pytest.raises(ValueError):
            parse_objectives("")
        # a typo'd latency family would arm an objective that can never
        # observe data (green forever); nonpositive targets likewise
        with pytest.raises(ValueError):
            parse_objectives("p99_ms=50:requests")
        with pytest.raises(ValueError):
            parse_objectives("p99_ms=0")
        with pytest.raises(ValueError):
            parse_objectives("floor_mibps=0")
        # a duplicate name would collapse last-wins in the report —
        # the earlier target declared but never checked
        with pytest.raises(ValueError):
            parse_objectives("availability=0.999;availability=0.99")
        with pytest.raises(ValueError):
            parse_objectives("p99_ms=50:launch;p99_ms=10:launch")
        objs = parse_objectives(
            "availability=0.99;p99_ms=50:launch;floor_mibps=2;integrity=on"
        )
        assert [o.kind for o in objs] == [
            "availability", "latency", "throughput", "integrity"
        ]

    def test_digest_summary_shape(self):
        rep = evaluate_slo(
            [mk_sample(1, pieces=10), mk_sample(2, pieces=10, failed=10)],
            default_objectives(), short_samples=4, long_samples=16,
        )
        d = digest_summary(rep)
        assert d["breach"] == 1 and d["objective"] == "availability"
        assert d["burn"] > 0
        assert digest_summary(None) is None
        assert digest_summary({"worst": None}) is None


class TestSloEngine:
    def _dumps(self):
        from torrent_tpu_torch.obs.recorder import flight_recorder

        return flight_recorder().counts().get("slo_breach", 0)

    def test_exactly_one_dump_per_breach_transition(self):
        eng = SloEngine("availability=0.99", short_samples=4, long_samples=16)
        base = self._dumps()
        ring = [mk_sample(1, pieces=10)]
        eng.observe({"samples": list(ring)})
        assert self._dumps() == base  # no breach yet
        ring.append(mk_sample(2, pieces=10, failed=10))
        eng.observe({"samples": list(ring)})
        assert self._dumps() == base + 1
        # still breaching: no second dump
        ring.append(mk_sample(3, pieces=10, failed=10))
        eng.observe({"samples": list(ring)})
        assert self._dumps() == base + 1
        # recovery clears, then a NEW burst transitions again -> 2nd dump
        for i in range(4, 9):
            ring.append(mk_sample(i, pieces=10 * i, failed=10))
        eng.observe({"samples": list(ring)})
        assert self._dumps() == base + 1
        assert not eng.report()["objectives"]["availability"]["breach"]
        ring.append(mk_sample(9, pieces=90, failed=100))
        eng.observe({"samples": list(ring)})
        assert self._dumps() == base + 2

    def test_simultaneous_breaches_coalesce_into_one_dump(self):
        from torrent_tpu_torch.obs.recorder import flight_recorder

        eng = SloEngine("availability=0.99;integrity=on",
                        short_samples=4, long_samples=16)
        base = self._dumps()
        eng.observe({"samples": [mk_sample(1, pieces=10)]})
        eng.observe({"samples": [mk_sample(1, pieces=10),
                                 mk_sample(2, pieces=10, failed=10,
                                           breaker_opens=1)]})
        assert self._dumps() == base + 1
        dump = flight_recorder().dumps()[-1]
        assert dump["reason"] == "slo_breach"
        assert sorted(dump["detail"]["objectives"]) == [
            "availability", "integrity"
        ]


class TestArmedSlot:
    def test_disarm_only_releases_its_own_engine(self):
        """Server A shutting down must not clear server B's armed
        engine: the slot survives unless the disarming engine still
        owns it (force-clear with no argument stays for tests)."""
        from torrent_tpu_torch.obs import slo as _slo

        a = SloEngine("availability=0.99")
        b = SloEngine("availability=0.9")
        _slo.arm(a)
        _slo.arm(b)  # B took over the slot
        _slo.disarm(a)  # A's shutdown: must NOT clobber B
        assert _slo.armed() is b
        _slo.disarm(b)
        assert _slo.armed() is None
        _slo.arm(a)
        _slo.disarm()  # argless force-clear
        assert _slo.armed() is None


class TestTimelineStats:
    def test_tail_snapshot_bounds_the_copy_to_the_window(self):
        tl = Timeline(depth=16)
        for i in range(10):
            tl.push(mk_sample(i))
        tail = tl.tail_snapshot(4)
        assert len(tail["samples"]) == 4
        assert [s["seq"] for s in tail["samples"]] == [7, 8, 9, 10]
        assert tail["seq"] == 10 and tail["drops"] == 0
        # shorter rings come back whole
        assert len(tl.tail_snapshot(64)["samples"]) == 10
        # a sampler armed with a tail hands the hook the bounded view
        seen = []
        sampler = TimelineSampler(tl, on_sample=lambda s: seen.append(
            len(s["samples"])), on_sample_tail=4)
        sampler.sample_once()
        assert seen == [4]

    def test_stats_matches_snapshot_counters_without_samples(self):
        tl = Timeline(depth=4)
        for i in range(6):
            tl.push(mk_sample(i))
        stats = tl.stats()
        snap = tl.snapshot()
        assert stats == {"v": 1, "depth": 4, "seq": 6, "drops": 2, "fill": 4}
        assert "samples" not in stats
        assert stats["fill"] == len(snap["samples"])
        from torrent_tpu_torch.utils.metrics import render_timeline_metrics

        text = render_timeline_metrics(stats)
        assert "torrent_tpu_timeline_ring_fill 4" in text
        assert "torrent_tpu_timeline_samples_total 6" in text


class TestHealth:
    def test_ready_when_everything_resolves(self):
        h = build_health(probe_ok=True, breakers={}, sampler_alive=True)
        assert h == {"live": True, "ready": True, "status": "ready",
                     "reasons": [], "slo_breaches": []}

    def test_unready_reasons(self):
        h = build_health(probe_ok=False)
        assert h["status"] == "unready" and "backend probe unresolved" in h["reasons"]
        h = build_health(sampler_alive=False)
        assert "timeline sampler dead" in h["reasons"]
        h = build_health(pump_age_s=100.0, pump_max_age_s=30.0)
        assert any("pump stalled" in r for r in h["reasons"])

    def test_breaker_stuck_open_vs_transiently_open(self):
        fresh = {"l": {"state": "open", "open_age_s": 5.0, "cooldown": 30.0}}
        stuck = {"l": {"state": "open", "open_age_s": 90.0, "cooldown": 30.0}}
        assert build_health(breakers=fresh)["ready"]  # within cooldown
        h = build_health(breakers=stuck)
        assert h["status"] == "unready"
        assert any("stuck open" in r for r in h["reasons"])
        closed = {"l": {"state": "closed", "cooldown": 30.0}}
        assert build_health(breakers=closed)["ready"]

    def test_slo_breach_degrades_but_stays_live(self):
        report = {"objectives": {"availability": {"breach": True},
                                 "integrity": {"breach": False}}}
        h = build_health(probe_ok=True, slo_report=report)
        assert h["live"] and not h["ready"]
        assert h["status"] == "degraded"
        assert h["slo_breaches"] == ["availability"]


# ----------------------------------------------------------------- bridge


async def _http(port: int, method: str, path: str, body: bytes = b""):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
        f"Content-Length: {len(body)}\r\n\r\n".encode() + body
    )
    await writer.drain()
    status_line = await reader.readline()
    clen = 0
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b""):
            break
        if line.lower().startswith(b"content-length:"):
            clen = int(line.split(b":", 1)[1])
    payload = await reader.readexactly(clen)
    writer.close()
    return int(status_line.split()[1]), payload


class TestBridgeRoutes:
    def test_unarmed_bridge_serves_detached_routes_and_ready_health(self):
        from torrent_tpu_torch.bridge.service import BridgeServer

        async def go():
            svc = await BridgeServer("127.0.0.1", port=0, hasher="cpu").start()
            try:
                await svc._probe_task
                # zero overhead when off: nothing constructed
                assert svc.timeline is None and svc.slo_engine is None
                assert svc.sampler is None
                status, body = await _http(svc.port, "GET", "/v1/timeline")
                assert status == 200 and not json.loads(body)["attached"]
                status, body = await _http(svc.port, "GET", "/v1/slo")
                assert status == 200 and not json.loads(body)["attached"]
                status, body = await _http(svc.port, "GET", "/v1/health")
                health = json.loads(body)
                assert status == 200 and health["status"] == "ready"
                # no timeline/slo series pollute the unarmed scrape
                status, body = await _http(svc.port, "GET", "/metrics")
                assert b"torrent_tpu_timeline_" not in body
                assert b"torrent_tpu_slo_" not in body
            finally:
                svc.close()
                await svc.wait_closed()

        run(go())

    def test_armed_bridge_serves_timeline_slo_health_and_metrics(self):
        from torrent_tpu_torch.bridge.service import BridgeServer
        from torrent_tpu_torch.codec.bencode import bencode

        async def go():
            svc = await BridgeServer(
                "127.0.0.1", port=0, hasher="cpu",
                slo="availability=0.999;integrity=on",
                timeline_interval_s=3600.0,
            ).start()
            try:
                await svc._probe_task
                body = bencode({b"pieces": [b"tl-piece"]})
                status, _ = await _http(svc.port, "POST", "/v1/digests", body)
                assert status == 200
                svc.sampler.sample_once()
                svc.sampler.sample_once()
                status, payload = await _http(svc.port, "GET", "/v1/timeline")
                tl = json.loads(payload)
                assert tl["attached"] and len(tl["samples"]) == 2
                assert tl["sampler_alive"]
                status, payload = await _http(svc.port, "GET", "/v1/slo")
                slo = json.loads(payload)
                assert slo["attached"]
                assert set(slo["report"]["objectives"]) == {
                    "availability", "integrity"
                }
                assert not slo["report"]["breach_any"]
                status, payload = await _http(svc.port, "GET", "/v1/health")
                assert status == 200 and json.loads(payload)["ready"]
                status, payload = await _http(svc.port, "GET", "/metrics")
                text = payload.decode()
                assert "torrent_tpu_timeline_samples_total 2" in text
                assert 'torrent_tpu_slo_breach{objective="availability"} 0' in text
                assert "torrent_tpu_timeline_sampler_alive 1" in text
            finally:
                svc.close()
                await svc.wait_closed()
            # disarmed on close: the global engine slot is free again
            from torrent_tpu_torch.obs import slo as _slo

            assert _slo.armed() is None

        run(go())


# ------------------------------------------------------- tracker + serve


class TestTrackerHealth:
    def test_sharded_tracker_serves_health(self):
        from torrent_tpu_torch.server.shard import run_sharded_tracker
        from torrent_tpu_torch.server.tracker import ServeOptions

        async def go():
            server, task = await run_sharded_tracker(
                ServeOptions(http_port=0, udp_port=None, host="127.0.0.1"),
                n_shards=2,
            )
            try:
                await asyncio.sleep(0.05)  # let the pump stamp a tick
                status, body = await _http(
                    server.http_port, "GET", "/v1/health"
                )
                health = json.loads(body)
                assert status == 200 and health["ready"]
                assert health["live"]
            finally:
                server.close()
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):
                    pass

        run(go())

    def test_serve_recipe_wires_everything(self):
        """The deployment recipe: one call starts the sharded tracker +
        DHT indexer + health + metrics (+ timeline/SLO when armed);
        /v1/health answers ready, /metrics carries tracker AND slo
        series, and an announce round-trips through the plane."""
        import hashlib as _hashlib

        from torrent_tpu_torch.tools.serve import start_service

        async def go():
            handle = await start_service(
                http_port=0, udp_port=None, host="127.0.0.1",
                shards=2, dht_port=0, crawl_interval=3600.0,
                slo=True, timeline_interval_s=3600.0,
            )
            try:
                assert handle.dht is not None and handle.indexer is not None
                assert handle.slo_engine is not None
                ih = _hashlib.sha1(b"serve-swarm").digest()
                handle.store.announce(ih, b"p" * 20, "10.0.0.1", 6881, left=0)
                handle.sampler.sample_once()
                await asyncio.sleep(0.05)
                status, body = await _http(handle.http_port, "GET", "/v1/health")
                health = json.loads(body)
                assert status == 200 and health["ready"], health
                status, body = await _http(handle.http_port, "GET", "/metrics")
                text = body.decode()
                assert "torrent_tpu_tracker_peers 1" in text
                assert "torrent_tpu_slo_budget_remaining" in text
                assert "torrent_tpu_timeline_samples_total 1" in text
                # the sample carried tracker facts
                assert handle.timeline.samples()[-1]["tracker"]["peers"] == 1
            finally:
                await handle.close()
            from torrent_tpu_torch.obs import slo as _slo

            assert _slo.armed() is None

        run(go())


class TestFleetBudgetHealth:
    """The reference's class without its ``top --fleet`` rendering case,
    which waits for ``tools/top.py``."""

    def test_digest_carries_slo_and_rollup_surfaces_worst(self):
        from torrent_tpu_torch.obs import slo as _slo
        from torrent_tpu_torch.obs.fleet import aggregate_fleet, obs_digest

        eng = SloEngine("availability=0.99", short_samples=4, long_samples=16)
        eng.observe({"samples": [mk_sample(1, pieces=10),
                                 mk_sample(2, pieces=10, failed=10)]})
        _slo.arm(eng)
        try:
            digest = obs_digest()
            assert digest["slo"]["breach"] == 1
            assert digest["slo"]["burn"] > 0
        finally:
            _slo.disarm()
        # an unarmed digest carries no slo key (byte-identical to before)
        assert "slo" not in obs_digest()
        roll = aggregate_fleet({
            0: {"wall_s": 1.0, "stages": {}, "unit": {},
                "slo": {"burn": 2.0, "objective": "availability", "breach": 0}},
            1: {"wall_s": 1.0, "stages": {}, "unit": {},
                "slo": {"burn": 30.0, "objective": "integrity", "breach": 1}},
        })
        assert roll["slo"]["pid"] == 1
        assert roll["slo"]["worst_burn"] == 30.0
        assert roll["slo"]["breaching"] == 1

    def test_rollup_without_slo_has_none(self):
        from torrent_tpu_torch.obs.fleet import aggregate_fleet

        roll = aggregate_fleet({0: {"wall_s": 1.0, "stages": {}, "unit": {}}})
        assert roll["slo"] is None


# ----------------------------------------------------- acceptance scenario


class TestAcceptanceScenario:
    def test_fault_burst_breach_dump_health_and_breaker_recovery(self):
        """The end-to-end SLO scenario, deterministic on CPU: injected
        transient device failures trip the lane breaker (an integrity
        event + CPU degradation), the engine classifies a fast burn and
        breaches, /v1/health flips ready→degraded, exactly one
        slo_breach dump fires — and after the breaker's half-open probe
        restores the device plane, clean samples clear the breach and
        readiness returns."""
        from torrent_tpu_torch.bridge.service import BridgeServer
        from torrent_tpu_torch.codec.bencode import bencode
        from torrent_tpu_torch.obs.recorder import flight_recorder
        from torrent_tpu_torch.sched import FaultPlan

        async def go():
            svc = await BridgeServer(
                "127.0.0.1", port=0, hasher="cpu",
                # exactly enough consecutive transient failures to
                # cross the default breaker threshold (launch + retry +
                # first bisected half); launch 4 — the half-open probe —
                # lands past the window and succeeds
                fault_plan=FaultPlan(fail_first=3),
                slo="availability=0.999;integrity=on",
                timeline_interval_s=3600.0,
                slo_short_samples=3, slo_long_samples=64,
            ).start()
            try:
                await svc._probe_task
                base = flight_recorder().counts().get("slo_breach", 0)
                svc.sampler.sample_once()
                # fixed width: burst and recovery must land in the SAME
                # (algo, piece-bucket) lane — its fault plane and
                # breaker — not open a fresh lane per size
                pieces = [(b"acc-%d" % i).ljust(8, b"x") for i in range(4)]
                body = bencode({b"pieces": pieces})
                # consecutive transient failures trip the breaker; the
                # CPU fallback still serves correct digests (200)
                status, payload = await _http(
                    svc.port, "POST", "/v1/digests", body
                )
                assert status == 200
                from torrent_tpu_torch.codec.bencode import bdecode

                got = bdecode(payload)[b"digests"]
                assert got == [hashlib.sha1(p).digest() for p in pieces]
                snap = svc.sched.metrics_snapshot()
                lane = next(iter(snap["breakers"].values()))
                assert lane["state"] == "open", lane
                svc.sampler.sample_once()

                # breach: the breaker-open transition is an integrity
                # event -> instant fast burn
                status, payload = await _http(svc.port, "GET", "/v1/slo")
                rep = json.loads(payload)["report"]
                integ = rep["objectives"]["integrity"]
                assert integ["breach"], integ
                assert integ["classification"] == "fast_burn"
                assert integ["budget_remaining"] == 0.0
                status, payload = await _http(svc.port, "GET", "/v1/health")
                health = json.loads(payload)
                assert status == 503 and health["status"] == "degraded"
                assert "integrity" in health["slo_breaches"]
                dumps = flight_recorder().counts().get("slo_breach", 0) - base
                assert dumps == 1, f"exactly one slo_breach dump, got {dumps}"

                # recovery: expire the cooldown -> the next launch is
                # the half-open probe (fault window over, it succeeds)
                for lane_obj in svc.sched._lanes.values():
                    with lane_obj.breaker.lock:
                        lane_obj.breaker.opened_at -= 1e6
                more = bencode(
                    {b"pieces": [(b"rec-%d" % i).ljust(8, b"x")
                                 for i in range(4)]}
                )
                status, _ = await _http(svc.port, "POST", "/v1/digests", more)
                assert status == 200
                snap = svc.sched.metrics_snapshot()
                lane = next(iter(snap["breakers"].values()))
                assert lane["state"] == "closed", lane
                # clean samples age the event out of the short window
                for _ in range(4):
                    svc.sampler.sample_once()
                status, payload = await _http(svc.port, "GET", "/v1/slo")
                rep = json.loads(payload)["report"]
                assert not rep["objectives"]["integrity"]["breach"]
                status, payload = await _http(svc.port, "GET", "/v1/health")
                assert status == 200 and json.loads(payload)["ready"]
                dumps = flight_recorder().counts().get("slo_breach", 0) - base
                assert dumps == 1, "recovery must not re-dump"
            finally:
                svc.close()
                await svc.wait_closed()

        run(go())

    def test_replay_names_same_limiting_stage_as_live_attributor(self, tmp_path):
        """An h2d-throttled scheduler run bracketed by timeline samples:
        the live attributor and the offline replay over the dumped file
        must name the same limiting stage."""
        from torrent_tpu_torch.obs.attrib import attribute
        from torrent_tpu_torch.obs.ledger import pipeline_ledger
        from torrent_tpu_torch.sched import FaultPlan, HashPlaneScheduler, SchedulerConfig

        async def go():
            plan = FaultPlan.parse("latency_ms=25")
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=8, flush_deadline=0.02,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            await sched.start()
            tl = Timeline(depth=32)
            sampler = TimelineSampler(tl, scheduler=sched,
                                      dump_dir=str(tmp_path))
            led = pipeline_ledger()
            base = led.snapshot()
            try:
                sampler.sample_once()
                pieces = [bytes([i % 251]) * 1024 for i in range(64)]
                want = [hashlib.sha1(p).digest() for p in pieces]
                for _ in range(2):
                    assert await sched.submit("replay", pieces) == want
                    sampler.sample_once()
            finally:
                await sched.close()
            live = attribute(led.snapshot(), prev=base)
            assert live["bottleneck"]["stage"] == "h2d", live["bottleneck"]
            path = sampler.dump()
            with open(path) as f:
                payload = json.load(f)
            rep = replay_report(payload)
            assert rep["overall"]["bottleneck"]["stage"] == "h2d"
            assert any(i["limiting"] == "h2d" for i in rep["intervals"])

        run(go())


# ------------------------------------------------------------------ swarm


class _Clock:
    """Injectable monotonic clock for duration-accounting tests."""

    def __init__(self, t0: float = 1000.0):
        self.t = t0

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    import torrent_tpu_torch.obs.swarm as swarm_mod

    monkeypatch.setattr(swarm_mod.time, "monotonic", c)
    return c


class TestRegistry:
    def test_message_and_byte_accounting(self):
        reg = SwarmTelemetry()
        reg.peer_connected("a@1.1.1.1:1")
        reg.on_message("a@1.1.1.1:1", "Piece", 16384)
        reg.on_message("a@1.1.1.1:1", "Piece", 16384)
        reg.on_message("a@1.1.1.1:1", "Have", 0)
        reg.on_message("a@1.1.1.1:1", "TotallyNewMessage", 7)
        snap = reg.snapshot()
        p = snap["peers"]["a@1.1.1.1:1"]
        assert p["msgs"]["Piece"] == {"count": 2, "bytes": 32768}
        assert p["msgs"]["Have"]["count"] == 1
        # unknown kinds fold — bounded cardinality no matter the wire
        assert "TotallyNewMessage" not in p["msgs"]
        assert p["msgs"]["other"] == {"count": 1, "bytes": 7}
        assert snap["msgs"]["Piece"]["bytes"] == 32768

    def test_choke_timeline_durations(self, clock):
        reg = SwarmTelemetry()
        reg.peer_connected("a@1.1.1.1:1")
        clock.t += 10.0  # choked (spec default) for 10 s
        reg.on_state("a@1.1.1.1:1", peer_choking=False)
        clock.t += 4.0  # unchoked for 4 s
        reg.on_state("a@1.1.1.1:1", peer_choking=True, am_interested=True)
        clock.t += 1.0
        p = reg.snapshot()["peers"]["a@1.1.1.1:1"]
        tl = p["choke_timeline"]
        # 10 s initial choke + the open 1 s interval; the 4 s unchoked
        # gap does not count toward peer_choking's True-time
        assert tl["peer_choking"] == pytest.approx(11.0)
        assert tl["am_interested"] == pytest.approx(1.0)
        assert tl["transitions"] == 3
        assert p["state"] == {
            "am_choking": True, "am_interested": True,
            "peer_choking": True, "peer_interested": False,
        }
        # no-op values are not transitions
        reg.on_state("a@1.1.1.1:1", peer_choking=True)
        assert (
            reg.snapshot()["peers"]["a@1.1.1.1:1"]["choke_timeline"][
                "transitions"
            ]
            == 3
        )

    def test_rtt_depth_and_snub_redemption(self):
        reg = SwarmTelemetry()
        reg.peer_connected("a@1.1.1.1:1")
        reg.on_depth("a@1.1.1.1:1", 16)
        reg.on_depth("a@1.1.1.1:1", 4)
        reg.on_snub("a@1.1.1.1:1")
        snap = reg.snapshot()["peers"]["a@1.1.1.1:1"]
        assert snap["pipeline"] == {"depth": 4, "depth_max": 16}
        assert snap["snubbed"] and snap["snubs"] == 1
        for rtt in (0.001, 0.002, 0.004, 1.0):
            reg.on_block("a@1.1.1.1:1", 16384, rtt)
        snap = reg.snapshot()["peers"]["a@1.1.1.1:1"]
        assert not snap["snubbed"]  # delivering redeems
        assert snap["block_rtt"]["count"] == 4
        assert snap["block_rtt"]["p50_s"] is not None
        assert snap["block_rtt"]["p99_s"] >= 1.0
        assert not snap["block_rtt"]["p99_overflow"]

    def test_totals_survive_peer_drop(self):
        reg = SwarmTelemetry()
        reg.peer_connected("a@1.1.1.1:1")
        reg.on_block("a@1.1.1.1:1", 1000, 0.01)
        reg.on_upload("a@1.1.1.1:1", 500)
        reg.peer_dropped("a@1.1.1.1:1")
        snap = reg.snapshot()
        assert snap["counts"]["connected"] == 0
        # cumulative process totals never drop when a peer leaves — the
        # SLO window deltas depend on it
        assert snap["totals"]["bytes_down"] == 1000
        assert snap["totals"]["bytes_up"] == 500
        assert snap["totals"]["blocks"] == 1
        assert snap["totals"]["connections"] == 1

    def test_tracked_peer_bound_overflow_record(self):
        from test_metrics import prom_lint
        from torrent_tpu_torch.utils.metrics import render_swarm_metrics

        reg = SwarmTelemetry(max_peers=4)
        for i in range(7):
            reg.peer_connected(f"p{i}@1.1.1.{i}:1")
            # the FOLDED peers carry the most bytes: even then the
            # shared overflow record must never rank into the named
            # top-K (that would emit peer="overflow" twice on /metrics)
            reg.on_block(f"p{i}@1.1.1.{i}:1", 100 * (7 - i), 0.001)
        snap = reg.snapshot()
        # every connection counted: 4 tracked + 3 sharing the overflow
        assert snap["counts"]["connected"] == 7
        assert snap["totals"]["connections"] == 7
        assert snap["totals"]["bytes_down"] == 100 * (7 + 6 + 5 + 4 + 3 + 2 + 1)
        assert "overflow" not in snap["peers"]
        assert snap["overflow"]["peers"] == 3
        prom_lint(render_swarm_metrics(snap))  # no duplicate series
        # folded peers leaving drain the shared record; the last one
        # removes it — the connected gauge never inflates forever
        for i in range(7):
            reg.peer_dropped(f"p{i}@1.1.1.{i}:1")
        snap = reg.snapshot()
        assert snap["counts"]["connected"] == 0
        assert snap["overflow"] is None
        assert snap["totals"]["bytes_down"] == 2800  # totals stay cumulative
        assert MAX_TRACKED_PEERS >= 4  # the default bound exists

    def test_snapshot_deterministic_bytes(self):
        raws = {
            f"p{i}": {
                "bytes_down": i * 100, "blocks": i, "rtt_counts": [i, 0, 2],
                "rtt_count": i + 2, "rtt_sum": 0.5, "state": {"peer_choking": True},
                "flag_true_s": {"peer_choking": 1.5},
            }
            for i in range(TOP_PEERS + 3)
        }
        totals = {"blocks": 9, "connections": 11}
        a = json.dumps(build_swarm_snapshot(raws, totals), sort_keys=True)
        b = json.dumps(build_swarm_snapshot(dict(reversed(raws.items())), totals),
                       sort_keys=True)
        assert a == b  # input dict order never reaches the bytes


class TestTriggers:
    def test_snub_storm_exactly_once_and_rearm(self):
        reg = SwarmTelemetry()
        base = flight_recorder().counts().get("snub_storm", 0)
        for i in range(4):
            reg.peer_connected(f"p{i}@2.2.2.{i}:1")
        reg.on_snub("p0@2.2.2.0:1")
        assert flight_recorder().counts().get("snub_storm", 0) == base  # 1/4 < half
        reg.on_snub("p1@2.2.2.1:1")
        assert flight_recorder().counts().get("snub_storm", 0) == base + 1
        reg.on_snub("p2@2.2.2.2:1")  # storm holds: no re-fire
        assert flight_recorder().counts().get("snub_storm", 0) == base + 1
        # delivery clears two snub flags -> storm clears -> re-snub fires
        reg.on_block("p0@2.2.2.0:1", 1, 0.001)
        reg.on_block("p1@2.2.2.1:1", 1, 0.001)
        reg.on_block("p2@2.2.2.2:1", 1, 0.001)
        reg.on_snub("p0@2.2.2.0:1")
        reg.on_snub("p1@2.2.2.1:1")
        assert flight_recorder().counts().get("snub_storm", 0) == base + 2
        assert reg.snapshot()["triggers"]["snub_storm"] == 2

    def test_all_peers_choked_gated_on_transfer(self):
        reg = SwarmTelemetry()
        base = flight_recorder().counts().get("all_peers_choked", 0)
        reg.peer_connected("a@3.3.3.1:1")
        reg.peer_connected("b@3.3.3.2:1")
        # startup: everything choked by spec default + we get interested
        # — must NOT fire (no transfer was underway)
        reg.on_state("a@3.3.3.1:1", am_interested=True)
        assert flight_recorder().counts().get("all_peers_choked", 0) == base
        # blocks flow, then the swarm chokes us → fires once
        reg.on_state("a@3.3.3.1:1", peer_choking=False)
        reg.on_block("a@3.3.3.1:1", 1, 0.001)
        reg.on_state("a@3.3.3.1:1", peer_choking=True)
        assert flight_recorder().counts().get("all_peers_choked", 0) == base + 1
        reg.on_state("b@3.3.3.2:1", peer_interested=True)  # still all-choked
        assert flight_recorder().counts().get("all_peers_choked", 0) == base + 1

    def test_announce_streaks_are_per_origin(self):
        """One torrent's healthy tracker must never mask another's dead
        one: streaks key on the announcing torrent's origin."""
        reg = SwarmTelemetry()
        base = flight_recorder().counts().get("announce_failure_streak", 0)
        for i in range(ANNOUNCE_STREAK):
            reg.on_announce(False, origin="swarm-dead")
            # torrent B's interleaved successes must not reset A's streak
            reg.on_announce(True, origin="swarm-healthy")
        assert (
            flight_recorder().counts().get("announce_failure_streak", 0)
            == base + 1
        )
        assert reg.snapshot()["totals"]["announce_streak"] == ANNOUNCE_STREAK

    def test_announce_failure_streak_exactly_once(self):
        reg = SwarmTelemetry()
        base = flight_recorder().counts().get("announce_failure_streak", 0)
        for _ in range(ANNOUNCE_STREAK - 1):
            reg.on_announce(False)
        assert (
            flight_recorder().counts().get("announce_failure_streak", 0) == base
        )
        reg.on_announce(False)  # crosses the streak
        assert (
            flight_recorder().counts().get("announce_failure_streak", 0)
            == base + 1
        )
        reg.on_announce(False)  # deeper into the same streak: no re-fire
        assert (
            flight_recorder().counts().get("announce_failure_streak", 0)
            == base + 1
        )
        reg.on_announce(True)  # re-arms
        for _ in range(ANNOUNCE_STREAK):
            reg.on_announce(False)
        assert (
            flight_recorder().counts().get("announce_failure_streak", 0)
            == base + 2
        )
        totals = reg.snapshot()["totals"]
        assert totals["announce_ok"] == 1
        assert totals["announce_failed"] == 2 * ANNOUNCE_STREAK + 1




class TestSwarmSlo:
    def _samples(self, rows):
        return [
            {"t": float(t), "swarm": dict(sw)} for t, sw in rows
        ]

    def test_snub_ratio_burns_and_clears(self):
        from torrent_tpu_torch.obs.slo import evaluate_slo, parse_objectives

        objs = parse_objectives("swarm_snub=0.99")
        # 8 snubs against 2 blocks: error ratio 0.8 >> the 0.01 budget
        bad = self._samples([
            (1.0, {"snubs": 0, "blocks": 0}),
            (2.0, {"snubs": 8, "blocks": 2}),
        ])
        rep = evaluate_slo(bad, objs, short_samples=4, long_samples=8)
        obj = rep["objectives"]["swarm_availability"]
        assert obj["breach"] and obj["classification"] == "fast_burn"
        # a clean swarm never burns
        good = self._samples([
            (1.0, {"snubs": 0, "blocks": 0}),
            (2.0, {"snubs": 0, "blocks": 500}),
        ])
        rep = evaluate_slo(good, objs, short_samples=4, long_samples=8)
        assert rep["objectives"]["swarm_availability"]["burn_rate"] == 0.0

    def test_download_floor_burns_only_active_intervals(self):
        from torrent_tpu_torch.obs.slo import evaluate_slo, parse_objectives

        objs = parse_objectives("swarm_floor_mibps=1")
        samples = self._samples([
            (1.0, {"bytes_down": 0, "blocks": 0}),
            # active interval at 100 KiB/s — under the 1 MiB/s floor
            (2.0, {"bytes_down": 100 * 1024, "blocks": 10}),
            # idle interval (no blocks moved): never burns
            (3.0, {"bytes_down": 100 * 1024, "blocks": 10}),
        ])
        rep = evaluate_slo(samples, objs, short_samples=4, long_samples=8)
        obj = rep["objectives"]["swarm_throughput"]
        assert obj["errors"] == 1 and obj["events"] == 1
        assert obj["burn_rate"] > 1.0
        fast = self._samples([
            (1.0, {"bytes_down": 0, "blocks": 0}),
            (2.0, {"bytes_down": 8 << 20, "blocks": 100}),
        ])
        rep = evaluate_slo(fast, objs, short_samples=4, long_samples=8)
        assert rep["objectives"]["swarm_throughput"]["burn_rate"] == 0.0

    def test_sample_now_carries_swarm_once_active(self):
        from torrent_tpu_torch.obs.timeline import sample_now

        reg = swarm_telemetry()
        if not reg.active():
            reg.peer_connected("slo@9.9.9.9:1")
            reg.on_block("slo@9.9.9.9:1", 64, 0.001)
            reg.peer_dropped("slo@9.9.9.9:1")
        sample = sample_now()
        assert "swarm" in sample
        assert sample["swarm"]["blocks"] >= 1
        assert set(sample["swarm"]) >= {
            "peers", "snubbed", "bytes_down", "blocks", "snubs", "all_choked",
        }



# ---------------------------------------------------------------- renderers


class TestRenderers:
    """The timeline, SLO, swarm and serve renderers, as the reference's
    tests/test_metrics.py holds them: fresh, partial and full snapshots
    render, and every output passes the format lint."""

    def test_timeline_renderer_fresh_partial_and_full(self):
        """The timeline series render from a fresh ring, a partial
        hand-rolled snapshot, and a live ring with a sampler flag —
        never a crash mid-scrape."""
        from torrent_tpu_torch.obs.timeline import Timeline
        from torrent_tpu_torch.utils.metrics import render_timeline_metrics

        prom_lint(render_timeline_metrics({}))
        prom_lint(render_timeline_metrics(None))
        text = render_timeline_metrics({"seq": 9, "drops": 2})
        prom_lint(text)
        assert "torrent_tpu_timeline_samples_total 9" in text
        assert "torrent_tpu_timeline_dropped_total 2" in text
        assert "torrent_tpu_timeline_sampler_alive" not in text  # no key
        tl = Timeline(depth=4)
        tl.push({"t": 1.0})
        snap = tl.snapshot()
        snap["sampler_alive"] = True
        text = render_timeline_metrics(snap)
        prom_lint(text)
        assert "torrent_tpu_timeline_ring_fill 1" in text
        assert "torrent_tpu_timeline_depth 4" in text
        assert "torrent_tpu_timeline_sampler_alive 1" in text

    def test_slo_renderer_none_partial_and_breaching(self):
        """The SLO series render from no report yet (engine armed but
        never observed), a partial objective dict, and a breaching
        report — per-objective budget/burn/breach families."""
        from torrent_tpu_torch.utils.metrics import render_slo_metrics

        prom_lint(render_slo_metrics(None))
        prom_lint(render_slo_metrics({}))
        text = render_slo_metrics({"objectives": {"availability": {}}})
        prom_lint(text)
        assert (
            'torrent_tpu_slo_budget_remaining{objective="availability"} 1.0'
            in text
        )
        report = {
            "objectives": {
                "availability": {
                    "budget_remaining": 0.25, "burn_rate": 20.0,
                    "burn_rate_long": 4.0, "breach": True,
                },
                "integrity": {
                    "budget_remaining": 1.0, "burn_rate": 0.0,
                    "burn_rate_long": 0.0, "breach": False,
                },
            }
        }
        text = render_slo_metrics(report)
        prom_lint(text)
        assert (
            'torrent_tpu_slo_burn_rate{objective="availability",window="short"} 20.0'
            in text
        )
        assert (
            'torrent_tpu_slo_burn_rate{objective="availability",window="long"} 4.0'
            in text
        )
        assert 'torrent_tpu_slo_breach{objective="availability"} 1' in text
        assert 'torrent_tpu_slo_breach{objective="integrity"} 0' in text

    def test_fleet_renderer_slo_budget_series(self):
        """A rollup carrying the fleet SLO summary renders the worst
        burn-rate series; one without it renders no slo series."""
        from torrent_tpu_torch.obs.fleet import local_fleet_snapshot
        from torrent_tpu_torch.utils.metrics import render_fleet_metrics

        roll = local_fleet_snapshot()
        roll["slo"] = {"pid": 1, "objective": "integrity",
                       "worst_burn": 30.5, "breaching": 1}
        text = render_fleet_metrics(roll)
        prom_lint(text)
        assert (
            'torrent_tpu_fleet_slo_worst_burn_rate{pid="1",objective="integrity"} 30.5'
            in text
        )
        assert "torrent_tpu_fleet_slo_breaching 1" in text
        assert "slo_worst_burn" not in render_fleet_metrics(
            local_fleet_snapshot()
        )

    def test_full_exposition_concatenation_lints(self):
        """What the bridge actually serves: sched + fabric + fleet +
        control + tracker + timeline + SLO + obs (incl. the pipeline
        ledger) in one payload must still have unique series and
        complete headers. The reference's case also renders its
        sanitizer families, which come with the analysis plane."""
        from torrent_tpu_torch.obs import render_obs_metrics
        from torrent_tpu_torch.obs.fleet import local_fleet_snapshot
        from torrent_tpu_torch.obs.ledger import pipeline_ledger
        from torrent_tpu_torch.sched import (
            ControlConfig,
            HashPlaneScheduler,
            SchedulerAutopilot,
            SchedulerConfig,
        )
        from torrent_tpu_torch.obs.slo import SloEngine
        from torrent_tpu_torch.obs.timeline import Timeline, TimelineSampler
        from torrent_tpu_torch.utils.metrics import (
            render_control_metrics,
            render_fabric_metrics,
            render_fleet_metrics,
            render_sched_metrics,
            render_slo_metrics,
            render_timeline_metrics,
            render_tracker_metrics,
        )
        from torrent_tpu_torch.server.shard import ShardedSwarmStore

        from torrent_tpu_torch.serve_plane.telemetry import serve_telemetry

        pipeline_ledger().record("read", 1024, 0.01)  # ledger series live
        # activate the serve plane so its families join the payload
        serve_telemetry().on_egress("concat@1.1.1.1:1", "sendfile", 16384)
        serve_telemetry().on_choke_round(
            0.002, unchoked=1, interested=1, optimistic=None, rotated=False
        )
        sched = HashPlaneScheduler(SchedulerConfig(), hasher="cpu")
        pilot = SchedulerAutopilot(sched, ControlConfig())
        store = ShardedSwarmStore(n_shards=2)
        store.announce(b"\x01" * 20, b"\x02" * 20, "1.1.1.1", 7001, left=0)
        timeline = Timeline(depth=4)
        engine = SloEngine("availability=0.999;integrity=on")
        sampler = TimelineSampler(timeline, scheduler=sched,
                                  on_sample=engine.observe)
        sampler.sample_once()
        tl_snap = timeline.snapshot()
        tl_snap["sampler_alive"] = False
        text = (
            render_sched_metrics(sched)
            + render_fabric_metrics({"pid": 0})
            + render_fleet_metrics(local_fleet_snapshot(sched))
            + render_control_metrics(pilot.metrics_snapshot())
            + render_tracker_metrics(store.metrics_snapshot())
            + render_timeline_metrics(tl_snap)
            + render_slo_metrics(engine.report())
            + render_obs_metrics()
        )
        prom_lint(text)
        assert "torrent_tpu_pipeline_stage_busy_seconds_total" in text
        assert "torrent_tpu_fleet_reporting 1" in text
        assert "torrent_tpu_control_enabled 1" in text
        assert "torrent_tpu_tracker_announces_total 1" in text
        # the swarm wire-plane families ride render_obs_metrics, so the
        # full bridge/MetricsServer payload carries both new families
        assert "torrent_tpu_swarm_peers " in text
        assert "torrent_tpu_peer_bytes_down_total" in text
        # the Byzantine audit/quorum families ride render_fabric_metrics
        # unconditionally (zeroed at f=0), so the concatenated payload
        # always carries them
        assert "torrent_tpu_fabric_audit_checks_total" in text
        assert "torrent_tpu_fabric_audit_mismatches_total" in text
        assert "torrent_tpu_fabric_quorum_convictions_total" in text
        assert "torrent_tpu_fabric_quorum_verifies_total" in text
        assert 'torrent_tpu_fabric_quorum_need{pid="0"} 1' in text
        # the seeder-plane families ride render_obs_metrics only once
        # the process has served (tracker-only scrapes stay lean): the
        # activation above came from the global registry poke
        assert "torrent_tpu_serve_peers" in text
        assert 'torrent_tpu_serve_bytes_total{path="sendfile"}' in text
        assert "torrent_tpu_serve_choke_round_seconds_bucket" in text

    def test_concat_omits_serve_until_active(self):
        """A process that never served renders NO torrent_tpu_serve_*
        series (checked on a private registry — the global one may have
        been activated by other tests in this session)."""
        from torrent_tpu_torch.serve_plane.telemetry import ServeTelemetry
        from torrent_tpu_torch.utils.metrics import render_serve_metrics

        reg = ServeTelemetry()
        assert not reg.active()
        # the render_obs_metrics gate: active() False → contributes ""
        text = render_serve_metrics(reg.snapshot())
        prom_lint(text)  # rendering a fresh one is still well-formed


class TestSwarmRenderer:
    """The swarm wire-plane renderer (obs/swarm → render_swarm_metrics):
    fresh registries, hostile/partial snapshots, and the bounded
    per-peer family's top-K + overflow contract."""

    def test_fresh_registry_renders_clean(self):
        from torrent_tpu_torch.obs.swarm import SwarmTelemetry
        from torrent_tpu_torch.utils.metrics import render_swarm_metrics

        text = render_swarm_metrics(SwarmTelemetry().snapshot())
        prom_lint(text)
        assert "torrent_tpu_swarm_peers 0" in text
        assert "torrent_tpu_swarm_connections_total 0" in text
        assert 'torrent_tpu_swarm_flight_triggers_total{reason="snub_storm"} 0' in text

    def test_partial_snapshot_tolerated(self):
        from torrent_tpu_torch.utils.metrics import render_swarm_metrics

        prom_lint(render_swarm_metrics({}))
        prom_lint(render_swarm_metrics(None))
        # hostile shapes: wrong-typed sub-dicts render as zeros
        text = render_swarm_metrics(
            {"counts": {"connected": 3}, "peers": {"x": {"bytes_down": 7}},
             "overflow": None, "totals": None, "msgs": {"Piece": "bogus"}}
        )
        prom_lint(text)
        assert "torrent_tpu_swarm_peers 3" in text
        assert 'torrent_tpu_peer_bytes_down_total{peer="x"} 7' in text

    def test_peer_overflow_fold(self):
        from torrent_tpu_torch.obs.swarm import SwarmTelemetry, TOP_PEERS
        from torrent_tpu_torch.utils.metrics import render_swarm_metrics

        reg = SwarmTelemetry()
        n = TOP_PEERS + 5
        for i in range(n):
            key = f"p{i:02d}@10.0.0.{i}:6881"
            reg.peer_connected(key)
            reg.on_block(key, (i + 1) * 1000, 0.002)
        snap = reg.snapshot()
        assert len(snap["peers"]) == TOP_PEERS
        assert snap["overflow"]["peers"] == n - TOP_PEERS
        # named peers are the TOP transferors; the fold keeps the rest's
        # bytes and RTT observations
        assert snap["overflow"]["bytes_down"] == sum(
            (i + 1) * 1000 for i in range(n - TOP_PEERS)
        )
        assert snap["overflow"]["block_rtt"]["count"] == n - TOP_PEERS
        text = render_swarm_metrics(snap)
        prom_lint(text)
        assert text.count("torrent_tpu_peer_bytes_down_total{") == TOP_PEERS + 1
        assert 'torrent_tpu_peer_bytes_down_total{peer="overflow"}' in text


class TestServeRenderer:
    """The seeder-plane renderer (serve_plane/telemetry →
    render_serve_metrics): fresh registries, hostile/partial snapshots,
    the fixed-label egress/reject families, the choke-round histogram,
    and the per-peer top-K + overflow contract."""

    def test_fresh_registry_renders_clean(self):
        from torrent_tpu_torch.serve_plane.telemetry import ServeTelemetry
        from torrent_tpu_torch.utils.metrics import render_serve_metrics

        text = render_serve_metrics(ServeTelemetry().snapshot())
        prom_lint(text)
        assert "torrent_tpu_serve_peers 0" in text
        # the fixed egress/reject label sets render even at zero, so
        # dashboards see the full fallback matrix from scrape one
        assert 'torrent_tpu_serve_bytes_total{path="sendfile"} 0' in text
        assert 'torrent_tpu_serve_blocks_total{path="preadv"} 0' in text
        assert 'torrent_tpu_serve_rejects_total{reason="per_ip"} 0' in text
        assert 'torrent_tpu_serve_rejects_total{reason="choked"} 0' in text
        assert "torrent_tpu_serve_choke_rounds_total 0" in text

    def test_partial_snapshot_tolerated(self):
        from torrent_tpu_torch.utils.metrics import render_serve_metrics

        prom_lint(render_serve_metrics({}))
        prom_lint(render_serve_metrics(None))
        # hostile shapes: wrong-typed sub-dicts render as zeros
        text = render_serve_metrics(
            {"counts": {"serving": 2}, "peers": {"x": {"bytes_up": 9}},
             "overflow": None, "paths": "bogus", "choke": None,
             "totals": {"blocks": "NaNsense"}}
        )
        prom_lint(text)
        assert "torrent_tpu_serve_peers 2" in text
        assert 'torrent_tpu_serve_peer_bytes_total{peer="x"} 9' in text

    def test_choke_round_histogram_lints(self):
        from torrent_tpu_torch.serve_plane.telemetry import ServeTelemetry
        from torrent_tpu_torch.utils.metrics import render_serve_metrics

        reg = ServeTelemetry()
        for d in (0.0005, 0.002, 0.03):
            reg.on_choke_round(d, unchoked=2, interested=5,
                               optimistic="o@1:1", rotated=True)
        text = render_serve_metrics(reg.snapshot())
        # prom_lint pins the _bucket/_sum/_count suffixes to a
        # histogram-typed family and the unique-series rule catches a
        # repeated le= bound
        prom_lint(text)
        assert "torrent_tpu_serve_choke_round_seconds_count 3" in text
        assert 'le="+Inf"} 3' in text
        assert "torrent_tpu_serve_unchoked 2" in text
        assert "torrent_tpu_serve_interested 5" in text
        assert "torrent_tpu_serve_optimistic_rotations_total 3" in text

    def test_peer_overflow_fold(self):
        from torrent_tpu_torch.serve_plane.telemetry import (
            TOP_PEERS,
            ServeTelemetry,
        )
        from torrent_tpu_torch.utils.metrics import render_serve_metrics

        reg = ServeTelemetry()
        n = TOP_PEERS + 4
        for i in range(n):
            key = f"s{i:02d}@10.0.0.{i}:6881"
            reg.peer_serving(key)
            reg.on_egress(key, "sendfile", (i + 1) * 1000)
        snap = reg.snapshot()
        assert len(snap["peers"]) == TOP_PEERS
        text = render_serve_metrics(snap)
        prom_lint(text)
        assert text.count("torrent_tpu_serve_peer_bytes_total{") == TOP_PEERS + 1
        assert 'torrent_tpu_serve_peer_bytes_total{peer="overflow"}' in text
        # the fold keeps the un-named peers' bytes: smallest uploaders
        assert f'peer="overflow"}} {sum((i + 1) * 1000 for i in range(4))}' in text


# ---------------------------------------------------------- differential


SPEC = (
    "availability=0.999;p99_ms=50:queue_wait;floor_mibps=1;integrity=on;"
    "swarm_floor_mibps=1;swarm_snub=0.99"
)
STAGES = ("read", "stage", "h2d", "launch", "digest", "verdict")


def _seeded_samples(seed: int, n: int = 12) -> list[dict]:
    """Cumulative-counter samples from numpy's seeded generator: ledger
    stages, scheduler counters, a queue-wait histogram, integrity and
    swarm counters, each non-decreasing from one sample to the next."""
    rng = np.random.default_rng(seed)
    out, acc = [], {}

    def bump(key, hi):
        acc[key] = acc.get(key, 0) + int(rng.integers(0, hi))
        return acc[key]

    for i in range(n):
        stages = {}
        for name in STAGES:
            ops = bump(name + ".ops", 40)
            if ops:
                stages[name] = {
                    "busy_s": round(ops * float(rng.uniform(0.001, 0.02)), 6),
                    "bytes": bump(name + ".bytes", 1 << 22),
                    "ops": ops,
                }
        buckets = {str(b): bump(f"qw{b}", 30) for b in (6, 9, 12, 15)}
        out.append({
            "v": 1,
            "t": float(i) * 0.5 + float(rng.uniform(0, 0.1)),
            "stages": stages,
            "overlap_s": 0.0,
            "sched": {"pieces": bump("pieces", 500), "shed": bump("shed", 3),
                      "failed_pieces": bump("failed", 2)},
            "hist": {"queue_wait": {"count": sum(buckets.values()),
                                    "sum": round(float(rng.uniform(0, 5)), 6),
                                    "buckets": buckets}},
            "integrity": {"breaker_opens": bump("opens", 2), "open_lanes": 0,
                          "races": 0, "distrust": 0},
            "swarm": {"peers": 3, "snubbed": 0, "bytes_down": bump("down", 1 << 20),
                      "blocks": bump("blocks", 64), "snubs": bump("snubs", 2),
                      "announce_failed": 0, "all_choked": 0},
        })
    return out


@pytest.fixture
def fresh_globals(monkeypatch):
    """Fresh process-global obs registries in both packages for one test,
    so what other test files in this worker recorded cannot differ
    between them; the old ones come back afterwards."""
    import torrent_tpu.obs.hist as ref_hist
    import torrent_tpu.obs.ledger as ref_ledger
    import torrent_tpu.obs.recorder as ref_recorder
    import torrent_tpu.obs.swarm as ref_swarm
    import torrent_tpu.serve_plane.telemetry as ref_serve
    import torrent_tpu_torch.obs.hist as hist
    import torrent_tpu_torch.obs.ledger as ledger
    import torrent_tpu_torch.obs.recorder as recorder
    import torrent_tpu_torch.obs.swarm as swarm
    import torrent_tpu_torch.serve_plane.telemetry as serve

    for mod, name in (
        (ref_hist, "_registry"), (hist, "_registry"),
        (ref_ledger, "_ledger"), (ledger, "_ledger"),
        (ref_recorder, "_recorder"), (recorder, "_recorder"),
        (ref_swarm, "_telemetry"), (swarm, "_telemetry"),
        (ref_serve, "_telemetry"), (serve, "_telemetry"),
    ):
        monkeypatch.setattr(mod, name, None)


class TestDifferential:
    """The copies against the reference on the same seeded inputs."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_carried_timeline_replays_and_evaluates_equally(self, seed):
        from torrent_tpu.obs import slo as ref_slo
        from torrent_tpu.obs import timeline as ref_timeline
        from torrent_tpu_torch.compat import timeline_from_reference

        ref_tl = ref_timeline.Timeline(depth=8)  # wraps: drops count too
        for sample in _seeded_samples(seed):
            ref_tl.push(sample)
        snap = ref_tl.snapshot()
        for dump in (snap, json.dumps(snap), json.dumps(snap).encode()):
            mine = timeline_from_reference(dump)
            assert mine == json.loads(json.dumps(snap))
            assert mine is not snap
            want = ref_timeline.replay_report(
                snap, objectives=ref_slo.parse_objectives(SPEC)
            )
            got = replay_report(mine, objectives=parse_objectives(SPEC))
            assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
            for short, long in ((3, 8), (4, 16)):
                assert evaluate_slo(
                    mine["samples"], parse_objectives(SPEC),
                    short_samples=short, long_samples=long,
                ) == ref_slo.evaluate_slo(
                    snap["samples"], ref_slo.parse_objectives(SPEC),
                    short_samples=short, long_samples=long,
                )

    def test_carried_live_timeline_names_the_same_stage(self, tmp_path):
        """A timeline the reference's own sampler recorded over its
        scheduler (an h2d-throttled hashlib plane) replays in the port to
        the reference's report, limiting stage included."""
        from torrent_tpu.obs import timeline as ref_timeline
        from torrent_tpu.sched import FaultPlan as RefFaultPlan
        from torrent_tpu.sched import HashPlaneScheduler as RefScheduler
        from torrent_tpu.sched import SchedulerConfig as RefConfig
        from torrent_tpu_torch.compat import timeline_from_reference

        async def go():
            plan = RefFaultPlan.parse("latency_ms=20")
            sched = RefScheduler(
                RefConfig(batch_target=8, flush_deadline=0.02,
                          plane_factory=plan.plane_factory(hasher="cpu")),
                hasher="cpu",
            )
            await sched.start()
            tl = ref_timeline.Timeline(depth=16)
            sampler = ref_timeline.TimelineSampler(
                tl, scheduler=sched, dump_dir=str(tmp_path)
            )
            try:
                sampler.sample_once()
                pieces = [bytes([i]) * 512 for i in range(32)]
                for _ in range(2):
                    await sched.submit("carry", pieces)
                    sampler.sample_once()
            finally:
                await sched.close()
            return sampler.dump()

        path = run(go())
        raw = open(path, "rb").read()
        want = ref_timeline.replay_report(json.loads(raw))
        got = replay_report(timeline_from_reference(raw))
        assert got == want
        assert got["overall"]["bottleneck"]["stage"] == "h2d"

    def test_a_dump_of_another_version_is_refused(self):
        from torrent_tpu_torch.compat import timeline_from_reference

        with pytest.raises(ValueError):
            timeline_from_reference({"v": 2, "samples": []})
        with pytest.raises(ValueError):
            timeline_from_reference("[1, 2]")

    def test_replay_fault_is_the_references(self):
        """The reference's replay_report raises on a sample whose
        ``sched`` is not a dict (the known failing property of
        tests/test_fuzz.py); the copy raises the same, unrepaired."""
        from torrent_tpu.obs import timeline as ref_timeline

        ring = {"samples": [{}, {"sched": 1}], "drops": "x"}
        with pytest.raises(Exception) as want:
            ref_timeline.replay_report(ring)
        with pytest.raises(Exception) as got:
            replay_report(ring)
        assert type(got.value) is type(want.value) is AttributeError
        assert str(got.value) == str(want.value)

    def test_build_sample_and_health_agree(self):
        from torrent_tpu.obs import slo as ref_slo
        from torrent_tpu.obs import timeline as ref_timeline

        for sample in _seeded_samples(5, n=4):
            led = {"stages": sample["stages"], "overlap": {"busy_s": 0.25}}
            sched = {"tenants": {"a": {"served_pieces": sample["sched"]["pieces"]}},
                     "shed_total": sample["sched"]["shed"],
                     "failed_pieces": sample["sched"]["failed_pieces"]}
            kw = dict(sched_snap=sched, swarm=sample["swarm"],
                      control={"stage": "h2d", "confirmed": True}, distrust=1)
            assert build_sample(sample["t"], led, **kw) == ref_timeline.build_sample(
                sample["t"], led, **kw
            )
        report = evaluate_slo(_seeded_samples(6), parse_objectives(SPEC))
        for kw in (
            {"probe_ok": True, "breakers": {}, "sampler_alive": True},
            {"probe_ok": False, "sampler_alive": False},
            {"breakers": {"l": {"state": "open", "open_age_s": 90.0, "cooldown": 30.0}}},
            {"slo_report": report},
        ):
            assert build_health(**kw) == ref_slo.build_health(**kw)

    def test_armed_engine_digest_summary_agrees(self, fresh_globals):
        """An armed engine's summary rides the fleet digest in both
        packages (the port's ``obs_digest`` restores it), and neither
        carries one once disarmed."""
        from torrent_tpu.obs import fleet as ref_fleet
        from torrent_tpu.obs import slo as ref_slo
        from torrent_tpu_torch.obs import fleet
        from torrent_tpu_torch.obs import slo

        samples = _seeded_samples(7)
        ref_engine = ref_slo.arm(ref_slo.SloEngine(SPEC, short_samples=3, long_samples=8))
        engine = slo.arm(SloEngine(SPEC, short_samples=3, long_samples=8))
        try:
            for k in range(1, len(samples) + 1):
                assert engine.observe({"samples": samples[:k]}) == ref_engine.observe(
                    {"samples": samples[:k]}
                )
            assert engine.summary() == ref_engine.summary() is not None
            assert fleet.obs_digest()["slo"] == ref_fleet.obs_digest()["slo"]
            assert fleet.obs_digest()["slo"] == engine.summary()
        finally:
            slo.disarm(engine)
            ref_slo.disarm(ref_engine)
        assert fleet.obs_digest().get("slo") is None
        assert slo.armed() is None

    def test_renderers_print_the_same_text(self, clock):
        """The four copied renderers print the reference's bytes for the
        same snapshots: seeded registries, hostile shapes, and the
        control-character peer key behind the reference's failing
        serve-snapshot property (it breaks the line-based lint in both)."""
        from torrent_tpu.obs import slo as ref_slo
        from torrent_tpu.obs import swarm as ref_swarm
        from torrent_tpu.obs import timeline as ref_timeline
        from torrent_tpu.serve_plane import telemetry as ref_serve
        from torrent_tpu.utils import metrics as ref_metrics
        from torrent_tpu_torch.serve_plane import telemetry as serve
        from torrent_tpu_torch.utils import metrics

        rng = np.random.default_rng(11)
        swarm_pair = (SwarmTelemetry(), ref_swarm.SwarmTelemetry())
        serve_pair = (serve.ServeTelemetry(), ref_serve.ServeTelemetry())
        for i in range(TOP_PEERS + 6):
            key = f"p{i:02d}@10.0.0.{i}:6881"
            n = int(rng.integers(1, 1 << 16))
            rtt = float(rng.uniform(0.0005, 0.5))
            path = ("sendfile", "preadv", "copy")[i % 3]
            for reg in swarm_pair:
                reg.peer_connected(key)
                reg.on_message(key, "Piece", n)
                reg.on_block(key, n, rtt)
                reg.on_state(key, peer_choking=bool(i % 2))
                if i % 4 == 0:
                    reg.on_snub(key)
            for reg in serve_pair:
                reg.peer_serving(key)
                reg.on_egress(key, path, n)
                if i % 5 == 0:
                    reg.on_reject(key, "per_ip")
            clock.t += float(rng.uniform(0.01, 1.0))
        for reg in swarm_pair:
            reg.on_announce(False, origin="udp")
        for reg in serve_pair:
            reg.on_choke_round(0.003, unchoked=4, interested=9,
                               optimistic="p01@10.0.0.1:6881", rotated=True)
        assert metrics.render_swarm_metrics(
            swarm_pair[0].snapshot()
        ) == ref_metrics.render_swarm_metrics(swarm_pair[1].snapshot())
        assert metrics.render_serve_metrics(
            serve_pair[0].snapshot()
        ) == ref_metrics.render_serve_metrics(serve_pair[1].snapshot())

        hostile = {"\x1e": {}}
        text = metrics.render_serve_metrics(serve.build_serve_snapshot(hostile, {}))
        assert text == ref_metrics.render_serve_metrics(
            ref_serve.build_serve_snapshot(hostile, {})
        )
        for s in ({}, None, {"counts": {"connected": 3}, "peers": {"x": {"bytes_down": 7}}}):
            assert metrics.render_swarm_metrics(s) == ref_metrics.render_swarm_metrics(s)
            assert metrics.render_serve_metrics(s) == ref_metrics.render_serve_metrics(s)

        ref_tl, tl = ref_timeline.Timeline(depth=6), Timeline(depth=6)
        for sample in _seeded_samples(12, n=9):
            ref_tl.push(sample)
            tl.push(sample)
        for snap_pair in ((tl.stats(), ref_tl.stats()), (tl.snapshot(), ref_tl.snapshot())):
            assert metrics.render_timeline_metrics(
                snap_pair[0]
            ) == ref_metrics.render_timeline_metrics(snap_pair[1])
        report = evaluate_slo(tl.snapshot()["samples"], parse_objectives(SPEC))
        assert report == ref_slo.evaluate_slo(
            ref_tl.snapshot()["samples"], ref_slo.parse_objectives(SPEC)
        )
        for r in (report, None, {}, {"objectives": {"availability": {}}}):
            assert metrics.render_slo_metrics(r) == ref_metrics.render_slo_metrics(r)

