"""`python -m torrent_tpu_torch bench` — unified bench rungs,
banked-schema records, and the trajectory comparator, on the card.

Every rung is named and emits ONE banked-schema JSON line; in-process
rungs embed the pipeline ledger's per-stage breakdown, so every record
carries its own bottleneck attribution.

Rungs::

    bench smoke      # CPU-plane scheduler recheck (seconds; the CI rung —
                     # in-process, ledger breakdown embedded)
    bench e2e        # end-to-end disk→slot→device recheck through the
                     # zero-copy ingest path (scheduler-fed; --hasher gpu
                     # is the SHA-1 kernel on --device, the card by
                     # default, cpu is hashlib; ledger breakdown + overlap
                     # + slab accounting embedded)
    bench v2         # the SHA-256 leaf plane + merkle roots: the device
                     # bench (tools/device_bench.py) BENCH_CONFIG=v2,
                     # median-of-3
    bench flagship   # B=8192 headline shape: the device bench
                     # BENCH_CONFIG=headline, median-of-3
    bench fabric     # 1/2/4-process fabric verify (tools/bench_fabric.py,
                     # every worker on --hasher and --device), median-of-3
    bench controller # scheduler-autopilot A/B under an h2d throttle
                     # (hashlib planes); value = the controller-on rate
    bench announce   # many-client announce storm against the sharded
                     # swarm store, median-of-3; FAILS unless >= 4 shards
                     # were exercised concurrently
    bench swarm      # loopback seed→leech download, median-of-3 pieces/s,
                     # both clients verifying with --hasher on --device
    bench seed       # one seed serving N raw-wire leechers; upload MiB/s
    bench scenario   # churn-storm against a million-swarm store

``--smoke`` is an alias for the smoke rung (CI spells it that way).
Device rungs run ``python -m torrent_tpu_torch.tools.device_bench``
with the rung's environment and pass the child's record through wrapped
in the bench schema; the child's record names its ``platform`` (``cuda``
or ``cpu``) and the kernel launches it made. Without CUDA it prints a
null record and the rung fails: no CPU number stands in for the card's.

Record schema (``"schema": "torrent-tpu-bench/1"``): the banked-record
fields the device bench emits (metric/value/unit/vs_baseline/batch/
platform/…) plus ``rung``, ``measured_at_utc``, and ``ledger`` — the
per-stage busy/bytes/utilization table and the bottleneck verdict from
``obs/attrib.attribute`` (null for subprocess rungs). The fabric rung
instead embeds ``per_process`` and ``fleet_bottleneck``.

Comparator (``--compare``): gates a candidate record against the banked
trajectory, the port's own file: ``TORRENT_TPU_BENCH_TRAJECTORY``, else
``BENCH_trajectory_cuda.json`` in the current directory (never the
repo's ``BENCH_trajectory.json``, whose TPU and CPU records are the
reference's). ``--bank`` appends to it. Like-for-like means an identical
measurement shape — ``metric``, ``platform``, ``batch``, payload shape
(``piece_kb``/``bytes``), and host class (``nproc``) — and the banked
record is not flagged ``non_like_for_like``. With no like-for-like
banked record the comparator reports itself **unarmed** and exits 0.
``--report-only`` never fails the run.

Exit codes: 0 = rung ok / comparator passed or unarmed; 1 = rung
failed, null value, or regression beyond ``--tolerance``; 2 = usage.
"""

from __future__ import annotations

import asyncio
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

__all__ = ["compare_record", "load_trajectory", "main"]

SCHEMA = "torrent-tpu-bench/1"
TRAJECTORY_SCHEMA = "torrent-tpu-bench-trajectory/1"
RUNGS = (
    "smoke", "e2e", "v2", "fabric", "flagship", "controller", "announce",
    "swarm", "scenario", "seed",
)
# the announce rung's acceptance floor: the banked rate must come from
# real cross-shard concurrency, not one hot shard
ANNOUNCE_MIN_SHARDS_HIT = 4
DEFAULT_TOLERANCE = 0.10
# the controller rung's deterministic throttle: every launch's h2d
# sleeps this long (sched/faults.py slow-interconnect model), so the
# autopilot's grown batches measurably amortize the fixed cost
CONTROLLER_FAULT = "latency_ms=25"

# env the retired .bench rung scripts exported, reproduced per rung
# (r6_sha256_rung.sh leg 2; the flagship shape from BENCH_CONFIGS_r05)
_DEVICE_RUNG_ENV = {
    "v2": {
        "BENCH_CONFIG": "v2",
        "BENCH_TOTAL_MB": "256",
        "BENCH_V2_NRES": "3",
        "BENCH_E2E_MB": "16",
        "BENCH_H2D_MB": "8",
        "BENCH_NO_REPLAY": "1",
    },
    "flagship": {
        "BENCH_CONFIG": "headline",
        "BENCH_BATCH": "8192",
        "BENCH_TOTAL_MB": "2048",
        "BENCH_NO_REPLAY": "1",
    },
}


def _utcnow() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _repo_root() -> str:
    """The source checkout root, which holds the package: the device and
    fabric rungs run their children from there. The smoke rung and the
    comparator do not need it."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def default_trajectory_path() -> str:
    """``TORRENT_TPU_BENCH_TRAJECTORY``, else ``BENCH_trajectory_cuda.json``
    in the current directory: the port's own records, never the repo's
    ``BENCH_trajectory.json`` (the reference's TPU and CPU records)."""
    env = os.environ.get("TORRENT_TPU_BENCH_TRAJECTORY")
    if env:
        return env
    return os.path.join(os.getcwd(), "BENCH_trajectory_cuda.json")


# ------------------------------------------------------------ smoke rung


def _build_smoke_torrent(tmp: str, total_mb: int, piece_kb: int):
    """Synthetic single-file torrent on real disk (the read stage must
    measure actual storage reads, not memory copies)."""
    import numpy as np

    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.storage.storage import FsStorage, Storage
    from torrent_tpu_torch.tools.make_torrent import make_torrent

    payload_path = os.path.join(tmp, "bench_smoke.bin")
    rng = np.random.default_rng(7)
    total = total_mb << 20
    with open(payload_path, "wb") as f:
        f.write(rng.integers(0, 256, total, dtype=np.uint8).tobytes())
    meta = parse_metainfo(
        make_torrent(
            payload_path, "http://bench.invalid/announce",
            piece_length=piece_kb << 10, hasher="cpu",
        )
    )
    return Storage(FsStorage(tmp), meta.info), meta.info


async def _smoke(total_mb: int, piece_kb: int, batch_target: int) -> dict:
    """The CPU-plane rung: a scheduler-fed library recheck with the
    pipeline ledger attributing every stage. Deterministic, CPU-only,
    seconds — the rung CI runs on every PR."""
    from torrent_tpu_torch.obs.attrib import attribute
    from torrent_tpu_torch.obs.ledger import pipeline_ledger
    from torrent_tpu_torch.obs.slo import default_objectives, evaluate_slo
    from torrent_tpu_torch.obs.timeline import Timeline, TimelineSampler
    from torrent_tpu_torch.parallel.bulk import verify_library_sched
    from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig

    with tempfile.TemporaryDirectory(prefix="tt_bench_smoke_") as tmp:
        storage, info = await asyncio.to_thread(
            _build_smoke_torrent, tmp, total_mb, piece_kb
        )
        led = pipeline_ledger()
        prev = led.snapshot()
        sched = HashPlaneScheduler(
            SchedulerConfig(batch_target=batch_target, flush_deadline=0.02),
            hasher="cpu",
        )
        await sched.start()
        # a private timeline bracketing the run (sampled manually, no
        # thread): the record embeds the ring facts + the SLO verdict
        # over them, so `summarize --trajectory` carries the schema
        timeline = Timeline(depth=16)
        sampler = TimelineSampler(timeline, scheduler=sched)
        try:
            sampler.sample_once()
            t0 = time.perf_counter()
            res = await verify_library_sched([(storage, info)], sched, tenant="bench")
            seconds = time.perf_counter() - t0
            sampler.sample_once()
            slo_rep = evaluate_slo(timeline.samples(), default_objectives())
        finally:
            await sched.close()
        rep = attribute(led.snapshot(), prev=prev)
    n_valid = int(res.bitfields[0].sum())
    pieces = info.num_pieces
    value = round(pieces / seconds, 1) if seconds > 0 else None
    return {
        "schema": SCHEMA,
        "rung": "smoke",
        "metric": f"sha1_recheck_smoke_{piece_kb}KiB_pieces_per_sec",
        "value": value if n_valid == pieces else None,
        "unit": "pieces/s",
        "pieces": pieces,
        "valid": n_valid,
        "bytes": info.length,
        "seconds": round(seconds, 4),
        "gib_per_sec": round(info.length / seconds / 2**30, 3) if seconds else None,
        "batch": batch_target,
        "piece_kb": piece_kb,
        "platform": "cpu",
        "plane": "cpu",
        # host class for the like-for-like key: a CPU-plane rate banked
        # on a big workstation must not gate a smaller CI runner
        "nproc": os.cpu_count(),
        "measured_at_utc": _utcnow(),
        "ledger": {
            "wall_s": rep["wall_s"],
            "stages": rep["stages"],
            "bottleneck": rep["bottleneck"],
            "overlap": rep.get("overlap"),
        },
        # the timeline/SLO plane's schema keys: ring facts plus
        # the default-contract verdict over the bracketing samples — a
        # clean rung must show zero burn and no breach
        "timeline": {
            "samples": len(timeline.samples()),
            "drops": 0,
            "limiting": (rep.get("bottleneck") or {}).get("stage")
            if rep.get("bottleneck")
            else None,
        },
        "slo": {
            "worst": slo_rep.get("worst"),
            "breach_any": slo_rep.get("breach_any"),
            "objectives": {
                name: {
                    "burn_rate": obj.get("burn_rate"),
                    "budget_remaining": obj.get("budget_remaining"),
                    "classification": obj.get("classification"),
                }
                for name, obj in sorted(slo_rep.get("objectives", {}).items())
            },
        },
    }


async def _e2e(
    total_mb: int, piece_kb: int, batch_target: int, hasher: str, device=None
) -> dict:
    """The end-to-end ingest rung: a scheduler-fed recheck over real
    disk through the zero-copy path (disk → staging slot → device),
    with the ledger's per-stage breakdown AND the cross-stage overlap
    series embedded — read-while-h2d-while-launch is part of the banked
    record, so double-buffering regressions are visible, not anecdotal.
    ``hasher='gpu'`` runs the SHA-1 kernel on ``device`` (None means the
    card; ``"cpu"`` its plain version), 'cpu' the hashlib plane; both go
    through the same ingest path. ``platform`` is ``cpu`` for hashlib,
    else the torch device type."""
    from torrent_tpu_torch.obs.attrib import attribute
    from torrent_tpu_torch.obs.ledger import pipeline_ledger
    from torrent_tpu_torch.parallel.bulk import verify_library_sched
    from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig
    from torrent_tpu_torch.utils.device import resolve_device

    with tempfile.TemporaryDirectory(prefix="tt_bench_e2e_") as tmp:
        storage, info = await asyncio.to_thread(
            _build_smoke_torrent, tmp, total_mb, piece_kb
        )
        led = pipeline_ledger()
        prev = led.snapshot()
        sched = HashPlaneScheduler(
            SchedulerConfig(batch_target=batch_target, flush_deadline=0.02),
            hasher=hasher,
            device=device,
        )
        await sched.start()
        try:
            t0 = time.perf_counter()
            res = await verify_library_sched([(storage, info)], sched, tenant="bench")
            seconds = time.perf_counter() - t0
        finally:
            await sched.close()
        staging = sched.metrics_snapshot().get("staging", {})
        rep = attribute(led.snapshot(), prev=prev)
    n_valid = int(res.bitfields[0].sum())
    pieces = info.num_pieces
    value = round(pieces / seconds, 1) if seconds > 0 else None
    return {
        "schema": SCHEMA,
        "rung": "e2e",
        "metric": f"sha1_recheck_e2e_{hasher}_{piece_kb}KiB_pieces_per_sec",
        "value": value if n_valid == pieces else None,
        "unit": "pieces/s",
        "pieces": pieces,
        "valid": n_valid,
        "bytes": info.length,
        "seconds": round(seconds, 4),
        "gib_per_sec": round(info.length / seconds / 2**30, 3) if seconds else None,
        "batch": batch_target,
        "piece_kb": piece_kb,
        "platform": "cpu" if hasher == "cpu" else resolve_device(device).type,
        "plane": hasher,
        "nproc": os.cpu_count(),
        # zero-copy health facts alongside the rate: stage-copy bytes
        # must stay ~0 and every slab must have come back
        "staging_outstanding": staging.get("outstanding"),
        "staged_checkouts": staging.get("checkouts"),
        "measured_at_utc": _utcnow(),
        "ledger": {
            "wall_s": rep["wall_s"],
            "stages": rep["stages"],
            "bottleneck": rep["bottleneck"],
            "overlap": rep.get("overlap"),
        },
    }


async def _controller_ab(total_mb: int, piece_kb: int, batch_target: int) -> dict:
    """The scheduler-autopilot A/B rung: one shape, run twice under the
    same deterministic h2d throttle (:data:`CONTROLLER_FAULT`) — first
    with the static config, then with the autopilot armed. The fixed
    per-launch transfer cost means fewer, bigger launches win; the
    controller's batch actuator must discover that live, so
    controller-on ≥ controller-off pieces/s is the banked proof that
    the observe→act loop changes throughput instead of describing it."""
    from torrent_tpu_torch.obs.attrib import attribute
    from torrent_tpu_torch.obs.ledger import pipeline_ledger
    from torrent_tpu_torch.parallel.bulk import verify_library_sched
    from torrent_tpu_torch.sched import (
        ControlConfig,
        FaultPlan,
        HashPlaneScheduler,
        SchedulerAutopilot,
        SchedulerConfig,
    )

    with tempfile.TemporaryDirectory(prefix="tt_bench_ctl_") as tmp:
        storage, info = await asyncio.to_thread(
            _build_smoke_torrent, tmp, total_mb, piece_kb
        )

        async def run_once(controller_on: bool):
            led = pipeline_ledger()
            prev = led.snapshot()
            plan = FaultPlan.parse(CONTROLLER_FAULT)
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=batch_target,
                    flush_deadline=0.02,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            await sched.start()
            pilot = None
            if controller_on:
                pilot = SchedulerAutopilot(
                    sched,
                    ControlConfig(
                        enabled=True, interval_s=0.05,
                        hysteresis_ticks=1, cooldown_ticks=0,
                    ),
                ).start()
            try:
                t0 = time.perf_counter()
                res = await verify_library_sched(
                    [(storage, info)], sched, tenant="bench"
                )
                seconds = time.perf_counter() - t0
            finally:
                if pilot is not None:
                    await pilot.close()
                await sched.close()
            rep = attribute(led.snapshot(), prev=prev)
            status = pilot.status() if pilot is not None else None
            snap = sched.metrics_snapshot()
            return {
                "seconds": seconds,
                "valid": int(res.bitfields[0].sum()),
                "launches": snap.get("launches", 0),
                "lane_stats": snap.get("lane_stats", {}),
                "admission_factor": snap.get("admission_factor", 1.0),
                "rep": rep,
                "control": status,
            }

        off = await run_once(False)
        on = await run_once(True)
    pieces = info.num_pieces
    off_pps = round(pieces / off["seconds"], 1) if off["seconds"] > 0 else None
    on_pps = round(pieces / on["seconds"], 1) if on["seconds"] > 0 else None
    complete = off["valid"] == pieces and on["valid"] == pieces
    control = on["control"] or {}
    decision = control.get("decision") or {}
    rep = on["rep"]
    return {
        "schema": SCHEMA,
        "rung": "controller",
        "metric": f"sha1_recheck_controller_ab_{piece_kb}KiB_pieces_per_sec",
        # the headline value is the CONTROLLER-ON rate; the embedded A/B
        # record carries both sides so the win is auditable
        "value": on_pps if complete else None,
        "unit": "pieces/s",
        "pieces": pieces,
        "bytes": info.length,
        "batch": batch_target,
        "piece_kb": piece_kb,
        "platform": "cpu",
        "plane": "cpu",
        "nproc": os.cpu_count(),
        "fault": CONTROLLER_FAULT,
        "measured_at_utc": _utcnow(),
        "ab": {
            "controller_off_pps": off_pps,
            "controller_on_pps": on_pps,
            "ratio": (
                round(on_pps / off_pps, 3) if on_pps and off_pps else None
            ),
            "launches_off": off["launches"],
            "launches_on": on["launches"],
        },
        "decision": {
            "ticks": control.get("tick"),
            "bottleneck": (decision.get("bottleneck") or {}).get("stage"),
            "actions_total": control.get("actions_total"),
            "admission_factor": on["admission_factor"],
            "lane_targets": {
                lane: st.get("target")
                for lane, st in sorted(on["lane_stats"].items())
            },
        },
        "ledger": {
            "wall_s": rep["wall_s"],
            "stages": rep["stages"],
            "bottleneck": rep["bottleneck"],
            "overlap": rep.get("overlap"),
        },
    }


async def _announce_storm(
    clients: int, swarms: int, per_client: int, shards: int, numwant: int
) -> dict:
    """The announce-plane rung: ``clients`` worker threads storm the
    sharded swarm store concurrently, each announcing ``per_client``
    times round-robin across ``swarms`` distinct info-hashes (fixed
    sha1-derived hashes, so shard distribution is deterministic).
    Median-of-3 announces/s, with per-shard occupancy and a latency
    summary embedded — the banked proof that the control plane's O(1)
    sampling and leaf-locked shards actually scale, not a slogan.

    The record's value is ``None`` (rung FAILED) unless at least
    :data:`ANNOUNCE_MIN_SHARDS_HIT` shards held peers at the end — the
    rate must come from cross-shard concurrency."""
    import hashlib

    from torrent_tpu_torch.net.types import AnnounceEvent
    from torrent_tpu_torch.obs.hist import histograms
    from torrent_tpu_torch.server.shard import ShardedSwarmStore

    info_hashes = [
        hashlib.sha1(f"bench-announce-swarm-{i}".encode()).digest()
        for i in range(swarms)
    ]

    def worker(store: ShardedSwarmStore, ci: int) -> list[float]:
        lats: list[float] = []
        for k in range(per_client):
            ih = info_hashes[(ci + k) % swarms]
            pid = b"%04d%04d" % (ci, k % 2000)
            pid = pid + b"p" * (20 - len(pid))
            t0 = time.perf_counter()
            store.announce(
                ih, pid, f"10.0.{ci % 256}.{k % 256}", 6881 + ci,
                left=(k % 4) and 1 or 0, event=AnnounceEvent.EMPTY,
                numwant=numwant,
            )
            lats.append(time.perf_counter() - t0)
        return lats

    rates: list[float] = []
    all_lats: list[float] = []
    snap: dict = {}
    for _rep in range(3):
        store = ShardedSwarmStore(n_shards=shards)
        t0 = time.perf_counter()
        lat_lists = await asyncio.gather(
            *(asyncio.to_thread(worker, store, ci) for ci in range(clients))
        )
        wall = time.perf_counter() - t0
        total = clients * per_client
        rates.append(total / wall if wall > 0 else 0.0)
        for lats in lat_lists:
            all_lats.extend(lats)
        snap = store.metrics_snapshot()
    # the storm observes into the shared log2 family too, so the rung
    # exercises the same wiring /metrics scrapes
    histograms().get(
        "torrent_tpu_tracker_announce_seconds",
        help="Tracker announce handle latency (receive to reply)",
        transport="storm",
    ).observe_batch(all_lats[-10000:])
    occupancy = {
        str(i): sh.get("peers", 0) for i, sh in enumerate(snap.get("shards", []))
    }
    shards_hit = sum(1 for v in occupancy.values() if v > 0)
    all_lats.sort()

    def _pct(q: float) -> float:
        return round(all_lats[int(q * (len(all_lats) - 1))] * 1e6, 1)

    value = round(statistics.median(rates), 1)
    ok = bool(all_lats) and shards_hit >= ANNOUNCE_MIN_SHARDS_HIT
    return {
        "schema": SCHEMA,
        "rung": "announce",
        "metric": f"tracker_announce_storm_{swarms}sw_announces_per_sec",
        "value": value if ok else None,
        "unit": "announces/s",
        "contract": "median-of-3",
        "rates": [round(r, 1) for r in rates],
        "announces": clients * per_client,
        "clients": clients,
        "swarms": swarms,
        "shards": shards,
        "shards_hit": shards_hit,
        "numwant": numwant,
        # the storm width is the launch shape for the like-for-like key
        "batch": clients,
        "platform": "cpu",
        "nproc": os.cpu_count(),
        "latency": {
            "p50_us": _pct(0.50) if all_lats else None,
            "p99_us": _pct(0.99) if all_lats else None,
            "max_us": _pct(1.0) if all_lats else None,
        },
        "shard_occupancy": occupancy,
        "store": {
            "swarms": snap.get("swarms"),
            "peers": snap.get("peers"),
            "numwant_clamped": snap.get("numwant_clamped"),
        },
        "measured_at_utc": _utcnow(),
        "ledger": None,  # the announce plane is not a pipeline-ledger path
    }


def _scenario_rung(occupancy: int, shards: int) -> dict:
    """The scenario rung: fill the sharded store to ``occupancy``
    single-seed swarms (distinct sha1-derived info-hashes, one peer
    each) on a virtual timeline, then run the bundled churn-storm
    scenario against that PRE-FILLED store — the banked rate is the
    wall-plane announces/s the serve stack sustains while holding
    million-swarm occupancy under live churn. The record's value is
    ``None`` unless the fill reached the requested occupancy, the SLO
    verdict passed, and the wall plane held its latency budget."""
    import hashlib
    import random

    from torrent_tpu_torch.net.types import AnnounceEvent
    from torrent_tpu_torch.scenario import VirtualClock, run_scenario
    from torrent_tpu_torch.scenario.library import get
    from torrent_tpu_torch.server.shard import ShardedSwarmStore

    spec = get("churn-storm")
    # same construction run_scenario uses for a fresh store: the engine
    # adopts the clock/rng, so the prefill and the scenario share one
    # coherent virtual timeline. churn-storm's short TTL means the
    # prefill population ages out by the final sweep, so the engine's
    # exact-occupancy oracle still balances.
    clock = VirtualClock(float(spec.peer_ttl_s) + 1.0)
    rng = random.Random(spec.seed)
    store = ShardedSwarmStore(
        n_shards=shards, peer_ttl=float(spec.peer_ttl_s),
        clock=clock, rng=rng,
    )

    chunk = 10_000
    t0 = time.perf_counter()
    for base in range(0, occupancy, chunk):
        batch = []
        for i in range(base, min(base + chunk, occupancy)):
            ih = hashlib.sha1(b"bench-scenario-swarm-%d" % i).digest()
            pid = b"-BN-" + ih[:16]
            batch.append((
                ih, pid,
                f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}",
                6881, 0, AnnounceEvent.STARTED, 0,
            ))
        store.announce_batch(batch)
    fill_wall = time.perf_counter() - t0
    fill_snap = store.metrics_snapshot()
    occupancy_held = fill_snap["peers"]

    result = run_scenario(spec, store=store)
    verdict = result["verdict"]
    wall = verdict["wall"]

    ok = (
        occupancy_held == occupancy
        and bool(verdict["pass"])
        and bool(wall["ok"])
    )
    return {
        "schema": SCHEMA,
        "rung": "scenario",
        "metric": f"scenario_churn_{occupancy}sw_announces_per_sec",
        "value": wall["announces_per_s"] if ok else None,
        "unit": "announces/s",
        "contract": "churn-storm verdict PASS at full occupancy",
        "scenario": spec.name,
        "seed": spec.seed,
        "ticks": spec.ticks,
        "population": verdict["population"],
        "occupancy": occupancy,
        "occupancy_held": occupancy_held,
        "fill_announces_per_sec": (
            round(occupancy / fill_wall, 1) if fill_wall > 0 else 0.0
        ),
        "shards": shards,
        "verdict_pass": bool(verdict["pass"]),
        "reasons": verdict["reasons"][:4],
        "budget": verdict["budget"],
        # the scenario population is the launch shape for the
        # like-for-like key
        "batch": verdict["population"],
        "platform": "cpu",
        "nproc": os.cpu_count(),
        "latency": {
            "p50_us": wall["p50_us"],
            "p99_us": wall["p99_us"],
            "max_us": wall["max_us"],
        },
        "measured_at_utc": _utcnow(),
        "ledger": None,  # scenario verdicts are not a pipeline-ledger path
    }


async def _swarm_rung(
    total_mb: int, piece_kb: int, hasher: str = "gpu", device=None
) -> dict:
    """The swarm wire-plane rung: a real two-client loopback download
    (in-memory tracker, TCP sockets, the full picker/choke/endgame
    stack), median-of-3 pieces/s. The record embeds the swarm telemetry
    snapshot's facts (block-RTT p99, choke transitions, endgame
    cancels) plus the recv-stage ledger breakdown bracketing the
    final rep — a swarm throughput regression banks WITH evidence of
    whether the wire, the picker, or verification moved. (Deliberately
    NOT built on doctor's ``_LoopbackSwarm`` scaffold: each rep times
    leech-add→completion and recreates the tracker, a rep-scoped shape
    the smoke harness doesn't need.) Both clients verify with ``hasher``
    on ``device`` (None means the card); ``platform`` is ``cpu`` for
    hashlib, else the torch device type."""
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.obs.attrib import attribute
    from torrent_tpu_torch.obs.ledger import pipeline_ledger
    from torrent_tpu_torch.obs.swarm import swarm_telemetry
    from torrent_tpu_torch.server.in_memory import run_tracker
    from torrent_tpu_torch.server.tracker import ServeOptions
    from torrent_tpu_torch.session.client import Client, ClientConfig
    from torrent_tpu_torch.tools.make_torrent import make_torrent
    from torrent_tpu_torch.utils.device import resolve_device

    import numpy as np

    platform = "cpu" if hasher == "cpu" else resolve_device(device).type
    rates: list[float] = []
    swarm_fact: dict = {}
    rep: dict = {}
    pieces = 0
    total = total_mb << 20
    with tempfile.TemporaryDirectory(prefix="tt_bench_swarm_") as tmp:
        sd = os.path.join(tmp, "seed")
        os.makedirs(sd)
        rng = np.random.default_rng(11)
        with open(os.path.join(sd, "swarm.bin"), "wb") as f:
            f.write(rng.integers(0, 256, total, dtype=np.uint8).tobytes())

        async def one_rep(i: int) -> float:
            nonlocal swarm_fact, rep, pieces
            led = pipeline_ledger()
            prev = led.snapshot()
            # the registry is process-global and cumulative: the facts
            # embedded in the record are THIS rep's delta, so they
            # reconcile with the record's own bytes/pieces (an
            # accumulated 3-rep total would read as a 3x mismatch)
            base_totals = swarm_telemetry().snapshot().get("totals") or {}
            server, _ = await run_tracker(
                ServeOptions(http_port=0, udp_port=None, interval=1)
            )
            ann = f"http://127.0.0.1:{server.http_port}/announce"
            meta = parse_metainfo(
                make_torrent(
                    os.path.join(sd, "swarm.bin"), ann,
                    piece_length=piece_kb << 10, hasher="cpu",
                )
            )
            ld = os.path.join(tmp, f"leech{i}")
            os.makedirs(ld)
            seed = Client(ClientConfig(
                port=0, enable_upnp=False, resume=False, hasher=hasher, device=device,
            ))
            leech = Client(ClientConfig(
                port=0, enable_upnp=False, resume=False, hasher=hasher, device=device,
            ))
            await seed.start()
            await leech.start()
            try:
                t1 = await seed.add(meta, sd)
                assert t1.bitfield.complete, "seed recheck failed"
                t0 = time.perf_counter()
                t2 = await leech.add(meta, ld)
                deadline = t0 + 300.0
                while not t2.bitfield.complete:
                    if time.perf_counter() > deadline:
                        raise RuntimeError("swarm rung download stalled")
                    await asyncio.sleep(0.02)
                seconds = time.perf_counter() - t0
                pieces = meta.info.num_pieces
                snap = swarm_telemetry().snapshot()
                totals = snap.get("totals") or {}
                peer_rtts = [
                    p.get("block_rtt") or {}
                    for p in (snap.get("peers") or {}).values()
                    if (p.get("block_rtt") or {}).get("count")
                ]

                def delta(key):
                    return (totals.get(key) or 0) - (base_totals.get(key) or 0)

                swarm_fact = {
                    # live peers are per-rep already (fresh clients);
                    # the RTT summary covers the live per-peer records
                    "peers": snap.get("counts", {}).get("connected"),
                    "blocks": delta("blocks"),
                    "bytes_down": delta("bytes_down"),
                    "snubs": delta("snubs"),
                    "endgame_cancels": delta("endgame_cancels"),
                    "block_rtt_p99_s": max(
                        (r.get("p99_s") or 0.0 for r in peer_rtts),
                        default=None,
                    ),
                }
            finally:
                await leech.close()
                await seed.close()
                server.close()
            rep = attribute(led.snapshot(), prev=prev)
            return pieces / seconds if seconds > 0 else 0.0

        for i in range(3):
            rates.append(await one_rep(i))
    value = round(statistics.median(rates), 1) if all(rates) else None
    return {
        "schema": SCHEMA,
        "rung": "swarm",
        "metric": f"swarm_loopback_{piece_kb}KiB_pieces_per_sec",
        "value": value,
        "unit": "pieces/s",
        "contract": "median-of-3",
        "rates": [round(r, 1) for r in rates],
        "pieces": pieces,
        "bytes": total,
        "piece_kb": piece_kb,
        "batch": None,
        "platform": platform,
        "plane": hasher,
        "nproc": os.cpu_count(),
        "measured_at_utc": _utcnow(),
        # the wire plane's own evidence: swarm telemetry facts + the
        # recv-stage breakdown of the final rep
        "swarm": swarm_fact,
        "ledger": {
            "wall_s": rep.get("wall_s"),
            "stages": rep.get("stages"),
            "bottleneck": rep.get("bottleneck"),
            "overlap": rep.get("overlap"),
        },
    }


async def _seed_rung(
    total_mb: int, piece_kb: int, leechers: int, hasher: str = "gpu", device=None
) -> dict:
    """The seeder-plane rung: ONE seeding client serving ``leechers``
    concurrent raw-wire loopback leechers, each pulling the FULL payload
    (staggered piece order spreads the read offsets). Banks sustained
    upload MiB/s measured from the serve telemetry's ``bytes_up`` delta
    — the bytes the egress plane actually pushed, duplicates included —
    plus block service p50/p99 (request-send to Piece-receipt on the
    leecher side, so choke-rotation queueing is IN the tail) and the
    egress fallback matrix (sendfile/preadv/copy deltas): an upload
    regression banks WITH evidence of whether zero-copy disengaged, the
    reactor shed, or the choke rotation stalled.

    Leech protocol discipline: a choked BEP 3 peer's requests are
    silently dropped, and every drop is bracketed by a later Unchoke —
    so the loop re-arms its whole request window on each Unchoke and
    keeps the window under ``serve_queue_depth`` (no backpressure sheds
    of our own traffic, no re-request timers, no mid-frame read
    cancellation). The seed rechecks its payload with ``hasher`` on
    ``device`` (None means the card)."""
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.net import protocol as proto
    from torrent_tpu_torch.obs.attrib import attribute
    from torrent_tpu_torch.obs.ledger import pipeline_ledger
    from torrent_tpu_torch.serve_plane.telemetry import serve_telemetry
    from torrent_tpu_torch.session.client import Client, ClientConfig
    from torrent_tpu_torch.session.torrent import TorrentConfig
    from torrent_tpu_torch.tools.make_torrent import make_torrent
    from torrent_tpu_torch.utils.device import resolve_device

    import numpy as np

    platform = "cpu" if hasher == "cpu" else resolve_device(device).type
    piece_len = piece_kb << 10
    block = 16384
    window = 32  # outstanding per leecher, < serve_queue_depth (64)
    total = total_mb << 20
    # fewer slots than leechers: the crowd must contend, so the banked
    # p99 includes real choke-rotation waits (the economics under test)
    slots = max(4, leechers // 8)
    with tempfile.TemporaryDirectory(prefix="tt_bench_seed_") as tmp:
        sd = os.path.join(tmp, "seed")
        os.makedirs(sd)
        rng = np.random.default_rng(17)
        payload = rng.integers(0, 256, total, dtype=np.uint8).tobytes()
        with open(os.path.join(sd, "seed.bin"), "wb") as f:
            f.write(payload)
        meta = parse_metainfo(
            make_torrent(
                os.path.join(sd, "seed.bin"), "http://127.0.0.1:1/announce",
                piece_length=piece_len, hasher="cpu",
            )
        )
        n_pieces = meta.info.num_pieces
        seed = Client(ClientConfig(
            port=0, enable_upnp=False, resume=False, hasher=hasher, device=device,
            torrent=TorrentConfig(
                max_peers=leechers + 8,
                choke_interval=0.25,
                unchoke_slots=slots,
            ),
        ))
        obs = serve_telemetry()
        base_tot = obs.snapshot().get("totals") or {}
        base_paths = {
            k: dict(v)
            for k, v in (obs.snapshot().get("paths") or {}).items()
        }
        led = pipeline_ledger()
        prev = led.snapshot()
        lat: list[float] = []
        writers: list = []
        await seed.start()
        try:
            t = await seed.add(meta, sd)
            assert t.bitfield.complete, "seed recheck failed"

            async def leech(i: int) -> None:
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", seed.port
                )
                writers.append(writer)
                pid = (b"-BR0001-" + f"{i:012d}".encode())[:20]
                await proto.send_handshake(writer, meta.info_hash, pid)
                await proto.read_handshake_head(reader)
                await proto.read_handshake_peer_id(reader)
                await proto.send_message(writer, proto.Interested())
                need: dict[tuple[int, int], int] = {}
                for j in range(n_pieces):
                    p = (i * 7 + j) % n_pieces
                    plen = min(piece_len, total - p * piece_len)
                    for off in range(0, plen, block):
                        need[(p, off)] = min(block, plen - off)
                pending: dict[tuple[int, int], float] = {}

                async def pump() -> None:
                    now = time.perf_counter()
                    for (p, off), ln in need.items():
                        if len(pending) >= window:
                            break
                        if (p, off) not in pending:
                            pending[(p, off)] = now
                            await proto.send_message(
                                writer, proto.Request(p, off, ln)
                            )

                unchoked = False
                while need:
                    msg = await proto.read_message(reader)
                    if isinstance(msg, proto.Unchoke):
                        # everything in flight may have been shed by a
                        # choke tick — re-arm the whole window
                        unchoked = True
                        pending.clear()
                        await pump()
                    elif isinstance(msg, proto.Choke):
                        unchoked = False
                    elif isinstance(msg, proto.Piece):
                        key = (msg.index, msg.begin)
                        sent = pending.pop(key, None)
                        if sent is not None:
                            lat.append(time.perf_counter() - sent)
                        ln = need.pop(key, None)
                        if ln is not None:
                            base = msg.index * piece_len + msg.begin
                            if msg.block != payload[base:base + ln]:
                                raise RuntimeError(
                                    f"leecher {i}: block {key} diverges"
                                )
                        if unchoked:
                            await pump()

            t0 = time.perf_counter()
            try:
                await asyncio.wait_for(
                    asyncio.gather(*(leech(i) for i in range(leechers))), 600
                )
            except asyncio.TimeoutError:
                raise RuntimeError(
                    f"seed rung stalled ({leechers} leechers, "
                    f"{total_mb} MiB each)"
                ) from None
            wall = time.perf_counter() - t0
        finally:
            for w in writers:
                w.close()
            await seed.close()

    snap = obs.snapshot()
    tot = snap.get("totals") or {}

    def delta(key):
        return (tot.get(key) or 0) - (base_tot.get(key) or 0)

    paths = {
        k: {
            "blocks": v.get("blocks", 0)
            - (base_paths.get(k) or {}).get("blocks", 0),
            "bytes": v.get("bytes", 0)
            - (base_paths.get(k) or {}).get("bytes", 0),
        }
        for k, v in (snap.get("paths") or {}).items()
    }
    zero_copy = sum(
        paths.get(k, {}).get("blocks", 0) for k in ("sendfile", "preadv")
    )
    if zero_copy <= 0:
        raise RuntimeError(
            f"no zero-copy egress on a contiguous single-file layout "
            f"(fallback matrix: {paths})"
        )
    if delta("optimistic_rotations") <= 0:
        raise RuntimeError(
            f"optimistic slot never rotated over {leechers} leechers "
            f"vs {slots} slots"
        )
    lat.sort()
    rep = attribute(led.snapshot(), prev=prev)
    return {
        "schema": SCHEMA,
        "rung": "seed",
        "metric": f"seed_{leechers}leech_{piece_kb}KiB_upload_MiB_per_sec",
        "value": round(delta("bytes_up") / (1 << 20) / wall, 1)
        if wall > 0 else None,
        "unit": "MiB/s",
        "contract": "sustained, full payload per leecher, dupes counted",
        "leechers": leechers,
        "block_p50_ms": round(lat[len(lat) // 2] * 1e3, 2) if lat else None,
        "block_p99_ms": round(lat[int(0.99 * (len(lat) - 1))] * 1e3, 2)
        if lat else None,
        "blocks": delta("blocks"),
        "bytes": total * leechers,
        "bytes_up": delta("bytes_up"),
        "piece_kb": piece_kb,
        "batch": None,
        "platform": platform,
        "plane": hasher,
        "nproc": os.cpu_count(),
        "measured_at_utc": _utcnow(),
        # the serve plane's own evidence: the egress fallback matrix +
        # reject/rotation counters bracketing the run
        "serve": {
            "paths": paths,
            "unchoke_slots": slots,
            "rounds": delta("rounds"),
            "optimistic_rotations": delta("optimistic_rotations"),
            "rejects_backpressure": delta("rejects_backpressure"),
            "rejects_choked": delta("rejects_choked"),
            "rejects_capacity": delta("rejects_capacity"),
            "rejects_per_ip": delta("rejects_per_ip"),
        },
        "ledger": {
            "wall_s": rep.get("wall_s"),
            "stages": rep.get("stages"),
            "bottleneck": rep.get("bottleneck"),
            "overlap": rep.get("overlap"),
        },
    }


# ----------------------------------------------------------- device rungs


def _run_bench_py(rung: str, timeout: float | None, device=None) -> dict:
    """Run the port's device bench (``python -m
    torrent_tpu_torch.tools.device_bench``, the counterpart of the repo's
    bench.py) with the rung's env; pass its record through wrapped in the
    bench schema. ``device`` None is the card; another device's type
    becomes ``BENCH_PLATFORM`` (``cpu``: the plain versions). Without
    CUDA the child prints a null record and the rung fails."""
    env = dict(os.environ)
    env.update(_DEVICE_RUNG_ENV[rung])
    if device is not None:
        import torch

        env["BENCH_PLATFORM"] = torch.device(device).type
    proc = subprocess.run(
        [sys.executable, "-m", "torrent_tpu_torch.tools.device_bench"],
        env=env, cwd=_repo_root(), capture_output=True, text=True,
        timeout=timeout,
    )
    line = ""
    for out_line in (proc.stdout or "").splitlines():
        out_line = out_line.strip()
        if out_line.startswith("{"):
            line = out_line  # last JSON line wins (the device bench's contract)
    if not line:
        raise RuntimeError(
            f"device bench emitted no record (rc={proc.returncode}): "
            f"{(proc.stderr or '')[-500:]}"
        )
    rec = json.loads(line)
    rec.update(
        schema=SCHEMA, rung=rung, measured_at_utc=_utcnow(),
        # the ledger lives in the child process; only in-process rungs
        # embed the stage breakdown
        ledger=None,
    )
    return rec


def _run_fabric_rung(
    timeout: float | None, hasher: str = "gpu", device=None
) -> dict:
    """The r7 scaling rung: 1/2/4-process fabric verify, median-of-3
    per process count, value = the 4-process GiB/s. The record embeds
    every leg's PER-PROCESS ledger/overlap breakdown (last rep) plus the
    fleet's two-level bottleneck verdict — the rate banks WITH its
    attribution, so a scaling regression names the process and stage
    that caused it. The legs run ``python -m
    torrent_tpu_torch.tools.bench_fabric`` with every worker on
    ``hasher`` and ``device`` (None means the card, resolved here before
    any leg starts); ``platform`` is ``cpu`` for hashlib, else the
    device type."""
    from torrent_tpu_torch.utils.device import resolve_device

    platform = "cpu" if hasher == "cpu" else resolve_device(device).type
    on = ["--device", str(device)] if device is not None else []
    results: dict[int, list[float]] = {}
    per_process: dict[str, list] = {}
    fleet_bottleneck: dict[str, dict | None] = {}
    with tempfile.TemporaryDirectory(prefix="tt_bench_fabric_") as work:
        for nproc in (1, 2, 4):
            proc = subprocess.run(
                [
                    sys.executable, "-m", "torrent_tpu_torch.tools.bench_fabric",
                    "--workdir", work,
                    "--nproc", str(nproc), "--reps", "3",
                    "--torrents", "8", "--mb-per-torrent", "64",
                    "--hasher", hasher, *on,
                ],
                cwd=_repo_root(), capture_output=True, text=True, timeout=timeout,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"fabric leg nproc={nproc} failed rc={proc.returncode}: "
                    f"{(proc.stderr or '')[-500:]}"
                )
            for out_line in (proc.stdout or "").splitlines():
                out_line = out_line.strip()
                if out_line.startswith("{"):
                    rec = json.loads(out_line)
                    results.setdefault(rec["nproc"], []).append(
                        rec["gib_per_sec"]
                    )
                    # last rep wins: one representative breakdown per leg
                    if rec.get("per_process"):
                        per_process[str(rec["nproc"])] = rec["per_process"]
                    if rec.get("fleet_bottleneck") is not None:
                        fleet_bottleneck[str(rec["nproc"])] = rec[
                            "fleet_bottleneck"
                        ]
    med = {n: round(statistics.median(v), 3) for n, v in sorted(results.items())}
    base = med.get(1)
    return {
        "schema": SCHEMA,
        "rung": "fabric",
        "metric": "fabric_scaling_gib_per_sec",
        "value": med.get(4),
        "unit": "GiB/s",
        "contract": "median-of-3",
        "scaling": {str(n): v for n, v in med.items()},
        "speedup_4p": round(med[4] / base, 2) if base and med.get(4) else None,
        "platform": platform,
        "batch": None,
        "measured_at_utc": _utcnow(),
        # subprocess rung: the parent's own ledger stays null, but the
        # per-worker breakdowns (and the fleet verdict) ride along
        "ledger": None,
        "per_process": per_process,
        "fleet_bottleneck": fleet_bottleneck,
    }


# ------------------------------------------------------------- comparator


def load_trajectory(path: str) -> list[dict]:
    """Records list from a trajectory file (``{"records": [...]}``,
    a bare list, or a single record dict). Missing file → []."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return []
    if isinstance(data, dict):
        recs = data.get("records")
        if isinstance(recs, list):
            return [r for r in recs if isinstance(r, dict)]
        return [data] if data.get("metric") else []
    if isinstance(data, list):
        return [r for r in data if isinstance(r, dict)]
    return []


# every field that defines a comparable measurement: the metric, the
# plane (platform), the launch shape (batch), the payload shape
# (piece_kb/bytes), and the host class (nproc — CPU-plane throughput
# scales with cores, and a workstation-banked record must not gate a
# smaller CI runner). Fields absent from BOTH records match vacuously,
# so device bench.py records (no piece_kb/nproc) keep their old key.
_LIKE_KEYS = ("metric", "platform", "batch", "piece_kb", "bytes", "nproc")


def like_for_like(records: list[dict], cand: dict) -> list[dict]:
    """Banked records the candidate may be gated against: identical
    measurement shape (:data:`_LIKE_KEYS`), value present, and not
    carrying a non-like-for-like shape caveat (the BENCH_CONFIGS_r05
    discipline)."""
    return [
        r
        for r in records
        if r.get("value") is not None
        and not r.get("non_like_for_like")
        and all(r.get(k) == cand.get(k) for k in _LIKE_KEYS)
    ]


def compare_record(
    cand: dict, records: list[dict], tolerance: float = DEFAULT_TOLERANCE
) -> tuple[int, str]:
    """(exit_code, message): 0 = within tolerance of the banked best or
    comparator unarmed (no like-for-like record); 1 = regression."""
    if cand.get("value") is None:
        return 1, "comparator: candidate record has no value (rung failed?)"
    eligible = like_for_like(records, cand)
    if not eligible:
        return 0, (
            f"comparator unarmed: no banked like-for-like record for "
            f"metric={cand.get('metric')!r} platform={cand.get('platform')!r} "
            f"batch={cand.get('batch')!r} (gate arms once one is banked)"
        )
    best = max(r["value"] for r in eligible)
    floor = best * (1.0 - tolerance)
    value = cand["value"]
    if value < floor:
        return 1, (
            f"REGRESSION: {cand['metric']} = {value} {cand.get('unit', '')} "
            f"< {floor:.1f} (banked best {best} − {tolerance:.0%} tolerance, "
            f"{len(eligible)} like-for-like record(s))"
        )
    verdict = "improves on" if value > best else "within tolerance of"
    return 0, (
        f"comparator ok: {cand['metric']} = {value} {cand.get('unit', '')} "
        f"{verdict} banked best {best}"
    )


def bank_record(cand: dict, path: str) -> None:
    """Append the record to the trajectory file (atomic write; creates
    the file with the trajectory schema when missing). History is kept —
    the comparator gates against the best like-for-like value."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        data = {"schema": TRAJECTORY_SCHEMA, "records": []}
    if isinstance(data, list):
        data = {"schema": TRAJECTORY_SCHEMA, "records": data}
    data.setdefault("records", []).append(cand)
    data["banked_at_utc"] = _utcnow()
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


# -------------------------------------------------------------------- cli


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="torrent-tpu bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "rung", nargs="?", choices=RUNGS,
        help="named rung to run (smoke/e2e/v2/fabric/flagship/"
        "controller/announce/swarm/scenario/seed)",
    )
    ap.add_argument(
        "--smoke", action="store_true",
        help="alias for the smoke rung (the CI spelling)",
    )
    ap.add_argument(
        "--mb", type=int, default=8,
        help="smoke/e2e rungs: payload MiB (default %(default)s)",
    )
    ap.add_argument(
        "--piece-kb", type=int, default=256,
        help="smoke/e2e rungs: piece size KiB (default %(default)s)",
    )
    ap.add_argument(
        "--batch-target", type=int, default=32,
        help="smoke/e2e rungs: scheduler pieces-per-launch target",
    )
    ap.add_argument(
        "--hasher", default="gpu", choices=("gpu", "cpu"),
        help="e2e/swarm/seed rungs: hash plane (default %(default)s: the "
        "kernels on --device; 'cpu' is hashlib)",
    )
    ap.add_argument(
        "--device", default=None,
        help="torch device of --hasher gpu and of the device rungs "
        "(default: cuda; 'cpu' runs the kernels' plain versions)",
    )
    ap.add_argument(
        "--clients", type=int, default=8,
        help="announce rung: concurrent announcer threads "
        "(default %(default)s)",
    )
    ap.add_argument(
        "--swarms", type=int, default=32,
        help="announce rung: distinct info-hashes stormed "
        "(default %(default)s)",
    )
    ap.add_argument(
        "--per-client", type=int, default=2000,
        help="announce rung: announces per client per rep "
        "(default %(default)s)",
    )
    ap.add_argument(
        "--shards", type=int, default=8,
        help="announce rung: store shard count (default %(default)s)",
    )
    ap.add_argument(
        "--numwant", type=int, default=30,
        help="announce rung: peers requested per announce "
        "(default %(default)s)",
    )
    ap.add_argument(
        "--leechers", type=int, default=64,
        help="seed rung: concurrent raw-wire loopback leechers "
        "(default %(default)s)",
    )
    ap.add_argument(
        "--occupancy", type=int, default=1_000_000,
        help="scenario rung: swarms pre-filled into the store before "
        "the churn-storm scenario runs (default %(default)s)",
    )
    ap.add_argument(
        "--timeout", type=float, default=None,
        help="device-rung subprocess timeout seconds (default: none)",
    )
    ap.add_argument("--out", default=None, help="also write the record here")
    ap.add_argument(
        "--record", default=None, metavar="FILE",
        help="skip the run; compare/bank this existing record instead",
    )
    ap.add_argument(
        "--compare", action="store_true",
        help="gate the record against the banked trajectory",
    )
    ap.add_argument(
        "--trajectory", default=None, metavar="FILE",
        help="trajectory file (default: TORRENT_TPU_BENCH_TRAJECTORY or "
        "BENCH_trajectory_cuda.json in the cwd)",
    )
    ap.add_argument(
        "--tolerance", type=float, default=DEFAULT_TOLERANCE,
        help="allowed fractional regression vs the banked best "
        "(default %(default)s)",
    )
    ap.add_argument(
        "--report-only", action="store_true",
        help="comparator reports but never fails the run",
    )
    ap.add_argument(
        "--bank", action="store_true",
        help="append the record to the trajectory file (self-banking)",
    )
    args = ap.parse_args(argv)

    rung = args.rung
    if args.smoke:
        if rung not in (None, "smoke"):
            print("error: --smoke conflicts with an explicit rung",
                  file=sys.stderr)
            return 2
        rung = "smoke"
    if rung is None and args.record is None:
        print("error: name a rung (smoke/e2e/v2/fabric/flagship/controller/"
              "announce/swarm/scenario/seed) or pass --record FILE",
              file=sys.stderr)
        return 2
    if rung == "announce" and (
        args.shards < ANNOUNCE_MIN_SHARDS_HIT
        or args.swarms < ANNOUNCE_MIN_SHARDS_HIT
    ):
        # refuse upfront instead of running a storm guaranteed to fail
        # the >=4-shards acceptance floor with a misleading null-value
        # error at the end
        print(
            f"error: the announce rung's banked rate must come from "
            f">= {ANNOUNCE_MIN_SHARDS_HIT} concurrently exercised shards; "
            f"--shards and --swarms must both be >= "
            f"{ANNOUNCE_MIN_SHARDS_HIT} (got --shards {args.shards} "
            f"--swarms {args.swarms})",
            file=sys.stderr,
        )
        return 2

    if args.record is not None:
        try:
            with open(args.record) as f:
                record = json.load(f)
        except (OSError, ValueError) as e:
            print(f"error: cannot read record {args.record!r}: {e}",
                  file=sys.stderr)
            return 2
    else:
        try:
            if rung == "smoke":
                record = asyncio.run(
                    _smoke(args.mb, args.piece_kb, args.batch_target)
                )
            elif rung == "e2e":
                record = asyncio.run(
                    _e2e(args.mb, args.piece_kb, args.batch_target, args.hasher,
                         args.device)
                )
            elif rung == "controller":
                record = asyncio.run(
                    _controller_ab(args.mb, args.piece_kb, args.batch_target)
                )
            elif rung == "announce":
                record = asyncio.run(
                    _announce_storm(
                        args.clients, args.swarms, args.per_client,
                        args.shards, args.numwant,
                    )
                )
            elif rung == "swarm":
                record = asyncio.run(
                    _swarm_rung(args.mb, args.piece_kb, args.hasher, args.device)
                )
            elif rung == "seed":
                record = asyncio.run(
                    _seed_rung(args.mb, args.piece_kb, args.leechers,
                               args.hasher, args.device)
                )
            elif rung == "scenario":
                record = _scenario_rung(args.occupancy, args.shards)
            elif rung == "fabric":
                record = _run_fabric_rung(args.timeout, args.hasher, args.device)
            else:
                record = _run_bench_py(rung, args.timeout, args.device)
        except (RuntimeError, FileNotFoundError,
                subprocess.TimeoutExpired) as e:
            print(f"error: rung {rung!r} failed: {e}", file=sys.stderr)
            return 1
        line = json.dumps(record, sort_keys=True)
        print(line)
        if args.out:
            tmp = args.out + ".tmp"
            with open(tmp, "w") as f:
                f.write(line + "\n")
            os.replace(tmp, args.out)

    rc = 0
    if record.get("value") is None and not args.report_only:
        print("bench: record value is null (device unavailable or rung "
              "failed)", file=sys.stderr)
        rc = 1

    trajectory_path = args.trajectory or default_trajectory_path()
    if args.bank and record.get("value") is not None:
        bank_record(record, trajectory_path)
        print(f"banked into {trajectory_path}", file=sys.stderr)
    if args.compare:
        code, message = compare_record(
            record, load_trajectory(trajectory_path), args.tolerance
        )
        print(message, file=sys.stderr)
        if code and not args.report_only:
            rc = max(rc, code)
    return rc


if __name__ == "__main__":  # pragma: no cover - manual entrypoint
    sys.exit(main())
