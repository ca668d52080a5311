"""The scenario runner: a spec, a world, a verdict.

``run_scenario(spec)`` builds a real serve stack in process — sharded
tracker store, DHT node (driven transportless through its datagram
path), DHT indexer feeding the store, BEP 33 blooms wired into scrape —
and steps the spec's actor population against it on a VIRTUAL timeline:
one tick advances the injected clock by ``tick_ms``, every timestamp
the stack takes routes through that clock, and every random draw
routes through one ``random.Random(spec.seed)``. Same spec + same seed
⇒ bit-identical canonical verdict and timeline, byte for byte.

Two planes, deliberately separated:

* **Deterministic plane** — the timeline ring (``obs.timeline
  .build_sample`` per tick), the SLO evaluation over it, the behavior
  facts and invariant failures, and the occupancy reconciliation. This
  is the replayable artifact; doctor diffs two same-seed runs of it.
* **Wall plane** — real ``perf_counter`` latency of every store
  announce, rendered as its own error-budget statement against the
  spec's ``wall_p99_ms``. Wall numbers vary run to run by nature, so
  they live under the verdict's ``"wall"`` key, which
  ``scenario.verdict.canonical_verdict`` strips before any bit-identity
  comparison.

The engine's own shared state (world counters, the conviction ledger)
sits behind ``utils.locks.named_lock`` + ``guard_attrs`` like every
other plane (plain locks and no-op cells until the sanitizer is ported).
"""

from __future__ import annotations

import hashlib
import random
import time
from bisect import bisect_left

from torrent_tpu_torch.utils.locks import guard_attrs, named_lock
from torrent_tpu_torch.codec.bencode import BencodeError, bdecode
from torrent_tpu_torch.net.dht import DHTNode
from torrent_tpu_torch.net.indexer import DhtIndexer
from torrent_tpu_torch.net.types import AnnounceEvent
from torrent_tpu_torch.obs.hist import BUCKET_BOUNDS
from torrent_tpu_torch.obs.slo import evaluate_slo, parse_objectives
from torrent_tpu_torch.obs.timeline import Timeline, build_sample
from torrent_tpu_torch.scenario.actors import build_behaviors
from torrent_tpu_torch.scenario.spec import ScenarioSpec
from torrent_tpu_torch.scenario.verdict import build_verdict
from torrent_tpu_torch.server.shard import ShardedSwarmStore
from torrent_tpu_torch.utils.log import get_logger

log = get_logger("scenario.engine")

CONVICT_STRIKES = 3  # digest failures before the sentinel convicts
WALL_SLO_CHUNKS = 8  # wall-latency samples fed to the wall-plane SLO


class VirtualClock:
    """The injected timeline: ``clock()`` is a plain callable (the
    ``time.monotonic`` drop-in the store/indexer seams take) that only
    moves when the engine says so."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def advance(self, dt: float) -> None:
        self._now += dt


class World:
    """Everything the behaviors touch, with the engine's shared counters
    behind one leaf lock (the store and DHT node guard themselves)."""

    def __init__(self, spec: ScenarioSpec, store: ShardedSwarmStore,
                 clock: VirtualClock, rng: random.Random):
        self.spec = spec
        self.store = store
        self.clock = clock
        self.rng = rng
        self.tick = 0
        # the server-side reply bound every sybil reply is checked against
        self.clamp_cap = min(store.max_numwant, store.max_reply_bytes // 18)
        # world counters: one cell, one leaf lock — tsan-lite learns the
        # association and flags any unguarded touch
        self._lock = named_lock("scenario.engine._lock")
        self._cells = guard_attrs("scenario.world", "counters")
        self.ok = 0  # availability events (served announces/pieces/conns)
        self.shed = 0  # availability errors: refused connections
        self.failed = 0  # availability errors: failed pieces
        self.poison_rejected = 0
        self.poison_escapes = 0
        self.false_convictions = 0
        self.forged_accepted = 0
        self.strikes: dict[str, int] = {}
        self.convicted: set[str] = set()
        self.scripted_poisoners: set[str] = set()
        # presence ledger: (info_hash, peer_id) -> last announce virtual
        # time; STOPPED removes — the exact-occupancy oracle
        self.presence: dict[tuple[bytes, bytes], float] = {}
        self.wall: list[float] = []  # real seconds per announce (wall plane)
        # transportless DHT: replies are captured, never sent
        self.node = DHTNode(
            node_id=hashlib.sha1(f"scn-node:{spec.name}".encode()).digest(),
            read_only=False,
        )
        self._dht_out: list[tuple[bytes, tuple]] = []
        self.node._sendto = lambda data, addr: self._dht_out.append(
            (data, addr)
        )
        self.indexer = DhtIndexer(self.node, store, clock=clock)
        store.attach_bloom_source(self.indexer.blooms_for)
        # presence must also see DHT-fed peers: wrap the seed seam the
        # indexer drives so the occupancy oracle stays exact
        inner_seed = store.seed_peer

        def seed_peer(info_hash, ip, port, left=0, peer_id=None):
            inner_seed(info_hash, ip, port, left=left, peer_id=peer_id)
            pid = peer_id if peer_id is not None else (
                b"-IX-" + hashlib.sha1(f"{ip}:{port}".encode()).digest()[:16]
            )
            with self._lock:
                self._cells.write("counters")
                self.presence[(info_hash, pid)] = self.clock()

        store.seed_peer = seed_peer

    # ----------------------------------------------------------- announce

    def announce(self, info_hash, peer_id, ip, port, left, event, numwant):
        t0 = time.perf_counter()
        out = self.store.announce(
            info_hash, peer_id, ip, port, left, event, numwant
        )
        self.wall.append(time.perf_counter() - t0)
        with self._lock:
            self._cells.write("counters")
            self.ok += 1
            key = (info_hash, peer_id)
            if event == AnnounceEvent.STOPPED:
                self.presence.pop(key, None)
            else:
                self.presence[key] = self.clock()
        return out

    # ----------------------------------------------------------- sentinel

    def submit_piece(self, key: str, payload: bytes, digest: bytes) -> bool:
        """Digest-verified piece ingestion with strike-based conviction
        — the sentinel/distrust plane in the scenario world. Returns
        whether the piece was accepted."""
        valid = hashlib.sha1(payload).digest() == digest
        with self._lock:
            self._cells.write("counters")
            if key in self.convicted:
                return False  # convicted submitters are dropped outright
            if valid:
                if key in self.scripted_poisoners:
                    # defense-in-depth accounting: a poisoner's piece
                    # passing verification would be an escape
                    self.poison_escapes += 1
                self.ok += 1
                return True
            self.poison_rejected += 1
            self.strikes[key] = self.strikes.get(key, 0) + 1
            if self.strikes[key] >= CONVICT_STRIKES:
                self.convicted.add(key)
                if key not in self.scripted_poisoners:
                    self.false_convictions += 1
            return False

    # ----------------------------------------------------------- counters

    def record_ok(self, n: int = 1) -> None:
        with self._lock:
            self._cells.write("counters")
            self.ok += n

    def record_shed(self, n: int = 1) -> None:
        with self._lock:
            self._cells.write("counters")
            self.shed += n

    def record_failed(self, n: int = 1) -> None:
        with self._lock:
            self._cells.write("counters")
            self.failed += n

    def record_forged_accepted(self, n: int = 1) -> None:
        with self._lock:
            self._cells.write("counters")
            self.forged_accepted += n

    # ---------------------------------------------------------------- dht

    def datagram(self, data: bytes, addr: tuple) -> list[dict]:
        """One raw datagram into the DHT node; returns the decoded
        replies it produced (the captured ``_sendto`` traffic)."""
        del self._dht_out[:]
        self.node._on_datagram(data, addr)
        out = []
        for raw, _to in self._dht_out:
            try:
                msg = bdecode(raw)
            except BencodeError:
                continue
            if isinstance(msg, dict):
                out.append(msg)
        return out

    # ------------------------------------------------------------ samples

    def distrust_count(self) -> int:
        with self._lock:
            self._cells.read("counters")
            return (
                self.poison_escapes
                + self.false_convictions
                + self.forged_accepted
            )

    def sched_snap(self) -> dict:
        with self._lock:
            self._cells.read("counters")
            return {
                "shed_total": self.shed,
                "failed_pieces": self.failed,
                "tenants": {"scenario": {"served_pieces": self.ok}},
            }


def _percentile(values: list[float], q: float) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    idx = min(len(ordered) - 1, max(0, int(q * (len(ordered) - 1) + 0.5)))
    return ordered[idx]


def _wall_report(spec: ScenarioSpec, wall: list[float]) -> dict:
    """The wall plane: measured announce latency vs the spec's budget,
    rendered through the SAME SLO machinery as the deterministic plane
    (synthetic cumulative-histogram samples, ``p99_ms=<budget>:request``
    objective) so the outcome is an error-budget statement too."""
    n = len(wall)
    total = sum(wall)
    p99 = _percentile(wall, 0.99)
    # cumulative log2-histogram progression, chunked so the SLO windows
    # have a delta to work with
    counts = [0] * (len(BUCKET_BOUNDS) + 1)
    running_count = 0
    running_sum = 0.0
    samples = [{"t": 0.0, "hist": {"request": {
        "count": 0, "sum": 0.0, "buckets": {}}}}]
    chunk = max(1, n // WALL_SLO_CHUNKS)
    for start in range(0, n, chunk):
        for v in wall[start:start + chunk]:
            counts[bisect_left(BUCKET_BOUNDS, v)] += 1
            running_count += 1
            running_sum += v
        samples.append({
            "t": float(len(samples)),
            "hist": {"request": {
                "count": running_count,
                "sum": running_sum,
                "buckets": {
                    str(i): c for i, c in enumerate(counts) if c
                },
            }},
        })
    objectives = parse_objectives(f"p99_ms={spec.wall_p99_ms}:request")
    slo = evaluate_slo(
        samples, objectives,
        short_samples=len(samples), long_samples=len(samples),
    )
    budget_s = spec.wall_p99_ms / 1e3
    return {
        "announces": n,
        "total_s": round(total, 6),
        "p50_us": round(_percentile(wall, 0.50) * 1e6, 1),
        "p99_us": round(p99 * 1e6, 1),
        "max_us": round(max(wall) * 1e6, 1) if wall else 0.0,
        "announces_per_s": round(n / total, 1) if total > 0 else 0.0,
        "budget_ms": spec.wall_p99_ms,
        "slo": slo,
        "ok": bool(p99 <= budget_s and not slo.get("breach_any")),
    }


def run_scenario(
    spec: ScenarioSpec,
    store: ShardedSwarmStore | None = None,
) -> dict:
    """Run one scenario to its verdict.

    Returns ``{"verdict", "timeline", "wall"}``: the SLO verdict (see
    ``scenario/verdict.py``), the full timeline ring snapshot (the
    ``torrent-tpu replay`` payload), and the wall-plane latency report.

    ``store`` may be a pre-filled :class:`ShardedSwarmStore` — the
    bench rung fills one with a million swarms first — but it MUST have
    been built with a :class:`VirtualClock` and a seeded rng; the
    engine adopts them so the virtual timeline stays coherent.
    """
    if store is None:
        clock = VirtualClock(float(spec.peer_ttl_s) + 1.0)
        rng = random.Random(spec.seed)
        store = ShardedSwarmStore(
            n_shards=spec.shards,
            peer_ttl=float(spec.peer_ttl_s),
            clock=clock,
            rng=rng,
        )
    else:
        clock = store._clock
        rng = store._rng
        if not isinstance(clock, VirtualClock) or not isinstance(
            rng, random.Random
        ):
            raise ValueError(
                "a pre-built scenario store needs clock=VirtualClock(...) "
                "and rng=random.Random(seed)"
            )
    world = World(spec, store, clock, rng)
    behaviors = build_behaviors(spec)
    for b in behaviors:
        b.setup(world)

    timeline = Timeline(depth=spec.ticks + 4)

    def push_sample() -> None:
        snap = store.metrics_snapshot()
        timeline.push(
            build_sample(
                clock(),
                {},
                sched_snap=world.sched_snap(),
                tracker={
                    "announces": snap["announces"],
                    "peers": snap["peers"],
                    "swarms": snap["swarms"],
                },
                distrust=world.distrust_count(),
            )
        )

    push_sample()  # the t0 baseline every window delta starts from
    tick_s = spec.tick_ms / 1e3
    for tick in range(spec.ticks):
        world.tick = tick
        for b in behaviors:
            b.step(world)
        store.sweep_one()
        clock.advance(tick_s)
        push_sample()

    # end of run: full expiry pass, then the exact-occupancy oracle —
    # the tracker's population must equal the presence ledger's fresh
    # entries, no more (ghost leaks) and no less (over-eviction)
    store.sweep()
    cutoff = clock() - store.peer_ttl
    expected = sum(1 for t in world.presence.values() if t >= cutoff)
    snap = store.metrics_snapshot()
    failures: list[str] = []
    if snap["peers"] != expected:
        failures.append(
            f"occupancy reconciliation failed: tracker holds "
            f"{snap['peers']} peers, presence ledger expects {expected}"
        )
    for b in behaviors:
        failures.extend(b.failures(world))

    timeline_snap = timeline.snapshot()
    slo_report = evaluate_slo(
        timeline_snap["samples"],
        spec.objectives(),
        short_samples=spec.short_samples,
        long_samples=spec.long_samples,
    )
    facts = {
        "population": spec.population(),
        "occupancy": {"expected": expected, "actual": snap["peers"]},
        "tracker": {
            "announces": snap["announces"],
            "swarms": snap["swarms"],
            "peers": snap["peers"],
            "evicted": snap["evicted"],
            "indexed": snap["indexed"],
            "numwant_clamped": snap["numwant_clamped"],
            "scrapes": snap["scrapes"],
        },
        "counters": {
            "ok": world.ok,
            "shed": world.shed,
            "failed": world.failed,
            "poison_rejected": world.poison_rejected,
            "poison_escapes": world.poison_escapes,
            "false_convictions": world.false_convictions,
            "forged_accepted": world.forged_accepted,
            "convicted": len(world.convicted),
        },
        "behaviors": {
            f"{b.kind}[{b.gi}]": b.facts(world) for b in behaviors
        },
    }
    verdict = build_verdict(spec, slo_report, facts, failures)
    verdict["wall"] = _wall_report(spec, world.wall)

    # stream into the shared obs plane: announce latency joins the real
    # tracker histogram family, and a failed scenario freezes a flight
    # dump exactly like a production SLO breach would
    if world.wall:
        from torrent_tpu_torch.obs.hist import histograms

        histograms().get(
            "torrent_tpu_tracker_announce_seconds",
            help="Tracker announce handle latency (receive to reply)",
            transport="scenario",
        ).observe_batch(world.wall)
    if not verdict["pass"]:
        from torrent_tpu_torch.obs.recorder import flight_recorder

        flight_recorder().trigger(
            "scenario_fail",
            detail={
                "scenario": spec.name,
                "seed": spec.seed,
                "reasons": verdict["reasons"][:8],
            },
        )
    return {"verdict": verdict, "timeline": timeline_snap, "wall": verdict["wall"]}
