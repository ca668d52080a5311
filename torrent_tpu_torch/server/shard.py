"""Sharded announce plane: the production-scale tracker service.

``server/in_memory.py`` is the reference policy layer — one dict, one
pump, O(swarm) peer-list scans. This module is the scale-out rewrite a
tracker serving millions of users needs:

* **Swarm state sharded by info-hash** across N independent shards.
  Each shard owns its swarms behind its own
  ``utils.locks.named_lock`` — there is NO global lock, and shard
  locks are *leaves* of the lock-order graph: nothing (not even another
  shard's lock) is ever acquired while one is held. Cross-shard
  aggregation (metrics, scrape, sweeps) takes locks strictly
  sequentially.
* **Reservoir-sampled peer lists.** Every swarm keeps a swap-remove
  index array beside its peer dict, so assembling a ``numwant`` reply is
  O(numwant) random draws — never an O(swarm) scan. A two-million-peer
  swarm answers as fast as a two-peer one.
* **Server-side reply bounds.** ``numwant`` is clamped against both a
  hard cap and a compact-reply byte budget (one unfragmented UDP
  datagram), and scrapes are capped per request — a hostile announce can
  never make the tracker assemble an unbounded response.
* **Batched announce processing.** ``announce_batch`` groups a drained
  datagram/request queue by shard and processes each shard's group under
  ONE lock acquisition; ``run_sharded_tracker``'s pump drains the
  transport queue and replies in bulk.
* **Per-shard TTL sweeps.** ``sweep_one`` expires one shard per tick
  (round-robin), so expiry cost is amortized instead of a periodic
  full-store stall.
* **Persistent-tracker seeding.** ``seed_peer`` lets the DHT indexer
  (``net/indexer.py``) feed harvested ``announce_peer`` traffic into the
  store, so the tracker answers for swarms it learned from the DHT —
  the "Persistent BitTorrent Trackers" semantics from PAPERS.md.

Observability: ``metrics_snapshot()`` feeds
``utils.metrics.render_tracker_metrics`` (``torrent_tpu_tracker_*``
series), and the service observes per-announce latency into the shared
log2 histogram registry (family
``torrent_tpu_tracker_announce_seconds``), rendered alongside the other
obs families. The tracker's own HTTP listener serves ``/metrics``.
"""

from __future__ import annotations

import asyncio
import hashlib
import random
import time
from dataclasses import dataclass, field

from torrent_tpu_torch.utils.locks import guard_attrs, named_lock
from torrent_tpu_torch.net.constants import DEFAULT_ANNOUNCE_INTERVAL, DEFAULT_NUM_WANT
from torrent_tpu_torch.net.types import AnnounceEvent, AnnouncePeer
from torrent_tpu_torch.server.tracker import (
    AnnounceRequest,
    ScrapeRequest,
    ServeOptions,
    TrackerServer,
    serve_tracker,
)
from torrent_tpu_torch.utils.log import get_logger

log = get_logger("server.shard")

DEFAULT_SHARDS = 8
PEER_TTL = 15 * 60  # same idle horizon as the reference tracker
SWEEP_TICK = 60.0  # one shard expired per tick (full cycle = N ticks)
# server-side reply bounds (satellite: never assemble unbounded replies)
MAX_NUM_WANT = 200
# compact-reply peer budget: v6 entries are 18 B and the whole reply must
# stay inside one unfragmented UDP datagram alongside the KRPC/announce
# framing, whatever family mix the sample draws
MAX_REPLY_BYTES = 1200
MAX_SCRAPE_HASHES = 64
MAX_BATCH = 256  # transport-queue drain bound per pump cycle
# /v1/health readiness: the pump stamps every cycle and an idle queue
# wakes it at least every 5 s, so a stamp older than this means the
# drive loop is wedged (not merely idle)
PUMP_MAX_AGE_S = 30.0


class _PeerRec:
    """One swarm member. ``idx`` is its slot in the swarm's swap-remove
    sampling array — removal is O(1), sampling O(numwant)."""

    __slots__ = ("peer_id", "ip", "port", "left", "last_seen", "idx")

    def __init__(self, peer_id: bytes, ip: str, port: int, left: int,
                 last_seen: float, idx: int):
        self.peer_id = peer_id
        self.ip = ip
        self.port = port
        self.left = left
        self.last_seen = last_seen
        self.idx = idx

    @property
    def is_seeder(self) -> bool:
        return self.left == 0


class _Swarm:
    __slots__ = ("complete", "downloaded", "incomplete", "peers", "order",
                 "seeded_from", "last_active")

    def __init__(self):
        self.complete = 0  # current seeders
        self.downloaded = 0  # lifetime completions
        self.incomplete = 0  # current leechers
        self.peers: dict[bytes, _PeerRec] = {}
        self.order: list[bytes] = []  # sampling array (swap-remove)
        self.seeded_from: str | None = None  # "dht" when indexer-created
        self.last_active = 0.0  # last announce/seed (bounds ghost retention)


class _Shard:
    """One independent slice of the swarm space. The lock is a LEAF:
    every critical section below is pure dict/list work — no calls that
    could acquire another lock, no IO, no device work."""

    __slots__ = ("_shard_lock", "swarms", "peers", "announces", "evicted",
                 "indexed", "clamped", "_cells")

    def __init__(self):
        self._shard_lock = named_lock("server.shard._shard_lock")
        # dynamic lockset checking: the shard's whole mutable blob
        # (swarms + counters) is one cell guarded by _shard_lock
        self._cells = guard_attrs("server.shard", "stats")
        self.swarms: dict[bytes, _Swarm] = {}
        # incremental peer count (maintained on insert/remove) so the
        # metrics snapshot never walks all swarms under the shard lock
        self.peers = 0
        self.announces = 0
        self.evicted = 0
        self.indexed = 0  # peers fed by the DHT indexer
        self.clamped = 0  # numwant requests clamped by the reply bounds


@dataclass
class AnnounceOutcome:
    """One processed announce, ready for any transport's ``respond``."""

    interval: int
    complete: int
    incomplete: int
    peers: list[AnnouncePeer] = field(default_factory=list)


class ShardedSwarmStore:
    """Swarm state sharded by info-hash; every method is thread-safe and
    lock-leaf (see module docstring)."""

    def __init__(
        self,
        n_shards: int = DEFAULT_SHARDS,
        interval: int = DEFAULT_ANNOUNCE_INTERVAL,
        peer_ttl: float = PEER_TTL,
        max_numwant: int = MAX_NUM_WANT,
        max_reply_bytes: int = MAX_REPLY_BYTES,
        clock=time.monotonic,
        rng: random.Random | None = None,
    ):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = n_shards
        self.interval = interval
        self.peer_ttl = peer_ttl
        self.max_numwant = max_numwant
        self.max_reply_bytes = max_reply_bytes
        # determinism seams: every timestamp (peer last_seen, TTL
        # cutoffs) and every reservoir draw routes through these, so a
        # scenario run with a virtual clock + seeded rng is replayable
        # bit-for-bit (scenario/engine.py); production defaults unchanged
        self._clock = clock
        self._rng: random.Random = rng if rng is not None else random  # type: ignore[assignment]
        # BEP 33 seam: info_hash -> (seed_bloom, peer_bloom) | None,
        # consulted by scrape() for swarms the tracker has never seen an
        # announce for (DHT-harvested knowledge only lives as blooms)
        self._bloom_source = None
        self._shards = [_Shard() for _ in range(n_shards)]
        self._sweep_cursor = 0
        # store-level counters (scrapes/batches span shards); leaf lock,
        # never held while a shard lock is taken or vice versa
        self._stats_lock = named_lock("server.shard._stats_lock")
        self._stats_cells = guard_attrs("server.store", "stats")
        self._scrapes = 0
        self._batches = 0
        self._batched_announces = 0
        self._batch_max = 0

    # ------------------------------------------------------------ routing

    def shard_of(self, info_hash: bytes) -> int:
        """Info-hash → shard index. The hash IS the distribution: BEP 3
        info-hashes are uniform sha1 output, so the top bytes spread
        swarms evenly without rehashing."""
        return int.from_bytes(info_hash[:4], "big") % self.n_shards

    def clamp_numwant(self, numwant: int | None) -> tuple[int, bool]:
        """(effective numwant, was_clamped): negative/absent means the
        BEP default; everything is bounded by the hard cap AND the
        compact-reply byte budget (18 B/peer worst case — v6)."""
        want = DEFAULT_NUM_WANT if numwant is None or numwant < 0 else numwant
        cap = min(self.max_numwant, self.max_reply_bytes // 18)
        return min(want, cap), want > cap

    # ----------------------------------------------------------- announce

    def announce(
        self,
        info_hash: bytes,
        peer_id: bytes,
        ip: str,
        port: int,
        left: int,
        event: AnnounceEvent = AnnounceEvent.EMPTY,
        numwant: int | None = None,
    ) -> AnnounceOutcome:
        shard = self._shards[self.shard_of(info_hash)]
        want, clamped = self.clamp_numwant(numwant)
        now = self._clock()
        with shard._shard_lock:
            shard._cells.write("stats")
            shard.announces += 1
            if clamped:
                shard.clamped += 1
            return self._announce_locked(
                shard, info_hash, peer_id, ip, port, left, event, want, now
            )

    def announce_batch(self, items: list[tuple]) -> list[AnnounceOutcome]:
        """Process many announces with ONE lock acquisition per shard.

        ``items`` are ``(info_hash, peer_id, ip, port, left, event,
        numwant)`` tuples; outcomes come back in input order. This is
        the bulk path the UDP pump drains into: contention cost is paid
        per *shard group*, not per datagram.
        """
        by_shard: dict[int, list[int]] = {}
        for i, it in enumerate(items):
            by_shard.setdefault(self.shard_of(it[0]), []).append(i)
        out: list[AnnounceOutcome | None] = [None] * len(items)
        now = self._clock()
        for si in sorted(by_shard):
            shard = self._shards[si]
            idxs = by_shard[si]
            with shard._shard_lock:
                shard._cells.write("stats")
                shard.announces += len(idxs)
                for i in idxs:
                    ih, pid, ip, port, left, event, numwant = items[i]
                    want, clamped = self.clamp_numwant(numwant)
                    if clamped:
                        shard.clamped += 1
                    out[i] = self._announce_locked(
                        shard, ih, pid, ip, port, left, event, want, now
                    )
        with self._stats_lock:
            self._stats_cells.write("stats")
            self._batches += 1
            self._batched_announces += len(items)
            self._batch_max = max(self._batch_max, len(items))
        return out  # type: ignore[return-value]

    def _announce_locked(
        self, shard: _Shard, info_hash: bytes, peer_id: bytes, ip: str,
        port: int, left: int, event: AnnounceEvent, want: int, now: float,
    ) -> AnnounceOutcome:
        swarm = shard.swarms.get(info_hash)
        if event == AnnounceEvent.STOPPED:
            # never get-or-create on STOPPED: a hostile loop of stops for
            # random hashes must not allocate ghost swarms
            if swarm is None:
                return AnnounceOutcome(self.interval, 0, 0, [])
            prev = swarm.peers.get(peer_id)
            if prev is not None:
                self._remove_locked(swarm, prev)
                shard.peers -= 1
            return AnnounceOutcome(
                self.interval, swarm.complete, swarm.incomplete, []
            )
        if swarm is None:
            swarm = shard.swarms[info_hash] = _Swarm()
        swarm.last_active = now
        prev = swarm.peers.get(peer_id)

        now_seeder = left == 0
        if prev is None:
            rec = _PeerRec(peer_id, ip, port, left, now, len(swarm.order))
            swarm.order.append(peer_id)
            swarm.peers[peer_id] = rec
            shard.peers += 1
            if now_seeder:
                swarm.complete += 1
            else:
                swarm.incomplete += 1
            if event == AnnounceEvent.COMPLETED and now_seeder:
                swarm.downloaded += 1
        else:
            if prev.is_seeder != now_seeder:
                if now_seeder:  # leecher → seeder promotion
                    swarm.incomplete -= 1
                    swarm.complete += 1
                    swarm.downloaded += 1
                else:
                    swarm.complete -= 1
                    swarm.incomplete += 1
            elif event == AnnounceEvent.COMPLETED and now_seeder:
                swarm.downloaded += 1
            prev.ip, prev.port, prev.left, prev.last_seen = ip, port, left, now
        peers = self._sample_locked(swarm, peer_id, want, now)
        return AnnounceOutcome(
            self.interval, swarm.complete, swarm.incomplete, peers
        )

    def _remove_locked(self, swarm: _Swarm, rec: _PeerRec) -> None:
        """O(1) swap-remove from both the dict and the sampling array."""
        last_pid = swarm.order[-1]
        swarm.order[rec.idx] = last_pid
        swarm.peers[last_pid].idx = rec.idx
        swarm.order.pop()
        del swarm.peers[rec.peer_id]
        if rec.is_seeder:
            swarm.complete -= 1
        else:
            swarm.incomplete -= 1

    def _sample_locked(
        self, swarm: _Swarm, exclude: bytes, n: int, now: float
    ) -> list[AnnouncePeer]:
        """Up to ``n`` random peers excluding the requester, O(n) draws
        on the swap-remove array — never a full-swarm scan. Peers past
        the TTL are skipped (not served while they await their shard's
        sweep turn); a draw hitting one simply yields a shorter reply."""
        order = swarm.order
        if n <= 0 or not order:
            return []
        cutoff = now - self.peer_ttl
        extra = 1 if exclude in swarm.peers else 0
        if len(order) <= n + extra:
            return [
                AnnouncePeer(ip=p.ip, port=p.port, peer_id=pid)
                for pid, p in swarm.peers.items()
                if pid != exclude and p.last_seen >= cutoff
            ][:n]
        out: list[AnnouncePeer] = []
        for i in self._rng.sample(range(len(order)), min(len(order), n + extra)):
            pid = order[i]
            if pid == exclude:
                continue
            p = swarm.peers[pid]
            if p.last_seen < cutoff:
                continue
            out.append(AnnouncePeer(ip=p.ip, port=p.port, peer_id=pid))
            if len(out) == n:
                break
        return out

    # ------------------------------------------------------------- scrape

    def attach_bloom_source(self, fn) -> None:
        """Wire a BEP 33 bloom provider (``net.indexer.DhtIndexer
        .blooms_for``): ``fn(info_hash) -> (seed_bloom, peer_bloom) |
        None``. Scrapes for swarms the tracker holds NO peer state for
        fall back to bloom cardinality estimates, so DHT-harvested
        swarms scrape as populations instead of zeros while costing the
        store 0 bytes per swarm. Called OUTSIDE every shard lock (the
        provider owns its own state)."""
        self._bloom_source = fn

    def scrape(self, info_hashes: list[bytes]) -> list[tuple]:
        """(info_hash, complete, downloaded, incomplete) per hash.
        Unknown hashes scrape as zeros — unless a BEP 33 bloom source is
        attached, in which case they scrape as the blooms' cardinality
        estimates (seeders from BFsd, leechers from BFpe); the request
        is CAPPED — an unbounded batch is truncated, and an empty
        scrape returns per-swarm totals only up to the cap."""
        hashes = info_hashes[:MAX_SCRAPE_HASHES]
        if not hashes:
            # empty scrape = "everything": bounded walk, shard by shard.
            # islice, never list(swarms) — materializing a huge shard's
            # key list under its lock would stall every announce on it
            from itertools import islice

            for shard in self._shards:
                with shard._shard_lock:
                    hashes.extend(
                        islice(shard.swarms, MAX_SCRAPE_HASHES - len(hashes))
                    )
                if len(hashes) >= MAX_SCRAPE_HASHES:
                    break
        with self._stats_lock:
            self._stats_cells.write("stats")
            self._scrapes += 1
        out = []
        unknown: list[int] = []  # out-indices to try the bloom source on
        for h in hashes:
            shard = self._shards[self.shard_of(h)]
            with shard._shard_lock:
                swarm = shard.swarms.get(h)
                if swarm is None:
                    unknown.append(len(out))
                    out.append((h, 0, 0, 0))
                else:
                    out.append(
                        (h, swarm.complete, swarm.downloaded, swarm.incomplete)
                    )
        # BEP 33 fallback strictly AFTER the shard-lock walk: the bloom
        # provider is foreign code and must never run under a leaf lock
        if self._bloom_source is not None:
            for i in unknown:
                h = out[i][0]
                blooms = self._bloom_source(h)
                if blooms is None:
                    continue
                seed_bloom, peer_bloom = blooms
                out[i] = (
                    h,
                    int(round(seed_bloom.estimate())),
                    0,
                    int(round(peer_bloom.estimate())),
                )
        return out

    # ----------------------------------------------------- indexer seam

    def seed_peer(
        self, info_hash: bytes, ip: str, port: int, left: int = 0,
        peer_id: bytes | None = None,
    ) -> None:
        """Feed a DHT-harvested peer into the store (persistent-tracker
        semantics): the swarm is created if the tracker has never seen
        an announce for it. DHT announces carry no peer id, so one is
        synthesized deterministically from the address."""
        if peer_id is None:
            peer_id = b"-IX-" + hashlib.sha1(
                f"{ip}:{port}".encode()
            ).digest()[:16]
        shard = self._shards[self.shard_of(info_hash)]
        now = self._clock()
        with shard._shard_lock:
            shard._cells.write("stats")
            shard.indexed += 1
            swarm = shard.swarms.get(info_hash)
            if swarm is None:
                swarm = shard.swarms[info_hash] = _Swarm()
                swarm.seeded_from = "dht"
            # not counted in shard.announces: seeding is harvest, not
            # client announce traffic (it has its own `indexed` counter)
            self._announce_locked(
                shard, info_hash, peer_id, ip, port, left,
                AnnounceEvent.EMPTY, 0, now,
            )

    # -------------------------------------------------------------- sweep

    def _sweep_shard(self, shard: _Shard) -> int:
        cutoff = self._clock() - self.peer_ttl
        evicted = 0
        with shard._shard_lock:
            shard._cells.write("stats")
            for ih in list(shard.swarms):
                swarm = shard.swarms[ih]
                for pid in [
                    pid for pid, p in swarm.peers.items() if p.last_seen < cutoff
                ]:
                    self._remove_locked(swarm, swarm.peers[pid])
                    shard.peers -= 1
                    evicted += 1
                if not swarm.peers and (
                    swarm.downloaded == 0 or swarm.last_active < cutoff
                ):
                    # an empty, never-completed swarm holds no history
                    # worth the memory, and even a completed one is only
                    # kept one TTL past its last announce — a hostile
                    # loop of COMPLETED announces to random hashes must
                    # not allocate permanent ghost swarms
                    del shard.swarms[ih]
            shard.evicted += evicted
        return evicted

    def sweep_one(self) -> int:
        """Expire ONE shard (round-robin) — the amortized form the pump
        calls every tick; a full cycle visits every shard."""
        shard = self._shards[self._sweep_cursor % self.n_shards]
        self._sweep_cursor += 1
        return self._sweep_shard(shard)

    def sweep(self) -> int:
        """Full expiry pass over every shard (sequential, never nested)."""
        return sum(self._sweep_shard(s) for s in self._shards)

    # ------------------------------------------------------------ metrics

    def metrics_snapshot(self) -> dict:
        """Everything ``render_tracker_metrics`` needs: totals plus
        per-shard occupancy. Shard locks are taken strictly one at a
        time (leaf discipline)."""
        per_shard = []
        for shard in self._shards:
            with shard._shard_lock:
                shard._cells.read("stats")
                # O(1) per shard: the peer count is maintained
                # incrementally, never a swarm walk under the lock
                per_shard.append(
                    {
                        "swarms": len(shard.swarms),
                        "peers": shard.peers,
                        "announces": shard.announces,
                        "evicted": shard.evicted,
                        "indexed": shard.indexed,
                        "clamped": shard.clamped,
                    }
                )
        with self._stats_lock:
            self._stats_cells.read("stats")
            batches = {
                "batches": self._batches,
                "announces": self._batched_announces,
                "max": self._batch_max,
            }
            scrapes = self._scrapes
        return {
            "shards": per_shard,
            "n_shards": self.n_shards,
            "announces": sum(s["announces"] for s in per_shard),
            "scrapes": scrapes,
            "swarms": sum(s["swarms"] for s in per_shard),
            "peers": sum(s["peers"] for s in per_shard),
            "evicted": sum(s["evicted"] for s in per_shard),
            "indexed": sum(s["indexed"] for s in per_shard),
            "numwant_clamped": sum(s["clamped"] for s in per_shard),
            "batch": batches,
            "interval": self.interval,
        }


# ================================================================ service


class ShardedTracker:
    """Policy layer speaking ``TrackerServer``'s request objects, with
    announce latency observed into the shared log2 histogram registry
    (outside every lock)."""

    def __init__(self, store: ShardedSwarmStore):
        self.store = store

    @staticmethod
    def _transport(req) -> str:
        return "udp" if type(req).__name__.startswith("Udp") else "http"

    def _observe(self, transport: str, seconds_list: list[float]) -> None:
        from torrent_tpu_torch.obs.hist import histograms

        histograms().get(
            "torrent_tpu_tracker_announce_seconds",
            help="Tracker announce handle latency (receive to reply)",
            transport=transport,
        ).observe_batch(seconds_list)

    async def handle_announce(self, req: AnnounceRequest) -> None:
        t0 = time.perf_counter()
        out = self.store.announce(
            req.info_hash, req.peer_id, req.ip, req.port, req.left,
            req.event, req.num_want,
        )
        await req.respond(out.interval, out.complete, out.incomplete, out.peers)
        self._observe(self._transport(req), [time.perf_counter() - t0])

    async def handle_scrape(self, req: ScrapeRequest) -> None:
        await req.respond(self.store.scrape(req.info_hashes))

    async def handle(self, req) -> None:
        if isinstance(req, AnnounceRequest):
            await self.handle_announce(req)
        elif isinstance(req, ScrapeRequest):
            await self.handle_scrape(req)

    async def handle_batch(self, reqs: list) -> None:
        """The bulk path: announces grouped per shard through
        ``announce_batch`` (one lock acquisition per shard), replies sent
        in bulk afterwards; scrapes handled after the announce burst.

        Latency accounting is per REQUEST: each announce observes the
        time from batch pickup to its OWN reply completing — store work
        plus its reply position in the drain cycle — never the whole
        batch's wall (which would inflate p99 by the batch width)."""
        announces = [r for r in reqs if isinstance(r, AnnounceRequest)]
        if announces:
            t0 = time.perf_counter()
            outcomes = self.store.announce_batch(
                [
                    (r.info_hash, r.peer_id, r.ip, r.port, r.left, r.event,
                     r.num_want)
                    for r in announces
                ]
            )
            by_transport: dict[str, list[float]] = {}
            for req, out in zip(announces, outcomes):
                await req.respond(
                    out.interval, out.complete, out.incomplete, out.peers
                )
                by_transport.setdefault(self._transport(req), []).append(
                    time.perf_counter() - t0
                )
            for transport, lats in by_transport.items():
                self._observe(transport, lats)
        for req in reqs:
            if isinstance(req, ScrapeRequest):
                await self.handle_scrape(req)


async def run_sharded_tracker(
    opts: ServeOptions | None = None,
    n_shards: int = DEFAULT_SHARDS,
    store: ShardedSwarmStore | None = None,
    indexer=None,
) -> tuple[TrackerServer, asyncio.Task]:
    """Serve + drive a :class:`ShardedTracker`.

    Returns the transport server (ports/close) and the pump task. The
    pump drains the request queue each cycle and hands the whole batch
    to ``handle_batch`` — a burst of UDP announces is processed per
    shard, not per datagram — and expires one shard per
    :data:`SWEEP_TICK`. The tracker's HTTP listener serves ``/metrics``
    (``torrent_tpu_tracker_*`` + the latency histogram families).
    ``indexer`` (a ``net.indexer.DhtIndexer``) is only carried for the
    metrics snapshot — its harvest feeds ``store`` directly.
    """
    server = await serve_tracker(opts)
    if store is None:
        store = ShardedSwarmStore(
            n_shards=n_shards,
            interval=(opts.interval if opts else DEFAULT_ANNOUNCE_INTERVAL),
        )
    tracker = ShardedTracker(store)

    def _metrics() -> str:
        from torrent_tpu_torch.obs.hist import histograms
        from torrent_tpu_torch.utils.metrics import render_tracker_metrics

        snap = store.metrics_snapshot()
        if indexer is not None:
            snap["indexer"] = indexer.snapshot()
        return render_tracker_metrics(snap) + histograms().render()

    server.metrics_provider = _metrics

    # pump liveness for GET /v1/health: the pump stamps every cycle
    # (it wakes at least every 5 s on an idle queue), so a stale stamp
    # means the drive loop is wedged and the LB should pull this node
    pump_state = {"tick": time.monotonic()}

    def _health() -> dict:
        from torrent_tpu_torch.obs.slo import armed, build_health

        engine = armed()
        return build_health(
            pump_age_s=time.monotonic() - pump_state["tick"],
            pump_max_age_s=PUMP_MAX_AGE_S,
            slo_report=engine.report() if engine is not None else None,
        )

    server.health_provider = _health

    # sweep enough shards per tick that a full round-robin cycle always
    # completes within one peer TTL, whatever the shard count — with 64
    # shards a one-shard-per-minute cadence would leave dead peers
    # servable for ~an hour
    import math

    shards_per_tick = max(
        1,
        math.ceil(store.n_shards * SWEEP_TICK / max(store.peer_ttl, SWEEP_TICK)),
    )

    async def pump():
        last_sweep = time.monotonic()
        it = server.__aiter__()
        while True:
            pump_state["tick"] = time.monotonic()
            try:
                req = await asyncio.wait_for(it.__anext__(), timeout=5.0)
            except asyncio.TimeoutError:
                req = None
            except StopAsyncIteration:
                break
            batch = ([req] if req is not None else []) + server.drain_nowait(
                MAX_BATCH
            )
            if batch:
                try:
                    await tracker.handle_batch(batch)
                except Exception:
                    log.exception("announce batch failed; tracker continues")
            if time.monotonic() - last_sweep > SWEEP_TICK:
                for _ in range(shards_per_tick):
                    store.sweep_one()
                last_sweep = time.monotonic()

    task = asyncio.create_task(pump())
    task.tracker = tracker  # expose state for tests/stats
    task.store = store
    task.pump_state = pump_state
    return server, task


def main(argv=None) -> int:  # pragma: no cover - manual entrypoint
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--http-port", type=int, default=8000)
    parser.add_argument(
        "--udp-port", type=int, default=6969, help="negative value disables UDP"
    )
    parser.add_argument("--interval", type=int, default=600)
    parser.add_argument("--shards", type=int, default=DEFAULT_SHARDS)
    args = parser.parse_args(argv)

    async def go():
        server, task = await run_sharded_tracker(
            ServeOptions(
                http_port=args.http_port,
                udp_port=args.udp_port if args.udp_port >= 0 else None,
                interval=args.interval,
            ),
            n_shards=args.shards,
        )
        print(
            f"sharded tracker listening: http={server.http_port} "
            f"udp={server.udp_port} shards={args.shards}"
        )
        await task

    asyncio.run(go())
    return 0


if __name__ == "__main__":  # pragma: no cover
    main()
