"""Swarm wire-plane observability: bounded per-peer telemetry.

The obs plane can name the limiting stage, process, and fleet-wide
budget burn for the verify pipeline — but the live swarm it was all
built to serve was a black box: ``session/torrent.py`` runs a
rarest-first picker, choke rounds, endgame, and per-peer pipelining,
yet not one byte of wire traffic reached the ledger, tracer, timeline,
or SLO engine. This module is the missing tier:

* :class:`SwarmTelemetry` — a bounded per-peer registry fed by the
  session layer: per-message-type byte/count accounting
  (``Torrent._handle_message``), choke/interest state transitions WITH
  cumulative durations (the choke timeline), request-pipeline depth,
  block round-trip log2 histograms (the ``obs/hist`` bucket bounds,
  mergeable like every other family), snub / endgame-cancel / reject
  counters, and connection lifecycle spans through the tracer. One
  leaf :func:`named_lock`; per-peer records are bounded at
  :data:`MAX_TRACKED_PEERS` live entries (excess peers share one
  ``overflow`` record) and process totals stay cumulative forever, so
  the SLO window deltas never see a counter drop when a peer leaves.
* :func:`build_swarm_snapshot` — the PURE rollup (analysis determinism
  pass scope, like the digest build functions): top-:data:`TOP_PEERS` peers by
  transferred bytes with an ``overflow`` fold of the rest, per-peer
  RTT p50/p99 from the bucket counts, choke-timeline seconds, and the
  process totals. Served as ``GET /v1/swarm`` (bridge AND session
  MetricsServer), rendered as ``torrent_tpu_swarm_*`` / bounded
  ``torrent_tpu_peer_*`` Prometheus families, and drawn by
  ``torrent-tpu top --swarm``.
* **Flight-recorder triggers**, exactly once per transition (the
  breaker-open discipline): ``snub_storm`` (half the swarm — at least
  :data:`SNUB_STORM_MIN` peers — simultaneously snubbed),
  ``all_peers_choked`` (every connected peer choking us while we're
  interested), and ``announce_failure_streak``
  (:data:`ANNOUNCE_STREAK` consecutive announce failures). Each
  re-arms only after the condition clears.

The registry is lock-leaf disciplined: the tracer, the histogram
registry, and the flight recorder are only ever called AFTER the
telemetry lock is released. Block RTTs additionally feed the shared
log2 family ``torrent_tpu_swarm_block_rtt_seconds`` so SLO latency
objectives (``p99_ms=…:block_rtt``) cover the swarm tier.
"""

from __future__ import annotations

import time
from bisect import bisect_left

from torrent_tpu_torch.utils.locks import guard_attrs, named_lock
from torrent_tpu_torch.obs.hist import BUCKET_BOUNDS

__all__ = [
    "ANNOUNCE_STREAK",
    "MAX_TRACKED_PEERS",
    "MSG_KINDS",
    "SNUB_STORM_MIN",
    "TOP_PEERS",
    "SwarmTelemetry",
    "build_swarm_snapshot",
    "swarm_telemetry",
]

SWARM_VERSION = 1

# live per-peer records; further peers share one "overflow" record so
# a 10k-peer swarm can't grow the registry (process totals still count
# every byte)
MAX_TRACKED_PEERS = 64
# peers named individually in a snapshot / /metrics scrape; the rest
# fold into the snapshot's own "overflow" aggregate
TOP_PEERS = 8
# snub-storm floor: the trigger needs at least this many peers snubbed
# at once (AND at least half the connected swarm) — a lone flaky peer
# is normal BitTorrent weather, not a storm
SNUB_STORM_MIN = 2
# consecutive announce failures before the flight recorder fires (the
# swarm is coasting on cached peers; operators should know now, not
# when the peer list drains). Streaks are per announcing torrent
# (origin), bounded at MAX_ANNOUNCE_ORIGINS tracked origins.
ANNOUNCE_STREAK = 3
MAX_ANNOUNCE_ORIGINS = 256

# the shared log2 family block RTTs observe into (SLO family key:
# "block_rtt" — see obs/timeline.SAMPLE_HIST_FAMILIES)
BLOCK_RTT_FAMILY = "torrent_tpu_swarm_block_rtt_seconds"

# bounded wire-message kinds (protocol.py class names); anything else —
# a future message, a subclass — folds into "other" so per-kind series
# cardinality is fixed
MSG_KINDS = frozenset(
    {
        "KeepAlive", "Choke", "Unchoke", "Interested", "NotInterested",
        "Have", "BitfieldMsg", "Request", "Piece", "Cancel", "SuggestPiece",
        "HaveAll", "HaveNone", "RejectRequest", "AllowedFast", "HashRequest",
        "Hashes", "HashReject", "Extended",
    }
)

_OVERFLOW_KEY = "overflow"

# the four wire-state flags whose transitions the choke timeline tracks
_FLAGS = ("am_choking", "am_interested", "peer_choking", "peer_interested")
# spec-default positions (BEP 3): both sides start choked, uninterested
_FLAG_DEFAULTS = {
    "am_choking": True,
    "am_interested": False,
    "peer_choking": True,
    "peer_interested": False,
}


class _PeerTel:
    """One live peer's counters. Mutated only under the registry lock."""

    __slots__ = (
        "key", "inbound", "connected_t", "trace_id", "bytes_down", "bytes_up",
        "blocks", "msgs", "flags", "flag_since", "flag_true_s", "transitions",
        "depth", "depth_max", "rtt_counts", "rtt_count", "rtt_sum", "snubs",
        "snubbed", "rejects", "endgame_cancels", "corrupt",
    )

    def __init__(self, key: str, inbound: bool, now: float, trace_id: str | None):
        self.key = key
        self.inbound = inbound
        self.connected_t = now
        self.trace_id = trace_id
        self.bytes_down = 0
        self.bytes_up = 0
        self.blocks = 0
        # kind -> [count, bytes]
        self.msgs: dict[str, list] = {}
        self.flags = dict(_FLAG_DEFAULTS)
        # per-flag: when the CURRENT value was entered / cumulative
        # seconds spent with the flag True (closed intervals only; the
        # snapshot extends the open interval to its own instant)
        self.flag_since = {f: now for f in _FLAGS}
        self.flag_true_s = {f: 0.0 for f in _FLAGS}
        self.transitions = 0
        self.depth = 0
        self.depth_max = 0
        self.rtt_counts = [0] * (len(BUCKET_BOUNDS) + 1)
        self.rtt_count = 0
        self.rtt_sum = 0.0
        self.snubs = 0
        self.snubbed = False
        self.rejects = 0
        self.endgame_cancels = 0
        self.corrupt = 0

    def raw(self, now: float) -> dict:
        """Scalar-only copy for the pure snapshot rollup (durations
        finalized to ``now`` so the rollup itself never reads a clock)."""
        true_s = {}
        for f in _FLAGS:
            open_s = max(0.0, now - self.flag_since[f]) if self.flags[f] else 0.0
            true_s[f] = self.flag_true_s[f] + open_s
        return {
            "key": self.key,
            "inbound": self.inbound,
            "connected_s": max(0.0, now - self.connected_t),
            "bytes_down": self.bytes_down,
            "bytes_up": self.bytes_up,
            "blocks": self.blocks,
            "msgs": {k: [v[0], v[1]] for k, v in self.msgs.items()},
            "state": dict(self.flags),
            "flag_true_s": true_s,
            "transitions": self.transitions,
            "depth": self.depth,
            "depth_max": self.depth_max,
            "rtt_counts": list(self.rtt_counts),
            "rtt_count": self.rtt_count,
            "rtt_sum": self.rtt_sum,
            "snubs": self.snubs,
            "snubbed": self.snubbed,
            "rejects": self.rejects,
            "endgame_cancels": self.endgame_cancels,
            "corrupt": self.corrupt,
        }


# ------------------------------------------------------------ rollups
# (analysis determinism pass scope, like the fleet digest build functions: no
# wall clock, no randomness, sorted iteration — every instant below was
# resolved by the registry before the rollup runs)


def _as_float(value, default: float = 0.0) -> float:
    """Defensive finite float: hostile raw fields (None, strings, NaN,
    ±Inf — NaN is truthy, so ``value or 0`` does NOT save you) read as
    ``default``. The snapshot must json-serialize with allow_nan=False."""
    try:
        f = float(value)
    except (TypeError, ValueError):
        return default
    return f if f == f and abs(f) != float("inf") else default


def _as_int(value, default: int = 0) -> int:
    return int(_as_float(value, float(default)))


# determinism-scope
def _rtt_summary(counts: list, count, total) -> dict:
    """p50/p99 upper-bound estimates from log2 bucket counts (pure).
    The overflow bucket has no finite upper bound: a quantile landing
    there reports ``None`` plus an ``overflow`` flag — same contract as
    the SLO evaluator's p99 (json must never carry Infinity)."""
    count = _as_int(count)
    total = _as_float(total)
    out: dict = {"count": count, "mean_s": round(total / count, 6) if count > 0 else None}
    counts = [_as_int(c) for c in counts] if isinstance(counts, list) else []
    for name, q in (("p50_s", 0.50), ("p99_s", 0.99)):
        est = None
        overflow = False
        if count > 0:
            want = q * count
            cum = 0
            for idx, c in enumerate(counts):
                cum += c
                if cum >= want:
                    if idx < len(BUCKET_BOUNDS):
                        est = round(BUCKET_BOUNDS[idx], 6)
                    else:
                        overflow = True
                    break
        out[name] = est
        if name == "p99_s":
            out["p99_overflow"] = overflow
    return out


# determinism-scope
def _peer_entry(raw: dict) -> dict:
    """One snapshot peer entry from a finalized raw record (pure,
    total: every field goes through the defensive scalar parsers)."""
    msgs = raw.get("msgs")
    msgs = msgs if isinstance(msgs, dict) else {}
    true_s = raw.get("flag_true_s")
    true_s = true_s if isinstance(true_s, dict) else {}
    state = raw.get("state")
    state = state if isinstance(state, dict) else {}
    return {
        "inbound": bool(raw.get("inbound")),
        "connected_s": round(_as_float(raw.get("connected_s")), 3),
        "bytes_down": _as_int(raw.get("bytes_down")),
        "bytes_up": _as_int(raw.get("bytes_up")),
        "blocks": _as_int(raw.get("blocks")),
        "msgs": {
            str(k): {
                "count": _as_int(msgs[k][0]),
                "bytes": _as_int(msgs[k][1]),
            }
            for k in sorted(msgs, key=str)
            if isinstance(msgs[k], (list, tuple)) and len(msgs[k]) >= 2
        },
        "state": {f: bool(state.get(f)) for f in _FLAGS},
        # the choke timeline: cumulative seconds each flag spent True
        # plus the transition count — "choked 41 of 42 connected
        # seconds" is the line a stalled download needs
        "choke_timeline": {
            "transitions": _as_int(raw.get("transitions")),
            **{f: round(_as_float(true_s.get(f)), 3) for f in _FLAGS},
        },
        "pipeline": {
            "depth": _as_int(raw.get("depth")),
            "depth_max": _as_int(raw.get("depth_max")),
        },
        "block_rtt": _rtt_summary(
            raw.get("rtt_counts"), raw.get("rtt_count"), raw.get("rtt_sum")
        ),
        "snubs": _as_int(raw.get("snubs")),
        "snubbed": bool(raw.get("snubbed")),
        "rejects": _as_int(raw.get("rejects")),
        "endgame_cancels": _as_int(raw.get("endgame_cancels")),
        "corrupt": _as_int(raw.get("corrupt")),
    }


# determinism-scope
def _fold_entries(raws: list) -> dict:
    """Aggregate raw peer records into one overflow entry (pure):
    counters sum, RTT buckets merge elementwise. A raw carrying its own
    ``peers`` count (the registry's shared overflow record speaks for
    many connections) contributes that count; ordinary records count 1."""
    folded = {
        "peers": sum(
            _as_int(raw.get("peers", 1), 1) if isinstance(raw, dict) else 1
            for raw in raws
        ),
        "bytes_down": 0,
        "bytes_up": 0,
        "blocks": 0,
        "snubs": 0,
        "snubbed": 0,
        "rejects": 0,
        "endgame_cancels": 0,
        "transitions": 0,
        "depth": 0,
    }
    counts = [0] * (len(BUCKET_BOUNDS) + 1)
    count = 0
    total = 0.0
    for raw in raws:
        folded["bytes_down"] += _as_int(raw.get("bytes_down"))
        folded["bytes_up"] += _as_int(raw.get("bytes_up"))
        folded["blocks"] += _as_int(raw.get("blocks"))
        folded["snubs"] += _as_int(raw.get("snubs"))
        folded["snubbed"] += 1 if raw.get("snubbed") else 0
        folded["rejects"] += _as_int(raw.get("rejects"))
        folded["endgame_cancels"] += _as_int(raw.get("endgame_cancels"))
        folded["transitions"] += _as_int(raw.get("transitions"))
        folded["depth"] += _as_int(raw.get("depth"))
        rc = raw.get("rtt_counts")
        rc = rc if isinstance(rc, list) else []
        for i in range(min(len(counts), len(rc))):
            counts[i] += _as_int(rc[i])
        count += _as_int(raw.get("rtt_count"))
        total += _as_float(raw.get("rtt_sum"))
    folded["block_rtt"] = _rtt_summary(counts, count, total)
    return folded


# determinism-scope
def build_swarm_snapshot(peer_raws: dict, totals: dict, top_k: int = TOP_PEERS) -> dict:
    """The pure swarm rollup over finalized raw records.

    ``peer_raws``: key -> :meth:`_PeerTel.raw` dict (durations already
    finalized). ``totals``: the registry's cumulative process counters.
    Top-``top_k`` peers by transferred bytes (total order: bytes desc,
    then key) are named; the rest fold into ``overflow``. Total and
    defensive: hostile/partial raw dicts produce a well-formed snapshot,
    never a crash — the hypothesis property in tests/test_fuzz.py."""
    src = peer_raws if isinstance(peer_raws, dict) else {}
    raws = {
        str(k): src[k]
        for k in sorted(src, key=str)
        if isinstance(src[k], dict)
    }
    # the registry's shared overflow record is NEVER a named peer — it
    # aggregates many connections, so ranking it into the top-K would
    # emit the peer="overflow" series twice on /metrics (an invalid
    # exposition); it always joins the snapshot's own fold instead
    shared_overflow = raws.pop(_OVERFLOW_KEY, None)
    order = sorted(
        raws,
        key=lambda k: (
            -(_as_int(raws[k].get("bytes_down")) + _as_int(raws[k].get("bytes_up"))),
            k,
        ),
    )
    top_k = max(0, _as_int(top_k))
    named = order[:top_k]
    folded = order[top_k:]
    fold_raws = [raws[k] for k in folded]
    if shared_overflow is not None:
        fold_raws.append(shared_overflow)
    totals = totals if isinstance(totals, dict) else {}
    def _state(k) -> dict:
        s = raws[k].get("state")
        return s if isinstance(s, dict) else {}

    counts = {
        # the shared overflow record contributes its own live-peer count
        # (per-peer flags over an aggregate are meaningless, so the
        # flag-derived counts cover individually-tracked peers only)
        "connected": len(raws) + (
            _as_int(shared_overflow.get("peers"))
            if shared_overflow is not None
            else 0
        ),
        "snubbed": sum(1 for k in order if raws[k].get("snubbed")),
        "choking_us": sum(1 for k in order if _state(k).get("peer_choking")),
        "interested_in": sum(1 for k in order if _state(k).get("am_interested")),
        "unchoked_by_us": sum(
            1 for k in order if not _state(k).get("am_choking", True)
        ),
    }
    return {
        "v": SWARM_VERSION,
        "counts": counts,
        "peers": {k: _peer_entry(raws[k]) for k in named},
        "overflow": _fold_entries(fold_raws) if fold_raws else None,
        # totals are registry-owned int counters in practice, but the
        # rollup is total over hostile dicts: every value normalizes
        # through the defensive int parser (the snapshot must
        # json-serialize with allow_nan=False)
        "totals": {str(k): _as_int(totals[k]) for k in sorted(totals, key=str)},
    }


# --------------------------------------------------------------- registry


class SwarmTelemetry:
    """Bounded per-peer wire telemetry. One global instance
    (:func:`swarm_telemetry`) serves every torrent of the process;
    tests may construct private ones."""

    def __init__(self, max_peers: int = MAX_TRACKED_PEERS):
        self._lock = named_lock("obs.swarm._lock")
        # dynamic lockset checking: the peer table + totals are one cell
        # guarded by _lock (the session loop writes, metrics scrapers
        # and the timeline sampler thread read)
        self._cells = guard_attrs("obs.swarm", "peers")
        self._max_peers = max(1, int(max_peers))
        self._peers: dict[str, _PeerTel] = {}
        self._totals: dict[str, int] = {
            "connections": 0,
            "bytes_down": 0,
            "bytes_up": 0,
            "blocks": 0,
            "snubs": 0,
            "rejects": 0,
            "endgame_cancels": 0,
            "corrupt": 0,
            "announce_ok": 0,
            "announce_failed": 0,
        }
        self._msg_totals: dict[str, list] = {}  # kind -> [count, bytes]
        # live connections sharing the overflow record (its per-peer
        # record speaks for this many peers; when the last one leaves
        # the record is removed so the connected gauge never inflates)
        self._overflow_live = 0
        # exactly-once trigger latches (re-arm when the condition clears)
        self._storm_active = False
        self._all_choked_active = False
        # announce failure streaks are PER ORIGIN (one per torrent's
        # announce loop): a healthy torrent's successes must not mask a
        # dead tracker on another torrent. Bounded: past the cap, new
        # origins share one fold key — the trigger still fires, only
        # per-origin precision degrades.
        self._announce_streaks: dict[str, int] = {}
        self._trigger_counts: dict[str, int] = {}

    # ---------------------------------------------------------- lifecycle

    def peer_connected(
        self, key: str, inbound: bool = False, trace_id: str | None = None
    ) -> None:
        now = time.monotonic()
        with self._lock:
            self._cells.write("peers")
            self._totals["connections"] += 1
            if key not in self._peers and len(self._peers) >= self._max_peers:
                self._overflow_live += 1
                if _OVERFLOW_KEY not in self._peers:
                    self._peers[_OVERFLOW_KEY] = _PeerTel(
                        _OVERFLOW_KEY, inbound, now, None
                    )
                return  # folded: no per-peer record, no lifecycle span
            self._peers[key] = _PeerTel(key, inbound, now, trace_id)
        if trace_id is not None:
            from torrent_tpu_torch.obs.tracer import tracer

            # outside the telemetry lock: the tracer takes its own leaf
            tracer().add_span(
                trace_id, "swarm.peer.connect", t0=now, t1=now,
                peer=key, inbound=inbound,
            )

    def peer_dropped(self, key: str) -> None:
        now = time.monotonic()
        span = None
        with self._lock:
            self._cells.write("peers")
            tel = self._peers.pop(key, None)
            if tel is None:
                # an untracked (folded) peer leaving: its connection is
                # one of the overflow record's; at zero the record goes
                # too — the connected gauge must not inflate forever
                # (the cumulative _totals already counted its bytes)
                if self._overflow_live > 0:
                    self._overflow_live -= 1
                    if self._overflow_live == 0:
                        self._peers.pop(_OVERFLOW_KEY, None)
                return
            if tel.trace_id is not None:
                span = (
                    tel.trace_id, tel.connected_t,
                    {
                        "peer": tel.key, "inbound": tel.inbound,
                        "bytes_down": tel.bytes_down, "bytes_up": tel.bytes_up,
                        "blocks": tel.blocks, "snubs": tel.snubs,
                    },
                )
            fire = self._recheck_latches_locked()
        if span is not None:
            from torrent_tpu_torch.obs.tracer import tracer

            trace_id, t0, attrs = span
            tracer().add_span(trace_id, "swarm.peer", t0=t0, t1=now, **attrs)
        self._fire(fire)

    # ------------------------------------------------------------- events

    def _tel(self, key: str) -> _PeerTel | None:
        # caller holds self._lock; a late event for a dropped/unknown
        # peer lands on the overflow record when one exists
        return self._peers.get(key) or self._peers.get(_OVERFLOW_KEY)

    def on_message(self, key: str, kind: str, nbytes: int = 0) -> None:
        kind = kind if kind in MSG_KINDS else "other"
        with self._lock:
            self._cells.write("peers")
            slot = self._msg_totals.setdefault(kind, [0, 0])
            slot[0] += 1
            slot[1] += nbytes
            tel = self._tel(key)
            if tel is not None:
                pslot = tel.msgs.setdefault(kind, [0, 0])
                pslot[0] += 1
                pslot[1] += nbytes

    def on_state(self, key: str, **flags) -> None:
        """Record wire-state flag transitions (``am_choking=False`` …).
        No-op values (already current) don't count as transitions."""
        now = time.monotonic()
        fire = None
        with self._lock:
            self._cells.write("peers")
            tel = self._tel(key)
            if tel is None:
                return
            changed = False
            for name, value in sorted(flags.items()):
                if name not in _FLAGS or bool(value) == tel.flags[name]:
                    continue
                if tel.flags[name]:  # closing a True interval
                    tel.flag_true_s[name] += max(0.0, now - tel.flag_since[name])
                tel.flags[name] = bool(value)
                tel.flag_since[name] = now
                tel.transitions += 1
                changed = True
            # the latch scan is bounded O(live peers) but still only
            # worth paying when a flag actually transitioned
            if changed:
                fire = self._recheck_latches_locked()
        self._fire(fire)

    def on_block(self, key: str, nbytes: int, rtt_s: float | None = None) -> None:
        """A payload block arrived: bytes, RTT, and snub redemption.
        (``rejects`` stays CUMULATIVE like its sibling counters — the
        session tracks its own since-last-block reject burst for the
        snub gate.) The hot path stays O(1): the bounded latch scan
        runs only when this delivery redeems a snubbed peer, the one
        state change a block can cause."""
        fire = None
        with self._lock:
            self._cells.write("peers")
            self._totals["bytes_down"] += nbytes
            self._totals["blocks"] += 1
            tel = self._tel(key)
            if tel is not None:
                tel.bytes_down += nbytes
                tel.blocks += 1
                redeemed = tel.snubbed
                tel.snubbed = False  # delivering redeems (session mirror)
                if rtt_s is not None and rtt_s >= 0:
                    tel.rtt_counts[bisect_left(BUCKET_BOUNDS, rtt_s)] += 1
                    tel.rtt_count += 1
                    tel.rtt_sum += rtt_s
                if redeemed:
                    fire = self._recheck_latches_locked()
        if rtt_s is not None and rtt_s >= 0:
            from torrent_tpu_torch.obs.hist import histograms

            # outside the telemetry lock (hist locks are their own leaves)
            histograms().get(
                BLOCK_RTT_FAMILY,
                help="Block round-trip time: request written to payload received",
            ).observe(rtt_s)
        self._fire(fire)

    def on_upload(self, key: str, nbytes: int) -> None:
        with self._lock:
            self._cells.write("peers")
            self._totals["bytes_up"] += nbytes
            tel = self._tel(key)
            if tel is not None:
                tel.bytes_up += nbytes

    def on_depth(self, key: str, depth: int) -> None:
        with self._lock:
            self._cells.write("peers")
            tel = self._tel(key)
            if tel is not None:
                tel.depth = depth
                if depth > tel.depth_max:
                    tel.depth_max = depth

    def on_snub(self, key: str) -> None:
        fire = None
        with self._lock:
            self._cells.write("peers")
            self._totals["snubs"] += 1
            tel = self._tel(key)
            if tel is not None:
                tel.snubs += 1
                tel.snubbed = True
            fire = self._recheck_latches_locked()
        self._fire(fire)

    def on_reject(self, key: str) -> None:
        with self._lock:
            self._cells.write("peers")
            self._totals["rejects"] += 1
            tel = self._tel(key)
            if tel is not None:
                tel.rejects += 1

    def on_endgame_cancel(self, key: str) -> None:
        with self._lock:
            self._cells.write("peers")
            self._totals["endgame_cancels"] += 1
            tel = self._tel(key)
            if tel is not None:
                tel.endgame_cancels += 1

    def on_corrupt(self, key: str) -> None:
        with self._lock:
            self._cells.write("peers")
            self._totals["corrupt"] += 1
            tel = self._tel(key)
            if tel is not None:
                tel.corrupt += 1

    def on_announce(self, ok: bool, origin: str = "") -> None:
        """Tracker announce outcome. ``origin`` names the announcing
        torrent (its swarm trace id): streaks are tracked per origin so
        one torrent's healthy tracker can never mask another's dead one.
        The flight recorder fires exactly once when an origin's streak
        crosses :data:`ANNOUNCE_STREAK`, re-arming on its next success."""
        fire = None
        origin = str(origin)
        with self._lock:
            self._cells.write("peers")
            if origin not in self._announce_streaks and (
                len(self._announce_streaks) >= MAX_ANNOUNCE_ORIGINS
            ):
                origin = _OVERFLOW_KEY
            if ok:
                self._totals["announce_ok"] += 1
                self._announce_streaks.pop(origin, None)
            else:
                self._totals["announce_failed"] += 1
                streak = self._announce_streaks.get(origin, 0) + 1
                self._announce_streaks[origin] = streak
                if streak == ANNOUNCE_STREAK:
                    fire = [(
                        "announce_failure_streak",
                        {"streak": streak, "origin": origin},
                    )]
                    self._trigger_counts["announce_failure_streak"] = (
                        self._trigger_counts.get("announce_failure_streak", 0) + 1
                    )
        self._fire(fire)

    # ----------------------------------------------------------- triggers

    def _recheck_latches_locked(self):
        """Evaluate the latched swarm-state triggers. Caller holds the
        lock; returns the list of (reason, detail) pairs to fire
        OUTSIDE it — each latch contributes at most one entry per
        False→True transition and re-arms only when it clears."""
        live = [t for k, t in self._peers.items() if k != _OVERFLOW_KEY]
        n = len(live)
        snubbed = sum(1 for t in live if t.snubbed)
        storm = n >= SNUB_STORM_MIN and snubbed >= max(SNUB_STORM_MIN, (n + 1) // 2)
        fires = []
        if storm and not self._storm_active:
            self._storm_active = True
            self._trigger_counts["snub_storm"] = (
                self._trigger_counts.get("snub_storm", 0) + 1
            )
            fires.append(("snub_storm", {"snubbed": snubbed, "connected": n}))
        elif not storm:
            self._storm_active = False
        all_choked = (
            n >= 2
            and all(t.flags["peer_choking"] for t in live)
            and any(t.flags["am_interested"] for t in live)
        )
        if all_choked and not self._all_choked_active:
            self._all_choked_active = True
            # fire only when a transfer was underway among the LIVE
            # peers: every BitTorrent connection STARTS choked (spec
            # defaults), so the condition is trivially true at swarm
            # startup — and a process-cumulative gate would still fire
            # spuriously when a SECOND torrent is added after the first
            # ever moved a block. The alarming transition is these
            # peers choking us after they had been delivering.
            if any(t.blocks > 0 for t in live):
                self._trigger_counts["all_peers_choked"] = (
                    self._trigger_counts.get("all_peers_choked", 0) + 1
                )
                fires.append(("all_peers_choked", {"connected": n}))
        elif not all_choked:
            self._all_choked_active = False
        return fires

    def _fire(self, fires) -> None:
        if not fires:
            return
        from torrent_tpu_torch.obs.recorder import flight_recorder

        for reason, detail in fires:
            # outside the telemetry lock; the snapshot the dump carries
            # is taken fresh (the recorder redacts it)
            flight_recorder().trigger(
                reason, detail=detail, snapshots={"swarm": self.snapshot()}
            )

    # ----------------------------------------------------------- snapshot

    def snapshot(self, top_k: int = TOP_PEERS) -> dict:
        """The ``/v1/swarm`` payload: raw records finalized under the
        lock, then rolled up by the pure rollup outside it."""
        now = time.monotonic()
        with self._lock:
            self._cells.read("peers")
            raws = {k: t.raw(now) for k, t in self._peers.items()}
            if _OVERFLOW_KEY in raws:
                # the shared record speaks for this many live folded
                # connections (build_swarm_snapshot folds it, never
                # names it)
                raws[_OVERFLOW_KEY]["peers"] = self._overflow_live
            totals = dict(self._totals)
            # the worst current per-origin failure streak (0 = healthy)
            totals["announce_streak"] = max(
                self._announce_streaks.values(), default=0
            )
            msgs = {k: [v[0], v[1]] for k, v in self._msg_totals.items()}
            triggers = dict(self._trigger_counts)
        snap = build_swarm_snapshot(raws, totals, top_k=top_k)
        snap["msgs"] = {
            k: {"count": msgs[k][0], "bytes": msgs[k][1]} for k in sorted(msgs)
        }
        snap["triggers"] = {k: triggers[k] for k in sorted(triggers)}
        return snap

    def sample_summary(self) -> dict | None:
        """The compact cumulative form a timeline sample carries (the
        SLO swarm objectives delta it). ``None`` while the swarm plane
        has never seen a connection — idle processes stay byte-identical
        to a swarm-less build."""
        with self._lock:
            self._cells.read("peers")
            if not self._totals["connections"]:
                return None
            live = [t for k, t in self._peers.items() if k != _OVERFLOW_KEY]
            return {
                "peers": len(live) + self._overflow_live,
                "snubbed": sum(1 for t in live if t.snubbed),
                "bytes_down": self._totals["bytes_down"],
                "bytes_up": self._totals["bytes_up"],
                "blocks": self._totals["blocks"],
                "snubs": self._totals["snubs"],
                "announce_failed": self._totals["announce_failed"],
                "all_choked": 1 if self._all_choked_active else 0,
            }

    def active(self) -> bool:
        with self._lock:
            self._cells.read("peers")
            return bool(self._totals["connections"])

    def clear(self) -> None:
        with self._lock:
            self._cells.write("peers")
            self._peers.clear()
            for k in self._totals:
                self._totals[k] = 0
            self._msg_totals.clear()
            self._overflow_live = 0
            self._storm_active = False
            self._all_choked_active = False
            self._announce_streaks.clear()
            self._trigger_counts.clear()


_telemetry = None
# construction guard, same rationale as the pipeline ledger's: first use
# can race between the session loop and a metrics scrape thread
_telemetry_guard = named_lock("obs.swarm._guard")


def swarm_telemetry() -> SwarmTelemetry:
    """The process-wide swarm telemetry registry (constructed on first
    use, so TSAN enabling in conftest instruments its lock)."""
    global _telemetry
    if _telemetry is None:
        with _telemetry_guard:
            if _telemetry is None:
                _telemetry = SwarmTelemetry()
    return _telemetry
