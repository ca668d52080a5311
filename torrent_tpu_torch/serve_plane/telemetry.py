"""Serve-side observability: the bounded seeder-plane registry.

The swarm registry (:mod:`torrent_tpu_torch.obs.swarm`) answers "what is the
wire doing to US"; this one answers "what are WE doing for the swarm":
which egress path carried each block (the per-connection fallback
matrix), how the choke economics are rotating slots, and where the
accept gate turned connections away. Same discipline as every obs tier:

* one leaf :func:`named_lock`, shared state registered as a
  :func:`guard_attrs` cell (the session loop writes; metrics scraper
  threads read);
* bounded cardinality — :data:`MAX_TRACKED_PEERS` live per-peer records
  with an ``overflow`` fold, egress paths fixed to
  :data:`EGRESS_PATHS` + ``"other"``;
* a PURE rollup, :func:`build_serve_snapshot` (analysis determinism
  pass scope), total over hostile/partial raw dicts — the hypothesis
  property in tests/test_fuzz.py.

Choke-round durations live in a log2 bucket family (the shared
``obs/hist`` bounds) so the snapshot can publish a real histogram plus
p50/p99 without unbounded sample storage.
"""

from __future__ import annotations

from bisect import bisect_left

from torrent_tpu_torch.utils.locks import guard_attrs, named_lock
from torrent_tpu_torch.obs.hist import BUCKET_BOUNDS
from torrent_tpu_torch.obs.swarm import _as_int, _rtt_summary

__all__ = [
    "EGRESS_PATHS",
    "MAX_TRACKED_PEERS",
    "TOP_PEERS",
    "ServeTelemetry",
    "build_serve_snapshot",
    "serve_telemetry",
]

SERVE_VERSION = 1

# the fixed egress fallback matrix columns; anything else folds into
# "other" so the per-path series cardinality can never grow
EGRESS_PATHS = ("sendfile", "preadv", "copy")
# bounded reject reasons (gate + reactor verdicts)
REJECT_REASONS = ("backpressure", "per_ip", "capacity", "choked")

# live per-peer serve records; excess peers share one "overflow" record
MAX_TRACKED_PEERS = 64
# peers named individually in a snapshot/scrape; the rest fold
TOP_PEERS = 8

_OVERFLOW_KEY = "overflow"


class _PeerServe:
    """One peer's serve-side counters. Mutated under the registry lock."""

    __slots__ = ("key", "bytes_up", "blocks", "paths", "rejects")

    def __init__(self, key: str):
        self.key = key
        self.bytes_up = 0
        self.blocks = 0
        # path -> [blocks, bytes]: this peer's fallback matrix row
        self.paths: dict[str, list] = {}
        self.rejects = 0

    def raw(self) -> dict:
        return {
            "key": self.key,
            "bytes_up": self.bytes_up,
            "blocks": self.blocks,
            "paths": {k: [v[0], v[1]] for k, v in self.paths.items()},
            "rejects": self.rejects,
        }


# ------------------------------------------------------------ rollups
# (analysis determinism pass scope: no wall clock, no randomness, sorted
# iteration — every duration below was bucketed by the registry already)


# determinism-scope
def _serve_peer_entry(raw: dict) -> dict:
    """One snapshot peer entry from a raw serve record (pure, total)."""
    paths = raw.get("paths")
    paths = paths if isinstance(paths, dict) else {}
    return {
        "bytes_up": _as_int(raw.get("bytes_up")),
        "blocks": _as_int(raw.get("blocks")),
        "paths": {
            str(k): {
                "blocks": _as_int(paths[k][0]),
                "bytes": _as_int(paths[k][1]),
            }
            for k in sorted(paths, key=str)
            if isinstance(paths[k], (list, tuple)) and len(paths[k]) >= 2
        },
        "rejects": _as_int(raw.get("rejects")),
    }


# determinism-scope
def _serve_fold_entries(raws: list) -> dict:
    """Aggregate raw serve records into one overflow entry (pure):
    counters sum, path matrices merge key-wise. A raw carrying its own
    ``peers`` count (the registry's shared overflow record) contributes
    that count; ordinary records count 1."""
    folded = {
        "peers": sum(
            _as_int(raw.get("peers", 1), 1) if isinstance(raw, dict) else 1
            for raw in raws
        ),
        "bytes_up": 0,
        "blocks": 0,
        "rejects": 0,
    }
    paths: dict[str, list] = {}
    for raw in raws:
        folded["bytes_up"] += _as_int(raw.get("bytes_up"))
        folded["blocks"] += _as_int(raw.get("blocks"))
        folded["rejects"] += _as_int(raw.get("rejects"))
        pm = raw.get("paths")
        pm = pm if isinstance(pm, dict) else {}
        for k in sorted(pm, key=str):
            v = pm[k]
            if not isinstance(v, (list, tuple)) or len(v) < 2:
                continue
            slot = paths.setdefault(str(k), [0, 0])
            slot[0] += _as_int(v[0])
            slot[1] += _as_int(v[1])
    folded["paths"] = {
        k: {"blocks": paths[k][0], "bytes": paths[k][1]} for k in sorted(paths)
    }
    return folded


# determinism-scope
def build_serve_snapshot(
    peer_raws: dict,
    totals: dict,
    paths: dict | None = None,
    rounds: dict | None = None,
    top_k: int = TOP_PEERS,
) -> dict:
    """The pure seeder-plane rollup over finalized raw records.

    ``peer_raws``: key -> :meth:`_PeerServe.raw` dict. ``totals``: the
    registry's cumulative counters. ``paths``: process-wide egress
    matrix (path -> [blocks, bytes]). ``rounds``: the choke-round
    duration digest (``counts``/``count``/``sum`` log2 buckets plus the
    last round's facts). Top-``top_k`` peers by uploaded bytes are
    named; the rest fold into ``overflow``. Total and defensive:
    hostile/partial inputs produce a well-formed snapshot, never a
    crash — the hypothesis property in tests/test_fuzz.py."""
    src = peer_raws if isinstance(peer_raws, dict) else {}
    raws = {
        str(k): src[k]
        for k in sorted(src, key=str)
        if isinstance(src[k], dict)
    }
    # the shared overflow record is never a named peer (same exposition
    # rule as the swarm snapshot: peer="overflow" must appear once)
    shared_overflow = raws.pop(_OVERFLOW_KEY, None)
    order = sorted(
        raws,
        key=lambda k: (-_as_int(raws[k].get("bytes_up")), k),
    )
    top_k = max(0, _as_int(top_k))
    named = order[:top_k]
    fold_raws = [raws[k] for k in order[top_k:]]
    if shared_overflow is not None:
        fold_raws.append(shared_overflow)
    totals = totals if isinstance(totals, dict) else {}
    paths = paths if isinstance(paths, dict) else {}
    rounds = rounds if isinstance(rounds, dict) else {}
    counts = rounds.get("counts")
    counts = counts if isinstance(counts, list) else []
    last = rounds.get("last")
    last = last if isinstance(last, dict) else {}
    return {
        "v": SERVE_VERSION,
        "counts": {
            "serving": len(raws) + (
                _as_int(shared_overflow.get("peers"))
                if shared_overflow is not None
                else 0
            ),
        },
        "peers": {k: _serve_peer_entry(raws[k]) for k in named},
        "overflow": _serve_fold_entries(fold_raws) if fold_raws else None,
        "paths": {
            str(k): {
                "blocks": _as_int(paths[k][0]),
                "bytes": _as_int(paths[k][1]),
            }
            for k in sorted(paths, key=str)
            if isinstance(paths[k], (list, tuple)) and len(paths[k]) >= 2
        },
        "choke": {
            "round_s": _rtt_summary(
                counts, rounds.get("count"), rounds.get("sum")
            ),
            "round_counts": [_as_int(c) for c in counts],
            "last": {
                "unchoked": _as_int(last.get("unchoked")),
                "interested": _as_int(last.get("interested")),
                "optimistic": (
                    str(last.get("optimistic"))
                    if last.get("optimistic") is not None
                    else None
                ),
            },
        },
        "totals": {str(k): _as_int(totals[k]) for k in sorted(totals, key=str)},
    }


# --------------------------------------------------------------- registry


class ServeTelemetry:
    """Bounded seeder-plane telemetry. One global instance
    (:func:`serve_telemetry`) serves every torrent of the process;
    tests may construct private ones."""

    def __init__(self, max_peers: int = MAX_TRACKED_PEERS):
        self._lock = named_lock("serve.telemetry._lock")
        # dynamic lockset checking: the peer table, path matrix, and
        # round digest are one cell guarded by _lock (session loop
        # writes; metrics scraper threads read)
        self._cells = guard_attrs("serve.telemetry", "serve")
        self._max_peers = max(1, int(max_peers))
        self._peers: dict[str, _PeerServe] = {}
        self._overflow_live = 0
        self._paths: dict[str, list] = {}  # path -> [blocks, bytes]
        self._totals: dict[str, int] = {
            "bytes_up": 0,
            "blocks": 0,
            "rejects_backpressure": 0,
            "rejects_per_ip": 0,
            "rejects_capacity": 0,
            "rejects_choked": 0,
            "gate_evictions": 0,
            "rounds": 0,
            "optimistic_rotations": 0,
            "queue_cancels": 0,
        }
        self._round_counts = [0] * (len(BUCKET_BOUNDS) + 1)
        self._round_count = 0
        self._round_sum = 0.0
        self._round_last = {"unchoked": 0, "interested": 0, "optimistic": None}

    # ---------------------------------------------------------- lifecycle

    def peer_serving(self, key: str) -> None:
        with self._lock:
            self._cells.write("serve")
            if key in self._peers:
                return
            if len(self._peers) >= self._max_peers:
                self._overflow_live += 1
                if _OVERFLOW_KEY not in self._peers:
                    self._peers[_OVERFLOW_KEY] = _PeerServe(_OVERFLOW_KEY)
                return
            self._peers[key] = _PeerServe(key)

    def peer_gone(self, key: str) -> None:
        with self._lock:
            self._cells.write("serve")
            if self._peers.pop(key, None) is None and self._overflow_live > 0:
                self._overflow_live -= 1
                if self._overflow_live == 0:
                    self._peers.pop(_OVERFLOW_KEY, None)

    # ------------------------------------------------------------- events

    def _tel(self, key: str) -> _PeerServe | None:
        # caller holds self._lock; events for unregistered peers land on
        # the overflow record when one exists, else create lazily
        tel = self._peers.get(key) or self._peers.get(_OVERFLOW_KEY)
        if tel is None:
            if len(self._peers) < self._max_peers:
                tel = self._peers[key] = _PeerServe(key)
            else:
                self._overflow_live += 1
                tel = self._peers[_OVERFLOW_KEY] = _PeerServe(_OVERFLOW_KEY)
        return tel

    def on_egress(self, key: str, path: str, nbytes: int) -> None:
        """A block left through ``path`` — the fallback-matrix write."""
        path = path if path in EGRESS_PATHS else "other"
        with self._lock:
            self._cells.write("serve")
            self._totals["bytes_up"] += nbytes
            self._totals["blocks"] += 1
            slot = self._paths.setdefault(path, [0, 0])
            slot[0] += 1
            slot[1] += nbytes
            tel = self._tel(key)
            tel.bytes_up += nbytes
            tel.blocks += 1
            pslot = tel.paths.setdefault(path, [0, 0])
            pslot[0] += 1
            pslot[1] += nbytes

    def on_reject(self, key: str, reason: str) -> None:
        reason = reason if reason in REJECT_REASONS else "backpressure"
        with self._lock:
            self._cells.write("serve")
            self._totals[f"rejects_{reason}"] += 1
            tel = self._tel(key)
            tel.rejects += 1

    def on_gate_evictions(self, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self._cells.write("serve")
            self._totals["gate_evictions"] += n

    def on_queue_cancel(self, n: int = 1) -> None:
        if n <= 0:
            return
        with self._lock:
            self._cells.write("serve")
            self._totals["queue_cancels"] += n

    def on_choke_round(
        self,
        duration_s: float,
        unchoked: int,
        interested: int,
        optimistic: str | None,
        rotated: bool,
    ) -> None:
        with self._lock:
            self._cells.write("serve")
            self._totals["rounds"] += 1
            if rotated:
                self._totals["optimistic_rotations"] += 1
            if duration_s >= 0:
                self._round_counts[bisect_left(BUCKET_BOUNDS, duration_s)] += 1
                self._round_count += 1
                self._round_sum += duration_s
            self._round_last = {
                "unchoked": int(unchoked),
                "interested": int(interested),
                "optimistic": optimistic,
            }

    # ----------------------------------------------------------- snapshot

    def snapshot(self, top_k: int = TOP_PEERS) -> dict:
        """Raw records copied under the lock, rolled up by the pure
        rollup outside it."""
        with self._lock:
            self._cells.read("serve")
            raws = {k: t.raw() for k, t in self._peers.items()}
            if _OVERFLOW_KEY in raws:
                raws[_OVERFLOW_KEY]["peers"] = self._overflow_live
            totals = dict(self._totals)
            paths = {k: [v[0], v[1]] for k, v in self._paths.items()}
            rounds = {
                "counts": list(self._round_counts),
                "count": self._round_count,
                "sum": self._round_sum,
                "last": dict(self._round_last),
            }
        return build_serve_snapshot(raws, totals, paths, rounds, top_k=top_k)

    def active(self) -> bool:
        with self._lock:
            self._cells.read("serve")
            return bool(
                self._totals["blocks"]
                or self._totals["rounds"]
                or self._peers
            )

    def clear(self) -> None:
        with self._lock:
            self._cells.write("serve")
            self._peers.clear()
            self._overflow_live = 0
            self._paths.clear()
            for k in self._totals:
                self._totals[k] = 0
            self._round_counts = [0] * (len(BUCKET_BOUNDS) + 1)
            self._round_count = 0
            self._round_sum = 0.0
            self._round_last = {"unchoked": 0, "interested": 0, "optimistic": None}


_telemetry = None
# construction guard: first use can race between the session loop and a
# metrics scrape thread (same rationale as the swarm registry's)
_telemetry_guard = named_lock("serve.telemetry._guard")


def serve_telemetry() -> ServeTelemetry:
    """The process-wide serve telemetry registry (constructed on first
    use, so TSAN enabling in conftest instruments its lock)."""
    global _telemetry
    if _telemetry is None:
        with _telemetry_guard:
            if _telemetry is None:
                _telemetry = ServeTelemetry()
    return _telemetry
