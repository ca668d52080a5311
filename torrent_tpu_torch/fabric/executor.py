"""Per-process fabric executor: one process's shard of a pod-scale
library recheck, fed through the LOCAL continuous-batching scheduler.

``verify_library_distributed`` shards torrents across processes but
each shard runs a private ``verify_library`` batch loop — bypassing the
scheduler, so a pod-scale recheck and foreground verify traffic compete
for the hash plane instead of coalescing. The executor closes that gap:
its shard's pieces are submitted to the shared
:class:`~torrent_tpu_torch.sched.HashPlaneScheduler` as a low-priority
``"fabric"`` tenant, so bulk rechecks ride the same launches (and the
same retry/bisection/breaker machinery) as everyone else, and DRR keeps
them from starving interactive callers.

Failure layer. Processes exchange a periodic few-byte heartbeat —
sequence, in-flight units, completed-unit verdict bits, a degraded
flag, a distrust list, and a bounded fleet obs digest (``obs/fleet``:
ledger stage deltas, histogram summaries, sched + unit progress — the
raw material of ``fleet_snapshot()``'s swarm rollup) — over a pluggable
transport:

* :class:`FileHeartbeat` — atomic JSON files in a shared directory.
  Files outlive their writer and staleness is visible, so this is the
  transport that supports **lapse adoption**: when a peer's heartbeat
  goes stale, its unfinished units are re-assigned among the survivors
  by the deterministic :func:`~torrent_tpu_torch.fabric.plan.adoption_owner`
  rule — no claim protocol, every survivor computes the same answer.
* :class:`AllgatherHeartbeat` — one ``torch.distributed`` all-gather
  of a fixed-size ``uint8`` buffer, the same discipline as
  ``allgather_bitfield``: a few KiB per round is the only payload that
  crosses ranks. Collective, so a *dead* peer blocks the round (that is
  the reality of any process group); it still carries the degraded
  flag, so breaker-stuck adoption works on a healthy group.

A process whose sha1 lane breaker has been stuck open past
``breaker_stuck_after`` publishes ``degraded=True``: it keeps its
in-flight units (on a card its scheduler fails the launches the breaker
refuses, and on ``device="cpu"`` it degrades to hashlib) but yields its
unstarted ones to the survivors. Verdict bits adopted from a
lapsed or degraded peer are **sentinel cross-checked** — one reportedly
valid piece per adopted unit is re-hashed locally against the info
dict — so a worker with silently corrupt storage or a lying hash plane
cannot poison the global bitfield: a mismatch adds a ``(publisher,
unit)`` pair to the exchanged distrust list, every process discards
those verdicts, and a survivor re-verifies the unit locally.

Termination is symmetric by construction: verdicts are tracked per
publisher, only *published* verdicts count toward the heartbeat loop's
stop condition, and the distrust list is part of the exchange — so
after any round, every process evaluates the same coverage state and
all heartbeat loops stop on the same round (the collective transport
requires exactly this). The final per-unit verdict is picked by the
same deterministic rule everywhere (lowest acceptable publisher pid),
so :meth:`FabricExecutor.bitfields` is identical on every process.

Byzantine layer (``FabricConfig.byzantine_f > 0``). The sentinel path
above tolerates *one* liar per adopted unit; ``byzantine_f = f`` turns
the fabric into a plane spanning untrusted machines. Each unit is
verified by ``f + 1`` processes up front (:func:`~torrent_tpu_torch.fabric.
plan.replica_owners`), every published verdict carries a Merkle
receipt root (``fabric/receipts.py``: leaf = ``(unit, piece, digest,
ok)``; the root rides the heartbeat, bounded proofs are served on
demand so AllgatherHeartbeat budgets stay fixed), and a unit only
counts as covered once ``f + 1`` publishers committed *byte-identical*
verdicts. Liars are convicted three ways, all symmetric: a root that
doesn't match its published bits (or two roots for one unit) is a
free structural conviction on every process; each round every process
re-hashes a seeded pseudo-random slice of every peer's claimed-ok
pieces (:func:`~torrent_tpu_torch.fabric.receipts.audit_sample` — the
schedule is a pure function of plan fingerprint + seed, so audits
replay bit-identically) and a mismatch convicts with portable
``(peer, unit, piece)`` evidence that rides the heartbeat and is
re-verified locally by every receiver; and a distrust pair published
by ``f + 1`` distinct accusers convicts without local proof (at most
``f`` of them can be lying). A convicted liar's units re-enter the
existing adoption/top-up path. At ``f = 0`` none of this exists on
the wire: behavior and heartbeat bytes are bit-identical to the
pre-receipt fabric (pinned by test).
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from collections import deque
from dataclasses import dataclass

import numpy as np

from torrent_tpu_torch.fabric.plan import FabricPlan, adoption_owner, replica_owners
from torrent_tpu_torch.fabric.receipts import (
    audit_sample,
    merkle_proof,
    merkle_root,
    unit_leaves,
)
from torrent_tpu_torch.obs.fleet import DIGEST_MAX_BYTES, aggregate_fleet, obs_digest
from torrent_tpu_torch.obs.ledger import pipeline_ledger
from torrent_tpu_torch.obs.recorder import flight_recorder
from torrent_tpu_torch.obs.tracer import fabric_trace_id, heartbeat_span_context, tracer
from torrent_tpu_torch.utils.log import get_logger

log = get_logger("fabric")


# determinism-scope
def pack_bits(bits: np.ndarray) -> str:
    """bool verdict vector -> hex (the heartbeat's few-byte encoding)."""
    return np.packbits(np.asarray(bits, dtype=bool)).tobytes().hex()


# determinism-scope
def unpack_bits(hexstr: str, n: int) -> np.ndarray:
    raw = np.frombuffer(bytes.fromhex(hexstr), dtype=np.uint8)
    bits = np.unpackbits(raw)[:n]
    if len(bits) != n:
        raise ValueError(f"verdict payload too short for {n} pieces")
    return bits.astype(bool)


@dataclass
class FabricConfig:
    tenant: str = "fabric"
    # low priority: bulk rechecks yield to foreground verify traffic in
    # the scheduler's DRR, but are never starved (weight > 0)
    weight: float = 0.25
    # bound on payload bytes this executor holds in scheduler futures —
    # on top of the scheduler's own admission budget, so one fabric
    # sweep can't monopolize the shared queue either
    max_inflight_bytes: int = 64 << 20
    heartbeat_interval: float = 0.5
    # a peer whose newest heartbeat is older than this is lapsed (file
    # transport only; collective transports can't outlive a dead peer)
    lapse_after: float = 5.0
    # seconds a sha1 lane breaker must stay open before this process
    # declares itself degraded and yields its unstarted units
    breaker_stuck_after: float = 3.0
    # a unit in flight longer than factor x the mean unit time (and at
    # least min_s) is logged as a straggler
    straggler_factor: float = 4.0
    straggler_min_s: float = 10.0
    # consecutive failed heartbeat exchanges (lost shared dir, broken
    # collective) before the run aborts with a classified error rather
    # than spinning forever with stale state
    heartbeat_fail_limit: int = 20
    # carry the fleet obs digest (obs/fleet.py: ledger stage deltas,
    # histogram summaries, sched + unit progress) on every heartbeat —
    # the payload cost is budgeted into plan_payload_bytes; disable only
    # to shrink heartbeats on an extremely constrained transport
    carry_obs_digest: bool = True
    # scheduler-autopilot work rebalancing (sched/control.py closes the
    # observe→act loop; this is its fleet-level actuator): when the
    # fleet rollup names THIS process a straggler for rebalance_after
    # consecutive heartbeats, its unstarted units are offered to peers
    # with headroom over the heartbeat channel — the same yield/reclaim
    # and sentinel/distrust machinery the degraded path uses, so
    # rebalancing cannot weaken the trust model
    rebalance: bool = False
    rebalance_after: int = 3
    # TEST/FAULT HOOK (doctor --fabric, tests/test_fabric.py): publish a
    # final heartbeat then hard-exit the process after this many units
    # complete — the deterministic stand-in for a worker dying mid-run.
    # File transport only (an extra collective round would break the
    # allgather lockstep — and a dead peer wedges it anyway).
    fault_exit_after_units: int | None = None
    # ---- Byzantine verdict layer (fabric/receipts.py) ----
    # lying processes tolerated. 0 = the single-sentinel fast path:
    # behavior AND heartbeat bytes bit-identical to the pre-receipt
    # fabric (pinned by test). f > 0: f + 1 replicas verify each unit,
    # every published verdict commits a Merkle receipt root on the
    # heartbeat, claims are audit-sampled each round, and coverage
    # requires f + 1 byte-identical receipts (see module docstring)
    byzantine_f: int = 0
    # per-(peer, unit, piece, round) audit probability at f > 0 — the
    # draw is deterministic given (plan fingerprint, audit_seed), so a
    # run's audit schedule replays bit-identically. Must be > 0 when
    # byzantine_f > 0: audits are the only way conflicting honest
    # verdicts (divergent storage) ever resolve
    audit_rate: float = 0.05
    audit_seed: int = 0
    # TEST/FAULT HOOK (doctor --byzantine, --fault-plan
    # forge_receipts=1): claim every piece of our own units verified-ok
    # regardless of what hashing said, with a CONSISTENT receipt root
    # over the forged bits — the structural check passes, so only
    # audit re-hashing (or the f = 0 sentinel) can convict this liar
    forge_receipts: bool = False


FAULT_EXIT_CODE = 42  # fault_exit_after_units exits with this


class FileHeartbeat:
    """Heartbeat over atomic JSON files in a shared directory.

    One ``fabric_hb_<pid>.json`` per process, replaced atomically each
    round. Staleness (and absence) is visible to every reader, so this
    transport supports lapse detection — and the files outlive their
    writer, so a survivor can still read a dead peer's last published
    verdicts. Same-host tests and shared-filesystem pods use this.
    """

    supports_lapse = True

    def __init__(self, directory: str, pid: int, purge_stale_s: float | None = None):
        self.dir = directory
        self.pid = pid
        os.makedirs(directory, exist_ok=True)
        if purge_stale_s is not None:
            # a reused heartbeat dir must not feed a fresh run the
            # PREVIOUS run's verdicts (e.g. a re-check after repairing
            # data would silently return the pre-repair bitfield).
            # Files from live peers are refreshed every interval, so an
            # mtime older than the lapse window can only be leftovers.
            now = time.time()
            for name in os.listdir(directory):
                if not name.startswith("fabric_hb_"):
                    continue
                path = os.path.join(directory, name)
                try:
                    if now - os.path.getmtime(path) > purge_stale_s:
                        os.unlink(path)
                except OSError:
                    continue

    def _path(self, pid: int) -> str:
        return os.path.join(self.dir, f"fabric_hb_{pid}.json")

    def exchange(self, payload: dict) -> dict[int, dict]:
        tmp = self._path(self.pid) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self._path(self.pid))
        peers: dict[int, dict] = {}
        for name in os.listdir(self.dir):
            if not (name.startswith("fabric_hb_") and name.endswith(".json")):
                continue
            try:
                pid = int(name[len("fabric_hb_") : -len(".json")])
            except ValueError:
                continue
            if pid == self.pid:
                continue
            try:
                with open(os.path.join(self.dir, name)) as f:
                    peers[pid] = json.load(f)
            except (OSError, ValueError):
                continue  # mid-replace or corrupt: next round re-reads
        return peers


class AllgatherHeartbeat:
    """Heartbeat over one ``torch.distributed`` all-gather a round
    (``parallel/distributed.allgather_rows``) — the discipline
    ``allgather_bitfield`` set: a fixed ``u8[max_bytes + 4]`` buffer of
    a few KiB per round is the only payload that crosses ranks. Every
    rank derives ``max_bytes`` from ``plan_payload_bytes`` of the same
    plan, so every rank gathers the same size.

    Collective: every process must call :meth:`exchange` the same
    number of times, which the executor guarantees by terminating its
    heartbeat loop on the symmetric published-coverage condition. A
    dead peer therefore blocks the round — lapse adoption needs the
    file transport; this one carries the degraded flag and distrust
    list, so breaker-stuck adoption works on a healthy pod.
    """

    supports_lapse = False

    def __init__(self, nproc: int, pid: int, max_bytes: int):
        self.nproc = nproc
        self.pid = pid
        self.max_bytes = max_bytes
        # heartbeats that had to shed their obs digest to fit the
        # buffer — surfaced as torrent_tpu_fleet_digest_dropped_total
        self.digest_drops = 0

    def exchange(self, payload: dict) -> dict[int, dict]:
        from torrent_tpu_torch.parallel.distributed import allgather_rows

        raw = json.dumps(payload).encode()
        if len(raw) > self.max_bytes and "obs" in payload:
            # overflow hardening: the obs digest is advisory — shed it
            # FIRST (counted, never silent) so verdict bits still
            # publish; plan_payload_bytes budgets the worst-case digest,
            # so reaching this line already means the sizing was wrong
            payload = {k: v for k, v in payload.items() if k != "obs"}
            self.digest_drops += 1
            log.warning(
                "fabric heartbeat payload over the %dB allgather buffer; "
                "dropping the obs digest this round (drop #%d)",
                self.max_bytes, self.digest_drops,
            )
            raw = json.dumps(payload).encode()
        if len(raw) > self.max_bytes:
            # NEVER bail out before the collective — peers are already
            # blocked in the all-gather and a raise here would wedge
            # the whole pod. Participate with a minimal envelope (no
            # verdicts published this round) and scream; sizing comes
            # from plan_payload_bytes, so this is a should-not-happen.
            log.error(
                "fabric heartbeat payload %dB exceeds the %dB allgather "
                "buffer; sending minimal envelope this round",
                len(raw), self.max_bytes,
            )
            raw = json.dumps(
                {
                    "pid": payload.get("pid"),
                    "seq": payload.get("seq"),
                    "t": payload.get("t"),
                    "fp": payload.get("fp"),
                    "degraded": payload.get("degraded", False),
                    "overflow": True,
                }
            ).encode()
        buf = np.zeros(self.max_bytes + 4, dtype=np.uint8)
        buf[:4] = np.frombuffer(len(raw).to_bytes(4, "big"), dtype=np.uint8)
        buf[4 : 4 + len(raw)] = np.frombuffer(raw, dtype=np.uint8)
        rows = allgather_rows(buf)
        peers: dict[int, dict] = {}
        for p in range(rows.shape[0]):
            if p == self.pid:
                continue
            ln = int.from_bytes(rows[p, :4].tobytes(), "big")
            peers[p] = json.loads(rows[p, 4 : 4 + ln].tobytes().decode())
        return peers


# determinism-scope
def plan_payload_bytes(plan: FabricPlan, byzantine_f: int = 0) -> int:
    """Allgather buffer size for a plan: the worst-case heartbeat is
    every unit's verdict bits (hex doubles the packed bytes) plus
    per-unit JSON overhead, a distrust/redone list that can hold one
    entry per (publisher, unit) pair, a fixed envelope, and the
    worst-case fleet obs digest (clamped to DIGEST_MAX_BYTES by
    construction, so the budget term is exact). At ``byzantine_f > 0``
    the budget grows by the receipt plane's worst case — one 40-hex
    Merkle root per published unit plus conviction-evidence triples —
    and ONLY then: the default keeps every ``f = 0`` caller's buffer
    byte-identical to the pre-receipt sizing."""
    bits_hex = sum((u.npieces + 7) // 8 * 2 for u in plan.units)
    base = (
        4096
        + DIGEST_MAX_BYTES
        + bits_hex
        + 48 * len(plan.units)
        + 24 * len(plan.units) * plan.nproc  # distrust pairs, worst case
    )
    if byzantine_f > 0:
        base += (
            56 * len(plan.units)  # "uid": 40-hex root + JSON overhead
            + 24 * len(plan.units) * plan.nproc  # evidence triples
        )
    return base


_PENDING, _INFLIGHT, _DONE = "pending", "inflight", "done"


class FabricExecutor:
    """One process's fabric role: verify its shard through the local
    scheduler, heartbeat progress, adopt orphans. See the module
    docstring for the failure model."""

    def __init__(
        self,
        items,
        plan: FabricPlan,
        pid: int,
        scheduler,
        config: FabricConfig | None = None,
        transport=None,
        progress_cb=None,
    ):
        if not 0 <= pid < plan.nproc:
            raise ValueError(f"pid {pid} outside plan's {plan.nproc} processes")
        if transport is None and plan.nproc > 1:
            raise ValueError("multi-process plan needs a heartbeat transport")
        cfg = config or FabricConfig()
        if cfg.byzantine_f < 0:
            raise ValueError(f"byzantine_f must be >= 0, got {cfg.byzantine_f}")
        if cfg.byzantine_f > 0 and not 0.0 < cfg.audit_rate <= 1.0:
            # audits are the only resolution path for conflicting honest
            # verdicts, so a zero rate at f > 0 can deadlock coverage
            raise ValueError(
                f"audit_rate must be in (0, 1] when byzantine_f > 0, "
                f"got {cfg.audit_rate}"
            )
        self.items = items
        self.plan = plan
        self.pid = pid
        self.scheduler = scheduler
        self.config = cfg
        self.transport = transport
        self.progress_cb = progress_cb
        self._fp = plan.fingerprint()
        # deterministic trace id (plan fingerprint + pid): every process
        # names the sweep the same way without exchanging random bytes,
        # and the heartbeat span context stays inside the analysis
        # plane's determinism pass
        self._trace_id = fabric_trace_id(self._fp, pid)
        # local work state. At byzantine_f > 0 the queue widens from the
        # planned shard to every unit whose replica set (f + 1 pids in
        # ring order from the owner) includes us, so quorum coverage
        # doesn't wait on top-up elections in the happy path; f = 0
        # keeps the exact single-owner queue.
        if cfg.byzantine_f > 0:
            mine = [
                u.uid
                for u in plan.units
                if pid
                in replica_owners(
                    u.uid, plan.owner[u.uid], plan.nproc, cfg.byzantine_f
                )
            ]
        else:
            mine = [u.uid for u in plan.units_for(pid)]
        self._queue: deque[int] = deque(mine)
        self._status: dict[int, str] = {u: _PENDING for u in self._queue}
        # verdicts per (unit, publisher): own results live under our own
        # pid; peers' published results are merged in. The deterministic
        # picker in bitfields() reads the same structure on every process.
        self._verdicts: dict[int, dict[int, np.ndarray]] = {}
        self._published_done: set[int] = set()
        self._peer_seen: dict[int, dict] = {}  # pid -> latest payload
        # liveness by LOCAL monotonic receipt of seq advances — never by
        # the payload's wall-clock stamp, which cross-host clock skew
        # would turn into permanent false lapses
        self._peer_advance: dict[int, tuple[int, float]] = {}
        # (publisher, uid) pairs whose verdicts failed a sentinel check —
        # exchanged in every heartbeat so coverage stays symmetric
        self._distrust: set[tuple[int, int]] = set()
        self._checked: set[tuple[int, int]] = set()
        # pairs retired by a re-verification (ours published as
        # "redone"; peers' redone processed into here) — the distrust
        # merge skips them so stale heartbeat files can't resurrect a
        # superseded rejection
        self._superseded: set[tuple[int, int]] = set()
        # ---- Byzantine verdict layer (byzantine_f > 0) ----
        # first root each publisher committed per unit: a SECOND,
        # different root for the same (publisher, unit) is equivocation
        # — a free conviction, no re-hash needed
        self._peer_roots: dict[tuple[int, int], str] = {}
        self._roots_checked: set[tuple[int, int]] = set()
        self._root_cache: dict[tuple[int, str], str] = {}
        # audit plane: (peer, unit, piece) claims already re-hashed; our
        # own portable conviction evidence rides the heartbeat "evid"
        # field and is re-verified locally by every receiver
        self._audited: set[tuple[int, int, int]] = set()
        self._evidence: list[tuple[int, int, int]] = []
        self._evid_seen: set[tuple[int, int, int]] = set()
        # accusation quorum: distrust pairs by distinct peer accuser —
        # f + 1 accusers convict even without local evidence (at most f
        # of them can be lying)
        self._accusations: dict[tuple[int, int], set[int]] = {}
        # units stuck short of quorum with no untainted verifier left
        # (honest disagreement = divergent storage): after a few rounds
        # the quorum requirement is waived — loudly — so the sweep
        # terminates instead of wedging
        self._quorum_stuck: dict[int, int] = {}
        self._quorum_waived: set[int] = set()
        # False while convictions/evidence recorded since the last
        # successful exchange have not yet ridden a heartbeat: the loop
        # must not stop on a round whose MERGE convicted someone, or the
        # evidence never reaches peers (heartbeat files outlive their
        # writer, so one flushing exchange is enough). Always True at
        # f = 0 — termination is bit-identical to the pre-receipt fabric
        self._trust_flushed = True
        self._yielded: dict[int, float] = {}  # uid -> yield time
        # autopilot rebalancing: unstarted units currently OFFERED to
        # peers with headroom (rides the heartbeat "offer" field; every
        # offered uid is also in _yielded so the reclaim path takes it
        # back if nobody adopts)
        self._offered: set[int] = set()
        self._straggler_streak = 0
        self._warned_straggler: set[int] = set()
        self._unit_started: dict[int, float] = {}
        self._unit_times: list[float] = []
        self._breaker_open_since: dict[str, float] = {}
        self._degraded = False
        # counters / gauges (metrics_snapshot)
        self._seq = 0
        self._units_done = 0
        self._units_adopted = 0
        self._units_offered = 0
        self._units_rebalanced = 0  # adopted specifically from an offer
        self._pieces_verified = 0
        self._sentinel_checks = 0
        self._sentinel_mismatches = 0
        self._audit_checks = 0
        self._audit_mismatches = 0
        self._convictions = 0
        self._evidence_rejected = 0
        self._quorum_verifies = 0
        self._quorum_waivers = 0
        self._stragglers = 0
        self._hb_errors = 0
        self._hb_consec_fail = 0
        self._hb_fatal: Exception | None = None
        self._inflight_bytes = 0
        self._bytes_cond: asyncio.Condition | None = None
        self._last_exchange: float | None = None
        self._started_mono = time.monotonic()
        self._started_wall = time.time()
        self._state = "idle"
        # fleet obs plane: digests are ledger DELTAS against this base,
        # so a long-lived process's earlier traffic never dilutes the
        # sweep's attribution; peers' digests ride _peer_seen
        self._obs_base = pipeline_ledger().snapshot()

    # ---------------------------------------------------------- coverage

    def _own_bits(self) -> dict[int, np.ndarray]:
        # iteration order doesn't matter here: the heartbeat payload
        # sorts own.items() and _published_done is a set
        return {
            uid: pubs[self.pid]
            for uid, pubs in self._verdicts.items()
            if self.pid in pubs
        }

    # determinism-scope
    def _quorum_groups(self, uid: int, published_only: bool) -> dict[str, list[int]]:
        """Non-distrusted publishers of a unit grouped by EXACT verdict
        bytes (``pack_bits``): the quorum rule counts *matching*
        receipts, so two publishers differing on one piece are distinct
        claims. Pure function of exchanged state (determinism-pass
        scope), so every process groups identically."""
        groups: dict[str, list[int]] = {}
        for p in sorted(self._verdicts.get(uid, ())):
            if (p, uid) in self._distrust:
                continue
            if published_only and p == self.pid and uid not in self._published_done:
                continue
            groups.setdefault(pack_bits(self._verdicts[uid][p]), []).append(p)
        return groups

    # determinism-scope
    def _unit_need(self, uid: int) -> int:
        """Matching receipts required to cover a unit: ``f + 1``,
        clamped to the processes still eligible to publish it (not
        distrusted on this unit) — convictions must shrink the quorum
        or a single convicted liar could wedge termination at small
        nproc. Symmetric: the distrust set is exchanged state."""
        if self.config.byzantine_f == 0:
            return 1
        eligible = sum(
            1
            for p in range(self.plan.nproc)
            if (p, uid) not in self._distrust
        )
        return max(1, min(self.config.byzantine_f + 1, eligible))

    def _unit_covered(self, uid: int, published_only: bool = False) -> bool:
        """An acceptable verdict exists for the unit: at ``f = 0`` any
        non-distrusted verdict; at ``f > 0`` a quorum of ``f + 1``
        byte-identical receipts (``_unit_need``-clamped; quorum-waived
        units fall back to the f = 0 rule so divergent-storage
        disagreement terminates instead of wedging).
        ``published_only`` restricts our OWN verdicts to those already
        exchanged — the symmetric form every process evaluates equally,
        so heartbeat loops all stop on the same round."""
        if self.config.byzantine_f > 0 and uid not in self._quorum_waived:
            need = self._unit_need(uid)
            return any(
                len(ps) >= need
                for ps in self._quorum_groups(uid, published_only).values()
            )
        for p in self._verdicts.get(uid, ()):
            if (p, uid) in self._distrust:
                continue
            if published_only and p == self.pid and uid not in self._published_done:
                continue
            return True
        return False

    def _covered(self) -> bool:
        return all(self._unit_covered(u.uid) for u in self.plan.units)

    def _covered_published(self) -> bool:
        return all(
            self._unit_covered(u.uid, published_only=True)
            for u in self.plan.units
        )

    # determinism-scope
    def bitfields(self) -> list[np.ndarray]:
        """Global per-torrent bitfields from the merged verdict view.

        Per unit, the verdict used is the lowest-pid publisher whose
        (publisher, unit) pair is not distrusted — a pure function of
        exchanged state, so every process assembles the identical global
        bitfield once run() returns. At ``byzantine_f > 0`` a quorum
        group (>= ``_unit_need`` publishers with byte-identical bits)
        outranks any lone verdict; among qualifying groups the one with
        the lowest member pid wins — still a pure function of exchanged
        state."""
        out = [np.zeros(info.num_pieces, dtype=bool) for _, info in self.items]
        for u in self.plan.units:
            pubs = self._verdicts.get(u.uid)
            if not pubs:
                continue
            if self.config.byzantine_f > 0:
                need = self._unit_need(u.uid)
                quorum = sorted(
                    (min(ps), key)
                    for key, ps in self._quorum_groups(u.uid, False).items()
                    if len(ps) >= need
                )
                if quorum:
                    out[u.torrent][u.start : u.stop] = pubs[quorum[0][0]]
                    continue
            ok = [p for p in sorted(pubs) if (p, u.uid) not in self._distrust]
            pick = ok[0] if ok else sorted(pubs)[0]
            out[u.torrent][u.start : u.stop] = pubs[pick]
        return out

    # -------------------------------------------------------------- run

    async def run(self) -> None:
        self._state = "running"
        t_run = time.monotonic()
        self.scheduler.register_tenant(
            self.config.tenant, weight=self.config.weight
        )
        self._bytes_cond = asyncio.Condition()
        hb_task = (
            asyncio.ensure_future(self._heartbeat_loop())
            if self.transport is not None
            else None
        )
        try:
            while not self._covered():
                if self._hb_fatal is not None:
                    raise self._hb_fatal
                uid = self._next_uid()
                if uid is None:
                    if self.transport is None:
                        raise RuntimeError(
                            "solo fabric run drained its queue without coverage"
                        )
                    # waiting on peers (or on adoption): idle briefly
                    await asyncio.sleep(
                        min(self.config.heartbeat_interval, 0.05)
                    )
                    continue
                await self._verify_unit(uid)
            self._state = "done"
        except BaseException:
            self._state = "failed"
            raise
        finally:
            if hb_task is not None:
                # the loop terminates itself on published coverage (the
                # collective transport needs every process to stop on
                # the same round); on failure paths cancel it instead
                if self._state == "done":
                    await hb_task
                else:
                    hb_task.cancel()
                    try:
                        await hb_task
                    except (asyncio.CancelledError, Exception):
                        pass
            tracer().add_span(
                self._trace_id, "fabric.run", t0=t_run,
                status="ok" if self._state == "done" else "error",
                pid=self.pid, units_done=self._units_done,
                units_adopted=self._units_adopted,
                pieces_verified=self._pieces_verified,
            )

    def _next_uid(self) -> int | None:
        while self._queue:
            uid = self._queue.popleft()
            if self._unit_covered(uid):
                continue  # a peer (or an adoption race) already covered it
            return uid
        return None

    # ------------------------------------------------------ verification

    async def _acquire_bytes(self, n: int) -> None:
        async with self._bytes_cond:
            await self._bytes_cond.wait_for(
                lambda: self._inflight_bytes == 0
                or self._inflight_bytes + n <= self.config.max_inflight_bytes
            )
            self._inflight_bytes += n

    async def _release_bytes(self, n: int) -> None:
        async with self._bytes_cond:
            self._inflight_bytes -= n
            self._bytes_cond.notify_all()

    async def _verify_unit(self, uid: int) -> None:
        from torrent_tpu_torch.parallel.verify import read_chunk_for_sched
        from torrent_tpu_torch.sched import SchedLaunchError

        unit = self.plan.units[uid]
        storage, info = self.items[unit.torrent]
        self._status[uid] = _INFLIGHT
        self._unit_started[uid] = time.monotonic()
        bits = np.zeros(unit.npieces, dtype=bool)
        chunk = self.scheduler.chunk_for(info.piece_length)
        futs: deque = deque()
        n_ok = 0

        async def drain_one() -> None:
            nonlocal n_ok
            fut, keep, nb = futs.popleft()
            try:
                ok = await fut
            except SchedLaunchError as e:
                log.warning(
                    "fabric unit %d: %d pieces unverified (launch failed: %s)",
                    uid, len(keep), e,
                )
                ok = None  # stay False: recheck later
            finally:
                await self._release_bytes(nb)
            if ok is not None:
                for j, i in enumerate(keep):
                    bits[i - unit.start] = bool(ok[j])
                n_ok += len(keep)

        for start in range(unit.start, unit.stop, chunk):
            idxs = list(range(start, min(start + chunk, unit.stop)))
            # zero-copy when the local scheduler's ingest pool covers
            # this geometry (slot-carrying submission), byte chunks
            # otherwise — same helper as the verify/bulk sessions, so
            # fabric units ride the identical read contract
            ck = await asyncio.to_thread(
                read_chunk_for_sched, storage, info, idxs, self.scheduler
            )
            if ck.empty:
                ck.discard()
                continue
            nb = ck.nbytes
            # free budget by draining the oldest outstanding launch
            # rather than blocking in _acquire_bytes: a unit bigger than
            # max_inflight_bytes would otherwise deadlock (releases only
            # happen here, in this coroutine)
            while futs and (
                self._inflight_bytes
                and self._inflight_bytes + nb > self.config.max_inflight_bytes
            ):
                await drain_one()
            await self._acquire_bytes(nb)
            try:
                # wait=True: backpressure pauses the read loop; the
                # chunk releases its slab hold on every path itself
                fut = await ck.enqueue(
                    self.scheduler, self.config.tenant, wait=True
                )
            except BaseException:
                await self._release_bytes(nb)
                raise
            futs.append((fut, ck.keep, nb))
        while futs:
            await drain_one()
        if self.config.forge_receipts:
            # TEST/FAULT HOOK: lie — claim the whole unit verified-ok.
            # The receipt root is computed over these forged bits, so
            # the commitment is self-consistent and only an audit
            # re-hash (or the f = 0 sentinel) can convict us.
            bits[:] = True
        self._verdicts.setdefault(uid, {})[self.pid] = bits
        self._status[uid] = _DONE
        self._units_done += 1
        # count pieces actually hashed — unreadable pieces and failed
        # launches must not inflate the verified gauge or progress
        self._pieces_verified += n_ok
        t_started = self._unit_started.pop(uid)
        self._unit_times.append(time.monotonic() - t_started)
        tracer().add_span(
            self._trace_id, "fabric.unit", t0=t_started, uid=uid,
            pieces=unit.npieces, ok=n_ok, torrent=unit.torrent, pid=self.pid,
        )
        if self.progress_cb:
            self.progress_cb(self._pieces_verified, self.plan.total_pieces)
        cfg = self.config
        if (
            cfg.fault_exit_after_units is not None
            and self._units_done >= cfg.fault_exit_after_units
        ):
            # deterministic worker-death injection: publish what we have
            # (so peers adopt only what we did NOT finish), then die at
            # the unit boundary — no cleanup, like a real SIGKILL
            if self.transport is not None:
                await self._heartbeat_once()
            log.warning(
                "fabric fault injection: exiting after %d units", self._units_done
            )
            os._exit(FAULT_EXIT_CODE)

    # --------------------------------------------------------- heartbeat

    async def _heartbeat_loop(self) -> None:
        while True:
            ok = await self._heartbeat_once()
            if ok:
                self._hb_consec_fail = 0
            else:
                self._hb_consec_fail += 1
                if self._hb_consec_fail >= self.config.heartbeat_fail_limit:
                    # a dead transport (lost shared dir, broken
                    # collective) must abort the run with a classified
                    # error, not spin forever on stale state — run()
                    # re-raises this on its next loop pass
                    self._hb_fatal = RuntimeError(
                        f"fabric heartbeat failed {self._hb_consec_fail} "
                        "consecutive exchanges; aborting the sweep"
                    )
                    return
            # at f > 0 a round's merge can convict a publisher — which
            # both completes our coverage (the convicted pair leaves the
            # quorum denominator) and records evidence the payload built
            # BEFORE the merge never carried. Stopping here would strand
            # that evidence locally; peers would waive quorum instead of
            # convicting the same liar. One more flushing round fixes it
            # (heartbeat files outlive their writer). Vacuous at f = 0.
            if self._covered_published() and self._trust_flushed:
                return
            await asyncio.sleep(self.config.heartbeat_interval)

    # determinism-scope
    async def _heartbeat_once(self) -> None:
        self._refresh_degraded()
        self._update_rebalance()
        self._seq += 1
        own = self._own_bits()
        payload = {
            "pid": self.pid,
            "seq": self._seq,
            "t": time.time(),
            "fp": self._fp,
            # span context for the analysis/obs planes: deterministic by
            # construction (fingerprint-derived id, seq counter — no
            # wall clock, no randomness reaches exchanged bytes)
            "span": heartbeat_span_context(self._trace_id, self._seq),
            "degraded": self._degraded,
            "done": {str(uid): pack_bits(b) for uid, b in sorted(own.items())},
            "inflight": sorted(self._unit_started),
            "distrust": sorted([p, u] for p, u in self._distrust),
            "redone": sorted(
                u for p, u in self._superseded if p == self.pid
            ),
            # autopilot rebalancing: unstarted units this (straggling)
            # process offers to peers with headroom (empty unless the
            # rebalance actuator is on and the straggler streak fired)
            "offer": sorted(self._offered),
        }
        if self.config.byzantine_f > 0:
            payload.update(self._receipt_payload(own))
        if self.config.carry_obs_digest:
            payload["obs"] = self._build_obs_digest()
        try:
            peers = await asyncio.to_thread(self.transport.exchange, payload)
        except Exception as e:
            self._hb_errors += 1
            log.warning("fabric heartbeat exchange failed: %s", e)
            return False
        self._last_exchange = time.monotonic()
        # only after a successful exchange do our verdicts count as
        # published — the symmetric-coverage condition depends on peers
        # actually having been able to see them
        self._published_done = set(own)
        # sorted: merge order must match on every process so the shared
        # coverage/adoption state stays symmetric round for round
        for p, pl in sorted(peers.items()):
            if pl.get("fp") != self._fp:
                log.warning(
                    "fabric peer %s heartbeat carries plan %s != ours %s; "
                    "ignoring (inputs diverged?)", p, pl.get("fp"), self._fp,
                )
                continue
            self._peer_seen[p] = pl
            seq = int(pl.get("seq", 0))
            prev = self._peer_advance.get(p)
            if prev is None or seq != prev[0]:
                self._peer_advance[p] = (seq, time.monotonic())
            for pair in pl.get("distrust", []):
                pair = (int(pair[0]), int(pair[1]))
                if self.config.byzantine_f == 0:
                    # f = 0: peers are trusted reporters — merge blindly
                    # (the pre-receipt fast path, bit-identical)
                    if pair not in self._superseded:
                        self._distrust.add(pair)
                elif p != pair[0]:
                    # f > 0: a bare distrust pair is an ACCUSATION, not
                    # a verdict — f liars could otherwise evict honest
                    # publishers by gossip alone. Conviction needs local
                    # proof (structural check, audit, or re-verified
                    # evidence) or f + 1 distinct accusers
                    # (_audit_round); self-accusations never count.
                    self._accusations.setdefault(pair, set()).add(p)
        await self._merge_and_adopt()
        self._check_stragglers()
        if self.config.byzantine_f > 0:
            # the merge above may have convicted (audit/evidence/
            # structural) AFTER this round's payload was built — those
            # verdicts must still ride a future heartbeat before the
            # loop may stop (see _heartbeat_loop)
            self._trust_flushed = (
                payload["distrust"]
                == sorted([p, u] for p, u in self._distrust)
                and payload.get("evid", [])
                == sorted([p, u, pc] for p, u, pc in self._evidence)
            )
        return True

    @staticmethod
    def _scoreboard_rows(rollup: dict) -> dict[int, dict]:
        """pid -> scoreboard row of a fleet rollup (shared by the
        straggler-streak gate and the offer law, so the two can never
        diverge on which rows count)."""
        return {
            int(r["pid"]): r
            for r in rollup.get("scoreboard") or []
            if isinstance(r, dict) and "pid" in r
        }

    # determinism-scope
    def _rebalance_offers(self, rollup: dict) -> list[int]:
        """Unstarted units this process should offer to peers, given a
        fleet rollup (``fleet_snapshot``): everything still PENDING in
        our queue, but only when the scoreboard names us a straggler
        AND at least one healthy non-straggler peer exists to absorb
        the work. Pure function of the rollup + local queue state (the
        analysis determinism pass holds it to the heartbeat rules)."""
        rows = self._scoreboard_rows(rollup)
        me = rows.get(self.pid)
        if me is None or not me.get("straggler"):
            return []
        if not any(
            p != self.pid
            and rows[p].get("status") == "ok"
            and not rows[p].get("straggler")
            for p in rows
        ):
            return []  # nobody with headroom to absorb the work
        return sorted(
            u for u in self._queue if self._status.get(u) == _PENDING
        )

    def _update_rebalance(self) -> None:
        """The autopilot's fleet actuator, laggard side: after
        ``rebalance_after`` consecutive heartbeats in which the fleet
        rollup names this process a straggler, move every unstarted
        unit into the offered set (and the yield/reclaim machinery, so
        unadopted offers come back)."""
        cfg = self.config
        if not cfg.rebalance or self.plan.nproc <= 1 or self.transport is None:
            return
        roll = self.fleet_snapshot()
        if (self._scoreboard_rows(roll).get(self.pid) or {}).get("straggler"):
            self._straggler_streak += 1
        else:
            self._straggler_streak = 0
        if self._straggler_streak < cfg.rebalance_after:
            return  # the (queue-walking) offer law only runs past the gate
        now = time.monotonic()
        for uid in self._rebalance_offers(roll):
            if uid in self._offered or uid not in self._queue:
                continue
            self._queue.remove(uid)
            self._offered.add(uid)
            self._yielded[uid] = now
            self._units_offered += 1
            log.warning(
                "fabric rebalance: offering unstarted unit %d to peers "
                "with headroom (straggler x%d heartbeats)",
                uid, self._straggler_streak,
            )

    def _peer_age(self, p: int) -> float:
        """Seconds since we LOCALLY observed this peer's seq advance —
        monotonic receipt time, never the payload's wall-clock stamp
        (cross-host clock skew would turn that into permanent false
        lapses). A never-seen peer ages from our own start."""
        adv = self._peer_advance.get(p)
        if adv is None:
            return time.monotonic() - self._started_mono
        return time.monotonic() - adv[1]

    def _unavailable(self) -> tuple[set[int], set[int]]:
        """(lapsed, degraded) peer sets from the latest heartbeat view."""
        lapsed: set[int] = set()
        degraded: set[int] = set()
        for p in range(self.plan.nproc):
            if p == self.pid:
                continue
            if (
                self.transport.supports_lapse
                and self._peer_age(p) > self.config.lapse_after
            ):
                lapsed.add(p)
            elif self._peer_seen.get(p, {}).get("degraded"):
                degraded.add(p)
        return lapsed, degraded

    async def _merge_and_adopt(self) -> None:
        cfg = self.config
        now = time.monotonic()
        lapsed, degraded = self._unavailable()
        unavailable = lapsed | degraded
        survivors = [
            p
            for p in range(self.plan.nproc)
            if p not in unavailable and (p != self.pid or not self._degraded)
        ]
        if not survivors:
            # everyone is degraded/lapsed: progress beats purity — keep
            # our own units rather than stranding the sweep
            survivors = [self.pid]
        # 1. merge published verdicts; verdicts from an unavailable peer
        # get one sentinel re-hash per (publisher, unit) before trust.
        # A peer's "redone" list retires a distrusted pair first: the
        # re-verified verdict replaces the rejected one and goes back
        # through the sentinel gate like any fresh publication.
        for p, pl in self._peer_seen.items():
            for uid_s in pl.get("redone", []):
                pair = (p, int(uid_s))
                if pair in self._distrust:
                    self._distrust.discard(pair)
                    self._checked.discard(pair)
                    self._verdicts.get(pair[1], {}).pop(p, None)
                    self._superseded.add(pair)
                    # a legitimate re-verification publishes NEW bits
                    # under a NEW root: forget the old commitment so the
                    # equivocation check doesn't convict the redo
                    self._peer_roots.pop(pair, None)
                    self._roots_checked.discard(pair)
            for uid_s, hexbits in pl.get("done", {}).items():
                uid = int(uid_s)
                if p in self._verdicts.get(uid, ()):
                    continue
                try:
                    bits = unpack_bits(hexbits, self.plan.units[uid].npieces)
                except (ValueError, IndexError):
                    continue
                self._verdicts.setdefault(uid, {})[p] = bits
        # 1a. Byzantine verdict layer: structural receipt checks, peer
        # evidence re-verification, accusation quorum, audit sampling —
        # BEFORE the adoption phases so this round's convictions feed
        # the same round's orphan set (symmetric conviction → symmetric
        # re-verification).
        if cfg.byzantine_f > 0:
            await self._audit_round()
        # 1b. cross-check foreign verdicts held from any UNAVAILABLE
        # publisher — including ones accepted while it was still healthy
        # (the lapse came later): one sentinel re-hash per (publisher,
        # unit). A mismatch goes on the exchanged distrust list, so
        # every process drops those verdicts and the unit is re-verified
        # by a survivor — a degraded or dead worker cannot silently
        # poison the global bitfield.
        for uid, pubs in list(self._verdicts.items()):
            for p in unavailable:
                if p not in pubs or (p, uid) in self._checked:
                    continue
                self._checked.add((p, uid))
                if not await self._sentinel_check(uid, pubs[p]):
                    self._sentinel_mismatches += 1
                    self._distrust.add((p, uid))
                    log.warning(
                        "fabric sentinel mismatch on unit %d from peer %d: "
                        "discarding its verdicts, re-verifying",
                        uid, p,
                    )
                    # black box at the moment of distrust: which peer,
                    # which unit, what the fabric looked like
                    flight_recorder().trigger(
                        "fabric_distrust",
                        detail={"peer": p, "unit": uid, "pid": self.pid},
                        trace_ids=(self._trace_id,),
                        snapshots={"fabric": self.metrics_snapshot()},
                    )
        # 2. degraded self: yield unstarted units a survivor will adopt
        if self._degraded:
            for uid in list(self._queue):
                if (
                    adoption_owner(uid, survivors) != self.pid
                    and uid not in self._yielded
                ):
                    self._yielded[uid] = now
                    self._queue.remove(uid)
                    log.warning(
                        "fabric: yielding unit %d (breaker stuck open)", uid
                    )
        # 3. reclaim yields nobody picked up (the adopter lapsed, or we
        # recovered and the survivor set moved on)
        reclaim_after = cfg.lapse_after + 2 * cfg.heartbeat_interval
        inflight_elsewhere: set[int] = set()
        for p, pl in self._peer_seen.items():
            if p not in lapsed:
                inflight_elsewhere.update(int(u) for u in pl.get("inflight", []))
        for uid, t0 in list(self._yielded.items()):
            if self._unit_covered(uid):
                del self._yielded[uid]
                self._offered.discard(uid)
            elif uid in inflight_elsewhere:
                self._yielded[uid] = now  # someone is on it; keep waiting
            elif now - t0 > reclaim_after:
                del self._yielded[uid]
                self._offered.discard(uid)
                self._status[uid] = _PENDING
                self._queue.append(uid)
                log.warning("fabric: reclaiming yielded unit %d", uid)
        # 4. adopt orphans: uncovered units whose responsible process is
        # unavailable (or whose only verdicts were distrusted), not in
        # flight on any available peer. Units OFFERED by a straggling
        # peer (autopilot rebalancing) join the same orphan set — the
        # adoption rule, the sentinel gate, and the distrust machinery
        # apply to them unchanged, so rebalancing can't weaken trust.
        offered_elsewhere: dict[int, int] = {}
        for p, pl in sorted(self._peer_seen.items()):
            if p in lapsed:
                continue  # a dead peer's stale offer is plain adoption
            for uid_s in pl.get("offer", []):
                offered_elsewhere.setdefault(int(uid_s), p)
        # headroom gate on the ADOPTION side too: an offered unit must
        # move to a peer with headroom, never to another straggler —
        # the same scoreboard rule the offer law applied
        offer_helpers: set[int] = set()
        if offered_elsewhere:
            rows = self._scoreboard_rows(self.fleet_snapshot())
            offer_helpers = {
                p
                for p in rows
                if rows[p].get("status") == "ok"
                and not rows[p].get("straggler")
            }
        distrusted_uids = {u for _, u in self._distrust}
        for u in self.plan.units:
            uid = u.uid
            owner = self.plan.owner[uid]
            offerer = offered_elsewhere.get(uid)
            orphan = (
                owner in unavailable
                or uid in distrusted_uids
                or offerer is not None
            )
            if not orphan or self._unit_covered(uid):
                continue
            if uid in inflight_elsewhere:
                continue  # an alive peer is already verifying it
            if uid in self._yielded:
                continue  # we yielded it; reclaim path handles comebacks
            # never route the re-verify to a survivor whose own verdict
            # is the distrusted one — its _DONE status would skip the
            # requeue and the sweep would never converge. The offerer is
            # excluded too: it keeps no claim while an offer stands.
            candidates = [
                s
                for s in survivors
                if (s, uid) not in self._distrust and s != offerer
            ]
            pure_offer = (
                offerer is not None
                and owner not in unavailable
                and uid not in distrusted_uids
            )
            if pure_offer:
                # rebalancing (not a lapse/distrust): only peers with
                # headroom may take the unit; with none, nobody adopts
                # and the offerer's reclaim path takes it back
                candidates = [s for s in candidates if s in offer_helpers]
                if not candidates or adoption_owner(uid, candidates) != self.pid:
                    continue
            elif adoption_owner(uid, candidates or survivors) != self.pid:
                continue
            if (
                (self.pid, uid) in self._distrust
                and self._status.get(uid) == _DONE
            ):
                # no untainted candidate left: supersede our own
                # rejected verdict and re-verify — published as
                # "redone" so peers retire the distrust pair too
                self._distrust.discard((self.pid, uid))
                self._superseded.add((self.pid, uid))
                self._verdicts.get(uid, {}).pop(self.pid, None)
            elif self._status.get(uid) in (_PENDING, _INFLIGHT, _DONE):
                continue  # ours already (queued, running, or done)
            self._status[uid] = _PENDING
            self._queue.append(uid)
            self._units_adopted += 1
            if offerer is not None and owner not in unavailable:
                self._units_rebalanced += 1
                log.warning(
                    "fabric rebalance: adopting offered unit %d from "
                    "straggler %d", uid, offerer,
                )
            else:
                log.warning(
                    "fabric: adopting unit %d from process %d (%s)",
                    uid, owner,
                    "lapsed" if owner in lapsed else "degraded/distrusted",
                )
        # 5. Byzantine quorum top-up: a unit whose replicas have all
        # published (or lapsed / been convicted) but whose best matching
        # receipt group is still short of f + 1 needs MORE independent
        # verifiers — elected deterministically from the survivors.
        if cfg.byzantine_f > 0:
            self._quorum_topup(survivors, unavailable, inflight_elsewhere)

    async def _sentinel_check(self, uid: int, bits: np.ndarray) -> bool:
        """Re-hash one reportedly-valid piece of a foreign unit against
        the info dict. All-False verdicts pass vacuously (claiming a
        piece is BAD cannot poison the bitfield — it only triggers a
        redownload)."""
        unit = self.plan.units[uid]
        true_rows = np.flatnonzero(bits)
        if not len(true_rows):
            return True
        piece = unit.start + int(true_rows[0])
        self._sentinel_checks += 1
        return await self._rehash_piece(unit.torrent, piece)

    async def _rehash_piece(self, torrent: int, piece: int) -> bool:
        """Local ground truth for one piece: read + CPU sha1 against the
        info dict. Shared by the f = 0 sentinel gate and the f > 0
        audit/evidence paths, so every trust decision rests on the same
        primitive — and the work is ledger-accounted like any other
        pipeline stage entry.

        hashlib here is a check of a PEER's verdicts, one piece a unit,
        independent of any plane; it is no fallback of this rank's
        device path, whose pieces all go through its scheduler."""
        storage, info = self.items[torrent]

        def rehash() -> bool:
            import hashlib

            from torrent_tpu_torch.obs.ledger import pipeline_ledger
            from torrent_tpu_torch.storage.piece import piece_length
            from torrent_tpu_torch.storage.storage import StorageError

            led = pipeline_ledger()
            try:
                with led.track("read") as tracked:
                    data = storage.read_piece(piece)
                    tracked.add(len(data))
            except (StorageError, OSError):
                return False
            with led.track("launch", len(data)):
                digest = hashlib.sha1(data).digest()
            return (
                len(data) == piece_length(info, piece)
                and digest == info.pieces[piece]
            )

        return await asyncio.to_thread(rehash)

    # --------------------------------------- Byzantine layer (f > 0)

    # determinism-scope
    def _unit_root(self, uid: int, bits: np.ndarray) -> str:
        """Merkle receipt root for one unit's verdict bits, cached by
        packed-bits value (publishers re-commit the same root every
        round). The leaf set is a pure function of the bits plus the
        torrent's expected piece digests, so ANY process can recompute
        any publisher's root — which is what makes a forged root a
        free structural conviction. Exchanged bytes: determinism-pass
        scope."""
        key = (uid, pack_bits(bits))
        root = self._root_cache.get(key)
        if root is None:
            unit = self.plan.units[uid]
            _, info = self.items[unit.torrent]
            digests = [
                info.pieces[p].hex() for p in range(unit.start, unit.stop)
            ]
            root = merkle_root(unit_leaves(uid, unit.start, bits, digests))
            self._root_cache[key] = root
        return root

    # determinism-scope
    def _receipt_payload(self, own: dict[int, np.ndarray]) -> dict:
        """Byzantine additions to the heartbeat payload — f > 0 ONLY
        (at f = 0 these keys are absent and the heartbeat stays
        bit-identical to the pre-receipt fabric, pinned by test): a
        receipt root per own published unit, and our portable
        conviction evidence. Exchanged bytes: determinism-pass
        scope."""
        return {
            "root": {
                str(uid): self._unit_root(uid, bits)
                for uid, bits in sorted(own.items())
            },
            "evid": sorted([p, u, pc] for p, u, pc in self._evidence),
        }

    def receipt_proof(self, uid: int, piece: int) -> dict:
        """Bounded Merkle proof for one leaf of OUR OWN unit receipt —
        served on demand (log(npieces) siblings) rather than on the
        heartbeat, so AllgatherHeartbeat buffer budgets stay fixed no
        matter how many proofs are requested."""
        if not 0 <= uid < len(self.plan.units):
            raise KeyError(f"no local verdict for unit {uid}")
        unit = self.plan.units[uid]
        bits = self._verdicts.get(uid, {}).get(self.pid)
        if bits is None:
            raise KeyError(f"no local verdict for unit {uid}")
        if not unit.start <= piece < unit.stop:
            raise IndexError(
                f"piece {piece} outside unit {uid}'s span "
                f"[{unit.start}, {unit.stop})"
            )
        _, info = self.items[unit.torrent]
        digests = [info.pieces[p].hex() for p in range(unit.start, unit.stop)]
        leaves = unit_leaves(uid, unit.start, bits, digests)
        i = piece - unit.start
        return {
            "uid": uid,
            "piece": piece,
            "index": i,
            "nleaves": len(leaves),
            "leaf": leaves[i].hex(),
            "ok": bool(bits[i]),
            "path": merkle_proof(leaves, i),
            "root": self._unit_root(uid, bits),
        }

    def _convict(
        self, p: int, uid: int, piece: int, kind: str, local: bool = True
    ) -> None:
        """Convict a (publisher, unit) pair on receipt evidence. The
        pair-membership guard makes the flight dump exactly-once per
        pair per process. ``local=False`` marks gossip-derived
        convictions (accusation quorum), which must not resurrect a
        superseded pair — local proof may, because fresh evidence about
        a re-published verdict is fresh truth."""
        pair = (p, uid)
        if pair in self._distrust:
            return
        if pair in self._superseded:
            if not local:
                return
            self._superseded.discard(pair)
        self._distrust.add(pair)
        self._convictions += 1
        if piece >= 0:
            ev = (p, uid, piece)
            self._evid_seen.add(ev)
            if ev not in self._evidence:
                self._evidence.append(ev)
        log.warning(
            "fabric byzantine: convicting peer %d on unit %d (%s%s)",
            p, uid, kind, f", piece {piece}" if piece >= 0 else "",
        )
        flight_recorder().trigger(
            "fabric_distrust",
            detail={
                "peer": p,
                "unit": uid,
                "pid": self.pid,
                "piece": piece,
                "kind": kind,
            },
            trace_ids=(self._trace_id,),
            snapshots={"fabric": self.metrics_snapshot()},
        )

    async def _audit_round(self) -> None:
        """One round of the Byzantine verdict layer, after the verdict
        merge and before adoption (so convictions feed the same round's
        orphan set). Four sub-passes, each over sorted state so every
        process walks them identically:

        * **structural** — a published root must equal the root
          recomputed from the published bits, and a publisher must
          never commit two different roots for one unit
          (equivocation). Both are visible to every process for free.
        * **evidence** — peers' (peer, unit, piece) conviction
          evidence is re-verified LOCALLY (the accused's merged bits
          claim the piece ok; our re-hash says bad) before we convict.
        * **accusation quorum** — a pair accused by >= f + 1 distinct
          peers convicts without local proof: at most f can be lying.
        * **audits** — re-hash this round's seeded pseudo-random slice
          of every peer's claimed-ok pieces (receipts.audit_sample);
          an actually-bad claimed-ok piece convicts with portable
          evidence.
        """
        cfg = self.config
        # structural: roots vs published bits, and equivocation
        for p in sorted(self._peer_seen):
            roots = self._peer_seen[p].get("root")
            if not isinstance(roots, dict):
                continue
            for uid_s in sorted(roots):
                try:
                    uid = int(uid_s)
                    self.plan.units[uid]
                except (ValueError, IndexError):
                    continue
                root = roots[uid_s]
                pair = (p, uid)
                prev = self._peer_roots.get(pair)
                if prev is None:
                    self._peer_roots[pair] = root
                elif prev != root:
                    self._convict(p, uid, -1, "equivocation")
                    continue
                if pair in self._roots_checked or pair in self._distrust:
                    continue
                bits = self._verdicts.get(uid, {}).get(p)
                if bits is None:
                    continue  # bits not merged yet: re-check next round
                self._roots_checked.add(pair)
                if self._unit_root(uid, bits) != root:
                    self._convict(p, uid, -1, "forged-root")
        # evidence: re-verify peers' conviction evidence locally
        for p in sorted(self._peer_seen):
            for ev in self._peer_seen[p].get("evid", []):
                try:
                    acc, uid, piece = int(ev[0]), int(ev[1]), int(ev[2])
                    unit = self.plan.units[uid]
                except (ValueError, TypeError, IndexError):
                    continue
                key = (acc, uid, piece)
                if key in self._evid_seen:
                    continue
                if not unit.start <= piece < unit.stop:
                    self._evid_seen.add(key)
                    self._evidence_rejected += 1
                    continue
                bits = self._verdicts.get(uid, {}).get(acc)
                if bits is None:
                    continue  # no claim merged yet: retry next round
                self._evid_seen.add(key)
                if (acc, uid) in self._distrust:
                    continue
                if not bool(bits[piece - unit.start]):
                    self._evidence_rejected += 1  # claim doesn't say ok
                    continue
                if await self._rehash_piece(unit.torrent, piece):
                    self._evidence_rejected += 1  # piece is fine
                    continue
                self._convict(acc, uid, piece, "evidence")
        # accusation quorum: f + 1 distinct accusers convict
        for pair in sorted(self._accusations):
            if len(self._accusations[pair]) >= cfg.byzantine_f + 1:
                self._convict(pair[0], pair[1], -1, "accusation-quorum",
                              local=False)
        # audits: this round's sample of every peer's claimed-ok pieces
        for uid in sorted(self._verdicts):
            unit = self.plan.units[uid]
            for p in sorted(self._verdicts[uid]):
                if p == self.pid or (p, uid) in self._distrust:
                    continue
                bits = self._verdicts[uid][p]
                for i in np.flatnonzero(bits):
                    piece = unit.start + int(i)
                    key = (p, uid, piece)
                    if key in self._audited:
                        continue
                    if not audit_sample(
                        self._fp, cfg.audit_seed, self._seq,
                        p, uid, piece, cfg.audit_rate,
                    ):
                        continue
                    self._audited.add(key)
                    self._audit_checks += 1
                    if not await self._rehash_piece(unit.torrent, piece):
                        self._audit_mismatches += 1
                        self._convict(p, uid, piece, "audit")
                        break  # one bad leaf retires the whole pair

    def _quorum_topup(
        self, survivors, unavailable: set[int], inflight_elsewhere: set[int]
    ) -> None:
        """Elect extra verifiers for units short of quorum. Only fires
        once a unit's normal pipeline has run dry — every replica owner
        has published, lapsed, or been convicted — so the happy path
        never double-assigns. The election (rotation over sorted
        candidates by uid) is a pure function of exchanged state, so
        every process elects the same helpers. A unit with NO untainted
        candidate left (honest publishers disagreeing: divergent
        storage) gets its quorum requirement waived after a few rounds
        — loudly — so the sweep terminates instead of wedging."""
        f = self.config.byzantine_f
        for u in self.plan.units:
            uid = u.uid
            if self._unit_covered(uid):
                self._quorum_stuck.pop(uid, None)
                continue
            pubs = sorted(self._verdicts.get(uid, ()))
            replicas = replica_owners(uid, self.plan.owner[uid], self.plan.nproc, f)
            waiting = any(
                r not in unavailable
                and (r, uid) not in self._distrust
                and r not in pubs
                for r in replicas
            )
            if waiting or uid in inflight_elsewhere or uid in self._yielded:
                continue
            groups = self._quorum_groups(uid, False)
            best = max((len(ps) for ps in groups.values()), default=0)
            missing = self._unit_need(uid) - best
            if missing <= 0:
                continue
            candidates = [
                s
                for s in sorted(survivors)
                if (s, uid) not in self._distrust and s not in pubs
            ]
            if not candidates:
                first = self._quorum_stuck.setdefault(uid, self._seq)
                if (
                    self._seq - first >= 3
                    and uid not in self._quorum_waived
                    and best > 0
                ):
                    self._quorum_waived.add(uid)
                    self._quorum_waivers += 1
                    log.error(
                        "fabric quorum: unit %d stuck at %d/%d matching "
                        "receipts with no untainted verifier left "
                        "(publishers disagree — divergent storage?); "
                        "waiving quorum so the sweep terminates",
                        uid, best, self._unit_need(uid),
                    )
                continue
            self._quorum_stuck.pop(uid, None)
            k = min(missing, len(candidates))
            helpers = sorted(
                candidates[(uid + j) % len(candidates)] for j in range(k)
            )
            if self.pid not in helpers:
                continue
            if self._status.get(uid) in (_PENDING, _INFLIGHT, _DONE):
                continue
            self._status[uid] = _PENDING
            self._queue.append(uid)
            self._quorum_verifies += 1
            log.warning(
                "fabric quorum: joining unit %d (best %d/%d matching "
                "receipts)", uid, best, self._unit_need(uid),
            )

    def _refresh_degraded(self) -> None:
        """Self-diagnose a stuck-open sha1 lane breaker from the
        scheduler's public snapshot (no private state reached into)."""
        now = time.monotonic()
        open_lanes: set[str] = set()
        for lane, b in self.scheduler.metrics_snapshot()["breakers"].items():
            if lane.startswith("sha1/") and b["state"] == "open":
                open_lanes.add(lane)
                self._breaker_open_since.setdefault(lane, now)
        for lane in list(self._breaker_open_since):
            if lane not in open_lanes:
                del self._breaker_open_since[lane]
        self._degraded = any(
            now - since >= self.config.breaker_stuck_after
            for since in self._breaker_open_since.values()
        )

    def _check_stragglers(self) -> None:
        mean = (
            sum(self._unit_times) / len(self._unit_times)
            if self._unit_times
            else 0.0
        )
        threshold = max(
            self.config.straggler_min_s, self.config.straggler_factor * mean
        )
        now = time.monotonic()
        for uid, t0 in self._unit_started.items():
            if now - t0 > threshold and uid not in self._warned_straggler:
                self._warned_straggler.add(uid)
                self._stragglers += 1
                log.warning(
                    "fabric straggler: unit %d in flight %.1fs (threshold %.1fs)",
                    uid, now - t0, threshold,
                )

    # ------------------------------------------------------------- fleet

    # determinism-scope
    def _build_obs_digest(self) -> dict:
        """This process's heartbeat-carried obs digest (obs/fleet.py).
        In the determinism pass's scope — exchanged bytes: counters and
        monotonic deltas only, clamped to DIGEST_MAX_BYTES."""
        unit = {
            "done": self._units_done,
            "planned": len(self.plan.units_for(self.pid)),
            "adopted": self._units_adopted,
            "pieces": self._pieces_verified,
            "inflight": len(self._unit_started),
            "stragglers": self._stragglers,
            "degraded": self._degraded,
        }
        if self.config.byzantine_f > 0:
            # audit/quorum counters ride the digest ONLY at f > 0: at
            # f = 0 the key set (and so the heartbeat bytes) must stay
            # bit-identical to the pre-receipt fabric
            unit["audits"] = self._audit_checks
            unit["audit_miss"] = self._audit_mismatches
            unit["convict"] = self._convictions
        return obs_digest(
            scheduler=self.scheduler, base=self._obs_base, unit=unit
        )

    def digest_drops(self) -> int:
        """Heartbeats that shed their obs digest to fit the transport
        buffer (allgather overflow hardening) — never silent."""
        return getattr(self.transport, "digest_drops", 0)

    def fleet_snapshot(self) -> dict:
        """This process's VIEW OF THE FLEET: own digest plus every
        peer's latest heartbeat-carried digest, merged by
        ``obs/fleet.aggregate_fleet`` into the two-level bottleneck
        verdict (limiting process → its limiting stage) and the
        straggler scoreboard. Statuses come from the same heartbeat
        view the adoption machinery uses, so ``GET /v1/fleet`` and the
        orphan-adoption decisions can never disagree about who is
        lapsed or degraded."""
        digests: dict[int, dict] = {self.pid: self._build_obs_digest()}
        for p in sorted(self._peer_seen):
            obs = self._peer_seen[p].get("obs")
            if isinstance(obs, dict):
                digests[p] = obs
        if (
            self.transport is not None
            and self.plan.nproc > 1
            and self._state == "running"
        ):
            # the live lapse test only makes sense mid-sweep: after a
            # completed (or failed) run peers legitimately stop
            # heartbeating, and a later /v1/fleet or /metrics scrape
            # must not flip every finished peer to "lapsed" with
            # spurious adoption debt
            lapsed, degraded = self._unavailable()
        else:
            lapsed, degraded = set(), set()
        distrusted = {p for p, _ in self._distrust}
        statuses: dict[int, str] = {}
        for p in range(self.plan.nproc):
            if p in distrusted:
                statuses[p] = "distrusted"
            elif p in lapsed:
                statuses[p] = "lapsed"
            elif p in degraded or (p == self.pid and self._degraded):
                statuses[p] = "degraded"
            elif p in digests:
                statuses[p] = "ok"
            else:
                statuses[p] = "unreported"
        planned = {
            p: len(self.plan.units_for(p)) for p in range(self.plan.nproc)
        }
        roll = aggregate_fleet(
            digests,
            statuses=statuses,
            planned_units=planned,
            nproc=self.plan.nproc,
            digest_drops=self.digest_drops(),
        )
        roll["pid"] = self.pid
        roll["plan"] = self._fp
        roll["state"] = self._state
        return roll

    # ----------------------------------------------------------- metrics

    def metrics_snapshot(self) -> dict:
        """Per-process fabric gauges for utils/metrics.py rendering."""
        return {
            "state": self._state,
            "pid": self.pid,
            "nproc": self.plan.nproc,
            "trace_id": self._trace_id,
            "plan_fingerprint": self._fp,
            "units_total": len(self.plan.units),
            "shard_units": len(self.plan.units_for(self.pid)),
            "shard_bytes": self.plan.shard_bytes(self.pid),
            "units_done": self._units_done,
            "units_adopted": self._units_adopted,
            "units_offered": self._units_offered,
            "units_rebalanced": self._units_rebalanced,
            "rebalance_streak": self._straggler_streak,
            "pieces_verified": self._pieces_verified,
            "inflight_bytes": self._inflight_bytes,
            "sentinel_checks": self._sentinel_checks,
            "sentinel_mismatches": self._sentinel_mismatches,
            "byzantine_f": self.config.byzantine_f,
            "quorum_need": (
                min(self.config.byzantine_f + 1, self.plan.nproc)
                if self.config.byzantine_f > 0
                else 1
            ),
            "audit_checks": self._audit_checks,
            "audit_mismatches": self._audit_mismatches,
            "convictions": self._convictions,
            "evidence_rejected": self._evidence_rejected,
            "quorum_verifies": self._quorum_verifies,
            "quorum_waivers": self._quorum_waivers,
            "distrusted": sorted({p for p, _ in self._distrust}),
            "stragglers": self._stragglers,
            "heartbeat_errors": self._hb_errors,
            "heartbeat_age": (
                time.monotonic() - self._last_exchange
                if self._last_exchange is not None
                else time.monotonic() - self._started_mono
            ),
            "degraded": self._degraded,
            "digest_drops": self.digest_drops(),
        }
