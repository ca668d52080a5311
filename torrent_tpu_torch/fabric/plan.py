"""Deterministic shard planner for the verify fabric.

A library recheck on a multi-process mesh needs every process to agree
on who verifies what WITHOUT a planning RPC: the coordinator round-trip
would serialize startup behind one host, and a planning service is one
more thing to fail. So the plan is a pure function of the inputs every
process already has — the library's info dicts and the process count —
and every process computes it independently and identically.

Work is cut into :class:`WorkUnit` s — (torrent, piece-range) spans
bounded by ``unit_bytes`` — so one huge torrent doesn't pin a whole
process while its peers idle, and so failure/adoption granularity (the
executor's heartbeat layer) is a bounded re-verify, not a whole torrent.
Units are assigned by longest-processing-time greedy over byte weight:
units sorted by (descending bytes, uid) land on the least-loaded
process, ties broken by lowest process id. Every comparison key is a
deterministic integer, so the plan — and its :meth:`FabricPlan.
fingerprint` — is identical on every process given the same library.
"""

# determinism-scope: module
# (plan fingerprints are exchanged proof-of-agreement bytes)

from __future__ import annotations

import hashlib
from dataclasses import dataclass

DEFAULT_UNIT_BYTES = 64 << 20


@dataclass(frozen=True)
class WorkUnit:
    """One (torrent, piece-range) span of the library's work list."""

    uid: int      # dense, stable id: position in torrent-major order
    torrent: int  # index into the library's items list
    start: int    # first piece, inclusive
    stop: int     # past-the-end piece
    nbytes: int   # payload bytes the span covers (ragged tail included)

    @property
    def npieces(self) -> int:
        return self.stop - self.start


@dataclass(frozen=True)
class FabricPlan:
    """The full assignment: every process holds the identical plan."""

    nproc: int
    units: tuple[WorkUnit, ...]  # uid-ordered
    owner: tuple[int, ...]       # uid -> owning process

    def units_for(self, pid: int) -> list[WorkUnit]:
        return [u for u in self.units if self.owner[u.uid] == pid]

    def shard_bytes(self, pid: int) -> int:
        return sum(u.nbytes for u in self.units_for(pid))

    @property
    def total_bytes(self) -> int:
        return sum(u.nbytes for u in self.units)

    @property
    def total_pieces(self) -> int:
        return sum(u.npieces for u in self.units)

    def fingerprint(self) -> str:
        """Short stable digest of the whole assignment — processes (and
        tests) compare it to prove they planned from the same inputs."""
        h = hashlib.sha1()
        h.update(str(self.nproc).encode())
        for u in self.units:
            h.update(
                f"|{u.uid}:{u.torrent}:{u.start}:{u.stop}:{u.nbytes}"
                f"@{self.owner[u.uid]}".encode()
            )
        return h.hexdigest()[:12]


def plan_library(
    infos, nproc: int, unit_bytes: int = DEFAULT_UNIT_BYTES
) -> FabricPlan:
    """Partition a library's (torrent, piece-range) work across
    ``nproc`` processes by byte weight.

    ``infos``: the library's info dicts in library order (anything with
    ``num_pieces``, ``piece_length``, ``length``) — the SAME list, in
    the same order, on every process.
    """
    if nproc < 1:
        raise ValueError(f"nproc must be >= 1, got {nproc}")
    if unit_bytes < 1:
        raise ValueError(f"unit_bytes must be >= 1, got {unit_bytes}")
    units: list[WorkUnit] = []
    for ti, info in enumerate(infos):
        n = info.num_pieces
        plen = info.piece_length
        if n == 0:
            continue
        span = max(1, unit_bytes // plen)
        for start in range(0, n, span):
            stop = min(start + span, n)
            nbytes = min(info.length, stop * plen) - start * plen
            units.append(WorkUnit(len(units), ti, start, stop, nbytes))
    # LPT greedy: biggest unit first onto the least-loaded process. Ties
    # break on uid (unit order) and pid (process order) — both total
    # orders, so the argmin below can never depend on dict/hash order.
    owner = [0] * len(units)
    loads = [0] * nproc
    for u in sorted(units, key=lambda u: (-u.nbytes, u.uid)):
        p = min(range(nproc), key=lambda p: (loads[p], p))
        owner[u.uid] = p
        loads[p] += u.nbytes
    return FabricPlan(nproc, tuple(units), tuple(owner))


def replica_owners(uid: int, owner: int, nproc: int, byzantine_f: int) -> tuple[int, ...]:
    """The processes that must independently verify a unit under
    ``byzantine_f = f``.

    A quorum verdict needs ``f + 1`` matching receipts, so ``f + 1``
    processes (clamped to ``nproc``) verify each unit up front: the
    planned owner plus the next ``f`` pids in ring order. Pure function
    of the plan — every process computes the same replica sets, so the
    widened assignment needs no coordination, and ``f = 0`` degenerates
    to exactly ``(owner,)`` (the single-owner fast path)."""
    if nproc < 1:
        raise ValueError(f"nproc must be >= 1, got {nproc}")
    need = min(byzantine_f + 1, nproc)
    return tuple(sorted((owner + k) % nproc for k in range(need)))


def adoption_owner(uid: int, survivors: list[int]) -> int:
    """Which surviving process adopts an orphaned unit.

    Pure function of (uid, sorted survivor set): every survivor computes
    the same answer from the same heartbeat view, so orphan adoption
    needs no claim protocol. Round-robin by uid spreads a dead process's
    shard across the survivors instead of dumping it on one."""
    if not survivors:
        raise ValueError("no surviving processes to adopt the unit")
    survivors = sorted(survivors)
    return survivors[uid % len(survivors)]
