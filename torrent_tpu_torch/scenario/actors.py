"""Hostile-internet actor behaviors — the population a scenario scripts.

Each :class:`Behavior` owns one ``ActorGroup`` from the spec and steps
it once per virtual tick against the world the engine built (real
``ShardedSwarmStore`` shards, a real ``DHTNode`` driven transportless,
the real indexer). Behaviors are deterministic: every identity,
info-hash, address, and payload derives from ``sha1`` of the actor's
coordinates or from the world's seeded rng, never from wall time.

The world object (``scenario/engine.py``) is the only surface a
behavior touches:

* ``world.announce(...)`` — tracker announce with presence bookkeeping
  and wall-latency capture; every completed announce is one
  availability EVENT.
* ``world.submit_piece(key, payload, digest)`` — the sentinel seam:
  digest-verified piece ingestion with strike-based conviction.
* ``world.datagram(data, addr)`` — a raw KRPC datagram into the DHT
  node; returns the decoded replies the node tried to send.
* ``world.record_shed()`` / ``world.record_failed()`` — availability
  ERRORS (shed connections, failed pieces).

Behaviors report two things at the end: ``facts()`` (plain data for
the verdict) and ``failures()`` (invariant violations, each a human
sentence — an empty list means the behavior's contract held).
"""

from __future__ import annotations

import hashlib

from torrent_tpu_torch.codec.bencode import bencode
from torrent_tpu_torch.net.types import AnnounceEvent

# Promoted to the live session: the scenario plane attacks
# the SAME AcceptGate class the real accept path runs (virtual ticks
# here, monotonic seconds there) — re-exported so scenario code keeps
# its historical import site.
from torrent_tpu_torch.session.torrent import AcceptGate

__all__ = ["Behavior", "AcceptGate", "build_behaviors", "BEHAVIOR_KINDS"]


def _h(*parts) -> bytes:
    """sha1 of the ':'-joined coordinates — the deterministic identity
    well every actor draws from."""
    return hashlib.sha1(":".join(str(p) for p in parts).encode()).digest()


def _ih(kind: str, gi: int, swarm: int) -> bytes:
    return _h("scn-ih", kind, gi, swarm)


def _pid(kind: str, gi: int, i: int, salt: int = 0) -> bytes:
    return b"-SC-" + _h("scn-pid", kind, gi, i, salt)[:16]


def _ip(kind: str, gi: int, i: int) -> str:
    d = _h("scn-ip", kind, gi, i)
    return f"10.{d[0]}.{d[1]}.{d[2]}"


class Behavior:
    """Base: one actor group's scripted conduct over the run."""

    kind = ""

    def __init__(self, group, gi: int):
        self.group = group
        self.gi = gi

    def setup(self, world) -> None:
        pass

    def step(self, world) -> None:
        raise NotImplementedError

    def facts(self, world) -> dict:
        return {}

    def failures(self, world) -> list[str]:
        return []


class HonestBehavior(Behavior):
    """Baseline announcers: the availability denominator. ``seed_pct``
    of the population are seeders; each peer announces (and submits one
    digest-valid piece) every ``interval_ticks``, spread over
    ``swarms`` info-hashes."""

    kind = "honest"

    def setup(self, world) -> None:
        g = self.group
        self.swarms = g.param("swarms")
        self.numwant = g.param("numwant")
        self.interval = g.param("interval_ticks")
        self.seeders = g.count * g.param("seed_pct") // 100
        self.announces = 0

    def step(self, world) -> None:
        for i in range(self.group.count):
            if (world.tick + i) % self.interval:
                continue
            ih = _ih(self.kind, self.gi, i % self.swarms)
            world.announce(
                ih, _pid(self.kind, self.gi, i), _ip(self.kind, self.gi, i),
                6881 + (i % 1000), 0 if i < self.seeders else 1,
                AnnounceEvent.EMPTY, self.numwant,
            )
            payload = _h("piece", self.gi, i, world.tick)
            world.submit_piece(
                f"honest:{self.gi}:{i}", payload,
                hashlib.sha1(payload).digest(),
            )
            self.announces += 1

    def facts(self, world) -> dict:
        return {"announces": self.announces}


class SybilBehavior(Behavior):
    """Announce stampede from forged identities: every tick, every
    sybil announces under a FRESH peer id with an oversized ``numwant``.
    The tracker's server-side clamp must bound every reply and its
    occupancy must stay a TTL-sweepable population, not a permanent
    allocation."""

    kind = "sybil"

    def setup(self, world) -> None:
        g = self.group
        self.swarms = g.param("swarms")
        self.numwant = g.param("numwant")
        self.announces = 0
        self.overflows = 0  # replies longer than the server-side cap

    def step(self, world) -> None:
        for i in range(self.group.count):
            out = world.announce(
                _ih(self.kind, self.gi, i % self.swarms),
                _pid(self.kind, self.gi, i, salt=world.tick),
                _ip(self.kind, self.gi, i), 1025 + (i % 60000), 1,
                AnnounceEvent.EMPTY, self.numwant,
            )
            self.announces += 1
            if len(out.peers) > world.clamp_cap:
                self.overflows += 1

    def facts(self, world) -> dict:
        snap = world.store.metrics_snapshot()
        return {
            "announces": self.announces,
            "overflows": self.overflows,
            "numwant_clamped": snap["numwant_clamped"],
        }

    def failures(self, world) -> list[str]:
        out = []
        if self.overflows:
            out.append(
                f"sybil reply clamp failed: {self.overflows} replies "
                f"exceeded the {world.clamp_cap}-peer cap"
            )
        if self.numwant > world.clamp_cap and self.announces:
            snap = world.store.metrics_snapshot()
            if not snap["numwant_clamped"]:
                out.append(
                    "sybil numwant above the cap but the tracker never "
                    "counted a clamp"
                )
        return out


class PoisonBehavior(Behavior):
    """Piece poisoners: every submission carries a payload whose digest
    does NOT verify. The sentinel must convict every scripted poisoner
    (strike threshold) and nobody else — zero false convictions is part
    of the verdict, not just zero escapes."""

    kind = "poison"

    def setup(self, world) -> None:
        g = self.group
        self.swarms = g.param("swarms")
        self.per_tick = g.param("per_tick")
        self.keys = [f"poison:{self.gi}:{i}" for i in range(g.count)]
        world.scripted_poisoners.update(self.keys)
        self.submitted = 0

    def step(self, world) -> None:
        for i in range(self.group.count):
            for k in range(self.per_tick):
                payload = _h("poisoned", self.gi, i, world.tick, k)
                # digest of DIFFERENT bytes: verification must fail
                world.submit_piece(
                    self.keys[i], payload,
                    hashlib.sha1(payload + b"!").digest(),
                )
                self.submitted += 1

    def facts(self, world) -> dict:
        convicted = sum(1 for k in self.keys if k in world.convicted)
        return {
            "scripted": len(self.keys),
            "submitted": self.submitted,
            "convicted": convicted,
            "false_convictions": world.false_convictions,
            "escapes": world.poison_escapes,
        }

    def failures(self, world) -> list[str]:
        out = []
        unconvicted = [k for k in self.keys if k not in world.convicted]
        if unconvicted:
            out.append(
                f"{len(unconvicted)}/{len(self.keys)} scripted poisoners "
                f"escaped conviction (first: {unconvicted[0]})"
            )
        if world.poison_escapes:
            out.append(
                f"{world.poison_escapes} poisoned pieces were accepted"
            )
        if world.false_convictions:
            out.append(
                f"{world.false_convictions} honest submitters were "
                f"falsely convicted"
            )
        return out


class ChurnBehavior(Behavior):
    """Churn storm: per tick each peer joins (announce), leaves
    politely (STOPPED), turns ghost (silent departure only the TTL
    sweep may reclaim), or refreshes — all by seeded-rng draw. The
    engine's end-of-run reconciliation must find tracker occupancy
    EXACTLY equal to the presence ledger."""

    kind = "churn"

    def setup(self, world) -> None:
        g = self.group
        self.swarms = g.param("swarms")
        self.join_pct = g.param("join_pct")
        self.stop_pct = g.param("stop_pct")
        self.ghost_pct = g.param("ghost_pct")
        self.state = ["out"] * g.count  # out | in | ghost
        self.joins = self.stops = self.ghosts = 0

    def step(self, world) -> None:
        for i in range(self.group.count):
            r = world.rng.randrange(100)
            state = self.state[i]
            ih = _ih(self.kind, self.gi, i % self.swarms)
            pid = _pid(self.kind, self.gi, i)
            ip = _ip(self.kind, self.gi, i)
            port = 2000 + (i % 60000)
            if state == "out":
                if r < self.join_pct:
                    world.announce(
                        ih, pid, ip, port, 1, AnnounceEvent.STARTED, 10
                    )
                    self.state[i] = "in"
                    self.joins += 1
            elif state == "in":
                if r < self.stop_pct:
                    world.announce(
                        ih, pid, ip, port, 1, AnnounceEvent.STOPPED, 0
                    )
                    self.state[i] = "out"
                    self.stops += 1
                elif r < self.stop_pct + self.ghost_pct:
                    self.state[i] = "ghost"  # silent: TTL must reclaim
                    self.ghosts += 1
                else:
                    world.announce(
                        ih, pid, ip, port, 1, AnnounceEvent.EMPTY, 10
                    )
            # ghosts never announce again

    def facts(self, world) -> dict:
        return {
            "joins": self.joins,
            "stops": self.stops,
            "ghosted": self.ghosts,
        }


class SlowlorisBehavior(Behavior):
    """Slot-holders against the accept gate: the whole population
    connects at the top of every ``hold_ticks`` wave and then never
    makes progress; the gate's ``idle_ticks`` eviction must reclaim
    them. ``honest_conns`` short-lived connections per tick are the
    availability probe — shed ones are SLO errors."""

    kind = "slowloris"

    def setup(self, world) -> None:
        g = self.group
        self.hold_ticks = g.param("hold_ticks")
        self.gate = AcceptGate(g.param("capacity"), g.param("idle_ticks"))
        self.honest_conns = g.param("honest_conns")
        self.honest_ok = 0
        self.honest_shed = 0

    def step(self, world) -> None:
        tick = world.tick
        if tick % self.hold_ticks == 0:
            for i in range(self.group.count):
                self.gate.connect(("loris", self.gi, i), tick)
        for j in range(self.honest_conns):
            key = ("conn", self.gi, tick, j)
            if self.gate.connect(key, tick):
                self.gate.release(key)
                self.honest_ok += 1
                world.record_ok()
            else:
                self.honest_shed += 1
                world.record_shed()
        self.gate.sweep(tick)

    def facts(self, world) -> dict:
        return {
            "honest_ok": self.honest_ok,
            "honest_shed": self.honest_shed,
            "idle_evicted": self.gate.evicted_idle,
            "slots_open": len(self.slots_left()),
        }

    def slots_left(self) -> dict:
        return self.gate.slots

    def failures(self, world) -> list[str]:
        out = []
        if self.honest_conns and not self.honest_ok:
            out.append(
                "slowloris held the accept gate shut for the whole run "
                "(no honest connection ever admitted)"
            )
        if not self.gate.evicted_idle and self.group.count:
            out.append("idle eviction never reclaimed a slowloris slot")
        return out


class LeecherBehavior(Behavior):
    """Leecher stampede against the seeder plane's two defenses: the
    accept gate's per-IP clamp and the DRR choke economics
    (``serve_plane/choke.py`` — the SAME class the live session's
    ``_choke_loop`` runs, driven here with virtual ticks).

    ``honest_pct`` of the population are honest leechers — unique IPs,
    real reciprocation weights; the rest are a stampede horde packed
    onto ``stampede_ips`` shared addresses that never reciprocates.
    Everyone dials in at tick 0; each subsequent tick is one unchoke
    round where every fed peer drinks a quantum (charged back, so the
    queue rotates). The contract: the per-IP clamp bounds the horde,
    no round unchokes more than ``slots`` + 1 peers, the optimistic
    slot rotates, and every admitted honest leecher is fed at least
    once before the run ends."""

    kind = "leecher"

    def setup(self, world) -> None:
        from torrent_tpu_torch.serve_plane.choke import ChokeEconomics

        g = self.group
        self.slots = g.param("slots")
        self.per_ip = g.param("per_ip")
        self.stampede_ips = g.param("stampede_ips")
        self.honest_n = g.count * g.param("honest_pct") // 100
        self.stampede_n = g.count - self.honest_n
        self.quantum = g.param("quantum_kb") * 1024
        # idle_after far past the run: eviction is slowloris's exam,
        # not this one's — here the per-IP clamp is the front door
        self.gate = AcceptGate(
            g.param("capacity"), 1 << 30, per_ip=self.per_ip
        )
        # one virtual tick = one whole unchoke round, so the product's
        # cap (8 quanta, tuned for continuous charging between rounds)
        # would saturate in a handful of ticks and flatten the queue
        # order into a key tie-break; size the cap past the run instead
        self.econ = ChokeEconomics(
            self.slots,
            quantum=self.quantum,
            seed=int.from_bytes(_h("leecher-econ", self.gi)[:8], "big"),
            cap_rounds=128,
        )
        self.admitted: list[str] = []
        self.weights: dict[str, float] = {}
        self.honest_admitted = 0
        self.honest_shed = 0
        self.honest_fed: set[str] = set()
        self.max_unchoked = 0
        self.stampede_unchokes = 0

    def _connect_all(self, world, tick: int) -> None:
        # the horde races in first — the worst case for the honest crowd
        for i in range(self.stampede_n):
            key = f"s{self.gi}.{i}"
            ip = _ip("leecher-horde", self.gi, i % self.stampede_ips)
            if self.gate.connect(key, tick, ip=ip):
                self.admitted.append(key)
                self.weights[key] = 0.0  # never reciprocates
        for i in range(self.honest_n):
            key = f"h{self.gi}.{i}"
            if self.gate.connect(key, tick, ip=_ip(self.kind, self.gi, i)):
                self.admitted.append(key)
                d = _h("leecher-rate", self.gi, i)
                self.weights[key] = 0.25 + d[0] / 1024
                self.honest_admitted += 1
            else:
                self.honest_shed += 1
                world.record_shed()

    def step(self, world) -> None:
        if world.tick == 0:
            self._connect_all(world, world.tick)
        if not self.admitted:
            return
        verdict = self.econ.round(self.weights)
        fed = verdict.all_unchoked()
        self.max_unchoked = max(self.max_unchoked, len(fed))
        for key in fed:
            # every fed peer drinks its unchoke dry and is charged for
            # it — the same spend-on-egress the session does (one tick
            # here is a whole unchoke round; real egress dwarfs the
            # accrual quantum), so the queue rotates instead of
            # freezing on the first winners
            self.econ.charge(key, self.econ.deficit(key))
            if key.startswith("h"):
                self.honest_fed.add(key)
                world.record_ok()
            else:
                self.stampede_unchokes += 1

    def facts(self, world) -> dict:
        return {
            "admitted": len(self.admitted),
            "per_ip_rejected": self.gate.rejected_per_ip,
            "capacity_rejected": self.gate.rejected_capacity,
            "honest_admitted": self.honest_admitted,
            "honest_shed": self.honest_shed,
            "honest_fed": len(self.honest_fed),
            "max_unchoked": self.max_unchoked,
            "stampede_unchokes": self.stampede_unchokes,
            "rounds": self.econ.rounds,
            "optimistic_rotations": self.econ.rotations,
        }

    def failures(self, world) -> list[str]:
        out = []
        if self.max_unchoked > self.slots + 1:
            out.append(
                f"choke round unchoked {self.max_unchoked} peers "
                f"(bound is slots + optimistic = {self.slots + 1})"
            )
        if (
            self.stampede_n > self.per_ip * self.stampede_ips
            and not self.gate.rejected_per_ip
        ):
            out.append(
                f"per-IP clamp never fired against a {self.stampede_n}"
                f"-strong horde on {self.stampede_ips} addresses"
            )
        starved = self.honest_admitted - len(self.honest_fed)
        if starved > 0:
            out.append(
                f"{starved}/{self.honest_admitted} honest leechers were "
                "never unchoked (starved by the horde)"
            )
        if len(self.admitted) > self.slots and not self.econ.rotations:
            out.append("the optimistic unchoke slot never rotated")
        return out


class GhostBehavior(Behavior):
    """Ghost-swarm flood: ``per_tick`` bencoded ``get_peers`` queries
    per flooder per tick, each for a hash nobody has — straight into
    the DHT node's datagram path. The indexer census and its BEP 33
    bloom table must hold their FIFO bounds."""

    kind = "ghost"

    def setup(self, world) -> None:
        self.per_tick = self.group.param("per_tick")
        self.sent = 0

    def step(self, world) -> None:
        for i in range(self.group.count):
            src = (_ip(self.kind, self.gi, i), 7000 + (i % 1000))
            node_id = _h("ghost-node", self.gi, i)
            for k in range(self.per_tick):
                ih = _h("ghost-ih", self.gi, i, world.tick, k)
                world.datagram(
                    bencode({
                        b"t": b"gh", b"y": b"q", b"q": b"get_peers",
                        b"a": {b"id": node_id, b"info_hash": ih},
                    }),
                    src,
                )
                self.sent += 1

    def facts(self, world) -> dict:
        snap = world.indexer.snapshot()
        return {
            "flood_queries": self.sent,
            "indexer_hashes": snap["hashes"],
            "indexer_blooms": snap["blooms"],
            "indexer_unresolved": snap["unresolved"],
        }

    def failures(self, world) -> list[str]:
        snap = world.indexer.snapshot()
        out = []
        if snap["hashes"] > world.indexer.max_hashes:
            out.append(
                f"indexer hash census {snap['hashes']} exceeded its "
                f"bound {world.indexer.max_hashes}"
            )
        if snap["blooms"] > world.indexer.max_hashes:
            out.append(
                f"indexer bloom table {snap['blooms']} exceeded the "
                f"census bound {world.indexer.max_hashes}"
            )
        return out


class ForgeBehavior(Behavior):
    """Token forgers: ``announce_peer`` with an invented token must be
    rejected (KRPC 203) and never reach the tracker feed. Every
    ``valid_every`` ticks each forger also runs the legitimate dance —
    ``get_peers`` for a real token, then a valid announce — proving the
    gate rejects forgeries WITHOUT killing the protocol."""

    kind = "forge"

    def setup(self, world) -> None:
        self.valid_every = self.group.param("valid_every")
        self.forged = 0
        self.rejected = 0
        self.accepted_forgeries = 0
        self.valid_ok = 0

    def step(self, world) -> None:
        for i in range(self.group.count):
            src = (_ip(self.kind, self.gi, i), 8000 + (i % 1000))
            node_id = _h("forge-node", self.gi, i)
            ih = _h("forge-ih", self.gi, i)
            replies = world.datagram(
                bencode({
                    b"t": b"fg", b"y": b"q", b"q": b"announce_peer",
                    b"a": {
                        b"id": node_id, b"info_hash": ih,
                        b"token": b"FORGEDTK", b"port": src[1],
                    },
                }),
                src,
            )
            self.forged += 1
            for msg in replies:
                if msg.get(b"y") == b"e":
                    self.rejected += 1
                elif msg.get(b"y") == b"r":
                    self.accepted_forgeries += 1
                    world.record_forged_accepted()
            if world.tick % self.valid_every == 0:
                token = None
                for msg in world.datagram(
                    bencode({
                        b"t": b"fq", b"y": b"q", b"q": b"get_peers",
                        b"a": {b"id": node_id, b"info_hash": ih},
                    }),
                    src,
                ):
                    r = msg.get(b"r")
                    if isinstance(r, dict) and isinstance(
                        r.get(b"token"), bytes
                    ):
                        token = r[b"token"]
                if token is not None:
                    for msg in world.datagram(
                        bencode({
                            b"t": b"fa", b"y": b"q", b"q": b"announce_peer",
                            b"a": {
                                b"id": node_id, b"info_hash": ih,
                                b"token": token, b"port": src[1],
                                b"seed": 1,
                            },
                        }),
                        src,
                    ):
                        if msg.get(b"y") == b"r":
                            self.valid_ok += 1

    def facts(self, world) -> dict:
        return {
            "forged": self.forged,
            "rejected": self.rejected,
            "accepted_forgeries": self.accepted_forgeries,
            "valid_ok": self.valid_ok,
            "fed_peers": world.indexer.fed_peers,
        }

    def failures(self, world) -> list[str]:
        out = []
        if self.accepted_forgeries:
            out.append(
                f"{self.accepted_forgeries} forged-token announces were "
                f"accepted"
            )
        if self.forged and self.rejected != self.forged:
            out.append(
                f"only {self.rejected}/{self.forged} forged announces "
                f"drew a KRPC error"
            )
        if self.group.count and not self.valid_ok:
            out.append(
                "the valid-token control path never landed an announce"
            )
        if world.indexer.fed_peers != self.valid_ok:
            out.append(
                f"tracker feed saw {world.indexer.fed_peers} peers but "
                f"only {self.valid_ok} valid announces were made"
            )
        return out


class ByzantineBehavior(Behavior):
    """Byzantine receipt publishers against the fabric's Merkle
    receipt plane (``fabric/receipts.py`` — the SAME pure primitives
    the live verify fabric exchanges at ``byzantine_f > 0``). The
    population splits into ``honest_pct`` honest publishers and three
    liar archetypes by index:

    * **forged-root** — claims every piece ok under a root committed
      over invented digests; the auditor's ground-truth root
      recomputation must convict.
    * **equivocation** — commits two DIFFERENT roots for the same unit
      across its two ticks; first-root pinning must convict on the
      second.
    * **under-hash** — hashed only a prefix of the unit but claims all
      of it; the root matches its own lazy leaves, so only proof
      verification against the TRUE leaf catches it.

    Every honest receipt is proof-checked too: a single refuted honest
    receipt (false refutation) fails the run — zero false convictions
    is part of the verdict, exactly like the poison plane."""

    kind = "byzantine"

    def setup(self, world) -> None:
        from torrent_tpu_torch.fabric.receipts import merkle_root

        g = self.group
        self.pieces = g.param("pieces")
        self.honest_pct = g.param("honest_pct")
        self.n_honest = g.count * self.honest_pct // 100
        self.first_root: dict[tuple[int, int], str] = {}
        self.convicted: set[int] = set()
        self.caught: dict[str, int] = {
            "forged-root": 0, "equivocation": 0, "under-hash": 0,
        }
        self.false_refutations = 0
        self.honest_verified = 0
        self.receipts = 0
        self._empty_root = merkle_root([])

    def _mode(self, i: int) -> str:
        if i < self.n_honest:
            return "honest"
        return ("forged-root", "equivocation", "under-hash")[i % 3]

    def _true_digests(self, i: int, unit: int) -> list[str]:
        return [
            _h("byz-digest", self.gi, i, unit, j).hex()
            for j in range(self.pieces)
        ]

    def step(self, world) -> None:
        from torrent_tpu_torch.fabric.receipts import (
            leaf_hash,
            merkle_proof,
            merkle_root,
            verify_proof,
        )

        # each unit spans two ticks: consistent publishers re-commit
        # the same root on the second tick, equivocators switch roots —
        # the only lie that needs history to catch
        unit = world.tick // 2
        second_tick = world.tick % 2 == 1
        for i in range(self.group.count):
            if i in self.convicted:
                continue  # convicted publishers are dropped outright
            mode = self._mode(i)
            true_digests = self._true_digests(i, unit)
            true_leaves = [
                leaf_hash(unit, j, d, True)
                for j, d in enumerate(true_digests)
            ]
            if mode == "forged-root":
                # all-ok claim over invented digests
                lied = [
                    _h("byz-lie", self.gi, i, unit, j).hex()
                    for j in range(self.pieces)
                ]
                leaves = [
                    leaf_hash(unit, j, d, True) for j, d in enumerate(lied)
                ]
            elif mode == "equivocation" and second_tick:
                # same unit, different committed leaf set → new root
                leaves = [
                    leaf_hash(unit, j, _h("byz-equiv", self.gi, i, unit, j).hex(), True)
                    for j in range(self.pieces)
                ]
            elif mode == "under-hash":
                # hashed only the first piece, claims every piece ok:
                # the root is self-consistent over its lazy leaves
                leaves = [true_leaves[0]] + [
                    leaf_hash(unit, j, "", True)
                    for j in range(1, self.pieces)
                ]
            else:  # honest (and the equivocator's innocent first tick)
                leaves = true_leaves
            root = merkle_root(leaves)
            self.receipts += 1
            # ---- the auditor (ground truth in hand) ----
            key = (i, unit)
            pinned = self.first_root.setdefault(key, root)
            if pinned != root:
                self.caught["equivocation"] += 1
                self.convicted.add(i)
                continue
            sample = unit % self.pieces
            proof = merkle_proof(leaves, sample)
            proof_ok = verify_proof(
                true_leaves[sample], sample, len(leaves), proof, root
            )
            true_root = merkle_root(true_leaves)
            if mode == "honest" or (mode == "equivocation" and not second_tick):
                if root == true_root and proof_ok:
                    self.honest_verified += 1
                    world.record_ok()
                else:
                    self.false_refutations += 1
                    world.record_failed()
            elif root != true_root and sample > 0 and not proof_ok:
                # under-hash: root recomputation AND the sampled proof
                # disagree with ground truth (sample 0 is the one piece
                # it really hashed — wait for a later unit's sample)
                self.caught[mode] += 1
                self.convicted.add(i)
            elif mode == "forged-root" and root != true_root:
                self.caught[mode] += 1
                self.convicted.add(i)

    def facts(self, world) -> dict:
        return {
            "receipts": self.receipts,
            "convicted": len(self.convicted),
            "caught_forged_root": self.caught["forged-root"],
            "caught_equivocation": self.caught["equivocation"],
            "caught_under_hash": self.caught["under-hash"],
            "honest_verified": self.honest_verified,
            "false_refutations": self.false_refutations,
        }

    def failures(self, world) -> list[str]:
        out = []
        liars = [
            i for i in range(self.group.count) if self._mode(i) != "honest"
        ]
        free = [i for i in liars if i not in self.convicted]
        if free:
            out.append(
                f"{len(free)}/{len(liars)} byzantine publishers escaped "
                f"conviction (first: {self._mode(free[0])} #{free[0]})"
            )
        if self.false_refutations:
            out.append(
                f"{self.false_refutations} honest receipts were refuted"
            )
        if self.n_honest and not self.honest_verified:
            out.append("no honest receipt ever verified (auditor inert)")
        return out


BEHAVIOR_KINDS: dict[str, type[Behavior]] = {
    cls.kind: cls
    for cls in (
        HonestBehavior, SybilBehavior, PoisonBehavior, ChurnBehavior,
        SlowlorisBehavior, LeecherBehavior, GhostBehavior,
        ForgeBehavior, ByzantineBehavior,
    )
}


def build_behaviors(spec) -> list[Behavior]:
    """One Behavior per spec actor group, in spec order."""
    out = []
    for gi, group in enumerate(spec.actors):
        cls = BEHAVIOR_KINDS.get(group.kind)
        if cls is None:
            raise ValueError(f"no behavior for actor kind {group.kind!r}")
        out.append(cls(group, gi))
    return out
