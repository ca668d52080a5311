"""ScenarioSpec — the declarative, replayable form of a hostile swarm.

A scenario is DATA: a seeded actor population plus the SLO objectives
its outcome is judged against, round-trippable through the compact
``key=value`` grammar (the ``FaultPlan.parse`` idiom of
``sched/faults.py``), JSON, and bencode — so a scenario can live in a
library module, a CI flag, or a ``.torrent``-adjacent artifact and
always replay bit-identically from (spec, seed).

Everything on the wire is an INT (bencode has no float type): durations
are milliseconds/seconds, ratios are percent. The only string payload
is the SLO objective spec, validated against ``obs.slo
.parse_objectives`` at construction so a typo'd objective fails at
parse time, never silently as an unarmed SLO.

This module is pure and total: no clocks, no randomness, no IO — it is
in the determinism pass SCOPE (``analysis/passes/determinism.py``) and
every iteration is sorted.
"""

# determinism-scope: module
# (specs must parse/serialize bit-identically across replays)

from __future__ import annotations

import json
from dataclasses import dataclass, replace

from torrent_tpu_torch.obs.slo import parse_objectives

SPEC_VERSION = 1

# kind -> param -> (default, lo, hi); ``count`` is implicit on every
# kind. Behaviors live in scenario/actors.py — this table is the WIRE
# contract (what a spec may say), kept here so spec parsing stays pure.
ACTOR_PARAMS: dict[str, dict[str, tuple[int, int, int]]] = {
    # baseline announcers: the availability denominator. seed_pct of the
    # population announces as seeders; each peer announces every
    # ``interval_ticks`` virtual ticks across ``swarms`` info-hashes.
    "honest": {
        "swarms": (8, 1, 1_000_000),
        "numwant": (30, 0, 1_000_000),
        "seed_pct": (25, 0, 100),
        "interval_ticks": (1, 1, 100_000),
    },
    # Sybil stampede: forged identities, oversized numwant — the
    # tracker's server-side clamps and reservoir sampling must hold.
    "sybil": {
        "swarms": (2, 1, 1_000_000),
        "numwant": (10_000, 0, 10_000_000),
    },
    # piece poisoners: submit payloads that fail digest verification;
    # the sentinel/distrust plane must convict every one of them and
    # nobody else.
    "poison": {
        "swarms": (1, 1, 1_000_000),
        "per_tick": (1, 1, 10_000),
    },
    # churn storm: joins, explicit STOPPED leaves, and silent ghosts
    # that only the TTL sweep may reclaim — occupancy must reconcile
    # exactly at the end.
    "churn": {
        "swarms": (16, 1, 1_000_000),
        "join_pct": (30, 0, 100),
        "stop_pct": (20, 0, 100),
        "ghost_pct": (10, 0, 100),
    },
    # slowloris: hold accept slots open against the session accept
    # gate; honest connections shed at capacity burn availability until
    # idle eviction reclaims the slots.
    "slowloris": {
        "capacity": (32, 1, 1_000_000),
        "hold_ticks": (10, 1, 100_000),
        "idle_ticks": (5, 1, 100_000),
        "honest_conns": (16, 0, 1_000_000),
    },
    # ghost-swarm flood: bencoded get_peers datagrams for random hashes
    # straight into the DHT node; the indexer's census and BEP 33
    # blooms must stay FIFO-bounded.
    "ghost": {
        "per_tick": (64, 1, 1_000_000),
    },
    # token forgers: announce_peer with invented tokens must be
    # rejected (KRPC 203) and never reach the tracker feed; a valid
    # control path (token harvested from a real get_peers reply) must
    # still land.
    "forge": {
        "valid_every": (4, 1, 100_000),
    },
    # leecher stampede against the seeder plane: a shared-IP horde
    # (count - honest_pct% actors spread over ``stampede_ips``
    # addresses, never reciprocating) and an honest crowd (unique IPs,
    # real reciprocation weights) contend for the accept gate's per-IP
    # clamp and the DRR choke economics. The clamp must bound the
    # horde, unchoke slots must stay at ``slots`` + 1 (optimistic), and
    # every admitted honest leecher must be fed before the run ends.
    "leecher": {
        "capacity": (512, 1, 1_000_000),
        "per_ip": (8, 1, 1_000_000),
        "slots": (8, 1, 100_000),
        "honest_pct": (20, 0, 100),
        "stampede_ips": (4, 1, 1_000_000),
        "quantum_kb": (16, 1, 100_000),
    },
    # Byzantine receipt publishers against the verify fabric's Merkle
    # receipt plane (fabric/receipts.py): forged roots, equivocating
    # receipts, and under-hashing workers. The ground-truth auditor
    # must convict every liar (root recomputation, first-root pinning,
    # proof verification) and refute NO honest receipt. honest_pct of
    # the population publishes honest receipts as refutation bait.
    "byzantine": {
        "pieces": (8, 1, 4096),
        "honest_pct": (25, 0, 100),
    },
}

MAX_ACTOR_GROUPS = 64
MAX_TOTAL_POPULATION = 10_000_000
_NAME_CHARS = frozenset("abcdefghijklmnopqrstuvwxyz0123456789-_")


def _int_in(label: str, value, lo: int, hi: int) -> int:
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValueError(f"{label} must be an int, got {value!r}")
    if not lo <= value <= hi:
        raise ValueError(f"{label} must be in [{lo}, {hi}], got {value}")
    return value


@dataclass(frozen=True)
class ActorGroup:
    """One behavior population: ``count`` actors of ``kind`` with the
    kind's int params (sorted tuple of pairs — hashable, order-stable)."""

    kind: str
    count: int
    params: tuple[tuple[str, int], ...] = ()

    def __post_init__(self):
        table = ACTOR_PARAMS.get(self.kind)
        if table is None:
            raise ValueError(
                f"unknown actor kind {self.kind!r} (one of "
                f"{', '.join(sorted(ACTOR_PARAMS))})"
            )
        _int_in(f"actor {self.kind} count", self.count, 1, MAX_TOTAL_POPULATION)
        if not isinstance(self.params, tuple):
            raise ValueError("actor params must be a tuple of (name, value)")
        seen = set()
        for pair in self.params:
            if not (isinstance(pair, tuple) and len(pair) == 2):
                raise ValueError("actor params must be (name, value) pairs")
            pname, pval = pair
            if pname not in table:
                raise ValueError(
                    f"unknown param {pname!r} for actor {self.kind!r} "
                    f"(one of {', '.join(sorted(table))})"
                )
            if pname in seen:
                raise ValueError(f"duplicate param {pname!r} for {self.kind!r}")
            seen.add(pname)
            _, lo, hi = table[pname]
            _int_in(f"actor {self.kind} param {pname}", pval, lo, hi)
        if tuple(sorted(self.params)) != self.params:
            raise ValueError("actor params must be sorted by name")

    def param(self, name: str) -> int:
        """Param value with the registry default filled in."""
        for pname, pval in self.params:
            if pname == name:
                return pval
        return ACTOR_PARAMS[self.kind][name][0]


@dataclass(frozen=True)
class ScenarioSpec:
    """The whole scenario, frozen. ``slo`` is a native
    ``parse_objectives`` spec string (``;``-separated); the compact
    grammar carries it with ``|`` separators so it nests inside one
    ``key=value`` field."""

    name: str
    seed: int
    ticks: int
    actors: tuple[ActorGroup, ...]
    slo: str
    tick_ms: int = 1000
    peer_ttl_s: int = 900
    shards: int = 8
    wall_p99_ms: int = 250
    short_samples: int = 8
    long_samples: int = 32

    def __post_init__(self):
        if not self.name or not set(self.name) <= _NAME_CHARS:
            raise ValueError(
                f"scenario name must be non-empty [a-z0-9_-], got {self.name!r}"
            )
        _int_in("seed", self.seed, 0, 2**32 - 1)
        _int_in("ticks", self.ticks, 1, 1_000_000)
        _int_in("tick_ms", self.tick_ms, 1, 3_600_000)
        _int_in("peer_ttl_s", self.peer_ttl_s, 1, 86_400)
        _int_in("shards", self.shards, 1, 1024)
        _int_in("wall_p99_ms", self.wall_p99_ms, 1, 60_000)
        _int_in("short_samples", self.short_samples, 1, 10_000)
        _int_in("long_samples", self.long_samples, 1, 1_000_000)
        if self.long_samples < self.short_samples:
            raise ValueError("long_samples must be >= short_samples")
        if not isinstance(self.actors, tuple) or not self.actors:
            raise ValueError("a scenario needs at least one actor group")
        if len(self.actors) > MAX_ACTOR_GROUPS:
            raise ValueError(f"at most {MAX_ACTOR_GROUPS} actor groups")
        for group in self.actors:
            if not isinstance(group, ActorGroup):
                raise ValueError("actors must be ActorGroup instances")
        total = sum(g.count for g in self.actors)
        if total > MAX_TOTAL_POPULATION:
            raise ValueError(
                f"total population {total} exceeds {MAX_TOTAL_POPULATION}"
            )
        if not isinstance(self.slo, str) or "|" in self.slo:
            raise ValueError("slo must be a ';'-separated objective spec")
        try:
            if not parse_objectives(self.slo):
                raise ValueError("empty objective spec")
        except ValueError as e:
            raise ValueError(f"bad slo spec {self.slo!r}: {e}") from None

    # ------------------------------------------------------------ derived

    def objectives(self):
        """The armed ``SloObjective`` tuple this scenario is judged by."""
        return parse_objectives(self.slo)

    def population(self) -> int:
        return sum(g.count for g in self.actors)

    def scaled(self, divisor: int, ticks: int | None = None) -> "ScenarioSpec":
        """A reduced-population copy (every count ``max(1, n //
        divisor)``) for tests and CI — same seed, same behaviors, same
        objectives, cheaper world."""
        if divisor < 1:
            raise ValueError("divisor must be >= 1")
        actors = tuple(
            replace(g, count=max(1, g.count // divisor)) for g in self.actors
        )
        return replace(
            self, actors=actors, ticks=ticks if ticks is not None else self.ticks
        )

    # ---------------------------------------------------- compact grammar

    @classmethod
    def parse(cls, text: str) -> "ScenarioSpec":
        """Parse the compact ``;``-separated grammar, e.g.::

            name=sybil-stampede;seed=7;ticks=40;slo=availability=0.999|integrity=on;actor=honest:count=64,numwant=30;actor=sybil:count=512,numwant=10000

        Unknown keys, malformed values, and invalid populations raise
        ``ValueError`` naming the offending part (FaultPlan idiom).
        """
        if not isinstance(text, str):
            raise ValueError("scenario spec must be a string")
        fields: dict[str, int | str] = {}
        actors: list[ActorGroup] = []
        int_keys = (
            "seed", "ticks", "tick_ms", "peer_ttl_s", "shards",
            "wall_p99_ms", "short_samples", "long_samples",
        )
        for part in text.split(";"):
            part = part.strip()
            if not part:
                continue
            key, sep, value = part.partition("=")
            key = key.strip()
            value = value.strip()
            if not sep:
                raise ValueError(f"bad scenario field {part!r}: missing '='")
            if key == "actor":
                actors.append(cls._parse_actor(value))
            elif key == "name":
                fields["name"] = value
            elif key == "slo":
                # '|' stands in for ';' so the objective spec nests
                # inside one field of the outer grammar
                fields["slo"] = value.replace("|", ";")
            elif key in int_keys:
                if key in fields:
                    raise ValueError(f"duplicate scenario field {key!r}")
                try:
                    fields[key] = int(value)
                except ValueError as e:
                    raise ValueError(
                        f"bad scenario {key} value {value!r}: {e}"
                    ) from None
            else:
                raise ValueError(f"unknown scenario field {key!r}")
        for required in ("name", "seed", "ticks", "slo"):
            if required not in fields:
                raise ValueError(f"scenario spec missing {required!r}")
        if not actors:
            raise ValueError("scenario spec declares no actor= groups")
        return cls(actors=tuple(actors), **fields)  # type: ignore[arg-type]

    @staticmethod
    def _parse_actor(value: str) -> ActorGroup:
        kind, sep, rest = value.partition(":")
        kind = kind.strip()
        if not sep:
            raise ValueError(
                f"bad actor {value!r}: want kind:count=N[,param=V...]"
            )
        count: int | None = None
        params: list[tuple[str, int]] = []
        for item in rest.split(","):
            item = item.strip()
            if not item:
                continue
            pname, psep, pval = item.partition("=")
            pname = pname.strip()
            if not psep:
                raise ValueError(f"bad actor param {item!r}: missing '='")
            try:
                ival = int(pval.strip())
            except ValueError as e:
                raise ValueError(
                    f"bad actor {kind} param {pname} value {pval!r}: {e}"
                ) from None
            if pname == "count":
                if count is not None:
                    raise ValueError(f"duplicate count for actor {kind!r}")
                count = ival
            else:
                params.append((pname, ival))
        if count is None:
            raise ValueError(f"actor {kind!r} missing count=")
        return ActorGroup(kind=kind, count=count, params=tuple(sorted(params)))

    def serialize(self) -> str:
        """The compact grammar form; ``parse(serialize()) == self``."""
        parts = [
            f"name={self.name}",
            f"seed={self.seed}",
            f"ticks={self.ticks}",
            f"tick_ms={self.tick_ms}",
            f"peer_ttl_s={self.peer_ttl_s}",
            f"shards={self.shards}",
            f"wall_p99_ms={self.wall_p99_ms}",
            f"short_samples={self.short_samples}",
            f"long_samples={self.long_samples}",
            f"slo={self.slo.replace(';', '|')}",
        ]
        for g in self.actors:
            items = [f"count={g.count}"] + [
                f"{pname}={pval}" for pname, pval in g.params
            ]
            parts.append(f"actor={g.kind}:{','.join(items)}")
        return ";".join(parts)

    # ------------------------------------------------------- dict / json

    def to_dict(self) -> dict:
        return {
            "v": SPEC_VERSION,
            "name": self.name,
            "seed": self.seed,
            "ticks": self.ticks,
            "tick_ms": self.tick_ms,
            "peer_ttl_s": self.peer_ttl_s,
            "shards": self.shards,
            "wall_p99_ms": self.wall_p99_ms,
            "short_samples": self.short_samples,
            "long_samples": self.long_samples,
            "slo": self.slo,
            "actors": [
                {
                    "kind": g.kind,
                    "count": g.count,
                    "params": {pname: pval for pname, pval in g.params},
                }
                for g in self.actors
            ],
        }

    @classmethod
    def from_dict(cls, d) -> "ScenarioSpec":
        if not isinstance(d, dict):
            raise ValueError("scenario dict must be a mapping")
        if d.get("v") != SPEC_VERSION:
            raise ValueError(f"unknown scenario spec version {d.get('v')!r}")
        known = {
            "v", "name", "seed", "ticks", "tick_ms", "peer_ttl_s", "shards",
            "wall_p99_ms", "short_samples", "long_samples", "slo", "actors",
        }
        extra = sorted(set(d) - known)
        if extra:
            raise ValueError(f"unknown scenario keys {extra}")
        raw_actors = d.get("actors")
        if not isinstance(raw_actors, list):
            raise ValueError("scenario actors must be a list")
        actors = []
        for entry in raw_actors:
            if not isinstance(entry, dict):
                raise ValueError("actor entry must be a mapping")
            if sorted(set(entry) - {"kind", "count", "params"}):
                raise ValueError(f"unknown actor keys in {sorted(entry)}")
            raw_params = entry.get("params", {})
            if not isinstance(raw_params, dict):
                raise ValueError("actor params must be a mapping")
            kind = entry.get("kind")
            if not isinstance(kind, str):
                raise ValueError(f"actor kind must be a string, got {kind!r}")
            for pname in raw_params:
                if not isinstance(pname, str):
                    raise ValueError(f"actor param name {pname!r} not a string")
            actors.append(
                ActorGroup(
                    kind=kind,
                    count=entry.get("count"),
                    params=tuple(sorted(raw_params.items())),
                )
            )
        name, slo = d.get("name"), d.get("slo")
        if not isinstance(name, str):
            raise ValueError(f"scenario name must be a string, got {name!r}")
        if not isinstance(slo, str):
            raise ValueError(f"scenario slo must be a string, got {slo!r}")
        kwargs = {}
        for key in (
            "seed", "ticks", "tick_ms", "peer_ttl_s", "shards",
            "wall_p99_ms", "short_samples", "long_samples",
        ):
            if key in d:
                kwargs[key] = d[key]
        return cls(name=name, slo=slo, actors=tuple(actors), **kwargs)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ScenarioSpec":
        try:
            d = json.loads(text)
        except (TypeError, json.JSONDecodeError) as e:
            raise ValueError(f"bad scenario json: {e}") from None
        return cls.from_dict(d)

    # ----------------------------------------------------------- bencode

    def to_bencode(self) -> bytes:
        from torrent_tpu_torch.codec.bencode import bencode

        return bencode(self.to_dict())

    @classmethod
    def from_bencode(cls, blob: bytes) -> "ScenarioSpec":
        from torrent_tpu_torch.codec.bencode import BencodeError, bdecode

        try:
            decoded = bdecode(blob)
        except BencodeError as e:
            raise ValueError(f"bad scenario bencode: {e}") from None
        return cls.from_dict(_debytes(decoded))


def _debytes(value):
    """bdecode output → the JSON-shaped dict ``from_dict`` validates
    (bytes keys/strings become str; undecodable bytes stay bytes and
    fail the type checks downstream with a clear ValueError)."""
    if isinstance(value, bytes):
        try:
            return value.decode("utf-8")
        except UnicodeDecodeError:
            return value
    if isinstance(value, list):
        return [_debytes(v) for v in value]
    if isinstance(value, dict):
        return {_debytes(k): _debytes(v) for k, v in sorted(value.items())}
    return value
