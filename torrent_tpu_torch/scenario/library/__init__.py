"""The bundled scenario library — named hostile-internet playbooks.

Each entry is ONE compact-grammar string (``ScenarioSpec.parse``), so
the library is greppable, diffable data; behaviors and populations
live in the spec, never in code. ``get(name)`` parses on demand;
``doctor --scenario`` and the CI stage pull from here, and tests run
the same specs at reduced population via ``ScenarioSpec.scaled``.
"""

from __future__ import annotations

from torrent_tpu_torch.scenario.spec import ScenarioSpec

# name -> compact spec. Conventions: every scenario arms integrity
# (one distrust event anywhere is an instant fast burn) on top of its
# own availability target; windows sized to the run so the SLO deltas
# span real traffic.
SCENARIOS: dict[str, str] = {
    # 256 forged identities, fresh peer id every tick, numwant=10000:
    # the server-side clamp and reservoir sampling must bound every
    # reply while honest announces stay inside the latency budget.
    "sybil-stampede": (
        "name=sybil-stampede;seed=7;ticks=24;tick_ms=1000;peer_ttl_s=900;"
        "shards=8;wall_p99_ms=250;short_samples=8;long_samples=24;"
        "slo=availability=0.999|integrity=on;"
        "actor=honest:count=64,numwant=30,swarms=8;"
        "actor=sybil:count=256,numwant=10000,swarms=2"
    ),
    # four poisoners, every submission a digest mismatch: the sentinel
    # must convict all four within its strike budget and convict NOBODY
    # else — the honest population rides along as conviction bait.
    "piece-poison": (
        "name=piece-poison;seed=11;ticks=24;tick_ms=1000;peer_ttl_s=900;"
        "shards=8;wall_p99_ms=250;short_samples=8;long_samples=24;"
        "slo=availability=0.999|integrity=on;"
        "actor=honest:count=32,numwant=30,swarms=4;"
        "actor=poison:count=4,per_tick=1,swarms=1"
    ),
    # 512 peers joining/stopping/ghosting against a 10-second TTL: the
    # end-of-run occupancy reconciliation must balance to the peer —
    # silent ghosts reclaimed by the sweep, polite stops immediately.
    "churn-storm": (
        "name=churn-storm;seed=13;ticks=30;tick_ms=1000;peer_ttl_s=10;"
        "shards=8;wall_p99_ms=250;short_samples=8;long_samples=30;"
        "slo=availability=0.999|integrity=on;"
        "actor=churn:count=512,ghost_pct=5,join_pct=30,stop_pct=20,swarms=32"
    ),
    # 48 connection-holders against a 32-slot accept gate: idle
    # eviction must reclaim the slots each wave; the honest probe
    # connections shed in the window are the availability cost.
    "slowloris": (
        "name=slowloris;seed=17;ticks=36;tick_ms=1000;peer_ttl_s=900;"
        "shards=8;wall_p99_ms=250;short_samples=8;long_samples=32;"
        "slo=availability=0.9|integrity=on;"
        "actor=honest:count=64,numwant=30,swarms=8;"
        "actor=slowloris:count=48,capacity=32,hold_ticks=12,honest_conns=24,idle_ticks=3"
    ),
    # 5120 get_peers queries for hashes nobody has: the indexer census
    # and its BEP 33 bloom table must hold their FIFO bounds instead of
    # growing with the flood.
    "ghost-flood": (
        "name=ghost-flood;seed=19;ticks=20;tick_ms=1000;peer_ttl_s=900;"
        "shards=8;wall_p99_ms=250;short_samples=8;long_samples=20;"
        "slo=availability=0.999|integrity=on;"
        "actor=honest:count=16,numwant=30,swarms=4;"
        "actor=ghost:count=4,per_tick=64"
    ),
    # eight forgers hammering announce_peer with invented tokens: every
    # forgery must draw a KRPC 203 and never reach the tracker feed,
    # while the periodic valid-token control path keeps landing.
    "token-forge": (
        "name=token-forge;seed=23;ticks=24;tick_ms=1000;peer_ttl_s=900;"
        "shards=8;wall_p99_ms=250;short_samples=8;long_samples=24;"
        "slo=availability=0.999|integrity=on;"
        "actor=honest:count=16,numwant=30,swarms=4;"
        "actor=forge:count=8,valid_every=4"
    ),
    # 24 byzantine receipt publishers (a quarter honest bait, the rest
    # forged-root / equivocating / under-hashing liars by turns)
    # against the fabric's Merkle receipt primitives: every liar must
    # be convicted — root recomputation, first-root pinning, sampled
    # proof verification — and NO honest receipt refuted.
    "byzantine-fabric": (
        "name=byzantine-fabric;seed=29;ticks=24;tick_ms=1000;peer_ttl_s=900;"
        "shards=8;wall_p99_ms=250;short_samples=8;long_samples=24;"
        "slo=availability=0.999|integrity=on;"
        "actor=honest:count=32,numwant=30,swarms=4;"
        "actor=byzantine:count=24,pieces=8,honest_pct=25"
    ),
    # a two-thousand-strong leecher crowd against the seeder plane: a
    # 1600-peer horde packed onto 4 shared addresses must be clamped
    # by the per-IP accept limit while the DRR choke economics keeps
    # unchoke slots bounded at slots+1, rotates the optimistic slot,
    # and feeds every admitted honest leecher at least once.
    "leecher-stampede": (
        "name=leecher-stampede;seed=37;ticks=72;tick_ms=1000;peer_ttl_s=900;"
        "shards=8;wall_p99_ms=250;short_samples=8;long_samples=64;"
        "slo=availability=0.999|integrity=on;"
        "actor=honest:count=16,numwant=30,swarms=4;"
        "actor=leecher:count=2000,capacity=512,per_ip=8,slots=16,"
        "honest_pct=20,stampede_ips=4,quantum_kb=16"
    ),
    # the kitchen-sink adversary: sybil stampede + churn storm + piece
    # poisoners in ONE population — defenses must not regress when the
    # attacks overlap (clamps hold, occupancy reconciles, every
    # poisoner convicted, nobody else).
    "mixed-adversary": (
        "name=mixed-adversary;seed=31;ticks=30;tick_ms=1000;peer_ttl_s=10;"
        "shards=8;wall_p99_ms=250;short_samples=8;long_samples=30;"
        "slo=availability=0.999|integrity=on;"
        "actor=honest:count=64,numwant=30,swarms=8;"
        "actor=sybil:count=128,numwant=10000,swarms=2;"
        "actor=churn:count=256,ghost_pct=5,join_pct=30,stop_pct=20,swarms=16;"
        "actor=poison:count=4,per_tick=1,swarms=1"
    ),
}


def names() -> list[str]:
    return sorted(SCENARIOS)


def get(name: str) -> ScenarioSpec:
    """Parse a library scenario by name; ValueError for unknown names
    (listing what exists — the doctor flag surfaces this verbatim)."""
    text = SCENARIOS.get(name)
    if text is None:
        raise ValueError(
            f"unknown scenario {name!r} (one of {', '.join(names())})"
        )
    return ScenarioSpec.parse(text)
