"""torrent_tpu_torch.scenario — the deterministic hostile-internet chaos plane.

Scripts thousands of synthetic peers, trackers, and DHT nodes against
the REAL serve stack (sharded tracker store, DHT node + indexer) on a
virtualized timeline, and renders the outcome as an SLO verdict: a
replayable error-budget statement, not an assertEqual.

* ``spec`` — :class:`ScenarioSpec`, the bencode/JSON round-trippable
  scenario artifact (FaultPlan-idiom compact grammar).
* ``actors`` — the behavior kinds (honest, sybil, poison, churn,
  slowloris, ghost, forge).
* ``engine`` — :func:`run_scenario`, the virtual-timeline runner.
* ``verdict`` — pure verdict functions + the canonical (bit-identical
  across same-seed replays) projection.
* ``library`` — the bundled named scenarios.
"""

from torrent_tpu_torch.scenario.engine import VirtualClock, World, run_scenario
from torrent_tpu_torch.scenario.spec import ActorGroup, ScenarioSpec
from torrent_tpu_torch.scenario.verdict import (
    budget_statement,
    build_verdict,
    canonical_bytes,
    canonical_verdict,
)

__all__ = [
    "ActorGroup",
    "ScenarioSpec",
    "VirtualClock",
    "World",
    "budget_statement",
    "build_verdict",
    "canonical_bytes",
    "canonical_verdict",
    "run_scenario",
]
