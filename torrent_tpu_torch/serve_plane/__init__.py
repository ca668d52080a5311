"""The crowd seeder plane: connection-scaled serving for one process.

* :mod:`.reactor` — a bounded reactor pool multiplexing peer request
  queues: per-peer FIFO backpressure, batch draining, cancel-by-predicate
  for BEP 6 rejects.
* :mod:`.egress` — zero-copy block egress: ``os.sendfile`` when the
  requested span maps contiguously into one real file, pooled ``preadv``
  staging when the fd is there but sendfile is not, buffered copy
  otherwise — with a per-connection fallback matrix recording which path
  served every block.
* :mod:`.choke` — upload choke economics on the scheduler's DRR
  byte-weight idiom: deficits accrue per round by reciprocation weight,
  egress spends them, a seeded optimistic slot rotates, and starvation
  is structurally impossible (a choked candidate accrues every round).
* :mod:`.telemetry` — the bounded serve-side registry + the pure
  :func:`~torrent_tpu_torch.serve_plane.telemetry.build_serve_snapshot`
  rollup behind ``torrent_tpu_serve_*`` metrics, which the bridge's
  ``/metrics`` and ``/v1/swarm`` read too.
"""

from torrent_tpu_torch.serve_plane.choke import ChokeEconomics, RoundResult
from torrent_tpu_torch.serve_plane.egress import EgressEngine
from torrent_tpu_torch.serve_plane.reactor import ReactorPool
from torrent_tpu_torch.serve_plane.telemetry import (
    EGRESS_PATHS,
    ServeTelemetry,
    build_serve_snapshot,
    serve_telemetry,
)

__all__ = [
    "EGRESS_PATHS",
    "ChokeEconomics",
    "EgressEngine",
    "ReactorPool",
    "RoundResult",
    "ServeTelemetry",
    "build_serve_snapshot",
    "serve_telemetry",
]
