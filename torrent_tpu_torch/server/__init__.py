"""The tracker server: HTTP and UDP announce/scrape (``tracker``), the
in-memory swarm store behind ``run_tracker`` (``in_memory``), and the
sharded announce plane behind ``run_sharded_tracker`` (``shard``)."""

from torrent_tpu_torch.server.tracker import (
    AnnounceRequest,
    HttpAnnounceRequest,
    HttpScrapeRequest,
    ScrapeRequest,
    ServeOptions,
    TrackerServer,
    UdpAnnounceRequest,
    UdpScrapeRequest,
    serve_tracker,
)
from torrent_tpu_torch.server.in_memory import InMemoryTracker, run_tracker
from torrent_tpu_torch.server.shard import (
    AnnounceOutcome,
    ShardedSwarmStore,
    ShardedTracker,
    run_sharded_tracker,
)

__all__ = [
    "AnnounceOutcome",
    "AnnounceRequest",
    "ScrapeRequest",
    "HttpAnnounceRequest",
    "HttpScrapeRequest",
    "UdpAnnounceRequest",
    "UdpScrapeRequest",
    "ServeOptions",
    "ShardedSwarmStore",
    "ShardedTracker",
    "TrackerServer",
    "serve_tracker",
    "run_sharded_tracker",
    "InMemoryTracker",
    "run_tracker",
]
