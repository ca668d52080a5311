"""The tracker server: HTTP and UDP announce/scrape (``tracker``) and the
in-memory swarm store behind ``run_tracker`` (``in_memory``). The
sharded store (``server/shard.py`` in the JAX package) is not ported
yet."""

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

__all__ = [
    "AnnounceRequest",
    "ScrapeRequest",
    "HttpAnnounceRequest",
    "HttpScrapeRequest",
    "UdpAnnounceRequest",
    "UdpScrapeRequest",
    "ServeOptions",
    "TrackerServer",
    "serve_tracker",
    "InMemoryTracker",
    "run_tracker",
]
