from torrent_tpu_torch.net.types import (
    AnnounceEvent,
    AnnounceInfo,
    AnnouncePeer,
    AnnounceResponse,
    ScrapeEntry,
    UdpTrackerAction,
)
from torrent_tpu_torch.net.tracker import announce, scrape, TrackerError

__all__ = [
    "AnnounceEvent",
    "AnnounceInfo",
    "AnnouncePeer",
    "AnnounceResponse",
    "ScrapeEntry",
    "UdpTrackerAction",
    "announce",
    "scrape",
    "TrackerError",
]
