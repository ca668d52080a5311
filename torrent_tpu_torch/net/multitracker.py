"""Multitracker support, BEP 12 (reference roadmap item, README.md:37).

``announce-list`` is a list of tiers; each tier a list of tracker URLs.
Per BEP 12: shuffle within each tier once, try tiers in order and URLs
within a tier in order, and promote a responding tracker to the front of
its tier so it's tried first next time.
"""

from __future__ import annotations

import asyncio
import random

from torrent_tpu_torch.net.tracker import TrackerError, announce
from torrent_tpu_torch.net.types import AnnounceInfo, AnnounceResponse
from torrent_tpu_torch.utils.log import get_logger

log = get_logger("net.multitracker")


def parse_announce_list(raw: dict) -> list[list[str]] | None:
    """Extract tiers from a decoded metainfo top-level dict."""
    tiers_raw = raw.get(b"announce-list")
    if not isinstance(tiers_raw, list):
        return None
    tiers: list[list[str]] = []
    for tier_raw in tiers_raw:
        if not isinstance(tier_raw, list):
            continue
        tier = [
            url.decode("utf-8", "replace") for url in tier_raw if isinstance(url, bytes)
        ]
        if tier:
            tiers.append(tier)
    return tiers or None


class TrackerList:
    """Tiered tracker rotation state for one torrent."""

    def __init__(
        self,
        announce_url: str,
        tiers: list[list[str]] | None = None,
        proxy=None,
        dns_prefs=None,
    ):
        self.proxy = proxy  # net.socks.ProxySpec | None, forwarded per call
        # BEP 34 (net/dnsprefs.TrackerPrefs | None): when set, each URL is
        # expanded through the host's published DNS tracker preferences
        # right before the announce attempt (deny = skip; no record =
        # announce as written; resolver trouble fails open)
        self.dns_prefs = dns_prefs
        if tiers:
            self.tiers = [[u for u in t if u] for t in tiers]
            self.tiers = [t for t in self.tiers if t]
            for tier in self.tiers:
                random.shuffle(tier)  # BEP 12: shuffle once at load
            # the single `announce` field is the fallback tier if absent
            if announce_url and not any(announce_url in tier for tier in self.tiers):
                self.tiers.append([announce_url])
        else:
            # Trackerless torrents (x.pe-only magnets) have no tiers at
            # all; the session skips its announce loop entirely.
            self.tiers = [[announce_url]] if announce_url else []

    def __bool__(self) -> bool:
        return bool(self.tiers)

    def urls(self):
        for tier in self.tiers:
            for url in list(tier):
                yield tier, url

    def promote(self, tier: list[str], url: str) -> None:
        """Move a responding tracker to its tier's front (BEP 12)."""
        try:
            tier.remove(url)
        except ValueError:
            return
        tier.insert(0, url)

    async def announce(
        self, info: AnnounceInfo, per_tracker_timeout: float = 45.0
    ) -> AnnounceResponse:
        """Try every tracker in tier order; first success wins.

        Each tracker gets at most ``per_tracker_timeout`` seconds before the
        rotation moves on — otherwise a single dead UDP tracker would hold
        the announce loop for its full BEP 15 retry ladder (8 attempts at
        15·2ⁿ s ≈ an hour) while later tiers sit untried.
        """
        last_err: Exception | None = None
        for tier, url in self.urls():
            candidates = [url]
            if self.dns_prefs is not None:
                candidates = await self.dns_prefs.apply(url)
                if not candidates:
                    log.debug("tracker %s skipped (BEP 34 deny)", url)
                    continue
            for target in candidates:
                try:
                    res = await asyncio.wait_for(
                        announce(target, info, proxy=self.proxy),
                        per_tracker_timeout,
                    )
                except (TrackerError, OSError, asyncio.TimeoutError) as e:
                    # any single-tracker failure must not abort the rotation
                    log.debug("tracker %s failed: %s", target, e)
                    last_err = e
                    continue
                self.promote(tier, url)
                return res
        raise TrackerError(f"all trackers failed; last error: {last_err}")
