"""BEP 36 torrent RSS/Atom feeds: subscribe and auto-add new entries.

The reference has no feed support (its README's scope ends at the wire
protocols). Real clients grow one because it's how long-running seeds
track a publisher: poll the feed, fetch each new entry's .torrent, add
it. This module is that loop, built on the session layer:

- :func:`parse_feed` — RSS 2.0 (``<item><enclosure url .../>``,
  ``<link>`` fallback) and Atom (``<entry><link href .../>``), plus the
  BEP 36 convention of magnet links in either slot. Untrusted XML: any
  DOCTYPE is rejected outright (entity-expansion bombs), and only
  http(s)/magnet URLs survive.
- :class:`FeedPoller` — periodic poll through the proxy-aware tracker
  HTTP client (size-capped while streaming), dedup by entry URL and by
  infohash after parsing, ``Client.add``/``add_magnet`` for new items.

CLI: ``torrent-tpu feed URL DIR [--interval N] [--once]``.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

from torrent_tpu_torch.utils.log import get_logger

log = get_logger("tools.feed")

MAX_FEED_BYTES = 4 << 20  # a feed document is text; 4 MiB is generous
MAX_TORRENT_BYTES = 16 << 20


class FeedPermanentRefusal(Exception):
    """An entry that can NEVER be accepted (e.g. a magnet under the
    signature gate — BEP 35 signatures live at the torrent root, so no
    future publisher action can make the same magnet pass). poll_once
    marks these seen: re-refusing them every poll is pure churn."""


class FeedError(Exception):
    pass


@dataclass(frozen=True)
class FeedItem:
    title: str
    url: str  # http(s) .torrent URL or a magnet URI


def _clean_url(url: str | None) -> str | None:
    if not url:
        return None
    url = url.strip()
    scheme = url.split(":", 1)[0].lower() if ":" in url else ""
    if scheme in ("http", "https", "magnet"):
        return url
    return None  # file://, ftp://, javascript:, ... are hostile here


def parse_feed(data: bytes) -> list[FeedItem]:
    """Feed document → ordered items (first = newest, as published).

    Raises FeedError on undecodable/hostile documents; unknown elements
    are ignored (feeds are messy in the wild).
    """
    if b"<!DOCTYPE" in data[:4096] or b"<!ENTITY" in data:
        # internal entity expansion is the classic XML bomb and no real
        # feed needs a DTD — refuse rather than parse carefully
        raise FeedError("feed contains a DOCTYPE/ENTITY declaration; refusing")
    import xml.etree.ElementTree as ET

    try:
        root = ET.fromstring(data)
    except ET.ParseError as e:
        raise FeedError(f"feed is not well-formed XML: {e}") from e

    def tag(el) -> str:
        return el.tag.rsplit("}", 1)[-1].lower()  # strip xmlns

    items: list[FeedItem] = []
    # RSS 2.0: rss > channel > item
    for item in root.iter():
        if tag(item) != "item":
            continue
        title, url = "", None
        for child in item:
            t = tag(child)
            if t == "title" and child.text:
                title = child.text.strip()
            elif t == "enclosure":
                url = _clean_url(child.get("url")) or url
        if url is None:  # <link> fallback, lower priority than enclosure
            for child in item:
                if tag(child) == "link" and child.text:
                    url = _clean_url(child.text)
                    if url:
                        break
        if url:
            items.append(FeedItem(title=title, url=url))
    if items:
        return items
    # Atom: feed > entry > link[@href]
    for entry in root.iter():
        if tag(entry) != "entry":
            continue
        title, url = "", None
        for child in entry:
            t = tag(child)
            if t == "title" and child.text:
                title = child.text.strip()
            elif t == "link":
                # prefer rel="enclosure"; plain links as fallback
                cand = _clean_url(child.get("href"))
                if cand and (url is None or child.get("rel") == "enclosure"):
                    url = cand
        if url:
            items.append(FeedItem(title=title, url=url))
    return items


class FeedPoller:
    """Poll one feed and add its new entries to a Client.

    ``seen`` carries across polls (and can be pre-seeded by the caller
    to resume a subscription without re-adding history). Every added
    torrent is also remembered by infohash, so a feed that rotates its
    URLs cannot re-add the same content.
    """

    def __init__(
        self,
        client,
        url: str,
        download_dir: str,
        interval: float = 300.0,
        seen: set[str] | None = None,
        require_signed: tuple[str, bytes] | None = None,
    ):
        self.client = client
        self.url = url
        self.download_dir = download_dir
        self.interval = interval
        # (signer, 32B Ed25519 key): every fetched .torrent must carry a
        # valid BEP 35 signature or it is skipped — the feed auto-add is
        # the highest-risk ingestion path (whatever XML says, we fetch
        # and run). Magnet entries are refused under the gate: BEP 9
        # metadata cannot carry root signatures.
        self.require_signed = require_signed
        self.seen: set[str] = seen if seen is not None else set()
        # infohashes ride the same persisted set as "ih:<hex>" entries,
        # so a publisher rotating entry URLs (signed/expiring links)
        # can't re-add content across process restarts either
        self._seen_hashes: set[bytes] = set()
        for s in self.seen:
            if s.startswith("ih:"):
                try:
                    self._seen_hashes.add(bytes.fromhex(s[3:]))
                except ValueError:
                    pass
        self._task: asyncio.Task | None = None

    async def poll_once(self) -> list:
        """One poll: fetch, parse, add new items; returns added torrents."""
        from torrent_tpu_torch.net.tracker import _http_get

        raw = await _http_get(
            self.url,
            timeout=30,
            proxy=self.client.proxy,
            max_bytes=MAX_FEED_BYTES,
        )
        added = []
        for item in parse_feed(raw):
            if item.url in self.seen:
                continue
            try:
                t = await self._add_item(item)
            except FeedPermanentRefusal as e:
                # marked seen: this entry can never be accepted, so one
                # warning is all it gets (not one per poll forever)
                log.warning("feed %s: %r refused permanently: %s",
                            self.url, item.title, e)
                self.seen.add(item.url)
                continue
            except Exception as e:
                # NOT marked seen: a transiently-503ing download URL gets
                # retried on the next poll instead of being dropped
                # forever (an unsigned .torrent may also be SIGNED later
                # — root signatures don't change its URL or infohash)
                log.warning("feed %s: adding %r failed: %s", self.url, item.title, e)
                continue
            self.seen.add(item.url)
            if t is not None:
                self._remember_hash(t.metainfo.info_hash)
                added.append(t)
        return added

    def _remember_hash(self, ih: bytes) -> None:
        self._seen_hashes.add(ih)
        self.seen.add("ih:" + ih.hex())

    async def _add_item(self, item: FeedItem):
        if item.url.startswith("magnet:"):
            if self.require_signed is not None:
                raise FeedPermanentRefusal(
                    f"{item.url!r}: magnet entries cannot satisfy the "
                    f"signature gate (no root signatures in BEP 9 metadata)"
                )
            return await self.client.add_magnet(item.url, self.download_dir)
        from torrent_tpu_torch.net.tracker import _http_get

        raw = await _http_get(
            item.url,
            timeout=30,
            proxy=self.client.proxy,
            max_bytes=MAX_TORRENT_BYTES,
        )
        if self.require_signed is not None:
            from torrent_tpu_torch.codec import signing

            try:
                signing.ensure_signed(raw, *self.require_signed)
            except ValueError as e:
                raise FeedError(f"{item.url} refused: {e}") from e
        from torrent_tpu_torch.codec.metainfo import parse_any_metainfo

        parsed = parse_any_metainfo(raw)
        if parsed is None:
            raise FeedError(f"{item.url} did not serve a valid .torrent")
        meta, ih = parsed
        if ih in self._seen_hashes or ih in self.client.torrents:
            self._remember_hash(ih)  # persist the rotated-URL knowledge
            return None  # same content under a rotated URL
        return await self.client.add(meta, self.download_dir)

    def start(self) -> None:
        """Spawn the periodic poll loop (errors are logged, never fatal:
        a feed that 500s for an hour resumes on the next tick)."""
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._loop())

    async def _loop(self) -> None:
        while True:
            try:
                added = await self.poll_once()
                if added:
                    log.info("feed %s: added %d new torrents", self.url, len(added))
            except Exception as e:
                log.warning("feed %s: poll failed: %s", self.url, e)
            await asyncio.sleep(self.interval)

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
