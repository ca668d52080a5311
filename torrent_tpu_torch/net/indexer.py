"""DHT indexer/crawler — turn ``net/dht.py`` outward.

The DHT endpoint so far is a *client*: it answers the queries BEP 5
obliges it to and looks things up on demand. This module adds the
indexer mode from "Efficient Indexing of the BitTorrent Distributed
Hash Table" (PAPERS.md): a long-running node that

* **passively harvests** the query traffic it receives anyway —
  ``get_peers`` is a demand signal (someone wants this swarm),
  ``announce_peer`` is a *live, token-validated peer* — via the
  observer seam on :class:`~torrent_tpu_torch.net.dht.DHTNode`; and
* **actively walks** the keyspace on a bounded budget: a crawl step
  converges toward a random target, asks every visited node for a BEP 51
  ``sample_infohashes``, and resolves a bounded number of fresh hashes
  to peers with ``get_peers`` lookups.

Harvested peers feed a
:class:`~torrent_tpu_torch.server.shard.ShardedSwarmStore` through its
``seed_peer`` seam — the persistent-tracker semantics of "Persistent
BitTorrent Trackers" (PAPERS.md): the sharded announce plane answers
for swarms it never saw an HTTP/UDP announce for, because the DHT told
it about them. A magnet-only client can then bootstrap through the
tracker with no ``.torrent`` file anywhere.

Everything is bounded: the discovered-hash set is a FIFO-capped dict,
crawl steps cap nodes visited and lookups issued, and observer work is
a few dict operations (it runs on the datagram path).
"""

from __future__ import annotations

import asyncio
import time

from torrent_tpu_torch.net.dht import (
    K,
    DHTError,
    DHTNode,
    ScrapeBloom,
    random_node_id,
    xor_distance,
)
from torrent_tpu_torch.utils.log import get_logger

log = get_logger("net.indexer")

MAX_HASHES = 4096  # discovered info-hash set bound (FIFO eviction)
MAX_UNRESOLVED = 1024  # resolve-backlog bound (FIFO eviction)
CRAWL_MAX_NODES = 16  # sample_infohashes queries per crawl step
CRAWL_MAX_LOOKUPS = 8  # get_peers resolutions per crawl step
CRAWL_INTERVAL = 300.0


class DhtIndexer:
    """Passive harvest + bounded active walk, feeding a sharded store.

    ``store`` is anything with the ``seed_peer(info_hash, ip, port,
    left=...)`` contract (``server.shard.ShardedSwarmStore``); ``None``
    runs the indexer in observe-only mode (hash census, no tracker
    feed).
    """

    def __init__(
        self,
        node: DHTNode,
        store=None,
        max_hashes: int = MAX_HASHES,
        clock=time.monotonic,
    ):
        self.node = node
        self.store = store
        self.max_hashes = max_hashes
        self._clock = clock  # determinism seam (scenario virtual time)
        # info_hash -> last harvest monotonic (insertion-ordered: FIFO
        # eviction past the cap keeps a hostile flood bounded)
        self._hashes: dict[bytes, float] = {}
        # BEP 33 scrape-side aggregation: info_hash -> (BFsd, BFpe).
        # Evicted in lockstep with _hashes (same FIFO bound), so a
        # ghost-swarm flood costs a bounded 512 B/hash, never unbounded
        self._blooms: dict[bytes, tuple[ScrapeBloom, ScrapeBloom]] = {}
        # discovered-but-not-yet-resolved hashes (insertion-ordered set,
        # FIFO-bounded): sampled hashes beyond one crawl's lookup budget
        # — and passively-censused get_peers hashes — wait here so later
        # crawls drain them instead of starving forever behind the
        # freshness filter
        self._unresolved: dict[bytes, None] = {}
        self.harvested = {"get_peers": 0, "announce_peer": 0}
        self.fed_peers = 0  # peers pushed into the store
        self.crawls = 0
        self.crawl_nodes = 0  # sample_infohashes queries issued
        self.crawl_samples = 0  # hashes received from samples
        self.crawl_lookups = 0  # get_peers resolutions issued
        node.add_observer(self._observe)

    # ------------------------------------------------------------ passive

    def _note(self, info_hash: bytes) -> bool:
        """Record a discovered hash; returns True when it is new."""
        fresh = info_hash not in self._hashes
        if fresh and len(self._hashes) >= self.max_hashes:
            # FIFO: drop the oldest-discovered hash (+ its blooms — the
            # bloom table must never outgrow the hash census)
            oldest = next(iter(self._hashes))
            self._hashes.pop(oldest)
            self._blooms.pop(oldest, None)
        self._hashes[info_hash] = self._clock()
        return fresh

    def _bloom_pair(self, info_hash: bytes) -> tuple[ScrapeBloom, ScrapeBloom]:
        pair = self._blooms.get(info_hash)
        if pair is None:
            # evicted in lockstep with _hashes in _note: the bloom table
            # never outgrows the hash census
            pair = self._blooms[info_hash] = (ScrapeBloom(), ScrapeBloom())  # bounded-by: max_hashes
        return pair

    def blooms_for(
        self, info_hash: bytes
    ) -> tuple[ScrapeBloom, ScrapeBloom] | None:
        """BEP 33 ``(seed_bloom, peer_bloom)`` for a harvested hash, or
        None — the tracker store's ``attach_bloom_source`` contract, so
        scrapes for DHT-only swarms answer with cardinality estimates."""
        return self._blooms.get(info_hash)

    def _defer_resolve(self, info_hash: bytes) -> None:
        """Queue a hash whose peers are still unknown for a later
        crawl's lookup budget (bounded: oldest dropped first)."""
        if info_hash in self._unresolved:
            return
        if len(self._unresolved) >= MAX_UNRESOLVED:
            self._unresolved.pop(next(iter(self._unresolved)))
        self._unresolved[info_hash] = None

    def _observe(self, kind: str, info_hash: bytes, addr, port, seed) -> None:
        if kind not in self.harvested:
            return
        self.harvested[kind] += 1
        self._note(info_hash)
        # BEP 33 blooms: a token-validated announcer lands in BFsd/BFpe
        # by seed flag; a get_peers querier is a "host requesting peers"
        # and joins BFpe (the downloader filter) per the BEP
        seed_bloom, peer_bloom = self._bloom_pair(info_hash)
        if kind == "announce_peer":
            (seed_bloom if seed else peer_bloom).insert_ip(addr[0])
        else:
            peer_bloom.insert_ip(addr[0])
        if kind == "announce_peer" and self.store is not None and port:
            # a token-validated announcer IS a swarm peer: seed it into
            # the tracker store (seed flag → seeder, else leecher)
            self.store.seed_peer(
                info_hash, addr[0], port, left=0 if seed else 1
            )
            self.fed_peers += 1
            self._unresolved.pop(info_hash, None)  # peers known now
        elif kind == "get_peers" and self.store is not None:
            # a demand signal with no peer attached: let the next crawl
            # resolve it instead of losing it to the freshness filter
            self._defer_resolve(info_hash)

    @property
    def known_hashes(self) -> int:
        return len(self._hashes)

    def hashes(self) -> list[bytes]:
        """Discovered info-hashes, most recent last (bounded copy)."""
        return list(self._hashes)

    # ------------------------------------------------------------- active

    async def crawl_once(
        self,
        target: bytes | None = None,
        max_nodes: int = CRAWL_MAX_NODES,
        max_lookups: int = CRAWL_MAX_LOOKUPS,
    ) -> dict:
        """One bounded crawl step; returns its census.

        Walks toward ``target`` (random by default) issuing BEP 51
        ``sample_infohashes`` to at most ``max_nodes`` nodes (the reply's
        closer-nodes keep the walk converging), then resolves at most
        ``max_lookups`` fresh hashes to peers and feeds them into the
        store.
        """
        tgt = target if target is not None else random_node_id()
        frontier: dict[tuple[str, int], bytes] = {
            n.addr: n.node_id for n in self.node.table.closest(tgt, K * 2)
        }
        # never query ourselves (the walk's closer-nodes can echo us back)
        visited: set[tuple[str, int]] = {(self.node.host, self.node.port)}
        sampled: list[bytes] = []
        queried = 0
        while queried < max_nodes:
            todo = sorted(
                (a for a in frontier if a not in visited),
                key=lambda a: xor_distance(frontier[a], tgt),
            )[: max_nodes - queried]
            if not todo:
                break
            for addr in todo:
                visited.add(addr)
                queried += 1
                try:
                    samples, _num, _ivl, nodes = (
                        await self.node.sample_infohashes(addr, tgt)
                    )
                except DHTError:
                    # node without BEP 51 or timed out — the walk goes on
                    continue
                self.crawl_nodes += 1
                sampled.extend(samples)
                for nid, ip, port in nodes:
                    frontier.setdefault((ip, port), nid)
        self.crawl_samples += len(sampled)

        fresh = [ih for ih in dict.fromkeys(sampled) if self._note(ih)]
        # everything sampled joins the resolve backlog; the lookup budget
        # then drains the backlog OLDEST-first, so hashes past one
        # crawl's budget are resolved by later crawls instead of being
        # permanently starved by the freshness filter
        for ih in fresh:
            self._defer_resolve(ih)
        todo = list(self._unresolved)[:max_lookups]
        resolved = 0
        fed = 0
        for ih in todo:
            self.crawl_lookups += 1
            self._unresolved.pop(ih, None)
            try:
                peers = await self.node.lookup_peers(ih)
            except DHTError:
                # transient failure: back to the END of the backlog so a
                # later crawl retries (the freshness filter would never
                # re-defer it) — the FIFO bound keeps dead hashes from
                # pinning the queue forever
                self._defer_resolve(ih)
                continue
            resolved += 1
            if self.store is not None:
                for ip, port in peers:
                    # family unknown from a sample: conservative leecher
                    self.store.seed_peer(ih, ip, port, left=1)
                    fed += 1
        self.fed_peers += fed
        self.crawls += 1
        return {
            "queried": queried,
            "sampled": len(sampled),
            "fresh": len(fresh),
            "resolved": resolved,
            "fed_peers": fed,
        }

    async def crawl(self, interval: float = CRAWL_INTERVAL) -> None:
        """Run :meth:`crawl_once` forever (cancel to stop)."""
        while True:
            await asyncio.sleep(interval)
            try:
                await self.crawl_once()
            except Exception as e:  # a bad step must not kill the loop
                log.debug("indexer crawl step failed: %s", e)

    # ------------------------------------------------------------ metrics

    def snapshot(self) -> dict:
        return {
            "hashes": len(self._hashes),
            "unresolved": len(self._unresolved),
            "blooms": len(self._blooms),
            "harvested": dict(self.harvested),
            "fed_peers": self.fed_peers,
            "crawls": self.crawls,
            "crawl_nodes": self.crawl_nodes,
            "crawl_samples": self.crawl_samples,
            "crawl_lookups": self.crawl_lookups,
        }
