"""`torrent-tpu serve` — the long-running tracker deployment recipe.

One command wires the production announce plane into a deployable
service:

* the **sharded tracker** (``server/shard.py``): HTTP + UDP announce
  transports feeding the sharded swarm store through the batched pump,
* the **DHT indexer** (``net/indexer.py``): a DHT node harvesting
  ``get_peers``/``announce_peer`` passively and walking BEP 51 samples
  on a bounded budget, seeding the store with persistent-tracker
  semantics (magnet-only swarms answerable with no ``.torrent``),
* ``GET /v1/health`` on the tracker listener: liveness + readiness
  (pump ticking, sampler alive, SLO breaches) for a real load balancer,
* ``GET /metrics``: ``torrent_tpu_tracker_*`` + announce-latency
  histograms, plus the timeline/SLO series when ``--slo`` is armed,
* optionally (``--slo``) the **timeline sampler + SLO engine**
  (``obs/timeline`` + ``obs/slo``): periodic obs samples with tracker
  facts, error-budget burn rates, a ``slo_breach`` flight dump per
  breach transition, and post-mortem dumps to
  ``TORRENT_TPU_TIMELINE_DIR``.

Run it under any supervisor — see the README quickstart for systemd
and container examples. Everything binds the ``--host`` you give it
(default all interfaces: a tracker exists to be announced to).
"""

from __future__ import annotations

import asyncio

from torrent_tpu_torch.utils.log import get_logger

log = get_logger("tools.serve")

__all__ = ["ServiceHandle", "start_service", "main"]


class ServiceHandle:
    """A running deployment: the tracker transports + pump, the DHT
    node + indexer crawl loop, and (when armed) the timeline/SLO tier.
    ``close()`` tears everything down in reverse dependency order."""

    def __init__(self):
        self.server = None  # TrackerServer (http_port/udp_port)
        self.pump_task: asyncio.Task | None = None
        self.store = None
        self.dht = None
        self.indexer = None
        self.crawl_task: asyncio.Task | None = None
        self.timeline = None
        self.sampler = None
        self.slo_engine = None

    @property
    def http_port(self):
        return self.server.http_port if self.server else None

    async def close(self) -> None:
        if self.sampler is not None:
            await asyncio.to_thread(self.sampler.stop)
            from torrent_tpu_torch.obs import slo as _slo

            # only release the slot if it is still ours (a later server
            # in the same process may have armed its own engine)
            _slo.disarm(self.slo_engine)
        for task in (self.crawl_task, self.pump_task):
            if task is not None and not task.done():
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):
                    pass
        if self.dht is not None:
            self.dht.close()
        if self.server is not None:
            self.server.close()


async def start_service(
    http_port: int = 8000,
    udp_port: int | None = 6969,
    host: str = "0.0.0.0",
    interval: int = 600,
    shards: int = 8,
    dht_port: int | None = 6881,
    crawl_interval: float = 300.0,
    slo=None,
    timeline_interval_s: float = 2.0,
) -> ServiceHandle:
    """Wire and start the whole deployment. ``dht_port=None`` disables
    the indexer (tracker-only mode); ``slo`` arms the timeline/SLO tier
    (True = the default contract, or an objective spec string)."""
    from torrent_tpu_torch.server.shard import (
        PUMP_MAX_AGE_S,
        ShardedSwarmStore,
        run_sharded_tracker,
    )
    from torrent_tpu_torch.server.tracker import ServeOptions

    handle = ServiceHandle()
    handle.store = ShardedSwarmStore(n_shards=shards, interval=interval)

    if dht_port is not None:
        from torrent_tpu_torch.net.dht import DHTNode
        from torrent_tpu_torch.net.indexer import DhtIndexer

        handle.dht = await DHTNode(host=host, port=dht_port).start()
        handle.indexer = DhtIndexer(handle.dht, handle.store)
        handle.crawl_task = asyncio.create_task(
            handle.indexer.crawl(interval=crawl_interval)
        )

    handle.server, handle.pump_task = await run_sharded_tracker(
        ServeOptions(http_port=http_port, udp_port=udp_port, host=host,
                     interval=interval),
        store=handle.store,
        indexer=handle.indexer,
    )
    pump_state = handle.pump_task.pump_state

    if slo:
        import time as _time

        from torrent_tpu_torch.obs import slo as _slo
        from torrent_tpu_torch.obs.slo import (
            DEFAULT_SLO_SPEC,
            SloEngine,
            build_health,
        )
        from torrent_tpu_torch.obs.timeline import Timeline, TimelineSampler

        handle.slo_engine = _slo.arm(
            SloEngine(DEFAULT_SLO_SPEC if slo is True else slo)
        )
        handle.timeline = Timeline()

        def _tracker_facts() -> dict:
            snap = handle.store.metrics_snapshot()
            return {
                "announces": snap.get("announces", 0),
                "peers": snap.get("peers", 0),
                "swarms": snap.get("swarms", 0),
            }

        handle.sampler = TimelineSampler(
            handle.timeline,
            interval_s=timeline_interval_s,
            sources={"tracker": _tracker_facts},
            on_sample=handle.slo_engine.observe,
            on_sample_tail=handle.slo_engine.long_samples,
        ).start()

        # /v1/health now also reflects sampler liveness + SLO breaches;
        # /metrics carries the timeline + SLO series
        def _health() -> dict:
            return build_health(
                pump_age_s=_time.monotonic() - pump_state["tick"],
                pump_max_age_s=PUMP_MAX_AGE_S,
                sampler_alive=handle.sampler.alive,
                slo_report=handle.slo_engine.report(),
            )

        handle.server.health_provider = _health
        base_metrics = handle.server.metrics_provider

        def _metrics() -> str:
            from torrent_tpu_torch.utils.metrics import (
                render_slo_metrics,
                render_timeline_metrics,
            )

            tl = handle.timeline.stats()  # counters only, no ring copy
            tl["sampler_alive"] = handle.sampler.alive
            return (
                base_metrics()
                + render_timeline_metrics(tl)
                + render_slo_metrics(handle.slo_engine.report())
            )

        handle.server.metrics_provider = _metrics
    return handle


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="torrent-tpu serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--http-port", type=int, default=8000)
    ap.add_argument(
        "--udp-port", type=int, default=6969,
        help="negative value disables the UDP transport",
    )
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument(
        "--interval", type=int, default=600,
        help="announce interval handed to clients (default %(default)s)",
    )
    ap.add_argument(
        "--shards", type=int, default=8,
        help="swarm-store shards (default %(default)s)",
    )
    ap.add_argument(
        "--dht-port", type=int, default=6881,
        help="DHT indexer UDP port (negative disables the indexer)",
    )
    ap.add_argument(
        "--crawl-interval", type=float, default=300.0,
        help="seconds between BEP 51 indexer crawl steps (default %(default)s)",
    )
    ap.add_argument(
        "--slo", nargs="?", const=True, default=None, metavar="SPEC",
        help="arm the timeline sampler + SLO engine (obs/slo spec, e.g. "
        "'availability=0.999;integrity=on'; no SPEC = the default "
        "contract). /v1/health reflects breaches; /metrics gains "
        "torrent_tpu_slo_*/timeline_* series",
    )
    ap.add_argument(
        "--timeline-interval", type=float, default=2.0, metavar="S",
        help="seconds between timeline samples when --slo is armed",
    )
    args = ap.parse_args(argv)

    async def go() -> int:
        handle = await start_service(
            http_port=args.http_port,
            udp_port=args.udp_port if args.udp_port >= 0 else None,
            host=args.host,
            interval=args.interval,
            shards=args.shards,
            dht_port=args.dht_port if args.dht_port >= 0 else None,
            crawl_interval=args.crawl_interval,
            slo=args.slo,
            timeline_interval_s=args.timeline_interval,
        )
        print(
            f"torrent-tpu serve: tracker http={handle.server.http_port} "
            f"udp={handle.server.udp_port} shards={args.shards} "
            f"dht={handle.dht.port if handle.dht else 'off'} "
            f"slo={'armed' if handle.slo_engine else 'off'}"
        )
        print(
            f"  health: http://{args.host}:{handle.server.http_port}/v1/health"
            f"  metrics: http://{args.host}:{handle.server.http_port}/metrics"
        )
        try:
            await handle.pump_task
        except asyncio.CancelledError:
            pass
        finally:
            await handle.close()
        return 0

    try:
        return asyncio.run(go())
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":  # pragma: no cover - manual entrypoint
    raise SystemExit(main())
