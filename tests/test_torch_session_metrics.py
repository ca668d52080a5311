"""The port's session metrics surface (``utils/metrics.py``:
``render_metrics``, ``MetricsServer``, ``render_tracker_metrics``) and
the session pieces behind it, against the reference's cases.

Ported from the reference's tests: the render-format, tracker-renderer
and live-scrape cases of tests/test_metrics.py, and
``TestRateWindow`` and ``TestLoopbackWire``'s session download of
tests/test_swarm_obs.py (its bridge case is in test_torch_bridge.py).
Clients run ``hasher="cpu"`` unless a case says otherwise; the last
class serves a ``"gpu"`` client on ``device="cpu"`` with the port's
scheduler, whose lane backend labels are the port's, never the
reference's TPU ones.
"""

import asyncio
import json
import re
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_metrics import prom_lint
from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.obs.swarm import swarm_telemetry
from torrent_tpu_torch.session.client import Client, ClientConfig
from torrent_tpu_torch.storage.storage import MemoryStorage, Storage
from torrent_tpu_torch.utils.metrics import MetricsServer, render_metrics

from tests.test_torch_session import build_torrent_bytes, fast_config, run, start_tracker

_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [0-9.eE+-]+$"
)


def _parse(text):
    families = {}
    samples = []
    for line in text.strip().splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            families[name] = kind
        elif not line.startswith("#"):
            assert _SAMPLE.match(line), f"malformed sample: {line!r}"
            samples.append(line)
    return families, samples


class _Clock:
    """Injectable monotonic clock for duration-accounting tests."""

    def __init__(self, t0: float = 1000.0):
        self.t = t0

    def __call__(self) -> float:
        return self.t


class TestRenderFormat:
    def test_empty_client_renders_valid_exposition(self):
        async def go():
            c = Client(ClientConfig(host="127.0.0.1", hasher="cpu"))
            families, samples = _parse(render_metrics(c))
            assert families["torrent_tpu_torrents"] == "gauge"
            assert "torrent_tpu_torrents 0" in samples

        run(go())

    def test_label_escaping(self):
        from torrent_tpu_torch.utils.metrics import _esc

        assert _esc('na"me\\x\n') == 'na\\"me\\\\x\\n'


class TestTrackerRenderer:
    def test_tracker_renderer_fresh_store(self):
        """A fresh sharded store (no announces yet) must render complete
        headers and zeroed totals — the tracker's /metrics is scraped
        from the moment the listener binds."""
        from torrent_tpu_torch.server.shard import ShardedSwarmStore
        from torrent_tpu_torch.utils.metrics import render_tracker_metrics

        text = render_tracker_metrics(ShardedSwarmStore(n_shards=4).metrics_snapshot())
        prom_lint(text)
        assert "torrent_tpu_tracker_announces_total 0" in text
        assert "torrent_tpu_tracker_shards 4" in text
        assert 'torrent_tpu_tracker_shard_peers{shard="3"} 0' in text

    def test_tracker_renderer_partial_snapshot(self):
        """Missing keys (a degraded or hand-rolled snapshot) render as
        zeros, never a crash mid-scrape; an indexer sub-dict adds the
        indexer families."""
        from torrent_tpu_torch.utils.metrics import render_tracker_metrics

        text = render_tracker_metrics({"announces": 7, "shards": [{"peers": 3}]})
        prom_lint(text)
        assert "torrent_tpu_tracker_announces_total 7" in text
        assert "torrent_tpu_tracker_scrapes_total 0" in text
        assert 'torrent_tpu_tracker_shard_peers{shard="0"} 3' in text
        assert 'torrent_tpu_tracker_shard_swarms{shard="0"} 0' in text
        text = render_tracker_metrics(
            {"indexer": {"hashes": 5, "harvested": {"announce_peer": 2}}}
        )
        prom_lint(text)
        assert "torrent_tpu_tracker_indexer_hashes 5" in text
        assert (
            'torrent_tpu_tracker_indexer_harvested_total{kind="announce_peer"} 2'
            in text
        )
        assert (
            'torrent_tpu_tracker_indexer_harvested_total{kind="get_peers"} 0'
            in text
        )
        prom_lint(render_tracker_metrics({}))
        prom_lint(render_tracker_metrics(None))

    def test_tracker_renderer_shard_overflow(self):
        """Bounded shard cardinality: a store misconfigured wider than
        MAX_TRACKER_SHARDS folds the tail into shard="overflow"."""
        from torrent_tpu_torch.utils.metrics import (
            MAX_TRACKER_SHARDS,
            render_tracker_metrics,
        )

        n = MAX_TRACKER_SHARDS + 4
        snap = {
            "n_shards": n,
            "shards": [
                {"swarms": 1, "peers": 2, "announces": 3} for _ in range(n)
            ],
        }
        text = render_tracker_metrics(snap)
        prom_lint(text)
        assert f'shard="{MAX_TRACKER_SHARDS - 1}"' in text
        assert f'shard="{MAX_TRACKER_SHARDS}"' not in text
        assert 'torrent_tpu_tracker_shard_peers{shard="overflow"} 8' in text
        assert (
            'torrent_tpu_tracker_shard_announces_total{shard="overflow"} 12'
            in text
        )


def _http(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, None, None


class TestLiveScrape:
    def test_scrape_during_swarm(self):
        async def go():
            rng = np.random.default_rng(80)
            payload = rng.integers(0, 256, size=200_000, dtype=np.uint8).tobytes()
            server, pump, announce_url = await start_tracker()
            m = parse_metainfo(build_torrent_bytes(payload, 32768, announce_url.encode()))
            seed = Client(ClientConfig(host="127.0.0.1", hasher="cpu"))
            leech = Client(ClientConfig(host="127.0.0.1", hasher="cpu"))
            seed.config.torrent = fast_config()
            leech.config.torrent = fast_config()
            await seed.start()
            await leech.start()
            metrics = await MetricsServer(leech).start()
            try:
                ss = Storage(MemoryStorage(), m.info)
                for off in range(0, len(payload), 65536):
                    ss.set(off, payload[off : off + 65536])
                await seed.add(m, ss)
                t = await leech.add(m, Storage(MemoryStorage(), m.info))
                await asyncio.wait_for(t.on_complete.wait(), timeout=30)

                status, ctype, text = await asyncio.to_thread(
                    _http, f"http://127.0.0.1:{metrics.port}/metrics"
                )
                assert status == 200 and ctype.startswith("text/plain")
                families, samples = _parse(text)
                assert families["torrent_tpu_downloaded_bytes_total"] == "counter"
                ih = m.info_hash.hex()
                assert f'torrent_tpu_torrent_pieces_total{{info_hash="{ih}",name="swarm-test"}} 7' in samples
                assert f"torrent_tpu_downloaded_bytes_total {len(payload)}" in samples
                assert (
                    f'torrent_tpu_torrent_state{{info_hash="{ih}",state="seeding"}} 1'
                    in samples
                )
                status, _, _ = await asyncio.to_thread(
                    _http, f"http://127.0.0.1:{metrics.port}/other"
                )
                assert status == 404
            finally:
                metrics.close()
                await seed.close()
                await leech.close()
                server.close()
                await asyncio.wait_for(pump, 5)

        run(go())


class TestRateWindow:
    """PeerConnection.snapshot_rate's window anchors: rates feed the
    choke policy AND the telemetry, so a wrong window poisons both."""

    def _peer(self):
        from torrent_tpu_torch.session.peer import PeerConnection

        class _W:
            def close(self):
                pass

        return PeerConnection(
            peer_id=b"x" * 20, reader=None, writer=_W(), num_pieces=4
        )

    def test_initial_window_anchored_at_construction(self, monkeypatch):
        import torrent_tpu_torch.session.peer as peer_mod

        t = _Clock(5000.0)
        monkeypatch.setattr(peer_mod.time, "monotonic", t)
        p = self._peer()
        # a peer that delivered 1 MiB in its first 2 seconds must report
        # ~512 KiB/s — NOT bytes/monotonic-uptime (the old (0.0, 0)
        # default made every fresh connection's rate read as ~zero)
        p.bytes_down += 1 << 20
        t.t += 2.0
        assert p.download_rate() == pytest.approx((1 << 20) / 2.0)

    def test_snapshot_resets_window(self, monkeypatch):
        import torrent_tpu_torch.session.peer as peer_mod

        t = _Clock(5000.0)
        monkeypatch.setattr(peer_mod.time, "monotonic", t)
        p = self._peer()
        p.bytes_down += 1000
        p.bytes_up += 4000
        t.t += 1.0
        p.snapshot_rate()
        # the old window's bytes are gone; only post-snapshot deltas count
        t.t += 2.0
        assert p.download_rate() == 0.0
        p.bytes_down += 500
        p.bytes_up += 900
        t.t += 0.5
        # marks were taken at t=5001: window is 2.5s, not 0.5s
        assert p.download_rate() == pytest.approx(500 / 2.5)
        assert p.upload_rate() == pytest.approx(900 / 2.5)

    def test_zero_dt_guard(self, monkeypatch):
        import torrent_tpu_torch.session.peer as peer_mod

        t = _Clock(5000.0)
        monkeypatch.setattr(peer_mod.time, "monotonic", t)
        p = self._peer()
        p.snapshot_rate()
        p.bytes_down += 100
        assert p.download_rate() == 0.0  # dt == 0 never divides


class TestLoopbackWire:
    """A real loopback download charges the recv ledger stage, populates
    the per-peer registry, emits lifecycle spans, and serves /v1/swarm
    from the session MetricsServer."""

    def test_download_charges_recv_and_populates_registry(self):
        from torrent_tpu_torch.obs.ledger import pipeline_ledger
        from torrent_tpu_torch.obs.tracer import tracer

        async def go():
            rng = np.random.default_rng(41)
            payload = rng.integers(0, 256, size=180_000, dtype=np.uint8).tobytes()
            prev = pipeline_ledger().snapshot()
            base_totals = swarm_telemetry().snapshot()["totals"]
            server, pump, announce_url = await start_tracker()
            m = parse_metainfo(
                build_torrent_bytes(payload, 32768, announce_url.encode())
            )
            seed = Client(ClientConfig(host="127.0.0.1", hasher="cpu"))
            leech = Client(ClientConfig(host="127.0.0.1", hasher="cpu"))
            seed.config.torrent = fast_config()
            leech.config.torrent = fast_config()
            await seed.start()
            await leech.start()
            metrics = await MetricsServer(leech).start()
            try:
                ss = Storage(MemoryStorage(), m.info)
                for off in range(0, len(payload), 65536):
                    ss.set(off, payload[off : off + 65536])
                await seed.add(m, ss)
                t = await leech.add(m, Storage(MemoryStorage(), m.info))
                await asyncio.wait_for(t.on_complete.wait(), timeout=30)

                # (a) recv stage: the download's bytes reached the ledger
                snap = pipeline_ledger().snapshot()
                recv = snap["stages"].get("recv") or {}
                prev_recv = (prev.get("stages") or {}).get("recv") or {}
                assert recv.get("bytes", 0) - prev_recv.get("bytes", 0) >= len(
                    payload
                )

                # (b) the registry saw both ends of the loopback pair
                swarm = swarm_telemetry().snapshot()
                assert swarm["counts"]["connected"] >= 2
                heavy = [
                    p for p in swarm["peers"].values()
                    if p["bytes_down"] >= len(payload)
                ]
                assert heavy, "no peer accounts the downloaded payload"
                assert heavy[0]["block_rtt"]["count"] > 0
                assert heavy[0]["msgs"]["Piece"]["count"] > 0
                assert (
                    swarm["totals"]["bytes_down"]
                    - base_totals.get("bytes_down", 0)
                    >= len(payload)
                )

                # (c) connection lifecycle spans under the deterministic
                # per-torrent swarm trace
                trace_id = f"swarm-{m.info_hash.hex()[:12]}"
                tree = tracer().trace_tree(trace_id)
                assert tree is not None
                names = {s["name"] for s in tree["spans"]}
                assert "swarm.peer.connect" in names

                # (d) GET /v1/swarm on the session MetricsServer
                status, ctype, body = await asyncio.to_thread(
                    _http, f"http://127.0.0.1:{metrics.port}/v1/swarm"
                )
                assert status == 200 and ctype == "application/json"
                payload_json = json.loads(body)
                assert payload_json["counts"]["connected"] >= 2
                assert "overflow" in payload_json

                # (e) the swarm families ride the session /metrics scrape
                _, _, text = await asyncio.to_thread(
                    _http, f"http://127.0.0.1:{metrics.port}/metrics"
                )
                assert "torrent_tpu_swarm_peers " in text
                assert 'torrent_tpu_peer_bytes_down_total{peer="' in text
                assert "torrent_tpu_swarm_block_rtt_seconds_bucket" in text
            finally:
                metrics.close()
                await seed.close()
                await leech.close()
                server.close()
                await asyncio.wait_for(pump, 5)

        run(go())


class TestGpuClientSurface:
    def test_gpu_client_metrics_carry_the_ports_scheduler_labels(self):
        """A ``"gpu"`` client on ``device="cpu"`` with the port's
        scheduler: /metrics lints, carries the session and scheduler
        series, and its lane backend labels are the port's planes
        (``device`` for sha1, ``torch`` for sha256 on the CPU), never
        the reference's pallas or scan. No sanitizer series render."""
        from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=4, flush_deadline=0.01),
                hasher="gpu", device="cpu",
            )
            await sched.start()
            client = Client(ClientConfig(host="127.0.0.1", hasher="gpu", device="cpu"))
            server = await MetricsServer(client, scheduler=sched).start()
            try:
                await sched.submit("t", [b"m" * 64])
                await sched.submit("v", [b"n" * 64], algo="sha256")
                return await asyncio.to_thread(
                    _http, f"http://127.0.0.1:{server.port}/metrics"
                )
            finally:
                server.close()
                await sched.close()

        status, _, text = run(go())
        assert status == 200
        prom_lint(text)
        assert "torrent_tpu_torrents 0" in text
        backends = set(re.findall(r'backend="([a-z]+)"', text))
        assert {"device", "torch"} <= backends
        assert not backends & {"pallas", "scan", "tpu"}
        assert "torrent_tpu_lockset" not in text and "torrent_tpu_guarded" not in text
