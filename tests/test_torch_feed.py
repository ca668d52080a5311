"""BEP 36 torrent RSS/Atom feeds: parse + poll + auto-add, and the
netbench tool: the reference's cases with the port's imports.

The subscription loop long-running seeds use to track a publisher: poll
the feed, fetch each new .torrent, add it. Parsing treats the XML as
hostile (DOCTYPE refused, non-http(s)/magnet URLs dropped). The CLI's
``feed --once`` case waits for ``tools/cli.py``.
"""

import asyncio
import os
import threading

import numpy as np
import pytest

from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.session.client import Client, ClientConfig
from torrent_tpu_torch.tools.feed import FeedError, FeedPoller, parse_feed
from torrent_tpu_torch.tools.make_torrent import make_torrent

from tests.test_torch_session import build_torrent_bytes, fast_config, start_tracker


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


RSS = """<?xml version="1.0"?>
<rss version="2.0"><channel>
  <title>releases</title>
  <item>
    <title>dataset v2</title>
    <enclosure url="http://example.org/v2.torrent" type="application/x-bittorrent"/>
  </item>
  <item>
    <title>dataset v1</title>
    <link>http://example.org/v1.torrent</link>
  </item>
  <item>
    <title>evil</title>
    <enclosure url="file:///etc/passwd"/>
    <link>javascript:alert(1)</link>
  </item>
</channel></rss>
"""

ATOM = """<?xml version="1.0"?>
<feed xmlns="http://www.w3.org/2005/Atom">
  <title>releases</title>
  <entry>
    <title>nightly</title>
    <link rel="alternate" href="http://example.org/page"/>
    <link rel="enclosure" href="http://example.org/nightly.torrent"/>
  </entry>
  <entry>
    <title>magnet drop</title>
    <link href="magnet:?xt=urn:btih:aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa"/>
  </entry>
</feed>
"""


class TestParse:
    def test_rss_enclosure_and_link_fallback(self):
        items = parse_feed(RSS.encode())
        assert [i.url for i in items] == [
            "http://example.org/v2.torrent",
            "http://example.org/v1.torrent",
        ]
        assert items[0].title == "dataset v2"

    def test_atom_prefers_enclosure_rel(self):
        items = parse_feed(ATOM.encode())
        assert items[0].url == "http://example.org/nightly.torrent"
        assert items[1].url.startswith("magnet:?xt=urn:btih:")

    def test_doctype_refused(self):
        bomb = b'<?xml version="1.0"?><!DOCTYPE x [<!ENTITY a "b">]><rss/>'
        with pytest.raises(FeedError, match="DOCTYPE"):
            parse_feed(bomb)

    def test_malformed_xml_raises(self):
        with pytest.raises(FeedError, match="well-formed"):
            parse_feed(b"<rss><channel><item></rss>")

    def test_empty_feed_ok(self):
        assert parse_feed(b"<rss><channel></channel></rss>") == []


def _serve_routes(routes: dict):
    """Local HTTP server mapping path -> callable returning bytes."""
    import http.server

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = routes.get(self.path)
            if body is None:
                self.send_response(404)
                self.end_headers()
                return
            payload = body() if callable(body) else body
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_port}", srv.shutdown


class TestLivePolling:
    def test_feed_entry_downloads_through_a_real_swarm(self, tmp_path):
        """Seed publishes a torrent + feed over HTTP; the subscriber's
        poll adds it and the download completes from the seed. A second
        poll and a rotated-URL duplicate add nothing."""

        async def go():
            rng = np.random.default_rng(36)
            payload = rng.integers(0, 256, size=128 * 1024, dtype=np.uint8).tobytes()
            server, pump, announce_url = await start_tracker()
            meta_bytes = build_torrent_bytes(
                payload, 32768, announce_url.encode(), name=b"drop.bin"
            )
            meta = parse_metainfo(meta_bytes)

            feed_xml = None  # set per phase

            base, shutdown = _serve_routes(
                {
                    "/feed.xml": lambda: feed_xml,
                    "/drop.torrent": meta_bytes,
                    "/rotated.torrent": meta_bytes,  # same content, new URL
                }
            )
            feed_xml = (
                f'<rss version="2.0"><channel><item><title>drop</title>'
                f'<enclosure url="{base}/drop.torrent"/></item></channel></rss>'
            ).encode()

            seed = Client(ClientConfig(host="127.0.0.1", enable_upnp=False, hasher="cpu"))
            sub = Client(ClientConfig(host="127.0.0.1", enable_upnp=False, hasher="cpu"))
            seed.config.torrent = fast_config()
            sub.config.torrent = fast_config()
            await seed.start()
            await sub.start()
            try:
                (tmp_path / "seed").mkdir()
                (tmp_path / "seed" / "drop.bin").write_bytes(payload)
                ts = await seed.add(meta, str(tmp_path / "seed"))
                assert ts.bitfield.complete

                (tmp_path / "dl").mkdir()
                poller = FeedPoller(sub, f"{base}/feed.xml", str(tmp_path / "dl"))
                added = await poller.poll_once()
                assert len(added) == 1
                await asyncio.wait_for(added[0].on_complete.wait(), 60)
                assert (tmp_path / "dl" / "drop.bin").read_bytes() == payload

                assert await poller.poll_once() == []  # same URL: seen
                feed_xml = (
                    f'<rss version="2.0"><channel><item><title>again</title>'
                    f'<enclosure url="{base}/rotated.torrent"/></item></channel></rss>'
                ).encode()
                # rotated URL, same infohash: fetched but not re-added
                assert await poller.poll_once() == []
            finally:
                await seed.close()
                await sub.close()
                server.close()
                pump.cancel()
                shutdown()

        run(go())

class TestDedupAndRetrySemantics:
    def test_failed_add_is_retried_next_poll(self, tmp_path):
        """A transiently-failing download URL must not be burned into the
        seen set (it would be dropped forever, across --seen restarts)."""

        async def go():
            attempts = []
            meta_bytes_holder = []

            def torrent_route():
                attempts.append(1)
                if len(attempts) == 1:
                    return b"not a torrent"  # first fetch: garbage (=failure)
                return meta_bytes_holder[0]

            base, shutdown = _serve_routes(
                {
                    "/feed.xml": lambda: (
                        '<rss version="2.0"><channel><item><title>x</title>'
                        f'<enclosure url="{base_holder[0]}/flaky.torrent"/></item>'
                        "</channel></rss>"
                    ).encode(),
                    "/flaky.torrent": torrent_route,
                }
            )
            base_holder = [base]
            rng = np.random.default_rng(44)
            payload = rng.integers(0, 256, size=16384, dtype=np.uint8).tobytes()
            meta_bytes_holder.append(
                build_torrent_bytes(payload, 16384, b"http://127.0.0.1:1/a", name=b"f.bin")
            )

            c = Client(ClientConfig(host="127.0.0.1", enable_upnp=False, hasher="cpu"))
            c.config.torrent = fast_config()
            await c.start()
            try:
                (tmp_path / "dl").mkdir()
                poller = FeedPoller(c, f"{base}/feed.xml", str(tmp_path / "dl"))
                assert await poller.poll_once() == []  # garbage: add fails
                assert f"{base}/flaky.torrent" not in poller.seen  # retryable
                added = await poller.poll_once()  # server healthy now
                assert len(added) == 1
            finally:
                await c.close()
                shutdown()

        run(go())

    def test_require_signed_gate_filters_feed_entries(self, tmp_path):
        """BEP 36 + BEP 35: under the signature gate only entries whose
        .torrent verifies under the trusted key are added; unsigned,
        wrong-key, and magnet entries are refused — and NOT burned into
        the seen set (the publisher may sign them later)."""

        async def go():
            from torrent_tpu_torch.codec import signing
            from torrent_tpu_torch.utils import ed25519

            seed = bytes(range(32))
            rng = np.random.default_rng(45)
            pa = rng.integers(0, 256, size=16384, dtype=np.uint8).tobytes()
            pb = rng.integers(0, 256, size=16384, dtype=np.uint8).tobytes()
            good = signing.sign_torrent(
                build_torrent_bytes(pa, 16384, b"http://127.0.0.1:1/a", name=b"good.bin"),
                seed, "publisher",
            )
            bad = build_torrent_bytes(
                pb, 16384, b"http://127.0.0.1:1/a", name=b"bad.bin"
            )  # unsigned
            base, shutdown = _serve_routes(
                {
                    "/feed.xml": lambda: (
                        '<rss version="2.0"><channel>'
                        "<item><title>g</title>"
                        f'<enclosure url="{base_holder[0]}/good.torrent"/></item>'
                        "<item><title>b</title>"
                        f'<enclosure url="{base_holder[0]}/bad.torrent"/></item>'
                        "<item><title>m</title>"
                        '<enclosure url="magnet:?xt=urn:btih:'
                        + "11" * 20
                        + '"/></item>'
                        "</channel></rss>"
                    ).encode(),
                    "/good.torrent": lambda: good,
                    "/bad.torrent": lambda: bad,
                }
            )
            base_holder = [base]
            c = Client(ClientConfig(host="127.0.0.1", enable_upnp=False, hasher="cpu"))
            c.config.torrent = fast_config()
            await c.start()
            try:
                (tmp_path / "dl").mkdir()
                poller = FeedPoller(
                    c,
                    f"{base}/feed.xml",
                    str(tmp_path / "dl"),
                    require_signed=("publisher", ed25519.publickey(seed)),
                )
                added = await poller.poll_once()
                assert [t.info.name for t in added] == ["good.bin"]
                assert f"{base}/good.torrent" in poller.seen
                # an unsigned .torrent stays retryable (may be signed
                # later); a magnet can NEVER pass → marked seen so it
                # isn't re-refused every poll forever
                assert f"{base}/bad.torrent" not in poller.seen
                assert any(s.startswith("magnet:") for s in poller.seen)
            finally:
                await c.close()
                shutdown()

        run(go())

    def test_rotated_url_survives_restart_via_seen_hashes(self, tmp_path):
        """Infohashes persist in the seen set as ih:<hex>, so a fresh
        process with a rotated entry URL cannot re-add the content."""

        async def go():
            rng = np.random.default_rng(45)
            payload = rng.integers(0, 256, size=16384, dtype=np.uint8).tobytes()
            meta_bytes = build_torrent_bytes(
                payload, 16384, b"http://127.0.0.1:1/a", name=b"r.bin"
            )
            base, shutdown = _serve_routes(
                {
                    "/feed.xml": lambda: (
                        '<rss version="2.0"><channel><item><title>r</title>'
                        f'<enclosure url="{base_holder[0]}/rot2.torrent"/></item>'
                        "</channel></rss>"
                    ).encode(),
                    "/rot2.torrent": meta_bytes,
                }
            )
            base_holder = [base]

            c = Client(ClientConfig(host="127.0.0.1", enable_upnp=False, hasher="cpu"))
            c.config.torrent = fast_config()
            await c.start()
            try:
                (tmp_path / "dl2").mkdir()
                ih = parse_metainfo(meta_bytes).info_hash
                # "previous run" added the content under a different URL
                carried = {f"{base}/rot1.torrent", "ih:" + ih.hex()}
                poller = FeedPoller(
                    c, f"{base}/feed.xml", str(tmp_path / "dl2"), seen=carried
                )
                assert await poller.poll_once() == []  # hash known: no re-add
                assert ih not in c.torrents
            finally:
                await c.close()
                shutdown()

        run(go())


class TestPublisherLifecycle:
    def test_feed_subscribe_then_update_with_reuse(self, tmp_path):
        """The whole publisher story in one flow: a subscriber picks v1
        up from the feed and downloads it from the swarm; the publisher
        later ships v2 (one file changed) named by v1's update-url; the
        subscriber applies the update in place and only the changed file
        is wanted again."""

        async def go():
            rng = np.random.default_rng(77)
            keep = rng.integers(0, 256, size=64 * 1024, dtype=np.uint8).tobytes()
            old_b = rng.integers(0, 256, size=32 * 1024, dtype=np.uint8).tobytes()
            new_b = rng.integers(0, 256, size=32 * 1024, dtype=np.uint8).tobytes()

            server, pump, announce_url = await start_tracker()
            pub_v1 = tmp_path / "pub1" / "ds"
            pub_v1.mkdir(parents=True)
            (pub_v1 / "keep.bin").write_bytes(keep)
            (pub_v1 / "change.bin").write_bytes(old_b)

            base_holder = []
            v2_bytes_holder = []

            routes = {}
            base, shutdown = _serve_routes(routes)
            base_holder.append(base)

            from torrent_tpu_torch.tools.make_torrent import make_torrent as mk
            from torrent_tpu_torch.codec.bencode import bdecode, bencode

            raw_v1 = mk(
                str(pub_v1), announce_url, piece_length=16384, hasher="gpu", device="cpu"
            )
            top = bdecode(raw_v1)
            top[b"update-url"] = f"{base}/ds.torrent".encode()
            raw_v1 = bencode(top)
            routes["/feed.xml"] = (
                '<rss version="2.0"><channel><item><title>ds</title>'
                f'<enclosure url="{base}/ds.torrent"/></item></channel></rss>'
            ).encode()
            routes["/ds.torrent"] = lambda: (
                v2_bytes_holder[0] if v2_bytes_holder else raw_v1
            )

            pub = Client(ClientConfig(host="127.0.0.1", enable_upnp=False, hasher="cpu"))
            sub = Client(ClientConfig(host="127.0.0.1", enable_upnp=False, hasher="cpu"))
            pub.config.torrent = fast_config()
            sub.config.torrent = fast_config()
            await pub.start()
            await sub.start()
            try:
                tp = await pub.add(parse_metainfo(raw_v1), str(tmp_path / "pub1"))
                assert tp.bitfield.complete

                (tmp_path / "subdl").mkdir()
                poller = FeedPoller(sub, f"{base}/feed.xml", str(tmp_path / "subdl"))
                added = await poller.poll_once()
                assert len(added) == 1
                t1 = added[0]
                await asyncio.wait_for(t1.on_complete.wait(), 60)

                # publisher ships v2: change.bin differs, update-url serves it
                pub_v2 = tmp_path / "pub2" / "ds"
                pub_v2.mkdir(parents=True)
                (pub_v2 / "keep.bin").write_bytes(keep)
                (pub_v2 / "change.bin").write_bytes(new_b)
                v2_bytes_holder.append(
                    mk(str(pub_v2), announce_url, piece_length=16384, hasher="gpu", device="cpu")
                )

                t2 = await sub.apply_update(t1)
                assert t2 is not None
                # keep.bin (pieces 2-5 after change.bin's 0-1) adopted in
                # place; change.bin re-wanted
                assert not t2.bitfield.complete
                assert not t2.bitfield.has(0)
                assert all(t2.bitfield.has(i) for i in (2, 3, 4, 5))

                # publisher seeds v2 too: subscriber converges
                tp2 = await pub.add(
                    parse_metainfo(v2_bytes_holder[0]), str(tmp_path / "pub2")
                )
                assert tp2.bitfield.complete
                await asyncio.wait_for(t2.on_complete.wait(), 60)
                assert (
                    tmp_path / "subdl" / "ds" / "change.bin"
                ).read_bytes() == new_b
                assert (
                    tmp_path / "subdl" / "ds" / "keep.bin"
                ).read_bytes() == keep
            finally:
                await pub.close()
                await sub.close()
                server.close()
                pump.cancel()
                shutdown()

        run(go(), timeout=120)


class TestNetbenchTool:
    def test_netbench_single_smoke(self):
        """Tiny end-to-end drive of the reproducible swarm bench tool."""
        import subprocess
        import sys as _sys
        import json as _json

        r = subprocess.run(
            [
                _sys.executable,
                "-m",
                "torrent_tpu_torch.tools.netbench",
                "--mode",
                "single",
                "--mb",
                "8",
                "--piece-kb",
                "64",
                "--hasher",
                "cpu",
                "--json",
            ],
            capture_output=True,
            text=True,
            cwd=REPO,
            timeout=120,
        )
        assert r.returncode == 0, r.stderr[-1500:]
        rec = _json.loads(r.stdout.strip().splitlines()[-1])
        assert rec["metric"] == "swarm_tcp_1leech_mib_s"
        assert rec["value"] > 0

    def test_netbench_runs_from_any_cwd(self, tmp_path):
        """netbench resolves its test-harness imports relative to its own
        file, so ``python -m torrent_tpu_torch.tools.netbench`` works from
        any working directory; its clients verify with the "gpu" hasher,
        here on ``device="cpu"``."""
        import json as _json
        import subprocess
        import sys as _sys

        proc = subprocess.run(
            [
                _sys.executable,
                "-c",
                "import asyncio, json; "
                "from torrent_tpu_torch.tools.netbench import _swarm; "
                "print(json.dumps(asyncio.run("
                "_swarm(65536, 16384, 1, False, device='cpu'))))",
            ],
            cwd=str(tmp_path),
            capture_output=True,
            text=True,
            timeout=120,
            env={**os.environ, "PYTHONPATH": REPO},
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        rec = _json.loads(proc.stdout.strip().splitlines()[-1])
        assert rec["leeches"] == 1 and rec["seconds"] > 0

    def test_netbench_default_hasher_needs_a_card(self):
        """The default hasher is the card's: on a host without CUDA the
        bench raises before any client listens, never falls back."""
        import subprocess
        import sys as _sys

        r = subprocess.run(
            [_sys.executable, "-m", "torrent_tpu_torch.tools.netbench",
             "--mb", "1", "--piece-kb", "64", "--json"],
            capture_output=True, text=True, cwd=REPO, timeout=120,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
        )
        assert r.returncode != 0
        assert "RuntimeError" in r.stderr and r.stdout.strip() == ""
