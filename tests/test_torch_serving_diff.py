"""The port's tracker deployment and serving tools against the reference's.

The sharded store, the indexer, ``render_tracker_metrics``,
``render_metrics``, the scenario plane, the feed parser and the stream
server are host code copied from the reference. Every case here feeds
both packages the same seeded input, with the clocks and ``random``
draws they would take from the host pinned to the same values, and
requires exact equality: replies, scrapes, snapshots, metrics text,
canonical verdict bytes, parsed feed items and HTTP response bytes are
equal or the case fails. The tolerance is zero everywhere.

The last class joins a magnet across the packages through the
persistent tracker: a reference leech (``hasher="cpu"``) through the
port's ``start_service``, fed by the port's indexer, and a port leech
(``hasher="gpu"`` on ``device="cpu"``, the plain PyTorch SHA-1) through
the reference's.
"""

import asyncio
import dataclasses
import hashlib
import random

import numpy as np
import pytest

from torrent_tpu.codec.magnet import Magnet as RefMagnet
from torrent_tpu.codec.metainfo import parse_metainfo as ref_parse_metainfo
from torrent_tpu.net.types import AnnounceEvent as RefEvent
from torrent_tpu.scenario import canonical_bytes as ref_canonical_bytes
from torrent_tpu.scenario import run_scenario as ref_run_scenario
from torrent_tpu.scenario.library import get as ref_get
from torrent_tpu.server import shard as ref_shard
from torrent_tpu.session.client import Client as RefClient
from torrent_tpu.session.client import ClientConfig as RefClientConfig
from torrent_tpu.session.torrent import TorrentConfig as RefTorrentConfig
from torrent_tpu.storage.storage import MemoryStorage as RefMemoryStorage
from torrent_tpu.storage.storage import Storage as RefStorage
from torrent_tpu.tools import feed as ref_feed
from torrent_tpu.tools import serve as ref_serve
from torrent_tpu.tools import stream as ref_stream
from torrent_tpu.utils import metrics as ref_metrics
from torrent_tpu_torch.codec.magnet import Magnet
from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.net.types import AnnounceEvent
from torrent_tpu_torch.scenario import canonical_bytes, run_scenario
from torrent_tpu_torch.scenario.library import SCENARIOS, get
from torrent_tpu_torch.server import shard as port_shard
from torrent_tpu_torch.session.client import Client, ClientConfig
from torrent_tpu_torch.session.torrent import TorrentConfig
from torrent_tpu_torch.storage.storage import MemoryStorage, Storage
from torrent_tpu_torch.tools import feed as port_feed
from torrent_tpu_torch.tools import serve as port_serve
from torrent_tpu_torch.tools import stream as port_stream
from torrent_tpu_torch.utils import metrics as port_metrics

from tests.test_torch_scenario import _SCALE
from tests.test_torch_session import build_torrent_bytes, run

SEEDS = range(4)


class _Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# ------------------------------------------------------------ sharded store


def _script(seed: int, n: int = 400) -> list[tuple]:
    """A seeded announce / scrape / seed_peer / sweep / clock sequence
    over a few swarms, with every event, numwant and left value."""
    rng = np.random.default_rng(seed)
    swarms = [hashlib.sha1(b"diff-swarm-%d-%d" % (seed, i)).digest() for i in range(6)]
    events = [None, "STARTED", "COMPLETED", "STOPPED"]
    ops = []
    for _ in range(n):
        k = int(rng.integers(0, 100))
        h = swarms[int(rng.integers(0, len(swarms)))]
        if k < 70:
            p = int(rng.integers(0, 60))
            ops.append((
                "announce", h, (b"peer%04d" % p).ljust(20, b"-"),
                f"10.{p % 7}.{p % 13}.{p % 251 + 1}", 6000 + p,
                int(rng.integers(0, 3)) * 1000,
                events[int(rng.integers(0, 4))],
                [None, -1, 0, 5, 50, 5000][int(rng.integers(0, 6))],
            ))
        elif k < 80:
            ops.append(("scrape", [swarms[int(i)] for i in rng.integers(0, 6, 3)]))
        elif k < 88:
            p = int(rng.integers(0, 40))
            ops.append(("seed_peer", h, f"172.16.0.{p + 1}", 7000 + p,
                        int(rng.integers(0, 2))))
        elif k < 95:
            ops.append(("advance", float(rng.integers(1, 900))))
        else:
            ops.append(("sweep",))
    ops.append(("scrape", []))
    return ops


def _drive(mod, event_cls, ops, store):
    clock = store._clock
    out = []
    for op in ops:
        if op[0] == "announce":
            _, h, pid, ip, port, left, ev, numwant = op
            r = store.announce(
                h, pid, ip, port, left=left,
                event=getattr(event_cls, ev) if ev else None, numwant=numwant,
            )
            out.append((
                r.complete, r.incomplete,
                [(p.ip, p.port, p.peer_id) for p in r.peers],
            ))
        elif op[0] == "scrape":
            out.append(store.scrape(op[1]))
        elif op[0] == "seed_peer":
            _, h, ip, port, left = op
            out.append(store.seed_peer(h, ip, port, left=left))
        elif op[0] == "advance":
            clock.t += op[1]
        else:
            out.append(store.sweep_one())
    snap = store.metrics_snapshot()
    return out, snap, mod_metrics(mod).render_tracker_metrics(snap)


def mod_metrics(mod):
    return port_metrics if mod is port_shard else ref_metrics


class TestShardedStoreDifferential:
    @pytest.mark.parametrize("n_shards", [1, 8])
    @pytest.mark.parametrize("seed", SEEDS)
    def test_seeded_script_equal_through_the_seams(self, seed, n_shards):
        """Exact: the same script through stores built with a virtual
        clock and a seeded ``random.Random`` each gives equal replies,
        scrapes, sweep counts, snapshots and metrics text."""
        ops = _script(seed)
        got = [
            _drive(mod, ev, ops, mod.ShardedSwarmStore(
                n_shards=n_shards, peer_ttl=1200.0, clock=_Clock(),
                rng=random.Random(seed),
            ))
            for mod, ev in ((port_shard, AnnounceEvent), (ref_shard, RefEvent))
        ]
        assert got[0][0] == got[1][0]
        assert got[0][1] == got[1][1]
        assert got[0][2] == got[1][2]

    @pytest.mark.parametrize("seed", SEEDS)
    def test_module_random_pinned_default_store(self, seed, monkeypatch):
        """Exact: with each package's own module ``random`` pinned to the
        same seeded generator, default stores (no rng given) sample the
        same reservoir replies."""
        ops = [op for op in _script(seed, 200) if op[0] != "advance"]
        got = []
        for mod, ev in ((port_shard, AnnounceEvent), (ref_shard, RefEvent)):
            monkeypatch.setattr(mod, "random", random.Random(seed))
            got.append(_drive(mod, ev, ops, mod.ShardedSwarmStore(
                n_shards=4, clock=_Clock())))
        assert got[0] == got[1]

    def test_tracker_renderer_equal_on_partial_snapshots(self):
        """Exact: the renderer's defensive paths (missing keys, an
        indexer sub-dict, shard overflow) print the same text."""
        n = port_metrics.MAX_TRACKER_SHARDS + 3
        for snap in (
            None, {}, {"announces": 7, "shards": [{"peers": 3}]},
            {"indexer": {"hashes": 5, "harvested": {"announce_peer": 2}}},
            {"n_shards": n, "shards": [{"swarms": 1, "peers": i} for i in range(n)]},
        ):
            assert port_metrics.render_tracker_metrics(snap) == (
                ref_metrics.render_tracker_metrics(snap)
            )

    def test_http_announce_and_scrape_bytes_equal(self, monkeypatch):
        """Exact: the same raw HTTP announces and scrapes against both
        packages' ``run_sharded_tracker`` (module ``random`` pinned)
        return byte-equal bodies."""
        from torrent_tpu.server.tracker import ServeOptions as RefServeOptions
        from torrent_tpu_torch.server.tracker import ServeOptions

        h = hashlib.sha1(b"diff-http").digest()
        q = "".join(f"%{b:02X}" for b in h)

        async def session(mod, opts_cls):
            monkeypatch.setattr(mod, "random", random.Random(5))
            server, pump = await mod.run_sharded_tracker(
                opts_cls(http_port=0, udp_port=None, host="127.0.0.1", interval=60),
                n_shards=4,
            )
            bodies = []
            try:
                for i in range(12):
                    pid = "".join(f"%{b:02X}" for b in (b"P%02d" % i).ljust(20, b"x"))
                    path = (
                        f"/announce?info_hash={q}&peer_id={pid}&port={7000 + i}"
                        f"&uploaded=0&downloaded=0&left={i % 2}&compact=1&numwant=8"
                    )
                    bodies.append(await _raw_get(server.http_port, path))
                bodies.append(await _raw_get(server.http_port, f"/scrape?info_hash={q}"))
            finally:
                server.close()
                await asyncio.wait_for(pump, 5)
            return bodies

        async def go():
            return (
                await session(port_shard, ServeOptions),
                await session(ref_shard, RefServeOptions),
            )

        mine, ref = run(go())
        assert mine == ref
        assert all(b.startswith(b"HTTP/1.") for b in mine)


async def _raw_get(port: int, path: str, headers: str = "") -> bytes:
    """One HTTP/1.1 GET over a fresh connection → the whole response,
    its ``Date:`` header dropped (the wall clock is not under test)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n{headers}\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), 30)
    writer.close()
    head, sep, body = raw.partition(b"\r\n\r\n")
    kept = [ln for ln in head.split(b"\r\n") if not ln.lower().startswith(b"date:")]
    return b"\r\n".join(kept) + sep + body


# ---------------------------------------------------------------- scenarios


class TestScenarioDifferential:
    @pytest.mark.parametrize("name", sorted(SCENARIOS))
    def test_library_scenario_canonical_bytes_equal(self, name):
        """Exact: each library scenario, scaled as the port's scenario
        tests scale it, gives byte-equal canonical verdict + timeline
        bytes in both packages, from specs with equal compact forms."""
        spec = get(name).scaled(_SCALE[name], ticks=6)
        ref_spec = ref_get(name).scaled(_SCALE[name], ticks=6)
        assert spec.serialize() == ref_spec.serialize()
        assert spec.to_bencode() == ref_spec.to_bencode()
        mine = run_scenario(spec)
        ref = ref_run_scenario(ref_spec)
        assert canonical_bytes(mine["verdict"], mine["timeline"]) == (
            ref_canonical_bytes(ref["verdict"], ref["timeline"])
        )
        assert mine["verdict"]["pass"] == ref["verdict"]["pass"]


# --------------------------------------------------------------------- feeds

_FEEDS = [
    b"<rss><channel></channel></rss>",
    b"""<?xml version="1.0"?><rss version="2.0"><channel>
<item><title>a</title><enclosure url="http://e.org/a.torrent"/></item>
<item><title>b</title><link>https://e.org/b.torrent</link></item>
<item><title>c</title><enclosure url="file:///etc/passwd"/><link>javascript:x</link></item>
<item><link>magnet:?xt=urn:btih:aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa</link></item>
<item><title>  spaced  </title><guid>http://e.org/g</guid></item>
</channel></rss>""",
    b"""<?xml version="1.0"?><feed xmlns="http://www.w3.org/2005/Atom">
<entry><title>n</title><link rel="alternate" href="http://e.org/p"/>
<link rel="enclosure" href="http://e.org/n.torrent"/></entry>
<entry><title>m</title><link href="magnet:?xt=urn:btih:bbbbbbbbbbbbbbbbbbbbbbbbbbbbbbbbbbbbbbbb"/></entry>
<entry><title>x</title><link href="ftp://e.org/x.torrent"/></entry>
</feed>""",
    b'<?xml version="1.0"?><!DOCTYPE x [<!ENTITY a "b">]><rss><channel></channel></rss>',
    b"<rss><channel><item>",
    b"not xml at all",
    "<rss><channel><item><title>café</title>"
    "<enclosure url='http://e.org/é.torrent'/></item></channel></rss>".encode(),
]


class TestFeedDifferential:
    @pytest.mark.parametrize("doc", range(len(_FEEDS)))
    def test_parse_feed_equal(self, doc):
        """Exact: the same document gives equal items, or the same
        refusal with the same message."""
        def outcome(mod):
            try:
                return [dataclasses.astuple(i) for i in mod.parse_feed(_FEEDS[doc])]
            except mod.FeedError as e:
                return ("FeedError", str(e))

        assert outcome(port_feed) == outcome(ref_feed)

    def test_parse_feed_seeded_documents_equal(self):
        """Exact: seeded RSS documents mixing accepted and refused URL
        schemes parse to equal items."""
        rng = np.random.default_rng(9)
        schemes = ["http://", "https://", "magnet:?xt=urn:btih:", "file://", "data:", ""]
        for _ in range(40):
            items = []
            for j in range(int(rng.integers(0, 6))):
                s = schemes[int(rng.integers(0, len(schemes)))]
                tag = "enclosure url" if rng.integers(0, 2) else "link"
                url = f"{s}e.org/{j}"
                body = (f'<{tag}="{url}"/>' if tag == "enclosure url"
                        else f"<link>{url}</link>")
                items.append(f"<item><title>t{j}</title>{body}</item>")
            doc = f"<rss><channel>{''.join(items)}</channel></rss>".encode()
            assert [dataclasses.astuple(i) for i in port_feed.parse_feed(doc)] == [
                dataclasses.astuple(i) for i in ref_feed.parse_feed(doc)
            ]


# -------------------------------------------------------------------- stream


def _multi_file_torrent(announce: bytes = b"http://127.0.0.1:1/announce"):
    """A 3-file v1 torrent (files cross piece boundaries) and its bytes."""
    from torrent_tpu_torch.codec.bencode import bencode

    rng = np.random.default_rng(44)
    sizes = [70_000, 1, 190_123]
    files = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]
    blob = b"".join(files)
    plen = 32768
    pieces = b"".join(
        hashlib.sha1(blob[i : i + plen]).digest() for i in range(0, len(blob), plen)
    )
    raw = bencode({
        b"announce": announce,
        b"info": {
            b"name": b"streamed",
            b"piece length": plen,
            b"pieces": pieces,
            b"files": [
                {b"length": n, b"path": [b"f%d.bin" % i]} for i, n in enumerate(sizes)
            ],
        },
    })
    return raw, blob


_REQUESTS = [
    ("/", ""), ("/index.json", ""), ("/0", ""), ("/2", ""), ("/1", ""),
    ("/2", "Range: bytes=100-\r\n"), ("/2", "Range: bytes=-5000\r\n"),
    ("/0", "Range: bytes=32000-33000\r\n"), ("/0", "Range: bytes=99999999-\r\n"),
    ("/0", "Range: bytes=5-2\r\n"), ("/2", "Range: items=0-1\r\n"),
    ("/7", ""), ("/-1", ""), ("/x", ""),
]


class TestStreamDifferential:
    def test_range_responses_byte_equal(self):
        """Exact: a seeding torrent of each package served by its own
        ``StreamServer`` answers the same requests (index, whole files,
        open, suffix and bounded ranges, 416s, 404s) with byte-equal
        responses, the ``Date:`` header aside."""
        raw, blob = _multi_file_torrent()

        async def serve(pkg):
            if pkg == "port":
                m = parse_metainfo(raw)
                c = Client(ClientConfig(host="127.0.0.1", hasher="cpu"))
                st = Storage(MemoryStorage(), m.info)
                server_cls = port_stream.StreamServer
            else:
                m = ref_parse_metainfo(raw)
                c = RefClient(RefClientConfig(host="127.0.0.1", hasher="cpu"))
                st = RefStorage(RefMemoryStorage(), m.info)
                server_cls = ref_stream.StreamServer
            st.set(0, blob)
            c.config.torrent = dataclasses.replace(c.config.torrent, announce_retry=3600.0)
            await c.start()
            srv = None
            try:
                t = await c.add(m, st)
                assert t.bitfield.complete
                srv = await server_cls(t).start()
                return [await _raw_get(srv.port, path, hdr) for path, hdr in _REQUESTS]
            finally:
                if srv is not None:
                    srv.close()
                await c.close()

        async def go():
            return await serve("port"), await serve("ref")

        mine, ref = run(go())
        assert mine == ref
        assert blob[70_001 + 100 :] in mine[5]

    def test_parse_range_equal(self):
        """Exact: the Range parser agrees on seeded header values."""
        rng = np.random.default_rng(3)
        for _ in range(300):
            length = int(rng.integers(1, 5000))
            a, b = (str(int(x)) if rng.integers(0, 4) else ""
                    for x in rng.integers(-10, 6000, 2))
            unit = ["bytes=", "bytes=", "items=", ""][int(rng.integers(0, 4))]
            value = f"{unit}{a}-{b}" + (",7-9" if rng.integers(0, 3) == 0 else "")
            assert port_stream.StreamServer._parse_range(value, length) == (
                ref_stream.StreamServer._parse_range(value, length)
            )


# ------------------------------------------------------------- render_metrics


class TestRenderMetricsDifferential:
    def test_equal_client_states_render_equal_text(self):
        """Exact: two torrents (one seeding, one half-verified) with the
        same counters in a client of each package render the same
        ``render_metrics`` text."""
        raw, blob = _multi_file_torrent()
        single = build_torrent_bytes(blob[:100_000], 16384, b"http://127.0.0.1:1/announce",
                                     name=b'odd "name"\\x')

        async def state(pkg):
            parse = parse_metainfo if pkg == "port" else ref_parse_metainfo
            if pkg == "port":
                c = Client(ClientConfig(host="127.0.0.1", hasher="cpu"))
                mk_storage = lambda info: Storage(MemoryStorage(), info)  # noqa: E731
                render = port_metrics.render_metrics
            else:
                c = RefClient(RefClientConfig(host="127.0.0.1", hasher="cpu"))
                mk_storage = lambda info: RefStorage(RefMemoryStorage(), info)  # noqa: E731
                render = ref_metrics.render_metrics
            c.config.torrent = dataclasses.replace(c.config.torrent, announce_retry=3600.0)
            await c.start()
            try:
                texts = [render(c)]
                m1 = parse(raw)
                s1 = mk_storage(m1.info)
                s1.set(0, blob)
                t1 = await c.add(m1, s1)
                m2 = parse(single)
                s2 = mk_storage(m2.info)
                s2.set(0, blob[:50_000])
                t2 = await c.add(m2, s2)
                t1.uploaded, t2.downloaded = 12345, 678
                texts.append(render(c))
                return texts
            finally:
                await c.close()

        async def go():
            return await state("port"), await state("ref")

        mine, ref = run(go())
        assert mine == ref
        assert "torrent_tpu_torrent_pieces_have" in mine[1]


# ------------------------------------------------- persistent-tracker joins


async def _start_deployment(pkg):
    kw = dict(http_port=0, udp_port=None, host="127.0.0.1", interval=1, shards=4,
              dht_port=0, crawl_interval=3600.0)
    if pkg == "port":
        return await port_serve.start_service(**kw)
    return await ref_serve.start_service(**kw)


@pytest.mark.parametrize("tracker_pkg,leech_pkg", [("port", "ref"), ("ref", "port")])
def test_magnet_joins_through_the_other_packages_tracker(tracker_pkg, leech_pkg):
    """A DHT-only seed of the tracker's package announces to the
    deployment's DHT node; the deployment's indexer seeds its sharded
    store; a leech of the other package that knows only a magnet
    (info-hash + the tracker's URL) joins through it, fetches the
    metadata over BEP 9 and downloads every piece. The port's leech
    verifies with the ``"gpu"`` hasher on ``device="cpu"``."""
    rng = np.random.default_rng(62)
    payload = rng.integers(0, 256, size=150_000, dtype=np.uint8).tobytes()
    raw = build_torrent_bytes(payload, 32768, b"", name=b"cross-join")

    def client(pkg, **kw):
        if pkg == "port":
            c = Client(ClientConfig(host="127.0.0.1", **kw))
            c.config.torrent = TorrentConfig(
                choke_interval=0.15, announce_retry=1.0, dht_interval=0.3,
                verify_batch_size=4,
            )
        else:
            c = RefClient(RefClientConfig(host="127.0.0.1", **kw))
            c.config.torrent = RefTorrentConfig(
                choke_interval=0.15, announce_retry=1.0, dht_interval=0.3,
            )
        return c

    async def go():
        handle = await _start_deployment(tracker_pkg)
        url = f"http://127.0.0.1:{handle.http_port}/announce"
        seed = client(tracker_pkg, hasher="cpu", enable_dht=True,
                      dht_bootstrap=(("127.0.0.1", handle.dht.port),))
        leech_kw = {"hasher": "gpu", "device": "cpu"} if leech_pkg == "port" else {
            "hasher": "cpu"}
        leech = client(leech_pkg, **leech_kw)
        await seed.start()
        await leech.start()
        try:
            if tracker_pkg == "port":
                m = parse_metainfo(raw)
                ss = Storage(MemoryStorage(), m.info)
            else:
                m = ref_parse_metainfo(raw)
                ss = RefStorage(RefMemoryStorage(), m.info)
            ss.set(0, payload)
            t_seed = await seed.add(m, ss)
            assert t_seed.bitfield.complete
            for _ in range(80):
                if handle.store.metrics_snapshot()["indexed"] >= 1:
                    break
                await asyncio.sleep(0.25)
            else:
                raise AssertionError(f"indexer never fed: {handle.indexer.snapshot()}")
            if leech_pkg == "port":
                magnet = Magnet(info_hash=m.info_hash, trackers=(url,))
                storage = MemoryStorage()
            else:
                magnet = RefMagnet(info_hash=m.info_hash, trackers=(url,))
                storage = RefMemoryStorage()
            t = await leech.add_magnet(magnet, storage)
            assert t.info.name == "cross-join"
            await asyncio.wait_for(t.on_complete.wait(), 60)
            assert t.storage.get(0, len(payload)) == payload
            if leech_pkg == "port":
                assert t.verifier is not None  # the "gpu" ingest
            assert handle.store.metrics_snapshot()["announces"] >= 1
        finally:
            await seed.close()
            await leech.close()
            await handle.close()

    run(go(), timeout=120)
