"""BEP 19 webseed tests: URL mapping, ranged fetches against a live HTTP
server, and a webseed-only download (no tracker, no peers)."""

import asyncio
import hashlib
import threading
from functools import partial
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from test_torch_session import build_torrent_bytes, fast_config, run
from torrent_tpu_torch.codec.bencode import bencode
from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.session.client import Client, ClientConfig
from torrent_tpu_torch.session.webseed import WebSeedError, fetch_range, url_for
from torrent_tpu_torch.storage.storage import MemoryStorage, Storage


class _RangeHandler(SimpleHTTPRequestHandler):
    """SimpleHTTPRequestHandler + RFC 7233 single-range support."""

    def log_message(self, *a):  # quiet
        pass

    def send_head(self):
        rng = self.headers.get("Range")
        if not rng or not rng.startswith("bytes="):
            return super().send_head()
        path = self.translate_path(self.path)
        try:
            f = open(path, "rb")
        except OSError:
            self.send_error(404)
            return None
        import os

        size = os.fstat(f.fileno()).st_size
        start_s, _, end_s = rng[len("bytes=") :].partition("-")
        start = int(start_s)
        end = min(int(end_s) if end_s else size - 1, size - 1)
        if start >= size:
            self.send_error(416)
            f.close()
            return None
        self.send_response(206)
        self.send_header("Content-Range", f"bytes {start}-{end}/{size}")
        self.send_header("Content-Length", str(end - start + 1))
        self.end_headers()
        f.seek(start)
        self._range_len = end - start + 1
        return f

    def copyfile(self, source, outputfile):
        n = getattr(self, "_range_len", None)
        if n is None:
            return super().copyfile(source, outputfile)
        outputfile.write(source.read(n))


def serve_dir(root):
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", 0), partial(_RangeHandler, directory=str(root))
    )
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}/"


class TestUrlMapping:
    def test_single_file_with_base_slash(self):
        from torrent_tpu_torch.codec.metainfo import InfoDict

        info = InfoDict(name="a b.bin", piece_length=4, pieces=(b"x" * 20,), length=4)
        assert url_for("http://s/d/", info, ("a b.bin",)) == "http://s/d/a%20b.bin"
        # non-slash base for single-file: URL used as-is
        assert url_for("http://s/direct.bin", info, ("a b.bin",)) == "http://s/direct.bin"

    def test_multi_file_paths(self):
        from torrent_tpu_torch.codec.metainfo import FileEntry, InfoDict

        info = InfoDict(
            name="album",
            piece_length=4,
            pieces=(b"x" * 20,),
            length=4,
            files=(FileEntry(length=4, path=("cd 1", "t.mp3")),),
        )
        assert (
            url_for("http://s/d/", info, ("album", "cd 1", "t.mp3"))
            == "http://s/d/album/cd%201/t.mp3"
        )
        assert (
            url_for("http://s/d", info, ("album", "cd 1", "t.mp3"))
            == "http://s/d/album/cd%201/t.mp3"
        )


class TestRangedFetch:
    def test_fetch_range_against_live_server(self, tmp_path):
        blob = bytes(range(256)) * 40
        (tmp_path / "f.bin").write_bytes(blob)
        httpd, base = serve_dir(tmp_path)
        try:
            got = fetch_range(base + "f.bin", 100, 500)
            assert got == blob[100:600]
            with pytest.raises(WebSeedError):
                fetch_range(base + "missing.bin", 0, 10)
        finally:
            httpd.shutdown()


class TestWebseedDownload:
    def test_webseed_only_download(self, tmp_path):
        """No tracker, no peers: the whole payload arrives over HTTP and
        verifies piece by piece."""

        async def go():
            rng = np.random.default_rng(91)
            payload = rng.integers(0, 256, size=150_000, dtype=np.uint8).tobytes()
            (tmp_path / "ws-test").write_bytes(payload)
            httpd, base = serve_dir(tmp_path)
            client = Client(ClientConfig(hasher="cpu", host="127.0.0.1"))
            client.config.torrent = fast_config(webseed_retry=0.5)
            await client.start()
            try:
                tb = bencode(
                    {
                        b"announce": b"",
                        b"url-list": [base.encode()],
                        b"info": {
                            b"name": b"ws-test",
                            b"piece length": 32768,
                            b"pieces": b"".join(
                                hashlib.sha1(payload[i : i + 32768]).digest()
                                for i in range(0, len(payload), 32768)
                            ),
                            b"length": len(payload),
                        },
                    }
                )
                m = parse_metainfo(tb)
                assert m is not None and m.web_seeds == (base,)
                t = await client.add(m, Storage(MemoryStorage(), m.info))
                await asyncio.wait_for(t.on_complete.wait(), timeout=30)
                assert t.storage.get(0, len(payload)) == payload
            finally:
                await client.close()
                httpd.shutdown()

        run(go())

    def test_resumed_partial_does_not_wedge_webseed_only_session(self, tmp_path):
        """A stale partial (resumed from checkpoint, no peers to finish
        it) must be fair game for the webseed picker — without that a
        webseed-only session sits one piece short forever."""
        from torrent_tpu_torch.session.torrent import _PartialPiece

        async def go():
            rng = np.random.default_rng(93)
            payload = rng.integers(0, 256, size=98_304, dtype=np.uint8).tobytes()
            (tmp_path / "ws-stale").write_bytes(payload)
            httpd, base = serve_dir(tmp_path)
            client = Client(ClientConfig(hasher="cpu", host="127.0.0.1"))
            client.config.torrent = fast_config(webseed_retry=0.3)
            await client.start()
            try:
                tb = bencode(
                    {
                        b"announce": b"",
                        b"url-list": [base.encode()],
                        b"info": {
                            b"name": b"ws-stale",
                            b"piece length": 32768,
                            b"pieces": b"".join(
                                hashlib.sha1(payload[i : i + 32768]).digest()
                                for i in range(0, len(payload), 32768)
                            ),
                            b"length": len(payload),
                        },
                    }
                )
                m = parse_metainfo(tb)
                t = await client.add(m, Storage(MemoryStorage(), m.info))
                # inject a stale resumed partial for piece 1: one block
                # received, nothing in flight, no peers exist
                stale = _PartialPiece(index=1, length=32768, buffer=bytearray(32768))
                stale.buffer[0:16384] = payload[32768 : 32768 + 16384]
                stale.received.add(0)
                t._partials[1] = stale
                await asyncio.wait_for(t.on_complete.wait(), timeout=30)
                assert t.storage.get(0, len(payload)) == payload
            finally:
                await client.close()
                httpd.shutdown()

        run(go())

    def test_corrupt_webseed_rejected(self, tmp_path):
        """A webseed serving wrong bytes never pollutes storage."""

        async def go():
            rng = np.random.default_rng(92)
            payload = rng.integers(0, 256, size=64_000, dtype=np.uint8).tobytes()
            # serve DIFFERENT bytes than the torrent was authored for
            (tmp_path / "ws-bad").write_bytes(b"\x00" * len(payload))
            httpd, base = serve_dir(tmp_path)
            client = Client(ClientConfig(hasher="cpu", host="127.0.0.1"))
            client.config.torrent = fast_config(webseed_retry=0.2)
            await client.start()
            try:
                tb = bencode(
                    {
                        b"announce": b"",
                        b"url-list": [base.encode()],
                        b"info": {
                            b"name": b"ws-bad",
                            b"piece length": 32768,
                            b"pieces": b"".join(
                                hashlib.sha1(payload[i : i + 32768]).digest()
                                for i in range(0, len(payload), 32768)
                            ),
                            b"length": len(payload),
                        },
                    }
                )
                m = parse_metainfo(tb)
                t = await client.add(m, Storage(MemoryStorage(), m.info))
                await asyncio.sleep(1.5)  # several fetch attempts
                assert t.bitfield.count() == 0  # nothing verified
                assert not t.on_complete.is_set()
                # corrupt bytes were never counted as download progress
                assert t.downloaded == 0
                # the strike budget is exhausted → the URL is disabled and
                # its loop has exited (no hot refetch forever)
                names = {task.get_name() for task in t._tasks}
                assert not any(n.startswith("webseed") for n in names), names
            finally:
                await client.close()
                httpd.shutdown()

        run(go())


class _Bep17Handler(SimpleHTTPRequestHandler):
    """Hoffman-style httpseed: GET ?info_hash=...&piece=N → piece bytes."""

    payload = b""
    piece_len = 32768
    expected_hash = b""
    corrupt_piece = None  # optionally serve garbage for one index

    def log_message(self, *a):
        pass

    def do_GET(self):
        from urllib.parse import parse_qs, unquote_to_bytes, urlsplit

        q = urlsplit(self.path).query
        params = parse_qs(q)
        ih = unquote_to_bytes(
            urlsplit(self.path).query.split("info_hash=")[1].split("&")[0]
        )
        if ih != self.expected_hash:
            self.send_error(404, "unknown info_hash")
            return
        index = int(params["piece"][0])
        lo = index * self.piece_len
        data = self.payload[lo : lo + self.piece_len]
        if index == self.corrupt_piece:
            data = bytes(len(data))  # zeros: wrong bytes, right size
        if not data:
            self.send_error(404, "no such piece")
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def _bep17_torrent_bytes(payload, base_url, name=b"hs-test", piece_len=32768):
    return bencode(
        {
            b"announce": b"",
            b"httpseeds": [base_url.encode()],
            b"info": {
                b"name": name,
                b"piece length": piece_len,
                b"pieces": b"".join(
                    hashlib.sha1(payload[i : i + piece_len]).digest()
                    for i in range(0, len(payload), piece_len)
                ),
                b"length": len(payload),
            },
        }
    )


class TestBep17HttpSeeds:
    def _serve(self, payload, info_hash, corrupt_piece=None):
        handler = type(
            "_H",
            (_Bep17Handler,),
            {
                "payload": payload,
                "expected_hash": info_hash,
                "corrupt_piece": corrupt_piece,
            },
        )
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        import threading

        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd, f"http://127.0.0.1:{httpd.server_address[1]}/seed.php"

    def test_httpseed_only_download(self, tmp_path):
        """BEP 17: no tracker, no peers — whole payload over piece-keyed
        GETs, verified piece by piece."""

        async def go():
            rng = np.random.default_rng(171)
            payload = rng.integers(0, 256, size=150_000, dtype=np.uint8).tobytes()
            tb = _bep17_torrent_bytes(payload, "http://127.0.0.1:1/x")
            m = parse_metainfo(tb)
            httpd, url = self._serve(payload, m.info_hash)
            tb = _bep17_torrent_bytes(payload, url)
            m = parse_metainfo(tb)
            assert m.http_seeds == (url,)
            client = Client(ClientConfig(hasher="cpu", host="127.0.0.1"))
            client.config.torrent = fast_config(webseed_retry=0.5)
            await client.start()
            try:
                t = await client.add(m, Storage(MemoryStorage(), m.info))
                assert t.http_seed_urls == [url]
                await asyncio.wait_for(t.on_complete.wait(), timeout=30)
                assert t.storage.get(0, len(payload)) == payload
            finally:
                await client.close()
                httpd.shutdown()

        run(go())

    def test_corrupt_httpseed_never_pollutes_storage(self, tmp_path):
        """A BEP 17 seed serving a bad piece is retried/disabled like a
        BEP 19 one; storage only ever holds verified bytes."""

        async def go():
            rng = np.random.default_rng(172)
            payload = rng.integers(0, 256, size=98_304, dtype=np.uint8).tobytes()
            tb = _bep17_torrent_bytes(payload, "http://127.0.0.1:1/x")
            m = parse_metainfo(tb)
            # piece 1 always corrupt from this seed
            httpd, url = self._serve(payload, m.info_hash, corrupt_piece=1)
            m = parse_metainfo(_bep17_torrent_bytes(payload, url))
            client = Client(ClientConfig(hasher="cpu", host="127.0.0.1"))
            client.config.torrent = fast_config(
                webseed_retry=0.1, webseed_max_failures=2
            )
            await client.start()
            try:
                t = await client.add(m, Storage(MemoryStorage(), m.info))
                await asyncio.sleep(2.0)  # give the loop time to fail out
                assert t.bitfield.has(0) and t.bitfield.has(2)
                assert not t.bitfield.has(1)  # never accepted corrupt bytes
            finally:
                await client.close()
                httpd.shutdown()

        run(go())


class TestV2Webseed:
    def test_v2_webseed_only_download(self, tmp_path):
        """BEP 19 against a pure-v2 torrent: the aligned piece space maps
        every piece to one ranged GET in one file — a leech completes
        from the web server alone (no tracker, no peers)."""
        import os

        from torrent_tpu_torch.models.v2 import build_v2

        async def go():
            plen = 32768
            rng = np.random.default_rng(55)
            fa = rng.integers(0, 256, 3 * plen + 777, dtype=np.uint8).tobytes()
            fb = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
            # the web server exports the content directory
            os.makedirs(tmp_path / "www" / "w2" / "sub")
            (tmp_path / "www" / "w2" / "big.bin").write_bytes(fa)
            (tmp_path / "www" / "w2" / "sub" / "small.bin").write_bytes(fb)
            httpd, base = serve_dir(tmp_path / "www")
            meta = build_v2(
                [(("big.bin",), fa), (("sub", "small.bin"), fb)],
                name="w2",
                piece_length=plen,
                hasher="cpu",
                announce="http://127.0.0.1:1/announce",  # dead tracker
                web_seeds=[base],
            )
            c = Client(ClientConfig(hasher="cpu", port=0, enable_upnp=False))
            await c.start()
            try:
                d = str(tmp_path / "dl")
                os.makedirs(d)
                t = await c.add(meta, d)
                assert t.metainfo.web_seeds == (base,)
                for _ in range(600):
                    if t.bitfield.complete:
                        break
                    await asyncio.sleep(0.05)
                assert t.bitfield.complete, t.status()
                assert open(os.path.join(d, "w2", "big.bin"), "rb").read() == fa
                assert (
                    open(os.path.join(d, "w2", "sub", "small.bin"), "rb").read()
                    == fb
                )
            finally:
                await c.close()
                httpd.shutdown()

        run(go(), timeout=60)


class TestMagnetWebseeds:
    def test_ws_param_roundtrip(self):
        from torrent_tpu_torch.codec.magnet import Magnet, parse_magnet

        m = Magnet(
            info_hash=b"\x22" * 20,
            web_seeds=("http://cdn.example/d/", "http://m.example/x?y=1"),
        )
        uri = m.to_uri()
        assert "ws=http%3A%2F%2Fcdn.example%2Fd%2F" in uri
        assert parse_magnet(uri).web_seeds == m.web_seeds

    def test_magnet_ws_downloads_from_webseed_only(self, tmp_path):
        """A ws= magnet completes with the DATA coming from the web
        server: the only peer serves metadata but is paused, so every
        block must arrive via the injected webseed."""
        import os

        from torrent_tpu_torch.codec.magnet import Magnet

        async def go():
            plen = 32768
            payload = np.random.default_rng(61).integers(
                0, 256, 4 * plen + 99, dtype=np.uint8
            ).tobytes()
            os.makedirs(tmp_path / "www")
            (tmp_path / "www" / "mws.bin").write_bytes(payload)
            httpd, base = serve_dir(tmp_path / "www")
            data = build_torrent_bytes(
                payload, plen, b"http://127.0.0.1:1/announce", name=b"mws.bin"
            )
            m = parse_metainfo(data)
            seed = Client(ClientConfig(port=0, enable_upnp=False, hasher="cpu"))
            leech = Client(ClientConfig(port=0, enable_upnp=False, hasher="cpu"))
            await seed.start()
            await leech.start()
            try:
                sd = str(tmp_path / "s")
                os.makedirs(sd)
                (tmp_path / "s" / "mws.bin").write_bytes(payload)
                t_seed = await seed.add(m, sd)
                await t_seed.pause()  # metadata yes, data no
                magnet = Magnet(
                    info_hash=m.info_hash,
                    peer_addrs=(("127.0.0.1", seed.port),),
                    web_seeds=(base,),
                )
                d = str(tmp_path / "l")
                os.makedirs(d)
                t = await asyncio.wait_for(leech.add_magnet(magnet.to_uri(), d), 60)
                assert base in t.web_seed_urls
                for _ in range(600):
                    if t.bitfield.complete:
                        break
                    await asyncio.sleep(0.05)
                assert t.bitfield.complete, t.status()
                assert open(os.path.join(d, "mws.bin"), "rb").read() == payload
                assert t_seed.uploaded == 0  # every byte came off the webseed
            finally:
                await seed.close()
                await leech.close()
                httpd.shutdown()

        run(go(), timeout=90)

    def test_unsafe_webseed_schemes_refused(self, tmp_path):
        """file:// and ftp:// webseeds (SSRF / local-read vectors) are
        dropped at every entry point: url-list, add_web_seed, ws=."""
        import os

        from torrent_tpu_torch.session.webseed import allowed_url

        assert allowed_url("http://x/d/") and allowed_url("https://x/d")
        for bad in ("file:///etc/shadow", "ftp://h/x", "gopher://h", ""):
            assert not allowed_url(bad)

        async def go():
            data = build_torrent_bytes(
                b"z" * 1000, 512, b"http://127.0.0.1:1/announce", name=b"w.bin"
            )
            # splice hostile url-list into the torrent
            from torrent_tpu_torch.codec.bencode import bdecode, bencode

            raw = bdecode(data)
            raw[b"url-list"] = [b"file:///etc/shadow", b"http://ok.example/d/"]
            m = parse_metainfo(bencode(raw))
            c = Client(ClientConfig(port=0, enable_upnp=False, hasher="cpu"))
            await c.start()
            try:
                d = str(tmp_path / "ws-unsafe")
                os.makedirs(d)
                t = await c.add(m, d)
                assert t.web_seed_urls == ["http://ok.example/d/"]
                assert not t.add_web_seed("file:///etc/passwd")
                assert not t.add_web_seed("ftp://internal/secret")
                assert t.add_web_seed("http://two.example/d/")
            finally:
                await c.close()

        run(go())
