"""MSE/PE protocol encryption (net/mse.py): RC4, handshake, swarm e2e.

The reference speaks only the plaintext handshake (protocol.ts:25-34);
MSE is beyond-parity. RC4 is checked against the classic published
vectors and differentially native-vs-Python; the handshake is driven
over real loopback sockets; the e2e swarms prove the policy matrix
(required↔required, enabled→required fallback, disabled rejects).
"""

import asyncio
import hashlib

import numpy as np
import pytest

from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.net import mse
from torrent_tpu_torch.server.in_memory import run_tracker
from torrent_tpu_torch.server.tracker import ServeOptions
from torrent_tpu_torch.session.client import Client, ClientConfig
from torrent_tpu_torch.session.torrent import TorrentConfig, TorrentState
from torrent_tpu_torch.storage.storage import MemoryStorage, Storage

from test_torch_session import build_torrent_bytes, fast_config, run


class TestRc4:
    def test_published_vectors(self):
        assert mse.RC4(b"Key").crypt(b"Plaintext").hex().upper() == "BBF316E8D940AF0AD3"
        assert mse.RC4(b"Wiki").crypt(b"pedia").hex().upper() == "1021BF0420"
        assert mse.RC4(b"Secret").crypt(b"Attack at dawn").hex().upper() == (
            "45A01F645FC35B383552544B9BF5"
        )

    def test_split_crypt_equals_whole(self):
        k = hashlib.sha1(b"key").digest()
        data = bytes(range(256)) * 7
        whole = mse.RC4(k).crypt(data)
        r = mse.RC4(k)
        split = r.crypt(data[:100]) + r.crypt(data[100:101]) + r.crypt(data[101:])
        assert whole == split

    def test_native_matches_python_fallback(self):
        rng = np.random.default_rng(7)
        data = rng.integers(0, 256, size=4096, dtype=np.uint8).tobytes()
        key = rng.integers(0, 256, size=20, dtype=np.uint8).tobytes()
        native = mse.RC4(key)
        if native._lib is None:
            pytest.skip("native engine unavailable; nothing to compare")
        lib, tried = mse._LIB, mse._LIB_TRIED
        mse._LIB = None
        try:
            pure = mse.RC4(key)
            assert pure._lib is None
            n_out = native.crypt(data)
            p_out = pure.crypt(data)
            assert n_out == p_out
            native.discard(1024)
            pure.discard(1024)
            assert native.crypt(data) == pure.crypt(data)
        finally:
            mse._LIB, mse._LIB_TRIED = lib, tried

    def test_crypt_is_involution(self):
        key = b"\x01" * 20
        data = b"the quick brown fox" * 10
        assert mse.RC4(key).crypt(mse.RC4(key).crypt(data)) == data

    def test_empty_key_rejected(self):
        with pytest.raises(ValueError):
            mse.RC4(b"")


def test_unknown_encryption_policy_rejected():
    with pytest.raises(ValueError, match="encryption"):
        TorrentConfig(hasher="cpu", encryption="require")  # typo'd value fails loudly


class _Echo:
    """Loopback responder that MSE-handshakes then echoes one message."""

    def __init__(self, skeys, **kw):
        self.skeys = skeys
        self.kw = kw
        self.selected = None
        self.skey = None

    async def __call__(self, r, w):
        try:
            head = await r.readexactly(20)
            rr, ww, self.skey, self.selected = await mse.respond(
                r, w, head, self.skeys, **self.kw
            )
            ww.write(await rr.readexactly(5))
            await ww.drain()
        except mse.MseError:
            w.close()


class TestHandshake:
    def loopback(self, handler):
        async def serve():
            server = await asyncio.start_server(handler, "127.0.0.1", 0)
            return server, server.sockets[0].getsockname()[1]

        return serve

    def test_rc4_selected_roundtrip(self):
        skey = hashlib.sha1(b"torrent").digest()

        async def go():
            echo = _Echo([b"z" * 20, skey])
            server, port = await self.loopback(echo)()
            try:
                r, w = await asyncio.open_connection("127.0.0.1", port)
                rr, ww, sel = await mse.initiate(r, w, skey)
                ww.write(b"hello")
                await ww.drain()
                assert await rr.readexactly(5) == b"hello"
                assert sel == mse.CRYPTO_RC4
                assert echo.selected == mse.CRYPTO_RC4
                assert echo.skey == skey  # resolved among candidates
                ww.close()
            finally:
                server.close()

        run(go())

    def test_plaintext_selected_when_rc4_not_offered(self):
        skey = hashlib.sha1(b"t2").digest()

        async def go():
            echo = _Echo([skey])
            server, port = await self.loopback(echo)()
            try:
                r, w = await asyncio.open_connection("127.0.0.1", port)
                rr, ww, sel = await mse.initiate(r, w, skey, allow_rc4=False)
                ww.write(b"hello")
                await ww.drain()
                assert await rr.readexactly(5) == b"hello"
                assert sel == mse.CRYPTO_PLAIN == echo.selected
                ww.close()
            finally:
                server.close()

        run(go())

    def test_unknown_skey_rejected(self):
        async def go():
            echo = _Echo([hashlib.sha1(b"other").digest()])
            server, port = await self.loopback(echo)()
            try:
                r, w = await asyncio.open_connection("127.0.0.1", port)
                with pytest.raises((mse.MseError, asyncio.IncompleteReadError, ConnectionError)):
                    await mse.initiate(r, w, hashlib.sha1(b"mine").digest())
                    await r.readexactly(1)  # responder closed without reply
                w.close()
            finally:
                server.close()

        run(go())

    def test_degenerate_public_key_rejected(self):
        async def go():
            async def evil(r, w):
                await r.readexactly(96)
                w.write((1).to_bytes(96, "big"))  # Y=1 → S=1 for any secret
                await w.drain()

            server = await asyncio.start_server(evil, "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            try:
                r, w = await asyncio.open_connection("127.0.0.1", port)
                with pytest.raises(mse.MseError, match="degenerate"):
                    await mse.initiate(r, w, b"k" * 20)
                w.close()
            finally:
                server.close()

        run(go())

    def test_responder_tolerates_trickled_pads(self):
        """PadA arriving byte-by-byte and coalesced IA both sync correctly."""
        skey = hashlib.sha1(b"trickle").digest()

        async def go():
            echo = _Echo([skey])
            server, port = await self.loopback(echo)()
            try:
                r, w = await asyncio.open_connection("127.0.0.1", port)
                # drive the initiator manually with a large PadA, trickled
                priv, pub = mse._keypair()
                w.write(pub)
                await w.drain()
                pad = b"\xaa" * 200
                for i in range(0, len(pad), 7):
                    w.write(pad[i : i + 7])
                    await w.drain()
                s = mse._shared(await r.readexactly(96), priv)
                enc, dec = mse._streams(s, skey)
                provide = mse.CRYPTO_RC4
                w.write(
                    mse._sha1(b"req1", s)
                    + mse._xor(mse._sha1(b"req2", skey), mse._sha1(b"req3", s))
                    + enc.crypt(
                        mse.VC
                        + provide.to_bytes(4, "big")
                        + (0).to_bytes(2, "big")
                        + (5).to_bytes(2, "big")
                    )
                    + enc.crypt(b"hello")  # IA carries the payload
                )
                await w.drain()
                sync = dec.crypt(mse.VC)
                window = await r.readexactly(8)
                hops = 0
                while window != sync:
                    window = window[1:] + await r.readexactly(1)
                    hops += 1
                    assert hops < 600
                assert int.from_bytes(dec.crypt(await r.readexactly(4)), "big") == mse.CRYPTO_RC4
                pad_d = int.from_bytes(dec.crypt(await r.readexactly(2)), "big")
                if pad_d:
                    dec.crypt(await r.readexactly(pad_d))
                assert dec.crypt(await r.readexactly(5)) == b"hello"
                w.close()
            finally:
                server.close()

        run(go())


class TestWrappers:
    def test_reader_prefix_then_stream(self):
        async def go():
            r = asyncio.StreamReader()
            r.feed_data(b"worldtail")
            r.feed_eof()
            wr = mse.WrappedReader(r, None, prefix=b"hello ")
            assert await wr.readexactly(8) == b"hello wo"
            assert await wr.readexactly(7) == b"rldtail"

        run(go())

    def test_read_to_eof_returns_prefix_plus_stream(self):
        async def go():
            r = asyncio.StreamReader()
            r.feed_data(b"stream-rest")
            r.feed_eof()
            wr = mse.WrappedReader(r, None, prefix=b"prefix:")
            assert await wr.read(-1) == b"prefix:stream-rest"

        run(go())

    def test_reader_rc4_decrypts_after_prefix(self):
        async def go():
            key = b"\x42" * 20
            enc = mse.RC4(key)
            r = asyncio.StreamReader()
            r.feed_data(enc.crypt(b"ciphertext"))
            r.feed_eof()
            wr = mse.WrappedReader(r, mse.RC4(key), prefix=b"plain:")
            assert await wr.readexactly(6) == b"plain:"
            assert await wr.readexactly(10) == b"ciphertext"

        run(go())


class TestMseOverUtp:
    def test_required_encryption_over_utp_transport(self):
        """MSE composes with the uTP transport: both sides RC4-only AND
        uTP-enabled; the winning connection carries RC4 over the
        reliable-UDP stream."""

        async def go():
            from torrent_tpu_torch.net.utp import _UtpWriter

            rng = np.random.default_rng(29)
            payload = rng.integers(0, 256, size=120_000, dtype=np.uint8).tobytes()
            server, pump, announce_url = await _start_tracker()
            m = _make_swarm_meta(payload, announce_url)
            seed = Client(ClientConfig(host="127.0.0.1", enable_utp=True, hasher="cpu"))
            leech = Client(ClientConfig(host="127.0.0.1", enable_utp=True, hasher="cpu"))
            seed.config.torrent = fast_config(encryption="required")
            leech.config.torrent = fast_config(encryption="required")
            await seed.start()
            await leech.start()
            try:
                ss = Storage(MemoryStorage(), m.info)
                for off in range(0, len(payload), 65536):
                    ss.set(off, payload[off : off + 65536])
                t_seed = await seed.add(m, ss)
                t_leech = await leech.add(m, Storage(MemoryStorage(), m.info))
                await asyncio.wait_for(t_leech.on_complete.wait(), timeout=30)
                assert t_leech.storage.get(0, len(payload)) == payload
                # at least one side's connection is RC4-wrapped over uTP
                writers = [
                    p.writer
                    for t in (t_seed, t_leech)
                    for p in t.peers.values()
                ]
                assert any(
                    isinstance(w, mse.WrappedWriter)
                    and isinstance(w._w, _UtpWriter)
                    for w in writers
                ), [type(w).__name__ for w in writers]
            finally:
                await seed.close()
                await leech.close()
                server.close()
                await asyncio.wait_for(pump, 5)

        run(go(), timeout=60)


def _make_swarm_meta(payload, announce_url):
    data = build_torrent_bytes(payload, 32768, announce_url.encode())
    m = parse_metainfo(data)
    assert m is not None
    return m


async def _start_tracker():
    opts = ServeOptions(http_port=0, udp_port=None, host="127.0.0.1", interval=2)
    server, task = await run_tracker(opts)
    return server, task, f"http://127.0.0.1:{server.http_port}/announce"


async def _transfer(seed_policy: str, leech_policy: str, timeout=30):
    """Author → seed → leech with the given encryption policies; returns
    the completed leech payload (asserts bit-identical)."""
    rng = np.random.default_rng(11)
    payload = rng.integers(0, 256, size=150_000, dtype=np.uint8).tobytes()
    server, pump, announce_url = await _start_tracker()
    m = _make_swarm_meta(payload, announce_url)
    seed = Client(ClientConfig(hasher="cpu", host="127.0.0.1"))
    leech = Client(ClientConfig(hasher="cpu", host="127.0.0.1"))
    seed.config.torrent = fast_config(encryption=seed_policy)
    leech.config.torrent = fast_config(encryption=leech_policy)
    await seed.start()
    await leech.start()
    try:
        seed_storage = Storage(MemoryStorage(), m.info)
        for off in range(0, len(payload), 65536):
            seed_storage.set(off, payload[off : off + 65536])
        t_seed = await seed.add(m, seed_storage)
        assert t_seed.state == TorrentState.SEEDING
        t_leech = await leech.add(m, Storage(MemoryStorage(), m.info))
        await asyncio.wait_for(t_leech.on_complete.wait(), timeout=timeout)
        got = t_leech.storage.get(0, len(payload))
        assert got == payload
        return True
    finally:
        await seed.close()
        await leech.close()
        server.close()
        await asyncio.wait_for(pump, 5)


class TestInboundGarbage:
    def test_garbage_floods_never_crash_the_accept_path(self):
        """Random bytes to the listener (neither BT nor valid MSE) must
        be dropped without harming later legitimate connections."""

        async def go():
            rng = np.random.default_rng(31)
            payload = rng.integers(0, 256, size=65536, dtype=np.uint8).tobytes()
            server, pump, announce_url = await _start_tracker()
            m = _make_swarm_meta(payload, announce_url)
            client = Client(ClientConfig(hasher="cpu", host="127.0.0.1"))
            client.config.torrent = fast_config()
            await client.start()
            try:
                st = Storage(MemoryStorage(), m.info)
                st.set(0, payload)
                await client.add(m, st)
                for size in (1, 19, 20, 96, 300, 2000):
                    r, w = await asyncio.open_connection("127.0.0.1", client.port)
                    w.write(rng.integers(0, 256, size=size, dtype=np.uint8).tobytes())
                    try:
                        await w.drain()
                        w.close()
                    except (ConnectionError, OSError):
                        pass
                await asyncio.sleep(0.2)
                # the listener is still healthy: a real MSE join succeeds
                r, w = await asyncio.open_connection("127.0.0.1", client.port)
                rr, ww, sel = await asyncio.wait_for(
                    mse.initiate(r, w, m.info_hash), timeout=10
                )
                assert sel == mse.CRYPTO_RC4
                ww.close()
            finally:
                await client.close()
                server.close()
                await asyncio.wait_for(pump, 5)

        run(go(), timeout=60)


class TestSwarmEncryption:
    def test_required_to_required(self):
        """Both sides RC4-only: every connection is fully encrypted."""
        assert run(_transfer("required", "required"), timeout=60)

    def test_enabled_leech_reaches_required_seed(self):
        """Default-policy dialer retries encrypted after the plaintext
        handshake is dropped on sight by an encryption-requiring seed."""
        assert run(_transfer("required", "enabled"), timeout=60)

    def test_enabled_to_enabled_stays_plaintext_compatible(self):
        assert run(_transfer("enabled", "enabled"), timeout=60)

    def test_disabled_client_rejects_mse_inbound(self):
        """A plaintext-only client drops an MSE initiator pre-reply."""

        async def go():
            rng = np.random.default_rng(3)
            payload = rng.integers(0, 256, size=65536, dtype=np.uint8).tobytes()
            server, pump, announce_url = await _start_tracker()
            m = _make_swarm_meta(payload, announce_url)
            client = Client(ClientConfig(hasher="cpu", host="127.0.0.1"))
            client.config.torrent = fast_config(encryption="disabled")
            await client.start()
            try:
                storage = Storage(MemoryStorage(), m.info)
                for off in range(0, len(payload), 65536):
                    storage.set(off, payload[off : off + 65536])
                await client.add(m, storage)
                r, w = await asyncio.open_connection("127.0.0.1", client.port)
                with pytest.raises(
                    (mse.MseError, asyncio.IncompleteReadError, ConnectionError)
                ):
                    await mse.initiate(r, w, m.info_hash)
                    await r.readexactly(1)
                w.close()
            finally:
                await client.close()
                server.close()
                await asyncio.wait_for(pump, 5)

        run(go())
