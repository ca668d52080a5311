"""The port's session where it differs from the reference on purpose.

Each case holds one divergence listed in ``tests/test_torch_mirror.py``:
the ``"gpu"`` hasher is the default and never turns into hashlib (no
verifier → the torrent builds its own ``GPUVerifier``; a device error
reaches the piece's waiter as the error), ``Client.start()`` refuses a
missing card before it listens, the subsystems it once refused are
accepted as the reference accepts them, the native RC4 gives the pure-Python keystream,
and the config converters of ``compat.py`` carry a reference config
across. Everything runs on the CPU: ``device="cpu"`` is the plain
PyTorch SHA-1.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib

import numpy as np
import pytest

from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.session import torrent as torrent_mod
from torrent_tpu_torch.session.client import Client, ClientConfig, generate_peer_id
from torrent_tpu_torch.session.torrent import Torrent, TorrentConfig, _PartialPiece
from torrent_tpu_torch.storage.storage import MemoryStorage, Storage

from tests.test_torch_session import build_torrent_bytes, run

PLEN = 16384


def _torrent(config: TorrentConfig, n_pieces: int = 4, seed: int = 3):
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, size=n_pieces * PLEN, dtype=np.uint8).tobytes()
    m = parse_metainfo(build_torrent_bytes(payload, PLEN, b"http://127.0.0.1:1/announce"))
    t = Torrent(
        metainfo=m,
        storage=Storage(MemoryStorage(), m.info),
        peer_id=generate_peer_id(),
        port=1,
        config=config,
    )
    return t, [payload[i * PLEN : (i + 1) * PLEN] for i in range(n_pieces)]


@pytest.fixture
def sha1_calls(monkeypatch):
    """Sizes of every input the session module hands ``hashlib.sha1``."""
    sizes: list[int] = []
    real = hashlib.sha1

    class _Counting:
        @staticmethod
        def sha1(data=b"", *args, **kwargs):
            sizes.append(len(data))
            return real(data, *args, **kwargs)

        def __getattr__(self, name):
            return getattr(hashlib, name)

    monkeypatch.setattr(torrent_mod, "hashlib", _Counting())
    return sizes


class TestGpuHasherDefaults:
    def test_configs_default_to_the_gpu_hasher_on_cuda(self):
        assert TorrentConfig().hasher == "gpu" and TorrentConfig().device is None
        cfg = ClientConfig()
        assert cfg.hasher == "gpu" and cfg.device is None

    def test_add_derives_hasher_and_device_without_mutating(self, tmp_path):
        async def go():
            shared = TorrentConfig(hasher="cpu")
            c = Client(
                ClientConfig(host="127.0.0.1", hasher="gpu", device="cpu", torrent=shared)
            )
            await c.start()
            try:
                t, pieces = _torrent(TorrentConfig(hasher="cpu"))
                torrent = await c.add(t.metainfo, Storage(MemoryStorage(), t.info))
                assert torrent.config.hasher == "gpu"
                assert torrent.config.device == "cpu"
                assert torrent.verifier is not None
                assert torrent.verifier.device.type == "cpu"
                assert shared.hasher == "cpu" and shared.device is None
            finally:
                await c.close()

        run(go())

    def test_torrent_without_verifier_builds_its_own(self, sha1_calls):
        async def go():
            t, pieces = _torrent(TorrentConfig(device="cpu", verify_batch_size=4))
            assert t.verifier is None
            bad = bytearray(pieces[1])
            bad[7] ^= 0x01
            ok = await asyncio.gather(
                t._verify_piece_data(0, pieces[0], t.info.pieces[0]),
                t._verify_piece_data(1, bytes(bad), t.info.pieces[1]),
                t._verify_piece_data(2, pieces[2], t.info.pieces[2]),
            )
            assert ok == [True, False, True]
            from torrent_tpu_torch.models.verifier import GPUVerifier

            assert isinstance(t.verifier, GPUVerifier)
            assert t.verifier.device.type == "cpu"
            assert t.verifier.piece_length == PLEN and t.verifier.batch_size == 4
            assert t._verify_pending == [] and not t._verify_flushing

        run(go())
        assert not [n for n in sha1_calls if n >= PLEN], sha1_calls

    def test_cpu_hasher_stays_hashlib(self, sha1_calls):
        async def go():
            t, pieces = _torrent(TorrentConfig(hasher="cpu"))
            assert await t._verify_piece_data(0, pieces[0], t.info.pieces[0])
            assert t.verifier is None

        run(go())
        assert sha1_calls == [PLEN]


class _FailingVerifier:
    def __init__(self):
        self.calls = 0

    def hash_pieces(self, pieces):
        self.calls += 1
        raise RuntimeError("launch failed: device lost")


class TestDeviceErrorNeverBecomesHashlib:
    def test_flush_error_reaches_every_waiter(self, sha1_calls, caplog):
        async def go():
            t, pieces = _torrent(TorrentConfig(device="cpu", verify_batch_size=8))
            t.verifier = _FailingVerifier()
            out = await asyncio.gather(
                *(
                    t._verify_piece_data(i, pieces[i], t.info.pieces[i])
                    for i in range(3)
                ),
                return_exceptions=True,
            )
            assert all(isinstance(e, RuntimeError) for e in out), out
            assert t.verifier.calls == 1  # one batch, failed once
            assert t._verify_pending == [] and not t._verify_flushing

        with caplog.at_level("ERROR", logger="torrent_tpu_torch.session.torrent"):
            run(go())
        assert sha1_calls == []
        assert any("gpu ingest verify failed" in r.getMessage() for r in caplog.records)

    def test_finish_piece_raises_and_piece_is_rerequested(self, sha1_calls):
        async def go():
            t, pieces = _torrent(TorrentConfig(device="cpu"))
            t.verifier = _FailingVerifier()
            partial = _PartialPiece(
                index=2, length=PLEN, buffer=bytearray(pieces[2]), received={0}
            )
            t._partials[2] = partial
            with pytest.raises(RuntimeError, match="device lost"):
                await t._finish_piece(partial)
            # not written, not a partial any more: the picker asks again
            assert not t.bitfield.has(2) and 2 not in t._partials

        run(go())
        assert sha1_calls == []

    def test_v2_flush_error_reaches_every_waiter(self, sha1_calls, monkeypatch):
        async def go():
            t, pieces = _torrent(TorrentConfig(device="cpu"))
            t.v2 = True

            def boom(pieces, expected):
                raise RuntimeError("leaf launch failed")

            monkeypatch.setattr(t, "_verify_batch_device_v2", boom)
            fut = asyncio.get_running_loop().create_future()
            t._verify_pending.append((0, pieces[0], b"\x00" * 32, fut))
            t._verify_flushing = True
            await t._flush_verify_batch()
            with pytest.raises(RuntimeError, match="leaf launch failed"):
                fut.result()

        run(go())
        assert sha1_calls == []


class TestStartRefusesAMissingCard:
    def test_start_raises_before_a_socket_opens(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

        async def go():
            c = Client(ClientConfig(host="127.0.0.1"))
            with pytest.raises(RuntimeError, match="CUDA"):
                await c.start()
            assert c._server is None and c.port is None
            await c.close()

        run(go())

    def test_start_raises_before_the_udp_sockets_open(self, monkeypatch):
        """With the DHT, uTP and LSD on, a missing card still stops
        ``start()`` before any of their UDP sockets opens."""
        import torch

        from torrent_tpu_torch.net import dht, lsd, utp

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        opened = []
        monkeypatch.setattr(dht.DHTNode, "start", lambda self: opened.append("dht"))
        monkeypatch.setattr(utp, "create_utp_endpoint", lambda *a, **k: opened.append("utp"))
        monkeypatch.setattr(lsd.LocalServiceDiscovery, "start", lambda self: opened.append("lsd"))

        async def go():
            c = Client(ClientConfig(host="127.0.0.1", enable_dht=True, enable_utp=True, enable_lsd=True))
            with pytest.raises(RuntimeError, match="CUDA"):
                await c.start()
            assert c._server is None and c.dht is None and c.utp is None and c.lsd is None
            await c.close()

        run(go())
        assert opened == []

    def test_cpu_device_and_cpu_hasher_start(self):
        async def go():
            for cfg in (
                ClientConfig(host="127.0.0.1", device="cpu"),
                ClientConfig(host="127.0.0.1", hasher="cpu"),
            ):
                c = Client(cfg)
                await c.start()
                try:
                    assert c.port
                finally:
                    await c.close()

        run(go())


ONCE_REFUSED = {
    "enable_upnp": True,
    "enable_natpmp": True,
    "enable_dht": True,
    "enable_lsd": True,
    "enable_utp": True,
    "dns_tracker_prefs": True,
    "ip_filter": ("10.0.0.0/8",),
    "proxy": "socks5://127.0.0.1:1080",
}


def _outcome(coro_fn):
    """The exception type and text an awaited call ends in (None if it
    returns), for holding the port's client against the reference's."""

    async def go():
        try:
            await coro_fn()
        except Exception as e:
            return type(e).__name__, str(e)
        return None

    return go


class TestUnportedSubsystemsRefused:
    """The options and entry points the port refused with
    ``NotImplementedError`` until its discovery and transport planes
    were ported (the case names keep that history): each is now
    accepted and behaves as the reference's client does."""

    @pytest.mark.parametrize("option", sorted(ONCE_REFUSED))
    def test_option_raises_not_implemented(self, option):
        from torrent_tpu.session.client import Client as RefClient
        from torrent_tpu.session.client import ClientConfig as RefClientConfig

        mine = Client(ClientConfig(hasher="cpu", **{option: ONCE_REFUSED[option]}))
        theirs = RefClient(RefClientConfig(hasher="cpu", **{option: ONCE_REFUSED[option]}))
        assert getattr(mine.config, option) == ONCE_REFUSED[option]
        for attr in ("ip_filter", "proxy", "dns_prefs", "dht", "lsd", "utp"):
            assert (getattr(mine, attr) is None) == (getattr(theirs, attr) is None), attr

    @pytest.mark.parametrize(
        "call",
        ["add_magnet", "resolve_mutable", "add_mutable_magnet", "require_signed"],
    )
    def test_entry_point_raises_not_implemented(self, call, tmp_path):
        from torrent_tpu.session.client import Client as RefClient
        from torrent_tpu.session.client import ClientConfig as RefClientConfig

        uri = "magnet:?xt=urn:btih:" + "ab" * 20

        async def go(make, config):
            c = make(config(host="127.0.0.1", hasher="cpu"))
            await c.start()
            try:
                calls = {
                    "add_magnet": lambda: c.add_magnet(uri, str(tmp_path)),
                    "resolve_mutable": lambda: c.resolve_mutable(uri),
                    "add_mutable_magnet": lambda: c.add_mutable_magnet(uri, str(tmp_path)),
                    "require_signed": lambda: c.add_torrent_bytes(b"d", str(tmp_path), require_signed=("x", b"k")),
                }
                got = await _outcome(calls[call])()
                assert not c.torrents
                return got
            finally:
                await c.close()

        mine = run(go(Client, ClientConfig))
        assert mine is not None and mine[0] != "NotImplementedError", mine
        assert mine == run(go(RefClient, RefClientConfig))


class TestNativeRc4:
    @pytest.mark.parametrize("key_len", [1, 16, 20, 96])
    def test_native_keystream_equals_pure_python(self, key_len, monkeypatch):
        from torrent_tpu_torch.net import mse

        assert mse._lib() is not None, "the host engine should build here (g++)"
        rng = np.random.default_rng(key_len)
        key = rng.integers(0, 256, key_len, dtype=np.uint8).tobytes()
        chunks = [
            rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in (0, 1, 7, 1024, 16384 + 13)
        ]
        native = mse.RC4(key)
        assert native._lib is not None
        monkeypatch.setattr(mse, "_lib", lambda: None)
        pure = mse.RC4(key)
        assert pure._lib is None
        native.discard(1024)
        pure.discard(1024)
        for c in chunks:
            assert native.crypt(c) == pure.crypt(c)

    def test_pure_python_matches_the_reference(self):
        from torrent_tpu.net import mse as ref_mse
        from torrent_tpu_torch.net import mse

        key = bytes(range(40))
        data = bytes(range(256)) * 9
        assert mse.RC4(key).crypt(data) == ref_mse.RC4(key).crypt(data)


class TestCompatConfigs:
    def test_torrent_config_maps_hasher_and_copies_fields(self):
        from torrent_tpu.session.torrent import TorrentConfig as RefTorrentConfig
        from torrent_tpu_torch.compat import torrent_config_from_reference

        ref = RefTorrentConfig(hasher="tpu", max_peers=7, encryption="required", verify_batch_size=32)
        port = torrent_config_from_reference(ref, device="cpu")
        assert (port.hasher, port.device) == ("gpu", "cpu")
        for f in dataclasses.fields(RefTorrentConfig):
            if f.name != "hasher":
                assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert torrent_config_from_reference(RefTorrentConfig()).hasher == "cpu"

    def test_client_config_maps_nested_torrent_config(self):
        from torrent_tpu.session.client import ClientConfig as RefClientConfig
        from torrent_tpu.session.torrent import TorrentConfig as RefTorrentConfig
        from torrent_tpu_torch.compat import client_config_from_reference

        ref = RefClientConfig(
            hasher="tpu", port=6881, max_upload_bps=5, torrent=RefTorrentConfig(hasher="tpu")
        )
        port = client_config_from_reference(ref, device="cpu")
        assert (port.hasher, port.device, port.port, port.max_upload_bps) == ("gpu", "cpu", 6881, 5)
        assert port.peer_id == ref.peer_id
        assert (port.torrent.hasher, port.torrent.device) == ("gpu", "cpu")

    def test_live_scheduler_and_unknown_hasher_refused(self):
        from torrent_tpu.session.client import ClientConfig as RefClientConfig
        from torrent_tpu.session.torrent import TorrentConfig as RefTorrentConfig
        from torrent_tpu_torch.compat import (
            client_config_from_reference,
            torrent_config_from_reference,
        )

        with pytest.raises(ValueError, match="scheduler"):
            torrent_config_from_reference(RefTorrentConfig(scheduler=object()))
        with pytest.raises(ValueError, match="scheduler"):
            client_config_from_reference(RefClientConfig(scheduler=object()))
        with pytest.raises(ValueError, match="scheduler"):
            client_config_from_reference(
                RefClientConfig(torrent=RefTorrentConfig(scheduler=object()))
            )
        with pytest.raises(ValueError, match="hasher"):
            torrent_config_from_reference(RefTorrentConfig(hasher="fpga"))


class TestExports:
    def test_package_and_session_export_the_session(self):
        import torrent_tpu_torch
        import torrent_tpu_torch.session as session

        for name in ("Client", "ClientConfig", "Torrent", "TorrentConfig", "TorrentState"):
            assert getattr(torrent_tpu_torch, name) is getattr(session, name)
        assert session.Client is Client and session.TorrentConfig is TorrentConfig
        with pytest.raises(AttributeError):
            torrent_tpu_torch.NoSuchName  # noqa: B018
