"""The port's session against the reference's, on the same inputs.

Inputs are made from numpy seeds and go through both packages in one
process: the reference on JAX's CPU backend (``hasher="tpu"``, as its
own tests run it) and the port on ``device="cpu"`` (the plain PyTorch
SHA-1 and SHA-256). What must agree:

- every peer-wire and extension message encodes to the same bytes, and
  each package decodes the other's;
- the in-memory tracker answers the same seeded announces and scrapes
  with the same HTTP and UDP bytes;
- ``Torrent._verify_batch_device`` and ``_verify_batch_device_v2`` give
  the same verdicts on a batch with one flipped byte;
- a swarm across the packages completes in both directions;
- a fastresume file written by either package resumes in the other
  with the same bitfield.

Ports are ephemeral (0) and the logger names are the packages' own, so
this file shares an xdist worker with ``tests/test_session.py`` safely.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import random
import zlib

import numpy as np
import pytest

from torrent_tpu.net import extension as ref_ext
from torrent_tpu.net import protocol as ref_proto
from torrent_tpu_torch.net import extension as ext
from torrent_tpu_torch.net import protocol as proto

from tests.test_torch_session import build_torrent_bytes, run

PLEN = 16384


def _value(rng, name: str, annotation: str):
    """A seeded value for one message field, by its name and type."""
    if name == "pieces_root":
        return rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    if name == "hashes":
        return rng.integers(0, 256, 32 * int(rng.integers(1, 5)), dtype=np.uint8).tobytes()
    if "bytes" in annotation:
        return rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes()
    if name == "ext_id":
        return int(rng.integers(0, 256))
    if name in ("base_layer", "proof_layers"):
        return int(rng.integers(0, 20))
    return int(rng.integers(0, 1 << 31))


def _message_classes():
    return sorted(
        name
        for name, obj in vars(proto).items()
        if dataclasses.is_dataclass(obj) and isinstance(obj, type)
        and obj.__module__ == proto.__name__
    )


class TestWireMessages:
    def test_both_packages_define_the_same_messages(self):
        ref = sorted(
            name
            for name, obj in vars(ref_proto).items()
            if dataclasses.is_dataclass(obj) and isinstance(obj, type)
            and obj.__module__ == ref_proto.__name__
        )
        assert _message_classes() == ref
        assert {m.name: int(m) for m in proto.MsgId} == {m.name: int(m) for m in ref_proto.MsgId}

    @pytest.mark.parametrize("name", _message_classes())
    def test_encodes_byte_equal_and_cross_decodes(self, name):
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        cls, ref_cls = getattr(proto, name), getattr(ref_proto, name)
        for _ in range(4):
            kw = {
                f.name: _value(rng, f.name, str(f.type))
                for f in dataclasses.fields(cls)
            }
            mine, theirs = cls(**kw), ref_cls(**kw)
            wire = proto.encode_message(mine)
            assert wire == ref_proto.encode_message(theirs)
            if len(wire) == 4:
                continue  # keep-alive: no id byte to decode
            mid, payload = wire[4], wire[5:]
            assert dataclasses.astuple(ref_proto.decode_message(mid, payload)) == dataclasses.astuple(mine)
            assert dataclasses.astuple(proto.decode_message(mid, payload)) == dataclasses.astuple(theirs)

    def test_handshake_and_reserved_bits(self):
        rng = np.random.default_rng(5)
        for _ in range(8):
            ih = rng.integers(0, 256, 20, dtype=np.uint8).tobytes()
            pid = rng.integers(0, 256, 20, dtype=np.uint8).tobytes()
            reserved = proto.merge_reserved(ext.extension_reserved(), proto.fast_reserved())
            assert reserved == ref_proto.merge_reserved(
                ref_ext.extension_reserved(), ref_proto.fast_reserved()
            )
            assert proto.handshake_bytes(ih, pid, reserved) == ref_proto.handshake_bytes(
                ih, pid, reserved
            )
        assert proto.allowed_fast_set("10.1.2.3", ih, 500) == ref_proto.allowed_fast_set(
            "10.1.2.3", ih, 500
        )

    def test_extension_messages(self):
        rng = np.random.default_rng(6)
        for _ in range(6):
            size = int(rng.integers(1, 1 << 20))
            port = int(rng.integers(1, 65535))
            assert ext.encode_extended_handshake(size, "tt", port) == ref_ext.encode_extended_handshake(
                size, "tt", port
            )
            hs = ref_ext.encode_extended_handshake(size, "tt", port, exclude=(b"ut_pex",))
            assert hs == ext.encode_extended_handshake(size, "tt", port, exclude=(b"ut_pex",))
            state, ref_state = ext.ExtensionState(), ref_ext.ExtensionState()
            ext.decode_extended_handshake(hs, state)
            ref_ext.decode_extended_handshake(hs, ref_state)
            assert dataclasses.asdict(state) == dataclasses.asdict(ref_state)

            added = [
                (".".join(str(int(b)) for b in rng.integers(1, 255, 4)), int(rng.integers(1, 65535)))
                for _ in range(int(rng.integers(0, 6)))
            ] + [("2001:db8::%x" % int(rng.integers(1, 4096)), 6881)]
            dropped = added[:1]
            pex = ext.encode_pex(added, dropped)
            assert pex == ref_ext.encode_pex(added, dropped)
            assert dataclasses.astuple(ext.decode_pex(pex)) == dataclasses.astuple(ref_ext.decode_pex(pex))

            piece = int(rng.integers(0, 64))
            data = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
            for enc in ("encode_metadata_request", "encode_metadata_reject", "encode_donthave"):
                assert getattr(ext, enc)(piece) == getattr(ref_ext, enc)(piece)
            md = ext.encode_metadata_data(piece, 64 * 16384, data)
            assert md == ref_ext.encode_metadata_data(piece, 64 * 16384, data)
            assert dataclasses.astuple(ext.decode_metadata_message(md)) == dataclasses.astuple(
                ref_ext.decode_metadata_message(md)
            )
            hp = ext.HolepunchMessage(msg_type=ext.HolepunchType.ERROR, addr=added[0], err_code=2)
            ref_hp = ref_ext.HolepunchMessage(msg_type=ref_ext.HolepunchType.ERROR, addr=added[0], err_code=2)
            assert ext.encode_holepunch(hp) == ref_ext.encode_holepunch(ref_hp)


# ------------------------------------------------------------- tracker


class _Writer:
    def __init__(self):
        self.data = bytearray()
        self.closed = False

    def write(self, b):
        self.data += b

    async def drain(self):
        pass

    def is_closing(self):
        return self.closed

    def close(self):
        self.closed = True


class _Transport:
    def __init__(self):
        self.packets = []

    def sendto(self, pkt, addr):
        self.packets.append((pkt, addr))


def _announces(seed: int, n: int):
    rng = np.random.default_rng(seed)
    hashes = [rng.integers(0, 256, 20, dtype=np.uint8).tobytes() for _ in range(3)]
    peers = [rng.integers(0, 256, 20, dtype=np.uint8).tobytes() for _ in range(12)]
    events = ["started", "empty", "completed", "stopped"]
    for _ in range(n):
        yield dict(
            info_hash=hashes[int(rng.integers(0, 3))],
            peer_id=peers[int(rng.integers(0, 12))],
            ip=f"10.0.{int(rng.integers(0, 4))}.{int(rng.integers(1, 255))}",
            port=int(rng.integers(1, 65535)),
            uploaded=int(rng.integers(0, 1 << 30)),
            downloaded=int(rng.integers(0, 1 << 30)),
            left=int(rng.choice([0, 0, 1, 1 << 20])),
            event=events[int(rng.integers(0, 4))],
            num_want=int(rng.integers(1, 8)),
            compact=bool(rng.integers(0, 4)),
        ), hashes


async def _tracker_replies(pkg: str, seed: int):
    import importlib

    in_memory = importlib.import_module(f"{pkg}.server.in_memory")
    tracker = importlib.import_module(f"{pkg}.server.tracker")
    types = importlib.import_module(f"{pkg}.net.types")
    store = in_memory.InMemoryTracker(interval=60, clock=lambda: 0.0, rng=random.Random(seed))
    out = []
    hashes = []
    for i, (kw, hashes) in enumerate(_announces(seed, 80)):
        kw = dict(kw, event=types.AnnounceEvent(kw["event"]))
        if i % 2:
            w = _Writer()
            await store.handle(tracker.HttpAnnounceRequest(**kw, _writer=w))
            out.append(bytes(w.data))
        else:
            tr = _Transport()
            await store.handle(
                tracker.UdpAnnounceRequest(**kw, _transport=tr, _addr=("10.9.9.9", 6969), _tid=b"\x01\x02\x03\x04")
            )
            out.append(tr.packets)
    w = _Writer()
    await store.handle(tracker.HttpScrapeRequest(info_hashes=hashes + [b"\x00" * 20], _writer=w))
    out.append(bytes(w.data))
    tr = _Transport()
    await store.handle(tracker.UdpScrapeRequest(info_hashes=hashes, _transport=tr, _addr=("10.9.9.9", 1), _tid=b"tidd"))
    out.append(tr.packets)
    return out


class TestInMemoryTracker:
    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_same_announces_same_bytes(self, seed):
        async def go():
            return (
                await _tracker_replies("torrent_tpu_torch", seed),
                await _tracker_replies("torrent_tpu", seed),
            )

        mine, ref = run(go())
        assert len(mine) == 82
        assert mine == ref

    def test_live_http_and_udp_servers_answer_alike(self):
        """The same announces over real sockets: both packages' tracker
        servers, started by their own ``run_tracker``."""
        from torrent_tpu.net.tracker import announce as ref_announce
        from torrent_tpu.net.types import AnnounceInfo as RefInfo
        from torrent_tpu.server.in_memory import run_tracker as ref_run
        from torrent_tpu.server.tracker import ServeOptions as RefOptions
        from torrent_tpu_torch.net.tracker import announce
        from torrent_tpu_torch.net.types import AnnounceInfo
        from torrent_tpu_torch.server.in_memory import run_tracker
        from torrent_tpu_torch.server.tracker import ServeOptions

        async def drive(run_fn, opts_cls, announce_fn, info_cls, udp):
            server, pump = await run_fn(
                opts_cls(http_port=0, udp_port=0 if udp else None, host="127.0.0.1", interval=30)
            )
            try:
                url = (
                    f"udp://127.0.0.1:{server.udp_port}"
                    if udp
                    else f"http://127.0.0.1:{server.http_port}/announce"
                )
                replies = []
                for i in range(4):  # fewer peers than num_want: no sampling
                    info = info_cls(
                        info_hash=b"\x11" * 20,
                        peer_id=bytes([65 + i]) * 20,
                        port=7000 + i,
                        left=0 if i % 2 else 1000,
                    )
                    r = await announce_fn(url, info)
                    replies.append(
                        (r.interval, r.complete, r.incomplete, sorted((p.ip, p.port) for p in r.peers))
                    )
                return replies
            finally:
                server.close()
                await asyncio.wait_for(pump, 5)

        async def go():
            out = {}
            for udp in (False, True):
                out[udp] = (
                    await drive(run_tracker, ServeOptions, announce, AnnounceInfo, udp),
                    await drive(ref_run, RefOptions, ref_announce, RefInfo, udp),
                )
            return out

        for udp, (mine, ref) in run(go()).items():
            assert mine == ref, ("udp" if udp else "http")
            assert mine[-1][1:3] == (2, 2)


# ------------------------------------------------------ ingest verdicts


def _v1_pair(n_pieces: int, seed: int):
    from torrent_tpu.codec.metainfo import parse_metainfo as ref_parse
    from torrent_tpu.models.verifier import TPUVerifier
    from torrent_tpu.session.torrent import Torrent as RefTorrent
    from torrent_tpu.session.torrent import TorrentConfig as RefConfig
    from torrent_tpu.storage.storage import MemoryStorage as RefMemory
    from torrent_tpu.storage.storage import Storage as RefStorage
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.models.verifier import GPUVerifier
    from torrent_tpu_torch.session.torrent import Torrent, TorrentConfig
    from torrent_tpu_torch.storage.storage import MemoryStorage, Storage

    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, n_pieces * PLEN - 100, dtype=np.uint8).tobytes()
    raw = build_torrent_bytes(payload, PLEN, b"http://127.0.0.1:1/announce")
    rm, m = ref_parse(raw), parse_metainfo(raw)
    ref = RefTorrent(
        metainfo=rm, storage=RefStorage(RefMemory(), rm.info), peer_id=b"R" * 20, port=1,
        config=RefConfig(hasher="tpu", verify_batch_size=8),
        verifier=TPUVerifier(piece_length=PLEN, batch_size=8),
    )
    mine = Torrent(
        metainfo=m, storage=Storage(MemoryStorage(), m.info), peer_id=b"P" * 20, port=1,
        config=TorrentConfig(device="cpu", verify_batch_size=8),
        verifier=GPUVerifier(PLEN, batch_size=8, device="cpu"),
    )
    pieces = [payload[i * PLEN : (i + 1) * PLEN] for i in range(n_pieces)]
    return ref, mine, pieces


class TestIngestVerdicts:
    def test_verify_batch_device_agrees_with_the_reference(self):
        ref, mine, pieces = _v1_pair(8, seed=21)
        flipped = bytearray(pieces[5])
        flipped[1234] ^= 0x40
        pieces[5] = bytes(flipped)
        expected = list(mine.info.pieces)
        got = list(mine._verify_batch_device(pieces, expected))
        want = list(ref._verify_batch_device(pieces, expected))
        assert got == want == [True] * 5 + [False] + [True] * 2

    def test_verify_batch_device_v2_agrees_with_the_reference(self):
        from torrent_tpu.models import v2 as ref_v2
        from torrent_tpu.session.torrent import Torrent as RefTorrent
        from torrent_tpu.session.torrent import TorrentConfig as RefConfig
        from torrent_tpu.session.v2 import v2_session_meta as ref_session_meta
        from torrent_tpu.storage.storage import MemoryStorage as RefMemory
        from torrent_tpu.storage.storage import Storage as RefStorage
        from torrent_tpu_torch.compat import metainfo_v2_from_reference
        from torrent_tpu_torch.session.torrent import Torrent, TorrentConfig
        from torrent_tpu_torch.session.v2 import v2_session_meta
        from torrent_tpu_torch.storage.storage import MemoryStorage, Storage

        plen = 2 * PLEN  # two leaves a piece: one merkle level
        rng = np.random.default_rng(22)
        data = rng.integers(0, 256, 8 * plen, dtype=np.uint8).tobytes()
        rmeta = ref_v2.build_v2([(("f",), data)], name="d", piece_length=plen, hasher="cpu")
        rsm, sm = ref_session_meta(rmeta), v2_session_meta(metainfo_v2_from_reference(rmeta))
        ref = RefTorrent(
            metainfo=rsm, storage=RefStorage(RefMemory(), rsm.info), peer_id=b"R" * 20, port=1,
            config=RefConfig(hasher="tpu"),
        )
        mine = Torrent(
            metainfo=sm, storage=Storage(MemoryStorage(), sm.info), peer_id=b"P" * 20, port=1,
            config=TorrentConfig(device="cpu"),
        )
        pieces = [data[i * plen : (i + 1) * plen] for i in range(8)]
        flipped = bytearray(pieces[2])
        flipped[-1] ^= 0x01
        pieces[2] = bytes(flipped)
        expected = list(mine.info.pieces)
        assert expected == list(ref.info.pieces)
        got = mine._verify_batch_device_v2(pieces, expected)
        want = ref._verify_batch_device_v2(pieces, expected)
        assert got == want == [True, True, False] + [True] * 5


# ------------------------------------------------------- cross swarms


async def _swarm(seed_pkg: str, leech_pkg: str, tmp_path, payload: bytes):
    """Seed in one package, leech in the other, one tracker (the
    port's), one loop; returns the leech's bytes."""
    import importlib

    from torrent_tpu_torch.server.in_memory import run_tracker
    from torrent_tpu_torch.server.tracker import ServeOptions

    server, pump = await run_tracker(
        ServeOptions(http_port=0, udp_port=None, host="127.0.0.1", interval=2)
    )
    url = f"http://127.0.0.1:{server.http_port}/announce"
    raw = build_torrent_bytes(payload, PLEN, url.encode(), name=b"x.bin")
    clients = []
    try:
        roles = {}
        for role, pkg in (("seed", seed_pkg), ("leech", leech_pkg)):
            client_mod = importlib.import_module(f"{pkg}.session.client")
            torrent_mod = importlib.import_module(f"{pkg}.session.torrent")
            meta = importlib.import_module(f"{pkg}.codec.metainfo").parse_metainfo(raw)
            if pkg == "torrent_tpu_torch":
                hasher = dict(hasher="gpu", device="cpu")
            else:
                hasher = dict(hasher="cpu")
            cfg = client_mod.ClientConfig(
                host="127.0.0.1",
                torrent=torrent_mod.TorrentConfig(
                    choke_interval=0.15, announce_retry=1.0, verify_batch_size=4
                ),
                **hasher,
            )
            c = client_mod.Client(cfg)
            await c.start()
            clients.append(c)
            d = tmp_path / role
            d.mkdir()
            if role == "seed":
                (d / "x.bin").write_bytes(payload)
            roles[role] = await c.add(meta, str(d))
        assert roles["seed"].bitfield.complete
        await asyncio.wait_for(roles["leech"].on_complete.wait(), timeout=60)
        return (tmp_path / "leech" / "x.bin").read_bytes()
    finally:
        for c in clients:
            await c.close()
        server.close()
        await asyncio.wait_for(pump, 5)


class TestCrossPackageSwarm:
    @pytest.mark.parametrize(
        "seed_pkg,leech_pkg",
        [("torrent_tpu", "torrent_tpu_torch"), ("torrent_tpu_torch", "torrent_tpu")],
        ids=["reference_seed-port_leech", "port_seed-reference_leech"],
    )
    def test_transfer_completes(self, seed_pkg, leech_pkg, tmp_path):
        rng = np.random.default_rng(31)
        payload = rng.integers(0, 256, 6 * PLEN + 777, dtype=np.uint8).tobytes()
        got = run(_swarm(seed_pkg, leech_pkg, tmp_path, payload), timeout=120)
        assert got == payload


# ------------------------------------------------------------ resume


def _resume_torrent(pkg: str, root, raw: bytes):
    import importlib

    meta = importlib.import_module(f"{pkg}.codec.metainfo").parse_metainfo(raw)
    resume = importlib.import_module(f"{pkg}.session.resume")
    tmod = importlib.import_module(f"{pkg}.session.torrent")
    smod = importlib.import_module(f"{pkg}.storage.storage")
    return tmod.Torrent(
        metainfo=meta,
        storage=smod.Storage(smod.FsStorage(str(root)), meta.info),
        peer_id=b"Q" * 20,
        port=1,
        config=tmod.TorrentConfig(hasher="cpu"),
        resume_store=resume.FsResumeStore(str(root)),
    )


class TestResumeAcrossPackages:
    @pytest.mark.parametrize(
        "writer,reader",
        [("torrent_tpu", "torrent_tpu_torch"), ("torrent_tpu_torch", "torrent_tpu")],
        ids=["reference_writes", "port_writes"],
    )
    def test_resume_file_resumes_with_the_same_bitfield(self, writer, reader, tmp_path):
        rng = np.random.default_rng(41)
        payload = bytearray(rng.integers(0, 256, 7 * PLEN + 5, dtype=np.uint8).tobytes())
        raw = build_torrent_bytes(bytes(payload), PLEN, b"http://127.0.0.1:1/announce", name=b"r.bin")
        for bad in (1, 4):  # two pieces on disk do not verify
            payload[bad * PLEN + 9] ^= 0xFF
        (tmp_path / "r.bin").write_bytes(bytes(payload))

        async def go():
            w = _resume_torrent(writer, tmp_path, raw)
            await w.recheck()
            w.uploaded, w.downloaded = 12345, 67890
            w._checkpoint()
            r = _resume_torrent(reader, tmp_path, raw)
            assert r._try_fastresume()
            return w, r

        w, r = run(go())
        assert w.bitfield.to_bytes() == r.bitfield.to_bytes()
        assert [r.bitfield.has(i) for i in range(8)] == [i not in (1, 4) for i in range(8)]
        assert (r.uploaded, r.downloaded) == (12345, 67890)
        assert any(p.name.endswith(".resume") for p in tmp_path.iterdir()), os.listdir(tmp_path)
