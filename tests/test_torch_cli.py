"""The port's command line (tools/cli.py, ``python -m torrent_tpu_torch``).

Four parts:

- the reference's CLI tests run against the port (``tests/test_cli.py``,
  and the CLI classes of ``test_signing.py``, ``test_tracker_shard.py``,
  ``test_feed.py``, ``test_obs.py``, ``test_timeline.py`` and
  ``test_fleet.py``), passing ``--hasher cpu`` where the reference relied
  on its hashlib default: the port's default is the card. The CLI classes
  of ``test_update.py`` and ``test_persistence.py`` run in their whole
  copies, ``tests/test_torch_update.py`` and ``test_torch_persistence.py``;
- differential cases: the same seeded files and argv through both
  packages' ``main`` give the same exit code, the same stdout (the
  output directory aside) and byte-equal ``.torrent`` files, for
  ``info``, ``magnet``, ``make`` (v1, ``--v2``, ``--hybrid``,
  ``--also-tracker``), ``verify``, ``edit``, ``sign`` and ``update``.
  ``verify --hasher gpu --device cpu`` (the plain PyTorch SHA-1) goes
  against the reference's ``--hasher tpu`` and hashlib on two 16 KiB
  pieces: the plain SHA-1 takes seconds a launch on a CPU;
- the parser against the reference's: the same subcommands in the same
  order with the same flags, apart from the listed divergences;
- what the CLI delegates and refuses: ``lint`` runs the port's
  analysis plane (exit 0 against the baseline, 1 on a new finding),
  ``bench`` without a rung exits 2 with the reference's usage error and
  with one delegates to ``tools/bench_cli.py``, and the default ``gpu`` hasher on
  a host without CUDA is an error with no verdict. The entry point alone
  (``python -m torrent_tpu_torch --help``) loads no jax.
"""

import asyncio
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from torrent_tpu.tools.cli import build_parser as ref_build_parser
from torrent_tpu.tools.cli import main as ref_main
from torrent_tpu_torch.tools.cli import build_parser, main

from tests.test_torch_session import build_torrent_bytes, fast_config, run, start_tracker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANNOUNCE = "http://127.0.0.1:1/announce"
SEED_A = bytes(range(32))
SEED_B = bytes(range(32, 64))


@pytest.fixture
def payload_dir(tmp_path):
    rng = np.random.default_rng(21)
    src = tmp_path / "src"
    sub = src / "data"
    sub.mkdir(parents=True)
    (src / "one.bin").write_bytes(rng.integers(0, 256, size=50_000, dtype=np.uint8).tobytes())
    (sub / "two.bin").write_bytes(rng.integers(0, 256, size=30_000, dtype=np.uint8).tobytes())
    return src


# ------------------------------------------------------------ test_cli.py


class TestCli:
    def test_make_info_verify_roundtrip(self, payload_dir, tmp_path, capsys):
        out = str(tmp_path / "made.torrent")
        rc = main(
            ["make", str(payload_dir), "http://127.0.0.1:1/announce", "-o", out,
             "--piece-length", "16384", "--comment", "cli test", "--hasher", "cpu"]
        )
        assert rc == 0

        rc = main(["info", out])
        assert rc == 0
        text = capsys.readouterr().out
        assert "src" in text and "pieces:" in text and "16,384" in text

        # verify against the parent dir (storage resolves <dir>/<name>/...)
        rc = main(["verify", out, str(payload_dir.parent), "--hasher", "cpu"])
        assert rc == 0
        assert "pieces valid" in capsys.readouterr().out

        # corrupt a byte -> nonzero exit, invalid piece listed
        blob = bytearray((payload_dir / "one.bin").read_bytes())
        blob[0] ^= 0xFF
        (payload_dir / "one.bin").write_bytes(bytes(blob))
        rc = main(["verify", out, str(payload_dir.parent), "--hasher", "cpu"])
        assert rc == 2
        assert "first invalid pieces: [0]" in capsys.readouterr().out

    def test_make_v2_info_verify_roundtrip(self, payload_dir, tmp_path, capsys):
        """BEP 52 flow: author --v2 → info autodetects → verify localizes
        corruption to one file's piece without touching the other."""
        out = str(tmp_path / "made_v2.torrent")
        rc = main(
            ["make", str(payload_dir), "http://127.0.0.1:1/announce", "-o", out,
             "--piece-length", "16384", "--v2", "--hasher", "cpu"]
        )
        assert rc == 0
        assert "v2" in capsys.readouterr().out

        rc = main(["info", out])
        assert rc == 0
        text = capsys.readouterr().out
        assert "BitTorrent v2" in text and "info hash v2" in text

        rc = main(["verify", out, str(payload_dir.parent), "--hasher", "cpu"])
        assert rc == 0
        assert "(v2)" in capsys.readouterr().out

        blob = bytearray((payload_dir / "one.bin").read_bytes())
        blob[0] ^= 0xFF
        (payload_dir / "one.bin").write_bytes(bytes(blob))
        rc = main(["verify", out, str(payload_dir.parent), "--hasher", "cpu"])
        assert rc == 2
        text = capsys.readouterr().out
        assert "one.bin: bad pieces [0]" in text

    def test_make_v2_single_file(self, tmp_path, capsys):
        """Single-file v2 payload verifies at <dir>/<name> (v1 Storage
        convention), not <dir>/<name>/<name>."""
        rng = np.random.default_rng(33)
        payload = tmp_path / "solo.bin"
        payload.write_bytes(rng.integers(0, 256, size=70_000, dtype=np.uint8).tobytes())
        out = str(tmp_path / "solo_v2.torrent")
        rc = main(["make", str(payload), "http://127.0.0.1:1/announce", "-o", out,
                   "--piece-length", "16384", "--v2", "--hasher", "cpu"])
        assert rc == 0
        rc = main(["verify", out, str(tmp_path), "--hasher", "cpu"])
        assert rc == 0
        assert "pieces valid (v2)" in capsys.readouterr().out

    def test_make_v2_with_root_hints_stays_canonical(self, tmp_path, capsys):
        """BEP 38/39 keys are appended to the decoded root dict AFTER the
        builder sorted it; the emitted bencode must still have sorted
        top-level keys or strict decoders reject the file."""
        rng = np.random.default_rng(34)
        payload = tmp_path / "c.bin"
        payload.write_bytes(
            rng.integers(0, 256, size=70_000, dtype=np.uint8).tobytes()
        )
        out = str(tmp_path / "c.torrent")
        rc = main(
            ["make", str(payload), "http://127.0.0.1:1/announce", "-o", out,
             "--piece-length", "16384", "--v2", "--hasher", "cpu",
             "--collection", "ds", "--update-url", "http://u/x"]
        )
        assert rc == 0
        capsys.readouterr()
        data = (tmp_path / "c.torrent").read_bytes()

        from torrent_tpu_torch.codec.bencode import bdecode, bencode

        top = bdecode(data)
        assert b"collections" in top and b"update-url" in top
        assert list(top) == sorted(top)
        # fully canonical: re-encoding with sorted keys is byte-identical
        assert data == bencode(top)

    def test_make_hybrid_roundtrip(self, payload_dir, tmp_path, capsys):
        """--hybrid authors one blob both parsers read; verify routes via
        the v2 path (pad files never exist on disk)."""
        out = str(tmp_path / "hyb.torrent")
        rc = main(["make", str(payload_dir), "http://127.0.0.1:1/announce", "-o", out,
                   "--piece-length", "16384", "--hybrid", "--hasher", "cpu"])
        assert rc == 0
        assert "hybrid v1+v2" in capsys.readouterr().out

        from torrent_tpu_torch.codec.metainfo import parse_metainfo

        blob = open(out, "rb").read()
        assert parse_metainfo(blob) is not None  # v1 clients read it too

        rc = main(["verify", out, str(payload_dir.parent), "--hasher", "cpu"])
        assert rc == 0
        assert "(v2)" in capsys.readouterr().out

    def test_info_rejects_garbage(self, tmp_path, capsys):
        bad = tmp_path / "bad.torrent"
        bad.write_bytes(b"this is not bencode")
        assert main(["info", str(bad)]) == 1

    def test_download_from_seed(self, payload_dir, tmp_path, capsys):
        """CLI download against a live seeding client + tracker."""
        from torrent_tpu_torch.codec.metainfo import parse_metainfo
        from torrent_tpu_torch.server.in_memory import run_tracker
        from torrent_tpu_torch.server.tracker import ServeOptions
        from torrent_tpu_torch.session.client import Client, ClientConfig
        from torrent_tpu_torch.session.torrent import TorrentConfig
        from torrent_tpu_torch.tools.make_torrent import make_torrent

        dest = tmp_path / "dest"
        dest.mkdir()
        ready = threading.Event()
        done = threading.Event()

        async def seed_side():
            server, pump = await run_tracker(
                ServeOptions(http_port=0, udp_port=None, interval=1)
            )
            url = f"http://127.0.0.1:{server.http_port}/announce"
            data = make_torrent(str(payload_dir), url, piece_length=16384, hasher="cpu")
            (tmp_path / "cli-dl.torrent").write_bytes(data)
            m = parse_metainfo(data)
            seed = Client(ClientConfig(host="127.0.0.1", hasher="cpu"))
            seed.config.torrent = TorrentConfig(
                choke_interval=0.15, announce_retry=1.0, hasher="cpu"
            )
            await seed.start()
            await seed.add(m, str(payload_dir.parent))
            ready.set()
            while not done.is_set():
                await asyncio.sleep(0.1)
            await seed.close()
            server.close()
            await asyncio.wait_for(pump, 5)

        th = threading.Thread(target=lambda: asyncio.run(seed_side()), daemon=True)
        th.start()
        assert ready.wait(30)
        try:
            rc = main(
                ["download", str(tmp_path / "cli-dl.torrent"), str(dest), "--no-resume",
                 "--hasher", "cpu"]
            )
            assert rc == 0
            got = (dest / "src" / "one.bin").read_bytes()
            assert got == (payload_dir / "one.bin").read_bytes()
            got2 = (dest / "src" / "data" / "two.bin").read_bytes()
            assert got2 == (payload_dir / "data" / "two.bin").read_bytes()
        finally:
            done.set()
            th.join(10)

    def test_download_pure_v2_torrent(self, tmp_path, capsys):
        """CLI download of a pure-v2 (BEP 52) .torrent against a live
        seed: the v1-parse fallback routes it through session/v2.py."""
        from torrent_tpu_torch.codec.metainfo_v2 import encode_metainfo_v2
        from torrent_tpu_torch.models.v2 import build_v2
        from torrent_tpu_torch.server.in_memory import run_tracker
        from torrent_tpu_torch.server.tracker import ServeOptions
        from torrent_tpu_torch.session.client import Client, ClientConfig
        from torrent_tpu_torch.session.torrent import TorrentConfig

        dest = tmp_path / "v2dest"
        dest.mkdir()
        payload = np.random.default_rng(66).integers(
            0, 256, 5 * 32768 + 123, dtype=np.uint8
        ).tobytes()
        ready = threading.Event()
        done = threading.Event()

        async def seed_side():
            server, pump = await run_tracker(
                ServeOptions(http_port=0, udp_port=None, interval=1)
            )
            url = f"http://127.0.0.1:{server.http_port}/announce"
            meta = build_v2(
                [(("v.bin",), payload)],
                name="v2cli",
                piece_length=32768,
                hasher="cpu",
                announce=url,
            )
            (tmp_path / "cli-v2.torrent").write_bytes(
                encode_metainfo_v2(meta.info, meta.piece_layers, announce=url)
            )
            sd = tmp_path / "v2seed" / "v2cli"
            sd.mkdir(parents=True)
            (sd / "v.bin").write_bytes(payload)
            seed = Client(ClientConfig(host="127.0.0.1", hasher="cpu"))
            seed.config.torrent = TorrentConfig(
                choke_interval=0.15, announce_retry=1.0, hasher="cpu"
            )
            await seed.start()
            t = await seed.add(meta, str(tmp_path / "v2seed"))
            assert t.bitfield.complete
            ready.set()
            while not done.is_set():
                await asyncio.sleep(0.1)
            await seed.close()
            server.close()
            await asyncio.wait_for(pump, 5)

        th = threading.Thread(target=lambda: asyncio.run(seed_side()), daemon=True)
        th.start()
        assert ready.wait(30)
        try:
            rc = main(
                ["download", str(tmp_path / "cli-v2.torrent"), str(dest), "--no-resume",
                 "--hasher", "cpu"]
            )
            assert rc == 0
            assert (dest / "v2cli" / "v.bin").read_bytes() == payload
        finally:
            done.set()
            th.join(10)

    def test_magnet_subcommand(self, payload_dir, tmp_path, capsys):
        """'torrent-tpu magnet' emits a parseable URI carrying the
        infohash(es), name, trackers, and --peer addresses."""
        from torrent_tpu_torch.codec.magnet import parse_magnet
        from torrent_tpu_torch.codec.metainfo import parse_metainfo
        from torrent_tpu_torch.tools.make_torrent import make_torrent

        data = make_torrent(str(payload_dir), "http://t/announce", piece_length=16384, hasher="cpu")
        p = tmp_path / "mg.torrent"
        p.write_bytes(data)
        rc = main(["magnet", str(p), "--peer", "127.0.0.1:6881"])
        assert rc == 0
        uri = capsys.readouterr().out.strip()
        m = parse_magnet(uri)
        ref = parse_metainfo(data)
        assert m.info_hash == ref.info_hash
        assert m.trackers == ("http://t/announce",)
        assert m.peer_addrs == (("127.0.0.1", 6881),)
        rc = main(["magnet", str(p), "--no-trackers"])
        assert rc == 0
        assert parse_magnet(capsys.readouterr().out.strip()).trackers == ()

    def test_magnet_subcommand_hybrid_both_topics(self, tmp_path, capsys):
        from torrent_tpu_torch.codec.magnet import parse_magnet
        from torrent_tpu_torch.models.v2 import build_hybrid

        fa = np.random.default_rng(96).integers(0, 256, 40000, dtype=np.uint8).tobytes()
        blob, meta2 = build_hybrid(
            [(("h.bin",), fa)], name="hm", piece_length=16384, hasher="cpu",
            announce="http://t/announce",
        )
        p = tmp_path / "hy.torrent"
        p.write_bytes(blob)
        rc = main(["magnet", str(p)])
        assert rc == 0
        m = parse_magnet(capsys.readouterr().out.strip())
        assert m.info_hash is not None and m.info_hash_v2 == meta2.info_hash_v2

    def test_magnet_rejects_bad_peer_and_carries_ws(self, tmp_path, capsys):
        from torrent_tpu_torch.codec.bencode import bdecode, bencode
        from torrent_tpu_torch.codec.magnet import parse_magnet

        data = build_torrent_bytes(b"q" * 5000, 4096, b"http://t/announce")
        p = tmp_path / "ws.torrent"
        raw = bdecode(data)
        raw[b"url-list"] = [b"http://cdn.example/d/"]
        p.write_bytes(bencode(raw))
        for bad in (":6881", "h:0", "h:70000", "nope"):
            assert main(["magnet", str(p), "--peer", bad]) == 1
        assert main(["magnet", str(p)]) == 0
        m = parse_magnet(capsys.readouterr().out.strip())
        assert m.web_seeds == ("http://cdn.example/d/",)
        assert main(["magnet", str(tmp_path)]) == 1  # directory: clean error

    def test_parser_flag_wiring(self):
        """Flag plumbing sanity."""
        p = build_parser()
        a = p.parse_args(["download", "x.torrent", "d", "--super-seed", "--utp"])
        assert a.super_seed and a.utp
        a2 = p.parse_args(["magnet", "x.torrent", "--no-trackers", "--peer", "h:1"])
        assert a2.no_trackers and a2.peer == ["h:1"]
        a3 = p.parse_args(["make", "p", "http://t/a", "--v2"])
        assert a3.v2 and not a3.hybrid
        a4 = p.parse_args(
            [
                "download", "x.torrent", "d",
                "--encryption", "required",
                "--proxy", "socks5://127.0.0.1:1080",
                "--stream-port", "0",
                "--metrics-port", "0",
            ]
        )
        assert a4.encryption == "required"
        assert a4.proxy == "socks5://127.0.0.1:1080"
        assert a4.stream_port == 0 and a4.metrics_port == 0
        a5 = p.parse_args(["scrape", "--proxy", "socks5://h:1", "--torrent", "t"])
        assert a5.proxy == "socks5://h:1"
        a6 = p.parse_args(
            ["seed", "tdir", "ddir", "--metrics-port", "0", "--encryption", "required"]
        )
        assert a6.torrents == "tdir" and a6.data == "ddir"
        assert a6.metrics_port == 0 and a6.encryption == "required"
        a7 = p.parse_args(["download", "x.torrent", "d", "--dht-state", "dht.dat"])
        assert a7.dht_state == "dht.dat"
        a8 = p.parse_args(["edit", "t", "--clear-trackers"])
        assert a8.clear_trackers
        # the port's device flags: the card unless asked otherwise
        a9 = p.parse_args(["verify", "t", "d"])
        assert a9.hasher == "gpu" and a9.device is None and a9.batch == 256
        a10 = p.parse_args(["make", "p", "http://t/a", "--hasher", "gpu", "--device", "cpu"])
        assert a10.hasher == "gpu" and a10.device == "cpu"


def test_edit_rewrites_without_touching_infohash(tmp_path, ref_fixtures):
    """edit swaps trackers/webseeds on a golden reference fixture whose
    info dict our canonical encoder would NOT reproduce byte-for-byte —
    the raw-splice requirement, proven on real foreign bytes."""
    from torrent_tpu_torch.codec.metainfo import parse_metainfo

    src = str(ref_fixtures / "singlefile.torrent")
    before = parse_metainfo(open(src, "rb").read())
    out = str(tmp_path / "edited.torrent")
    rc = main(
        [
            "edit", src, "-o", out,
            "--tracker", "http://new.example/announce",
            "--tracker", "http://backup.example/announce",
            "--web-seed", "http://mirror.example/f",
            "--comment", "relocated",
        ]
    )
    assert rc == 0
    after = parse_metainfo(open(out, "rb").read())
    assert after.info_hash == before.info_hash  # the whole point
    assert after.announce == "http://new.example/announce"
    assert after.web_seeds == ("http://mirror.example/f",)
    assert after.raw[b"comment"] == b"relocated"
    # tiers present for the multi-tracker form
    assert after.raw[b"announce-list"] == [
        [b"http://new.example/announce"], [b"http://backup.example/announce"]
    ]
    # clearing works and still parses
    rc = main(["edit", out, "--clear-trackers", "--clear-web-seeds", "--comment", ""])
    assert rc == 0
    cleared = parse_metainfo(open(out, "rb").read())
    assert cleared.info_hash == before.info_hash
    assert cleared.web_seeds == () and b"comment" not in cleared.raw


def test_seed_box_serves_directory_of_torrents(tmp_path):
    """`torrent-tpu seed` as a subprocess: two torrents in one directory,
    both downloadable by a client pointed at the box."""
    import re

    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.server.in_memory import run_tracker
    from torrent_tpu_torch.server.tracker import ServeOptions
    from torrent_tpu_torch.session.client import Client, ClientConfig
    from torrent_tpu_torch.storage.storage import MemoryStorage, Storage

    async def go():
        server, pump = await run_tracker(
            ServeOptions(http_port=0, udp_port=None, host="127.0.0.1", interval=1)
        )
        url = f"http://127.0.0.1:{server.http_port}/announce"
        tdir = tmp_path / "torrents"
        ddir = tmp_path / "data"
        tdir.mkdir()
        ddir.mkdir()
        rng = np.random.default_rng(83)
        metas = []
        for name in (b"box-a.bin", b"box-b.bin"):
            payload = rng.integers(0, 256, size=100_000, dtype=np.uint8).tobytes()
            tb = build_torrent_bytes(payload, 32768, url.encode(), name=name)
            (tdir / (name.decode() + ".torrent")).write_bytes(tb)
            (ddir / name.decode()).write_bytes(payload)
            metas.append((parse_metainfo(tb), payload))

        proc = await asyncio.create_subprocess_exec(
            sys.executable,
            "-m",
            "torrent_tpu_torch.tools.cli",
            "seed",
            str(tdir),
            str(ddir),
            "--hasher",
            "cpu",
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE,
            env=dict(os.environ, PYTHONPATH=REPO),
        )
        try:
            while True:
                raw = await asyncio.wait_for(proc.stderr.readline(), 30)
                assert raw, f"seed box exited early: {await proc.stderr.read()}"
                line = raw.decode()
                m = re.search(r"seeding 2 torrent\(s\) on port (\d+)", line)
                if m:
                    break
            leech = Client(ClientConfig(host="127.0.0.1", hasher="cpu"))
            leech.config.torrent = fast_config()
            await leech.start()
            try:
                for meta, payload in metas:
                    t = await leech.add(meta, Storage(MemoryStorage(), meta.info))
                    await asyncio.wait_for(t.on_complete.wait(), timeout=30)
                    assert t.storage.get(0, len(payload)) == payload
            finally:
                await leech.close()
        finally:
            proc.terminate()
            await proc.wait()
            server.close()
            await asyncio.wait_for(pump, 5)

    run(go())


# ------------------------------------------------ test_signing.py's CLI


def _make_cpu(path: str, out: str) -> None:
    assert main(["make", path, ANNOUNCE, "-o", out, "--piece-length", "16384",
                 "--hasher", "cpu"]) == 0


class TestCliSign:
    def test_keygen_sign_info_check_tamper(self, tmp_path, capsys):
        payload = np.random.default_rng(22).integers(
            0, 256, 40_000, dtype=np.uint8
        ).tobytes()
        (tmp_path / "d.bin").write_bytes(payload)
        tf = str(tmp_path / "d.torrent")
        _make_cpu(str(tmp_path / "d.bin"), tf)
        capsys.readouterr()

        key = str(tmp_path / "signer.key")
        assert main(["sign", "--keygen", "--key", key]) == 0
        out = capsys.readouterr().out
        pub_hex = out.strip().splitlines()[-1].split()[-1]
        assert len(pub_hex) == 64
        assert oct(os.stat(key).st_mode & 0o777) == "0o600"
        # refuses to clobber an existing key
        assert main(["sign", "--keygen", "--key", key]) == 2
        capsys.readouterr()

        assert main(["sign", tf, "--key", key, "--signer", "alice"]) == 0
        assert "signed by: alice" in capsys.readouterr().out

        assert main(["info", tf]) == 0
        assert "signed by:    alice (BEP 35" in capsys.readouterr().out

        assert main(["sign", tf, "--check", "alice", "--pub", pub_hex]) == 0
        assert "VALID" in capsys.readouterr().out

        # bare --check (no --pub) verifies against the attacker-
        # controlled embedded certificate: a tampered torrent whose
        # cert+signature were replaced together would pass, so the
        # scriptable exit code must be non-zero and the output must not
        # claim validity
        assert main(["sign", tf, "--check", "alice"]) == 2
        out = capsys.readouterr().out
        assert "SELF-CONSISTENT" in out and "UNTRUSTED" in out
        assert "VALID" not in out

        # wrong-length trusted key is a usage error, never "INVALID"
        assert main(["sign", tf, "--check", "alice", "--pub", pub_hex[:-2]]) == 2
        err = capsys.readouterr().err
        assert "64 hex chars" in err

        data = bytearray(open(tf, "rb").read())
        i = data.index(b"4:name")
        data[i + 7] ^= 0x01  # flip a byte inside the signed info span
        open(tf, "wb").write(bytes(data))
        assert main(["sign", tf, "--check", "alice", "--pub", pub_hex]) == 2
        assert "INVALID" in capsys.readouterr().out

    def test_download_require_signed_gate(self, tmp_path, capsys):
        """`download --require-signed SIGNER=PUBHEX` refuses unsigned or
        wrong-key torrents before touching the swarm; magnets are
        refused outright (BEP 9 metadata cannot carry root signatures)."""
        from torrent_tpu_torch.codec import signing
        from torrent_tpu_torch.utils import ed25519

        (tmp_path / "g.bin").write_bytes(b"\x11" * 20_000)
        tf = str(tmp_path / "g.torrent")
        _make_cpu(str(tmp_path / "g.bin"), tf)
        capsys.readouterr()
        pub = ed25519.publickey(SEED_A).hex()
        dl = str(tmp_path / "dl")
        os.makedirs(dl)

        # unsigned: refused before any network activity
        assert main(["download", tf, dl, "--hasher", "cpu",
                     f"--require-signed=publisher={pub}"]) == 2
        assert "no valid BEP 35 signature" in capsys.readouterr().err
        # wrong key: refused
        signed = signing.sign_torrent(open(tf, "rb").read(), SEED_B, "publisher")
        open(tf, "wb").write(signed)
        assert main(["download", tf, dl, "--hasher", "cpu",
                     f"--require-signed=publisher={pub}"]) == 2
        capsys.readouterr()
        # malformed spec: usage error
        assert main(["download", tf, dl, "--hasher", "cpu",
                     "--require-signed=publisher=zz"]) == 2
        assert "SIGNER=PUBHEX" in capsys.readouterr().err
        # magnets can never satisfy the gate
        assert main(["download", "magnet:?xt=urn:btih:" + "0" * 40, dl, "--hasher", "cpu",
                     f"--require-signed=publisher={pub}"]) == 2
        assert "magnet" in capsys.readouterr().err

    def test_info_distinguishes_out_of_band_keys(self, tmp_path, capsys):
        """An entry without an embedded certificate is 'unverifiable
        without a trusted key', not 'DOES NOT verify'."""
        from torrent_tpu_torch.codec import signing
        from torrent_tpu_torch.codec.bencode import bdecode, bencode
        from torrent_tpu_torch.utils import ed25519

        (tmp_path / "e.bin").write_bytes(b"\x5a" * 30_000)
        tf = str(tmp_path / "e.torrent")
        _make_cpu(str(tmp_path / "e.bin"), tf)
        signed = signing.sign_torrent(open(tf, "rb").read(), SEED_A, "oob")
        top = bdecode(signed)
        del top[b"signatures"][b"oob"][b"certificate"]
        open(tf, "wb").write(bencode(top))
        capsys.readouterr()
        assert main(["info", tf]) == 0
        out = capsys.readouterr().out
        assert "no embedded certificate" in out
        assert "DOES NOT verify" not in out
        # --check without --pub: UNVERIFIABLE, never INVALID
        assert main(["sign", tf, "--check", "oob"]) == 2
        out = capsys.readouterr().out
        assert "UNVERIFIABLE" in out and "INVALID" not in out
        # --check WITH the right key verifies despite the missing cert
        pub = ed25519.publickey(SEED_A).hex()
        assert main(["sign", tf, "--check", "oob", "--pub", pub]) == 0
        assert "VALID" in capsys.readouterr().out

    def test_cli_write_errors_are_clean(self, tmp_path, capsys):
        assert main(["sign", "--keygen", "--key",
                     str(tmp_path / "no" / "dir" / "k.hex")]) == 1
        assert "cannot write key file" in capsys.readouterr().err


# ------------------------------------------- test_tracker_shard.py's CLI


class TestCliGuards:
    def test_tracker_shards_rejects_state_file(self, tmp_path, capsys):
        """--state-file must not be silently dropped when the sharded
        plane is selected — refuse loudly instead."""
        rc = main(["tracker", "--shards", "4", "--state-file", str(tmp_path / "x")])
        assert rc == 2
        assert "--state-file is not supported" in capsys.readouterr().err


# ------------------------------------------------- test_feed.py's CLI


class TestFeedCli:
    def test_cli_feed_once(self, tmp_path):
        """Real subprocess drive of `torrent-tpu feed --once --seen`."""
        from torrent_tpu_torch.codec.metainfo import parse_metainfo
        from torrent_tpu_torch.session.client import Client, ClientConfig

        from tests.test_torch_feed import _serve_routes

        async def prep():
            rng = np.random.default_rng(37)
            payload = rng.integers(0, 256, size=64 * 1024, dtype=np.uint8).tobytes()
            server, pump, announce_url = await start_tracker()
            meta_bytes = build_torrent_bytes(
                payload, 32768, announce_url.encode(), name=b"cli.bin"
            )
            meta = parse_metainfo(meta_bytes)
            base, shutdown = _serve_routes({"/cli.torrent": meta_bytes})
            return server, pump, base, shutdown, meta, payload

        async def go():
            server, pump, base, shutdown, meta, payload = await prep()
            base2, shutdown2 = _serve_routes(
                {
                    "/feed.xml": (
                        '<rss version="2.0"><channel><item><title>cli</title>'
                        f'<enclosure url="{base}/cli.torrent"/></item>'
                        "</channel></rss>"
                    ).encode(),
                }
            )
            seed = Client(ClientConfig(host="127.0.0.1", enable_upnp=False, hasher="cpu"))
            seed.config.torrent = fast_config()
            await seed.start()
            try:
                (tmp_path / "s2").mkdir()
                (tmp_path / "s2" / "cli.bin").write_bytes(payload)
                ts = await seed.add(meta, str(tmp_path / "s2"))
                assert ts.bitfield.complete
                (tmp_path / "d2").mkdir()
                seen_file = tmp_path / "seen.txt"
                r = await asyncio.to_thread(
                    subprocess.run,
                    [
                        sys.executable,
                        "-m",
                        "torrent_tpu_torch.tools.cli",
                        "feed",
                        f"{base2}/feed.xml",
                        str(tmp_path / "d2"),
                        "--once",
                        "--seen",
                        str(seen_file),
                        "--hasher",
                        "cpu",
                    ],
                    capture_output=True,
                    text=True,
                    cwd=REPO,
                    timeout=90,
                )
                assert r.returncode == 0, r.stderr
                assert "added: cli.bin" in r.stdout, r.stdout
                assert "cli.torrent" in seen_file.read_text()
                # atomic save: the temp file was replaced, not left behind
                assert not os.path.exists(str(seen_file) + ".tmp")
            finally:
                await seed.close()
                server.close()
                pump.cancel()
                shutdown()
                shutdown2()

        run(go(), timeout=120)


# --------------------------------------------------- test_obs.py's CLI


class TestTraceCli:
    def test_render_span_tree(self):
        from torrent_tpu_torch.obs.tracer import Tracer
        from torrent_tpu_torch.tools.cli import _render_span_tree

        t = Tracer()
        with t.span("root", trace_id="t-cli", route="/v1/verify"):
            with t.span("child"):
                pass
        out = _render_span_tree(t.trace_tree("t-cli"))
        assert "trace t-cli — 2 span(s)" in out
        assert "root" in out and "child" in out
        assert "route=/v1/verify" in out

    def test_dump_from_dir(self, tmp_path, capsys):
        (tmp_path / "blackbox_0001.json").write_text(
            json.dumps(
                {"seq": 1, "reason": "breaker_open", "detail": {"lane": "sha1/64"},
                 "recent_spans": [], "traces": {}}
            )
        )
        rc = main(["trace", "dump", "--dir", str(tmp_path)])
        assert rc == 0
        out = capsys.readouterr().out
        assert "breaker_open" in out and "sha1/64" in out

    def test_dump_from_dir_empty(self, tmp_path, capsys):
        rc = main(["trace", "dump", "--dir", str(tmp_path)])
        assert rc == 1


# ---------------------------------------------- test_timeline.py's CLI


class TestReplayCli:
    def test_replay_command_renders_and_exits_zero(self, tmp_path, capsys):
        from tests.test_torch_timeline import mk_sample

        samples = [
            mk_sample(t, h2d_busy=0.9 * t, h2d_bytes=10_000 * t,
                      verdict_bytes=1000 * t, verdict_ops=t, pieces=10 * t)
            for t in range(1, 5)
        ]
        path = tmp_path / "timeline.json"
        path.write_text(json.dumps({"samples": samples, "drops": 0}))
        rc = main(["replay", str(path), "--slo", "availability=0.999"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "h2d" in out and "overall:" in out
        assert "slo availability" in out
        # the reference renders the same replay to the same text
        assert ref_main(["replay", str(path), "--slo", "availability=0.999"]) == 0
        assert capsys.readouterr().out == out

    def test_replay_json_mode_and_missing_file(self, tmp_path, capsys):
        from tests.test_torch_timeline import mk_sample

        path = tmp_path / "t.json"
        path.write_text(json.dumps({"samples": [mk_sample(1), mk_sample(2)]}))
        rc = main(["replay", str(path), "--json"])
        out = capsys.readouterr().out
        assert rc == 0
        assert json.loads(out)["samples"] == 2
        assert main(["replay", str(tmp_path / "missing.json")]) == 2

    def test_replay_bad_slo_spec(self, tmp_path):
        path = tmp_path / "t.json"
        path.write_text("{}")
        assert main(["replay", str(path), "--slo", "nope=1"]) == 2


# ------------------------------------------------- test_fleet.py's CLI


class TestCliResultEmbedsFleet:
    def test_fabric_verify_result_carries_ledger_and_fleet(self, tmp_path):
        """The fabric-verify subcommand's result record embeds this
        process's ledger breakdown and its final fleet view."""
        from torrent_tpu_torch.tools.make_torrent import make_torrent

        from tests.test_torch_fleet import PLEN, make_library

        make_library(tmp_path, [12])
        tdir = tmp_path / "torrents"
        tdir.mkdir()
        (tdir / "lib0.torrent").write_bytes(
            make_torrent(
                str(tmp_path / "data" / "lib0" / "payload.bin"),
                "http://t.invalid/announce", piece_length=PLEN, hasher="cpu",
            )
        )
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        out = tmp_path / "result.json"
        proc = subprocess.run(
            [
                sys.executable, "-m", "torrent_tpu_torch", "fabric-verify",
                str(tdir), str(tmp_path / "data"), "--hasher", "cpu",
                "--unit-mb", "1", "--batch-target", "16",
                "--result-file", str(out),
            ],
            env=env, capture_output=True, text=True, timeout=240,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        rec = json.loads(out.read_text())
        assert rec["ledger"]["bottleneck"] is not None
        assert "read" in rec["ledger"]["stages"]
        fleet = rec["fleet"]
        assert fleet["nproc"] == 1 and fleet["reporting"] == 1
        assert fleet["scoreboard"][0]["pieces_verified"] == rec["n_pieces"]
        assert rec["sched"]["cpu_fallback_launches"] == 0


# ------------------------------------------------------------ differential


class Both:
    """Runs one argv through both packages' ``main`` in two directories
    that hold the same seeded files: ``{d}`` in an argument stands for
    the run's own directory. Returns ``(rc, stdout)`` of each, with the
    directory in stdout replaced by ``<dir>``."""

    def __init__(self, tmp_path, capsys):
        self.dirs = {"port": tmp_path / "port", "ref": tmp_path / "ref"}
        for d in self.dirs.values():
            d.mkdir()
        self.capsys = capsys

    def write(self, rel: str, data: bytes) -> None:
        for d in self.dirs.values():
            (d / rel).parent.mkdir(parents=True, exist_ok=True)
            (d / rel).write_bytes(data)

    def read(self, which: str, rel: str) -> bytes:
        return (self.dirs[which] / rel).read_bytes()

    def run(self, argv, ref_argv=None) -> tuple:
        self.capsys.readouterr()
        out = {}
        for which, fn, args in (
            ("port", main, argv),
            ("ref", ref_main, argv if ref_argv is None else ref_argv),
        ):
            d = str(self.dirs[which])
            rc = fn([a.replace("{d}", d) for a in args])
            out[which] = (rc, self.capsys.readouterr().out.replace(d, "<dir>"))
        return out["port"], out["ref"]

    def same(self, argv, ref_argv=None, rc=0) -> str:
        port, ref = self.run(argv, ref_argv)
        assert port == ref
        assert port[0] == rc, port
        return port[1]


@pytest.fixture
def both(tmp_path, capsys, monkeypatch):
    import time

    # v1 authoring stamps "creation date": one clock for both packages
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.0)
    b = Both(tmp_path, capsys)
    rng = np.random.default_rng(1011)
    b.write("tree/one.bin", rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes())
    b.write("tree/sub/two.bin", rng.integers(0, 256, 30_000, dtype=np.uint8).tobytes())
    b.write("tree/three.bin", rng.integers(0, 256, 1_234, dtype=np.uint8).tobytes())
    b.write("small.bin", rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes())
    return b


MAKE_VARIANTS = {
    "v1": [],
    "v2": ["--v2"],
    "hybrid": ["--hybrid"],
    "also-tracker": ["--also-tracker", "http://b.example/announce",
                     "--also-tracker", "udp://c.example:6969", "--private",
                     "--web-seed", "http://ws.example/", "--comment", "c"],
    "hints": ["--collection", "ds", "--update-url", "http://u.example/x",
              "--similar", "ab" * 20],
    "v2-hints": ["--v2", "--collection", "ds", "--update-url", "http://u.example/x"],
}


class TestDifferential:
    @pytest.mark.parametrize("variant", sorted(MAKE_VARIANTS))
    def test_make_info_magnet_verify(self, both, variant):
        """make → info → magnet → verify of a multi-file tree, hashlib on
        both sides: the same exit codes, stdout and torrent bytes."""
        extra = MAKE_VARIANTS[variant]
        out = both.same(["make", "{d}/tree", ANNOUNCE, "-o", "{d}/t.torrent",
                         "--piece-length", "16384", "--hasher", "cpu", *extra],
                        ["make", "{d}/tree", ANNOUNCE, "-o", "{d}/t.torrent",
                         "--piece-length", "16384", *extra])
        assert "wrote <dir>/t.torrent" in out
        assert both.read("port", "t.torrent") == both.read("ref", "t.torrent")
        both.same(["info", "{d}/t.torrent"])
        both.same(["magnet", "{d}/t.torrent", "--peer", "127.0.0.1:6881"])
        both.same(["magnet", "{d}/t.torrent", "--no-trackers"])
        out = both.same(["verify", "{d}/t.torrent", "{d}", "--hasher", "cpu"])
        assert "pieces valid" in out
        # one flipped byte: the same failing pieces, exit 2
        for d in both.dirs.values():
            blob = bytearray((d / "tree" / "sub" / "two.bin").read_bytes())
            blob[20_000] ^= 0xFF
            (d / "tree" / "sub" / "two.bin").write_bytes(bytes(blob))
        both.same(["verify", "{d}/t.torrent", "{d}", "--hasher", "cpu"], rc=2)

    def test_make_single_file_v1_and_v2(self, both):
        for extra in ([], ["--v2"], ["--hybrid"]):
            both.same(["make", "{d}/small.bin", ANNOUNCE, "-o", "{d}/s.torrent",
                       "--piece-length", "16384", "--hasher", "cpu", *extra],
                      ["make", "{d}/small.bin", ANNOUNCE, "-o", "{d}/s.torrent",
                       "--piece-length", "16384", *extra])
            assert both.read("port", "s.torrent") == both.read("ref", "s.torrent")
            both.same(["info", "{d}/s.torrent"])
            both.same(["verify", "{d}/s.torrent", "{d}", "--hasher", "cpu"])

    def test_verify_plain_sha1_against_reference_tpu_and_hashlib(self, both):
        """``verify --hasher gpu --device cpu`` (the port's plain PyTorch
        SHA-1) prints what the reference's ``--hasher tpu`` and both
        packages' hashlib print, clean and with one flipped byte, on two
        16 KiB pieces."""
        both.same(["make", "{d}/small.bin", ANNOUNCE, "-o", "{d}/s.torrent",
                   "--piece-length", "16384", "--hasher", "cpu"],
                  ["make", "{d}/small.bin", ANNOUNCE, "-o", "{d}/s.torrent",
                   "--piece-length", "16384"])
        gpu = ["verify", "{d}/s.torrent", "{d}", "--hasher", "gpu", "--device", "cpu",
               "--batch", "2"]
        tpu = ["verify", "{d}/s.torrent", "{d}", "--hasher", "tpu", "--batch", "2"]
        out = both.same(gpu, tpu)
        assert out == "2/2 pieces valid\n"
        assert both.same(["verify", "{d}/s.torrent", "{d}", "--hasher", "cpu"]) == out
        for d in both.dirs.values():
            blob = bytearray((d / "small.bin").read_bytes())
            blob[17_000] ^= 0x01
            (d / "small.bin").write_bytes(bytes(blob))
        out = both.same(gpu, tpu, rc=2)
        assert out == "1/2 pieces valid\nfirst invalid pieces: [1]\n"
        assert both.same(["verify", "{d}/s.torrent", "{d}", "--hasher", "cpu"], rc=2) == out

    def test_make_and_verify_v2_plain_sha256(self, both):
        """``make --v2`` and ``verify`` of a v2 torrent through the plain
        PyTorch SHA-256 and merkle (``--hasher gpu --device cpu``): the
        reference's hashlib bytes and text (two 16 KiB leaves)."""
        both.same(["make", "{d}/small.bin", ANNOUNCE, "-o", "{d}/v.torrent",
                   "--piece-length", "16384", "--v2", "--hasher", "gpu", "--device", "cpu"],
                  ["make", "{d}/small.bin", ANNOUNCE, "-o", "{d}/v.torrent",
                   "--piece-length", "16384", "--v2"])
        assert both.read("port", "v.torrent") == both.read("ref", "v.torrent")
        out = both.same(["verify", "{d}/v.torrent", "{d}", "--hasher", "gpu", "--device", "cpu"],
                        ["verify", "{d}/v.torrent", "{d}", "--hasher", "cpu"])
        assert out == "2/2 pieces valid (v2)\n"

    def test_make_v1_plain_sha1_equals_hashlib(self, both):
        both.same(["make", "{d}/small.bin", ANNOUNCE, "-o", "{d}/g.torrent",
                   "--piece-length", "16384", "--hasher", "gpu", "--device", "cpu"],
                  ["make", "{d}/small.bin", ANNOUNCE, "-o", "{d}/g.torrent",
                   "--piece-length", "16384"])
        assert both.read("port", "g.torrent") == both.read("ref", "g.torrent")

    def test_edit(self, both):
        both.same(["make", "{d}/tree", ANNOUNCE, "-o", "{d}/f.torrent",
                   "--piece-length", "16384", "--hasher", "cpu", "--comment", "c"],
                  ["make", "{d}/tree", ANNOUNCE, "-o", "{d}/f.torrent",
                   "--piece-length", "16384", "--comment", "c"])
        both.same(["edit", "{d}/f.torrent", "-o", "{d}/e.torrent",
                   "--tracker", "http://new.example/announce",
                   "--tracker", "http://backup.example/announce",
                   "--web-seed", "http://mirror.example/f", "--comment", "moved"])
        assert both.read("port", "e.torrent") == both.read("ref", "e.torrent")
        both.same(["edit", "{d}/e.torrent", "--clear-trackers", "--clear-web-seeds",
                   "--comment", ""])
        assert both.read("port", "e.torrent") == both.read("ref", "e.torrent")
        both.same(["info", "{d}/e.torrent"])
        both.same(["edit", "{d}/missing.torrent"], rc=1)

    def test_sign(self, both, monkeypatch):
        both.same(["make", "{d}/small.bin", ANNOUNCE, "-o", "{d}/s.torrent",
                   "--piece-length", "16384", "--hasher", "cpu"],
                  ["make", "{d}/small.bin", ANNOUNCE, "-o", "{d}/s.torrent",
                   "--piece-length", "16384"])
        monkeypatch.setattr(os, "urandom", lambda n: bytes(range(n)))
        both.same(["sign", "--keygen", "--key", "{d}/k.hex"])
        assert both.read("port", "k.hex") == both.read("ref", "k.hex")
        both.same(["sign", "--keygen", "--key", "{d}/k.hex"], rc=2)
        both.same(["sign", "{d}/s.torrent", "--key", "{d}/k.hex", "--signer", "alice",
                   "-o", "{d}/signed.torrent"])
        assert both.read("port", "signed.torrent") == both.read("ref", "signed.torrent")
        from torrent_tpu_torch.utils import ed25519

        pub = ed25519.publickey(bytes(range(32))).hex()
        both.same(["sign", "{d}/signed.torrent", "--check", "alice", "--pub", pub])
        both.same(["sign", "{d}/signed.torrent", "--check", "alice"], rc=2)
        both.same(["sign", "{d}/signed.torrent", "--check", "bob", "--pub", pub], rc=2)
        both.same(["info", "{d}/signed.torrent"])
        both.same(["sign", "{d}/s.torrent"], rc=2)

    def test_update(self, both):
        from torrent_tpu_torch.codec.bencode import bdecode, bencode

        from tests.test_torch_update import _serve_bytes

        both.same(["make", "{d}/small.bin", ANNOUNCE, "-o", "{d}/a.torrent",
                   "--piece-length", "16384", "--hasher", "cpu"],
                  ["make", "{d}/small.bin", ANNOUNCE, "-o", "{d}/a.torrent",
                   "--piece-length", "16384"])
        both.same(["make", "{d}/small.bin", ANNOUNCE, "-o", "{d}/b.torrent",
                   "--piece-length", "32768", "--hasher", "cpu"],
                  ["make", "{d}/small.bin", ANNOUNCE, "-o", "{d}/b.torrent",
                   "--piece-length", "32768"])
        successor = both.read("port", "b.torrent")
        url, shutdown = _serve_bytes(successor)
        try:
            top = bdecode(both.read("port", "a.torrent"))
            top[b"update-url"] = url.encode()
            both.write("u.torrent", bencode(top))
            both.same(["update", "{d}/u.torrent", "--check"])
            out = both.same(["update", "{d}/u.torrent"])
            assert "wrote <dir>/u.updated.torrent" in out
            assert both.read("port", "u.updated.torrent") == successor
            assert both.read("ref", "u.updated.torrent") == successor
            both.same(["update", "{d}/u.torrent", "--require-signed=x=zz"], rc=2)
            both.same(["update", "{d}/a.torrent"], rc=1)
        finally:
            shutdown()


# ------------------------------------------------------------------ parser


# the port's flags that the reference's parser has not, and the
# reference's that the port's has not, by subcommand
ADDED = {
    "make": {"--device"}, "verify": {"--device"}, "download": {"--device"},
    "seed": {"--device"}, "bridge": {"--device"}, "bench": {"--device"},
    "doctor": {"--device"}, "feed": {"--hasher", "--device"},
    # tools/fabric_verify.py: a torch.distributed rendezvous
    "fabric-verify": {"--device", "--init-method", "--backend"},
}
REMOVED = {"fabric-verify": {"--coordinator"}}


def _subcommands(parser) -> dict:
    import argparse

    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return dict(sub.choices)


def _flags(sp) -> dict:
    out = {}
    for a in sp._actions:
        if a.option_strings and "-h" not in a.option_strings:
            out[max(a.option_strings, key=len)] = a
        elif not a.option_strings:
            out[a.dest] = a
    return out


class TestParser:
    def test_same_subcommands_in_order(self):
        port, ref = _subcommands(build_parser()), _subcommands(ref_build_parser())
        assert list(port) == list(ref)
        assert len(port) == 21

    @pytest.mark.parametrize("cmd", list(_subcommands(ref_build_parser())))
    def test_same_flags_apart_from_the_divergences(self, cmd):
        port = _flags(_subcommands(build_parser())[cmd])
        ref = _flags(_subcommands(ref_build_parser())[cmd])
        assert set(port) - set(ref) == ADDED.get(cmd, set())
        assert set(ref) - set(port) == REMOVED.get(cmd, set())
        for name in set(port) & set(ref):
            p, r = port[name], ref[name]
            assert p.option_strings == r.option_strings, name
            assert type(p) is type(r), name
            if name == "--hasher":
                assert tuple(p.choices) == ("gpu", "cpu") and p.default == "gpu"
                assert set(r.choices) == {"cpu", "tpu"}
                continue
            assert (p.dest, p.default, p.choices, p.nargs, p.const, p.type) == (
                r.dest, r.default, r.choices, r.nargs, r.const, r.type
            ), name

    def test_every_hasher_has_a_device(self):
        for cmd, sp in _subcommands(build_parser()).items():
            flags = _flags(sp)
            if "--hasher" in flags:
                assert "--device" in flags and flags["--device"].default is None, cmd


# ------------------------------------------------------------- refusals


class TestRefusals:
    @pytest.mark.parametrize(
        "argv,module",
        [(["bench"], "torrent_tpu_torch.tools.bench_cli"),
         (["bench", "smoke", "--mb", "2"], "torrent_tpu_torch.tools.bench_cli"),
         (["lint"], "torrent_tpu_torch.analysis"),
         (["lint", "--json", "--no-baseline"], "torrent_tpu_torch.analysis")],
    )
    def test_unported_subcommands_exit_2_with_one_line(self, argv, module, capsys, monkeypatch, tmp_path):
        """The two subcommands that were once unported. ``lint`` runs
        ``module``'s gate: exit 0 with "0 new, 0 stale" against the
        committed baseline, and with ``--no-baseline`` exit 1 with every
        baselined finding listed as new. ``bench`` with no rung exits 2
        with the reference's usage error (one line), and ``bench smoke``
        delegates to ``module`` and prints one banked-schema record."""
        if module.endswith("bench_cli"):
            import importlib

            bench_cli = importlib.import_module(module)
            calls = []
            real = bench_cli.main
            monkeypatch.setattr(bench_cli, "main", lambda a: calls.append(a) or real(a))
            monkeypatch.setenv("TORRENT_TPU_BENCH_TRAJECTORY", str(tmp_path / "traj.json"))
            rc = main(argv)
            cap = capsys.readouterr()
            assert len(calls) == 1 and calls[0][: len(argv) - 1] == argv[1:]
            if len(argv) == 1:
                assert rc == 2 and cap.out == ""
                lines = cap.err.strip().splitlines()
                assert len(lines) == 1 and lines[0].startswith("error: name a rung")
            else:
                assert rc == 0
                rec = json.loads(cap.out.strip())
                assert rec["schema"] == "torrent-tpu-bench/1" and rec["rung"] == "smoke"
                assert rec["value"] is not None and rec["bytes"] == 2 << 20
            return
        from torrent_tpu_torch.analysis.findings import load_baseline
        from torrent_tpu_torch.analysis.lint import default_baseline, default_root

        baseline = load_baseline(default_baseline(default_root()))
        rc = main(argv)
        cap = capsys.readouterr()
        if argv == ["lint"]:
            assert rc == 0, cap.out
            assert "0 new, 0 stale" in cap.out
            return
        assert rc == 1
        report = json.loads(cap.out)
        assert not report["ok"] and report["baselined"] == []
        keys = {
            f"{f['pass_name']}::{f['path']}::{f['symbol']}::{f['message']}"
            for f in report["new"]
        }
        assert keys == set(baseline)

    def test_lint_fails_on_a_seeded_fixture(self, tmp_path, capsys):
        """A new finding in the linted package fails the gate: exit 1 and
        a NEW line naming it."""
        pkg = tmp_path / "pkg" / "bridge"
        pkg.mkdir(parents=True)
        (pkg / "mod.py").write_text("import time\n\nasync def bad():\n    time.sleep(1)\n")
        rc = main(["lint", "--root", str(tmp_path / "pkg"),
                   "--baseline", str(tmp_path / "none.json")])
        out = capsys.readouterr().out
        assert rc == 1
        assert "NEW  pkg/bridge/mod.py:4: [blocking-in-async] blocking call time.sleep" in out

    def test_default_gpu_hasher_without_cuda_is_an_error(self, both, capsys):
        if torch.cuda.is_available():
            pytest.skip("the default hasher runs on this host's CUDA card")
        both.same(["make", "{d}/small.bin", ANNOUNCE, "-o", "{d}/s.torrent",
                   "--piece-length", "16384", "--hasher", "cpu"],
                  ["make", "{d}/small.bin", ANNOUNCE, "-o", "{d}/s.torrent",
                   "--piece-length", "16384"])
        d = str(both.dirs["port"])
        for argv in (
            ["verify", f"{d}/s.torrent", d],
            ["make", f"{d}/small.bin", ANNOUNCE, "-o", f"{d}/x.torrent"],
            ["make", f"{d}/small.bin", ANNOUNCE, "-o", f"{d}/x.torrent", "--v2"],
            ["download", f"{d}/s.torrent", d, "--no-resume"],
        ):
            capsys.readouterr()
            assert main(argv) == 1, argv
            cap = capsys.readouterr()
            assert "torch.cuda.is_available() is False" in cap.err
            assert "valid" not in cap.out and "wrote" not in cap.out
        assert not os.path.exists(f"{d}/x.torrent")

    def test_verify_subprocess_without_cuda_prints_no_bitfield(self, both):
        if torch.cuda.is_available():
            pytest.skip("the default hasher runs on this host's CUDA card")
        both.same(["make", "{d}/small.bin", ANNOUNCE, "-o", "{d}/s.torrent",
                   "--piece-length", "16384", "--hasher", "cpu"],
                  ["make", "{d}/small.bin", ANNOUNCE, "-o", "{d}/s.torrent",
                   "--piece-length", "16384"])
        d = str(both.dirs["port"])
        proc = subprocess.run(
            [sys.executable, "-m", "torrent_tpu_torch", "verify", f"{d}/s.torrent", d],
            cwd=REPO, capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 1
        assert proc.stdout == ""
        assert proc.stderr.startswith("error: CUDA device requested")
        assert "Traceback" not in proc.stderr


# ------------------------------------------------------------ entry point


def test_entry_point_help_loads_no_jax():
    """``python -m torrent_tpu_torch --help`` in a fresh interpreter exits
    0 and imports nothing of jax or the reference (``-X importtime``
    lists every module the interpreter imported)."""
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "torrent_tpu_torch", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("usage: torrent-tpu")
    for sub in ("make", "verify", "doctor", "fabric-verify", "bench", "lint"):
        assert sub in proc.stdout
    modules = {
        line.rsplit("|", 1)[-1].strip()
        for line in proc.stderr.splitlines()
        if line.startswith("import time:") and "|" in line
    }
    assert "torrent_tpu_torch.tools.cli" in modules
    leaked = sorted(m for m in modules if m.split(".")[0] in ("jax", "jaxlib", "torrent_tpu"))
    assert leaked == []
