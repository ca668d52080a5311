"""The port's device grid (torrent_tpu_torch/parallel/mesh.py) held
against the reference's ``(hosts, dp)`` mesh on this host's 8 virtual JAX
CPU devices (tests/conftest.py).

A grid of ``cpu`` entries stands for a host's cards: each entry hashes
its block of every batch with the plain PyTorch SHA-1, as each virtual
device runs the reference's kernel on its shard. Digests, bitfields,
counts and ``.torrent`` bytes must equal the reference's and hashlib's
bit for bit. Pieces stay at 1 KiB and batches at 64 rows or fewer: the
plain SHA-1 costs milliseconds a 64-byte block.

The two-rank case runs this file as a script (the rank worker at the
bottom), as tests/test_torch_distributed.py does.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from torrent_tpu.codec.metainfo import InfoDict as RefInfoDict
from torrent_tpu.models.verifier import TPUVerifier
from torrent_tpu.parallel.mesh import batch_sharding, make_mesh as ref_make_mesh
from torrent_tpu.storage.storage import MemoryStorage as RefMemoryStorage
from torrent_tpu.storage.storage import Storage as RefStorage
from torrent_tpu_torch.codec.metainfo import FileEntry, InfoDict
from torrent_tpu_torch.models.verifier import GPUVerifier
from torrent_tpu_torch.ops.padding import digests_to_words, pad_pieces
from torrent_tpu_torch.ops.sha1_torch import words_to_numpy
from torrent_tpu_torch.parallel import distributed
from torrent_tpu_torch.parallel.mesh import GridDevice, make_mesh, row_blocks
from torrent_tpu_torch.storage.storage import MemoryStorage, Storage
from torrent_tpu_torch.utils.device import DeviceUnavailable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8
PLEN = 1024


def ref_mesh(n_hosts=None):
    return ref_make_mesh(jax.devices(), n_hosts=n_hosts)


def build(length, plen=PLEN, files=None, seed=0):
    """The same seeded payload in both packages' storages:
    ``(info, storage, ref_info, ref_storage, payload)``."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, size=length, dtype=np.uint8).tobytes()
    pieces = tuple(hashlib.sha1(payload[i : i + plen]).digest() for i in range(0, length, plen))
    info = InfoDict(name="v", piece_length=plen, pieces=pieces, length=length, files=files)
    ref_files = None
    if files is not None:
        from torrent_tpu.codec.metainfo import FileEntry as RefFileEntry

        ref_files = tuple(RefFileEntry(length=f.length, path=f.path) for f in files)
    ref_info = RefInfoDict(name="v", piece_length=plen, pieces=pieces, length=length, files=ref_files)
    storage = Storage(MemoryStorage(), info)
    storage.set(0, payload)
    ref_storage = RefStorage(RefMemoryStorage(), ref_info)
    ref_storage.set(0, payload)
    return info, storage, ref_info, ref_storage, payload


def hashlib_bits(payload: bytes, info) -> np.ndarray:
    plen = info.piece_length
    return np.array(
        [hashlib.sha1(payload[i * plen : (i + 1) * plen]).digest() == info.pieces[i] for i in range(info.num_pieces)]
    )


# ------------------------------------------------------------ make_mesh


class TestMakeMesh:
    @pytest.mark.parametrize("n_hosts", [None, 1, 2, 4, 8])
    def test_shape_matches_reference(self, n_hosts):
        ref = ref_mesh(n_hosts)
        grid = make_mesh(CPU8, n_hosts=n_hosts)
        assert grid.shape == dict(ref.shape)
        assert grid.axis_names == tuple(ref.axis_names)
        assert grid.size == ref.size == 8
        assert grid.process_span() == 1

    @pytest.mark.parametrize(
        "case",
        [
            ("devices", 3, 2),
            ("devices", 8, 3),
            ("devices", 6, 4),
            ("spread", (0, 0, 1), 2),
            ("spread", (0, 1, 1, 1), 2),
            ("spread", (1, 1), 2),
            ("spread", (0, 0, 1, 1, 2), 3),
        ],
    )
    def test_errors_match_reference(self, case, monkeypatch):
        """``devices.size % n_hosts`` and the even spread of a
        multi-process grid: the same ValueError, message for message."""
        kind, arg, n_hosts = case
        if kind == "devices":
            with pytest.raises(ValueError) as ref_err:
                ref_make_mesh(jax.devices()[:arg], n_hosts=n_hosts)
            with pytest.raises(ValueError) as port_err:
                make_mesh(["cpu"] * arg, n_hosts=n_hosts)
        else:
            monkeypatch.setattr(jax, "process_count", lambda: n_hosts)
            monkeypatch.setattr(distributed, "world", lambda: (n_hosts, 0))
            with pytest.raises(ValueError, match="evenly") as ref_err:
                ref_make_mesh([types.SimpleNamespace(process_index=p) for p in arg], n_hosts=n_hosts)
            with pytest.raises(ValueError, match="evenly") as port_err:
                make_mesh([GridDevice(p, torch.device("cpu")) for p in arg], n_hosts=n_hosts)
        assert str(port_err.value) == str(ref_err.value)

    @pytest.mark.parametrize("n_hosts,batch", [(1, 16), (2, 16), (2, 24), (4, 64)])
    def test_row_blocks_are_batch_sharding(self, n_hosts, batch):
        """Entry d of the flattened grid holds the rows the reference's
        ``batch_sharding`` puts on device d of ``mesh.devices.flat``."""
        ref = ref_mesh(n_hosts)
        arr = jax.device_put(np.arange(batch), batch_sharding(ref))
        flat = list(ref.devices.flat)
        shards = sorted(arr.addressable_shards, key=lambda s: flat.index(s.device))
        want = [(s.index[0].start or 0, batch if s.index[0].stop is None else s.index[0].stop) for s in shards]
        got = [(lo, hi) for _, _, lo, hi in row_blocks(make_mesh(CPU8, n_hosts=n_hosts), batch)]
        assert got == want

    def test_row_blocks_need_a_multiple_of_the_grid(self):
        with pytest.raises(ValueError, match="not divisible"):
            row_blocks(make_mesh(CPU8), 12)

    def test_no_device_means_cuda(self):
        """The default grid is every card of the process; this host has
        none, and nothing falls back to the CPU."""
        if torch.cuda.is_available():
            pytest.skip("this host has a card")
        with pytest.raises(DeviceUnavailable):
            make_mesh()
        with pytest.raises(DeviceUnavailable):
            GPUVerifier(piece_length=64)

    def test_one_grid_argument_at_most(self):
        with pytest.raises(ValueError, match="at most one"):
            GPUVerifier(piece_length=64, device="cpu", devices=["cpu"])

    def test_entries_of_a_multi_process_grid(self, monkeypatch):
        """In a two-rank group plain devices are this rank's row and stand
        for every rank's; named entries keep their owners; a rank hashes
        on its own row."""
        monkeypatch.setattr(distributed, "world", lambda: (2, 1))
        grid = make_mesh(["cpu", "cpu"])
        assert grid.shape == {"hosts": 2, "dp": 2} and grid.process_span() == 2
        assert grid.processes.tolist() == [[0, 0], [1, 1]]
        local = grid.local()
        assert local.shape == {"hosts": 1, "dp": 2} and set(local.processes.flat) == {1}
        named = make_mesh([GridDevice(p, torch.device("cpu")) for p in (1, 0, 1, 0)])
        assert named.processes.tolist() == [[0, 0], [1, 1]]
        assert make_mesh(["cpu", "cpu"], n_hosts=1).process_span() == 1
        with pytest.raises(ValueError, match="no entry on rank 1"):
            make_mesh([GridDevice(0, torch.device("cpu"))], n_hosts=1).local()


@pytest.mark.parametrize(
    "local_rank,local_ranks,cards,want",
    [
        (0, 1, 8, list(range(8))),  # one rank a host takes every card
        (1, 2, 8, [4, 5, 6, 7]),
        (3, 8, 8, [3]),  # torchrun's one rank a card
        (2, 3, 8, [4, 5]),  # an even share; the rest stay idle
        (1, 2, 1, [0]),  # gloo ranks sharing the one card
    ],
)
def test_rank_cards_divide_a_host(local_rank, local_ranks, cards, want):
    from torrent_tpu_torch.parallel.distributed import rank_cards

    assert rank_cards(local_rank, local_ranks, cards) == [torch.device("cuda", i) for i in want]


# -------------------------------------------------------------- verifier


class TestVerifierAgainstReference:
    @pytest.mark.parametrize("batch", [1, 5, 9, 16, 17])
    @pytest.mark.parametrize("n_hosts", [1, 2])
    def test_batch_rounds_to_grid_multiple(self, batch, n_hosts):
        ref = TPUVerifier(piece_length=64, batch_size=batch, mesh=ref_mesh(n_hosts))
        port = GPUVerifier(piece_length=64, batch_size=batch, mesh=make_mesh(CPU8, n_hosts=n_hosts))
        assert port.batch_size == ref.batch_size and port.batch_size % 8 == 0
        assert GPUVerifier(piece_length=64, batch_size=batch, devices=["cpu"] * 3).batch_size % 3 == 0

    def test_hash_pieces_and_digest_batch(self):
        rng = np.random.default_rng(3)
        pieces = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in (0, 1, 55, 64, 500, 1000, 1024) * 3]
        ref = TPUVerifier(piece_length=PLEN, batch_size=16, mesh=ref_mesh())
        port = GPUVerifier(piece_length=PLEN, batch_size=16, devices=CPU8)
        want = [hashlib.sha1(p).digest() for p in pieces]
        assert port.hash_pieces(pieces) == ref.hash_pieces(pieces) == want
        padded, nblocks = pad_pieces(pieces[:16])
        words = port.digest_batch(padded, nblocks)
        assert (words == np.asarray(ref.digest_batch(padded, nblocks))).all()
        assert (words == digests_to_words(want[:16])).all()
        assert port.hash_bytes(pieces[5]) == want[5]

    def test_ragged_batch_takes_sentinel_rows(self):
        """A batch whose rows do not split over the grid is padded with
        sentinel rows, and only its own rows come back."""
        rng = np.random.default_rng(4)
        pieces = [rng.bytes(n) for n in (10, 700, 64, 0, 333)]
        padded, nblocks = pad_pieces(pieces)
        expected = digests_to_words([hashlib.sha1(p).digest() for p in pieces])
        port = GPUVerifier(piece_length=PLEN, batch_size=8, devices=["cpu"] * 4)
        assert (port.digest_batch(padded, nblocks) == expected).all()
        expected[1, 0] ^= 1
        assert port.verify_batch(padded, nblocks, expected).tolist() == [True, False, True, True, True]
        assert port.upload_batch(padded) is None  # 5 rows do not split over 4 entries

    def test_upload_handle_is_per_entry(self):
        rng = np.random.default_rng(5)
        pieces = [rng.bytes(300) for _ in range(8)]
        padded, nblocks = pad_pieces(pieces)
        port = GPUVerifier(piece_length=PLEN, batch_size=8, devices=["cpu"] * 4)
        handle = port.upload_batch(padded)
        assert [h.shape[0] for h in handle] == [2, 2, 2, 2]
        padded[:] = 0  # the staging buffer is free once upload_batch returns
        words = port.digest_uploaded(handle, nblocks)
        assert len(words) == 4
        assert (words_to_numpy(words) == digests_to_words([hashlib.sha1(p).digest() for p in pieces])).all()

    @pytest.mark.parametrize("n_hosts", [1, 2])
    def test_verify_storage_ragged_last_batch(self, n_hosts):
        """40 pieces at batch 16: batches of 16, 16 and a ragged 8 (the
        last piece short), one corrupt piece in the second."""
        info, storage, ref_info, ref_storage, payload = build(39 * PLEN + 700, seed=6)
        storage.method.set(("v",), 20 * PLEN + 5, b"\x00BAD\x00")
        ref_storage.method.set(("v",), 20 * PLEN + 5, b"\x00BAD\x00")
        ref = TPUVerifier(piece_length=PLEN, batch_size=16, mesh=ref_mesh(n_hosts))
        port = GPUVerifier(piece_length=PLEN, batch_size=16, mesh=make_mesh(CPU8, n_hosts=n_hosts))
        want = np.asarray(ref.verify_storage(ref_storage, ref_info))
        got = port.verify_storage(storage, info, io_threads=2)
        assert (got == want).all() and list(np.nonzero(~got)[0]) == [20]
        assert port.last_result.n_valid == ref.last_result.n_valid == info.num_pieces - 1

    def test_verify_storage_multi_file(self):
        files = (
            FileEntry(length=5 * PLEN + 100, path=("a",)),
            FileEntry(length=9 * PLEN + 333, path=("b", "c")),
            FileEntry(length=2 * PLEN + 7, path=("d",)),
        )
        length = sum(f.length for f in files)
        info, storage, ref_info, ref_storage, payload = build(length, files=files, seed=7)
        off = files[0].length + 3 * PLEN  # inside b/c
        storage.set(off, bytes([payload[off] ^ 0xFF]))
        ref_storage.set(off, bytes([payload[off] ^ 0xFF]))
        from torrent_tpu.parallel.verify import verify_pieces as ref_verify_pieces
        from torrent_tpu_torch.parallel.verify import verify_pieces

        want = np.asarray(ref_verify_pieces(ref_storage, ref_info, hasher="tpu", batch_size=16, mesh=ref_mesh()))
        got = verify_pieces(storage, info, hasher="gpu", batch_size=16, devices=CPU8)
        assert (got == want).all()
        assert list(np.nonzero(~got)[0]) == [off // PLEN]


# ----------------------------------------------------- the default grid


@pytest.fixture
def cpu_cards(monkeypatch):
    """A process whose cards are four ``cpu`` entries: the default grid
    (no device, devices or mesh) of every construction site is then
    those four."""
    monkeypatch.setattr(distributed, "local_devices", lambda: [torch.device("cpu")] * 4)


class TestDefaultGrid:
    def test_sites_take_the_default_grid(self, cpu_cards):
        """With no device, devices or mesh, every SHA-1 construction site
        hashes on every card of the process."""
        from torrent_tpu_torch.models import v2 as v2_mod
        from torrent_tpu_torch.sched import HashPlaneScheduler
        from torrent_tpu_torch.session.client import Client, ClientConfig
        from torrent_tpu_torch.tools.make_torrent import _Hasher

        grid = {"hosts": 1, "dp": 4}
        assert GPUVerifier(piece_length=PLEN).mesh.shape == grid
        assert make_mesh().size == 4
        assert Client(ClientConfig(hasher="gpu"))._verifier_for(PLEN).mesh.shape == grid
        hasher = _Hasher(hasher="gpu", piece_length=PLEN)
        assert hasher.digests(iter([b"abc"])) == [hashlib.sha1(b"abc").digest()]
        assert hasher._verifier.mesh.shape == grid
        v2_mod._piece_verifier.cache_clear()
        try:
            assert v2_mod._piece_verifier(PLEN, None).mesh.shape == grid
        finally:
            v2_mod._piece_verifier.cache_clear()
        assert HashPlaneScheduler(hasher="gpu").mesh.shape == grid

    def test_make_torrent_bytes(self, cpu_cards, tmp_path, monkeypatch):
        import time

        from torrent_tpu.tools.make_torrent import make_torrent as ref_make_torrent
        from torrent_tpu_torch.tools.make_torrent import make_torrent

        rng = np.random.default_rng(8)
        root = tmp_path / "payload"
        (root / "sub").mkdir(parents=True)
        for rel, size in (("a.bin", 3 * PLEN + 17), ("sub/b.bin", 5 * PLEN), ("z.bin", 700)):
            (root / rel).write_bytes(rng.bytes(size))
        # v1 authoring stamps "creation date": one clock for both packages
        monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
        ref = ref_make_torrent(str(root), "http://t.invalid/a", piece_length=PLEN, hasher="tpu")
        port = make_torrent(str(root), "http://t.invalid/a", piece_length=PLEN, hasher="gpu")
        cpu = make_torrent(str(root), "http://t.invalid/a", piece_length=PLEN, hasher="cpu")
        assert port == ref == cpu

    def test_scheduler_sweep_on_a_grid(self, cpu_cards):
        import asyncio

        from torrent_tpu_torch.parallel.verify import verify_pieces_sched
        from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig

        info, storage, ref_info, ref_storage, payload = build(29 * PLEN + 5, seed=9)
        storage.method.set(("v",), 11 * PLEN, b"!")

        async def go():
            sched = await HashPlaneScheduler(SchedulerConfig(batch_target=10, flush_deadline=0.01), hasher="gpu").start()
            try:
                assert sched.mesh.size == 4
                bf = await verify_pieces_sched(storage, info, sched)
                snap = sched.metrics_snapshot()
                return bf, snap
            finally:
                await sched.close()

        bf, snap = asyncio.run(go())
        want = hashlib_bits(payload, info)
        want[11] = False
        assert (bf == want).all()
        assert snap["launches"] > 0 and snap["cpu_fallback_launches"] == 0
        assert snap["staging"]["outstanding"] == 0

    def test_grid_plane_rounds_launches_to_the_grid(self, cpu_cards):
        from torrent_tpu_torch.sched.scheduler import build_builtin_plane

        plane = build_builtin_plane("gpu", "sha1", 1024, 10)
        assert len(plane.devices) == 4 and plane._slots.rows == 12
        assert plane.launch_geometry(5, 1024)[0] == 8
        pieces = [bytes([i]) * (100 + i) for i in range(7)]
        assert plane.run(pieces) == [hashlib.sha1(p).digest() for p in pieces]


# ---------------------------------------------------------------- CLI


def test_fabric_verify_cpu_devices(tmp_path, capsys):
    """``--cpu-devices K``: the scheduler's SHA-1 planes span K cpu
    entries; without ``--device cpu`` it is one error line and exit 1."""
    from torrent_tpu_torch.tools import fabric_verify, make_torrent

    data = tmp_path / "data"
    data.mkdir()
    (data / "t.bin").write_bytes(np.random.default_rng(10).bytes(6 * PLEN + 9))
    (tmp_path / "t.torrent").write_bytes(
        make_torrent.make_torrent(str(data / "t.bin"), "http://t.invalid/a", piece_length=PLEN, hasher="cpu")
    )
    out = tmp_path / "result.json"
    rc = fabric_verify.main(
        [str(tmp_path), str(data), "--device", "cpu", "--cpu-devices", "2", "--batch-target", "4",
         "--result-file", str(out)]
    )
    rec = json.loads(out.read_text())
    assert rc == 0 and rec["n_valid"] == rec["n_pieces"] == 7
    assert rec["sched"]["grid"] == {"hosts": 1, "dp": 2}
    capsys.readouterr()
    assert fabric_verify.main([str(tmp_path), str(data), "--cpu-devices", "2"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert err == ["error: --cpu-devices needs --device cpu"]


# --------------------------------------------------------------- dry run


def test_dryrun_multichip_matches_reference():
    """``entry.dryrun_multichip(8, device="cpu")`` prints the reference's
    line (run in its own interpreter: the reference's dry run resets
    JAX's backends) and its leaves and roots equal the reference's
    sharded SHA-256 and fused merkle on the same inputs."""
    import jax.numpy as jnp

    from torrent_tpu.models.merkle import _merkle_reduce_fused, words32_to_digests
    from torrent_tpu.ops.sha256_jax import sha256_pieces_jax
    from torrent_tpu_torch.entry import dryrun_multichip

    ref = subprocess.run(
        [sys.executable, "-c", "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert ref.returncode == 0, ref.stderr[-3000:]
    ref_line = [ln for ln in ref.stdout.splitlines() if ln.startswith("dryrun_multichip OK")]

    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = dryrun_multichip(8, device="cpu")
    assert buf.getvalue().splitlines() == ref_line
    assert got["mesh"] == {"hosts": 2, "dp": 4} and got["valid"] == 15 and got["batch"] == 16

    rng = np.random.default_rng(7)  # the dry runs' leaves, drawn the same way
    leaves = [rng.integers(0, 256, size=160, dtype=np.uint8).tobytes() for _ in range(16)]
    padded, nblocks = pad_pieces(leaves)
    words = np.asarray(sha256_pieces_jax(padded, nblocks))
    assert got["leaves"] == [b"".join(int(w).to_bytes(4, "big") for w in row) for row in words]
    ref_roots = words32_to_digests(np.asarray(_merkle_reduce_fused(jnp.asarray(got["trees"]), 3)))
    assert got["roots"] == list(ref_roots)


# ------------------------------------------------------- two ranks, 2 x 2


def test_two_ranks_with_two_entries_each(tmp_path):
    """The reference's ``(hosts, dp)`` layout across processes: two gloo
    ranks of two cpu entries each, a ``(2, 2)`` grid. Each rank reads the
    reference's rows of every global batch and hashes them in two blocks;
    both return the bitfield of hashlib and of the reference's
    single-process recheck on a ``(2, 2)`` mesh, and the count."""
    from tests.test_torch_distributed import bits, free_port, make_multi, run_ranks, v1_layout

    from torrent_tpu.codec.metainfo import parse_metainfo as ref_parse
    from torrent_tpu.parallel.verify import verify_pieces as ref_verify_pieces
    from torrent_tpu.storage.storage import FsStorage as RefFsStorage

    workdir, payload, torrent, info, root = make_multi(tmp_path, [7 * 4096 + 100, 9 * 4096 + 2000], seed=12)
    n = info.num_pieces
    f1 = payload / "f1.bin"
    buf = bytearray(f1.read_bytes())
    buf[4096 * 3 + 9] ^= 0xFF  # piece 10 of the torrent
    f1.write_bytes(bytes(buf))
    blob = b"".join((payload / f"f{i}.bin").read_bytes() for i in range(2))
    expected = bits(hashlib.sha1(blob[i * 4096 : (i + 1) * 4096]).digest() == info.pieces[i] for i in range(n))
    assert expected.count("0") == 1
    ref_info = ref_parse(torrent.read_bytes()).info
    ref_mesh4 = ref_make_mesh(jax.devices()[:4], n_hosts=2)
    ref = bits(ref_verify_pieces(RefStorage(RefFsStorage(str(root)), ref_info), ref_info, hasher="tpu", batch_size=8, mesh=ref_mesh4))
    assert ref == expected

    init = f"tcp://127.0.0.1:{free_port()}"
    outs = run_ranks(
        [[sys.executable, os.path.abspath(__file__), init, "2", str(r), str(workdir), str(torrent)] for r in range(2)],
        workdir,
    )
    for rank, rec in enumerate(outs):
        assert rec["grid"] == {"hosts": 2, "dp": 2} and rec["local"] == {"hosts": 1, "dp": 2}
        assert rec["bitfield"] == rec["routed"] == expected
        assert rec["local_bitfield"] == expected  # local=True: the rank's own grid, the whole torrent
        assert rec["n_valid"] == n - 1
        assert rec["rows"] == v1_layout(rank, 2, 8, n)
        # every global batch: one launch an entry, 2 rows each
        assert rec["launch_rows"] == [2] * (2 * -(-n // 8))


def _rank_main(argv) -> None:
    init, nproc, rank, workdir, torrent = argv
    nproc, rank = int(nproc), int(rank)
    sys.path.insert(0, REPO)
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.ops import sha1_cuda
    from torrent_tpu_torch.parallel import distributed as D
    from torrent_tpu_torch.parallel.mesh import spanning_grid
    from torrent_tpu_torch.parallel.verify import verify_pieces
    from torrent_tpu_torch.storage.storage import FsStorage, Storage

    D.initialize(init, nproc, rank, backend="gloo", device="cpu", timeout=240)
    launch_rows: list = []
    plain = sha1_cuda.sha1_pieces_cuda

    def counted(data, nblocks):
        launch_rows.append(int(data.shape[0]))
        return plain(data, nblocks)

    sha1_cuda.sha1_pieces_cuda = counted  # make_sha1_fn hands this out
    try:
        with open(torrent, "rb") as f:
            info = parse_metainfo(f.read()).info
        entries = ["cpu", "cpu"]
        rows: list = []
        storage = Storage(FsStorage(workdir), info)
        read_batch = storage.read_batch

        def recorded(idxs, *args, **kwargs):
            rows.extend(int(i) for i in idxs)
            return read_batch(idxs, *args, **kwargs)

        storage.read_batch = recorded
        bf, n_valid = D.verify_storage_distributed(storage, info, batch_size=8, devices=entries, io_threads=1)
        counted_rows = list(launch_rows)
        storage.read_batch = read_batch
        routed = verify_pieces(storage, info, hasher="gpu", devices=entries, batch_size=8, io_threads=1)
        local = verify_pieces(storage, info, hasher="gpu", devices=entries, batch_size=8, local=True)
        grid = spanning_grid(devices=entries)
        out = {
            "grid": grid.shape, "local": grid.local().shape,
            "bitfield": "".join("1" if b else "0" for b in bf),
            "routed": "".join("1" if b else "0" for b in routed),
            "local_bitfield": "".join("1" if b else "0" for b in local),
            "n_valid": int(n_valid), "rows": rows, "launch_rows": counted_rows,
        }
        path = os.path.join(workdir, f"result_{rank}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(out, f)
        os.replace(path + ".tmp", path)
    finally:
        D.shutdown()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
