"""The port's multi-process routes (torrent_tpu_torch/parallel/distributed.py),
proven with real rank processes over gloo on the CPU.

The counterpart of tests/test_distributed.py. Each test spawns ``nproc``
fresh interpreters running this file as a script (the rank worker at the
bottom); they join a ``torch.distributed`` group over ``gloo`` at a free
localhost port with ``device="cpu"``, so the port's plain PyTorch planes
hash. Results come back through files under ``tmp_path``: gloo may log
to stdout from C++ while Python prints. One rank failing leaves its peers
blocked in a collective, so every handle is killed on any error path.

Every bitfield must equal hashlib's and the reference's single-process
``verify_pieces(hasher="tpu")`` on JAX's CPU, on the same files; every
rank must return the same bitfield and ``n_valid == popcount``; and each
rank must read the reference's rows: pieces ``[g*B + p*L, g*B + (p+1)*L)``
of global batch ``g`` (v1), or its round-robin stride (v2, library).
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLEN = 4096
CPU = "cpu"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_ranks(argvs, workdir, timeout=300) -> list:
    """Start one process per argv, wait for all, and return each rank's
    ``result_<rank>.json``; kill every rank if any fails."""
    procs = [
        subprocess.Popen(argv, env=worker_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for argv in argvs
    ]
    outs = []
    try:
        for rank, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {rank} failed:\n{err[-3000:]}"
            outs.append(json.loads((workdir / f"result_{rank}.json").read_text()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def spawn(workdir, nproc: int, mode: str, torrent="-", batch: int = 8, device: str = CPU, backend: str = "gloo") -> list:
    """Run ``nproc`` ranks of this file's worker; ``device="cuda"`` puts
    every rank on the card (``cuda:(rank % device_count)``)."""
    init = f"tcp://127.0.0.1:{free_port()}"
    return run_ranks(
        [
            [sys.executable, os.path.abspath(__file__), init, str(nproc), str(r), str(workdir), mode,
             str(torrent), str(batch), device, backend]
            for r in range(nproc)
        ],
        workdir,
    )


def bits(bf) -> str:
    return "".join("1" if b else "0" for b in bf)


def v1_layout(rank: int, nproc: int, batch: int, n: int) -> list:
    """The pieces rank ``rank`` reads under the reference's row layout."""
    local = batch // nproc
    rows = []
    for g in range(-(-n // batch)):
        lo = g * batch + rank * local
        rows.extend(range(lo, min(lo + local, n)))
    return rows


def ref_bitfield(root, torrent_bytes: bytes) -> str:
    """The reference's single-process device recheck on JAX's CPU."""
    from torrent_tpu.codec.metainfo import parse_metainfo
    from torrent_tpu.parallel.verify import verify_pieces
    from torrent_tpu.storage.storage import FsStorage, Storage

    info = parse_metainfo(torrent_bytes).info
    return bits(verify_pieces(Storage(FsStorage(str(root)), info), info, hasher="tpu", batch_size=8))


def make_multi(tmp_path, sizes, seed, name="payload"):
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.tools.make_torrent import make_torrent

    rng = np.random.default_rng(seed)
    workdir = tmp_path / "data"
    payload = workdir / name
    payload.mkdir(parents=True)
    for i, size in enumerate(sizes):
        (payload / f"f{i}.bin").write_bytes(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    torrent = tmp_path / f"{name}.torrent"
    target = payload if len(sizes) > 1 else payload / "f0.bin"
    torrent.write_bytes(make_torrent(str(target), "http://t.invalid/announce", piece_length=PLEN, hasher="cpu"))
    root = workdir if len(sizes) > 1 else payload
    return workdir, payload, torrent, parse_metainfo(torrent.read_bytes()).info, root


def test_nccl_with_more_ranks_than_devices_raises(monkeypatch):
    """The counterpart of make_mesh's uneven-spread check: NCCL needs a
    device a rank, so two ranks on one card fail before any group is
    created, and the message names gloo."""
    import torch
    import torch.distributed as dist

    from torrent_tpu_torch.parallel.distributed import initialize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match='backend="gloo"'):
        initialize(f"tcp://127.0.0.1:{free_port()}", 2, 0, backend="nccl")
    with pytest.raises(ValueError, match='backend="gloo"'):
        initialize(f"tcp://127.0.0.1:{free_port()}", 2, 0)  # None means nccl on CUDA
    assert not dist.is_initialized()


def test_two_rank_v1_route_multi_file(tmp_path):
    """v1 over 2 ranks, a multi-file payload whose pieces span the file
    boundary, one corrupt piece: the distributed recheck and the public
    verify_pieces route agree with hashlib and the reference."""
    sizes = [5 * PLEN + 1000, 14 * PLEN + PLEN // 2]
    workdir, payload, torrent, info, root = make_multi(tmp_path, sizes, seed=5)
    n = info.num_pieces
    assert n >= 16  # at least two 8-piece global batches
    corrupt = 9
    f1 = payload / "f1.bin"
    buf = bytearray(f1.read_bytes())
    buf[corrupt * PLEN - sizes[0] + 17] ^= 0xFF
    f1.write_bytes(bytes(buf))
    blob = b"".join((payload / f"f{i}.bin").read_bytes() for i in range(len(sizes)))
    expected = bits(hashlib.sha1(blob[i * PLEN : (i + 1) * PLEN]).digest() == info.pieces[i] for i in range(n))
    assert expected.count("0") == 1 and expected[corrupt] == "0"
    assert ref_bitfield(root, torrent.read_bytes()) == expected

    outs = spawn(workdir, 2, "storage", torrent)
    for rank, rec in enumerate(outs):
        assert rec["world_size"] == 2 and rec["backend"] == "gloo"
        assert rec["bitfield"] == rec["routed"] == expected
        assert rec["n_valid"] == n - 1
        # each pass (distributed, then routed) read the reference's rows
        assert rec["rows"] == 2 * v1_layout(rank, 2, 8, n)


def test_three_rank_v1_route_empty_tail_slices(tmp_path):
    """3 ranks, batch 12 (L = 4), 13 pieces: the final global batch
    holds one real piece on rank 0 and empty slices on ranks 1-2, which
    must still enter the count collective."""
    workdir, payload, torrent, info, root = make_multi(tmp_path, [12 * PLEN + PLEN // 3], seed=17)
    n = info.num_pieces
    assert n == 13
    expected = "1" * n
    assert ref_bitfield(root, torrent.read_bytes()) == expected
    outs = spawn(workdir / "payload", 3, "storage", torrent, batch=12)
    for rank, rec in enumerate(outs):
        assert rec["world_size"] == 3
        assert rec["bitfield"] == rec["routed"] == expected
        assert rec["n_valid"] == n
        assert rec["rows"] == 2 * v1_layout(rank, 3, 12, n)


def test_three_rank_library_route(tmp_path):
    """Torrent-level sharding over 3 ranks: each rank bulk-validates its
    round-robin share of a 4-torrent library, the packed allgather
    assembles the global view on every rank."""
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.tools.make_torrent import make_torrent

    rng = np.random.default_rng(11)
    workdir = tmp_path / "lib"
    workdir.mkdir()
    metas = []
    for t, npcs in enumerate([5, 9, 6, 3]):
        root = workdir / f"t{t}"
        root.mkdir()
        size = (npcs - 1) * PLEN + PLEN // 2
        (root / f"payload{t}.bin").write_bytes(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        tf = workdir / f"t{t}.torrent"
        tf.write_bytes(make_torrent(str(root / f"payload{t}.bin"), "http://t.invalid/announce", piece_length=PLEN, hasher="cpu"))
        metas.append((root, tf.read_bytes(), parse_metainfo(tf.read_bytes()).info))
    f1 = workdir / "t1" / "payload1.bin"
    buf = bytearray(f1.read_bytes())
    buf[4 * PLEN + 9] ^= 0xFF
    f1.write_bytes(bytes(buf))
    expected = []
    for t, (root, raw, info) in enumerate(metas):
        blob = (root / f"payload{t}.bin").read_bytes()
        want = bits(hashlib.sha1(blob[i * PLEN : (i + 1) * PLEN]).digest() == info.pieces[i] for i in range(info.num_pieces))
        assert ref_bitfield(root, raw) == want
        expected.append(want)
    assert expected[1][4] == "0" and sum(e.count("0") for e in expected) == 1

    outs = spawn(workdir, 3, "library")
    total = sum(info.num_pieces for _, _, info in metas)
    for rank, rec in enumerate(outs):
        assert rec["bitfields"] == expected
        assert rec["n_valid"] == total - 1
        assert rec["torrents_read"] == list(range(rank, len(metas), 3))


def test_two_rank_v2_route(tmp_path):
    """BEP 52 over 2 ranks: each rechecks its round-robin stride through
    the v2 plane, one allgather assembles the bitfield."""
    from torrent_tpu.codec.metainfo_v2 import parse_metainfo_v2 as ref_parse_metainfo_v2
    from torrent_tpu.parallel.verify import verify_pieces as ref_verify_pieces
    from torrent_tpu.session.v2 import v2_session_meta as ref_v2_session_meta
    from torrent_tpu.storage.storage import FsStorage as RefFs, Storage as RefStorage

    from torrent_tpu_torch.codec.metainfo_v2 import encode_metainfo_v2
    from torrent_tpu_torch.models.v2 import build_v2
    from torrent_tpu_torch.parallel.verify import verify_pieces
    from torrent_tpu_torch.session.v2 import v2_session_meta
    from torrent_tpu_torch.storage.storage import FsStorage, Storage

    plen = 16384
    rng = np.random.default_rng(41)
    workdir = tmp_path / "v2data"
    workdir.mkdir()
    payload = rng.integers(0, 256, 7 * plen + plen // 2, dtype=np.uint8).tobytes()
    src = workdir / "vp.bin"
    src.write_bytes(payload)
    meta = build_v2([(("vp.bin",), str(src))], "vp.bin", plen, hasher="cpu")
    torrent = tmp_path / "vp.torrent"
    torrent.write_bytes(encode_metainfo_v2(meta.info, meta.piece_layers))
    buf = bytearray(payload)
    buf[5 * plen + 5] ^= 0xFF
    src.write_bytes(bytes(buf))

    vmeta = v2_session_meta(meta)
    n = vmeta.info.num_pieces
    expected = bits(verify_pieces(Storage(FsStorage(str(workdir)), vmeta.info), vmeta.info, hasher="cpu"))
    assert expected.count("0") == 1 and expected[5] == "0"
    ref_meta = ref_v2_session_meta(ref_parse_metainfo_v2(torrent.read_bytes()))
    ref = ref_verify_pieces(RefStorage(RefFs(str(workdir)), ref_meta.info), ref_meta.info, hasher="tpu")
    assert bits(ref) == expected

    outs = spawn(workdir, 2, "v2", torrent)
    for rank, rec in enumerate(outs):
        assert rec["world_size"] == 2
        assert rec["bitfield"] == expected
        assert rec["n_valid"] == n - 1
        assert rec["rows"] == list(range(rank, n, 2))


def test_two_rank_count_collective(tmp_path):
    """Each rank verifies its own rows of one global batch through its
    GPUVerifier and the count is all_reduced: a corrupt row on the last
    rank flips exactly there, and every rank sees the same total."""
    outs = spawn(tmp_path, 2, "count")
    local = len(outs[0]["ok_local"])
    for rec in outs:
        assert rec["count"] == 2 * local - 1
    assert all(outs[0]["ok_local"])
    assert not outs[1]["ok_local"][0] and all(outs[1]["ok_local"][1:])


# ---------------------------------------------------------------- the rank


def _emit(workdir: str, rank: int, payload: dict) -> None:
    path = os.path.join(workdir, f"result_{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(dict(payload, rank=rank), f)
    os.replace(path + ".tmp", path)


def _recording(storage, rows: list):
    """``storage`` whose ``read_batch`` records the piece indices asked for."""
    read_batch = storage.read_batch

    def recorded(idxs, *args, **kwargs):
        rows.extend(int(i) for i in idxs)
        return read_batch(idxs, *args, **kwargs)

    storage.read_batch = recorded
    return storage


def _rank_main(argv) -> None:
    import glob

    import torch
    import torch.distributed as dist

    init, nproc, rank, workdir, mode, torrent, batch, device, backend = argv
    nproc, rank, batch = int(nproc), int(rank), int(batch)
    sys.path.insert(0, REPO)
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.ops import sha1_cuda, sha256_cuda
    from torrent_tpu_torch.parallel import distributed as D
    from torrent_tpu_torch.parallel.verify import verify_pieces
    from torrent_tpu_torch.storage.storage import FsStorage, Storage

    dev = None if device == "cuda" else device  # None: this rank's card
    backend = D.initialize(init, nproc, rank, backend=backend, device=dev, timeout=240)
    head = {"world_size": dist.get_world_size(), "backend": backend}
    counters = (sha1_cuda.sha1_pieces_cuda, sha256_cuda.sha256_pieces_cuda, sha256_cuda.sha256_merkle_cuda)
    for k in counters:
        k.launches = 0
    try:
        if mode == "storage":
            with open(torrent, "rb") as f:
                info = parse_metainfo(f.read()).info
            rows: list = []
            storage = _recording(Storage(FsStorage(workdir), info), rows)
            bf, n_valid = D.verify_storage_distributed(storage, info, batch_size=batch, device=dev, io_threads=1)
            routed = verify_pieces(storage, info, hasher="gpu", device=dev, batch_size=batch, io_threads=1)
            out = dict(head, bitfield=bits(bf), routed=bits(routed), n_valid=int(n_valid), rows=rows)
        elif mode == "v2":
            from torrent_tpu_torch.codec.metainfo_v2 import parse_metainfo_v2
            from torrent_tpu_torch.session.v2 import v2_session_meta

            with open(torrent, "rb") as f:
                vmeta = v2_session_meta(parse_metainfo_v2(f.read()))
            rows = []
            storage = _recording(Storage(FsStorage(workdir), vmeta.info), rows)
            bf = verify_pieces(storage, vmeta.info, hasher="gpu", device=dev)
            out = dict(head, bitfield=bits(bf), n_valid=int(bf.sum()), rows=sorted(rows))
        elif mode == "library":
            items, read = [], []
            for t, tf in enumerate(sorted(glob.glob(os.path.join(workdir, "*.torrent")))):
                with open(tf, "rb") as f:
                    info = parse_metainfo(f.read()).info
                root = os.path.join(workdir, os.path.splitext(os.path.basename(tf))[0])
                rows = []
                items.append((_recording(Storage(FsStorage(root), info), rows), info))
                read.append(rows)
            bitfields, n_valid = D.verify_library_distributed(items, batch_size=8, device=dev, io_threads=1)
            out = dict(
                head,
                bitfields=[bits(bf) for bf in bitfields],
                n_valid=int(n_valid),
                torrents_read=[t for t, rows in enumerate(read) if rows],
            )
        elif mode == "count":
            from torrent_tpu_torch.models.verifier import GPUVerifier
            from torrent_tpu_torch.ops.padding import digests_to_words, pad_pieces

            global_rows, local = 8, 8 // nproc
            rng = np.random.default_rng(7)  # the same seed on every rank
            pieces = [rng.integers(0, 256, 192, dtype=np.uint8).tobytes() for _ in range(global_rows)]
            padded, nblocks = pad_pieces(pieces)
            expected = digests_to_words([hashlib.sha1(p).digest() for p in pieces])
            padded = padded.copy()
            padded[(nproc - 1) * local, 0] ^= 0xFF  # a row of the last rank
            lo = rank * local
            ok = GPUVerifier(piece_length=192, batch_size=local, device=dev).verify_batch(
                padded[lo : lo + local], nblocks[lo : lo + local], expected[lo : lo + local]
            )
            count = D.psum_valid_count(torch.from_numpy(ok))
            out = dict(head, ok_local=[bool(b) for b in ok], count=int(count.item()))
        elif mode == "nccl1":
            # the collectives on CUDA tensors, at the only world size one
            # card allows NCCL: the count stays on the card
            from torrent_tpu_torch.fabric import AllgatherHeartbeat

            ok = torch.tensor([True, False, True, True], device="cuda")
            count = D.psum_valid_count(ok)
            gathered = D.allgather_bitfield(np.array([1, 0, 0, 1], dtype=bool))
            peers = AllgatherHeartbeat(1, 0, max_bytes=256).exchange({"pid": 0, "seq": 1})
            out = dict(head, count=int(count.item()), count_on_card=bool(count.is_cuda),
                       gathered=bits(gathered), peers=len(peers))
        else:
            raise ValueError(f"unknown mode {mode!r}")
        out["launches"] = {k.__name__: k.launches for k in counters}
        _emit(workdir, rank, out)
    finally:
        D.shutdown()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
