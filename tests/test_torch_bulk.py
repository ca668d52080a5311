"""Bulk library validation on the port (BASELINE config 5, scaled down):
the ``"gpu"`` hasher runs the plain PyTorch SHA-1 on ``device="cpu"``."""

import hashlib

import numpy as np
import pytest

from torrent_tpu_torch.codec.metainfo import InfoDict
from torrent_tpu_torch.parallel.bulk import verify_library
from torrent_tpu_torch.storage.storage import MemoryStorage, Storage


def make_item(length, piece_len, seed, corrupt_piece=None):
    rng = np.random.default_rng(seed)
    payload = bytearray(rng.integers(0, 256, size=length, dtype=np.uint8).tobytes())
    pieces = tuple(
        hashlib.sha1(bytes(payload[i : i + piece_len])).digest()
        for i in range(0, length, piece_len)
    )
    if corrupt_piece is not None:
        payload[corrupt_piece * piece_len] ^= 0xFF
    info = InfoDict(
        name=f"t{seed}", piece_length=piece_len, pieces=pieces, length=length, files=None
    )
    storage = Storage(MemoryStorage(), info)
    for off in range(0, length, 1 << 20):
        storage.set(off, bytes(payload[off : off + (1 << 20)]))
    return storage, info


class TestVerifyLibrary:
    def test_mixed_geometries_and_corruption(self):
        items = [
            make_item(100_000, 16384, seed=1),
            make_item(50_000, 32768, seed=2, corrupt_piece=1),
            make_item(131072, 16384, seed=3),
            make_item(32768, 32768, seed=4),
        ]
        res = verify_library(items, hasher="gpu", device="cpu", batch_size=8)
        assert res.bitfields[0].all()
        assert not res.bitfields[1][1] and res.bitfields[1][0]
        assert res.bitfields[2].all()
        assert res.bitfields[3].all()
        assert res.n_pieces == sum(i.num_pieces for _, i in items)
        # matches per-torrent cpu verification exactly
        cpu = verify_library(items, hasher="cpu")
        for a, b in zip(res.bitfields, cpu.bitfields):
            assert (a == b).all()

    def test_cross_torrent_batching(self):
        # batch of 8 with three 3-piece torrents: batches must span torrents
        items = [make_item(49152, 16384, seed=s) for s in (10, 11, 12)]
        progress = []
        res = verify_library(
            items, hasher="gpu", device="cpu", batch_size=8,
            progress_cb=lambda d, t: progress.append((d, t)),
        )
        assert all(bf.all() for bf in res.bitfields)
        # 9 pieces, batch 8 → two launches: 8 then 1
        assert progress == [(8, 9), (9, 9)]

    def test_empty_library(self):
        res = verify_library([], hasher="gpu", device="cpu")
        assert res.bitfields == [] and res.n_pieces == 0


# ------------------------------------------------------------ a library with faults

FAULT_PLEN = 1024


def fault_library(root) -> tuple[list, list[np.ndarray]]:
    """Five single-file torrents on disk with every kind of bad piece, and
    the bitfield each should get: a short last piece (clean), a one-piece
    torrent with a flipped byte, a file torn in the middle of piece 4, a
    file that is missing, and two flipped pieces. 20 pieces in all, so
    batches of 1, 3, 7 and 64 all cross torrent boundaries."""
    from torrent_tpu_torch.storage.storage import FsStorage

    rng = np.random.default_rng(23)
    plan = [  # (length, flipped pieces, bytes left on disk: None = all)
        (5 * FAULT_PLEN - 100, (), None),
        (700, (0,), None),
        (7 * FAULT_PLEN, (), 4 * FAULT_PLEN + 300),
        (3 * FAULT_PLEN - 1, (), 0),
        (4 * FAULT_PLEN - 9, (0, 3), None),
    ]
    items, want = [], []
    for t, (length, flipped, kept) in enumerate(plan):
        payload = bytearray(rng.bytes(length))
        pieces = tuple(
            hashlib.sha1(bytes(payload[i : i + FAULT_PLEN])).digest() for i in range(0, length, FAULT_PLEN)
        )
        for p in flipped:
            payload[p * FAULT_PLEN + 17] ^= 0x5A
        ok = np.ones(len(pieces), dtype=bool)
        ok[list(flipped)] = False
        d = root / f"t{t}"
        d.mkdir()
        if kept != 0:
            (d / "data.bin").write_bytes(bytes(payload[:kept]))
        if kept is not None:
            ok[kept // FAULT_PLEN :] = False
        info = InfoDict(name="data.bin", piece_length=FAULT_PLEN, pieces=pieces, length=length, files=None)
        items.append((Storage(FsStorage(str(d)), info), info))
        want.append(ok)
    return items, want


@pytest.mark.parametrize("batch", [1, 3, 7, 64])
def test_faulty_library_matches_each_torrent_and_hashlib(tmp_path, batch):
    """The device route over the flattened library gives each torrent the
    bitfield its own recheck gives, and streaming hashlib's."""
    from torrent_tpu_torch.models.verifier import GPUVerifier

    items, want = fault_library(tmp_path)
    progress = []
    res = verify_library(
        items, hasher="gpu", device="cpu", batch_size=batch, io_threads=2,
        progress_cb=lambda d, t: progress.append((d, t)),
    )
    cpu = verify_library(items, hasher="cpu")
    verifier = GPUVerifier(piece_length=FAULT_PLEN, batch_size=batch, device="cpu")
    for (storage, info), got, hashed, ok in zip(items, res.bitfields, cpu.bitfields, want):
        assert got.tolist() == ok.tolist() == hashed.tolist()
        assert verifier.verify_storage(storage, info, io_threads=2).tolist() == ok.tolist()
    assert progress == [(min(d, 20), 20) for d in range(batch, 20 + batch, batch)]


@pytest.mark.parametrize("batch,io_threads", [(3, 1), (8, 3)])
def test_distributed_at_world_size_one_matches_the_direct_recheck(tmp_path, batch, io_threads):
    """Without a process group the multi-process route is one rank's
    recheck: each torrent's bitfield and count as the direct route's."""
    from torrent_tpu_torch.models.verifier import GPUVerifier
    from torrent_tpu_torch.parallel.distributed import verify_storage_distributed

    items, want = fault_library(tmp_path)
    verifier = GPUVerifier(piece_length=FAULT_PLEN, batch_size=batch, device="cpu")
    for (storage, info), ok in zip(items, want):
        bitfield, n_valid = verify_storage_distributed(storage, info, batch_size=batch, device="cpu", io_threads=io_threads)
        direct = verifier.verify_storage(storage, info, io_threads=io_threads)
        assert bitfield.tolist() == direct.tolist() == ok.tolist()
        assert n_valid == int(ok.sum())
