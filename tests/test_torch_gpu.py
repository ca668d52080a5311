"""The CUDA kernels on the card: tests marked ``gpu``.

They need an NVIDIA GPU with nvcc, decide so inside a fixture, and skip
on hosts without one. This file imports neither jax nor the reference
package, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same device
tensors and against hashlib; digests compare exactly. The v2 plane's
authoring and rechecks on the card are held against ``hasher="cpu"``.
"""

import hashlib

import numpy as np
import pytest
import torch

from torrent_tpu_torch.codec.bencode import bencode
from torrent_tpu_torch.codec.metainfo import InfoDict
from torrent_tpu_torch.entry import entry
from torrent_tpu_torch.models.merkle import merkle_root
from torrent_tpu_torch.models.v2 import build_hybrid, build_v2, verify_v2
from torrent_tpu_torch.models.verifier import GPUVerifier
from torrent_tpu_torch.ops.padding import digests_to_words, pad_pieces, words_to_digests
from torrent_tpu_torch.ops.sha1_cuda import make_sha1_fn, sha1_pieces_cuda
from torrent_tpu_torch.ops.sha1_torch import IV, sha1_pieces_torch, words_to_numpy
from torrent_tpu_torch.ops.sha256_cuda import (
    MERKLE_CAP,
    make_sha256_fn,
    merkle_passes,
    sha256_merkle_cuda,
    sha256_pairs_cuda,
    sha256_pieces_cuda,
)
from torrent_tpu_torch.ops.sha256_torch import IV as IV256
from torrent_tpu_torch.ops.sha256_torch import sha256_merkle_torch, sha256_pairs_torch, sha256_pieces_torch
from torrent_tpu_torch.parallel.verify import verify_pieces
from torrent_tpu_torch.session.v2 import v2_session_info
from torrent_tpu_torch.storage.storage import FsStorage, MemoryStorage, Storage
from torrent_tpu_torch.tools.time_merkle import hashlib_roots

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def on_card(pieces, device, sentinels=()):
    padded, nblocks = pad_pieces(pieces)
    nblocks[list(sentinels)] = 0
    return torch.from_numpy(padded).to(device), torch.from_numpy(nblocks).to(device)


def digests(words):
    return words_to_digests(words_to_numpy(words))


@pytest.mark.parametrize(
    "lens",
    [
        [0, 1, 55, 56, 63, 64, 65, 119, 120, 127, 128, 300, 16384, 262143],
        [1024] * 33,
        [320, 64, 256, 130],
    ],
)
def test_kernel_matches_plain_and_hashlib(cuda, lens):
    rng = np.random.default_rng(len(lens))
    pieces = [rng.bytes(n) for n in lens]
    data, nb = on_card(pieces, cuda)
    got = sha1_pieces_cuda(data, nb)
    got32 = sha1_pieces_cuda(data.view(torch.int32), nb)
    plain = sha1_pieces_torch(data, nb)
    torch.cuda.synchronize()
    assert torch.equal(got, plain) and torch.equal(got32, plain)
    assert digests(got) == [hashlib.sha1(p).digest() for p in pieces]


def test_nist_vectors_including_a_million_a(cuda):
    msgs = [b"", b"abc", b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq", b"a" * 1_000_000]
    want = [
        "da39a3ee5e6b4b0d3255bfef95601890afd80709",
        "a9993e364706816aba3e25717850c26c9cd0d89d",
        "84983e441c3bd26ebaae4aa1f95129e5e54670f1",
        "34aa973cd4c4daa4f61eeb2bdbad27316534016f",
    ]
    data, nb = on_card(msgs, cuda)
    assert [d.hex() for d in digests(sha1_pieces_cuda(data, nb))] == want


def test_sentinel_rows_write_the_iv(cuda):
    pieces = [b"x" * n for n in (10, 100, 1000, 0)]
    data, nb = on_card(pieces, cuda, sentinels=(1, 3))
    words = words_to_numpy(sha1_pieces_cuda(data, nb))
    assert tuple(words[1]) == IV and tuple(words[3]) == IV
    assert words_to_digests(words[[0, 2]]) == [hashlib.sha1(p).digest() for p in (pieces[0], pieces[2])]


def test_launch_counter_counts_cuda_launches_only(cuda):
    data, nb = on_card([b"abc"], cuda)
    before = sha1_pieces_cuda.launches
    sha1_pieces_cuda(data, nb)
    sha1_pieces_cuda(data.cpu(), nb.cpu())  # the plain version: not a launch
    assert sha1_pieces_cuda.launches == before + 1


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    data, nb = on_card([b"abc", b"def"], cuda)
    with pytest.raises(ValueError):
        sha1_pieces_cuda(data.t(), nb)  # not contiguous (and not [B, row])
    wide = torch.zeros((2, 256), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        sha1_pieces_cuda(wide.view(-1)[4:196].view(2, 96)[:, :64], nb)
    with pytest.raises(ValueError):
        sha1_pieces_cuda(wide.view(-1)[4:132].view(1, 128), nb[:1])  # 4-byte aligned only
    with pytest.raises(ValueError):
        sha1_pieces_cuda(data, nb.cpu())


def test_verifier_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    length, plen = 300_000, 16384
    payload = rng.bytes(length)
    pieces = tuple(hashlib.sha1(payload[i : i + plen]).digest() for i in range(0, length, plen))
    info = InfoDict(name="v", piece_length=plen, pieces=pieces, length=length)
    storage = Storage(MemoryStorage(), info)
    storage.set(0, payload)
    storage.method.set(("v",), 70_000, b"\x00CORRUPT\x00")
    before = sha1_pieces_cuda.launches
    gpu = verify_pieces(storage, info, hasher="gpu", batch_size=4)
    assert sha1_pieces_cuda.launches - before == -(-info.num_pieces // 4)
    cpu = verify_pieces(storage, info, hasher="cpu")
    assert (gpu == cpu).all() and list(np.nonzero(~gpu)[0]) == [4]
    v = GPUVerifier(piece_length=plen, batch_size=8)
    assert v.hash_pieces([payload[:plen], payload[plen:100]]) == [
        hashlib.sha1(payload[:plen]).digest(), hashlib.sha1(payload[plen:100]).digest()
    ]


def kernel_u8_u32_plain(pieces, device, sentinels=()):
    """The kernel on u8 and int32-viewed rows and the plain version, all
    on the card, and hashlib's digests (the IV words for sentinel rows)."""
    data, nb = on_card(pieces, device, sentinels)
    got, got32 = sha1_pieces_cuda(data, nb), sha1_pieces_cuda(data.view(torch.int32), nb)
    plain = sha1_pieces_torch(data, nb)
    torch.cuda.synchronize()
    iv = words_to_digests(np.asarray([IV], dtype=np.uint32))[0]
    want = [iv if i in sentinels else hashlib.sha1(p).digest() for i, p in enumerate(pieces)]
    return got, got32, plain, want


@pytest.mark.parametrize("rows", [1, 31, 32, 33, 4097])
def test_kernel_batches_around_the_32_piece_cta(cuda, rows):
    # the kernel runs one CTA per 32 pieces: full, partial and lone CTAs
    rng = np.random.default_rng(rows)
    pieces = [rng.bytes(int(n)) for n in rng.integers(0, 2048, size=rows)]
    sentinels = (rows // 2,) if rows > 2 else ()
    got, got32, plain, want = kernel_u8_u32_plain(pieces, cuda, sentinels)
    assert torch.equal(got, plain) and torch.equal(got32, plain)
    assert digests(got) == want


def test_kernel_one_cta_of_ragged_chains_with_sentinels(cuda):
    # one 32-row CTA whose chains run 1 … 4097 blocks; the rings run to the
    # longest while shorter lanes and the sentinels in the middle keep theirs
    rng = np.random.default_rng(32)
    lens = np.linspace(0, 256 * 1024 - 1, 32).astype(int)
    pieces = [rng.bytes(int(n)) for n in lens]
    got, got32, plain, want = kernel_u8_u32_plain(pieces, cuda, sentinels=(12, 13, 20))
    assert torch.equal(got, plain) and torch.equal(got32, plain)
    assert digests(got) == want


def test_kernel_rows_of_a_mebibyte_and_one_block(cuda):
    # 16,386 blocks per chain: thousands of trips around both rings
    rng = np.random.default_rng(1 << 20)
    pieces = [rng.bytes((1 << 20) + 64), rng.bytes(1 << 20), rng.bytes(5)]
    got, got32, plain, want = kernel_u8_u32_plain(pieces, cuda)
    assert torch.equal(got, plain) and torch.equal(got32, plain)
    assert digests(got) == want


def test_entry_on_card(cuda):
    forward, args = entry()
    assert args[0].is_cuda and forward(*args).all()
    assert make_sha1_fn() is sha1_pieces_cuda


# ---------------------------------------------------------------- SHA-256


@pytest.mark.parametrize(
    "lens",
    [
        [0, 1, 55, 56, 63, 64, 65, 119, 120, 127, 128, 300, 8191, 16383, 16384],
        [16384] * 33,
        [320, 64, 256, 130],
    ],
)
def test_sha256_kernel_matches_plain_and_hashlib(cuda, lens):
    rng = np.random.default_rng(len(lens) + 100)
    pieces = [rng.bytes(n) for n in lens]
    data, nb = on_card(pieces, cuda)
    got = sha256_pieces_cuda(data, nb)
    got32 = sha256_pieces_cuda(data.view(torch.int32), nb)
    plain = sha256_pieces_torch(data, nb)
    torch.cuda.synchronize()
    assert torch.equal(got, plain) and torch.equal(got32, plain)
    assert digests(got) == [hashlib.sha256(p).digest() for p in pieces]


def test_sha256_nist_vectors_including_a_million_a(cuda):
    msgs = [b"", b"abc", b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq", b"a" * 1_000_000]
    want = [
        "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
        "ba7816bf8f01cfea414140de5dae2223b00361a396177a9cb410ff61f20015ad",
        "248d6a61d20638b8e5c026930c3e6039a33ce45964ff2167f6ecedd419db06c1",
        "cdc76e5c9914fb9281a1c7e284d73e67f1809a48a497200e046d39ccc7112cd0",
    ]
    data, nb = on_card(msgs, cuda)
    assert [d.hex() for d in digests(sha256_pieces_cuda(data, nb))] == want


def test_sha256_sentinel_rows_write_the_iv(cuda):
    pieces = [b"x" * n for n in (10, 100, 1000, 0)]
    data, nb = on_card(pieces, cuda, sentinels=(1, 3))
    words = words_to_numpy(sha256_pieces_cuda(data, nb))
    assert tuple(words[1]) == IV256 and tuple(words[3]) == IV256
    assert words_to_digests(words[[0, 2]]) == [hashlib.sha256(p).digest() for p in (pieces[0], pieces[2])]


@pytest.mark.parametrize("pairs", [1, 33, 4096])
def test_sha256_pairs_match_plain_and_hashlib(cuda, pairs):
    rng = np.random.default_rng(pairs)
    kids = [rng.bytes(32) for _ in range(2 * pairs)]
    words = torch.from_numpy(digests_to_words(kids, words=8).reshape(pairs, 16).view(np.int32)).to(cuda)
    before = sha256_pairs_cuda.launches
    got = sha256_pairs_cuda(words)
    assert sha256_pairs_cuda.launches == before + 1
    assert torch.equal(got, sha256_pairs_torch(words))
    assert digests(got) == [hashlib.sha256(kids[i] + kids[i + 1]).digest() for i in range(0, 2 * pairs, 2)]


def test_sha256_wrappers_reject_what_the_kernels_do_not_take(cuda):
    data, nb = on_card([b"abc", b"def"], cuda)
    with pytest.raises(ValueError):
        sha256_pieces_cuda(data.t(), nb)
    with pytest.raises(ValueError):
        sha256_pieces_cuda(data, nb.cpu())
    wide = torch.zeros((2, 40), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        sha256_pairs_cuda(wide[:, :16])  # not contiguous
    with pytest.raises(ValueError):
        sha256_pairs_cuda(wide.view(-1)[1:17].view(1, 16))  # 4-byte aligned only
    assert make_sha256_fn() is sha256_pieces_cuda


def test_merkle_root_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(7)
    grid = rng.integers(0, 2**32, size=(5, 16, 8), dtype=np.uint32)
    before = (sha256_merkle_cuda.launches, sha256_pairs_cuda.launches)
    assert (merkle_root(grid) == merkle_root(grid, device="cpu")).all()
    # all four levels of all five trees in one launch of the merkle kernel
    assert (sha256_merkle_cuda.launches, sha256_pairs_cuda.launches) == (before[0] + 1, before[1])


def merkle_on_card(b, l, device, seed):
    """A seeded ``[b, l, 8]`` grid as ``int32[b·l, 8]`` node words on the
    card, and hashlib's pair-fold of each tree."""
    grid = np.random.default_rng(seed).integers(0, 2**32, size=(b, l, 8), dtype=np.uint32)
    return torch.from_numpy(grid.reshape(-1, 8).view(np.int32)).to(device), hashlib_roots(grid)


@pytest.mark.parametrize(
    "b,l",
    # one CTA takes 512 nodes: partial, full and ragged last CTAs; trees of
    # 1 ... 9 levels in one launch, and 11, 12 and 17 levels in two
    [(1, 2), (5, 8), (3, 64), (256, 64), (1000, 2), (9, 64), (1, 2048), (2, 4096), (1, 1 << 17)],
)
def test_merkle_kernel_matches_plain_and_hashlib(cuda, b, l):
    words, roots = merkle_on_card(b, l, cuda, seed=b * 31 + l)
    levels = l.bit_length() - 1
    got = sha256_merkle_cuda(words, levels)
    plain = sha256_merkle_torch(words, levels)
    torch.cuda.synchronize()
    assert got.shape == (b, 8) and torch.equal(got, plain)
    assert digests(got) == roots


@pytest.mark.parametrize("levels", [1, 6, MERKLE_CAP, MERKLE_CAP + 1, 11, 17])
def test_merkle_launches_follow_the_pass_plan(cuda, levels):
    words, roots = merkle_on_card(2, 1 << levels, cuda, seed=levels)
    before = sha256_merkle_cuda.launches
    got = sha256_merkle_cuda(words, levels)
    n = sha256_merkle_cuda.launches - before
    assert n == len(merkle_passes(levels)) and (n == 1) == (levels <= MERKLE_CAP)
    assert digests(got) == roots
    assert sha256_merkle_cuda(words, 0) is words
    assert sha256_merkle_cuda.launches - before == n  # no launch for 0 levels


def test_merkle_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    wide = torch.zeros((8, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        sha256_merkle_cuda(wide[:, :8], 3)  # not contiguous
    with pytest.raises(ValueError):
        sha256_merkle_cuda(wide.view(-1)[1:65].view(8, 8), 3)  # 4-byte aligned only
    with pytest.raises(ValueError):
        sha256_merkle_cuda(wide.view(16, 8)[:12], 3)  # 12 nodes are not trees of 8
    with pytest.raises(ValueError):
        sha256_merkle_cuda(wide.view(16, 8), -1)


V2_PLEN = 4 * 16384


def v2_corpus(tmp_path):
    rng = np.random.default_rng(21)
    files = []
    for rel, size in (("a.bin", 3 * V2_PLEN + 100), ("b/c.bin", 5000), ("d.bin", 8 * V2_PLEN), ("e", 0)):
        path = tmp_path / "payload" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(rng.bytes(size))
        files.append((tuple(rel.split("/")), str(path)))
    return files


def test_build_v2_and_hybrid_on_card_match_cpu(cuda, tmp_path):
    files = v2_corpus(tmp_path)
    before = (sha256_pieces_cuda.launches, sha256_merkle_cuda.launches, sha1_pieces_cuda.launches)
    gpu = build_v2(files, "payload", V2_PLEN)
    cpu = build_v2(files, "payload", V2_PLEN, hasher="cpu")
    assert bencode(gpu.raw) == bencode(cpu.raw)
    blob_gpu, _ = build_hybrid(files, "payload", V2_PLEN)
    blob_cpu, _ = build_hybrid(files, "payload", V2_PLEN, hasher="cpu")
    assert blob_gpu == blob_cpu
    after = (sha256_pieces_cuda.launches, sha256_merkle_cuda.launches, sha1_pieces_cuda.launches)
    assert all(a > b for a, b in zip(after, before))


def test_verify_v2_and_verify_pieces_on_card(cuda, tmp_path):
    files = v2_corpus(tmp_path)
    meta = build_v2(files, "payload", V2_PLEN, hasher="cpu")
    lookup = dict(files)
    info = v2_session_info(meta.info, meta.piece_layers)
    assert all(ok.all() for ok in verify_v2(lookup.get, meta).values())
    assert verify_pieces(Storage(FsStorage(tmp_path), info), info, hasher="gpu", batch_size=3).all()
    with open(lookup[("d.bin",)], "r+b") as f:
        f.seek(5 * V2_PLEN + 9)
        f.write(b"\xff\x00")
    res = verify_v2(lookup.get, meta)
    assert list(np.nonzero(~res[("d.bin",)])[0]) == [5]
    gpu = verify_pieces(Storage(FsStorage(tmp_path), info), info, hasher="gpu", batch_size=3)
    cpu = verify_pieces(Storage(FsStorage(tmp_path), info), info, hasher="cpu")
    assert (gpu == cpu).all() and (~gpu).sum() == 1


# ------------------------------------------------------------ scheduler
#
# The hash-plane scheduler (torrent_tpu_torch/sched) on the card: its
# sha1 lanes run the SHA-1 kernel through GPUVerifier, its sha256 lanes
# the SHA-256 row kernel, from pinned staging slots on a copy stream.


def _sched_run(coro, timeout: float = 300.0):
    import asyncio

    return asyncio.run(asyncio.wait_for(coro, timeout))


def _sched_torrent(tmp_path, name, n_pieces, plen, seed, pad_files=False, sizes=None):
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.tools.make_torrent import make_torrent

    rng = np.random.default_rng(seed)
    root = tmp_path / name
    src = root / "payload"
    src.mkdir(parents=True)
    for i, size in enumerate(sizes or [n_pieces * plen]):
        (src / f"f{i}.bin").write_bytes(rng.bytes(size))
    target = str(src if sizes else src / "f0.bin")
    base = str(root if sizes else src)
    meta = parse_metainfo(
        make_torrent(target, "http://t.invalid/a", piece_length=plen, pad_files=pad_files, hasher="cpu")
    )
    return Storage(FsStorage(base), meta.info), meta.info


def _assert_clean(sched):
    snap = sched.metrics_snapshot()
    assert snap["cpu_fallback_launches"] == 0, snap
    assert snap["launch_failures"] == 0, snap
    assert all(b["state"] == "closed" for b in snap["breakers"].values()), snap["breakers"]
    assert snap["staging"]["outstanding"] == 0
    reuse = sched.staging_reuse()
    assert reuse["outstanding"] == 0
    # stream-ordered reuse: slots went back only after their copy event
    assert reuse["copy_checks"] > 0 and reuse["early_checkins"] == 0, reuse


def test_sched_lanes_on_card_match_hashlib(cuda):
    from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig

    rng = np.random.default_rng(21)
    pieces = [rng.bytes(int(n)) for n in rng.integers(0, 16385, size=300)]

    async def go():
        sched = await HashPlaneScheduler(
            SchedulerConfig(batch_target=64, flush_deadline=0.01), hasher="gpu"
        ).start()
        assert sched.device.type == "cuda" and sched.sha256_backend() == "cuda"
        s1, s256 = sha1_pieces_cuda.launches, sha256_pieces_cuda.launches
        try:
            got1 = await sched.submit("t", pieces, piece_length=16384)
            got256 = await sched.submit("t", pieces, algo="sha256", piece_length=16384)
        finally:
            await sched.close()
        assert got1 == [hashlib.sha1(p).digest() for p in pieces]
        assert got256 == [hashlib.sha256(p).digest() for p in pieces]
        assert sha1_pieces_cuda.launches - s1 >= 5
        assert sha256_pieces_cuda.launches - s256 >= 5
        lanes = sched.metrics_snapshot()["lane_stats"]
        assert lanes["sha1/16384"]["backend"] == "cuda"
        assert lanes["sha256/16384"]["backend"] == "cuda"
        # a card's lanes have no hashlib alternative to steer to
        for key in ("sha1/16384", "sha256/16384"):
            with pytest.raises(ValueError, match="card"):
                sched.steer_lane_backend(key, "cpu")
        _assert_clean(sched)

    _sched_run(go())


def test_sched_zero_copy_recheck_on_card(cuda, tmp_path):
    """A scheduler-fed recheck lands reads in pinned slabs and launches
    them in place: staged launches, no ``stage`` copy bytes, and the
    h2d / launch / digest spans (closed on CUDA events) carry bytes."""
    from torrent_tpu_torch.obs.attrib import attribute
    from torrent_tpu_torch.obs.ledger import pipeline_ledger
    from torrent_tpu_torch.obs.tracer import tracer
    from torrent_tpu_torch.parallel.verify import verify_pieces_sched
    from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig

    storage, info = _sched_torrent(tmp_path, "one", 96, 1 << 16, seed=3)

    async def go():
        led = pipeline_ledger()
        prev = led.snapshot()
        sched = await HashPlaneScheduler(
            SchedulerConfig(batch_target=32, flush_deadline=0.01), hasher="gpu"
        ).start()
        try:
            with tracer().span("recheck", trace_id="t-zero-copy"):
                bf = await verify_pieces_sched(storage, info, sched)
        finally:
            await sched.close()
        assert bf.all()
        rep = attribute(led.snapshot(), prev=prev)
        assert rep["stages"].get("stage", {}).get("bytes", 0) == 0, rep["stages"]
        for stage in ("read", "h2d", "launch", "digest"):
            st = rep["stages"][stage]
            assert st["bytes"] > 0 and st["busy_s"] > 0, (stage, st)
        tree = tracer().trace_tree("t-zero-copy")
        launches = [s for s in _flat(tree) if s["name"] == "sched.launch"]
        assert launches and all(s["attrs"].get("staged") for s in launches)
        _assert_clean(sched)

    _sched_run(go())


def test_grid_of_two_entries_on_one_card(cuda):
    """A grid that names the card twice (``parallel/mesh.py``): each
    entry launches the kernel on its own block of every batch, on its
    own streams; the bitfield, digests and count equal one entry's and
    hashlib's."""
    from torrent_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(15)
    length, plen = 37 * 16384 + 1000, 16384
    payload = rng.bytes(length)
    pieces = tuple(hashlib.sha1(payload[i : i + plen]).digest() for i in range(0, length, plen))
    info = InfoDict(name="v", piece_length=plen, pieces=pieces, length=length)
    storage = Storage(MemoryStorage(), info)
    storage.set(0, payload)
    storage.method.set(("v",), 20 * plen + 3, b"\x00BAD\x00")
    before = sha1_pieces_cuda.launches
    grid = verify_pieces(storage, info, hasher="gpu", batch_size=8, devices=[cuda, cuda])
    assert sha1_pieces_cuda.launches - before == 2 * -(-info.num_pieces // 8)
    one = verify_pieces(storage, info, hasher="gpu", batch_size=8, device=cuda)
    cpu = verify_pieces(storage, info, hasher="cpu")
    assert (grid == one).all() and (grid == cpu).all() and list(np.nonzero(~grid)[0]) == [20]
    v = GPUVerifier(piece_length=plen, batch_size=5, mesh=make_mesh([cuda, cuda]))
    assert v.batch_size == 6
    ragged = [payload[i : i + n] for i, n in ((0, 0), (1, 55), (9, 16384), (77, 700), (5, 64))]
    assert v.hash_pieces(ragged) == [hashlib.sha1(p).digest() for p in ragged]
    padded, nblocks = pad_pieces(ragged[:4])
    one_v = GPUVerifier(piece_length=plen, batch_size=4, device=cuda)
    assert (v.digest_batch(padded, nblocks) == one_v.digest_batch(padded, nblocks)).all()


def test_dryrun_multichip_on_card(cuda, capsys):
    from torrent_tpu_torch.entry import dryrun_multichip

    before = sha1_pieces_cuda.launches
    got = dryrun_multichip(4)
    assert got["mesh"] == {"hosts": 2, "dp": 2} and got["valid"] == 7 and got["batch"] == 8
    assert sha1_pieces_cuda.launches - before == 2 * 4  # two verifies, one launch an entry
    assert capsys.readouterr().out.startswith("dryrun_multichip OK: mesh={'hosts': 2, 'dp': 2}")


def test_sched_grid_on_card(cuda, tmp_path):
    """A scheduler whose SHA-1 lanes span two entries on the card:
    zero-copy launches of whole grid blocks, hashlib's bitfield."""
    from torrent_tpu_torch.parallel.verify import verify_pieces_sched
    from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig

    storage, info = _sched_torrent(tmp_path, "grid", 96, 1 << 16, seed=4)

    async def go():
        sched = await HashPlaneScheduler(
            SchedulerConfig(batch_target=32, flush_deadline=0.01), hasher="gpu", devices=[cuda, cuda]
        ).start()
        before = sha1_pieces_cuda.launches
        try:
            bf = await verify_pieces_sched(storage, info, sched)
        finally:
            await sched.close()
        assert bf.all()
        assert sched.mesh.size == 2
        launches = sched.metrics_snapshot()["launches"]
        assert sha1_pieces_cuda.launches - before == 2 * launches
        _assert_clean(sched)

    _sched_run(go())


def _flat(tree):
    out = []

    def walk(node):
        out.append(node)
        for c in node["children"]:
            walk(c)

    for root in tree["spans"]:
        walk(root)
    return out


def test_sched_slot_reuse_never_reads_over_a_copy(cuda, tmp_path):
    """Two lanes (two piece lengths), launches pipelined two deep, many
    more batches than slots: every slab is reused dirty, and a BEP 47
    pad-file torrent's pad spans still hash as zeros from slabs dirtied
    by another torrent (test_torch_ingest.py's pad-span case, on the
    card). Every bitfield is hashlib's; the ingest pools drain."""
    import asyncio

    from torrent_tpu_torch.parallel.verify import verify_pieces_cpu, verify_pieces_sched
    from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig

    plen = 16384
    a = _sched_torrent(tmp_path, "a", 160, plen, seed=5)
    b = _sched_torrent(tmp_path, "b", 64, 4 * plen, seed=6)
    padded = _sched_torrent(
        tmp_path, "pad", 0, plen, seed=9, pad_files=True,
        sizes=[3 * plen + 123, 2 * plen + 77, 5 * plen + 1],
    )
    assert any(getattr(e, "pad", False) for e in padded[1].files)

    async def go():
        sched = await HashPlaneScheduler(
            SchedulerConfig(batch_target=8, flush_deadline=0.005, pipeline_depth=2),
            hasher="gpu",
        ).start()
        try:
            for _ in range(2):
                got = await asyncio.gather(
                    verify_pieces_sched(*a, sched, tenant="a"),
                    verify_pieces_sched(*b, sched, tenant="b"),
                )
                assert got[0].all() and got[1].all()
                for _ in range(2):
                    assert (await verify_pieces_sched(*padded, sched)).all()
        finally:
            await sched.close()
        assert sched.metrics_snapshot()["launches"] >= 2 * (20 + 8)
        _assert_clean(sched)

    _sched_run(go())
    assert verify_pieces_cpu(*padded).all()


def test_sched_breaker_trips_and_recloses_on_card(cuda):
    """``FaultPlan("fail_first=3")`` around the CUDA planes: the breaker
    opens and the launches it refuses fail with a transient
    ``SchedLaunchError`` (never hashlib's digests behind the caller's
    back); after a short cooldown it half-opens, the probe re-closes it,
    and later launches run on the kernels again."""
    import asyncio
    import time

    from torrent_tpu_torch.sched import (
        FaultPlan,
        HashPlaneScheduler,
        SchedLaunchError,
        SchedulerConfig,
    )

    plan = FaultPlan.parse("fail_first=3")
    pieces = [bytes([i + 1]) * 5000 for i in range(16)]
    want = [hashlib.sha1(p).digest() for p in pieces]

    async def go():
        sched = await HashPlaneScheduler(
            SchedulerConfig(
                batch_target=8, flush_deadline=0.01, breaker_threshold=3,
                breaker_cooldown=0.5, launch_retries=1,
                plane_factory=plan.plane_factory(hasher="gpu"),
            ),
            hasher="gpu",
        ).start()
        try:
            with pytest.raises(SchedLaunchError) as err:
                await sched.submit("t", pieces, piece_length=8192)
            assert err.value.kind == "transient"
            while sched.metrics_snapshot()["queue_bytes"]:  # the rest refused
                await asyncio.sleep(0.01)
            snap = sched.metrics_snapshot()
            assert snap["breakers"]["sha1/8192"]["state"] == "open", snap["breakers"]
            # while open, a launch is refused at once: no retry, no
            # bisection, no hashlib
            retries, bisections = snap["retries"], snap["bisections"]
            with pytest.raises(SchedLaunchError, match="breaker open"):
                await sched.submit("t", pieces[:8], piece_length=8192)
            snap = sched.metrics_snapshot()
            assert (snap["retries"], snap["bisections"]) == (retries, bisections)
            assert snap["cpu_fallback_launches"] == 0
            await asyncio.sleep(0.7)
            before = sha1_pieces_cuda.launches
            t0 = time.monotonic()
            # one launch: the half-open probe
            assert await sched.submit("t", pieces[:8], piece_length=8192) == want[:8]
            assert time.monotonic() - t0 < 60
            br = sched.metrics_snapshot()["breakers"]["sha1/8192"]
            assert br["state"] == "closed", br
            assert br["transitions"].get("open->half_open") == 1
            assert br["transitions"].get("half_open->closed") == 1
            assert sha1_pieces_cuda.launches > before
            before = sha1_pieces_cuda.launches
            assert await sched.submit("t", pieces, piece_length=8192) == want
            assert sha1_pieces_cuda.launches > before
            assert sched.metrics_snapshot()["cpu_fallback_launches"] == 0
        finally:
            await sched.close()

    _sched_run(go())


# ------------------------------------------- multi-process routes on the card
# Rank processes of tests/test_torch_distributed.py's worker with every
# rank on the card. One H100 takes two gloo ranks on cuda:0; NCCL, which
# needs a device a rank, is proved at world size 1.


@pytest.fixture
def built(cuda):
    """The kernels and the pread pool, built here before any rank starts:
    the ranks only load them, never race two builds."""
    from torrent_tpu_torch.native import build as native_build
    from torrent_tpu_torch.ops import sha1_cuda, sha256_cuda

    sha1_cuda.build()
    sha256_cuda.build()
    native_build.build()
    return cuda


def _v1_torrent(tmp_path):
    from test_torch_distributed import PLEN, make_multi

    sizes = [5 * PLEN + 1000, 14 * PLEN + PLEN // 2]
    workdir, payload, torrent, info, _ = make_multi(tmp_path, sizes, seed=5)
    f1 = payload / "f1.bin"
    buf = bytearray(f1.read_bytes())
    buf[9 * PLEN - sizes[0] + 17] ^= 0xFF
    f1.write_bytes(bytes(buf))
    blob = b"".join((payload / f"f{i}.bin").read_bytes() for i in range(len(sizes)))
    expected = "".join(
        "1" if hashlib.sha1(blob[i * PLEN : (i + 1) * PLEN]).digest() == info.pieces[i] else "0"
        for i in range(info.num_pieces)
    )
    assert expected.count("0") == 1
    return workdir, torrent, info, expected


def test_two_gloo_ranks_share_the_card_on_the_v1_route(built, tmp_path):
    from test_torch_distributed import spawn, v1_layout

    workdir, torrent, info, expected = _v1_torrent(tmp_path)
    outs = spawn(workdir, 2, "storage", torrent, device="cuda")
    for rank, rec in enumerate(outs):
        assert rec["backend"] == "gloo" and rec["world_size"] == 2
        assert rec["bitfield"] == rec["routed"] == expected
        assert rec["n_valid"] == expected.count("1")
        assert rec["rows"] == 2 * v1_layout(rank, 2, 8, info.num_pieces)
        assert rec["launches"]["sha1_pieces_cuda"] > 0


def test_two_gloo_ranks_share_the_card_on_the_v2_route(built, tmp_path):
    from torrent_tpu_torch.codec.metainfo_v2 import encode_metainfo_v2
    from torrent_tpu_torch.session.v2 import v2_session_meta

    from test_torch_distributed import spawn

    plen = 65536  # 4 leaves a piece: a 2-level merkle reduction each
    rng = np.random.default_rng(41)
    payload = rng.integers(0, 256, 11 * plen + plen // 2, dtype=np.uint8).tobytes()
    src = tmp_path / "vp.bin"
    src.write_bytes(payload)
    meta = build_v2([(("vp.bin",), str(src))], "vp.bin", plen, hasher="cpu")
    torrent = tmp_path / "vp.torrent"
    torrent.write_bytes(encode_metainfo_v2(meta.info, meta.piece_layers))
    buf = bytearray(payload)
    buf[7 * plen + 5] ^= 0xFF
    src.write_bytes(bytes(buf))
    info = v2_session_meta(meta).info
    expected = verify_pieces(Storage(FsStorage(str(tmp_path)), info), info, hasher="cpu")
    assert list(np.nonzero(~expected)[0]) == [7]
    outs = spawn(tmp_path, 2, "v2", torrent, device="cuda")
    for rank, rec in enumerate(outs):
        assert rec["bitfield"] == "".join("1" if b else "0" for b in expected)
        assert rec["n_valid"] == info.num_pieces - 1
        assert rec["rows"] == list(range(rank, info.num_pieces, 2))
        assert rec["launches"]["sha256_pieces_cuda"] > 0
        assert rec["launches"]["sha256_merkle_cuda"] > 0


def test_nccl_at_world_size_one(built, tmp_path):
    from test_torch_distributed import spawn

    (rec,) = spawn(tmp_path, 1, "nccl1", device="cuda", backend="nccl")
    assert rec["backend"] == "nccl" and rec["world_size"] == 1
    assert rec["count"] == 3 and rec["count_on_card"]
    assert rec["gathered"] == "1001"
    assert rec["peers"] == 0


# The localhost HTTP bridge (torrent_tpu_torch/bridge) on the card: a
# client speaks bencode over a socket, and every hash runs in the kernels
# through the scheduler's lanes.


async def _bridge_http(port, method, path, headers=None, body=b""):
    import asyncio

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    head = [f"{method} {path} HTTP/1.1", "Host: x", f"Content-Length: {len(body)}"]
    head += [f"{k}: {v}" for k, v in (headers or {}).items()]
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, _, payload = data.partition(b"\r\n\r\n")
    return int(head.split()[1]), payload


def _bridge_frames(pieces, expected=None):
    return b"".join(
        len(p).to_bytes(4, "big") + p + (expected[i] if expected is not None else b"")
        for i, p in enumerate(pieces)
    )


def test_bridge_on_card_matches_hashlib(cuda):
    """Buffered /v1/verify and both stream routes (sha1, sha256) answer
    hashlib's verdicts and digests, /v1/info names the card, and the
    kernels' launch counters rise by at least one launch a route."""
    from torrent_tpu_torch.bridge import BridgeServer
    from torrent_tpu_torch.codec.bencode import bdecode

    rng = np.random.default_rng(31)
    pieces = [rng.bytes(int(n)) for n in rng.integers(1, 16385, size=200)]
    sha1 = [hashlib.sha1(p).digest() for p in pieces]
    expected = list(sha1)
    expected[17] = bytes(20)

    async def go():
        svc = await BridgeServer(port=0, hasher="gpu").start()
        try:
            await svc._probe_task
            assert svc.sched.device.type == "cuda"
            st, body = await _bridge_http(svc.port, "GET", "/v1/info")
            info = bdecode(body)
            assert st == 200 and info[b"backend"] == b"gpu"
            assert info[b"sha256_backend"] == b"cuda"
            assert info[b"devices"] == torch.cuda.device_count() >= 1

            s1 = sha1_pieces_cuda.launches
            st, body = await _bridge_http(
                svc.port, "POST", "/v1/verify", {},
                bencode({b"pieces": pieces, b"expected": expected}),
            )
            assert st == 200
            assert bdecode(body)[b"ok"] == bytes(int(i != 17) for i in range(len(pieces)))
            assert sha1_pieces_cuda.launches > s1

            s1 = sha1_pieces_cuda.launches
            st, body = await _bridge_http(
                svc.port, "POST", "/v1/stream/verify", {"X-Piece-Length": "16384"},
                _bridge_frames(pieces, expected),
            )
            out = bdecode(body)
            assert st == 200 and out[b"valid"] == len(pieces) - 1 and out[b"failed"] == 0
            assert sha1_pieces_cuda.launches > s1

            s256 = sha256_pieces_cuda.launches
            st, body = await _bridge_http(
                svc.port, "POST", "/v1/stream/digests",
                {"X-Piece-Length": "16384", "X-Hash-Algo": "sha256"},
                _bridge_frames(pieces),
            )
            assert st == 200
            assert bdecode(body)[b"digests"] == [hashlib.sha256(p).digest() for p in pieces]
            assert sha256_pieces_cuda.launches > s256
            st, _ = await _bridge_http(svc.port, "GET", "/v1/health")
            assert st == 200
        finally:
            svc.close()
            await svc.wait_closed()
        _assert_clean(svc.sched)

    _sched_run(go())


def test_bridge_start_warms_the_card(cuda):
    """``start()`` builds the common lanes' planes and their pinned slots
    before the socket opens; a first request of those geometries
    allocates no new slot."""
    from torrent_tpu_torch.bridge import BridgeServer
    from torrent_tpu_torch.bridge.service import WARM_GEOMETRIES
    from torrent_tpu_torch.codec.bencode import bdecode

    async def go():
        svc = await BridgeServer(port=0, hasher="gpu").start()
        try:
            depth = svc.sched.config.pipeline_depth
            lanes = svc.sched._lanes
            assert len(lanes) == len(WARM_GEOMETRIES)
            for lane in lanes.values():
                assert lane.plane is not None
                assert lane.plane._slots.pinned and lane.plane._slots.allocs == depth
            pieces = [bytes([i]) * (256 << 10) for i in range(8)]
            st, body = await _bridge_http(
                svc.port, "POST", "/v1/digests", {}, bencode({b"pieces": pieces})
            )
            assert st == 200
            assert bdecode(body)[b"digests"] == [hashlib.sha1(p).digest() for p in pieces]
            assert lanes[("sha1", 256 << 10)].plane._slots.allocs == depth
        finally:
            svc.close()
            await svc.wait_closed()
        _assert_clean(svc.sched)

    _sched_run(go())


# --------------------------------------------------------------- session


def _session_swarm(tmp_path, metainfo, files, storage_root, expect):
    """Seed ``storage_root`` and leech into an empty directory through
    the port's tracker and clients, both ``hasher="gpu"`` on the card;
    returns the launch counts of the leech's download."""
    import asyncio

    from torrent_tpu_torch.server.in_memory import run_tracker
    from torrent_tpu_torch.server.tracker import ServeOptions
    from torrent_tpu_torch.session.client import Client, ClientConfig
    from torrent_tpu_torch.session.torrent import TorrentConfig

    async def go():
        server, pump = await run_tracker(
            ServeOptions(http_port=0, udp_port=None, host="127.0.0.1", interval=1)
        )
        meta = metainfo(f"http://127.0.0.1:{server.http_port}/announce")
        clients = []
        try:
            for _ in range(2):
                c = Client(ClientConfig(
                    host="127.0.0.1", hasher="gpu",
                    torrent=TorrentConfig(choke_interval=0.15, announce_retry=1.0),
                ))
                await c.start()
                clients.append(c)
            seed = await clients[0].add(meta, str(storage_root))
            assert seed.bitfield.complete
            for k in expect:
                k.launches = 0
            leech_dir = tmp_path / "leech"
            leech_dir.mkdir()
            leech = await clients[1].add(meta, str(leech_dir))
            await asyncio.wait_for(leech.on_complete.wait(), 120)
            counts = {k.__name__: k.launches for k in expect}
            for rel, data in files.items():
                assert (leech_dir / rel).read_bytes() == data, rel
            return counts
        finally:
            for c in clients:
                await c.close()
            server.close()
            await asyncio.wait_for(pump, 5)

    return asyncio.run(asyncio.wait_for(go(), 300))


def test_session_swarm_ingest_on_card(cuda, tmp_path):
    """A v1 seed → leech on cuda:0: the leech verifies every finished
    piece through the SHA-1 kernel (the client's shared GPUVerifier)."""
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.tools.make_torrent import make_torrent

    rng = np.random.default_rng(81)
    data = rng.integers(0, 256, 40 * 65536 + 999, dtype=np.uint8).tobytes()
    src = tmp_path / "seed"
    src.mkdir()
    (src / "x.bin").write_bytes(data)

    def meta(url):
        return parse_metainfo(make_torrent(str(src / "x.bin"), url, piece_length=65536, hasher="gpu"))

    counts = _session_swarm(tmp_path, meta, {"x.bin": data}, src, [sha1_pieces_cuda])
    assert counts["sha1_pieces_cuda"] > 0, counts


def test_session_v2_swarm_on_card(cuda, tmp_path):
    """A BEP 52 seed → leech on cuda:0: full pieces are verified through
    the SHA-256 row and merkle kernels (2 leaves a piece at least)."""
    from torrent_tpu_torch.codec.metainfo_v2 import encode_metainfo_v2, parse_metainfo_v2

    rng = np.random.default_rng(82)
    files = {
        "multi/a.bin": rng.integers(0, 256, 9 * 65536 + 5, dtype=np.uint8).tobytes(),
        "multi/b/c.bin": rng.integers(0, 256, 4 * 65536, dtype=np.uint8).tobytes(),
    }
    for rel, blob in files.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(blob)
    built = build_v2(
        [(tuple(rel.split("/")[1:]), str(tmp_path / rel)) for rel in files], "multi", 65536, hasher="gpu"
    )

    def meta(url):
        return parse_metainfo_v2(encode_metainfo_v2(built.info, built.piece_layers, url))

    counts = _session_swarm(
        tmp_path, meta, files, tmp_path, [sha256_pieces_cuda, sha256_merkle_cuda]
    )
    assert counts["sha256_pieces_cuda"] > 0 and counts["sha256_merkle_cuda"] > 0, counts


# ---------------------------------------------------------------- magnet


def _magnet_swarm(tmp_path, meta, storage_root, magnet_of, expect):
    """Seed ``meta`` from ``storage_root`` and join it by a magnet from an
    empty directory, both clients ``hasher="gpu"`` on the card with a
    loopback DHT and uTP; returns the leech's launch counts, its peers'
    writer types and its directory."""
    import asyncio

    from torrent_tpu_torch.net.dht import DHTNode
    from torrent_tpu_torch.session.client import Client, ClientConfig
    from torrent_tpu_torch.session.metadata import MetadataError
    from torrent_tpu_torch.session.torrent import TorrentConfig

    async def go():
        boot = await DHTNode(host="127.0.0.1").start()
        clients = []
        try:
            for _ in range(2):
                c = Client(ClientConfig(
                    host="127.0.0.1", hasher="gpu", enable_utp=True, enable_dht=True,
                    dht_bootstrap=(("127.0.0.1", boot.port),),
                    torrent=TorrentConfig(choke_interval=0.15, announce_retry=1.0, dht_interval=0.5),
                ))
                await c.start()
                clients.append(c)
            seed = await clients[0].add(meta, str(storage_root))
            assert seed.bitfield.complete
            for k in expect:
                k.launches = 0
            leech_dir = tmp_path / "leech"
            leech_dir.mkdir()
            for _ in range(80):  # the seed's DHT announce is asynchronous
                try:
                    leech = await clients[1].add_magnet(magnet_of(clients[0]), str(leech_dir))
                    break
                except MetadataError:
                    await asyncio.sleep(0.25)
            writers = set()
            for _ in range(2400):
                if leech.bitfield.complete:
                    break
                writers.update(type(p.writer) for p in leech.peers.values())
                await asyncio.sleep(0.05)
            assert leech.bitfield.complete, leech.status()
            return {k.__name__: k.launches for k in expect}, writers, leech_dir
        finally:
            for c in clients:
                await c.close()
            boot.close()

    return asyncio.run(asyncio.wait_for(go(), 300))


def test_magnet_via_dht_over_utp_on_card(cuda, tmp_path):
    """A hash-only magnet, found through a loopback DHT and carried over
    uTP: the leech verifies every finished piece through the SHA-1
    kernel."""
    from torrent_tpu_torch.codec.magnet import Magnet
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.net.utp import _UtpWriter
    from torrent_tpu_torch.tools.make_torrent import make_torrent

    rng = np.random.default_rng(91)
    data = rng.integers(0, 256, 40 * 65536 + 999, dtype=np.uint8).tobytes()
    src = tmp_path / "seed"
    src.mkdir()
    (src / "x.bin").write_bytes(data)
    meta = parse_metainfo(make_torrent(str(src / "x.bin"), "", piece_length=65536, hasher="gpu"))

    counts, writers, leech_dir = _magnet_swarm(
        tmp_path, meta, src, lambda seed: Magnet(info_hash=meta.info_hash), [sha1_pieces_cuda]
    )
    assert (leech_dir / "x.bin").read_bytes() == data
    assert counts["sha1_pieces_cuda"] > 0, counts
    assert writers == {_UtpWriter}, writers


def test_btmh_magnet_on_card(cuda, tmp_path):
    """A pure-v2 (btmh) magnet with the seed in ``x.pe``: the info dict
    and piece layers come over the wire, and full pieces are verified
    through the SHA-256 row and merkle kernels."""
    from torrent_tpu_torch.codec.magnet import Magnet
    from torrent_tpu_torch.codec.metainfo_v2 import encode_metainfo_v2, parse_metainfo_v2

    rng = np.random.default_rng(92)
    files = {
        "multi/a.bin": rng.integers(0, 256, 9 * 65536 + 5, dtype=np.uint8).tobytes(),
        "multi/b/c.bin": rng.integers(0, 256, 4 * 65536, dtype=np.uint8).tobytes(),
    }
    for rel, blob in files.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(blob)
    built = build_v2(
        [(tuple(rel.split("/")[1:]), str(tmp_path / rel)) for rel in files], "multi", 65536, hasher="gpu"
    )
    meta = parse_metainfo_v2(encode_metainfo_v2(built.info, built.piece_layers, ""))

    def magnet_of(seed):
        return Magnet(info_hash_v2=meta.info_hash_v2, peer_addrs=(("127.0.0.1", seed.port),))

    counts, _, leech_dir = _magnet_swarm(
        tmp_path, meta, tmp_path, magnet_of, [sha256_pieces_cuda, sha256_merkle_cuda]
    )
    for rel, blob in files.items():
        assert (leech_dir / rel).read_bytes() == blob, rel
    assert counts["sha256_pieces_cuda"] > 0 and counts["sha256_merkle_cuda"] > 0, counts


# ------------------------------------------------- tracker deployment


def _get(url, headers=None):
    import urllib.request

    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def test_magnet_through_the_sharded_tracker_streamed_on_card(cuda, tmp_path):
    """The persistent tracker on the card's path: a DHT-only seed is
    harvested by ``start_service``'s indexer into the sharded store; a
    leech with only the info hash and the tracker's URL fetches the
    metadata, streams a Range from mid-file while it downloads, verifies
    every piece through the SHA-1 kernel, and its scheduler recheck
    launches the kernel again."""
    import asyncio

    from torrent_tpu_torch.codec.magnet import Magnet
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.parallel.bulk import verify_library_sched
    from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig
    from torrent_tpu_torch.session.client import Client, ClientConfig
    from torrent_tpu_torch.session.torrent import TorrentConfig
    from torrent_tpu_torch.tools.make_torrent import make_torrent
    from torrent_tpu_torch.tools.serve import start_service
    from torrent_tpu_torch.tools.stream import BoxStreamServer
    from torrent_tpu_torch.utils.metrics import MetricsServer

    rng = np.random.default_rng(93)
    data = rng.integers(0, 256, 48 * 65536 + 777, dtype=np.uint8).tobytes()
    src = tmp_path / "seed"
    src.mkdir()
    (src / "x.bin").write_bytes(data)
    meta = parse_metainfo(make_torrent(str(src / "x.bin"), "", piece_length=65536, hasher="gpu"))

    async def go():
        handle = await start_service(host="127.0.0.1", http_port=0, udp_port=0, dht_port=0,
                                     shards=8, interval=1, crawl_interval=3600.0)
        url = f"http://127.0.0.1:{handle.http_port}/announce"
        torrent_cfg = TorrentConfig(choke_interval=0.15, announce_retry=1.0, dht_interval=0.5)
        seed = Client(ClientConfig(host="127.0.0.1", hasher="gpu", enable_dht=True,
                                   dht_bootstrap=(("127.0.0.1", handle.dht.port),), torrent=torrent_cfg))
        leech = Client(ClientConfig(host="127.0.0.1", hasher="gpu", torrent=torrent_cfg))
        sched = HashPlaneScheduler(SchedulerConfig(), hasher="gpu")
        servers = []
        try:
            await seed.start()
            await leech.start()
            await sched.start()
            assert (await seed.add(meta, str(src))).bitfield.complete
            for _ in range(120):
                if handle.store.metrics_snapshot()["indexed"] >= 1:
                    break
                await asyncio.sleep(0.25)
            assert handle.store.metrics_snapshot()["indexed"] >= 1
            metrics = await MetricsServer(leech).start()
            box = await BoxStreamServer(leech).start()
            servers += [metrics, box]
            sha1_pieces_cuda.launches = 0
            t = await leech.add_magnet(Magnet(info_hash=meta.info_hash, trackers=(url,)), str(tmp_path / "leech"))
            lo = len(data) // 2
            status, body = await asyncio.to_thread(
                _get, f"http://127.0.0.1:{box.port}/{meta.info_hash.hex()}/0", {"Range": f"bytes={lo}-"}
            )
            assert status == 206 and body == data[lo:]
            await asyncio.wait_for(t.on_complete.wait(), 120)
            assert sha1_pieces_cuda.launches > 0
            sha1_pieces_cuda.launches = 0
            res = await verify_library_sched([(t.storage, t.metainfo.info)], sched, tenant="recheck")
            assert bool(res.bitfields[0].all()) and sha1_pieces_cuda.launches > 0
            _, text = await asyncio.to_thread(_get, f"http://127.0.0.1:{metrics.port}/metrics")
            assert f"torrent_tpu_torrent_pieces_have{{info_hash=\"{meta.info_hash.hex()}\"".encode() in text
            _, text = await asyncio.to_thread(_get, f"http://127.0.0.1:{handle.http_port}/metrics")
            assert b"torrent_tpu_tracker_indexed_total" in text
            assert handle.store.metrics_snapshot()["announces"] >= 1
        finally:
            for s in servers:
                s.close()
            await sched.close()
            await seed.close()
            await leech.close()
            await handle.close()

    asyncio.run(asyncio.wait_for(go(), 300))


def test_pure_v2_stream_on_card(cuda, tmp_path):
    """A pure-v2 torrent streamed while it downloads: every byte served
    passed the SHA-256 row and merkle kernels first."""
    import asyncio

    from torrent_tpu_torch.codec.metainfo_v2 import encode_metainfo_v2, parse_metainfo_v2
    from torrent_tpu_torch.server.shard import run_sharded_tracker
    from torrent_tpu_torch.server.tracker import ServeOptions
    from torrent_tpu_torch.session.client import Client, ClientConfig
    from torrent_tpu_torch.session.torrent import TorrentConfig
    from torrent_tpu_torch.tools.stream import StreamServer, content_files

    rng = np.random.default_rng(94)
    files = {
        "multi/a.bin": rng.integers(0, 256, 9 * 65536 + 5, dtype=np.uint8).tobytes(),
        "multi/b/c.bin": rng.integers(0, 256, 4 * 65536, dtype=np.uint8).tobytes(),
    }
    for rel, blob in files.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(blob)
    built = build_v2(
        [(tuple(rel.split("/")[1:]), str(tmp_path / rel)) for rel in files], "multi", 65536, hasher="gpu"
    )

    async def go():
        server, pump = await run_sharded_tracker(
            ServeOptions(http_port=0, udp_port=None, host="127.0.0.1", interval=1)
        )
        meta = parse_metainfo_v2(encode_metainfo_v2(
            built.info, built.piece_layers, f"http://127.0.0.1:{server.http_port}/announce"))
        cfg = TorrentConfig(choke_interval=0.15, announce_retry=1.0)
        clients = [Client(ClientConfig(host="127.0.0.1", hasher="gpu", torrent=cfg)) for _ in range(2)]
        stream = None
        try:
            for c in clients:
                await c.start()
            assert (await clients[0].add(meta, str(tmp_path))).bitfield.complete
            sha256_pieces_cuda.launches = sha256_merkle_cuda.launches = 0
            t = await clients[1].add(meta, str(tmp_path / "leech"))
            stream = await StreamServer(t).start()
            for i, _, _, _ in content_files(t):
                rel = "multi/" + "/".join(t.info.files[i].path)
                status, body = await asyncio.to_thread(_get, f"http://127.0.0.1:{stream.port}/{i}")
                assert status == 200 and body == files[rel], rel
            await asyncio.wait_for(t.on_complete.wait(), 120)
            return sha256_pieces_cuda.launches, sha256_merkle_cuda.launches
        finally:
            if stream is not None:
                stream.close()
            for c in clients:
                await c.close()
            server.close()
            await asyncio.wait_for(pump, 5)

    rows, merkle = asyncio.run(asyncio.wait_for(go(), 300))
    assert rows > 0 and merkle > 0, (rows, merkle)


# ---------------------------------------------------------------- the CLI


def _counts():
    return (sha1_pieces_cuda.launches, sha256_pieces_cuda.launches, sha256_merkle_cuda.launches)


def test_cli_make_and_verify_through_the_kernels(cuda, tmp_path, capsys):
    """``make`` and ``verify`` with the default ``--hasher gpu``: the
    SHA-1 kernel's launches grow, the bytes equal ``--hasher cpu``'s, and
    one flipped byte flags exactly its piece."""
    import time

    from torrent_tpu_torch.tools.cli import main

    rng = np.random.default_rng(1301)
    (tmp_path / "p.bin").write_bytes(rng.bytes(40 * 65536 + 77))
    argv = ["make", str(tmp_path / "p.bin"), "http://t/a", "--piece-length", "65536"]
    stamp = time.time
    try:
        time.time = lambda: 1_760_000_000.0  # one creation date for both
        before = _counts()
        assert main(argv + ["-o", str(tmp_path / "g.torrent")]) == 0
        assert _counts()[0] > before[0]
        assert main(argv + ["-o", str(tmp_path / "c.torrent"), "--hasher", "cpu"]) == 0
    finally:
        time.time = stamp
    assert (tmp_path / "g.torrent").read_bytes() == (tmp_path / "c.torrent").read_bytes()
    capsys.readouterr()
    before = _counts()
    assert main(["verify", str(tmp_path / "g.torrent"), str(tmp_path), "--batch", "16"]) == 0
    assert capsys.readouterr().out == "41/41 pieces valid\n"
    assert _counts()[0] - before[0] == 3  # ceil(41 / 16) launches
    blob = bytearray((tmp_path / "p.bin").read_bytes())
    blob[7 * 65536 + 5] ^= 0x01
    (tmp_path / "p.bin").write_bytes(bytes(blob))
    assert main(["verify", str(tmp_path / "g.torrent"), str(tmp_path)]) == 2
    assert capsys.readouterr().out == "40/41 pieces valid\nfirst invalid pieces: [7]\n"


def test_cli_make_v2_and_verify_through_the_kernels(cuda, tmp_path, capsys):
    """``make --v2`` and ``--hybrid`` and ``verify`` of both on the card:
    the SHA-256 row and merkle kernels launch, and the bytes equal
    hashlib's."""
    from torrent_tpu_torch.tools.cli import main

    rng = np.random.default_rng(1302)
    root = tmp_path / "tree"
    (root / "sub").mkdir(parents=True)
    (root / "a.bin").write_bytes(rng.bytes(3 * (1 << 20) + 5))
    (root / "sub" / "b.bin").write_bytes(rng.bytes(700_000))
    for kind in ("--v2", "--hybrid"):
        base = ["make", str(root), "http://t/a", kind]
        before = _counts()
        assert main(base + ["-o", str(tmp_path / "g.torrent")]) == 0
        after = _counts()
        assert after[1] > before[1] and after[2] > before[2], (kind, before, after)
        if kind == "--hybrid":
            assert after[0] > before[0]
        assert main(base + ["-o", str(tmp_path / "c.torrent"), "--hasher", "cpu"]) == 0
        assert (tmp_path / "g.torrent").read_bytes() == (tmp_path / "c.torrent").read_bytes()
        capsys.readouterr()
        before = _counts()
        assert main(["verify", str(tmp_path / "g.torrent"), str(tmp_path)]) == 0
        assert capsys.readouterr().out == "5/5 pieces valid (v2)\n"
        after = _counts()
        assert after[1] > before[1] and after[2] > before[2], (kind, before, after)


def test_doctor_reports_the_cuda_route(cuda):
    """doctor's kernel checks, scheduler and v2 smokes on the card: the
    ``cuda`` route with grown launch counters and no CPU-fallback launch."""
    import asyncio

    from torrent_tpu_torch.tools import doctor

    doctor._RESULTS.clear()
    assert doctor._check_kernels(None)
    for status, name, detail in doctor._RESULTS:
        assert status == "PASS" and detail.startswith("route=cuda, "), (name, detail)
    assert "cuda lane" in asyncio.run(doctor._sched_smoke())
    assert "(cuda," in asyncio.run(doctor._v2_smoke())


def test_doctor_swarm_smoke_on_card(cuda, tmp_path):
    """The loopback swarm smoke with every piece hashed on the card."""
    import asyncio

    from torrent_tpu_torch.tools import doctor

    before = _counts()
    asyncio.run(asyncio.wait_for(doctor._swarm_smoke(str(tmp_path)), 90))
    assert _counts()[0] > before[0]


# ------------------------------------------------- kernel variants and bench


def _ragged_rows(device, seed, lens, sentinels=()):
    rng = np.random.default_rng(seed)
    pieces = [rng.bytes(n) for n in lens]
    data, nb = on_card(pieces, device, sentinels)
    want = [hashlib.sha1(p).digest() if i not in sentinels else None for i, p in enumerate(pieces)]
    return pieces, data, nb, want


def test_sha1_variant_matches_hashlib(cuda):
    """A non-default SHA-1 build (a 2-stage W+K ring, 2-stage raw rings)
    on ragged rows across a partial 32-piece CTA, and its sentinel rows,
    against hashlib and the production kernel."""
    from torrent_tpu_torch.ops import sha1_cuda

    variant = sha1_cuda.load_variant(wk_stages=2, raw_stages=2, schedule_warps=2)
    assert variant.knobs == {"wk_stages": 2, "raw_stages": 2, "schedule_warps": 2}
    assert variant.library.name.startswith("libtorrent_tpu_torch_sha1_wk2_raw2_sched2_")
    assert variant.lib.tt_sha1_smem_bytes() == sha1_cuda.variant_smem_bytes(2, 2, 2)
    lens = [0, 1, 55, 64, 65, 300, 16384, 65536 + 7] * 5
    _, data, nb, want = _ragged_rows(cuda, 1401, lens, sentinels=(3,))
    got = digests(variant.launch(data, nb))
    prod = sha1_pieces_cuda(data, nb)
    torch.cuda.synchronize()
    assert [g for i, g in enumerate(got) if i != 3] == [w for w in want if w is not None]
    assert got == digests(prod)


def test_sha256_variant_matches_hashlib(cuda):
    """A non-default SHA-256 rows block (128 threads) on ragged rows and
    a sentinel row, against hashlib and the production kernel."""
    from torrent_tpu_torch.ops import sha256_cuda

    variant = sha256_cuda.load_variant(row_threads=128)
    assert variant.lib.tt_sha256_row_threads() == 128
    rng = np.random.default_rng(1402)
    pieces = [rng.bytes(n) for n in [0, 1, 55, 56, 64, 300, 8191, 16384] * 40]
    data, nb = on_card(pieces, cuda, sentinels=(5,))
    got = digests(variant.launch(data, nb))
    prod = digests(sha256_pieces_cuda(data, nb))
    assert got == prod
    assert [g for i, g in enumerate(got) if i != 5] == [
        hashlib.sha256(p).digest() for i, p in enumerate(pieces) if i != 5
    ]


def test_load_variant_leaves_production_untouched(cuda):
    """Building and launching variants changes neither the production
    libraries' path and mtime nor their launch counters."""
    from torrent_tpu_torch.ops import sha1_cuda, sha256_cuda

    sha1_cuda._load()
    sha256_cuda._load()
    libs = {m.LIBRARY: m.LIBRARY.stat().st_mtime_ns for m in (sha1_cuda, sha256_cuda)}
    handles = (sha1_cuda._lib, sha256_cuda._lib)
    before = _counts()
    v1 = sha1_cuda.load_variant(force=True, wk_stages=8, raw_stages=3, schedule_warps=2)
    v2 = sha256_cuda.load_variant(force=True, row_threads=64)
    assert v1.library.parent.name == "variants" and v1.library != sha1_cuda.LIBRARY
    assert v2.library.parent.name == "variants" and v2.library != sha256_cuda.LIBRARY
    _, data, nb, _ = _ragged_rows(cuda, 1403, [4096] * 40)
    v1.launch(data, nb)
    v2.launch(data, nb)
    torch.cuda.synchronize()
    assert _counts() == before
    assert (sha1_cuda._lib, sha256_cuda._lib) == handles
    assert {m: m.stat().st_mtime_ns for m in libs} == libs
    assert v1.report and "registers" in v1.report and v1.build_s > 0


def test_tuners_rank_variants_on_card(cuda, capsys):
    """Both tuners' command lines at small batches: one ranked line a
    variant, every one checked against hashlib, and a best line with the
    winner's -D flags."""
    import json

    from torrent_tpu_torch.tools import tune_sha1, tune_sha256

    assert tune_sha1.main(["--grid", "4.3.2,2.2.2", "--batch", "64", "--piece-kb", "64", "--iters", "2"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["rank"] for r in lines[:2]] == [1, 2] and lines[0]["ms"] <= lines[1]["ms"]
    assert sum(r["default"] for r in lines[:2]) == 1 and all(r["rows_checked"] == 64 for r in lines[:2])
    assert lines[2]["nvcc_defines"] == lines[0]["defines"] and lines[2]["best"]["registers"] > 0
    assert tune_sha256.main(["--grid", "32,64", "--batch", "256", "--iters", "2"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 3 and lines[2]["nvcc_defines"][0].startswith("-DTT_SHA256_ROW_THREADS=")


def test_bench_e2e_gpu_on_card(cuda, tmp_path):
    """``bench e2e --hasher gpu --mb 64`` through the command line: a
    non-null rate on ``cuda``, the SHA-1 counter grown, every slab back."""
    import json

    from torrent_tpu_torch.tools.cli import main

    before = _counts()
    out = tmp_path / "rec.json"
    assert main(["bench", "e2e", "--hasher", "gpu", "--mb", "64", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["value"] is not None and rec["platform"] == "cuda" and rec["plane"] == "gpu"
    assert rec["valid"] == rec["pieces"] == 256 and rec["staging_outstanding"] == 0
    assert _counts()[0] > before[0]


def test_bench_fabric_gpu_workers_on_card(cuda, tmp_path):
    """``tools/bench_fabric.py`` with its default hasher: two
    ``fabric-verify`` workers on the card verify a small library whole,
    each with its own ledger breakdown."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "torrent_tpu_torch.tools.bench_fabric", "--workdir", str(tmp_path),
         "--nproc", "2", "--reps", "1", "--torrents", "2", "--mb-per-torrent", "4",
         "--piece-kb", "256"],
        cwd=repo, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    (rec,) = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    assert rec["hasher"] == "gpu" and rec["valid"] == rec["pieces"] > 0
    assert rec["gib_per_sec"] > 0 and len(rec["per_process"]) == 2
    assert sum(p["pieces_verified"] for p in rec["per_process"]) == rec["pieces"]


def test_device_bench_v2_on_card(cuda, tmp_path):
    """The device bench's v2 config in a child process on the card: the
    record names ``cuda`` and its SHA-256 row and merkle launches."""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ, BENCH_CONFIG="v2", BENCH_TOTAL_MB="32", BENCH_V2_NRES="3",
               BENCH_H2D_MB="8", BENCH_BANK_DIR=str(tmp_path), TORRENT_TPU_LEAF_BATCH="4096")
    env.pop("BENCH_PLATFORM", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "torrent_tpu_torch.tools.device_bench"], env=env,
                          cwd=repo, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["value"] > 0 and rec["platform"] == "cuda" and rec["backend"] == "cuda"
    assert rec["launches"]["sha256_cuda"] > 0 and rec["launches"]["sha256_merkle_cuda"] > 0
    assert len(rec["device_runs_pps"]) == 3


def test_sanitized_sched_and_bridge_on_card(cuda, tmp_path):
    """tests/test_torch_analysis.py's sanitized drive on the card: a fresh
    interpreter with TORRENT_TPU_TSAN=1 rechecks through a bridge's
    scheduler (SHA-1 zero-copy ingest beside a SHA-256 tenant) and answers
    one /v1/verify; both kernels launch, every verdict is hashlib's, and
    the port's sanitizer sees both planes' _device_lock, the lane build
    lock and the staging/slab/breaker cells with zero cycles and races."""
    from test_torch_analysis import check_tsan_drive, run_tsan_drive

    out = run_tsan_drive("cuda", tmp_path, timeout=600)
    check_tsan_drive(out, ["sched.sha1_plane._device_lock", "sched.sha256_cuda_plane._device_lock"])
    assert out["launches"]["sha1_cuda"] > 0 and out["launches"]["sha256_cuda"] > 0, out["launches"]


# ------------------------------------------------------------ the examples


def test_batched_recheck_example_on_card(cuda, capsys):
    """``python -m torrent_tpu_torch.examples.batched_recheck`` with its
    default ``gpu``: authored and rechecked through the SHA-1 kernel, the
    one flipped byte flags exactly its piece, and its lines are hashlib's
    with the hasher's name changed."""
    from torrent_tpu_torch.examples import batched_recheck

    before = _counts()
    assert batched_recheck.main([]) == 0
    gpu = capsys.readouterr().out
    assert _counts()[0] - before[0] >= 3  # make_torrent and two rechecks
    assert gpu.splitlines()[-1] == "after corruption: 19/20 valid; bad pieces [14]"
    assert batched_recheck.main(["cpu"]) == 0
    assert gpu.replace("(gpu)", "(cpu)") == capsys.readouterr().out


# ------------------------------------------------------------ the pipeline ledger's regions


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_direct_recheck_names_its_stages_on_card(cuda, tmp_path, version):
    """Both direct rechecks on the card charge the ledger's stage, h2d,
    launch and digest once a batch, and under a profiler every batch is a
    ``verify.<version>.batch`` region holding the hashing thread's
    ``pipeline.*`` stages and its ``verify.wait_load``, beside the
    kernels and copies of the card."""
    import json

    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.obs.ledger import pipeline_ledger
    from torrent_tpu_torch.tools.make_torrent import make_torrent

    if version == "v1":
        plen, n_pieces, batch = 1 << 16, 40, 16
        (tmp_path / "data.bin").write_bytes(np.random.default_rng(5).bytes(n_pieces * plen - 99))
        info = parse_metainfo(
            make_torrent(str(tmp_path / "data.bin"), "http://t.invalid/a", piece_length=plen, hasher="cpu")
        ).info
        run = lambda: verify_pieces(Storage(FsStorage(tmp_path), info), info, hasher="gpu",  # noqa: E731
                                    batch_size=batch, io_threads=4)
    else:
        files = v2_corpus(tmp_path)
        meta = build_v2(files, "payload", V2_PLEN, hasher="cpu")
        info = v2_session_info(meta.info, meta.piece_layers)
        batch = 3
        by_pad = {}
        for p in range(info.num_pieces):
            by_pad[info.piece_pad_leaves[p]] = by_pad.get(info.piece_pad_leaves[p], 0) + 1
        run = lambda: verify_pieces(Storage(FsStorage(tmp_path), info), info, hasher="gpu",  # noqa: E731
                                    batch_size=batch)
    assert run().all()  # builds and warms up
    batches = -(-info.num_pieces // batch) if version == "v1" else sum(-(-c // batch) for c in by_pad.values())
    led = pipeline_ledger()
    before = led.snapshot()["stages"]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        assert run().all()
    after = led.snapshot()["stages"]
    for stage in ("stage", "h2d", "launch", "digest"):
        assert after[stage]["ops"] - before.get(stage, {"ops": 0})["ops"] == batches, stage
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count(f"verify.{version}.batch") == batches
    for name in ("verify.wait_load", "pipeline.h2d", "pipeline.launch", "pipeline.digest"):
        assert names.count(name) == batches, name
    assert any(e.get("cat") == "kernel" for e in events)


def test_v1_recheck_read_stays_within_the_wall_on_card(cuda, tmp_path):
    """At the v1 recheck's shape (batches of 4096 x 256 KiB read in 4
    stripes), each batch's stripes are one ledger ``read`` entry, over
    their zero-fill, planning and preads: ``read`` stays within the
    recheck's wall time."""
    import time

    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.obs.ledger import pipeline_ledger
    from torrent_tpu_torch.tools.make_torrent import make_torrent

    plen, batch = 256 << 10, 4096
    chunk = np.random.default_rng(18).bytes(1024 * plen)
    path = tmp_path / "data.bin"
    with open(path, "wb") as f:
        for _ in range(8):
            f.write(chunk)
        f.write(chunk[: plen // 2])  # a short last piece in a ragged third batch
    info = parse_metainfo(make_torrent(str(path), "http://t.invalid/a", piece_length=plen, hasher="cpu")).info
    storage = Storage(FsStorage(tmp_path), info)
    verifier = GPUVerifier(piece_length=plen, batch_size=batch, device=cuda)
    assert verifier.verify_storage(storage, info, io_threads=4).all()  # builds and warms up
    led = pipeline_ledger()
    before = led.snapshot()["stages"]["read"]
    t0 = time.monotonic()
    assert verifier.verify_storage(storage, info, io_threads=4).all()
    wall = time.monotonic() - t0
    after = led.snapshot()["stages"]["read"]
    busy = after["busy_s"] - before["busy_s"]
    print(f"v1 recheck {info.num_pieces} x 256 KiB: read busy_s={busy:.4f} wall_s={wall:.4f}")
    assert after["ops"] - before["ops"] == 3
    assert busy <= wall
