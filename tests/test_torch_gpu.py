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
