"""The CUDA kernel on the card: tests marked ``gpu``.

They need an NVIDIA GPU with nvcc, decide so inside a fixture, and skip
on hosts without one. This file imports neither jax nor the reference
package, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The kernel is held against its plain PyTorch version on the same device
tensors and against hashlib; digests compare exactly.
"""

import hashlib

import numpy as np
import pytest
import torch

from torrent_tpu_torch.codec.metainfo import InfoDict
from torrent_tpu_torch.entry import entry
from torrent_tpu_torch.models.verifier import GPUVerifier
from torrent_tpu_torch.ops.padding import pad_pieces, words_to_digests
from torrent_tpu_torch.ops.sha1_cuda import make_sha1_fn, sha1_pieces_cuda
from torrent_tpu_torch.ops.sha1_torch import IV, sha1_pieces_torch, words_to_numpy
from torrent_tpu_torch.parallel.verify import verify_pieces
from torrent_tpu_torch.storage.storage import MemoryStorage, Storage

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


def test_entry_on_card(cuda):
    forward, args = entry()
    assert args[0].is_cuda and forward(*args).all()
    assert make_sha1_fn() is sha1_pieces_cuda
