#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout, on a GPU host

Phases (any failure exits non-zero, and no phase hides an error):

1. The card: ``nvidia-smi``'s name and power limit, ``torch``'s device
   name. Without CUDA, or outside a checkout, the script exits 1.
2. Build: the SHA-1 and SHA-256 kernels (``torrent_tpu_torch/csrc/
   sha1.cu`` and ``sha256.cu``, one nvcc for sm_90a each, started
   together) and the host pread pool, from the checkout's sources; prints
   ptxas' registers, spills and static shared memory, the SHA-1 kernel's
   dynamic shared memory, each kernel's SASS instruction count and the
   SHA-1 kernel's SASS opcode mix.
3. Each kernel against its plain PyTorch version on the card, bit for
   bit, and both against hashlib. SHA-1: the NIST vectors, a ragged
   batch (lengths 0 … 256 KiB-1), sentinel rows, a 33-row and a 4097-row
   batch (a partial last CTA of 32 pieces), one full 4096 x 256 KiB
   batch. SHA-256: the NIST vectors (the 1,000,000 x "a" vector against
   hashlib only: the plain version would take minutes over its 15,626
   blocks), ragged lengths 0 … 16 KiB with sentinel rows, u8 and
   int32-viewed input, one full 32768 x 16 KiB leaf launch, and a merkle
   pair level against ``hashlib.sha256(left + right)``. The merkle kernel:
   whole reductions of [B, L, 8] grids (one launch up to its 9-level cap,
   two above it, up to one 2**17-leaf tree) against the plain version and
   a hashlib pair-fold of every tree.
4. The v1 main path at a real size, on a seeded payload written to a
   temporary directory: a single-file torrent of 8192 pieces of 256 KiB
   (the last one short, 2 GiB in all) and a multi-file torrent of 6
   files (184 MB) whose files cross piece boundaries. Each is authored
   with ``make_torrent(hasher="gpu")`` and checked against hashlib's
   authoring, rechecked with ``verify_pieces(hasher="gpu",
   batch_size=4096)`` (all True), then one byte is flipped and a fresh
   storage must flag exactly that piece; the byte is flipped back after.
   The SHA-1 kernel's launch counter is reset before this phase and must
   have grown after it.
5. The v2 (BEP 52) main path on the same payloads at ``make --v2``'s
   default 1 MiB pieces (2048 pieces, the last one short, and the 6
   files): ``build_v2(hasher="gpu")`` must encode the same bytes as
   ``hasher="cpu"``, and ``build_hybrid(hasher="gpu")`` of the multi-file
   payload the same bytes as hashlib's (its v1 pieces go through the
   SHA-1 kernel). ``verify_v2`` and ``verify_pieces`` on the
   ``v2_session_info`` must be all True; after one flipped byte both must
   flag exactly that piece, as hashlib's rechecks do. Every launch
   counter is reset before this phase; the SHA-256 row and merkle kernels
   (and, through hybrid authoring, SHA-1) must have launched in it, the
   merkle kernel at most 58 times (one launch a reduction up to its cap).
6. Times, from CUDA events after warm-up (SHA-1 at 4096 x 256 KiB and
   4096 x 1 MiB, a batch sweep of SHA-1 at 1, 256, 4096 and 16384 rows
   x 256 KiB on rows filled on the card, spot-checked against hashlib,
   SHA-256 at the 32768-leaf authoring launch and the
   16384-leaf recheck launch, one 65536-pair merkle level, and each plain
   version), the merkle reduction at the v2 paths' shapes with its chain
   floor in cycles per level (``torrent_tpu_torch/tools/time_merkle.py``:
   one synced call, back to back, and the device's own time), and from
   the host clock (end-to-end rechecks, authoring and the hashlib
   baselines of the 2 GiB file), each printed beside the card's name and
   power limit.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. The page cache holds the payload when
it is rechecked (it was just written), so the end-to-end rates measure
reads from memory, padding, copies and the kernels, not a disk.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
PIECE = 256 * 1024
BATCH = 4096
# single-file payload: 8192 pieces, the last one 100,000 bytes short
SINGLE_BYTES = 8192 * PIECE - 100_000
# multi-file payload: sizes chosen so files start and end inside pieces
MULTI_FILES = (
    ("a.bin", 100_000_003),
    ("b/tiny.bin", 7),
    ("b/c.bin", PIECE - 1),
    ("d.bin", 50_000_000),
    ("e.bin", 1),
    ("f/g/h.bin", 33_554_433),
)
NIST = (
    (b"", "da39a3ee5e6b4b0d3255bfef95601890afd80709"),
    (b"abc", "a9993e364706816aba3e25717850c26c9cd0d89d"),
    (
        b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq",
        "84983e441c3bd26ebaae4aa1f95129e5e54670f1",
    ),
)
RAGGED = (0, 1, 55, 56, 63, 64, 65, 119, 120, 127, 128, 300, 16 * 1024, PIECE - 1)
# SHA-1 batches around the kernel's 32-piece CTA: rows, longest length
CTA_BATCHES = ((33, 16 * 1024), (4097, 4096))
SWEEP_ROWS = (1, 256, 4096, 16384)  # the phase-6 batch sweep at 256 KiB
NIST256 = (
    (b"", "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
    (b"abc", "ba7816bf8f01cfea414140de5dae2223b00361a396177a9cb410ff61f20015ad"),
    (
        b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq",
        "248d6a61d20638b8e5c026930c3e6039a33ce45964ff2167f6ecedd419db06c1",
    ),
)
MILLION_A256 = "cdc76e5c9914fb9281a1c7e284d73e67f1809a48a497200e046d39ccc7112cd0"
RAGGED256 = (0, 1, 55, 56, 63, 64, 65, 119, 120, 127, 128, 300, 8191, 16383, 16384)
V2_PIECE = 1 << 20  # make --v2's default piece length
LEAF = 16 * 1024  # BEP 52 leaf block
LEAF_LAUNCH = 32768  # leaves per authoring launch (models/v2.py LEAF_BATCH)
VERIFY_LEAVES = 256 * (V2_PIECE // LEAF)  # leaves per v2 recheck launch
PAIRS = 65536  # one merkle level of the 2 GiB payload's leaf grid
# merkle reductions held against hashlib, (trees, leaves per tree): partial,
# full and ragged 512-node CTAs, the v2 recheck batch and authoring piece
# grid, one and two launches
MERKLE_SHAPES = ((1, 2), (5, 8), (3, 64), (256, 64), (2048, 64), (1000, 2), (1, 2048), (2, 4096), (1, 1 << 17))
MERKLE_RECORD = (2048, 64)  # the kernels record's shape: build_v2's piece grid of the 2 GiB payload
MERKLE_PATH_MAX = 58  # merkle launches the v2 phase may make (one a reduction up to the cap)


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def write_random(path: str, nbytes: int, rng: np.random.Generator) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        left = nbytes
        while left:
            n = min(left, 64 << 20)
            f.write(rng.bytes(n))
            left -= n


def flip_byte(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def sass_opcodes(lib) -> dict:
    """SASS opcodes per kernel of a built library, from ``cuobjdump -sass``
    (prologue, loads and stores included), as {kernel: Counter}; {}
    without cuobjdump."""
    from collections import Counter

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120).stdout
    ops: dict = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            ops[name] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name is not None and m:
            ops[name][m.group(1)] += 1
    return ops


def main() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this script needs a GPU")
    if not os.path.isdir(os.path.join(REPO, "torrent_tpu_torch")):
        raise SmokeFailure(f"no torrent_tpu_torch/ beside {__file__}: run it from a checkout")
    sys.path.insert(0, REPO)

    from concurrent.futures import ThreadPoolExecutor

    from torrent_tpu_torch.codec.bencode import bencode
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.models.v2 import build_hybrid, build_v2, verify_v2
    from torrent_tpu_torch.native import build as native_build
    from torrent_tpu_torch.ops import sha1_cuda, sha256_cuda
    from torrent_tpu_torch.ops.padding import (
        alloc_padded,
        digests_to_words,
        num_blocks_for,
        pad_in_place,
        pad_pieces,
        padded_len_for,
        words_to_digests,
    )
    from torrent_tpu_torch.ops.sha1_torch import sha1_pieces_torch, words_to_numpy
    from torrent_tpu_torch.ops.sha256_torch import IV as IV256
    from torrent_tpu_torch.ops.sha256_torch import sha256_merkle_torch, sha256_pairs_torch, sha256_pieces_torch
    from torrent_tpu_torch.parallel.verify import verify_pieces
    from torrent_tpu_torch.session.v2 import v2_session_info
    from torrent_tpu_torch.storage.storage import FsStorage, Storage
    from torrent_tpu_torch.tools.make_torrent import make_torrent
    from torrent_tpu_torch.tools.time_merkle import bound_ms, hashlib_roots, smi, time_shapes

    sha256_rows = sha256_cuda.sha256_pieces_cuda
    sha256_pairs = sha256_cuda.sha256_pairs_cuda
    sha256_merkle = sha256_cuda.sha256_merkle_cuda

    # ---------------------------------------------------------------- 1
    name_and_limit = smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    card = f"[{name_and_limit}]"
    log(name_and_limit)
    log(f"phase 1: device {kind}, count {torch.cuda.device_count()}, torch {torch.__version__}, cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    # ---------------------------------------------------------------- 2
    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        builds = {
            mod.LIBRARY.name: pool.submit(mod.build, force=True) for mod in (sha1_cuda, sha256_cuda)
        }
        pread_pool = pool.submit(native_build.build, force=True)
        reports = {name: fut.result() for name, fut in builds.items()}
        check(pread_pool.result() is not None, "the host pread pool did not build")
    log(f"phase 2: built {', '.join(reports)} and the host pread pool in {time.perf_counter() - t:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "Compiling entry" in line:
                log(f"  ptxas ({name}): {line.strip()}")
    log(
        f"  shared memory (sha1): {sha1_cuda.smem_bytes()} bytes of dynamic shared memory per CTA "
        f"of 32 pieces, {sha1_cuda.ctas_per_sm()} CTAs per SM"
    )
    for mod in (sha1_cuda, sha256_cuda):
        for fn, ops in sass_opcodes(mod.LIBRARY).items():
            log(f"  sass ({mod.LIBRARY.name}): {fn} {sum(ops.values())} instructions")
            if mod is sha1_cuda:
                log(f"  sass mix ({mod.LIBRARY.name}): {' '.join(f'{k}={v}' for k, v in ops.most_common())}")

    def mismatches(a, b) -> int:
        return int((a != b).any(dim=1).sum())

    def abs_err(a, b) -> int:
        return int(((a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64) & 0xFFFFFFFF)).abs().max())

    def digests(words):
        return words_to_digests(words_to_numpy(words))

    def plain_timed(fn, *args):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*args)
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1)

    # ---------------------------------------------------------------- 3
    def kernel_and_plain(kernel, plain, pieces, sentinel_rows=()):
        padded, nblocks = pad_pieces(pieces)
        nblocks[list(sentinel_rows)] = 0
        d = torch.from_numpy(padded).to(dev)
        n = torch.from_numpy(nblocks).to(dev)
        k_u8 = kernel(d, n)
        k_u32 = kernel(d.view(torch.int32), n)
        p = plain(d, n)
        torch.cuda.synchronize()
        return k_u8, k_u32, p

    rng = np.random.default_rng(SEED)
    clock_phase3 = smi("clocks.sm")
    total_mismatch = 0
    # NIST vectors
    k, k32, p = kernel_and_plain(sha1_cuda.sha1_pieces_cuda, sha1_pieces_torch, [m for m, _ in NIST])
    total_mismatch += mismatches(k, p) + mismatches(k32, p)
    check([d.hex() for d in digests(k)] == [h for _, h in NIST], "NIST vectors wrong")
    # ragged lengths, then the same rows with sentinels
    ragged = [rng.bytes(n) for n in RAGGED]
    k, k32, p = kernel_and_plain(sha1_cuda.sha1_pieces_cuda, sha1_pieces_torch, ragged)
    total_mismatch += mismatches(k, p) + mismatches(k32, p)
    check(digests(k) == [hashlib.sha1(x).digest() for x in ragged], "ragged batch wrong")
    sentinels = (0, 3, 13)
    k, k32, p = kernel_and_plain(sha1_cuda.sha1_pieces_cuda, sha1_pieces_torch, ragged, sentinels)
    total_mismatch += mismatches(k, p) + mismatches(k32, p)
    iv = bytes.fromhex("67452301efcdab8998badcfe10325476c3d2e1f0")
    got = digests(k)
    for i, x in enumerate(ragged):
        check(got[i] == (iv if i in sentinels else hashlib.sha1(x).digest()), f"sentinel batch row {i}")
    # batches that end in a partial CTA of the kernel's 32 pieces
    for rows, longest in CTA_BATCHES:
        pieces = [rng.bytes(int(n)) for n in rng.integers(0, longest, size=rows)]
        k, k32, p = kernel_and_plain(sha1_cuda.sha1_pieces_cuda, sha1_pieces_torch, pieces, (1, rows - 1))
        total_mismatch += mismatches(k, p) + mismatches(k32, p)
        got = digests(k)
        for i, x in enumerate(pieces):
            check(got[i] == (iv if i in (1, rows - 1) else hashlib.sha1(x).digest()), f"{rows}-row batch row {i}")
    # one full recheck batch: 4096 pieces of 256 KiB
    full = [rng.bytes(PIECE) for _ in range(BATCH)]
    padded, nblocks = pad_pieces(full)
    d256 = torch.from_numpy(padded).to(dev)
    n256 = torch.from_numpy(nblocks).to(dev)
    del padded
    k = sha1_cuda.sha1_pieces_cuda(d256, n256)
    p, plain_ms = plain_timed(sha1_pieces_torch, d256, n256)
    total_mismatch += mismatches(k, p)
    max_abs_err = abs_err(k, p)
    want = [hashlib.sha1(x).digest() for x in full]
    check(digests(k) == want, "full batch: kernel disagrees with hashlib")
    check(digests(p) == want, "full batch: plain version disagrees with hashlib")
    del full, want
    log(f"kernels: sha1_cuda launches={sha1_cuda.sha1_pieces_cuda.launches} mismatches={total_mismatch}")
    check(total_mismatch == 0 and max_abs_err == 0, "kernel disagrees with its plain version")
    log(
        f"phase 3: sha1 kernel == plain == hashlib on NIST, ragged, sentinel, "
        f"{', '.join(str(r) for r, _ in CTA_BATCHES)}-row and {BATCH} x 256 KiB batches"
    )

    # SHA-256 rows: NIST vectors, ragged lengths with sentinels, u8 and int32
    mis256 = 0
    k, k32, p = kernel_and_plain(sha256_rows, sha256_pieces_torch, [m for m, _ in NIST256])
    mis256 += mismatches(k, p) + mismatches(k32, p)
    check([d.hex() for d in digests(k)] == [h for _, h in NIST256], "sha256: NIST vectors wrong")
    check([d.hex() for d in digests(p)] == [h for _, h in NIST256], "sha256 plain: NIST vectors wrong")
    padded, nblocks = pad_pieces([b"a" * 1_000_000])
    k = sha256_rows(torch.from_numpy(padded).to(dev), torch.from_numpy(nblocks).to(dev))
    check(digests(k)[0].hex() == MILLION_A256, "sha256: 1,000,000 x 'a' wrong")
    ragged = [rng.bytes(n) for n in RAGGED256]
    iv256 = words_to_digests(np.asarray([IV256], dtype=np.uint32))[0]
    for sentinels in ((), (0, 4, 12)):
        k, k32, p = kernel_and_plain(sha256_rows, sha256_pieces_torch, ragged, sentinels)
        mis256 += mismatches(k, p) + mismatches(k32, p)
        got = digests(k)
        for i, x in enumerate(ragged):
            want = iv256 if i in sentinels else hashlib.sha256(x).digest()
            check(got[i] == want, f"sha256 ragged row {i} (sentinels {sentinels})")
    # one full authoring leaf launch: 32768 leaves of 16 KiB
    leaf_padded, leaf_view = alloc_padded(LEAF_LAUNCH, LEAF)
    leaf_view[:] = np.frombuffer(rng.bytes(LEAF_LAUNCH * LEAF), dtype=np.uint8).reshape(LEAF_LAUNCH, LEAF)
    leaf_nb = pad_in_place(leaf_padded, np.full(LEAF_LAUNCH, LEAF))
    d_leaf = torch.from_numpy(leaf_padded).to(dev)
    n_leaf = torch.from_numpy(leaf_nb).to(dev)
    k, first_leaf_ms = plain_timed(sha256_rows, d_leaf, n_leaf)  # the first launch at this shape
    k32 = sha256_rows(d_leaf.view(torch.int32), n_leaf)
    p, plain256_ms = plain_timed(sha256_pieces_torch, d_leaf, n_leaf)
    mis256 += mismatches(k, p) + mismatches(k32, p)
    err256 = abs_err(k, p)
    want = [hashlib.sha256(leaf_view[i].tobytes()).digest() for i in range(LEAF_LAUNCH)]
    check(digests(k) == want, "leaf launch: kernel disagrees with hashlib")
    check(digests(p) == want, "leaf launch: plain version disagrees with hashlib")
    del leaf_padded, leaf_view, want
    log(f"kernels: sha256_cuda launches={sha256_rows.launches} mismatches={mis256}")
    check(mis256 == 0 and err256 == 0, "sha256 kernel disagrees with its plain version")
    # one merkle level: random child digests, parents against hashlib
    kids = rng.bytes(PAIRS * 64)
    pair_words = torch.from_numpy(
        digests_to_words([kids[i : i + 32] for i in range(0, len(kids), 32)], words=8)
        .reshape(PAIRS, 16).view(np.int32)
    ).to(dev)
    k = sha256_pairs(pair_words)
    p, plain_pairs_ms = plain_timed(sha256_pairs_torch, pair_words)
    mis_pairs = mismatches(k, p)
    err_pairs = abs_err(k, p)
    want = [hashlib.sha256(kids[i : i + 64]).digest() for i in range(0, len(kids), 64)]
    check(digests(k) == want, "pair level: kernel disagrees with hashlib")
    check(digests(p) == want, "pair level: plain version disagrees with hashlib")
    del kids, want
    log(f"kernels: sha256_pairs_cuda launches={sha256_pairs.launches} mismatches={mis_pairs}")
    check(mis_pairs == 0 and err_pairs == 0, "pair kernel disagrees with its plain version")
    # whole merkle reductions: random node words, roots against hashlib
    mis_merkle = err_merkle = 0
    for b, l in MERKLE_SHAPES:
        levels = l.bit_length() - 1
        grid = rng.integers(0, 2**32, size=(b, l, 8), dtype=np.uint32)
        words = torch.from_numpy(grid.reshape(-1, 8).view(np.int32)).to(dev)
        launches0 = sha256_merkle.launches
        k = sha256_merkle(words, levels)
        check(
            sha256_merkle.launches - launches0 == len(sha256_cuda.merkle_passes(levels)),
            f"merkle [{b}, {l}]: launches differ from the pass plan",
        )
        p, ms = plain_timed(sha256_merkle_torch, words, levels)
        if (b, l) == MERKLE_RECORD:
            plain_merkle_ms = ms
        mis_merkle += mismatches(k, p)
        err_merkle = max(err_merkle, abs_err(k, p))
        want = hashlib_roots(grid)
        check(digests(k) == want, f"merkle [{b}, {l}]: kernel disagrees with hashlib")
        check(digests(p) == want, f"merkle [{b}, {l}]: plain version disagrees with hashlib")
    log(f"kernels: sha256_merkle_cuda launches={sha256_merkle.launches} mismatches={mis_merkle}")
    check(mis_merkle == 0 and err_merkle == 0, "merkle kernel disagrees with its plain version")
    log(
        f"phase 3: sha256 kernels == plain == hashlib on NIST (+ 1,000,000 x 'a' vs hashlib), "
        f"ragged, sentinel, {LEAF_LAUNCH} x 16 KiB leaf and {PAIRS}-pair level batches, and merkle "
        f"reductions of {', '.join(f'[{b}, {l}]' for b, l in MERKLE_SHAPES)} trees"
    )

    # ---------------------------------------------------------------- 4
    def recheck_stages(storage) -> dict:
        """Seconds of each stage of one full recheck batch, run apart:
        a pinned slot's allocation, the loader's read (4 striped
        read_batch calls, as verify_storage makes them) and padding on
        the host clock, the host→device copy on CUDA events. The
        kernel's time comes from phase 6."""
        ta = time.perf_counter()
        host = torch.empty((BATCH, padded_len_for(PIECE)), dtype=torch.uint8, pin_memory=True)
        alloc_s = time.perf_counter() - ta
        padded = host.numpy()
        view = padded[:, :PIECE]
        step = BATCH // 4
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=4) as pool:
            futs = [
                pool.submit(storage.read_batch, range(s, s + step), out=view[s : s + step])
                for s in range(0, BATCH, step)
            ]
            for f in futs:
                f.result()
        t1 = time.perf_counter()
        padded[:, PIECE:] = 0
        pad_in_place(padded, np.full(BATCH, PIECE))
        t2 = time.perf_counter()
        dev_buf = torch.empty(host.shape, dtype=torch.uint8, device=dev)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        dev_buf.copy_(host, non_blocking=True)
        b.record()
        torch.cuda.synchronize()
        return {
            "alloc_s": alloc_s, "read_s": t1 - t0, "pad_s": t2 - t1,
            "h2d_s": a.elapsed_time(b) / 1e3,
        }

    def v2_stages(path: str, info) -> dict:
        """Seconds of each stage of one v2 authoring launch (the file's
        first LEAF_LAUNCH leaves) and one v2 recheck batch (256 pieces of
        1 MiB), run apart as ``build_v2`` and ``verify_pieces`` run them:
        the host stages on the host clock, the device work (host→device
        copy, kernels) on CUDA events."""
        from torrent_tpu_torch.models.merkle import _merkle_reduce_fused
        from torrent_tpu_torch.models.v2 import _LeafPlane
        from torrent_tpu_torch.native.io_engine import get_engine

        def on_device(fn):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            return out, a.elapsed_time(b) / 1e3

        n = LEAF_LAUNCH * LEAF
        step = n // 4
        buf = np.empty(n, dtype=np.uint8)
        t0 = time.perf_counter()
        get_engine().read_segments([path], [(0, o, o, step) for o in range(0, n, step)], buf)
        t1 = time.perf_counter()
        chunk = buf.tobytes()
        t2 = time.perf_counter()
        plane = _LeafPlane(LEAF_LAUNCH, dev)
        t3 = time.perf_counter()
        k = plane.stage_bytes(chunk)
        t4 = time.perf_counter()
        words, author_dev_s = on_device(lambda: plane.launch(k))
        t5 = time.perf_counter()
        words_to_numpy(words)
        t6 = time.perf_counter()
        del plane, chunk, buf
        storage = Storage(FsStorage(os.path.dirname(path)), info)
        pieces = list(range(256))
        t7 = time.perf_counter()
        pbuf, lengths = storage.read_batch(pieces)
        t8 = time.perf_counter()
        plane = _LeafPlane(VERIFY_LEAVES, dev)
        t9 = time.perf_counter()
        plane.stage_pieces(pbuf, lengths, 64)
        t10 = time.perf_counter()
        merkle0 = sha256_merkle.launches
        _, verify_dev_s = on_device(lambda: _merkle_reduce_fused(plane.launch_grid(256, 64), 6))
        return {
            "verify_merkle_launches": sha256_merkle.launches - merkle0,
            "author_read_s": t1 - t0, "author_tobytes_s": t2 - t1, "author_alloc_s": t3 - t2,
            "author_stage_s": t4 - t3, "author_device_s": author_dev_s, "author_d2h_s": t6 - t5,
            "verify_read_s": t8 - t7, "verify_alloc_s": t9 - t8, "verify_stage_s": t10 - t9,
            "verify_device_s": verify_dev_s,
        }

    def reset_counts() -> None:
        sha1_cuda.sha1_pieces_cuda.launches = 0
        sha256_rows.launches = 0
        sha256_pairs.launches = 0
        sha256_merkle.launches = 0

    reset_counts()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        single = os.path.join(tmp, "single.bin")
        write_random(single, SINGLE_BYTES, rng)
        multi_root = os.path.join(tmp, "multi")
        for rel, size in MULTI_FILES:
            write_random(os.path.join(multi_root, rel), size, rng)
        log(f"phase 4: wrote {SINGLE_BYTES} + {sum(s for _, s in MULTI_FILES)} seeded bytes")

        results = {}
        for label, path, storage_root in (
            ("single", single, tmp),
            ("multi", multi_root, tmp),
        ):
            t = time.perf_counter()
            gpu_torrent = make_torrent(path, "http://localhost/announce", piece_length=PIECE, hasher="gpu")
            author_s = time.perf_counter() - t
            t = time.perf_counter()
            cpu_torrent = make_torrent(path, "http://localhost/announce", piece_length=PIECE, hasher="cpu")
            author_cpu_s = time.perf_counter() - t
            meta = parse_metainfo(gpu_torrent)
            check(meta is not None, f"{label}: authored torrent does not parse")
            check(
                meta.info.pieces == parse_metainfo(cpu_torrent).info.pieces,
                f"{label}: gpu authoring differs from hashlib authoring",
            )
            info = meta.info
            launches0 = sha1_cuda.sha1_pieces_cuda.launches
            t = time.perf_counter()
            bf = verify_pieces(Storage(FsStorage(storage_root), info), info, hasher="gpu", batch_size=BATCH)
            gpu_s = time.perf_counter() - t
            batch_launches = sha1_cuda.sha1_pieces_cuda.launches - launches0
            check(bf.shape == (info.num_pieces,) and bf.all(), f"{label}: clean recheck not all True")
            if label == "single":
                stages = recheck_stages(Storage(FsStorage(storage_root), info))
            # flip one byte deep in the file (single) or inside a piece
            # that spans a file boundary (multi); a fresh FsStorage drops
            # cached handles, as a new process would
            if label == "single":
                victim, off = single, 5000 * PIECE + 777
                bad_piece = 5000
            else:
                # 12,345 bytes into d.bin, whose first piece also holds
                # the tail of the file before it in the torrent's order
                victim, off = os.path.join(multi_root, "d.bin"), 12_345
                start = 0
                for entry in info.files:
                    if entry.path == ("d.bin",):
                        break
                    start += entry.length
                bad_piece = (start + off) // PIECE
                check(start % PIECE != 0, "d.bin should start inside a piece")
            flip_byte(victim, off)
            t = time.perf_counter()
            bf = verify_pieces(Storage(FsStorage(storage_root), info), info, hasher="gpu", batch_size=BATCH)
            gpu_again_s = time.perf_counter() - t
            check(
                list(np.nonzero(~bf)[0]) == [bad_piece],
                f"{label}: expected only piece {bad_piece} False, got {list(np.nonzero(~bf)[0])}",
            )
            t = time.perf_counter()
            cpu_bf = verify_pieces(Storage(FsStorage(storage_root), info), info, hasher="cpu")
            cpu_s = time.perf_counter() - t
            check((cpu_bf == bf).all(), f"{label}: hashlib recheck disagrees with the gpu recheck")
            flip_byte(victim, off)  # restore the seeded payload for phase 5
            results[label] = dict(
                pieces=info.num_pieces, bytes=info.length, gpu_s=gpu_s,
                gpu_again_s=gpu_again_s, cpu_s=cpu_s,
                author_s=author_s, author_cpu_s=author_cpu_s, batch_launches=batch_launches,
            )
            log(
                f"phase 4: {label}: {info.num_pieces} pieces authored (gpu == hashlib), "
                f"recheck all True, flipped byte flags exactly piece {bad_piece}, "
                f"{batch_launches} kernel launches per recheck"
            )
        main_launches = sha1_cuda.sha1_pieces_cuda.launches
        check(main_launches > 0, "the v1 main path launched the SHA-1 kernel no time")
        log(f"phase 4: v1 main path launched sha1_cuda {main_launches} times")

        # ------------------------------------------------------------ 5
        reset_counts()
        v2_results = {}
        multi_files = [(tuple(rel.split("/")), os.path.join(multi_root, rel)) for rel, _ in MULTI_FILES]
        for label, files, name, source_of, victim, off in (
            ("single", [(("single.bin",), single)], "single.bin",
             lambda p: single if p == ("single.bin",) else None,
             ("single.bin",), 5000 * PIECE + 777),
            ("multi", multi_files, "multi",
             lambda p: os.path.join(multi_root, *p),
             ("d.bin",), 12_345),
        ):
            def read_file(path):
                src = source_of(path)
                return src if src is not None and os.path.exists(src) else None

            t = time.perf_counter()
            gpu_meta = build_v2(files, name, V2_PIECE, hasher="gpu", announce="http://localhost/announce")
            author_s = time.perf_counter() - t
            t = time.perf_counter()
            cpu_meta = build_v2(files, name, V2_PIECE, hasher="cpu", announce="http://localhost/announce")
            author_cpu_s = time.perf_counter() - t
            check(bencode(gpu_meta.raw) == bencode(cpu_meta.raw), f"v2 {label}: gpu authoring differs from hashlib")
            hybrid = ""
            if label == "multi":
                t = time.perf_counter()
                blob_gpu, _ = build_hybrid(files, name, V2_PIECE, hasher="gpu", announce="http://localhost/announce")
                hybrid_s = time.perf_counter() - t
                t = time.perf_counter()
                blob_cpu, _ = build_hybrid(files, name, V2_PIECE, hasher="cpu", announce="http://localhost/announce")
                hybrid_cpu_s = time.perf_counter() - t
                check(blob_gpu == blob_cpu, "hybrid: gpu authoring differs from hashlib")
                hybrid = f"hybrid author gpu s={hybrid_s:.3f} hashlib s={hybrid_cpu_s:.3f}"
            info = v2_session_info(gpu_meta.info, gpu_meta.piece_layers)
            t = time.perf_counter()
            res = verify_v2(read_file, gpu_meta, hasher="gpu")
            verify_v2_s = time.perf_counter() - t
            check(all(ok.all() for ok in res.values()), f"v2 {label}: clean verify_v2 not all True")
            t = time.perf_counter()
            bf = verify_pieces(Storage(FsStorage(tmp), info), info, hasher="gpu")
            vp_s = time.perf_counter() - t
            check(bf.shape == (info.num_pieces,) and bf.all(), f"v2 {label}: clean verify_pieces not all True")
            if label == "single":
                single_v2_info = info
            # the flat piece index of the flipped byte (files start on
            # piece boundaries in v2's piece space)
            first = 0
            for f in gpu_meta.info.files:
                if f.path == victim:
                    break
                first += f.num_pieces(V2_PIECE)
            bad_piece = first + off // V2_PIECE
            victim_path = source_of(victim)
            flip_byte(victim_path, off)
            t = time.perf_counter()
            res = verify_v2(read_file, gpu_meta, hasher="gpu")
            verify_v2_again_s = time.perf_counter() - t
            for path, ok in res.items():
                want_bad = [off // V2_PIECE] if path == victim else []
                check(list(np.nonzero(~ok)[0]) == want_bad, f"v2 {label}: verify_v2 flags {path} {list(np.nonzero(~ok)[0])}")
            t = time.perf_counter()
            res_cpu = verify_v2(read_file, gpu_meta, hasher="cpu")
            verify_v2_cpu_s = time.perf_counter() - t
            check(all((res_cpu[p] == ok).all() for p, ok in res.items()), f"v2 {label}: hashlib verify_v2 disagrees")
            t = time.perf_counter()
            bf = verify_pieces(Storage(FsStorage(tmp), info), info, hasher="gpu")
            vp_again_s = time.perf_counter() - t
            check(
                list(np.nonzero(~bf)[0]) == [bad_piece],
                f"v2 {label}: expected only piece {bad_piece} False, got {list(np.nonzero(~bf)[0])}",
            )
            t = time.perf_counter()
            cpu_bf = verify_pieces(Storage(FsStorage(tmp), info), info, hasher="cpu")
            vp_cpu_s = time.perf_counter() - t
            check((cpu_bf == bf).all(), f"v2 {label}: hashlib recheck disagrees with the gpu recheck")
            flip_byte(victim_path, off)
            v2_results[label] = dict(
                pieces=info.num_pieces, bytes=info.payload_length, author_s=author_s,
                author_cpu_s=author_cpu_s, verify_v2_s=verify_v2_s,
                verify_v2_again_s=verify_v2_again_s, verify_v2_cpu_s=verify_v2_cpu_s,
                vp_s=vp_s, vp_again_s=vp_again_s, vp_cpu_s=vp_cpu_s, hybrid=hybrid,
            )
            log(
                f"phase 5: v2 {label}: {info.num_pieces} pieces of 1 MiB authored (gpu == hashlib"
                f"{', hybrid gpu == hashlib' if hybrid else ''}), verify_v2 and verify_pieces all True, "
                f"flipped byte flags exactly piece {bad_piece}"
            )
        v2_launches = {
            "sha256_cuda": sha256_rows.launches,
            "sha256_merkle_cuda": sha256_merkle.launches,
            "sha256_pairs_cuda": sha256_pairs.launches,
            "sha1_cuda": sha1_cuda.sha1_pieces_cuda.launches,
        }
        for name in ("sha256_cuda", "sha256_merkle_cuda", "sha1_cuda"):
            check(v2_launches[name] > 0, f"the v2 main path launched {name} no time")
        check(
            v2_launches["sha256_merkle_cuda"] <= MERKLE_PATH_MAX,
            f"the v2 main path made {v2_launches['sha256_merkle_cuda']} merkle launches, more than {MERKLE_PATH_MAX}",
        )
        log(f"phase 5: v2 main path launches {v2_launches}")
        # measured after the counts are read: its launches are not the path's
        stages_v2 = v2_stages(single, single_v2_info)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---------------------------------------------------------------- 6
    clock_phase6 = smi("clocks.sm")

    def time_kernel(fn, *args, reps=10) -> float:
        for _ in range(2):
            fn(*args)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn(*args)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def rows_bound(nb: torch.Tensor, words_out: int, ops_per_block: int) -> tuple[float, str]:
        blocks = int(nb.to(torch.int64).sum())
        rows = nb.shape[0]
        # blocks read, counts read, words written
        return bound_ms(sha1_cuda, blocks * 64 + rows * 4 + rows * 4 * words_out, blocks * ops_per_block)

    def device_rows(rows: int, piece: int):
        """``rows`` seeded random pieces of ``piece`` bytes, made and padded
        on the card as ops/padding.py pads them, and their block counts."""
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + rows)
        d = torch.randint(0, 256, (rows, padded_len_for(piece)), dtype=torch.uint8, device=dev, generator=g)
        nblk = int(num_blocks_for(piece))
        d[:, piece:] = 0
        d[:, piece] = 0x80
        d[:, nblk * 64 - 8 : nblk * 64] = torch.tensor(
            list((piece * 8).to_bytes(8, "big")), dtype=torch.uint8, device=dev
        )
        return d, torch.full((rows,), nblk, dtype=torch.int32, device=dev)

    def timed_and_checked(d, n, piece: int, label: str):
        """The SHA-1 kernel's ms per launch on (d, n), and a few rows of
        one launch's output against hashlib."""
        ms = time_kernel(sha1_cuda.sha1_pieces_cuda, d, n)
        got = digests(sha1_cuda.sha1_pieces_cuda(d, n))
        rows = d.shape[0]
        for i in sorted({0, 1, 31, 32, rows // 2, rows - 1} & set(range(rows))):
            want = hashlib.sha1(d[i, :piece].cpu().numpy().tobytes()).digest()
            check(got[i] == want, f"{label}: row {i} disagrees with hashlib")
        return ms

    ms_256 = time_kernel(sha1_cuda.sha1_pieces_cuda, d256, n256)
    bound_256, by_256 = rows_bound(n256, 5, sha1_cuda.OPS_PER_BLOCK)
    del d256
    # 4096 x 1 MiB (every row a full 1 MiB piece)
    mib = 1 << 20
    rows = BATCH
    d1m, n1m = device_rows(rows, mib)
    ms_1m = timed_and_checked(d1m, n1m, mib, "1 MiB rows")
    bound_1m, by_1m = rows_bound(n1m, 5, sha1_cuda.OPS_PER_BLOCK)
    del d1m
    # the batch sweep at 256 KiB: leading slices of one device batch
    d_sweep, n_sweep = device_rows(max(SWEEP_ROWS), PIECE)
    sweep = {}
    for r in SWEEP_ROWS:
        ms = timed_and_checked(d_sweep[:r], n_sweep[:r], PIECE, f"sweep {r} rows")
        sweep[r] = (ms, *rows_bound(n_sweep[:r], 5, sha1_cuda.OPS_PER_BLOCK))
    del d_sweep

    ms_leaf = time_kernel(sha256_rows, d_leaf, n_leaf)
    bound_leaf, by_leaf = rows_bound(n_leaf, 8, sha256_cuda.OPS_PER_BLOCK)
    ms_verify_leaf = time_kernel(sha256_rows, d_leaf[:VERIFY_LEAVES], n_leaf[:VERIFY_LEAVES])
    bound_verify_leaf, by_verify_leaf = rows_bound(n_leaf[:VERIFY_LEAVES], 8, sha256_cuda.OPS_PER_BLOCK)
    del d_leaf
    # the merkle reduction at the v2 paths' shapes and one pair level; the
    # JSON records take the device's own time (the host's launch work is
    # on the time: lines) at the authoring piece grid, whose plain version
    # phase 3 timed, and at the pair level
    merkle_times = {r["name"]: r for r in time_shapes()}
    pair_rec, grid_rec = merkle_times["pair level"], merkle_times["authoring piece grid"]
    b, l, _ = grid_rec["shape"]
    check((b, l) == MERKLE_RECORD, f"time_merkle's authoring piece grid is [{b}, {l}, 8], not {MERKLE_RECORD}")

    s, m = results["single"], results["multi"]
    log(f"time: sha1_cuda {BATCH} x 256 KiB ms={ms_256:.4f} bound_ms={bound_256:.4f} ({by_256}) {card}")
    log(f"time: sha1_cuda {rows} x 1 MiB ms={ms_1m:.4f} bound_ms={bound_1m:.4f} ({by_1m}) {card}")
    for r, (ms, bound, by) in sweep.items():
        log(f"time: sha1_cuda sweep {r} x 256 KiB ms={ms:.4f} bound_ms={bound:.4f} ({by}) {card}")
    log(f"time: sha1_torch (plain) {BATCH} x 256 KiB ms={plain_ms:.1f} {card}")
    log(f"time: sha256_cuda {LEAF_LAUNCH} x 16 KiB ms={ms_leaf:.4f} bound_ms={bound_leaf:.4f} ({by_leaf}) {card}")
    log(
        f"time: sha256_cuda {VERIFY_LEAVES} x 16 KiB ms={ms_verify_leaf:.4f} "
        f"bound_ms={bound_verify_leaf:.4f} ({by_verify_leaf}) {card}"
    )
    log(
        f"time: sha256_cuda first launch of the process at {LEAF_LAUNCH} x 16 KiB "
        f"ms={first_leaf_ms:.4f}; SM clock before phase 3 {clock_phase3}, before phase 6 {clock_phase6} {card}"
    )
    log(f"time: sha256_torch (plain) {LEAF_LAUNCH} x 16 KiB ms={plain256_ms:.1f} {card}")
    log(f"time: sha256_pairs_torch (plain) {PAIRS} pairs ms={plain_pairs_ms:.1f} {card}")
    log(f"time: sha256_merkle_torch (plain) [{b}, {l}, 8] ms={plain_merkle_ms:.1f} {card}")
    for label, r in (("single 2 GiB", s), ("multi 184 MB", m)):
        log(
            f"time: recheck {label} gpu pieces/s={r['pieces'] / r['gpu_s']:.1f} "
            f"GiB/s={r['bytes'] / r['gpu_s'] / 2**30:.3f} s={r['gpu_s']:.3f} "
            f"(second recheck in the process s={r['gpu_again_s']:.3f}); "
            f"hashlib pieces/s={r['pieces'] / r['cpu_s']:.1f} s={r['cpu_s']:.3f}; "
            f"author gpu s={r['author_s']:.3f} hashlib s={r['author_cpu_s']:.3f} {card}"
        )
    for label, r in (("single 2 GiB", v2_results["single"]), ("multi 184 MB", v2_results["multi"])):
        log(
            f"time: v2 {label} (1 MiB pieces) build_v2 gpu s={r['author_s']:.3f} "
            f"hashlib s={r['author_cpu_s']:.3f}; verify_v2 gpu s={r['verify_v2_s']:.3f} "
            f"GiB/s={r['bytes'] / r['verify_v2_s'] / 2**30:.3f} (after the flip s={r['verify_v2_again_s']:.3f}) "
            f"hashlib s={r['verify_v2_cpu_s']:.3f}; verify_pieces gpu s={r['vp_s']:.3f} "
            f"pieces/s={r['pieces'] / r['vp_s']:.1f} (after the flip s={r['vp_again_s']:.3f}) "
            f"hashlib s={r['vp_cpu_s']:.3f} pieces/s={r['pieces'] / r['vp_cpu_s']:.1f}"
            f"{'; ' + r['hybrid'] if r['hybrid'] else ''} {card}"
        )
    log(
        "time: v2 stages, one authoring launch of "
        f"{LEAF_LAUNCH} leaves: read (4 stripes) s={stages_v2['author_read_s']:.4f} "
        f"tobytes s={stages_v2['author_tobytes_s']:.4f} staging alloc s={stages_v2['author_alloc_s']:.4f} "
        f"stage+pad s={stages_v2['author_stage_s']:.4f} h2d+kernel s={stages_v2['author_device_s']:.4f} "
        f"words d2h s={stages_v2['author_d2h_s']:.4f}; one recheck batch of 256 x 1 MiB: "
        f"read_batch s={stages_v2['verify_read_s']:.4f} staging alloc s={stages_v2['verify_alloc_s']:.4f} "
        f"stage_pieces s={stages_v2['verify_stage_s']:.4f} h2d+leaf kernel+"
        f"{stages_v2['verify_merkle_launches']} merkle launch(es) s={stages_v2['verify_device_s']:.4f} {card}"
    )
    log("time: library_ms none (no single PyTorch call computes SHA-1 or SHA-256)")
    batches = -(-s["pieces"] // BATCH)
    device_s = batches * (stages["h2d_s"] + ms_256 / 1e3)
    log(
        f"time: recheck stages per {BATCH} x 256 KiB batch: pinned 1 GiB slot alloc "
        f"s={stages['alloc_s']:.4f} read (4 stripes) s={stages['read_s']:.4f} "
        f"pad s={stages['pad_s']:.4f} h2d s={stages['h2d_s']:.4f} kernel s={ms_256 / 1e3:.4f}; "
        f"device busy share of the 2 GiB recheck (h2d + kernel) = {device_s / s['gpu_s']:.3f} {card}"
    )

    def record(name, source, replaces, launches, err, ms, plain, bound, by):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
        }

    kernels = {
        "kernels": [
            record("sha1_cuda", "torrent_tpu_torch/csrc/sha1.cu", "torrent_tpu/ops/sha1_pallas.py:151",
                   main_launches, max_abs_err, ms_256, plain_ms, bound_256, by_256),
            record("sha256_cuda", "torrent_tpu_torch/csrc/sha256.cu", "torrent_tpu/ops/sha256_pallas.py:200",
                   v2_launches["sha256_cuda"], err256, ms_leaf, plain256_ms, bound_leaf, by_leaf),
            record("sha256_pairs_cuda", "torrent_tpu_torch/csrc/sha256.cu", "torrent_tpu/models/merkle.py:30",
                   v2_launches["sha256_pairs_cuda"], err_pairs, pair_rec["device_ms"], plain_pairs_ms,
                   pair_rec["bound_ms"], pair_rec["bound_by"]),
            record("sha256_merkle_cuda", "torrent_tpu_torch/csrc/sha256.cu", "torrent_tpu/models/merkle.py:49",
                   v2_launches["sha256_merkle_cuda"], err_merkle, grid_rec["device_ms"], plain_merkle_ms,
                   grid_rec["bound_ms"], grid_rec["bound_by"]),
        ]
    }
    log(json.dumps(kernels))
    leaked = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "torrent_tpu"))
    check(not leaked, f"the port imported {leaked}")
    return {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}


if __name__ == "__main__":
    try:
        result = main()
    except Exception:  # the boundary: report and fail, never exit 0
        traceback.print_exc()
        print("chip_smoke: FAILED", flush=True)
        sys.exit(1)
    print(json.dumps(result), flush=True)
