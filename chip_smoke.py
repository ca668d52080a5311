#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout, on a GPU host

Phases (any failure exits non-zero, and no phase hides an error):

1. The card: ``nvidia-smi``'s name and power limit, ``torch``'s device
   name. Without CUDA, or outside a checkout, the script exits 1.
2. Build: the SHA-1 kernel (``torrent_tpu_torch/csrc/sha1.cu``, nvcc for
   sm_90a) and the host pread pool, from the checkout's sources; prints
   ptxas' registers, spills and shared memory.
3. The kernel against its plain PyTorch version on the card, bit for
   bit, and both against hashlib: the NIST vectors, a ragged batch
   (lengths 0 … 256 KiB-1), sentinel rows, and one full 4096 x 256 KiB
   batch.
4. The main path at a real size, on a seeded payload written to a
   temporary directory: a single-file torrent of 8192 pieces of 256 KiB
   (the last one short, 2 GiB in all) and a multi-file torrent of 6
   files (184 MB) whose files cross piece boundaries. Each is authored
   with ``make_torrent(hasher="gpu")`` and checked against hashlib's
   authoring, rechecked with ``verify_pieces(hasher="gpu",
   batch_size=4096)`` (all True), then one byte is flipped and a fresh
   storage must flag exactly that piece. The kernel's launch counter is
   reset before this phase and must have grown after it.
5. Times, from CUDA events after warm-up (kernel at 4096 x 256 KiB and
   4096 x 1 MiB, the plain version at 4096 x 256 KiB) and from the host
   clock (end-to-end recheck and hashlib recheck of the 2 GiB file), each
   printed beside the card's name and power limit.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. The page cache holds the payload when
it is rechecked (it was just written), so the end-to-end rate measures
read_batch from memory, padding, copies and the kernel, not a disk.
"""

from __future__ import annotations

import hashlib
import json
import os
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


def main() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this script needs a GPU")
    if not os.path.isdir(os.path.join(REPO, "torrent_tpu_torch")):
        raise SmokeFailure(f"no torrent_tpu_torch/ beside {__file__}: run it from a checkout")
    sys.path.insert(0, REPO)

    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.native import build as native_build
    from torrent_tpu_torch.ops import sha1_cuda
    from torrent_tpu_torch.ops.padding import (
        num_blocks_for,
        pad_pieces,
        padded_len_for,
        words_to_digests,
    )
    from torrent_tpu_torch.ops.sha1_torch import sha1_pieces_torch, words_to_numpy
    from torrent_tpu_torch.parallel.verify import verify_pieces
    from torrent_tpu_torch.storage.storage import FsStorage, Storage
    from torrent_tpu_torch.tools.make_torrent import make_torrent

    # ---------------------------------------------------------------- 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    card = f"[{smi}]"
    log(smi)
    log(f"phase 1: device {kind}, count {torch.cuda.device_count()}, torch {torch.__version__}, cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    # ---------------------------------------------------------------- 2
    t = time.perf_counter()
    report = sha1_cuda.build(force=True)
    log(f"phase 2: built {sha1_cuda.LIBRARY.name} in {time.perf_counter() - t:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "smem" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    check(native_build.build(force=True) is not None, "the host pread pool did not build")
    log("phase 2: built the host pread pool")

    # ---------------------------------------------------------------- 3
    def kernel_and_plain(pieces, sentinel_rows=()):
        padded, nblocks = pad_pieces(pieces)
        nblocks[list(sentinel_rows)] = 0
        d = torch.from_numpy(padded).to(dev)
        n = torch.from_numpy(nblocks).to(dev)
        k_u8 = sha1_cuda.sha1_pieces_cuda(d, n)
        k_u32 = sha1_cuda.sha1_pieces_cuda(d.view(torch.int32), n)
        plain = sha1_pieces_torch(d, n)
        torch.cuda.synchronize()
        return k_u8, k_u32, plain

    def mismatches(a, b) -> int:
        return int((a != b).any(dim=1).sum())

    def digests(words):
        return words_to_digests(words_to_numpy(words))

    rng = np.random.default_rng(SEED)
    total_mismatch = 0
    # NIST vectors
    k, k32, p = kernel_and_plain([m for m, _ in NIST])
    total_mismatch += mismatches(k, p) + mismatches(k32, p)
    check([d.hex() for d in digests(k)] == [h for _, h in NIST], "NIST vectors wrong")
    # ragged lengths, then the same rows with sentinels
    ragged = [rng.bytes(n) for n in RAGGED]
    k, k32, p = kernel_and_plain(ragged)
    total_mismatch += mismatches(k, p) + mismatches(k32, p)
    check(digests(k) == [hashlib.sha1(x).digest() for x in ragged], "ragged batch wrong")
    sentinels = (0, 3, 13)
    k, k32, p = kernel_and_plain(ragged, sentinels)
    total_mismatch += mismatches(k, p) + mismatches(k32, p)
    iv = bytes.fromhex("67452301efcdab8998badcfe10325476c3d2e1f0")
    got = digests(k)
    for i, x in enumerate(ragged):
        check(got[i] == (iv if i in sentinels else hashlib.sha1(x).digest()), f"sentinel batch row {i}")
    # one full recheck batch: 4096 pieces of 256 KiB
    full = [rng.bytes(PIECE) for _ in range(BATCH)]
    padded, nblocks = pad_pieces(full)
    d256 = torch.from_numpy(padded).to(dev)
    n256 = torch.from_numpy(nblocks).to(dev)
    del padded
    k = sha1_cuda.sha1_pieces_cuda(d256, n256)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    p = sha1_pieces_torch(d256, n256)
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
    total_mismatch += mismatches(k, p)
    max_abs_err = int(
        ((k.to(torch.int64) & 0xFFFFFFFF) - (p.to(torch.int64) & 0xFFFFFFFF)).abs().max()
    )
    want = [hashlib.sha1(x).digest() for x in full]
    check(digests(k) == want, "full batch: kernel disagrees with hashlib")
    check(digests(p) == want, "full batch: plain version disagrees with hashlib")
    del full, want
    log(f"kernels: sha1_cuda launches={sha1_cuda.sha1_pieces_cuda.launches} mismatches={total_mismatch}")
    check(total_mismatch == 0 and max_abs_err == 0, "kernel disagrees with its plain version")
    log(f"phase 3: kernel == plain == hashlib on NIST, ragged, sentinel and {BATCH} x 256 KiB batches")

    # ---------------------------------------------------------------- 4
    def recheck_stages(storage) -> dict:
        """Seconds of each stage of one full recheck batch, run apart:
        a pinned slot's allocation, the loader's read (4 striped
        read_batch calls, as verify_storage makes them) and padding on
        the host clock, the host→device copy on CUDA events. The
        kernel's time comes from phase 5."""
        from concurrent.futures import ThreadPoolExecutor

        from torrent_tpu_torch.ops.padding import pad_in_place

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

    sha1_cuda.sha1_pieces_cuda.launches = 0
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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    main_launches = sha1_cuda.sha1_pieces_cuda.launches
    check(main_launches > 0, "the main path launched the SHA-1 kernel no time")
    log(f"phase 4: main path launched sha1_cuda {main_launches} times")

    # ---------------------------------------------------------------- 5
    def time_kernel(data, nb, reps=10) -> float:
        for _ in range(2):
            sha1_cuda.sha1_pieces_cuda(data, nb)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            sha1_cuda.sha1_pieces_cuda(data, nb)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def bound_ms(nb: torch.Tensor, rows: int) -> tuple[float, str]:
        blocks = int(nb.to(torch.int64).sum())
        nbytes = blocks * 64 + rows * 4 + rows * 20  # blocks read, counts read, words written
        t_bytes = nbytes / sha1_cuda.HBM_BYTES_PER_S * 1e3
        t_ops = blocks * sha1_cuda.OPS_PER_BLOCK / sha1_cuda.INT32_OPS_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    ms_256 = time_kernel(d256, n256)
    bound_256, by_256 = bound_ms(n256, BATCH)
    del d256
    # 4096 x 1 MiB, padded on the device (every row a full 1 MiB piece)
    mib = 1 << 20
    rows = BATCH
    p_mib = padded_len_for(mib)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    d1m = torch.randint(0, 256, (rows, p_mib), dtype=torch.uint8, device=dev, generator=g)
    nblk = int(num_blocks_for(mib))
    d1m[:, mib:] = 0
    d1m[:, mib] = 0x80
    d1m[:, nblk * 64 - 8 : nblk * 64] = torch.tensor(
        list((mib * 8).to_bytes(8, "big")), dtype=torch.uint8, device=dev
    )
    n1m = torch.full((rows,), nblk, dtype=torch.int32, device=dev)
    ms_1m = time_kernel(d1m, n1m)
    bound_1m, by_1m = bound_ms(n1m, rows)
    spot = digests(sha1_cuda.sha1_pieces_cuda(d1m[:2].contiguous(), n1m[:2]))
    host = d1m[:2, :mib].cpu().numpy()
    check(spot == [hashlib.sha1(host[i].tobytes()).digest() for i in range(2)], "1 MiB rows wrong")
    del d1m

    s, m = results["single"], results["multi"]
    log(f"time: sha1_cuda {BATCH} x 256 KiB ms={ms_256:.4f} bound_ms={bound_256:.4f} ({by_256}) {card}")
    log(f"time: sha1_cuda {rows} x 1 MiB ms={ms_1m:.4f} bound_ms={bound_1m:.4f} ({by_1m}) {card}")
    log(f"time: sha1_torch (plain) {BATCH} x 256 KiB ms={plain_ms:.1f} {card}")
    for label, r in (("single 2 GiB", s), ("multi 184 MB", m)):
        log(
            f"time: recheck {label} gpu pieces/s={r['pieces'] / r['gpu_s']:.1f} "
            f"GiB/s={r['bytes'] / r['gpu_s'] / 2**30:.3f} s={r['gpu_s']:.3f} "
            f"(second recheck in the process s={r['gpu_again_s']:.3f}); "
            f"hashlib pieces/s={r['pieces'] / r['cpu_s']:.1f} s={r['cpu_s']:.3f}; "
            f"author gpu s={r['author_s']:.3f} hashlib s={r['author_cpu_s']:.3f} {card}"
        )
    log("time: library_ms none (no single PyTorch call computes SHA-1)")
    batches = -(-s["pieces"] // BATCH)
    device_s = batches * (stages["h2d_s"] + ms_256 / 1e3)
    log(
        f"time: recheck stages per {BATCH} x 256 KiB batch: pinned 1 GiB slot alloc "
        f"s={stages['alloc_s']:.4f} read (4 stripes) s={stages['read_s']:.4f} "
        f"pad s={stages['pad_s']:.4f} h2d s={stages['h2d_s']:.4f} kernel s={ms_256 / 1e3:.4f}; "
        f"device busy share of the 2 GiB recheck (h2d + kernel) = {device_s / s['gpu_s']:.3f} {card}"
    )

    kernels = {
        "kernels": [
            {
                "name": "sha1_cuda",
                "route": "cuda",
                "source": "torrent_tpu_torch/csrc/sha1.cu",
                "replaces": "torrent_tpu/ops/sha1_pallas.py:151",
                "launches": main_launches,
                "max_abs_err": max_abs_err,
                "ms": ms_256,
                "plain_ms": plain_ms,
                "bound_ms": bound_256,
                "bound_by": by_256,
                "library_ms": None,
            }
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
