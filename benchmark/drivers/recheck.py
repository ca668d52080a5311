"""Driver ``recheck``: whole rechecks of one single-file torrent, back to
back, through the port's entry ``parallel/verify.py::verify_pieces``.

Set-up writes the configuration's payload from the seed (random bytes
made on the card by a ``torch.Generator``, in chunks, into the page
cache under ``TMPDIR``), authors its v1 or v2 torrent with the plain
reference, has the port parse it as any ``.torrent``, flips one byte in
a seeded share of the pieces on disk, flushes the file to disk, and
runs one recheck to warm up.
Each unit of the window is a full recheck on a fresh ``FsStorage`` (a
resume: a new process's storage); every unit's bitfield is judged.

Traffic parameters: ``flip_share`` (pieces with one flipped byte).
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

import numpy as np

from benchmark.reference import hashes
from benchmark.reference.metainfo import v1_single_file, v2_single_file

CHUNK_BYTES = 256 << 20  # a multiple of every configuration's piece length
CONTROL_SHARE = 0.5  # the control hashes this share of the pieces and passes the rest


class PortRecheck:
    """The timed call: one full recheck by the port on a fresh storage.
    The benchmark's own spans time each ``Storage.read_batch`` the port
    makes (the storage-read layer), from whatever thread makes it."""

    def __init__(self):
        self.read_spans: list[tuple[float, float]] = []

    def __call__(self, root: str, info, config: dict, device):
        from torrent_tpu_torch.parallel.verify import verify_pieces
        from torrent_tpu_torch.storage.storage import FsStorage, Storage

        storage = Storage(FsStorage(root), info)
        real, spans = storage.read_batch, self.read_spans

        def read_batch(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                spans.append((t0, time.perf_counter()))

        storage.read_batch = read_batch
        return verify_pieces(storage, info, hasher="gpu", batch_size=config["batch_size"], device=device)


def piece_digest(data, config: dict) -> bytes:
    """The reference's digest of one piece: SHA-1 (v1) or its BEP 52
    subtree root (v2, a piece of a multi-piece file)."""
    if config["version"] == 1:
        return hashlib.sha1(data).digest()
    return hashes.merkle_root(hashes.leaf_hashes(data), config["piece_length"] // hashes.LEAF)


def piece_spans(config: dict) -> list[tuple[int, int]]:
    plen, total = config["piece_length"], config["total_bytes"]
    return [(s, min(plen, total - s)) for s in range(0, total, plen)]


def write_payload(path: str, config: dict, seed: int, device) -> tuple[list[bytes], float]:
    """The configuration's payload: random bytes from ``seed``, made on
    ``device`` (None: the card) by a ``torch.Generator`` in chunks and
    written to ``path``. Returns the reference's digest of every piece
    (SHA-1, or the BEP 52 piece root for version 2) and the seconds the
    reference took to work them out."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    digests: list[bytes] = []
    reference_s = 0.0
    total, plen = config["total_bytes"], config["piece_length"]
    with open(path, "wb") as f:
        for start in range(0, total, CHUNK_BYTES):
            n = min(CHUNK_BYTES, total - start)
            chunk = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev, generator=gen).cpu().numpy()
            f.write(chunk.data)
            t = time.perf_counter()
            if config["version"] == 1:
                digests += hashes.sha1_pieces(chunk, plen)
            else:
                digests += hashes.v2_piece_roots(chunk, plen)
            reference_s += time.perf_counter() - t
    return digests, reference_s


class ControlRecheck:
    """The control in the program's place: the reference rechecks a
    seeded half of the pieces and passes the rest unread (a sampled
    recheck, the step that would halve the work)."""

    def __init__(self, seed: int, config: dict, digests: list[bytes]):
        self.config, self.digests = config, digests
        self.rng = np.random.default_rng([seed, 7])

    def __call__(self, root: str, info, config: dict, device):
        spans = piece_spans(config)
        sampled = self.rng.random(len(spans)) < CONTROL_SHARE
        path = os.path.join(root, config["file_name"])
        fd = os.open(path, os.O_RDONLY)
        try:
            def one(i):
                off, n = spans[i]
                return piece_digest(os.pread(fd, n, off), config) == self.digests[i]

            todo = [int(i) for i in np.flatnonzero(sampled)]
            ok = np.ones(len(spans), dtype=bool)
            ok[todo] = hashes.map_threads(one, todo)
        finally:
            os.close(fd)
        return ok


class Cell:
    def __init__(self, ctx, program=None):
        self.ctx, self.config = ctx, ctx.config
        self.program = program
        self.bitfields: list = []
        self.reference_s = 0.0  # set-up seconds of the reference's own digests, left out of setup_s

    # ---------------------------------------------------------- set-up

    def _author(self, digests: list[bytes]):
        """The torrent's bytes by the reference, parsed by the port."""
        cfg = self.config
        name, total, plen = cfg["file_name"], cfg["total_bytes"], cfg["piece_length"]
        if cfg["version"] == 1:
            from torrent_tpu_torch.codec.metainfo import parse_metainfo

            return parse_metainfo(v1_single_file(name, total, plen, digests)).info
        from torrent_tpu_torch.codec.metainfo_v2 import parse_metainfo_v2
        from torrent_tpu_torch.session.v2 import v2_session_info

        meta = parse_metainfo_v2(v2_single_file(name, total, plen, digests))
        return v2_session_info(meta.info, meta.piece_layers)

    def setup(self) -> None:
        cfg = self.config
        self.root = os.path.join(self.ctx.tmpdir, "data")
        os.makedirs(self.root)
        path = os.path.join(self.root, cfg["file_name"])
        self.digests, self.reference_s = write_payload(path, cfg, self.ctx.seed, self.ctx.device)
        self.info = self._author(self.digests)
        spans = piece_spans(cfg)
        if len(self.digests) != len(spans) or self.info.num_pieces != len(spans):
            raise RuntimeError(f"{len(self.digests)} digests, {self.info.num_pieces} pieces, {len(spans)} spans")
        # one flipped byte in a seeded share of the pieces; the reference
        # reads each flipped piece back and judges it again
        rng = np.random.default_rng([self.ctx.seed, 1])
        n_flip = max(1, round(self.ctx.traffic["flip_share"] * len(spans)))
        flipped = sorted(int(i) for i in rng.choice(len(spans), n_flip, replace=False))
        self.expected = np.ones(len(spans), dtype=bool)
        fd = os.open(path, os.O_RDWR)
        try:
            for i in flipped:
                off, n = spans[i]
                at = off + int(rng.integers(n))
                byte = os.pread(fd, 1, at)[0] ^ int(rng.integers(1, 256))
                os.pwrite(fd, bytes([byte]), at)
                t = time.perf_counter()
                self.expected[i] = piece_digest(os.pread(fd, n, off), cfg) == self.digests[i]
                self.reference_s += time.perf_counter() - t
            # a fresh payload is written back in the background for some tens
            # of seconds, and rechecks run slower meanwhile: flush it here, in
            # set-up, so that the window starts after it
            t = time.perf_counter()
            os.fsync(fd)
            print(f"recheck set-up: payload fsync {time.perf_counter() - t:.3f} s", file=sys.stderr)
        finally:
            os.close(fd)
        if self.program is None:
            self.program = ControlRecheck(self.ctx.seed, cfg, self.digests) if self.ctx.control else PortRecheck()
        self.program(self.root, self.info, cfg, self.ctx.device)  # warm-up: builds, first-use allocation

    # ---------------------------------------------------------- window

    def window(self, seconds: float, hooks) -> dict:
        cfg = self.config
        times = []
        hooks.start()
        while True:
            t = time.perf_counter()
            self.bitfields.append(np.asarray(self.program(self.root, self.info, cfg, self.ctx.device)))
            times.append(time.perf_counter() - t)
            if time.perf_counter() - hooks.t0 >= seconds:
                break
        hooks.end()
        q = np.percentile(times, [0, 25, 50, 75, 100])
        print(f"recheck window: units={len(times)} seconds min/p25/p50/p75/max " + " ".join(f"{x:.4f}" for x in q), file=sys.stderr)
        if isinstance(self.program, PortRecheck):
            hooks.evidence["read_spans"] = [(a, b) for a, b in self.program.read_spans if b > hooks.t0]
        n = len(self.bitfields)
        lengths = [length for _, length in piece_spans(cfg)]
        if cfg["version"] == 1:
            hooks.evidence["hashed"] = {"repeats": n, "sha1_lengths": lengths}
        else:
            leaves = [min(hashes.LEAF, length - s) for length in lengths for s in range(0, length, hashes.LEAF)]
            hooks.evidence["hashed"] = {
                "repeats": n,
                "sha256_lengths": leaves,
                "merkle_trees": [cfg["piece_length"] // hashes.LEAF] * len(lengths),
            }
        hooks.evidence["work_bytes"] = n * cfg["total_bytes"]
        return {
            "attempted": n,
            "failed": sum(1 for bf in self.bitfields if bf.shape != self.expected.shape),
            "e2e": {},
        }

    # ---------------------------------------------------------- judging

    def check(self) -> dict:
        """Every bitfield of the window against the reference's, piece by piece."""
        n = len(self.expected)
        wrong = sum(n if bf.shape != self.expected.shape else int((bf != self.expected).sum()) for bf in self.bitfields)
        return {"bitfield_mismatches": (wrong, 0)}

    def close(self) -> None:
        self.info = None
