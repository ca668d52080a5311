"""BitTorrent v2 hashing/verify pipeline — batched SHA-256 + merkle.

Authoring and resume-recheck for BEP 52 torrents on the GPU hash plane,
the counterpart of ``torrent_tpu/models/v2.py``:

- ``hash_file_v2``    — one file's bytes → (pieces_root, piece layer)
- ``build_v2``        — author a pure-v2 torrent from (path, source)s
- ``build_hybrid``    — author a hybrid v1+v2 torrent (BEP 52 upgrade path)
- ``verify_v2``       — recheck files against piece layers; returns a
                        per-piece bool array for every file (the v2
                        analogue of the v1 bitfield)

Leaves are uniform 16 KiB blocks → padded rows of a leaf launch: up to
``LEAF_BATCH`` rows staged in pinned host memory, one host→device copy and
one SHA-256 kernel launch each (``_LeafPlane``). The merkle levels above
them reduce on the device, one pair launch per level per shape group
across ALL files (``roots_batched``, ``models/merkle.py``).

``hasher="gpu"`` runs on ``device`` (None means the GPU and raises without
one; ``device="cpu"`` runs the plain PyTorch versions, as the tests do).
``hasher="cpu"`` is device-free END TO END — hashlib leaves AND hashlib
merkle folds (``_root_cpu``) — so an explicitly-CPU author/verify never
touches torch's devices.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from torrent_tpu_torch.codec.metainfo_v2 import (
    BLOCK,
    InfoDictV2,
    MetainfoV2,
    V2File,
    encode_metainfo_v2,
    parse_metainfo_v2,
    valid_path_component,
)
from torrent_tpu_torch.models.merkle import (
    digests_to_words32,
    file_root_from_piece_roots,
    merkle_root,
    pad_leaves,
    piece_roots_from_leaves,
    small_file_root,
    words32_to_digests,
    zero_chain,
)
from torrent_tpu_torch.obs.profiler import annotate
from torrent_tpu_torch.ops.padding import pad_in_place, padded_len_for
from torrent_tpu_torch.ops.sha256_cuda import make_sha256_fn
from torrent_tpu_torch.utils.device import resolve_device
from torrent_tpu_torch.utils.env import env_int

# Leaf blocks hashed per device launch: 32768 × 16 KiB = 512 MiB of
# payload (541 MB of padded rows) staged per launch. Memory-constrained
# hosts can dial it back via the env knob.
LEAF_BATCH = env_int("TORRENT_TPU_LEAF_BATCH", 32768)

# A "source" is either resident bytes or a filesystem path (str) that is
# streamed in LEAF_BATCH-block chunks — a 60 GiB file never holds more
# than one chunk (LEAF_BATCH x 16 KiB) in memory.


def _check_hasher(hasher: str) -> None:
    if hasher not in ("cpu", "gpu"):
        raise ValueError(f"unknown hasher {hasher!r}: expected 'cpu' or 'gpu'")


def source_len(source) -> int:
    if isinstance(source, (bytes, bytearray, memoryview)):
        return len(source)
    import os

    return os.path.getsize(source)


def _iter_source(source, chunk_bytes: int):
    """Yield ``chunk_bytes``-sized slices of the source (last may be short).

    Path sources go through the native C++ pread pool when it's built
    (striped parallel reads per chunk — the same engine behind
    ``Storage.read_batch``); plain buffered reads otherwise.
    """
    if isinstance(source, (bytes, bytearray, memoryview)):
        mv = memoryview(source)
        for off in range(0, len(mv), chunk_bytes):
            yield bytes(mv[off : off + chunk_bytes])
        return
    from torrent_tpu_torch.native.io_engine import get_engine

    engine = get_engine()
    total = source_len(source)
    if engine is not None and total > 0:
        path = str(source)
        buf = np.empty(chunk_bytes, dtype=np.uint8)
        stripes = 4
        for off in range(0, total, chunk_bytes):
            n = min(chunk_bytes, total - off)
            step = -(-n // stripes)
            segs = [
                (0, off + s, s, min(step, n - s)) for s in range(0, n, step)
            ]
            engine.read_segments([path], segs, buf[:n])
            yield buf[:n].tobytes()
        return
    with open(source, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                return
            yield chunk


def _make_leaf_fn(device):
    """The batched SHA-256 for leaf launches on ``device``.

    The reference picks a Pallas tiling that divides the launch's row
    count; that is Mosaic geometry. The GPU kernel takes any row count,
    so a launch is exactly the staged rows.
    """
    return make_sha256_fn(device)


def _host_copy(words: torch.Tensor):
    """Start bringing device ``int32`` words to the host; returns a
    callable that waits for them and gives ``uint32`` numpy."""
    if words.device.type == "cpu":
        return lambda: words.numpy().view(np.uint32)
    host = torch.empty(words.shape, dtype=words.dtype, pin_memory=True)
    host.copy_(words, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def get() -> np.ndarray:
        done.synchronize()
        return host.numpy().view(np.uint32)

    return get


class _LeafPlane:
    """Staging for leaf launches of up to ``rows`` 16 KiB leaves.

    On a GPU the host rows and block counts are pinned; a launch is one
    host→device copy of the staged rows (:meth:`copy_in`), then the
    kernel, both on the current stream, so a launch never waits for the
    one before it. The host rows may be refilled as soon as the copy is
    done: every ``stage_*`` call waits for it (a ``verify.wait_host_free``
    region while a profiler runs). On the CPU the plain version reads the
    staging rows in place and is done when ``launch`` returns.
    """

    def __init__(self, rows: int, device=None):
        self.device = resolve_device(device)
        self.rows = rows
        self._sha256 = _make_leaf_fn(self.device)
        row_bytes = padded_len_for(BLOCK)
        cuda = self.device.type == "cuda"
        self._host = torch.empty((rows, row_bytes), dtype=torch.uint8, pin_memory=cuda)
        self._host_nblocks = torch.zeros(rows, dtype=torch.int32, pin_memory=cuda)
        self.padded = self._host.numpy()
        self.nblocks = self._host_nblocks.numpy()
        if cuda:
            self._dev = torch.empty((rows, row_bytes), dtype=torch.uint8, device=self.device)
            self._dev_nblocks = torch.empty(rows, dtype=torch.int32, device=self.device)
            self._copied = torch.cuda.Event()

    def _wait_host_free(self) -> None:
        if self.device.type == "cuda":
            # an event never recorded is complete: the first stage never waits
            with annotate("verify.wait_host_free"):
                self._copied.synchronize()

    def _pad(self, k: int, lengths: np.ndarray) -> None:
        self.padded[:k, BLOCK:] = 0  # stale 0x80/bit-length bytes of a reused row
        self.nblocks[:k] = pad_in_place(self.padded[:k], lengths)

    def stage_bytes(self, chunk) -> int:
        """Stage a run of consecutive leaves (the last may be short; an
        empty chunk is one empty leaf); returns the rows staged."""
        flat = np.frombuffer(chunk, dtype=np.uint8)
        full, rem = divmod(flat.size, BLOCK)
        k = full + (1 if rem or not full else 0)
        if k > self.rows:
            raise ValueError(f"{k} leaves exceed the plane's {self.rows} rows")
        self._wait_host_free()
        view = self.padded[:k, :BLOCK]
        view[:full] = flat[: full * BLOCK].reshape(full, BLOCK)
        lengths = np.full(k, BLOCK, dtype=np.int64)
        if k > full:
            view[full, :rem] = flat[full * BLOCK :]
            view[full, rem:] = 0
            lengths[full] = rem
        self._pad(k, lengths)
        return k

    def stage_pieces(self, buf: np.ndarray, lengths: np.ndarray, pad: int) -> int:
        """Stage the leaves of ``m`` pieces as an ``[m, pad]`` leaf grid.

        ``buf`` is ``uint8[m, piece_length]`` from ``Storage.read_batch``
        (zero past each piece's length) and ``pad`` the pieces' common
        leaf-pad target. A piece's leaves are consecutive in its row, so
        the whole batch moves in one strided copy; grid slots past a
        piece's last leaf become sentinel rows (``nblocks=0``), which
        :meth:`launch_grid` turns into zero leaves. Returns the rows staged.
        """
        m = buf.shape[0]
        k = m * pad
        if k > self.rows:
            raise ValueError(f"{k} leaves exceed the plane's {self.rows} rows")
        lengths = np.asarray(lengths, dtype=np.int64)
        slot = np.arange(pad, dtype=np.int64)
        row_len = np.clip(lengths[:, None] - slot * BLOCK, 0, BLOCK)
        # a zero-length piece still has one (empty) leaf
        live = slot < np.maximum(-(-lengths // BLOCK), 1)[:, None]
        self._wait_host_free()
        rows = self.padded[:k].reshape(m, pad, -1)
        rows[:, :, :BLOCK] = buf[:, : pad * BLOCK].reshape(m, pad, BLOCK)
        self._pad(k, row_len.reshape(-1))
        self.nblocks[:k][~live.reshape(-1)] = 0
        return k

    def copy_in(self, k: int) -> int:
        """Start the host→device copy of the first ``k`` staged rows and
        their block counts; returns the bytes it moves (none on the CPU,
        where the plain version reads the staging rows in place)."""
        if self.device.type != "cuda":
            return 0
        self._dev[:k].copy_(self._host[:k], non_blocking=True)
        self._dev_nblocks[:k].copy_(self._host_nblocks[:k], non_blocking=True)
        self._copied.record()
        return self._host[:k].nbytes + self._host_nblocks[:k].nbytes

    def _rows(self, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The first ``k`` rows and block counts where the hash reads them."""
        if self.device.type == "cpu":
            return self._host[:k], self._host_nblocks[:k]
        return self._dev[:k], self._dev_nblocks[:k]

    def launch(self, k: int) -> torch.Tensor:
        """Copy in and hash the first ``k`` staged rows; returns
        ``int32[k, 8]`` words on the device (not synchronised)."""
        self.copy_in(k)
        return self._sha256(*self._rows(k))

    def launch_grid(self, m: int, pad: int) -> torch.Tensor:
        """Hash a grid staged by :meth:`stage_pieces` and copied in by
        :meth:`copy_in`; returns ``int32[m, pad, 8]`` on the device with
        the sentinel slots zeroed (BEP 52 pads a merkle tree with zero
        leaves)."""
        data, nblocks = self._rows(m * pad)
        words = self._sha256(data, nblocks)
        return words.masked_fill_((nblocks == 0).unsqueeze(1), 0).view(m, pad, 8)


def _leaf_words_from_chunks(chunks, total: int, device=None) -> np.ndarray:
    """SHA-256 leaf hashes from an iterator of block-aligned chunks
    → ``u32[n_blocks, 8]``.

    One leaf launch per chunk. The host stages chunk i+1 while the device
    copies and hashes chunk i, and chunk i's words come back while chunk
    i+1 is staged.
    """
    n = max(1, -(-total // BLOCK))
    b = min(LEAF_BATCH, max(16, 1 << (n - 1).bit_length()))
    plane = _LeafPlane(b, device)
    out = np.zeros((n, 8), dtype=np.uint32)
    pending = None
    start = 0
    for chunk in chunks:
        k = plane.stage_bytes(chunk)
        fetch = _host_copy(plane.launch(k))
        if pending is not None:
            s, kk, get = pending
            out[s : s + kk] = get()
        pending = (start, k, fetch)
        start += k
    if total == 0:  # empty source: single zero-length leaf
        pending = (0, 1, _host_copy(plane.launch(plane.stage_bytes(b""))))
    if pending is not None:
        s, kk, get = pending
        out[s : s + kk] = get()
    return out


def _leaf_words_device(source, device=None) -> np.ndarray:
    total = source_len(source)
    n = max(1, -(-total // BLOCK))
    b = min(LEAF_BATCH, max(16, 1 << (n - 1).bit_length()))
    return _leaf_words_from_chunks(_iter_source(source, b * BLOCK), total, device)


def _leaf_words_cpu_from_chunks(chunks) -> np.ndarray:
    digs = []
    for chunk in chunks:
        for i in range(0, len(chunk), BLOCK):
            digs.append(hashlib.sha256(chunk[i : i + BLOCK]).digest())
    if not digs:
        digs.append(hashlib.sha256(b"").digest())
    return digests_to_words32(digs)


def _leaf_words_cpu(source) -> np.ndarray:
    return _leaf_words_cpu_from_chunks(_iter_source(source, LEAF_BATCH * BLOCK))


def _root_cpu(words: np.ndarray, pad_to: int, pad_digest: bytes = b"\x00" * 32) -> bytes:
    """hashlib pair-fold of ``u32[n, 8]`` leaf/node words padded to
    ``pad_to`` with ``pad_digest`` — the device-free merkle reduction the
    ``hasher='cpu'`` paths use."""
    nodes = list(words32_to_digests(words)) + [pad_digest] * (pad_to - words.shape[0])
    while len(nodes) > 1:
        nodes = [
            hashlib.sha256(nodes[i] + nodes[i + 1]).digest()
            for i in range(0, len(nodes), 2)
        ]
    return nodes[0]


def roots_batched(
    entries: "list[tuple[int, np.ndarray]]",
    piece_length: int,
    hasher: str = "gpu",
    device=None,
) -> list[tuple[bytes, tuple[bytes, ...]]]:
    """(pieces_root, layer) for MANY files from precomputed leaf words,
    with ONE pair-reduction launch per tree level per shape group instead
    of one reduction chain per file.

    ``entries`` is ``[(length, leaf_words u32[n,8]), ...]``. Three
    batched stages, numerically identical to hash_file_v2:

    1. small files (≤1 piece) group by their pow2 leaf-pad target; each
       group stacks to ``[k, target, 8]`` and reduces together (the
       leading axis of ``merkle_root`` flattens into the pair batch);
    2. big files' leaf grids concatenate to ``[total_pieces, lpp, 8]``
       — every piece root of every file in log2(lpp) launches;
    3. per-file piece-root layers pad with the zero-piece-subtree root,
       group by padded length, and reduce stacked the same way.

    ``hasher="cpu"`` folds with hashlib instead (the reference's
    ``device=False``); ``hasher="gpu"`` reduces on ``device``.
    """
    _check_hasher(hasher)
    on_device = hasher == "gpu"
    lpp = piece_length // BLOCK
    out: list = [None] * len(entries)

    # stage 1: single-piece files, grouped by pad target
    small_groups: dict[int, list[int]] = {}
    for i, (length, leaves) in enumerate(entries):
        if length == 0:
            out[i] = (b"\x00" * 32, ())
        elif length <= piece_length:
            n = leaves.shape[0]
            target = max(1, 1 << max(0, (n - 1).bit_length()))
            small_groups.setdefault(target, []).append(i)
    for target, idxs in small_groups.items():
        if on_device:
            stacked = np.stack(
                [pad_leaves(entries[i][1], target) for i in idxs]
            )  # [k, target, 8]
            roots = words32_to_digests(merkle_root(stacked, device))
        else:
            roots = [_root_cpu(entries[i][1], target) for i in idxs]
        for i, r in zip(idxs, roots):
            out[i] = (r, ())

    # stage 2: all big files' piece roots in one reduction chain
    big = [i for i, (length, _) in enumerate(entries) if length > piece_length]
    if big:
        counts = [-(-entries[i][0] // piece_length) for i in big]
        if on_device:
            grid = np.zeros((sum(counts), lpp, 8), dtype=np.uint32)
            pos = 0
            for i, n_pieces in zip(big, counts):
                leaves = entries[i][1]
                grid.reshape(-1, 8)[pos * lpp : pos * lpp + leaves.shape[0]] = leaves
                pos += n_pieces
            all_roots = merkle_root(grid, device)  # [sum_pieces, 8]
        else:
            rows = []
            for i, n_pieces in zip(big, counts):
                leaves = entries[i][1]
                for p in range(n_pieces):
                    rows.append(
                        digests_to_words32(
                            [_root_cpu(leaves[p * lpp : (p + 1) * lpp], lpp)]
                        )[0]
                    )
            all_roots = np.stack(rows)

        # stage 3: file roots from the piece-root layers, grouped by
        # padded layer length (zero-piece-subtree padding, BEP 52)
        height = lpp.bit_length() - 1
        zero_root = zero_chain(height)[height]
        zero_root_words = digests_to_words32([zero_root])[0]
        layer_groups: dict[int, list[tuple[int, np.ndarray]]] = {}
        pos = 0
        for i, n_pieces in zip(big, counts):
            roots_i = all_roots[pos : pos + n_pieces]
            pos += n_pieces
            padded_n = 1 << max(0, (n_pieces - 1).bit_length())
            layer_groups.setdefault(padded_n, []).append((i, roots_i))
        for padded_n, group in layer_groups.items():
            if on_device:
                stacked = np.tile(zero_root_words, (len(group), padded_n, 1))
                for g, (_, roots_i) in enumerate(group):
                    stacked[g, : roots_i.shape[0]] = roots_i
                file_roots = words32_to_digests(merkle_root(stacked, device))
            else:
                file_roots = [
                    _root_cpu(roots_i, padded_n, pad_digest=zero_root)
                    for _, roots_i in group
                ]
            for (i, roots_i), fr in zip(group, file_roots):
                out[i] = (fr, tuple(words32_to_digests(roots_i)))
    return out


# Leaf-word window for the batched reduction passes: flush once this
# many leaves (32 B each) are resident. The default bounds leaf RAM at
# ~64 MB (covering ~32 GiB of payload per window) — batching still
# collapses reductions to one launch per level per shape group WITHIN
# a window, without the corpus-proportional residency of an unbounded
# pass.
LEAF_WINDOW = env_int("TORRENT_TPU_LEAF_WINDOW", 1 << 21)


def roots_batched_windowed(
    entry_iter,
    piece_length: int,
    window: int | None = None,
    hasher: str = "gpu",
    device=None,
) -> list[tuple[bytes, tuple[bytes, ...]]]:
    """Windowed driver for :func:`roots_batched`: consumes an iterator of
    ``(length, leaf_words)`` and flushes whenever the resident leaf count
    reaches ``window`` (default ``LEAF_WINDOW``), so memory stays bounded
    no matter how large the corpus is. Results keep input order."""
    window = window or LEAF_WINDOW
    out: list[tuple[bytes, tuple[bytes, ...]]] = []
    buf: list[tuple[int, np.ndarray]] = []
    acc = 0
    for entry in entry_iter:
        buf.append(entry)
        acc += entry[1].shape[0]
        if acc >= window:
            out.extend(roots_batched(buf, piece_length, hasher, device))
            buf, acc = [], 0
    if buf:
        out.extend(roots_batched(buf, piece_length, hasher, device))
    return out


def hash_file_v2(
    source, piece_length: int, hasher: str = "gpu", device=None
) -> tuple[bytes, tuple[bytes, ...]]:
    """One file source (bytes or filesystem path) → (pieces_root, layer).

    The layer is empty for files of at most one piece (BEP 52 publishes
    piece layers only for multi-piece files). Path sources stream in
    bounded chunks — memory is independent of file size.
    """
    _check_hasher(hasher)
    total = source_len(source)
    if total == 0:
        return b"\x00" * 32, ()
    if hasher == "cpu":
        leaves = _leaf_words_cpu(source)
        return roots_batched([(total, leaves)], piece_length, hasher="cpu")[0]
    leaves = _leaf_words_device(source, device)
    if total <= piece_length:
        return small_file_root(leaves, device), ()
    lpp = piece_length // BLOCK
    roots = piece_roots_from_leaves(leaves, lpp, device)
    layer = tuple(words32_to_digests(roots))
    return file_root_from_piece_roots(roots, lpp, device), layer


def _check_v2_args(files, piece_length: int, hasher: str) -> None:
    _check_hasher(hasher)
    if piece_length < BLOCK or piece_length & (piece_length - 1):
        raise ValueError("piece_length must be a power of two >= 16 KiB")
    for path, _ in files:
        for part in path:
            if not valid_path_component(part):
                raise ValueError(
                    f"path component {part!r} cannot appear in a v2 file tree "
                    "(separator/traversal/non-UTF-8 names are not encodable)"
                )


def build_v2(
    files: list[tuple[tuple[str, ...], "bytes | str"]],
    name: str,
    piece_length: int,
    hasher: str = "gpu",
    announce: str | None = None,
    private: bool = False,
    comment: str | None = None,
    announce_list: list[list[str]] | None = None,
    web_seeds: list[str] | None = None,
    device=None,
) -> MetainfoV2:
    """Author a pure-v2 torrent from (path, source) entries.

    Sources are bytes or filesystem paths (streamed — a 60 GiB corpus
    never holds more than one leaf chunk resident).
    """
    _check_v2_args(files, piece_length, hasher)
    # phase 1: leaf words per file (streaming — bounded by the chunk
    # size, not file size); phase 2: batched reduction passes across
    # files (one launch per level per shape group within each
    # bounded-residency window, not a chain per file)
    ordered = sorted(files, key=lambda e: e[0])
    lengths = [source_len(source) for _, source in ordered]

    def leaf_entries():
        for (_, source), total in zip(ordered, lengths):
            if total == 0:
                yield 0, np.zeros((0, 8), dtype=np.uint32)
            elif hasher == "cpu":
                yield total, _leaf_words_cpu(source)
            else:
                yield total, _leaf_words_device(source, device)

    reduced = roots_batched_windowed(
        leaf_entries(), piece_length, hasher=hasher, device=device
    )
    v2files: list[V2File] = []
    layers: dict[bytes, tuple[bytes, ...]] = {}
    for (path, _), total, (root, layer) in zip(ordered, lengths, reduced):
        v2files.append(V2File(path=path, length=total, pieces_root=root))
        if layer:
            layers[root] = layer
    info = InfoDictV2(
        name=name, piece_length=piece_length, files=tuple(v2files), private=private
    )
    encoded = encode_metainfo_v2(
        info, layers, announce,
        comment=comment, announce_list=announce_list, web_seeds=web_seeds,
    )
    parsed = parse_metainfo_v2(encoded)
    if parsed is None:
        raise RuntimeError("authored v2 metainfo failed its own parse")
    return parsed


@functools.lru_cache(maxsize=4)
def _piece_verifier(plen: int, device: torch.device | None):
    """One SHA-1 hash-plane verifier per piece geometry and device (None:
    the default grid, every card of the process)."""
    from torrent_tpu_torch.models.verifier import GPUVerifier

    return GPUVerifier(piece_length=plen, batch_size=256, device=device)


def _hybrid_hash_file(
    source, plen: int, hasher: str, pad_tail: bool, device=None
) -> tuple[bytes, tuple[bytes, ...], list[bytes]]:
    """One streaming pass → (v2 pieces_root, v2 layer, v1 piece digests).

    Both hash families consume the same chunk iterator, so hybrid
    authoring reads each file from disk exactly once. ``pad_tail`` zero-
    extends the final v1 piece to full length (BEP 47 — the pad bytes are
    part of the hashed piece). Chunk size is the leaf bucket (a power-of-
    two multiple of BLOCK, hence of ``plen`` whenever plen ≤ chunk), so
    the v1 carry is only ever the file's final partial piece.
    """
    total = source_len(source)
    if total == 0:
        return b"\x00" * 32, (), []
    n = max(1, -(-total // BLOCK))
    bkt = min(LEAF_BATCH, max(16, 1 << (n - 1).bit_length()))
    chunk_bytes = bkt * BLOCK

    if hasher == "cpu":
        hash_batch = lambda ps: [hashlib.sha1(p).digest() for p in ps]  # noqa: E731
    else:
        hash_batch = _piece_verifier(plen, None if device is None else resolve_device(device)).hash_pieces

    v1_digs: list[bytes] = []
    state = {"carry": b""}

    def feed_sha1(chunk: bytes) -> None:
        buf = state["carry"] + chunk
        full = len(buf) // plen
        if full:
            v1_digs.extend(hash_batch([buf[i * plen : (i + 1) * plen] for i in range(full)]))
        state["carry"] = buf[full * plen :]

    def tee():
        for chunk in _iter_source(source, chunk_bytes):
            feed_sha1(chunk)
            yield chunk

    if hasher == "cpu":
        leaves = _leaf_words_cpu_from_chunks(tee())
    else:
        leaves = _leaf_words_from_chunks(tee(), total, device)
    tail = state["carry"]
    if tail:
        v1_digs.extend(hash_batch([tail.ljust(plen, b"\x00") if pad_tail else tail]))

    root, layer = roots_batched([(total, leaves)], plen, hasher, device)[0]
    return root, layer, v1_digs


def build_hybrid(
    files: list[tuple[tuple[str, ...], "bytes | str"]],
    name: str,
    piece_length: int,
    hasher: str = "gpu",
    announce: str | None = None,
    private: bool = False,
    comment: str | None = None,
    announce_list: list[list[str]] | None = None,
    web_seeds: list[str] | None = None,
    device=None,
) -> tuple[bytes, MetainfoV2]:
    """Author a hybrid v1+v2 torrent (BEP 52 upgrade path).

    Every file except the last is padded to a piece boundary with a
    BEP 47 pad file (``.pad/N``, attr ``p``) so v1 pieces never span
    files — which is exactly what lets the v1 piece hashes and the v2
    per-file merkle trees describe the same bytes. Returns the bencoded
    torrent and its parsed v2 view (``parse_metainfo`` reads the same
    blob for the v1 view). On the GPU the v1 pieces go through the SHA-1
    kernel and the v2 leaves through the SHA-256 kernel.
    """
    _check_v2_args(files, piece_length, hasher)
    entries = sorted(files, key=lambda e: e[0])
    v2files: list[V2File] = []
    layers: dict[bytes, tuple[bytes, ...]] = {}
    v1_pieces: list[bytes] = []
    v1_files: list[dict] = []
    single = len(entries) == 1 and entries[0][0] == (name,)
    for idx, (path, source) in enumerate(entries):
        last = idx == len(entries) - 1
        root, layer, digs = _hybrid_hash_file(
            source, piece_length, hasher, pad_tail=not last, device=device
        )
        length = source_len(source)
        v2files.append(V2File(path=path, length=length, pieces_root=root))
        if layer:
            layers[root] = layer
        v1_pieces.extend(digs)
        v1_files.append({b"length": length, b"path": [p.encode() for p in path]})
        pad = (-length) % piece_length
        if not last and pad:
            v1_files.append(
                {b"length": pad, b"path": [b".pad", str(pad).encode()], b"attr": b"p"}
            )
    info = InfoDictV2(
        name=name, piece_length=piece_length, files=tuple(v2files), private=private
    )
    encoded = encode_metainfo_v2(
        info,
        layers,
        announce=announce,
        comment=comment,
        announce_list=announce_list,
        web_seeds=web_seeds,
        v1_pieces=v1_pieces,
        v1_files=None if single else v1_files,
        v1_length=source_len(entries[0][1]) if single else None,
    )
    parsed = parse_metainfo_v2(encoded)
    if parsed is None:
        raise RuntimeError("authored hybrid failed its own v2 parse")
    return encoded, parsed


def verify_v2(
    read_file,
    meta: MetainfoV2,
    hasher: str = "gpu",
    device=None,
) -> dict[tuple[str, ...], np.ndarray]:
    """Recheck every file against its pieces_root / piece layer.

    ``read_file(path_tuple) -> bytes | path-str | None`` supplies each
    file's source (None = missing; a path source streams in bounded
    chunks). Returns ``{path: bool[n_pieces]}`` — the v2 analogue of the
    v1 resume-recheck bitfield, per file.
    """
    _check_hasher(hasher)
    plen = meta.info.piece_length
    lpp = plen // BLOCK
    results: dict[tuple[str, ...], np.ndarray] = {}
    # phase 1: select present, size-matching files (stashing the source —
    # calling read_file again later could observe a concurrently deleted
    # or resized file and crash instead of marking it missing); phase 2:
    # windowed batched reduction passes (one launch per level per shape
    # group within each bounded-residency window, not a chain per file)
    todo: list[tuple[V2File, object]] = []  # (file, source)
    for f in meta.info.files:
        n_pieces = f.num_pieces(plen)
        source = read_file(f.path)
        if source is None or (source_len(source) != f.length):
            results[f.path] = (
                np.zeros(max(1, n_pieces), dtype=bool)
                if f.length
                else np.ones(0, dtype=bool)
            )
            continue
        if f.length == 0:
            results[f.path] = np.ones(0, dtype=bool)
            continue
        todo.append((f, source))

    def leaf_entries():
        for f, source in todo:
            try:
                if hasher == "cpu":
                    yield f.length, _leaf_words_cpu(source)
                else:
                    yield f.length, _leaf_words_device(source, device)
            except OSError:
                # a path source deleted between phases: zero leaf words
                # can't match any real root, so every piece of this file
                # lands False — same verdict as a missing file
                yield f.length, np.zeros(
                    (max(1, -(-f.length // BLOCK)), 8), dtype=np.uint32
                )

    reduced = roots_batched_windowed(leaf_entries(), plen, hasher=hasher, device=device)
    for ei, (f, _) in enumerate(todo):
        n_pieces = f.num_pieces(plen)
        ok = np.zeros(max(1, n_pieces), dtype=bool)
        got_root, got_layer = reduced[ei]
        if f.length <= plen:
            ok[0] = got_root == f.pieces_root
            results[f.path] = ok
            continue
        layer = meta.piece_layers.get(f.pieces_root, ())
        # metadata self-consistency: the published layer must merkle up to
        # the published root (a hostile layer otherwise localizes damage
        # to the wrong pieces). Data corruption must NOT trip this — the
        # per-piece comparison below is what localizes it. The cpu hasher
        # folds with hashlib (device-free guarantee).
        if len(layer) != n_pieces:
            results[f.path] = ok
            continue
        if hasher == "cpu":
            height = lpp.bit_length() - 1
            padded_n = 1 << max(0, (n_pieces - 1).bit_length())
            layer_root = _root_cpu(
                digests_to_words32(layer), padded_n,
                pad_digest=zero_chain(height)[height],
            )
        else:
            layer_root = file_root_from_piece_roots(digests_to_words32(layer), lpp, device)
        if layer_root != f.pieces_root:
            results[f.path] = ok
            continue
        for i in range(n_pieces):
            ok[i] = got_layer[i] == layer[i]
        results[f.path] = ok
    return results
