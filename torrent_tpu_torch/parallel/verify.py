"""Batched piece verification — the resume-recheck / authoring hash plane.

``verify_pieces(storage, info)`` reads pieces in large batches
(``Storage.read_batch``), pads them on the host, and hashes them on the
device — digests compared on the device, one bool per piece returned.

Pipeline shape (per batch of B pieces):

    disk → read_batch → pad_in_place → pinned slot → copy stream ┐
                               SHA-1 kernel on the compute stream │ overlapped:
                               compare vs expected on the device  │ next batch's
                               bool[B] → pinned host ─────────────┘ disk read runs
                                                                    on a host thread

The CPU path (``hasher="cpu"``) is streaming hashlib — the baseline the
device path is measured against. v2 session infos (``session/v2.py``)
route to the merkle recheck: SHA-256 16 KiB leaves of a whole piece batch
in one kernel launch, then one merkle launch that reduces every piece's
tree (up to 9 levels a launch), and the roots compared on the device.

The scheduler sessions (``read_pieces_chunk`` / ``read_pieces_into`` →
``enqueue_torrent_sched`` → ``verify_pieces_sched``) submit the pieces
to a shared ``sched.HashPlaneScheduler`` instead of owning a batch loop.
The v1 device route hashes on a grid of devices (``parallel/mesh.py``),
every card of the process by default, as the reference's on its mesh.
In a ``torch.distributed`` group of more than one rank, the device
routes go multi-process (``parallel/distributed.py``), as the
reference's go over ``jax.distributed``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable

import numpy as np

from torrent_tpu_torch.codec.metainfo import InfoDict
from torrent_tpu_torch.storage.piece import piece_length
from torrent_tpu_torch.storage.storage import Storage, StorageError


@dataclass
class VerifyResult:
    """Outcome of a full verify pass."""

    bitfield: np.ndarray  # bool[n_pieces]
    n_pieces: int
    n_valid: int
    bytes_hashed: int
    seconds: float

    @property
    def complete(self) -> bool:
        return self.n_valid == self.n_pieces

    @property
    def pieces_per_sec(self) -> float:
        return self.n_pieces / self.seconds if self.seconds > 0 else float("inf")

    @property
    def gib_per_sec(self) -> float:
        return self.bytes_hashed / self.seconds / 2**30 if self.seconds > 0 else float("inf")


ProgressCb = Callable[[int, int], None]  # (pieces_done, pieces_total)


def verify_pieces_cpu(
    storage: Storage, info: InfoDict, progress_cb: ProgressCb | None = None
) -> np.ndarray:
    """Streaming hashlib recheck — the CPU baseline."""
    n = info.num_pieces
    bitfield = np.zeros(n, dtype=bool)
    for idx in range(n):
        try:
            data = storage.read_piece(idx)
        except (StorageError, OSError):
            continue  # unreadable = failed piece, keep checking the rest
        if len(data) == piece_length(info, idx) and hashlib.sha1(data).digest() == info.pieces[idx]:
            bitfield[idx] = True
        if progress_cb and (idx + 1) % 256 == 0:
            progress_cb(idx + 1, n)
    if progress_cb:
        progress_cb(n, n)
    return bitfield


def verify_pieces_gpu(
    storage: Storage,
    info: InfoDict,
    batch_size: int = 1024,
    device=None,
    progress_cb: ProgressCb | None = None,
    io_threads: int = 4,
    local: bool = False,
    devices=None,
    mesh=None,
) -> np.ndarray:
    """Batched device recheck; overlaps disk reads with device hashing.

    The grid (``parallel/mesh.py``) is ``mesh``, or ``devices``, or the
    one entry ``device``; with none of them every card of the process,
    and a host without one raises.

    Routed on the grid's process span, as the reference routes on its
    mesh's: in a ``torch.distributed`` default process group of more
    than one rank, a grid over the group (the default, or one built
    from ``device`` / ``devices``) takes the multi-process path, where
    every rank verifies its slice of each global batch on its own
    entries and all return the identical global bitfield
    (``parallel/distributed.py``). A grid of this process's entries
    alone (``mesh=make_mesh(devices, n_hosts=1)``, or ``local=True``)
    keeps the rank on the local path.
    """
    from torrent_tpu_torch.models.verifier import GPUVerifier
    from torrent_tpu_torch.parallel.distributed import verify_storage_distributed, world
    from torrent_tpu_torch.parallel.mesh import spanning_grid

    if not local and world()[0] > 1:
        mesh = spanning_grid(device, devices, mesh)
        if mesh.process_span() > 1:
            bitfield, _ = verify_storage_distributed(
                storage,
                info,
                batch_size=batch_size,
                mesh=mesh,
                progress_cb=progress_cb,
                io_threads=io_threads,
            )
            return bitfield
        device = devices = None
    verifier = GPUVerifier(
        piece_length=info.piece_length, batch_size=batch_size, device=device, devices=devices, mesh=mesh
    )
    return verifier.verify_storage(
        storage, info, progress_cb=progress_cb, io_threads=io_threads
    )


def verify_pieces_v2_cpu(
    storage: Storage, info, progress_cb: ProgressCb | None = None
) -> np.ndarray:
    """Streaming per-piece merkle recheck (session/v2.py geometry)."""
    from torrent_tpu_torch.models.merkle import piece_root_cpu

    n = info.num_pieces
    bitfield = np.zeros(n, dtype=bool)
    for idx in range(n):
        try:
            data = storage.read_piece(idx)
        except (StorageError, OSError):
            continue  # unreadable = failed piece, keep checking the rest
        if (
            len(data) == info.piece_sizes[idx]
            and piece_root_cpu(data, info.piece_pad_leaves[idx]) == info.pieces[idx]
        ):
            bitfield[idx] = True
        if progress_cb and (idx + 1) % 256 == 0:
            progress_cb(idx + 1, n)
    if progress_cb:
        progress_cb(n, n)
    return bitfield


def verify_pieces_v2_gpu(
    storage: Storage,
    info,
    batch_size: int = 256,
    device=None,
    progress_cb: ProgressCb | None = None,
    indices=None,
    **_ignored,
) -> np.ndarray:
    """Batched device merkle recheck of a v2 session info.

    Pieces group by leaf-pad target (multi-piece files all share
    blocks-per-piece, single-piece files use their own pow2 count). Per
    batch of ``batch_size`` pieces: one ``read_batch``, one staged leaf
    grid ``[m, pad]`` (a piece's full blocks are consecutive, so the
    batch moves as one strided copy), one SHA-256 launch over all its
    leaves (256 × 64 = 16384 rows at 1 MiB pieces), one merkle launch
    reducing all of the batch's trees (``ops/sha256_cuda.merkle_passes``:
    up to 9 levels a launch), and the roots compared with the expected
    digests there; only ``bool[m]`` comes back. The next batch is read
    on a host thread while the device works.

    The pipeline ledger (``obs/ledger.py``) is charged on the way:
    ``read`` on the loader thread (``Storage.read_batch``), and on this
    thread each batch's ``stage``, ``h2d``, ``launch`` and ``digest``;
    after the digest, the batch's copy as the card timed it
    (``h2d_beside_load`` while the next read ran as it was enqueued, else
    ``h2d_alone``: ``obs/h2d.py``). The batches of a pad group run through
    ``parallel/pipeline.py``'s loop; the expected roots go to the device
    once, in the set-up.
    While a profiler runs, a batch is a ``verify.v2.batch`` region
    holding those stages' ``pipeline.*`` regions and this thread's waits
    (``verify.wait_load``, ``verify.wait_host_free``), and the set-up a
    ``verify.setup`` one: the card's idle gaps carry their names.

    ``indices``: optional subset of piece indices to recheck; the
    returned bitfield is always full length, False outside the subset.
    Other keyword arguments of the v1 path (``io_threads``) are accepted
    and ignored, as in the reference.
    """
    import torch

    from torrent_tpu_torch.compat import to_device
    from torrent_tpu_torch.models.merkle import _merkle_reduce_fused, digests_to_words32
    from torrent_tpu_torch.models.v2 import _host_copy, _LeafPlane
    from torrent_tpu_torch.obs.ledger import pipeline_ledger
    from torrent_tpu_torch.obs.profiler import annotate
    from torrent_tpu_torch.parallel.pipeline import run_batches

    n = info.num_pieces
    bitfield = np.zeros(n, dtype=bool)
    if n == 0:
        return bitfield
    with annotate("verify.setup"):
        todo = range(n) if indices is None else indices
        by_pad: dict[int, list[int]] = {}
        for idx in todo:
            by_pad.setdefault(info.piece_pad_leaves[idx], []).append(idx)
        n_todo = sum(len(v) for v in by_pad.values())
        if n_todo == 0:
            return bitfield
        batch_size = max(1, int(batch_size))
        plane = _LeafPlane(min(batch_size, n_todo) * max(by_pad), device)
        plen = info.piece_length
        bufs = [np.empty((min(batch_size, n_todo), plen), dtype=np.uint8) for _ in range(2)]
        # in the order the batches run: a batch's roots are one slice
        order = [idx for group in by_pad.values() for idx in group]
        expected = to_device(digests_to_words32([info.pieces[idx] for idx in order]), plane.device)
    led = pipeline_ledger()
    row_bytes = plane.padded.shape[1]
    done = 0

    def finish(pending) -> None:
        nonlocal done
        batch, ok_len, get_ok, copy = pending
        with led.track("digest", len(batch)):
            ok = get_ok()
        if copy is not None:
            copy.charge(led)
        bitfield[batch] = ok_len & ok.astype(bool)
        done += len(batch)
        if progress_cb:
            progress_cb(done, n_todo)

    first = 0  # the group's first row of ``expected``
    for pad, group in by_pad.items():
        batches = [group[s : s + batch_size] for s in range(0, len(group), batch_size)]

        def read(bi: int):
            return storage.read_batch(batches[bi], out=bufs[bi % 2][: len(batches[bi])])

        def launch(bi: int, loaded, beside: bool):
            buf, lengths = loaded
            batch = batches[bi]
            ok_len = lengths == np.asarray([info.piece_sizes[p] for p in batch])
            m = len(batch)
            with led.track("stage", int(lengths.sum())):
                plane.stage_pieces(buf, lengths, pad)
            with led.track("h2d") as copied:
                copied.add(plane.copy_in(m * pad, beside=beside))
            with led.track("launch", m * pad * row_bytes):
                roots = _merkle_reduce_fused(plane.launch_grid(m, pad), pad.bit_length() - 1)
                lo = first + bi * batch_size
                ok = (roots == expected[lo : lo + m]).all(dim=1).to(torch.int32)
                fetch = _host_copy(ok)
            return batch, ok_len, fetch, plane.last_copy

        run_batches(len(batches), read, launch, finish, "verify.v2.batch")
        first += len(group)
    return bitfield


def striped(storage: Storage, idxs, stripes: int) -> list:
    """Pieces ``idxs`` of ``storage`` as at most ``stripes`` contiguous
    ``(storage, indices, rows)`` runs, ``rows`` the slice of a batch's
    rows each fills from row 0 (one run when there are no more pieces
    than stripes, none for no pieces)."""
    k = len(idxs)
    if k <= stripes:
        return [(storage, idxs, slice(0, k))] if k else []
    step = -(-k // stripes)
    return [(storage, idxs[s : s + step], slice(s, min(s + step, k))) for s in range(0, k, step)]


def read_runs(runs: list, pool=None) -> None:
    """Fill each ``(storage, indices, rows)`` run with ``Storage.read_batch``.

    Without ``pool``, or for one run, the calls run in turn, each its
    own pipeline-ledger ``read`` entry. With it, they run at once on
    ``pool`` as ONE ``read`` entry over all of them: each call's
    zero-fill and planning run beside the others', so an entry a call
    would add up to more busy seconds than the wall the read took. The
    calls queue on the native pool's one lock; each call's wait there
    is charged to the ledger's ``read_wait`` (``NativeIOEngine.read_into``),
    so the counter shows how far the stripes serialise."""
    from torrent_tpu_torch.obs.ledger import pipeline_ledger

    if pool is None or len(runs) < 2:
        for storage, idxs, rows in runs:
            storage.read_batch(idxs, out=rows)
        return
    with pipeline_ledger().track("read") as tracked:
        futs = [pool.submit(storage.read_batch, idxs, out=rows, track=False) for storage, idxs, rows in runs]
        tracked.add(sum(int(f.result()[1].sum()) for f in futs))


def read_pieces_chunk(storage: Storage, info: InfoDict, idxs):
    """Read a chunk of pieces with mark-and-continue semantics.

    Returns ``(payloads, expected, keep)`` — a torn/unreadable/short
    piece is skipped (stays False in the caller's bitfield) instead of
    aborting, the same contract as ``verify_pieces_cpu``; OSError too,
    because a backend that leaks a raw errno (file truncated between
    open and pread) must not kill the pass. The ONE implementation of
    the read/filter/keep contract, shared by the scheduler sessions
    here and (in the reference) the fabric executor — which also
    makes it the pipeline ledger's ``read`` stage boundary for every
    scheduler-fed path."""
    from torrent_tpu_torch.obs.ledger import pipeline_ledger

    payloads, exps, keep = [], [], []
    with pipeline_ledger().track("read") as tracked:
        for i in idxs:
            try:
                data = storage.read_piece(i)
            except (StorageError, OSError):
                continue
            tracked.add(len(data))
            if len(data) != piece_length(info, i):
                continue
            payloads.append(data)
            exps.append(info.pieces[i])
            keep.append(i)
    return payloads, exps, keep


def read_pieces_into(storage: Storage, info: InfoDict, idxs, scheduler):
    """Zero-copy sibling of :func:`read_pieces_chunk`.

    Checks a staging slab out of the scheduler's ingest pool
    (``sched._StagingSlots`` via ``checkout_staging``) FIRST, then has
    ``Storage.read_batch`` — the native ``io_engine.read_into`` pread
    pool when available, the pure-Python backend walk otherwise — land
    the reads directly in the slab's row-strided view and pads the rows
    in place. No intermediate per-piece ``bytes``, no ``np.frombuffer``
    row copy, no ``_StagingSlots.stage`` pass later: the slab IS the
    launch buffer.

    Mark-and-continue semantics are preserved: a torn/short/unreadable
    piece becomes an ``nblocks=0`` sentinel row, is dropped from the
    returned ticket rows, and stays False in the caller's bitfield —
    the same contract as ``read_pieces_chunk`` (differential-tested in
    tests/test_torch_ingest.py, native engine present and absent).

    Returns ``(slab, rows, expected, keep)`` — the caller holds one
    slab reference and must ``slab.release()`` after hand-off (or on
    abort) — or ``None`` when this scheduler/geometry can't take
    pre-staged submissions (callers fall back to the byte path). Any
    read-path failure checks the slab back in before returning, so a
    mid-batch ``NativeIOError`` can never leak a slot.
    """
    checkout = getattr(scheduler, "checkout_staging", None)
    if checkout is None:
        return None
    idxs = list(idxs)
    slab = checkout(info.piece_length, len(idxs), algo="sha1")
    if slab is None:
        return None
    try:
        n = len(idxs)
        slab.prepare([piece_length(info, i) for i in idxs])
        ok = np.zeros(n, dtype=bool)
        storage.read_batch(
            idxs,
            out=slab.padded[:n, : info.piece_length],
            row_status=ok,
            zero_fill=False,
        )
        slab.finalize(ok)
    except Exception:
        # whatever broke (engine fault, backend bug): return the slot —
        # callers retry through the byte path, which re-reads cleanly
        slab.release()
        return None
    rows = [i for i in range(n) if ok[i]]
    expected = [info.pieces[idxs[i]] for i in rows]
    keep = [idxs[i] for i in rows]
    return slab, rows, expected, keep


class _SchedChunk:
    """One read chunk ready for scheduler submission — staged (slab)
    or byte form, behind one enqueue/discard surface so every
    scheduler-fed read loop (torrent rechecks, library sweeps, the
    fabric executor) shares the zero-copy-with-fallback contract."""

    __slots__ = ("slab", "rows", "payloads", "expected", "keep", "piece_length")

    def __init__(self, slab, rows, payloads, expected, keep, piece_length):
        self.slab = slab
        self.rows = rows
        self.payloads = payloads
        self.expected = expected
        self.keep = keep
        self.piece_length = piece_length

    @property
    def empty(self) -> bool:
        return not self.keep

    @property
    def nbytes(self) -> int:
        if self.slab is not None:
            return int(self.slab.lengths[list(self.rows)].sum())
        return sum(len(p) for p in self.payloads)

    async def enqueue(self, scheduler, tenant: str, wait: bool = True):
        """Submit and hand ownership over: the creator's slab reference
        is released on EVERY path (tickets keep the slab alive through
        demux; a shed releases everything)."""
        if self.slab is not None:
            slab, self.slab = self.slab, None
            try:
                return await scheduler.enqueue_staged(
                    tenant, slab, self.rows, expected=self.expected, wait=wait
                )
            finally:
                slab.release()
        return await scheduler.enqueue(
            tenant,
            self.payloads,
            expected=self.expected,
            algo="sha1",
            piece_length=self.piece_length,
            wait=wait,
        )

    def discard(self) -> None:
        """Abandon without submitting (empty chunk, caller abort)."""
        if self.slab is not None:
            self.slab.release()
            self.slab = None


def read_chunk_for_sched(
    storage: Storage, info: InfoDict, idxs, scheduler
) -> _SchedChunk:
    """Read one chunk for scheduler submission, zero-copy when the
    scheduler's ingest pool can take it, ``read_pieces_chunk`` bytes
    otherwise. Runs in a worker thread (both read paths block)."""
    staged = read_pieces_into(storage, info, idxs, scheduler)
    if staged is not None:
        slab, rows, expected, keep = staged
        if not keep:  # nothing readable: give the slot straight back
            slab.release()
            return _SchedChunk(None, None, [], [], [], info.piece_length)
        return _SchedChunk(slab, rows, None, expected, keep, info.piece_length)
    payloads, exps, keep = read_pieces_chunk(storage, info, idxs)
    return _SchedChunk(None, None, payloads, exps, keep, info.piece_length)


async def enqueue_torrent_sched(
    storage: Storage,
    info: InfoDict,
    scheduler,
    tenant: str,
    chunk_pieces: int | None = None,
) -> list[tuple]:
    """Read a torrent's pieces off-thread and enqueue them on the shared
    hash-plane scheduler WITHOUT awaiting results.

    Returns ``[(future, keep_indices), ...]`` — each future resolves to
    ok-bytes for the pieces in ``keep_indices`` (rows that failed to read
    or were short are skipped and stay False in the caller's bitfield).
    Submissions use blocking admission (``wait=True``): a full queue
    pauses the disk read loop instead of buffering without bound. Shared
    by ``verify_pieces_sched`` and ``verify_library_sched`` so the read /
    filter / keep-demux contract lives in one place.

    Chunks go zero-copy whenever the scheduler's ingest pool covers the
    geometry (:func:`read_pieces_into` → ``enqueue_staged``): reads for
    chunk *k+1* land in a second slab while chunk *k*'s H2D/launch runs
    — the read→h2d→launch overlap the pipeline ledger's occupancy
    series makes visible.
    """
    import asyncio

    chunk = chunk_pieces or scheduler.chunk_for(info.piece_length)

    futs: list[tuple] = []
    for start in range(0, info.num_pieces, chunk):
        idxs = list(range(start, min(start + chunk, info.num_pieces)))
        ck = await asyncio.to_thread(
            read_chunk_for_sched, storage, info, idxs, scheduler
        )
        if ck.empty:
            ck.discard()
            continue
        fut = await ck.enqueue(scheduler, tenant, wait=True)
        futs.append((fut, ck.keep))
    return futs


async def verify_pieces_sched(
    storage: Storage,
    info: InfoDict,
    scheduler,
    tenant: str = "verify",
    chunk_pieces: int | None = None,
    progress_cb: ProgressCb | None = None,
) -> np.ndarray:
    """Recheck through the shared hash-plane scheduler (v1/sha1 infos).

    Instead of owning a private ``GPUVerifier`` batch loop, pieces are
    read off-thread and submitted to ``scheduler``
    (``sched.HashPlaneScheduler``): the scheduler coalesces
    them with every other caller's traffic into full device launches and
    keeps the geometry-grouped compile cache across sessions. Reads
    pipeline against launches — submissions are enqueued with blocking
    admission (``wait=True``), so a full queue pauses the disk read
    loop instead of buffering without bound.

    A launch failure that outlives the scheduler's retry/bisection
    (``SchedLaunchError``) marks its pieces unverified (False — retried
    on the next recheck or re-downloaded) instead of aborting the whole
    pass: one poisoned piece must not discard every verified one.

    v2 (merkle) infos don't map onto the flat digest plane; use
    ``verify_pieces`` for those.
    """
    from torrent_tpu_torch.sched import SchedLaunchError
    from torrent_tpu_torch.utils.log import get_logger

    if getattr(info, "v2", False):
        raise ValueError("scheduler sessions are sha1/v1-only; use verify_pieces")
    n = info.num_pieces
    bitfield = np.zeros(n, dtype=bool)
    if n == 0:
        return bitfield
    futs = await enqueue_torrent_sched(storage, info, scheduler, tenant, chunk_pieces)
    done = 0
    for fut, keep in futs:
        try:
            ok = await fut
        except SchedLaunchError as e:
            get_logger("parallel.verify").warning(
                "recheck: %d pieces unverified (hash launch failed: %s)",
                len(keep), e,
            )
            done += len(keep)  # stay False in the bitfield: retry later
            if progress_cb:
                progress_cb(min(done, n), n)
            continue
        for j, i in enumerate(keep):
            bitfield[i] = bool(ok[j])
        done += len(keep)
        if progress_cb:
            progress_cb(min(done, n), n)
    return bitfield


def verify_pieces(
    storage: Storage,
    info: InfoDict,
    hasher: str = "gpu",
    progress_cb: ProgressCb | None = None,
    **gpu_kwargs,
) -> np.ndarray:
    """Recheck every piece; returns ``bool[n_pieces]``.

    ``hasher``: ``"gpu"`` (the default: the batched device path, the
    counterpart of the reference's ``"tpu"``; takes ``device``,
    ``devices``, ``mesh``, ``batch_size``, ``io_threads`` and ``local``)
    or ``"cpu"`` (streaming hashlib). v2 session infos (session/v2.py)
    route to the merkle recheck automatically; it runs on one card, as
    the reference's v2 plane has no mesh, and ignores ``devices`` and
    ``mesh``.

    In a ``torch.distributed`` group of more than one rank both device
    routes go multi-process, and every rank must call this on the same
    torrent: v1 through ``verify_pieces_gpu``, v2 through
    ``verify_pieces_v2_distributed`` (each rank's round-robin stride,
    one allgather). ``local=True``, or for v2 an explicit ``indices``
    subset (rank-local by definition), keeps the rank-local path.
    """
    if info.num_pieces == 0:
        return np.zeros(0, dtype=bool)
    v2 = getattr(info, "v2", False)
    if hasher == "cpu":
        fn = verify_pieces_v2_cpu if v2 else verify_pieces_cpu
        return fn(storage, info, progress_cb)
    if hasher == "gpu":
        if not v2:
            return verify_pieces_gpu(storage, info, progress_cb=progress_cb, **gpu_kwargs)
        from torrent_tpu_torch.parallel.distributed import verify_pieces_v2_distributed, world

        local = gpu_kwargs.pop("local", False)
        if not local and "indices" not in gpu_kwargs and world()[0] > 1:
            return verify_pieces_v2_distributed(
                storage,
                info,
                batch_size=gpu_kwargs.get("batch_size", 256),
                device=gpu_kwargs.get("device"),
                progress_cb=progress_cb,
            )
        return verify_pieces_v2_gpu(storage, info, progress_cb=progress_cb, **gpu_kwargs)
    raise ValueError(f"unknown hasher {hasher!r}")
