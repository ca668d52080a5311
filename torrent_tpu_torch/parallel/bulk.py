"""Bulk library validation — BASELINE config 5 (1000 torrents × ~1 GiB).

Verifying a library torrent-by-torrent wastes device time twice: one
set-up + ragged tail batch per torrent. Here torrents are grouped by
piece geometry (one verifier per piece length) and their pieces are
flattened into a single work list, so every device batch is full —
pieces from different torrents ride the same launch — and only the
library's final batch is ragged.

``verify_library_sched`` runs the same sweep as a session of the shared
hash-plane scheduler (``sched/``), so a bulk recheck coalesces with
foreground verify traffic instead of competing for the card.

Across processes, each rank runs ``verify_library`` over its shard of
the library (``parallel/distributed.verify_library_distributed``), and
``verify_library_fabric`` composes that sharding WITH the shared
scheduler: each process's shard feeds its local continuous-batching
queue (``torrent_tpu_torch/fabric``), so multi-process rechecks coalesce
with foreground verify traffic instead of competing for the plane.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from torrent_tpu_torch.codec.metainfo import InfoDict
from torrent_tpu_torch.ops.padding import alloc_padded, digests_to_words, pad_in_place
from torrent_tpu_torch.parallel.verify import read_runs, verify_pieces_cpu
from torrent_tpu_torch.storage.storage import Storage


@dataclass
class LibraryResult:
    bitfields: list[np.ndarray]
    n_pieces: int
    bytes_hashed: int
    seconds: float

    @property
    def pieces_per_sec(self) -> float:
        return self.n_pieces / self.seconds if self.seconds > 0 else float("inf")

    @property
    def gib_per_sec(self) -> float:
        return self.bytes_hashed / self.seconds / 2**30 if self.seconds > 0 else float("inf")


def verify_library(
    items: list[tuple[Storage, InfoDict]],
    hasher: str = "gpu",
    batch_size: int = 1024,
    device=None,
    io_threads: int = 4,
    progress_cb=None,
    verifier=None,
    devices=None,
    mesh=None,
) -> LibraryResult:
    """Recheck every torrent; returns per-torrent bitfields in order.

    ``hasher``: ``"cpu"`` (streaming hashlib) or ``"gpu"`` (the batched
    device path on a grid: ``device`` alone, ``devices`` or ``mesh``, as
    ``GPUVerifier`` takes them; with none of them every card of the
    process, and a host without one raises; ``device="cpu"`` is the
    plain PyTorch path).
    ``verifier``: reuse a ``GPUVerifier`` across calls (its geometry
    must match every torrent's piece length) — repeated library sweeps
    then skip the set-up entirely.
    """
    t0 = time.perf_counter()
    bitfields = [np.zeros(info.num_pieces, dtype=bool) for _, info in items]
    total_pieces = sum(info.num_pieces for _, info in items)
    total_bytes = sum(info.length for _, info in items)

    if hasher == "cpu":
        done_pieces = 0
        for i, (storage, info) in enumerate(items):
            bitfields[i] = verify_pieces_cpu(storage, info)
            done_pieces += info.num_pieces
            if progress_cb:
                # same (pieces_done, pieces_total) contract as the gpu path
                # and parallel/verify.py's ProgressCb
                progress_cb(done_pieces, total_pieces)
        return LibraryResult(
            bitfields, total_pieces, total_bytes, time.perf_counter() - t0
        )
    if hasher != "gpu":
        raise ValueError(f"unknown hasher {hasher!r}")

    from torrent_tpu_torch.models.verifier import GPUVerifier

    # Group torrents by piece length: one verifier per geometry.
    groups: dict[int, list[int]] = {}
    for idx, (_, info) in enumerate(items):
        groups.setdefault(info.piece_length, []).append(idx)

    done = 0
    for plen, group in groups.items():
        if verifier is not None:
            if verifier.piece_length != plen:
                raise ValueError(
                    f"shared verifier is built for piece_length="
                    f"{verifier.piece_length}, library has {plen}"
                )
            group_verifier = verifier
        else:
            group_verifier = GPUVerifier(
                piece_length=plen, batch_size=batch_size, device=device,
                devices=devices, mesh=mesh,
            )
        b = group_verifier.batch_size
        # Flattened torrent-major work list: rows of one batch that belong
        # to the same torrent are contiguous, so loads stay batched reads.
        work: list[tuple[int, int]] = [
            (ti, pi) for ti in group for pi in range(items[ti][1].num_pieces)
        ]
        expected = {
            ti: digests_to_words(items[ti][1].pieces) for ti in group
        }
        staging = [alloc_padded(b, plen) for _ in range(2)]
        stripes = max(1, io_threads)
        io_pool = ThreadPoolExecutor(max_workers=stripes) if stripes > 1 else None

        def load(slot: int, start: int):
            padded, view = staging[slot]
            rows = work[start : start + b]
            k = len(rows)
            lengths = np.zeros(b, dtype=np.int64)
            exp = np.zeros((b, 5), dtype=np.uint32)
            # contiguous per-torrent runs → one read_batch per run
            runs = []
            row = 0
            while row < k:
                ti = rows[row][0]
                run_end = row
                while run_end < k and rows[run_end][0] == ti:
                    run_end += 1
                idxs = [pi for _, pi in rows[row:run_end]]
                storage, info = items[ti]
                runs.append((storage, idxs, view[row:run_end]))
                for j, pi in enumerate(idxs):
                    lengths[row + j] = min(plen, info.length - pi * plen)
                    exp[row + j] = expected[ti][pi]
                row = run_end
            read_runs(runs, io_pool)
            padded[:, plen:] = 0
            if k < b:
                padded[k:] = 0
            nblocks = pad_in_place(padded, lengths)
            if k < b:
                nblocks[k:] = 0
            return padded, nblocks, exp, rows

        try:
            with ThreadPoolExecutor(max_workers=1) as pool:
                fut = pool.submit(load, 0, 0)
                start = 0
                slot = 0
                while start < len(work):
                    padded, nblocks, exp, rows = fut.result()
                    nxt = start + b
                    if nxt < len(work):
                        slot = 1 - slot
                        fut = pool.submit(load, slot, nxt)
                    ok = group_verifier.verify_batch(padded, nblocks, exp)
                    for j, (ti, pi) in enumerate(rows):
                        bitfields[ti][pi] = ok[j]
                    done += len(rows)
                    if progress_cb:
                        progress_cb(done, total_pieces)
                    start = nxt
        finally:
            if io_pool is not None:
                io_pool.shutdown(wait=False)

    return LibraryResult(bitfields, total_pieces, total_bytes, time.perf_counter() - t0)


async def verify_library_sched(
    items: list[tuple[Storage, InfoDict]],
    scheduler,
    tenant: str = "bulk",
    progress_cb=None,
) -> LibraryResult:
    """Bulk validation as a scheduler session.

    The sync ``verify_library`` owns its own batch loop; this variant
    submits every torrent's pieces to the shared hash-plane scheduler
    (``sched/``) instead. Cross-torrent coalescing then falls
    out of the queue itself — the tail of one torrent and the head of
    the next ride the same device launch, and pieces from *other*
    concurrent callers (bridge clients, CLI verifies) fill the batch
    too, with the scheduler's DRR keeping them fair. Geometry grouping
    is the scheduler's lane map, so the planes (built kernels, staging,
    streams) are shared with every other consumer rather than per-call.

    Per-piece hash failures (``SchedLaunchError`` after the scheduler's
    retry/bisection) leave those pieces unverified (False) and the sweep
    continues — a poisoned piece in torrent 3 must not abort the other
    997 torrents' results.
    """
    from torrent_tpu_torch.parallel.verify import enqueue_torrent_sched
    from torrent_tpu_torch.sched import SchedLaunchError
    from torrent_tpu_torch.utils.log import get_logger

    t0 = time.perf_counter()
    bitfields = [np.zeros(info.num_pieces, dtype=bool) for _, info in items]
    total_pieces = sum(info.num_pieces for _, info in items)
    total_bytes = sum(info.length for _, info in items)

    # enqueue the WHOLE library before awaiting any result: the ragged
    # tail of torrent i is still queued when torrent i+1's head arrives,
    # so they share a launch instead of each paying a deadline flush
    pending: list[tuple] = []
    for ti, (storage, info) in enumerate(items):
        for fut, keep in await enqueue_torrent_sched(storage, info, scheduler, tenant):
            pending.append((fut, ti, keep))
    done = 0
    for fut, ti, keep in pending:
        try:
            ok = await fut
        except SchedLaunchError as e:
            get_logger("parallel.bulk").warning(
                "library sweep: %d pieces of torrent %d unverified "
                "(hash launch failed: %s)", len(keep), ti, e,
            )
            done += len(keep)  # stay False: recheck later
            if progress_cb:
                progress_cb(min(done, total_pieces), total_pieces)
            continue
        for j, pi in enumerate(keep):
            bitfields[ti][pi] = bool(ok[j])
        done += len(keep)
        if progress_cb:
            progress_cb(min(done, total_pieces), total_pieces)
    return LibraryResult(bitfields, total_pieces, total_bytes, time.perf_counter() - t0)


async def verify_library_fabric(
    items: list[tuple[Storage, InfoDict]],
    scheduler,
    nproc: int | None = None,
    pid: int | None = None,
    heartbeat_dir: str | None = None,
    transport=None,
    fabric_config=None,
    unit_bytes: int | None = None,
    progress_cb=None,
    executor_out: list | None = None,
) -> LibraryResult:
    """Pod-scale bulk validation THROUGH each process's scheduler —
    the composition of ``verify_library_sched`` (cross-tenant
    coalescing) and ``verify_library_distributed`` (process sharding).

    A deterministic byte-weight shard plan is computed identically on
    every process (``torrent_tpu_torch.fabric.plan`` — no coordinator RPC);
    each process feeds its shard of (torrent, piece-range) units into
    its LOCAL scheduler as a low-priority ``"fabric"`` tenant, so bulk
    recheck launches coalesce with foreground verify traffic instead of
    competing with it. A periodic few-byte heartbeat carries progress
    and verdict bits; survivors adopt orphaned units from lapsed or
    breaker-degraded processes with a sentinel cross-check per adopted
    unit (see ``torrent_tpu_torch.fabric.executor``).

    ``items``: the SAME list, in the same order, on every process (each
    host opens its own storage handles; only the shard is read).
    ``nproc``/``pid`` default to the live ``torch.distributed`` process
    group (world size and rank); pass them explicitly (with
    ``heartbeat_dir`` for the shared-filesystem heartbeat transport) to
    run without a process group.
    ``executor_out``: optional list the executor is appended to, so
    callers can poll ``metrics_snapshot()`` while the sweep runs.

    Returns a :class:`LibraryResult` whose bitfields are identical on
    every process. ``progress_cb`` reports THIS process's verified
    pieces against the library-wide total.
    """
    from torrent_tpu_torch.fabric import DEFAULT_UNIT_BYTES, build_fabric_executor

    t0 = time.perf_counter()
    ex = build_fabric_executor(
        items,
        scheduler,
        nproc=nproc,
        pid=pid,
        heartbeat_dir=heartbeat_dir,
        transport=transport,
        config=fabric_config,
        unit_bytes=unit_bytes or DEFAULT_UNIT_BYTES,
        progress_cb=progress_cb,
    )
    if executor_out is not None:
        executor_out.append(ex)
    await ex.run()
    total_pieces = sum(info.num_pieces for _, info in items)
    total_bytes = sum(info.length for _, info in items)
    return LibraryResult(
        ex.bitfields(), total_pieces, total_bytes, time.perf_counter() - t0
    )
