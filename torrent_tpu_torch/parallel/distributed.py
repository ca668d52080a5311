"""Multi-process support for the verify/bulk hash planes, on
``torch.distributed``.

The counterpart of the reference's ``parallel/distributed.py``. The
reference shards each global batch over a ``(hosts, dp)`` mesh and
reduces over DCN; here each rank of a ``torch.distributed`` process
group hashes on its own row of the grid (``parallel/mesh.py``), its
local cards, and only bitfields, counts and heartbeat bytes cross ranks:

- :func:`initialize` — ``init_process_group`` with an idempotence guard,
  the rank's cards (:func:`local_devices`), and the backend stated,
  never guessed.
- :func:`allgather_rows` — one ``all_gather`` of a fixed-size ``uint8``
  row from every rank (the bitfield and the fabric heartbeat ride it).
- :func:`allgather_bitfield` — OR-assembled disjoint bitfields.
- :func:`psum_valid_count` — the count of valid pieces, summed on each
  of the rank's entries and ``all_reduce``d as one int64.
- :func:`verify_storage_distributed` — the multi-process recheck: each
  rank reads its slice of every global batch and hashes it over its
  entries with its own ``GPUVerifier``; every rank returns the same
  global bitfield.
- :func:`verify_pieces_v2_distributed` / :func:`verify_library_distributed`
  — round-robin strides of pieces (v2) or torrents (library).

Row layout contract (the reference's): over ``P`` ranks, rank ``p``
loads pieces ``[g*B + p*L, g*B + (p+1)*L)`` of global batch ``g``, with
``L = B / P``, and its ``D`` entries take contiguous blocks of ``L / D``
of them. Piece bytes never cross a rank.

Backends: NCCL keeps the count on the card and needs one CUDA device a
rank at the least; gloo carries host tensors and may share one card
between ranks.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0

# the rank's cards, as initialize() divided the host's among its ranks;
# None outside a group that initialize() joined on CUDA
_local_cards: list | None = None


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> tuple[int, int]:
    """``(world_size, rank)`` of the default process group, or ``(1, 0)``
    when none is initialised."""
    if _grouped():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def initialize(
    init_method: str,
    world_size: int,
    rank: int,
    backend: str | None = None,
    timeout: float = DEFAULT_TIMEOUT_S,
    device=None,
) -> str:
    """Join the default process group; returns its backend.

    Idempotent: with a group already initialised this returns its
    backend and changes nothing. ``device`` is the rank's device kind
    (None means CUDA, ``"cpu"`` the plain path). On CUDA the host's
    cards are divided among its ranks (:func:`rank_cards`): one rank a
    host takes every card, ``torchrun``'s one rank a card takes one; the
    first is set with ``torch.cuda.set_device`` and all are the rank's
    :func:`local_devices`. ``local_rank`` is ``LOCAL_RANK`` when a
    launcher set it, else ``rank``; the host's ranks are
    ``LOCAL_WORLD_SIZE``, else ``world_size``. ``backend=None`` means
    ``"nccl"`` on CUDA and ``"gloo"`` on the CPU. ``"nccl"`` with more
    ranks on this host than CUDA devices raises ``ValueError`` before
    any group is created: NCCL cannot run two ranks on one device, and
    ``backend="gloo"`` can. ``timeout`` is every collective's, in
    seconds."""
    global _local_cards
    if dist.is_initialized():
        return dist.get_backend()
    on_cuda = torch.device("cuda" if device is None else device).type == "cuda"
    if on_cuda and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path explicitly"
        )
    backend = backend or ("nccl" if on_cuda else "gloo")
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if backend == "nccl":
        if not on_cuda:
            raise ValueError("backend 'nccl' needs a CUDA device; use backend='gloo' on the CPU")
        cards = torch.cuda.device_count()
        if local_ranks > cards:
            raise ValueError(
                f"backend 'nccl' needs one CUDA device a rank: {local_ranks} ranks on this "
                f"host, {cards} devices; pass backend=\"gloo\" to share a device between ranks"
            )
    mine = None
    if on_cuda:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        mine = rank_cards(local_rank, local_ranks, torch.cuda.device_count())
        torch.cuda.set_device(mine[0])
    dist.init_process_group(
        backend,
        init_method=init_method,
        world_size=world_size,
        rank=rank,
        timeout=timedelta(seconds=timeout),
    )
    _local_cards = mine
    return backend


def rank_cards(local_rank: int, local_ranks: int, cards: int) -> list:
    """The CUDA devices of local rank ``local_rank`` of ``local_ranks``
    on a host of ``cards``: an even share of contiguous cards when every
    rank can have one, else card ``local_rank % cards`` (ranks share a
    card, which only gloo allows)."""
    if local_ranks > cards:
        return [torch.device("cuda", local_rank % cards)]
    share = cards // local_ranks
    return [torch.device("cuda", local_rank * share + i) for i in range(share)]


def local_devices() -> list:
    """This process's cards: those :func:`initialize` gave the rank, else
    every visible card. Raises ``DeviceUnavailable`` without CUDA (None
    means CUDA, and nothing falls back to the CPU)."""
    from torrent_tpu_torch.utils.device import resolve_device

    current = resolve_device(None)
    if _local_cards is not None:
        return list(_local_cards)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())] or [current]


def shutdown() -> None:
    """Leave the default process group, if one is initialised."""
    global _local_cards
    if _grouped():
        dist.destroy_process_group()
    _local_cards = None


def _collective_device():
    """Where a collective's tensors live: the rank's CUDA device under
    NCCL, the host under every other backend."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_rows(row: np.ndarray) -> np.ndarray:
    """``uint8[world, n]``: every rank's ``uint8[n]`` row, in rank order.
    Every rank must pass the same ``n``; without a process group the
    result is this rank's row alone."""
    row = np.ascontiguousarray(row, dtype=np.uint8).reshape(-1)
    if not _grouped():
        return row[None, :].copy()
    size, _ = world()
    dev = _collective_device()
    mine = torch.from_numpy(row).to(dev)
    rows = [torch.empty_like(mine) for _ in range(size)]
    dist.all_gather(rows, mine)
    return torch.stack(rows).cpu().numpy()


def allgather_bitfield(local_contrib: np.ndarray) -> np.ndarray:
    """OR-assemble per-rank disjoint bitfield contributions into the
    global bitfield (identical on every rank). A byte per piece — the
    only payload of a recheck that crosses ranks."""
    return allgather_rows(np.asarray(local_contrib).astype(np.uint8)).any(axis=0)


def psum_valid_count(ok_local) -> torch.Tensor:
    """The count of True in every rank's ``ok_local`` (a bool tensor, or
    a list of them, one a grid entry, each on its entry's device), as
    one int64 ``all_reduce``d over the group. Each entry's part is
    summed where it lives and the rank's parts are added before the one
    collective; under NCCL the count stays on the card and the result is
    a CUDA tensor, under gloo it goes to the host first. ``int()`` of the
    result is the same total on every rank."""
    parts = [ok_local] if isinstance(ok_local, torch.Tensor) else list(ok_local)
    dev = _collective_device() if _grouped() else parts[0].device
    count = None
    for part in parts:
        if part.is_cuda:
            # the sum reads the part on this device's current stream;
            # keep its memory from reuse by the stream that made it
            part.record_stream(torch.cuda.current_stream(part.device))
        c = part.sum(dtype=torch.int64).reshape(1).to(dev)
        count = c if count is None else count + c
    if not _grouped():
        return count
    dist.all_reduce(count)
    return count


def verify_storage_distributed(
    storage,
    info,
    batch_size: int = 1024,
    device=None,
    progress_cb=None,
    io_threads: int = 4,
    devices=None,
    mesh=None,
):
    """The multi-process recheck; returns ``(bitfield, n_valid)``,
    identical on every rank. ``n_valid`` comes from the count
    collective, once per global batch, so the collective path runs on
    every call; it equals ``bitfield.sum()`` because sentinel and
    out-of-range rows carry ``expected = 0``, which no SHA-1 digest
    equals.

    The grid is ``mesh``, or one over the group of ``devices``, of
    ``device``, or of every rank's cards (``parallel/mesh.py``); rank
    ``p`` hashes on row ``p``, its ``D`` entries. ``batch_size`` rounds
    up to a multiple of the grid's size, as the reference's verifier's
    does, and each rank owns one ``GPUVerifier`` of batch ``L =
    batch_size / world_size`` over its entries: it reads its rows of
    each global batch into the verifier's two staging slots, a loader
    thread filling one while the other is hashed, each entry its block
    of ``L / D`` rows. Every rank enters the count collective once per
    global batch, also with an empty tail slice: a rank that left early
    would deadlock its peers.
    """
    from torrent_tpu_torch.models.verifier import GPUVerifier
    from torrent_tpu_torch.ops.padding import digests_to_words, pad_in_place
    from torrent_tpu_torch.parallel.mesh import round_up_to_multiple, spanning_grid
    from torrent_tpu_torch.parallel.verify import read_runs, striped

    nproc, pid = world()
    grid = spanning_grid(device, devices, mesh)
    B = round_up_to_multiple(max(1, int(batch_size), grid.size), grid.size)
    if B % nproc:
        raise ValueError(f"batch_size {B} not divisible by {nproc} processes")
    L = B // nproc
    verifier = GPUVerifier(piece_length=info.piece_length, batch_size=L, mesh=grid)
    if verifier.batch_size != L:
        raise ValueError(f"rank {pid}'s {L} rows of a batch do not split over its {verifier.mesh.size} entries")
    n = info.num_pieces
    plen = info.piece_length
    n_batches = math.ceil(n / B)
    # this rank's expected digests, row r of batch g at g*L + r; rows
    # past the torrent stay zero and never match
    expected_all = digests_to_words(info.pieces)
    expected = np.zeros((n_batches * L, 5), dtype=np.uint32)
    for g in range(n_batches):
        lo = g * B + pid * L
        hi = min(lo + L, n)
        if hi > lo:
            expected[g * L : g * L + hi - lo] = expected_all[lo:hi]
    expected_dev = verifier.expected_rows(expected)
    local_contrib = np.zeros(n, dtype=bool)
    slots = verifier.staging_slots()
    stripes = max(1, io_threads)
    io_pool = ThreadPoolExecutor(max_workers=stripes) if stripes > 1 else None

    def load(slot, g: int) -> range:
        # a slot is refilled only after its last host→device copy ended
        slot.wait_host_free()
        padded = slot.padded
        view = padded[:, :plen]
        lo = g * B + pid * L
        idxs = range(lo, min(lo + L, n))
        k = len(idxs)
        if k:
            read_runs(striped(storage, idxs, view, stripes), io_pool)
        padded[:, plen:] = 0  # clear pad tail (stale 0x80/bitlen bytes)
        if k < L:
            padded[k:] = 0
        lengths = np.zeros(L, dtype=np.int64)
        lengths[:k] = np.minimum(plen, info.length - np.arange(lo, lo + k) * plen)
        slot.nblocks[:] = pad_in_place(padded, lengths)
        slot.nblocks[k:] = 0  # sentinel rows
        return idxs

    total = None
    pending = None  # (g, idxs, slot) launched, not yet drained

    def drain(g: int, idxs: range, slot) -> None:
        nonlocal total
        ok = slot.fetch_ok()
        local_contrib[idxs.start : idxs.stop] = ok[: len(idxs)]
        count = psum_valid_count(slot.ok_dev)
        total = count if total is None else total + count
        if progress_cb:
            progress_cb(min((g + 1) * B, n), n)

    try:
        with ThreadPoolExecutor(max_workers=1) as loader:
            fut = loader.submit(load, slots[0], 0)
            for g in range(n_batches):
                idxs = fut.result()
                if g + 1 < n_batches:
                    # refills the slot of batch g-1 once its copy ended;
                    # its result lives apart from the host buffers
                    fut = loader.submit(load, slots[(g + 1) % 2], g + 1)
                slot = slots[g % 2]
                slot.launch(verifier._sha1, expected_dev, g)
                if pending is not None:
                    # the kernel of batch g runs while batch g-1 is counted
                    drain(*pending)
                pending = (g, idxs, slot)
            if pending is not None:
                drain(*pending)
    finally:
        if io_pool is not None:
            io_pool.shutdown(wait=False)
    bitfield = allgather_bitfield(local_contrib)
    return bitfield, 0 if total is None else int(total.item())


def verify_pieces_v2_distributed(
    storage,
    info,
    batch_size: int = 256,
    device=None,
    progress_cb=None,
) -> np.ndarray:
    """The multi-process BEP 52 (merkle) recheck: pieces are verified
    independently, so each rank takes its round-robin stride of the
    piece index space through the ordinary v2 device plane
    (``verify_pieces_v2_gpu``), and one allgather assembles the disjoint
    contributions. Returns the identical full bitfield on every rank.

    Every rank must call this on the same torrent (the allgather blocks
    until all arrive). For a rank-local recheck call
    ``verify_pieces_v2_gpu`` directly."""
    from torrent_tpu_torch.parallel.verify import verify_pieces_v2_gpu

    nproc, pid = world()
    local = verify_pieces_v2_gpu(
        storage,
        info,
        batch_size=batch_size,
        device=device,
        progress_cb=progress_cb,
        indices=range(pid, info.num_pieces, nproc),
    )
    return allgather_bitfield(local)


def verify_library_distributed(
    items,
    batch_size: int = 1024,
    device=None,
    io_threads: int = 4,
    progress_cb=None,
    devices=None,
    mesh=None,
):
    """Multi-process bulk library validation (BASELINE config 5): each
    rank runs ``verify_library(hasher="gpu")`` over its round-robin shard
    of the library on its own entries of the grid (``device``,
    ``devices`` or ``mesh``, as :func:`verify_storage_distributed` takes
    them; every card of the rank by default), then the per-torrent
    bitfields are assembled over one packed allgather. Returns
    ``(bitfields, n_valid)``, identical on every rank.

    ``items``: ``list[(Storage, InfoDict)]`` — the SAME list, in the
    same order, on every rank (each opens its own storage handles; only
    its shard is read). ``progress_cb`` reports THIS rank's shard
    progress; only the return values are identical on every rank."""
    from torrent_tpu_torch.parallel.bulk import verify_library

    nproc, pid = world()
    # round-robin, not contiguous: libraries are often sorted by size,
    # and striding spreads the big torrents evenly across ranks
    mine = list(range(pid, len(items), nproc))
    result = verify_library(
        [items[i] for i in mine],
        hasher="gpu",
        batch_size=batch_size,
        device=device,
        io_threads=io_threads,
        progress_cb=progress_cb,
        devices=devices,
        mesh=None if mesh is None else mesh.local(),
    )
    offsets = np.zeros(len(items) + 1, dtype=np.int64)
    for i, (_, info) in enumerate(items):
        offsets[i + 1] = offsets[i] + info.num_pieces
    flat = np.zeros(int(offsets[-1]), dtype=bool)
    for j, i in enumerate(mine):
        flat[offsets[i] : offsets[i + 1]] = result.bitfields[j]
    flat = allgather_bitfield(flat)
    bitfields = [flat[offsets[i] : offsets[i + 1]].copy() for i in range(len(items))]
    return bitfields, int(flat.sum())
