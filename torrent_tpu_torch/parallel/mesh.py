"""The device grid of the v1 hash plane.

The counterpart of the reference's ``parallel/mesh.py``. The reference
shards every SHA-1 batch over a ``(hosts, dp)`` ``jax.sharding.Mesh``:
axis ``dp`` is a host's chips, axis ``hosts`` the processes of a
``jax.distributed`` cluster, and a batch's rows are split over both
axes in ``P((hosts, dp))`` order. Here a grid is a :class:`Mesh` of
``torch.device`` entries with the same two axes:

- row ``p`` of a grid that spans several processes is the entries of
  rank ``p`` of the ``torch.distributed`` group; a process hashes only
  on its own entries (:meth:`Mesh.local`), and only bitfields and counts
  cross ranks (``parallel/distributed.py``);
- :func:`row_blocks` is the counterpart of ``batch_sharding``: entry
  ``d`` of the flattened grid takes the contiguous rows ``[d*B/D,
  (d+1)*B/D)`` of a batch of ``B`` rows;
- a grid may name one device more than once, as the reference's tests
  run on virtual CPU devices: each entry still gets its own buffers and
  streams (``models/verifier.py``).

SHA-1's block chain is serial within a piece, so all scale-out is
across pieces: nothing but the result rows crosses an entry.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from torrent_tpu_torch.parallel import distributed
from torrent_tpu_torch.utils import device as device_mod

DP_AXIS = "dp"
HOST_AXIS = "hosts"


class GridDevice(NamedTuple):
    """A grid entry that names its owner: ``device`` of rank
    ``process_index`` (the reference's ``Device.process_index``)."""

    process_index: int
    device: torch.device


class Mesh:
    """A ``(hosts, dp)`` grid of devices: ``devices[h, d]`` is a
    ``torch.device``, ``processes[h, d]`` the rank that owns it."""

    axis_names = (HOST_AXIS, DP_AXIS)

    def __init__(self, rows: list[list[GridDevice]]):
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        self.processes = np.empty(self.devices.shape, dtype=np.int64)
        for h, row in enumerate(rows):
            for d, entry in enumerate(row):
                self.devices[h, d] = entry.device
                self.processes[h, d] = entry.process_index

    @property
    def shape(self) -> dict:
        """Each axis' size by name, as the reference's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def entries(self) -> list[torch.device]:
        """The grid's devices in ``P((hosts, dp))`` (row-major) order."""
        return list(self.devices.flat)

    def process_span(self) -> int:
        """How many processes own an entry of the grid."""
        return len(set(self.processes.flat))

    def local(self, rank: int | None = None) -> "Mesh":
        """The entries of ``rank`` (default: this process's rank), in
        grid order; the grid itself when it is all this rank's."""
        if rank is None:
            rank = distributed.world()[1]
        mine = self.processes == rank
        if mine.all():
            return self
        rows = [
            [GridDevice(rank, dev) for dev, own in zip(drow, prow) if own]
            for drow, prow in zip(self.devices, mine)
        ]
        rows = [r for r in rows if r]
        if not rows:
            raise ValueError(f"the grid has no entry on rank {rank}")
        return Mesh(rows)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, entries={[str(d) for d in self.entries]})"


def _entry(x, rank: int) -> tuple[GridDevice, bool]:
    """``(entry, named)``: a :class:`GridDevice` keeps its owner and is not
    resolved here; any other device is this rank's and is resolved (None
    means CUDA)."""
    if isinstance(x, GridDevice):
        return GridDevice(int(x.process_index), torch.device(x.device)), True
    return GridDevice(rank, device_mod.resolve_device(x)), False


def make_mesh(devices=None, n_hosts: int | None = None) -> Mesh:
    """Build a ``(hosts, dp)`` grid over ``devices`` (default: every card
    of this process, ``distributed.local_devices()``).

    ``n_hosts`` defaults to the ``torch.distributed`` world size (1
    without a group). With several ranks and ``n_hosts`` equal to the
    world size, row ``p`` is rank ``p``'s entries: entries that name
    their owner (:class:`GridDevice`) are grouped by it and must be
    evenly spread; plain devices are this rank's row, and every rank's
    row has this rank's layout. Otherwise the entries are this process's
    and are reshaped to ``(n_hosts, size / n_hosts)``. Entries must be
    all CUDA or all CPU; CUDA asked for on a host without it raises.
    """
    nproc, rank = distributed.world()
    if n_hosts is None:
        n_hosts = nproc
    if devices is None:
        devices = distributed.local_devices()
    pairs = [_entry(x, rank) for x in devices]
    if not pairs:
        raise ValueError("a grid needs at least one device")
    entries = [e for e, _ in pairs]
    kinds = {e.device.type for e in entries}
    if len(kinds) > 1:
        raise ValueError(f"a grid's entries must be all CUDA or all CPU, not {sorted(kinds)}")
    if nproc > 1 and n_hosts == nproc:
        if not any(named for _, named in pairs):
            return Mesh([[GridDevice(p, e.device) for e in entries] for p in range(nproc)])
        # row p MUST be rank p's entries, so the rows a rank loads are
        # the rows its own devices hash
        rows = [[e for e in entries if e.process_index == p] for p in range(n_hosts)]
        width = len(rows[0])
        if width == 0 or any(len(r) != width for r in rows):
            raise ValueError(
                "devices are not evenly spread over processes: " + str([len(r) for r in rows])
            )
        return Mesh(rows)
    if len(entries) % n_hosts != 0:
        raise ValueError(f"{len(entries)} devices not divisible by {n_hosts} hosts")
    width = len(entries) // n_hosts
    return Mesh([entries[h * width : (h + 1) * width] for h in range(n_hosts)])


def spanning_grid(device=None, devices=None, mesh=None) -> Mesh:
    """The grid of a hash plane's arguments, over every rank of the
    ``torch.distributed`` group (the grid itself without one): ``mesh``,
    a grid of ``devices``, of the one entry ``device``, or, with none of
    them, of every card of the process. At most one may be given."""
    if sum(x is not None for x in (device, devices, mesh)) > 1:
        raise ValueError("pass at most one of device=, devices=, mesh=")
    if mesh is not None:
        return mesh
    return make_mesh([device] if device is not None else devices)


def local_grid(device=None, devices=None, mesh=None) -> Mesh:
    """This process's entries of :func:`spanning_grid`: the grid a hash
    plane of this process runs on."""
    return spanning_grid(device, devices, mesh).local()


def row_blocks(mesh: Mesh, batch: int) -> list[tuple[int, torch.device, int, int]]:
    """``(entry index, device, lo, hi)`` of each grid entry's rows of a
    ``batch``-row array: contiguous blocks of ``batch / size`` rows in
    ``P((hosts, dp))`` order. ``batch`` must be a multiple of the grid's
    size (``round_up_to_multiple``)."""
    if batch % mesh.size:
        raise ValueError(f"batch of {batch} rows not divisible by a grid of {mesh.size}")
    w = batch // mesh.size
    return [(i, dev, i * w, (i + 1) * w) for i, dev in enumerate(mesh.entries)]


def round_up_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k
