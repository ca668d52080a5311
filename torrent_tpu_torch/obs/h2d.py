"""The host-to-device copy, counted: how fast each slot copy ran on the
card, whether a load ran beside it, and where its host memory and the
loader sit relative to the card.

Four pipeline-ledger counters (``obs/ledger.py``), charged by
:meth:`PipelineLedger.record` on the direct recheck paths
(``models/verifier.py::GPUVerifier.verify_storage``,
``parallel/verify.py::verify_pieces_v2_gpu``):

* ``h2d_beside_load`` / ``h2d_alone`` — one op a slot copy: its bytes
  (the data rows and the block counts) and its seconds on the card, from
  two timing events around it on the stream that carries it. A copy is
  ``beside_load`` when the loader's next load was still running as the
  copy was enqueued.
* ``h2d_local`` — one op a copy whose placement is known, with the bytes
  of it that come from host pages on the card's NUMA node.
* ``load_local`` — one op a load that starts on a CPU of the card's node.

Everything here only reads: the nodes come from sysfs, a page's node from
``move_pages`` with no target nodes (which reports and moves nothing), a
thread's CPU from ``sched_getcpu``. A host whose node tree shows one
node counts every byte and every load as local. Where the node tree or
the syscall is missing, or the card's node is unknown on a host of
several, nothing is counted. The counters are
``PipelineLedger.COUNTERS``: ``obs/attrib.py`` never names one the
bottleneck.
"""

from __future__ import annotations

import ctypes
import functools
import os
import platform
import re
import sys

__all__ = [
    "Copy",
    "HostPages",
    "Placement",
    "SlabPages",
    "card_node",
    "charge_load",
    "current_cpu",
    "device_placement",
    "numa_nodes",
    "page_nodes",
    "parse_cpulist",
    "placement",
]

SYSFS = "/sys"
SAMPLE_BYTES = 2 << 20  # one page sampled in every 2 MiB of a slab
# move_pages(2) by machine; nodes=NULL makes it report each page's node
_MOVE_PAGES = {"x86_64": 279, "aarch64": 239}


# ------------------------------------------------------------ reading the host


def parse_cpulist(text: str) -> list[int]:
    """CPUs of a sysfs ``cpulist`` (``0-3,8-11``); empty for an empty list."""
    cpus: list[int] = []
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            cpus.extend(range(int(lo), int(hi or lo) + 1))
    return cpus


def numa_nodes(sysfs: str = SYSFS) -> dict[int, list[int]] | None:
    """Each NUMA node of the host and its CPUs (a node of memory alone has
    none), from ``devices/system/node/node*/cpulist``; None without the
    node tree, where the placement cannot be seen."""
    root = os.path.join(sysfs, "devices", "system", "node")
    try:
        names = os.listdir(root)
    except OSError:
        return None
    nodes = {}
    for name in names:
        if re.fullmatch(r"node\d+", name):
            try:
                with open(os.path.join(root, name, "cpulist")) as f:
                    nodes[int(name[4:])] = parse_cpulist(f.read())
            except OSError:
                continue
    return nodes or None


def card_node(pci_address: str | None, sysfs: str = SYSFS) -> int:
    """The NUMA node sysfs gives the PCI device ``pci_address``
    (``0000:1b:00.0``); -1 where it gives none or there is no address."""
    if not pci_address:
        return -1
    try:
        with open(os.path.join(sysfs, "bus", "pci", "devices", pci_address.lower(), "numa_node")) as f:
            return int(f.read())
    except (OSError, ValueError):
        return -1


@functools.cache
def _libc():
    if not sys.platform.startswith("linux"):
        return None
    try:
        return ctypes.CDLL(None, use_errno=True)
    except OSError:
        return None


def page_nodes(address: int, nbytes: int, step: int = SAMPLE_BYTES) -> list[int] | None:
    """The node of one page in every ``step`` bytes of ``[address, address +
    nbytes)``: a node, or a negative errno for a page the kernel cannot
    place. ``move_pages(0, n, pages, NULL, status, 0)`` only reports. None
    where the syscall is missing or refused."""
    libc, nr = _libc(), _MOVE_PAGES.get(platform.machine())
    if libc is None or nr is None or nbytes <= 0:
        return None
    page = os.sysconf("SC_PAGE_SIZE")
    n = -(-nbytes // step)
    pages = (ctypes.c_void_p * n)(*[(address + i * step) // page * page for i in range(n)])
    status = (ctypes.c_int * n)()
    libc.syscall.restype = ctypes.c_long
    rc = libc.syscall(ctypes.c_long(nr), ctypes.c_int(0), ctypes.c_ulong(n), pages, None, status, ctypes.c_int(0))
    return list(status) if rc == 0 else None


def current_cpu() -> int | None:
    """The CPU this thread runs on now (``sched_getcpu``); None without it."""
    libc = _libc()
    fn = getattr(libc, "sched_getcpu", None)
    if fn is None:
        return None
    fn.restype = ctypes.c_int
    cpu = fn()
    return cpu if cpu >= 0 else None


# ------------------------------------------------------------ the card's side


class Placement:
    """A card's NUMA node beside the host's nodes."""

    def __init__(self, card: int, nodes: dict[int, list[int]]):
        self.card = card  # -1: sysfs gives the card no node
        self.nodes = nodes
        self._cpu_node = {cpu: node for node, cpus in nodes.items() for cpu in cpus}

    @property
    def one_node(self) -> bool:
        return len(self.nodes) == 1

    def local(self, node: int) -> bool | None:
        """Whether memory or a CPU on ``node`` sits on the card's node; on a
        host of one node always; None where it cannot be told."""
        if self.one_node:
            return True
        if self.card < 0 or node < 0:
            return None
        return node == self.card

    def cpu_node(self, cpu: int) -> int:
        return self._cpu_node.get(cpu, -1)

    def local_bytes(self, pages: "HostPages", lo: int, hi: int) -> int | None:
        """Bytes ``[lo, hi)`` of ``pages``'s tensor that sit on the card's
        node, each sampled page standing for its ``SAMPLE_BYTES``; None
        where the placement is unknown."""
        if self.one_node:
            return hi - lo
        if self.card < 0:
            return None
        status = pages.status()
        if status is None or all(s < 0 for s in status):
            return None
        step = pages.step
        return sum(
            max(0, min(hi, (i + 1) * step) - max(lo, i * step)) for i, s in enumerate(status) if s == self.card
        )


def placement(pci_address: str | None, sysfs: str = SYSFS) -> Placement | None:
    """The placement of the PCI device ``pci_address``; None without sysfs."""
    nodes = numa_nodes(sysfs)
    return None if nodes is None else Placement(card_node(pci_address, sysfs), nodes)


@functools.cache
def _card_placement(index: int) -> Placement | None:
    import torch

    p = torch.cuda.get_device_properties(index)
    try:
        address = f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}.0"
    except AttributeError:
        address = None
    return placement(address)


def device_placement(device) -> Placement | None:
    """The placement of the CUDA ``device`` (read once a card); None for
    any other device."""
    if device is None or device.type != "cuda":
        return None
    import torch

    return _card_placement(torch.cuda.current_device() if device.index is None else device.index)


class HostPages:
    """Where the pages of one host tensor sit, sampled once, when a host
    of several nodes first asks."""

    def __init__(self, tensor, step: int = SAMPLE_BYTES):
        self.address = tensor.data_ptr()
        self.nbytes = tensor.numel() * tensor.element_size()
        self.step = step
        self._status: list[int] | None = None
        self._asked = False

    def status(self) -> list[int] | None:
        if not self._asked:
            self._status = page_nodes(self.address, self.nbytes, self.step)
            self._asked = True
        return self._status


class SlabPages:
    """Where a staging slab's pinned rows and their block counts sit."""

    def __init__(self, rows, nblocks):
        self._rows, self._nblocks = HostPages(rows), HostPages(nblocks)
        self._row_bytes = rows.shape[1] * rows.element_size()
        self._count_bytes = nblocks.element_size()

    def local_bytes(self, device, lo: int, hi: int) -> int | None:
        """Bytes of rows ``[lo, hi)`` and their block counts on ``device``'s
        node; None where the placement is unknown."""
        p = device_placement(device)
        if p is None:
            return None
        rb, cb = self._row_bytes, self._count_bytes
        parts = (p.local_bytes(self._rows, lo * rb, hi * rb), p.local_bytes(self._nblocks, lo * cb, hi * cb))
        return None if None in parts else sum(parts)


# ------------------------------------------------------------ charging the ledger


class Copy:
    """One slot copy bracketed on the card: ``start`` and ``end`` are timing
    events around its data rows and block counts on the stream that
    carries it, ``local`` the bytes of it on the card's node (None:
    unknown), ``beside`` whether a load was running as it was enqueued.
    :meth:`charge` once the path has waited past ``end``."""

    __slots__ = ("start", "end", "nbytes", "local", "beside")

    def __init__(self, start, end, nbytes: int, local: int | None, beside: bool):
        self.start, self.end, self.nbytes, self.local, self.beside = start, end, nbytes, local, beside

    def charge(self, ledger=None) -> None:
        from torrent_tpu_torch.obs.ledger import pipeline_ledger

        led = ledger or pipeline_ledger()
        seconds = self.start.elapsed_time(self.end) / 1e3
        led.record("h2d_beside_load" if self.beside else "h2d_alone", self.nbytes, seconds)
        if self.local is not None:
            led.record("h2d_local", self.local, 0.0)


def charge_load(device, ledger=None) -> None:
    """At a load's start, on the loader thread: one op to ``load_local``
    when the thread runs on a CPU of ``device``'s node."""
    p = device_placement(device)
    cpu = current_cpu() if p is not None else None
    if cpu is not None and p.local(p.cpu_node(cpu)):
        from torrent_tpu_torch.obs.ledger import pipeline_ledger

        (ledger or pipeline_ledger()).record("load_local", 0, 0.0)
