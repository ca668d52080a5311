"""The hand-written Hopper SHA-256 kernels (``csrc/sha256.cu``) and their
wrappers.

:func:`sha256_pieces_cuda` replaces
``torrent_tpu/ops/sha256_pallas.py::_sha256_kernel`` (its ``pallas_call`` at
sha256_pallas.py:275), with the contract of ``ops/sha256_torch.py``.
:func:`sha256_merkle_cuda` is the same source's merkle entry point: a whole
reduction of ``[B, 2^levels, 8]`` words to ``[B, 8]`` roots in one launch
(up to :data:`MERKLE_CAP` levels; taller trees take the launches of
:func:`merkle_passes`), in place of the XLA program the reference runs for
``models/merkle.py::_merkle_reduce_fused``. :func:`sha256_pairs_cuda`, one
merkle level, is its one-level case. Both kernels are integer-ALU bound on
an H100 (``ops/work.py``: ``SHA256_BLOCK_OPS`` integer instructions per
64-byte block, ``MERKLE_PAIR_OPS`` per merkle pair); the design notes are
at the top of ``csrc/sha256.cu``.

Build: CUDA C++ for ``sm_90a`` with a plain C interface, compiled by
``nvcc`` at first use into ``build/torrent_tpu_torch/`` and loaded with
``ctypes`` (``native/build.py``). A missing ``nvcc`` or a failed build
raises.

Dispatch: a CUDA tensor goes to the kernel and a CPU tensor to the plain
version. There is no path from a failed build or launch to the plain
version. Each wrapper counts its own launches in ``.launches``.

Variants: the rows kernel's block (:data:`KNOBS`) is a compile-time
parameter of the source. :func:`load_variant` builds the library with
another value into ``build/torrent_tpu_torch/variants/`` and returns its
own handle and rows launch (``tools/tune_sha256.py`` sweeps them); the
module's library, wrappers and counters never see a variant.
"""

from __future__ import annotations

import ctypes

import torch

from torrent_tpu_torch.native import build as native_build
from torrent_tpu_torch.native.build import BUILD_DIR, PACKAGE_DIR, Variant, build_cuda
from torrent_tpu_torch.ops.sha1_torch import check_batch
from torrent_tpu_torch.ops.sha256_torch import (
    check_merkle,
    check_pairs,
    sha256_merkle_torch,
    sha256_pairs_torch,
    sha256_pieces_torch,
)
from torrent_tpu_torch.utils.device import resolve_device
from torrent_tpu_torch.utils.locks import named_lock

SOURCE = PACKAGE_DIR / "csrc" / "sha256.cu"
LIBRARY = BUILD_DIR / "libtorrent_tpu_torch_sha256.so"

# The most pair levels one merkle launch reduces: a CTA of 8 warps takes
# 512 nodes (csrc/sha256.cu kMerkleCap, checked when the library loads).
MERKLE_CAP = 9

# The rows kernel's compile-time knob (csrc/sha256.cu): keyword → (macro,
# production value, short label of a variant's file name).
KNOBS = {"row_threads": ("TT_SHA256_ROW_THREADS", 32, "rows")}

_lib = None
_lib_lock = named_lock("ops.sha256_cuda._lib_lock")


def build(force: bool = False) -> str:
    """Compile ``csrc/sha256.cu`` if its library is missing or stale;
    returns nvcc's ptxas report, or ``""`` when the built library was
    current."""
    return build_cuda(SOURCE, LIBRARY, force)


def _bind(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.tt_sha256_launch.restype = ctypes.c_int
    lib.tt_sha256_launch.argtypes = [
        ctypes.c_void_p,  # data
        ctypes.c_int64,  # row_bytes
        ctypes.c_void_p,  # nblocks
        ctypes.c_void_p,  # out
        ctypes.c_int64,  # batch
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tt_sha256_merkle_launch.restype = ctypes.c_int
    lib.tt_sha256_merkle_launch.argtypes = [
        ctypes.c_void_p,  # words
        ctypes.c_void_p,  # out
        ctypes.c_int64,  # nodes
        ctypes.c_int,  # levels
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tt_sha256_merkle_cap.restype = ctypes.c_int
    lib.tt_sha256_merkle_cap.argtypes = []
    lib.tt_sha256_row_threads.restype = ctypes.c_int
    lib.tt_sha256_row_threads.argtypes = []
    cap = lib.tt_sha256_merkle_cap()
    if cap != MERKLE_CAP:
        raise RuntimeError(f"{path} reduces {cap} levels a launch, MERKLE_CAP is {MERKLE_CAP}")
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            _lib = _bind(LIBRARY)
    return _lib


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned for the kernel's vector loads")


def _launch_rows(load, data: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Check a CUDA batch and launch the rows kernel of ``load()``'s
    library on the current stream; an empty batch launches nothing."""
    row_bytes = check_batch(data, nblocks)
    _check_cuda(data, "data")
    if not nblocks.is_contiguous():
        raise ValueError("nblocks must be contiguous")
    lib = load()
    batch = data.shape[0]
    out = torch.empty((batch, 8), dtype=torch.int32, device=data.device)
    if batch == 0:
        return out
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.tt_sha256_launch(
            data.data_ptr(), row_bytes, nblocks.data_ptr(), out.data_ptr(), batch, stream
        )
    if rc != 0:
        raise RuntimeError(f"sha256 kernel launch failed: cudaError {rc}")
    return out


def sha256_pieces_cuda(data: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Batched SHA-256: ``(u8[B, P] | int32[B, P/4], int32[B]) → int32[B, 8]``.

    A CUDA batch launches the kernel on the current stream, without
    synchronising; a CPU batch runs the plain version. The result holds
    the uint32 state words' bits (``sha1_torch.words_to_numpy``).
    """
    if data.device.type == "cpu":
        return sha256_pieces_torch(data, nblocks)
    out = _launch_rows(_load, data, nblocks)
    if data.shape[0]:
        sha256_pieces_cuda.launches += 1
    return out


def merkle_passes(levels: int) -> tuple[int, ...]:
    """The launches of a reduction of ``levels`` pair levels: as few as
    :data:`MERKLE_CAP` allows, as even as they can be, tallest first (11
    levels are ``(6, 5)``, not ``(9, 2)``)."""
    if levels < 0:
        raise ValueError(f"levels must be >= 0, got {levels}")
    n = -(-levels // MERKLE_CAP)
    return tuple(levels // n + (i < levels % n) for i in range(n))


def _merkle_launch(lib, words: torch.Tensor, levels: int) -> torch.Tensor:
    """One launch: ``int32[N, 8]`` → ``int32[N >> levels, 8]`` roots."""
    out = torch.empty((words.shape[0] >> levels, 8), dtype=torch.int32, device=words.device)
    if out.shape[0] == 0:
        return out
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = lib.tt_sha256_merkle_launch(
            words.data_ptr(), out.data_ptr(), words.shape[0], levels, stream
        )
    if rc != 0:
        raise RuntimeError(f"sha256 merkle kernel launch failed: cudaError {rc}")
    return out


def sha256_merkle_cuda(words: torch.Tensor, levels: int) -> torch.Tensor:
    """Merkle roots: ``int32[N, 8]`` node words → ``int32[N / 2^levels, 8]``,
    each run of ``2^levels`` consecutive nodes reduced by ``levels`` pair
    levels.

    A CUDA tensor runs the launches of :func:`merkle_passes` on the
    current stream, without synchronising; a CPU tensor runs the plain
    version. ``levels == 0`` (or no node) returns ``words`` and launches
    nothing.
    """
    if words.device.type == "cpu":
        return sha256_merkle_torch(words, levels)
    check_merkle(words, levels)
    _check_cuda(words, "merkle words")
    if levels == 0 or words.shape[0] == 0:
        return words
    lib = _load()
    for h in merkle_passes(levels):
        words = _merkle_launch(lib, words, h)
        sha256_merkle_cuda.launches += 1
    return words


def sha256_pairs_cuda(words: torch.Tensor) -> torch.Tensor:
    """One merkle level: ``int32[M, 16]`` child-pair words → ``int32[M, 8]``.

    A CUDA level is one launch of the merkle kernel with ``levels = 1`` on
    the ``[2M, 8]`` node view, on the current stream; a CPU level runs the
    plain version.
    """
    if words.device.type == "cpu":
        return sha256_pairs_torch(words)
    check_pairs(words)
    _check_cuda(words, "pair words")
    if words.shape[0] == 0:
        return torch.empty((0, 8), dtype=torch.int32, device=words.device)
    out = _merkle_launch(_load(), words.view(-1, 8), 1)
    sha256_pairs_cuda.launches += 1
    return out


# kernel launches since the counters were last reset (chip_smoke.py resets
# them around the main path to show the path went through the kernels)
sha256_pieces_cuda.launches = 0
sha256_pairs_cuda.launches = 0
sha256_merkle_cuda.launches = 0


def make_sha256_fn(device=None):
    """The batched SHA-256 for ``device`` (None means the GPU).

    Mirrors the reference's ``make_sha256_fn(backend)``: on a GPU the
    kernel is built here, so a missing toolchain fails at construction,
    not at the first batch.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        _load()
    return sha256_pieces_cuda


# ------------------------------------------------------------- variants


def check_knobs(**knobs) -> dict:
    """The full knob set (production values where not given), or
    ValueError for a set that csrc/sha256.cu's static_assert would refuse:
    an unknown knob, or a block that is not whole warps from 32 to 1024
    threads. Nothing is compiled."""
    full = native_build.full_knobs("sha256", KNOBS, knobs)
    t = full["row_threads"]
    if t % 32 or not 32 <= t <= 1024:
        raise ValueError(f"row_threads {t} is not a whole number of warps from 32 to 1024")
    return full


def _probe(lib, knobs: dict) -> str | None:
    threads = lib.tt_sha256_row_threads()
    return None if threads == knobs["row_threads"] else f"{threads} row threads"


def load_variant(force: bool = False, **knobs) -> Variant:
    """Build (if missing or stale, or ``force``) and load the library with
    ``knobs`` (see :func:`check_knobs`). The variant has its own library
    under ``build/torrent_tpu_torch/variants/``, its own ctypes handle and
    its own rows launch (same contract as :func:`sha256_pieces_cuda` on a
    CUDA batch); it never replaces the module's library and never counts
    in the module's launch counters. A failed build raises."""
    return native_build.load_variant(
        SOURCE, LIBRARY.stem, KNOBS, check_knobs(**knobs),
        bind=_bind, launch=_launch_rows, probe=_probe, force=force,
    )
