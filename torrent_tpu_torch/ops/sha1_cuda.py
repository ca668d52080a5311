"""The hand-written Hopper SHA-1 kernel (``csrc/sha1.cu``) and its wrapper.

Replaces ``torrent_tpu/ops/sha1_pallas.py::_sha1_kernel`` (its
``pallas_call`` at sha1_pallas.py:243), with the contract of
``ops/sha1_torch.py``. The work is integer arithmetic
(``ops/work.py``'s ``SHA1_BLOCK_OPS`` integer instructions per 64-byte
block), but up to
132 x 32 = 4,224 rows (the recheck's 4096, authoring's 256) there is at
most one warp of pieces per SM, so a launch takes as long as one piece's
serial chain of rounds; only beyond that does the card's integer rate
bound it. The kernel is warp-specialised for that: per CTA of 32 pieces,
one warp runs only the rounds, fed through a shared-memory ring by two
warps that load the blocks (16-byte ``cp.async``) and compute the
message schedule. The design notes are at the top of ``csrc/sha1.cu``.

Build: CUDA C++ for ``sm_90a`` with a plain C interface, compiled by
``nvcc`` at first use into ``build/torrent_tpu_torch/`` and loaded with
``ctypes``. A missing ``nvcc`` or a failed build raises.

Dispatch: :func:`sha1_pieces_cuda` takes a CUDA tensor to the kernel and
a CPU tensor to the plain version. There is no path from a failed build
or launch to the plain version.

Variants: the launch design's knobs (:data:`KNOBS`) are compile-time
parameters of the source. :func:`load_variant` builds the kernel with
other values into ``build/torrent_tpu_torch/variants/`` and returns its
own handle and launch (``tools/tune_sha1.py`` sweeps them); the module's
library, :func:`sha1_pieces_cuda` and its counter never see a variant.
"""

from __future__ import annotations

import ctypes

import torch

from torrent_tpu_torch.native import build as native_build
from torrent_tpu_torch.native.build import BUILD_DIR, PACKAGE_DIR, Variant, build_cuda
from torrent_tpu_torch.ops.sha1_torch import check_batch, sha1_pieces_torch
from torrent_tpu_torch.utils.device import resolve_device
from torrent_tpu_torch.utils.locks import named_lock

SOURCE = PACKAGE_DIR / "csrc" / "sha1.cu"
LIBRARY = BUILD_DIR / "libtorrent_tpu_torch_sha1.so"

# The launch design's compile-time knobs (csrc/sha1.cu): keyword → (macro,
# production value, short label of a variant's file name).
KNOBS = {
    "wk_stages": ("TT_SHA1_WK_STAGES", 4, "wk"),
    "raw_stages": ("TT_SHA1_RAW_STAGES", 3, "raw"),
    "schedule_warps": ("TT_SHA1_SCHEDULE_WARPS", 2, "sched"),
}
# Hopper's shared memory per block (csrc/sha1.cu's static_assert).
SMEM_LIMIT = 232448

_lib = None
_lib_lock = named_lock("ops.sha1_cuda._lib_lock")


def build(force: bool = False) -> str:
    """Compile ``csrc/sha1.cu`` if its library is missing or stale; returns
    nvcc's ptxas report, or ``""`` when the built library was current."""
    return build_cuda(SOURCE, LIBRARY, force)


def _bind(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.tt_sha1_launch.restype = ctypes.c_int
    lib.tt_sha1_launch.argtypes = [
        ctypes.c_void_p,  # data
        ctypes.c_int64,  # row_bytes
        ctypes.c_void_p,  # nblocks
        ctypes.c_void_p,  # out
        ctypes.c_int64,  # batch
        ctypes.c_void_p,  # cudaStream_t
    ]
    for fn in (lib.tt_sha1_smem_bytes, lib.tt_sha1_ctas_per_sm):
        fn.restype = ctypes.c_int
        fn.argtypes = []
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            _lib = _bind(LIBRARY)
    return _lib


def smem_bytes() -> int:
    """Dynamic shared memory of one CTA of the kernel, in bytes (ptxas'
    report counts only static shared memory). Builds the kernel."""
    return _load().tt_sha1_smem_bytes()


def ctas_per_sm() -> int:
    """CTAs of the kernel (32 pieces each) that one SM of the current GPU
    holds at once. Builds the kernel; raises if CUDA cannot answer."""
    n = _load().tt_sha1_ctas_per_sm()
    if n < 0:
        raise RuntimeError(f"sha1 kernel occupancy query failed: cudaError {-n}")
    return n


def _launch(load, data: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Check a CUDA batch and launch the kernel of ``load()``'s library on
    the current stream; an empty batch launches nothing."""
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    row_bytes = check_batch(data, nblocks)
    if not data.is_contiguous() or not nblocks.is_contiguous():
        raise ValueError("data and nblocks must be contiguous")
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned for the kernel's vector loads")
    lib = load()
    batch = data.shape[0]
    out = torch.empty((batch, 5), dtype=torch.int32, device=data.device)
    if batch == 0:
        return out
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.tt_sha1_launch(
            data.data_ptr(), row_bytes, nblocks.data_ptr(), out.data_ptr(), batch, stream
        )
    if rc != 0:
        raise RuntimeError(f"sha1 kernel launch (or its shared-memory set-up) failed: cudaError {rc}")
    return out


def sha1_pieces_cuda(data: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Batched SHA-1: ``(u8[B, P] | int32[B, P/4], int32[B]) → int32[B, 5]``.

    A CUDA batch launches the kernel on the current stream, without
    synchronising; a CPU batch runs the plain version. The result holds
    the uint32 state words' bits (``sha1_torch.words_to_numpy``).
    """
    if data.device.type == "cpu":
        return sha1_pieces_torch(data, nblocks)
    out = _launch(_load, data, nblocks)
    if data.shape[0]:
        sha1_pieces_cuda.launches += 1
    return out


# kernel launches since the counter was last reset (chip_smoke.py resets
# it around the main path to show the path went through the kernel)
sha1_pieces_cuda.launches = 0


def make_sha1_fn(device=None):
    """The batched SHA-1 for ``device`` (None means the GPU).

    Mirrors the reference's ``make_sha1_fn(backend)``: on a GPU the
    kernel is built here, so a missing toolchain fails at construction,
    not at the first batch.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        _load()
    return sha1_pieces_cuda


# ------------------------------------------------------------- variants


def variant_smem_bytes(wk_stages: int, raw_stages: int, schedule_warps: int) -> int:
    """Dynamic shared memory of one CTA of a variant, as csrc/sha1.cu
    computes ``kSmemBytes``: the W+K ring (80 words of 32 pieces a
    stage), each schedule warp's raw ring (64 bytes of 32 pieces a stage),
    two mbarriers a W+K stage and 32 block counts."""
    return wk_stages * 20 * 32 * 16 + schedule_warps * raw_stages * 32 * 64 + 2 * wk_stages * 8 + 32 * 4


def check_knobs(**knobs) -> dict:
    """The full knob set (production values where not given), or
    ValueError for a set that csrc/sha1.cu's static_asserts would refuse:
    an unknown knob, a ring without a stage, a W+K stage with two
    producers (``wk_stages % schedule_warps``), or shared memory over
    Hopper's 232,448 bytes a block. Nothing is compiled."""
    full = native_build.full_knobs("sha1", KNOBS, knobs)
    if min(full.values()) < 1:
        raise ValueError(f"sha1 knobs must be >= 1: {full}")
    if full["wk_stages"] % full["schedule_warps"]:
        raise ValueError(
            f"wk_stages {full['wk_stages']} is not a multiple of schedule_warps "
            f"{full['schedule_warps']}: a W+K stage would have two producers"
        )
    smem = variant_smem_bytes(**full)
    if smem > SMEM_LIMIT:
        raise ValueError(f"sha1 knobs {full} need {smem} bytes of shared memory, over {SMEM_LIMIT}")
    return full


def _probe(lib, knobs: dict) -> str | None:
    smem = lib.tt_sha1_smem_bytes()
    return None if smem == variant_smem_bytes(**knobs) else f"{smem} bytes of shared memory"


def load_variant(force: bool = False, **knobs) -> Variant:
    """Build (if missing or stale, or ``force``) and load the kernel with
    ``knobs`` (see :func:`check_knobs`; the rest keep their production
    values). The variant has its own library under
    ``build/torrent_tpu_torch/variants/``, its own ctypes handle and its
    own launch (same contract as :func:`sha1_pieces_cuda` on a CUDA
    batch); it never replaces the module's library and never counts in
    ``sha1_pieces_cuda.launches``. A failed build raises."""
    return native_build.load_variant(
        SOURCE, LIBRARY.stem, KNOBS, check_knobs(**knobs),
        bind=_bind, launch=_launch, probe=_probe, force=force,
    )
