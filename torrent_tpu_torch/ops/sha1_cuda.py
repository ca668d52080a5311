"""The hand-written Hopper SHA-1 kernel (``csrc/sha1.cu``) and its wrapper.

Replaces ``torrent_tpu/ops/sha1_pallas.py::_sha1_kernel`` (its
``pallas_call`` at sha1_pallas.py:243), with the contract of
``ops/sha1_torch.py``. The work is integer arithmetic
(``OPS_PER_BLOCK`` integer instructions per 64-byte block), but up to
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
"""

from __future__ import annotations

import ctypes

import torch

from torrent_tpu_torch.native.build import BUILD_DIR, PACKAGE_DIR, build_cuda
from torrent_tpu_torch.ops.sha1_torch import check_batch, sha1_pieces_torch
from torrent_tpu_torch.utils.device import resolve_device
from torrent_tpu_torch.utils.locks import named_lock

SOURCE = PACKAGE_DIR / "csrc" / "sha1.cu"
LIBRARY = BUILD_DIR / "libtorrent_tpu_torch_sha1.so"

# Integer instructions one 64-byte block needs at the least, counted as
# Hopper issues them: 16 byteswaps (PRMT); 64 schedule words of two LOP3
# (a 4-way XOR) and one rotate (SHF); 80 rounds of one rotate for a, one
# LOP3 for ch/parity/maj, two IADD3 for the five-term sum and one rotate
# for b; 5 feed-forward adds. 16 + 192 + 400 + 5.
OPS_PER_BLOCK = 16 + 64 * 3 + 80 * 5 + 5
# H100 SXM peak INT32 rate: 64 INT32 lanes per SM (Hopper white paper)
# x 132 SMs x 1.98 GHz boost clock, at the full 700 W power limit.
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# H100 SXM HBM3 rate (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12

_lib = None
_lib_lock = named_lock("ops.sha1_cuda._lib_lock")


def build(force: bool = False) -> str:
    """Compile ``csrc/sha1.cu`` if its library is missing or stale; returns
    nvcc's ptxas report, or ``""`` when the built library was current."""
    return build_cuda(SOURCE, LIBRARY, force)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIBRARY))
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
            _lib = lib
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


def sha1_pieces_cuda(data: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Batched SHA-1: ``(u8[B, P] | int32[B, P/4], int32[B]) → int32[B, 5]``.

    A CUDA batch launches the kernel on the current stream, without
    synchronising; a CPU batch runs the plain version. The result holds
    the uint32 state words' bits (``sha1_torch.words_to_numpy``).
    """
    if data.device.type == "cpu":
        return sha1_pieces_torch(data, nblocks)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    row_bytes = check_batch(data, nblocks)
    if not data.is_contiguous() or not nblocks.is_contiguous():
        raise ValueError("data and nblocks must be contiguous")
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned for the kernel's vector loads")
    lib = _load()
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
