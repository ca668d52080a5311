"""Build the package's shared libraries at first use.

Every library goes into ``build/torrent_tpu_torch/`` at the root of the
checkout (listed in ``.gitignore``), never next to its source. A library
is rebuilt when its source is newer, and is written under a temporary
name and renamed into place, so processes that build at the same time
never load a half-written file.

Two libraries are built here:

- the host pread pool (``io_engine.cpp``, g++). A missing toolchain
  means ``load()`` returns None and ``Storage.read_batch`` takes its
  pure-Python read path: this is host IO, and both paths give the same
  bytes;
- the CUDA kernels (``csrc/sha1.cu`` and ``csrc/sha256.cu``, built by
  ``ops/sha1_cuda.py`` and ``ops/sha256_cuda.py`` through
  :func:`build_cuda`). There a missing ``nvcc`` or a failed build
  raises: no device path falls back.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import tempfile

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torrent_tpu_torch"

# CUDA C++ for Hopper with a plain C interface; -Xptxas -v reports each
# kernel's registers, spills and shared memory
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_SRC = pathlib.Path(__file__).with_name("io_engine.cpp")
_LIB = BUILD_DIR / "libtorrent_tpu_torch_io.so"


def is_stale(src: pathlib.Path, lib: pathlib.Path) -> bool:
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def compile_library(
    cmd_for, lib: pathlib.Path, timeout: float
) -> subprocess.CompletedProcess:
    """Run ``cmd_for(tmp_path)`` and atomically move its output to ``lib``.

    Returns the finished process (its ``stderr`` holds the compiler's
    report); raises ``subprocess.CalledProcessError`` when the compiler
    fails and ``OSError`` when it cannot be started.
    """
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=lib.name + ".", suffix=".tmp", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            cmd_for(tmp), check=True, capture_output=True, text=True, timeout=timeout
        )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc


def nvcc_path(source: pathlib.Path) -> str:
    """The CUDA compiler: ``PATH``, then ``$CUDA_HOME``/``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the kernel "
        f"is built from {source} at first use"
    )


def build_cuda(source: pathlib.Path, lib: pathlib.Path, force: bool = False) -> str:
    """Compile a kernel source with nvcc if its library is missing or stale.

    Returns nvcc's report (``-Xptxas -v``: registers, spills, shared
    memory per kernel), or ``""`` when the built library was current.
    Raises RuntimeError when nvcc is missing or fails.
    """
    if not force and not is_stale(source, lib):
        return ""
    nvcc = nvcc_path(source)
    try:
        proc = compile_library(
            lambda out: [nvcc, *NVCC_FLAGS, str(source), "-o", out], lib, timeout=600
        )
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed on {source}:\n{e.stdout}{e.stderr}") from e
    return proc.stdout + proc.stderr


def build(force: bool = False) -> pathlib.Path | None:
    """Compile the pread pool if needed; returns the .so path or None."""
    if not force and not is_stale(_SRC, _LIB):
        return _LIB
    cxx = os.environ.get("CXX", "g++")
    try:
        compile_library(
            lambda out: [cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
                         str(_SRC), "-o", out],
            _LIB,
            timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return _LIB


def load():
    """ctypes handle to the built pread pool, or None if unavailable."""
    import ctypes

    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        # Stale/foreign binary (other arch, older glibc): rebuild from
        # source once before giving up on the native engine.
        path = build(force=True)
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
    lib.tt_io_create.restype = ctypes.c_void_p
    lib.tt_io_create.argtypes = [ctypes.c_int]
    lib.tt_io_destroy.restype = None
    lib.tt_io_destroy.argtypes = [ctypes.c_void_p]
    lib.tt_io_read_batch.restype = ctypes.c_int
    lib.tt_io_read_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


if __name__ == "__main__":
    out = build(force=True)
    print(f"built: {out}" if out else "build failed")
