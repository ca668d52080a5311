"""Build the package's shared libraries at first use.

Every library goes into ``build/torrent_tpu_torch/`` at the root of the
checkout (listed in ``.gitignore``), never next to its source. A library
is rebuilt when its source is newer, and is written under a temporary
name and renamed into place, so processes that build at the same time
never load a half-written file.

Two libraries are built here:

- the host engine (``io_engine.cpp``, g++): the pread pool and the RC4
  cipher of the peer wire's MSE/PE handshake. A missing toolchain means
  ``load()`` returns None, ``Storage.read_batch`` takes its pure-Python
  read path and ``net/mse.py`` its pure-Python RC4: this is host code,
  and both paths give the same bytes;
- the CUDA kernels (``csrc/sha1.cu`` and ``csrc/sha256.cu``, built by
  ``ops/sha1_cuda.py`` and ``ops/sha256_cuda.py`` through
  :func:`build_cuda`). There a missing ``nvcc`` or a failed build
  raises: no device path falls back. Variants of a kernel, built with
  other compile-time knobs for the tuners (``load_variant``), go into
  ``build/torrent_tpu_torch/variants/`` under names that spell their
  knobs and a digest of the source and flags, beside and never over the
  production libraries.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import time
from typing import Callable

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torrent_tpu_torch"

# CUDA C++ for Hopper with a plain C interface; -Xptxas -v reports each
# kernel's registers, spills and shared memory
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

VARIANT_DIR = BUILD_DIR / "variants"

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


def build_cuda(
    source: pathlib.Path, lib: pathlib.Path, force: bool = False, defines=None
) -> str:
    """Compile a kernel source with nvcc if its library is missing or stale.

    ``defines`` (``{"NAME": value}``) become ``-DNAME=value`` flags: the
    compile-time knobs a variant library is built with. Returns nvcc's
    report (``-Xptxas -v``: registers, spills, shared memory per kernel),
    or ``""`` when the built library was current. Raises RuntimeError when
    nvcc is missing or fails.
    """
    if not force and not is_stale(source, lib):
        return ""
    nvcc = nvcc_path(source)
    flags = define_flags(defines)
    try:
        proc = compile_library(
            lambda out: [nvcc, *NVCC_FLAGS, *flags, str(source), "-o", out], lib, timeout=600
        )
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed on {source}:\n{e.stdout}{e.stderr}") from e
    return proc.stdout + proc.stderr


def define_flags(defines: dict | None) -> list[str]:
    """``{"NAME": value}`` → nvcc's ``["-DNAME=value", ...]``."""
    return [f"-D{name}={value}" for name, value in (defines or {}).items()]


# ------------------------------------------------------------- variants
#
# A kernel's knob table (``ops/*_cuda.py::KNOBS``) maps a keyword to
# (macro, production value, short label of a variant's file name).


def full_knobs(kernel: str, table: dict, knobs: dict) -> dict:
    """``knobs`` over the production values of ``table``, as ints, in the
    table's order; ValueError on a keyword the table lacks."""
    unknown = set(knobs) - set(table)
    if unknown:
        raise ValueError(f"unknown {kernel} knob(s) {sorted(unknown)}: expected {sorted(table)}")
    return {name: int(knobs.get(name, default)) for name, (_, default, _) in table.items()}


def knob_defines(table: dict, knobs: dict) -> dict:
    """``{macro: value}`` of a full knob set: what :func:`define_flags` spells."""
    return {table[name][0]: value for name, value in knobs.items()}


def knob_tag(table: dict, knobs: dict) -> str:
    """A full knob set spelt for a file name: ``wk4_raw3_sched2``."""
    return "_".join(f"{table[name][2]}{value}" for name, value in knobs.items())


@dataclasses.dataclass
class Variant:
    """A kernel library built with other compile-time knobs than the
    production one (``ops/*_cuda.py::load_variant``): its own file, its
    own ctypes handle and its own launch, which no launch counter sees."""

    knobs: dict
    library: pathlib.Path
    lib: object  # the ctypes handle
    launch: Callable  # (data, nblocks) -> words on the device, not synchronised
    report: str  # nvcc's -Xptxas -v report ("" when the library was current)
    build_s: float


def variant_path(source: pathlib.Path, stem: str, tag: str, defines: dict) -> pathlib.Path:
    """``VARIANT_DIR/<stem>_<tag>_<digest>.so``: the digest covers the
    source's bytes and every nvcc flag, so one name never stands for two
    builds. A process that loaded a variant and builds it again, forced or
    after the source changed, maps what it built: ``dlopen`` hands back an
    earlier mapping only for a name, and so a build, it already holds."""
    h = hashlib.sha256(source.read_bytes())
    h.update("\0".join([*NVCC_FLAGS, *define_flags(defines)]).encode())
    return VARIANT_DIR / f"{stem}_{tag}_{h.hexdigest()[:12]}.so"


def build_variant(
    source: pathlib.Path, stem: str, tag: str, defines: dict, force: bool = False
) -> tuple[pathlib.Path, str, float]:
    """Build ``source`` with ``defines`` into :func:`variant_path` if that
    library is missing or stale (or ``force``); returns its path, nvcc's
    report and the seconds the build took."""
    lib = variant_path(source, stem, tag, defines)
    t = time.perf_counter()
    report = build_cuda(source, lib, force=force, defines=defines)
    return lib, report, time.perf_counter() - t


def load_variant(
    source: pathlib.Path, stem: str, table: dict, knobs: dict, *,
    bind: Callable, launch: Callable, probe: Callable, force: bool = False,
) -> Variant:
    """Build (if missing or stale, or ``force``) and bind ``source`` with
    the full, checked knob set ``knobs``. ``bind(path)`` gives the ctypes
    handle; ``probe(lib, knobs)`` names what the library reports that
    ``knobs`` would not give (None when it agrees), and a disagreement
    raises; ``launch(load, data, nblocks)`` is the module's checked launch,
    here on the variant's own handle. A failed build raises."""
    defines = knob_defines(table, knobs)
    path, report, build_s = build_variant(source, stem, knob_tag(table, knobs), defines, force)
    lib = bind(path)
    wrong = probe(lib, knobs)
    if wrong:
        raise RuntimeError(f"{path} was not built with {knobs}: {wrong}")
    return Variant(knobs, path, lib, lambda data, nblocks: launch(lambda: lib, data, nblocks), report, build_s)


def ptxas_resources(report: str, kernel: str) -> dict:
    """What ``-Xptxas -v`` reported for the entry function whose mangled
    name holds ``kernel``: ``registers``, static ``smem_bytes`` and spill
    store and load bytes (None where the report has no such line)."""
    out = {"registers": None, "smem_bytes": None, "spill_stores": None, "spill_loads": None}
    current = None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            current = m.group(1)
            continue
        if current is None or kernel not in current:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out["spill_stores"], out["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out["smem_bytes"] = int(m.group(1)) if m else 0
    return out


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
    """ctypes handle to the built host engine, or None if unavailable."""
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
    lib.tt_rc4_init.restype = None
    lib.tt_rc4_init.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int32,
    ]
    lib.tt_rc4_crypt.restype = None
    # buf is mutated in place (keystream xor), hence void* not char*
    lib.tt_rc4_crypt.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int64,
    ]
    return lib


if __name__ == "__main__":
    out = build(force=True)
    print(f"built: {out}" if out else "build failed")
