"""The kernel tuners (``tools/tune_sha1.py``, ``tools/tune_sha256.py``) and
the kernels' compile-time knobs (``ops/*_cuda.py::load_variant``), on the
CPU.

Nothing here compiles: this host has no ``nvcc``. The cases hold what
the CPU can reach: grid parsing, the ``-D`` flags and variant file names,
the rejection of knob sets the sources' static_asserts would refuse
before ``nvcc`` runs, the ``-D`` flags reaching the compiler's command
line, the padding the tuners put on the card against ``ops/padding.py``,
ptxas report parsing, and ``DeviceUnavailable`` without CUDA (the tuners
have no CPU mode). The variants' digests against hashlib and their times
are ``gpu`` tests (``tests/test_torch_gpu.py``) and ``chip_smoke.py``'s
phase 14.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from torrent_tpu_torch.native import build as native_build
from torrent_tpu_torch.ops import sha1_cuda, sha256_cuda
from torrent_tpu_torch.ops.padding import pad_pieces
from torrent_tpu_torch.tools import tune_sha1, tune_sha256
from torrent_tpu_torch.utils.device import DeviceUnavailable

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def no_nvcc(monkeypatch):
    """Fail the test if anything tries to compile."""

    def refuse(*a, **k):
        raise AssertionError("nvcc was called")

    monkeypatch.setattr(native_build, "build_cuda", refuse)
    monkeypatch.setattr(native_build, "compile_library", refuse)


def _source_default(path: str, macro: str) -> int:
    text = (REPO / "torrent_tpu_torch" / "csrc" / path).read_text()
    return int(re.search(rf"#ifndef {macro}\n#define {macro} (\d+)\n#endif", text).group(1))


class TestKnobs:
    def test_production_values_are_the_sources_defaults(self):
        for mod, src in ((sha1_cuda, "sha1.cu"), (sha256_cuda, "sha256.cu")):
            for name, (macro, default, _) in mod.KNOBS.items():
                assert _source_default(src, macro) == default, (src, macro)
        assert sha1_cuda.check_knobs() == {"wk_stages": 4, "raw_stages": 3, "schedule_warps": 2}
        assert sha256_cuda.check_knobs() == {"row_threads": 32}

    def test_sha1_default_shared_memory_is_the_kernels(self):
        """53,440 bytes a CTA at the production knobs (csrc/sha1.cu's
        header: 4 x 10 KiB + 2 x 3 x 2 KiB + 8 mbarriers + 32 counts)."""
        assert sha1_cuda.variant_smem_bytes(**sha1_cuda.check_knobs()) == 53440
        assert sha1_cuda.variant_smem_bytes(8, 3, 2) == 53440 + 4 * 10240 + 4 * 16

    @pytest.mark.parametrize(
        "knobs,reason",
        [
            ({"wk_stages": 3}, "two producers"),
            ({"wk_stages": 4, "schedule_warps": 3}, "two producers"),
            ({"raw_stages": 0}, ">= 1"),
            ({"schedule_warps": 0}, ">= 1"),
            ({"wk_stages": 22}, "shared memory"),
            ({"wk_stages": 4, "raw_stages": 200, "schedule_warps": 4}, "shared memory"),
            ({"stages": 4}, "unknown"),
        ],
    )
    def test_sha1_refused_before_nvcc(self, knobs, reason, no_nvcc):
        with pytest.raises(ValueError, match=reason):
            sha1_cuda.load_variant(**knobs)

    @pytest.mark.parametrize("threads", [0, 16, 48, 1056, 2048])
    def test_sha256_refused_before_nvcc(self, threads, no_nvcc):
        with pytest.raises(ValueError, match="whole number of warps"):
            sha256_cuda.load_variant(row_threads=threads)

    def test_sha1_largest_ring_that_fits(self):
        """At the default raw rings and schedule warps the W+K ring can
        grow to 20 stages (217,536 bytes); 22 pass Hopper's 232,448."""
        fits = sha1_cuda.check_knobs(wk_stages=20)
        assert sha1_cuda.variant_smem_bytes(**fits) <= sha1_cuda.SMEM_LIMIT
        assert sha1_cuda.variant_smem_bytes(22, 3, 2) > sha1_cuda.SMEM_LIMIT

    def test_defines_tags_and_library_names(self):
        k = sha1_cuda.check_knobs(wk_stages=8, raw_stages=4, schedule_warps=4)
        assert native_build.knob_defines(sha1_cuda.KNOBS, k) == {
            "TT_SHA1_WK_STAGES": 8, "TT_SHA1_RAW_STAGES": 4, "TT_SHA1_SCHEDULE_WARPS": 4,
        }
        assert native_build.knob_tag(sha1_cuda.KNOBS, k) == "wk8_raw4_sched4"
        assert native_build.define_flags(native_build.knob_defines(sha1_cuda.KNOBS, k)) == [
            "-DTT_SHA1_WK_STAGES=8", "-DTT_SHA1_RAW_STAGES=4", "-DTT_SHA1_SCHEDULE_WARPS=4",
        ]
        k = sha256_cuda.check_knobs(row_threads=128)
        assert native_build.knob_tag(sha256_cuda.KNOBS, k) == "rows128"
        assert native_build.define_flags(native_build.knob_defines(sha256_cuda.KNOBS, k)) == [
            "-DTT_SHA256_ROW_THREADS=128"
        ]

    def test_variant_names_cover_source_and_flags(self, tmp_path):
        """A variant's file name holds its tag and a digest of the source
        and the nvcc flags: the same build keeps its name, and another
        source or other flags get another, so a process never maps an
        earlier build under the name of a new one."""
        src = tmp_path / "k.cu"
        src.write_text("// one\n")
        name = native_build.variant_path(src, "libk", "rows64", {"TT_ROWS": 64})
        assert name == native_build.variant_path(src, "libk", "rows64", {"TT_ROWS": 64})
        assert name.parent == native_build.VARIANT_DIR
        assert re.fullmatch(r"libk_rows64_[0-9a-f]{12}\.so", name.name)
        assert name != native_build.variant_path(src, "libk", "rows64", {"TT_ROWS": 32})
        src.write_text("// two\n")
        assert name != native_build.variant_path(src, "libk", "rows64", {"TT_ROWS": 64})

    def test_load_variant_rejects_a_library_built_otherwise(self, monkeypatch):
        """A library that does not report the knobs it was asked for
        (``probe``) fails the load: it is never launched."""
        monkeypatch.setattr(native_build, "build_cuda", lambda *a, **k: "")

        class Lib:
            def tt_sha256_row_threads(self):
                return 32

        with pytest.raises(RuntimeError, match="not built with .* 32 row threads"):
            native_build.load_variant(
                sha256_cuda.SOURCE, sha256_cuda.LIBRARY.stem, sha256_cuda.KNOBS,
                sha256_cuda.check_knobs(row_threads=64), bind=lambda path: Lib(),
                launch=sha256_cuda._launch_rows, probe=sha256_cuda._probe,
            )

    def test_build_variant_passes_the_defines_and_keeps_production(self, monkeypatch):
        """A variant's nvcc command carries its -D flags and writes into
        ``variants/`` under its tag, never over the production library."""
        seen = []

        def fake_compile(cmd_for, lib, timeout):
            seen.append((cmd_for(str(lib) + ".tmp"), lib))

            class Done:
                stdout, stderr = "", "ptxas info : Used 40 registers"

            return Done()

        monkeypatch.setattr(native_build, "nvcc_path", lambda source: "nvcc")
        monkeypatch.setattr(native_build, "compile_library", fake_compile)
        k = sha1_cuda.check_knobs(wk_stages=2, raw_stages=2)
        defines = native_build.knob_defines(sha1_cuda.KNOBS, k)
        lib, report, secs = native_build.build_variant(
            sha1_cuda.SOURCE, sha1_cuda.LIBRARY.stem, native_build.knob_tag(sha1_cuda.KNOBS, k),
            defines, force=True,
        )
        (cmd, target), = seen
        assert target == lib == native_build.variant_path(
            sha1_cuda.SOURCE, sha1_cuda.LIBRARY.stem, "wk2_raw2_sched2", defines
        )
        assert lib.name.startswith("libtorrent_tpu_torch_sha1_wk2_raw2_sched2_")
        assert lib != sha1_cuda.LIBRARY and lib.parent.parent == sha1_cuda.LIBRARY.parent
        for flag in ("-DTT_SHA1_WK_STAGES=2", "-DTT_SHA1_RAW_STAGES=2", "-DTT_SHA1_SCHEDULE_WARPS=2"):
            assert flag in cmd
        assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
        assert "registers" in report and secs >= 0
        # the production build carries no -D flag
        seen.clear()
        native_build.build_cuda(sha1_cuda.SOURCE, sha1_cuda.LIBRARY, force=True)
        assert not any(a.startswith("-D") for a in seen[0][0])


class TestGrids:
    def test_sha1_grid(self):
        grid = tune_sha1.parse_grid("4.3.2, 2.2.2,8.3.2,4.3.2")
        assert grid == [
            {"wk_stages": 4, "raw_stages": 3, "schedule_warps": 2},
            {"wk_stages": 2, "raw_stages": 2, "schedule_warps": 2},
            {"wk_stages": 8, "raw_stages": 3, "schedule_warps": 2},
        ]
        for entry in tune_sha1.DEFAULT_GRID.split(","):
            tune_sha1.parse_grid(entry)

    @pytest.mark.parametrize("spec", ["4.3", "4x16", "4.3.2.1", "a.b.c", "", "3.3.2"])
    def test_sha1_bad_grid(self, spec, no_nvcc):
        with pytest.raises(ValueError):
            tune_sha1.parse_grid(spec)

    def test_sha256_grid(self):
        assert tune_sha256.parse_grid("32,64,128,64") == [
            {"row_threads": 32}, {"row_threads": 64}, {"row_threads": 128},
        ]
        tune_sha256.parse_grid(tune_sha256.DEFAULT_GRID)

    @pytest.mark.parametrize("spec", ["32,48", "x", "", "-32", "8x16"])
    def test_sha256_bad_grid(self, spec, no_nvcc):
        with pytest.raises(ValueError):
            tune_sha256.parse_grid(spec)

    @pytest.mark.parametrize(
        "main,argv",
        [(tune_sha1.main, ["--grid", "4.3.2,3.3.2"]), (tune_sha256.main, ["--grid", "32,100"])],
    )
    def test_bad_grid_is_a_usage_error_before_the_device(self, main, argv, capsys, no_nvcc):
        assert main(argv) == 2
        err = capsys.readouterr().err
        assert err.startswith("error: ") and len(err.strip().splitlines()) == 1


class TestNoCpuMode:
    @pytest.mark.parametrize(
        "call",
        [
            lambda: tune_sha1.main(["--grid", "4.3.2"]),
            lambda: tune_sha256.main(["--grid", "32"]),
            lambda: tune_sha1.run_sweep(4, 64, tune_sha1.parse_grid("2.2.2"), 1),
            lambda: tune_sha256.run_sweep(16, 64, tune_sha256.parse_grid("64"), 1),
        ],
    )
    def test_without_cuda_the_tuners_raise(self, call, no_nvcc):
        """No CPU mode, and nothing built first: the device is resolved
        before any variant."""
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA card")
        with pytest.raises(DeviceUnavailable):
            call()

    def test_variant_launch_refuses_a_cpu_tensor(self):
        """A variant's launch takes CUDA batches only: it never runs the
        plain version."""
        data, nb = torch.zeros((1, 128), dtype=torch.uint8), torch.ones(1, dtype=torch.int32)
        with pytest.raises(ValueError, match="unsupported device"):
            sha1_cuda._launch(lambda: None, data, nb)
        with pytest.raises(ValueError, match="unsupported device"):
            sha256_cuda._launch_rows(lambda: None, data, nb)

    def test_wrappers_count_no_cpu_launch(self):
        before = (sha1_cuda.sha1_pieces_cuda.launches, sha256_cuda.sha256_pieces_cuda.launches)
        padded, nb = pad_pieces([b"abc", b""])
        data = torch.from_numpy(padded)
        sha1_cuda.sha1_pieces_cuda(data, torch.from_numpy(nb))
        sha256_cuda.sha256_pieces_cuda(data, torch.from_numpy(nb))
        assert (sha1_cuda.sha1_pieces_cuda.launches, sha256_cuda.sha256_pieces_cuda.launches) == before


class TestHelpers:
    @pytest.mark.parametrize("msg", [64, 128, 16384, 65536, 256 * 1024])
    def test_pad_words_match_ops_padding(self, msg):
        """The tail the tuners write on the card after a random message
        equals ops/padding.py's padding of a message of that length."""
        rng = np.random.default_rng(msg)
        body = rng.bytes(msg)
        padded, nblocks = pad_pieces([body])
        tail, nblk = tune_sha1.pad_words(msg)
        assert nblk == int(nblocks[0])
        assert padded.shape[1] == msg + tail.size * 4
        assert padded[0, msg:].tobytes() == tail.tobytes()

    def test_pad_words_refuses_ragged_messages(self):
        with pytest.raises(ValueError):
            tune_sha1.pad_words(100)

    def test_hashlib_words(self):
        import hashlib

        rows = torch.from_numpy(np.random.default_rng(3).integers(-(2**31), 2**31, (4, 48), dtype=np.int32))
        got = tune_sha1.hashlib_words(rows, 128, hashlib.sha256)
        want = [hashlib.sha256(r.numpy().tobytes()[:128]).digest() for r in rows]
        assert [np.asarray(g, dtype=">u4").tobytes() for g in got] == want

    def test_ptxas_resources(self):
        report = "\n".join([
            "ptxas info    : 0 bytes gmem",
            "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116sha1_rows_kernelEPKhlPKiPjl' for 'sm_90a'",
            "ptxas info    : Function properties for _ZN12_GLOBAL__N_116sha1_rows_kernelEPKhlPKiPjl",
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
            "ptxas info    : Used 64 registers, used 1 barriers, 400 bytes cmem[0]",
            "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120sha256_merkle_kernelEPKjPjli' for 'sm_90a'",
            "ptxas info    : Function properties for _ZN12_GLOBAL__N_120sha256_merkle_kernelEPKjPjli",
            "    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads",
            "ptxas info    : Used 80 registers, used 1 barriers, 16384 bytes smem, 400 bytes cmem[0]",
        ])
        assert native_build.ptxas_resources(report, "sha1_rows_kernel") == {
            "registers": 64, "smem_bytes": 0, "spill_stores": 0, "spill_loads": 0,
        }
        assert native_build.ptxas_resources(report, "sha256_merkle_kernel") == {
            "registers": 80, "smem_bytes": 16384, "spill_stores": 12, "spill_loads": 4,
        }
        assert native_build.ptxas_resources(report, "nope")["registers"] is None
        assert native_build.ptxas_resources("", "sha1_rows_kernel")["registers"] is None
