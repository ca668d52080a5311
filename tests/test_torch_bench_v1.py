"""The benchmark's v1 recheck deployment, ``v1_256k`` in cell ``v1-recheck``,
and its two per-layer readers, on the CPU.

The configuration is loaded from the real ``BENCHMARK.json`` and cut to
a few pieces of 16 KiB at batch 8, its 4 read stripes kept (the entry's
default), then run through ``benchmark.run.run_cell`` with the port's
plain CPU planes in the cell's timed call: its bitfields agree with
the plain reference (``benchmark/reference/hashes.py``, hashlib) piece
by piece, and the traced run reports the pread pool's lock wait
(``read_wait_ms_per_GiB.recheck``). The control and an answer altered
where it is produced are not correct. ``sha1_roofline.recheck`` gives
on a synthetic trace the share the frozen yardstick says.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness
from benchmark import run as bench_run
from benchmark.reference import hashes
from benchmark.reference.yardstick import least_seconds, sha1_work
from torrent_tpu_torch.native.io_engine import native_available

CELL, CONFIG = "v1-recheck", "v1_256k"
SEED = 2**31 + 2121
PLEN, PIECES, BATCH = 16384, 10, 8  # batches of 8 and 2; 4 stripes of 2 pieces


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_configuration_as_published(bench):
    entry = harness.find(bench["configs"], CONFIG, "configuration")
    cfg = harness.load_config(bench, CONFIG)
    assert (cfg["version"], cfg["hash"], cfg["piece_length"], cfg["batch_size"]) == (1, "sha1", 262144, 4096)
    assert cfg["total_bytes"] == 8191 * 262144 + 100000
    assert entry["reduced"] == cfg["reduced"] == ["total_bytes"]
    assert cfg["published"] == {"total_bytes": 100 * 2**30}
    cell = harness.find(bench["workloads"], CELL, "workload")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "recheck", 1)
    e2e = {m["name"] for m in harness.metrics_for(bench["end_to_end"], CELL)}
    assert e2e == {"card_ms_per_GiB", "setup_s"}
    per_layer = {m["name"] for m in harness.metrics_for(bench["per_layer"], CELL, e2e)}
    assert {"sha1_roofline.recheck", "read_wait_ms_per_GiB.recheck"} <= per_layer
    assert not per_layer & {"stage_share.recheck", "sha256_roofline.recheck", "merkle_roofline.recheck"}


@pytest.fixture
def tiny(bench, tmp_path):
    """``BENCHMARK.json`` with ``v1_256k`` cut to a few pieces of 16 KiB."""
    out = copy.deepcopy(bench)
    entry = harness.find(out["configs"], CONFIG, "configuration")
    cfg = harness.load_config(out, CONFIG)
    cfg.update(piece_length=PLEN, total_bytes=PLEN * PIECES - 777, batch_size=BATCH)
    path = tmp_path / f"{CONFIG}.json"
    path.write_text(json.dumps(cfg))
    entry["file"] = str(path)
    return out


def _reference(root, info, config, device):
    """The plain reference's verdicts, read back from the file."""
    with open(Path(root) / config["file_name"], "rb") as f:
        data = f.read()
    digests = hashes.sha1_pieces(np.frombuffer(data, dtype=np.uint8), config["piece_length"])
    return np.array([d == info.pieces[i] for i, d in enumerate(digests)])


def _altered(root, info, config, device):
    ok = _reference(root, info, config, device)
    ok[1] = not ok[1]
    return ok


def test_port_run_is_correct_and_counts_the_wait(tiny):
    out = bench_run.run_cell(tiny, CELL, SEED, 0.1, trace=True, device="cpu")
    assert out["correct"] and out["checks"]["bitfield_mismatches"]["value"] == 0
    assert out["attempted"] >= 1 and out["failed"] == 0
    metrics = out["metrics"]
    assert metrics["recheck_GiB_s.host"]["value"] > 0
    assert 0 < metrics["read_share.recheck"]["value"] <= 100
    # no device trace on the CPU: the kernel's share finds nothing
    assert "sha1_roofline.recheck" not in metrics
    if native_available():
        assert metrics["read_wait_ms_per_GiB.recheck"]["value"] >= 0
        assert metrics["read_wait_ms_per_GiB.recheck"]["unit"] == "ms/GiB"


@pytest.mark.parametrize("program,control", [(_reference, False), (_altered, False), (None, True)],
                         ids=["reference", "altered", "control"])
def test_only_the_sound_answer_is_correct(tiny, program, control):
    out = bench_run.run_cell(tiny, CELL, SEED, 0.1, device="cpu", program=program, control=control)
    sound = program is _reference
    assert out["correct"] is sound
    assert (out["checks"]["bitfield_mismatches"]["value"] == 0) is sound


# ------------------------------------------------------------ the readers


def _trace(kernels):
    return {"window_us": (0.0, 60e6), "kernels": kernels, "copies": [], "host": []}


@pytest.mark.parametrize("repeats,kernel_us", [(1, [1840.0, 1840.0]), (3, [1800.0] * 6), (2, [900.0, 2000.0, 1500.0, 1700.0])])
def test_sha1_roofline_is_the_yardsticks_share(repeats, kernel_us):
    read = harness.load_reader("sha1_roofline.recheck")
    lengths = [262144] * 8191 + [100000]
    kernels = [("sha1_rows_kernel(unsigned char const*)", t, t + d) for t, d in zip(np.cumsum([0.0] + kernel_us), kernel_us)]
    kernels.append(("sha256_rows_kernel", 0.0, 5e6))  # another kernel is not counted
    ops, nbytes = sha1_work(lengths)
    want = 100.0 * repeats * least_seconds(ops, nbytes) / (sum(kernel_us) / 1e6)
    got = read({"trace": _trace(kernels), "hashed": {"repeats": repeats, "sha1_lengths": lengths}})
    assert got == pytest.approx(want, rel=1e-12)
    assert 0 < got <= 100


@pytest.mark.parametrize(
    "evidence",
    [
        {"trace": None, "hashed": {"repeats": 1, "sha1_lengths": [16384]}},
        {"trace": _trace([("sha1_rows_kernel", 0.0, 10.0)]), "hashed": {"repeats": 1, "sha256_lengths": [16384]}},
        {"trace": _trace([("sha256_rows_kernel", 0.0, 10.0)]), "hashed": {"repeats": 1, "sha1_lengths": [16384]}},
    ],
    ids=["no-trace", "v2-work", "no-sha1-kernel"],
)
def test_sha1_roofline_reads_nothing_where_there_is_nothing(evidence):
    assert harness.load_reader("sha1_roofline.recheck")(evidence) is None


@pytest.mark.parametrize(
    "ledger,work,want",
    [
        ({"read_wait": {"busy_s": 0.5, "bytes": 2**30, "ops": 8}}, 2 * 2**30, 250.0),
        ({"read_wait": {"busy_s": 0.0, "bytes": 2**30, "ops": 8}}, 2**30, 0.0),
        ({"read": {"busy_s": 1.0, "bytes": 2**30, "ops": 2}}, 2**30, None),  # a program without the counter
        ({"read_wait": {"busy_s": 0.0, "bytes": 0, "ops": 0}}, 2**30, None),
        ({"read_wait": {"busy_s": 0.5, "bytes": 2**30, "ops": 8}}, 0, None),
    ],
    ids=["rate", "zero", "parent", "no-calls", "no-work"],
)
def test_read_wait_reader(ledger, work, want):
    got = harness.load_reader("read_wait_ms_per_GiB.recheck")({"ledger": ledger, "work_bytes": work, "window_s": 51.0})
    assert got == (pytest.approx(want) if want is not None else None)
