"""The port's bench command (``torrent_tpu_torch/tools/bench_cli.py``,
``python -m torrent_tpu_torch bench``): its rungs, its banked-schema
records and its trajectory comparator.

Three parts:

- the reference's bench cases run against the port: ``test_pipeline.py``'s
  ``TestBenchHarness`` and ``TestTrajectoryAggregation``,
  ``test_tracker_shard.py::TestBenchAnnounceRung``,
  ``test_swarm_obs.py::TestBenchSwarmRung``,
  ``test_timeline.py::TestTrajectoryPreservesSchema``,
  ``test_ingest.py``'s e2e-rung case and ``test_control.py``'s
  controller-rung and controller-trajectory cases. Rungs whose clients
  verify pieces take ``hasher="cpu"`` where the reference relied on its
  hashlib default: the port's default is the card. ``test_pipeline.py``'s
  ``TestTopRendering`` is in ``tests/test_torch_top.py`` and
  ``test_serve_plane.py``'s seed-rung classes in
  ``tests/test_torch_serve_plane.py``;
- differential cases: the same records give both packages'
  ``compare_record``, ``like_for_like``, ``load_trajectory`` and
  ``bank_record`` the same results, and the smoke and e2e rungs the same
  metric names and record keys;
- the port's own rules: the default trajectory is never the repo's
  ``BENCH_trajectory.json``, the device rungs run the port's device bench
  (a null record, and exit 1, without CUDA), and the e2e rung's ``gpu``
  hasher runs the plain SHA-1 on ``--device cpu``.
"""

import asyncio
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from torrent_tpu.tools import bench_cli as ref_bench_cli
from torrent_tpu_torch.tools import bench_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(coro, timeout=300):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _summarize():
    """The reference's trajectory aggregator (``.bench/summarize.py``),
    loaded as the reference's tests load it: the port never imports it."""
    spec = importlib.util.spec_from_file_location(
        "summarize", os.path.join(REPO, ".bench", "summarize.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _file_hash(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# ------------------------------------------------- test_pipeline.py copies


class TestBenchHarness:
    """python -m torrent_tpu_torch bench: banked-schema records with the
    ledger breakdown embedded, self-banking, and the trajectory
    comparator."""

    def _smoke_record(self, tmp_path, extra=()):
        out = str(tmp_path / "record.json")
        rc = bench_cli.main(
            ["--smoke", "--mb", "1", "--piece-kb", "64", "--out", out,
             *extra]
        )
        with open(out) as f:
            return rc, json.load(f)

    def test_smoke_emits_banked_schema_with_ledger(self, tmp_path, capsys):
        rc, rec = self._smoke_record(tmp_path)
        assert rc == 0
        assert rec["schema"] == "torrent-tpu-bench/1"
        assert rec["rung"] == "smoke"
        assert rec["value"] is not None and rec["unit"] == "pieces/s"
        assert rec["valid"] == rec["pieces"]
        # the per-stage ledger breakdown is embedded in the record
        assert rec["ledger"]["bottleneck"] is not None
        for stage in ("read", "launch", "verdict"):
            assert stage in rec["ledger"]["stages"]
        # stdout carries exactly the record as one JSON line
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert json.loads(line)["metric"] == rec["metric"]

    def test_compare_regression_exits_nonzero(self, tmp_path):
        banked = {
            "metric": "sha1_recheck_smoke_64KiB_pieces_per_sec",
            "value": 1000.0, "unit": "pieces/s", "platform": "cpu",
            "batch": 32,
        }
        traj = str(tmp_path / "traj.json")
        with open(traj, "w") as f:
            json.dump({"records": [banked]}, f)
        # synthetically injected regression: 40% below the banked best
        cand = dict(banked, value=600.0)
        cand_path = str(tmp_path / "cand.json")
        with open(cand_path, "w") as f:
            json.dump(cand, f)
        rc = bench_cli.main(
            ["--record", cand_path, "--compare", "--trajectory", traj]
        )
        assert rc == 1
        # within tolerance → ok
        with open(cand_path, "w") as f:
            json.dump(dict(banked, value=950.0), f)
        assert bench_cli.main(
            ["--record", cand_path, "--compare", "--trajectory", traj]
        ) == 0
        # report-only never fails
        with open(cand_path, "w") as f:
            json.dump(cand, f)
        assert bench_cli.main(
            ["--record", cand_path, "--compare", "--trajectory", traj,
             "--report-only"]
        ) == 0

    def test_compare_unarmed_without_like_for_like(self, tmp_path, capsys):
        traj = str(tmp_path / "traj.json")
        with open(traj, "w") as f:
            # same metric but a different batch shape AND a caveated
            # record: neither arms the gate
            json.dump({"records": [
                {"metric": "m", "value": 100.0, "platform": "cpu",
                 "batch": 512},
                {"metric": "m", "value": 100.0, "platform": "cpu",
                 "batch": 32, "non_like_for_like": True},
            ]}, f)
        cand_path = str(tmp_path / "cand.json")
        with open(cand_path, "w") as f:
            json.dump({"metric": "m", "value": 1.0, "platform": "cpu",
                       "batch": 32}, f)
        rc = bench_cli.main(
            ["--record", cand_path, "--compare", "--trajectory", traj]
        )
        assert rc == 0
        assert "unarmed" in capsys.readouterr().err

    def test_bank_then_compare_gates(self, tmp_path):
        """The self-banking loop: a banked smoke record arms the gate
        for the next run of the same shape."""
        traj = str(tmp_path / "traj.json")
        rc, rec = self._smoke_record(
            tmp_path, extra=["--bank", "--trajectory", traj]
        )
        assert rc == 0
        records = bench_cli.load_trajectory(traj)
        assert len(records) == 1 and records[0]["metric"] == rec["metric"]
        # a regressed candidate of the same shape now fails the gate
        cand = dict(records[0], value=records[0]["value"] * 0.1)
        code, msg = bench_cli.compare_record(cand, records)
        assert code == 1 and "REGRESSION" in msg
        # and the genuine record passes against itself
        code, msg = bench_cli.compare_record(records[0], records)
        assert code == 0

    def test_null_value_record_fails(self, tmp_path):
        cand_path = str(tmp_path / "cand.json")
        with open(cand_path, "w") as f:
            json.dump({"metric": "m", "value": None}, f)
        assert bench_cli.main(["--record", cand_path]) == 1

    def test_usage_errors(self):
        assert bench_cli.main([]) == 2  # no rung, no record


class TestTrajectoryAggregation:
    def test_summarize_trajectory_marks_shape_caveats(self, tmp_path):
        """.bench/summarize.py --trajectory aggregates the reference's live
        bank into one machine-readable file with the schema the port's
        bank_record writes, preserving the like-for-like caveats."""
        out = str(tmp_path / "traj.json")
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, ".bench", "summarize.py"),
             "--trajectory", out],
            capture_output=True, text=True, timeout=60,
        )
        assert proc.returncode == 0, proc.stderr
        with open(out) as f:
            data = json.load(f)
        assert data["schema"] == bench_cli.TRAJECTORY_SCHEMA
        recs = data["records"]
        assert recs, "no records aggregated"
        assert all(r["value"] is not None for r in recs)
        caveated = [r for r in recs if r["non_like_for_like"]]
        assert any(
            r["metric"] == "sha1_recheck_256KiB_pieces_per_sec"
            and r.get("batch") == 512
            for r in caveated
        ), recs
        # the port's comparator reads the aggregate: none of its TPU
        # records is like-for-like with a cuda record of the same metric
        cand = {"metric": "sha1_recheck_256KiB_pieces_per_sec", "value": 1.0,
                "platform": "cuda", "batch": 8192}
        assert bench_cli.like_for_like(bench_cli.load_trajectory(out), cand) == []

    def test_regeneration_preserves_self_banked_records(self, tmp_path):
        """`bench --bank` records exist only in the trajectory file;
        regenerating it with the aggregator must merge the port's banked
        records back."""
        out = str(tmp_path / "traj.json")
        banked = {"metric": "sha1_recheck_smoke_256KiB_pieces_per_sec",
                  "value": 3000.0, "unit": "pieces/s", "platform": "cpu",
                  "batch": 32, "rung": "smoke",
                  "schema": "torrent-tpu-bench/1"}
        bench_cli.bank_record(banked, out)
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, ".bench", "summarize.py"),
             "--trajectory", out],
            capture_output=True, text=True, timeout=60,
        )
        assert proc.returncode == 0, proc.stderr
        records = bench_cli.load_trajectory(out)
        kept = [r for r in records if r["metric"] == banked["metric"]]
        assert kept and kept[0]["value"] == 3000.0, records
        assert any(r.get("artifact") for r in records)


# ---------------------------------------- test_tracker_shard.py copies


class TestBenchAnnounceRung:
    def test_storm_record_schema_and_occupancy(self):
        from torrent_tpu_torch.tools.bench_cli import (
            ANNOUNCE_MIN_SHARDS_HIT,
            SCHEMA,
            _announce_storm,
        )

        rec = run(_announce_storm(
            clients=4, swarms=16, per_client=120, shards=8, numwant=10))
        assert rec["schema"] == SCHEMA and rec["rung"] == "announce"
        assert rec["unit"] == "announces/s"
        assert rec["value"] is not None and rec["value"] > 0
        assert rec["contract"] == "median-of-3" and len(rec["rates"]) == 3
        assert rec["shards_hit"] >= ANNOUNCE_MIN_SHARDS_HIT
        occ = rec["shard_occupancy"]
        assert len(occ) == 8 and sum(occ.values()) == rec["store"]["peers"]
        lat = rec["latency"]
        assert lat["p50_us"] is not None and lat["p99_us"] >= lat["p50_us"]
        for key in ("metric", "platform", "batch", "nproc"):
            assert rec.get(key) is not None

    def test_bank_then_compare_gates(self, tmp_path):
        traj = str(tmp_path / "traj.json")
        small = ["announce", "--clients", "2", "--swarms", "16",
                 "--per-client", "60", "--shards", "8", "--numwant", "5",
                 "--trajectory", traj]
        assert bench_cli.main(small + ["--bank"]) == 0
        # like-for-like record banked → the comparator is ARMED and passes
        assert bench_cli.main(small + ["--compare", "--tolerance", "0.99"]) == 0

    def test_trajectory_normalize_preserves_announce_keys(self):
        mod = _summarize()
        rec = {
            "metric": "tracker_announce_storm_32sw_announces_per_sec",
            "value": 50000.0, "unit": "announces/s", "rung": "announce",
            "platform": "cpu", "batch": 8, "nproc": 8,
            "contract": "median-of-3", "clients": 8, "swarms": 32,
            "shards": 8, "shards_hit": 8, "numwant": 30,
            "announces": 16000, "rates": [49000.0, 50000.0, 51000.0],
            "latency": {"p50_us": 20.0, "p99_us": 90.0, "max_us": 400.0},
            "shard_occupancy": {"0": 2000, "1": 2000},
            "store": {"peers": 16000},
            "measured_at_utc": "2026-08-04T00:00:00Z",
        }
        out = mod._normalize(rec, "x.json")
        for key in ("contract", "clients", "swarms", "shards", "shards_hit",
                    "numwant", "announces", "rates", "latency",
                    "shard_occupancy", "store", "nproc"):
            assert out[key] == rec[key], key
        assert out["non_like_for_like"] is False

    def test_sub_floor_config_rejected_upfront(self, capsys):
        assert bench_cli.main(["announce", "--shards", "2"]) == 2
        assert ">= 4" in capsys.readouterr().err
        assert bench_cli.main(["announce", "--swarms", "3"]) == 2

    def test_single_shard_storm_fails_acceptance(self):
        rec = run(bench_cli._announce_storm(
            clients=2, swarms=4, per_client=30, shards=1, numwant=5))
        assert rec["value"] is None and rec["shards_hit"] == 1


# -------------------------------------------- test_swarm_obs.py copies


class TestBenchSwarmRung:
    def test_swarm_rung_record_schema(self):
        rec = run(bench_cli._swarm_rung(1, 64, hasher="cpu"))
        assert rec["schema"] == bench_cli.SCHEMA
        assert rec["rung"] == "swarm"
        assert rec["value"] is not None and rec["value"] > 0
        assert rec["unit"] == "pieces/s"
        assert len(rec["rates"]) == 3
        assert rec["pieces"] == 16
        # the wire plane's evidence rides the banked rate
        assert rec["swarm"]["blocks"] >= rec["pieces"]
        assert rec["swarm"]["peers"] >= 2
        assert "recv" in (rec["ledger"]["stages"] or {})
        for key in ("piece_kb", "bytes", "nproc", "platform"):
            assert key in rec
        assert rec["platform"] == "cpu" and rec["plane"] == "cpu"

    def test_trajectory_normalize_preserves_swarm_keys(self):
        rec = {
            "metric": "swarm_loopback_256KiB_pieces_per_sec",
            "value": 255.4, "unit": "pieces/s", "rung": "swarm",
            "swarm": {"blocks": 1536, "block_rtt_p99_s": 0.015},
            "ledger": {"stages": {"recv": {"busy_s": 0.05}}},
            "piece_kb": 256, "bytes": 8 << 20, "nproc": 1,
            "platform": "cpu", "batch": None,
        }
        out = _summarize()._normalize(rec, "bench_swarm.json")
        assert out["swarm"] == rec["swarm"]
        assert out["ledger"] == rec["ledger"]
        assert out["piece_kb"] == 256 and out["nproc"] == 1
        assert not out["non_like_for_like"]


# ---------------------------------------------- test_timeline.py copies


class TestTrajectoryPreservesSchema:
    def test_summarize_normalize_keeps_timeline_and_slo_keys(self):
        rec = {
            "metric": "sha1_recheck_smoke_256KiB_pieces_per_sec",
            "value": 500.0, "unit": "pieces/s", "batch": 32,
            "platform": "cpu", "piece_kb": 256, "bytes": 1 << 23, "nproc": 4,
            "timeline": {"samples": 2, "drops": 0, "limiting": "launch"},
            "slo": {"worst": {"objective": "availability", "burn_rate": 0.0},
                    "breach_any": False, "objectives": {}},
        }
        out = _summarize()._normalize(rec, "live/r.json")
        assert out["timeline"] == rec["timeline"]
        assert out["slo"] == rec["slo"]
        assert out["non_like_for_like"] is False

    def test_bench_smoke_record_embeds_timeline_and_slo(self):
        rec = run(bench_cli._smoke(total_mb=1, piece_kb=256, batch_target=8), timeout=120)
        assert rec["timeline"]["samples"] == 2
        assert rec["slo"]["breach_any"] is False
        assert "availability" in rec["slo"]["objectives"]
        assert rec["value"] is not None


# ------------------------------------- test_ingest.py / test_control.py


class TestLedgerAcceptance:
    def test_bench_e2e_rung_embeds_breakdown(self):
        """`bench e2e` emits a banked-schema record with the ledger
        breakdown + overlap + slab accounting embedded."""
        rec = run(bench_cli._e2e(2, 256, 4, "cpu"))
        assert rec["schema"] == bench_cli.SCHEMA and rec["rung"] == "e2e"
        assert rec["value"] is not None and rec["valid"] == rec["pieces"]
        assert rec["staging_outstanding"] == 0
        assert rec["ledger"]["stages"].get("stage", {}).get("bytes", 0) == 0
        assert "overlap" in rec["ledger"]

    def test_bench_e2e_gpu_hasher_on_the_plain_sha1(self):
        """``--hasher gpu --device cpu``: the scheduler's device plane runs
        the plain SHA-1 through the same zero-copy ingest; the record
        names the ``gpu`` plane on the ``cpu`` device."""
        rec = run(bench_cli._e2e(1, 4, 64, "gpu", "cpu"))
        assert rec["metric"] == "sha1_recheck_e2e_gpu_4KiB_pieces_per_sec"
        assert rec["platform"] == "cpu" and rec["plane"] == "gpu"
        assert rec["value"] is not None and rec["valid"] == rec["pieces"] == 256
        assert rec["staging_outstanding"] == 0


class TestSurfaces:
    def test_bench_controller_record_schema(self):
        rec = run(bench_cli._controller_ab(2, 256, 4), timeout=300)
        assert rec["schema"] == bench_cli.SCHEMA
        assert rec["rung"] == "controller"
        assert rec["value"] is not None
        assert rec["ab"]["controller_off_pps"] and rec["ab"]["controller_on_pps"]
        assert rec["ab"]["ratio"] is not None
        assert rec["fault"] == "latency_ms=25"
        assert rec["decision"]["bottleneck"] in (None, *(
            "read", "stage", "h2d", "launch", "digest", "verdict",
        ))
        assert "ledger" in rec and rec["ledger"]["stages"]

    def test_trajectory_normalize_preserves_controller_keys(self):
        rec = {
            "metric": "sha1_recheck_controller_ab_256KiB_pieces_per_sec",
            "value": 758.1, "unit": "pieces/s", "rung": "controller",
            "platform": "cpu", "batch": 8, "piece_kb": 256, "nproc": 8,
            "bytes": 1 << 25, "fault": "latency_ms=25",
            "ab": {"controller_off_pps": 500.4, "controller_on_pps": 758.1,
                   "ratio": 1.515},
            "decision": {"bottleneck": "h2d"},
            "measured_at_utc": "2026-08-04T00:00:00Z",
        }
        out = _summarize()._normalize(rec, "x.json")
        for key in ("ab", "decision", "fault", "piece_kb", "bytes", "nproc"):
            assert out[key] == rec[key], key
        assert out["non_like_for_like"] is False


# ---------------------------------------------------------- differential

_RECORDS = [
    {"metric": "m", "value": 100.0, "platform": "cpu", "batch": 32},
    {"metric": "m", "value": 120.0, "platform": "cpu", "batch": 32, "nproc": 8},
    {"metric": "m", "value": 300.0, "platform": "cpu", "batch": 32, "non_like_for_like": True},
    {"metric": "m", "value": None, "platform": "cpu", "batch": 32},
    {"metric": "m", "value": 90.0, "platform": "cuda", "batch": 32},
    {"metric": "m", "value": 80.0, "platform": "tpu", "batch": 512},
    {"metric": "n", "value": 5.0, "platform": "cpu", "batch": 32, "piece_kb": 256, "bytes": 1 << 20},
]
_CANDIDATES = [
    {"metric": "m", "value": 100.0, "platform": "cpu", "batch": 32},
    {"metric": "m", "value": 85.0, "platform": "cpu", "batch": 32},
    {"metric": "m", "value": 130.0, "platform": "cpu", "batch": 32, "nproc": 8},
    {"metric": "m", "value": None, "platform": "cpu", "batch": 32},
    {"metric": "m", "value": 1.0, "platform": "cuda", "batch": 32},
    {"metric": "m", "value": 1.0, "platform": "gpu", "batch": 32},
    {"metric": "n", "value": 4.4, "platform": "cpu", "batch": 32, "piece_kb": 256, "bytes": 1 << 20},
    {"metric": "n", "value": 4.4, "platform": "cpu", "batch": 32, "piece_kb": 64, "bytes": 1 << 20},
]


class TestComparatorDifferential:
    @pytest.mark.parametrize("cand", _CANDIDATES)
    @pytest.mark.parametrize("tolerance", [0.10, 0.0, 0.5])
    def test_compare_and_like_for_like_agree(self, cand, tolerance):
        assert bench_cli.like_for_like(_RECORDS, cand) == ref_bench_cli.like_for_like(_RECORDS, cand)
        assert bench_cli.compare_record(cand, _RECORDS, tolerance) == ref_bench_cli.compare_record(
            cand, _RECORDS, tolerance
        )

    @pytest.mark.parametrize(
        "content",
        [
            json.dumps({"records": _RECORDS}),
            json.dumps(_RECORDS),
            json.dumps(_RECORDS[0]),
            json.dumps({"schema": "x"}),
            json.dumps({"records": "nope"}),
            json.dumps([1, "two", _RECORDS[1]]),
            "not json",
            "",
            None,
        ],
        ids=["records", "list", "single", "no-metric", "bad-records", "mixed-list",
             "malformed", "empty", "missing"],
    )
    def test_load_trajectory_agrees(self, content, tmp_path):
        path = tmp_path / "traj.json"
        if content is not None:
            path.write_text(content)
        assert bench_cli.load_trajectory(str(path)) == ref_bench_cli.load_trajectory(str(path))

    @pytest.mark.parametrize("start", [None, "list", "records", "malformed"])
    def test_bank_record_agrees(self, start, tmp_path):
        paths = {}
        for name, mod in (("port", bench_cli), ("ref", ref_bench_cli)):
            p = tmp_path / f"{name}.json"
            if start == "list":
                p.write_text(json.dumps(_RECORDS[:2]))
            elif start == "records":
                p.write_text(json.dumps({"schema": "x", "records": _RECORDS[:3]}))
            elif start == "malformed":
                p.write_text("{")
            for rec in _CANDIDATES[:3]:
                mod.bank_record(rec, str(p))
            paths[name] = json.loads(p.read_text())
        for data in paths.values():
            assert data.pop("banked_at_utc")
        assert paths["port"] == paths["ref"]

    def test_smoke_rung_metric_and_keys_agree(self):
        port = run(bench_cli._smoke(1, 64, 8))
        ref = run(ref_bench_cli._smoke(1, 64, 8))
        assert port["metric"] == ref["metric"] == "sha1_recheck_smoke_64KiB_pieces_per_sec"
        assert set(port) == set(ref)
        assert set(port["ledger"]) == set(ref["ledger"]) and set(port["slo"]) == set(ref["slo"])
        for key in ("unit", "pieces", "valid", "bytes", "batch", "piece_kb", "platform", "plane"):
            assert port[key] == ref[key], key

    def test_e2e_rung_metric_and_keys_agree(self):
        port = run(bench_cli._e2e(1, 64, 8, "cpu"))
        ref = run(ref_bench_cli._e2e(1, 64, 8, "cpu"))
        assert port["metric"] == ref["metric"] == "sha1_recheck_e2e_cpu_64KiB_pieces_per_sec"
        assert set(port) == set(ref)
        for key in ("pieces", "valid", "bytes", "platform", "plane", "staging_outstanding"):
            assert port[key] == ref[key], key

    def test_announce_rung_keys_agree(self):
        kw = dict(clients=2, swarms=8, per_client=40, shards=4, numwant=5)
        port = run(bench_cli._announce_storm(**kw))
        ref = run(ref_bench_cli._announce_storm(**kw))
        assert set(port) == set(ref) and port["metric"] == ref["metric"]
        # the swarms' info-hashes and the shard routing are deterministic
        assert port["shard_occupancy"] == ref["shard_occupancy"]
        assert port["shards_hit"] == ref["shards_hit"]


# ------------------------------------------------------- the port's rules


class TestPortRules:
    def test_default_trajectory_is_never_the_repos(self, monkeypatch, tmp_path):
        """The reference's default resolves to the repo's
        BENCH_trajectory.json (TPU and CPU records of the reference); the
        port's never does, from any directory."""
        repo_traj = os.path.join(REPO, "BENCH_trajectory.json")
        monkeypatch.delenv("TORRENT_TPU_BENCH_TRAJECTORY", raising=False)
        for cwd in (REPO, str(tmp_path)):
            monkeypatch.chdir(cwd)
            path = bench_cli.default_trajectory_path()
            assert os.path.realpath(path) != os.path.realpath(repo_traj)
            assert path == os.path.join(cwd, "BENCH_trajectory_cuda.json")
        monkeypatch.chdir(REPO)
        assert os.path.realpath(ref_bench_cli.default_trajectory_path()) == os.path.realpath(repo_traj)
        monkeypatch.setenv("TORRENT_TPU_BENCH_TRAJECTORY", str(tmp_path / "t.json"))
        assert bench_cli.default_trajectory_path() == str(tmp_path / "t.json")

    def test_bank_without_trajectory_leaves_the_repos_file(self, monkeypatch, tmp_path):
        """``--bank`` with the default trajectory writes the port's file in
        the current directory and never edits the repo's."""
        repo_traj = os.path.join(REPO, "BENCH_trajectory.json")
        before = _file_hash(repo_traj)
        monkeypatch.delenv("TORRENT_TPU_BENCH_TRAJECTORY", raising=False)
        monkeypatch.chdir(tmp_path)
        rec = tmp_path / "rec.json"
        rec.write_text(json.dumps({"metric": "m", "value": 5.0, "platform": "cuda", "batch": 8}))
        assert bench_cli.main(["--record", str(rec), "--bank"]) == 0
        assert bench_cli.main(["--record", str(rec), "--compare"]) == 0
        banked = bench_cli.load_trajectory(str(tmp_path / "BENCH_trajectory_cuda.json"))
        assert [r["value"] for r in banked] == [5.0]
        assert _file_hash(repo_traj) == before

    def test_device_rung_runs_the_port_device_bench(self, monkeypatch, tmp_path):
        """A device rung on ``--device cpu`` runs the port's device bench
        (the plain versions) with the rung's env, and wraps its record."""
        small = {"BENCH_CONFIG": "headline", "BENCH_BATCH": "64", "BENCH_TOTAL_MB": "1",
                 "BENCH_PIECE_KB": "4", "BENCH_BANK_DIR": str(tmp_path)}
        monkeypatch.setitem(bench_cli._DEVICE_RUNG_ENV, "flagship", small)
        out = tmp_path / "rec.json"
        assert bench_cli.main(["flagship", "--device", "cpu", "--out", str(out)]) == 0
        rec = json.loads(out.read_text())
        assert rec["rung"] == "flagship" and rec["schema"] == bench_cli.SCHEMA
        assert rec["metric"] == "sha1_recheck_4KiB_pieces_per_sec"
        assert rec["platform"] == "cpu" and rec["backend"] == "torch" and rec["ledger"] is None
        assert rec["n_runs"] == 3 and len(rec["runs_pps"]) == 3 and rec["value"] > 0

    def test_device_rungs_without_cuda_fail_with_a_null_record(self, capsys):
        """No ``--device`` means the card: on a host without CUDA each
        device rung prints the child's null record and exits 1."""
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA card")
        for rung in ("flagship", "v2"):
            assert bench_cli.main([rung]) == 1
            cap = capsys.readouterr()
            rec = json.loads(cap.out.strip().splitlines()[-1])
            assert rec["value"] is None and rec["status"] == "cuda_unavailable"
            assert rec["rung"] == rung and "value is null" in cap.err
        assert bench_cli.main(["e2e", "--mb", "1"]) == 1
        assert "torch.cuda.is_available() is False" in capsys.readouterr().err

    def test_device_rung_env_has_one_sha256_plane(self):
        assert {k: v for k, v in ref_bench_cli._DEVICE_RUNG_ENV["v2"].items()
                if k != "TORRENT_TPU_SHA256_BACKEND"} == bench_cli._DEVICE_RUNG_ENV["v2"]
        assert bench_cli._DEVICE_RUNG_ENV["flagship"] == ref_bench_cli._DEVICE_RUNG_ENV["flagship"]

    def test_fabric_measurer_prints_one_line_a_rep(self, tmp_path):
        """``tools/bench_fabric.py`` (the fabric rung's legs): a 2-process
        hashlib fabric over a tiny library, one record a rep, each with
        every worker's ledger breakdown."""
        proc = subprocess.run(
            [sys.executable, "-m", "torrent_tpu_torch.tools.bench_fabric",
             "--workdir", str(tmp_path), "--nproc", "2", "--reps", "2", "--torrents", "2",
             "--mb-per-torrent", "1", "--piece-kb", "64", "--hasher", "cpu"],
            cwd=REPO, capture_output=True, text=True, timeout=240,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
        assert [r["rep"] for r in lines] == [0, 1]
        for r in lines:
            assert r["nproc"] == 2 and r["hasher"] == "cpu" and r["valid"] == r["pieces"]
            assert r["gib_per_sec"] > 0 and len(r["per_process"]) == 2
            assert sum(p["pieces_verified"] for p in r["per_process"]) == r["pieces"]

    def test_fabric_measurer_gpu_hasher_on_cpu_device(self, tmp_path):
        """``--hasher gpu --device cpu``: every worker runs the port's
        ``gpu`` plane on the plain SHA-1 (tiny pieces: the plain version
        is slow by blocks) and verifies the whole library."""
        proc = subprocess.run(
            [sys.executable, "-m", "torrent_tpu_torch.tools.bench_fabric",
             "--workdir", str(tmp_path), "--nproc", "2", "--reps", "1", "--torrents", "2",
             "--mb-per-torrent", "0", "--piece-kb", "16", "--hasher", "gpu", "--device", "cpu"],
            cwd=REPO, capture_output=True, text=True, timeout=240,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        (r,) = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
        assert r["hasher"] == "gpu" and r["valid"] == r["pieces"] == 2
        assert sum(p["pieces_verified"] for p in r["per_process"]) == 2

    def test_fabric_measurer_defaults_to_the_card(self, tmp_path):
        """No ``--hasher`` means the card: without CUDA the tool raises
        before it builds a library or starts a worker."""
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA card")
        from torrent_tpu_torch.tools import bench_fabric
        from torrent_tpu_torch.utils.device import DeviceUnavailable

        with pytest.raises(DeviceUnavailable):
            bench_fabric.main(["--workdir", str(tmp_path), "--nproc", "1"])
        assert os.listdir(tmp_path) == []

    @pytest.mark.parametrize(
        "argv,forwarded,platform",
        [
            (["--hasher", "gpu", "--device", "cpu"], ["--hasher", "gpu", "--device", "cpu"], "cpu"),
            (["--hasher", "cpu"], ["--hasher", "cpu"], "cpu"),
        ],
    )
    def test_fabric_rung_forwards_hasher_and_device(self, monkeypatch, tmp_path, argv,
                                                     forwarded, platform):
        """``bench fabric`` hands ``main``'s ``--hasher`` and ``--device`` to
        every leg and names the plane's device as ``platform``."""
        seen = []

        def fake_run(cmd, **kw):
            seen.append(cmd)
            nproc = int(cmd[cmd.index("--nproc") + 1])
            lines = [json.dumps({"nproc": nproc, "rep": r, "gib_per_sec": float(nproc + r),
                                 "per_process": [{"pid": 0}], "fleet_bottleneck": None})
                     for r in range(3)]
            return subprocess.CompletedProcess(cmd, 0, stdout="\n".join(lines), stderr="")

        monkeypatch.setattr(bench_cli.subprocess, "run", fake_run)
        out = tmp_path / "rec.json"
        assert bench_cli.main(["fabric", *argv, "--out", str(out)]) == 0
        rec = json.loads(out.read_text())
        assert [int(c[c.index("--nproc") + 1]) for c in seen] == [1, 2, 4]
        for cmd in seen:
            assert cmd[cmd.index("--hasher"):] == forwarded
        assert rec["platform"] == platform and rec["value"] == 5.0
        assert rec["scaling"] == {"1": 2.0, "2": 3.0, "4": 5.0}

    def test_fabric_rung_without_cuda_starts_no_leg(self, monkeypatch, capsys):
        """``bench fabric`` with the default hasher resolves the card
        before any leg: without CUDA it exits 1 and runs no worker."""
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA card")

        def refuse(*a, **k):
            raise AssertionError("a fabric leg started")

        monkeypatch.setattr(bench_cli.subprocess, "run", refuse)
        assert bench_cli.main(["fabric"]) == 1
        assert "torch.cuda.is_available() is False" in capsys.readouterr().err
