"""The port's verify fabric (torrent_tpu_torch/fabric), against the
reference.

The reference's tests/test_fabric.py, ported (its bridge routes wait for
the serving slice): deterministic shard planning, scheduler-fed
execution, heartbeat-lapse adoption with sentinel cross-checks, the
Byzantine receipt layer, and the multi-process runs. Those spawn REAL OS
processes through ``python -m torrent_tpu_torch.tools.fabric_verify``
with explicit ``--num-processes/--process-id`` over the shared-directory
heartbeat — the mode that survives a killed worker (a dead peer wedges
any collective; heartbeat files just go stale) — plus one pair over
``AllgatherHeartbeat`` in a gloo process group, whose device planes run
the plain PyTorch SHA-1 (``--hasher gpu --device cpu``).

``TestDifferential`` runs the same library through both packages: plan
fingerprints, receipt roots and audit samples, payload budgets and the
solo executor's bitfields (one reference ``FabricConfig`` carried across
by ``compat.fabric_config_from_reference``) must agree exactly.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.fabric import (
    FAULT_EXIT_CODE,
    FabricConfig,
    FabricExecutor,
    FileHeartbeat,
    adoption_owner,
    build_fabric_executor,
    pack_bits,
    plan_library,
    unpack_bits,
)
from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig
from torrent_tpu_torch.storage.storage import FsStorage, Storage
from torrent_tpu_torch.tools.make_torrent import make_torrent

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLEN = 16384


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def make_library(tmp_path, sizes_pieces, seed=7, corrupt=None):
    """Build an on-disk library: one single-file torrent per entry of
    ``sizes_pieces`` (ragged last piece), optionally corrupting
    ``corrupt=(torrent, piece)`` on disk. Returns (items, torrent_dir,
    data_dir)."""
    rng = np.random.default_rng(seed)
    tdir = tmp_path / "torrents"
    ddir = tmp_path / "data"
    tdir.mkdir()
    items = []
    for t, npieces in enumerate(sizes_pieces):
        root = ddir / f"lib{t}"
        root.mkdir(parents=True)
        size = (npieces - 1) * PLEN + PLEN // 2
        payload = root / "payload.bin"
        payload.write_bytes(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        tf = tdir / f"lib{t}.torrent"
        tf.write_bytes(
            make_torrent(str(payload), "http://t.invalid/announce", piece_length=PLEN, hasher="cpu")
        )
        items.append(tf)
    if corrupt is not None:
        ct, cp = corrupt
        f = ddir / f"lib{ct}" / "payload.bin"
        buf = bytearray(f.read_bytes())
        buf[cp * PLEN + 11] ^= 0xFF
        f.write_bytes(bytes(buf))
    out = []
    for t, tf in enumerate(items):
        meta = parse_metainfo(tf.read_bytes())
        out.append((Storage(FsStorage(str(ddir / f"lib{t}")), meta.info), meta.info))
    return out, tdir, ddir


def cpu_sched():
    return HashPlaneScheduler(
        SchedulerConfig(batch_target=16, flush_deadline=0.01), hasher="cpu"
    )


class TestPlan:
    def _infos(self, tmp_path):
        items, _, _ = make_library(tmp_path, [12, 20, 7, 3])
        return [info for _, info in items]

    def test_deterministic_and_exact_partition(self, tmp_path):
        infos = self._infos(tmp_path)
        p1 = plan_library(infos, 3, unit_bytes=8 * PLEN)
        p2 = plan_library(infos, 3, unit_bytes=8 * PLEN)
        assert p1 == p2
        assert p1.fingerprint() == p2.fingerprint()
        # every piece of every torrent appears in exactly one unit
        for ti, info in enumerate(infos):
            seen = np.zeros(info.num_pieces, dtype=int)
            for u in p1.units:
                if u.torrent == ti:
                    seen[u.start : u.stop] += 1
            assert (seen == 1).all()
        # owners partition the units and byte totals add up
        assert sum(p1.shard_bytes(p) for p in range(3)) == p1.total_bytes
        assert p1.total_bytes == sum(i.length for i in infos)
        assert p1.total_pieces == sum(i.num_pieces for i in infos)

    def test_unit_split_bounds_and_ragged_tail(self, tmp_path):
        infos = self._infos(tmp_path)
        plan = plan_library(infos, 2, unit_bytes=8 * PLEN)
        for u in plan.units:
            assert u.npieces <= 8
            assert u.nbytes <= 8 * PLEN
        # a 20-piece torrent with a ragged tail: 8+8+4 piece spans
        spans = sorted(
            (u.start, u.stop) for u in plan.units if u.torrent == 1
        )
        assert spans == [(0, 8), (8, 16), (16, 20)]
        tail = next(u for u in plan.units if u.torrent == 1 and u.stop == 20)
        assert tail.nbytes == 3 * PLEN + PLEN // 2  # ragged last piece

    def test_balance(self, tmp_path):
        infos = self._infos(tmp_path)
        plan = plan_library(infos, 2, unit_bytes=8 * PLEN)
        loads = [plan.shard_bytes(p) for p in range(2)]
        # LPT bound: no shard exceeds the other by more than one unit
        assert abs(loads[0] - loads[1]) <= max(u.nbytes for u in plan.units)

    def test_fingerprint_tracks_inputs(self, tmp_path):
        infos = self._infos(tmp_path)
        a = plan_library(infos, 2, unit_bytes=8 * PLEN)
        b = plan_library(infos, 3, unit_bytes=8 * PLEN)
        c = plan_library(infos[:-1], 2, unit_bytes=8 * PLEN)
        assert len({a.fingerprint(), b.fingerprint(), c.fingerprint()}) == 3

    def test_adoption_owner_deterministic(self):
        assert adoption_owner(5, [2, 0]) == adoption_owner(5, [0, 2])
        assert adoption_owner(4, [0, 2]) == 0 and adoption_owner(5, [0, 2]) == 2
        with pytest.raises(ValueError):
            adoption_owner(1, [])

    def test_bad_args(self, tmp_path):
        infos = self._infos(tmp_path)
        with pytest.raises(ValueError):
            plan_library(infos, 0)
        with pytest.raises(ValueError):
            plan_library(infos, 2, unit_bytes=0)


class TestPackBits:
    def test_roundtrip(self):
        for n in (1, 7, 8, 9, 64, 129):
            bits = np.random.default_rng(n).integers(0, 2, n).astype(bool)
            assert (unpack_bits(pack_bits(bits), n) == bits).all()

    def test_short_payload_rejected(self):
        with pytest.raises(ValueError):
            unpack_bits("ff", 9)


class TestSoloExecutor:
    def test_matches_verify_library_sched(self, tmp_path):
        """nproc=1 fabric == the plain scheduler session bitfields,
        including a corrupt piece staying False."""
        from torrent_tpu_torch.parallel.bulk import (
            verify_library_fabric,
            verify_library_sched,
        )

        items, _, _ = make_library(tmp_path, [12, 20, 7], corrupt=(1, 5))

        async def go():
            sched = await cpu_sched().start()
            try:
                ref = await verify_library_sched(items, sched)
                res = await verify_library_fabric(
                    items, sched, nproc=1, pid=0, unit_bytes=8 * PLEN
                )
            finally:
                await sched.close()
            return ref, res

        ref, res = run(go())
        for a, b in zip(ref.bitfields, res.bitfields):
            assert (a == b).all()
        assert not res.bitfields[1][5]  # the corrupted piece
        assert int(sum(b.sum() for b in res.bitfields)) == res.n_pieces - 1


class TestInflightBudget:
    def test_unit_larger_than_budget_completes(self, tmp_path):
        """A work unit bigger than max_inflight_bytes must drain its
        oldest launches to free budget instead of deadlocking (releases
        only happen in the unit's own coroutine)."""
        items, _, _ = make_library(tmp_path, [20])

        async def go():
            sched = await HashPlaneScheduler(
                SchedulerConfig(batch_target=2, flush_deadline=0.01),
                hasher="cpu",
            ).start()
            cfg = FabricConfig(max_inflight_bytes=2 * PLEN)  # unit is 8x
            try:
                ex = build_fabric_executor(
                    items, sched, nproc=1, pid=0, config=cfg,
                    unit_bytes=8 * PLEN,
                )
                await ex.run()
            finally:
                await sched.close()
            return ex

        ex = run(go(), timeout=60)
        assert sum(int(b.sum()) for b in ex.bitfields()) == 20
        assert ex.metrics_snapshot()["pieces_verified"] == 20


class TestHeartbeatAdoption:
    def test_lapsed_peer_units_adopted(self, tmp_path):
        """A peer that never heartbeats is lapsed after the grace
        period; its whole shard is adopted and the sweep completes."""
        items, _, _ = make_library(tmp_path, [12, 20, 7])

        async def go():
            sched = await cpu_sched().start()
            cfg = FabricConfig(heartbeat_interval=0.05, lapse_after=0.3)
            try:
                ex = build_fabric_executor(
                    items, sched, nproc=2, pid=0,
                    heartbeat_dir=str(tmp_path / "hb"),
                    config=cfg, unit_bytes=8 * PLEN,
                )
                await ex.run()
            finally:
                await sched.close()
            return ex

        ex = run(go())
        snap = ex.metrics_snapshot()
        assert snap["units_adopted"] == len(ex.plan.units_for(1))
        assert snap["units_adopted"] >= 1
        total = sum(int(b.sum()) for b in ex.bitfields())
        assert total == ex.plan.total_pieces

    def test_both_alive_split_and_identical_bitfields(self, tmp_path):
        """Two in-process executors over one heartbeat dir: no adoption,
        work split per plan, and both assemble the identical global
        view (with the corrupt piece False in both)."""
        items1, _, _ = make_library(tmp_path, [12, 20, 7], corrupt=(1, 5))
        # separate Storage handles per "process", same underlying files
        items2 = [
            (Storage(FsStorage(s.method.root), info), info)
            for (s, info) in items1
        ]

        async def go():
            s0 = await cpu_sched().start()
            s1 = await cpu_sched().start()
            cfg = FabricConfig(heartbeat_interval=0.05, lapse_after=3.0)
            try:
                e0 = build_fabric_executor(
                    items1, s0, nproc=2, pid=0,
                    heartbeat_dir=str(tmp_path / "hb"), config=cfg,
                    unit_bytes=8 * PLEN,
                )
                e1 = build_fabric_executor(
                    items2, s1, nproc=2, pid=1,
                    heartbeat_dir=str(tmp_path / "hb"), config=cfg,
                    unit_bytes=8 * PLEN,
                )
                await asyncio.gather(e0.run(), e1.run())
            finally:
                await s0.close()
                await s1.close()
            return e0, e1

        e0, e1 = run(go())
        assert e0.plan.fingerprint() == e1.plan.fingerprint()
        for a, b in zip(e0.bitfields(), e1.bitfields()):
            assert (a == b).all()
        assert not e0.bitfields()[1][5]
        s0, s1 = e0.metrics_snapshot(), e1.metrics_snapshot()
        assert s0["units_adopted"] == s1["units_adopted"] == 0
        assert s0["units_done"] == len(e0.plan.units_for(0))
        assert s1["units_done"] == len(e1.plan.units_for(1))

    def test_sentinel_mismatch_rejects_poisoned_verdicts(self, tmp_path):
        """A dead peer whose published verdicts claim a corrupt piece
        is valid must be caught by the sentinel re-hash: its verdicts
        are discarded, the unit re-verified locally, and the mismatch
        counted."""
        items, _, _ = make_library(tmp_path, [12, 20, 7], corrupt=(1, 8))

        async def go():
            sched = await cpu_sched().start()
            cfg = FabricConfig(heartbeat_interval=0.05, lapse_after=0.4)
            hb_dir = str(tmp_path / "hb")
            try:
                ex = build_fabric_executor(
                    items, sched, nproc=2, pid=0, heartbeat_dir=hb_dir,
                    config=cfg, unit_bytes=8 * PLEN,
                )
                # forge peer 1's heartbeat: every unit it owns claimed
                # done with ALL-TRUE verdicts (the lie covers torrent
                # 1's corrupted piece 8). The stale timestamp makes the
                # peer lapse immediately, so the verdicts arrive via
                # the adoption path and get sentinel-checked. Pick a
                # unit whose FIRST reportedly-valid piece is the
                # corrupt one so one sentinel is enough to catch it.
                lying_units = {}
                for u in ex.plan.units_for(1):
                    lying_units[str(u.uid)] = pack_bits(
                        np.ones(u.npieces, dtype=bool)
                    )
                FileHeartbeat(hb_dir, 1).exchange(
                    {
                        "pid": 1, "seq": 1, "t": time.time() - 60,
                        "fp": ex.plan.fingerprint(), "degraded": False,
                        "done": lying_units, "inflight": [], "distrust": [],
                    }
                )
                # clock-rewind (the breaker tests' trick, no sleeps):
                # peer 1's seq last advanced "long ago", so it is
                # lapsed from the very first exchange and its verdicts
                # must take the sentinel-gated adoption path
                ex._peer_advance[1] = (1, time.monotonic() - 999)
                await ex.run()
            finally:
                await sched.close()
            return ex

        ex = run(go())
        snap = ex.metrics_snapshot()
        # the corrupt piece lives in a unit owned by peer 1 or peer 0;
        # either way the lie about it must not survive into the output
        bf = ex.bitfields()
        assert not bf[1][8], "poisoned verdict leaked into the global bitfield"
        owner = next(
            ex.plan.owner[u.uid]
            for u in ex.plan.units
            if u.torrent == 1 and u.start <= 8 < u.stop
        )
        if owner == 1:
            assert snap["sentinel_mismatches"] >= 1
        assert snap["sentinel_checks"] >= 1
        # everything else still verified
        total = sum(int(b.sum()) for b in bf)
        assert total == ex.plan.total_pieces - 1

    def test_degraded_peer_unstarted_units_adopted(self, tmp_path):
        """A peer publishing degraded=True (breaker stuck open) keeps
        its in-flight work but its unstarted units are adopted."""
        items, _, _ = make_library(tmp_path, [12, 20, 7])

        async def go():
            sched = await cpu_sched().start()
            cfg = FabricConfig(heartbeat_interval=0.05, lapse_after=30.0)
            hb_dir = str(tmp_path / "hb")
            try:
                ex = build_fabric_executor(
                    items, sched, nproc=2, pid=0, heartbeat_dir=hb_dir,
                    config=cfg, unit_bytes=8 * PLEN,
                )
                hb1 = FileHeartbeat(hb_dir, 1)
                stop = asyncio.Event()

                async def degraded_peer():
                    # alive (fresh heartbeats) but degraded, nothing done
                    while not stop.is_set():
                        hb1.exchange(
                            {
                                "pid": 1, "seq": 1, "t": time.time(),
                                "fp": ex.plan.fingerprint(),
                                "degraded": True, "done": {},
                                "inflight": [], "distrust": [],
                            }
                        )
                        await asyncio.sleep(0.05)

                peer = asyncio.ensure_future(degraded_peer())
                try:
                    await ex.run()
                finally:
                    stop.set()
                    await peer
            finally:
                await sched.close()
            return ex

        ex = run(go())
        snap = ex.metrics_snapshot()
        assert snap["units_adopted"] == len(ex.plan.units_for(1))
        assert sum(int(b.sum()) for b in ex.bitfields()) == ex.plan.total_pieces

    def test_fabric_tenant_registered_low_priority(self, tmp_path):
        items, _, _ = make_library(tmp_path, [6])

        async def go():
            sched = await cpu_sched().start()
            try:
                ex = build_fabric_executor(
                    items, sched, nproc=1, pid=0, unit_bytes=8 * PLEN
                )
                await ex.run()
                snap = sched.metrics_snapshot()
            finally:
                await sched.close()
            return snap

        snap = run(go())
        assert snap["tenants"]["fabric"]["weight"] == 0.25
        assert snap["tenants"]["fabric"]["served_pieces"] == 6


def _spawn_workers(tdir, ddir, tmp_path, nproc, extra_by_pid=None, transport=None):
    """Spawn fabric_verify workers, over the file heartbeat transport
    unless ``transport`` (argv naming another) is given, killing every
    handle on any error path."""
    env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    hb = str(tmp_path / "hb")
    workers = []
    for p in range(nproc):
        cmd = [
            sys.executable, "-m", "torrent_tpu_torch.tools.fabric_verify",
            str(tdir), str(ddir),
            "--num-processes", str(nproc), "--process-id", str(p),
            "--heartbeat-interval", "0.1", "--lapse-after", "1.5",
            "--unit-mb", "1", "--batch-target", "32",
            "--result-file", str(tmp_path / f"result_{p}.json"),
        ] + (transport or ["--hasher", "cpu", "--heartbeat-dir", hb]) + (extra_by_pid or {}).get(p, [])
        workers.append(
            subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
            )
        )
    rcs, errs = [], []
    try:
        for p, w in enumerate(workers):
            _, err = w.communicate(timeout=240)
            rcs.append(w.returncode)
            errs.append(err)
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.communicate()
    return rcs, errs


class TestTwoProcessFabric:
    def test_smoke_matches_single_process_sched(self, tmp_path):
        """The two-process fabric bitfield is
        identical to the single-process verify_library_sched bitfield
        on the same library — on BOTH workers."""
        from torrent_tpu_torch.parallel.bulk import verify_library_sched

        # 96+160 pieces at 16 KiB = 5 one-MiB units over 2 processes
        items, tdir, ddir = make_library(
            tmp_path, [96, 160], corrupt=(1, 70)
        )

        async def ref():
            sched = await cpu_sched().start()
            try:
                return await verify_library_sched(items, sched)
            finally:
                await sched.close()

        expected = [
            "".join("1" if b else "0" for b in bf)
            for bf in run(ref()).bitfields
        ]
        assert expected[1][70] == "0" and sum(r.count("0") for r in expected) == 1

        rcs, errs = _spawn_workers(tdir, ddir, tmp_path, 2)
        # rc 2 = completed with invalid pieces (the corrupt one) — both
        # workers must COMPLETE, and agree with the reference
        assert rcs == [2, 2], errs
        recs = [
            json.loads((tmp_path / f"result_{p}.json").read_text())
            for p in range(2)
        ]
        for rec in recs:
            assert rec["bitfields"] == expected
            assert rec["n_valid"] == rec["n_pieces"] - 1
            assert rec["units_adopted"] == 0
        assert recs[0]["plan"] == recs[1]["plan"]
        # the work was actually split: both processes verified pieces
        assert all(r["pieces_verified"] > 0 for r in recs)
        assert recs[0]["pieces_verified"] + recs[1]["pieces_verified"] == 256

    def test_killed_worker_adoption_exactly_once(self, tmp_path):
        """Killing one worker mid-run still completes
        with every piece verified exactly once — the dead worker's
        published unit counts once, the survivor covers the orphaned
        rest, and the sentinel cross-check runs on the adopted
        verdicts."""
        items, tdir, ddir = make_library(tmp_path, [96, 160], seed=11)
        total = sum(info.num_pieces for _, info in items)

        rcs, errs = _spawn_workers(
            tdir, ddir, tmp_path, 2,
            extra_by_pid={1: ["--die-after-units", "1"]},
        )
        assert rcs[0] == 0, errs[0]
        assert rcs[1] == FAULT_EXIT_CODE, errs[1]
        rec = json.loads((tmp_path / "result_0.json").read_text())
        # complete global view despite the death
        assert rec["n_valid"] == rec["n_pieces"] == total
        assert all(set(bf) == {"1"} for bf in rec["bitfields"])
        assert rec["units_adopted"] >= 1
        # exactly once: survivor's verified pieces + the dead worker's
        # ONE published unit cover the library with no overlap
        dead_published = total - rec["pieces_verified"]
        assert dead_published > 0, "worker 1 published nothing before dying"
        assert rec["units_done"] == rec["shard_units"] + rec["units_adopted"]
        # the dead worker's published verdicts were sentinel-checked
        assert rec["sentinel_checks"] >= 1
        assert rec["sentinel_mismatches"] == 0


    def test_allgather_heartbeat_over_gloo(self, tmp_path):
        """Two ranks of a gloo process group exchange heartbeats through
        AllgatherHeartbeat (one all-gather a round, lock-step) while
        each hashes its shard on its device planes (the plain PyTorch
        SHA-1 here): both give the single-process bitfields, split the
        work, and no launch falls back or fails."""
        from torrent_tpu_torch.parallel.bulk import verify_library_sched

        items, tdir, ddir = make_library(tmp_path, [40, 56], seed=23, corrupt=(0, 33))

        async def ref():
            sched = await cpu_sched().start()
            try:
                return await verify_library_sched(items, sched)
            finally:
                await sched.close()

        expected = ["".join("1" if b else "0" for b in bf) for bf in run(ref()).bitfields]
        assert expected[0][33] == "0" and sum(r.count("0") for r in expected) == 1
        init = ["--init-method", f"tcp://127.0.0.1:{free_port()}", "--backend", "gloo",
                "--hasher", "gpu", "--device", "cpu"]
        rcs, errs = _spawn_workers(tdir, ddir, tmp_path, 2, transport=init)
        assert rcs == [2, 2], errs
        recs = [json.loads((tmp_path / f"result_{p}.json").read_text()) for p in range(2)]
        for rec in recs:
            assert rec["bitfields"] == expected
            assert rec["units_adopted"] == 0
            assert rec["sched"]["launches"] > 0
            assert rec["sched"]["cpu_fallback_launches"] == rec["sched"]["launch_failures"] == 0
        assert recs[0]["plan"] == recs[1]["plan"]
        assert all(r["pieces_verified"] > 0 for r in recs)
        assert recs[0]["pieces_verified"] + recs[1]["pieces_verified"] == 96

    def test_collective_transport_needs_a_live_group(self, tmp_path):
        """Without a process group of nproc ranks the all-gather
        transport would hang its first round: it raises up front."""
        items, _, _ = make_library(tmp_path, [6])
        with pytest.raises(ValueError, match="process group of 2 ranks"):
            build_fabric_executor(items, cpu_sched(), nproc=2, pid=0, unit_bytes=8 * PLEN)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class TestByzantineReceipts:
    """The Byzantine verdict layer: f = 0 heartbeat
    bit-identity, receipt roots/proofs at f > 0, and the multi-process
    forger conviction acceptance."""

    # every key a pre-receipt (f = 0) heartbeat carries — the pin: the
    # receipt plane must add NOTHING here, so f = 0 exchanged bytes are
    # identical to the pre-PR fabric
    LEGACY_KEYS = {
        "pid", "seq", "t", "fp", "span", "degraded", "done",
        "inflight", "distrust", "redone", "offer", "obs",
    }

    def _spy(self, ex, seen):
        orig = ex.transport.exchange

        def exchange(payload):
            seen.append(payload)
            return orig(payload)

        ex.transport.exchange = exchange

    def _run_pair(self, tmp_path, cfg, corrupt=None):
        items1, _, _ = make_library(tmp_path, [12, 20, 7], corrupt=corrupt)
        items2 = [
            (Storage(FsStorage(s.method.root), info), info)
            for (s, info) in items1
        ]
        seen0, seen1 = [], []

        async def go():
            s0 = await cpu_sched().start()
            s1 = await cpu_sched().start()
            try:
                e0 = build_fabric_executor(
                    items1, s0, nproc=2, pid=0,
                    heartbeat_dir=str(tmp_path / "hb"), config=cfg,
                    unit_bytes=8 * PLEN,
                )
                e1 = build_fabric_executor(
                    items2, s1, nproc=2, pid=1,
                    heartbeat_dir=str(tmp_path / "hb"), config=cfg,
                    unit_bytes=8 * PLEN,
                )
                self._spy(e0, seen0)
                self._spy(e1, seen1)
                await asyncio.gather(e0.run(), e1.run())
            finally:
                await s0.close()
                await s1.close()
            return e0, e1

        e0, e1 = run(go())
        return e0, e1, seen0, seen1

    def test_f0_heartbeat_keys_and_payload_budget_pinned(self, tmp_path):
        """byzantine_f = 0 is bit-identical to the
        pre-receipt fabric — no receipt keys ever reach the exchanged
        bytes, and the allgather buffer budget is unchanged."""
        cfg = FabricConfig(heartbeat_interval=0.05, lapse_after=3.0)
        e0, e1, seen0, seen1 = self._run_pair(tmp_path, cfg)
        assert seen0 and seen1
        for payload in seen0 + seen1:
            assert set(payload) <= self.LEGACY_KEYS
            assert "root" not in payload and "evid" not in payload
        # the f = 0 default leaves every existing caller's buffer
        # sizing byte-identical
        from torrent_tpu_torch.fabric import plan_payload_bytes

        assert plan_payload_bytes(e0.plan) == plan_payload_bytes(
            e0.plan, byzantine_f=0
        )
        assert plan_payload_bytes(e0.plan, byzantine_f=1) > plan_payload_bytes(
            e0.plan
        )
        snap = e0.metrics_snapshot()
        assert snap["quorum_need"] == 1
        assert snap["audit_checks"] == snap["convictions"] == 0

    def test_f1_receipts_ride_heartbeat_and_audits_pass(self, tmp_path):
        """Two HONEST processes at f = 1: receipt roots and (empty)
        evidence ride every heartbeat, full-rate audits all match,
        nobody is convicted, and the shared view still rejects the
        genuinely corrupt piece."""
        cfg = FabricConfig(
            heartbeat_interval=0.05, lapse_after=3.0,
            byzantine_f=1, audit_rate=1.0,
        )
        e0, e1, seen0, seen1 = self._run_pair(
            tmp_path, cfg, corrupt=(1, 5)
        )
        rooted = [p for p in seen0 + seen1 if "root" in p]
        assert rooted, "no heartbeat ever carried a receipt root"
        for payload in seen0 + seen1:
            assert "evid" in payload  # present (and empty: all honest)
            assert payload["evid"] == []
        for a, b in zip(e0.bitfields(), e1.bitfields()):
            assert (a == b).all()
        assert not e0.bitfields()[1][5]
        for ex in (e0, e1):
            snap = ex.metrics_snapshot()
            assert snap["quorum_need"] == 2
            assert snap["audit_checks"] >= 1
            assert snap["audit_mismatches"] == 0
            assert snap["convictions"] == 0
            assert snap["distrusted"] == []

    def test_receipt_proof_roundtrips_and_rejects_tampering(self, tmp_path):
        """receipt_proof serves a bounded proof that verifies against
        the published root; any tampered field fails verification; the
        guards reject unknown units and out-of-span pieces."""
        from torrent_tpu_torch.fabric import verify_proof

        cfg = FabricConfig(
            heartbeat_interval=0.05, lapse_after=3.0,
            byzantine_f=1, audit_rate=1.0,
        )
        e0, _, _, _ = self._run_pair(tmp_path, cfg, corrupt=(1, 5))
        unit = e0.plan.units_for(0)[0]
        uid = unit.uid
        for piece in (unit.start, unit.stop - 1):
            pr = e0.receipt_proof(uid, piece)
            assert verify_proof(
                bytes.fromhex(pr["leaf"]), pr["index"],
                pr["nleaves"], pr["path"], pr["root"],
            )
            # single-field tampering: flipped leaf byte, wrong index,
            # truncated path — none may verify
            bad_leaf = bytes.fromhex(pr["leaf"])
            bad_leaf = bytes([bad_leaf[0] ^ 1]) + bad_leaf[1:]
            assert not verify_proof(
                bad_leaf, pr["index"], pr["nleaves"], pr["path"], pr["root"]
            )
            if pr["nleaves"] > 1:
                assert not verify_proof(
                    bytes.fromhex(pr["leaf"]), pr["index"],
                    pr["nleaves"], pr["path"][:-1], pr["root"],
                )
        with pytest.raises(IndexError):
            e0.receipt_proof(uid, unit.stop)
        with pytest.raises(KeyError):
            e0.receipt_proof(10**9, 0)

    def test_three_process_forger_convicted_on_every_process(self, tmp_path):
        """byzantine_f = 1, three processes, one
        forging receipts — the run completes with identical correct
        bitfields on the honest processes, and the forger is convicted
        via receipt evidence on EVERY process (symmetric verdicts)."""
        items, tdir, ddir = make_library(tmp_path, [96, 160], seed=13)
        total = sum(info.num_pieces for _, info in items)
        # the forger lies by claiming its WHOLE shard verified-ok, so
        # the lie is only a lie if a corrupt piece lands in ITS shard:
        # plan deterministically (same inputs as the workers) and
        # corrupt the first piece of pid 2's first unit on disk
        plan = plan_library(
            [info for _, info in items], nproc=3, unit_bytes=1 << 20
        )
        bad_unit = plan.units_for(2)[0]
        bad_piece = bad_unit.start + 1
        f = ddir / f"lib{bad_unit.torrent}" / "payload.bin"
        buf = bytearray(f.read_bytes())
        buf[bad_piece * PLEN + 11] ^= 0xFF
        f.write_bytes(bytes(buf))
        byz = ["--byzantine-f", "1", "--audit-rate", "1.0"]
        rcs, errs = _spawn_workers(
            tdir, ddir, tmp_path, 3,
            extra_by_pid={
                0: byz, 1: byz,
                2: byz + ["--fault-plan", "forge_receipts=1"],
            },
        )
        # rc 2 = completed with the one invalid piece — every process
        # COMPLETES, forger included (exit-code parity)
        assert rcs == [2, 2, 2], errs
        recs = [
            json.loads((tmp_path / f"result_{p}.json").read_text())
            for p in range(3)
        ]
        for rec in recs:
            assert rec["byzantine_f"] == 1 and rec["quorum_need"] == 2
            # symmetric termination: all three convicted the forger
            assert 2 in rec["distrusted"], rec
            assert rec["convictions"] >= 1
        honest = recs[:2]
        assert honest[0]["bitfields"] == honest[1]["bitfields"]
        assert honest[0]["n_valid"] == honest[0]["n_pieces"] - 1 == total - 1
        # the forger claimed the corrupt piece ok; the honest view
        # rejects it anyway
        assert honest[0]["bitfields"][bad_unit.torrent][bad_piece] == "0"
        # the audits actually ran — and caught the forged claim
        assert any(r["audit_checks"] >= 1 for r in honest)
        assert any(r["audit_mismatches"] >= 1 for r in honest)


class TestFabricMetricsRender:
    def test_render_fabric_metrics(self):
        from torrent_tpu_torch.utils.metrics import render_fabric_metrics

        snap = {
            "state": "running", "pid": 3, "nproc": 8,
            "plan_fingerprint": "abc", "units_total": 10, "shard_units": 2,
            "shard_bytes": 1 << 20, "units_done": 1, "units_adopted": 1,
            "pieces_verified": 64, "inflight_bytes": 4096,
            "sentinel_checks": 2, "sentinel_mismatches": 1, "stragglers": 0,
            "heartbeat_errors": 0, "heartbeat_age": 0.25, "degraded": True,
        }
        text = render_fabric_metrics(snap)
        assert 'torrent_tpu_fabric_state{pid="3"} 1' in text
        assert 'torrent_tpu_fabric_units{pid="3",kind="adopted"} 1' in text
        assert 'torrent_tpu_fabric_sentinel_mismatches_total{pid="3"} 1' in text
        assert 'torrent_tpu_fabric_degraded{pid="3"} 1' in text
        assert 'torrent_tpu_fabric_heartbeat_age_seconds{pid="3"} 0.250' in text


class TestDifferential:
    """The same library through both packages."""

    def _both(self, tmp_path, sizes, corrupt=None):
        from torrent_tpu.codec.metainfo import parse_metainfo as ref_parse
        from torrent_tpu.storage.storage import FsStorage as RefFs, Storage as RefStorage

        items, tdir, ddir = make_library(tmp_path, sizes, corrupt=corrupt)
        ref_items = []
        for t, (_, info) in enumerate(items):
            meta = ref_parse((tdir / f"lib{t}.torrent").read_bytes())
            ref_items.append((RefStorage(RefFs(str(ddir / f"lib{t}")), meta.info), meta.info))
        return items, ref_items

    def test_plans_fingerprints_and_budgets_agree(self, tmp_path):
        from torrent_tpu.fabric import plan_library as ref_plan, plan_payload_bytes as ref_budget

        from torrent_tpu_torch.fabric import plan_payload_bytes

        items, ref_items = self._both(tmp_path, [12, 20, 7, 3])
        for nproc in (1, 2, 3, 5):
            for unit in (3 * PLEN, 8 * PLEN, 1 << 20):
                mine = plan_library([i for _, i in items], nproc, unit_bytes=unit)
                ref = ref_plan([i for _, i in ref_items], nproc, unit_bytes=unit)
                assert mine.fingerprint() == ref.fingerprint()
                assert [(u.uid, u.torrent, u.start, u.stop, u.nbytes) for u in mine.units] == [
                    (u.uid, u.torrent, u.start, u.stop, u.nbytes) for u in ref.units
                ]
                assert list(mine.owner) == list(ref.owner)
                for f in (0, 1, 2):
                    assert plan_payload_bytes(mine, f) == ref_budget(ref, f)

    def test_receipts_and_audit_samples_agree(self, tmp_path):
        from torrent_tpu.fabric import (
            audit_sample as ref_audit,
            merkle_proof as ref_proof,
            merkle_root as ref_root,
            unit_leaves as ref_leaves,
        )

        from torrent_tpu_torch.fabric import audit_sample, merkle_proof, merkle_root, unit_leaves

        items, ref_items = self._both(tmp_path, [12, 20])
        plan = plan_library([i for _, i in items], 2, unit_bytes=8 * PLEN)
        rng = np.random.default_rng(3)
        for u in plan.units:
            info, ref_info = items[u.torrent][1], ref_items[u.torrent][1]
            verdicts = rng.integers(0, 2, u.npieces).astype(bool)
            digests = [d.hex() for d in info.pieces[u.start : u.stop]]
            ref_digests = [d.hex() for d in ref_info.pieces[u.start : u.stop]]
            mine = unit_leaves(u.uid, u.start, verdicts, digests)
            ref = ref_leaves(u.uid, u.start, verdicts, ref_digests)
            assert mine == ref
            assert merkle_root(mine) == ref_root(ref)
            for i in (0, len(mine) - 1):
                assert merkle_proof(mine, i) == ref_proof(ref, i)
            for rnd in range(3):
                for piece in range(u.start, u.stop):
                    args = (plan.fingerprint(), 7, rnd, 1, u.uid, piece, 0.3)
                    assert audit_sample(*args) == ref_audit(*args)

    def test_solo_executor_bitfields_agree(self, tmp_path):
        from torrent_tpu.fabric import (
            FabricConfig as RefFabricConfig,
            build_fabric_executor as ref_build,
        )
        from torrent_tpu.sched import (
            HashPlaneScheduler as RefScheduler,
            SchedulerConfig as RefSchedulerConfig,
        )

        from torrent_tpu_torch.compat import fabric_config_from_reference, scheduler_config_from_reference

        items, ref_items = self._both(tmp_path, [12, 20, 7], corrupt=(1, 5))
        ref_cfg = RefFabricConfig(max_inflight_bytes=4 * PLEN, heartbeat_interval=0.05)
        ref_sched_cfg = RefSchedulerConfig(batch_target=16, flush_deadline=0.01)
        cfg = fabric_config_from_reference(ref_cfg)
        assert cfg == FabricConfig(max_inflight_bytes=4 * PLEN, heartbeat_interval=0.05)

        async def go(build, its, sched, config):
            await sched.start()
            try:
                ex = build(its, sched, nproc=1, pid=0, config=config, unit_bytes=8 * PLEN)
                await ex.run()
            finally:
                await sched.close()
            return ex

        ref = run(go(ref_build, ref_items, RefScheduler(ref_sched_cfg, hasher="cpu"), ref_cfg))
        mine = run(go(
            build_fabric_executor, items,
            HashPlaneScheduler(scheduler_config_from_reference(ref_sched_cfg), hasher="gpu", device="cpu"),
            cfg,
        ))
        for a, b in zip(ref.bitfields(), mine.bitfields()):
            assert (a == b).all()
        assert not mine.bitfields()[1][5]
        keys = ("units_total", "shard_units", "units_done", "pieces_verified", "quorum_need")
        assert {k: mine.metrics_snapshot()[k] for k in keys} == {k: ref.metrics_snapshot()[k] for k in keys}
        assert mine.metrics_snapshot()["plan_fingerprint"] == ref.metrics_snapshot()["plan_fingerprint"]
