"""The port's continuous-batching hash-plane scheduler
(torrent_tpu_torch/sched), against hashlib and against the reference.

The reference's tests/test_sched.py, ported: the multi-tenant verify
queue is deterministic on the CPU, so every case runs with the hashlib
plane or the device planes on ``device="cpu"`` (the plain PyTorch SHA-1
and SHA-256) — cross-request coalescing to ≥0.9 batch fill, deadline
flush for lone small requests, DRR fairness under a greedy + trickle
tenant pair, typed load-shed, and CPU-path parity. The cases that need
the bridge, the session client or ``doctor``, and the pallas
tile-snapping cases, are not ported (ROADMAP.md lists them).

``TestDifferential`` then drives the reference's scheduler (JAX on the
CPU, as its own tests run it) and this one with the same seeded
payloads and one reference ``SchedulerConfig`` carried across by
``compat.scheduler_config_from_reference``: digests, lane geometry,
counters, snapshot keys, ledger stages and full rechecks must agree
exactly.
"""

from __future__ import annotations

import asyncio
import hashlib
import time

import numpy as np
import pytest

from torrent_tpu_torch.codec.bencode import bdecode, bencode
from torrent_tpu_torch.sched import HashPlaneScheduler, SchedRejected, SchedulerConfig


def run(coro, timeout: float = 120.0):
    # a stuck lane fails its test instead of hanging the suite
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _pieces(n: int, plen: int = 1024, salt: int = 0) -> list[bytes]:
    return [bytes([(i + salt) % 251]) * plen for i in range(n)]


class _StallPlane:
    """Test plane that blocks until released — pins queue bytes so
    admission-control behaviour is deterministic, no timing involved."""

    def __init__(self):
        import threading

        self.release = threading.Event()

    def run(self, payloads):
        self.release.wait(timeout=30)
        return [hashlib.sha1(p).digest() for p in payloads]


class TestTenantCardinality:
    def test_idle_auto_tenants_are_evicted(self):
        """Fresh tenant names per request (attacker-controlled X-Tenant)
        must not grow per-tenant state without bound: idle auto-registered
        tenants beyond max_idle_tenants are evicted, pinned ones kept."""

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=4, flush_deadline=0.01, max_idle_tenants=8
                ),
                hasher="cpu",
            )
            try:
                sched.register_tenant("pinned", weight=0.5)
                for j in range(50):
                    got = await sched.submit(f"rnd{j}", _pieces(1, 256, salt=j))
                    assert got == [hashlib.sha1(p).digest() for p in _pieces(1, 256, salt=j)]
                snap = sched.metrics_snapshot()
                assert len(snap["tenants"]) <= 8 + 1, len(snap["tenants"])
                assert "pinned" in snap["tenants"]
                evicted = snap["evicted"]
                assert evicted["tenants"] >= 40
                # served totals stay monotonic across eviction
                live_pieces = sum(
                    t["served_pieces"] for t in snap["tenants"].values()
                )
                assert live_pieces + evicted["served_pieces"] == 50
                # rotation/queues shrink with the tenants
                for lane in sched._lanes.values():
                    assert len(lane.rotation) == len(lane.queues) <= 9
            finally:
                await sched.close()

        run(go())


class TestStagingReuse:
    def test_reused_slots_zero_stale_tails(self):
        """The SHA-1 device plane reuses staging slots across launches;
        pad_in_place needs zeroed tails, so a long-piece launch followed
        by shorter pieces in the same slot must still hash correctly
        (stale-tail zeroing, the classic staging-reuse corruption)."""

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=4, flush_deadline=0.01),
                hasher="gpu", device="cpu",  # the device plane (plain torch) w/ slots
            )
            try:
                # launch 1: full-bucket pieces dirty the whole slot rows
                long = [bytes([i]) * 4096 for i in range(4)]
                got = await sched.submit("t", long, piece_length=4096)
                assert got == [hashlib.sha1(p).digest() for p in long]
                # launch 2, same lane: much shorter pieces — stale bytes
                # beyond each message must not leak into the hash
                short = [bytes([0x55 + i]) * 100 for i in range(4)]
                got = await sched.submit("t", short, piece_length=4096)
                assert got == [hashlib.sha1(p).digest() for p in short]
                # launch 3: ragged mix, including empty-ish rows
                mix = [b"x", b"y" * 2000, b"", b"z" * 4096]
                got = await sched.submit("t", mix, piece_length=4096)
                assert got == [hashlib.sha1(p).digest() for p in mix]
            finally:
                await sched.close()

        run(go())

    def test_pipelined_launches_stay_correct(self):
        """pipeline_depth=2 runs launches concurrently in worker threads;
        many batches of distinct payloads through one lane must demux to
        the right submitters."""

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=8, flush_deadline=0.01, pipeline_depth=2
                ),
                hasher="gpu", device="cpu",
            )
            try:
                outs = await asyncio.gather(
                    *(
                        sched.submit("t", _pieces(8, 512, salt=j), piece_length=512)
                        for j in range(12)
                    )
                )
                for j, got in enumerate(outs):
                    assert got == [
                        hashlib.sha1(p).digest() for p in _pieces(8, 512, salt=j)
                    ], f"submission {j} demuxed wrong"
            finally:
                await sched.close()

        run(go())


class TestParity:
    @pytest.mark.parametrize("hasher", ["cpu", "gpu"])
    def test_digests_match_hashlib(self, hasher):
        """CPU-path fallback parity: same results from the hashlib plane
        and the device plane (plain torch here), both vs hashlib."""

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=16, flush_deadline=0.01), hasher=hasher, device="cpu"
            )
            try:
                pieces = _pieces(23, 700)  # ragged: crosses batch_target
                got = await sched.submit("t", pieces, algo="sha1")
                assert got == [hashlib.sha1(p).digest() for p in pieces]
            finally:
                await sched.close()

        run(go())

    @pytest.mark.parametrize("hasher", ["cpu", "gpu"])
    def test_verify_mode_flags(self, hasher):
        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=8, flush_deadline=0.01), hasher=hasher, device="cpu"
            )
            try:
                pieces = _pieces(10, 300)
                expected = [hashlib.sha1(p).digest() for p in pieces]
                expected[4] = b"\x00" * 20
                ok = await sched.submit("t", pieces, expected=expected)
                assert isinstance(ok, bytes) and len(ok) == 10
                assert ok[4] == 0 and all(ok[i] == 1 for i in range(10) if i != 4)
            finally:
                await sched.close()

        run(go())

    def test_sha256_lane(self):
        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=8, flush_deadline=0.01), hasher="cpu"
            )
            try:
                pieces = _pieces(5, 200)
                got = await sched.submit("t", pieces, algo="sha256")
                assert got == [hashlib.sha256(p).digest() for p in pieces]
            finally:
                await sched.close()

        run(go())

    def test_empty_submission(self):
        async def go():
            sched = HashPlaneScheduler(hasher="cpu")
            try:
                assert await sched.submit("t", []) == []
                assert await sched.submit("t", [], expected=[]) == b""
            finally:
                await sched.close()

        run(go())


class TestAssembler:
    def test_deadline_flush_for_lone_small_request(self):
        """A lone 4-piece request must never be stranded behind a big
        batch target: the deadline timer flushes it."""

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=256, flush_deadline=0.05), hasher="cpu"
            )
            try:
                t0 = time.monotonic()
                pieces = _pieces(4)
                got = await asyncio.wait_for(sched.submit("lone", pieces), 5)
                elapsed = time.monotonic() - t0
                assert got == [hashlib.sha1(p).digest() for p in pieces]
                snap = sched.metrics_snapshot()
                assert snap["flush_reasons"]["deadline"] == 1
                assert snap["flush_reasons"]["full"] == 0
                assert elapsed < 3.0
            finally:
                await sched.close()

        run(go())

    def test_cross_request_coalescing_fills_batches(self):
        """≥8 concurrent submitters of small piece counts reach a mean
        batch-fill ratio ≥0.9 of the configured target."""

        async def go():
            target = 64
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=target, flush_deadline=0.5), hasher="cpu"
            )
            try:
                # 8 tenants × 32 pieces = 4 exactly-full launches
                outs = await asyncio.gather(
                    *(
                        sched.submit(f"client{j}", _pieces(32, salt=j))
                        for j in range(8)
                    )
                )
                for j, got in enumerate(outs):
                    want = [hashlib.sha1(p).digest() for p in _pieces(32, salt=j)]
                    assert got == want
                snap = sched.metrics_snapshot()
                assert snap["launches"] >= 1
                assert snap["mean_fill"] >= 0.9, snap
                assert snap["flush_reasons"]["full"] >= 1
            finally:
                await sched.close()

        run(go())

    def test_shutdown_flushes_pending(self):
        """close() launches what's queued (reason 'shutdown') instead of
        dropping it."""

        async def go():
            sched = HashPlaneScheduler(
                # deadline far beyond the test: only shutdown can flush
                SchedulerConfig(batch_target=1024, flush_deadline=60.0),
                hasher="cpu",
            )
            pieces = _pieces(3)
            fut = await sched.enqueue("t", pieces)
            await sched.close()
            got = await asyncio.wait_for(fut, 5)
            assert got == [hashlib.sha1(p).digest() for p in pieces]
            assert sched.metrics_snapshot()["flush_reasons"]["shutdown"] == 1

        run(go())

    def test_geometry_lanes_are_separate(self):
        """Different piece-length buckets get their own lanes (the
        geometry-grouped compile cache), same algo."""

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=4, flush_deadline=0.01), hasher="cpu"
            )
            try:
                a = await sched.submit("t", _pieces(4, 512))
                b = await sched.submit("t", _pieces(4, 100_000))
                assert a and b
                assert sched.metrics_snapshot()["lanes"] == 2
            finally:
                await sched.close()

        run(go())


class TestFairnessAndBackpressure:
    def test_greedy_plus_trickle_tenant(self):
        """Acceptance: under a saturating tenant plus a trickle
        tenant, the trickle tenant completes without timeout and the
        greedy tenant observes backpressure (shed) — deterministic, no
        GPU, no sleeps in the assertion path."""

        async def go():
            stall = _StallPlane()
            cfg = SchedulerConfig(
                batch_target=8,
                flush_deadline=0.02,
                max_queue_bytes=64 << 10,
                max_tenant_bytes=16 << 10,
                drr_quantum=2048,  # small quantum → per-pass interleave
                plane_factory=lambda a, b, t: stall,
            )
            sched = HashPlaneScheduler(cfg, hasher="cpu")
            try:
                # greedy saturates: keeps submitting until admission
                # control sheds it (its queue bound is 16 KiB)
                greedy_futs = []
                shed = 0
                for i in range(64):
                    try:
                        greedy_futs.append(
                            await sched.enqueue("greedy", _pieces(4, 1024, salt=i))
                        )
                    except SchedRejected as e:
                        shed += 1
                        assert e.tenant == "greedy"
                        assert e.reason == "queue full"
                assert shed > 0, "greedy tenant never saw backpressure"
                assert sched.metrics_snapshot()["shed_total"] == shed

                # trickle submits one small request AFTER the greedy
                # backlog exists; DRR must serve it from an early batch
                trickle_fut = await sched.enqueue("trickle", _pieces(2, 512))
                stall.release.set()  # let launches run
                got = await asyncio.wait_for(trickle_fut, 10)
                assert got == [hashlib.sha1(p).digest() for p in _pieces(2, 512)]
                # the greedy backlog still drains correctly afterwards
                for i, fut in enumerate(greedy_futs):
                    res = await asyncio.wait_for(fut, 10)
                    assert res == [
                        hashlib.sha1(p).digest() for p in _pieces(4, 1024, salt=i)
                    ]
                snap = sched.metrics_snapshot()
                assert snap["tenants"]["trickle"]["served_pieces"] == 2
                assert snap["tenants"]["greedy"]["shed"] == shed
            finally:
                stall.release.set()
                await sched.close()

        run(go())

    def test_drr_serves_trickle_before_greedy_tail(self):
        """Byte-fair DRR: with a deep greedy backlog queued first, a
        later trickle piece is still served in the FIRST post-backlog
        launch round, not after the whole backlog."""

        async def go():
            order: list[str] = []

            class _RecordingPlane:
                def run(self, payloads):
                    order.append(f"launch:{len(payloads)}")
                    return [hashlib.sha1(p).digest() for p in payloads]

            stall = _StallPlane()
            first = [True]

            class _GatePlane:
                # first launch stalls (pins the queue while we enqueue),
                # later launches record
                def run(self, payloads):
                    if first[0]:
                        first[0] = False
                        stall.release.wait(timeout=30)
                    return _RecordingPlane().run(payloads)

            cfg = SchedulerConfig(
                batch_target=8,
                flush_deadline=0.02,
                drr_quantum=1024,
                plane_factory=lambda a, b, t: _GatePlane(),
            )
            sched = HashPlaneScheduler(cfg, hasher="cpu")
            try:
                # prime: one piece launches immediately and stalls the lane
                prime = await sched.enqueue("greedy", _pieces(1, 64))
                await asyncio.sleep(0.1)  # let the stalled launch start
                # deep greedy backlog + one trickle piece behind it
                greedy = [
                    await sched.enqueue("greedy", _pieces(8, 1024, salt=i))
                    for i in range(8)
                ]
                trickle = await sched.enqueue("trickle", _pieces(1, 1024))
                done_at = {}
                counter = [0]

                def mark(name):
                    def cb(_fut):
                        counter[0] += 1
                        done_at[name] = counter[0]

                    return cb

                trickle.add_done_callback(mark("trickle"))
                greedy[-1].add_done_callback(mark("greedy_tail"))
                stall.release.set()
                await asyncio.wait_for(
                    asyncio.gather(prime, trickle, *greedy), 15
                )
                # trickle resolved before the last greedy submission
                assert done_at["trickle"] < done_at["greedy_tail"], done_at
            finally:
                stall.release.set()
                await sched.close()

        run(go())

    def test_blocking_submit_waits_instead_of_shedding(self):
        """wait=True is the streaming-backpressure path: over-budget
        submits delay until a launch frees bytes, then succeed."""

        async def go():
            stall = _StallPlane()
            cfg = SchedulerConfig(
                batch_target=4,
                flush_deadline=0.01,
                max_queue_bytes=8 << 10,
                plane_factory=lambda a, b, t: stall,
            )
            sched = HashPlaneScheduler(cfg, hasher="cpu")
            try:
                first = await sched.enqueue("s", _pieces(8, 1024))  # fills budget
                waited = asyncio.ensure_future(
                    sched.submit("s", _pieces(2, 1024), wait=True)
                )
                await asyncio.sleep(0.1)
                assert not waited.done(), "blocking submit did not block"
                stall.release.set()
                got = await asyncio.wait_for(waited, 10)
                assert got == [hashlib.sha1(p).digest() for p in _pieces(2, 1024)]
                await asyncio.wait_for(first, 10)
            finally:
                stall.release.set()
                await sched.close()

        run(go())

    def test_oversize_submission_sheds_on_idle_queue(self):
        """A single submission bigger than the budget must shed on the
        non-blocking path even when the queue is empty — the empty-queue
        escape exists only for wait=True (livelock avoidance), else one
        giant request blows past both bounds and 429s everyone behind it."""

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=4,
                    flush_deadline=0.01,
                    max_queue_bytes=4096,
                    max_tenant_bytes=4096,
                ),
                hasher="cpu",
            )
            try:
                with pytest.raises(SchedRejected) as ei:
                    await sched.enqueue("t", _pieces(8, 1024))  # 8 KiB > 4 KiB
                assert ei.value.reason == "queue full"
                # the blocking path still admits the oversize lone
                # submission once the queue is empty (can never fit, so
                # waiting would livelock)
                got = await sched.submit("t", _pieces(8, 1024), wait=True)
                assert got == [hashlib.sha1(p).digest() for p in _pieces(8, 1024)]
            finally:
                await sched.close()

        run(go())

    def test_typed_rejection_fields(self):
        async def go():
            stall = _StallPlane()
            cfg = SchedulerConfig(
                max_queue_bytes=2048, plane_factory=lambda a, b, t: stall
            )
            sched = HashPlaneScheduler(cfg, hasher="cpu")
            try:
                await sched.enqueue("t", _pieces(2, 1024))  # fills the budget
                with pytest.raises(SchedRejected) as ei:
                    await sched.enqueue("t", _pieces(1, 1024))
                assert ei.value.reason == "queue full"
                assert ei.value.tenant == "t"
                assert ei.value.limit_bytes == 2048
                assert ei.value.queued_bytes == 2048
            finally:
                stall.release.set()
                await sched.close()

        run(go())


class TestSha256CudaLane:
    """The v2 lanes on the port's one SHA-256 plane, ``_Sha256CudaPlane``
    (the plain PyTorch version here, ``device="cpu"``; the CUDA kernel on
    a GPU, tests/test_torch_gpu.py). It replaces the reference's pallas
    and scan planes, and its launches are row-exact: no tile snapping,
    no sentinel pad rows, no budget-forced fallback."""

    def test_lane_parity_and_row_exact_launches(self):
        """A partial-fill launch stages exactly its live rows; ragged rows
        (incl. an empty piece) hash bit-identically to hashlib, slot
        reuse across launches leaks no stale bytes, and the lane's
        backend and zero pad waste are observable."""

        async def go():
            from torrent_tpu_torch.utils.metrics import render_sched_metrics

            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=1024, flush_deadline=0.05),
                hasher="gpu", device="cpu",
            )
            try:
                pieces = [b"", b"x" * 200, b"y" * 64, b"z" * 256, b"w" * 129]
                got = await sched.submit(
                    "t", pieces, algo="sha256", piece_length=256
                )
                assert got == [hashlib.sha256(p).digest() for p in pieces]
                snap = sched.metrics_snapshot()
                assert snap["launch_failures"] == 0
                assert snap["cpu_fallback_launches"] == 0
                lane = snap["lane_stats"]["sha256/256"]
                assert lane["backend"] == "torch"
                assert lane["pad_rows_total"] == 0
                short = [b"a", b"bb" * 100, b"", b"c" * 256]
                got = await sched.submit(
                    "t", short, algo="sha256", piece_length=256
                )
                assert got == [hashlib.sha256(p).digest() for p in short]
                text = render_sched_metrics(sched)
                assert 'torrent_tpu_sched_launch_pad_rows_total{lane="sha256/256"} 0' in text
                assert 'torrent_tpu_sched_lane_fill_ratio{lane="sha256/256"}' in text
                assert 'backend="torch"' in text
            finally:
                await sched.close()

        run(go())

    def test_flush_target_is_row_exact_and_full_launch_wastes_zero(self):
        """The sha256 lane's flush target is the configured one (300 stays
        300: the kernel takes any row count), and a full-target launch
        stages zero pad rows. A big bucket keeps the budget's afford
        instead of falling back to another backend."""

        async def go():
            from torrent_tpu_torch.ops.padding import padded_len_for

            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=300, flush_deadline=0.5),
                hasher="gpu", device="cpu",
            )
            try:
                assert sched.chunk_for(64, "sha256") == 300
                assert sched.chunk_for(64) == 300
                pieces = [bytes([i % 251]) * 64 for i in range(300)]
                got = await sched.submit(
                    "t", pieces, algo="sha256", piece_length=64
                )
                assert got == [hashlib.sha256(p).digest() for p in pieces]
                snap = sched.metrics_snapshot()
                lane = snap["lane_stats"]["sha256/64"]
                assert lane["target"] == 300
                assert lane["launches"] == 1
                assert lane["mean_fill"] == 1.0
                assert lane["pad_rows_total"] == 0, lane
                assert snap["flush_reasons"]["full"] == 1
            finally:
                await sched.close()

            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=2048, staging_budget=64 << 20),
                hasher="gpu", device="cpu",
            )
            assert sched._lane_plan("sha256", 1 << 20) == (
                "torch", (64 << 20) // padded_len_for(1 << 20)
            )
            await sched.close()

        run(go())

    def test_backend_selection(self, monkeypatch):
        """The device alone decides the backend, with no knob: 'cuda' on
        a GPU and 'torch' on device="cpu" (so the plain version never
        runs on a card behind the caller's back); a card's sha1 lanes are
        'cuda' too; a cpu-hasher scheduler's lanes are hashlib's."""
        import torch

        from torrent_tpu_torch.sched import resolve_sha256_backend
        from torrent_tpu_torch.sched.scheduler import (
            _Sha256CudaPlane,
            build_builtin_plane,
        )
        from torrent_tpu_torch.utils import device as device_mod

        plane = build_builtin_plane("gpu", "sha256", 256, 64, device="cpu")
        assert isinstance(plane, _Sha256CudaPlane)
        assert plane.device.type == "cpu"
        assert resolve_sha256_backend("cpu") == "torch"
        assert not hasattr(SchedulerConfig(), "sha256_backend")
        if not torch.cuda.is_available():
            # no device given means the GPU, and a host without one raises
            with pytest.raises(RuntimeError, match="CUDA"):
                resolve_sha256_backend(None)
        port = HashPlaneScheduler(hasher="gpu", device="cpu")
        assert port._lane_plan("sha1", 16384)[0] == "device"
        assert port._lane_plan("sha256", 16384)[0] == "torch"
        # on a GPU scheduler every lane is the kernels' (the device probe
        # is stubbed: this host may have no GPU)
        monkeypatch.setattr(
            device_mod, "resolve_device", lambda d=None: torch.device("cuda", 0)
        )
        assert resolve_sha256_backend(None) == "cuda"
        card = HashPlaneScheduler(hasher="gpu")
        assert card._on_card()
        assert card._lane_plan("sha1", 16384)[0] == "cuda"
        assert card._lane_plan("sha256", 16384)[0] == "cuda"
        assert card.sha256_backend() == "cuda"

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=8, flush_deadline=0.05),
                hasher="cpu",
            )
            try:
                pieces = _pieces(5, 200)
                got = await sched.submit("t", pieces, algo="sha256")
                assert got == [hashlib.sha256(p).digest() for p in pieces]
                assert sched.sha256_backend() == "cpu"
                lane = sched.metrics_snapshot()["lane_stats"]["sha256/256"]
                assert lane["backend"] == "cpu"
            finally:
                await sched.close()

        run(go())

    def test_plane_factory_gets_the_lanes_backend(self):
        """A FaultPlan factory builds the plane its device decides: on a
        device="cpu" lane, the plain sha256 plane ('torch')."""
        from torrent_tpu_torch.sched.faults import FaultPlan, FaultyPlane
        from torrent_tpu_torch.sched.scheduler import _Sha256CudaPlane

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=64,
                    plane_factory=FaultPlan().plane_factory(  # no-op: wiring only
                        hasher="gpu", device="cpu"
                    ),
                ),
                hasher="gpu", device="cpu",
            )
            try:
                lane = sched._lane("sha256", 1 << 20)
                assert lane.backend == "torch"
                plane = sched._build_plane(lane)
                assert isinstance(plane, FaultyPlane)
                assert isinstance(plane.inner, _Sha256CudaPlane), type(plane.inner)
                assert plane.inner.device.type == "cpu"
            finally:
                await sched.close()

        run(go())

    def test_padded_admission_charges_staging_footprint(self):
        """Admission accounting charges the padded staging row, not raw
        payload bytes: tiny pieces in a big bucket pin full rows, so the
        queue bound reflects what launches actually stage."""
        from torrent_tpu_torch.ops.padding import padded_len_for

        async def go():
            row = padded_len_for(4096)  # 4224
            stall = _StallPlane()
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=64,
                    flush_deadline=0.02,
                    max_queue_bytes=4 * row,
                    plane_factory=lambda a, b, t: stall,
                ),
                hasher="gpu", device="cpu",
            )
            try:
                # 4 ten-byte pieces: 40 raw bytes, but 4 staging rows —
                # exactly the budget
                futs = [
                    await sched.enqueue("t", [b"0123456789"], piece_length=4096)
                    for _ in range(4)
                ]
                assert sched.metrics_snapshot()["queue_bytes"] == 4 * row
                with pytest.raises(SchedRejected) as ei:
                    await sched.enqueue("t", [b"x"], piece_length=4096)
                assert ei.value.queued_bytes == 4 * row
                stall.release.set()
                for fut in futs:
                    await asyncio.wait_for(fut, 10)
                # release returns the charged (padded) bytes, not raw
                assert sched.metrics_snapshot()["queue_bytes"] == 0
            finally:
                stall.release.set()
                await sched.close()

        run(go())

    def test_breaker_and_fault_plan_through_sha256_plane(self):
        """Fault-plan / breaker compatibility through the plane_factory
        seam: a FaultPlan wrapping the sha256 plane still trips the lane
        to the CPU plane (digests stay correct) and recovers via the
        half-open probe back onto the device plane; FaultyPlane delegates
        the launch_geometry hook to the wrapped plane."""
        from torrent_tpu_torch.ops.padding import padded_len_for
        from torrent_tpu_torch.sched import FaultPlan

        plan = FaultPlan(fail_first=2)
        factory = plan.plane_factory(hasher="gpu", device="cpu")
        wrapped = factory("sha256", 256, 1024)
        assert wrapped.launch_geometry(5, 256) == (5, 5 * padded_len_for(256))

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=1024,
                    flush_deadline=0.05,
                    breaker_threshold=2,
                    breaker_cooldown=300.0,
                    plane_factory=plan.plane_factory(hasher="gpu", device="cpu"),
                ),
                hasher="gpu", device="cpu",
            )
            try:
                pieces = [bytes([i + 1]) * 64 for i in range(4)]
                want = [hashlib.sha256(p).digest() for p in pieces]
                got = await sched.submit("t", pieces, algo="sha256", piece_length=256)
                assert got == want, "CPU degradation digests wrong"
                snap = sched.metrics_snapshot()
                lane = next(iter(snap["breakers"].values()))
                assert lane["state"] == "open", lane
                assert snap["cpu_fallback_launches"] > 0
                # degraded launches run on hashlib, which stages nothing:
                # the padding waste counter must not grow while open
                pads_open = snap["lane_stats"]["sha256/256"]["pad_rows_total"]
                got = await sched.submit("t", pieces, algo="sha256", piece_length=256)
                assert got == want
                stats = sched.metrics_snapshot()["lane_stats"]["sha256/256"]
                assert stats["pad_rows_total"] == pads_open, stats
                # rewind the cooldown: next launch is the half-open probe
                # through the real sha256 plane, which re-closes the lane
                for ln in sched._lanes.values():
                    with ln.breaker.lock:
                        ln.breaker.opened_at -= 1e6
                got = await sched.submit("t", pieces, algo="sha256", piece_length=256)
                assert got == want
                lane = next(iter(sched.metrics_snapshot()["breakers"].values()))
                assert lane["state"] == "closed", lane
            finally:
                await sched.close()

        run(go())


# ----------------------------------------------------------- sessions


def _build_torrent(length, piece_len, seed=0, name="s"):
    from torrent_tpu_torch.codec.metainfo import InfoDict
    from torrent_tpu_torch.storage.storage import MemoryStorage, Storage

    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, size=length, dtype=np.uint8).tobytes()
    pieces = tuple(
        hashlib.sha1(payload[i : i + piece_len]).digest()
        for i in range(0, length, piece_len)
    )
    info = InfoDict(
        name=name, piece_length=piece_len, pieces=pieces, length=length, files=None
    )
    storage = Storage(MemoryStorage(), info)
    for off in range(0, length, 1 << 20):
        storage.set(off, payload[off : off + (1 << 20)])
    return info, storage


class TestSchedulerSessions:
    def test_verify_pieces_sched_matches_cpu(self):
        from torrent_tpu_torch.parallel.verify import verify_pieces, verify_pieces_sched

        async def go():
            info, storage = _build_torrent(300_000, 16384, seed=3)
            storage.method.set(("s",), 33_000, b"XX")  # corrupt piece 2
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=8, flush_deadline=0.05), hasher="cpu"
            )
            try:
                bf = await verify_pieces_sched(storage, info, sched, tenant="cli")
            finally:
                await sched.close()
            want = verify_pieces(storage, info, hasher="cpu")
            assert (bf == want).all()
            assert not bf[2] and bf[0]

        run(go())

    def test_verify_library_sched_coalesces_across_torrents(self):
        """Cross-torrent coalescing: 6 torrents × 24 pieces at one
        geometry = 144 pieces = 3 full launches of 48 — the per-torrent
        ragged tails ride shared launches instead of flushing alone."""
        from torrent_tpu_torch.parallel.bulk import verify_library_sched

        async def go():
            items = [
                (storage, info)
                for info, storage in (
                    _build_torrent(24 * 4096, 4096, seed=i, name=f"t{i}")
                    for i in range(6)
                )
            ]
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=48, flush_deadline=0.5), hasher="cpu"
            )
            try:
                res = await verify_library_sched(items, sched, tenant="bulk")
                snap = sched.metrics_snapshot()
            finally:
                await sched.close()
            assert all(bf.all() for bf in res.bitfields)
            assert res.n_pieces == 144
            assert snap["mean_fill"] >= 0.9, snap
            # 144 pieces at target 48: exactly 3 launches, all full
            assert snap["launches"] == 3
            assert snap["flush_reasons"]["full"] == 3

        run(go())


# ------------------------------------------------------- differential


def _ref_and_port(ref_cfg):
    """The reference's scheduler (its device planes on JAX's CPU
    backend, as its own tests run them) and the port's (``device="cpu"``:
    the plain versions, whichever v2 backend the reference config
    names), both built from the one reference config."""
    from torrent_tpu.sched import HashPlaneScheduler as RefScheduler
    from torrent_tpu_torch.compat import scheduler_config_from_reference

    port_cfg = scheduler_config_from_reference(ref_cfg)
    return (
        RefScheduler(ref_cfg, hasher="tpu"),
        HashPlaneScheduler(port_cfg, hasher="gpu", device="cpu"),
    )


def _seeded_pieces(seed: int, n: int, max_len: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len + 1, size=n)
    lengths[0] = max_len  # one full-bucket row, one empty row
    lengths[-1] = 0
    return [rng.integers(0, 256, size=int(k), dtype=np.uint8).tobytes() for k in lengths]


async def _drive(sched, script):
    """Submit ``script``'s (tenant, pieces, kwargs) one after another,
    each awaited (a deterministic order); a shed submission records
    its rejection reason."""
    from torrent_tpu.sched import SchedRejected as RefRejected

    out = []
    for tenant, pieces, kw in script:
        try:
            out.append(await sched.submit(tenant, pieces, **kw))
        except (SchedRejected, RefRejected) as e:
            out.append(("shed", e.reason))
    return out


def _shape(obj):
    """The nested key structure of a snapshot (values dropped)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    return None


class TestDifferential:
    """The reference scheduler and the port's, same input, same config:
    exact agreement (digests and counters have no tolerance)."""

    @pytest.mark.parametrize(
        "algo,backend",
        [
            ("sha1", None),
            ("sha256", "scan"),
            ("sha256", "pallas"),  # pallas in interpret mode
        ],
        ids=["sha1", "sha256-scan", "sha256-pallas"],
    )
    def test_digests_agree(self, algo, backend):
        from torrent_tpu.sched import SchedulerConfig as RefConfig

        h = hashlib.sha1 if algo == "sha1" else hashlib.sha256
        bucket = 1024 if algo == "sha1" else 256
        pieces = _seeded_pieces(11, 19, bucket)
        want = [h(p).digest() for p in pieces]

        async def go():
            cfg = RefConfig(batch_target=8, flush_deadline=0.02, sha256_backend=backend)
            ref, port = _ref_and_port(cfg)
            try:
                got_ref = await ref.submit("t", pieces, algo=algo, piece_length=bucket)
                got_port = await port.submit("t", pieces, algo=algo, piece_length=bucket)
            finally:
                await ref.close()
                await port.close()
            assert got_port == got_ref == want
            assert port.metrics_snapshot()["cpu_fallback_launches"] == 0
            assert ref.metrics_snapshot()["cpu_fallback_launches"] == 0

        run(go(), timeout=300)

    @pytest.mark.parametrize(
        "cfg_kw",
        [{}, {"batch_target": 4096, "staging_budget": 4096 * 262272}],
        ids=["default", "baseline-batch"],
    )
    def test_lane_geometry_agrees(self, cfg_kw):
        """``chunk_for`` for sha1 at 16 KiB … 16 MiB pieces, and sha256 at
        16 KiB / 64 B against the reference's row-exact scan backend."""
        from torrent_tpu.sched import SchedulerConfig as RefConfig

        ref, port = _ref_and_port(RefConfig(sha256_backend="scan", **cfg_kw))
        for shift in range(14, 25):
            assert port.chunk_for(1 << shift) == ref.chunk_for(1 << shift), shift
        for plen in (16384, 64):
            assert port.chunk_for(plen, "sha256") == ref.chunk_for(plen, "sha256"), plen
        assert port._lane_plan("sha256", 16384) == ("torch", ref.chunk_for(16384, "sha256"))

    def test_accounting_snapshot_and_ledger_agree(self):
        """The same submission order gives the same launches, flush
        reasons, per-tenant served/shed counts, the same
        ``metrics_snapshot()`` key structure and the same ledger stages."""
        from torrent_tpu.obs.ledger import pipeline_ledger as ref_ledger
        from torrent_tpu.ops.padding import padded_len_for
        from torrent_tpu.sched import SchedulerConfig as RefConfig
        from torrent_tpu_torch.obs.ledger import pipeline_ledger as port_ledger

        script = [
            ("fg", _seeded_pieces(1, 20, 512), {"piece_length": 512}),
            ("bulk", _seeded_pieces(2, 8, 512), {"piece_length": 512}),
            ("bulk", _seeded_pieces(3, 3, 512), {"piece_length": 512}),
            # over its 2-row budget: shed, never queued
            ("small", _seeded_pieces(4, 3, 512), {"piece_length": 512}),
            ("small", _seeded_pieces(5, 2, 512), {"piece_length": 512}),
            ("v2", _seeded_pieces(6, 5, 256), {"algo": "sha256", "piece_length": 256}),
        ]

        async def go():
            cfg = RefConfig(batch_target=8, flush_deadline=0.02, sha256_backend="scan")
            ref, port = _ref_and_port(cfg)
            results, snaps, stages = [], [], []
            for sched, ledger in ((ref, ref_ledger()), (port, port_ledger())):
                sched.register_tenant("small", max_bytes=2 * padded_len_for(512))
                sched.register_tenant("bulk", weight=0.25)
                ledger.clear()
                try:
                    results.append(await _drive(sched, script))
                finally:
                    await sched.close()
                snaps.append(sched.metrics_snapshot())
                stages.append(set(ledger.snapshot()["stages"]))
            assert results[0] == results[1]
            assert results[1][3] == ("shed", "queue full")
            r, p = snaps
            for key in ("launches", "flush_reasons", "shed_total", "mean_fill",
                        "launch_failures", "cpu_fallback_launches", "queue_bytes"):
                assert p[key] == r[key], key
            for name in r["tenants"]:
                for key in ("served_pieces", "served_bytes", "shed", "queued_bytes"):
                    assert p["tenants"][name][key] == r["tenants"][name][key], (name, key)
            assert _shape(p) == _shape(r)
            assert stages[0] == stages[1] == {"stage", "h2d", "launch", "digest", "verdict"}

        run(go(), timeout=300)

    @pytest.mark.parametrize("damaged", [False, True], ids=["intact", "damaged"])
    def test_full_recheck_agrees(self, tmp_path, damaged):
        """``verify_pieces_sched`` on a multi-file torrent and
        ``verify_library_sched`` on it plus a single-file one give the
        reference's bitfields, intact and with one byte flipped."""
        from torrent_tpu.codec.metainfo import FileEntry as RefFile
        from torrent_tpu.codec.metainfo import InfoDict as RefInfo
        from torrent_tpu.parallel.bulk import verify_library_sched as ref_library
        from torrent_tpu.parallel.verify import verify_pieces_sched as ref_pieces
        from torrent_tpu.sched import SchedulerConfig as RefConfig
        from torrent_tpu.storage.storage import FsStorage as RefFs
        from torrent_tpu.storage.storage import Storage as RefStorage
        from torrent_tpu_torch.compat import info_from_reference
        from torrent_tpu_torch.parallel.bulk import verify_library_sched
        from torrent_tpu_torch.parallel.verify import verify_pieces_sched
        from torrent_tpu_torch.storage.storage import FsStorage, Storage

        plen = 2048
        rng = np.random.default_rng(7)
        sizes = {("lib", "a.bin"): 5000, ("lib", "sub", "b.bin"): 9000, ("lib", "c.bin"): 1234}
        blobs = {}
        for path, n in sizes.items():
            blobs[path] = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            f = tmp_path.joinpath(*path)
            f.parent.mkdir(parents=True, exist_ok=True)
            f.write_bytes(blobs[path])
        payload = b"".join(blobs.values())
        single = rng.integers(0, 256, size=7000, dtype=np.uint8).tobytes()
        (tmp_path / "one.bin").write_bytes(single)

        def info_for(name, data, files):
            return RefInfo(
                name=name, piece_length=plen,
                pieces=tuple(hashlib.sha1(data[i : i + plen]).digest()
                             for i in range(0, len(data), plen)),
                length=len(data), files=files,
            )

        multi = info_for("lib", payload, tuple(
            RefFile(length=n, path=path[1:]) for path, n in sizes.items()
        ))
        one = info_for("one.bin", single, None)
        if damaged:
            f = tmp_path / "lib" / "sub" / "b.bin"
            raw = bytearray(f.read_bytes())
            raw[3000] ^= 0xFF  # byte 8000 of the torrent: piece 3
            f.write_bytes(bytes(raw))

        async def go():
            cfg = RefConfig(batch_target=8, flush_deadline=0.02)
            ref, port = _ref_and_port(cfg)
            try:
                bf_ref = await ref_pieces(RefStorage(RefFs(tmp_path), multi), multi, ref)
                lib_ref = await ref_library(
                    [(RefStorage(RefFs(tmp_path), i), i) for i in (multi, one)], ref
                )
                pinfo = [info_from_reference(i) for i in (multi, one)]
                bf_port = await verify_pieces_sched(
                    Storage(FsStorage(tmp_path), pinfo[0]), pinfo[0], port
                )
                lib_port = await verify_library_sched(
                    [(Storage(FsStorage(tmp_path), i), i) for i in pinfo], port
                )
            finally:
                await ref.close()
                await port.close()
            assert (bf_port == bf_ref).all()
            for a, b in zip(lib_port.bitfields, lib_ref.bitfields):
                assert (a == b).all()
            want = np.ones(multi.num_pieces, dtype=bool)
            if damaged:
                want[3] = False
            assert (bf_port == want).all()
            assert (lib_port.bitfields[0] == want).all() and lib_port.bitfields[1].all()
            assert port.metrics_snapshot()["staging"]["outstanding"] == 0

        run(go(), timeout=300)

    def test_config_carry_over(self):
        """``compat.scheduler_config_from_reference`` carries every field
        the port has across, checks and drops the reference's v2 backend
        name, and refuses a plane_factory: code, not state."""
        import dataclasses

        from torrent_tpu.sched import FaultPlan as RefPlan
        from torrent_tpu.sched import SchedulerConfig as RefConfig
        from torrent_tpu_torch.compat import scheduler_config_from_reference

        ref = RefConfig(batch_target=77, flush_deadline=0.3, max_queue_bytes=123,
                        breaker_cooldown=1.5, bisect_depth=3)
        got = scheduler_config_from_reference(ref)
        assert {f.name for f in dataclasses.fields(got)} == {
            f.name for f in dataclasses.fields(ref)
        } - {"sha256_backend"}
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(ref, f.name), f.name
        # the reference's v2 backend choice is checked and dropped: the
        # port's device decides its own
        for ref_backend in ("pallas", "scan", "auto", None):
            cfg = scheduler_config_from_reference(RefConfig(sha256_backend=ref_backend))
            assert cfg == SchedulerConfig(plane_factory=None)
        with pytest.raises(ValueError, match="unknown reference sha256 backend"):
            scheduler_config_from_reference(RefConfig(sha256_backend="warp"))
        with pytest.raises(ValueError, match="code, not state"):
            scheduler_config_from_reference(
                RefConfig(plane_factory=RefPlan().plane_factory(hasher="cpu"))
            )

    def test_gpu_hasher_without_a_device_needs_cuda(self):
        """``hasher="gpu"`` with no device means the GPU: on a host
        without one the constructor raises instead of running the plain
        version; ``device="cpu"`` is the explicit plain path."""
        import torch

        if torch.cuda.is_available():
            sched = HashPlaneScheduler(hasher="gpu")
            assert sched.device.type == "cuda"
            assert sched.sha256_backend() == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                HashPlaneScheduler(hasher="gpu")
        sched = HashPlaneScheduler(hasher="gpu", device="cpu")
        assert sched.device.type == "cpu" and sched.sha256_backend() == "torch"
        with pytest.raises(ValueError, match="hasher"):
            HashPlaneScheduler(hasher="tpu")
