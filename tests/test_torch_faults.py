"""The port's fault-tolerant hash plane (sched/faults.py + scheduler
layer), against hashlib and against the reference.

The reference's tests/test_faults.py, ported. Device faults can't be
provoked on demand, so every behavior of the fault-tolerance layer —
launch retry, bisection isolation of a poisoned ticket, the per-lane
circuit breaker with CPU degradation, and the mark-and-continue recheck
semantics — is driven deterministically on the CPU through a
``FaultPlan`` wired into the ``plane_factory`` seam, and so is the
session recheck's local path after a whole-queue rejection.
``doctor --faults`` waits for the tools slice (ROADMAP.md); the
bridge's 503/Retry-After mapping is in test_torch_bridge.py.

``TestDifferential`` runs the same fault-plan specs through the
reference's device planes (JAX on the CPU) and the port's
(``device="cpu"``): retries, bisections, failed pieces, breaker
transitions and CPU-fallback launches must agree exactly.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import threading

import numpy as np
import pytest

from torrent_tpu_torch.sched import (
    DeviceFaultError,
    FaultPlan,
    HashPlaneScheduler,
    PoisonedPayloadError,
    SchedLaunchError,
    SchedRejected,
    SchedulerConfig,
    classify_error,
)


def run(coro, timeout: float = 120.0):
    # a stuck lane fails its test instead of hanging the suite
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _pieces(n: int, plen: int = 1024, salt: int = 0) -> list[bytes]:
    return [bytes([(i + salt) % 251]) * plen for i in range(n)]


def _sha1(pieces: list[bytes]) -> list[bytes]:
    return [hashlib.sha1(p).digest() for p in pieces]


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


class _StallPlane:
    """Blocks until released — pins queue bytes deterministically."""

    def __init__(self):
        self.release = threading.Event()

    def run(self, payloads):
        self.release.wait(timeout=30)
        return _sha1(payloads)


# ------------------------------------------------------------ fault plan


class TestFaultPlan:
    def test_parse_round_trip(self):
        plan = FaultPlan.parse(
            "fail_first=3; latency_ms=5; payload=deadbeef; "
            "fail_launches=2,5; dead_after=9"
        )
        assert plan.fail_first == 3
        assert plan.latency_s == pytest.approx(0.005)
        assert plan.payload_prefix == b"\xde\xad\xbe\xef"
        assert plan.fail_launches == frozenset({2, 5})
        assert plan.dead_after == 9

    def test_parse_rejects_garbage(self):
        for bad in (
            "fail_first",  # not key=value
            "frobnicate=1",  # unknown key
            "fail_first=x",  # non-int
            "payload=zz",  # non-hex
            "fail_first=-1",  # negative ordinal
            "latency_ms=-2",  # negative latency
            "payload=",  # empty prefix would match every payload
        ):
            with pytest.raises(ValueError):
                FaultPlan.parse(bad)

    def test_injected_errors_self_classify(self):
        assert classify_error(DeviceFaultError("x")) == "transient"
        assert classify_error(PoisonedPayloadError("x")) == "deterministic"
        # uninjected errors: payload/shape bugs are deterministic,
        # everything else is presumed a device hiccup worth one retry
        assert classify_error(ValueError("bad shape")) == "deterministic"
        assert classify_error(RuntimeError("XLA launch failed")) == "transient"
        assert classify_error(OSError("device lost")) == "transient"

    def test_faulty_plane_counts_launches_per_plan(self):
        plan = FaultPlan(fail_launches=frozenset({2}))
        plane = plan.plane_factory(hasher="cpu")("sha1", 1024, 8)
        pieces = _pieces(4, 64)
        assert plane.run(pieces) == _sha1(pieces)  # launch 1 fine
        with pytest.raises(DeviceFaultError):
            plane.run(pieces)  # launch 2 injected
        assert plane.run(pieces) == _sha1(pieces)  # launch 3 fine


# ------------------------------------------------- retry and bisection


class TestRetryAndBisection:
    def test_transient_failure_is_retried_once(self):
        """A single injected device fault is absorbed by the retry: the
        submitter sees correct digests and only the retry counter moves."""

        async def go():
            plan = FaultPlan(fail_launches=frozenset({1}))
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=8,
                    flush_deadline=0.05,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            try:
                pieces = _pieces(8, 512)
                assert await sched.submit("t", pieces) == _sha1(pieces)
                snap = sched.metrics_snapshot()
                assert snap["launch_failures"] == 1
                assert snap["retries"] == 1
                assert snap["bisections"] == 0
                assert snap["failed_pieces"] == 0
            finally:
                await sched.close()

        run(go())

    def test_poisoned_batch_isolates_single_ticket(self):
        """Acceptance: 16 pieces from 3 tenants with exactly one
        poisoned payload — the poisoned submitter's future fails with a
        classified (deterministic) error, the other 15 tickets all get
        correct digests, and sched_bisections > 0."""

        async def go():
            poison = b"\xbd\xbd\xbd\xbd" + b"p" * 508
            plan = FaultPlan(payload_prefix=b"\xbd\xbd\xbd\xbd")
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=16,
                    flush_deadline=0.5,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            try:
                a, b, c = _pieces(6, 512, salt=1), _pieces(5, 512, salt=9), _pieces(4, 512, salt=17)
                # enqueue all four submissions without an intervening
                # yield so all 16 pieces deterministically coalesce into
                # ONE poisoned launch
                fa = await sched.enqueue("tenant-a", a)
                fb = await sched.enqueue("tenant-b", b)
                fc = await sched.enqueue("tenant-c", c)
                fbad = await sched.enqueue("tenant-c", [poison])
                got_a, got_b, got_c, got_bad = await asyncio.gather(
                    fa, fb, fc, fbad, return_exceptions=True
                )
                assert got_a == _sha1(a), "tenant-a lost to a co-batched poison"
                assert got_b == _sha1(b), "tenant-b lost to a co-batched poison"
                assert got_c == _sha1(c), "tenant-c lost to a co-batched poison"
                assert isinstance(got_bad, SchedLaunchError), got_bad
                assert got_bad.kind == "deterministic"
                assert isinstance(got_bad.cause, PoisonedPayloadError)
                snap = sched.metrics_snapshot()
                assert snap["bisections"] > 0, snap
                assert snap["failed_pieces"] == 1
                # deterministic errors never burn the retry budget
                assert snap["retries"] == 0
            finally:
                await sched.close()

        run(go())

    def test_deterministic_failure_skips_retry(self):
        """A lone poisoned piece (batch of 1: nothing to bisect) fails
        immediately — no retry, no bisection."""

        async def go():
            plan = FaultPlan(payload_prefix=b"\xbd")
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=4,
                    flush_deadline=0.02,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            try:
                with pytest.raises(SchedLaunchError) as ei:
                    await sched.submit("t", [b"\xbd" * 64])
                assert ei.value.kind == "deterministic"
                snap = sched.metrics_snapshot()
                assert snap["retries"] == 0
                assert snap["bisections"] == 0
                assert snap["failed_pieces"] == 1
            finally:
                await sched.close()

        run(go())

    def test_bisect_depth_bounds_the_split(self):
        """Past bisect_depth the surviving group fails together instead
        of splitting forever — the recursion is bounded."""

        async def go():
            plan = FaultPlan(payload_prefix=b"\xbd")
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=8,
                    flush_deadline=0.1,
                    bisect_depth=1,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            try:
                good = _pieces(7, 64, salt=3)
                fa = await sched.enqueue("ok", good)
                fbad = await sched.enqueue("bad", [b"\xbd" * 64])
                got_ok, got_bad = await asyncio.gather(
                    fa, fbad, return_exceptions=True
                )
                assert isinstance(got_bad, SchedLaunchError)
                snap = sched.metrics_snapshot()
                # depth 1: one split of 8 -> two 4s; the poisoned half
                # (4 tickets incl. 3 innocents) fails together
                assert snap["bisections"] == 1
                assert snap["failed_pieces"] == 4
                # the innocent half still verified
                assert isinstance(got_ok, SchedLaunchError) or got_ok == _sha1(good)
            finally:
                await sched.close()

        run(go())


def _rewind_breaker(sched, seconds: float = 1e6) -> None:
    """Expire every lane breaker's cooldown without sleeping: tests use
    a long real cooldown (so a slow CI box can't close the breaker
    early) and rewind the clock to trigger the half-open probe."""
    for lane in sched._lanes.values():
        with lane.breaker.lock:
            lane.breaker.opened_at -= seconds


# -------------------------------------------------------------- breaker


class TestCircuitBreaker:
    def test_breaker_trips_to_cpu_and_recovers(self):
        """Acceptance: consecutive injected device failures trip
        the lane breaker → submits succeed via the CPU plane (digests
        match hashlib), a half-open probe restores the device plane
        after recovery, and the transitions appear in /metrics."""
        from torrent_tpu_torch.utils.metrics import render_sched_metrics

        async def go():
            plan = FaultPlan(fail_first=2)
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=4,
                    flush_deadline=0.02,
                    breaker_threshold=2,
                    breaker_cooldown=300.0,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            try:
                pieces = _pieces(4, 256)
                # launch fails, retry fails -> threshold 2 trips the
                # breaker; the bisected halves ride the CPU plane, so
                # the caller still gets correct digests
                assert await sched.submit("t", pieces) == _sha1(pieces)
                snap = sched.metrics_snapshot()
                lane = next(iter(snap["breakers"].values()))
                assert lane["state"] == "open", lane
                assert lane["transitions"].get("closed->open") == 1
                assert snap["cpu_fallback_launches"] > 0
                assert snap["failed_pieces"] == 0, "degradation must not fail pieces"
                # breaker-open launches keep serving via CPU
                more = _pieces(4, 256, salt=40)
                assert await sched.submit("t", more) == _sha1(more)
                # expire the cooldown: the next launch is the half-open
                # probe; the injected fault window (fail_first=2) is
                # over, so it succeeds and re-closes the breaker
                _rewind_breaker(sched)
                again = _pieces(4, 256, salt=80)
                assert await sched.submit("t", again) == _sha1(again)
                snap = sched.metrics_snapshot()
                lane = next(iter(snap["breakers"].values()))
                assert lane["state"] == "closed", lane
                assert lane["transitions"].get("open->half_open") == 1
                assert lane["transitions"].get("half_open->closed") == 1
                text = render_sched_metrics(sched)
                assert "torrent_tpu_sched_breaker_state{lane=" in text
                assert (
                    'transition="closed->open"} 1' in text
                    and 'transition="half_open->closed"} 1' in text
                ), text
            finally:
                await sched.close()

        run(go())

    def test_card_breaker_fails_refused_launches_instead_of_hashlib(self):
        """On a card an open breaker never moves work to hashlib: the
        launches it refuses fail their tickets at once with a transient
        SchedLaunchError (no retry, no bisection), and the half-open
        probe brings the lane back onto its own plane. The scheduler is
        a device="cpu" one whose ``_on_card`` is forced true, over
        hashlib planes from the factory, so the rule runs here."""

        async def go():
            plan = FaultPlan(fail_first=2)
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=4,
                    flush_deadline=0.02,
                    breaker_threshold=2,
                    breaker_cooldown=300.0,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="gpu", device="cpu",
            )
            sched._on_card = lambda: True
            try:
                pieces = _pieces(4, 256)
                # launch fails, retry fails -> threshold 2 opens the
                # breaker; the bisected halves are refused and fail
                with pytest.raises(SchedLaunchError) as err:
                    await sched.submit("t", pieces)
                assert err.value.kind == "transient"
                while sched.metrics_snapshot()["queue_bytes"]:
                    await asyncio.sleep(0.01)
                snap = sched.metrics_snapshot()
                assert next(iter(snap["breakers"].values()))["state"] == "open"
                assert snap["cpu_fallback_launches"] == 0
                assert snap["failed_pieces"] == 4
                retries, bisections = snap["retries"], snap["bisections"]
                more = _pieces(4, 256, salt=40)
                with pytest.raises(SchedLaunchError, match="breaker open") as err:
                    await sched.submit("t", more)
                assert err.value.kind == "transient"
                snap = sched.metrics_snapshot()
                assert (snap["retries"], snap["bisections"]) == (retries, bisections)
                assert snap["cpu_fallback_launches"] == 0
                assert snap["failed_pieces"] == 8
                # refused launches never reach the plane
                assert next(iter(sched._lanes.values())).plane.launches == 2
                _rewind_breaker(sched)
                again = _pieces(4, 256, salt=80)
                assert await sched.submit("t", again) == _sha1(again)
                snap = sched.metrics_snapshot()
                lane = next(iter(snap["breakers"].values()))
                assert lane["state"] == "closed", lane
                assert lane["transitions"].get("half_open->closed") == 1
                assert snap["cpu_fallback_launches"] == 0
            finally:
                await sched.close()

        run(go())

    def test_permanent_device_loss_pins_cpu_plane(self):
        """dead_after=0 (every launch raises): a failed half-open probe
        re-opens the breaker and the lane keeps answering via CPU."""

        async def go():
            plan = FaultPlan(dead_after=0)
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=4,
                    flush_deadline=0.02,
                    breaker_threshold=2,
                    breaker_cooldown=300.0,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            try:
                pieces = _pieces(4, 256)
                assert await sched.submit("t", pieces) == _sha1(pieces)
                _rewind_breaker(sched)  # expire cooldown: next launch probes
                more = _pieces(4, 256, salt=5)
                assert await sched.submit("t", more) == _sha1(more)
                lane = next(iter(sched.metrics_snapshot()["breakers"].values()))
                assert lane["state"] == "open", lane
                assert lane["transitions"].get("half_open->open", 0) >= 1, lane
            finally:
                await sched.close()

        run(go())

    def test_count_contract_violation_feeds_breaker(self):
        """A plane persistently returning the wrong digest count is a
        primary-plane failure: it must trip the breaker to the CPU plane
        (not reset it via record_success), and callers still get correct
        digests instead of an unbounded retry+bisection cascade."""

        class _ShortPlane:
            def run(self, payloads):
                return _sha1(payloads)[:-1]  # always one digest short

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=4,
                    flush_deadline=0.02,
                    breaker_threshold=2,
                    breaker_cooldown=30.0,
                    plane_factory=lambda a, b, t: _ShortPlane(),
                ),
                hasher="cpu",
            )
            try:
                pieces = _pieces(4, 256)
                assert await sched.submit("t", pieces) == _sha1(pieces)
                snap = sched.metrics_snapshot()
                lane = next(iter(snap["breakers"].values()))
                assert lane["state"] == "open", lane
                assert snap["cpu_fallback_launches"] > 0
                assert snap["failed_pieces"] == 0
            finally:
                await sched.close()

        run(go())

    def test_latency_spike_plan_stays_correct(self):
        """latency_ms slows every launch but nothing fails — digests
        stay correct and the breaker never moves."""

        async def go():
            plan = FaultPlan.parse("latency_ms=5")
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=4,
                    flush_deadline=0.02,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            try:
                pieces = _pieces(8, 256)
                assert await sched.submit("t", pieces) == _sha1(pieces)
                lane = next(iter(sched.metrics_snapshot()["breakers"].values()))
                assert lane["state"] == "closed"
                assert lane["transitions"] == {}
            finally:
                await sched.close()

        run(go())


# -------------------------------------------- recheck failure semantics


class TestRecheckFailureSemantics:
    def test_torn_file_marks_piece_failed_sched(self):
        """A piece whose read raises mid-recheck (torn/truncated file,
        raw OSError) is marked failed; every other piece still verifies —
        device-path parity with verify_pieces_cpu's mark-and-continue."""
        from torrent_tpu_torch.parallel.verify import verify_pieces_sched

        async def go():
            info, storage = _build_torrent(16 * 16384, 16384, seed=11)
            # tear at the BACKEND seam: both read paths (per-piece
            # read_piece bytes and the zero-copy read_batch-into-slab
            # form) route through method.get, so the torn range fails
            # whichever one the scheduler session picks
            orig = storage.method.get
            lo, hi = 5 * 16384, 6 * 16384

            def torn(path, offset, length):
                if offset < hi and offset + length > lo:
                    raise OSError(5, "input/output error")
                return orig(path, offset, length)

            storage.method.get = torn
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=8, flush_deadline=0.05), hasher="cpu"
            )
            try:
                bf = await verify_pieces_sched(storage, info, sched, tenant="cli")
            finally:
                await sched.close()
            assert not bf[5]
            assert bf.sum() == info.num_pieces - 1

        run(go())

    def test_torn_file_marks_piece_failed_cpu(self):
        from torrent_tpu_torch.parallel.verify import verify_pieces_cpu

        info, storage = _build_torrent(16 * 16384, 16384, seed=11)
        orig = storage.read_piece

        def torn(i):
            if i == 5:
                raise OSError(5, "input/output error")
            return orig(i)

        storage.read_piece = torn
        bf = verify_pieces_cpu(storage, info)
        assert not bf[5]
        assert bf.sum() == info.num_pieces - 1

    def test_read_batch_zero_fills_on_oserror(self):
        """The bulk device-read path (Storage.read_batch) zero-fills a
        range whose backend leaks a raw OSError instead of raising — the
        hash mismatch flags the piece, co-batched pieces are unaffected."""
        info, storage = _build_torrent(8 * 16384, 16384, seed=4)
        orig = storage.method.get

        def flaky(path, off, size):
            if off == 3 * 16384:  # piece 3's range
                raise OSError(5, "input/output error")
            return orig(path, off, size)

        storage.method.get = flaky
        buf, lengths = storage.read_batch(range(8))
        assert not buf[3].any(), "torn range must zero-fill"
        assert bytes(buf[2][: lengths[2]]) == storage.read_piece(2)

    def test_launch_failure_leaves_pieces_unverified_not_fatal(self):
        """verify_pieces_sched: a retry-exhausted launch failure marks
        its pieces unverified (False) instead of aborting the pass."""
        from torrent_tpu_torch.parallel.verify import verify_pieces_sched

        async def go():
            info, storage = _build_torrent(16 * 16384, 16384, seed=21)
            # poison exactly piece 5 by matching its content prefix
            prefix = storage.read_piece(5)[:8]
            plan = FaultPlan(payload_prefix=prefix)
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=4,
                    flush_deadline=0.05,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            try:
                bf = await verify_pieces_sched(storage, info, sched, tenant="cli")
            finally:
                await sched.close()
            # the poisoned piece's submission chunk stays False (chunked
            # enqueue: pieces 4..7 share piece 5's submission future);
            # every piece outside that chunk verified
            assert not bf[5]
            assert bf[:4].all() and bf[8:].all()

        run(go())

    def test_library_sweep_survives_poisoned_torrent(self):
        """verify_library_sched: a poisoned piece in one torrent leaves
        that chunk unverified but the other torrents' results intact."""
        from torrent_tpu_torch.parallel.bulk import verify_library_sched

        async def go():
            items = [
                (storage, info)
                for info, storage in (
                    _build_torrent(24 * 4096, 4096, seed=i, name=f"t{i}")
                    for i in range(3)
                )
            ]
            prefix = items[1][0].read_piece(0)[:8]  # poison torrent 1
            plan = FaultPlan(payload_prefix=prefix)
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=8,
                    flush_deadline=0.1,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            try:
                res = await verify_library_sched(items, sched, tenant="bulk")
            finally:
                await sched.close()
            assert res.bitfields[0].all(), "torrent 0 lost to torrent 1's poison"
            assert res.bitfields[2].all(), "torrent 2 lost to torrent 1's poison"
            assert not res.bitfields[1].all()
            assert res.bitfields[1][8:].all(), "only the poisoned chunk may fail"

        run(go())

    def test_session_recheck_falls_back_locally_on_rejection(self):
        """A whole-queue rejection (scheduler shutting down) drops the
        session recheck to the local verify path — the torrent still
        rechecks complete, on the torrent's own hasher (here the plain
        device path on the CPU)."""

        async def go():
            from torrent_tpu_torch.codec.metainfo import Metainfo
            from torrent_tpu_torch.session.torrent import Torrent, TorrentConfig

            info, storage = _build_torrent(200_000, 16384, seed=7, name="heal")
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=8, flush_deadline=0.05), hasher="cpu"
            )
            await sched.close()  # enqueue now raises SchedRejected
            meta = Metainfo(
                announce="",
                info=info,
                info_hash=hashlib.sha1(b"heal").digest(),
                raw={},
            )
            torrent = Torrent(
                metainfo=meta,
                storage=storage,
                peer_id=b"-TT0001-xxxxxxxxxxxx",
                port=0,
                config=dataclasses.replace(
                    TorrentConfig(device="cpu", verify_batch_size=16), scheduler=sched
                ),
            )
            await torrent.recheck()
            assert torrent.bitfield.complete

        run(go())


class TestAbandonedSubmission:
    def test_disconnect_mid_submit_releases_bytes_and_waiters(self):
        """A submission future abandoned before demux (client gone) must
        not leak queued_bytes: accounting drains and a blocked admission
        waiter still gets through."""

        async def go():
            stall = _StallPlane()
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=1,
                    flush_deadline=0.01,
                    max_queue_bytes=64 << 10,
                    plane_factory=lambda a, b, t: stall,
                ),
                hasher="cpu",
            )
            try:
                fut = await sched.enqueue("gone", [b"x" * (32 << 10)])
                for _ in range(200):  # wait until the launch holds the bytes
                    if sched.metrics_snapshot()["queue_bytes"] > 0:
                        break
                    await asyncio.sleep(0.01)
                fut.cancel()  # client disconnected; nobody will await it
                del fut
                # 48 KiB doesn't fit beside the abandoned 32 KiB: blocks
                waiter = asyncio.ensure_future(
                    sched.submit("next", [b"y" * (48 << 10)], wait=True)
                )
                await asyncio.sleep(0.05)
                assert not waiter.done(), "waiter admitted over budget"
                stall.release.set()
                got = await asyncio.wait_for(waiter, 10)
                assert got == [hashlib.sha1(b"y" * (48 << 10)).digest()]
                for _ in range(200):
                    if sched.metrics_snapshot()["queue_bytes"] == 0:
                        break
                    await asyncio.sleep(0.01)
                assert sched.metrics_snapshot()["queue_bytes"] == 0, "leaked bytes"
            finally:
                stall.release.set()
                await sched.close()

        run(go())


# ------------------------------------------------------- differential


def _seeded(seed: int, n: int, plen: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=plen, dtype=np.uint8).tobytes() for _ in range(n)]


def _breakers(snap) -> dict:
    return {
        lane: {k: v for k, v in b.items() if k != "open_age_s"}
        for lane, b in snap["breakers"].items()
    }


async def _fault_run(sched, batches, algo):
    """Submit each batch in turn (deterministic launch ordinals); a
    failed submission records its error kind."""
    from torrent_tpu.sched import SchedLaunchError as RefLaunchError

    out = []
    for pieces in batches:
        try:
            out.append(await sched.submit("t", pieces, algo=algo, piece_length=512))
        except (SchedLaunchError, RefLaunchError) as e:
            out.append(("failed", e.kind))
    return out


class TestDifferential:
    """One fault-plan spec through both packages' device planes (the
    reference's on JAX's CPU backend, the port's on ``device="cpu"``),
    one lane, one launch in flight, submissions in a fixed order: the
    fault-tolerance counters must be equal, and every digest hashlib's."""

    @pytest.mark.parametrize("algo", ["sha1", "sha256"])
    @pytest.mark.parametrize(
        "spec", ["fail_first=3", "payload=POISON", "dead_after=2"],
        ids=["fail_first", "poisoned_prefix", "dead_after"],
    )
    def test_fault_counters_agree(self, spec, algo):
        from torrent_tpu.sched import FaultPlan as RefPlan
        from torrent_tpu.sched import HashPlaneScheduler as RefScheduler
        from torrent_tpu.sched import SchedulerConfig as RefConfig
        from torrent_tpu_torch.compat import scheduler_config_from_reference

        h = hashlib.sha1 if algo == "sha1" else hashlib.sha256
        batches = [_seeded(s, 6, 512) for s in range(4)]
        poison = batches[1][4][:4]
        spec = spec.replace("POISON", poison.hex())
        base = dict(
            batch_target=4, flush_deadline=0.02, pipeline_depth=1,
            breaker_threshold=3, breaker_cooldown=300.0, sha256_backend="scan",
        )

        async def go():
            ref = RefScheduler(
                RefConfig(**base, plane_factory=RefPlan.parse(spec).plane_factory(
                    hasher="tpu", sha256_backend="scan")),
                hasher="tpu",
            )
            port = HashPlaneScheduler(
                dataclasses.replace(
                    scheduler_config_from_reference(RefConfig(**base)),
                    plane_factory=FaultPlan.parse(spec).plane_factory(
                        hasher="gpu", device="cpu"),
                ),
                hasher="gpu", device="cpu",
            )
            outs, snaps = [], []
            for sched in (ref, port):
                try:
                    outs.append(await _fault_run(sched, batches, algo))
                finally:
                    await sched.close()
                snaps.append(sched.metrics_snapshot())
            assert outs[0] == outs[1]
            for got, pieces in zip(outs[1], batches):
                if got != ("failed", "deterministic"):
                    assert got == [h(p).digest() for p in pieces]
            r, p = snaps
            for key in ("launches", "launch_failures", "retries", "bisections",
                        "failed_pieces", "cpu_fallback_launches", "flush_reasons"):
                assert p[key] == r[key], (key, p[key], r[key])
            # state, failure count and every transition (an open
            # breaker's age is a clock reading, not a count)
            assert _breakers(p) == _breakers(r)
            return r

        r = run(go(), timeout=300)
        if spec.startswith("payload"):
            assert r["failed_pieces"] == 1
        else:
            assert r["cpu_fallback_launches"] > 0
