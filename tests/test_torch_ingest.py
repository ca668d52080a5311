"""The port's zero-copy ingest pipeline: disk→slot→device streaming.

The reference's tests/test_ingest.py, ported (its ``bench e2e`` rung
waits for the port's tools slice). Covers:

* ``read_pieces_into`` vs ``read_pieces_chunk`` differential — identical
  bitfields on multi-file torrents with torn/short/unreadable pieces,
  native engine present AND absent
* slab lifecycle: the leak counter returns to zero after every path —
  happy, shed, poisoned-ticket bisection, breaker CPU-fallback, and a
  mid-batch ``NativeIOError`` (regression: the slot is checked back in)
* the acceptance ledger assertions: no ``stage`` copy bytes on the
  happy path, read→h2d occupancy overlap (``max_concurrent_stages ≥ 2``)
  under the CPU-deterministic ``latency_ms`` H2D throttle, with the
  ``read`` stage now recorded by ``Storage.read_batch`` and the native
  pread pool
* scheduler semantics preserved under slot-backed submissions:
  admission shed, retry+bisection isolating a poisoned ticket while
  co-batched slot rows still verify, breaker degradation to the hashlib
  plane consuming per-row views
* ``native.io_engine.get_engine`` warn-once on a conflicting n_threads
"""

from __future__ import annotations

import asyncio
import hashlib
import os

import numpy as np
import pytest

from torrent_tpu_torch.obs.attrib import attribute
from torrent_tpu_torch.obs.ledger import pipeline_ledger
from torrent_tpu_torch.sched import (
    FaultPlan,
    HashPlaneScheduler,
    SchedRejected,
    SchedulerConfig,
)


def run(coro, timeout: float = 120.0):
    # a stuck lane fails its test instead of hanging the suite
    return asyncio.run(asyncio.wait_for(coro, timeout))


PLEN = 16384


def _mk_multifile(tmp_path, seed=7):
    """Multi-file torrent on disk whose pieces span file boundaries,
    then damage it: one file truncated mid-piece (torn/short) and one
    deleted outright (unreadable)."""
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.storage.storage import FsStorage, Storage
    from torrent_tpu_torch.tools.make_torrent import make_torrent

    root = os.path.join(str(tmp_path), "lib")
    src = os.path.join(root, "multi")
    os.makedirs(src)
    rng = np.random.default_rng(seed)
    sizes = [5 * PLEN + 1000, 3 * PLEN + 700, 4 * PLEN]
    for i, size in enumerate(sizes):
        with open(os.path.join(src, f"f{i}.bin"), "wb") as f:
            f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    meta = parse_metainfo(
        make_torrent(src, "http://t.invalid/announce", piece_length=PLEN, hasher="cpu")
    )
    # torn: truncate f1 mid-file; unreadable: delete f2 entirely
    f1 = os.path.join(src, "f1.bin")
    with open(f1, "r+b") as f:
        f.truncate(sizes[1] - 2 * PLEN)
    os.unlink(os.path.join(src, "f2.bin"))
    return Storage(FsStorage(root), meta.info), meta.info


def _mk_single(tmp_path, n_pieces=32, seed=3):
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.storage.storage import FsStorage, Storage
    from torrent_tpu_torch.tools.make_torrent import make_torrent

    payload = os.path.join(str(tmp_path), "data.bin")
    rng = np.random.default_rng(seed)
    with open(payload, "wb") as f:
        f.write(rng.integers(0, 256, n_pieces * PLEN, dtype=np.uint8).tobytes())
    meta = parse_metainfo(
        make_torrent(payload, "http://t.invalid/announce", piece_length=PLEN, hasher="cpu")
    )
    return Storage(FsStorage(str(tmp_path)), meta.info), meta.info


def _staging(sched) -> dict:
    return sched.metrics_snapshot()["staging"]


async def _recheck(storage, info, **cfg_kw):
    from torrent_tpu_torch.parallel.verify import verify_pieces_sched

    hasher = cfg_kw.pop("hasher", "cpu")
    device = cfg_kw.pop("device", "cpu")
    sched = HashPlaneScheduler(
        SchedulerConfig(batch_target=8, flush_deadline=0.02, **cfg_kw),
        hasher=hasher,
        device=device,
    )
    await sched.start()
    try:
        bf = await verify_pieces_sched(storage, info, sched)
    finally:
        await sched.close()
    return bf, sched


class TestDifferential:
    """read_pieces_into and read_pieces_chunk must produce identical
    bitfields — damaged pieces and all — whichever read backend runs."""

    def _both_paths(self, storage, info, monkeypatch):
        from torrent_tpu_torch.sched.scheduler import HashPlaneScheduler as S

        async def go():
            zero_bf, zsched = await _recheck(storage, info)
            assert _staging(zsched)["checkouts"] > 0, "zero-copy not used"
            assert _staging(zsched)["outstanding"] == 0
            # force the byte path: no slab checkout available
            monkeypatch.setattr(
                S, "checkout_staging", lambda self, *a, **k: None
            )
            byte_bf, bsched = await _recheck(storage, info)
            assert _staging(bsched)["checkouts"] == 0
            return zero_bf, byte_bf

        return run(go())

    def test_multifile_damaged_native(self, tmp_path, monkeypatch):
        from torrent_tpu_torch.native.io_engine import native_available

        if not native_available():
            pytest.skip("native engine unavailable")
        storage, info = _mk_multifile(tmp_path)
        zero_bf, byte_bf = self._both_paths(storage, info, monkeypatch)
        assert (zero_bf == byte_bf).all(), (zero_bf, byte_bf)
        # damage is visible: some pieces fail, the undamaged ones verify
        assert not zero_bf.all() and zero_bf.any()

    def test_multifile_damaged_python_fallback(self, tmp_path, monkeypatch):
        import torrent_tpu_torch.native.io_engine as io_engine

        monkeypatch.setattr(io_engine, "get_engine", lambda *a, **k: None)
        storage, info = _mk_multifile(tmp_path)
        zero_bf, byte_bf = self._both_paths(storage, info, monkeypatch)
        assert (zero_bf == byte_bf).all()
        assert not zero_bf.all() and zero_bf.any()

    def test_native_and_python_agree(self, tmp_path, monkeypatch):
        from torrent_tpu_torch.native.io_engine import native_available

        if not native_available():
            pytest.skip("native engine unavailable")
        storage, info = _mk_multifile(tmp_path)

        async def go():
            bf_native, s1 = await _recheck(storage, info)
            import torrent_tpu_torch.native.io_engine as io_engine

            monkeypatch.setattr(io_engine, "get_engine", lambda *a, **k: None)
            bf_py, s2 = await _recheck(storage, info)
            assert (bf_native == bf_py).all()
            assert _staging(s1)["outstanding"] == 0
            assert _staging(s2)["outstanding"] == 0

        run(go())

    def test_read_pieces_into_contract(self, tmp_path):
        """Direct contract check: failed rows dropped from rows/keep,
        readable rows staged + padded, creator release returns the slot."""
        from torrent_tpu_torch.parallel.verify import read_pieces_into

        storage, info = _mk_multifile(tmp_path)

        async def go():
            sched = HashPlaneScheduler(SchedulerConfig(), hasher="cpu")
            await sched.start()
            try:
                idxs = list(range(info.num_pieces))
                got = await asyncio.to_thread(
                    read_pieces_into, storage, info, idxs, sched
                )
                assert got is not None
                slab, rows, expected, keep = got
                assert len(rows) == len(keep) == len(expected)
                assert 0 < len(keep) < info.num_pieces  # damage dropped
                # staged rows hash to their expected digests in place
                for r, k in zip(rows, keep):
                    assert hashlib.sha1(slab.row(r)).digest() == info.pieces[k]
                # sentinel rows for everything not kept
                kept_rows = set(rows)
                for i in range(len(idxs)):
                    if i not in kept_rows:
                        assert slab.nblocks[i] == 0
                slab.release()
                assert _staging(sched)["outstanding"] == 0
            finally:
                await sched.close()

        run(go())


class TestSlabLifecycle:
    def test_native_error_midbatch_checks_slot_in(self, tmp_path, monkeypatch):
        """Regression: an engine-level NativeIOError mid-batch must not
        leak the checked-out slab — read_pieces_into returns the slot
        and reports None so callers fall back to the byte path."""
        from torrent_tpu_torch.native.io_engine import NativeIOError
        from torrent_tpu_torch.parallel.verify import read_pieces_into
        from torrent_tpu_torch.storage.storage import Storage

        storage, info = _mk_single(tmp_path)

        def boom(self, *a, **k):
            raise NativeIOError("injected mid-batch engine failure")

        monkeypatch.setattr(Storage, "read_batch", boom)

        async def go():
            sched = HashPlaneScheduler(SchedulerConfig(), hasher="cpu")
            await sched.start()
            try:
                got = read_pieces_into(
                    storage, info, list(range(8)), sched
                )
                assert got is None  # fell back, did not raise
                assert _staging(sched)["outstanding"] == 0
                assert _staging(sched)["checkouts"] == 1
            finally:
                await sched.close()

        run(go())

    def test_full_recheck_still_correct_after_native_error(
        self, tmp_path, monkeypatch
    ):
        """End to end: with read_batch broken, the session falls back to
        read_pieces_chunk and the bitfield is still complete."""
        from torrent_tpu_torch.native.io_engine import NativeIOError
        from torrent_tpu_torch.storage.storage import Storage

        storage, info = _mk_single(tmp_path)

        def boom(self, *a, **k):
            raise NativeIOError("injected")

        monkeypatch.setattr(Storage, "read_batch", boom)

        async def go():
            bf, sched = await _recheck(storage, info)
            assert bf.all()
            assert _staging(sched)["outstanding"] == 0

        run(go())

    def test_shed_releases_slab(self, tmp_path):
        """enqueue_staged over the admission bound sheds AND releases
        the per-ticket refs; the caller's release returns the slot."""
        storage, info = _mk_single(tmp_path, n_pieces=8)

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(max_queue_bytes=1, max_tenant_bytes=1),
                hasher="gpu", device="cpu",
            )
            await sched.start()
            try:
                slab = sched.checkout_staging(PLEN, 4)
                assert slab is not None
                storage.read_batch(
                    [0, 1, 2, 3],
                    out=slab.padded[:4, :PLEN],
                    row_status=np.zeros(4, dtype=bool),
                    zero_fill=False,
                )
                slab.prepare([PLEN] * 4)
                slab.finalize([True] * 4)
                with pytest.raises(SchedRejected):
                    await sched.enqueue_staged(
                        "t", slab, [0, 1, 2, 3],
                        expected=[info.pieces[i] for i in range(4)],
                    )
                slab.release()
                assert _staging(sched)["outstanding"] == 0
            finally:
                await sched.close()

        run(go())

    def test_poisoned_ticket_bisection_with_slots(self, tmp_path):
        """Poisoned-ticket semantics under zero-copy: a poisoned slot row's
        SUBMISSION fails alone (bisection isolates it; failure is per
        submission, as for byte payloads), innocent co-batched
        submissions — rows of OTHER slabs riding the same launch —
        still verify, and every slab comes back. chunk_pieces=1 also
        forces mixed-slab launches through the copying run path, so the
        per-ticket slab release is exercised across slabs."""
        from torrent_tpu_torch.parallel.verify import verify_pieces_sched

        storage, info = _mk_single(tmp_path, n_pieces=16)
        poisoned = 5
        prefix = storage.read_piece(poisoned)[:8]
        plan = FaultPlan(payload_prefix=prefix)

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=8, flush_deadline=0.02,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            await sched.start()
            try:
                bf = await verify_pieces_sched(
                    storage, info, sched, chunk_pieces=1
                )
            finally:
                await sched.close()
            assert not bf[poisoned]
            assert bf.sum() == info.num_pieces - 1
            snap = sched.metrics_snapshot()
            assert snap["bisections"] > 0
            assert _staging(sched)["outstanding"] == 0
            assert _staging(sched)["checkouts"] > 0  # slot path was used

        run(go())

    def test_breaker_cpu_fallback_with_slots(self, tmp_path):
        """Breaker trips to the hashlib plane mid-sweep; the fallback
        consumes per-row slab views and the bitfield stays complete."""
        storage, info = _mk_single(tmp_path, n_pieces=32)
        plan = FaultPlan(fail_first=4)

        async def go():
            bf, sched = await _recheck(
                storage, info,
                plane_factory=plan.plane_factory(hasher="cpu"),
                breaker_threshold=2,
                breaker_cooldown=3600.0,
                launch_retries=0,
                bisect_depth=2,
            )
            snap = sched.metrics_snapshot()
            assert snap["cpu_fallback_launches"] > 0
            assert _staging(sched)["outstanding"] == 0
            # pieces that fell into the failed launches stay False and
            # every piece hashed by the fallback verified
            assert bf.sum() + snap["failed_pieces"] == info.num_pieces

        run(go())


class TestPadFileSlabReuse:
    def test_pad_spans_hash_clean_from_dirty_slabs(self, tmp_path):
        """Regression (review finding): BEP 47 pad spans are virtual
        zeros the read paths must WRITE into a reused slab — zero_fill
        is off on the zero-copy path, so a slab dirtied by a previous
        torrent's rows would otherwise corrupt every pad-covering piece
        of a pad-file torrent."""
        from torrent_tpu_torch.codec.metainfo import parse_metainfo
        from torrent_tpu_torch.parallel.verify import verify_pieces_sched
        from torrent_tpu_torch.storage.storage import FsStorage, Storage
        from torrent_tpu_torch.tools.make_torrent import make_torrent

        # torrent A: random data that dirties the ingest slabs
        storage_a, info_a = _mk_single(tmp_path, n_pieces=16, seed=5)
        # torrent B: multi-file WITH pad files, same piece geometry so
        # both ride the same (algo, bucket) pool
        root = os.path.join(str(tmp_path), "padlib")
        src = os.path.join(root, "padded")
        os.makedirs(src)
        rng = np.random.default_rng(9)
        for i, size in enumerate([3 * PLEN + 123, 2 * PLEN + 77]):
            with open(os.path.join(src, f"g{i}.bin"), "wb") as f:
                f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        meta_b = parse_metainfo(
            make_torrent(src, "http://t.invalid/a", piece_length=PLEN,
                         pad_files=True, hasher="cpu")
        )
        storage_b = Storage(FsStorage(root), meta_b.info)
        assert any(
            getattr(e, "pad", False) for e in meta_b.info.files
        ), "fixture must actually contain pad files"

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=8, flush_deadline=0.02),
                hasher="cpu",
            )
            await sched.start()
            try:
                assert (await verify_pieces_sched(storage_a, info_a, sched)).all()
                # slabs are now dirty with A's bytes; B's pad spans must
                # still hash as zeros — twice, to also reuse B's own rows
                for _ in range(2):
                    bf = await verify_pieces_sched(
                        storage_b, meta_b.info, sched
                    )
                    assert bf.all(), bf
            finally:
                await sched.close()
            assert _staging(sched)["outstanding"] == 0

        run(go())


class TestLedgerAcceptance:
    """Acceptance: ledger-delta proof of the zero-copy path."""

    def test_no_stage_bytes_and_read_h2d_overlap(self, tmp_path):
        """Under the CPU-deterministic h2d throttle (`latency_ms`), the
        zero-copy scheduler-fed recheck stages ZERO copy bytes and shows
        read→h2d occupancy overlap (max_concurrent_stages ≥ 2)."""
        storage, info = _mk_single(tmp_path, n_pieces=64)
        plan = FaultPlan(latency_s=0.03)

        async def go():
            led = pipeline_ledger()
            prev = led.snapshot()
            bf, sched = await _recheck(
                storage, info,
                plane_factory=plan.plane_factory(hasher="cpu"),
                # a small admission bound paces the read loop against the
                # throttled launches, so reads provably run WHILE an h2d
                # is in flight (wait=True backpressure)
                max_queue_bytes=300_000,
                max_tenant_bytes=300_000,
            )
            assert bf.all()
            rep = attribute(led.snapshot(), prev=prev)
            # no per-piece bytes materialized, no staging copy
            assert rep["stages"].get("stage", {}).get("bytes", 0) == 0
            assert rep["stages"]["read"]["bytes"] == info.length
            # throttled h2d owns the pipeline...
            assert rep["bottleneck"]["stage"] == "h2d"
            # ...and the next chunk's read overlaps it (double buffering)
            assert rep["overlap"]["max_concurrent_stages"] >= 2
            assert rep["overlap"]["busy_s"] > 0
            assert _staging(sched)["outstanding"] == 0

        run(go())

    def test_device_plane_split_and_zero_stage(self, tmp_path):
        """The sha1 device plane now reports real h2d/launch/digest
        stages with zero stage-copy bytes on the
        zero-copy path."""
        storage, info = _mk_single(tmp_path, n_pieces=16)

        async def go():
            led = pipeline_ledger()
            prev = led.snapshot()
            bf, sched = await _recheck(storage, info, hasher="gpu", device="cpu")
            assert bf.all()
            rep = attribute(led.snapshot(), prev=prev)
            for stage in ("read", "h2d", "launch", "digest", "verdict"):
                assert rep["stages"].get(stage, {}).get("ops", 0) >= 1, (
                    stage, rep["stages"])
            assert rep["stages"].get("stage", {}).get("bytes", 0) == 0
            assert rep["stages"]["h2d"]["bytes"] == info.length
            assert _staging(sched)["outstanding"] == 0

        run(go())


class TestStagedSha256:
    def test_staged_sha256_digest_submission(self):
        """Slot-carrying submissions work on the v2 (sha256) lane too:
        digest mode, zero stage-copy, slab returned."""

        async def go():
            led = pipeline_ledger()
            prev = led.snapshot()
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=8, flush_deadline=0.05),
                hasher="gpu", device="cpu",
            )
            await sched.start()
            try:
                pieces = [bytes([i + 1]) * 2048 for i in range(6)]
                slab = sched.checkout_staging(2048, len(pieces), algo="sha256")
                assert slab is not None
                slab.prepare([len(p) for p in pieces])
                for i, p in enumerate(pieces):
                    slab.view[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
                slab.finalize([True] * len(pieces))
                fut = await sched.enqueue_staged(
                    "t", slab, list(range(len(pieces)))
                )
                slab.release()
                got = await fut
                assert got == [hashlib.sha256(p).digest() for p in pieces]
                assert _staging(sched)["outstanding"] == 0
            finally:
                await sched.close()
            rep = attribute(led.snapshot(), prev=prev)
            assert rep["stages"].get("stage", {}).get("bytes", 0) == 0
            assert rep["stages"].get("h2d", {}).get("ops", 0) >= 1

        run(go())


class TestEngineThreads:
    def test_get_engine_warns_once_on_conflicting_threads(self, monkeypatch):
        """First caller wins; a conflicting n_threads warns exactly once
        (and TT_IO_THREADS is the documented pre-sizing knob)."""
        import torrent_tpu_torch.native.io_engine as io_engine

        if not io_engine.native_available():
            pytest.skip("native engine unavailable")
        engine = io_engine.get_engine()  # ensure the global exists
        assert engine is not None
        monkeypatch.setattr(io_engine, "_threads_conflict_warned", False)
        import logging

        records: list = []

        class _H(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())

        h = _H()
        logging.getLogger("torrent_tpu_torch.native").addHandler(h)
        try:
            assert io_engine.get_engine(n_threads=3) is engine
            assert io_engine.get_engine(n_threads=3) is engine
        finally:
            logging.getLogger("torrent_tpu_torch.native").removeHandler(h)
        conflict = [m for m in records if "first caller wins" in m]
        assert len(conflict) == 1, records
