"""The port's observability plane (torrent_tpu_torch/obs): span tracer,
latency histograms, flight recorder, pipeline ledger and bottleneck
attributor, and their scheduler integrations.

The cases of the reference's tests/test_obs.py and tests/test_pipeline.py
that touch only ported modules, ported. The bridge, sanitizer,
trace-CLI, ``doctor``, ``bench``, ``top`` and trajectory cases wait for
later slices (ROADMAP.md lists them). The profiler case runs on
``torch.profiler`` in place of ``jax.profiler``.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import os
import threading
import time

import numpy as np
import pytest

from torrent_tpu_torch.obs import (
    fabric_trace_id,
    flight_recorder,
    heartbeat_span_context,
    histograms,
    tracer,
    valid_trace_id,
)
from torrent_tpu_torch.obs.attrib import attribute, format_report
from torrent_tpu_torch.obs.hist import BUCKET_BOUNDS, HistogramRegistry
from torrent_tpu_torch.obs.ledger import (
    PIPELINE_STAGES,
    PipelineLedger,
    pipeline_ledger,
    render_pipeline_metrics,
)
from torrent_tpu_torch.obs.recorder import FlightRecorder, _redact
from torrent_tpu_torch.obs.tracer import Tracer

from test_metrics import prom_lint


def run(coro, timeout: float = 120.0):
    # a stuck lane fails its test instead of hanging the suite
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(autouse=True)
def _fresh_recorder():
    """Dump counts are asserted exactly; start each test clean (the
    recorder is process-global by design)."""
    flight_recorder().clear()
    yield
    flight_recorder().clear()


def span_names(tree):
    def walk(node):
        yield node["name"]
        for c in node["children"]:
            yield from walk(c)

    return [n for root in tree["spans"] for n in walk(root)]


def flat_spans(tree):
    def walk(node):
        yield node
        for c in node["children"]:
            yield from walk(c)

    return [s for root in tree["spans"] for s in walk(root)]


# --------------------------------------------------------------- tracer


class TestTracer:
    def test_span_nesting_and_tree_order(self):
        t = Tracer()
        tid = "t-nest"
        with t.span("root", trace_id=tid) as rid:
            with t.span("child-a"):
                pass
            with t.span("child-b"):
                pass
        tree = t.trace_tree(tid)
        assert tree["span_count"] == 3
        root = tree["spans"][0]
        assert root["name"] == "root" and root["span_id"] == rid
        assert [c["name"] for c in root["children"]] == ["child-a", "child-b"]
        # monotonic: every child starts at/after the root, durations >= 0
        for s in flat_spans(tree):
            assert s["start_ms"] >= 0 and s["duration_ms"] >= 0

    def test_span_without_context_is_noop(self):
        t = Tracer()
        with t.span("orphan") as sid:
            assert sid is None
        assert t.trace_ids() == []

    def test_error_status_recorded(self):
        t = Tracer()
        with pytest.raises(ValueError):
            with t.span("boom", trace_id="t-err"):
                raise ValueError("nope")
        tree = t.trace_tree("t-err")
        span = tree["spans"][0]
        assert span["status"] == "error"
        assert "nope" in span["attrs"]["error"]

    def test_attr_cleaning_strips_payload_bytes(self):
        t = Tracer()
        t.add_span("t-attr", "s", payload=b"\x00" * 4096, note="x" * 500, n=3)
        attrs = t.trace_tree("t-attr")["spans"][0]["attrs"]
        assert attrs["payload"] == "<4096 bytes>"
        assert len(attrs["note"]) <= 201 and attrs["note"].endswith("…")
        assert attrs["n"] == 3

    def test_trace_store_is_bounded(self):
        t = Tracer(max_traces=4, max_spans_per_trace=3)
        for i in range(10):
            t.add_span(f"t{i}", "s")
        assert len(t.trace_ids()) == 4
        for _ in range(10):
            t.add_span("t9", "extra")
        tree = t.trace_tree("t9")
        assert tree["span_count"] == 3
        assert tree["dropped_spans"] == 8

    def test_trace_id_validation(self):
        assert valid_trace_id("t1")
        assert valid_trace_id("a-b_c.9" * 8)
        assert not valid_trace_id("")
        assert not valid_trace_id("x" * 65)
        assert not valid_trace_id("bad id\n")
        assert not valid_trace_id('q"uote')

    def test_mint_is_unique(self):
        t = Tracer()
        ids = {t.mint() for _ in range(100)}
        assert len(ids) == 100
        assert all(valid_trace_id(i) for i in ids)

    def test_fabric_ids_deterministic(self):
        assert fabric_trace_id("abcdef0123456789", 3) == fabric_trace_id(
            "abcdef0123456789", 3
        )
        ctx = heartbeat_span_context(fabric_trace_id("abcdef0123456789", 3), 7)
        assert ctx == {"seq": 7, "trace": "fabric-abcdef012345-p3"}


# ----------------------------------------------------------- histograms


class TestHistograms:
    def test_bucket_placement_and_render(self):
        reg = HistogramRegistry()
        h = reg.get("x_seconds", help="test family", lane="sha1/64")
        h.observe(0.0)  # below the lowest bound -> first bucket
        h.observe(1.5)  # between 1 and 2 -> le=2 bucket
        h.observe(1e9)  # beyond every bound -> +Inf only
        counts, count, total = h.snapshot()
        assert count == 3 and total == pytest.approx(1e9 + 1.5)
        assert counts[0] == 1 and counts[-1] == 1
        text = reg.render()
        assert "# TYPE x_seconds histogram" in text
        # cumulative: +Inf bucket equals _count
        assert 'x_seconds_bucket{lane="sha1/64",le="+Inf"} 3' in text
        assert 'x_seconds_count{lane="sha1/64"} 3' in text
        # every configured bound appears
        assert text.count("x_seconds_bucket{") == len(BUCKET_BOUNDS) + 1

    def test_cumulative_monotone(self):
        reg = HistogramRegistry()
        h = reg.get("y_seconds")
        h.observe_batch([2.0 ** k for k in range(-20, 8)])
        lines = [
            line for line in reg.render().splitlines() if "y_seconds_bucket" in line
        ]
        values = [int(line.rsplit(" ", 1)[1]) for line in lines]
        assert values == sorted(values)
        assert values[-1] == h.snapshot()[1]

    def test_observe_batch_matches_singles(self):
        reg = HistogramRegistry()
        a = reg.get("a_seconds")
        b = reg.get("b_seconds")
        vals = [0.001, 0.5, 3.0, 70.0]
        a.observe_batch(vals)
        for v in vals:
            b.observe(v)
        assert a.snapshot()[0] == b.snapshot()[0]

    def test_label_cardinality_bounded(self):
        reg = HistogramRegistry(max_series=4)
        for i in range(50):
            reg.get("z_seconds", tenant=f"t{i}").observe(0.01)
        text = reg.render()
        # 4 real series + the shared overflow series
        assert text.count("z_seconds_count") == 5
        assert 'z_seconds_count{overflow="true"} 46' in text


# ------------------------------------------------------ flight recorder


class TestFlightRecorder:
    def test_redaction(self):
        redacted = _redact(
            {"payload": b"\xff" * 1000, "msg": "y" * 1000, "n": 7,
             "nested": {"deep": [b"zz", "ok"]}}
        )
        assert redacted["payload"] == "<1000 bytes>"
        assert len(redacted["msg"]) <= 301
        assert redacted["n"] == 7
        assert redacted["nested"]["deep"] == ["<2 bytes>", "ok"]
        json.dumps(redacted)  # must be JSON-clean

    def test_trigger_bounded_ring_and_counts(self):
        rec = FlightRecorder(max_dumps=3)
        for i in range(5):
            rec.trigger("breaker_open", detail={"i": i})
        dumps = rec.dumps()
        assert len(dumps) == 3
        assert [d["detail"]["i"] for d in dumps] == [2, 3, 4]
        assert rec.counts() == {"breaker_open": 5}
        assert (
            'torrent_tpu_flight_dumps_total{reason="breaker_open"} 5'
            in rec.render_metrics()
        )

    def test_dump_carries_named_traces(self):
        t = tracer()
        tid = t.mint()
        t.add_span(tid, "the-failing-span")
        dump = flight_recorder().trigger("retry_exhausted", trace_ids=[tid])
        assert tid in dump["traces"]
        assert "the-failing-span" in span_names(dump["traces"][tid])

    def test_dump_written_to_flight_dir(self, tmp_path, monkeypatch):
        monkeypatch.setenv("TORRENT_TPU_FLIGHT_DIR", str(tmp_path))
        dump = flight_recorder().trigger("fabric_distrust", detail={"unit": 1})
        # filename carries a per-run token (a restarted process must not
        # overwrite the previous run's evidence) + the dump seq
        pattern = f"blackbox_*_{dump['seq']:04d}.json"
        deadline = time.monotonic() + 5  # written off-thread
        while not list(tmp_path.glob(pattern)) and time.monotonic() < deadline:
            time.sleep(0.01)
        (path,) = tmp_path.glob(pattern)
        on_disk = json.loads(path.read_text())
        assert on_disk["reason"] == "fabric_distrust"
        assert on_disk["detail"] == {"unit": 1}


# ------------------------------------------------- scheduler lifecycle


class TestSchedulerTracing:
    def test_traced_submission_full_lifecycle(self):
        from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig

        async def go():
            t = tracer()
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=8, flush_deadline=0.02),
                hasher="cpu",
            )
            await sched.start()
            try:
                pieces = [bytes([i]) * 512 for i in range(4)]
                exp = [hashlib.sha1(p).digest() for p in pieces]
                tid = t.mint()
                with t.span("request", trace_id=tid):
                    ok = await sched.submit("acme", pieces, expected=exp)
                assert ok == b"\x01" * 4
            finally:
                await sched.close()
            tree = t.trace_tree(tid)
            names = span_names(tree)
            for stage in ("sched.enqueue", "sched.admission",
                          "sched.lane_wait", "sched.launch", "sched.digest",
                          "sched.verdict"):
                assert stage in names, names
            # ordered: start offsets are non-decreasing through the chain
            by_name = {s["name"]: s for s in flat_spans(tree)}
            chain = ["sched.enqueue", "sched.lane_wait", "sched.launch",
                     "sched.digest"]
            starts = [by_name[n]["start_ms"] for n in chain]
            assert starts == sorted(starts)
            assert by_name["sched.verdict"]["attrs"]["valid"] == 4

        run(go())

    def test_shed_records_error_span(self):
        from torrent_tpu_torch.sched import (
            HashPlaneScheduler,
            SchedRejected,
            SchedulerConfig,
        )

        async def go():
            t = tracer()
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=4, max_queue_bytes=64,
                                max_tenant_bytes=64),
                hasher="cpu",
            )
            await sched.start()
            try:
                tid = t.mint()
                with t.span("request", trace_id=tid):
                    with pytest.raises(SchedRejected):
                        await sched.submit("greedy", [b"x" * 4096])
            finally:
                await sched.close()
            tree = t.trace_tree(tid)
            shed = [s for s in flat_spans(tree) if s["name"] == "sched.shed"]
            assert len(shed) == 1 and shed[0]["status"] == "error"
            assert shed[0]["attrs"]["reason"] == "queue full"

        run(go())

    def test_retry_exhausted_exactly_one_dump(self):
        from torrent_tpu_torch.sched import (
            FaultPlan,
            HashPlaneScheduler,
            SchedLaunchError,
            SchedulerConfig,
        )

        async def go():
            t = tracer()
            plan = FaultPlan(payload_prefix=b"\xbd\xbd")
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=4, flush_deadline=0.02,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            await sched.start()
            tid = t.mint()
            try:
                with t.span("request", trace_id=tid):
                    with pytest.raises(SchedLaunchError):
                        await sched.submit("bad", [b"\xbd\xbd" + b"p" * 64])
            finally:
                await sched.close()
            dumps = flight_recorder().dumps()
            assert [d["reason"] for d in dumps] == ["retry_exhausted"]
            dump = dumps[0]
            # the dump carries the failing ticket's spans...
            assert tid in dump["traces"]
            names = span_names(dump["traces"][tid])
            assert "sched.launch" in names and "sched.digest" in names
            launch = [
                s for s in flat_spans(dump["traces"][tid])
                if s["name"] == "sched.launch"
            ][0]
            assert launch["status"] == "error"
            assert launch["attrs"]["kind"] == "deterministic"
            # ...and the breaker/scheduler state
            sched_snap = dump["snapshots"]["sched"]
            assert sched_snap["failed_pieces"] == 1
            assert "sha1/128" in sched_snap["breakers"]

        run(go())

    def test_bisected_double_failure_single_digest_span(self):
        """A submission whose halves BOTH terminally fail must get one
        sched.digest span, not one per failing demux."""
        from torrent_tpu_torch.sched import (
            FaultPlan,
            HashPlaneScheduler,
            SchedLaunchError,
            SchedulerConfig,
        )

        async def go():
            t = tracer()
            plan = FaultPlan(payload_prefix=b"\xbd\xbd")
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=2, flush_deadline=0.02,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            await sched.start()
            tid = t.mint()
            try:
                with t.span("request", trace_id=tid):
                    with pytest.raises(SchedLaunchError):
                        # both pieces poisoned: the bisected halves each
                        # fail terminally in separate demux calls
                        await sched.submit(
                            "bad", [b"\xbd\xbd" + b"a" * 64, b"\xbd\xbd" + b"b" * 64]
                        )
            finally:
                await sched.close()
            spans = flat_spans(t.trace_tree(tid))
            assert len([s for s in spans if s["name"] == "sched.digest"]) == 1

        run(go())

    def test_breaker_open_exactly_one_dump(self):
        from torrent_tpu_torch.sched import (
            FaultPlan,
            HashPlaneScheduler,
            SchedulerConfig,
        )

        async def go():
            plan = FaultPlan(fail_first=2)
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=4, flush_deadline=0.02, breaker_threshold=2,
                    launch_retries=2, breaker_cooldown=300.0,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            await sched.start()
            try:
                pieces = [bytes([i]) * 128 for i in range(2)]
                want = [hashlib.sha1(p).digest() for p in pieces]
                # two transient failures trip the breaker; the third
                # attempt rides the CPU fallback and succeeds
                assert await sched.submit("t", pieces) == want
                snap = sched.metrics_snapshot()
                assert next(iter(snap["breakers"].values()))["state"] == "open"
            finally:
                await sched.close()
            dumps = flight_recorder().dumps()
            assert [d["reason"] for d in dumps] == ["breaker_open"]
            breakers = dumps[0]["snapshots"]["sched"]["breakers"]
            assert next(iter(breakers.values()))["state"] == "open"

        run(go())

    def test_stage_histograms_recorded(self):
        from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig

        async def go():
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=4, flush_deadline=0.02),
                hasher="cpu",
            )
            await sched.start()
            try:
                await sched.submit("histo-tenant", [b"q" * 256])
            finally:
                await sched.close()
            text = histograms().render()
            assert "torrent_tpu_sched_queue_wait_seconds_bucket" in text
            assert "torrent_tpu_sched_launch_seconds_sum" in text
            assert (
                'torrent_tpu_sched_e2e_seconds_count{tenant="histo-tenant"}'
                in text
            )

        run(go())


# -------------------------------------------------------------- bridge


async def _http(port, method, path, headers=None, body=b""):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    head = [f"{method} {path} HTTP/1.1", "Host: x",
            f"Content-Length: {len(body)}"]
    for k, v in (headers or {}).items():
        head.append(f"{k}: {v}")
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    hdrs = {}
    clen = 0
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b""):
            break
        if b":" in line:
            k, _, v = line.partition(b":")
            hdrs[k.strip().lower().decode()] = v.strip().decode()
            if k.strip().lower() == b"content-length":
                clen = int(v)
    resp = await reader.readexactly(clen)
    writer.close()
    return status, hdrs, resp


# ------------------------------------------------- satellites: log/env


class TestLogSatellites:
    def _fresh_root(self, monkeypatch, name):
        """Re-run first-configure against a scratch logger hierarchy.
        Its names are the port's own: a handler this test leaves on a
        logger holds the captured stderr of its run, and would break the
        reference's same test (tests/test_obs.py) run after it in one
        process."""
        from torrent_tpu_torch.utils import log as tlog

        monkeypatch.setattr(tlog, "_configured", False)
        monkeypatch.setattr(tlog, "_ROOT", name)
        return tlog

    def test_json_lines_with_trace_id(self, monkeypatch, capsys):
        monkeypatch.setenv("TORRENT_TPU_LOG_JSON", "1")
        monkeypatch.setenv("TORRENT_TPU_LOG", "INFO")
        tlog = self._fresh_root(monkeypatch, "port_tlogjson")
        logger = tlog.get_logger("sub.system")
        t = tracer()
        with t.span("ctx", trace_id="t-log"):
            logger.info("hello %s", "world")
        err = capsys.readouterr().err.strip().splitlines()[-1]
        rec = json.loads(err)
        assert rec["level"] == "INFO"
        assert rec["subsystem"] == "sub.system"
        assert rec["msg"] == "hello world"
        assert rec["trace_id"] == "t-log"
        assert isinstance(rec["ts"], float)

    def test_invalid_level_warns_once_and_falls_back(self, monkeypatch, capsys):
        monkeypatch.delenv("TORRENT_TPU_LOG_JSON", raising=False)
        monkeypatch.setenv("TORRENT_TPU_LOG", "DEUBG")
        tlog = self._fresh_root(monkeypatch, "port_tlogwarn")
        logger = tlog.get_logger("x")
        tlog.get_logger("y")  # second call: no second warning
        assert logging.getLogger("port_tlogwarn").level == logging.WARNING
        err = capsys.readouterr().err
        assert err.count("invalid TORRENT_TPU_LOG level 'DEUBG'") == 1
        logger.debug("must not raise")


class TestProfilerSatellite:
    def test_env_resolved_lazily_per_call(self, monkeypatch):
        from torrent_tpu_torch.obs import profiler

        monkeypatch.delenv("TORRENT_TPU_PROFILE", raising=False)
        assert profiler.profile_dir() is None
        # enabling AFTER import must take effect (the old utils/trace.py
        # read the env at import time and ignored later changes)
        monkeypatch.setenv("TORRENT_TPU_PROFILE", "/tmp/prof")
        assert profiler.profile_dir() == "/tmp/prof"
        monkeypatch.setenv("TORRENT_TPU_PROFILE_BATCHES", "3")
        assert profiler.profile_batches() == 3
        monkeypatch.setenv("TORRENT_TPU_PROFILE_BATCHES", "junk")
        assert profiler.profile_batches() == 8
        monkeypatch.setenv("TORRENT_TPU_PROFILE_BATCHES", "-2")
        assert profiler.profile_batches() == 8

    def test_profiler_capture_lifecycle(self, monkeypatch, tmp_path):
        """The capture starts on the first batch, stops after N and
        writes one Chrome trace (torch.profiler, on the CPU here); later
        batches run as plain ``record_function`` regions."""
        from torrent_tpu_torch.obs import profiler

        monkeypatch.setattr(profiler, "_prof", None)
        monkeypatch.setattr(profiler, "_trace_done", False)
        monkeypatch.setattr(profiler, "_batches_seen", 0)
        monkeypatch.setenv("TORRENT_TPU_PROFILE", str(tmp_path))
        monkeypatch.setenv("TORRENT_TPU_PROFILE_BATCHES", "2")
        for i in range(3):
            with profiler.maybe_profile_batch(f"b{i}"):
                sum(range(1000))
            if i == 0:
                assert profiler._prof is not None
        assert profiler._trace_done and profiler._prof is None
        trace = json.loads((tmp_path / profiler.TRACE_NAME).read_text())
        names = {e.get("name") for e in trace.get("traceEvents", [])}
        assert {"b0", "b1"} <= names and "b2" not in names

    def test_flush_trace_writes_an_open_capture(self, monkeypatch, tmp_path):
        """Batches in several worker threads (as the scheduler's launches
        run) are captured, and the capture is written when another
        thread flushes, not only at interpreter exit; a second flush and
        a flush with no capture return None."""
        from concurrent.futures import ThreadPoolExecutor

        from torrent_tpu_torch.obs import profiler

        monkeypatch.setattr(profiler, "_prof", None)
        monkeypatch.setattr(profiler, "_trace_done", False)
        monkeypatch.setattr(profiler, "_batches_seen", 0)
        monkeypatch.setenv("TORRENT_TPU_PROFILE", str(tmp_path))
        monkeypatch.setenv("TORRENT_TPU_PROFILE_BATCHES", "1000")

        def batch(i):
            with profiler.maybe_profile_batch(f"f{i}"):
                sum(range(1000))
            return threading.get_ident()

        with ThreadPoolExecutor(2) as pool:
            threads = {pool.submit(batch, 0).result(), pool.submit(batch, 1).result()}
        assert threading.get_ident() not in threads
        assert profiler._prof is not None
        path = profiler.flush_trace()
        assert path == str(tmp_path / profiler.TRACE_NAME)
        assert profiler._trace_done and profiler._prof is None
        names = {e.get("name") for e in json.loads(open(path).read())["traceEvents"]}
        assert {"f0", "f1"} <= names
        assert profiler.flush_trace() is None
        # a CPU-only capture holds no device events
        busy = profiler.device_busy(path)
        assert busy["kernels"] == busy["copies"] == 0 and busy["busy_s"] == 0.0

    def test_device_busy_takes_the_union_of_device_intervals(self, tmp_path):
        """Kernel and copy intervals that overlap count once in
        ``busy_s``; host events and GPU annotations count nowhere."""
        from torrent_tpu_torch.obs import profiler

        def ev(cat, name, ts, dur, ph="X"):
            return {"ph": ph, "cat": cat, "name": name, "ts": ts, "dur": dur}

        events = [
            ev("kernel", "sha1_kernel", 100.0, 50.0),
            ev("kernel", "sha1_kernel", 120.0, 50.0),  # overlaps: 100-170
            ev("kernel", "sha256_rows_kernel", 300.0, 10.0),
            ev("gpu_memcpy", "Memcpy HtoD", 160.0, 40.0),  # 160-200
            ev("gpu_memset", "Memset", 400.0, 5.0),
            ev("cpu_op", "aten::copy_", 0.0, 1000.0),
            ev("gpu_user_annotation", "sched_sha1_launch_b16384", 90.0, 500.0),
            ev("kernel", "counter", 0.0, 0.0, ph="i"),
        ]
        path = tmp_path / "t.json"
        path.write_text(json.dumps({"traceEvents": events}))
        busy = profiler.device_busy(str(path))
        assert busy["kernels"] == 3 and busy["copies"] == 2
        assert busy["kernel_names"] == {"sha1_kernel": 2, "sha256_rows_kernel": 1}
        assert busy["kernel_s"] == pytest.approx((70 + 10) / 1e6)
        assert busy["copy_s"] == pytest.approx((40 + 5) / 1e6)
        # 100-200, 300-310, 400-405
        assert busy["busy_s"] == pytest.approx((100 + 10 + 5) / 1e6)
        assert busy["span_s"] == pytest.approx((405 - 100) / 1e6)




# ------------------------------------------------- pipeline ledger


def _mk_torrent(tmp_path, n_pieces=32, plen=16384, seed=11):
    """Synthetic single-file v1 torrent on disk + its FsStorage."""
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.storage.storage import FsStorage, Storage
    from torrent_tpu_torch.tools.make_torrent import make_torrent

    payload = os.path.join(str(tmp_path), "data.bin")
    rng = np.random.default_rng(seed)
    with open(payload, "wb") as f:
        f.write(rng.integers(0, 256, n_pieces * plen, dtype=np.uint8).tobytes())
    meta = parse_metainfo(
        make_torrent(payload, "http://t.invalid/announce", piece_length=plen, hasher="cpu")
    )
    return Storage(FsStorage(str(tmp_path)), meta.info), meta.info




class TestLedger:
    def test_track_and_record_accounting(self):
        led = PipelineLedger()
        with led.track("read", 100):
            time.sleep(0.002)
        led.record("launch", 50, 0.5)
        snap = led.snapshot()
        assert snap["stages"]["read"]["bytes"] == 100
        assert snap["stages"]["read"]["ops"] == 1
        assert snap["stages"]["read"]["busy_s"] > 0.001
        assert snap["stages"]["read"]["active"] == 0
        assert snap["stages"]["read"]["max_active"] == 1
        assert snap["stages"]["launch"] == {
            "busy_s": 0.5, "bytes": 50, "ops": 1, "active": 0, "max_active": 0,
        }
        assert snap["t_last"] >= snap["t_first"]

    def test_tracked_byte_accumulation(self):
        led = PipelineLedger()
        with led.track("read") as t:
            t.add(10)
            t.add(20)
        assert led.snapshot()["stages"]["read"]["bytes"] == 30

    def test_occupancy_counts_overlap(self):
        led = PipelineLedger()
        a = led.track("h2d", 1)
        b = led.track("h2d", 1)
        a.__enter__()
        b.__enter__()
        assert led.snapshot()["stages"]["h2d"]["active"] == 2
        b.__exit__(None, None, None)
        a.__exit__(None, None, None)
        s = led.snapshot()["stages"]["h2d"]
        assert s["active"] == 0 and s["max_active"] == 2 and s["ops"] == 2

    def test_unknown_stage_cardinality_bound(self):
        led = PipelineLedger()
        for i in range(40):
            led.record(f"weird{i}", 1, 0.0)
        snap = led.snapshot()
        # canonical stages always fit; extras fold into "other"
        assert len(snap["stages"]) <= 17
        assert "other" in snap["stages"]

    def test_exception_in_tracked_body_still_records(self):
        led = PipelineLedger()
        with pytest.raises(ValueError):
            with led.track("stage", 5):
                raise ValueError("boom")
        s = led.snapshot()["stages"]["stage"]
        assert s["ops"] == 1 and s["active"] == 0

    def test_clear(self):
        led = PipelineLedger()
        led.record("read", 1, 0.1)
        led.clear()
        snap = led.snapshot()
        assert snap["stages"] == {} and snap["t_first"] is None


class TestAttrib:
    def test_idle_snapshot(self):
        rep = attribute(PipelineLedger().snapshot())
        assert rep["bottleneck"] is None
        assert "idle" in format_report(rep)

    def test_limiting_stage_and_demanded_rate(self):
        led = PipelineLedger()
        # h2d: 0.8s busy for 8 MiB (10 MiB/s); read: 0.1s for 100 MiB
        led.record("read", 100 << 20, 0.1)
        led.record("h2d", 8 << 20, 0.8)
        led.record("verdict", 8 << 20, 0.01)
        rep = attribute(led.snapshot())
        bn = rep["bottleneck"]
        assert bn["stage"] == "h2d"
        assert bn["achieved_bps"] == pytest.approx(10 * (1 << 20), rel=0.01)
        # demanded = the fastest other stage (read at 1000 MiB/s)
        assert bn["demanded_bps"] == pytest.approx(1000 * (1 << 20), rel=0.01)
        assert bn["headroom"] == pytest.approx(100, rel=0.05)
        assert rep["pipeline_bytes"] == 8 << 20
        assert "h2d limits the pipeline" in format_report(rep)

    def test_interval_delta(self):
        led = PipelineLedger()
        led.record("read", 100, 1.0)
        prev = led.snapshot()
        led.record("h2d", 100, 2.0)
        rep = attribute(led.snapshot(), prev=prev)
        assert rep["stages"]["read"]["busy_s"] == 0.0
        assert rep["stages"]["h2d"]["busy_s"] == 2.0
        assert rep["bottleneck"]["stage"] == "h2d"

    def test_delta_anchors_at_snapshot_not_last_activity(self):
        """Idle time between a previous run and the prev snapshot must
        not dilute the next interval's utilization: the wall anchors at
        prev's t_snap (when it was taken), not its t_last (when the
        previous activity ended)."""
        prev = {
            "stages": {"read": {"busy_s": 0.1, "bytes": 10, "ops": 1}},
            "t_first": 90.0, "t_last": 100.0, "t_snap": 200.0,
        }
        cur = {
            "stages": {
                "read": {"busy_s": 0.1, "bytes": 10, "ops": 1},
                "h2d": {"busy_s": 0.9, "bytes": 10, "ops": 1},
            },
            "t_first": 90.0, "t_last": 201.0, "t_snap": 201.0,
        }
        rep = attribute(cur, prev=prev)
        # wall = 201 - 200 (snapshot anchor), NOT 201 - 100
        assert rep["wall_s"] == pytest.approx(1.0)
        assert rep["bottleneck"]["stage"] == "h2d"
        assert rep["bottleneck"]["utilization"] == pytest.approx(0.9)

    def test_stage_order_constant(self):
        assert PIPELINE_STAGES == ("recv", "read", "stage", "h2d", "launch",
                                   "digest", "verdict", "egress")


class TestRenderer:
    def test_fresh_ledger_renders_clean(self):
        text = render_pipeline_metrics(PipelineLedger())
        prom_lint(text)
        assert "torrent_tpu_pipeline_wall_seconds 0" in text

    def test_active_ledger_renders_and_lints(self):
        led = PipelineLedger()
        led.record("read", 1024, 0.1)
        led.record("h2d", 1024, 0.9)
        text = render_pipeline_metrics(led)
        prom_lint(text)
        assert 'torrent_tpu_pipeline_stage_bytes_total{stage="read"} 1024' in text
        assert 'torrent_tpu_pipeline_bottleneck{stage="h2d"} 1' in text
        assert 'torrent_tpu_pipeline_bottleneck{stage="read"} 0' in text


class TestSchedulerInstrumentation:
    def test_cpu_plane_records_read_launch_verdict(self, tmp_path):
        from torrent_tpu_torch.parallel.verify import verify_pieces_sched
        from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig

        async def go():
            storage, info = _mk_torrent(tmp_path, n_pieces=8)
            led = pipeline_ledger()
            prev = led.snapshot()
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=8, flush_deadline=0.02),
                hasher="cpu",
            )
            await sched.start()
            try:
                bf = await verify_pieces_sched(storage, info, sched)
            finally:
                await sched.close()
            assert bf.all()
            rep = attribute(led.snapshot(), prev=prev)
            for stage in ("read", "launch", "verdict"):
                assert rep["stages"].get(stage, {}).get("ops", 0) >= 1, (
                    stage, rep["stages"])
            assert rep["stages"]["read"]["bytes"] == info.length
            assert rep["stages"]["verdict"]["bytes"] == info.length

        run(go())

    def test_device_plane_records_stage_h2d_launch_digest(self):
        """The sha256 plane (its plain PyTorch version here) reports the
        full stage split: staging copy, device copy, launch, D2H."""
        from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig

        async def go():
            led = pipeline_ledger()
            prev = led.snapshot()
            sched = HashPlaneScheduler(
                SchedulerConfig(batch_target=8, flush_deadline=0.05),
                hasher="gpu", device="cpu",
            )
            await sched.start()
            try:
                pieces = [bytes([i + 1]) * 2048 for i in range(8)]
                got = await sched.submit(
                    "t", pieces, algo="sha256", piece_length=2048
                )
                assert got == [hashlib.sha256(p).digest() for p in pieces]
            finally:
                await sched.close()
            rep = attribute(led.snapshot(), prev=prev)
            for stage in ("stage", "h2d", "launch", "digest", "verdict"):
                assert rep["stages"].get(stage, {}).get("ops", 0) >= 1, (
                    stage, rep["stages"])

        run(go())


class TestBottleneckAcceptance:
    """Acceptance: latency-injected H2D throttling must be named
    by the attributor, by doctor --bottleneck, and by GET /v1/pipeline.
    Deterministic and CPU-only throughout."""

    def test_throttled_library_sched_names_h2d_majority(self, tmp_path):
        from torrent_tpu_torch.parallel.bulk import verify_library_sched
        from torrent_tpu_torch.sched import (
            FaultPlan,
            HashPlaneScheduler,
            SchedulerConfig,
        )

        async def go():
            storage, info = _mk_torrent(tmp_path, n_pieces=48)
            led = pipeline_ledger()
            prev = led.snapshot()
            plan = FaultPlan(latency_s=0.03)
            sched = HashPlaneScheduler(
                SchedulerConfig(
                    batch_target=16,
                    flush_deadline=0.02,
                    plane_factory=plan.plane_factory(hasher="cpu"),
                ),
                hasher="cpu",
            )
            await sched.start()
            try:
                res = await verify_library_sched(
                    [(storage, info)], sched, tenant="t"
                )
            finally:
                await sched.close()
            assert int(res.bitfields[0].sum()) == info.num_pieces
            rep = attribute(led.snapshot(), prev=prev)
            bn = rep["bottleneck"]
            assert bn["stage"] == "h2d", rep
            # the throttled stage owns the MAJORITY of pipeline wall time
            assert bn["utilization"] > 0.5, bn
            assert bn["utilization"] > max(
                st["utilization"]
                for name, st in rep["stages"].items()
                if name != "h2d"
            )
            # achieved ≪ demanded: the gap is the headroom the zero-copy
            # ingest refactor would unlock
            assert bn["demanded_bps"] > bn["achieved_bps"]

        run(go())


# -------------------------------------------------------------- fabric


class TestFabricTracing:
    def test_heartbeat_carries_deterministic_span_context(self, tmp_path):
        from test_torch_fabric import cpu_sched, make_library
        from torrent_tpu_torch.fabric import FabricConfig, FabricExecutor, FileHeartbeat
        from torrent_tpu_torch.fabric.plan import plan_library

        async def go():
            items, _, _ = make_library(tmp_path, [6])
            plan = plan_library([info for _, info in items], 1)
            hb_dir = tmp_path / "hb"
            sched = cpu_sched()
            await sched.start()
            try:
                ex = FabricExecutor(
                    items, plan, 0, sched,
                    FabricConfig(heartbeat_interval=0.05),
                    transport=FileHeartbeat(str(hb_dir), 0),
                )
                await ex.run()
            finally:
                await sched.close()
            payload = json.loads((hb_dir / "fabric_hb_0.json").read_text())
            want_tid = fabric_trace_id(plan.fingerprint(), 0)
            assert payload["span"]["trace"] == want_tid
            assert payload["span"]["seq"] == payload["seq"]
            # unit spans landed in the deterministic fabric trace
            tree = tracer().trace_tree(want_tid)
            names = span_names(tree)
            assert "fabric.unit" in names and "fabric.run" in names
            assert ex.metrics_snapshot()["trace_id"] == want_tid

        run(go())

    def test_sentinel_distrust_triggers_dump(self, tmp_path):
        """A lying peer's verdicts fail the sentinel cross-check: the
        distrust must leave exactly one black-box dump behind."""
        from test_torch_fabric import cpu_sched, make_library
        from torrent_tpu_torch.fabric import (
            FabricConfig,
            FabricExecutor,
            FileHeartbeat,
            pack_bits,
        )
        from torrent_tpu_torch.fabric.plan import plan_library

        import numpy as np

        async def go():
            PLEN = 16384
            items, _, ddir = make_library(tmp_path, [12])
            plan = plan_library(
                [info for _, info in items], 2, unit_bytes=3 * PLEN
            )
            hb_dir = str(tmp_path / "hb")
            # a dead peer (pid 1) claims its unit is all-valid — but its
            # first piece is corrupt on disk, so the sentinel re-hash of
            # exactly that piece must reject the verdicts
            liar_unit = plan.units_for(1)[0]
            payload = ddir / "lib0" / "payload.bin"
            buf = bytearray(payload.read_bytes())
            buf[liar_unit.start * PLEN + 11] ^= 0xFF
            payload.write_bytes(bytes(buf))
            FileHeartbeat(hb_dir, 1).exchange(
                {
                    "pid": 1, "seq": 1, "t": 0.0, "fp": plan.fingerprint(),
                    "degraded": False,
                    "done": {
                        str(liar_unit.uid): pack_bits(
                            np.ones(liar_unit.npieces, dtype=bool)
                        )
                    },
                    "inflight": [], "distrust": [], "redone": [],
                }
            )
            sched = cpu_sched()
            await sched.start()
            try:
                ex = FabricExecutor(
                    items, plan, 0, sched,
                    FabricConfig(heartbeat_interval=0.05, lapse_after=0.2),
                    transport=FileHeartbeat(hb_dir, 0),
                )
                await asyncio.wait_for(ex.run(), 60)
                assert ex.metrics_snapshot()["sentinel_mismatches"] >= 1
            finally:
                await sched.close()
            counts = flight_recorder().counts()
            assert counts.get("fabric_distrust") == 1
            dump = [
                d for d in flight_recorder().dumps()
                if d["reason"] == "fabric_distrust"
            ][0]
            assert dump["detail"]["peer"] == 1
            assert dump["snapshots"]["fabric"]["pid"] == 0

        run(go())
