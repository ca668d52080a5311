"""The crowd seeder plane (torrent_tpu_torch/serve_plane), the reference's
tests run against the port.

Covers the choke-economics DRR scheduler (determinism, slot bounds,
optimistic rotation, charge/cap arithmetic, no-starvation), the bounded
serve reactor (backpressure, round-robin batch fairness, cancel/drop,
worker resilience), the AcceptGate per-IP clamp, the zero-copy egress
engine (span classification, EOF guard, real-socket sendfile/preadv
frames), the PeerConnection upload-rate window (anchored at
registration), the pure serve-snapshot builder and the
metrics-renderer constant parity pin.
"""

import asyncio
import os
import time

import pytest

from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.net import protocol as proto
from torrent_tpu_torch.serve_plane.choke import MIN_WEIGHT, ChokeEconomics
from torrent_tpu_torch.serve_plane.egress import EgressEngine
from torrent_tpu_torch.serve_plane.reactor import ReactorPool
from torrent_tpu_torch.serve_plane.telemetry import (
    EGRESS_PATHS,
    REJECT_REASONS,
    ServeTelemetry,
    build_serve_snapshot,
)
from torrent_tpu_torch.session.peer import PeerConnection
from torrent_tpu_torch.session.torrent import AcceptGate
from torrent_tpu_torch.storage.storage import FsStorage, MemoryStorage, Storage

from test_torch_session import build_torrent_bytes, run


# ---------------------------------------------------------------- choke


class TestChokeEconomics:
    def _weights(self, n):
        return {f"p{i:02d}": 0.5 for i in range(n)}

    def test_same_seed_same_schedule(self):
        a = ChokeEconomics(slots=2, seed=7)
        b = ChokeEconomics(slots=2, seed=7)
        w = self._weights(6)
        for _ in range(20):
            ra, rb = a.round(dict(w)), b.round(dict(w))
            assert ra.unchoked == rb.unchoked
            assert ra.optimistic == rb.optimistic
            assert ra.rotated == rb.rotated
        assert a.rotations == b.rotations > 0

    def test_slot_bound_and_dedup(self):
        econ = ChokeEconomics(slots=3, seed=1)
        for _ in range(10):
            r = econ.round(self._weights(8))
            assert len(r.unchoked) <= 3
            fed = r.all_unchoked()
            assert len(fed) == len(set(fed)) <= 4
            if r.optimistic is not None:
                assert r.optimistic in fed

    def test_optimistic_only_from_the_rest(self):
        econ = ChokeEconomics(slots=3, seed=2)
        for _ in range(12):
            r = econ.round(self._weights(8))
            if r.optimistic is not None:
                assert r.optimistic not in r.unchoked

    def test_fewer_candidates_than_slots_no_optimistic(self):
        econ = ChokeEconomics(slots=4, seed=0)
        r = econ.round(self._weights(3))
        assert sorted(r.unchoked) == ["p00", "p01", "p02"]
        assert r.optimistic is None and not r.rotated

    def test_departed_key_stops_accruing(self):
        econ = ChokeEconomics(slots=1, seed=0)
        econ.round({"a": 1.0, "b": 1.0})
        assert econ.deficit("b") > 0
        econ.round({"a": 1.0})
        assert econ.deficit("b") == 0

    def test_charge_clamps_at_zero_and_ignores_strangers(self):
        econ = ChokeEconomics(slots=1, quantum=1000, seed=0)
        econ.round({"a": 1.0})
        assert econ.deficit("a") == 1000
        econ.charge("a", 10_000_000)
        assert econ.deficit("a") == 0
        econ.charge("ghost", 500)  # never seen: must not create state
        assert econ.deficit("ghost") == 0

    def test_deficit_caps_at_cap_rounds(self):
        econ = ChokeEconomics(slots=1, quantum=100, cap_rounds=3, seed=0)
        w = {"a": 1.0, "b": 1.0}
        for _ in range(10):
            econ.round(w)
        assert econ.deficit("b") == 3 * 100

    def test_min_weight_floor_still_accrues(self):
        econ = ChokeEconomics(slots=1, quantum=16384, seed=0)
        econ.round({"z": 0.0})
        assert econ.deficit("z") >= int(16384 * MIN_WEIGHT)

    def test_no_starvation_under_full_drain(self):
        """DRR + optimistic: with every fed peer draining its deficit,
        a crowd 4x the slot count must all get fed within a bounded
        number of rounds (the leecher-stampede scenario's core claim)."""
        econ = ChokeEconomics(slots=2, quantum=16384, seed=5, cap_rounds=64)
        w = self._weights(8)
        fed = set()
        for _ in range(40):
            r = econ.round(dict(w))
            for key in r.all_unchoked():
                fed.add(key)
                econ.charge(key, econ.deficit(key))
            if len(fed) == len(w):
                break
        assert fed == set(w)


# -------------------------------------------------------------- reactor


class TestReactorPool:
    def test_backpressure_rejects_past_queue_depth(self):
        pool = ReactorPool(lambda k, i: None, per_peer_queue=2)
        assert pool.submit("a", 1) and pool.submit("a", 2)
        assert not pool.submit("a", 3)
        assert pool.rejected == 1 and pool.submitted == 2
        assert pool.depth("a") == 2

    def test_cancel_by_predicate_and_drop(self):
        pool = ReactorPool(lambda k, i: None, per_peer_queue=8)
        for i in range(5):
            pool.submit("a", i)
        gone = pool.cancel("a", lambda it: it % 2 == 0)
        assert gone == [0, 2, 4]
        assert pool.depth("a") == 2
        assert pool.drop("a") == 2
        assert pool.depth("a") == 0

    def test_round_robin_batch_fairness(self):
        """A peer with a deep queue must not starve the others: drains
        interleave in ``batch``-sized turns."""
        order = []

        async def serve(key, item):
            order.append(key)

        async def go():
            pool = ReactorPool(serve, workers=1, per_peer_queue=64, batch=2)
            for i in range(6):
                pool.submit("hog", i)
            pool.submit("meek", 0)
            pool.start(asyncio.get_running_loop().create_task)
            for _ in range(100):
                if len(order) == 7:
                    break
                await asyncio.sleep(0.01)
            await pool.aclose()

        run(go())
        assert len(order) == 7
        # the meek peer is served within one batch turn of the hog
        assert order.index("meek") <= 2

    def test_worker_survives_serve_exception(self):
        served = []

        async def serve(key, item):
            if item == "boom":
                raise RuntimeError("serve failed")
            served.append(item)

        async def go():
            pool = ReactorPool(serve, workers=1)
            pool.submit("a", "boom")
            pool.submit("a", "ok")
            pool.start(asyncio.get_running_loop().create_task)
            for _ in range(100):
                if served:
                    break
                await asyncio.sleep(0.01)
            assert pool.running
            await pool.aclose()
            assert not pool.running

        run(go())
        assert served == ["ok"]
        # both items count as served — the callback owns its errors
        # (the pool only guarantees the worker survives)

    def test_forget_resets_for_restart(self):
        pool = ReactorPool(lambda k, i: None)
        pool.submit("a", 1)
        pool.forget()
        assert pool.depth("a") == 0 and not pool.running


# ------------------------------------------------------------ gate


class TestAcceptGatePerIp:
    def test_per_ip_clamp(self):
        gate = AcceptGate(100, 60.0, per_ip=2)
        assert gate.connect("a", 0.0, ip="10.0.0.1")
        assert gate.connect("b", 0.0, ip="10.0.0.1")
        assert not gate.connect("c", 0.0, ip="10.0.0.1")
        assert gate.rejected_per_ip == 1
        assert gate.last_reject == "per_ip"
        # other addresses are unaffected by one address's stampede
        assert gate.connect("d", 0.0, ip="10.0.0.2")

    def test_release_frees_the_ip_budget(self):
        gate = AcceptGate(100, 60.0, per_ip=1)
        assert gate.connect("a", 0.0, ip="10.0.0.1")
        assert not gate.connect("b", 0.0, ip="10.0.0.1")
        gate.release("a")
        assert gate.connect("b", 1.0, ip="10.0.0.1")

    def test_idle_sweep_frees_the_ip_budget(self):
        gate = AcceptGate(100, 10.0, per_ip=1)
        assert gate.connect("a", 0.0, ip="10.0.0.1")
        assert gate.sweep(10.0) == ["a"]
        assert gate.evicted_idle == 1
        assert gate.connect("b", 10.0, ip="10.0.0.1")

    def test_capacity_still_applies_with_per_ip_off(self):
        gate = AcceptGate(1, 60.0, per_ip=0)
        assert gate.connect("a", 0.0, ip="10.0.0.1")
        assert not gate.connect("b", 0.0, ip="10.0.0.2")
        assert gate.last_reject == "capacity"
        assert gate.rejected_capacity == 1


# ------------------------------------------------------------ egress


PIECE_LEN = 16384


def _fs_rig(tmp_path, payload: bytes):
    meta = parse_metainfo(
        build_torrent_bytes(payload, PIECE_LEN, b"http://x/ann", name=b"egress.bin")
    )
    with open(os.path.join(tmp_path, "egress.bin"), "wb") as f:
        f.write(payload)
    return Storage(FsStorage(str(tmp_path)), meta.info)


async def _socket_pair():
    loop = asyncio.get_running_loop()
    fut = loop.create_future()

    async def on_conn(reader, writer):
        fut.set_result((reader, writer))

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    host, port = server.sockets[0].getsockname()[:2]
    c_reader, c_writer = await asyncio.open_connection(host, port)
    s_reader, s_writer = await fut
    return server, (c_reader, c_writer), (s_reader, s_writer)


class TestEgressEngine:
    def test_memory_storage_is_never_eligible(self):
        meta = parse_metainfo(
            build_torrent_bytes(b"\x01" * PIECE_LEN, PIECE_LEN, b"http://x/a")
        )
        eng = EgressEngine(Storage(MemoryStorage(), meta.info))
        assert eng.classify(0, PIECE_LEN) is None

    def test_classify_resolves_fd_and_offset(self, tmp_path):
        payload = os.urandom(2 * PIECE_LEN)
        eng = EgressEngine(_fs_rig(tmp_path, payload))
        got = eng.classify(PIECE_LEN, 4096)
        assert got is not None
        f, foff = got
        assert foff == PIECE_LEN
        assert os.pread(f.fileno(), 4096, foff) == payload[PIECE_LEN:PIECE_LEN + 4096]

    def test_eof_guard_refuses_short_files(self, tmp_path):
        payload = os.urandom(2 * PIECE_LEN)
        storage = _fs_rig(tmp_path, payload)
        os.truncate(os.path.join(tmp_path, "egress.bin"), PIECE_LEN // 2)
        eng = EgressEngine(storage)
        # committing a Piece header for bytes the file doesn't hold
        # would desync the stream: the copy path must take over
        assert eng.classify(0, PIECE_LEN) is None

    def test_zero_length_is_never_eligible(self, tmp_path):
        eng = EgressEngine(_fs_rig(tmp_path, os.urandom(PIECE_LEN)))
        assert eng.classify(0, 0) is None

    @pytest.mark.parametrize("force_preadv", [False, True])
    def test_send_block_frames_a_real_piece(self, tmp_path, force_preadv):
        payload = os.urandom(2 * PIECE_LEN)
        eng = EgressEngine(_fs_rig(tmp_path, payload))
        eng._sendfile_broken = force_preadv

        async def go():
            server, (c_reader, c_writer), (s_reader, s_writer) = await _socket_pair()
            try:
                path = await eng.send_block(c_writer, 1, 4096, 8192)
                msg = await proto.read_message(s_reader)
                return path, msg
            finally:
                c_writer.close()
                s_writer.close()
                server.close()
                await server.wait_closed()

        path, msg = run(go())
        assert path == ("preadv" if force_preadv else "sendfile")
        assert isinstance(msg, proto.Piece)
        assert (msg.index, msg.begin) == (1, 4096)
        assert msg.block == payload[PIECE_LEN + 4096:PIECE_LEN + 4096 + 8192]
        assert eng.served[path] == 1

    def test_ineligible_span_returns_none_for_copy_path(self, tmp_path):
        eng = EgressEngine(_fs_rig(tmp_path, os.urandom(PIECE_LEN)))

        async def go():
            server, (c_reader, c_writer), (s_reader, s_writer) = await _socket_pair()
            try:
                # past EOF: classify refuses, NO header bytes committed
                got = await eng.send_block(c_writer, 4, 0, PIECE_LEN)
                c_writer.write_eof()
                rest = await s_reader.read()
                return got, rest
            finally:
                c_writer.close()
                s_writer.close()
                server.close()
                await server.wait_closed()

        got, rest = run(go())
        assert got is None and rest == b""

    def test_staging_pool_is_bounded_and_reused(self, tmp_path):
        from torrent_tpu_torch.serve_plane.egress import POOL_MAX

        eng = EgressEngine(_fs_rig(tmp_path, os.urandom(PIECE_LEN)))
        bufs = [eng._take_buf(4096) for _ in range(POOL_MAX + 5)]
        for b in bufs:
            eng._put_buf(b)
        assert len(eng._pool) == POOL_MAX
        again = eng._take_buf(4096)
        assert any(again is b for b in bufs)  # reused, not reallocated


# ------------------------------------------------------- upload window


class _Clock:
    def __init__(self, t0=1000.0):
        self.t = t0

    def __call__(self):
        return self.t


class _NullWriter:
    def close(self):
        pass


@pytest.fixture
def peer_clock(monkeypatch):
    c = _Clock()
    import torrent_tpu_torch.session.peer as peer_mod

    monkeypatch.setattr(peer_mod.time, "monotonic", c)
    return c


def _mk_peer():
    return PeerConnection(
        peer_id=b"U" * 20, reader=object(), writer=_NullWriter(), num_pieces=4
    )


class TestUploadRateWindow:
    def test_window_anchored_at_registration(self, peer_clock):
        """A (0.0, 0) default mark would span the whole monotonic
        uptime and report a near-zero rate for a peer that just took
        megabytes — the choke economics would then mis-rank every
        fresh connection."""
        peer_clock.t = 5000.0
        p = _mk_peer()
        p.bytes_up += 1 << 20
        peer_clock.t = 5001.0
        assert p.upload_rate() == pytest.approx(float(1 << 20))

    def test_zero_dt_guard(self, peer_clock):
        p = _mk_peer()
        p.bytes_up += 12345
        # no time has passed since the anchor: 0.0, not a div-by-zero
        assert p.upload_rate() == 0.0

    def test_snapshot_resets_both_marks(self, peer_clock):
        p = _mk_peer()
        p.bytes_up += 1000
        p.bytes_down += 4000
        peer_clock.t += 1.0
        assert p.upload_rate() == pytest.approx(1000.0)
        assert p.download_rate() == pytest.approx(4000.0)
        p.snapshot_rate()
        peer_clock.t += 2.0
        # only bytes AFTER the snapshot count toward the new window
        assert p.upload_rate() == 0.0
        p.bytes_up += 500
        assert p.upload_rate() == pytest.approx(250.0)


# ----------------------------------------------------- snapshot builder


def _raw(key, bytes_up=0, blocks=0):
    return {
        "key": key,
        "bytes_up": bytes_up,
        "blocks": blocks,
        "paths": {},
        "rejects": {},
    }


class TestServeSnapshot:
    def test_equal_inputs_equal_bytes(self):
        import json

        raws = {f"p{i}": _raw(f"p{i}", bytes_up=i * 100) for i in range(5)}
        totals = {"bytes_up": 1000, "blocks": 10}
        a = build_serve_snapshot(dict(raws), dict(totals))
        b = build_serve_snapshot(dict(raws), dict(totals))
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)

    def test_top_k_fold_and_counts(self):
        raws = {f"p{i:02d}": _raw(f"p{i:02d}", bytes_up=i) for i in range(12)}
        snap = build_serve_snapshot(raws, {}, top_k=8)
        assert snap["counts"]["serving"] == 12
        assert len(snap["peers"]) == 8
        assert snap["overflow"] is not None
        # top-K is by uploaded bytes: the biggest uploader is named
        assert "p11" in snap["peers"]
        assert "p00" not in snap["peers"]

    def test_registry_round_trip(self):
        reg = ServeTelemetry()
        reg.peer_serving("a@1:1")
        reg.on_egress("a@1:1", "sendfile", 16384)
        reg.on_reject("a@1:1", "choked")
        reg.on_choke_round(0.01, unchoked=1, interested=2, optimistic=None,
                           rotated=True)
        snap = reg.snapshot()
        assert snap["totals"]["bytes_up"] == 16384
        assert snap["totals"]["rejects_choked"] == 1
        assert snap["totals"]["optimistic_rotations"] == 1
        assert snap["paths"]["sendfile"]["blocks"] == 1
        assert reg.active()
        reg.clear()
        assert not reg.active()


# --------------------------------------------------- renderer parity pin


class TestMetricsConstantParity:
    def test_renderer_constants_match_telemetry(self):
        """utils.metrics can't import serve_plane.telemetry at module
        level (obs.hist imports _esc from utils.metrics, and telemetry
        imports obs.hist) — so the renderer carries literal copies.
        This pin is what makes that safe."""
        from torrent_tpu_torch.utils.metrics import (
            _SERVE_PATHS,
            _SERVE_REJECT_REASONS,
        )

        assert _SERVE_PATHS == EGRESS_PATHS
        assert _SERVE_REJECT_REASONS == REJECT_REASONS


class TestBenchSeedRung:
    def test_seed_rung_record_schema(self):
        from torrent_tpu_torch.tools.bench_cli import SCHEMA, _seed_rung

        # the seed's recheck on hashlib, the reference's default
        rec = run(_seed_rung(1, 64, 6, hasher="cpu"), timeout=240)
        assert rec["schema"] == SCHEMA
        assert rec["rung"] == "seed"
        assert rec["value"] is not None and rec["value"] > 0
        assert rec["unit"] == "MiB/s"
        assert rec["leechers"] == 6
        assert rec["bytes"] == 6 << 20
        assert rec["bytes_up"] >= rec["bytes"]
        assert rec["block_p99_ms"] >= rec["block_p50_ms"] > 0
        # the serve plane's evidence rides the banked rate
        zero_copy = sum(
            rec["serve"]["paths"].get(k, {}).get("blocks", 0)
            for k in ("sendfile", "preadv")
        )
        assert zero_copy > 0
        assert rec["serve"]["rounds"] > 0
        assert rec["serve"]["optimistic_rotations"] > 0
        assert "egress" in (rec["ledger"]["stages"] or {})
        for key in ("piece_kb", "bytes", "nproc", "platform", "batch"):
            assert key in rec
        assert rec["platform"] == "cpu" and rec["plane"] == "cpu"


class TestTrajectorySeedKeys:
    def test_normalize_preserves_seed_keys(self):
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "summarize",
            os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), ".bench", "summarize.py"),
        )
        summarize = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(summarize)
        rec = {
            "metric": "seed_64leech_256KiB_upload_MiB_per_sec",
            "value": 1.8, "unit": "MiB/s", "rung": "seed",
            "leechers": 64, "block_p50_ms": 8.5, "block_p99_ms": 86.26,
            "blocks": 32768, "bytes_up": 536870912,
            "serve": {"paths": {"sendfile": {"blocks": 32768}},
                      "optimistic_rotations": 363},
            "ledger": {"stages": {"egress": {"busy_s": 12.5}}},
            "piece_kb": 256, "bytes": 512 << 20, "nproc": 1,
            "platform": "cpu", "batch": None,
        }
        out = summarize._normalize(rec, "bench_seed.json")
        for key in ("leechers", "block_p50_ms", "block_p99_ms", "blocks",
                    "bytes_up", "serve", "ledger", "piece_kb", "bytes"):
            assert out[key] == rec[key]
        assert not out["non_like_for_like"]
