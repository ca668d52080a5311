"""Timeline ring: the observability plane's history tier.

Every surface built so far (tracer, ledger/attributor, fleet digests,
autopilot decisions) is *instantaneous*: the system can name its
bottleneck right now but cannot say whether it has been degrading for
the last ten minutes, or what was limiting five minutes before a crash.
This module adds the missing axis — time:

* :func:`build_sample` — one compact, bounded snapshot of the whole
  observability plane at a single monotonic instant: pipeline-ledger
  stage counters, a scheduler summary (shed/faults/breaker states/
  fill), latency-histogram family summaries, integrity counters
  (breaker-open transitions, lockset races, distrust events), plus
  optional control/fleet/tracker facts. Pure function of already-taken
  snapshots — it sits in the analysis plane's determinism pass like the
  fleet digest build functions, so a sample's bytes are bit-stable given the
  same inputs. Counters are CUMULATIVE; consumers (the SLO engine, the
  replay attributor) delta consecutive samples.
* :class:`Timeline` — a fixed-depth ring of samples behind ONE leaf
  :func:`named_lock` (never held while a snapshot is taken), with a
  drop counter when the ring wraps — the same cardinality/bounding
  discipline as the fleet digest.
* :class:`TimelineSampler` — an off-loop periodic sampler (a daemon
  thread, so capture never stalls a serving loop), dumping the ring to
  ``TORRENT_TPU_TIMELINE_DIR`` for post-mortems. ``sample_once()`` is
  public so tests and doctor drive sampling deterministically.
* :func:`replay_report` — offline replay: the ledger attributor run over
  the HISTORICAL deltas between ring samples, so "what was limiting at
  T-5m" is answerable after the process is gone (``torrent-tpu replay
  <file>``).

Overhead when off is zero: nothing here is constructed unless a caller
arms it (``bridge --slo``, ``torrent-tpu serve --slo``, a test).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from torrent_tpu_torch.utils.locks import guard_attrs, named_lock
from torrent_tpu_torch.obs.fleet import _digest_hist, _digest_sched, _digest_stages
from torrent_tpu_torch.obs.hist import histograms
from torrent_tpu_torch.obs.ledger import pipeline_ledger
from torrent_tpu_torch.utils.log import get_logger

log = get_logger("obs.timeline")

__all__ = [
    "DEFAULT_DEPTH",
    "DEFAULT_INTERVAL_S",
    "TIMELINE_DIR_ENV",
    "TIMELINE_VERSION",
    "Timeline",
    "TimelineSampler",
    "build_sample",
    "replay_report",
    "sample_now",
]

TIMELINE_VERSION = 1
# ring depth: at the default 1 s cadence this is ~8.5 minutes of
# history in ~a few hundred KiB of dicts — bounded however long the
# process lives (older samples fall off; the drop counter says so)
DEFAULT_DEPTH = 512
DEFAULT_INTERVAL_S = 1.0
# dump the ring to disk every N appended samples (plus once at stop),
# so a crash loses at most one dump interval of history
DUMP_EVERY = 32

TIMELINE_DIR_ENV = "TORRENT_TPU_TIMELINE_DIR"

# histogram families a sample summarizes (short key -> family name):
# the SLO latency objectives evaluate p99 targets over these
SAMPLE_HIST_FAMILIES = (
    ("queue_wait", "torrent_tpu_sched_queue_wait_seconds"),
    ("launch", "torrent_tpu_sched_launch_seconds"),
    ("request", "torrent_tpu_bridge_request_seconds"),
    # the swarm wire tier (obs/swarm): block round-trip times, so
    # `p99_ms=…:block_rtt` objectives page on a slow swarm
    ("block_rtt", "torrent_tpu_swarm_block_rtt_seconds"),
)

# per-process run token in dump filenames, same rationale as the flight
# recorder's: a restarted process must not overwrite the previous run's
# post-mortem evidence. Wall clock is fine — filenames never enter
# deterministic or exchanged bytes.
_RUN_TOKEN = f"{int(time.time()):x}-{os.getpid():x}"


# ------------------------------------------------------------ samples
# (analysis determinism pass scope, like the fleet digest build functions: no
# wall clock, no randomness, sorted iteration — the monotonic instant is
# PASSED IN by the sampler, never read here)


def _num(value, default: float = 0.0) -> float:
    """Defensive float: replay/fuzz feed arbitrary JSON back through
    these helpers, so a missing/NaN/str field reads as ``default``."""
    try:
        f = float(value)
    except (TypeError, ValueError):
        return default
    return f if f == f and abs(f) != float("inf") else default


# determinism-scope
def _integrity_counters(sched_snap: dict, tsan_snap: dict | None, distrust: int) -> dict:
    """Cumulative integrity-event counters: breaker open-transitions,
    currently-open lanes, lockset races, distrust events. Any of these
    burns the integrity SLO budget instantly (obs/slo)."""
    opens = 0
    open_lanes = 0
    breakers = (sched_snap or {}).get("breakers") or {}
    for lane in sorted(breakers):
        b = breakers[lane] or {}
        if b.get("state") in ("open", "half_open"):
            open_lanes += 1
        transitions = b.get("transitions") or {}
        for key in sorted(transitions):
            if key.endswith("->open"):
                opens += int(_num(transitions[key]))
    return {
        "breaker_opens": opens,
        "open_lanes": open_lanes,
        "races": int(_num((tsan_snap or {}).get("lockset_race_count"))),
        "distrust": int(_num(distrust)),
    }


# determinism-scope
def _sample_sched(sched_snap: dict) -> dict:
    """The fleet digest's scheduler summary plus the two extra counters
    the SLO availability objective needs: total served pieces (the
    denominator) and the admission actuator's current factor."""
    out = _digest_sched(sched_snap or {})
    tenants = (sched_snap or {}).get("tenants") or {}
    evicted = (sched_snap or {}).get("evicted") or {}
    evicted = evicted if isinstance(evicted, dict) else {}
    # the availability denominator must be CUMULATIVE: live tenants'
    # served pieces PLUS the pieces of idle tenants the scheduler has
    # since evicted — without the evicted share, an eviction makes the
    # counter drop and the window delta goes wrong in both directions
    # (a real burst reads as zero events, a benign eviction reads as a
    # false fast burn)
    out["pieces"] = sum(
        int(_num(tenants[name].get("served_pieces")))
        for name in sorted(tenants)
        if isinstance(tenants[name], dict)
    ) + int(_num(evicted.get("served_pieces")))
    out["admission_factor"] = round(
        _num((sched_snap or {}).get("admission_factor"), 1.0), 4
    )
    return out


# determinism-scope
def build_sample(
    t_mono: float,
    ledger_snap: dict,
    sched_snap: dict | None = None,
    hist_snaps: dict | None = None,
    tsan_snap: dict | None = None,
    control: dict | None = None,
    fleet: dict | None = None,
    tracker: dict | None = None,
    swarm: dict | None = None,
    distrust: int = 0,
) -> dict:
    """Assemble one timeline sample from already-taken snapshots.

    All counters are cumulative (consumers delta consecutive samples);
    ``t_mono`` is the capture instant on the local monotonic clock —
    meaningful only as a difference between samples, never wall time.
    """
    ledger_snap = ledger_snap or {}
    overlap = ledger_snap.get("overlap") or {}
    sample = {
        "v": TIMELINE_VERSION,
        "t": round(_num(t_mono), 6),
        "stages": _digest_stages(ledger_snap.get("stages") or {}),
        "overlap_s": round(_num(overlap.get("busy_s")), 6),
        "sched": _sample_sched(sched_snap or {}),
        "hist": _digest_hist(hist_snaps or {}),
        "integrity": _integrity_counters(sched_snap or {}, tsan_snap, distrust),
    }
    if control:
        sample["control"] = {
            "stage": control.get("stage"),
            "confirmed": bool(control.get("confirmed")),
        }
    if fleet:
        sample["fleet"] = {
            "pid": fleet.get("pid"),
            "stage": fleet.get("stage"),
        }
    if tracker:
        sample["tracker"] = {
            "announces": int(_num(tracker.get("announces"))),
            "peers": int(_num(tracker.get("peers"))),
            "swarms": int(_num(tracker.get("swarms"))),
        }
    if swarm:
        # the swarm wire tier (obs/swarm.sample_summary): cumulative
        # counters the swarm SLO objectives delta — bytes/blocks for the
        # download-rate floor, snubs/blocks for the snub-ratio budget
        sample["swarm"] = {
            "peers": int(_num(swarm.get("peers"))),
            "snubbed": int(_num(swarm.get("snubbed"))),
            "bytes_down": int(_num(swarm.get("bytes_down"))),
            "bytes_up": int(_num(swarm.get("bytes_up"))),
            "blocks": int(_num(swarm.get("blocks"))),
            "snubs": int(_num(swarm.get("snubs"))),
            "announce_failed": int(_num(swarm.get("announce_failed"))),
            "all_choked": int(_num(swarm.get("all_choked"))),
        }
    return sample


def sample_now(
    scheduler=None,
    control: dict | None = None,
    fleet: dict | None = None,
    tracker: dict | None = None,
    distrust: int = 0,
) -> dict:
    """Capture one sample from the process-global obs state (plus
    ``scheduler`` when given). Reads the monotonic clock and every leaf
    snapshot OUTSIDE any timeline lock.

    The reference adds its lockset sanitizer's snapshot when that is
    enabled; the port has no sanitizer yet, so ``tsan`` stays None, as
    the reference's does whenever its sanitizer is off."""
    reg = histograms()
    hist_snaps = {}
    for short, family in SAMPLE_HIST_FAMILIES:
        hist_snaps[short] = reg.family_snapshot(family)
    sched_snap = scheduler.metrics_snapshot() if scheduler is not None else {}
    tsan_snap = None
    from torrent_tpu_torch.obs.swarm import swarm_telemetry

    # None until the process ever saw a peer connection, so swarm-less
    # samples stay byte-identical to a pre-swarm-plane build
    swarm = swarm_telemetry().sample_summary()
    return build_sample(
        time.monotonic(),
        pipeline_ledger().snapshot(),
        sched_snap=sched_snap,
        hist_snaps=hist_snaps,
        tsan_snap=tsan_snap,
        control=control,
        fleet=fleet,
        tracker=tracker,
        swarm=swarm,
        distrust=distrust,
    )


# ------------------------------------------------------------------- ring


class Timeline:
    """Fixed-depth sample ring. One leaf lock taken only around the
    deque push/copy — never while a sample is being captured."""

    def __init__(self, depth: int = DEFAULT_DEPTH):
        self.depth = max(2, int(depth))
        self._lock = named_lock("obs.timeline._lock")
        # dynamic lockset checking: the ring + counters are one cell
        # guarded by _lock (the sampler thread appends, serving loops
        # snapshot)
        self._cells = guard_attrs("obs.timeline", "ring")
        self._ring: deque[dict] = deque(maxlen=self.depth)
        self._seq = 0
        self._drops = 0

    def push(self, sample: dict) -> int:
        with self._lock:
            self._cells.write("ring")
            self._seq += 1
            if len(self._ring) == self.depth:
                self._drops += 1
            self._ring.append({**sample, "seq": self._seq})
            return self._seq

    def snapshot(self) -> dict:
        """The ``GET /v1/timeline`` payload (and the dump file body)."""
        with self._lock:
            self._cells.read("ring")
            return {
                "v": TIMELINE_VERSION,
                "depth": self.depth,
                "seq": self._seq,
                "drops": self._drops,
                "samples": [dict(s) for s in self._ring],
            }

    def stats(self) -> dict:
        """Counters only — what the /metrics rendering needs. Unlike
        :meth:`snapshot` this never copies the sample dicts, so a hot
        Prometheus scrape path holds the leaf lock for O(1)."""
        with self._lock:
            self._cells.read("ring")
            return {
                "v": TIMELINE_VERSION,
                "depth": self.depth,
                "seq": self._seq,
                "drops": self._drops,
                "fill": len(self._ring),
            }

    def samples(self) -> list[dict]:
        with self._lock:
            self._cells.read("ring")
            return [dict(s) for s in self._ring]

    def tail_snapshot(self, n: int) -> dict:
        """Snapshot-shaped dict carrying only the newest ``n`` samples —
        what the SLO engine's windows actually read. Bounds the
        per-capture copy (and the leaf-lock hold) to the window size
        instead of the whole ring."""
        n = max(2, int(n))
        with self._lock:
            self._cells.read("ring")
            # refs only under the lock (O(depth) pointer copy); the
            # per-sample dict copies happen outside it, tail-bounded
            ring = list(self._ring)
            seq, drops = self._seq, self._drops
        tail = ring[-n:] if len(ring) > n else ring
        return {
            "v": TIMELINE_VERSION,
            "depth": self.depth,
            "seq": seq,
            "drops": drops,
            "samples": [dict(s) for s in tail],
        }

    def clear(self) -> None:
        with self._lock:
            self._cells.write("ring")
            self._ring.clear()
            self._seq = 0
            self._drops = 0


# ---------------------------------------------------------------- sampler


class TimelineSampler:
    """Off-loop periodic capture into a :class:`Timeline`.

    A daemon thread (not an asyncio task): snapshot capture takes the
    scheduler/ledger/histogram leaf locks and may contend briefly, and
    the serving loop must never pay for it. ``sources`` maps optional
    sample fields to zero-arg callables evaluated per capture (control
    status, fleet verdict, tracker facts, distrust count); a raising
    source is dropped from that sample, never kills the sampler.
    ``on_sample`` (the SLO engine's ``observe``) runs after each append
    with the fresh ring snapshot — tail-bounded to ``on_sample_tail``
    samples when set (pass the engine's long window: the evaluator
    never reads past it, so copying the whole ring per capture would be
    pure waste). When ``TORRENT_TPU_TIMELINE_DIR`` (or ``dump_dir``) is
    set, the ring is dumped atomically every :data:`DUMP_EVERY` samples
    and once at :meth:`stop` — the post-mortem file ``torrent-tpu
    replay`` reads."""

    def __init__(
        self,
        timeline: Timeline,
        interval_s: float = DEFAULT_INTERVAL_S,
        scheduler=None,
        sources: dict | None = None,
        on_sample=None,
        on_sample_tail: int | None = None,
        dump_dir: str | None = None,
    ):
        self.timeline = timeline
        self.interval_s = max(0.01, float(interval_s))
        self.scheduler = scheduler
        self.sources = dict(sources or {})
        self.on_sample = on_sample
        self.on_sample_tail = on_sample_tail
        self._dump_dir = dump_dir
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._since_dump = 0

    # --------------------------------------------------------- lifecycle

    def start(self) -> "TimelineSampler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="tt-timeline-sampler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self.dump()

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # ----------------------------------------------------------- capture

    def _source(self, name: str):
        fn = self.sources.get(name)
        if fn is None:
            return None
        try:
            return fn()
        except Exception as e:  # a broken source must not kill sampling
            log.warning("timeline source %s failed: %s", name, e)
            return None

    def sample_once(self) -> dict:
        """One capture → append → on_sample pass. Public so tests and
        ``doctor --slo`` drive the timeline deterministically instead of
        racing the thread's cadence."""
        distrust = self._source("distrust")
        sample = sample_now(
            scheduler=self.scheduler,
            control=self._source("control"),
            fleet=self._source("fleet"),
            tracker=self._source("tracker"),
            distrust=int(distrust) if distrust else 0,
        )
        self.timeline.push(sample)
        if self.on_sample is not None:
            try:
                self.on_sample(
                    self.timeline.tail_snapshot(self.on_sample_tail)
                    if self.on_sample_tail
                    else self.timeline.snapshot()
                )
            except Exception as e:  # the SLO hook must not kill sampling
                log.warning("timeline on_sample hook failed: %s", e)
        self._since_dump += 1
        if self._since_dump >= DUMP_EVERY:
            self.dump()
        return sample

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception as e:  # a bad capture must not kill the loop
                log.warning("timeline capture failed: %s", e)

    # -------------------------------------------------------------- dump

    def dump(self) -> str | None:
        """Write the ring to the timeline dir (atomic replace). Returns
        the path, or None when no dir is configured / the write failed
        (best-effort: the in-memory ring still has everything)."""
        directory = self._dump_dir or os.environ.get(TIMELINE_DIR_ENV)
        self._since_dump = 0
        if not directory:
            return None
        snap = self.timeline.snapshot()
        try:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, f"timeline_{_RUN_TOKEN}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(snap, f, sort_keys=True)
            os.replace(tmp, path)
            return path
        except OSError as e:
            log.warning("timeline dump to %s failed: %s", directory, e)
            return None


# ----------------------------------------------------------------- replay


# determinism-scope
def _sample_to_ledger(sample: dict) -> dict:
    """Reconstruct a ledger-shaped snapshot from one timeline sample so
    ``obs/attrib.attribute`` runs unchanged over HISTORICAL counters —
    the same trick the fleet rollup plays on peer digests."""
    stages = {}
    raw = sample.get("stages")
    raw = raw if isinstance(raw, dict) else {}
    for name in sorted(raw):
        s = raw[name] if isinstance(raw[name], dict) else {}
        stages[str(name)] = {
            "busy_s": _num(s.get("busy_s")),
            "bytes": int(_num(s.get("bytes"))),
            "ops": int(_num(s.get("ops"))),
            "active": 0,
            "max_active": 0,
        }
    t = _num(sample.get("t"))
    return {
        "t_first": None,
        "t_last": t,
        "t_snap": t,
        "overlap": {
            "busy_s": _num(sample.get("overlap_s")),
            "concurrent_stages": 0,
            "max_concurrent_stages": 0,
        },
        "stages": stages,
    }


# determinism-scope
def replay_report(timeline_snap: dict, objectives=None) -> dict:
    """Offline replay of a dumped (or fetched) timeline.

    Runs the ledger's bottleneck attributor over the delta between every
    consecutive sample pair — so "what was limiting at T-5m" has the
    SAME answer the live attributor would have given — plus an overall
    first→last attribution and (optionally) the SLO evaluation over the
    ring. Pure function of the payload: usable long after the process
    that recorded it is gone."""
    from torrent_tpu_torch.obs.attrib import attribute

    raw = timeline_snap.get("samples") if isinstance(timeline_snap, dict) else timeline_snap
    samples = [s for s in (raw or []) if isinstance(s, dict)]
    t_end = _num(samples[-1].get("t")) if samples else 0.0
    intervals = []
    for prev, cur in zip(samples, samples[1:]):
        rep = attribute(_sample_to_ledger(cur), prev=_sample_to_ledger(prev))
        bn = rep.get("bottleneck")
        intervals.append(
            {
                # age of this interval's END relative to the newest
                # sample: "T-300s" = five minutes before the dump
                "age_s": round(max(0.0, t_end - _num(cur.get("t"))), 3),
                "wall_s": rep.get("wall_s"),
                "limiting": bn.get("stage") if bn else None,
                "utilization": bn.get("utilization") if bn else None,
                "pipeline_bps": rep.get("pipeline_bps"),
                "sched": {
                    "shed": (cur.get("sched") or {}).get("shed", 0),
                    "failed_pieces": (cur.get("sched") or {}).get(
                        "failed_pieces", 0
                    ),
                },
            }
        )
    overall = None
    if len(samples) >= 2:
        overall = attribute(
            _sample_to_ledger(samples[-1]), prev=_sample_to_ledger(samples[0])
        )
    out = {
        "v": TIMELINE_VERSION,
        "samples": len(samples),
        "span_s": round(
            max(0.0, t_end - _num(samples[0].get("t"))), 3
        )
        if samples
        else 0.0,
        "drops": int(_num(timeline_snap.get("drops")))
        if isinstance(timeline_snap, dict)
        else 0,
        "intervals": intervals,
        "overall": overall,
    }
    if objectives is not None:
        from torrent_tpu_torch.obs.slo import evaluate_slo

        out["slo"] = evaluate_slo(samples, objectives)
    return out
