"""Declarative service-level objectives over the timeline ring.

"Persistent BitTorrent Trackers" motivates the tracker as a long-lived
service with availability expectations, and "GPUs as Storage System
Accelerators" frames the verify plane as a storage-tier service — both
need the standard service contract this module provides: declared
objectives, error-budget burn-rate alerting, and health/readiness
semantics a load balancer can act on.

Objectives (:class:`SloObjective`, parsed from a spec string):

* **availability** — the shed + retry-exhausted failure ratio over the
  pieces the scheduler was asked to process. ``target`` is the success
  ratio (e.g. 0.999 → a 0.1% error budget).
* **latency** — a p99 target (seconds) over one of the existing log2
  histogram families (queue_wait / launch / request). The error events
  are observations above the target bound; the budget is the 1% a p99
  objective tolerates by definition.
* **throughput** — an achieved-B/s floor over the pipeline ledger's
  verdict stage. Error events are ACTIVE intervals (verdict ops moved)
  that ran under the floor; idle intervals never burn.
* **integrity** — breaker-open transitions, lockset races, and
  distrust events burn the budget instantly (the budget fraction is
  effectively zero: one event is a fast burn).

Evaluation (:func:`evaluate_slo`) is a **pure function over timeline
samples** — in the analysis determinism pass's scope exactly like the
autopilot's ``decide()`` and the fleet digest build functions. Windows are
counted in SAMPLES (deterministic over any ring, independent of
wall-clock jitter); at the sampler's cadence they map to time
(30 samples × 1 s ≈ 30 s short window).

Burn-rate model (the multi-window SRE idiom): over a window,
``burn = error_ratio / error_budget`` — burn 1.0 spends the budget
exactly at the window's length. Classification:

* ``fast_burn`` — short-window burn ≥ :data:`FAST_BURN` (page now);
* ``slow_burn`` — long-window burn ≥ :data:`SLOW_BURN` (ticket);
* ``ok`` otherwise.

``breach`` is the page-now condition: a fast burn, or an exhausted
budget (remaining 0) while the short window still shows errors. A
breach CLEARS when the short window runs clean — the property the
recovery leg of the acceptance scenario pins.

The stateful :class:`SloEngine` wraps evaluation with breach-transition
tracking: each observe() pass that newly breaches one or more
objectives fires exactly ONE ``slo_breach`` flight-recorder dump (the
dump lists every newly-breached objective), and nothing fires again
until the breach clears and re-occurs.

:func:`build_health` is the shared liveness/readiness verdict for
``GET /v1/health`` on the bridge AND the tracker listener: ready only
when the backend probe resolved, no lane breaker is stuck open past
its cooldown, the tracker pump is ticking, and the sampler is alive;
``degraded`` (still live, not ready) while any SLO objective breaches.
"""

from __future__ import annotations

from dataclasses import dataclass

from torrent_tpu_torch.utils.locks import guard_attrs, named_lock
from torrent_tpu_torch.obs.hist import BUCKET_BOUNDS
from torrent_tpu_torch.utils.log import get_logger

log = get_logger("obs.slo")

__all__ = [
    "DEFAULT_LONG_SAMPLES",
    "DEFAULT_SHORT_SAMPLES",
    "DEFAULT_SLO_SPEC",
    "FAST_BURN",
    "SLOW_BURN",
    "SloEngine",
    "SloObjective",
    "arm",
    "armed",
    "build_health",
    "default_objectives",
    "digest_summary",
    "disarm",
    "evaluate_slo",
    "parse_objectives",
]

# multi-window burn-rate thresholds (the classic SRE workbook numbers:
# 14.4× spends a 30-day budget in ~2 days; 3× in ~10 days)
FAST_BURN = 14.4
SLOW_BURN = 3.0

# window lengths in SAMPLES (deterministic over any ring; at the
# default 1 s sampler cadence: 30 s / 5 min)
DEFAULT_SHORT_SAMPLES = 30
DEFAULT_LONG_SAMPLES = 300

# a p99 objective tolerates 1% above target by definition; that 1% IS
# its error budget
LATENCY_BUDGET = 0.01
# fraction of ACTIVE intervals a throughput floor may dip under
THROUGHPUT_BUDGET = 0.1
# the integrity budget is "effectively zero": one event is an instant
# fast burn (burn = ratio / budget explodes past FAST_BURN)
INTEGRITY_BUDGET = 1e-9

# an open breaker should have gone half-open after its cooldown; stuck
# open for this multiple of the cooldown means the probe path is wedged
BREAKER_STUCK_FACTOR = 2.0

DEFAULT_SLO_SPEC = "availability=0.999;integrity=on"

# hist short keys a latency objective may target — must match the
# sampler's SAMPLE_HIST_FAMILIES (obs/timeline) or the objective could
# never observe data. "block_rtt" is the swarm wire tier's family
# (obs/swarm): a p99 objective over it pages on a slow swarm.
LATENCY_FAMILIES = ("queue_wait", "launch", "request", "block_rtt")

# fraction of block arrivals the snub-ratio budget tolerates mapping is
# expressed by the objective's own target (a success ratio, like
# availability); the swarm download floor shares the throughput budget
SWARM_THROUGHPUT_BUDGET = 0.1

_KINDS = (
    "availability", "integrity", "latency", "throughput",
    "swarm_availability", "swarm_throughput",
)


@dataclass(frozen=True)
class SloObjective:
    """One declared objective. ``target`` means: success ratio
    (availability), p99 seconds (latency), floor B/s (throughput);
    integrity ignores it. ``family`` is the sample ``hist`` short key a
    latency objective reads (queue_wait / launch / request)."""

    name: str
    kind: str
    target: float = 0.0
    family: str = ""


def default_objectives(
    availability: float = 0.999, integrity: bool = True
) -> tuple[SloObjective, ...]:
    objs = [SloObjective("availability", "availability", availability)]
    if integrity:
        objs.append(SloObjective("integrity", "integrity"))
    return tuple(objs)


def parse_objectives(spec: str) -> tuple[SloObjective, ...]:
    """Parse a declarative objective spec, e.g.
    ``"availability=0.999;p99_ms=50:queue_wait;floor_mibps=10;integrity=on"``.

    Keys: ``availability=<ratio in (0,1)>``, ``p99_ms=<ms>[:family]``
    (family defaults to ``queue_wait``; ``block_rtt`` targets the swarm
    wire tier), ``floor_mibps=<MiB/s>``, ``integrity=on|off``, plus the
    swarm tier: ``swarm_floor_mibps=<MiB/s>`` (a download-rate floor
    over the samples' cumulative swarm bytes) and ``swarm_snub=<ratio
    in (0,1)>`` (snub-ratio availability: the success ratio of block
    arrivals vs snub events). Raises ValueError with the offending
    pair."""
    objs: list[SloObjective] = []
    for pair in (spec or "").split(";"):
        pair = pair.strip()
        if not pair:
            continue
        key, _, value = pair.partition("=")
        key = key.strip()
        value = value.strip()
        try:
            if key == "availability":
                target = float(value)
                if not 0.0 < target < 1.0:
                    raise ValueError("availability target must be in (0, 1)")
                objs.append(SloObjective("availability", "availability", target))
            elif key == "p99_ms":
                ms, _, family = value.partition(":")
                family = family or "queue_wait"
                if family not in LATENCY_FAMILIES:
                    # a typo'd family would arm an objective that can
                    # never observe data — green forever, unmonitored
                    raise ValueError(
                        f"unknown latency family {family!r} (one of "
                        f"{', '.join(LATENCY_FAMILIES)})"
                    )
                target = float(ms) / 1e3
                if target <= 0:
                    raise ValueError("p99_ms target must be positive")
                objs.append(
                    SloObjective(f"latency_{family}", "latency", target, family)
                )
            elif key == "floor_mibps":
                floor = float(value) * (1 << 20)
                if floor <= 0:
                    raise ValueError("floor_mibps must be positive")
                objs.append(SloObjective("throughput", "throughput", floor))
            elif key == "swarm_floor_mibps":
                floor = float(value) * (1 << 20)
                if floor <= 0:
                    raise ValueError("swarm_floor_mibps must be positive")
                objs.append(
                    SloObjective("swarm_throughput", "swarm_throughput", floor)
                )
            elif key == "swarm_snub":
                target = float(value)
                if not 0.0 < target < 1.0:
                    raise ValueError("swarm_snub target must be in (0, 1)")
                objs.append(
                    SloObjective(
                        "swarm_availability", "swarm_availability", target
                    )
                )
            elif key == "integrity":
                if value not in ("on", "off"):
                    raise ValueError("integrity must be on or off")
                if value == "on":
                    objs.append(SloObjective("integrity", "integrity"))
            else:
                raise ValueError(f"unknown objective key {key!r}")
        except ValueError as e:
            raise ValueError(f"bad SLO spec pair {pair!r}: {e}") from e
    if not objs:
        raise ValueError(f"SLO spec declares no objectives: {spec!r}")
    names = [o.name for o in objs]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        # evaluate_slo keys its report by name, so a duplicate would
        # silently collapse last-wins — the earlier target declared but
        # never checked (green forever, unmonitored)
        raise ValueError(f"duplicate SLO objective(s): {', '.join(dupes)}")
    return tuple(objs)


# ------------------------------------------------------------- evaluation
# (analysis determinism pass scope: pure functions of the sample list —
# no wall clock, no randomness, sorted iteration)


# one defensive float parser for the whole sample layer: the evaluator
# and the replay attributor must agree on every hostile field
from torrent_tpu_torch.obs.timeline import _num  # noqa: E402


# determinism-scope
def _tail(samples: list, n: int) -> list:
    n = max(2, int(n))
    return samples[-n:] if len(samples) > n else samples


def _sched_of(sample) -> dict:
    s = sample.get("sched") if isinstance(sample, dict) else None
    return s if isinstance(s, dict) else {}


def _integrity_of(sample) -> dict:
    s = sample.get("integrity") if isinstance(sample, dict) else {}
    return s if isinstance(s, dict) else {}


# determinism-scope
def _counter_objective(
    errors_short: float,
    events_short: float,
    errors_long: float,
    events_long: float,
    budget: float,
) -> dict:
    """The shared burn-rate machinery: ratio per window → burn per
    window → classification + budget remaining + breach. Monotone in
    the error count (for fixed totals) — the hypothesis property."""
    ratio_short = (errors_short / events_short) if events_short > 0 else 0.0
    ratio_long = (errors_long / events_long) if events_long > 0 else 0.0
    budget = budget if budget > 0 else 1e-9
    burn_short = ratio_short / budget
    burn_long = ratio_long / budget
    remaining = max(0.0, 1.0 - burn_long)
    if burn_short >= FAST_BURN:
        classification = "fast_burn"
    elif burn_long >= SLOW_BURN:
        classification = "slow_burn"
    else:
        classification = "ok"
    return {
        "errors": int(errors_long),
        "events": int(events_long),
        "error_ratio": round(ratio_long, 6),
        "burn_rate": round(burn_short, 3),
        "burn_rate_long": round(burn_long, 3),
        "budget_remaining": round(remaining, 6),
        "classification": classification,
        "breach": bool(
            classification == "fast_burn"
            or (remaining <= 0.0 and ratio_short > 0.0)
        ),
    }


# determinism-scope
def _avail_counters(sample) -> tuple[float, float]:
    """(errors, events) cumulative: shed + retry-exhausted failures over
    everything the scheduler was asked to process."""
    sched = _sched_of(sample)
    errors = _num(sched.get("shed")) + _num(sched.get("failed_pieces"))
    events = errors + _num(sched.get("pieces"))
    return errors, events


# determinism-scope
def _window_delta(samples: list, extract) -> tuple[float, float]:
    """Delta of ``extract(sample) -> (errors, events)`` across a window
    (first vs last sample), clamped at 0 for counter resets."""
    if len(samples) < 2:
        return 0.0, 0.0
    e0, n0 = extract(samples[0])
    e1, n1 = extract(samples[-1])
    return max(0.0, e1 - e0), max(0.0, n1 - n0)


# determinism-scope
def _eval_availability(short: list, long: list, obj: SloObjective) -> dict:
    es, ns = _window_delta(short, _avail_counters)
    el, nl = _window_delta(long, _avail_counters)
    out = _counter_objective(es, ns, el, nl, 1.0 - obj.target)
    out.update({"kind": obj.kind, "target": obj.target})
    return out


# determinism-scope
def _hist_window(samples: list, family: str) -> tuple[dict, float, float]:
    """(bucket-count deltas, total count delta) for one histogram
    family across a window; sparse string-keyed buckets like the
    digest encoding."""
    if len(samples) < 2:
        return {}, 0.0, 0.0

    def counters(sample):
        hist = sample.get("hist") if isinstance(sample, dict) else {}
        fam = (hist or {}).get(family) if isinstance(hist, dict) else {}
        return fam if isinstance(fam, dict) else {}

    first, last = counters(samples[0]), counters(samples[-1])
    b0 = first.get("buckets") if isinstance(first.get("buckets"), dict) else {}
    b1 = last.get("buckets") if isinstance(last.get("buckets"), dict) else {}
    deltas = {}
    for key in sorted(set(b0) | set(b1)):
        d = _num(b1.get(key)) - _num(b0.get(key))
        if d > 0:
            deltas[str(key)] = d
    count = max(0.0, _num(last.get("count")) - _num(first.get("count")))
    total = max(0.0, _num(last.get("sum")) - _num(first.get("sum")))
    return deltas, count, total


# determinism-scope
def _hist_errors(bucket_deltas: dict, target_s: float) -> float:
    """Observations whose bucket lies entirely above the target bound
    (conservative: a bucket straddling the target does not count)."""
    errors = 0.0
    for key in sorted(bucket_deltas):
        try:
            idx = int(key)
        except (TypeError, ValueError):
            continue
        if idx <= 0:
            continue  # the first bucket's lower edge is 0
        # bucket idx covers (BOUNDS[idx-1], BOUNDS[idx]]; the overflow
        # bucket (idx == len(BOUNDS)) has lower edge BOUNDS[-1]
        lower = BUCKET_BOUNDS[min(idx, len(BUCKET_BOUNDS)) - 1]
        if lower >= target_s:
            errors += _num(bucket_deltas[key])
    return errors


# determinism-scope
def _p99_estimate(bucket_deltas: dict, count: float) -> float | None:
    """Upper-bound p99 estimate from log2 bucket deltas."""
    if count <= 0:
        return None
    want = 0.99 * count
    # normalize keys BEFORE walking: a hostile/hand-edited dump may
    # carry '07'/' 7' keys whose int() form is not their dict key, and
    # negative indices must not wrap around BUCKET_BOUNDS
    by_idx: dict[int, float] = {}
    for key in sorted(bucket_deltas):
        try:
            idx = int(key)
        except (TypeError, ValueError):
            continue
        if idx < 0:
            continue
        by_idx[idx] = by_idx.get(idx, 0.0) + _num(bucket_deltas[key])
    cum = 0.0
    for idx in sorted(by_idx):
        cum += by_idx[idx]
        if cum >= want:
            if idx < len(BUCKET_BOUNDS):
                return BUCKET_BOUNDS[idx]
            return float("inf")
    return None


# determinism-scope
def _eval_latency(short: list, long: list, obj: SloObjective) -> dict:
    bs, cs, _ = _hist_window(short, obj.family)
    bl, cl, _ = _hist_window(long, obj.family)
    out = _counter_objective(
        _hist_errors(bs, obj.target), cs, _hist_errors(bl, obj.target), cl,
        LATENCY_BUDGET,
    )
    p99 = _p99_estimate(bl, cl)
    out.update({
        "kind": obj.kind,
        "target": obj.target,
        "family": obj.family,
        # the overflow bucket has no finite upper bound; report None +
        # a flag rather than float('inf'), which json.dumps would emit
        # as the non-RFC token `Infinity` and break every strict parser
        # of /v1/slo exactly when latency is pathological
        "p99_s": (
            round(p99, 6) if p99 is not None and p99 != float("inf") else None
        ),
        "p99_overflow": bool(p99 == float("inf")),
    })
    return out


# determinism-scope
def _throughput_intervals(samples: list, floor_bps: float) -> tuple[float, float, float]:
    """(slow_intervals, active_intervals, last_bps) over consecutive
    sample pairs: an interval is ACTIVE when verdict ops moved; a slow
    interval ran under the floor. Idle intervals never burn."""

    def verdict(sample):
        stages = sample.get("stages") if isinstance(sample, dict) else {}
        v = (stages or {}).get("verdict") if isinstance(stages, dict) else {}
        v = v if isinstance(v, dict) else {}
        return _num(v.get("bytes")), _num(v.get("ops"))

    slow = active = 0.0
    last_bps = 0.0
    for prev, cur in zip(samples, samples[1:]):
        b0, o0 = verdict(prev)
        b1, o1 = verdict(cur)
        if o1 - o0 <= 0:
            continue
        dt = _num(cur.get("t") if isinstance(cur, dict) else 0) - _num(
            prev.get("t") if isinstance(prev, dict) else 0
        )
        if dt <= 0:
            continue
        active += 1
        last_bps = max(0.0, b1 - b0) / dt
        if last_bps < floor_bps:
            slow += 1
    return slow, active, last_bps


# determinism-scope
def _eval_throughput(short: list, long: list, obj: SloObjective) -> dict:
    ss, ns, _ = _throughput_intervals(short, obj.target)
    sl, nl, last_bps = _throughput_intervals(long, obj.target)
    out = _counter_objective(ss, ns, sl, nl, THROUGHPUT_BUDGET)
    out.update({
        "kind": obj.kind,
        "target": obj.target,
        "achieved_bps": round(last_bps, 3),
    })
    return out


def _swarm_of(sample) -> dict:
    s = sample.get("swarm") if isinstance(sample, dict) else None
    return s if isinstance(s, dict) else {}


# determinism-scope
def _swarm_avail_counters(sample) -> tuple[float, float]:
    """(errors, events) cumulative for the snub-ratio budget: snub
    transitions over block deliveries + snubs — a swarm whose peers
    keep getting snubbed is failing its users even while bytes trickle."""
    swarm = _swarm_of(sample)
    errors = _num(swarm.get("snubs"))
    events = errors + _num(swarm.get("blocks"))
    return errors, events


# determinism-scope
def _eval_swarm_availability(short: list, long: list, obj: SloObjective) -> dict:
    es, ns = _window_delta(short, _swarm_avail_counters)
    el, nl = _window_delta(long, _swarm_avail_counters)
    out = _counter_objective(es, ns, el, nl, 1.0 - obj.target)
    out.update({"kind": obj.kind, "target": obj.target})
    return out


# determinism-scope
def _swarm_throughput_intervals(
    samples: list, floor_bps: float
) -> tuple[float, float, float]:
    """(slow_intervals, active_intervals, last_bps) over consecutive
    sample pairs of the swarm download counters: an interval is ACTIVE
    when blocks arrived; a slow interval downloaded under the floor.
    Idle intervals (seeding, no download) never burn."""

    def counters(sample):
        swarm = _swarm_of(sample)
        return _num(swarm.get("bytes_down")), _num(swarm.get("blocks"))

    slow = active = 0.0
    last_bps = 0.0
    for prev, cur in zip(samples, samples[1:]):
        b0, o0 = counters(prev)
        b1, o1 = counters(cur)
        if o1 - o0 <= 0:
            continue
        dt = _num(cur.get("t") if isinstance(cur, dict) else 0) - _num(
            prev.get("t") if isinstance(prev, dict) else 0
        )
        if dt <= 0:
            continue
        active += 1
        last_bps = max(0.0, b1 - b0) / dt
        if last_bps < floor_bps:
            slow += 1
    return slow, active, last_bps


# determinism-scope
def _eval_swarm_throughput(short: list, long: list, obj: SloObjective) -> dict:
    ss, ns, _ = _swarm_throughput_intervals(short, obj.target)
    sl, nl, last_bps = _swarm_throughput_intervals(long, obj.target)
    out = _counter_objective(ss, ns, sl, nl, SWARM_THROUGHPUT_BUDGET)
    out.update({
        "kind": obj.kind,
        "target": obj.target,
        "achieved_bps": round(last_bps, 3),
    })
    return out


# determinism-scope
def _integrity_counters_of(sample) -> tuple[float, float]:
    integ = _integrity_of(sample)
    errors = (
        _num(integ.get("breaker_opens"))
        + _num(integ.get("races"))
        + _num(integ.get("distrust"))
    )
    return errors, 0.0


# determinism-scope
def _eval_integrity(short: list, long: list, obj: SloObjective) -> dict:
    es, _ = _window_delta(short, _integrity_counters_of)
    el, _ = _window_delta(long, _integrity_counters_of)
    # events = the interval count: each window interval is one chance
    # for an integrity event; the budget is effectively zero, so ONE
    # event anywhere in the short window is an instant fast burn
    ns = max(0, len(short) - 1)
    nl = max(0, len(long) - 1)
    out = _counter_objective(es, ns, el, nl, INTEGRITY_BUDGET)
    out.update({"kind": obj.kind, "target": obj.target, "events_seen": int(el)})
    return out


# determinism-scope
def evaluate_slo(
    samples: list,
    objectives: tuple[SloObjective, ...],
    short_samples: int = DEFAULT_SHORT_SAMPLES,
    long_samples: int = DEFAULT_LONG_SAMPLES,
) -> dict:
    """Evaluate every objective over a sample ring. Pure and total:
    arbitrary (even hostile) sample dicts evaluate to a well-formed
    report — missing fields read as zero, never a crash."""
    samples = [s for s in (samples or []) if isinstance(s, dict)]
    long = _tail(samples, max(2, int(long_samples)))
    short = _tail(long, max(2, int(short_samples)))
    per: dict[str, dict] = {}
    for obj in sorted(objectives or (), key=lambda o: o.name):
        if obj.kind == "availability":
            per[obj.name] = _eval_availability(short, long, obj)
        elif obj.kind == "latency":
            per[obj.name] = _eval_latency(short, long, obj)
        elif obj.kind == "throughput":
            per[obj.name] = _eval_throughput(short, long, obj)
        elif obj.kind == "swarm_availability":
            per[obj.name] = _eval_swarm_availability(short, long, obj)
        elif obj.kind == "swarm_throughput":
            per[obj.name] = _eval_swarm_throughput(short, long, obj)
        elif obj.kind == "integrity":
            per[obj.name] = _eval_integrity(short, long, obj)
    worst = None
    for name in sorted(per):
        burn = per[name]["burn_rate"]
        if worst is None or burn > per[worst]["burn_rate"]:
            worst = name
    return {
        "objectives": per,
        "worst": (
            {
                "objective": worst,
                "burn_rate": per[worst]["burn_rate"],
                "classification": per[worst]["classification"],
            }
            if worst is not None
            else None
        ),
        "breach_any": any(per[name]["breach"] for name in sorted(per)),
        "window": {
            "samples": len(samples),
            "short_samples": len(short),
            "long_samples": len(long),
            "span_s": round(
                max(
                    0.0,
                    _num(samples[-1].get("t")) - _num(samples[0].get("t")),
                ),
                3,
            )
            if len(samples) >= 2
            else 0.0,
        },
    }


# determinism-scope
def digest_summary(report: dict | None) -> dict | None:
    """The compact form the fleet obs digest carries (worst burn rate +
    breach flag), so ``top --fleet`` shows fleet-wide budget health."""
    if not isinstance(report, dict):
        return None
    worst = report.get("worst")
    if not isinstance(worst, dict):
        return None
    return {
        "burn": round(_num(worst.get("burn_rate")), 3),
        "objective": str(worst.get("objective")),
        "breach": 1 if report.get("breach_any") else 0,
    }


# ----------------------------------------------------------------- health


# determinism-scope
def build_health(
    probe_ok: bool | None = None,
    breakers: dict | None = None,
    sampler_alive: bool | None = None,
    pump_age_s: float | None = None,
    pump_max_age_s: float | None = None,
    slo_report: dict | None = None,
) -> dict:
    """The shared liveness/readiness verdict (pure — every age is
    passed in). ``live`` is unconditionally True: answering at all IS
    the liveness probe. ``status``:

    * ``ready``    — serve traffic;
    * ``degraded`` — structurally healthy but an SLO objective is in
      breach (drain politely: the budget is burning);
    * ``unready``  — a structural reason (probe unresolved, breaker
      stuck open past cooldown, sampler dead, tracker pump stalled).

    A ``None`` input means "component not applicable here" and is
    skipped — the bridge has no pump, the tracker has no device probe.
    """
    reasons: list[str] = []
    if probe_ok is False:
        reasons.append("backend probe unresolved")
    for lane in sorted(breakers or {}):
        b = (breakers or {})[lane]
        if not isinstance(b, dict) or b.get("state") != "open":
            continue
        age = b.get("open_age_s")
        cooldown = _num(b.get("cooldown"))
        if age is not None and cooldown > 0 and _num(age) > cooldown * BREAKER_STUCK_FACTOR:
            reasons.append(f"breaker stuck open past cooldown: {lane}")
    if sampler_alive is False:
        reasons.append("timeline sampler dead")
    if (
        pump_age_s is not None
        and pump_max_age_s is not None
        and _num(pump_age_s) > _num(pump_max_age_s)
    ):
        reasons.append(f"tracker pump stalled ({_num(pump_age_s):.1f}s)")
    breaches = sorted(
        name
        for name, obj in ((slo_report or {}).get("objectives") or {}).items()
        if isinstance(obj, dict) and obj.get("breach")
    )
    if reasons:
        status = "unready"
    elif breaches:
        status = "degraded"
    else:
        status = "ready"
    return {
        "live": True,
        "ready": status == "ready",
        "status": status,
        "reasons": reasons,
        "slo_breaches": breaches,
    }


# ----------------------------------------------------------------- engine


class SloEngine:
    """Stateful wrapper: evaluation + breach-transition tracking.

    ``observe(timeline_snapshot)`` (the sampler's ``on_sample`` hook,
    called from the sampler thread) re-evaluates and fires exactly one
    ``slo_breach`` flight-recorder dump per observe pass that NEWLY
    breaches one or more objectives; nothing fires again until the
    breach clears and re-occurs. ``report()`` is read from serving
    loops (``GET /v1/slo``, /metrics) — state sits behind one leaf
    :func:`named_lock`, and the recorder trigger runs OUTSIDE it."""

    def __init__(
        self,
        objectives: tuple[SloObjective, ...] | str = DEFAULT_SLO_SPEC,
        short_samples: int = DEFAULT_SHORT_SAMPLES,
        long_samples: int = DEFAULT_LONG_SAMPLES,
    ):
        if isinstance(objectives, str):
            objectives = parse_objectives(objectives)
        self.objectives = tuple(objectives)
        self.short_samples = short_samples
        self.long_samples = long_samples
        self._lock = named_lock("obs.slo._lock")
        # dynamic lockset checking: report + breach map are one cell
        # (sampler thread writes, serving loops read)
        self._cells = guard_attrs("obs.slo", "report")
        self._report: dict | None = None
        self._breached: dict[str, bool] = {}
        self._breach_dumps = 0

    def observe(self, timeline_snapshot: dict) -> dict:
        samples = (
            timeline_snapshot.get("samples")
            if isinstance(timeline_snapshot, dict)
            else timeline_snapshot
        )
        report = evaluate_slo(
            samples or [], self.objectives, self.short_samples, self.long_samples
        )
        newly: list[str] = []
        with self._lock:
            self._cells.write("report")
            for name in sorted(report["objectives"]):
                breach = report["objectives"][name]["breach"]
                if breach and not self._breached.get(name):
                    newly.append(name)
                self._breached[name] = breach
            self._report = report
            if newly:
                self._breach_dumps += 1
        if newly:
            # outside the engine lock: the recorder takes its own leaf
            # lock and snapshots the tracer ring
            from torrent_tpu_torch.obs.recorder import flight_recorder

            flight_recorder().trigger(
                "slo_breach",
                detail={
                    "objectives": newly,
                    "report": {
                        name: report["objectives"][name] for name in newly
                    },
                    "window": report["window"],
                },
            )
            log.warning("SLO breach: %s", ", ".join(newly))
        return report

    def report(self) -> dict | None:
        with self._lock:
            self._cells.read("report")
            return self._report

    def summary(self) -> dict | None:
        """The fleet-digest form of the last report."""
        return digest_summary(self.report())

    def metrics_snapshot(self) -> dict:
        with self._lock:
            self._cells.read("report")
            return {
                "report": self._report,
                "breach_dumps": self._breach_dumps,
                "objectives": len(self.objectives),
            }


# a process may arm at most one engine (the bridge's, or serve's); the
# fleet obs digest reads it so heartbeats carry budget health. None
# unless explicitly armed — zero overhead, zero byte-difference when
# objectives are off.
_armed: SloEngine | None = None


def arm(engine: SloEngine) -> SloEngine:
    global _armed
    _armed = engine
    return engine


def armed() -> SloEngine | None:
    return _armed


def disarm(engine: SloEngine | None = None) -> None:
    """Clear the armed slot. Pass the engine you armed: if another
    server armed a NEWER engine since, its slot must survive your
    shutdown (disarm(None) force-clears — tests only)."""
    global _armed
    if engine is None or _armed is engine:
        _armed = None
