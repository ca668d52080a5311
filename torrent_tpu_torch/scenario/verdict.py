"""Verdict functions — pure functions from (spec, SLO report, facts) to
the scenario's outcome artifact.

A verdict is an ERROR-BUDGET STATEMENT, not an assertEqual: it carries
the full ``obs.slo.evaluate_slo`` report, the behaviors' facts, and a
human budget sentence per objective — pass/fail falls out of "no
objective breached and no invariant violated", and the remaining
budget says how close the run came.

Pure and total (determinism pass SCOPE): no clocks, no randomness, no
IO; every iteration is sorted. ``canonical_verdict`` strips the wall
plane, leaving exactly the bytes a same-seed replay must reproduce.
"""

# determinism-scope: module
# (the verdict is the artifact same-seed replays are diffed on)

from __future__ import annotations

import json

VERDICT_VERSION = 1


def budget_statement(slo_report: dict) -> str:
    """One human sentence per objective: remaining budget, burn rate,
    classification — the shape an SLO review reads out loud."""
    objectives = slo_report.get("objectives") or {}
    if not objectives:
        return "no objectives evaluated"
    parts = []
    for name in sorted(objectives):
        obj = objectives[name] or {}
        remaining = obj.get("budget_remaining", 0.0)
        parts.append(
            f"{name}: {round(float(remaining) * 100, 1)}% budget left, "
            f"burn {obj.get('burn_rate', 0.0)} "
            f"({obj.get('classification', 'ok')})"
        )
    return "; ".join(parts)


def build_verdict(
    spec, slo_report: dict, facts: dict, failures: list[str]
) -> dict:
    """Assemble the deterministic verdict. ``failures`` are invariant
    violations from the engine and behaviors (empty = all held)."""
    reasons = list(failures)
    objectives = slo_report.get("objectives") or {}
    for name in sorted(objectives):
        obj = objectives[name] or {}
        if obj.get("breach"):
            reasons.append(
                f"slo breach: {name} burned "
                f"{obj.get('burn_rate', 0.0)}x its error budget "
                f"({obj.get('classification', '?')})"
            )
    return {
        "v": VERDICT_VERSION,
        "scenario": spec.name,
        "seed": spec.seed,
        "ticks": spec.ticks,
        "population": spec.population(),
        "pass": not reasons,
        "reasons": reasons,
        "budget": budget_statement(slo_report),
        "slo": slo_report,
        "facts": facts,
    }


def canonical_verdict(verdict: dict) -> dict:
    """The verdict minus its wall plane — the part of the artifact a
    same-seed replay reproduces bit-identically. Wall latencies are
    real ``perf_counter`` measurements and legitimately differ run to
    run; everything else may not."""
    return {k: verdict[k] for k in sorted(verdict) if k != "wall"}


def canonical_bytes(verdict: dict, timeline_snap: dict) -> bytes:
    """The byte string two same-seed runs are diffed on: canonical
    verdict + timeline ring, JSON with sorted keys."""
    return json.dumps(
        {"verdict": canonical_verdict(verdict), "timeline": timeline_snap},
        sort_keys=True,
    ).encode()
