"""Run a cell several times, one process a run, and summarise the spread.

    python -m benchmark.sets --workload <cell> --seeds 11,12,13 --seconds 10 \
        [--trace 0|1] [--control 1] [--out runs.jsonl]

Each run is ``python -m benchmark.run`` with one of the seeds, in turn.
Every result line goes to ``--out`` (JSON lines, with the seed, exit
code, wall seconds and the end of standard error), and the summary
prints, for each metric, the median and the spread: the distance between
the first and third quartiles (``statistics.quantiles(values, n=4)``)
as a share of the median, over all runs and without the run farthest
from the median. This is how a cell's bounds and limits are
measured; the benchmark's own runs never call it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def spread_trimmed(values: list) -> float | None:
    """The spread with the run farthest from the median left out."""
    if len(values) < 3:
        return None
    mid = statistics.median(values)
    rest = list(values)
    rest.remove(max(rest, key=lambda v: abs(v - mid)))
    return spread(rest)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.sets")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--control", default="0")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    rows = []
    for seed in a.seeds.split(","):
        cmd = [sys.executable, "-m", "benchmark.run", "--workload", a.workload, "--seed", seed,
               "--seconds", a.seconds, "--trace", a.trace, "--control", a.control]
        t = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        wall = time.perf_counter() - t
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        row = {"seed": int(seed), "rc": proc.returncode, "wall_s": wall, "result": result, "stderr": proc.stderr[-3000:]}
        rows.append(row)
        brief = {k: v["value"] for k, v in (result or {}).get("metrics", {}).items()}
        print(f"seed={seed} rc={proc.returncode} wall_s={wall:.1f} correct={(result or {}).get('correct')} "
              f"attempted={(result or {}).get('attempted')} failed={(result or {}).get('failed')} {brief} "
              f"checks={(result or {}).get('checks')}", flush=True)
        if result is None:
            print(proc.stderr[-3000:], file=sys.stderr, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    metrics: dict = {}
    for row in rows:
        for k, v in ((row["result"] or {}).get("metrics") or {}).items():
            metrics.setdefault(k, []).append(v["value"])
    for k, vals in metrics.items():
        s = spread(vals)
        print(f"summary {a.workload} {k}: n={len(vals)} median={statistics.median(vals)!r} "
              f"min={min(vals)!r} max={max(vals)!r} spread={s!r} trimmed={spread_trimmed(vals)!r}", flush=True)
    return 0 if all(r["rc"] == 0 and r["result"] and r["result"]["correct"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
