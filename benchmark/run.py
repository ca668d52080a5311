"""Run one cell of ``BENCHMARK.json`` once.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: sets the cell up from ``--seed`` (inputs,
the port's state, warm-up), measures whole units of work back to back
for ``--seconds``, judges every answer of the window against the plain
reference, and prints one JSON line last on standard output (the
numbers compared, beside their limits, also end standard error). With
``--trace 1`` the window runs under ``torch.profiler`` and the line
holds the cell's per-layer metrics instead of its end-to-end ones. On
the card every run's window is traced, so that end-to-end metrics whose
source is the device trace are read from it as per-layer ones are, each
by its own reader (``layer_metrics/<metric>.py``). ``setup_s`` runs from
the process's start to the end of the driver's set-up (the profiler's
start is left out), less the seconds the set-up spent in the plain
reference (``Cell.reference_s``).

Exits 2 without a line when CUDA is missing or has fewer cards than the
cell asks for, and 3 when JAX or the JAX package was loaded.

``--control 1`` puts the reference's lower-fidelity control in the
program's place: it is for setting the cells' limits, and the
benchmark's own runs never use it.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402


@dataclass
class Context:
    """What a driver's ``Cell`` is built from."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    tmpdir: str
    device: str | None = None  # None: the card (the port's default)
    control: bool = False


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python -m benchmark.run", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool = False, control: bool = False,
             device: str | None = None, program=None) -> dict:
    """Set up, measure and judge one run of cell ``name``; returns the
    result line's fields. ``device`` None is the card; ``program``
    replaces the driver's timed call into the port (the tests' faults)."""
    import torch

    from benchmark import harness

    cell = harness.find(bench["workloads"], name, "workload")
    traffic = harness.load_traffic(cell["traffic"])
    driver = harness.load_driver(traffic["driver"])
    end_to_end = harness.metrics_for(bench["end_to_end"], cell["name"])
    per_layer = harness.metrics_for(bench["per_layer"], cell["name"], {m["name"] for m in end_to_end})
    on_card = device is None

    tmp = tempfile.mkdtemp(prefix="benchmark-")
    run = None
    try:
        ctx = Context(cell, harness.load_config(bench, cell["config"]), traffic, seed, tmp, device, control)
        run = driver.Cell(ctx, program) if program is not None else driver.Cell(ctx)
        run.setup()
        ready = time.perf_counter()
        hooks = harness.Hooks(traced=trace or on_card)
        prof = None
        if hooks.traced:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        win = run.window(seconds, hooks)
        dev = {"platform": "gpu" if on_card else "cpu", "count": cell["chips"]}
        if on_card:
            dev["kind"] = torch.cuda.get_device_name(0)
            dev["memory_peak_bytes"] = max(torch.cuda.max_memory_allocated(d) for d in range(cell["chips"]))
        tr = None
        if prof is not None:
            prof.stop()
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            tr = harness.read_trace(path)
            os.unlink(path)
            if trace:
                dev["busy_s"] = harness.device_busy_s(tr) / cell["chips"]
                dev["window_s"] = (tr["window_us"][1] - tr["window_us"][0]) / 1e6
        run.close()
        checks = run.check()
    finally:
        if run is not None:
            run.close()
        shutil.rmtree(tmp, ignore_errors=True)

    evidence = {"window_s": hooks.window_s, "window": (hooks.t0, hooks.t1), "trace": tr, "ledger": hooks.ledger_delta(), **hooks.evidence}
    if trace:
        values = {m["name"]: harness.load_reader(m["name"])(evidence) for m in per_layer}
        reported = per_layer
    else:
        values = dict(win["e2e"], setup_s=ready - _T0 - run.reference_s)
        for m in end_to_end:
            if m["source"] == "device_trace":
                values[m["name"]] = harness.load_reader(m["name"])(evidence)
        reported = end_to_end
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in reported if values[m["name"]] is not None}
    return {
        "correct": all(value <= limit for value, limit in checks.values()),
        "attempted": win["attempted"],
        "failed": win["failed"],
        "metrics": metrics,
        "device": dev,
        "breakdown": harness.breakdown(tr) if trace and tr is not None else None,
        "checks": {name: {"value": value, "limit": limit} for name, (value, limit) in checks.items()},
    }


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark import harness

    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(
            f"benchmark: cell {cell['name']} needs {cell['chips']} CUDA device(s); "
            f"available={torch.cuda.is_available()} count={torch.cuda.device_count()}",
            file=sys.stderr,
        )
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), bool(args.control))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(harness.result_line(**out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
