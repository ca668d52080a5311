"""The port stands alone: it imports neither jax nor torrent_tpu.

This process has jax loaded already (tests/conftest.py), so the import
check runs in a fresh interpreter: it imports torrent_tpu_torch and every
module of the package, then lists what of jax and torrent_tpu reached
``sys.modules``. A static scan of the sources backs it up.
"""

import ast
import json
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "torrent_tpu_torch"
SOURCES = sorted(PACKAGE.rglob("*.py"))
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in SOURCES
)

_PROBE = """
import importlib, json, sys
for name in json.loads(sys.argv[1]):
    importlib.import_module(name)
leaked = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "torrent_tpu"))
print(json.dumps(leaked))
"""


def test_package_has_the_slice():
    for name in (
        "torrent_tpu_torch.models.verifier",
        "torrent_tpu_torch.parallel.verify",
        "torrent_tpu_torch.ops.sha1_cuda",
        "torrent_tpu_torch.ops.sha1_torch",
        "torrent_tpu_torch.ops.sha256_cuda",
        "torrent_tpu_torch.ops.sha256_torch",
        "torrent_tpu_torch.codec.metainfo_v2",
        "torrent_tpu_torch.session.v2",
        "torrent_tpu_torch.models.merkle",
        "torrent_tpu_torch.models.v2",
        "torrent_tpu_torch.tools.make_torrent",
        "torrent_tpu_torch.compat",
        "torrent_tpu_torch.entry",
        "torrent_tpu_torch.parallel.mesh",
        "torrent_tpu_torch.sched",
        "torrent_tpu_torch.sched.scheduler",
        "torrent_tpu_torch.sched.faults",
        "torrent_tpu_torch.sched.control",
        "torrent_tpu_torch.obs",
        "torrent_tpu_torch.obs.tracer",
        "torrent_tpu_torch.obs.hist",
        "torrent_tpu_torch.obs.attrib",
        "torrent_tpu_torch.obs.ledger",
        "torrent_tpu_torch.obs.recorder",
        "torrent_tpu_torch.obs.profiler",
        "torrent_tpu_torch.utils.metrics",
        "torrent_tpu_torch.parallel.bulk",
        "torrent_tpu_torch.parallel.distributed",
        "torrent_tpu_torch.fabric",
        "torrent_tpu_torch.fabric.plan",
        "torrent_tpu_torch.fabric.receipts",
        "torrent_tpu_torch.fabric.executor",
        "torrent_tpu_torch.obs.fleet",
        "torrent_tpu_torch.tools.fabric_verify",
        "torrent_tpu_torch.bridge",
        "torrent_tpu_torch.bridge.service",
        "torrent_tpu_torch.bridge.__main__",
        "torrent_tpu_torch.obs.slo",
        "torrent_tpu_torch.obs.timeline",
        "torrent_tpu_torch.obs.swarm",
        "torrent_tpu_torch.serve_plane",
        "torrent_tpu_torch.serve_plane.telemetry",
        "torrent_tpu_torch.serve_plane.choke",
        "torrent_tpu_torch.serve_plane.egress",
        "torrent_tpu_torch.serve_plane.reactor",
        "torrent_tpu_torch.utils.bitfield",
        "torrent_tpu_torch.utils.ratelimit",
        "torrent_tpu_torch.utils.timeout",
        "torrent_tpu_torch.net",
        "torrent_tpu_torch.net.constants",
        "torrent_tpu_torch.net.types",
        "torrent_tpu_torch.net.protocol",
        "torrent_tpu_torch.net.extension",
        "torrent_tpu_torch.net.mse",
        "torrent_tpu_torch.net.priority",
        "torrent_tpu_torch.net.tracker",
        "torrent_tpu_torch.net.multitracker",
        "torrent_tpu_torch.server",
        "torrent_tpu_torch.server.tracker",
        "torrent_tpu_torch.server.in_memory",
        "torrent_tpu_torch.session",
        "torrent_tpu_torch.session.peer",
        "torrent_tpu_torch.session.resume",
        "torrent_tpu_torch.session.webseed",
        "torrent_tpu_torch.session.torrent",
        "torrent_tpu_torch.session.client",
        "torrent_tpu_torch.models.hashes",
        "torrent_tpu_torch.net.ipfilter",
        "torrent_tpu_torch.net.socks",
        "torrent_tpu_torch.codec.magnet",
        "torrent_tpu_torch.session.metadata",
        "torrent_tpu_torch.utils.ed25519",
        "torrent_tpu_torch.codec.signing",
        "torrent_tpu_torch.net.dht",
        "torrent_tpu_torch.net.utp",
        "torrent_tpu_torch.net.lsd",
        "torrent_tpu_torch.net.natpmp",
        "torrent_tpu_torch.net.upnp",
        "torrent_tpu_torch.net.dnsprefs",
        "torrent_tpu_torch.server.shard",
        "torrent_tpu_torch.net.indexer",
        "torrent_tpu_torch.scenario",
        "torrent_tpu_torch.scenario.spec",
        "torrent_tpu_torch.scenario.verdict",
        "torrent_tpu_torch.scenario.actors",
        "torrent_tpu_torch.scenario.engine",
        "torrent_tpu_torch.scenario.library",
        "torrent_tpu_torch.tools.serve",
        "torrent_tpu_torch.tools.stream",
        "torrent_tpu_torch.tools.feed",
        "torrent_tpu_torch.tools.netbench",
        "torrent_tpu_torch.__main__",
        "torrent_tpu_torch.tools.cli",
        "torrent_tpu_torch.tools.top",
        "torrent_tpu_torch.tools.doctor",
        "torrent_tpu_torch.tools.bench_cli",
        "torrent_tpu_torch.tools.device_bench",
        "torrent_tpu_torch.tools.bench_fabric",
        "torrent_tpu_torch.tools.tune_sha1",
        "torrent_tpu_torch.tools.tune_sha256",
        "torrent_tpu_torch.utils.trace",
        "torrent_tpu_torch.analysis",
        "torrent_tpu_torch.analysis.__main__",
        "torrent_tpu_torch.analysis.sanitizer",
        "torrent_tpu_torch.analysis.findings",
        "torrent_tpu_torch.analysis.lint",
        "torrent_tpu_torch.analysis.passes",
        "torrent_tpu_torch.analysis.passes.common",
        "torrent_tpu_torch.analysis.passes.lock_order",
        "torrent_tpu_torch.analysis.passes.blocking_async",
        "torrent_tpu_torch.analysis.passes.device_under_lock",
        "torrent_tpu_torch.analysis.passes.determinism",
        "torrent_tpu_torch.analysis.passes.guarded_state",
        "torrent_tpu_torch.analysis.passes.lifecycle",
        "torrent_tpu_torch.analysis.passes.dataflow",
        "torrent_tpu_torch.analysis.passes.wire_taint",
        "torrent_tpu_torch.analysis.passes.bounded_state",
        "torrent_tpu_torch.analysis.pytest_plugin",
        "torrent_tpu_torch.tools.ci",
        "torrent_tpu_torch.examples",
        "torrent_tpu_torch.examples.batched_recheck",
        "torrent_tpu_torch.examples.seed_and_download",
        "torrent_tpu_torch.examples.v2_author_verify",
    ):
        assert name in MODULES
    assert (PACKAGE / "csrc" / "sha1.cu").is_file()
    assert (PACKAGE / "csrc" / "sha256.cu").is_file()
    assert (PACKAGE / "analysis_baseline.json").is_file()


def test_analysis_plane_imports_no_torch():
    """The sanitizer is imported by every module that makes a lock, and
    the lint runs where the card's stack may be absent: the analysis
    package imports no torch, in a fresh interpreter."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, torrent_tpu_torch.analysis.lint, torrent_tpu_torch.utils.locks; "
         "print(sorted(n for n in sys.modules if n.split('.')[0] == 'torch'))"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_importing_every_module_loads_no_jax_and_no_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, json.dumps(MODULES)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_grid_dry_run_loads_no_jax_and_no_reference():
    """``entry.dryrun_multichip`` (the grid over ``parallel/mesh.py``)
    runs in a fresh interpreter on CPU entries and loads neither jax nor
    the reference."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; from torrent_tpu_torch.entry import dryrun_multichip; "
         "dryrun_multichip(4, device='cpu'); "
         "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'torrent_tpu')))"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("dryrun_multichip OK: mesh={'hosts': 2, 'dp': 2}, batch=8, valid=7/8")
    assert lines[-1] == "[]"


def test_package_import_is_lazy():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, torrent_tpu_torch; "
         "print(sorted(n for n in sys.modules if n.startswith('torrent_tpu_torch')))"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "['torrent_tpu_torch']"


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path", SOURCES + [REPO / "chip_smoke.py"], ids=lambda p: str(p.relative_to(REPO))
)
def test_sources_import_no_jax_and_no_reference(path):
    for name in _imported_roots(path):
        assert name.split(".")[0] not in ("jax", "jaxlib", "torrent_tpu"), f"{path}: {name}"
    text = path.read_text()
    assert "import jax" not in text
    # a dotted reference module path (not torrent_tpu_torch's) in any string
    # would be an import waiting to happen, e.g. through importlib
    assert not re.search(r"\btorrent_tpu\.[A-Za-z_]", text)
