"""The port's copied modules stay copies of the reference's.

Each file below is held against its reference source as syntax trees:
the package prefix (``torrent_tpu_torch`` → ``torrent_tpu``) and every
docstring are ignored, comments never reach the tree, and each top-level
function, class and method must be the reference's node for node. The
only differences allowed are the ones listed in ``DIVERGENCES``, by
qualified name with the reason; an entry whose definition no longer
differs fails too, so the list stays exact.

The port's modules take ``named_lock`` and ``guard_attrs`` from its
``utils.locks``, a re-export of ``analysis.sanitizer``'s, so an import
of those names from it reads as the reference's import from the
sanitizer.
"""

from __future__ import annotations

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
MIRRORED = (
    "fabric/plan.py",
    "fabric/receipts.py",
    "obs/fleet.py",
    "codec/bencode.py",
    "codec/valid.py",
    "codec/metainfo_v2.py",
    "utils/bytesio.py",
    "utils/env.py",
    "storage/piece.py",
    "obs/attrib.py",
    "obs/hist.py",
    "obs/tracer.py",
    "obs/ledger.py",
    "obs/recorder.py",
    "obs/swarm.py",
    "obs/timeline.py",
    "obs/slo.py",
    "serve_plane/telemetry.py",
    "utils/bitfield.py",
    "utils/ratelimit.py",
    "utils/timeout.py",
    "net/constants.py",
    "net/types.py",
    "net/protocol.py",
    "net/extension.py",
    "net/mse.py",
    "net/priority.py",
    "net/tracker.py",
    "net/multitracker.py",
    "server/tracker.py",
    "server/in_memory.py",
    "serve_plane/choke.py",
    "serve_plane/egress.py",
    "serve_plane/reactor.py",
    "session/peer.py",
    "session/resume.py",
    "session/webseed.py",
    "models/hashes.py",
    "storage/storage.py",
    "session/torrent.py",
    "session/client.py",
    "net/ipfilter.py",
    "net/socks.py",
    "codec/magnet.py",
    "session/metadata.py",
    "utils/ed25519.py",
    "codec/signing.py",
    "net/dht.py",
    "net/utp.py",
    "net/lsd.py",
    "net/natpmp.py",
    "net/upnp.py",
    "net/dnsprefs.py",
    "server/shard.py",
    "net/indexer.py",
    "utils/metrics.py",
    "scenario/spec.py",
    "scenario/verdict.py",
    "scenario/actors.py",
    "scenario/engine.py",
    "scenario/library/__init__.py",
    "scenario/__init__.py",
    "server/__init__.py",
    "tools/serve.py",
    "tools/stream.py",
    "tools/feed.py",
    "tools/netbench.py",
    "tools/top.py",
    "tools/cli.py",
    "tools/bench_cli.py",
    "utils/trace.py",
    "analysis/__init__.py",
    "analysis/sanitizer.py",
    "analysis/findings.py",
    "analysis/lint.py",
    "analysis/passes/__init__.py",
    "analysis/passes/common.py",
    "analysis/passes/lock_order.py",
    "analysis/passes/blocking_async.py",
    "analysis/passes/device_under_lock.py",
    "analysis/passes/determinism.py",
    "analysis/passes/guarded_state.py",
    "analysis/passes/lifecycle.py",
    "analysis/passes/dataflow.py",
    "analysis/passes/wire_taint.py",
    "analysis/passes/bounded_state.py",
    "examples/batched_recheck.py",
    "examples/seed_and_download.py",
    "examples/v2_author_verify.py",
)
# copies whose reference lives outside the reference package
REFERENCE_PATHS = {
    f"examples/{name}.py": REPO / "examples" / f"{name}.py"
    for name in ("batched_recheck", "seed_and_download", "v2_author_verify")
}
DIVERGENCES = {
    # the hash plane is the GPU's: hasher "gpu" | "cpu" (default "gpu")
    # on a ``device`` (None means CUDA), and "gpu" never turns into hashlib
    "session/torrent.py": {
        "TorrentConfig": 'hasher "gpu" | "cpu", default "gpu"; new field device',
        "Torrent.recheck": 'hasher "gpu" passes device and batch_size to verify_pieces',
        "Torrent._verify_piece_data": (
            'hasher "gpu" with no shared verifier builds its own GPUVerifier '
            "instead of hashing with hashlib"
        ),
        "Torrent._flush_verify_batch": (
            "a device error reaches every waiter as the exception, never as "
            "a hashlib verdict"
        ),
        "Torrent._verify_batch_device_v2": "leaf and merkle launches take config.device",
    },
    "session/client.py": {
        "ClientConfig": 'hasher "gpu" | "cpu", default "gpu"; new field device',
        "Client.start": 'hasher "gpu" resolves the device before listening: no card, no socket',
        "Client._verifier_for": "a shared GPUVerifier on config.device",
        "Client.add": "the derived TorrentConfig carries device",
    },
    # the clients' hasher is the card's by default, so the bench takes
    # the hasher and the device; its harness is the port's own test file
    "tools/netbench.py": {
        "_swarm": (
            'hasher and device parameters reach every ClientConfig; the '
            "harness comes from tests/test_torch_session.py"
        ),
        "main": "--hasher gpu|cpu (default gpu) and --device",
    },
    # the command line: every hashing subcommand takes --hasher gpu|cpu
    # (default gpu, the card) and --device; fabric-verify is
    # tools/fabric_verify.py's
    "tools/cli.py": {
        "_feed_loop": "the subscriber's ClientConfig takes --hasher and --device",
        "_cmd_make": "make_torrent takes --device",
        "_make_v2": "build_v2 and build_hybrid take --device",
        "_verify_v2": "verify_v2 takes --device",
        "_cmd_verify": 'hasher "gpu" (not "tpu") passes --batch and --device',
        "_seed_box": "the ClientConfig takes --device",
        "_fabric_verify": (
            "tools/fabric_verify.py's sweep (a torch.distributed rendezvous, "
            "no jax.distributed, no virtual CPU devices)"
        ),
        "_cmd_fabric_verify": "shuts the process group down after the sweep",
        "_cmd_doctor": "forwards --device; no re-exec comment",
        "_cmd_bench": "forwards --device to tools/bench_cli.py",
        "_download": "the ClientConfig takes --device",
        "_cmd_bridge": "the port's bridge command (bridge/__main__.py), with --device",
        "build_parser": (
            "--hasher gpu|cpu (default gpu) and --device beside every --hasher "
            "(feed gains both); fabric-verify takes tools/fabric_verify.py's "
            "flags; doctor takes --device"
        ),
        "main": (
            "no TORRENT_TPU_PLATFORM jax pin; a missing CUDA device is one "
            "error line and exit 1"
        ),
    },
}


DIVERGENCES["tools/bench_cli.py"] = {
    # the port's device bench and fabric measurer are modules of the
    # package (the reference's rungs shell out to the repo's bench.py and
    # .bench/measure_fabric.py, which import jax); there is one sha256
    # plane, so no backend env; the hash plane is the card's
    "<statement 16: Assign>": "_DEVICE_RUNG_ENV: no TORRENT_TPU_SHA256_BACKEND",
    "default_trajectory_path": (
        "TORRENT_TPU_BENCH_TRAJECTORY or ./BENCH_trajectory_cuda.json, never "
        "the repo's BENCH_trajectory.json (the reference's TPU and CPU records)"
    ),
    "_build_smoke_torrent": 'authors with hashlib (hasher="cpu"): the port\'s default is the card',
    "_e2e": 'takes device; hasher "gpu" | "cpu"; platform is "cpu" or the device type',
    "_swarm_rung": "both clients take hasher and device; platform is the plane's device",
    "_seed_rung": "the seed takes hasher and device; platform is the plane's device",
    "_run_bench_py": (
        "runs python -m torrent_tpu_torch.tools.device_bench; device becomes "
        "BENCH_PLATFORM"
    ),
    "_run_fabric_rung": (
        "runs python -m torrent_tpu_torch.tools.bench_fabric, no jax env; takes "
        "hasher and device (not FABRIC_HASHER); platform is the plane's device"
    ),
    "main": "--hasher gpu|cpu (default gpu) and --device reach the rungs",
}


# the analysis plane lints the port: its device list names what
# enqueues or waits on card work (the CUDA kernel entries, collectives,
# synchronize, anything rooted at torch) instead of jax's, and the gate's
# default root and program name are the port's
DIVERGENCES["analysis/passes/common.py"] = {
    "<statement 3: Assign>": (
        "DEVICE_CALL_NAMES: the CUDA kernel entries, torch.distributed "
        "collectives and synchronize, no pallas/jax names"
    ),
    "<statement 4: Assign>": 'DEVICE_ROOTS = ("torch",)',
}
DIVERGENCES["analysis/passes/blocking_async.py"] = {
    "<statement 6: Assign>": (
        "BLOCKING_DOTTED: torch.cuda.synchronize / device_count / "
        "is_available instead of jax.devices"
    ),
    "<statement 7: Assign>": "BLOCKING_TAILS: synchronize and item",
    "<statement 9: Assign>": 'BLOCKING_ROOTS = ("torch",)',
}
DIVERGENCES["analysis/lint.py"] = {
    "default_root": "the installed torrent_tpu_torch",
    "main": "the program name is python -m torrent_tpu_torch lint",
}
# the examples: the hasher is the card's by default (a positional
# gpu|cpu and --device; a missing CUDA is one error line and exit 1), and
# each lives inside the package, so a run by path puts the checkout three
# directories up on sys.path
_EXAMPLE = {
    "main": 'hasher gpu | cpu (default gpu) and --device; DeviceUnavailable is "error: ..." and exit 1',
    "<statement {try_at}: Try>": "the module path: the checkout root is three directories above the example",
    "<statement {if_at}: If>": "the exit code of main is the process's",
}
for _rel, _try_at, _if_at in (
    ("examples/batched_recheck.py", 3, 8),
    ("examples/seed_and_download.py", 5, 10),
    ("examples/v2_author_verify.py", 3, 9),
):
    DIVERGENCES[_rel] = {k.format(try_at=_try_at, if_at=_if_at): v for k, v in _EXAMPLE.items()}
DIVERGENCES["utils/trace.py"] = {
    # the port's profiler names its flush public (flush_trace)
    "<statement 1: ImportFrom>": "re-exports flush_trace, not _flush_trace",
}
# the ledger's stages are regions of a running torch.profiler's timeline,
# and a read's wait for the pread pool's lock is not read time
DIVERGENCES["obs/ledger.py"] = {
    "_Tracked": "__slots__ gain _wait_s (a wait left out) and _region (the open profiler region)",
    "_Tracked.__init__": "starts with no wait left out and no region",
    "_Tracked.add": "takes wait_s, seconds of the body left out of its busy time",
    "_Tracked.__enter__": "opens a pipeline.<stage> region while a profiler runs (one flag read otherwise)",
    "_Tracked.__exit__": "busy time less the waits left out; closes its region",
    "PipelineLedger.__init__": "keeps obs/profiler.py's annotate and profiling for its entries",
    "PipelineLedger": "COUNTERS: the names recorded beside the stages (read_wait, the copy's counters)",
}
# the native pool's lock wait (read_wait) and the copy's counters
# (obs/h2d.py) are ledger counters, not stages
DIVERGENCES["obs/attrib.py"] = {
    "attribute": "a counter of PipelineLedger.COUNTERS is never the limiting stage nor the demanded rate",
}
DIVERGENCES["storage/storage.py"] = {
    "Storage.read_batch": (
        "one ledger read entry a call, over its zero-fill, planning and "
        "reads (the native pool's or the Python walk's); track=False leaves "
        "the entry to a caller that reads in concurrent stripes"
    ),
    "Storage._native_read_batch": (
        "takes the caller's ledger entry: adds the bytes read and leaves out "
        "the wait for the pool's lock"
    ),
}

class _Normalise(ast.NodeTransformer):
    """Drop docstrings and map the port's package name to the reference's."""

    def _strip(self, node):
        self.generic_visit(node)
        body = getattr(node, "body", None)
        if (
            isinstance(body, list)
            and body
            and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)
        ):
            node.body = body[1:] or [ast.Pass()]
        return node

    visit_Module = visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = _strip

    def visit_ImportFrom(self, node):
        if node.module:
            node.module = node.module.replace("torrent_tpu_torch", "torrent_tpu")
            if node.module == "torrent_tpu.utils.locks":
                node.module = "torrent_tpu.analysis.sanitizer"
        return node

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            node.value = node.value.replace("torrent_tpu_torch", "torrent_tpu")
        return node


def _definitions(path: pathlib.Path) -> dict[str, str]:
    """Qualified name → normalised dump of every top-level statement,
    with a class's methods under ``Class.method``."""
    tree = _Normalise().visit(ast.parse(path.read_text()))
    out: dict[str, str] = {}
    for i, node in enumerate(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.ClassDef):
            rest = []
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = ast.dump(sub)
                else:
                    rest.append(ast.dump(sub))
            out[node.name] = repr((node.name, [ast.dump(b) for b in node.bases], rest))
        else:
            out[f"<statement {i}: {type(node).__name__}>"] = ast.dump(node)
    return out


@pytest.mark.parametrize("rel", MIRRORED)
def test_mirror_matches_reference(rel):
    mine = _definitions(REPO / "torrent_tpu_torch" / rel)
    ref = _definitions(REFERENCE_PATHS.get(rel, REPO / "torrent_tpu" / rel))
    allowed = DIVERGENCES.get(rel, {})
    assert sorted(mine) == sorted(ref), f"{rel}: definitions differ in name or order of statements"
    differ = {name for name in ref if mine[name] != ref[name]}
    assert differ == set(allowed), (
        f"{rel}: differs from the reference in {sorted(differ - set(allowed))}; "
        f"listed but identical: {sorted(set(allowed) - differ)}"
    )
