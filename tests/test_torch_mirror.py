"""The port's copied modules stay copies of the reference's.

Each file below is held against its reference source as syntax trees:
the package prefix (``torrent_tpu_torch`` → ``torrent_tpu``) and every
docstring are ignored, comments never reach the tree, and each top-level
function, class and method must be the reference's node for node. The
only differences allowed are the ones listed in ``DIVERGENCES``, by
qualified name with the reason; an entry whose definition no longer
differs fails too, so the list stays exact.

The port's ``utils.locks`` stands in for the reference's
``analysis.sanitizer`` as the module that hands out ``named_lock`` and
``guard_attrs`` (plain locks and no-op cells until the sanitizer is
ported), so an import of those names from it reads as the reference's.
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
)
DIVERGENCES = {
    # the lockset sanitizer (analysis/sanitizer.py) is not ported: what
    # it adds when enabled is absent, as in the reference when it is off
    "obs/recorder.py": {
        "FlightRecorder.trigger": "no sanitizer snapshot under a dump's tsan key",
    },
    "obs/timeline.py": {
        "sample_now": "no sanitizer snapshot: a sample's tsan input is None",
    },
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
    "utils/metrics.py": {
        "MetricsServer._handle": "no sanitizer block on /metrics until the sanitizer is ported",
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
    # tools/fabric_verify.py's; lint waits for its module
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
        "_cmd_lint": "exits 2 with one line until the analysis plane is ported",
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
    ref = _definitions(REPO / "torrent_tpu" / rel)
    allowed = DIVERGENCES.get(rel, {})
    assert sorted(mine) == sorted(ref), f"{rel}: definitions differ in name or order of statements"
    differ = {name for name in ref if mine[name] != ref[name]}
    assert differ == set(allowed), (
        f"{rel}: differs from the reference in {sorted(differ - set(allowed))}; "
        f"listed but identical: {sorted(set(allowed) - differ)}"
    )
