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
    ):
        assert name in MODULES
    assert (PACKAGE / "csrc" / "sha1.cu").is_file()
    assert (PACKAGE / "csrc" / "sha256.cu").is_file()


def test_importing_every_module_loads_no_jax_and_no_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, json.dumps(MODULES)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


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
