"""The port's copied modules stay copies of the reference's.

Each file below is held against its reference source as syntax trees:
the package prefix (``torrent_tpu_torch`` → ``torrent_tpu``) and every
docstring are ignored, comments never reach the tree, and each top-level
function, class and method must be the reference's node for node. The
only differences allowed are the ones listed in ``DIVERGENCES``, by
qualified name with the reason; an entry whose definition no longer
differs fails too, so the list stays exact.
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
)
DIVERGENCES = {
    "obs/fleet.py": {
        # the SLO plane (obs/slo) comes with the serving slice; the
        # reference's unarmed engine gives the same None
        "obs_digest": "no armed SLO engine to summarise",
    },
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
