"""The JAX side of the repository stays out of every run.

Module names are compared by their top-level name whole, so
``myscaledb_tpu_torch`` (the port) passes and ``myscaledb_tpu`` (the JAX
package) does not."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "myscaledb_tpu"})
PROGRAM = "myscaledb_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list:
    """Names in ``sys.modules`` (or ``modules``) whose top level is
    forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top(n) in FORBIDDEN)


def imported_names(path: Path) -> set:
    """Every module a Python file imports, by its full dotted name
    (relative imports as written)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add("." * node.level + node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value))
    return out
