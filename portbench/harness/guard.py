"""Nothing the benchmark runs may load JAX or the JAX package.

Names are compared whole by their top-level part (before the first dot):
``multimodars_torch`` is the port, ``multimodars`` the JAX package's shim."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "multimodars_tpu", "multimodars", "bench"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list:
    """Forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names} & FORBIDDEN)


def imported_names(path: Path) -> set:
    """Top-level names of every module a Python file imports (relative
    imports left out)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(top_level(node.module))
    return out
