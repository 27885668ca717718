"""The import guard: the benchmark measures the port alone.

No module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or ``ttnx``
(the JAX package) may be loaded in a run, compared by whole top-level
names, since the port's own name begins with ``ttnx``. The plain
references import nothing of the port either.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

__all__ = ["FORBIDDEN", "forbidden_loaded", "imported_tops", "check_reference"]

FORBIDDEN = ("jax", "jaxlib", "flax", "ttnx")
PORT = "ttnx_torch"
PACKAGE = Path(__file__).resolve().parents[1]


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: every
    module loaded in this process)."""
    names = sys.modules if modules is None else modules
    return sorted({n.partition(".")[0] for n in names} & set(FORBIDDEN))


def imported_tops(path: Path, seen=None) -> set[str]:
    """Top-level names that the source at ``path`` imports, following its
    imports of ``portbench`` modules into their sources."""
    seen = set() if seen is None else seen
    if path in seen:
        return set()
    seen.add(path)
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = path.parent
                for _ in range(node.level - 1):
                    base = base.parent
                rel = base.relative_to(PACKAGE.parent).as_posix().replace("/", ".")
                base = f"{rel}.{node.module}" if node.module else rel
            else:
                base = node.module
            mods = [base] + [f"{base}.{a.name}" for a in node.names]
        else:
            continue
        for mod in mods:
            top = mod.partition(".")[0]
            tops.add(top)
            if top == "portbench":
                sub = PACKAGE.parent.joinpath(*mod.split("."))
                for cand in (sub.with_suffix(".py"), sub / "__init__.py"):
                    if cand.is_file():
                        tops |= imported_tops(cand, seen)
    return tops


def check_reference(path: Path) -> None:
    """Raise if the reference at ``path`` imports the port or JAX."""
    bad = sorted(imported_tops(Path(path)) & (set(FORBIDDEN) | {PORT}))
    if bad:
        raise RuntimeError(f"the reference {path} imports {bad}")
