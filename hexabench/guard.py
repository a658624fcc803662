"""The import guard: the benchmark drives the port (``repro_torch``) and
nothing of the JAX package or of JAX; the references load nothing of the
program either. Names are compared by their whole top-level part (the
text before the first dot), so ``repro_torch`` is not ``repro``.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
#: What a reference may not load, besides FORBIDDEN.
PROGRAM = "repro_torch"
HERE = Path(__file__).resolve().parent


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({top(m) for m in names} & FORBIDDEN)


def _imports(path: Path) -> set:
    """Every module a file imports, by its full dotted name."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
            out.update(f"{node.module}.{a.name}" for a in node.names)
    return out


def _module_file(name: str):
    """The file of a ``hexabench`` module (or package), or None."""
    parts = name.split(".")[1:]
    base = HERE.joinpath(*parts)
    for cand in (base.with_suffix(".py"), base / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def reference_violations() -> list:
    """(file, module) for every import, followed through ``hexabench``'s
    own modules from ``reference/``, of the program, the JAX package or
    JAX."""
    seen, bad = set(), []
    todo = sorted((HERE / "reference").glob("*.py"))
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for mod in sorted(_imports(path)):
            if top(mod) in FORBIDDEN or top(mod) == PROGRAM:
                bad.append((str(path.relative_to(HERE.parent)), mod))
            elif top(mod) == "hexabench":
                f = _module_file(mod)
                if f is not None:
                    todo.append(f)
    return bad


def check(stage: str) -> None:
    """Raise ``SystemExit`` naming what was found, at ``stage``."""
    found = loaded_forbidden()
    bad = reference_violations()
    if found or bad:
        msg = [f"[guard] {stage}:"]
        if found:
            msg.append(f"loaded modules with top-level names {found}")
        if bad:
            msg.append(f"reference imports {bad}")
        print(" ".join(msg), file=sys.stderr)
        raise SystemExit(3)
