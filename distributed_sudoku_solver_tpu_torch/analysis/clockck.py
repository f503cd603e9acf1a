"""clockck: bare wall-clock CALLS banned in the clock-scoped layers.

A copy of the JAX package's ``analysis/clockck.py`` with its imports pointed
at this package; it reads the port's ``analysis/manifest.py``.

The simnet runtime guard (tests/conftest.py) catches a stray
``time.sleep`` only on paths a simnet test happens to execute; this rule
is the same promise made static and whole-tree: inside
``manifest.CLOCK_SCOPED_DIRS`` every *call* to a banned clock
(``manifest.CLOCK_BANNED_CALLS``) is a violation unless it sits inside a
declared seam (``manifest.CLOCK_SEAMS`` qualname prefixes — e.g.
``wire.SystemClock``) or carries a ``# clockck: allow(<reason>)`` waiver.

*References* are allowed by design: ``clock: Callable[[], float] =
time.monotonic`` parameter/field defaults are exactly the injection seam
this rule exists to force timing through (the default binds the real
function at import time, which is also what keeps engines immune to the
runtime guard's monkeypatch).  Import-aliases (``import time as _time``),
from-imports (``from time import monotonic as m``) and module-level
captures (``_monotonic = _time.monotonic``) are tracked, so renaming a
banned clock does not launder the call.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from distributed_sudoku_solver_tpu_torch.analysis.common import (
    Finding,
    QualnameVisitor,
    SourceModule,
    finding,
)


def _collect_aliases(
    tree: ast.Module, banned: Tuple[Tuple[str, str], ...]
) -> Tuple[Dict[str, str], Dict[str, str]]:
    """-> (module alias -> module name, direct callable name -> dotted)."""
    banned_mods = {m for m, _ in banned}
    banned_by_mod: Dict[str, set] = {}
    for m, a in banned:
        banned_by_mod.setdefault(m, set()).add(a)
    mod_alias: Dict[str, str] = {}
    direct: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for al in node.names:
                if al.name in banned_mods:
                    mod_alias[al.asname or al.name] = al.name
        elif isinstance(node, ast.ImportFrom) and node.module in banned_mods:
            for al in node.names:
                if al.name in banned_by_mod[node.module]:
                    direct[al.asname or al.name] = f"{node.module}.{al.name}"
                elif al.name == node.module:
                    # ``from datetime import datetime``: the class carries
                    # the same banned constructors (now/utcnow).
                    mod_alias[al.asname or al.name] = node.module
    # Module-level captures of a banned callable: X = _time.monotonic
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Attribute)
            and isinstance(node.value.value, ast.Name)
        ):
            mod = mod_alias.get(node.value.value.id)
            if mod and node.value.attr in banned_by_mod.get(mod, ()):
                direct[node.targets[0].id] = f"{mod}.{node.value.attr}"
    return mod_alias, direct


class _ClockVisitor(QualnameVisitor):
    def __init__(self, mod: SourceModule, seams, mod_alias, direct):
        super().__init__()
        self.mod = mod
        self.seams = seams
        self.mod_alias = mod_alias
        self.direct = direct
        self.banned_by_mod: Dict[str, set] = {}
        self.findings: List[Finding] = []

    def _in_seam(self) -> bool:
        q = self.qualname
        return any(q == s or q.startswith(s + ".") for s in self.seams)

    def visit_Call(self, node: ast.Call) -> None:
        dotted = None
        f = node.func
        if isinstance(f, ast.Name) and f.id in self.direct:
            dotted = self.direct[f.id]
        elif isinstance(f, ast.Attribute):
            # Walk the whole attribute chain so two-level spellings
            # (``datetime.datetime.now()`` under ``import datetime``)
            # resolve too — only `f.value is Name` used to be handled,
            # which silently laundered the most common datetime form.
            parts = [f.attr]
            base = f.value
            while isinstance(base, ast.Attribute):
                parts.append(base.attr)
                base = base.value
            if isinstance(base, ast.Name):
                mod = self.mod_alias.get(base.id)
                if mod is not None and parts[0] in self.banned_by_mod.get(
                    mod, ()
                ):
                    dotted = f"{mod}.{parts[0]}"
        if dotted is not None and not self._in_seam():
            self.findings.append(finding(
                self.mod, "clockck", node,
                f"bare clock call {dotted}() — route through an injected "
                "clock seam (a `clock=...` default referencing it is the "
                "seam; calls are not)",
                def_lines=tuple(self.def_lines),
            ))
        self.generic_visit(node)


def check_module(
    mod: SourceModule,
    scoped_dirs: Tuple[str, ...],
    banned: Tuple[Tuple[str, str], ...],
    seams: Dict[str, Tuple[str, ...]],
    scope_all: bool = False,
) -> List[Finding]:
    if not scope_all and not any(
        mod.rel.startswith(d + "/") or mod.rel.startswith(d + ".")
        for d in scoped_dirs
    ):
        return []
    mod_alias, direct = _collect_aliases(mod.tree, banned)
    if not mod_alias and not direct:
        return []
    v = _ClockVisitor(mod, seams.get(mod.rel, ()), mod_alias, direct)
    for m, a in banned:
        v.banned_by_mod.setdefault(m, set()).add(a)
    v.visit(mod.tree)
    return v.findings
