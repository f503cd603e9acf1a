"""Shared plumbing for the invariant checkers: parsed sources, comment
maps, the waiver grammar, and the finding record.

A copy of the JAX package's ``analysis/common.py``; only the lazy rule
changes (``kernelck`` in place of ``jaxck``).  Stdlib only (``ast`` +
``tokenize``) — importing anything heavier here would break the package's
own closed-layer rule (manifest.LAYERS ``analysis``) and the "no torch"
promise of the default lane.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import sys
import tokenize
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

#: The default fast lane: stdlib-``ast`` only, never imports torch, <5 s.
RULES = ("layerck", "clockck", "syncck", "lockck", "deadck")

#: Rules that lazily import heavy dependencies and therefore only run
#: when explicitly selected (``--rule kernelck``, which imports torch for
#: its dtype pass): the default lane's no-torch / <5 s contract stays
#: intact (pinned by tests/test_torch_analysis.py).
LAZY_RULES = ("kernelck",)

ALL_RULES = RULES + LAZY_RULES

#: The waiver grammar (README "Static analysis"): a trailing comment
#: ``# <rule>: allow(<reason>)`` on the flagged line — or on the
#: enclosing ``def`` line, which waives the whole function for that rule.
#: The reason is REQUIRED: an empty ``allow()`` is itself a violation, so
#: every committed waiver carries its why.
WAIVER_RE = re.compile(
    r"#\s*(layerck|clockck|syncck|lockck|deadck|kernelck):\s*allow\(([^)]*)\)"
)

#: lockck's declaration grammar: ``# lockck: guard(<lock_attr>)`` on the
#: attribute's initialisation line declares that every other write to the
#: attribute must hold ``<base>.<lock_attr>``.
GUARD_RE = re.compile(r"#\s*lockck:\s*guard\((\w+)\)")

#: deadck's lock-identity grammar: ``# lockck: name(<tier>.<name>)`` on a
#: lock's creation line binds the lock object to its manifest identity
#: (``manifest.LOCK_RANKS``).  The same string is the literal argument of
#: the ``obs.lockdep.named_*`` factory on that line — deadck checks the
#: two agree, so the static graph and the runtime witness can never name
#: the same lock differently.
NAME_RE = re.compile(r"#\s*lockck:\s*name\(([\w.]+)\)")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    rule: str
    path: str  # scan-root-relative, posix separators
    line: int
    message: str
    waived: bool = False
    reason: str = ""  # the waiver reason, when waived

    def to_dict(self) -> dict:
        d = {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
        }
        if self.waived:
            d["waived"] = True
            d["reason"] = self.reason
        return d

    def render(self) -> str:
        tag = " [waived: %s]" % self.reason if self.waived else ""
        return f"{self.rule}: {self.path}:{self.line}: {self.message}{tag}"


class SourceModule:
    """One parsed source file + its comment map and waiver index."""

    def __init__(self, abspath: Path, rel: str, modname: Optional[str]):
        self.abspath = abspath
        self.rel = rel  # posix path relative to the scan root
        self.modname = modname  # package-relative dotted name, or None
        self.text = abspath.read_text(encoding="utf-8")
        self.tree = ast.parse(self.text, filename=str(abspath))
        #: (rule, comment line) waiver sites a checker actually consulted
        #: — the complement (see :func:`stale_waivers`) is a waiver whose
        #: rule no longer fires there, itself worth reporting before the
        #: committed waiver set rots.
        self.used_waiver_sites: set = set()
        self.comments: Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(
                io.StringIO(self.text).readline
            ):
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string
        except tokenize.TokenError:  # pragma: no cover - ast already parsed
            pass

    def _standalone_comment(self, line: int) -> bool:
        idx = line - 1
        if idx < 0:
            return False
        lines = self.text.splitlines()
        return idx < len(lines) and lines[idx].lstrip().startswith("#")

    def waiver(self, rule: str, line: int) -> Optional[str]:
        """The waiver reason for ``rule`` on ``line`` (None = no waiver,
        "" = waiver present but reason missing).  A waiver may sit as a
        trailing comment on the line itself, or as a STANDALONE comment
        line immediately above it — the readable form when the flagged
        statement is already long."""
        for at in (line, line - 1):
            comment = self.comments.get(at)
            if not comment or (at != line and not self._standalone_comment(at)):
                continue
            for m in WAIVER_RE.finditer(comment):
                if m.group(1) == rule:
                    self.used_waiver_sites.add((rule, at))
                    return m.group(2).strip()
        return None

    def waiver_sites(self) -> List[Tuple[str, int, str]]:
        """Every waiver comment in the file: (rule, line, reason)."""
        out = []
        for line in sorted(self.comments):
            for m in WAIVER_RE.finditer(self.comments[line]):
                out.append((m.group(1), line, m.group(2).strip()))
        return out


def finding(
    mod: SourceModule,
    rule: str,
    node: ast.AST,
    message: str,
    def_lines: Tuple[int, ...] = (),
) -> Finding:
    """Build a Finding, resolving the waiver grammar: a waiver on the
    flagged line or on any enclosing ``def`` line downgrades the finding
    to ``waived`` (an empty reason keeps it a violation, reworded)."""
    line = getattr(node, "lineno", 0)
    for at in (line,) + tuple(def_lines):
        reason = mod.waiver(rule, at)
        if reason is None:
            continue
        if not reason:
            return Finding(
                rule, mod.rel, line,
                message + " — waiver present but allow() has no reason",
            )
        return Finding(rule, mod.rel, line, message, waived=True, reason=reason)
    return Finding(rule, mod.rel, line, message)


class QualnameVisitor(ast.NodeVisitor):
    """NodeVisitor that tracks the lexical class/function qualname stack
    and the line numbers of enclosing ``def`` statements (for
    function-scope waivers)."""

    def __init__(self) -> None:
        self.stack: List[str] = []
        self.def_lines: List[int] = []

    @property
    def qualname(self) -> str:
        return ".".join(self.stack)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def _visit_func(self, node) -> None:
        self.stack.append(node.name)
        self.def_lines.append(node.lineno)
        self.generic_visit(node)
        self.def_lines.pop()
        self.stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_func(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_func(node)


def stale_waivers(
    mods: List["SourceModule"], rules: Tuple[str, ...]
) -> List[Tuple[str, int, str, str]]:
    """Waiver comments whose rule (among the rules that RAN) no longer
    fires on that line: (path, line, rule, reason), sorted.

    Must be called after the checkers, which populate
    ``used_waiver_sites`` as they resolve findings.  Scoped to the
    selected rules — a kernelck waiver is not stale just because the fast
    lane didn't run kernelck."""
    out = []
    for mod in mods:
        for rule, line, reason in mod.waiver_sites():
            if rule not in rules:
                continue
            if (rule, line) not in mod.used_waiver_sites:
                out.append((mod.rel, line, rule, reason))
    return sorted(out)


def expr_root(node: ast.AST) -> Optional[str]:
    """The base Name an expression hangs off: ``info["steps"]`` -> info,
    ``st.nodes[i]`` -> st, ``self._status["solved"]`` -> ``self._status``
    (one attribute level kept for self-attrs, so class-wide host attrs
    resolve).  None for anything not rooted in a Name."""
    n = node
    while isinstance(n, (ast.Subscript, ast.Call)):
        n = n.value if isinstance(n, ast.Subscript) else n.func
    if isinstance(n, ast.Attribute):
        base = n.value
        if isinstance(base, ast.Name) and base.id == "self":
            return f"self.{n.attr}"
        while isinstance(base, (ast.Attribute, ast.Subscript, ast.Call)):
            if isinstance(base, ast.Attribute):
                base = base.value
            elif isinstance(base, ast.Subscript):
                base = base.value
            else:
                base = base.func
        return base.id if isinstance(base, ast.Name) else None
    if isinstance(n, ast.Name):
        return n.id
    return None


def call_name(node: ast.Call) -> str:
    """Dotted best-effort name of a call target (``np.asarray``,
    ``engine_mod.host_fetch``, ``host_fetch``)."""
    try:
        return ast.unparse(node.func)
    except Exception:  # pragma: no cover - unparse is total on parsed asts
        return ""


def stdlib_top(name: str) -> bool:
    top = name.split(".", 1)[0]
    return top == "__future__" or top in sys.stdlib_module_names


def iter_sources(
    root: Path, package_root: Optional[Path]
) -> Iterator[SourceModule]:
    """Yield parsed modules under ``root`` in sorted order (determinism:
    the walk order IS the report order before the final sort)."""
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        modname = None
        if package_root is not None:
            try:
                parts = path.relative_to(package_root).with_suffix("").parts
                modname = ".".join(
                    p for p in parts if p != "__init__"
                ) or "__init__"
            except ValueError:
                modname = None
        yield SourceModule(path, rel, modname)
