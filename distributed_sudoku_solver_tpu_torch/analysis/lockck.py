"""lockck: declared lock coverage for cross-thread counters.

A copy of the JAX package's ``analysis/lockck.py`` with its imports pointed
at this package; it reads the port's ``analysis/manifest.py``.

The bug family it hunts: a counter that submit/handler threads race
being bumped outside its lock (``breaker_deflected``,
``fault_bulk_retries``, the agg counters — all annotated).  The
convention this rule enforces:

* the attribute's initialisation line declares the contract:
  ``self.rejected = 0  # lockck: guard(_lock)``;
* every other write to that attribute (plain/augmented assign, and
  mutation through a subscript like ``self.duplicates_dropped[m] = ...``)
  must sit lexically inside ``with <base>.<lock>:`` for the SAME base
  expression (``self._lock`` for ``self.rejected``; ``engine._lock`` for
  ``engine.fault_bulk_retries`` — a cross-module write);
* OR inside a method whose name ends in ``_locked`` — the repo's existing
  "caller holds the lock" convention (``_count_duplicate_locked``,
  ``_reflect_ok_locked``);
* OR carry a ``# lockck: allow(<reason>)`` waiver.

Scoping: ``self.<attr>`` writes are checked against the declarations of
the LEXICALLY ENCLOSING class only — an unrelated class with its own
(unguarded) ``admitted`` attribute is not constrained by ResidentFlight's
declaration.  Writes through any other base (``engine.fault_bulk_retries``)
cannot be class-resolved statically and check against the global registry
of guarded attribute names: satisfied by holding ANY declared lock for
that name on the same base expression.

Lexical, not a race detector: a helper called under the lock but not
named ``*_locked`` is flagged on purpose — the suffix IS the documented
contract the next reader relies on.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from distributed_sudoku_solver_tpu_torch.analysis.common import (
    GUARD_RE,
    Finding,
    QualnameVisitor,
    SourceModule,
    finding,
)


@dataclasses.dataclass(frozen=True)
class GuardDecl:
    attr: str
    lock: str
    path: str
    line: int
    qualclass: str  # lexical class qualname of the declaration ("" = module)


def _write_target(node: ast.AST) -> Optional[ast.Attribute]:
    """The Attribute actually written by an assignment target —
    ``self.x`` directly, or ``self.d[k]`` (mutating the dict the
    attribute holds counts as writing the guarded state)."""
    if isinstance(node, ast.Attribute):
        return node
    if isinstance(node, ast.Subscript) and isinstance(
        node.value, ast.Attribute
    ):
        return node.value
    return None


class _ClassStackVisitor(QualnameVisitor):
    """QualnameVisitor that additionally tracks the class-only stack, so
    a write inside ``ResidentFlight.admit`` resolves to class
    ``ResidentFlight`` even though the full stack mixes functions in."""

    def __init__(self) -> None:
        super().__init__()
        self.class_stack: List[str] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.class_stack.append(node.name)
        super().visit_ClassDef(node)
        self.class_stack.pop()

    @property
    def qualclass(self) -> str:
        return ".".join(self.class_stack)


def collect_guards(mod: SourceModule) -> List[GuardDecl]:
    out: List[GuardDecl] = []

    class V(_ClassStackVisitor):
        def _decl(self, target: ast.AST, line: int) -> None:
            comment = mod.comments.get(line, "")
            m = GUARD_RE.search(comment)
            if m is None:
                return
            attr = _write_target(target)
            if attr is None:
                return
            out.append(GuardDecl(
                attr=attr.attr,
                lock=m.group(1),
                path=mod.rel,
                line=line,
                qualclass=self.qualclass,
            ))

        def visit_Assign(self, node: ast.Assign) -> None:
            for t in node.targets:
                self._decl(t, node.lineno)
            self.generic_visit(node)

        def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
            self._decl(node.target, node.lineno)
            self.generic_visit(node)

    V().visit(mod.tree)
    return out


class _LockVisitor(_ClassStackVisitor):
    def __init__(
        self,
        mod: SourceModule,
        self_guards: Dict[Tuple[str, str, str], str],
        any_guards: Dict[str, Set[str]],
        decl_lines,
    ):
        super().__init__()
        self.mod = mod
        # (path, qualclass, attr) -> lock: self-writes resolve against
        # the lexically enclosing class's own declarations.
        self.self_guards = self_guards
        # attr -> {lock, ...}: the cross-base fallback registry.
        self.any_guards = any_guards
        self.decl_lines = decl_lines
        self.with_ctx: List[str] = []  # unparsed context exprs in scope
        self.findings: List[Finding] = []

    def visit_With(self, node: ast.With) -> None:
        ctxs = []
        for item in node.items:
            try:
                ctxs.append(ast.unparse(item.context_expr))
            except Exception:  # pragma: no cover
                pass
        self.with_ctx.extend(ctxs)
        self.generic_visit(node)
        del self.with_ctx[len(self.with_ctx) - len(ctxs) :]

    def _check_write(self, target: ast.AST, line: int) -> None:
        attr = _write_target(target)
        if attr is None:
            return
        if (self.mod.rel, line) in self.decl_lines:
            return  # the declaration site itself
        try:
            base = ast.unparse(attr.value)
        except Exception:  # pragma: no cover
            base = "self"
        if base == "self":
            lock = self.self_guards.get(
                (self.mod.rel, self.qualclass, attr.attr)
            )
            locks = {lock} if lock is not None else set()
        else:
            locks = self.any_guards.get(attr.attr, set())
        if not locks:
            return
        if any(f"{base}.{lock}" in self.with_ctx for lock in locks):
            return
        if self.stack and self.stack[-1].endswith("_locked"):
            return
        wanted = " or ".join(
            f"`with {base}.{lock}:`" for lock in sorted(locks)
        )
        self.findings.append(finding(
            self.mod, "lockck", target,
            f"write to guarded attribute '{attr.attr}' outside {wanted} "
            "(declare the helper `*_locked` if the caller holds it, or "
            "waive with reason)",
            def_lines=tuple(self.def_lines),
        ))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._check_write(t, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_write(node.target, node.lineno)
        self.generic_visit(node)


def check_modules(mods: List[SourceModule]) -> List[Finding]:
    """Two passes over the whole scan set: collect guard declarations,
    then verify every write.  Self-writes check the declaring class's
    own guards; base-named writes (http's ``engine.fault_bulk_retries``
    bump) check the global name registry."""
    decls: List[GuardDecl] = []
    for mod in mods:
        decls.extend(collect_guards(mod))
    self_guards: Dict[Tuple[str, str, str], str] = {}
    any_guards: Dict[str, Set[str]] = {}
    findings: List[Finding] = []
    for d in decls:
        key = (d.path, d.qualclass, d.attr)
        prev = self_guards.get(key)
        if prev is not None and prev != d.lock:
            findings.append(Finding(
                "lockck", d.path, d.line,
                f"attribute '{d.attr}' declared twice in "
                f"'{d.qualclass or '<module>'}' with conflicting guards "
                f"('{prev}' vs '{d.lock}')",
            ))
        self_guards[key] = d.lock
        any_guards.setdefault(d.attr, set()).add(d.lock)
    decl_lines = {(d.path, d.line) for d in decls}
    for mod in mods:
        v = _LockVisitor(mod, self_guards, any_guards, decl_lines)
        v.visit(mod.tree)
        findings.extend(v.findings)
    return findings
