"""deadck: prove the thread plane — the static lock-order graph.

A copy of the JAX package's ``analysis/deadck.py`` with its imports pointed
at this package; it reads the port's ``analysis/manifest.py``.

The suite proves imports (layerck), clocks (clockck), host syncs
(syncck), declared lock guards (lockck) and the kernel layer (kernelck);
this rule proves the substrate they all run on.  Three passes over the
whole scan set, all driven by ``analysis/manifest.py`` as pure data:

1. **Lock identity.**  Every lock is created through the
   ``obs.lockdep.named_*`` factories with a ``# lockck: name(<tier>.<name>)``
   annotation on the creation line.  deadck checks: a raw
   ``threading.Lock/RLock/Condition`` creation is a finding (unnamed
   lock); the annotation and the factory's literal argument must agree;
   the name must exist in ``manifest.LOCK_RANKS``.

2. **Lock-order graph vs the declared hierarchy.**  A conservative
   call-graph walk records every acquisition reached — lexically or
   through resolvable calls (``self.m()``, module functions, the
   ``manifest.DEADCK_BASE_CLASSES`` receiver hints, and globally
   near-unique method names), including cross-module edges (an http
   handler taking ``engine._lock``) and the ``*_locked`` caller-holds-it
   convention (a ``*_locked`` method is analyzed as holding its class's
   named locks).  Every edge (held -> acquired) must be rank-upward in
   ``manifest.LOCK_RANKS`` or declared in ``manifest.LOCK_EDGE_DECLARED``;
   any cycle in the predicted graph (declared edges included) is a
   finding.  The predicted edge set is exported in the ``--json`` report
   — tier-1 cross-checks that the runtime witness's observed graph
   (``obs/lockdep.py``) is a SUBSET of it: an observed edge deadck did
   not predict is a deadck bug (a golden's discipline applied to
   concurrency).

3. **Guard inference** — the pass that closes lockck's annotate-only
   blind spot.  ``manifest.DEADCK_THREAD_ROOTS`` declares the repo's
   thread roots (the device loop, HTTP handler methods, heartbeat/
   progress loops, fan-out/racer/timer bodies); deadck walks the call
   graph from each root and reports every ``self.<attr>`` write (outside
   ``__init__``) reachable from >= 2 distinct roots whose class declares
   no lockck guard for it.  lockck's declared set thereby becomes
   *proven complete*: a cross-thread write either carries a guard
   declaration, or a reasoned waiver, or fails the gate.

Conservative by design: call resolution over-approximates (an edge that
cannot happen is harmless — the hierarchy only rejects rank-violating
shapes), and what it cannot see statically (injected callables like
``metrics_fn``) is exactly what ``LOCK_EDGE_DECLARED`` declares and the
runtime witness observes.

Stdlib-``ast`` only; stays in the <5 s no-torch fast lane.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from distributed_sudoku_solver_tpu_torch.analysis.common import (
    NAME_RE,
    Finding,
    QualnameVisitor,
    SourceModule,
    finding,
)
from distributed_sudoku_solver_tpu_torch.analysis.lockck import (
    _write_target,
    collect_guards,
)

#: Raw primitives whose direct use is an unnamed-lock finding.
_RAW_PRIMS = ("threading.Lock", "threading.RLock", "threading.Condition")
#: The naming factories (matched on the trailing attribute so both
#: ``lockdep.named_lock`` and a bare ``named_lock`` import resolve).
_FACTORIES = ("named_lock", "named_rlock", "named_condition")
#: The one module allowed to touch raw primitives: the factories' own
#: internals and the witness's bookkeeping lock live there.
_EXEMPT_PATHS = ("obs/lockdep.py",)
#: Bare-name call resolution falls back to the global function-name index
#: only when the name is this unambiguous; anything noisier is treated as
#: unresolvable (the runtime witness is the backstop).
_NAME_FANOUT_CAP = 8


@dataclasses.dataclass(frozen=True, order=True)
class LockDecl:
    name: str
    path: str
    line: int
    qualclass: str  # declaring class ("" = module level)
    attr: str  # attribute / variable the lock is bound to
    kind: str = "lock"  # factory kind: lock | rlock | condition


class _Collector(QualnameVisitor):
    """Pass 1 over one module: lock creations, function registry, and the
    per-function acquisition/call/write facts pass 2 consumes."""

    def __init__(self, mod: SourceModule):
        super().__init__()
        self.mod = mod
        self.class_stack: List[str] = []
        self.locks: List[LockDecl] = []
        self.findings: List[Finding] = []
        # fkey = (path, dotted qualname)
        self.functions: Dict[Tuple[str, str], dict] = {}
        self._fstack: List[dict] = []
        self._with_stacks: List[List[str]] = []  # one per function frame
        self._cur_assign: Optional[Tuple[str, str, int]] = None
        # Lock resolution registries filled by _register_lock; merged
        # tree-wide by check_modules.
        self.class_locks: Dict[Tuple[str, str, str], str] = {}
        self.module_locks: Dict[str, str] = {}

    # -- plumbing ------------------------------------------------------------
    @property
    def qualclass(self) -> str:
        return ".".join(self.class_stack)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.class_stack.append(node.name)
        super().visit_ClassDef(node)
        self.class_stack.pop()

    def _visit_func(self, node) -> None:
        self.stack.append(node.name)
        self.def_lines.append(node.lineno)
        qn = ".".join(s for s in self.stack)
        fn = {
            "qualclass": self.qualclass,
            "name": node.name,
            "line": node.lineno,
            "def_lines": tuple(self.def_lines),
            "acquires": [],  # (lockname, heldset, line)
            "calls": [],  # (callname, heldset, line)
            "writes": [],  # (attr, line, heldset, def_lines)
            "order": len(self.functions),
        }
        self.functions[(self.mod.rel, qn)] = fn
        self._fstack.append(fn)
        self._with_stacks.append([])
        self.generic_visit(node)
        self._with_stacks.pop()
        self._fstack.pop()
        self.def_lines.pop()
        self.stack.pop()

    def _held(self) -> Tuple[str, ...]:
        if not self._with_stacks:
            return ()
        return tuple(self._with_stacks[-1])

    # -- lock creation -------------------------------------------------------
    def visit_Assign(self, node: ast.Assign) -> None:
        target = node.targets[0] if len(node.targets) == 1 else None
        self._enter_assign(target, node.lineno)
        for t in node.targets:
            self._record_write(t, node.lineno)
        self.generic_visit(node)
        self._cur_assign = None

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._enter_assign(node.target, node.lineno)
        self._record_write(node.target, node.lineno)
        self.generic_visit(node)
        self._cur_assign = None

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_write(node.target, node.lineno)
        self.generic_visit(node)

    def _enter_assign(self, target, line: int) -> None:
        self._cur_assign = None
        if target is None:
            return
        if isinstance(target, ast.Attribute) and isinstance(
            target.value, ast.Name
        ) and target.value.id == "self":
            self._cur_assign = ("self", target.attr, line)
        elif isinstance(target, ast.Name):
            if self.class_stack and not self._fstack:
                # Class-body field (the _Control dataclass lock): an
                # instance attribute, resolved the same way self.X is.
                self._cur_assign = ("self", target.id, line)
            else:
                self._cur_assign = ("", target.id, line)

    def _record_write(self, target, line: int) -> None:
        if not self._fstack:
            return
        attr = _write_target(target)
        if attr is None:
            return
        if not (
            isinstance(attr.value, ast.Name) and attr.value.id == "self"
        ):
            return
        self._fstack[-1]["writes"].append(
            (attr.attr, line, self._held(), self._fstack[-1]["def_lines"])
        )

    def visit_Call(self, node: ast.Call) -> None:
        try:
            func = ast.unparse(node.func)
        except Exception:  # pragma: no cover
            func = ""
        if func in _RAW_PRIMS and self.mod.rel not in _EXEMPT_PATHS:
            self.findings.append(finding(
                self.mod, "deadck", node,
                f"unnamed lock: `{func}()` — create it through "
                "obs.lockdep.named_lock/named_rlock/named_condition with a "
                "`# lockck: name(<tier>.<name>)` annotation so the static "
                "graph and the runtime witness both know it",
                def_lines=self._fstack[-1]["def_lines"] if self._fstack else (),
            ))
        elif func.rsplit(".", 1)[-1] in _FACTORIES:
            if self.mod.rel not in _EXEMPT_PATHS:
                self._register_lock(node)
        elif func.rsplit(".", 1)[-1] == "field" and self.mod.rel not in _EXEMPT_PATHS:
            for kw in node.keywords:
                if kw.arg == "default_factory":
                    try:
                        v = ast.unparse(kw.value)
                    except Exception:  # pragma: no cover
                        v = ""
                    if v in _RAW_PRIMS:
                        self.findings.append(finding(
                            self.mod, "deadck", node,
                            f"unnamed lock: `default_factory={v}` — use a "
                            "lambda over an obs.lockdep factory with the "
                            "name annotation",
                        ))
        # record the call for the graph (skip the factory itself)
        if self._fstack and func.rsplit(".", 1)[-1] not in _FACTORIES:
            self._fstack[-1]["calls"].append(
                (func, self._held(), node.lineno)
            )
            if func.rsplit(".", 1)[-1] == "acquire":
                # Direct .acquire() — treated as an acquisition of the
                # receiver if it resolves to a named lock (pass 2).
                recv = func[: -len(".acquire")]
                self._fstack[-1]["acquires"].append(
                    ("?expr:" + recv, self._held(), node.lineno)
                )
        self.generic_visit(node)

    def _register_lock(self, node: ast.Call) -> None:
        try:
            factory = ast.unparse(node.func).rsplit(".", 1)[-1]
        except Exception:  # pragma: no cover
            factory = "named_lock"
        kind = {"named_rlock": "rlock", "named_condition": "condition"}.get(
            factory, "lock"
        )
        arg = None
        if node.args and isinstance(node.args[0], ast.Constant) and isinstance(
            node.args[0].value, str
        ):
            arg = node.args[0].value
        ann = None
        if self._cur_assign is not None:
            m = NAME_RE.search(self.mod.comments.get(self._cur_assign[2], ""))
            if m is not None:
                ann = m.group(1)
        if arg is None:
            self.findings.append(finding(
                self.mod, "deadck", node,
                "named-lock factory needs a literal name argument",
            ))
            return
        if self._cur_assign is None:
            self.findings.append(finding(
                self.mod, "deadck", node,
                f"named lock '{arg}' created outside a simple assignment — "
                "deadck cannot bind it to an attribute",
            ))
            return
        base, attr, line = self._cur_assign
        if ann is None:
            self.findings.append(finding(
                self.mod, "deadck", node,
                f"named lock '{arg}' is missing its creation-line "
                "`# lockck: name(...)` annotation",
            ))
        elif ann != arg:
            self.findings.append(finding(
                self.mod, "deadck", node,
                f"lock name annotation '{ann}' disagrees with the factory "
                f"argument '{arg}'",
            ))
        self.locks.append(LockDecl(
            name=arg, path=self.mod.rel, line=line,
            qualclass=self.qualclass, attr=attr, kind=kind,
        ))
        if base == "self":
            self.class_locks[(self.mod.rel, self.qualclass, attr)] = arg
        else:
            self.module_locks[attr] = arg

    # -- acquisitions --------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        if self._fstack:
            for item in node.items:
                try:
                    ctx = ast.unparse(item.context_expr)
                except Exception:  # pragma: no cover
                    continue
                self._fstack[-1]["acquires"].append(
                    ("?expr:" + ctx, self._held(), node.lineno)
                )
                # Optimistically track it as held; pass 2 drops the frame
                # if the expression does not resolve to a named lock.
                self._with_stacks[-1].append("?expr:" + ctx)
                pushed += 1
        self.generic_visit(node)
        if pushed:
            del self._with_stacks[-1][-pushed:]

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # A lambda body runs later (thread targets, default factories):
        # never under the lexical with-stack.  Not walked for edges — a
        # lambda substantial enough to take locks belongs in a def — but
        # a factory call inside one (the dataclass-field idiom) still
        # registers its lock.
        for sub in ast.walk(node.body):
            if isinstance(sub, ast.Call):
                try:
                    func = ast.unparse(sub.func)
                except Exception:  # pragma: no cover
                    continue
                if func.rsplit(".", 1)[-1] in _FACTORIES:
                    self._register_lock(sub)
        return


def _class_only(qualname: str, functions_meta: dict) -> str:
    return functions_meta["qualclass"]


class _Resolver:
    """Tree-wide name resolution shared by the edge and reachability
    passes."""

    def __init__(self, collectors: List[_Collector], base_classes: dict):
        self.base_classes = dict(base_classes)
        self.class_locks: Dict[Tuple[str, str, str], str] = {}
        self.module_locks: Dict[Tuple[str, str], str] = {}
        self.attr_locks: Dict[str, Set[str]] = {}
        self.methods: Dict[Tuple[str, str], Dict[str, Tuple[str, str]]] = {}
        self.modfuncs: Dict[str, Dict[str, Tuple[str, str]]] = {}
        self.name_index: Dict[str, List[Tuple[str, str]]] = {}
        self.functions: Dict[Tuple[str, str], dict] = {}
        for c in collectors:
            self.class_locks.update(c.class_locks)
            for attr, name in c.module_locks.items():
                self.module_locks[(c.mod.rel, attr)] = name
            for (_p, _c, attr), name in c.class_locks.items():
                self.attr_locks.setdefault(attr, set()).add(name)
            for fkey, fn in c.functions.items():
                self.functions[fkey] = fn
                path, qn = fkey
                cls = fn["qualclass"]
                fname = fn["name"]
                if cls:
                    self.methods.setdefault((path, cls), {})[fname] = fkey
                elif "." not in qn:
                    self.modfuncs.setdefault(path, {})[fname] = fkey
                self.name_index.setdefault(fname, []).append(fkey)

    # -- locks ---------------------------------------------------------------
    def resolve_lock(self, expr: str, path: str, qualclass: str) -> Optional[str]:
        parts = expr.split(".")
        if len(parts) == 1:
            return self.module_locks.get((path, expr))
        attr = parts[-1]
        recv = ".".join(parts[:-1])
        if recv == "self" and qualclass:
            # Walk outward through nested classes.
            cls = qualclass
            while True:
                hit = self.class_locks.get((path, cls, attr))
                if hit is not None:
                    return hit
                if "." not in cls:
                    break
                cls = cls.rsplit(".", 1)[0]
        hint = self.base_classes.get(recv)
        if hint is not None:
            return self.class_locks.get((hint[0], hint[1], attr))
        if recv != "self":
            # Unhinted cross-base: unique attribute name tree-wide only.
            names = self.attr_locks.get(attr, set())
            if len(names) == 1:
                return next(iter(names))
        return None

    # -- calls ---------------------------------------------------------------
    def resolve_call(
        self, callname: str, path: str, qualclass: str, strict: bool = False
    ) -> List[Tuple[str, str]]:
        parts = callname.split(".")
        meth = parts[-1]
        if not meth.isidentifier():
            return []
        if len(parts) == 1:
            hit = self.modfuncs.get(path, {}).get(meth)
            if hit is not None:
                return [hit]
        else:
            recv = ".".join(parts[:-1])
            if recv == "self" and qualclass:
                cls = qualclass
                while True:
                    hit = self.methods.get((path, cls), {}).get(meth)
                    if hit is not None:
                        return [hit]
                    if "." not in cls:
                        break
                    cls = cls.rsplit(".", 1)[0]
            hint = self.base_classes.get(recv)
            if hint is not None:
                hit = self.methods.get(hint, {}).get(meth)
                return [hit] if hit is not None else []
        if "(" in callname:
            # A constructed receiver (``threading.Thread(...).start()``)
            # is never one of our instances — the name-index fallback
            # would bind it to unrelated classes' methods.
            return []
        cands = self.name_index.get(meth, [])
        cap = 1 if strict else _NAME_FANOUT_CAP
        if 0 < len(cands) <= cap:
            return list(cands)
        return []


def _function_facts(resolver: _Resolver, ranks: dict) -> Dict[Tuple[str, str], dict]:
    """Resolve the raw per-function facts: acquisition expressions to lock
    names, ``*_locked`` implicit holds, held-set frames that turned out
    not to be locks."""
    facts = {}
    for fkey, fn in resolver.functions.items():
        path, _qn = fkey
        cls = fn["qualclass"]

        def name_of(token: str) -> Optional[str]:
            if not token.startswith("?expr:"):
                return token
            return resolver.resolve_lock(token[6:], path, cls)

        implicit: Tuple[str, ...] = ()
        if fn["name"].endswith("_locked") and cls:
            implicit = tuple(sorted(
                name
                for (p, c, _a), name in resolver.class_locks.items()
                if p == path and c == cls
            ))
        acquires = []
        calls = []
        for token, held, line in fn["acquires"]:
            name = name_of(token)
            if name is None:
                continue
            held_names = tuple(
                h for h in (name_of(t) for t in held) if h is not None
            ) + implicit
            acquires.append((name, held_names, line))
        for callname, held, line in fn["calls"]:
            held_names = tuple(
                h for h in (name_of(t) for t in held) if h is not None
            ) + implicit
            calls.append((callname, held_names, line))
        writes = []
        for attr, line, held, def_lines in fn["writes"]:
            held_names = tuple(
                h for h in (name_of(t) for t in held) if h is not None
            ) + implicit
            writes.append((attr, line, held_names, def_lines))
        facts[fkey] = {
            "acquires": acquires,
            "calls": calls,
            "writes": writes,
            "qualclass": cls,
            "name": fn["name"],
            "def_lines": fn["def_lines"],
            "order": fn["order"],
        }
    return facts


def _may_acquire(
    facts: dict, resolver: _Resolver
) -> Dict[Tuple[str, str], Set[str]]:
    """Fixpoint: the set of lock names each function may (transitively)
    acquire."""
    may: Dict[Tuple[str, str], Set[str]] = {
        fkey: {a for a, _h, _l in fn["acquires"]} for fkey, fn in facts.items()
    }
    callees: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
    strict_callees: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
    for fkey, fn in facts.items():
        path, _ = fkey
        seen = []
        strict_seen = []
        for callname, _held, _line in fn["calls"]:
            for g in resolver.resolve_call(callname, path, fn["qualclass"]):
                if g != fkey:
                    seen.append(g)
            for g in resolver.resolve_call(
                callname, path, fn["qualclass"], strict=True
            ):
                if g != fkey:
                    strict_seen.append(g)
        callees[fkey] = seen
        strict_callees[fkey] = strict_seen
    changed = True
    while changed:
        changed = False
        for fkey in facts:
            cur = may[fkey]
            before = len(cur)
            for g in callees[fkey]:
                cur |= may.get(g, set())
            if len(cur) != before:
                changed = True
    return may, callees, strict_callees


def check_modules(
    mods: List[SourceModule],
    ranks: dict,
    declared: dict,
    base_classes: dict,
    thread_roots: dict,
) -> Tuple[List[Finding], dict]:
    """Run all three deadck passes; returns (findings, summary) where the
    summary carries the predicted graph for ``--json`` and the runtime
    cross-check."""
    collectors = []
    findings: List[Finding] = []
    for mod in mods:
        c = _Collector(mod)
        c.visit(mod.tree)
        collectors.append(c)
        findings.extend(c.findings)
    resolver = _Resolver(collectors, base_classes)
    mod_by_rel = {c.mod.rel: c.mod for c in collectors}

    # Pass 1 tail: every named lock must exist in the manifest ranks.
    locks: List[LockDecl] = []
    for c in collectors:
        locks.extend(c.locks)
    for d in sorted(locks):
        if d.name not in ranks:
            findings.append(Finding(
                "deadck", d.path, d.line,
                f"lock name '{d.name}' is not declared in "
                "manifest.LOCK_RANKS",
            ))

    # Factory kind per name: a DIRECT re-acquisition of a held
    # non-reentrant lock is a guaranteed self-deadlock (the runtime
    # witness raises on it by object identity; this is the static twin,
    # approximated by name — waivable if two distinct instances of one
    # name are legitimately nested).
    lock_kind = {d.name: d.kind for d in locks}
    facts = _function_facts(resolver, ranks)
    may, callees, strict_callees = _may_acquire(facts, resolver)

    # Pass 2: edge emission (deterministic: modules in scan order,
    # functions in definition order, sites in line order).
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}

    def add_edge(a: str, b: str, path: str, line: int) -> None:
        if a == b or (a, b) in edges:
            return
        edges[(a, b)] = (path, line)

    ordered = sorted(
        facts.items(), key=lambda kv: (kv[0][0], kv[1]["order"])
    )
    for (path, _qn), fn in ordered:
        sites = [
            (line, "acq", name, held)
            for name, held, line in fn["acquires"]
        ] + [
            (line, "call", callname, held)
            for callname, held, line in fn["calls"]
            if held
        ]
        for line, kind, what, held in sorted(sites, key=lambda s: (s[0], s[1])):
            if kind == "acq":
                if what in held and lock_kind.get(what) == "lock":
                    mod = mod_by_rel.get(path)
                    if mod is not None:
                        findings.append(finding(
                            mod, "deadck", _FakeNode(line),
                            f"self-acquisition of non-reentrant lock "
                            f"'{what}' while already held — a guaranteed "
                            "self-deadlock if it is the same instance "
                            "(use named_rlock, or waive if these are "
                            "provably distinct instances)",
                            def_lines=fn["def_lines"],
                        ))
                for h in held:
                    add_edge(h, what, path, line)
            else:
                targets: Set[str] = set()
                for g in resolver.resolve_call(what, path, fn["qualclass"]):
                    targets |= may.get(g, set())
                for b in sorted(targets):
                    for h in held:
                        add_edge(h, b, path, line)

    for (a, b), (path, line) in sorted(edges.items()):
        if (a, b) in declared:
            continue
        ra, rb = ranks.get(a), ranks.get(b)
        if ra is None or rb is None:
            continue  # unknown-name finding already reported at creation
        if ra >= rb:
            mod = mod_by_rel.get(path)
            msg = (
                f"lock-order edge '{a}' (rank {ra}) -> '{b}' (rank {rb}) "
                "violates the declared hierarchy and is not in "
                "manifest.LOCK_EDGE_DECLARED"
            )
            if mod is not None:
                findings.append(finding(
                    mod, "deadck", _FakeNode(line), msg,
                ))
            else:  # pragma: no cover - edges only come from scanned mods
                findings.append(Finding("deadck", path, line, msg))

    # Cycles over the predicted graph (declared edges included).
    adj: Dict[str, Set[str]] = {}
    for a, b in list(edges) + list(declared):
        adj.setdefault(a, set()).add(b)
    for cycle in _find_cycles(adj):
        findings.append(Finding(
            "deadck", "analysis/manifest.py", 0,
            "cycle in the predicted lock-order graph: "
            + " -> ".join(cycle + [cycle[0]]),
        ))

    # Pass 3: guard inference from the declared thread roots.
    guards = {}
    for c in collectors:
        for g in collect_guards(c.mod):
            guards[(g.path, g.qualclass, g.attr)] = g.lock
    roots: Dict[Tuple[str, str], str] = {}
    for path, prefixes in thread_roots.items():
        for fkey in facts:
            if fkey[0] != path:
                continue
            qn = fkey[1]
            for prefix in prefixes:
                if qn == prefix or qn.startswith(prefix + "."):
                    roots[fkey] = f"{path}:{prefix}"
    reach: Dict[Tuple[str, str], Set[str]] = {f: set() for f in facts}
    for root_fkey, label in sorted(roots.items()):
        stack = [root_fkey]
        while stack:
            f = stack.pop()
            if label in reach[f]:
                continue
            reach[f].add(label)
            # Reachability resolves calls STRICTLY (unique names only):
            # the edge pass over-approximates on purpose, but inference
            # findings demand burn-down work, so a generic method name
            # ("record", "start") must not connect every root to every
            # class.  The runtime witness covers what this under-sees.
            stack.extend(g for g in strict_callees.get(f, ()) if g in reach)
    flagged: Set[Tuple[str, str, str]] = set()
    for (path, _qn), fn in ordered:
        if path.startswith("analysis/"):
            # The linter lane itself is a single-threaded CLI; its
            # lazy-cache attrs are not part of the serving thread plane.
            continue
        labels = reach.get((path, _qn), set())
        if len(labels) < 2:
            continue
        if fn["name"] in ("__init__", "__new__"):
            continue
        for attr, line, held, def_lines in fn["writes"]:
            key = (path, fn["qualclass"], attr)
            if key in flagged:
                continue
            if key in guards:
                continue
            if held:
                # Lexically under a NAMED lock (or in a *_locked method,
                # whose implicit holds ride the same tuple): the guard
                # exists — lockck's annotation then makes it durable, but
                # the write is not the unguarded-cross-thread hazard this
                # pass hunts.
                continue
            flagged.add(key)
            mod = mod_by_rel[path]
            owner = fn["qualclass"] or "<module>"
            findings.append(finding(
                mod, "deadck", _FakeNode(line),
                f"attribute '{attr}' of {owner} is written from "
                f"{len(labels)} thread roots "
                f"({', '.join(sorted(r.split(':', 1)[1] for r in labels))}) "
                "with no declared lockck guard — annotate the init site "
                "`# lockck: guard(<lock>)` or waive with reason",
                def_lines=def_lines,
            ))

    summary = {
        "locks": [
            {"name": d.name, "path": d.path, "line": d.line, "attr": d.attr}
            for d in sorted(locks)
        ],
        "edges": [
            {"from": a, "to": b, "path": p, "line": ln}
            for (a, b), (p, ln) in sorted(edges.items())
        ],
        "declared": [list(k) for k in sorted(declared)],
        "predicted": sorted(
            {(a, b) for (a, b) in edges} | set(declared)
        ),
    }
    summary["predicted"] = [list(e) for e in summary["predicted"]]
    return findings, summary


class _FakeNode:
    """Minimal lineno carrier for findings attached to derived sites."""

    def __init__(self, lineno: int):
        self.lineno = lineno


def _find_cycles(adj: Dict[str, Set[str]]) -> List[List[str]]:
    """Strongly connected components with >1 node (or a self-loop),
    returned as sorted node lists — deterministic output for the report."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    def strong(v: str) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        for w in sorted(adj.get(v, ())):
            if w not in index:
                strong(w)
                low[v] = min(low[v], low[w])
            elif w in on:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on.discard(w)
                comp.append(w)
                if w == v:
                    break
            if len(comp) > 1 or v in adj.get(v, ()):
                out.append(sorted(comp))

    for v in sorted(adj):
        if v not in index:
            strong(v)
    return sorted(out)
