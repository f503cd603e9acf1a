"""syncck: host-sync discipline in the serving hot loops, in torch terms.

The JAX package's ``analysis/syncck.py`` hunts ``np.asarray`` /
``jax.device_get`` / ``.item()`` on jax values; here the same contract is
stated for torch tensors.  The serving loops read the device only through
the ``host_fetch`` seam (serving/engine.py), which copies a status word
(or a verdict tuple) in one transfer: "exactly one host sync per chunk".
The fetch-count tests of tests/test_torch_status_pipeline.py prove it at
run time on the paths they drive; this rule proves it statically on every
line:

* in ``manifest.SYNC_SCOPED_FILES``, every host read of a tensor is
  flagged unless its operand is PROVEN host-side or it carries a
  ``# syncck: allow(<reason>)`` waiver (line- or def-scoped):
  ``np.asarray`` / ``np.ascontiguousarray`` / ``np.array``, the methods
  ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``, ``.to("cpu")``
  / ``.to(device="cpu")``, and the explicit sync points
  ``torch.cuda.synchronize()`` / ``Event.synchronize()``;
* inside the hot regions (``manifest.SYNC_HOT_REGIONS``) the rule widens
  to ``bool()`` / ``int()`` / ``float()`` over a subscript, an attribute,
  or a reduction call (``x.any()``, ``x.sum()``, ...) — the shape of a
  scalar read off a live tensor, which torch turns into a blocking copy.

"Proven host-side" is the JAX rule's forward dataflow pass: a name (or
``self.<attr>``, tracked class-wide) assigned from a ``host_fetch`` /
``unpack_status`` call — tuple unpacking included — is host data, and so
is anything re-assigned from an expression rooted at one.  Tensor
metadata (``.shape``, ``.dtype``, ``.device``, ``.ndim``) is host data by
construction.  The ``host_fetch`` body (and its one-transfer helper) is
the seam and exempt.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from distributed_sudoku_solver_tpu_torch.analysis.common import (
    Finding,
    QualnameVisitor,
    SourceModule,
    call_name,
    expr_root,
    finding,
)

#: Reductions whose result is a 0-d tensor: ``bool(x.any())`` is a sync.
REDUCTIONS = ("any", "all", "sum", "max", "min", "amax", "amin", "prod", "argmax", "argmin")


def _is_host_source(node: ast.AST, host_sources: Tuple[str, ...]) -> bool:
    """A call whose (possibly dotted) name ends in a host-source function,
    applied to anything — ``unpack_status(host_fetch(...))`` included."""
    if isinstance(node, ast.Call):
        name = call_name(node).rsplit(".", 1)[-1]
        return name in host_sources
    return False


def _host_attrs(tree: ast.Module, host_sources: Tuple[str, ...]) -> Set[str]:
    """Class-wide pass: ``self.X = <host source>(...)`` anywhere marks
    ``self.X`` host-side for the whole file (the scheduler's
    ``self._status`` pattern)."""
    attrs: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and _is_host_source(node.value, host_sources):
            for t in node.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    attrs.add(f"self.{t.attr}")
    return attrs


def _is_cpu(node: ast.AST) -> bool:
    """A literal device naming the host: ``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and call_name(node).endswith("device") and node.args:
        return _is_cpu(node.args[0])
    return False


class _SyncVisitor(QualnameVisitor):
    def __init__(
        self,
        mod: SourceModule,
        hot_regions: Tuple[str, ...],
        seam_funcs: Tuple[str, ...],
        host_sources: Tuple[str, ...],
        numpy_calls: Tuple[str, ...],
        method_calls: Tuple[str, ...],
        scalar_casts: Tuple[str, ...],
        metadata_attrs: Tuple[str, ...],
        np_aliases: Set[str],
        host_attrs: Set[str],
    ):
        super().__init__()
        self.mod = mod
        self.hot_regions = hot_regions
        self.seam_funcs = seam_funcs
        self.host_sources = host_sources
        self.numpy_calls = numpy_calls
        self.method_calls = method_calls
        self.scalar_casts = scalar_casts
        self.metadata_attrs = metadata_attrs
        self.np_aliases = np_aliases
        self.host_attrs = host_attrs
        self.host_locals: List[Set[str]] = []  # one scope per function
        self.findings: List[Finding] = []

    # -- scope plumbing ------------------------------------------------------
    def _visit_func(self, node) -> None:
        self.stack.append(node.name)
        self.def_lines.append(node.lineno)
        self.host_locals.append(set())
        if node.name not in self.seam_funcs:  # the seam body is exempt
            self.generic_visit(node)
        self.host_locals.pop()
        self.def_lines.pop()
        self.stack.pop()

    def _in_hot_region(self) -> bool:
        q = self.qualname
        return any(q == r or q.startswith(r + ".") for r in self.hot_regions)

    def _is_metadata(self, node: ast.AST) -> bool:
        n = node
        while isinstance(n, (ast.Subscript, ast.Attribute, ast.Call)):
            if isinstance(n, ast.Attribute) and n.attr in self.metadata_attrs:
                return True
            n = n.value if isinstance(n, (ast.Subscript, ast.Attribute)) else n.func
        return False

    def _is_host(self, node: ast.AST) -> bool:
        if self._is_metadata(node) or _is_host_source(node, self.host_sources):
            return True
        root = expr_root(node)
        if root is None:
            return False
        if root in self.host_attrs:
            return True
        return any(root in scope for scope in self.host_locals)

    def _mark_host(self, target: ast.AST) -> None:
        if not self.host_locals:
            return
        if isinstance(target, ast.Name):
            self.host_locals[-1].add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._mark_host(elt)
        elif (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
        ):
            self.host_attrs.add(f"self.{target.attr}")

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        if self._is_host(node.value):
            for t in node.targets:
                self._mark_host(t)

    # -- the checks ----------------------------------------------------------
    def _flag(self, node: ast.Call, what: str) -> None:
        self.findings.append(finding(
            self.mod, "syncck", node,
            f"{what} outside the host_fetch seam — route the value "
            "through host_fetch (or prove it host-side / waive with "
            "reason)",
            def_lines=tuple(self.def_lines),
        ))

    def _scalar_read(self, arg: ast.AST) -> bool:
        """A cast operand that reads a tensor element: a subscript, an
        attribute, or a reduction call, not proven host-side."""
        if arg is None or self._is_host(arg):
            return False
        if isinstance(arg, (ast.Subscript, ast.Attribute)):
            return True
        return (
            isinstance(arg, ast.Call)
            and isinstance(arg.func, ast.Attribute)
            and arg.func.attr in REDUCTIONS
            and not self._is_host(arg.func.value)
        )

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        arg0 = node.args[0] if node.args else None
        if isinstance(f, ast.Attribute):
            if (
                isinstance(f.value, ast.Name)
                and f.value.id in self.np_aliases
                and f.attr in self.numpy_calls
            ):
                if arg0 is None or not self._is_host(arg0):
                    self._flag(node, f"host copy np.{f.attr}()")
            elif f.attr == "synchronize":
                self._flag(node, f"sync point {call_name(node)}()")
            elif f.attr in self.method_calls and not self._is_host(f.value):
                self._flag(node, f".{f.attr}() call")
            elif f.attr == "to" and not self._is_host(f.value) and (
                (arg0 is not None and _is_cpu(arg0))
                or any(k.arg == "device" and _is_cpu(k.value) for k in node.keywords)
            ):
                self._flag(node, ".to('cpu') call")
        elif (
            isinstance(f, ast.Name)
            and f.id in self.scalar_casts
            and self._in_hot_region()
            and self._scalar_read(arg0)
        ):
            self._flag(node, f"hot-loop {f.id}() of a tensor value")
        self.generic_visit(node)


def check_module(
    mod: SourceModule,
    scoped_files: Tuple[str, ...],
    hot_regions: Dict[str, Tuple[str, ...]],
    seam_funcs: Tuple[str, ...],
    host_sources: Tuple[str, ...],
    numpy_calls: Tuple[str, ...],
    method_calls: Tuple[str, ...],
    scalar_casts: Tuple[str, ...],
    metadata_attrs: Tuple[str, ...],
) -> List[Finding]:
    if mod.rel not in scoped_files:
        return []
    np_aliases: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for al in node.names:
                if al.name == "numpy":
                    np_aliases.add(al.asname or "numpy")
    v = _SyncVisitor(
        mod,
        hot_regions.get(mod.rel, ()),
        seam_funcs,
        host_sources,
        numpy_calls,
        method_calls,
        scalar_casts,
        metadata_attrs,
        np_aliases,
        _host_attrs(mod.tree, host_sources),
    )
    v.visit(mod.tree)
    return v.findings
