"""layerck: prove the import-layering manifest against real import nodes.

A copy of the JAX package's ``analysis/layerck.py`` with its imports pointed
at this package; it reads the port's ``analysis/manifest.py``.

Every ``import``/``from`` node in the tree — including ones nested inside
functions, the lazy-import idiom this codebase uses everywhere — is
resolved to a dotted target and checked against the longest-prefix rule
in ``manifest.LAYERS``.  Closed layers whitelist (stdlib + declared
siblings + declared third-party roots); open layers blacklist forbidden
prefixes with declared carve-outs.  See manifest.py for the rule
semantics and the docstring contracts each entry encodes.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from distributed_sudoku_solver_tpu_torch.analysis.common import (
    Finding,
    SourceModule,
    finding,
    stdlib_top,
)

PACKAGE = "distributed_sudoku_solver_tpu_torch"


def _dotted_prefix(prefix: str, name: str) -> bool:
    return name == prefix or name.startswith(prefix + ".")


def _rule_for(modname: str, layers: Dict[str, dict]) -> Optional[Tuple[str, dict]]:
    best = None
    for key, rule in layers.items():
        if _dotted_prefix(key, modname):
            if best is None or len(key) > len(best[0]):
                best = (key, rule)
    return best


def _targets(node: ast.AST, modname: str, package: str) -> List[str]:
    """Absolute dotted targets of one import node (relative imports are
    resolved against the importing module's package path)."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    assert isinstance(node, ast.ImportFrom)
    if node.level:
        parts = modname.split(".")
        # level 1 = the module's own package, each extra level one up.
        keep = len(parts) - node.level
        base_parts = [package] + parts[: max(keep, 0)]
        base = ".".join(p for p in base_parts if p)
        mod = f"{base}.{node.module}" if node.module else base
        return [mod]
    mod = node.module or ""
    # Qualify by the imported names: ``from pkg.serving import faults``
    # is an import OF ``serving.faults``, and the rules (carve-outs like
    # ops' declared ``serving.faults`` seam) must see it that way.  A
    # symbol import (``from pkg.cluster.wire import WireError``) gains a
    # trailing component the dotted-prefix matching ignores.
    return [f"{mod}.{a.name}" for a in node.names] if mod else [mod]


def _internal_allowed(target: str, allow: Tuple[str, ...]) -> bool:
    # Prefix in either direction: importing the parent package to reach a
    # declared submodule keeps the same promise (manifest.py note).
    return any(
        _dotted_prefix(a, target) or _dotted_prefix(target, a) for a in allow
    )


def check_module(
    mod: SourceModule,
    layers: Dict[str, dict],
    package: str = PACKAGE,
) -> List[Finding]:
    if mod.modname is None:
        return []
    matched = _rule_for(mod.modname, layers)
    if matched is None:
        return []
    key, rule = matched
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        for target in _targets(node, mod.modname, package):
            if not target:
                continue
            if _dotted_prefix(package, target):
                internal = target[len(package) :].lstrip(".")
                if not internal:
                    continue  # bare package import: the lazy __init__
                if rule.get("closed"):
                    if not _internal_allowed(internal, rule.get("allow", ())):
                        out.append(finding(
                            mod, "layerck", node,
                            f"closed layer '{key}' imports internal module "
                            f"'{internal}' (allowed: "
                            f"{', '.join(rule.get('allow', ())) or 'none'})",
                        ))
                else:
                    for forb in rule.get("forbid", ()):
                        if _dotted_prefix(forb, internal) and not any(
                            _dotted_prefix(exc, internal)
                            for exc in rule.get("except", ())
                        ):
                            out.append(finding(
                                mod, "layerck", node,
                                f"layer '{key}' must not import '{forb}' "
                                f"(got '{internal}')",
                            ))
                            break
            elif not stdlib_top(target):
                if rule.get("closed") and target.split(".", 1)[0] not in rule.get(
                    "third_party", ()
                ):
                    out.append(finding(
                        mod, "layerck", node,
                        f"closed layer '{key}' imports third-party "
                        f"'{target}' (stdlib only"
                        + (
                            " + " + ", ".join(rule["third_party"])
                            if rule.get("third_party")
                            else ""
                        )
                        + ")",
                    ))
    return out
