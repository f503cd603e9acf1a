"""Runner: ``python -m distributed_sudoku_solver_tpu_torch.analysis``.

The JAX package's runner, pointed at the port's tree and manifest::

    python -m distributed_sudoku_solver_tpu_torch.analysis [--json] [--rule R]
        [--strict-waivers] [--update-golden]

``--rule`` narrows to one or more rules, and the exit code then reflects
exactly the selected rules (the "per-rule exit codes" contract).  The JAX
runner's ``--scope benchmarks`` lane has no counterpart: the port has no
benchmark scripts of its own.

Two lanes behind one flag:

* the default fast lane (``RULES``) is stdlib-``ast`` only — it never
  imports torch, runs in <5 s, and its output is byte-identical run to
  run (all pinned by tests/test_torch_analysis.py);
* ``--rule kernelck`` is the kernel lane (``analysis/kernelck.py``): the
  kernel libraries' build digests against ``analysis/goldens/kernelck.json``
  and the advance programs' dtypes, the latter run on the CPU with torch
  imported lazily.  ``--update-golden`` blesses kernel drift by rewriting
  the golden.

Waiver hygiene rides every run: a ``# <rule>: allow(...)`` comment whose
rule (among the rules that ran) no longer fires on that line is reported
as *stale* — report-only by default, exit 1 under ``--strict-waivers``.

Deterministic by construction: sorted file walk, sorted findings,
``sort_keys`` JSON — two runs over the same tree are byte-identical
(pinned by tests/test_torch_analysis.py).
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path
from typing import List, Optional, Tuple

from distributed_sudoku_solver_tpu_torch.analysis import (
    clockck,
    deadck,
    layerck,
    lockck,
    syncck,
)
from distributed_sudoku_solver_tpu_torch.analysis import manifest
from distributed_sudoku_solver_tpu_torch.analysis.common import (
    ALL_RULES,
    RULES,
    Finding,
    iter_sources,
    stale_waivers,
)
from distributed_sudoku_solver_tpu_torch.obs.exitcodes import (
    EXIT_CLEAN,
    EXIT_INTERNAL,
    EXIT_VIOLATIONS,
)

_PACKAGE_DIR = Path(__file__).resolve().parent.parent


def run(
    root: Optional[Path] = None,
    rules: Tuple[str, ...] = RULES,
    update_golden: bool = False,
) -> Tuple[dict, List[Finding]]:
    """Run the selected rules; returns (json-ready report, findings)."""
    root = root or _PACKAGE_DIR
    mods = list(iter_sources(root, root))
    findings: List[Finding] = []
    if "layerck" in rules:
        for mod in mods:
            findings.extend(layerck.check_module(mod, manifest.LAYERS))
    if "clockck" in rules:
        for mod in mods:
            findings.extend(clockck.check_module(
                mod,
                manifest.CLOCK_SCOPED_DIRS,
                manifest.CLOCK_BANNED_CALLS,
                manifest.CLOCK_SEAMS,
            ))
    if "syncck" in rules:
        for mod in mods:
            findings.extend(syncck.check_module(
                mod,
                manifest.SYNC_SCOPED_FILES,
                manifest.SYNC_HOT_REGIONS,
                manifest.SYNC_SEAM_FUNCS,
                manifest.SYNC_HOST_SOURCES,
                manifest.SYNC_NUMPY_CALLS,
                manifest.SYNC_METHOD_CALLS,
                manifest.SYNC_SCALAR_CASTS,
                manifest.SYNC_METADATA_ATTRS,
            ))
    if "lockck" in rules:
        findings.extend(lockck.check_modules(mods))
    deadck_summary = None
    if "deadck" in rules:
        dk_findings, deadck_summary = deadck.check_modules(
            mods,
            ranks=manifest.LOCK_RANKS,
            declared=manifest.LOCK_EDGE_DECLARED,
            base_classes=manifest.DEADCK_BASE_CLASSES,
            thread_roots=manifest.DEADCK_THREAD_ROOTS,
        )
        findings.extend(dk_findings)
    kernelck_summary = None
    if "kernelck" in rules:
        # The lazy lane: torch is imported inside kernelck's dtype pass
        # only, and only here — the default rules tuple never includes
        # kernelck, so the fast lane never imports torch.
        from distributed_sudoku_solver_tpu_torch.analysis import kernelck

        kc_findings, kernelck_summary = kernelck.check_kernels(
            mods, update_golden=update_golden
        )
        findings.extend(kc_findings)
    findings.sort()
    report = {
        "rules": {
            rule: {
                "violations": [
                    f.to_dict() for f in findings
                    if f.rule == rule and not f.waived
                ],
                "waived": [
                    f.to_dict() for f in findings
                    if f.rule == rule and f.waived
                ],
            }
            for rule in sorted(rules)
        },
        "files_scanned": len(mods),
        # Waiver hygiene: sites whose rule ran and no longer fires there.
        "stale_waivers": [
            {"path": path, "line": line, "rule": rule, "reason": reason}
            for path, line, rule, reason in stale_waivers(mods, rules)
        ],
    }
    if deadck_summary is not None:
        # The predicted thread-plane graph: tier-1's runtime witness
        # (obs/lockdep.py) must observe a SUBSET of these edges.
        report["deadck"] = deadck_summary
    if kernelck_summary is not None:
        report["kernelck"] = {
            "drifted": kernelck_summary["drifted"],
            "golden_written": kernelck_summary["golden_written"],
            "libraries": len(kernelck_summary["libraries"]),
            "programs": len(kernelck_summary["programs"]),
        }
    return report, findings


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributed_sudoku_solver_tpu_torch.analysis",
        description=(
            "invariant linter of the port: layerck/clockck/syncck/lockck/"
            "deadck (fast, no torch) + the opt-in kernel lane (--rule kernelck)"
        ),
    )
    parser.add_argument("--json", action="store_true", help="machine report")
    parser.add_argument(
        "--rule", action="append", choices=ALL_RULES,
        help="run only this rule (repeatable); exit code reflects it alone. "
        "kernelck is opt-in: it imports torch (the default lane never does)",
    )
    parser.add_argument(
        "--update-golden", action="store_true",
        help="(kernelck) bless kernel drift: rewrite "
        "analysis/goldens/kernelck.json from the current sources — commit "
        "the diff with the change that causes it",
    )
    parser.add_argument(
        "--strict-waivers", action="store_true",
        help="exit 1 when a committed waiver's rule no longer fires on its "
        "line (default: stale waivers are report-only)",
    )
    parser.add_argument(
        "--root", type=Path, default=None, help=argparse.SUPPRESS
    )
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        # argparse exits 2 on usage errors already — keep its semantics,
        # but normalise --help's 0.
        return EXIT_INTERNAL if e.code else EXIT_CLEAN
    rules = tuple(args.rule) if args.rule else RULES
    if args.update_golden and "kernelck" not in rules:
        print(
            "analysis: --update-golden only applies to --rule kernelck",
            file=sys.stderr,
        )
        return EXIT_INTERNAL
    try:
        report, findings = run(
            root=args.root, rules=rules, update_golden=args.update_golden,
        )
    except Exception:  # noqa: BLE001 - the tool failing is exit 2, loudly
        traceback.print_exc()
        return EXIT_INTERNAL
    if report["files_scanned"] == 0:
        # A typo'd --root must not report success while checking nothing.
        print(
            "analysis: no Python files found under the scan root "
            "— refusing to report a clean tree",
            file=sys.stderr,
        )
        return EXIT_INTERNAL
    violations = [f for f in findings if not f.waived]
    waived = [f for f in findings if f.waived]
    stale = report["stale_waivers"]
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        for f in findings:
            print(f.render(), file=sys.stderr if not f.waived else sys.stdout)
        for s in stale:
            print(
                f"stale-waiver: {s['path']}:{s['line']}: "
                f"# {s['rule']}: allow({s['reason']}) — {s['rule']} no "
                "longer fires here; delete the waiver"
            )
        for rule in sorted(rules):
            nv = sum(1 for f in violations if f.rule == rule)
            nw = sum(1 for f in waived if f.rule == rule)
            print(f"analysis: {rule}: {nv} violation(s), {nw} waived")
        if "kernelck" in report:
            kc = report["kernelck"]
            if kc["golden_written"]:
                print(
                    f"analysis: kernelck: golden updated for {kc['libraries']} "
                    f"librar(ies) ({len(kc['drifted'])} drifted) — commit "
                    "analysis/goldens/kernelck.json"
                )
            elif kc["drifted"]:
                print(
                    f"analysis: kernelck: kernel drift in {len(kc['drifted'])} "
                    "librar(ies) — this change rebuilds: "
                    + ", ".join(kc["drifted"])
                )
        if stale:
            print(f"analysis: {len(stale)} stale waiver(s)")
        print(
            f"analysis: {len(violations)} violation(s) over "
            f"{report['files_scanned']} files"
        )
    if violations:
        return EXIT_VIOLATIONS
    if stale and args.strict_waivers:
        return EXIT_VIOLATIONS
    return EXIT_CLEAN


if __name__ == "__main__":
    raise SystemExit(main())
