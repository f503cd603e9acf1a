"""kernelck: the port's counterpart of the JAX package's ``jaxck``.

jaxck proves what XLA compiles: donation lowers, hot jaxprs are
callback-free, dtypes stay f64-free, and a jaxpr fingerprint per program
matches a committed golden, so HLO drift (which invalidates the XLA
cache) is seen in review.  The port compiles nothing at run time but its
CUDA kernel libraries (``ops/cuda_build``), and its programs are plain
torch calls, so the rule keeps what carries over:

* **Kernel drift.**  Each registered kernel library's build digest
  (``ops/cuda_build._digest``: its source, the shared headers and the
  nvcc flags, hashed with the stdlib) against the committed golden
  ``analysis/goldens/kernelck.json``.  An edited ``.cu`` or ``.cuh`` file,
  or new flags, show up as "this change rebuilds N libraries", as jaxck's
  HLO drift does, and are blessed with ``--update-golden``.  This pass
  needs no nvcc and no torch.
* **Dtype.**  Statically: no ``torch.float64`` / ``torch.double`` /
  ``torch.complex128`` / ``.double()`` in the source of the hot programs
  (``manifest.KERNELCK_HOT_SOURCES``).  Dynamically: each serving advance
  program (``manifest.ADVANCE_PROGRAMS``) runs at canonical tiny shapes
  on the CPU (the kernels' plain versions) and every tensor it returns is
  checked: the mask fields are ``int32`` and every tensor of the state
  and status is ``int32`` or ``bool``.  int64 index tensors are told
  apart by scope: torch indexes with int64, so the programs widen indices
  and uint32 arithmetic to int64 inside a call, and an int64 tensor in
  the returned state is a finding.  This pass imports torch, lazily,
  which is why kernelck runs only when selected (``--rule kernelck``).

What does not carry over, and why:

* **Donation.**  The port's advances update the frontier's stack in
  place; there is no aliasing declaration to check.  Its runtime
  counterpart is ``test_in_place_reuse_is_invisible`` in
  tests/test_torch_status_pipeline.py (chunk k's status is a fresh tensor
  the in-place update of chunk k+1 does not write).
* **Callback-freedom.**  A torch program has no callback primitive hidden
  inside a compiled graph: every host read is a Python call that syncck
  sees in the source, and the fetch-count tests count at run time.
* **jaxpr fingerprints.**  There is no traced graph to fingerprint; the
  kernel digests above are the only compiled artefacts, and plain torch
  code needs no cache to invalidate.
"""

from __future__ import annotations

import ast
import importlib
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from distributed_sudoku_solver_tpu_torch.analysis import manifest
from distributed_sudoku_solver_tpu_torch.analysis.common import Finding, SourceModule, finding

GOLDEN_PATH = Path(__file__).resolve().parent / "goldens" / "kernelck.json"
_PACKAGE = "distributed_sudoku_solver_tpu_torch"
_FLOAT64_NAMES = ("float64", "double", "complex128")


def library_digests() -> Dict[str, str]:
    """Display name -> ``cuda_build._digest`` of every registered kernel
    library (reads the sources; builds nothing)."""
    from distributed_sudoku_solver_tpu_torch.ops import cuda_build

    return {
        cuda_build.lib_name(src, var): cuda_build._digest(src, var)
        for src, var in manifest.KERNEL_LIBRARIES
    }


def load_golden(path: Path) -> dict:
    if not path.exists():
        return {}
    return json.loads(path.read_text())


# -- the static dtype pass ------------------------------------------------------


def _float64_sites(mod: SourceModule) -> List[Tuple[ast.AST, str]]:
    out = []
    for node in ast.walk(mod.tree):
        if (
            isinstance(node, ast.Attribute)
            and node.attr in _FLOAT64_NAMES
            and isinstance(node.value, ast.Name)
            and node.value.id == "torch"
        ):
            out.append((node, f"torch.{node.attr}"))
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "double"
            and not node.args
        ):
            out.append((node, ".double()"))
    return out


# -- the dynamic dtype pass -----------------------------------------------------


def _canon_state(entry: dict):
    """Build the canonical inputs of one advance program on the CPU and run
    it once; returns its result."""
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
    from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
    from distributed_sudoku_solver_tpu_torch.ops.frontier import (
        SolverConfig,
        attach_roots,
        init_frontier_roots,
    )

    canon = manifest.KERNELCK_CANON
    geom = Geometry(*canon["geom"])
    config = SolverConfig(**canon["configs"][entry["config"]])
    modpath, attr = entry["fn"].split(":")
    fn = getattr(importlib.import_module(modpath), attr)
    cpu = torch.device("cpu")
    grid = torch.zeros((1, geom.n, geom.n), dtype=torch.int32)
    grid[0, 0, 0], grid[0, 1, 2], grid[0, 2, 1], grid[0, 3, 3] = 1, 3, 4, 2
    steps = canon["chunk_steps"]
    if entry["name"] in (manifest.ADVANCE_STATUS, manifest.ADVANCE_FUSED_STATUS):
        from distributed_sudoku_solver_tpu_torch.utils.checkpoint import start_frontier

        return fn(start_frontier(grid, geom, config), steps, geom, config)
    slot = torch.zeros(1, dtype=torch.int32)
    if entry["name"] == manifest.MESH_ADVANCE_STATUS:
        from distributed_sudoku_solver_tpu_torch.parallel.mesh import make_mesh
        from distributed_sudoku_solver_tpu_torch.parallel.mesh_resident import (
            mesh_attach,
            mesh_init_resident,
        )

        mesh = make_mesh([cpu])
        state = mesh_init_resident(geom, config, canon["slots"], mesh)
        state = mesh_attach(state, grid, slot, geom, config.steal_gang, mesh)
        return fn(state, steps, geom, config, mesh)
    lanes = config.lanes
    state = init_frontier_roots(
        torch.zeros((lanes, geom.n, geom.n), dtype=torch.int32),
        torch.full((lanes,), -1, dtype=torch.int32), canon["slots"], config,
    )
    state = attach_roots(state, encode_grid(grid, geom), slot, config.steal_gang)
    return fn(state, steps, canon["max_chunks"], geom, config)


def _tensors(value, path: str = ""):
    """(dotted field path, tensor) for every tensor in a result tree."""
    import torch

    if isinstance(value, torch.Tensor):
        yield path, value
    elif hasattr(value, "_fields"):
        for name in value._fields:
            yield from _tensors(getattr(value, name), f"{path}.{name}" if path else name)
    elif isinstance(value, (tuple, list)):
        for i, item in enumerate(value):
            yield from _tensors(item, f"{path}[{i}]")


def dtype_problems(result) -> List[str]:
    """The dtype findings of one advance program's result."""
    problems = []
    for path, t in _tensors(result):
        dtype = str(t.dtype).replace("torch.", "")
        field = path.rsplit(".", 1)[-1]
        if dtype in manifest.KERNELCK_BANNED_DTYPES:
            problems.append(f"{path} is {dtype}")
        elif field in manifest.KERNELCK_MASK_FIELDS and dtype != "int32":
            problems.append(f"mask field {path} is {dtype}, not int32")
        elif dtype not in manifest.KERNELCK_STATE_DTYPES:
            problems.append(f"{path} is {dtype} (returned state is "
                            f"{' or '.join(manifest.KERNELCK_STATE_DTYPES)})")
    return problems


def _def_line(mods: Dict[str, SourceModule], fnref: str) -> Tuple[Optional[SourceModule], int]:
    modpath, attr = fnref.split(":")
    rel = modpath[len(_PACKAGE) + 1:].replace(".", "/") + ".py"
    mod = mods.get(rel)
    if mod is None:
        return None, 0
    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name == attr:
            return mod, node.lineno
    return mod, 0


class _At:
    def __init__(self, lineno: int):
        self.lineno = lineno


def _at(mod: Optional[SourceModule], path: str, line: int, message: str) -> Finding:
    if mod is None:
        return Finding("kernelck", path, line, message)
    return finding(mod, "kernelck", _At(line), message)


def check_kernels(
    mods: List[SourceModule],
    golden_path: Optional[Path] = None,
    update_golden: bool = False,
) -> Tuple[List[Finding], dict]:
    """Run the drift and dtype passes; returns (findings, summary).  With
    ``update_golden`` the current digests are written to ``golden_path``
    (default: the committed golden) and drift is reported in the summary,
    not as findings."""
    golden_path = GOLDEN_PATH if golden_path is None else Path(golden_path)
    by_rel = {m.rel: m for m in mods}
    findings: List[Finding] = []
    digests = library_digests()
    golden = dict(load_golden(golden_path).get("libraries", {}))
    drifted = sorted(k for k in digests if golden.get(k) != digests[k])
    if not update_golden:
        for name in drifted:
            if name in golden:
                msg = (f"kernel drift: library {name} digest {digests[name]} != golden "
                       f"{golden[name]} — this change rebuilds it (source, headers or "
                       "flags); bless with --rule kernelck --update-golden")
            else:
                msg = (f"{name}: no committed golden for this library — run --rule "
                       "kernelck --update-golden and commit the result")
            findings.append(Finding("kernelck", "analysis/goldens/kernelck.json", 0, msg))
        for name in sorted(set(golden) - set(digests)):
            findings.append(Finding(
                "kernelck", "analysis/goldens/kernelck.json", 0,
                f"{name}: golden entry has no registered kernel library — remove it "
                "(or re-run --update-golden)",
            ))
    written = False
    if update_golden:
        golden_path.parent.mkdir(parents=True, exist_ok=True)
        golden_path.write_text(json.dumps({"libraries": digests}, indent=2, sort_keys=True) + "\n")
        written = True
    for rel in manifest.KERNELCK_HOT_SOURCES:
        mod = by_rel.get(rel)
        if mod is None:
            continue
        for node, what in _float64_sites(mod):
            findings.append(finding(mod, "kernelck", node,
                                    f"{what} in a hot program's source (no float64 on "
                                    "the serving path)"))
    programs = []
    for entry in manifest.ADVANCE_PROGRAMS:
        mod, line = _def_line(by_rel, entry["fn"])
        where = entry["fn"].split(":")[0][len(_PACKAGE) + 1:].replace(".", "/") + ".py"
        try:
            problems = dtype_problems(_canon_state(entry))
        except Exception as e:  # noqa: BLE001 - a program that cannot run is a finding
            problems = [f"did not run at the canonical shape: {type(e).__name__}: {e}"]
        for p in problems:
            findings.append(_at(mod, where, line, f"{entry['display']}: {p}"))
        programs.append(entry["display"])
    summary = {
        "drifted": drifted,
        "golden_written": written,
        "libraries": digests,
        "programs": programs,
    }
    return findings, summary
