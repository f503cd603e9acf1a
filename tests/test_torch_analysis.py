"""The port's static analysis (``distributed_sudoku_solver_tpu_torch/analysis``).

Twins of the rule and runner cases of ``tests/test_analysis.py`` and the
static cases of ``tests/test_deadck.py``, on the port's rules and manifest:

* fixture lane — one violating and one clean synthetic module per rule,
  driven through the checkers with injected configs, so each rule is seen
  to FIRE; ``syncck``'s fixtures are in torch terms, and ``kernelck`` has a
  drift fixture (an edited kernel source against the golden) and dtype
  fixtures;
* the gate — ``python -m distributed_sudoku_solver_tpu_torch.analysis``
  over the port's tree exits 0 without importing torch, jax or the JAX
  package; with all six rules it exits 0 with no stale waiver;
* the triage of the findings the JAX rules reported on the port's tree:
  the two unnamed locks are named (and the witness knows them), and the
  phantom lock-order edges from name resolution are declared receivers;
* manifest pins — every hot region, thread root and layer names real
  code, the lock ranks have one source, the simnet list is the JAX one;
* ``obs/traceck.py`` against the JAX package's on the same documents.
"""

import ast
import dataclasses
import functools
import importlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from distributed_sudoku_solver_tpu.analysis import clockck as jclockck
from distributed_sudoku_solver_tpu.analysis import deadck as jdeadck
from distributed_sudoku_solver_tpu.analysis import layerck as jlayerck
from distributed_sudoku_solver_tpu.analysis import lockck as jlockck
from distributed_sudoku_solver_tpu.analysis import manifest as jmanifest
from distributed_sudoku_solver_tpu.analysis.common import SourceModule as JSourceModule
from distributed_sudoku_solver_tpu.analysis.common import iter_sources as jiter_sources
from distributed_sudoku_solver_tpu.obs import traceck as jtraceck
from distributed_sudoku_solver_tpu_torch.analysis import (
    clockck,
    deadck,
    kernelck,
    layerck,
    lockck,
    manifest,
    syncck,
)
from distributed_sudoku_solver_tpu_torch.analysis.__main__ import main, run
from distributed_sudoku_solver_tpu_torch.analysis.common import (
    ALL_RULES,
    RULES,
    SourceModule,
    iter_sources,
    stale_waivers,
)
from distributed_sudoku_solver_tpu_torch.obs import exitcodes, lock_manifest, lockdep, promck, traceck
from distributed_sudoku_solver_tpu_torch.ops import cuda_build

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "distributed_sudoku_solver_tpu_torch"
FIXTURES = Path(__file__).resolve().parent / "data" / "analysis"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def module(tmp_path, name: str, text: str, modname=None) -> SourceModule:
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)
    return SourceModule(p, name, modname)


def line_of(mod: SourceModule, needle: str) -> int:
    return next(i + 1 for i, ln in enumerate(mod.text.splitlines()) if needle in ln)


# -- layerck -------------------------------------------------------------------

LAYER_BAD = '''import json
import some_third_party_lib


def lazy():
    from distributed_sudoku_solver_tpu_torch.forbidden_layer import thing

    return thing, json, some_third_party_lib
'''

LAYER_OK = '''import json

from distributed_sudoku_solver_tpu_torch.allowed_layer import helper


def lazy():
    from distributed_sudoku_solver_tpu_torch.allowed_layer.sub import thing

    return thing, helper, json
'''


def test_layerck_fires_on_nested_import_and_third_party(tmp_path):
    mod = module(tmp_path, "layer_bad.py", LAYER_BAD, modname="layer_bad")
    closed = {"layer_bad": {"closed": True, "allow": ("allowed_layer",), "third_party": ()}}
    findings = layerck.check_module(mod, closed)
    assert sorted(f.line for f in findings) == [2, line_of(mod, "forbidden_layer")]
    opened = {"layer_bad": {"closed": False, "forbid": ("forbidden_layer",)}}
    assert [f.line for f in layerck.check_module(mod, opened)] == [line_of(mod, "forbidden")]
    carved = {"layer_bad": {"closed": False, "forbid": ("forbidden_layer",),
                            "except": ("forbidden_layer.thing",)}}
    assert layerck.check_module(mod, carved) == []


def test_layerck_clean_fixture(tmp_path):
    mod = module(tmp_path, "layer_ok.py", LAYER_OK, modname="layer_ok")
    layers = {"layer_ok": {"closed": True, "allow": ("allowed_layer",), "third_party": ()}}
    assert layerck.check_module(mod, layers) == []


def test_layerck_first_party_is_the_port():
    """The JAX manifest knows only the JAX package as first party, so its
    layerck read every port import as third-party; the port's rule does
    not, and the JAX package is third-party here (closed layers reject
    it)."""
    assert layerck.PACKAGE == "distributed_sudoku_solver_tpu_torch"
    report, _ = run(rules=("layerck",))
    assert report["rules"]["layerck"]["violations"] == []


# -- clockck -------------------------------------------------------------------

CLOCK_BAD = '''import time as _t
from time import monotonic as mono

_grab = _t.perf_counter


def f():
    _t.sleep(1)
    a = mono()
    return a, _grab()
'''

CLOCK_OK = '''import time
from typing import Callable


def f(clock: Callable[[], float] = time.monotonic):
    time.sleep(0.1)  # clockck: allow(fixture: a declared simulator's pace)
    return clock()
'''


def _clock(mod):
    return clockck.check_module(mod, manifest.CLOCK_SCOPED_DIRS, manifest.CLOCK_BANNED_CALLS,
                                manifest.CLOCK_SEAMS, scope_all=True)


def test_clockck_fires_on_alias_rename_and_capture(tmp_path):
    live = [f for f in _clock(module(tmp_path, "c.py", CLOCK_BAD)) if not f.waived]
    assert len(live) == 3
    text = " ".join(f.message for f in live)
    assert "time.sleep" in text and "time.monotonic" in text and "time.perf_counter" in text


def test_clockck_clean_fixture_reference_default_and_waiver(tmp_path):
    findings = _clock(module(tmp_path, "c.py", CLOCK_OK))
    assert [f for f in findings if not f.waived] == []
    assert len(findings) == 1 and findings[0].reason


# -- syncck, in torch terms -----------------------------------------------------

SYNC_BAD = '''import numpy as np
import torch


class Hot:
    def step(self, state, ev):
        a = state.top.item()
        b = state.solved.tolist()
        c = state.nodes.cpu()
        d = state.stack.numpy()
        e = state.steps.to("cpu")
        f = state.steps.to(device="cpu")
        g = np.asarray(state.solution)
        h = bool(state.has_top.any())
        i = int(state.steps)
        j = float(state.nodes[0])
        torch.cuda.synchronize()
        ev.synchronize()
        return a, b, c, d, e, f, g, h, i, j
'''

SYNC_OK = '''import numpy as np


def host_fetch(x):
    return x.cpu().numpy()  # the seam: its body is exempt by name


def unpack_status(raw, n):
    return {"steps": raw[0], "solved": raw[1:n]}


class Hot:
    def prime(self):
        self._status = unpack_status(host_fetch(self.pending), 4)

    def step(self, state):
        info, extra = host_fetch((state.status, state.extra))
        n = int(info[0])
        solved = self._status["solved"]
        m = bool(solved[0])
        lanes = int(state.top.shape[0])
        pinned = np.asarray(extra[1], np.int32)
        cold = np.asarray([1, 2])  # syncck: allow(fixture: literal host data)
        return n, m, lanes, pinned, cold
'''


def _sync(mod):
    return syncck.check_module(
        mod,
        scoped_files=(mod.rel,),
        hot_regions={mod.rel: ("Hot.step",)},
        seam_funcs=manifest.SYNC_SEAM_FUNCS,
        host_sources=manifest.SYNC_HOST_SOURCES,
        numpy_calls=manifest.SYNC_NUMPY_CALLS,
        method_calls=manifest.SYNC_METHOD_CALLS,
        scalar_casts=manifest.SYNC_SCALAR_CASTS,
        metadata_attrs=manifest.SYNC_METADATA_ATTRS,
    )


def test_syncck_fires_on_every_torch_host_read(tmp_path):
    mod = module(tmp_path, "sync_bad.py", SYNC_BAD)
    live = [f for f in _sync(mod) if not f.waived]
    lines = sorted(f.line for f in live)
    want = [line_of(mod, s) for s in (
        ".item()", ".tolist()", ".cpu()", ".numpy()", 'to("cpu")', 'to(device="cpu")',
        "np.asarray", "bool(", "int(", "float(", "torch.cuda.synchronize", "ev.synchronize")]
    assert lines == sorted(want), [f.render() for f in live]


def test_syncck_host_proof_metadata_and_waiver(tmp_path):
    findings = _sync(module(tmp_path, "sync_ok.py", SYNC_OK))
    assert [f for f in findings if not f.waived] == []
    waived = [f for f in findings if f.waived]
    assert len(waived) == 1 and waived[0].reason


def test_syncck_casts_only_in_hot_regions(tmp_path):
    mod = module(tmp_path, "cold.py", SYNC_BAD.replace("class Hot", "class Cold"))
    kinds = {f.message.split(" outside")[0] for f in _sync(mod)}
    assert not any(k.startswith("hot-loop") for k in kinds)
    assert ".item() call" in kinds and "host copy np.asarray()" in kinds


# -- lockck --------------------------------------------------------------------


def test_lockck_fires_on_unlocked_helper_write():
    findings = lockck.check_modules([SourceModule(FIXTURES / "lock_bad.py", "lock_bad.py", None)])
    assert len(findings) == 1 and not findings[0].waived and "hits" in findings[0].message


def test_lockck_clean_fixture_with_block_suffix_and_subscript():
    assert lockck.check_modules([SourceModule(FIXTURES / "lock_ok.py", "lock_ok.py", None)]) == []


def test_lockck_cross_module_write_checks_base_lock(tmp_path):
    decl = module(tmp_path, "decl.py", "class E:\n    def __init__(self):\n"
                  "        self.jobs = 0  # lockck: guard(_lock)\n")
    writer = module(tmp_path, "writer.py", "def good(engine):\n    with engine._lock:\n"
                    "        engine.jobs += 1\ndef bad(engine):\n    engine.jobs += 1\n")
    findings = lockck.check_modules([decl, writer])
    assert [(f.path, f.line) for f in findings] == [("writer.py", 5)]


# -- deadck (static) ------------------------------------------------------------

ROOTS = {"deadlock_bad.py": ("root_one", "root_two"),
         "deadlock_ok.py": ("root_one", "root_two")}


def _dead(name, ranks, declared=None):
    return deadck.check_modules([SourceModule(FIXTURES / name, name, None)], ranks=ranks,
                                declared=declared or {}, base_classes={}, thread_roots=ROOTS)


def test_deadck_fires_on_every_finding_shape():
    findings, summary = _dead("deadlock_bad.py", {"t.a": 20, "t.b": 10})
    msgs = " | ".join(f.message for f in findings if not f.waived)
    assert "unnamed lock" in msgs
    assert "disagrees with the factory argument" in msgs
    assert "lock-order edge 't.a'" in msgs and "'t.b'" in msgs
    assert "attribute 'shared' of A" in msgs and "2 thread roots" in msgs
    assert "self-acquisition of non-reentrant lock 't.a'" in msgs
    assert ["t.a", "t.b"] in summary["predicted"]


def test_deadck_clean_fixture_and_waiver():
    findings, summary = _dead("deadlock_ok.py", {"t.a": 20, "t.b": 30})
    assert [f for f in findings if not f.waived] == []
    waived = [f for f in findings if f.waived]
    assert len(waived) == 1 and "tolerated" in waived[0].message and waived[0].reason
    assert ["t.a", "t.b"] in summary["predicted"]


def test_deadck_cycle_finding_via_declared_edges():
    findings, _ = _dead("deadlock_ok.py", {"t.a": 20, "t.b": 30},
                        declared={("t.b", "t.a"): "fixture"})
    assert any("cycle in the predicted lock-order graph" in f.message for f in findings)


# -- the copied rules against the JAX package's, on the same inputs ---------------
#
# layerck, clockck, lockck and deadck are copies of the JAX rules.  Each case
# runs the JAX rule and the port's over the same files with the same tables
# (layers, clock tables, ranks, declared edges, base classes, thread roots)
# and requires the same findings, waivers and reasons included, and for
# deadck the same predicted graph: the fixtures, the port's tree under the
# port's manifest, and the JAX package's tree under the JAX manifest.

JAX_PKG = REPO / "distributed_sudoku_solver_tpu"
TREES = {"port": (PKG, manifest, layerck.PACKAGE), "jax": (JAX_PKG, jmanifest, jlayerck.PACKAGE)}
DEAD_RANKS = {"bad": {"t.a": 20, "t.b": 10}, "ok": {"t.a": 20, "t.b": 30}}


TWINS = {"jax": ({"layerck": jlayerck, "clockck": jclockck, "lockck": jlockck, "deadck": jdeadck},
                 JSourceModule, jiter_sources),
         "port": ({"layerck": layerck, "clockck": clockck, "lockck": lockck, "deadck": deadck},
                  SourceModule, iter_sources)}


@functools.lru_cache(maxsize=None)
def _tree_mods(pkg: str, tree: str) -> tuple:
    root = TREES[tree][0]
    return tuple(TWINS[pkg][2](root, root))


def _run_twin(rule, pkg, mods, tables, package=None, scope_all=False, dead=None):
    checker = TWINS[pkg][0][rule]
    summary = None
    if rule == "layerck":
        findings = [f for m in mods for f in checker.check_module(m, tables.LAYERS, package)]
    elif rule == "clockck":
        findings = [f for m in mods for f in checker.check_module(
            m, tables.CLOCK_SCOPED_DIRS, tables.CLOCK_BANNED_CALLS, tables.CLOCK_SEAMS,
            scope_all=scope_all)]
    elif rule == "lockck":
        findings = checker.check_modules(mods)
    else:
        findings, summary = checker.check_modules(mods, **dead)
    rows = sorted((f.rule, f.path, f.line, f.message, f.waived, f.reason) for f in findings)
    return rows, json.dumps(summary, sort_keys=True, default=sorted)


FIXTURE_CASES = {
    "layerck-closed": ("layerck", "layer_bad.py", "layer_bad", {"layer_bad": {
        "closed": True, "allow": ("allowed_layer",), "third_party": ()}}),
    "layerck-open": ("layerck", "layer_bad.py", "layer_bad", {"layer_bad": {
        "closed": False, "forbid": ("forbidden_layer",)}}),
    "layerck-carved": ("layerck", "layer_bad.py", "layer_bad", {"layer_bad": {
        "closed": False, "forbid": ("forbidden_layer",), "except": ("forbidden_layer.thing",)}}),
    "layerck-clean": ("layerck", "layer_ok.py", "layer_ok", {"layer_ok": {
        "closed": True, "allow": ("allowed_layer",), "third_party": ()}}),
    "clockck-bad": ("clockck", "clock_bad.py", None, None),
    "clockck-clean": ("clockck", "clock_ok.py", None, None),
    "lockck-bad": ("lockck", "lock_bad.py", None, None),
    "lockck-clean": ("lockck", "lock_ok.py", None, None),
    "deadck-bad": ("deadck", "deadlock_bad.py", None, ("bad", {})),
    "deadck-clean": ("deadck", "deadlock_ok.py", None, ("ok", {})),
    "deadck-cycle": ("deadck", "deadlock_ok.py", None, ("ok", {("t.b", "t.a"): "fixture"})),
}


@pytest.mark.parametrize("case", sorted(FIXTURE_CASES))
def test_copied_rule_equals_the_jax_rule_on_fixtures(case):
    rule, name, modname, extra = FIXTURE_CASES[case]
    tables = jmanifest
    dead = None
    if rule == "layerck":
        tables = type("Layers", (), {"LAYERS": extra})
    if rule == "deadck":
        ranks, declared = extra
        dead = dict(ranks=DEAD_RANKS[ranks], declared=declared, base_classes={},
                    thread_roots={n: ("root_one", "root_two")
                                  for n in ("deadlock_bad.py", "deadlock_ok.py")})
    got = {}
    for pkg in ("jax", "port"):
        mods = [TWINS[pkg][1](FIXTURES / name, name, modname)]
        got[pkg] = _run_twin(rule, pkg, mods, tables, package=jlayerck.PACKAGE,
                             scope_all=True, dead=dead)
    assert got["port"] == got["jax"]
    if case.endswith("-bad") or case in ("layerck-closed", "layerck-open", "deadck-cycle"):
        assert [r for r in got["jax"][0] if not r[4]], case  # the case does fire


@pytest.mark.parametrize("rule", ["layerck", "clockck", "lockck", "deadck"])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_copied_rule_equals_the_jax_rule_on_a_tree(rule, tree):
    _, tables, package = TREES[tree]
    dead = dict(ranks=tables.LOCK_RANKS, declared=tables.LOCK_EDGE_DECLARED,
                base_classes=tables.DEADCK_BASE_CLASSES, thread_roots=tables.DEADCK_THREAD_ROOTS)
    got = {}
    for pkg in ("jax", "port"):
        mods = list(_tree_mods(pkg, tree))
        got[pkg] = _run_twin(rule, pkg, mods, tables, package=package, dead=dead)
    assert got["port"] == got["jax"]
    if rule in ("clockck", "deadck"):
        # Both trees carry reasoned waivers of these rules, so the
        # comparison covers waiver parsing and reasons.
        assert any(r[4] and r[5] for r in got["jax"][0]), rule
    if rule == "lockck":
        # Neither tree has a live lockck finding: hold the parsed guard
        # declarations equal instead.
        guards = {pkg: [dataclasses.astuple(g) for m in _tree_mods(pkg, tree)
                        for g in TWINS[pkg][0]["lockck"].collect_guards(m)]
                  for pkg in TWINS}
        assert guards["port"] == guards["jax"] and guards["jax"]


# -- the triage of the port's findings -------------------------------------------


def _port_mods():
    from distributed_sudoku_solver_tpu_torch.analysis.common import iter_sources

    return list(iter_sources(PKG, PKG))


def test_repaired_unnamed_locks_are_named_and_ranked():
    """The kernel libraries' build lock and the virtual-device count were
    raw ``threading`` locks neither the static graph nor the witness knew.
    Both are named now, ranked as port-only locks, and deadck binds them."""
    findings, summary = deadck.check_modules(
        _port_mods(), ranks=manifest.LOCK_RANKS, declared=manifest.LOCK_EDGE_DECLARED,
        base_classes=manifest.DEADCK_BASE_CLASSES, thread_roots=manifest.DEADCK_THREAD_ROOTS)
    assert not [f for f in findings if "unnamed lock" in f.message]
    assert [f for f in findings if not f.waived] == []
    from distributed_sudoku_solver_tpu_torch.parallel import mesh

    for lock, name in ((cuda_build._build_lock, "ops.cuda_build"),
                       (mesh._virtual_lock, "parallel.mesh")):
        assert lock.name == name and name in lock_manifest.PORT_ONLY_LOCKS
    # The compile watch's hooks run under the build lock: a predicted
    # edge, rank-upward.
    assert ["ops.cuda_build", "obs.compilewatch"] in summary["predicted"]


def test_build_lock_is_witnessed_under_the_megastep_lock(monkeypatch):
    """The runtime half: a first load from inside the megastep flight's
    lock (where a flight first launches K2) is rank-upward under the
    strict witness, and so are the watch's hooks under the build lock."""
    from distributed_sudoku_solver_tpu_torch.obs import compilewatch

    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "lib_path",
                        lambda name, variant="": Path(torch.__file__).parent / "lib" / "libc10.so")
    monkeypatch.setattr(cuda_build, "_build", lambda targets: {"fused_step": 1.0})
    megastep = lockdep.named_lock("serving.megastep")
    with lockdep.installed(lockdep.manifest_witness(strict=True)) as w, \
            compilewatch.installed(compilewatch.CompileWatch(warmup_s=3600.0)):
        with megastep:
            cuda_build.load("fused_step")
    assert w.violations == []
    edges = set(w.graph())
    assert ("serving.megastep", "ops.cuda_build") in edges
    assert ("ops.cuda_build", "obs.compilewatch") in edges
    report, _ = run(rules=("deadck",))
    assert edges <= {tuple(e) for e in report["deadck"]["predicted"]}


def test_phantom_edges_are_name_resolution_artefacts():
    """The JAX manifest's run reported edges from ``native.build`` and
    ``utils.profile_window`` into the serving locks.  They come from the
    name-index fallback binding ``subprocess.run`` (the native build) to
    the profile window's nested ``run``, and ``thread.start()`` to
    ``SolverEngine.start`` / ``ClusterNode.start``.  Without the declared
    stdlib receivers they come back; with them the graph has none."""
    hints = dict(manifest.DEADCK_BASE_CLASSES)
    for stdlib in ("subprocess", "thread", "proc"):
        assert hints.pop(stdlib)[0] == "<stdlib>"
    kw = dict(ranks=manifest.LOCK_RANKS, declared=manifest.LOCK_EDGE_DECLARED,
              thread_roots=manifest.DEADCK_THREAD_ROOTS)
    mods = _port_mods()
    bare, _ = deadck.check_modules(mods, base_classes=hints, **kw)
    phantom = [f for f in bare if "lock-order edge" in f.message and not f.waived]
    assert any("'native.build'" in f.message and "'serving.engine'" in f.message for f in phantom)
    assert any("'utils.profile_window'" in f.message for f in phantom)
    hinted, summary = deadck.check_modules(mods, base_classes=manifest.DEADCK_BASE_CLASSES, **kw)
    assert not [f for f in hinted if "lock-order edge" in f.message]
    assert not [e for e in summary["predicted"] if e[0] in ("native.build", "utils.profile_window")
                and e[1].startswith(("serving.", "cluster."))]


# -- kernelck ------------------------------------------------------------------


def test_kernelck_golden_matches_the_sources():
    golden = kernelck.load_golden(kernelck.GOLDEN_PATH)["libraries"]
    assert golden == kernelck.library_digests()
    assert set(golden) == {cuda_build.lib_name(s, v) for s, v in manifest.KERNEL_LIBRARIES}
    assert set(manifest.COMPILED_PROGRAMS) == set(golden) | {manifest.NATIVE_LIBRARY}


def test_kernelck_drift_fixture_names_the_rebuilt_libraries(tmp_path, monkeypatch):
    """An edited ``cover.cu`` changes the digests of ``cover`` and its
    counter build and of nothing else; the finding says so until the
    golden is blessed with ``--update-golden``."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    (csrc / "cover.cu").write_text((csrc / "cover.cu").read_text() + "\n// an edit\n")
    golden = tmp_path / "kernelck.json"
    shutil.copy(kernelck.GOLDEN_PATH, golden)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    findings, summary = kernelck.check_kernels([], golden_path=golden)
    assert summary["drifted"] == ["cover", "cover_clocks"]
    assert sorted(f.message.split(" digest")[0] for f in findings) == [
        "kernel drift: library cover", "kernel drift: library cover_clocks"]
    findings, summary = kernelck.check_kernels([], golden_path=golden, update_golden=True)
    assert findings == [] and summary["golden_written"]
    assert kernelck.check_kernels([], golden_path=golden) == (
        [], {**summary, "golden_written": False, "drifted": []})
    # A library missing from the golden, and a golden entry with no library.
    doc = json.loads(golden.read_text())
    doc["libraries"].pop("propagate")
    doc["libraries"]["retired_kernel"] = "0" * 16
    golden.write_text(json.dumps(doc))
    msgs = [f.message for f in kernelck.check_kernels([], golden_path=golden)[0]]
    assert any(m.startswith("propagate: no committed golden") for m in msgs)
    assert any(m.startswith("retired_kernel: golden entry has no registered") for m in msgs)


def test_kernelck_dtype_fixtures():
    from typing import NamedTuple

    class State(NamedTuple):
        top: torch.Tensor
        nodes: torch.Tensor
        steps: torch.Tensor

    good = (State(torch.zeros(2, 4, 4, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
                  torch.zeros((), dtype=torch.int32)), torch.zeros(8, dtype=torch.int32))
    assert kernelck.dtype_problems(good) == []
    bad = (State(torch.zeros(2, 4, 4, dtype=torch.int64), torch.zeros(2, dtype=torch.int64),
                 torch.zeros((), dtype=torch.float64)), torch.zeros(8, dtype=torch.int32))
    problems = kernelck.dtype_problems(bad)
    assert problems == ["mask field [0].top is int64, not int32",
                        "[0].nodes is int64 (returned state is int32 or bool)",
                        "[0].steps is float64"]


def test_kernelck_static_float64_fixture(tmp_path):
    src = ("import torch\n\ndef f(x):\n    y = x.to(torch.float64)\n"
           "    return y.double(), torch.int32\n")
    mod = module(tmp_path, manifest.KERNELCK_HOT_SOURCES[0], src)
    findings, _ = kernelck.check_kernels([mod])
    assert sorted((f.line, f.message.split(" in a")[0]) for f in findings) == [
        (4, "torch.float64"), (5, ".double()")]


def test_kernelck_runs_every_advance_program_clean():
    findings, summary = kernelck.check_kernels(_port_mods())
    assert findings == [], [f.render() for f in findings]
    assert summary["programs"] == [e["display"] for e in manifest.ADVANCE_PROGRAMS]
    assert summary["drifted"] == []


# -- the runner ------------------------------------------------------------------


def test_runner_refuses_empty_scan_root(tmp_path, capsys):
    assert main(["--root", str(tmp_path / "nope")]) == exitcodes.EXIT_INTERNAL
    capsys.readouterr()


def test_waiver_without_reason_stays_a_violation(tmp_path):
    mod = module(tmp_path, "w.py", "import time as _t\n\n\ndef f():\n    _t.sleep(1)  # clockck: allow()\n")
    findings = _clock(mod)
    assert len(findings) == 1 and not findings[0].waived and "no reason" in findings[0].message


def test_def_level_waiver_covers_the_function(tmp_path):
    mod = module(tmp_path, "w.py", "import time as _t\n\n\n"
                 "def f():  # clockck: allow(whole function is a declared simulator)\n"
                 "    _t.sleep(1)\n    _t.sleep(2)\n")
    findings = _clock(mod)
    assert len(findings) == 2 and all(f.waived for f in findings)


def test_stale_waiver_reported_and_used_waiver_is_not(tmp_path):
    mod = module(tmp_path, "w.py", "import time as _t\n\n\ndef f():\n"
                 "    _t.sleep(1)  # clockck: allow(declared simulator pace)\n"
                 "    x = 1  # clockck: allow(left behind after a refactor)\n    return x\n")
    assert [f.waived for f in _clock(mod)] == [True]
    assert stale_waivers([mod], ("clockck",)) == [
        ("w.py", 6, "clockck", "left behind after a refactor")]
    assert stale_waivers([mod], ("lockck",)) == []


def test_strict_waivers_gates_the_exit_code(tmp_path, capsys):
    (tmp_path / "w.py").write_text("x = 1  # kernelck: allow(rule never fires here)\n")
    root = str(tmp_path)
    assert main(["--root", root]) == exitcodes.EXIT_CLEAN  # kernelck did not run
    (tmp_path / "w.py").write_text("x = 1  # clockck: allow(rule never fires here)\n")
    assert main(["--root", root]) == exitcodes.EXIT_CLEAN
    assert main(["--root", root, "--strict-waivers"]) == exitcodes.EXIT_VIOLATIONS
    assert main(["--root", root, "--rule", "lockck", "--strict-waivers"]) == exitcodes.EXIT_CLEAN
    assert "stale-waiver" in capsys.readouterr().out


def test_update_golden_requires_kernelck(capsys):
    assert main(["--update-golden"]) == exitcodes.EXIT_INTERNAL
    capsys.readouterr()


def test_usage_error_exits_internal(capsys):
    assert main(["--rule", "jaxck"]) == exitcodes.EXIT_INTERNAL
    assert main(["--rule", "nosuchrule"]) == exitcodes.EXIT_INTERNAL
    capsys.readouterr()


def test_runner_exit_codes_per_rule_over_fixtures(capsys):
    root = str(FIXTURES)
    assert main(["--root", root]) == exitcodes.EXIT_VIOLATIONS
    assert main(["--root", root, "--rule", "lockck"]) == exitcodes.EXIT_VIOLATIONS
    assert main(["--root", root, "--rule", "layerck"]) == exitcodes.EXIT_CLEAN
    capsys.readouterr()


def test_runner_json_is_deterministic():
    a = json.dumps(run()[0], indent=2, sort_keys=True)
    b = json.dumps(run()[0], indent=2, sort_keys=True)
    assert a == b


def test_runner_clean_over_the_port_without_torch_or_jax():
    """The acceptance pin: the five fast rules over the port's tree exit 0
    in a fresh process that never imports torch, jax or the JAX package.
    Measured at about 3 s alone on a 2-core container; the budget leaves
    room for a loaded test run."""
    code = (
        "import sys\n"
        "from distributed_sudoku_solver_tpu_torch.analysis.__main__ import main\n"
        "rc = main(['--json'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('torch', 'jax', 'jaxlib', 'distributed_sudoku_solver_tpu')]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n"
    )
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    elapsed = time.monotonic() - t0
    assert proc.returncode == exitcodes.EXIT_CLEAN, (proc.stdout[-4000:], proc.stderr[-4000:])
    report = json.loads(proc.stdout)
    assert set(report["rules"]) == set(RULES)
    assert all(r["violations"] == [] for r in report["rules"].values()), report
    for r in report["rules"].values():
        for w in r["waived"]:
            assert w["reason"].strip()
    assert report["deadck"]["predicted"]
    assert report["files_scanned"] == len(list(PKG.rglob("*.py")))
    assert elapsed < 15.0, f"analysis run took {elapsed:.1f}s"


def test_all_six_rules_clean_with_strict_waivers(capsys):
    args = ["--strict-waivers"] + [a for r in ALL_RULES for a in ("--rule", r)]
    assert main(args) == exitcodes.EXIT_CLEAN, capsys.readouterr()
    report, _ = run(rules=ALL_RULES)
    assert report["stale_waivers"] == []
    assert report["kernelck"]["drifted"] == [] and report["kernelck"]["programs"] == 5
    capsys.readouterr()


# -- manifest pins ----------------------------------------------------------------


def _qualnames(path: Path) -> set:
    names = set()

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                q = f"{prefix}.{child.name}" if prefix else child.name
                names.add(q)
                walk(child, q)
            else:  # a def nested in a with / if / try block keeps its prefix
                walk(child, prefix)

    walk(ast.parse(path.read_text()), "")
    return names


@pytest.mark.parametrize("table", ["SYNC_HOT_REGIONS", "DEADCK_THREAD_ROOTS", "CLOCK_SEAMS"])
def test_every_region_and_root_names_real_code(table):
    for rel, quals in getattr(manifest, table).items():
        names = _qualnames(PKG / rel)
        for q in quals:
            assert q in names, (table, rel, q)
    for rel in manifest.SYNC_SCOPED_FILES + manifest.KERNELCK_HOT_SOURCES:
        assert (PKG / rel).exists(), rel


def test_layers_name_real_modules():
    for key in manifest.LAYERS:
        path = PKG.joinpath(*key.split("."))
        assert path.is_dir() or path.with_suffix(".py").exists(), key


def test_manifest_tables_shared_with_the_jax_package():
    assert manifest.LOCK_RANKS is lock_manifest.LOCK_RANKS  # one source
    assert manifest.LOCK_EDGE_DECLARED is lock_manifest.LOCK_EDGE_DECLARED
    assert manifest.SIMNET_RUNTIME_BANNED == jmanifest.SIMNET_RUNTIME_BANNED
    assert manifest.CLOCK_BANNED_CALLS == jmanifest.CLOCK_BANNED_CALLS
    assert set(manifest.CLOCK_SEAMS) == set(jmanifest.CLOCK_SEAMS)
    assert {("time", "sleep"), ("time", "monotonic")} <= set(manifest.SIMNET_RUNTIME_BANNED)


def test_program_registry_covers_the_builds_and_advances():
    libs = set(manifest.KERNEL_LIBRARIES)
    assert set(cuda_build.TARGETS) <= libs
    assert all(v in cuda_build.VARIANTS for _, v in libs)
    for entry in manifest.ADVANCE_PROGRAMS:
        modpath, attr = entry["fn"].split(":")
        assert callable(getattr(importlib.import_module(modpath), attr))
    # The JAX watch's advance programs, under the same display names.
    jax_advances = {
        "utils.checkpoint.advance_frontier_status", "ops.pallas_step.advance_frontier_fused_status",
        "ops.frontier.advance_megastep", "ops.pallas_step.advance_megastep_fused",
        "parallel.mesh_resident.mesh_advance_status",
    }
    assert {e["display"] for e in manifest.ADVANCE_PROGRAMS} == {
        jmanifest.DISPLAY_BY_NAME[name] for name in jax_advances}


# -- the ck family and traceck ------------------------------------------------------


def test_ck_family_shares_one_exit_code_scheme():
    for mod in (traceck, promck):
        assert (mod.EXIT_CLEAN, mod.EXIT_VIOLATIONS, mod.EXIT_INTERNAL) == (0, 1, 2)
    assert (exitcodes.EXIT_CLEAN, exitcodes.EXIT_VIOLATIONS, exitcodes.EXIT_INTERNAL) == (0, 1, 2)


TRACE_DOCS = [
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 5},
                     {"name": "b", "ph": "X", "pid": 1, "tid": 1, "ts": 3, "dur": 1},
                     {"name": "m", "ph": "M", "pid": 1, "tid": 1}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 9, "dur": 1},
                     {"name": "b", "ph": "X", "pid": 1, "tid": 1, "ts": 3, "dur": -1}]},
    {"traceEvents": [{"name": "", "ph": "Q", "pid": "x", "tid": 1}, 7]},
    [1, 2],
    {"events": []},
]


@pytest.mark.parametrize("doc", TRACE_DOCS, ids=range(len(TRACE_DOCS)))
def test_traceck_equals_the_jax_validator(doc, tmp_path, capsys):
    assert traceck.check(doc) == jtraceck.check(doc)
    path = tmp_path / "t.json"
    path.write_text(json.dumps(doc))
    assert traceck.main([str(path)]) == jtraceck.main([str(path)])
    assert traceck.main([]) == exitcodes.EXIT_INTERNAL
    assert traceck.main([str(tmp_path / "missing.json")]) == exitcodes.EXIT_INTERNAL
    capsys.readouterr()
