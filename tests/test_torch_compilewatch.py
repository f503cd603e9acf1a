"""The port's compile watch (``obs/compilewatch.py``) and its cost plane.

Twins of the eight cases of ``tests/test_compilewatch.py`` on the port's
seams, where a "compile" is a kernel library's build or first load:

* unit lane, on a fake clock with fake build and load events: attribution
  (counts exact, walls the builder's, unregistered libraries bucketed),
  events racing a scrape from several threads, the mixed-shape
  suppression of the efficiency gauge, the edge-triggered dump and its
  re-arm, ``seal``;
* live lane, a ``device="cpu"`` engine under the watch: the cost plane
  prices the advance program and the gauge reads a device efficiency; a
  forced first load of a library after warmup (through the real
  ``ops/cuda_build.load`` seam, a shared library standing in for an nvcc
  output) fires exactly one recompile dump, re-armed after recovery;
* microcheck: with nothing installed the watch is unreachable.

Then the sections' shape against the JAX watch's on the same synthetic
events (``obs/agg.py`` and ``obs/prom.py`` take either), and the hooks in
``ops/cuda_build`` and ``native``: one event per build and per first load,
none on the cached path, a raising hook not swallowed, a ``KernelError``
still permanent.
"""

import json
import logging
import os
import threading
from pathlib import Path

import pytest
import torch

from distributed_sudoku_solver_tpu.obs import compilewatch as jcompilewatch
from distributed_sudoku_solver_tpu_torch import native
from distributed_sudoku_solver_tpu_torch.analysis import manifest
from distributed_sudoku_solver_tpu_torch.obs import agg, compilewatch, critpath, lockdep, prom, promck, trace
from distributed_sudoku_solver_tpu_torch.ops import cuda_build
from distributed_sudoku_solver_tpu_torch.ops.cost import advance_round_cost, round_ops, sweep_ops
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
from distributed_sudoku_solver_tpu_torch.utils.puzzles import EASY_9, HARD_9

SMALL = SolverConfig(min_lanes=8, stack_slots=16)
# A shared library every torch install carries: it stands in for an nvcc
# output, so the real load path runs on a machine without nvcc.
STAND_IN = Path(torch.__file__).parent / "lib" / "libc10.so"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean_seams():
    with lockdep.installed(lockdep.manifest_witness(strict=True)) as w:
        yield
    compilewatch.install(None)
    critpath.install(None)
    trace.install(None)
    assert w.violations == [], w.violations


@pytest.fixture
def fake_nvcc(monkeypatch):
    """``cuda_build`` with no nvcc: every library path is the stand-in,
    nothing is loaded yet, and ``_build`` reports ``built`` (library ->
    seconds) for the targets it is asked for, then finds them built."""
    built: dict = {}
    calls: list = []
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "_failed", {})
    monkeypatch.setattr(cuda_build, "lib_path", lambda name, variant="": STAND_IN)

    def fake_build(targets):
        out = {}
        for name, variant in targets:
            lib = cuda_build.lib_name(name, variant)
            calls.append(lib)
            if lib in built:
                out[lib] = built.pop(lib)
        return out

    monkeypatch.setattr(cuda_build, "_build", fake_build)
    return built, calls


# -- unit lane -----------------------------------------------------------------


def test_attribution_counts_walls_and_unregistered():
    t = [0.0]
    w = compilewatch.CompileWatch(programs={"prog_a", "prog_b"}, warmup_s=100.0,
                                  clock=lambda: t[0])
    w.on_build("prog_a", 0.5)
    w.on_load("prog_a", built=True)
    w.on_load("prog_b")
    w.on_build("prog_b", 0.125)
    w.on_build("prog_b", 0.25)
    m = w.metrics()
    assert m["programs"]["prog_a"] == {
        "count": 2, "builds": 1, "loads": 1, "wall_ms_total": 500.0,
        "wall_ms": m["programs"]["prog_a"]["wall_ms"],
    }
    assert m["programs"]["prog_b"]["count"] == 3
    assert m["programs"]["prog_b"]["builds"] == 2 and m["programs"]["prog_b"]["loads"] == 1
    assert m["programs"]["prog_b"]["wall_ms_total"] == pytest.approx(375.0)
    assert sum(m["programs"]["prog_b"]["wall_ms"]["counts"]) == 2
    assert m["compiles_total"] == 5 and m["recompiles_total"] == 0
    assert m["registered"] == 2
    # A load that needed no build is a hit of the on-disk cache; a build
    # is a miss.
    assert m["cache"] == {"persistent_cache_hits": 1, "persistent_cache_misses": 3}
    # A library no registered program names lands in `unregistered`.
    w.on_load("probe_cover_clocks")
    m = w.metrics()
    assert m["programs"][compilewatch.UNREGISTERED]["loads"] == 1
    assert m["compiles_total"] == 6
    assert compilewatch.CompileWatch().metrics()["registered"] == len(manifest.COMPILED_PROGRAMS)


def test_events_racing_a_scrape_never_misattribute(tmp_path):
    """The JAX watch pairs events with cache growth and must survive a
    scrape racing an insertion; here events name their library, so the
    race to pin is threads reporting at once while ``/metrics`` scrapes:
    counts stay exact, every event lands on its own library, and a storm
    after warmup costs one dump."""
    t = [0.0]
    rec = trace.TraceRecorder(clock=lambda: t[0], dump_dir=str(tmp_path))
    libs = ["propagate", "fused_step", "cover", "probe_uint16"]
    w = compilewatch.CompileWatch(warmup_s=10.0, clock=lambda: t[0])
    stop = threading.Event()
    scrapes = []

    def scrape():
        while not stop.is_set():
            scrapes.append(w.metrics()["compiles_total"])

    def report(lib):
        for _ in range(50):
            w.on_load(lib)
            w.on_build(lib, 0.001)

    with trace.installed(rec):
        s = threading.Thread(target=scrape)
        s.start()
        workers = [threading.Thread(target=report, args=(lib,)) for lib in libs]
        for th in workers:
            th.start()
        for th in workers:
            th.join()
        t[0] = 20.0  # warmup over: a storm of post-warmup events
        workers = [threading.Thread(target=report, args=(lib,)) for lib in libs]
        for th in workers:
            th.start()
        for th in workers:
            th.join()
        stop.set()
        s.join()
    m = w.metrics()
    assert scrapes == sorted(scrapes)  # every scrape a consistent prefix
    for lib in libs:
        assert m["programs"][lib]["count"] == 200
        assert m["programs"][lib]["recompiles"] == 100
    assert compilewatch.UNREGISTERED not in m["programs"]
    assert m["recompiles_total"] == 400 and m["dumps"] == 1
    assert len([f for f in os.listdir(tmp_path) if "recompile" in f]) == 1


def test_efficiency_suppressed_on_mixed_shapes():
    w = compilewatch.CompileWatch(programs=(), warmup_s=1e9, peak_gflops=1000.0)
    name = compilewatch.ADVANCE_FUSED_STATUS
    w.capture_cost(name, (9, 128), lambda: advance_round_cost(SUDOKU_9, 128, "basic"),
                   geometry="9x9")
    # The key dedupes: a second capture of the same shape is a no-op.
    w.capture_cost(name, (9, 128), lambda: 1 / 0, geometry="9x9")
    eff = w.efficiency(name, rounds=1000, wall_s=1.0)
    ops = 128 * (sweep_ops(SUDOKU_9, "basic") + round_ops(SUDOKU_9))
    assert eff["flops_per_round"] == ops and eff["unit"] == "int32_ops"
    assert eff["achieved_gflops_per_s"] == pytest.approx(ops * 1000 / 1e9)
    assert eff["device_efficiency"] == pytest.approx(ops * 1000 / 1000e9, rel=1e-3)
    w.capture_cost(name, (16, 256), lambda: advance_round_cost(SUDOKU_9, 256, "basic"),
                   geometry="16x16")
    assert w.efficiency(name, rounds=1000, wall_s=1.0) == {
        "program": "advance_fused_status",
        "suppressed": "mixed_shapes",
        "shapes_captured": 2,
    }
    # A model that raises is counted, never raised.
    w.capture_cost(compilewatch.ADVANCE_STATUS, (9, 8), lambda: 1 / 0)
    assert w.cost_metrics()["errors"] == 1


def test_warmup_edge_triggered_dump_and_rearm(tmp_path, caplog):
    t = [0.0]
    rec = trace.TraceRecorder(clock=lambda: t[0], dump_dir=str(tmp_path))
    w = compilewatch.CompileWatch(programs={"prog_a"}, warmup_s=10.0, rearm_s=60.0,
                                  clock=lambda: t[0])

    def dumps():
        return [f for f in os.listdir(tmp_path) if "recompile" in f]

    with trace.installed(rec):
        w.on_build("prog_a", 0.1)  # inside warmup: expected, no alarm
        w.on_load("prog_a", built=True)
        assert w.metrics()["recompiles_total"] == 0
        t[0] = 20.0
        with caplog.at_level(logging.WARNING):
            w.on_load("prog_a")
        assert any("[compile prog_a]" in r.getMessage() for r in caplog.records)
        m = w.metrics()
        assert m["recompiles_total"] == 1 and m["programs"]["prog_a"]["recompiles"] == 1
        assert m["dumps"] == 1 and m["armed"] is False
        assert len(dumps()) == 1
        doc = json.loads((tmp_path / dumps()[0]).read_text())
        assert doc["metrics"]["program"] == "prog_a" and doc["metrics"]["kind"] == "load"
        t[0] = 30.0  # same excursion: counted, not dumped
        w.on_build("prog_a", 0.2)
        assert w.metrics()["recompiles_total"] == 2 and len(dumps()) == 1
        t[0] = 30.0 + 61.0  # recovery re-arms; the next excursion dumps
        assert w.metrics()["armed"] is True
        w.on_load("prog_a")
        assert len(dumps()) == 2
        assert any(s["name"] == "compile" for s in rec.spans())


def test_seal_ends_warmup_immediately():
    t = [0.0]
    w = compilewatch.CompileWatch(programs={"prog_a"}, warmup_s=1e9, clock=lambda: t[0])
    assert not w.warmup_over()
    w.seal()
    assert w.warmup_over()
    w.on_load("prog_a")
    assert w.metrics()["recompiles_total"] == 1


# -- live lane -----------------------------------------------------------------


def test_live_workload_exports_per_program_counts_and_cost():
    """A CPU engine under the watch: ``/metrics`` has the compile section
    at the registry's size, and the cost plane prices the advance program
    at the flight's shape with a live efficiency gauge."""
    watch = compilewatch.CompileWatch(warmup_s=3600.0, peak_gflops=100.0)
    with compilewatch.installed(watch):
        eng = SolverEngine(config=SMALL, max_batch=8, chunk_steps=4, device="cpu").start()
        try:
            j = eng.submit(HARD_9[1])
            assert j.wait(180) and j.solved, j.error
            m = eng.metrics()
        finally:
            eng.stop(timeout=2)
    sec = m["compile"]
    assert sec["registered"] == len(manifest.COMPILED_PROGRAMS)
    assert sec["recompiles_total"] == 0 and sec["armed"] is True
    for name in sec["programs"]:
        assert name == compilewatch.UNREGISTERED or name in manifest.COMPILED_PROGRAMS
    cost = m["cost"]["programs"]["advance_status"]
    assert cost["unit"] == "int32_ops" and cost["geometry"] == "9x9"
    assert cost["flops"] == advance_round_cost(SUDOKU_9, cost["lanes"], "basic")["flops"] > 0
    assert cost["bytes_accessed"] > 0 and cost["shapes_captured"] == 1
    eff = m["cost"]["efficiency"]
    assert eff["program"] == "advance_status" and eff["achieved_gflops_per_s"] > 0
    assert eff["peak_gflops"] == 100.0 and 0 < eff["device_efficiency"] < 1
    assert promck.check_text(prom.render(m)) == []


def test_forced_first_load_fires_exactly_one_recompile_dump(tmp_path, fake_nvcc):
    """After warmup, a library's first load (through ``cuda_build.load``)
    is an unexpected recompile: exactly one ``recompiles`` increment, one
    log line, one dump, while the engine serves on.  A storm of first
    loads costs one dump; after a quiet ``rearm_s`` the next one dumps
    again."""
    built, _ = fake_nvcc
    t = [0.0]
    rec = trace.TraceRecorder(dump_dir=str(tmp_path))
    watch = compilewatch.CompileWatch(warmup_s=100.0, rearm_s=60.0, clock=lambda: t[0])

    def dumps():
        return [f for f in os.listdir(tmp_path) if "recompile" in f]

    with trace.installed(rec), compilewatch.installed(watch):
        eng = SolverEngine(config=SMALL, max_batch=8, chunk_steps=8, device="cpu").start()
        try:
            built["propagate"] = 2.5
            cuda_build.load("propagate")  # warmup: expected
            j = eng.submit(EASY_9)
            assert j.wait(180) and j.solved, j.error
            m = watch.metrics()
            assert m["recompiles_total"] == 0
            assert m["programs"]["propagate"]["wall_ms_total"] == 2500.0
            t[0] = 200.0
            logs = []
            handler = logging.Handler()
            handler.emit = lambda r: logs.append(r.getMessage())
            logging.getLogger(compilewatch.__name__).addHandler(handler)
            try:
                cuda_build.load("cover")
            finally:
                logging.getLogger(compilewatch.__name__).removeHandler(handler)
            m = watch.metrics()
            assert m["recompiles_total"] == 1 and m["programs"]["cover"]["recompiles"] == 1
            assert len([x for x in logs if "[compile cover]" in x]) == 1
            assert len(dumps()) == 1 and m["armed"] is False
            cuda_build.load("cover")  # cached: no event
            assert watch.metrics()["recompiles_total"] == 1
            for lib in ("probe_uint16", "probe_cover"):  # the same excursion
                cuda_build.load(lib)
            assert watch.metrics()["recompiles_total"] == 3 and len(dumps()) == 1
            j = eng.submit(HARD_9[1])
            assert j.wait(180) and j.solved, j.error
            t[0] = 200.0 + 61.0
            assert watch.metrics()["armed"] is True
            cuda_build.load("fused_step", "clocks")
            assert len(dumps()) == 2
        finally:
            eng.stop(timeout=2)


# -- microcheck ----------------------------------------------------------------


def test_disabled_seams_are_one_global_read(monkeypatch, fake_nvcc):
    """With no watch installed, neither a serving solve nor a library's
    build and first load reaches any of the watch's surfaces."""
    assert compilewatch.active() is None

    def boom(*a, **k):  # pragma: no cover - failure path
        raise AssertionError("compile watch reached while disabled")

    for meth in ("on_build", "on_load", "capture_cost", "metrics", "cost_metrics"):
        monkeypatch.setattr(compilewatch.CompileWatch, meth, boom)
    built, _ = fake_nvcc
    built["cover"] = 1.0
    cuda_build.load("cover")
    eng = SolverEngine(config=SMALL, max_batch=8, chunk_steps=4, device="cpu").start()
    try:
        j = eng.submit(HARD_9[1])
        assert j.wait(180) and j.solved, j.error
        m = eng.metrics()
        assert "compile" not in m and "cost" not in m
    finally:
        eng.stop(timeout=2)


# -- the sections against the JAX watch's ----------------------------------------


class _FakeProg:
    def __init__(self):
        self.n = 0

    def _cache_size(self):
        return self.n


class _Lowered:
    def cost_analysis(self):
        return {"flops": 100.0, "bytes accessed": 10.0}


def _jax_sections():
    ev = jcompilewatch.BACKEND_COMPILE_EVENT
    a = _FakeProg()
    w = jcompilewatch.CompileWatch(programs={"prog_a": a}, warmup_s=0.0,
                                   peak_gflops=1000.0, clock=lambda: 5.0)
    w.on_duration(ev, 0.5)
    a.n += 1
    w.on_duration(ev, 0.25)
    a.n += 1
    w.capture_cost(jcompilewatch.ADVANCE_FUSED_STATUS, (9, 128), _Lowered, geometry="9x9")
    return w.metrics(), w.cost_metrics(), w.efficiency(
        jcompilewatch.ADVANCE_FUSED_STATUS, 1000, 1.0)


def _port_sections():
    w = compilewatch.CompileWatch(programs={"prog_a"}, warmup_s=0.0, peak_gflops=1000.0,
                                  clock=lambda: 5.0)
    w.on_build("prog_a", 0.5)
    w.on_build("prog_a", 0.25)
    w.capture_cost(compilewatch.ADVANCE_FUSED_STATUS, (9, 128),
                   lambda: {"flops": 100.0, "bytes_accessed": 10.0}, geometry="9x9")
    return w.metrics(), w.cost_metrics(), w.efficiency(
        compilewatch.ADVANCE_FUSED_STATUS, 1000, 1.0)


def test_compile_sections_equal_the_jax_watch_in_shape():
    """The same synthetic compiles and cost fed to both watches: equal
    top-level key sets of ``metrics()`` and ``cost_metrics()``, the JAX
    per-program and efficiency keys all present in the port's (which adds
    ``builds`` / ``loads`` and the ``unit``), equal numbers where both
    count the same thing, and the port's ``agg`` and ``prom`` take either
    package's section."""
    (jm, jc, je), (pm, pc, pe) = _jax_sections(), _port_sections()
    assert set(jm) == set(pm)
    assert set(jm["programs"]["prog_a"]) <= set(pm["programs"]["prog_a"])
    assert set(pm["programs"]["prog_a"]) - set(jm["programs"]["prog_a"]) == {"builds", "loads"}
    for k in ("count", "recompiles", "wall_ms_total"):
        assert jm["programs"]["prog_a"][k] == pm["programs"]["prog_a"][k], k
    for k in ("compiles_total", "recompiles_total", "warmup_over", "armed", "dumps"):
        assert jm[k] == pm[k], k
    assert set(jm["cache"]) == set(pm["cache"])
    assert set(jc) == set(pc) and set(jc["programs"]) == set(pc["programs"])
    jp, pp = jc["programs"]["advance_fused_status"], pc["programs"]["advance_fused_status"]
    assert set(pp) - set(jp) == {"unit"} and set(jp) <= set(pp)
    assert set(pe) - set(je) == {"unit"} and set(je) <= set(pe)
    for k in je:
        assert je[k] == pe[k], k
    for m, c in ((jm, jc), (pm, pc)):
        body = {"compile": m, "cost": c}
        ru = agg.rollup([body, body])
        assert ru["compile"]["programs"]["prog_a"]["count"] == 4
        assert ru["compile"]["programs"]["prog_a"]["wall_ms_total"] == pytest.approx(1500.0)
        assert ru["compile"]["recompiles_total"] == 4
        assert promck.check_text(prom.render(body)) == []
        assert promck.check_text(prom.render(ru)) == []


# -- the hooks in ops/cuda_build and native ---------------------------------------


def test_cuda_build_reports_each_build_and_first_load_once(fake_nvcc, monkeypatch):
    built, calls = fake_nvcc
    watch = compilewatch.CompileWatch(warmup_s=3600.0)
    with compilewatch.installed(watch):
        built["fused_step"] = 42.0
        assert cuda_build.build((("fused_step", ""),)) == {"fused_step": 42.0}
        cuda_build.load("fused_step")  # built on disk already: a load, a hit
        built["cover"] = 7.0
        cuda_build.load("cover")  # built by this load: a build, then a load
        n_calls = len(calls)

        def boom(*a, **k):  # pragma: no cover - the cached path must not reach it
            raise AssertionError("cached load reached the watch")

        monkeypatch.setattr(watch, "on_load", boom)
        cuda_build.load("cover")
        cuda_build.load("fused_step")
        assert len(calls) == n_calls  # no build attempted either
    m = watch.metrics()
    assert m["programs"]["fused_step"] == {
        "count": 2, "builds": 1, "loads": 1, "wall_ms_total": 42000.0,
        "wall_ms": m["programs"]["fused_step"]["wall_ms"],
    }
    assert m["programs"]["cover"]["builds"] == 1 and m["programs"]["cover"]["loads"] == 1
    assert m["cache"] == {"persistent_cache_hits": 1, "persistent_cache_misses": 2}


def test_raising_hook_is_not_swallowed_and_kernel_error_stays_permanent(fake_nvcc, monkeypatch):
    """A watch hook that raises is a bug: the load path raises it instead
    of hiding it.  A build that fails raises ``KernelError``, again on the
    next call without a second build, and reaches no watch."""
    class Broken(compilewatch.CompileWatch):
        def on_load(self, program, built=False):
            raise RuntimeError("hook bug")

    with compilewatch.installed(Broken(warmup_s=0.0)):
        with pytest.raises(RuntimeError, match="hook bug"):
            cuda_build.load("propagate")
    _, calls = fake_nvcc

    def failing(targets):
        calls.append("failing")
        raise cuda_build.KernelError("nvcc cover.cu failed (1)")

    monkeypatch.setattr(cuda_build, "_build", failing)
    watch = compilewatch.CompileWatch(warmup_s=0.0)
    with compilewatch.installed(watch):
        for _ in range(2):
            with pytest.raises(cuda_build.KernelError, match="nvcc cover.cu failed"):
                cuda_build.load("cover")
    assert calls.count("failing") == 1
    assert watch.metrics()["compiles_total"] == 0


def test_native_build_and_first_load_reported_as_libcsp(tmp_path, monkeypatch):
    """``native.load`` reports its g++ build with the build's seconds and
    the first load, as ``libcsp``; the cached path reports nothing."""
    if not native.available():
        pytest.skip("no C++ compiler to build the native library")
    real = native.lib_path()
    target = tmp_path / real.name
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "lib_path", lambda: target)

    def fake_build(path):
        path.write_bytes(real.read_bytes())
        native.build_seconds = 3.0
        return True

    monkeypatch.setattr(native, "_build", fake_build)
    watch = compilewatch.CompileWatch(warmup_s=3600.0)
    with compilewatch.installed(watch):
        assert native.load() is not None
        assert native.load() is not None
    rec = watch.metrics()["programs"][native.PROGRAM]
    assert rec["builds"] == 1 and rec["loads"] == 1 and rec["wall_ms_total"] == 3000.0
    assert native.PROGRAM in manifest.COMPILED_PROGRAMS
