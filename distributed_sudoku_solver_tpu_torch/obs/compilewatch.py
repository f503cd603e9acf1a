"""The compile/recompile watch of the port, and its cost plane.

The JAX package's ``obs/compilewatch.py`` watches XLA compilations.  The
port compiles no graph at run time (no torch.compile, no torch.jit, no
CUDA graph); what it builds and loads while serving are its kernel
libraries, so a "compile" here is:

* an nvcc build of a CUDA kernel library (``ops/cuda_build.build``, one
  per source digest) or the g++ build of the native oracle's library
  (``native/__init__.py``): reported with the builder's own seconds;
* the first ``ctypes`` load of such a library in this process
  (``ops/cuda_build.load``, ``native.load``): the moment a kernel is
  first used, whether it was built now or found built on disk.

The JAX watch's contract carries over:

* **Attribution.**  Each event names its library, so attribution is
  direct: a registered program (``analysis/manifest.COMPILED_PROGRAMS``:
  every kernel library, the counter builds, ``libcsp``) or
  ``unregistered``.  Counts are exact; walls are the builder's seconds.
  The ``cache`` counters read the on-disk build directory as the
  persistent cache: a build is a miss, a first load that needed no build
  is a hit.
* **Warmup, then alarm.**  Events inside the warmup window (``warmup_s``
  after construction, or until :meth:`CompileWatch.seal`) are expected: a
  booting node builds and loads its serving set once.  After it, ANY
  build or first load is an *unexpected recompile*: one
  ``[compile <program>]`` log line, a per-program ``recompiles`` counter,
  a trace event, and, edge-triggered, exactly ONE flight-recorder dump
  (``trace.active().dump("recompile", ...)``) per excursion.  The alarm
  re-arms after ``rearm_s`` seconds with no further recompile.
* **Cost plane.**  The serving loops call :meth:`capture_cost` once per
  (program, shape) at flight birth.  JAX prices a round from
  ``Lowered.cost_analysis()``, which costs a ``while`` body once; the
  port has no lowering to ask, so the cost is a **static model of one
  round with one fixpoint sweep**, from the shape alone
  (``ops/cost.advance_round_cost``: lanes, ``n``, rules; the same op
  counts ``chip_smoke.py`` bounds its kernels with).  It counts int32
  operations, not floating-point ones, and says so (``"unit":
  "int32_ops"``); the JAX field names (``flops``, ``bytes_accessed``,
  ``flops_per_round``, ``achieved_gflops_per_s``, ``peak_gflops``) are
  kept so ``obs/agg.py`` and ``obs/prom.py`` read either package's
  section.  ``peak_gflops`` (the CLI's ``--peak-gflops``) is then read as
  G int32 ops/s.  :meth:`efficiency` prices the engine's measured
  rounds/s with it, and keeps the JAX suppression on mixed shapes.

**Hot-path contract** (the trace/slo/faults pattern): the build and load
paths reach the watch through :func:`active` — with no watch installed,
one global read and one branch — and the cached fast path of
``cuda_build.load`` (a library already loaded) reaches nothing.  Nothing
here reads a device value: **zero added host syncs** (the fetch-count
tests run with the watch installed).  A hook that raises is a bug and is
not swallowed; the watch observes and never changes what is built, loaded
or launched.

Stdlib + sibling ``obs`` modules + the pure-data ``analysis.manifest``
registry.  Clock-injectable (``clock=``) so the warmup and re-arm edges
are deterministic under test.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Iterable, Optional

from distributed_sudoku_solver_tpu_torch.analysis import manifest
from distributed_sudoku_solver_tpu_torch.obs import lockdep, trace
from distributed_sudoku_solver_tpu_torch.obs.hist import LatencyHistogram
from distributed_sudoku_solver_tpu_torch.obs.logctx import ctx_log

_LOG = logging.getLogger(__name__)

#: The two kinds of compile event.
BUILD = "build"
LOAD = "load"

#: The cost plane's unit: integer operations of the kernels' bit algebra.
UNIT = "int32_ops"

#: The serving advance programs the cost seams name (the JAX constant
#: names, pointed at the port's functions: ``analysis/manifest.py``).
ADVANCE_STATUS = manifest.ADVANCE_STATUS
ADVANCE_FUSED_STATUS = manifest.ADVANCE_FUSED_STATUS
ADVANCE_MEGASTEP = manifest.ADVANCE_MEGASTEP
ADVANCE_MEGASTEP_FUSED = manifest.ADVANCE_MEGASTEP_FUSED
MESH_ADVANCE_STATUS = manifest.MESH_ADVANCE_STATUS

#: The attribution bucket for a library no registered program names.
UNREGISTERED = "unregistered"


def display_name(entry_name: str) -> str:
    """The short display name of an advance program (the manifest's)."""
    return manifest.DISPLAY_BY_NAME.get(entry_name, entry_name.rsplit(".", 1)[-1])


class CompileWatch:
    """Per-library build and load accounting plus the post-warmup alarm.

    ``programs`` is the registered display names (default: every
    ``manifest.COMPILED_PROGRAMS`` library); ``warmup_s`` is the expected
    window after construction (``seal()`` ends it early); ``rearm_s`` is
    the quiet period after which the one-dump-per-excursion alarm
    re-arms; ``peak_gflops`` (operator-supplied, in G int32 ops/s) turns
    the achieved-rate gauge into a ratio against the cost model's
    ceiling.  All timing through the injectable ``clock``.
    """

    def __init__(
        self,
        programs: Optional[Iterable[str]] = None,
        warmup_s: float = 300.0,
        rearm_s: float = 300.0,
        peak_gflops: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._clock = clock
        self.rearm_s = float(rearm_s)
        self.peak_gflops = peak_gflops
        self._lock = lockdep.named_lock("obs.compilewatch")  # lockck: name(obs.compilewatch)
        self._programs = frozenset(
            manifest.COMPILED_PROGRAMS if programs is None else programs
        )
        self.builds: dict = {}  # display -> builds
        self.loads: dict = {}  # display -> first loads
        self.recompiles: dict = {}  # display -> post-warmup events
        self.wall: dict = {}  # display -> LatencyHistogram (build wall)
        self.wall_ms_total: dict = {}  # display -> float
        self.cache_events = {"persistent_cache_hits": 0, "persistent_cache_misses": 0}
        self.compiles_total = 0
        self.recompiles_total = 0
        self.dumps = 0
        now = self._clock()
        self.installed_at = now
        self._warmup_until = now + max(0.0, float(warmup_s))
        self._armed = True  # the edge trigger: one dump per excursion
        self._last_unexpected: Optional[float] = None
        # Cost plane: display -> {flops, bytes_accessed, unit, ...meta};
        # the seen-set bounds the model to once per (program, shape).
        self.costs: dict = {}
        self.cost_keys: set = set()
        self.cost_errors = 0

    # -- warmup / alarm edges -------------------------------------------------
    def seal(self) -> None:
        """End the warmup window now: every later build or first load is
        an unexpected recompile."""
        with self._lock:
            self._warmup_until = self._clock()

    def warmup_over(self) -> bool:
        return self._clock() >= self._warmup_until

    # -- the event feed (from ops/cuda_build and native) ---------------------
    def on_build(self, program: str, seconds: float) -> None:
        """A library was built (the builder's own ``seconds``)."""
        with self._lock:
            self.cache_events["persistent_cache_misses"] += 1
            actions = self._note_locked(program, BUILD, float(seconds))
        self._run_actions(actions)

    def on_load(self, program: str, built: bool = False) -> None:
        """A library was loaded for the first time in this process;
        ``built`` says whether this load had to build it first (that
        build was reported by :meth:`on_build`)."""
        with self._lock:
            if not built:
                self.cache_events["persistent_cache_hits"] += 1
            actions = self._note_locked(program, LOAD, None)
        self._run_actions(actions)

    def _note_locked(self, program: str, kind: str, dur_s: Optional[float]) -> list:
        name = program if program in self._programs else UNREGISTERED
        t = self._clock()
        per_kind = self.builds if kind == BUILD else self.loads
        per_kind[name] = per_kind.get(name, 0) + 1
        self.compiles_total += 1
        if dur_s is not None:
            hist = self.wall.get(name)
            if hist is None:
                hist = self.wall[name] = LatencyHistogram()
            hist.record(dur_s)
            self.wall_ms_total[name] = self.wall_ms_total.get(name, 0.0) + dur_s * 1e3
        if t < self._warmup_until:
            return []
        # Post-warmup: an unexpected recompile.  Re-arm first (recovery =
        # rearm_s of quiet since the last one), then edge-trigger.
        self._rearm_locked(t)
        self.recompiles[name] = self.recompiles.get(name, 0) + 1
        self.recompiles_total += 1
        self._last_unexpected = t
        fire_dump = self._armed
        if fire_dump:
            self._armed = False
            self.dumps += 1
        payload = {
            "program": name,
            "library": program,
            "kind": kind,
            "wall_ms": None if dur_s is None else round(dur_s * 1e3, 3),
            "recompiles": dict(self.recompiles),
            "counts": {n: self._count(n) for n in set(self.builds) | set(self.loads)},
        }
        return [(name, fire_dump, payload)]

    def _count(self, name: str) -> int:
        """Builds plus first loads of ``name`` since install."""
        return int(self.builds.get(name, 0) + self.loads.get(name, 0))

    def _rearm_locked(self, now: float) -> None:
        if (
            not self._armed
            and self._last_unexpected is not None
            and now - self._last_unexpected >= self.rearm_s
        ):
            self._armed = True
            ctx_log(_LOG, "compile", "watch").info(
                "recompile alarm re-armed after %.0fs quiet", self.rearm_s
            )

    def _run_actions(self, actions: list) -> None:
        """Log, trace and dump OUTSIDE the watch lock: the dump re-enters
        the recorder."""
        for name, fire_dump, payload in actions:
            ctx_log(_LOG, "compile", name).warning(
                "unexpected %s after warmup (wall %s ms) — %s",
                payload["kind"],
                payload["wall_ms"],
                "flight-recorder dump triggered"
                if fire_dump
                else "alarm already fired this excursion",
            )
            rec = trace.active()
            if rec is None:
                continue
            rec.event(
                None, "compile", f"library.{payload['kind']}", program=name,
                wall_ms=payload["wall_ms"],
            )
            if fire_dump:
                rec.dump("recompile", metrics=payload)

    # -- the cost plane -------------------------------------------------------
    def capture_cost(self, name: str, key, cost_thunk, **meta) -> None:
        """Record the cost model of one advance program at one live shape.

        ``name`` is the program's registry name; ``key`` dedupes per
        (program, shape) so the model runs once per shape ever;
        ``cost_thunk()`` returns ``{"flops": int32 ops per round,
        "bytes_accessed": bytes per round}`` from the shape alone (host
        arithmetic, no device read).  Never raises: a cost model is
        evidence, not a dependency."""
        full_key = (name,) + tuple(key)
        with self._lock:
            if full_key in self.cost_keys:
                return
            self.cost_keys.add(full_key)
        disp = display_name(name)
        try:
            cm = cost_thunk() or {}
            cost = {
                "flops": float(cm.get("flops", 0.0)),
                "bytes_accessed": float(cm.get("bytes_accessed", 0.0)),
                "unit": UNIT,
            }
        except Exception as e:  # noqa: BLE001 - see docstring
            with self._lock:
                self.cost_errors += 1
            _LOG.debug("[compilewatch] cost capture failed for %s: %r", disp, e)
            return
        entry = {**cost, **meta}
        with self._lock:
            # Latest captured shape wins the entry; the shape COUNT rides
            # along so the gauge can refuse to price mixed shapes.
            entry["shapes_captured"] = sum(1 for k in self.cost_keys if k[0] == name)
            self.costs[disp] = entry

    def efficiency(self, name: str, rounds: int, wall_s: float) -> Optional[dict]:
        """The live device-efficiency gauge: the measured serving rate
        (frontier rounds/s from the engine's chunk totals) priced by the
        per-round cost model; with ``peak_gflops`` (G int32 ops/s) the
        ratio against the model's ceiling rides along.

        Honest only for shape-homogeneous serving: once more than one
        shape of the program has been captured, the gauge is suppressed
        (``suppressed: mixed_shapes``), as in the JAX watch."""
        disp = display_name(name)
        with self._lock:
            cost = self.costs.get(disp)
        if cost is None or rounds <= 0 or wall_s <= 0:
            return None
        if cost.get("shapes_captured", 1) > 1:
            return {
                "program": disp,
                "suppressed": "mixed_shapes",
                "shapes_captured": int(cost["shapes_captured"]),
            }
        flops = cost.get("flops", 0.0)
        rounds_per_s = rounds / wall_s
        out = {
            "program": disp,
            "unit": UNIT,
            "flops_per_round": flops,
            "achieved_rounds_per_s": round(rounds_per_s, 3),
            "achieved_gflops_per_s": round(flops * rounds_per_s / 1e9, 6),
        }
        if self.peak_gflops:
            out["peak_gflops"] = float(self.peak_gflops)
            if flops > 0:
                # The model's ceiling: rounds/s if the device did nothing
                # but this program at its peak int32 rate.
                ceiling = self.peak_gflops * 1e9 / flops
                out["ceiling_rounds_per_s"] = round(ceiling, 3)
                out["device_efficiency"] = round(rounds_per_s / ceiling, 6)
        return out

    # -- reads ----------------------------------------------------------------
    def metrics(self) -> dict:
        with self._lock:
            now = self._clock()
            self._rearm_locked(now)
            programs = {}
            for name in sorted(set(self.builds) | set(self.loads) | set(self.recompiles)):
                rec: dict = {
                    "count": self._count(name),
                    "builds": int(self.builds.get(name, 0)),
                    "loads": int(self.loads.get(name, 0)),
                }
                if self.recompiles.get(name):
                    rec["recompiles"] = int(self.recompiles[name])
                if name in self.wall_ms_total:
                    rec["wall_ms_total"] = round(self.wall_ms_total[name], 3)
                if name in self.wall:
                    rec["wall_ms"] = self.wall[name].to_dict()
                programs[name] = rec
            return {
                "programs": programs,
                "registered": len(self._programs),
                "compiles_total": int(self.compiles_total),
                "recompiles_total": int(self.recompiles_total),
                "warmup_over": now >= self._warmup_until,
                "armed": self._armed,
                "dumps": int(self.dumps),
                "cache": dict(self.cache_events),
            }

    def cost_metrics(self) -> Optional[dict]:
        with self._lock:
            if not self.costs and not self.cost_errors:
                return None
            out: dict = {"programs": {k: dict(v) for k, v in self.costs.items()}}
            if self.cost_errors:
                out["errors"] = int(self.cost_errors)
            return out


# -- the process-wide seam ----------------------------------------------------
#
# Mirrors obs/trace.py and obs/slo.py: uninstalled, each build or first
# load costs one global read and one branch.

_active: Optional[CompileWatch] = None


def install(watch: Optional[CompileWatch]) -> None:
    global _active
    _active = watch


def active() -> Optional[CompileWatch]:
    return _active


@contextlib.contextmanager
def installed(watch: CompileWatch):
    """Scope a watch over a block (tests): always uninstalls."""
    install(watch)
    try:
        yield watch
    finally:
        install(None)
