"""The port's invariant manifest: the contracts the checkers prove.

The tables of the JAX package's ``analysis/manifest.py``, written for this
package's tree: its layers, clock seams, serving hot regions in torch
terms, lock hierarchy and thread roots.  In place of the JAX manifest's
``ENTRY_POINTS`` (jit programs) it holds the **program registry**: the
kernel libraries ``ops/cuda_build`` builds, the native oracle's library,
and the serving advance programs the cost plane prices.  The compile
watch (``obs/compilewatch.py``) attributes builds and loads to it, and
``kernelck`` checks its kernel sources against a committed golden and its
advance programs' dtypes.

Pure data: stdlib only.  The lock ranks have one source,
``obs/lock_manifest.py`` (which the runtime witness loads); they are
imported from there, not copied.
"""

from __future__ import annotations

from distributed_sudoku_solver_tpu_torch.obs.lock_manifest import (  # noqa: F401
    LOCK_EDGE_DECLARED,
    LOCK_RANKS,
)

# -- layerck -------------------------------------------------------------
#
# Keys are package-relative dotted module prefixes; the LONGEST matching
# prefix wins.  Closed layers allow stdlib + the listed internal prefixes
# + the listed third-party roots; open layers forbid the listed prefixes
# minus the ``except`` carve-outs.  The promises are the JAX manifest's,
# with the port's own additions noted.
LAYERS = {
    "obs": {"closed": True, "allow": ("obs",), "third_party": ()},
    # The compile watch reads the program registry below (one vocabulary
    # for the watch, kernelck and the cost seams); stdlib only otherwise.
    "obs.compilewatch": {
        "closed": True,
        "allow": ("obs", "analysis.manifest"),
        "third_party": (),
    },
    # serving.faults also imports ops.cuda_build's KernelError, to classify
    # a kernel that failed to build, load or launch as permanent;
    # ops.cuda_build is stdlib at import, so the layer stays light.
    "serving.faults": {
        "closed": True,
        "allow": ("obs.lockdep", "ops.cuda_build"),
        "third_party": (),
    },
    "cluster.wire": {"closed": True, "allow": (), "third_party": ()},
    "cluster.simnet": {
        "closed": True,
        "allow": ("cluster.wire", "serving.faults", "obs.lockdep"),
        "third_party": (),
    },
    "cluster.dht": {
        "closed": True,
        "allow": ("cluster.dht", "cluster.wire", "obs.lockdep"),
        "third_party": (),
    },
    # The checker's own layer: source-only tooling, stdlib + obs (the *ck
    # exit codes and the lock ranks).  Importing torch here would break the
    # default lane's "no torch" promise that tests/test_torch_analysis.py
    # pins.
    "analysis": {"closed": True, "allow": ("analysis", "obs"), "third_party": ()},
    # ...with ONE declared exception: kernelck is the lazy lane.  Its
    # drift pass reads ops.cuda_build (stdlib); its dtype pass imports
    # torch and the compute layers inside functions, behind
    # ``--rule kernelck``, which the default lane never runs.
    "analysis.kernelck": {
        "closed": True,
        "allow": (
            "analysis",
            "obs",
            "models.geometry",
            "ops",
            "parallel",
            "utils.checkpoint",
        ),
        "third_party": ("torch",),
    },
    "ops": {
        "closed": False,
        "forbid": ("serving", "cluster", "analysis"),
        "except": ("serving.faults",),
    },
    "models": {"closed": False, "forbid": ("serving", "cluster", "analysis")},
    "parallel": {"closed": False, "forbid": ("serving", "cluster", "analysis")},
    "utils": {"closed": False, "forbid": ("serving", "cluster", "analysis")},
    "native": {"closed": False, "forbid": ("serving", "cluster", "analysis")},
    # The ports of the two Mosaic probes: compute + their kernel wrappers.
    "probes": {"closed": False, "forbid": ("serving", "cluster", "analysis")},
    # The front door: host numpy, the obs planes, its serving siblings,
    # the geometry model and the native DFS; never cluster, never torch
    # (the whole point is answering without a device).
    "serving.frontdoor": {
        "closed": True,
        "allow": ("serving", "obs", "models.geometry", "native"),
        "third_party": ("numpy",),
    },
    "serving.brownout": {"closed": True, "allow": ("obs",), "third_party": ()},
    "serving.journal": {
        "closed": True,
        "allow": ("obs", "serving.faults"),
        "third_party": (),
    },
    # serving sits BELOW cluster (cluster/node.py imports serving.engine).
    "serving": {"closed": False, "forbid": ("cluster", "analysis")},
}

# -- clockck -------------------------------------------------------------
#
# Directories where bare wall-clock CALLS are banned; ``clock=...``
# defaults that reference them are the injection seam and pass.
CLOCK_SCOPED_DIRS = ("cluster", "serving", "obs")

CLOCK_BANNED_CALLS = (
    ("time", "time"),
    ("time", "time_ns"),
    ("time", "monotonic"),
    ("time", "monotonic_ns"),
    ("time", "perf_counter"),
    ("time", "perf_counter_ns"),
    ("time", "sleep"),
    ("datetime", "now"),
    ("datetime", "utcnow"),
)

# Declared seams: qualname prefixes (per package-relative file) whose
# bodies may touch the real clock.
CLOCK_SEAMS = {
    "cluster/wire.py": ("SystemClock",),
    "cluster/simnet.py": ("SimNet.sleep", "SimNet.advance", "SimNet.settle"),
}

# The runtime twin: the module attributes the simnet guard of
# tests/conftest.py patches to raise inside ``simnet``-marked tests (it
# covers the port's frames too).  A copy of the JAX list, held equal to it
# by tests/test_torch_analysis.py.
SIMNET_RUNTIME_BANNED = (
    ("socket", "socket"),
    ("socket", "create_connection"),
    ("socket", "create_server"),
    ("select", "select"),
    ("selectors", "DefaultSelector"),
    ("selectors", "SelectSelector"),
    ("selectors", "PollSelector"),
    ("selectors", "EpollSelector"),
    ("selectors", "KqueueSelector"),
    ("time", "sleep"),
    ("time", "monotonic"),
)

# -- syncck --------------------------------------------------------------
#
# Files under the "one host sync per chunk" contract, and within them the
# hot regions (qualname prefixes) where a device-to-host read must go
# through ``host_fetch`` (serving/engine.py), prove its operand host-side
# (the dataflow pass over host_fetch / unpack_status results) or carry a
# reasoned syncck waiver comment.  The fetch-count tests of
# tests/test_torch_status_pipeline.py are the runtime twin.
SYNC_SCOPED_FILES = (
    "serving/engine.py",
    "serving/scheduler.py",
    "ops/bulk.py",
    "ops/solve.py",
    "serving/portfolio.py",
    "serving/megastep.py",
    "serving/mesh_scheduler.py",
)

SYNC_HOT_REGIONS = {
    "serving/engine.py": (
        "SolverEngine._advance_flight",
        "SolverEngine._resolve_solved",
        "SolverEngine._do_snapshot",
        "SolverEngine._do_shed",
    ),
    # The round bodies and the strategy hooks that run inside them (the
    # mesh flight overrides the hooks).
    "serving/scheduler.py": (
        "ResidentFlight.step",
        "ResidentFlight._consume_status",
        "ResidentFlight._collect_and_detach",
        "ResidentFlight._attach_pending",
        "ResidentFlight._advance",
        "ResidentFlight._unpack",
        "ResidentFlight._init_state",
        "ResidentFlight._attach_state",
        "ResidentFlight._detach_state",
        "ResidentFlight._verdict_state",
        "ResidentFlight._rebase_state",
        "ResidentFlight._advance_state",
    ),
    "ops/bulk.py": (
        "_solve_bulk.run_chunk",
        "_solve_bulk.run_rung_stepped",
        "_solve_bulk.drain",
    ),
    "serving/portfolio.py": (
        "race_jobs",
        "race_cover.device_entrant",
    ),
    # The megastep's one-fetch-per-flight contract: admission to verdict
    # runs inside these two bodies.
    "serving/megastep.py": (
        "MegastepFlight.solve",
        "MegastepFlight._fly_locked",
    ),
    "serving/mesh_scheduler.py": (
        "MeshResidentFlight._unpack",
        "MeshResidentFlight._init_state",
        "MeshResidentFlight._attach_state",
        "MeshResidentFlight._detach_state",
        "MeshResidentFlight._verdict_state",
        "MeshResidentFlight._rebase_state",
        "MeshResidentFlight._advance_state",
    ),
}

# Functions whose BODY is the seam (exempt): host_fetch, and the one
# transfer it makes of a tuple of tensors.
SYNC_SEAM_FUNCS = ("host_fetch", "_tensors_to_host")
SYNC_HOST_SOURCES = (
    "host_fetch",
    "unpack_status",
    "unpack_mesh_status",
    # The flight's strategy hook: unpack_status or unpack_mesh_status over
    # a word host_fetch already copied.
    "_unpack",
    # The megastep's flight body: it returns the payload of the flight's
    # one host_fetch, so what solve() unpacks from it is host data.
    "_fly_locked",
)

# numpy-module calls that copy a tensor to the host (a sync on a CUDA
# tensor).
SYNC_NUMPY_CALLS = ("asarray", "ascontiguousarray", "array")
# Tensor methods that read a value on the host, and the two explicit sync
# points (``torch.cuda.synchronize()``, ``Event.synchronize()``).
SYNC_METHOD_CALLS = ("item", "tolist", "cpu", "numpy", "synchronize")
# ``bool()`` / ``int()`` / ``float()`` of a tensor, checked in hot regions.
SYNC_SCALAR_CASTS = ("bool", "int", "float")
# Attribute reads that are host metadata of a tensor, never a sync
# (``int(x.shape[0])``).
SYNC_METADATA_ATTRS = ("shape", "dtype", "device", "ndim")

# -- the program registry ------------------------------------------------
#
# A "compile" in the port is a kernel library built by nvcc
# (``ops/cuda_build.build``, one per source digest) and loaded with ctypes
# (``ops/cuda_build.load``), or the native oracle's library built by g++
# and loaded (``native/__init__.py``).  The port runs no torch.compile, no
# torch.jit and no CUDA graph.

#: The CUDA kernel libraries: every ``ops/cuda_build.TARGETS`` source, plus
#: the ``clocks`` counter builds the stage breakdowns load, as (source,
#: variant).  A library's name is ``cuda_build.lib_name``'s (a test holds
#: COMPILED_PROGRAMS to it; this module cannot import ops.cuda_build, which
#: reaches it through the compile watch).
KERNEL_LIBRARIES = (
    ("propagate", ""),
    ("fused_step", ""),
    ("cover", ""),
    ("probe_uint16", ""),
    ("probe_cover", ""),
    ("fused_step", "clocks"),
    ("cover", "clocks"),
)


#: The native oracle and loader's shared library (g++).
NATIVE_LIBRARY = "libcsp"

#: Every program the compile watch attributes a build or a load to.
COMPILED_PROGRAMS = tuple(
    f"{s}_{v}" if v else s for s, v in KERNEL_LIBRARIES
) + (NATIVE_LIBRARY,)

# The serving advance programs the cost plane prices: the JAX constant
# names, pointed at the port's functions.
ADVANCE_STATUS = "utils.checkpoint.advance_frontier_status"
ADVANCE_FUSED_STATUS = "ops.cuda_step.advance_frontier_fused_status"
ADVANCE_MEGASTEP = "ops.frontier.advance_megastep"
ADVANCE_MEGASTEP_FUSED = "ops.cuda_step.advance_megastep_fused"
MESH_ADVANCE_STATUS = "parallel.mesh_resident.mesh_advance_status"

ADVANCE_PROGRAMS = (
    dict(name=ADVANCE_STATUS, display="advance_status",
         fn="distributed_sudoku_solver_tpu_torch.utils.checkpoint:advance_frontier_status",
         config="config"),
    dict(name=ADVANCE_FUSED_STATUS, display="advance_fused_status",
         fn="distributed_sudoku_solver_tpu_torch.ops.cuda_step:advance_frontier_fused_status",
         config="config_fused"),
    dict(name=ADVANCE_MEGASTEP, display="advance_megastep",
         fn="distributed_sudoku_solver_tpu_torch.ops.frontier:advance_megastep",
         config="config_gang"),
    dict(name=ADVANCE_MEGASTEP_FUSED, display="advance_megastep_fused",
         fn="distributed_sudoku_solver_tpu_torch.ops.cuda_step:advance_megastep_fused",
         config="config_gang_fused"),
    dict(name=MESH_ADVANCE_STATUS, display="mesh_advance_status",
         fn="distributed_sudoku_solver_tpu_torch.parallel.mesh_resident:mesh_advance_status",
         config="config_mesh"),
)

DISPLAY_BY_NAME = {e["name"]: e["display"] for e in ADVANCE_PROGRAMS}

# -- kernelck ------------------------------------------------------------
#
# The canonical tiny shapes the dtype pass runs each advance program at,
# on the CPU (the kernels' plain versions): 4x4 boards, 8 lanes, 4-deep
# stacks, two rounds a chunk.
KERNELCK_CANON = {
    "geom": (2, 2),
    "chunk_steps": 2,
    "max_chunks": 2,
    "slots": 2,
    "configs": {
        "config": {"lanes": 8, "min_lanes": 8, "stack_slots": 4, "max_steps": 64},
        "config_fused": {
            "lanes": 8, "min_lanes": 8, "stack_slots": 4, "max_steps": 64,
            "step_impl": "fused", "fused_steps": 2,
        },
        "config_gang": {
            "lanes": 8, "min_lanes": 8, "stack_slots": 4, "max_steps": 64,
            "steal_gang": 4,
        },
        "config_gang_fused": {
            "lanes": 8, "min_lanes": 8, "stack_slots": 4, "max_steps": 64,
            "steal_gang": 4, "step_impl": "fused", "fused_steps": 2,
        },
        "config_mesh": {
            "lanes": 8, "min_lanes": 8, "stack_slots": 4, "max_steps": 64,
            "steal_gang": 4, "protect_home_lanes": True,
        },
    },
}

# dtypes banned in any tensor an advance program returns, and in the
# source of the hot programs (``torch.float64`` / ``torch.double`` /
# ``.double()`` in KERNELCK_HOT_SOURCES).
KERNELCK_BANNED_DTYPES = ("float64", "complex128")
KERNELCK_HOT_SOURCES = (
    "ops/bitmask.py",
    "ops/cuda_propagate.py",
    "ops/cuda_step.py",
    "ops/frontier.py",
    "ops/propagate.py",
    "parallel/mesh_resident.py",
    "utils/checkpoint.py",
)
# Candidate-mask fields of the frontier: int32 exactly (bit patterns read
# as uint32; the kernels' ABI).
KERNELCK_MASK_FIELDS = ("top", "stack", "solution")
# Every tensor an advance program returns (the loop-carried frontier and
# the status word) is one of these.  int64 index tensors are told apart by
# scope, not by name: torch indexes with int64, so the programs widen
# indices (``.long()``) and uint32 arithmetic (``ops/bitmask.py``) to int64
# inside a call, and an int64 tensor in the returned state is a finding.
KERNELCK_STATE_DTYPES = ("int32", "bool")

# -- deadck --------------------------------------------------------------
#
# The lock hierarchy (LOCK_RANKS, LOCK_EDGE_DECLARED) is imported above
# from obs/lock_manifest.py.

# Receiver hints for deadck's call/lock resolution: the receiver
# expression (as written) -> the (file, class) whose methods/locks it
# denotes.
DEADCK_BASE_CLASSES = {
    "engine": ("serving/engine.py", "SolverEngine"),
    "self.engine": ("serving/engine.py", "SolverEngine"),
    "self.server.engine": ("serving/engine.py", "SolverEngine"),
    "self.node": ("cluster/node.py", "ClusterNode"),
    "node": ("cluster/node.py", "ClusterNode"),
    "ex": ("cluster/node.py", "_Exec"),
    "rf": ("serving/scheduler.py", "ResidentFlight"),
    "flight": ("serving/scheduler.py", "ResidentFlight"),
    "mrf": ("serving/mesh_scheduler.py", "MeshResidentFlight"),
    "mf": ("serving/megastep.py", "MegastepFlight"),
    "self.breaker": ("serving/faults.py", "CircuitBreaker"),
    "req": ("serving/engine.py", "_Control"),
    "self._dedupe": ("cluster/node.py", "_DedupeLRU"),
    "self._net": ("cluster/simnet.py", "SimNet"),
    "net": ("cluster/simnet.py", "SimNet"),
    "mon": ("obs/slo.py", "SloMonitor"),
    "rec": ("obs/trace.py", "TraceRecorder"),
    "cw": ("obs/compilewatch.py", "CompileWatch"),
    "cp": ("obs/critpath.py", "CritPathMonitor"),
    "self.frontdoor": ("serving/frontdoor/router.py", "FrontDoor"),
    "self.cache": ("serving/frontdoor/cache.py", "ResultCache"),
    "fd": ("serving/frontdoor/router.py", "FrontDoor"),
    "ctrl": ("serving/brownout.py", "BrownoutController"),
    "self.ctrl": ("serving/brownout.py", "BrownoutController"),
    "bo": ("serving/brownout.py", "BrownoutController"),
    "self.gossip": ("cluster/dht/membership.py", "Gossip"),
    "g": ("cluster/dht/membership.py", "Gossip"),
    "self.ring": ("cluster/dht/hashring.py", "HashRing"),
    "self.dcache": ("cluster/dht/cluster_cache.py", "ClusterCache"),
    "self.l2": ("cluster/node.py", "_L2Adapter"),
    "self._schedule": ("serving/faults.py", "FaultSchedule"),
    "jr": ("serving/journal.py", "Journal"),
    "self.journal": ("serving/journal.py", "Journal"),
    # Stdlib receivers, never this package's classes.  Without a hint the
    # name-index fallback binds ``subprocess.run`` (the native and kernel
    # builds) to the profile window's nested ``run`` and ``thread.start()``
    # (the profile window's own thread) to ``SolverEngine.start`` /
    # ``ClusterNode.start``: phantom edges from native.build and
    # utils.profile_window into the serving locks.  An empty class has no
    # methods, so these receivers resolve to nothing.
    "subprocess": ("<stdlib>", "subprocess"),
    "thread": ("<stdlib>", "threading.Thread"),
    "proc": ("<stdlib>", "subprocess.Popen"),
}

# The port's thread roots: qualname prefixes (per file) whose bodies run on
# their own threads.  The JAX manifest's roots, plus the port's own: the
# mesh flight's any-thread surfaces, and the sharded and bulk entry
# points, which HTTP handler threads (``/solve_batch``), the CLI's
# ``solve-file`` and the device loop (a ``--sharded`` node's solve_fn)
# call concurrently.
DEADCK_THREAD_ROOTS = {
    "serving/engine.py": (
        "SolverEngine._run",
        "SolverEngine.submit",
        "SolverEngine.cancel",
    ),
    "serving/http.py": ("_Handler",),
    "cluster/node.py": (
        "ClusterNode._hb_loop",
        "ClusterNode._progress_loop",
        "ClusterNode._broadcast_send",
        "ClusterNode._flush_parked",
        "ClusterNode._handle",
        "ClusterNode.submit",
        "_Exec._watch_local",
    ),
    "cluster/wire.py": (
        "TcpTransport._accept_loop",
        "TcpTransport._serve_conn",
        "fanout_requests",
    ),
    "cluster/simnet.py": (
        "SimNet._worker",
        "SimNet._overflow_worker",
    ),
    "cluster/dht/cluster_cache.py": ("ClusterCache._put_loop",),
    "serving/portfolio.py": ("race", "race_cover", "race_jobs"),
    "serving/megastep.py": ("MegastepFlight.solve",),
    "serving/mesh_scheduler.py": (
        "MeshResidentFlight.metrics",
        "MeshResidentFlight.admission_pressure",
    ),
    "serving/journal.py": ("Journal._fsync_loop",),
    "serving/brownout.py": ("BrownoutController.evaluate",),
    "utils/profiling.py": ("start_profile_window.run",),
    "utils/dataset.py": ("solve_file",),
    "ops/bulk.py": ("solve_bulk", "_solve_bulk"),
    "parallel/sharded.py": ("solve_batch_sharded", "solve_csp_sharded"),
    "parallel/fused_sharded.py": ("solve_batch_fused_sharded", "solve_csp_fused_sharded"),
    "parallel/board_sharded.py": ("solve_batch_banded",),
}
