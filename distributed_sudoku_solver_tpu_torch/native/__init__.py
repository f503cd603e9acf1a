"""ctypes bindings for the native CPU oracle and loader (``src/*.cc``).

A copy of the JAX package's ``native`` module; ``src/solver.cc`` and
``src/loader.cc`` are its sources byte for byte.  The shared library is
built with ``g++`` at first use (plain C ABI + ctypes), into ``_build/``
beside the package (git ignores it), under a name keyed by a hash of the
sources, the flags and the machine's architecture, so an edited source
never loads a stale library.  The compiler writes a temporary file named by
process and thread, which is then renamed into place: threads and processes
building at once (test workers, request threads) never load a partial
file.  Within a process one lock (``native.build``) serialises the build.
An installed compile watch (``obs/compilewatch.py``) hears of the build,
with its seconds, and of the library's first load, as ``libcsp``.

Without a compiler, :func:`available` is False and callers take the
pure-Python oracle (``utils/oracle.py``), as in the JAX package: this is a
CPU accelerator of host work, not a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry, geometry_for_size
from distributed_sudoku_solver_tpu_torch.obs import compilewatch, lockdep

SRC_DIR = Path(__file__).resolve().parent / "src"
#: The library's name in the compile watch's program registry.
PROGRAM = "libcsp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# x86-64-v2 carries POPCNT, which the cover DFS counts columns with; a
# library built here runs on any x86-64 host of the last decade.
_ARCH_FLAGS = ("-march=x86-64-v2",) if platform.machine() == "x86_64" else ()
FLAGS = ("-O3", *_ARCH_FLAGS, "-shared", "-fPIC", "-pthread")
_lock = lockdep.named_lock("native.build")  # lockck: name(native.build)
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
# Seconds the last build of this process took (None: loaded a built library).
build_seconds: Optional[float] = None


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cc"))


def lib_path() -> Path:
    h = hashlib.sha256(" ".join((platform.machine(), *FLAGS)).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcsp-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    """Compile to a temporary name of this process and thread, then rename:
    a concurrent build in another process finds either no library or a
    whole one."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}-{threading.get_ident()}.so")
    cmd = ["g++", *FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    build_seconds = time.perf_counter() - t0
    return True


def load() -> Optional[ctypes.CDLL]:
    """The bound library, building it if needed; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = lib_path()
        built = not path.exists()
        if built and not _build(path):
            _build_failed = True
            return None
        cw = compilewatch.active()
        if built and cw is not None:
            cw.on_build(PROGRAM, build_seconds)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.csp_solve.argtypes = [i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i64p]
        lib.csp_solve.restype = ctypes.c_int
        lib.csp_count_solutions.argtypes = [
            i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, i64p,
        ]
        lib.csp_count_solutions.restype = ctypes.c_int
        lib.csp_is_valid_solution.argtypes = [
            i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.csp_is_valid_solution.restype = ctypes.c_int
        lib.csp_solve_batch.argtypes = [
            i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.csp_solve_batch.restype = ctypes.c_int
        lib.csp_parse_boards.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, i32p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ]
        lib.csp_parse_boards.restype = ctypes.c_int64
        lib.csp_format_boards.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int, ctypes.c_char_p,
        ]
        lib.csp_format_boards.restype = ctypes.c_int64
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        lib.cover_count_solutions.argtypes = [
            u32p, u32p, u32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, i64p,
        ]
        lib.cover_count_solutions.restype = ctypes.c_int64
        _lib = lib
        if cw is not None:
            cw.on_load(PROGRAM, built=built)
        return _lib


def available() -> bool:
    return load() is not None


def _require(what: str = "solver") -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(f"native {what} unavailable (no compiler?)")
    return lib


def solve(grid, geom: Optional[Geometry] = None) -> Tuple[Optional[np.ndarray], int]:
    """(lexicographically-least solution | None, nodes expanded)."""
    lib = _require()
    g = np.ascontiguousarray(np.asarray(grid), dtype=np.int32).copy()
    n = g.shape[0]
    geom = geom or geometry_for_size(n)
    nodes = ctypes.c_int64(0)
    rc = lib.csp_solve(g.reshape(-1), n, geom.box_h, geom.box_w, ctypes.byref(nodes))
    if rc < 0:
        raise ValueError("malformed grid")
    return (g if rc == 1 else None), int(nodes.value)


def count_solutions(grid, geom: Optional[Geometry] = None, limit: int = 2) -> int:
    lib = _require()
    g = np.ascontiguousarray(np.asarray(grid), dtype=np.int32)
    n = g.shape[0]
    geom = geom or geometry_for_size(n)
    rc = lib.csp_count_solutions(g.reshape(-1), n, geom.box_h, geom.box_w, limit, None, None)
    if rc < 0:
        raise ValueError("malformed grid")
    return rc


def is_valid_solution(grid, geom: Optional[Geometry] = None) -> bool:
    lib = _require()
    g = np.ascontiguousarray(np.asarray(grid), dtype=np.int32)
    n = g.shape[0]
    geom = geom or geometry_for_size(n)
    return bool(lib.csp_is_valid_solution(g.reshape(-1), n, geom.box_h, geom.box_w))


def solve_batch(grids, geom: Optional[Geometry] = None):
    """Solve count boards in place; returns (solutions, results, nodes)."""
    lib = _require()
    g = np.ascontiguousarray(np.asarray(grids), dtype=np.int32).copy()
    count, n = g.shape[0], g.shape[1]
    geom = geom or geometry_for_size(n)
    results = np.zeros(count, dtype=np.int32)
    nodes = np.zeros(count, dtype=np.int64)
    lib.csp_solve_batch(
        g.reshape(-1), count, n, geom.box_h, geom.box_w,
        results.ctypes.data_as(ctypes.c_void_p), nodes.ctypes.data_as(ctypes.c_void_p),
    )
    return g, results, nodes


def parse_boards(data: bytes, n: int, max_boards: Optional[int] = None,
                 allow_header: bool = True, n_threads: int = 0) -> np.ndarray:
    """Parse newline-separated board lines (first CSV field) -> int32[B, n, n].

    Raises ValueError naming the first malformed line.  Blank/whitespace
    lines are skipped; with ``allow_header`` an unparseable *first* line is
    treated as a CSV header, otherwise it is an error (see src/loader.cc).
    """
    lib = _require("loader")
    # Newline count is a free upper bound on board lines; exact sizing
    # comes from the parse's return.
    upper = data.count(b"\n") + 1
    if max_boards is not None:
        upper = min(upper, int(max_boards))
    out = np.empty((max(upper, 1), n, n), dtype=np.int32)
    got = int(lib.csp_parse_boards(data, len(data), n, out.reshape(-1), upper,
                                   int(allow_header), n_threads))
    if got < 0:
        raise ValueError(f"malformed board at data line {-got - 1}")
    return out[:got]


def format_boards(boards) -> bytes:
    """int[B, n, n] -> newline-separated board lines (inverse of parse)."""
    lib = _require("loader")
    g = np.ascontiguousarray(np.asarray(boards), dtype=np.int32)
    if g.ndim != 3 or g.shape[1] != g.shape[2]:
        raise ValueError(f"expected [B, n, n] boards, got shape {g.shape}")
    count, n = g.shape[0], g.shape[1]
    if count == 0:
        return b""
    buf = ctypes.create_string_buffer(count * (n * n + 1))
    written = int(lib.csp_format_boards(g.reshape(-1), count, n, buf))
    return buf.raw[:written]


def cover_count(problem, limit: int = -1) -> Tuple[int, int]:
    """Count exact-cover solutions of an ``ExactCoverCSP`` natively.

    Runs the recursive MRV DFS in ``src/solver.cc`` over the same packed
    matrix the device engine searches (``col_rows``/``row_cols``/``elim``,
    numpy ``uint32`` already).  Returns ``(count, nodes)``; ``limit < 0``
    enumerates everything.
    """
    lib = _require()
    col_rows = np.ascontiguousarray(problem.col_rows, dtype=np.uint32)
    row_cols = np.ascontiguousarray(problem.row_cols, dtype=np.uint32)
    elim = np.ascontiguousarray(problem.elim, dtype=np.uint32)
    nodes = ctypes.c_int64(0)
    rc = lib.cover_count_solutions(
        col_rows.reshape(-1), row_cols.reshape(-1), elim.reshape(-1),
        problem.n_rows, problem.n_primary, elim.shape[1], row_cols.shape[1],
        limit, ctypes.byref(nodes),
    )
    if rc < 0:
        raise ValueError("malformed cover instance")
    return int(rc), int(nodes.value)
