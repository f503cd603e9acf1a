"""Build and load the package's CUDA kernels (nvcc -> .so -> ctypes).

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, for ``sm_90a`` (Hopper).  The build runs at first use,
into ``_build/`` beside this package (git ignores it), under a name keyed
by a hash of the sources and flags, so an edited source never loads a stale
library.  :func:`build` starts one ``nvcc`` per target, all at once, and
keeps ptxas's register / shared-memory / spill report beside each library.
A target is a source and a variant: ``""`` is the library the package
runs; ``"clocks"`` compiles the same source with ``-DDSST_STAGE_CLOCKS``
(per-stage ``clock64()`` counters, ``csrc/fixpoint.cuh`` for K1 and K2,
``csrc/cover.cu`` for K3) into a library of its own name, which only the
stage breakdowns load.  ``probe_uint16`` and ``probe_cover`` are the
ports of the two Mosaic probes (``probes/``).
Nothing here runs when the module is imported.  Building and loading are
serialised by one process-wide lock (``ops.cuda_build`` in the lock
hierarchy): a server launches kernels from its device loop and from its
request threads, and the first use of a library may come from two of them
at once.  Every failure to build, load or launch a kernel raises
:class:`KernelError`, and a failed build is not tried again in the same
process.  An installed compile watch (``obs/compilewatch.py``) hears of
each build, with its seconds, and of each library's first load; the
cached path of :func:`load` reaches no watch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

from distributed_sudoku_solver_tpu_torch.obs import compilewatch, lockdep

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("propagate", "fused_step", "cover", "probe_uint16", "probe_cover")
HEADERS = ("fixpoint.cuh",)
VARIANTS = {"": (), "clocks": ("-DDSST_STAGE_CLOCKS",)}
TARGETS = tuple((name, "") for name in SOURCES)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[tuple[str, str], ctypes.CDLL] = {}
# A library's path -> why it could not be built or loaded.
_failed: dict[Path, str] = {}
# Re-entrant: ``load`` holds it across its own call of ``build``.
_build_lock = lockdep.named_rlock("ops.cuda_build")  # lockck: name(ops.cuda_build)


class KernelError(RuntimeError):
    """A kernel of this package failed to build, load or launch.  No retry
    and no other step implementation can mend that, so the serving layers
    classify it as permanent (``serving.faults``) and never fall back to a
    plain version to hide it."""


def nvcc_path() -> str:
    """The CUDA compiler, from PATH or the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "distributed_sudoku_solver_tpu_torch cannot be built"
    )


def _flags(variant: str) -> tuple[str, ...]:
    return NVCC_FLAGS + VARIANTS[variant]


def _digest(name: str, variant: str) -> str:
    h = hashlib.sha256(" ".join(_flags(variant)).encode())
    for f in (f"{name}.cu", *HEADERS):
        h.update(f.encode())
        h.update((CSRC_DIR / f).read_bytes())
    return h.hexdigest()[:16]


def lib_name(name: str, variant: str = "") -> str:
    """The library's name: the source's, with ``_<variant>`` for a variant."""
    return f"{name}_{variant}" if variant else name


def lib_path(name: str, variant: str = "") -> Path:
    return BUILD_DIR / f"lib{lib_name(name, variant)}-{_digest(name, variant)}.so"


def ptxas_report(name: str, variant: str = "") -> str:
    """ptxas's per-kernel resource lines from the build of ``name``."""
    log = lib_path(name, variant).with_suffix(".ptxas.txt")
    return log.read_text() if log.exists() else ""


def build(targets=TARGETS) -> dict[str, float]:
    """Compile every ``(source, variant)`` target not built yet, all nvcc
    processes started together; returns each library's seconds from the
    start to its own nvcc's exit.  Temporary outputs are named by process
    and thread, so no two threads ever write one file."""
    with _build_lock:
        seconds = _build(targets)
        cw = compilewatch.active()
        if cw is not None:
            for lib, s in seconds.items():
                cw.on_build(lib, s)
        return seconds


def _build(targets) -> dict[str, float]:
    todo = [t for t in targets if not lib_path(*t).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, variant in todo:
        tmp = lib_path(name, variant).with_suffix(
            f".tmp{os.getpid()}-{threading.get_ident()}.so")
        log = tmp.with_suffix(".log")
        cmd = [nvcc, *_flags(variant), "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        with open(log, "w") as out:
            procs[name, variant] = (tmp, log, subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT))
    # Each library's own seconds: poll until every nvcc has exited.
    seconds: dict[str, float] = {}
    while len(seconds) < len(procs):
        for (name, variant), (_, _, proc) in procs.items():
            if lib_name(name, variant) not in seconds and proc.poll() is not None:
                seconds[lib_name(name, variant)] = time.perf_counter() - t0
        time.sleep(0.05)
    errors = []
    for (name, variant), (tmp, log, proc) in procs.items():
        out = log.read_text()
        log.unlink()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu {variant} failed ({proc.returncode}):\n{out}")
            continue
        lib_path(name, variant).with_suffix(".ptxas.txt").write_text(out)
        os.replace(tmp, lib_path(name, variant))
    if errors:
        raise KernelError("\n".join(errors))
    return seconds


def load(name: str, variant: str = "") -> ctypes.CDLL:
    """The loaded library of ``(name, variant)``, built first if needed;
    one build and one load however many threads ask at once, and a
    library that failed raises :class:`KernelError` again at once."""
    lib = _loaded.get((name, variant))
    if lib is None:
        with _build_lock:
            lib = _loaded.get((name, variant))
            if lib is None:
                path = lib_path(name, variant)
                if path in _failed:
                    raise KernelError(_failed[path])
                try:
                    built = build(((name, variant),))
                    lib = ctypes.CDLL(str(path))
                except (KernelError, OSError) as e:
                    _failed[path] = f"{name}.cu {variant}: {e}"
                    raise KernelError(_failed[path]) from e
                _loaded[name, variant] = lib
                cw = compilewatch.active()
                if cw is not None:
                    cw.on_load(lib_name(name, variant), built=bool(built))
    return lib


def compiled_geometries() -> tuple[tuple[int, int], ...]:
    """The ``(box_h, box_w)`` shapes with a compile-time instantiation of
    K1 and K2: ``DSST_FOR_EACH_GEOMETRY`` in ``csrc/fixpoint.cuh``."""
    text = (CSRC_DIR / "fixpoint.cuh").read_text()
    found = re.search(r"#define DSST_FOR_EACH_GEOMETRY\(X\)((?:\s*X\(\d+, *\d+\))+)", text)
    if found is None:
        raise RuntimeError("DSST_FOR_EACH_GEOMETRY not found in csrc/fixpoint.cuh")
    return tuple((int(h), int(w)) for h, w in re.findall(r"X\((\d+), *(\d+)\)", found.group(1)))


def instantiation(box_h: int, box_w: int) -> tuple[int, int]:
    """The template arguments ``Geo<BH, BW>`` that K1 and K2 run for a box
    shape: its own, or ``(0, 0)``, the instantiation with run-time
    dimensions."""
    return (box_h, box_w) if (box_h, box_w) in compiled_geometries() else (0, 0)


@functools.lru_cache(maxsize=None)
def compiled_cover_shapes() -> tuple[tuple[int, int, int], ...]:
    """The ``(RW, CW, ST)`` shapes with a compile-time instantiation of K3:
    ``DSST_FOR_EACH_COVER_SHAPE`` in ``csrc/cover.cu``."""
    text = (CSRC_DIR / "cover.cu").read_text()
    found = re.search(r"#define DSST_FOR_EACH_COVER_SHAPE\(X\)((?:[\s\\]*X\(\d+, *\d+, *\d+\))+)",
                      text)
    if found is None:
        raise RuntimeError("DSST_FOR_EACH_COVER_SHAPE not found in csrc/cover.cu")
    return tuple((int(a), int(b), int(c))
                 for a, b, c in re.findall(r"X\((\d+), *(\d+), *(\d+)\)", found.group(1)))


def cover_instantiation(w_rows: int, w_cols: int, stage: bool) -> tuple[int, int, int]:
    """The template arguments ``cover_kernel<RW, CW, ST>`` that K3 runs for
    an instance of ``w_rows`` row words and ``w_cols`` covered words, its
    constants staged in shared memory or not (and its counts in shared
    memory): ``(ceil(w_rows / 32), w_cols, stage)`` when compiled, else
    ``(0, 0, -1)``, the instantiation with run-time trip counts."""
    shape = (-(-w_rows // 32), w_cols, int(stage))
    return shape if shape in compiled_cover_shapes() else (0, 0, -1)


def ptxas_kernels(report: str) -> list[dict]:
    """Per kernel instantiation in a ptxas ``-v`` report: its name, its
    integer template arguments (``Geo<BH, BW>`` of K1 and K2, ``<RW, CW,
    ST>`` of K3, the mask bits of P16, the row words of PCV; None for a
    kernel without them),
    registers, spill stores and loads and stack frame, in bytes."""
    rows: list[dict] = []
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            name = re.search(r"\d+([a-z_]+_kernel)", mangled)
            args = [int(a.replace("n", "-")) for a in re.findall(r"Li(n?\d+)E", mangled)]
            rows.append({"kernel": name.group(1) if name else mangled,
                         "geometry": tuple(args) if args else None})
            continue
        if not rows:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if frame:
            rows[-1].update(stack_frame=int(frame.group(1)), spill_stores=int(frame.group(2)),
                            spill_loads=int(frame.group(3)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            rows[-1]["registers"] = int(regs.group(1))
    return rows


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch function."""
    if err != 0:
        raise KernelError(f"{what}: CUDA error {err} at launch")
