"""Rules of the PyTorch/CUDA port, and its card-only kernel tests.

* The port imports neither JAX nor the JAX package (checked in a fresh
  subprocess, since this test process has JAX loaded, and by an AST scan).
* Entry points default to CUDA and raise where it is absent, unless the
  caller asks for the CPU (the probes' ``python -m`` entries need
  ``--device cpu``); kernel wrappers, the probes' included, never fall
  back to the plain version for a tensor that is not on the CPU.
* The fused loop's modules import one way: ``frontier`` <-
  ``cuda_bookkeep`` <- ``cuda_step`` <- ``cuda_cover``.
* ``chip_smoke.py``'s ``kernels`` line names all five kernels.
* Tests marked ``cuda`` hold each kernel against its plain version on a
  card; a fixture decides whether a card exists and skips otherwise.
  Tolerance: exact equality.
"""

import ast
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu_torch.models.cover import (
    build_cover,
    sudoku_clue_rows,
    sudoku_cover,
)
from distributed_sudoku_solver_tpu_torch.models.geometry import (
    SUDOKU_4,
    SUDOKU_6,
    SUDOKU_9,
    SUDOKU_16,
    SUDOKU_25,
    Geometry,
)
from distributed_sudoku_solver_tpu_torch.models.nqueens import nqueens_cover
from distributed_sudoku_solver_tpu_torch.models.pentomino import pentomino_cover
from distributed_sudoku_solver_tpu_torch.ops import cuda_cover, cuda_propagate, cuda_step
from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
from distributed_sudoku_solver_tpu_torch.ops.bulk import solve_bulk
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.ops.solve import solve_batch, solve_csp, solve_one
from distributed_sudoku_solver_tpu_torch.probes import cover_kernel, uint16
from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9, make_puzzle

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "distributed_sudoku_solver_tpu_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _modules():
    names = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'distributed_sudoku_solver_tpu'\n"
        "       or m.startswith('distributed_sudoku_solver_tpu.')]\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout


def test_serving_http_import_leaves_jax_out():
    """The HTTP node pulls in the whole serving stack (engine, scheduler,
    megastep, profiling); none of it brings JAX along."""
    code = ("import sys\n"
            "import distributed_sudoku_solver_tpu_torch.serving.http as h\n"
            "assert h.SolverEngine and h.EngineSaturated\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_file_imports_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "distributed_sudoku_solver_tpu"), (path, name)


# The fused loop's layers, lowest first: the frontier record, the job
# bookkeeping, K2 and the loop, K3.  Each module imports none above it.
FUSED_LAYERS = ("frontier", "cuda_bookkeep", "cuda_step", "cuda_cover")


@pytest.mark.parametrize("layer", FUSED_LAYERS[:-1])
def test_fused_loop_imports_point_one_way(layer):
    """``frontier`` <- ``cuda_bookkeep`` <- ``cuda_step`` <- ``cuda_cover``:
    no import of a higher layer anywhere in the module, inside a function
    or under ``TYPE_CHECKING`` included."""
    above = set(FUSED_LAYERS[FUSED_LAYERS.index(layer) + 1:])
    tree = ast.parse((PKG / "ops" / f"{layer}.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        for name in names:
            assert name.rsplit(".", 1)[-1] not in above, (layer, name)


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grids = np.stack([HARD_9[0]]).astype(np.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve_batch(grids, SUDOKU_9)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve_one(HARD_9[0], SUDOKU_9)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve_bulk(grids, SUDOKU_9)
    res = solve_batch(grids, SUDOKU_9, SolverConfig(min_lanes=4), device="cpu")
    assert bool(res.solved[0])


def test_later_entry_points_raise_without_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    """``load_frontier``, ``dataset.solve_file``, ``portfolio.race_cover``
    and a default ``StandaloneNode()`` resolve ``device=None`` to CUDA."""
    from distributed_sudoku_solver_tpu_torch.serving.http import StandaloneNode
    from distributed_sudoku_solver_tpu_torch.serving.portfolio import race_cover
    from distributed_sudoku_solver_tpu_torch.utils import checkpoint, dataset

    grids = np.stack([HARD_9[0]]).astype(np.int32)
    cfg = SolverConfig(min_lanes=4)
    snap = str(tmp_path / "f.npz")
    state = checkpoint.start_frontier(torch.from_numpy(grids), SUDOKU_9, cfg)
    checkpoint.save_frontier(snap, state, SUDOKU_9, cfg)
    boards = str(tmp_path / "in.txt")
    dataset.save_boards(boards, grids)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: checkpoint.load_frontier(snap, SUDOKU_9, cfg),
        lambda: dataset.solve_file(boards, str(tmp_path / "out.txt"), SUDOKU_9),
        lambda: race_cover(nqueens_cover(6), timeout=10.0),
        StandaloneNode,
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert checkpoint.load_frontier(snap, SUDOKU_9, cfg, device="cpu").top.device.type == "cpu"
    assert dataset.solve_file(boards, None, SUDOKU_9, device="cpu")["solved"] == 1
    assert race_cover(nqueens_cover(6), timeout=60.0, device="cpu").count == 4


MESH_FILES = sorted((PKG / "parallel").glob("*.py")) + [PKG / "serving" / "mesh_scheduler.py"]


def test_mesh_modules_import_no_jax():
    """``parallel/`` and ``serving/mesh_scheduler.py`` are port files the
    AST scan above covers, and importing them leaves JAX out."""
    assert len(MESH_FILES) == 8 and all(p in PORT_FILES for p in MESH_FILES)
    code = ("import sys\n"
            "import distributed_sudoku_solver_tpu_torch.parallel as p\n"
            "import distributed_sudoku_solver_tpu_torch.parallel.mesh_resident\n"
            "import distributed_sudoku_solver_tpu_torch.serving.mesh_scheduler as m\n"
            "assert p.solve_batch_sharded and m.MeshResidentFlight\n"
            "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib'))\n"
            "       or k == 'distributed_sudoku_solver_tpu'\n"
            "       or k.startswith('distributed_sudoku_solver_tpu.')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_mesh_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    """The mesh entry points resolve ``device=None`` (and a default mesh)
    to CUDA; ``device="cpu"`` runs them on CPU shards."""
    from distributed_sudoku_solver_tpu_torch import parallel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grids = np.stack([HARD_9[0]]).astype(np.int32)
    queens = nqueens_cover(5)
    roots = queens.initial_state()[None]
    fused = SolverConfig(step_impl="fused", min_lanes=8)
    calls = [
        lambda d: parallel.default_mesh(d),
        lambda d: parallel.make_mesh(device=d),
        lambda d: parallel.make_band_mesh(device=d),
        lambda d: parallel.solve_batch_sharded(grids, SUDOKU_9, device=d),
        lambda d: parallel.solve_csp_sharded(roots, queens, device=d),
        lambda d: parallel.solve_batch_fused_sharded(grids, SUDOKU_9, fused, device=d),
        lambda d: parallel.solve_csp_fused_sharded(roots, queens, fused, device=d),
        lambda d: parallel.solve_batch_banded(grids, SUDOKU_9, device=d),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call(None)
    with parallel.virtual_devices(2):
        for call in calls:
            out = call("cpu")
            if isinstance(out, parallel.Mesh):
                assert out.devices == (torch.device("cpu"),) * 2
            else:
                assert out.solved.device.type == "cpu" and bool(out.solved[0])
        res = solve_bulk(grids, SUDOKU_9, mesh=parallel.default_mesh("cpu"))
        assert res.solved.all()


def test_wrappers_never_fall_back_off_the_cpu():
    meta = torch.empty((2, 9, 9), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_propagate.propagate_fixpoint_pallas(meta, SUDOKU_9)
    stack = torch.empty((2, 3, 9, 9), dtype=torch.int32, device="meta")
    lane = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_step.fused_rounds(meta, stack, lane.bool(), lane, lane, SUDOKU_9)


def test_cover_wrapper_never_falls_back_off_the_cpu():
    problem = nqueens_cover(6)
    d = problem.state_shape[1]
    top = torch.empty((2, 1, d), dtype=torch.int32, device="meta")
    stack = torch.empty((2, 3, 1, d), dtype=torch.int32, device="meta")
    lane = torch.empty(2, dtype=torch.int32, device="meta")
    before = cuda_cover.cover_fused_rounds_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_cover.cover_fused_rounds(top, stack, lane.bool(), lane, lane, problem)
    assert cuda_cover.cover_fused_rounds_cuda.launches == before


@pytest.mark.parametrize("module", ["uint16", "cover_kernel"])
def test_probe_entry_points_need_a_card_unless_cpu_is_asked(module):
    """Without a card the entry point fails and prints no result; with
    ``--device cpu`` it prints the probe's JSON line."""
    name = f"distributed_sudoku_solver_tpu_torch.probes.{module}"
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; import runpy; "
            f"sys.argv = ['probe'] + sys.argv[1:]; runpy.run_module({name!r}, run_name='__main__')")
    bare = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert bare.returncode != 0 and "metric" not in bare.stdout
    assert "CUDA is not available" in bare.stderr
    extra = ["--batch", "32", "--iters", "1"] if module == "uint16" else []
    cpu = subprocess.run([sys.executable, "-c", code, "--device", "cpu", *extra], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert cpu.returncode == 0, cpu.stderr
    assert '"metric"' in cpu.stdout.strip().splitlines()[-1]


def test_probe_wrappers_never_fall_back_off_the_cpu():
    meta = torch.empty((9, 9, 8), dtype=torch.int32, device="meta")
    before = uint16.fixpoint_probe_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        uint16.fixpoint_probe(meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        uint16.fixpoint_probe(meta.to(torch.int16))
    assert uint16.fixpoint_probe_cuda.launches == before
    inc, packed, m, stack = (torch.empty_like(x, device="meta") for x in cover_kernel.probe_inputs())
    before = cover_kernel.cover_probe_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        cover_kernel.cover_probe(inc, packed, m, stack)
    assert cover_kernel.cover_probe_cuda.launches == before


def test_chip_smoke_kernels_line_names_all_five_kernels():
    """K1-K3 and the two probes, each with its source and the TPU kernel it
    replaces (a line of the function that reaches ``pl.pallas_call``)."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert set(chip_smoke.KERNELS) == {"K1", "K2", "K3", "P16", "PCV"}
    text = (REPO / "chip_smoke.py").read_text()
    for key, (name, source, replaces) in chip_smoke.KERNELS.items():
        assert name.startswith(key + " ") and f'kernel_row("{key}"' in text
        assert (PKG / "csrc" / source).exists()
        path, line = replaces.split(":")
        lines = (REPO / path).read_text().splitlines()
        assert "pl.pallas_call" in "\n".join(lines)
        at = lines[int(line) - 1]
        assert "pallas_call" in at or at.startswith("def "), (key, at)


def test_chip_smoke_kernels_line_names_the_port_only_kernels():
    """The port's kernels with no TPU kernel to replace (the fused loop's
    bookkeeping): each with its source, a row in the kernels line, and the
    line of the JAX function whose XLA ops it does."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert set(chip_smoke.PORT_KERNELS) == {"BK"}
    assert not set(chip_smoke.PORT_KERNELS) & set(chip_smoke.KERNELS)
    text = (REPO / "chip_smoke.py").read_text()
    for key, (name, source, replaces) in chip_smoke.PORT_KERNELS.items():
        assert name.startswith(key + " ") and f'kernel_row("{key}"' in text
        assert (PKG / "csrc" / source).exists()
        path, line = replaces.split(":")
        at = (REPO / path).read_text().splitlines()[int(line) - 1]
        assert at.startswith("def _fused_round("), (key, at)


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# -- card-only: each kernel against its plain version ---------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# Every shipped geometry (a compile-time instantiation each), then two box
# shapes that take the instantiation with run-time dimensions; 4x8 is
# n = 32, so bit 31 of the masks is set.
KERNEL_GEOMETRIES = [SUDOKU_4, SUDOKU_6, SUDOKU_9, SUDOKU_16, SUDOKU_25, Geometry(3, 4),
                     Geometry(4, 8)]


def _corpus(geom, count, seed):
    return np.stack([make_puzzle(geom, seed + i, unique=False) for i in range(count)]).astype(
        np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("rules", ["basic", "extended", "subsets"])
@pytest.mark.parametrize("geom", KERNEL_GEOMETRIES, ids=str)
def test_k1_kernel_matches_plain(cuda_device, geom, rules):
    cand = encode_grid(torch.from_numpy(_corpus(geom, 300, 1)).to(cuda_device), geom).contiguous()
    before = cuda_propagate.propagate_fixpoint_cuda.launches
    got, sweeps = cuda_propagate.propagate_fixpoint_pallas(cand, geom, rules=rules)
    want, want_sweeps = cuda_propagate.propagate_fixpoint_plain(cand, geom, rules=rules)
    assert cuda_propagate.propagate_fixpoint_cuda.launches == before + 1
    assert torch.equal(got, want) and int(sweeps) == int(want_sweeps)


@pytest.mark.cuda
@pytest.mark.parametrize("count_mode", [False, True])
@pytest.mark.parametrize("branch", ["minrem", "first", "mixed", "minrem-desc", "head:minrem",
                                    "head:cw-slack", "head:mlp"])
@pytest.mark.parametrize("geom", KERNEL_GEOMETRIES, ids=str)
def test_k2_kernel_matches_plain(cuda_device, geom, branch, count_mode):
    lanes, slots = (384 if geom.n <= 16 else 128), 5
    top = encode_grid(torch.from_numpy(_corpus(geom, lanes, 2)).to(cuda_device), geom)
    stack = encode_grid(
        torch.from_numpy(_corpus(geom, lanes * slots, 9)).to(cuda_device), geom
    ).reshape(lanes, slots, geom.n, geom.n).contiguous()
    gen = np.random.default_rng(3)
    has = torch.from_numpy(gen.random(lanes) < 0.8).to(cuda_device)
    base = torch.from_numpy(gen.integers(0, slots, lanes).astype(np.int32)).to(cuda_device)
    count = torch.from_numpy(gen.integers(0, slots + 1, lanes).astype(np.int32)).to(cuda_device)
    kw = dict(rules="extended", branch_rule=branch, k_steps=6, count_mode=count_mode)
    before = cuda_step.fused_rounds_cuda.launches
    got = cuda_step.fused_rounds(top, stack.clone(), has, base, count, geom, **kw)
    assert cuda_step.fused_rounds_cuda.launches == before + 1
    want = cuda_step.fused_rounds_plain(top, stack.clone(), has, base, count, geom, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_fused_solve_on_card_matches_cpu(cuda_device):
    grids = _corpus(SUDOKU_9, 200, 5)
    cfg = SolverConfig(step_impl="fused", rules="extended", stack_slots=12)
    got = solve_batch(grids, SUDOKU_9, cfg, device=cuda_device)
    want = solve_batch(grids, SUDOKU_9, cfg, device="cpu")
    for f in want._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


def _cover_frontier(problem, roots, lanes, slots, device, steps):
    """A frontier fanned out from ``roots`` by plain enumeration rounds and steals."""
    from distributed_sudoku_solver_tpu_torch.ops.frontier import init_frontier

    cfg = SolverConfig(lanes=lanes, stack_slots=slots, step_impl="fused", fused_steps=4,
                       count_all=True)
    state = init_frontier(torch.from_numpy(roots), cfg)
    state = cuda_cover.advance_cover_fused(state, steps, problem, cfg)
    return [t.to(device) for t in (state.top, state.stack, state.has_top, state.base,
                                   state.count)]


def wide_cover(segments: int = 60, width: int = 1000):
    """60,000 primary columns: a lane's counts do not fit beside its state
    in shared memory, so they live in device memory (run-time shape).  Each
    segment is covered by one of two whole-segment rows or by its four
    quarters; taking one quarter forces the other three, one per sweep."""
    rows = []
    for s in range(segments):
        base = s * width
        for lo, hi in [(0, 4)] * 2 + [(q, q + 1) for q in range(4)]:
            row = np.zeros(segments * width, dtype=bool)
            row[base + lo * width // 4:base + hi * width // 4] = True
            rows.append(row)
    return build_cover("wide", np.stack(rows), segments * width)


def _clue_roots(problem, geom, count, n_clues):
    return np.stack([problem.state_with_rows_taken(sudoku_clue_rows(
        make_puzzle(geom, seed, n_clues=n_clues, unique=False))) for seed in range(count)])


@functools.lru_cache(maxsize=None)
def _k3_case(name):
    """(problem, CPU frontier) of a K3 card test: every compile-time
    instantiation (RW, CW) of csrc/cover.cu and the run-time one."""
    if name == "nqueens4":  # (1, 1), W_r 1: a queen in each cell of row 0, unexpanded
        problem = nqueens_cover(4)
        roots = np.stack([problem.state_with_rows_taken([c]) for c in range(4)])
        lanes, steps = 256, 0
    elif name.startswith("nqueens"):  # (1, 1); secondary columns (the diagonals)
        problem = nqueens_cover(int(name[len("nqueens"):]))
        roots, lanes, steps = problem.initial_state()[None], 256, 40
    elif name.startswith("pentomino"):  # (2, 3) and (3, 3)
        h, w = map(int, name[len("pentomino"):].split("x"))
        problem = pentomino_cover(h, w)
        roots, lanes, steps = problem.initial_state()[None], 256, 40
    elif name == "sudoku-cover9x9":  # (1, 11)
        problem = sudoku_cover(SUDOKU_9)
        roots = np.stack([problem.state_with_rows_taken(sudoku_clue_rows(h)) for h in HARD_9])
        lanes, steps = 256, 12
    elif name == "sudoku-cover4x4":  # (1, 2)
        problem = sudoku_cover(SUDOKU_4)
        roots, lanes, steps = _clue_roots(problem, SUDOKU_4, 64, 4), 256, 4
    elif name == "sudoku-cover6x6":  # (1, 5): the run-time shape
        problem = sudoku_cover(SUDOKU_6)
        roots, lanes, steps = _clue_roots(problem, SUDOKU_6, 64, 8), 256, 6
    elif name == "sudoku-cover16x16":  # (4, 32), column masks not staged
        problem = sudoku_cover(SUDOKU_16)
        roots, lanes, steps = _clue_roots(problem, SUDOKU_16, 8, 100), 32, 4
    else:  # the run-time shape with its counts in device memory
        problem = wide_cover()
        roots, lanes, steps = problem.initial_state()[None], 32, 12
    return problem, _cover_frontier(problem, roots, lanes, 16, "cpu", steps)


K3_CASES = ["nqueens4", "nqueens8", "nqueens10", "nqueens14", "pentomino3x20", "pentomino6x10",
            "sudoku-cover4x4", "sudoku-cover6x6", "sudoku-cover9x9", "sudoku-cover16x16", "wide"]


@pytest.mark.cuda
@pytest.mark.parametrize("max_sweeps", [64, 1, 2])
@pytest.mark.parametrize("count_mode", [False, True])
@pytest.mark.parametrize("name", K3_CASES)
def test_k3_kernel_matches_plain(cuda_device, name, count_mode, max_sweeps):
    problem, frontier = _k3_case(name)
    top, stack, has, base, count = [t.to(cuda_device) for t in frontier]
    assert bool(has.any())
    if max_sweeps < 64:
        # Some live lane's forced chain is cut at the cap in the first round,
        # so the re-scan after the cap and a branch on a cnt == 1 column run.
        capped, sweeps = problem.propagate_per_lane(top, max_sweeps)
        cut = has & (capped != problem.propagate_per_lane(top, 64)[0]).flatten(1).any(1)
        assert bool(cut.any()) and bool((sweeps[cut] == max_sweeps).all())
    kw = dict(k_steps=6, count_mode=count_mode, max_sweeps=max_sweeps)
    before = cuda_cover.cover_fused_rounds_cuda.launches
    got = cuda_cover.cover_fused_rounds(top, stack.clone(), has, base, count, problem, **kw)
    want = cuda_cover.cover_fused_rounds_plain(top, stack.clone(), has, base, count, problem,
                                               **kw)
    assert cuda_cover.cover_fused_rounds_cuda.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("count_mode", [False, True])
@pytest.mark.parametrize("name", ["pentomino6x10", "sudoku-cover6x6"])
def test_k3_kernel_overflow_matches_plain(cuda_device, name, count_mode):
    # A two-slot stack: lanes branch from their top with no room to push.
    problem, frontier = _k3_case(name)
    top, _, has, _, _ = [t.to(cuda_device) for t in frontier]
    lanes = top.shape[0]
    stack = torch.zeros((lanes, 2, *top.shape[1:]), dtype=torch.int32, device=cuda_device)
    zero = torch.zeros(lanes, dtype=torch.int32, device=cuda_device)
    kw = dict(k_steps=8, count_mode=count_mode, max_sweeps=64)
    got = cuda_cover.cover_fused_rounds(top, stack.clone(), has, zero, zero, problem, **kw)
    want = cuda_cover.cover_fused_rounds_plain(top, stack.clone(), has, zero, zero, problem, **kw)
    assert bool(want[7].any())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_fused_cover_solve_on_card_matches_cpu(cuda_device):
    problem = nqueens_cover(8)
    roots = np.repeat(problem.initial_state()[None], 3, axis=0)
    cfg = SolverConfig(min_lanes=200, stack_slots=16, step_impl="fused", count_all=True)
    got = solve_csp(roots, problem, cfg, device=cuda_device)
    want = solve_csp(roots, problem, cfg, device="cpu")
    for f in want._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert got.sol_count.tolist() == [92, 92, 92]
