"""The fused loop's bookkeeping replayed from a CUDA graph, held against the
reference step on the card.

Card-only (marked ``cuda``; a fixture skips them where no CUDA device is
visible), and free of JAX, so the chip machine runs them with
``--noconftest``.  On each surface (a 16x16 first-pass batch, a fused rung
chunk over several status advances, a megastep flight, a K3 cover run, two
cover instances of one frontier shape taking turns) the loop runs twice on
the same inputs: through ``ops/cuda_step._run_fused`` (the driver
``_Rounds``, its bookkeeping replayed) and through the reference step
(``_fused_round`` until ``_fused_go`` is false: the round kernel's
13-tuple and the plain bookkeeping, eagerly).  Every ``Frontier`` field,
the round kernel's launches and the dispatches must be equal.  Tolerance:
exact equality.
"""

import threading

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu_torch.models.cover import build_cover
from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9, Geometry
from distributed_sudoku_solver_tpu_torch.models.nqueens import nqueens_cover
from distributed_sudoku_solver_tpu_torch.obs import trace
from distributed_sudoku_solver_tpu_torch.ops import cuda_bookkeep, cuda_build, cuda_cover, cuda_step
from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    FUSED_STEPS_LINKED,
    SolverConfig,
    attach_roots,
    init_frontier,
    init_frontier_roots,
)
from distributed_sudoku_solver_tpu_torch.utils.checkpoint import start_frontier
from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9
from portbench.gen import boards

GEOM16 = Geometry(4, 4)
FIRST = SolverConfig(lanes=4096, stack_slots=12, max_steps=4096, step_impl="fused",
                     fused_steps=FUSED_STEPS_LINKED)
RUNG = SolverConfig(lanes=8192, stack_slots=24, max_steps=100_000, step_impl="fused",
                    steal_rounds=4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def graphs(monkeypatch):
    """A cache of its own for the test, so each test captures afresh."""
    cache = cuda_step._GraphCache(8)
    monkeypatch.setattr(cuda_step, "_GRAPHS", cache)
    return cache


def _grids16(count: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(boards.draw(seed, "graph", count, "sudoku16-93")[0].astype(np.int32))


def _k2(fs):
    """K2's round function under ``FIRST`` on ``fs``'s lanes."""
    return cuda_step._rounds_fn(GEOM16, FIRST, fs.has_top.shape[0])


def _reference(fs, config, limit, rounds_fn):
    """The fused loop's reference: ``_fused_round`` until ``_fused_go`` is
    false, each step counted as a dispatch of the call's recording."""
    rec = trace.current() or trace.OFF
    limit = cuda_step._step_limit(limit, config.max_steps)
    while bool(cuda_bookkeep._fused_go(fs, limit)):
        fs = cuda_step._fused_round(fs, config, rounds_fn)
        rec.count("fused.dispatch")
    return fs


def _launches():
    return cuda_step.fused_rounds_cuda.launches + cuda_cover.cover_fused_rounds_cuda.launches


def _counted(run, reference: bool):
    """``run()`` through ``_run_fused`` or through the reference; returns
    its result, the round kernels' launches, the loop's dispatch, graph and
    spare counts, and the loop's calls that dispatched."""
    loops = cuda_step._run_fused, cuda_cover._run_fused
    loop = _reference if reference else cuda_step._run_fused
    runs = []

    def counting_loop(*a, **k):
        before = _launches()
        out = loop(*a, **k)
        runs.append(_launches() > before)
        return out

    cuda_step._run_fused = cuda_cover._run_fused = counting_loop
    k = _launches()
    try:
        with trace.recording(keep=True) as rec:
            out = run()
        torch.cuda.synchronize()
    finally:
        cuda_step._run_fused, cuda_cover._run_fused = loops
    return (out, _launches() - k, rec.counts.get("fused.dispatch", 0),
            rec.counts.get("fused.graph", 0), rec.counts.get("fused.spare", 0), sum(runs))


def _assert_equal(got, want):
    assert type(got) is type(want)
    for name, a, b in zip(want._fields, got, want, strict=True):
        assert torch.equal(a, b), name


def _both(run, graphs):
    got, launches, dispatches, replays, spares, runs = _counted(run, False)
    want, ref_launches, ref_dispatches, ref_replays, ref_spares, ref_runs = _counted(run, True)
    assert ref_launches == ref_dispatches > 0 and ref_spares == 0
    assert runs == ref_runs > 0 and spares == (cuda_step.LOOKAHEAD - 1) * runs
    assert launches == dispatches == ref_launches + spares
    assert replays == dispatches and ref_replays == 0
    assert len(graphs) >= 1
    return got, want


@pytest.mark.cuda
def test_first_pass_batch_16x16(cuda_device, graphs):
    """K2 at ``Geo<4,4>`` on 4,096 unique 93-clue boards, as the bulk first
    pass runs it (``FUSED_STEPS_LINKED`` rounds a dispatch)."""
    states0 = encode_grid(_grids16(4096, 17).to(cuda_device), GEOM16)

    def run():
        fs = init_frontier(states0, FIRST)
        return cuda_step._run_fused(fs, FIRST, FIRST.max_steps, _k2(fs))

    got, want = _both(run, graphs)
    _assert_equal(got, want)


@pytest.mark.cuda
def test_fused_rung_chunk_status_advances(cuda_device, graphs):
    """A rung chunk of 64 jobs on 8,192 lanes advanced five times by 512
    steps through ``advance_frontier_fused_status``, status words included;
    the state each advance returns is read after the next one ran."""
    grids = _grids16(64, 23).to(cuda_device)

    def run():
        state = start_frontier(grids, GEOM16, RUNG)
        out = []
        for _ in range(5):
            state, status = cuda_step.advance_frontier_fused_status(state, 512, GEOM16, RUNG)
            out.append((state, status))
        return out

    got, want = _both(run, graphs)
    for (gs, gst), (ws, wst) in zip(got, want, strict=True):
        _assert_equal(gs, ws)
        assert torch.equal(gst, wst)


@pytest.mark.cuda
def test_megastep_flight(cuda_device, graphs):
    """A latency flight of one hard 9x9 board on the one-slot mailbox."""
    cfg = SolverConfig(step_impl="fused", branch="head:cw-slack", lanes=8, min_lanes=8,
                       steal_gang=8, max_steps=2**31 - 1)
    roots = encode_grid(torch.tensor(np.asarray(HARD_9[0], np.int32))[None], SUDOKU_9)

    def run():
        box = init_frontier_roots(torch.zeros(8, 9, 9, dtype=torch.int32),
                                  torch.full((8,), -1, dtype=torch.int32), 1, cfg)
        box = attach_roots(box, roots, torch.zeros(1, dtype=torch.int32), 8)
        box = type(box)(*(t.to(cuda_device) for t in box))
        return cuda_step.advance_megastep_fused(box, 64, 64, SUDOKU_9, cfg)

    (gs, gst, gc), (ws, wst, wc) = _both(run, graphs)
    _assert_equal(gs, ws)
    assert torch.equal(gst, wst) and gc == wc


@pytest.mark.cuda
def test_k3_cover_run(cuda_device, graphs):
    """Every solution of n-queens 8 counted by K3 through its round function."""
    problem = nqueens_cover(8)
    cfg = SolverConfig(lanes=256, stack_slots=64, step_impl="fused", fused_steps=4,
                       count_all=True)
    roots = torch.from_numpy(problem.initial_state()[None]).to(cuda_device)

    def run():
        state = init_frontier(roots, cfg)
        return cuda_cover.advance_cover_fused(state, cfg.max_steps, problem, cfg)

    got, want = _both(run, graphs)
    _assert_equal(got, want)
    assert int(got.sol_count.sum()) == 92


@pytest.mark.cuda
def test_a_patched_fused_rounds_sees_every_dispatch(cuda_device, monkeypatch, graphs):
    """The benchmark's K2 replay patches ``cuda_step.fused_rounds``: with
    the bookkeeping replayed, every dispatch, the spare too, still calls
    it, with the frontier's lanes as its first five arguments (its
    ``has_top`` as the driver's int32 gate)."""
    states0 = encode_grid(_grids16(1024, 29).to(cuda_device), GEOM16)
    seen = []
    orig = cuda_step.fused_rounds

    def watching(*args, **kw):
        seen.append(None if seen else tuple(a.clone() for a in args[:5]))
        return orig(*args, **kw)

    monkeypatch.setattr(cuda_step, "fused_rounds", watching)
    before = cuda_step.fused_rounds_cuda.launches
    with trace.recording(keep=True) as rec:
        fs = init_frontier(states0, FIRST)
        cuda_step._run_fused(fs, FIRST, FIRST.max_steps, _k2(fs))
    launches = cuda_step.fused_rounds_cuda.launches - before
    assert len(seen) == launches == rec.counts["fused.dispatch"] == rec.counts["fused.graph"] > 1
    assert rec.counts["fused.spare"] == cuda_step.LOOKAHEAD - 1
    first = init_frontier(states0, FIRST)
    assert seen[0][2].dtype == torch.int32
    for a, b in zip(seen[0], (first.top, first.stack, first.has_top, first.base, first.count)):
        assert a.dtype == b.dtype or b is first.has_top
        assert torch.equal(a, b.to(a.dtype))


@pytest.mark.cuda
def test_capture_beside_a_copying_thread(cuda_device, graphs):
    """A capture taken while another thread copies from the card to the
    host (the bulk drain worker, an HTTP thread) succeeds and replays
    right."""
    big = torch.arange(1 << 24, dtype=torch.int32, device=cuda_device)
    stop, copies = threading.Event(), []

    def copying():
        while not stop.is_set():
            copies.append(int(big.cpu()[-1]))

    states0 = encode_grid(_grids16(1024, 31).to(cuda_device), GEOM16)

    def run():
        fs = init_frontier(states0, FIRST)
        return cuda_step._run_fused(fs, FIRST, FIRST.max_steps, _k2(fs))

    worker = threading.Thread(target=copying)
    worker.start()
    try:
        got, launches, dispatches, replays, spares, runs = _counted(run, False)
    finally:
        stop.set()
        worker.join(timeout=60)
    assert not worker.is_alive() and copies and set(copies) == {(1 << 24) - 1}
    assert len(graphs) == 1 and replays == dispatches == launches > 0
    assert runs == 1 and spares == cuda_step.LOOKAHEAD - 1
    want = _counted(run, True)[0]
    _assert_equal(got, want)


@pytest.mark.cuda
def test_a_second_call_leaves_the_first_result_untouched(cuda_device, graphs):
    """Two calls on one key share the graph's buffers; the first call's
    returned state is fresh, so the second does not write it, and each
    caller's stack is its own, updated in place."""
    grids = _grids16(2048, 37).to(cuda_device)

    def frontier(rows):
        return init_frontier(encode_grid(rows, GEOM16), FIRST)

    fs_a, fs_b = frontier(grids[:1024]), frontier(grids[1024:])
    a = cuda_step._run_fused(fs_a, FIRST, 64, _k2(fs_a))
    kept = type(a)(*(t.clone() for t in a))
    b = cuda_step._run_fused(fs_b, FIRST, 64, _k2(fs_b))
    torch.cuda.synchronize()
    assert len(graphs) == 1
    _assert_equal(a, kept)
    assert a.stack is fs_a.stack and b.stack is fs_b.stack
    (entry,) = [s[1] for s in graphs._slots]
    buffers = {t.data_ptr() for t in (*entry.state, *entry.tops)}
    assert not buffers & {t.data_ptr() for t in (*a, *b)}
    assert not torch.equal(a.top, b.top)


@pytest.mark.cuda
def test_a_failed_capture_raises_kernel_error(cuda_device, monkeypatch, graphs):
    """A bookkeeping that cannot be captured (here: one that reads a value
    on the host) raises ``KernelError`` and leaves no entry; nothing runs
    eagerly in its place."""
    bookkeep = cuda_step._Rounds._bookkeep

    def reading(self, p, config):
        bookkeep(self, p, config)
        bool(self.go)  # a host sync: illegal while the stream captures

    monkeypatch.setattr(cuda_step._Rounds, "_bookkeep", reading)
    states0 = encode_grid(_grids16(256, 41).to(cuda_device), GEOM16)
    fs = init_frontier(states0, FIRST)
    with pytest.raises(cuda_build.KernelError):
        cuda_step._run_fused(fs, FIRST, FIRST.max_steps, _k2(fs))
    assert len(graphs) == 0
    torch.cuda.synchronize()


def _cover_32x40():
    """A 32-row by 40-column instance (``w_rows`` 1, ``w_cols`` 2) with 256
    exact covers: 8 groups of 5 columns, each covered whole or as 2 + 3,
    beside a row of 3 that leads nowhere."""
    groups = np.random.default_rng(7).permutation(40).reshape(8, 5)
    rows = [r for g in groups for r in (g, g[:2], g[2:], g[:3])]
    incidence = np.zeros((32, 40), dtype=bool)
    for i, cols in enumerate(rows):
        incidence[i, cols] = True
    return build_cover("groups-32x40", incidence, 40)


@pytest.mark.cuda
def test_two_cover_instances_of_one_shape_take_turns(cuda_device, graphs):
    """``nqueens_cover(6)`` (``w_rows`` 2, ``w_cols`` 1) and a 32x40
    instance (``w_rows`` 1, ``w_cols`` 2) have 3-word states, so at 16
    lanes their frontiers have one shape, but their tile clears differ:
    advanced in turns, 4 steps a call, each keeps a graph of its own and
    equals the reference step after every call, and both count in full."""
    problems = (nqueens_cover(6), _cover_32x40())
    assert [(p.w_rows, p.w_cols) for p in problems] == [(2, 1), (1, 2)]
    cfg = SolverConfig(lanes=16, stack_slots=32, step_impl="fused", fused_steps=4,
                       count_all=True)

    def run():
        states = [init_frontier(torch.from_numpy(p.initial_state()[None]).to(cuda_device), cfg)
                  for p in problems]
        out = []
        for _ in range(14):
            for i, p in enumerate(problems):
                states[i] = cuda_cover.advance_cover_fused(states[i], int(states[i].steps) + 4,
                                                           p, cfg)
                out.append(states[i])
        return out

    got, want = _both(run, graphs)
    for g, w in zip(got, want, strict=True):
        _assert_equal(g, w)
    assert len(graphs) == 2
    assert [int(s.sol_count.sum()) for s in got[-2:]] == [4, 256]
    assert not any(bool(s.has_top.any()) for s in got[-2:])
