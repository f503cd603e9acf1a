"""The fused loop's look-ahead on the card: a spare dispatch is an exact no-op.

Card-only (marked ``cuda``; a fixture skips them where no CUDA device is
visible), and free of JAX, so the chip machine runs them with
``--noconftest``.  ``ops/cuda_step._run_fused`` keeps ``LOOKAHEAD``
dispatches enqueued while it reads a loop flag, so each call ends with a
spare, enqueued after the flag fell.  Held here: the bookkeeping kernel
(``csrc/bookkeep.cu``) finding ``go`` false at entry writes nothing, the
scratch included; K2 and K3 given a gated ``has_top`` of zeros copy every
top through and write no lane's state; a spare through the captured graph
leaves every frontier field bit-identical, after exhaustion and after the
step limit; and ``_run_fused`` returns, field for field, what a depth-1
loop of the same driver returns.  Tolerance: exact equality.
"""

import dataclasses
import types
import zlib

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9, Geometry
from distributed_sudoku_solver_tpu_torch.models.nqueens import nqueens_cover
from distributed_sudoku_solver_tpu_torch.models.pentomino import pentomino_cover
from distributed_sudoku_solver_tpu_torch.obs import trace
from distributed_sudoku_solver_tpu_torch.ops import cuda_bookkeep, cuda_cover, cuda_step
from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    FUSED_STEPS_LINKED,
    Frontier,
    SolverConfig,
    init_frontier,
)
from portbench.gen import boards

GEOM16 = Geometry(4, 4)
FIRST = SolverConfig(lanes=4096, stack_slots=12, max_steps=4096, step_impl="fused",
                     fused_steps=FUSED_STEPS_LINKED)
COUNT = SolverConfig(lanes=4096, stack_slots=128, max_steps=1_000_000, count_all=True,
                     steal_rounds=4, step_impl="fused")
I32 = (-(2**31), 2**31)


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


def _clone(fs: Frontier) -> Frontier:
    return Frontier(*(t.clone() for t in fs))


def _assert_equal(got: Frontier, want: Frontier):
    for name, a, b in zip(Frontier._fields, got, want, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _ints(gen, shape, lo, hi, dev):
    return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int64).to(
        torch.int32)


# -- the bookkeeping kernel with the flag false at entry ---------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("steal", [(False, 0), (True, 0), (True, 32)], ids=["no-steal", "steal",
                                                                            "gang32"])
@pytest.mark.parametrize("count_all", [False, True], ids=["first", "count_all"])
@pytest.mark.parametrize("lanes,jobs,board,words", [(96, 24, (9, 9), 81),
                                                    (32768, 1, (1, 68), 44),
                                                    (32768, 32768, (16, 16), 256)],
                         ids=["k2-9x9", "k3-68", "k2-16x16"])
def test_the_kernel_with_the_flag_false_at_entry_changes_nothing(cuda_device, lanes, jobs,
                                                                 board, words, count_all, steal):
    """A dispatch with ``go`` true first (so the scratch's per-block words
    are written), then one with ``go`` false: the second leaves every field
    of the frontier, the round's top, the flag, the gate and the scratch as
    they were, but the scratch's last word, the entry flag the harvest
    found, now 0."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(zlib.crc32(repr((lanes, count_all, steal))
                                                             .encode()))
    config = types.SimpleNamespace(count_all=count_all, steal=steal[0], steal_gang=steal[1])
    rand = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    solved = rand(jobs) < 0.3
    state = Frontier(
        top=_ints(gen, (lanes, *board), *I32, dev), stack=_ints(gen, (lanes, 5, *board), *I32, dev),
        has_top=rand(lanes) < 0.5, base=_ints(gen, (lanes,), 0, 5, dev),
        count=_ints(gen, (lanes,), 0, 6, dev), job=_ints(gen, (lanes,), 0, jobs, dev),
        solved=solved, solution=_ints(gen, (jobs, *board), *I32, dev),
        overflowed=rand(jobs) < 0.1, nodes=_ints(gen, (jobs,), 0, 1000, dev),
        sol_count=_ints(gen, (jobs,), 0, 3, dev) if count_all else solved.to(torch.int32),
        steps=_ints(gen, (), 0, 50, dev), sweeps=_ints(gen, (), 0, 1000, dev),
        expansions=_ints(gen, (), 0, 1000, dev), steals=_ints(gen, (), 0, 1000, dev),
        lane_rounds=_ints(gen, (lanes,), 0, 100, dev))

    def kout():
        rows = [(rand(lanes) < 0.6).to(torch.int32), _ints(gen, (lanes,), 0, 6, dev),
                (rand(lanes) < 0.05).to(torch.int32), (rand(lanes) < 0.03).to(torch.int32),
                _ints(gen, (lanes,), 0, 9, dev), _ints(gen, (lanes,), 0, 3, dev),
                _ints(gen, (lanes,), 0, 9, dev), _ints(gen, (lanes,), 0, 100, dev)]
        return cuda_bookkeep.KernelOut(_ints(gen, (lanes, *board), *I32, dev),
                                       _ints(gen, (lanes, *board), *I32, dev),
                                       torch.stack(rows).contiguous(), min(128, lanes), words)

    limit = state.steps.to(torch.int64) + 1000
    work = cuda_bookkeep.new_work(lanes, jobs, dev)
    gate = torch.full((lanes,), -1, dtype=torch.int32, device=dev)
    go = torch.ones((), dtype=torch.bool, device=dev)
    first = kout()
    cuda_bookkeep.bookkeep_cuda(state, first, limit, go, work, config, gate)
    state = state._replace(top=first.top)
    assert torch.equal(gate, (state.has_top & go).to(torch.int32))
    go.fill_(False)
    spare = kout()
    before, top, gate0, work0 = _clone(state), spare.top.clone(), gate.clone(), work.clone()
    cuda_bookkeep.bookkeep_cuda(state, spare, limit, go, work, config, gate)
    torch.cuda.synchronize()
    _assert_equal(state, before)
    assert torch.equal(spare.top, top) and torch.equal(gate, gate0) and not bool(go)
    assert int(work0[-1]) == 1 and int(work[-1]) == 0
    assert torch.equal(work[:-1], work0[:-1])


# -- the round kernels with a gated has_top ------------------------------------------


def _k2_launch(top, stack, gate, base, count, out, n):
    geom = SUDOKU_9 if n == 9 else GEOM16
    return cuda_step.fused_rounds_cuda(top, stack, gate, base, count, geom, count_mode=True,
                                       out=out)


def _k3_launch(problem):
    def launch(top, stack, gate, base, count, out, _):
        return cuda_cover.cover_fused_rounds_cuda(top, stack, gate, base, count, problem,
                                                  count_mode=True, out=out)
    return launch


ROUND_KERNELS = {
    "k2-9x9": (lambda: _k2_launch, (9, 9), 9),
    "k2-16x16": (lambda: _k2_launch, (16, 16), 16),
    "k3-pentomino-6x10": (lambda: _k3_launch(pentomino_cover(6, 10)), None, 0),
    "k3-nqueens-8": (lambda: _k3_launch(nqueens_cover(8)), None, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(ROUND_KERNELS))
def test_a_round_kernel_with_a_gated_has_top_copies_every_top_through(cuda_device, kernel):
    """K2 and K3 at 4,096 lanes on a gate of zeros: every top written
    through unchanged into the output top, the stack untouched, the
    solutions zero, and of ``lane_out`` only the stack counts not zero."""
    make, board, n = ROUND_KERNELS[kernel]
    launch = make()
    if board is None:
        problem = (pentomino_cover(6, 10) if "pentomino" in kernel else nqueens_cover(8))
        board = (1, problem.w_rows + problem.w_cols)
    dev, lanes, slots = cuda_device, 4096, 7
    gen = torch.Generator(device=dev).manual_seed(zlib.crc32(kernel.encode()))
    top = _ints(gen, (lanes, *board), *I32, dev)
    stack = _ints(gen, (lanes, slots, *board), *I32, dev)
    base, count = _ints(gen, (lanes,), 0, slots, dev), _ints(gen, (lanes,), 0, slots + 1, dev)
    kept = stack.clone()
    out = (torch.full_like(top, 7), torch.full_like(top, 7),
           torch.full((8, lanes), 7, dtype=torch.int32, device=dev))
    res = launch(top, stack, torch.zeros(lanes, dtype=torch.int32, device=dev), base, count,
                 out, n)
    torch.cuda.synchronize()
    assert res.top is out[0] and torch.equal(res.top, top) and torch.equal(stack, kept)
    assert not bool(res.sol.any()) and torch.equal(res.lane_out[1], count)
    assert not bool(res.lane_out[[0, 2, 3, 4, 5, 6, 7]].any())


# -- the spare through the captured graph, and the loop against depth 1 ------------


def _grids16(count: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(boards.draw(seed, "lookahead", count, "sudoku16-93")[0]
                            .astype(np.int32))


def _k2_case(dev, count=1024, seed=43):
    fs = init_frontier(encode_grid(_grids16(count, seed).to(dev), GEOM16), FIRST)
    return fs, FIRST, cuda_step._rounds_fn(GEOM16, FIRST, fs.has_top.shape[0])


def _k3_case(dev, problem, cfg=COUNT):
    cfg = cfg.with_fused_steps(FUSED_STEPS_LINKED)
    fs = init_frontier(torch.from_numpy(problem.initial_state()[None]).to(dev), cfg)
    return fs, cfg, cuda_cover._rounds_fn(problem, cfg, fs.has_top.shape[0])


def _depth_one(fs, config, limit, rounds_fn):
    """The fused loop without look-ahead: a driver of its own, each flag
    read before the next dispatch is enqueued, so no dispatch is a spare."""
    limit = cuda_step._step_limit(limit, config.max_steps)
    if not bool(cuda_bookkeep._fused_go(fs, limit)):
        return fs
    g = cuda_step._Rounds(fs)
    g.load(fs, limit)
    go = True
    while go:
        g.dispatch_round(rounds_fn, config, trace.OFF, 0)
        go = g.flag(0)
    return g.unload(fs.stack)


SPARES = {
    "k2": lambda dev: _k2_case(dev),
    "k3": lambda dev: _k3_case(dev, nqueens_cover(8), dataclasses.replace(COUNT, lanes=256)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("stop", ["exhausted", "limit"])
@pytest.mark.parametrize("family", list(SPARES))
def test_a_spare_through_the_graph_changes_nothing(cuda_device, family, stop):
    """The captured bookkeeping replayed with ``go`` false at entry, behind
    a round kernel on the gate: every field of the frontier, the flag and
    the gate as they were after the flag fell."""
    fs, cfg, rounds = SPARES[family](cuda_device)
    limit = cuda_step._step_limit(cfg.max_steps if stop == "exhausted" else 16, cfg.max_steps)
    g = cuda_step._Rounds(fs)
    g.load(fs, limit)
    dispatches = 0
    while True:
        g.dispatch_round(rounds, cfg, trace.OFF, 0)
        dispatches += 1
        if not g.flag(0):
            break
    before = _clone(g.state)
    assert dispatches > 1 and g.graphs is not None and not bool(g.gate.any())
    assert bool(before.has_top.any()) == (stop == "limit")
    g.dispatch_round(rounds, cfg, trace.OFF, 1)
    torch.cuda.synchronize()
    _assert_equal(g.state, before)
    assert not g.flag(1) and not bool(g.go) and not bool(g.gate.any())


ELSEWHERE = {
    "k2-first-pass": lambda dev: (*_k2_case(dev, 4096, 59), None),
    "k3-pentomino-6x10": lambda dev: (*_k3_case(dev, pentomino_cover(6, 10),
                                                dataclasses.replace(COUNT, lanes=32768)), None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ELSEWHERE))
def test_the_loop_on_a_card_that_is_not_the_current_one(cuda_device, graphs, case):
    """A frontier on the last card while the calling thread's current
    device is card 0, as on the serving engine's device thread: the loop
    launches its kernels on the frontier's card and reads each flag after
    its own dispatch's copy, so the call runs to the end the depth-1 loop
    reaches on that card (with that card current), field for field, the
    pentomino count complete, and the caller's current device is kept."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the frontier on one, the current device another")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    with torch.cuda.device(0):
        fs, cfg, rounds, limit = ELSEWHERE[case](dev)
        limit = cfg.max_steps if limit is None else limit
        got = cuda_step._run_fused(_clone(fs), cfg, limit, rounds)
        assert torch.cuda.current_device() == 0
        torch.cuda.synchronize(dev)
    with torch.cuda.device(dev):
        want = _depth_one(_clone(fs), cfg, limit, rounds)
        torch.cuda.synchronize(dev)
    _assert_equal(got, want)
    assert got.has_top.device == dev and int(got.steps) > 2 * FUSED_STEPS_LINKED
    if case == "k3-pentomino-6x10":
        assert int(got.sol_count.sum()) == 9356 and not bool(got.has_top.any())
    else:
        assert int(got.steps) >= cfg.max_steps


LOOPS = {
    "k2-first-pass": lambda dev: (*_k2_case(dev, 4096, 47), None),
    "k2-limit": lambda dev: (*_k2_case(dev, 4096, 53), 6),
    "k3-pentomino-6x10": lambda dev: (*_k3_case(dev, pentomino_cover(6, 10),
                                                dataclasses.replace(COUNT, lanes=32768)), None),
    "k3-nqueens-8": lambda dev: (*_k3_case(dev, nqueens_cover(8)), None),
    "k3-limit": lambda dev: (*_k3_case(dev, pentomino_cover(3, 20)), 40),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LOOPS))
def test_the_lookahead_returns_what_a_depth_one_loop_returns(cuda_device, graphs, case):
    """``_run_fused`` (its graph from the cache) and the depth-1 loop on
    equal inputs: every field of the returned frontier equal, ``steps``
    included, with one spare more on the look-ahead's side.  The first
    pass stops at its ``max_steps`` with lanes live, the limit cases
    mid-search, and the cover counts exhausted."""
    fs, cfg, rounds, limit = LOOPS[case](cuda_device)
    limit = cfg.max_steps if limit is None else limit
    a, b = _clone(fs), _clone(fs)
    with trace.recording(keep=True) as rec:
        got = cuda_step._run_fused(a, cfg, limit, rounds)
    want = _depth_one(b, cfg, limit, rounds)
    torch.cuda.synchronize()
    _assert_equal(got, want)
    assert got.stack is a.stack and want.stack is b.stack
    assert rec.counts["fused.spare"] == cuda_step.LOOKAHEAD - 1
    assert rec.counts["fused.graph"] == rec.counts["fused.dispatch"] > 1
    assert bool(got.has_top.any()) == (case.startswith("k2") or case.endswith("limit"))
    if case == "k3-pentomino-6x10":
        assert int(got.sol_count.sum()) == 9356
    if case == "k3-nqueens-8":
        assert int(got.sol_count.sum()) == 92
