"""The fused loop's look-ahead on the CPU: a spare dispatch changes nothing.

``ops/cuda_step._run_fused`` keeps ``LOOKAHEAD`` dispatches enqueued while
it reads a loop flag, so each call ends with a spare: a dispatch enqueued
after the flag fell.  Its round function reads the driver's gate
(``has_top & go``, all zero), so it sees no live lane and writes every top
through, and its bookkeeping finds ``go`` false at entry and changes
nothing.  Held here on the CPU (the plain round functions and
``bookkeep_plain``, in the card's order): the spare leaves every frontier
field bit-identical, after exhaustion and after the step limit, for K2 and
K3; ``_run_fused`` returns, field for field, what a depth-1 loop of the
same driver returns; and each call counts one ``fused.spare``.  The card's
side is ``tests/test_torch_lookahead_cuda.py``.
"""

import types

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
    FUSED_STEPS_DEVICE,
    FUSED_STEPS_LINKED,
    Frontier,
    SolverConfig,
    init_frontier,
)
from distributed_sudoku_solver_tpu_torch.ops.solve import solve_csp
from distributed_sudoku_solver_tpu_torch.utils.puzzles import EASY_9, HARD_9, make_puzzle

GRIDS9 = np.stack([HARD_9[0], HARD_9[1], EASY_9]).astype(np.int32)
GEOM16 = Geometry(4, 4)
K2_CFG = SolverConfig(min_lanes=8, stack_slots=16, step_impl="fused", fused_steps=2)
K3_CFG = SolverConfig(lanes=16, stack_slots=32, step_impl="fused", fused_steps=4, count_all=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _clone(fs: Frontier) -> Frontier:
    return Frontier(*(t.clone() for t in fs))


def _assert_equal(got: Frontier, want: Frontier):
    for name, a, b in zip(Frontier._fields, got, want, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _k2(grids, cfg=K2_CFG, geom=SUDOKU_9):
    """A K2 frontier of ``grids`` and its round function, as the fused batch
    solve makes them."""
    cfg = cfg.with_fused_steps(FUSED_STEPS_DEVICE)
    fs = init_frontier(encode_grid(torch.from_numpy(grids), geom), cfg)
    return fs, cfg, cuda_step._rounds_fn(geom, cfg, fs.has_top.shape[0])


def _k3(problem, cfg=K3_CFG):
    """A K3 frontier of ``problem``'s root and its round function."""
    cfg = cfg.with_fused_steps(FUSED_STEPS_LINKED)
    fs = init_frontier(torch.from_numpy(problem.initial_state()[None]), cfg)
    return fs, cfg, cuda_cover._rounds_fn(problem, cfg, fs.has_top.shape[0])


def _depth_one(fs, config, limit, rounds_fn):
    """The fused loop without look-ahead: the same driver, each flag read
    before the next dispatch is enqueued, so no dispatch is a spare."""
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


# -- the spare dispatch --------------------------------------------------------


SPARE_CASES = {
    "k2": lambda: _k2(GRIDS9),
    "k3": lambda: _k3(nqueens_cover(6)),
}


@pytest.mark.parametrize("stop", ["exhausted", "limit"])
@pytest.mark.parametrize("family", list(SPARE_CASES))
def test_a_dispatch_after_the_flag_fell_changes_nothing(family, stop):
    """Dispatch until the flag falls, then once more: every field of the
    frontier, the flag and the gate are as they were.  Stopped by the step
    limit, lanes are still live, so only the gate keeps the round function
    off them."""
    fs, cfg, rounds = SPARE_CASES[family]()
    limit = cuda_step._step_limit(cfg.max_steps if stop == "exhausted" else 12, cfg.max_steps)
    g = cuda_step._Rounds(fs)
    g.load(fs, limit)
    dispatches = 0
    while True:
        g.dispatch_round(rounds, cfg, trace.OFF, 0)
        dispatches += 1
        if not g.flag(0):
            break
    before = _clone(g.state)
    assert dispatches > 1 and not bool(g.go) and not bool(g.gate.any())
    assert bool(before.has_top.any()) == (stop == "limit")
    g.dispatch_round(rounds, cfg, trace.OFF, 1)
    _assert_equal(g.state, before)
    assert not bool(g.go) and not g.flag(1) and not bool(g.gate.any())


def _rounds_inputs(lanes, board, slots, seed):
    gen = torch.Generator().manual_seed(seed)

    def ints(*shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen, dtype=torch.int64).to(torch.int32)

    count = torch.randint(0, slots + 1, (lanes,), generator=gen, dtype=torch.int32)
    base = torch.randint(0, slots, (lanes,), generator=gen, dtype=torch.int32)
    return ints(lanes, *board), ints(lanes, slots, *board), base, count


PLAIN_ROUNDS = {
    "k2": lambda top, stack, has, base, count, **kw: cuda_step.fused_rounds_plain(
        top, stack, has, base, count, SUDOKU_9, count_mode=True, **kw),
    "k3": lambda top, stack, has, base, count, **kw: cuda_cover.cover_fused_rounds_plain(
        top, stack, has, base, count, pentomino_cover(3, 20), count_mode=True, **kw),
}


@pytest.mark.parametrize("out", [False, True], ids=["tuple", "out"])
@pytest.mark.parametrize("family", list(PLAIN_ROUNDS))
def test_a_plain_round_with_no_live_lane_copies_every_top_through(family, out):
    """With the gate all zero, the plain round functions change no lane:
    every top comes back whole (no tile clear: no lane ran a round), the
    stack is untouched, the solutions are zero, and of the lanes' outputs
    only the stack counts are not zero."""
    lanes, slots = 256, 3
    problem = pentomino_cover(3, 20)
    board = (9, 9) if family == "k2" else (1, problem.w_rows + problem.w_cols)
    top, stack, base, count = _rounds_inputs(lanes, board, slots, 5)
    kept = stack.clone()
    gate = torch.zeros(lanes, dtype=torch.int32)
    bufs = (torch.full_like(top, 7), torch.full_like(top, 7),
            torch.full((8, lanes), 7, dtype=torch.int32))
    res = PLAIN_ROUNDS[family](top, stack, gate, base, count, **({"out": bufs} if out else {}))
    if out:
        assert isinstance(res, cuda_bookkeep.KernelOut) and res.top is bufs[0]
        got_top, sol, cnt = res.top, res.sol, res.lane_out[1]
        zero = [res.lane_out[r] for r in (0, 2, 3, 4, 5, 6, 7)]
    else:
        got_top, _, has, _, cnt, solved, sol, over, nodes, sols, live, sweeps, steps = res
        zero = [has, solved, over, nodes, sols, live, sweeps, steps]
    assert torch.equal(got_top, top) and torch.equal(stack, kept)
    assert torch.equal(cnt, count)
    assert not bool(sol.any()) and not any(bool(z.any()) for z in zero)


def _bookkeep_inputs(seed, lanes=64, jobs=5, board=(1, 12), words=7, count_all=True):
    gen = torch.Generator().manual_seed(seed)

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int64).to(torch.int32)

    def flags(shape, p):
        return torch.rand(shape, generator=gen) < p

    state = Frontier(
        top=ints((lanes, *board), -2**31, 2**31), stack=ints((lanes, 4, *board), -2**31, 2**31),
        has_top=flags((lanes,), 0.5), base=ints((lanes,), 0, 4), count=ints((lanes,), 0, 5),
        job=ints((lanes,), -1, jobs), solved=flags((jobs,), 0.3),
        solution=ints((jobs, *board), -2**31, 2**31), overflowed=flags((jobs,), 0.2),
        nodes=ints((jobs,), 0, 100), sol_count=ints((jobs,), 0, 3), steps=ints((), 0, 20),
        sweeps=ints((), 0, 100), expansions=ints((), 0, 100), steals=ints((), 0, 100),
        lane_rounds=ints((lanes,), 0, 50))
    rows = [flags((lanes,), 0.6).to(torch.int32), ints((lanes,), 0, 5),
            flags((lanes,), 0.3).to(torch.int32), flags((lanes,), 0.2).to(torch.int32),
            ints((lanes,), 0, 9), ints((lanes,), 0, 3), ints((lanes,), 0, 9),
            ints((lanes,), 0, 50)]
    kout = cuda_bookkeep.KernelOut(ints((lanes, *board), -2**31, 2**31),
                                   ints((lanes, *board), -2**31, 2**31), torch.stack(rows),
                                   16, words)
    return state, kout, state.steps.to(torch.int64) + 10, ints((lanes,), 0, 2)


@pytest.mark.parametrize("steal", [False, True])
@pytest.mark.parametrize("count_all", [False, True])
def test_plain_bookkeeping_with_the_flag_false_at_entry_changes_nothing(count_all, steal):
    """``bookkeep_plain`` finding ``go`` false writes back what each buffer
    held: the frontier, the round's top, the flag and the gate; with ``go``
    true the same inputs change the frontier."""
    config = types.SimpleNamespace(count_all=count_all, steal=steal, steal_gang=0)
    state, kout, limit, gate = _bookkeep_inputs(11)
    before, top, gate0 = _clone(state), kout.top.clone(), gate.clone()
    go = torch.zeros((), dtype=torch.bool)
    cuda_bookkeep.bookkeep_plain(state, kout, limit, go, None, config, gate)
    _assert_equal(state, before)
    assert torch.equal(kout.top, top) and torch.equal(gate, gate0) and not bool(go)
    go.fill_(True)
    cuda_bookkeep.bookkeep_plain(state, kout, limit, go, None, config, gate)
    assert not all(torch.equal(a, b) for a, b in zip(state, before))
    assert torch.equal(gate, (state.has_top & go).to(torch.int32))


# -- the look-ahead against a depth-1 loop ---------------------------------------


def _grids16():
    return np.stack([make_puzzle(GEOM16, 900 + i, n_clues=150, unique=False)
                     for i in range(4)]).astype(np.int32)


LOOPS = {
    "sudoku9": lambda: (*_k2(GRIDS9), None),
    "sudoku16": lambda: (*_k2(_grids16(), SolverConfig(min_lanes=8, stack_slots=16,
                                                       step_impl="fused"), GEOM16), None),
    "pentomino-3x20": lambda: (*_k3(pentomino_cover(3, 20), SolverConfig(
        lanes=32, stack_slots=128, max_steps=1_000_000, count_all=True, step_impl="fused")),
        None),
    "nqueens-8": lambda: (*_k3(nqueens_cover(8), SolverConfig(
        lanes=64, stack_slots=64, step_impl="fused", count_all=True)), None),
    "limit": lambda: (*_k3(nqueens_cover(8), SolverConfig(
        lanes=64, stack_slots=64, step_impl="fused", count_all=True)), 12),
}


@pytest.mark.parametrize("case", list(LOOPS))
def test_the_lookahead_returns_what_a_depth_one_loop_returns(case):
    """``_run_fused`` and the depth-1 loop on equal inputs: every field of
    the returned frontier equal (``steps`` included), each caller's stack
    updated in place to the same rows, and one dispatch more, the spare."""
    fs, cfg, rounds, limit = LOOPS[case]()
    limit = cfg.max_steps if limit is None else limit
    a, b = _clone(fs), _clone(fs)
    with trace.recording(keep=True) as rec:
        got = cuda_step._run_fused(a, cfg, limit, rounds)
    want = _depth_one(b, cfg, limit, rounds)
    _assert_equal(got, want)
    assert got.stack is a.stack and want.stack is b.stack
    assert rec.counts["fused.dispatch"] > 1 and rec.counts["fused.spare"] == 1
    assert bool(got.has_top.any()) == (case == "limit")
    if case == "pentomino-3x20":
        assert int(got.sol_count.sum()) == 8
    if case == "nqueens-8":
        assert int(got.sol_count.sum()) == 92


def test_depth_one_dispatches_one_fewer():
    """The look-ahead's only extra dispatch is the spare: the round
    function runs once more than in the depth-1 loop."""
    fs, cfg, rounds = _k3(nqueens_cover(8), SolverConfig(lanes=64, stack_slots=64,
                                                         step_impl="fused", count_all=True))
    calls = []

    def counting(f, **kw):
        calls.append(1)
        return rounds(f, **kw)

    counting.words, counting.tile = rounds.words, rounds.tile
    cuda_step._run_fused(_clone(fs), cfg, cfg.max_steps, counting)
    ahead, calls[:] = len(calls), []
    _depth_one(_clone(fs), cfg, cfg.max_steps, counting)
    assert ahead == len(calls) + cuda_step.LOOKAHEAD - 1 > 2


# -- the counter -------------------------------------------------------------------


def test_spare_dispatches_count_one_a_call_that_dispatched():
    """``loop_counts`` reports the spares beside the dispatches: one a
    ``_run_fused`` call that dispatched, none for a call that found its
    flag false at once, and every spare a ``fused.dispatch`` span too."""
    fs, cfg, rounds = _k2(GRIDS9)
    with trace.recording(keep=True) as rec:
        out = fs
        for _ in range(3):
            out = cuda_step._run_fused(out, cfg, out.steps + 4, rounds)
        done = cuda_step._run_fused(out, cfg, out.steps, rounds)  # the limit is reached already
    assert done is out
    counts = cuda_step.loop_counts(rec.counts, "k2_dispatches")
    assert counts["spare_dispatches"] == 3 == rec.counts["fused.spare"]
    spans = [s["name"] for s in rec.spans]
    assert counts["k2_dispatches"] == spans.count("fused.dispatch")
    # a read before each call, then one a dispatch but the spares
    assert counts["host_syncs"] == spans.count("fused.sync") == 4 + counts["k2_dispatches"] - 3


def test_solve_csp_reports_one_spare():
    tr: dict = {}
    res = solve_csp(torch.from_numpy(nqueens_cover(6).initial_state()[None]), nqueens_cover(6),
                    K3_CFG, device="cpu", trace=tr)
    assert int(res.sol_count[0]) == 4
    assert tr["spare_dispatches"] == 1 < tr["k3_dispatches"]
    assert tr["host_syncs"] == tr["k3_dispatches"] - tr["spare_dispatches"] + 1


# -- the flag's event on a card --------------------------------------------------


class _Event:
    def __init__(self):
        self.streams = []

    def record(self, stream=None):
        self.streams.append(stream)

    def synchronize(self):
        pass


def test_the_flag_event_goes_on_the_frontier_devices_stream(monkeypatch):
    """On a card the copy of ``go`` into the host ring runs on the stream
    of the frontier's device, which ``load`` keeps in ``stream``; the
    event each flag read waits on is recorded there, not on the calling
    thread's current stream, whose device may be another card.  The
    driver's card path on the CPU: the graph replays run the plain
    bookkeeping, and ``current_stream`` answers a stream of another
    device."""
    fs, cfg, rounds = _k2(GRIDS9)
    g = cuda_step._Rounds(fs)
    g.load(fs, cfg.max_steps)
    frontier_stream, other_stream = object(), object()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: other_stream)

    def plain(state, kout, limit, go, work, config, gate):
        cuda_bookkeep.bookkeep_plain(state, kout, limit, go, work, config, gate)

    plain.launches = 0
    monkeypatch.setattr(cuda_bookkeep, "bookkeep_cuda", plain)
    g.captured, g.stream = True, frontier_stream
    g.events = [_Event() for _ in g.flags]
    g.graphs = tuple(types.SimpleNamespace(replay=lambda p=p: g._bookkeep(p, cfg))
                     for p in (0, 1))
    for slot in (0, 1, 0):
        g.dispatch_round(rounds, cfg, trace.OFF, slot)
    assert [e.streams for e in g.events] == [[frontier_stream] * 2, [frontier_stream]]
    assert g.flag(0) == bool(g.go) and plain.launches == 3

