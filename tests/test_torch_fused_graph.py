"""The fused loop's captured bookkeeping, on the CPU.

The CPU runs the bookkeeping eagerly and counts no graph round.  The graph
cache's key and bound logic is held with stub entries.  The graph path of
``ops/cuda_step._run_fused`` (``_RoundGraph``: static buffers loaded from the
caller's frontier, one replay a dispatch, fresh tensors out) is held
against the eager loop with a stub capture whose replay runs the captured
chain eagerly: the same fields, the same dispatches, every one a graph
round.  The real capture runs only on a card
(``tests/test_torch_fused_graph_cuda.py``).
"""

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9, Geometry
from distributed_sudoku_solver_tpu_torch.models.nqueens import nqueens_cover
from distributed_sudoku_solver_tpu_torch.obs import trace
from distributed_sudoku_solver_tpu_torch.ops import cuda_cover, cuda_step
from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
from distributed_sudoku_solver_tpu_torch.ops.bulk import BulkConfig, solve_bulk
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    SolverConfig,
    attach_roots,
    init_frontier,
    init_frontier_roots,
)
from distributed_sudoku_solver_tpu_torch.utils.checkpoint import start_frontier
from distributed_sudoku_solver_tpu_torch.utils.puzzles import EASY_9, HARD_9, make_puzzle

FUSED_SMALL = SolverConfig(min_lanes=8, stack_slots=16, step_impl="fused", fused_steps=2)
GRIDS = np.stack([HARD_9[0], HARD_9[1], EASY_9]).astype(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the CPU path ---------------------------------------------------------------


class _Refusing:
    def claim(self, key, build):
        raise AssertionError("the CPU path claimed a graph")


def test_cpu_runs_the_bookkeeping_eagerly(monkeypatch):
    """A traced bulk pass on the CPU through the fused first pass and a
    fused rung: it dispatches, claims no graph and counts no graph round."""
    monkeypatch.setattr(cuda_step, "_GRAPHS", _Refusing())
    geom = Geometry(2, 3)
    grids = np.stack([make_puzzle(geom, 300 + i, n_clues=13, unique=False)
                      for i in range(64)]).astype(np.int32)
    tr: dict = {}
    solve_bulk(grids, geom, BulkConfig(chunk=64, stack_slots=1, first_pass_steps=1,
                                       max_sweeps=1, step_impl="fused", rung_step_impl="fused"),
               trace=tr, device="cpu")
    assert tr["k2_dispatches"] > 0 and tr["graph_rounds"] == 0
    assert tr["rungs"] and all(r["graph_rounds"] == 0 < r["k2_dispatches"] for r in tr["rungs"])
    (bulk_pass,) = [s for s in tr["spans"] if s["name"] == "bulk.pass"]
    assert bulk_pass["attrs"]["graph_rounds"] == 0


def test_graph_rounds_count_no_span():
    """``Recording.count`` tallies beside the span counts and keeps no span;
    ``trace.OFF`` counts nothing."""
    with trace.recording(keep=True) as rec:
        rec.count("fused.graph")
        rec.count("fused.graph")
    assert rec.counts == {"fused.graph": 2} and rec.spans == []
    trace.OFF.count("fused.graph")
    assert dict(trace.OFF.counts) == {}


# -- the cache's key and bound ----------------------------------------------------


def _fs(lanes=8, jobs=3, slots=16, n=9):
    geom = Geometry(3, 3) if n == 9 else Geometry(2, 2)
    grids = torch.zeros(jobs, n, n, dtype=torch.int32)
    state = init_frontier(encode_grid(grids, geom),
                          SolverConfig(lanes=lanes, min_lanes=lanes, stack_slots=slots,
                                       step_impl="fused"))
    return cuda_step.frontier_to_fused(state)


def _cover_fn():
    problem = nqueens_cover(6)
    return cuda_cover._rounds_fn(problem, FUSED_SMALL, 8)


KEY_CHANGES = {
    "lanes": lambda: cuda_step._graph_key(_fs(lanes=16), FUSED_SMALL, None),
    "jobs": lambda: cuda_step._graph_key(_fs(jobs=4), FUSED_SMALL, None),
    "stack_slots": lambda: cuda_step._graph_key(_fs(slots=8), FUSED_SMALL, None),
    "n": lambda: cuda_step._graph_key(_fs(n=4), FUSED_SMALL, None),
    "count_all": lambda: cuda_step._graph_key(
        _fs(), SolverConfig(min_lanes=8, stack_slots=16, step_impl="fused", count_all=True), None),
    "steal": lambda: cuda_step._graph_key(
        _fs(), SolverConfig(min_lanes=8, stack_slots=16, step_impl="fused", steal=False), None),
    "steal_gang": lambda: cuda_step._graph_key(
        _fs(), SolverConfig(min_lanes=8, stack_slots=16, step_impl="fused", steal_gang=8), None),
    "family": lambda: cuda_step._graph_key(_fs(), FUSED_SMALL, _cover_fn()),
}


@pytest.mark.parametrize("field", list(KEY_CHANGES))
def test_graph_key_changes_with_what_the_chain_reads(field):
    base = cuda_step._graph_key(_fs(), FUSED_SMALL, None)
    assert KEY_CHANGES[field]() != base


def test_graph_key_ignores_what_only_the_kernel_reads():
    """Rules, branch, sweeps and rounds a dispatch go to the kernel, which
    is launched outside the graph, and the values in the buffers are loaded
    each call: none of them is part of the key."""
    other = SolverConfig(min_lanes=8, stack_slots=16, step_impl="fused", fused_steps=32,
                         rules="basic", branch="head:mlp", max_sweeps=3, max_steps=9)
    fs = _fs()
    moved = cuda_step.FusedFrontier(*(t + 1 if t.dtype != torch.bool else ~t for t in fs))
    assert cuda_step._graph_key(moved, other, None) == cuda_step._graph_key(fs, FUSED_SMALL, None)
    assert cuda_step._graph_key(fs, FUSED_SMALL, _cover_fn()) == cuda_step._graph_key(
        fs, FUSED_SMALL, _cover_fn())


def _claim(cache, key, made):
    def build():
        made.append(key)
        return object()
    return cache.claim(key, build)


def test_cache_reuses_an_idle_entry_of_the_key():
    cache, made = cuda_step._GraphCache(2), []
    with _claim(cache, "a", made) as first:
        pass
    with _claim(cache, "a", made) as again:
        assert again is first
    assert made == ["a"] and len(cache) == 1 and cache.built == 1


def test_cache_never_shares_a_claimed_entry():
    """A second caller of a key whose entry is claimed builds another."""
    cache, made = cuda_step._GraphCache(2), []
    with _claim(cache, "a", made) as outer:
        with _claim(cache, "a", made) as inner:
            assert inner is not outer
    assert made == ["a", "a"] and len(cache) == 2 and cache.built == 2


def test_cache_drops_the_least_recently_used_idle_entries():
    cache, made = cuda_step._GraphCache(2), []
    entries = {}
    for key in ("a", "b", "a", "c"):
        with _claim(cache, key, made) as e:
            entries.setdefault(key, e)
    assert made == ["a", "b", "c"] and len(cache) == 2
    assert sorted(s[0] for s in cache._slots) == ["a", "c"]  # b was used least recently
    with _claim(cache, "b", made) as e:
        assert e is not entries["b"]
    assert made[-1] == "b" and len(cache) == 2


def test_cache_keeps_claimed_entries_past_its_bound():
    """An entry is dropped only once idle: past the bound while claimed, the
    cache comes back to it when the claims end."""
    cache, made = cuda_step._GraphCache(1), []
    with _claim(cache, "a", made):
        with _claim(cache, "b", made):
            assert len(cache) == 2
        assert len(cache) == 1
    assert len(cache) == 1 and [s[0] for s in cache._slots] == ["a"]


def test_cache_drops_an_entry_whose_claim_raised():
    cache, made = cuda_step._GraphCache(2), []
    with pytest.raises(RuntimeError):
        with _claim(cache, "a", made):
            raise RuntimeError("capture failed")
    assert len(cache) == 0
    with _claim(cache, "a", made):
        pass
    assert made == ["a", "a"] and len(cache) == 1


# -- the graph path, with a stub capture ----------------------------------------


class _Stream:
    def wait_stream(self, other):
        pass


def _writing_into_out(plain):
    """A round function that takes the kernels' ``out=`` (the graph hands
    it three buffers to write): the plain version's returns written there
    in the kernels' layout, as a ``KernelOut``.  Its top is already tile
    cleared (a second clear changes nothing) and its sweeps are summed, so
    lane 0 holds them all; the plain version updates the stack in place."""

    def rounds(top, stack, has_top, base, count, family, out=None, **kw):
        res = plain(top, stack, has_top, base, count, family, **kw)
        if out is None:
            return res
        sweeps = torch.zeros_like(res[10])
        sweeps[0] = res[11]
        out[0].copy_(res[0])
        out[1].copy_(res[6])
        out[2].copy_(torch.stack([res[2].to(torch.int32), res[4], res[5].to(torch.int32),
                                  res[7].to(torch.int32), res[8], res[9], res[10], sweeps]))
        return cuda_step.KernelOut(*out, kw["tile"], getattr(family, "w_rows", None))

    return rounds


@pytest.fixture
def stub_graphs(monkeypatch):
    """A cache of its own, a capture whose replay runs the captured chain
    eagerly (the CPU has no graphs) and round functions that write into the
    graph's buffers as the kernels do; ``_run_fused`` still takes the eager
    path until a test sets ``cuda_step._replays``."""
    cache = cuda_step._GraphCache(8)
    monkeypatch.setattr(cuda_step, "_GRAPHS", cache)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(cuda_step, "fused_rounds", _writing_into_out(cuda_step.fused_rounds))
    monkeypatch.setattr(cuda_cover, "cover_fused_rounds",
                        _writing_into_out(cuda_cover.cover_fused_rounds))

    def capture(self, config):
        return lambda: self._write(*self._chain(config))

    monkeypatch.setattr(cuda_step._RoundGraph, "_capture", capture)
    return cache


def _counted(run, graphed: bool, monkeypatch):
    monkeypatch.setattr(cuda_step, "_replays", lambda fs: graphed)
    with trace.recording(keep=True) as rec:
        out = run()
    return out, rec.counts.get("fused.dispatch", 0), rec.counts.get("fused.graph", 0)


def _equal(got, want):
    if isinstance(got, torch.Tensor):
        assert torch.equal(got, want)
    elif isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    else:
        assert got == want


def _batch():
    cfg = FUSED_SMALL
    return cuda_step.solve_batch_fused(torch.from_numpy(GRIDS), SUDOKU_9, cfg)


def _status():
    state = start_frontier(torch.from_numpy(GRIDS), SUDOKU_9, FUSED_SMALL)
    out = []
    for _ in range(4):
        state, status = cuda_step.advance_frontier_fused_status(state, 4, SUDOKU_9, FUSED_SMALL)
        out.append((state, status))
    return out


def _megastep():
    cfg = SolverConfig(step_impl="fused", branch="head:cw-slack", lanes=8, min_lanes=8,
                       steal_gang=8, max_steps=2**31 - 1)
    box = init_frontier_roots(torch.zeros(8, 9, 9, dtype=torch.int32),
                              torch.full((8,), -1, dtype=torch.int32), 1, cfg)
    box = attach_roots(box, encode_grid(torch.tensor(HARD_9[0])[None], SUDOKU_9),
                       torch.zeros(1, dtype=torch.int32), 8)
    return cuda_step.advance_megastep_fused(box, 8, 4, SUDOKU_9, cfg)


def _cover():
    problem = nqueens_cover(6)
    cfg = SolverConfig(lanes=16, stack_slots=32, step_impl="fused", fused_steps=4,
                       count_all=True)
    state = init_frontier(torch.from_numpy(problem.initial_state()[None]), cfg)
    return cuda_cover.advance_cover_fused(state, cfg.max_steps, problem, cfg)


SURFACES = {"batch": _batch, "status": _status, "megastep": _megastep, "cover": _cover}


@pytest.mark.parametrize("surface", list(SURFACES))
def test_graph_path_equals_the_eager_loop(surface, stub_graphs, monkeypatch):
    run = SURFACES[surface]
    want, dispatches, eager_rounds = _counted(run, False, monkeypatch)
    got, graph_dispatches, graph_rounds = _counted(run, True, monkeypatch)
    _equal(got, want)
    assert graph_dispatches == dispatches > 0
    assert graph_rounds == dispatches and eager_rounds == 0
    assert len(stub_graphs) >= 1
    if surface == "cover":
        assert int(got.sol_count.sum()) == 4  # the 6-queens solutions


def test_graph_path_returns_fresh_tensors_and_the_callers_stack(stub_graphs, monkeypatch):
    """Two calls on one key share the buffers; the first result is neither
    written by the second nor a view of the buffers, each caller's stack is
    updated in place, and a call that dispatches nothing returns its input."""
    monkeypatch.setattr(cuda_step, "_replays", lambda fs: True)
    cfg = FUSED_SMALL

    def frontier(rows):
        state = start_frontier(torch.from_numpy(rows), SUDOKU_9, cfg)
        return cuda_step.frontier_to_fused(state)

    fs_a, fs_b = frontier(GRIDS), frontier(GRIDS[::-1].copy())
    a = cuda_step._run_fused(fs_a, SUDOKU_9, cfg, 4)
    kept = [t.clone() for t in a]
    b = cuda_step._run_fused(fs_b, SUDOKU_9, cfg, 4)
    assert len(stub_graphs) == 1
    _equal(list(a), kept)
    assert a.stack is fs_a.stack and b.stack is fs_b.stack
    (entry,) = [s[1] for s in stub_graphs._slots]
    buffers = {t.data_ptr() for t in entry.state}
    assert not buffers & {t.data_ptr() for t in (*a, *b)}
    assert not torch.equal(a.top, b.top)
    done = cuda_step._run_fused(a, SUDOKU_9, cfg, 0)
    assert done is a
