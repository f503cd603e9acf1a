"""The fused loop's driver and its cache of captured graphs, on the CPU.

On the CPU ``ops/cuda_step._run_fused`` runs the one driver (``_Rounds``:
static buffers loaded from the caller's frontier, the round function
writing into ``out=``, the plain bookkeeping in place, fresh tensors out)
with nothing captured: no graph is claimed and no graph round counted.
Each fused surface through it is held against the reference step
(``_fused_round`` until ``_fused_go`` is false).  The graph cache's key
and bound logic is held with stub entries.  The capture runs only on a
card (``tests/test_torch_fused_graph_cuda.py``).
"""

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu_torch.models.cover import build_cover
from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9, Geometry
from distributed_sudoku_solver_tpu_torch.models.nqueens import nqueens_cover
from distributed_sudoku_solver_tpu_torch.obs import trace
from distributed_sudoku_solver_tpu_torch.ops import cuda_bookkeep, cuda_cover, cuda_step
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
    return init_frontier(encode_grid(grids, geom),
                         SolverConfig(lanes=lanes, min_lanes=lanes, stack_slots=slots,
                                      step_impl="fused"))


def _key(fs, config=FUSED_SMALL, rounds=None):
    """The key of ``fs`` under K2's round function of its geometry and lanes."""
    n = fs.top.shape[1]
    rounds = rounds or cuda_step._rounds_fn(Geometry(3, 3) if n == 9 else Geometry(2, 2),
                                            config, fs.has_top.shape[0])
    return cuda_step._graph_key(fs, config, rounds)


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


def _cover_key(problem, lanes=16):
    cfg = SolverConfig(lanes=lanes, stack_slots=32, step_impl="fused", fused_steps=4,
                       count_all=True)
    fs = init_frontier(torch.from_numpy(problem.initial_state()[None]), cfg)
    return cuda_step._graph_key(fs, cfg, cuda_cover._rounds_fn(problem, cfg, lanes))


def _three_word_states():
    """``nqueens_cover(6)`` (``w_rows`` 2, ``w_cols`` 1) and the 32x40
    instance (``w_rows`` 1, ``w_cols`` 2): equal frontier shapes, a tile
    clear of 2 words against one of 1."""
    a, b = nqueens_cover(6), _cover_32x40()
    assert (a.w_rows, a.w_cols, b.w_rows, b.w_cols) == (2, 1, 1, 2)
    return _cover_key(a), _cover_key(b)


KEY_CHANGES = {
    "lanes": lambda: (_key(_fs()), _key(_fs(lanes=16))),
    "jobs": lambda: (_key(_fs()), _key(_fs(jobs=4))),
    "stack_slots": lambda: (_key(_fs()), _key(_fs(slots=8))),
    "n": lambda: (_key(_fs()), _key(_fs(n=4))),
    "count_all": lambda: (_key(_fs()), _key(_fs(), SolverConfig(
        min_lanes=8, stack_slots=16, step_impl="fused", count_all=True))),
    "steal": lambda: (_key(_fs()), _key(_fs(), SolverConfig(
        min_lanes=8, stack_slots=16, step_impl="fused", steal=False))),
    "steal_gang": lambda: (_key(_fs()), _key(_fs(), SolverConfig(
        min_lanes=8, stack_slots=16, step_impl="fused", steal_gang=8))),
    "tile": lambda: (_key(_fs()), _key(_fs(), rounds=cuda_step._rounds_fn(
        SUDOKU_9, FUSED_SMALL, 4))),
    "words": _three_word_states,
}


@pytest.mark.parametrize("field", list(KEY_CHANGES))
def test_graph_key_changes_with_what_the_chain_reads(field):
    before, after = KEY_CHANGES[field]()
    assert before != after


def test_graph_key_ignores_what_only_the_kernel_reads():
    """Rules, branch, sweeps and rounds a dispatch go to the kernel, which
    is launched outside the graph, and the values in the buffers are loaded
    each call: none of them is part of the key, nor is which closure of an
    instance's round function the caller built."""
    other = SolverConfig(min_lanes=8, stack_slots=16, step_impl="fused", fused_steps=32,
                         rules="basic", branch="head:mlp", max_sweeps=3, max_steps=9)
    fs = _fs()
    moved = type(fs)(*(t + 1 if t.dtype != torch.bool else ~t for t in fs))
    assert _key(moved, other) == _key(fs)
    assert _cover_key(nqueens_cover(6)) == _cover_key(nqueens_cover(6))


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


# -- the driver against the reference step ------------------------------------


def _reference(fs, config, limit, rounds_fn):
    """The fused loop's reference: ``_fused_round`` until ``_fused_go`` is
    false, each step counted as a dispatch of the call's recording."""
    rec = trace.current() or trace.OFF
    limit = cuda_step._step_limit(limit, config.max_steps)
    while bool(cuda_bookkeep._fused_go(fs, limit)):
        fs = cuda_step._fused_round(fs, config, rounds_fn)
        rec.count("fused.dispatch")
    return fs


def _counted(run, reference: bool, monkeypatch):
    """``run()`` through ``_run_fused`` or through the reference; returns
    its result, its round-function calls (at the benchmark's hooks), its
    dispatch, graph and spare counts, and the loop's calls that
    dispatched."""
    calls, runs = [], []
    for module, name in ((cuda_step, "fused_rounds"), (cuda_cover, "cover_fused_rounds")):
        def counting(*a, _orig=getattr(module, name), **k):
            calls.append(1)
            return _orig(*a, **k)

        monkeypatch.setattr(module, name, counting)
    loop = _reference if reference else cuda_step._run_fused

    def counting_loop(*a, **k):
        before = len(calls)
        out = loop(*a, **k)
        runs.append(len(calls) > before)
        return out

    monkeypatch.setattr(cuda_step, "_run_fused", counting_loop)
    monkeypatch.setattr(cuda_cover, "_run_fused", counting_loop)
    with trace.recording(keep=True) as rec:
        out = run()
    monkeypatch.undo()
    return (out, len(calls), rec.counts.get("fused.dispatch", 0), rec.counts.get("fused.graph", 0),
            rec.counts.get("fused.spare", 0), sum(runs))


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
def test_graph_path_equals_the_eager_loop(surface, monkeypatch):
    """Each surface through the driver on the CPU (its buffers, the round
    functions writing into ``out=``, ``bookkeep_plain`` in place) equals
    the reference step iterated: every field, the same dispatches and one
    spare a loop call that dispatched, and neither a graph round nor a run
    of the bookkeeping kernel."""
    run = SURFACES[surface]
    kernel_runs = cuda_bookkeep.bookkeep_cuda.launches
    got, calls, dispatches, graph_rounds, spares, runs = _counted(run, False, monkeypatch)
    want, ref_calls, ref_dispatches, _, ref_spares, ref_runs = _counted(run, True, monkeypatch)
    _equal(got, want)
    assert ref_calls == ref_dispatches > 0 and ref_spares == 0
    assert runs == ref_runs > 0 and spares == (cuda_step.LOOKAHEAD - 1) * runs
    assert calls == dispatches == ref_calls + spares
    assert graph_rounds == 0 and cuda_bookkeep.bookkeep_cuda.launches == kernel_runs
    if surface == "cover":
        assert int(got.sol_count.sum()) == 4  # the 6-queens solutions


def test_graph_path_returns_fresh_tensors_and_the_callers_stack(monkeypatch):
    """The result is neither written by a later call nor a view of the
    driver's buffers, each caller's stack is updated in place, and a call
    that dispatches nothing returns its input."""
    made = []

    class Kept(cuda_step._Rounds):
        def __init__(self, fs):
            super().__init__(fs)
            made.append(self)

    monkeypatch.setattr(cuda_step, "_Rounds", Kept)
    cfg = FUSED_SMALL
    rounds = cuda_step._rounds_fn(SUDOKU_9, cfg, 8)
    fs_a = start_frontier(torch.from_numpy(GRIDS), SUDOKU_9, cfg)
    fs_b = start_frontier(torch.from_numpy(GRIDS[::-1].copy()), SUDOKU_9, cfg)
    a = cuda_step._run_fused(fs_a, cfg, 4, rounds)
    kept = [t.clone() for t in a]
    b = cuda_step._run_fused(fs_b, cfg, 4, rounds)
    assert len(made) == 2  # the CPU builds a driver each call and keeps none
    _equal(list(a), kept)
    assert a.stack is fs_a.stack and b.stack is fs_b.stack
    buffers = {t.data_ptr() for g in made for t in (*g.state, *g.tops, g.sol, g.lane_out)}
    assert not buffers & {t.data_ptr() for t in (*a, *b)}
    assert not torch.equal(a.top, b.top)
    done = cuda_step._run_fused(a, cfg, 0, rounds)
    assert done is a and len(made) == 2
