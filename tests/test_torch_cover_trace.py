"""``solve_csp`` on the exact-cover family, held to the benchmark's plain
reference, and its call-scoped recording.

The fused path on the CPU (the plain K3 rounds, ``step_impl="fused"``)
counts every exact cover of seeded random instances (with and without
secondary columns, with a planted cover or none), of n-queens 1-8 and of
the 3x20 pentomino box; ``portbench/reference/cover.py`` counts them its
own way.  Then the ``cover.solve`` span, its attributes and the host reads
of a traced and an untraced call.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu_torch.models.cover import build_cover
from distributed_sudoku_solver_tpu_torch.models.nqueens import nqueens_cover
from distributed_sudoku_solver_tpu_torch.models.pentomino import pentomino_cover
from distributed_sudoku_solver_tpu_torch.obs import trace
from distributed_sudoku_solver_tpu_torch.ops import cuda_cover
from distributed_sudoku_solver_tpu_torch.ops.cuda_cover import cover_fused_frontier
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.ops.solve import finalize_frontier, solve_csp
from portbench.reference import cover as ref

CFG = SolverConfig(lanes=32, stack_slots=128, max_steps=1_000_000, count_all=True,
                   steal_rounds=4, step_impl="fused")
DEVICE_KEYS = ("steps", "live_lane_rounds", "nodes", "steals", "solutions")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def random_instance(seed: int):
    """A bool incidence [R, C] and its primary columns: 20-80 rows over
    8-24 columns, the last 0-4 secondary on odd seeds; two seeds in three
    plant a cover (a partition of the primary columns into rows)."""
    g = np.random.default_rng(seed)
    n_cols = int(g.integers(8, 25))
    n_secondary = int(g.integers(1, 5)) if seed % 2 else 0
    n_primary = n_cols - n_secondary
    rows = []
    if seed % 3:
        cut = np.sort(g.choice(np.arange(1, n_primary), size=int(g.integers(2, 6)),
                               replace=False))
        for part in np.split(g.permutation(n_primary), cut):
            row = np.zeros(n_cols, dtype=bool)
            row[part] = True
            rows.append(row)
    while len(rows) < int(g.integers(20, 81)):
        row = np.zeros(n_cols, dtype=bool)
        row[g.choice(n_primary, size=int(g.integers(1, 5)), replace=False)] = True
        if n_secondary and g.random() < 0.5:
            row[n_primary + int(g.integers(n_secondary))] = True
        rows.append(row)
    return np.stack([rows[i] for i in g.permutation(len(rows))]), n_primary


def _solve(problem, config=CFG, **kw):
    return solve_csp(problem.initial_state()[None], problem, config, device="cpu", **kw)


def _assert_counts_and_cover(problem, incidence, n_primary, res, want):
    count = int(res.sol_count[0])
    assert count == want
    assert bool(res.unsat[0]) and not bool(res.overflowed[0])
    if count:
        rows = ref.chosen_rows(res.solution[0], problem.n_rows)
        assert ref.is_exact_cover(incidence, n_primary, rows)


@pytest.mark.parametrize("seed", range(24))
def test_fused_solve_csp_counts_what_the_reference_counts(seed):
    a, n_primary = random_instance(seed)
    problem = build_cover(f"random{seed}", a, n_primary)
    _assert_counts_and_cover(problem, a, n_primary, _solve(problem),
                             ref.count_exact_covers(a, n_primary, block=64))


def test_the_random_instances_hold_covers_and_none():
    counts = [ref.count_exact_covers(a, p, block=64)
              for a, p in map(random_instance, range(24))]
    assert sum(c == 0 for c in counts) >= 4 and sum(c > 1 for c in counts) >= 4


@pytest.mark.parametrize("n,want", [(1, 1), (2, 0), (3, 0), (4, 2), (5, 10), (6, 4), (7, 40),
                                    (8, 92)])
def test_nqueens_counts(n, want):
    inc, n_primary = ref.nqueens_incidence(n)
    assert ref.count_exact_covers(inc, n_primary) == want
    problem = nqueens_cover(n)
    _assert_counts_and_cover(problem, inc, n_primary,
                             _solve(problem, dataclasses.replace(CFG, lanes=16)), want)


def test_pentomino_3x20_counts_its_eight_tilings():
    problem = pentomino_cover(3, 20)
    inc = ref.bits(problem.incidence.view(np.int32), problem.n_cols_full)
    _assert_counts_and_cover(problem, inc, problem.n_primary, _solve(problem), 8)


def _watching(monkeypatch):
    """The recording each ``_run_fused`` call of the cover path sees."""
    seen, run = [], cuda_cover._run_fused

    def watching_run(*a, **k):
        seen.append(trace.current())
        return run(*a, **k)

    monkeypatch.setattr(cuda_cover, "_run_fused", watching_run)
    return seen


def test_cover_solve_span_holds_the_recordings_counts(monkeypatch):
    seen = _watching(monkeypatch)
    problem = nqueens_cover(6)
    tr: dict = {}
    res = _solve(problem, trace=tr)
    assert len(seen) == 1 and seen[0] is not None and trace.current() is None
    spans = tr["spans"]
    names = [s["name"] for s in spans]
    assert names[-1] == "cover.solve" and set(names[:-1]) == {"fused.dispatch", "fused.sync"}
    assert tr["k3_dispatches"] == names.count("fused.dispatch") > 1
    # One read before the loop and one a dispatch but the spare's, the one
    # dispatch enqueued after the flag fell.
    assert tr["spare_dispatches"] == 1
    assert tr["host_syncs"] == names.count("fused.sync") == (
        tr["k3_dispatches"] - tr["spare_dispatches"] + 1)
    assert tr["graph_rounds"] == 0  # the CPU runs the bookkeeping eagerly
    assert tr["lanes"] == CFG.lanes
    top = spans[-1]
    assert top["trace"] == tr["trace_id"] and tr["solve_s"] == pytest.approx(top["t1"] - top["t0"])
    assert top["attrs"] == {k: tr[k] for k in top["attrs"]}
    assert set(top["attrs"]) == {"k3_dispatches", "host_syncs", "graph_rounds",
                                 "spare_dispatches", "lanes", *DEVICE_KEYS}
    # The loop's spans tile it: each starts where the one before ended.
    loop = spans[:-1]
    assert loop[0]["name"] == "fused.sync" and loop[-1]["name"] == "fused.sync"
    assert all(b["t0"] == a["t1"] for a, b in zip(loop, loop[1:]))
    assert top["t0"] <= loop[0]["t0"] and loop[-1]["t1"] <= top["t1"]
    # The device's counts, read once after the loop.
    state = cover_fused_frontier(torch.from_numpy(problem.initial_state()[None]), problem, CFG)
    assert tr["live_lane_rounds"] == int(state.lane_rounds.sum()) > 0
    assert (tr["steps"], tr["nodes"], tr["steals"], tr["solutions"]) == (
        int(res.steps), int(res.nodes.sum()), int(res.steals), int(res.sol_count.sum()))
    assert tr["solutions"] == 4


def test_an_untraced_call_records_nothing(monkeypatch):
    seen = _watching(monkeypatch)
    rec = trace.TraceRecorder()
    _solve(nqueens_cover(5))
    assert seen == [None] and rec.spans() == []
    # Under an installed recorder the call records its spans there, with
    # only the counts the host holds: nothing is read for them.
    with trace.installed(rec):
        _solve(nqueens_cover(5))
    spans = rec.spans()
    top = [s for s in spans if s["name"] == "cover.solve"]
    assert len(top) == 1 and not set(DEVICE_KEYS) & set(top[0]["attrs"])
    assert top[0]["attrs"]["k3_dispatches"] == sum(s["name"] == "fused.dispatch" for s in spans)


class _Reads:
    """Counts the host reads of CPU tensors: scalar casts, ``item``,
    ``tolist``, ``numpy`` and ``cpu``."""

    METHODS = ("__bool__", "__int__", "__float__", "item", "tolist", "numpy", "cpu")

    def __init__(self, monkeypatch):
        self.n = 0
        for name in self.METHODS:
            orig = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, **k):
                self.n += 1
                return _orig(t, *a, **k)

            monkeypatch.setattr(torch.Tensor, name, counted)


def test_an_untraced_call_reads_the_device_no_more_than_the_search(monkeypatch):
    """An untraced ``solve_csp`` reads what the fused search and its
    finalize read (the calls the entry point made before it opened a
    recording), and a traced one one fetch more."""
    problem = nqueens_cover(6)
    roots = torch.from_numpy(problem.initial_state()[None])
    reads = _Reads(monkeypatch)
    finalize_frontier(cover_fused_frontier(roots, problem, CFG))
    bare, reads.n = reads.n, 0
    solve_csp(roots, problem, CFG, device="cpu")
    untraced, reads.n = reads.n, 0
    solve_csp(roots, problem, CFG, device="cpu", trace={})
    assert bare > 0 and untraced == bare and reads.n == bare + 1
