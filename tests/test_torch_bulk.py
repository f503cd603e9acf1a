"""The port's in-flight bulk pipeline: results independent of ``inflight``, and its fault seam.

``solve_bulk`` keeps up to ``BulkConfig.inflight`` first-pass chunks in
flight with one drain worker.  On a CPU corpus that spans several chunks
(with a partial last chunk, an unsat board and boards that need search) the
results are bit-identical for every ``inflight``;
``faults.fire("bulk.dispatch")`` runs once per chunk and per rung dispatch,
and a seeded schedule's first fault stops the pass at that chunk.
"""

import numpy as np
import pytest

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops.bulk import BulkConfig, solve_bulk
from distributed_sudoku_solver_tpu_torch.serving import faults
from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution
from distributed_sudoku_solver_tpu_torch.utils.puzzles import make_puzzle

GEOM = Geometry(2, 3)
FIELDS = ("solution", "solved", "unsat", "by_propagation", "searched")


@pytest.fixture(scope="module")
def corpus():
    grids = np.stack([make_puzzle(GEOM, 300 + i, n_clues=13, unique=False)
                      for i in range(290)]).astype(np.int32)
    grids[7, 0, :2] = 1  # two 1s in one row: unsat
    return grids


@pytest.fixture(scope="module")
def serial(corpus):
    """Chunks drained one at a time (``inflight=1``)."""
    return solve_bulk(corpus, GEOM, BulkConfig(chunk=64, inflight=1), device="cpu")


def _same(got, want):
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f))), f


@pytest.mark.parametrize("inflight", [1, 2, 3])
def test_results_identical_for_every_inflight(corpus, serial, inflight):
    trace: dict = {}
    got = solve_bulk(corpus, GEOM, BulkConfig(chunk=64, inflight=inflight), trace=trace,
                     device="cpu")
    assert trace["chunks"] == 5 and trace["inflight"] == inflight
    assert all(trace[k] >= 0.0 for k in ("pack_s", "solve_s", "drain_s"))
    _same(got, serial)
    assert got.unsat[7] and not got.unsat[np.arange(len(corpus)) != 7].any()
    assert 0 < got.searched < got.solved.sum() == len(corpus) - 1
    assert all(is_valid_solution(s) for s in got.solution[got.solved])


def test_dispatch_seam_fires_once_per_chunk_and_rung_dispatch(corpus, serial):
    injector = faults.FaultInjector(faults.FaultSchedule.seeded(seed=3, rate=0.0))
    trace: dict = {}
    with faults.injected(injector):
        got = solve_bulk(corpus, GEOM, BulkConfig(chunk=64), trace=trace, device="cpu")
    _same(got, serial)
    rung_dispatches = sum(r["dispatches"] for r in trace["rungs"])
    assert injector.metrics()["dispatches"] == {"bulk.dispatch": 5 + rung_dispatches}
    assert injector.metrics()["injected"] == {}


@pytest.mark.parametrize("inflight", [1, 3])
def test_seeded_fault_stops_the_pass_at_its_chunk(corpus, inflight):
    schedule = faults.FaultSchedule.seeded(seed=11, rate=0.3)
    first = next(i for i in range(100) if schedule.lookup("bulk.dispatch", i) is not None)
    assert first < 5, "the seed must fault one of the five chunks"
    injector = faults.FaultInjector(schedule)
    with faults.injected(injector), pytest.raises(faults.SimulatedFault) as exc:
        solve_bulk(corpus, GEOM, BulkConfig(chunk=64, inflight=inflight), device="cpu")
    assert exc.value.site == "bulk.dispatch" and exc.value.index == first
    assert injector.dispatches("bulk.dispatch") == first + 1
