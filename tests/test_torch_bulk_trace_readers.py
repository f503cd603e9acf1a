"""The benchmark's readers of ``solve_bulk``'s spans and counts.

``k2_dispatches_per_pass.bulk``, ``host_syncs_per_pass.bulk``,
``dispatch_idle_pct.bulk`` and ``fused_graph_pct.bulk``
(``portbench/metrics/``), loaded by name as the harness loads them, are fed
synthetic passes and a synthetic profile whose idle time inside and outside
the fused loop's spans is known, then the trace of a real pass on the CPU.
"""

import numpy as np
import pytest

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops.bulk import BulkConfig, solve_bulk
from distributed_sudoku_solver_tpu_torch.utils.puzzles import make_puzzle
from portbench import core

READERS = ("k2_dispatches_per_pass.bulk", "host_syncs_per_pass.bulk", "dispatch_idle_pct.bulk",
           "fused_graph_pct.bulk")
T = 1000.0  # a span clock whose ns are exact in a float
NS = 10**9


def _span(name, t0, t1):
    return {"name": name, "t0": T + t0, "t1": T + t1}


def _dev(t0, t1):
    return ("kernel", round((T + t0) * NS), round((T + t1) * NS))


# Device busy [0, 0.25] and [0.5, 0.625] of a 1 s window; the fused loop's
# spans leave it idle for 0.125 s in each of [0.25, 0.375], [0.375, 0.5]
# and [0.625, 0.75]; a pack span covers the idle [0.75, 1.0], outside the
# loop.  A sync nested in a dispatch counts once.
PROFILE = {"window_s": 1.0, "busy_s": 0.375, "device": [_dev(0.0, 0.25), _dev(0.5, 0.625)]}
TRACES = [
    {"k2_dispatches": 430, "host_syncs": 500,
     "spans": [_span("fused.sync", 0.125, 0.375), _span("fused.dispatch", 0.375, 0.5)]},
    {"k2_dispatches": 441, "host_syncs": 511,
     "spans": [_span("fused.dispatch", 0.5625, 0.75), _span("fused.sync", 0.6875, 0.75),
               _span("bulk.pack", 0.75, 1.0), _span("bulk.pass", 0.0, 1.0)]},
]


@pytest.mark.parametrize("name, want", [
    ("k2_dispatches_per_pass.bulk", 435.5),
    ("host_syncs_per_pass.bulk", 505.5),
    ("dispatch_idle_pct.bulk", 37.5),
])
def test_readers_give_the_exact_value(name, want):
    read = core.reader(name)
    assert read({"bulk_traces": TRACES, "profile": PROFILE}) == want
    assert read({}) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_of_a_program_without_the_counts_return_none(name):
    """A pass traced by a program that records neither spans nor counts
    (the parent of this change) reads nothing, and raises nothing."""
    old = [{"pack_s": 0.1, "first_pass_s": 1.0, "remaining_after_first": 3, "rungs": []}]
    assert core.reader(name)({"bulk_traces": old, "profile": PROFILE}) is None


def test_dispatch_idle_needs_a_profile_and_loop_spans():
    read = core.reader("dispatch_idle_pct.bulk")
    assert read({"bulk_traces": TRACES}) is None
    assert read({"bulk_traces": [{"spans": [_span("bulk.pack", 0, 1)]}],
                 "profile": PROFILE}) is None
    # An idle device leaves all of the loop's union idle: 0.5625 s of 1 s.
    assert read({"bulk_traces": TRACES, "profile": {**PROFILE, "device": []}}) == 56.25


def test_fused_graph_share_sums_over_passes():
    """Graph rounds over K2 dispatches, summed over the passes that count
    graph rounds; None where none does, or where nothing was dispatched."""
    read = core.reader("fused_graph_pct.bulk")
    traces = [{"k2_dispatches": 300, "graph_rounds": 300},
              {"k2_dispatches": 100, "graph_rounds": 0}]
    assert read({"bulk_traces": traces}) == 75.0
    assert read({"bulk_traces": traces + TRACES}) == 75.0
    assert read({"bulk_traces": TRACES}) is None
    assert read({"bulk_traces": [{"k2_dispatches": 0, "graph_rounds": 0}]}) is None
    assert read({}) is None


def test_dispatch_idle_interval_arithmetic():
    mod = core.reader("dispatch_idle_pct.bulk").__globals__
    busy = [[1, 2], [4, 6], [9, 20]]
    assert mod["idle_ns"]([[0, 3], [5, 10]], busy) == 2 + 3


def test_readers_on_a_real_pass():
    """A traced pass on the CPU: the counters read the pass's own counts,
    and with no device operation the loop's spans are all idle."""
    geom = Geometry(2, 3)
    grids = np.stack([make_puzzle(geom, 300 + i, n_clues=13, unique=False)
                      for i in range(64)]).astype(np.int32)
    tr: dict = {}
    solve_bulk(grids, geom, BulkConfig(chunk=64, stack_slots=1, first_pass_steps=1,
                                       max_sweeps=1, step_impl="fused",
                                       rung_step_impl="fused"),
               trace=tr, device="cpu")
    r = {"bulk_traces": [tr], "profile": {"window_s": 10.0, "busy_s": 0.0, "device": []}}
    assert core.reader("k2_dispatches_per_pass.bulk")(r) == tr["k2_dispatches"] > 0
    assert core.reader("host_syncs_per_pass.bulk")(r) == tr["host_syncs"] > tr["k2_dispatches"]
    # The CPU runs the bookkeeping eagerly: no dispatch is a graph round.
    assert tr["graph_rounds"] == 0 and core.reader("fused_graph_pct.bulk")(r) == 0.0
    loop = [s["t1"] - s["t0"] for s in tr["spans"]
            if s["name"] in ("fused.dispatch", "fused.sync")]
    # In ns an epoch-clock float is good to 256 ns, so each span to 512 ns.
    assert core.reader("dispatch_idle_pct.bulk")(r) == pytest.approx(
        10.0 * sum(loop), abs=10.0 * len(loop) * 512e-9)
