"""The benchmark's exact-cover cell on the CPU: the reference's instances,
the ``cover`` driver and its judge, the readers of the cell's per-layer
metrics, and the frozen K3 replay held to the program today.

The driver runs at a small size (the 3x20 box over 16 lanes, from a copy
of the cell's configuration): its set-up gets the program's answer, solved
once for the module, and its window solves through the program, or gets
that answer with one fault planted; the judge must see each.  ``-m cuda`` runs the cell
traced on a card and reads K3's roofline.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu_torch.models.nqueens import nqueens_cover
from distributed_sudoku_solver_tpu_torch.models.pentomino import pentomino_cover
from distributed_sudoku_solver_tpu_torch.ops import cuda_cover
from distributed_sudoku_solver_tpu_torch.ops import solve as solve_mod
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig, init_frontier
from portbench import core
from portbench.reference import cover as ref
from portbench.yardstick import k3_replay

import chip_smoke

CELL = "cover-pentomino"
BOX = {"rectangles": [[3, 20]], "counts": [8]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _program_incidence(problem) -> np.ndarray:
    return ref.bits(problem.incidence.view(np.int32), problem.n_cols_full)


@pytest.mark.parametrize("box", [(6, 10), (5, 12), (4, 15), (3, 20)])
def test_the_references_rectangles_hold_the_programs_rows(box):
    inc, n_primary = ref.pentomino_incidence(*box)
    problem = pentomino_cover(*box)
    assert n_primary == problem.n_primary == 72
    assert ref.same_rows(inc, _program_incidence(problem))


@pytest.mark.parametrize("n", range(1, 9))
def test_the_references_queens_hold_the_programs_rows(n):
    inc, n_primary = ref.nqueens_incidence(n)
    problem = nqueens_cover(n)
    assert n_primary == problem.n_primary
    assert ref.same_rows(inc, _program_incidence(problem))


def test_same_rows_tells_a_changed_row_and_a_repeated_one():
    inc, _ = ref.pentomino_incidence(3, 20)
    assert ref.same_rows(inc, inc[::-1])
    moved = inc.copy()
    moved[5, 12:] = np.roll(moved[5, 12:], 1)
    assert not ref.same_rows(inc, moved)
    repeated = inc.copy()
    repeated[1] = repeated[0]
    assert not ref.same_rows(repeated, repeated)


def test_chosen_rows_and_the_judge_of_a_cover():
    problem = nqueens_cover(6)
    inc, n_primary = ref.nqueens_incidence(6)
    res = solve_mod.solve_csp(problem.initial_state()[None], problem,
                              SolverConfig(lanes=16, stack_slots=64, step_impl="fused"),
                              device="cpu")
    rows = ref.chosen_rows(res.solution[0], problem.n_rows)
    assert rows == sorted(int(r) for r in problem.chosen_rows(res.solution[0]))
    assert ref.is_exact_cover(inc, n_primary, rows)
    assert not ref.is_exact_cover(inc, n_primary, rows[1:])
    assert not ref.is_exact_cover(inc, n_primary, rows + [rows[0]])
    assert not ref.is_exact_cover(inc, n_primary, rows[:-1] + [len(inc)])
    other = next(r for r in range(len(inc)) if r not in rows)
    assert not ref.is_exact_cover(inc, n_primary, rows + [other])


def _bench(tmp_path) -> dict:
    """The benchmark with the cell's configuration copied at 16 lanes."""
    bench = core.spec()
    cfg = core.load_json(os.path.join(core.ROOT, "portbench/configs/cover-count.json"))
    cfg["solver_config"]["lanes"] = 16
    path = tmp_path / "cover-count.json"
    path.write_text(json.dumps(cfg))
    bench["configs"] = [dict(c, file=str(path)) if c["name"] == "cover-count" else c
                        for c in bench["configs"]]
    return bench


@pytest.fixture(scope="module")
def box_answer():
    """The program's answer for the 3x20 box at the tests' 16 lanes."""
    cfg = core.load_json(os.path.join(core.ROOT, "portbench/configs/cover-count.json"))
    problem = pentomino_cover(*BOX["rectangles"][0])
    return solve_mod.solve_csp(problem.initial_state()[None], problem,
                               SolverConfig(**dict(cfg["solver_config"], lanes=16)), device="cpu")


def _answering(monkeypatch, answer, window):
    """``solve_csp`` gives ``answer`` in the set-up (one solve a board) and
    ``window(...)`` in the window."""
    calls = []

    def answering(*a, **k):
        calls.append(1)
        return answer if len(calls) <= len(BOX["rectangles"]) else window(*a, **k)

    monkeypatch.setattr(solve_mod, "solve_csp", answering)


def _off_by_one(res):
    return res._replace(sol_count=res.sol_count + 1)


def _overflowed(res):
    return res._replace(overflowed=torch.ones_like(res.overflowed))


def _corrupted(res):
    solution = res.solution.clone()
    solution[0, 0, 0] ^= 1  # row 0 taken or dropped
    return res._replace(solution=solution)


def _unexhausted(res):
    return res._replace(unsat=torch.zeros_like(res.unsat))


@pytest.mark.parametrize("fault,check", [
    (None, None), (_off_by_one, "wrong_counts"), (_overflowed, "overflowed_boards"),
    (_corrupted, "invalid_solutions"), (_unexhausted, "unexhausted_boards")])
def test_the_cover_driver_judges_every_board(monkeypatch, tmp_path, box_answer, fault, check):
    _answering(monkeypatch, box_answer, solve_mod.solve_csp if fault is None
               else lambda *a, **k: fault(box_answer))
    line = core.run_cell(CELL, 2**31 + 41, 0.3, False, time.perf_counter(), device="cpu",
                         bench=_bench(tmp_path), traffic=BOX)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == {"wrong_counts", "unexhausted_boards", "overflowed_boards",
                                   "invalid_solutions"}
    assert set(line["metrics"]) == {"boards_per_s", "setup_s"}
    assert line["attempted"] >= 1
    assert line["info"]["reference_counts"] == BOX["counts"]
    if fault is None:
        assert line["correct"] is True and line["failed"] == 0
        assert all(c["value"] == 0 for c in line["checks"].values())
        return
    assert line["correct"] is False and line["failed"] == line["attempted"]
    assert line["checks"][check]["value"] == line["attempted"]
    assert all(c["value"] == 0 for name, c in line["checks"].items() if name != check)


def test_a_count_the_reference_disputes_is_wrong(monkeypatch, tmp_path, box_answer):
    """A published count the reference does not reach fails every board of
    its instance, though the program agrees with it."""
    _answering(monkeypatch, box_answer, lambda *a, **k: box_answer)
    monkeypatch.setattr(ref, "count_exact_covers", lambda inc, p, block=ref.BLOCK: 3)
    line = core.run_cell(CELL, 7, 0.2, False, time.perf_counter(), device="cpu",
                         bench=_bench(tmp_path), traffic=BOX)
    assert not line["correct"]
    assert line["checks"]["wrong_counts"]["value"] == line["attempted"]


T = 1000.0
NS = 10**9


def _span(name, t0, t1):
    return {"name": name, "t0": T + t0, "t1": T + t1}


PROFILE = {"window_s": 1.0, "busy_s": 0.375,
           "device": [("k", round(T * NS), round((T + 0.25) * NS)),
                      ("k", round((T + 0.5) * NS), round((T + 0.625) * NS))]}
TRACES = [
    {"k3_dispatches": 60, "graph_rounds": 52, "lanes": 100, "steps": 40,
     "live_lane_rounds": 1000,
     "spans": [_span("fused.sync", 0.125, 0.375), _span("fused.dispatch", 0.375, 0.5)]},
    {"k3_dispatches": 70, "graph_rounds": 65, "lanes": 100, "steps": 60,
     "live_lane_rounds": 4000,
     "spans": [_span("fused.dispatch", 0.5625, 0.75), _span("cover.solve", 0.0, 1.0)]},
]
READERS = ("k3_dispatches_per_board.cover", "lane_occupancy_pct.cover",
           "dispatch_idle_pct.cover", "k3_roofline_pct.cover", "device_idle_pct.cover",
           "fused_graph_pct.cover")


@pytest.mark.parametrize("name,want", [
    ("k3_dispatches_per_board.cover", 65.0), ("lane_occupancy_pct.cover", 50.0),
    ("dispatch_idle_pct.cover", 37.5), ("k3_roofline_pct.cover", 25.0),
    ("device_idle_pct.cover", 62.5), ("fused_graph_pct.cover", 90.0)])
def test_the_cover_readers_give_the_exact_value(name, want):
    r = {"cover_traces": TRACES, "profile": PROFILE, "k3": {"bound_ms": 0.5, "device_ms": 2.0}}
    assert core.reader(name)(r) == want


@pytest.mark.parametrize("name", READERS)
def test_the_cover_readers_return_none_with_nothing_to_read(name):
    """Nothing read, or a window traced on a program whose ``solve_csp``
    keeps no trace (the driver's readings then hold no trace; the device's
    idle share reads the window alone)."""
    read = core.reader(name)
    assert read({}) is None
    assert read({"cover_traces": [{"spans": []}], "k3": {"device_ms": 0}}) is None
    if name != "device_idle_pct.cover":
        assert read({"cover_traces": [], "profile": PROFILE}) is None


def _frontiers():
    """Small cover frontiers, grown from one root by fused dispatches."""
    cfg = SolverConfig(lanes=64, stack_slots=16, max_steps=10**6, count_all=True, steal_rounds=4,
                       step_impl="fused")
    for problem, steps in ((nqueens_cover(8), 40), (pentomino_cover(3, 20), 56)):
        state = init_frontier(torch.from_numpy(problem.initial_state()[None]), cfg)
        state = cuda_cover.advance_cover_fused(state, steps, problem, cfg)
        yield problem, (state.top, state.stack, state.has_top, state.base, state.count)


@pytest.mark.parametrize("count_mode", [False, True])
def test_the_frozen_k3_replay_agrees_with_the_program_today(count_mode):
    for problem, f in _frontiers():
        assert int(f[2].sum()) >= 8
        kw = dict(max_sweeps=problem.max_sweeps, k_steps=8, tile=64, count_mode=count_mode)
        out = cuda_cover.cover_fused_rounds_plain(*[x.clone() for x in f], problem, **kw)
        state, work = k3_replay.rounds(*f, problem, **kw)
        for key, j in (("stack", 1), ("has", 2), ("count", 4), ("solved", 5), ("sol", 6),
                       ("overflow", 7), ("nodes", 8), ("sols", 9), ("live_rounds", 10)):
            assert torch.equal(state[key], out[j]), key
        assert state["sweeps"] == int(out[11])
        smoke = chip_smoke.cover_dispatch_work(problem, f[0], f[1].clone(), *f[2:], **kw)
        assert {k: work[k] for k in smoke} == smoke
        pushes, pops = int(out[8].sum()), int((f[4] + out[8] - out[4]).sum())
        assert (work["nodes"], work["pops"], work["lanes"]) == (pushes, pops, 64)
        inst = k3_replay.Instance(problem, "cpu")
        n_ops = chip_smoke.cover_dispatch_ops(problem, smoke, pushes, pushes + pops)
        assert k3_replay.dispatch_ops(inst, work) == pytest.approx(n_ops, rel=1e-12)
        d = f[0].shape[-1]
        consts = problem.n_cols_full * problem.w_rows + problem.row_list().size
        n_bytes = (3 * 64 * d + (pushes + pops) * d + consts) * 4 + 11 * 64 * 4
        assert k3_replay.dispatch_bytes(inst, work) == n_bytes
        assert k3_replay.bound(inst, work) == pytest.approx(chip_smoke.bound_ms(n_bytes, n_ops))


class _FakeCover:
    """``ops.cuda_cover`` as ``_k3_reading`` sees it: ``cover_fused_rounds``
    and the launch counter of ``cover_fused_rounds_cuda``."""

    def __init__(self):
        cover = self

        class Cuda:
            launches = 0

        self.cover_fused_rounds_cuda = Cuda

        def cover_fused_rounds(*args, **kw):
            cover.cover_fused_rounds_cuda.launches += 1

        self.cover_fused_rounds = cover_fused_rounds


@pytest.mark.parametrize("events,launches,dispatches,total,raises", [
    (6, 6, 2, 2, None), (5, 6, 2, 2, "lost K3 records"), (6, 6, 3, 2, "dispatched K3 2 times"),
    (100, 100, 90, 90, None)])
def test_the_k3_reading_replays_evenly_spaced_dispatches_or_fails(
        monkeypatch, events, launches, dispatches, total, raises):
    from portbench.drivers import cover

    fake = _FakeCover()
    device = [("void cover_kernel<3, 3, 1>(...)", 1000 * j, 1000 * j + 250_000 * (j + 1))
              for j in range(events)]
    picks = []

    def rounds(*a, **k):
        picks.append(fake.cover_fused_rounds_cuda.launches)
        return None, {}

    monkeypatch.setattr(k3_replay, "Instance", lambda problem, device: problem)
    monkeypatch.setattr(k3_replay, "rounds", rounds)
    monkeypatch.setattr(k3_replay, "bound", lambda inst, work: (0.1, "operations"))
    top = torch.zeros(4, 1, 3, dtype=torch.int32)

    def rerun():
        for _ in range(total):
            fake.cover_fused_rounds(top, None, None, None, None, "problem", k_steps=8)

    in_pass = range(launches - dispatches, launches)
    if raises:
        with pytest.raises(RuntimeError, match=raises):
            cover._k3_reading({"device": device}, launches, in_pass, rerun, fake)
        return
    out = cover._k3_reading({"device": device}, launches, in_pass, rerun, fake)
    assert out["dispatches"] == dispatches and out["replayed"] == len(picks)
    assert len(picks) == min(dispatches, cover.REPLAYED)
    assert picks[0] == 0 and picks[-1] == dispatches - 1
    assert out["bound_ms"] == pytest.approx(0.1 * len(picks))
    assert out["device_ms"] == pytest.approx(
        sum(250_000 * (in_pass[j] + 1) for j in picks) / 1e6)


def test_the_reference_imports_numpy_and_nothing_of_the_program():
    import ast

    path = os.path.join(core.ROOT, "portbench", "reference", "cover.py")
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "numpy"}, names


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_traced_cover_run_on_the_card_reads_k3_roofline(card):
    line = core.run_cell(CELL, 2**31 + 99, 2.0, True, time.perf_counter())
    assert line["correct"]
    roof = line["metrics"]["k3_roofline_pct.cover"]["value"]
    assert 0 < roof <= 100
    assert set(line["metrics"]) == set(READERS)
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
