"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU (no look for a card, small
sizes) with one fault planted in the program where its answers are made,
and sees ``correct`` come out false; the sound run beside them comes out
true.  The faults a solver's cells can have: a pass that returns its boards
unchanged, half of the batch left out, one answer altered where it is
produced, and, on the served path, answers that never come.  The control
(``portbench/control.py``, a relabelled answer) is held to the same.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from portbench import control, core
from portbench.tests.cells import later_bench

BULK = {"batch": 8, "batches": 2}
SERVE = {"rate_rps": 3.0, "warm": 4, "conns": 16}


def _bulk(monkeypatch, fault=None, answers=None):
    from distributed_sudoku_solver_tpu_torch.ops import bulk as bulk_mod

    if fault is not None:
        orig = bulk_mod.solve_bulk

        def broken(grids, *a, **k):
            return fault(np.asarray(grids), orig(grids, *a, **k))

        monkeypatch.setattr(bulk_mod, "solve_bulk", broken)
    return core.run_cell("sudoku16-bulk", 2**31 + 21, 0.3, False, time.perf_counter(),
                         device="cpu", answers=answers, traffic=BULK)


def unchanged(grids, res):
    res.solution = grids.astype(np.int32).copy()
    res.solved[:] = True
    return res


def half_left_out(grids, res):
    half = len(grids) // 2
    res.solution[half:] = 0
    res.solved[half:] = False
    return res


def one_altered(grids, res):
    i = int(np.flatnonzero(res.solved)[0])
    res.solution[i, 0, 0] = res.solution[i, 0, 0] % res.solution.shape[-1] + 1
    return res


def test_a_sound_bulk_run_is_correct(monkeypatch):
    assert _bulk(monkeypatch)["correct"] is True


@pytest.mark.parametrize("fault", [unchanged, half_left_out, one_altered],
                         ids=lambda f: f.__name__)
def test_a_broken_bulk_pass_is_not_correct(monkeypatch, fault):
    line = _bulk(monkeypatch, fault)
    assert line["correct"] is False
    assert sum(c["value"] for c in line["checks"].values()) > 0


def test_the_bulk_control_is_not_correct(monkeypatch):
    line = _bulk(monkeypatch, answers=control.bulk_hook)
    assert line["correct"] is False and line["checks"]["wrong_answers"]["value"] > 0


def _serve(monkeypatch, fault=None, answers=None):
    from distributed_sudoku_solver_tpu_torch.serving import http as http_mod

    if fault is not None:
        orig = http_mod._Handler._send

        def broken(self, code, body, headers=None):
            if code == 201 and "solution" in body:
                out = fault(self, body)
                if out is None:  # the answer never leaves the node
                    self.close_connection = True
                    return None
                body = out
            return orig(self, code, body, headers)

        monkeypatch.setattr(http_mod._Handler, "_send", broken)
    return core.run_cell("sudoku9-serve-device", 2**31 + 5, 3.0, False, time.perf_counter(),
                         device="cpu", answers=answers, bench=later_bench(), traffic=SERVE)


def echo_board(handler, body):
    return {**body, "solution": [[0] * 9 for _ in range(9)]}


def answer_altered(handler, body):
    sol = [row[:] for row in body["solution"]]
    sol[0][0] = sol[0][0] % 9 + 1
    return {**body, "solution": sol}


def never_answers(handler, body):
    return None


def test_a_sound_serve_run_is_correct(monkeypatch):
    line = _serve(monkeypatch)
    assert line["correct"] is True and line["attempted"] == 9
    json.dumps(line)


@pytest.mark.parametrize("fault", [echo_board, answer_altered, never_answers],
                         ids=lambda f: f.__name__)
def test_a_broken_serve_answer_is_not_correct(monkeypatch, fault):
    line = _serve(monkeypatch, fault)
    assert line["correct"] is False


def test_the_serve_control_is_not_correct(monkeypatch):
    line = _serve(monkeypatch, answers=control.serve_hook)
    assert line["correct"] is False and line["checks"]["wrong_answers"]["value"] > 0
