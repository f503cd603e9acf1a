"""The port's serving stack on a card, held against itself on the CPU.

Card-only (marked ``cuda``; a fixture skips them where no CUDA device is
visible), and free of JAX, so the chip machine runs them with
``--noconftest``.  A static flight of each step (composite with the plain
propagation, composite with K1, fused with K2), driven by hand so the
chunk schedule is fixed, gives the same verdicts, node counts and
solutions on the card as on the CPU (K1 and K2 are bit-equal to their
plain versions); so do the resident flight and the megastep, whose
verdicts are compared.  ``host_fetch`` crosses a frontier in one copy.
Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
from distributed_sudoku_solver_tpu_torch.ops import cuda_propagate, cuda_step
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.serving.engine import Job, SolverEngine, host_fetch
from distributed_sudoku_solver_tpu_torch.serving.megastep import MegastepConfig
from distributed_sudoku_solver_tpu_torch.serving.scheduler import ResidentConfig
from distributed_sudoku_solver_tpu_torch.utils.puzzles import EASY_9, HARD_9

SMALL = SolverConfig(min_lanes=8, stack_slots=16)
CONFIGS = {
    "xla": SMALL,
    "pallas": SolverConfig(min_lanes=8, stack_slots=16, propagator="pallas"),
    "fused": SolverConfig(min_lanes=8, stack_slots=16, step_impl="fused", fused_steps=2),
}


def _boards():
    bad = np.zeros((9, 9), np.int32)
    bad[0, 0] = bad[0, 1] = 5
    return [np.asarray(b, np.int32) for b in HARD_9] + [np.asarray(EASY_9, np.int32), bad]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _static_flight(cfg, device):
    eng = SolverEngine(config=cfg, max_batch=8, chunk_steps=4, device=device)
    jobs = [Job(uuid=f"j{i}", grid=b, geom=SUDOKU_9) for i, b in enumerate(_boards())]
    eng._launch_flights(SUDOKU_9, cfg, jobs)
    fl = eng._flights.pop()
    while not eng._advance_flight(fl):
        pass
    return [(j.solved, j.unsat, j.nodes, None if j.solution is None else j.solution.tolist())
            for j in jobs]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_static_flight_on_the_card_equals_the_cpu(cuda_device, name):
    cfg = CONFIGS[name]
    k1, k2 = cuda_propagate.propagate_fixpoint_cuda.launches, cuda_step.fused_rounds_cuda.launches
    got = _static_flight(cfg, cuda_device)
    if name == "pallas":
        assert cuda_propagate.propagate_fixpoint_cuda.launches > k1
    if name == "fused":
        assert cuda_step.fused_rounds_cuda.launches > k2
    assert got == _static_flight(cfg, "cpu")


def _served(cfg, device, **kw):
    eng = SolverEngine(config=cfg, max_batch=8, device=device, **kw).start()
    try:
        jobs = [eng.submit(b) for b in _boards()]
        for j in jobs:
            assert j.wait(120), j.error
        return [(j.solved, j.unsat) for j in jobs], eng.metrics()
    finally:
        eng.stop(timeout=5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["xla", "fused"])
@pytest.mark.parametrize("route", ["resident", "megastep"])
def test_resident_and_megastep_on_the_card_equal_the_cpu(cuda_device, name, route):
    kw = (dict(resident=ResidentConfig(job_slots=4, gang_lanes=4, chunk_steps=16))
          if route == "resident" else
          dict(latency_mode=True, megastep=MegastepConfig(chunk_steps=16)))
    got, m = _served(CONFIGS[name], cuda_device, **kw)
    want, _ = _served(CONFIGS[name], "cpu", **kw)
    assert got == want
    assert m["fused_downgrades"] == 0
    assert m[route]["9x9"]["completed" if route == "resident" else "flights"] == len(got)


@pytest.mark.cuda
def test_host_fetch_crosses_a_frontier_in_one_copy(cuda_device, monkeypatch):
    from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
    from distributed_sudoku_solver_tpu_torch.ops.frontier import init_frontier

    grids = torch.from_numpy(np.stack(_boards())).to(cuda_device)
    state = init_frontier(encode_grid(grids, SUDOKU_9), SMALL)
    copies = []
    orig = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: (
        copies.append(self.device), orig(self, *a, **k))[1])
    host = host_fetch(state, tag="control")
    monkeypatch.undo()
    assert copies == [cuda_device] or [str(c) for c in copies] == ["cuda:0"]
    for name, a, b in zip(state._fields, state, host):
        np.testing.assert_array_equal(b, a.cpu().numpy(), err_msg=name)
