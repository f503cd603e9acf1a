"""K1, K2 and K3 on every shard of a four-shard mesh on one card, against
their plain versions (``-m cuda``; skipped where there is no card).

Each sharded driver runs twice on the same boards inside
``virtual_devices(4)``: once through the kernels, once with the kernel's
wrapper swapped for its plain version on the card.  Every field of the
result must be equal (integer bit algebra: exact), and each kernel must
have launched on every shard of every round.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
from distributed_sudoku_solver_tpu_torch.models.nqueens import nqueens_cover
from distributed_sudoku_solver_tpu_torch.ops import cuda_cover, cuda_propagate, cuda_step
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.parallel import (
    solve_batch_fused_sharded,
    solve_batch_sharded,
    solve_csp_fused_sharded,
    virtual_devices,
)
from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9, make_puzzle


@pytest.fixture
def card_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    with virtual_devices(4):
        yield torch.device("cuda")


def _grids(count: int = 124) -> np.ndarray:
    carved = [make_puzzle(SUDOKU_9, 900 + i, n_clues=24, unique=False) for i in range(count)]
    return np.stack([*HARD_9, *carved]).astype(np.int32)


def _assert_equal(got, want):
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
def test_k2_on_every_shard_matches_plain(card_mesh, monkeypatch):
    cfg = SolverConfig(step_impl="fused", rules="extended", stack_slots=12, fused_steps=4)
    cuda_step.fused_rounds_cuda.launches = 0
    got = solve_batch_fused_sharded(_grids(), SUDOKU_9, cfg, device=card_mesh)
    launches = cuda_step.fused_rounds_cuda.launches
    assert launches >= 4 and launches % 4 == 0
    monkeypatch.setattr(cuda_step, "fused_rounds", cuda_step.fused_rounds_plain)
    want = solve_batch_fused_sharded(_grids(), SUDOKU_9, cfg, device=card_mesh)
    assert cuda_step.fused_rounds_cuda.launches == launches
    _assert_equal(got, want)


@pytest.mark.cuda
def test_k3_on_every_shard_matches_plain(card_mesh, monkeypatch):
    p = nqueens_cover(9)
    roots = p.initial_state()[None]
    cfg = SolverConfig(step_impl="fused", min_lanes=512, stack_slots=64, count_all=True)
    cuda_cover.cover_fused_rounds_cuda.launches = 0
    got = solve_csp_fused_sharded(roots, p, cfg, device=card_mesh)
    launches = cuda_cover.cover_fused_rounds_cuda.launches
    assert launches >= 4 and launches % 4 == 0
    assert int(got.sol_count[0]) == 352
    monkeypatch.setattr(cuda_cover, "cover_fused_rounds", cuda_cover.cover_fused_rounds_plain)
    want = solve_csp_fused_sharded(roots, p, cfg, device=card_mesh)
    assert cuda_cover.cover_fused_rounds_cuda.launches == launches
    _assert_equal(got, want)


@pytest.mark.cuda
def test_k1_on_every_shard_matches_plain(card_mesh):
    cfg = SolverConfig(propagator="pallas", stack_slots=32)
    cuda_propagate.propagate_fixpoint_cuda.launches = 0
    got = solve_batch_sharded(_grids(60), SUDOKU_9, cfg, device=card_mesh)
    launches = cuda_propagate.propagate_fixpoint_cuda.launches
    assert launches >= 4 * int(got.steps)
    want = solve_batch_sharded(_grids(60), SUDOKU_9, dataclasses.replace(cfg, propagator="xla"),
                               device=card_mesh)
    assert cuda_propagate.propagate_fixpoint_cuda.launches == launches
    _assert_equal(got, want)
