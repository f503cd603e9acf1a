"""Port parity: propagation rules and the fixpoint (K1's plain path) against JAX.

Corpus and random boards come from numpy seeds; JAX's
``propagate_fixpoint_pallas`` runs as its own tests run it on the CPU (Pallas
interpret mode).  Tolerance: exact equality of masks and sweep counts.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distributed_sudoku_solver_tpu.models.geometry import Geometry as JGeometry
from distributed_sudoku_solver_tpu.ops.pallas_propagate import (
    propagate_fixpoint_pallas as jax_fixpoint_pallas,
)
from distributed_sudoku_solver_tpu.utils.puzzles import make_puzzle
from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops import cuda_propagate
from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid

jp = importlib.import_module("distributed_sudoku_solver_tpu.ops.propagate")
tp = importlib.import_module("distributed_sudoku_solver_tpu_torch.ops.propagate")

GEOMS = [(2, 2), (2, 3), (3, 3)]


def _boards(bh, bw, count=24, seed=0):
    """Carved puzzles at ~30% clues plus random masks (mostly contradictory)."""
    jg = JGeometry(bh, bw)
    n = jg.n
    grids = np.stack([
        make_puzzle(jg, seed + i, n_clues=int(n * n * 0.3), unique=False) for i in range(count)
    ]).astype(np.int32)
    cand = encode_grid(torch.from_numpy(grids), Geometry(bh, bw)).numpy().view(np.uint32)
    rng = np.random.default_rng(seed + 99)
    rand = rng.integers(0, 2**n, size=(8, n, n)).astype(np.uint32)
    return np.concatenate([cand, rand])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _j(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("bh,bw", GEOMS)
def test_sweeps_and_status_match_jax(bh, bw):
    jg, tg = JGeometry(bh, bw), Geometry(bh, bw)
    cand = _boards(bh, bw)
    for name in ("propagate_sweep", "box_line_sweep", "naked_subsets_sweep"):
        want = _j(getattr(jp, name)(jnp.asarray(cand), jg))
        got = getattr(tp, name)(_t(cand), tg).numpy()
        assert np.array_equal(got, want), name
    js, ts = jp.board_status(jnp.asarray(cand), jg), tp.board_status(_t(cand), tg)
    assert np.array_equal(ts.solved.numpy(), np.asarray(js.solved))
    assert np.array_equal(ts.contradiction.numpy(), np.asarray(js.contradiction))


@pytest.mark.parametrize("rules", ["basic", "extended", "subsets"])
@pytest.mark.parametrize("bh,bw", GEOMS)
def test_fixpoint_matches_jax_on_every_tier(bh, bw, rules):
    jg, tg = JGeometry(bh, bw), Geometry(bh, bw)
    cand = _boards(bh, bw, seed=bh * 5 + bw)
    want, want_sweeps = jp.propagate(jnp.asarray(cand), jg, rules=rules)
    got, sweeps = tp.propagate(_t(cand), tg, rules=rules)
    assert np.array_equal(got.numpy(), _j(want))
    assert int(sweeps) == int(want_sweeps)
    # Per-board counts: same masks, max over boards is the batch count.
    per_mask, per_board = tp.propagate_per_board(_t(cand), tg, rules=rules)
    assert np.array_equal(per_mask.numpy(), _j(want))
    assert int(per_board.max()) == int(want_sweeps)


@pytest.mark.parametrize("rules", ["basic", "extended", "subsets"])
def test_port_fixpoint_wrapper_matches_jax_pallas_kernel(rules):
    jg, tg = JGeometry(3, 3), Geometry(3, 3)
    cand = _boards(3, 3, count=56, seed=7)
    want, want_sweeps = jax_fixpoint_pallas(jnp.asarray(cand), jg, tile=16, rules=rules)
    cuda_propagate.propagate_fixpoint_cuda.launches = 0
    got, sweeps = cuda_propagate.propagate_fixpoint_pallas(_t(cand), tg, rules=rules)
    assert np.array_equal(got.numpy(), _j(want))
    assert int(sweeps) == int(want_sweeps)
    assert cuda_propagate.propagate_fixpoint_cuda.launches == 0  # CPU: plain version


def test_per_board_counts_follow_the_unroll_floor():
    tg = Geometry(3, 3)
    cand = _t(_boards(3, 3, count=8, seed=3))
    _, base = tp.propagate_per_board(cand, tg, rules="extended")
    _, floored = tp.propagate_per_board(cand, tg, rules="extended", unroll=3)
    assert torch.equal(floored, torch.clamp(base, min=3))
    _, capped = tp.propagate_per_board(cand, tg, max_sweeps=1, rules="extended", unroll=2)
    assert capped.tolist() == [1] * cand.shape[0]


def test_wrapper_rejects_bad_inputs():
    tg = Geometry(3, 3)
    with pytest.raises(ValueError):
        cuda_propagate.propagate_fixpoint_pallas(torch.zeros(2, 4, 4, dtype=torch.int32), tg)
    with pytest.raises(TypeError):
        cuda_propagate.propagate_fixpoint_pallas(torch.zeros(2, 9, 9, dtype=torch.int64), tg)
    with pytest.raises(ValueError):
        cuda_propagate.propagate_fixpoint_pallas(
            torch.zeros(2, 9, 9, dtype=torch.int32), tg, rules="extend")
