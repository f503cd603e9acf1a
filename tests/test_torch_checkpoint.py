"""Port parity: frontier snapshots and checkpointed solves against JAX.

A snapshot is the JAX package's ``.npz``: the same field names, uint32
masks and signature string (problem, every ``SolverConfig`` field, grids
digest), so one written by either package loads in the other.  Tolerance:
exact equality: a resumed solve is bit-identical to an uninterrupted one,
and a snapshot carried across steps on to the same state in both packages.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu.models.geometry import Geometry as JGeometry
from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JSolverConfig
from distributed_sudoku_solver_tpu.ops.solve import solve_batch as jax_solve_batch
from distributed_sudoku_solver_tpu.utils import checkpoint as jck
from distributed_sudoku_solver_tpu.utils.puzzles import EASY_9, HARD_9, make_puzzle
from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig, frontier_to_numpy
from distributed_sudoku_solver_tpu_torch.ops.solve import solve_batch
from distributed_sudoku_solver_tpu_torch.utils import checkpoint as tck

JG, TG = JGeometry(3, 3), Geometry(3, 3)
JCFG = JSolverConfig(min_lanes=16, stack_slots=48)
TCFG = SolverConfig.from_fields(JCFG)
FIELDS = ("solution", "solved", "unsat", "overflowed", "nodes", "sol_count", "steps",
          "sweeps", "expansions", "steals")


def _grids():
    boards = [make_puzzle(JG, 70 + i, n_clues=24, unique=False) for i in range(5)]
    return np.stack([np.asarray(EASY_9)] + list(HARD_9) + boards).astype(np.int32)


def _same_result(got, want):
    for f in FIELDS:
        a = getattr(got, f)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert np.array_equal(a, np.asarray(getattr(want, f))), f


class _Interrupt(Exception):
    pass


def _interrupt(_state):
    raise _Interrupt


def test_signature_and_digest_equal_jax():
    grids = _grids()
    assert tck.grids_digest(grids) == jck.grids_digest(grids)
    assert tck.grids_digest(torch.from_numpy(grids)) == jck.grids_digest(grids)
    for cfg in (JCFG, JSolverConfig(branch="head:mlp", step_impl="fused", rules="extended")):
        assert tck._signature(TG, SolverConfig.from_fields(cfg), "abc") == jck._signature(
            JG, cfg, "abc")


def test_save_load_round_trip(tmp_path):
    grids = _grids()
    state = tck.advance_frontier(tck.start_frontier(torch.from_numpy(grids), TG, TCFG), 5, TG,
                                 TCFG)
    path = str(tmp_path / "f.npz")
    tck.save_frontier(path, state, TG, TCFG, grids_hash=tck.grids_digest(grids))
    back = tck.load_frontier(path, TG, TCFG, grids_hash=tck.grids_digest(grids))
    for k, v in state._asdict().items():
        assert torch.equal(getattr(back, k), v) and getattr(back, k).dtype == v.dtype, k
    assert sorted(os.listdir(tmp_path)) == ["f.npz"]  # the temporary file was renamed


@pytest.mark.parametrize("cfg", [TCFG, dataclasses.replace(TCFG, branch="head:cw-slack",
                                                           rules="extended")],
                         ids=["minrem", "cw-slack"])
def test_resume_after_interrupt_is_bit_exact(tmp_path, cfg):
    grids = _grids()
    path = str(tmp_path / "f.npz")
    with pytest.raises(_Interrupt):
        tck.solve_batch_checkpointed(grids, TG, cfg, checkpoint_path=path, chunk_steps=3,
                                     on_chunk=_interrupt, device="cpu")
    with np.load(path) as snap:
        assert int(snap["steps"]) == 3
    resumed = tck.solve_batch_checkpointed(grids, TG, cfg, checkpoint_path=path, chunk_steps=3,
                                           device="cpu")
    assert not os.path.exists(path)
    whole = tck.solve_batch_checkpointed(grids, TG, cfg, chunk_steps=3, device="cpu")
    direct = solve_batch(grids, TG, cfg, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(resumed, f), getattr(whole, f)), f
        assert torch.equal(getattr(resumed, f), getattr(direct, f)), f


def test_checkpointed_solve_equals_jax(tmp_path):
    grids = _grids()
    want = jck.solve_batch_checkpointed(grids, JG, JCFG, checkpoint_path=str(tmp_path / "j.npz"),
                                        chunk_steps=4)
    got = tck.solve_batch_checkpointed(grids, TG, TCFG, checkpoint_path=str(tmp_path / "t.npz"),
                                       chunk_steps=4, device="cpu")
    _same_result(got, want)


def test_jax_snapshot_resumes_in_the_port(tmp_path):
    grids = _grids()
    path = str(tmp_path / "j.npz")
    state = jck.advance_frontier(jck.start_frontier(jnp.asarray(grids), JG, JCFG), jnp.int32(6),
                                 JG, JCFG)
    jck.save_frontier(path, state, JG, JCFG, grids_hash=jck.grids_digest(grids))
    loaded = tck.load_frontier(path, TG, TCFG, grids_hash=tck.grids_digest(grids))
    host = {k: np.asarray(v) for k, v in state._asdict().items()}
    got = frontier_to_numpy(loaded)
    assert all(np.array_equal(got[k], host[k]) and got[k].dtype == host[k].dtype for k in host)
    # The port resumes from the JAX file as JAX's uninterrupted run ends.
    _same_result(
        tck.solve_batch_checkpointed(grids, TG, TCFG, checkpoint_path=path, device="cpu"),
        jax_solve_batch(jnp.asarray(grids), JG, JCFG),
    )


def test_port_snapshot_resumes_in_jax(tmp_path):
    grids = _grids()
    path = str(tmp_path / "t.npz")
    state = tck.advance_frontier(tck.start_frontier(torch.from_numpy(grids), TG, TCFG), 6, TG,
                                 TCFG)
    tck.save_frontier(path, state, TG, TCFG, grids_hash=tck.grids_digest(grids))
    loaded = jck.load_frontier(path, JG, JCFG, grids_hash=jck.grids_digest(grids))
    mine = frontier_to_numpy(state)
    for k, v in loaded._asdict().items():
        assert np.array_equal(np.asarray(v), mine[k]) and np.asarray(v).dtype == mine[k].dtype, k
    want = jck.solve_batch_checkpointed(grids, JG, JCFG, checkpoint_path=path)
    got = tck.solve_batch_checkpointed(grids, TG, TCFG, device="cpu")
    _same_result(got, want)


def test_mismatched_snapshot_rejected(tmp_path):
    grids = _grids()
    path = str(tmp_path / "f.npz")
    state = tck.start_frontier(torch.from_numpy(grids), TG, TCFG)
    tck.save_frontier(path, state, TG, TCFG, grids_hash=tck.grids_digest(grids))
    with pytest.raises(ValueError, match="signature mismatch"):
        tck.load_frontier(path, TG, dataclasses.replace(TCFG, stack_slots=32),
                          grids_hash=tck.grids_digest(grids))
    with pytest.raises(ValueError, match="signature mismatch"):
        tck.load_frontier(path, TG, TCFG, grids_hash=tck.grids_digest(grids[:2]))
    with pytest.raises(ValueError, match="signature mismatch"):
        jck.load_frontier(path, JG, dataclasses.replace(JCFG, branch="head:mlp"),
                          grids_hash=jck.grids_digest(grids))
