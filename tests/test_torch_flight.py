"""Port parity: the frontier's flight operations and the latency-mode megastep against JAX.

Each operation runs on the same frontier in both packages (the JAX state
carried across as numpy) and must give the same state, field for field:
the six flight operations (seed from roots, seed packed, attach, detach,
purge, shed) and the composite megastep exactly; the fused megastep on
every field but ``sweeps`` (per-lane in the port, per-tile in JAX).  The
inputs include padding rows (-1), ``k`` above the lane count for
``shed_rows`` and gang-scoped stealing (``steal_gang > 0``).  Last, the
megastep's verdict equals the chunked path's and ``solve_one``'s, the
twin of ``tests/test_megastep.py``'s bit-identity lane without the engine.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu.models.geometry import Geometry as JGeometry
from distributed_sudoku_solver_tpu.ops import frontier as jfr
from distributed_sudoku_solver_tpu.ops.bitmask import encode_grid as jax_encode_grid
from distributed_sudoku_solver_tpu.ops.pallas_step import (
    advance_megastep_fused as jax_advance_megastep_fused,
)
from distributed_sudoku_solver_tpu.utils.checkpoint import advance_frontier as jax_advance
from distributed_sudoku_solver_tpu.utils.puzzles import EASY_9, HARD_9, make_puzzle
from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops import frontier as tfr
from distributed_sudoku_solver_tpu_torch.ops.bitmask import decode_grid, encode_grid
from distributed_sudoku_solver_tpu_torch.ops.cuda_step import (
    advance_frontier_fused_status,
    advance_megastep_fused,
)
from distributed_sudoku_solver_tpu_torch.ops.solve import solve_one
from distributed_sudoku_solver_tpu_torch.utils.checkpoint import advance_frontier_status

JG, TG = JGeometry(3, 3), Geometry(3, 3)


def _grids(count, seed):
    return np.stack([make_puzzle(JG, seed + i, n_clues=24, unique=False)
                     for i in range(count)]).astype(np.int32)


def _host(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _assert_state(port, jax_state, skip=()):
    got = tfr.frontier_to_numpy(port)
    for k, v in _host(jax_state).items():
        if k not in skip:
            assert np.array_equal(got[k], v) and got[k].dtype == v.dtype, k


def _resident(n_slots, gang, **kw):
    """A resident-shaped pair of empty frontiers (every root padding), as
    the serving scheduler seeds them, and its config."""
    cfg = jfr.SolverConfig(lanes=n_slots * gang, min_lanes=n_slots * gang, stack_slots=8,
                           steal_gang=gang, **kw)
    lanes = cfg.lanes
    j = jfr.init_frontier_roots(jnp.zeros((lanes, 9, 9), jnp.uint32),
                                jnp.full(lanes, -1, jnp.int32), n_slots, cfg)
    t = tfr.init_frontier_roots(torch.zeros((lanes, 9, 9), dtype=torch.int32),
                                torch.full((lanes,), -1, dtype=torch.int32), n_slots,
                                tfr.SolverConfig.from_fields(cfg))
    _assert_state(t, j)
    return j, t, cfg


def _mid_flight(steps=5, gang=4):
    """Two jobs attached to a 3-slot resident frontier, advanced ``steps``
    composite rounds with gang-scoped stealing, in both packages."""
    j, t, cfg = _resident(3, gang)
    grids = np.stack([HARD_9[0], HARD_9[1]]).astype(np.int32)
    slots = np.array([2, 0], np.int32)
    j = jfr.attach_roots(j, jax_encode_grid(jnp.asarray(grids), JG), jnp.asarray(slots), gang)
    t = tfr.attach_roots(t, encode_grid(torch.from_numpy(grids), TG), torch.from_numpy(slots),
                         gang)
    j = jax_advance(j, jnp.int32(steps), JG, cfg)
    t = tfr.frontier_from_numpy(_host(j))
    return j, t, cfg


# -- the six flight operations ---------------------------------------------------


@pytest.mark.parametrize("kw", [dict(min_lanes=4), dict(lanes=13)])
def test_init_frontier_roots_matches_jax(kw):
    grids = _grids(9, seed=3)
    job_of = np.array([0, 2, -1, 1, 4, -1, 3, 3, 0], np.int32)
    cfg = jfr.SolverConfig(stack_slots=5, **kw)
    want = jfr.init_frontier_roots(jax_encode_grid(jnp.asarray(grids), JG), jnp.asarray(job_of),
                                   5, cfg)
    got = tfr.init_frontier_roots(encode_grid(torch.from_numpy(grids), TG),
                                  torch.from_numpy(job_of), 5, tfr.SolverConfig.from_fields(cfg))
    _assert_state(got, want)
    assert int(got.has_top.sum()) == 7


@pytest.mark.parametrize("kw", [dict(min_lanes=2, stack_slots=3), dict(lanes=4, stack_slots=3)])
def test_init_frontier_packed_matches_jax(kw):
    grids = _grids(11, seed=5)
    valid = np.arange(11) < 8  # padding rows come last
    cfg = jfr.SolverConfig(**kw)
    tcfg = tfr.SolverConfig.from_fields(cfg)
    assert tcfg.resolve_lanes_packed(11) == cfg.resolve_lanes_packed(11)
    want = jfr.init_frontier_packed(jax_encode_grid(jnp.asarray(grids), JG), jnp.asarray(valid),
                                    cfg)
    got = tfr.init_frontier_packed(encode_grid(torch.from_numpy(grids), TG),
                                   torch.from_numpy(valid), tcfg)
    _assert_state(got, want)
    assert int(got.has_top.sum()) + int(got.count.sum()) == 8
    with pytest.raises(ValueError, match="capacity"):
        tfr.init_frontier_packed(encode_grid(torch.from_numpy(_grids(17, 1)), TG),
                                 torch.ones(17, dtype=torch.bool),
                                 dataclasses.replace(tcfg, lanes=4))


def test_purge_jobs_matches_jax():
    j, t, _ = _mid_flight()
    dead = np.array([False, False, True])
    _assert_state(tfr.purge_jobs(t, torch.from_numpy(dead)), jfr.purge_jobs(j, jnp.asarray(dead)))


@pytest.mark.parametrize("gang", [1, 4])
def test_attach_roots_matches_jax(gang):
    j, t, _ = _resident(3, gang)
    grids = _grids(4, seed=11)
    # A padding row, and a slot past the pool whose rows are dropped.
    slots = np.array([1, -1, 0, 3], np.int32)
    want = jfr.attach_roots(j, jax_encode_grid(jnp.asarray(grids), JG), jnp.asarray(slots), gang)
    got = tfr.attach_roots(t, encode_grid(torch.from_numpy(grids), TG), torch.from_numpy(slots),
                           gang)
    _assert_state(got, want)
    assert int(got.has_top.sum()) == 2


def test_attach_into_a_live_frontier_matches_jax():
    j, t, _ = _mid_flight()
    grid = _grids(1, seed=13)
    slot = np.array([1], np.int32)
    want = jfr.attach_roots(j, jax_encode_grid(jnp.asarray(grid), JG), jnp.asarray(slot), 4)
    got = tfr.attach_roots(t, encode_grid(torch.from_numpy(grid), TG), torch.from_numpy(slot), 4)
    _assert_state(got, want)


def test_detach_matches_jax():
    j, t, _ = _mid_flight()
    mask = np.array([False, False, True])
    _assert_state(tfr.detach(t, torch.from_numpy(mask)), jfr.detach(j, jnp.asarray(mask)))


@pytest.mark.parametrize("k", [2, 15])  # 15 > the 12 lanes: no row ships twice
@pytest.mark.parametrize("job", [0, 2])
def test_shed_rows_matches_jax(job, k):
    j, t, _ = _mid_flight(steps=8)
    want_state, want_rows, want_valid = jfr.shed_rows(j, jnp.int32(job), k)
    got_state, got_rows, got_valid = tfr.shed_rows(t, job, k)
    _assert_state(got_state, want_state)
    assert np.array_equal(got_rows.numpy().view(np.uint32), np.asarray(want_rows))
    assert np.array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert int(got_valid.sum()) >= 1


# -- the megastep ----------------------------------------------------------------


def _flight_start(fused, **kw):
    j, t, cfg = _resident(1, 8, **kw)
    if fused:
        cfg = dataclasses.replace(cfg, step_impl="fused", fused_steps=2, rules="extended")
    grid = np.asarray(HARD_9[0], np.int32)[None]
    j = jfr.attach_roots(j, jax_encode_grid(jnp.asarray(grid), JG), jnp.zeros(1, jnp.int32), 8)
    return j, tfr.frontier_from_numpy(_host(j)), cfg


@pytest.mark.parametrize("fused", [False, True], ids=["xla", "fused"])
@pytest.mark.parametrize("chunk_steps,max_chunks", [(3, 2), (16, 64)])
def test_advance_megastep_matches_jax(fused, chunk_steps, max_chunks):
    j, t, cfg = _flight_start(fused)
    if fused:
        want = jax_advance_megastep_fused(j, jnp.int32(chunk_steps), jnp.int32(max_chunks), JG,
                                          cfg)
        got = advance_megastep_fused(t, chunk_steps, max_chunks, TG,
                                     tfr.SolverConfig.from_fields(cfg))
    else:
        want = jfr.advance_megastep(j, jnp.int32(chunk_steps), jnp.int32(max_chunks), JG, cfg)
        got = tfr.advance_megastep(t, chunk_steps, max_chunks, TG,
                                   tfr.SolverConfig.from_fields(cfg))
    _assert_state(got[0], want[0], skip=("sweeps",) if fused else ())
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])
    info = tfr.unpack_status(got[1], 1)
    if max_chunks == 2:  # the chunk budget ran out with work left
        assert int(got[2]) == 2 and bool(info["has_work"][0])
    else:  # early exit on the solve
        assert int(got[2]) < max_chunks and bool(info["solved"][0])


def _verdict(state):
    return (state.nodes.clone(), state.sol_count.clone(), state.overflowed.clone(),
            decode_grid(state.solution))


@pytest.mark.parametrize("fused", [False, True], ids=["xla", "fused"])
def test_megastep_verdict_equals_chunked_and_solve_one(fused):
    """One board per flight on a one-slot, 8-lane mailbox (attach ->
    megastep -> verdict -> detach), against the same flight driven one
    status chunk at a time, and against ``solve_one``."""
    bad = np.zeros((9, 9), np.int32)
    bad[0, 0] = bad[0, 1] = 5
    boards = [np.asarray(b, np.int32) for b in HARD_9] + [np.asarray(EASY_9, np.int32), bad]
    _, mailbox, cfg = _resident(1, 8)
    if fused:
        cfg = dataclasses.replace(cfg, step_impl="fused", fused_steps=2, rules="extended")
    cfg = tfr.SolverConfig.from_fields(cfg)
    chunked = mailbox
    for board in boards:
        root = encode_grid(torch.from_numpy(board[None]), TG)
        slot = torch.zeros(1, dtype=torch.int32)
        mailbox = tfr.attach_roots(mailbox, root, slot, 8)
        advance = advance_megastep_fused if fused else tfr.advance_megastep
        mailbox, status, chunks = advance(mailbox, 16, 64, TG, cfg)
        info = tfr.unpack_status(status, 1)
        got = _verdict(mailbox)
        mailbox = tfr.detach(mailbox, torch.ones(1, dtype=torch.bool))

        chunked = tfr.attach_roots(chunked, root, slot, 8)
        step = advance_frontier_fused_status if fused else advance_frontier_status
        while True:
            chunked, st = step(chunked, 16, TG, cfg)
            ref_info = tfr.unpack_status(st, 1)
            if not ref_info["has_work"][0]:
                break
        ref = _verdict(chunked)
        chunked = tfr.detach(chunked, torch.ones(1, dtype=torch.bool))

        assert bool(info["solved"][0]) == bool(ref_info["solved"][0])
        assert not info["has_work"][0] and not ref_info["has_work"][0]
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        sol, res = solve_one(board, TG, dataclasses.replace(cfg, max_steps=100_000),
                             device="cpu")
        assert bool(info["solved"][0]) == bool(res.solved[0])
        assert bool(res.unsat[0]) == (not info["solved"][0] and not bool(got[2][0]))
        if sol is not None:
            assert np.array_equal(got[3][0].numpy(), sol)
        assert int(chunks) >= 1
