"""Port parity: the scored branch heads (``ops/ordering.py``) against JAX.

Inputs come from numpy seeds and the shared puzzle corpus.  Tolerances:

* ``pack_key``, every head's ``score_full`` and the ``minrem`` / ``cw-slack``
  ``score_lanes``: bit-equal (f32 bits and int32 keys);
* ``mlp``'s ``score_lanes`` is a matrix product whose summation order
  belongs to the BLAS of each framework: scores within 4e-6 (four f32 ulps
  at scores in [8, 16); a key quantum is 1/4096), and at most 1 % of the
  keys may differ (22 of 47,628 on this corpus when it was written, with
  no branch cell changed; PERF.md records the counts);
* the composite solve: bit-equal on every field for ``head:minrem`` and
  ``head:cw-slack``, verdict-equal (valid, clue-keeping solutions) for
  ``head:mlp``, JAX's own contract for that head;
* the fused round's plain version: equal to JAX's ``fused_rounds`` (Pallas
  interpret mode, as ``tests/test_torch_fused.py`` runs it) on every output
  but ``sweeps_total``.
"""

import dataclasses
import operator
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distributed_sudoku_solver_tpu.models.geometry import Geometry as JGeometry
from distributed_sudoku_solver_tpu.ops import ordering as jord
from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JSolverConfig
from distributed_sudoku_solver_tpu.ops.pallas_step import _unit_full
from distributed_sudoku_solver_tpu.ops.pallas_step import fused_rounds as jax_fused_rounds
from distributed_sudoku_solver_tpu.ops.solve import solve_batch as jax_solve_batch
from distributed_sudoku_solver_tpu.utils.puzzles import EASY_9, HARD_9, make_puzzle
from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops import cuda_step, ordering
from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.ops.propagate import propagate
from distributed_sudoku_solver_tpu_torch.ops.solve import solve_batch
from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution

REPO = Path(__file__).resolve().parents[1]
HEADS = ["head:minrem", "head:cw-slack", "head:mlp"]
FIELDS = ("solution", "solved", "unsat", "overflowed", "nodes", "sol_count", "steps",
          "sweeps", "expansions", "steals")


def _states(bh, bw, count, seed):
    """Candidate boards as the search meets them: carved boards swept to
    their fixpoint (decided, undecided and contradicted cells), plus random
    masks of one to n candidates per cell."""
    jg, tg = JGeometry(bh, bw), Geometry(bh, bw)
    n = tg.n
    grids = np.stack([make_puzzle(jg, seed + i, n_clues=int(n * n * 0.3), unique=False)
                      for i in range(count)]).astype(np.int32)
    swept, _ = propagate(encode_grid(torch.from_numpy(grids), tg), tg, 64, "basic")
    rng = np.random.default_rng(seed)
    bits = rng.random((count, n, n, n)) < rng.random((count, n, n, 1))
    masks = (bits * (1 << np.arange(n))).sum(-1).astype(np.int64)
    masks = np.where(masks == 0, 1 << rng.integers(0, n, masks.shape), masks)
    return tg, jg, np.concatenate([swept.numpy(), masks.astype(np.int32)])


def _round_inputs(bh, bw, seed, lanes=128, slots=6):
    """A lane-first frontier: carved boards as tops, other carved boards in
    partly filled circular stacks, a fifth of the lanes idle."""
    jg, tg = JGeometry(bh, bw), Geometry(bh, bw)
    n = jg.n
    rng = np.random.default_rng(seed)
    grids = np.stack([
        make_puzzle(jg, seed + i, n_clues=int(n * n * 0.3), unique=False)
        for i in range(lanes * (slots + 1))
    ]).astype(np.int32)
    cand = encode_grid(torch.from_numpy(grids), tg).reshape(lanes, slots + 1, n, n)
    has = torch.from_numpy(rng.random(lanes) < 0.8)
    base = torch.from_numpy(rng.integers(0, slots, lanes).astype(np.int32))
    count = torch.from_numpy(rng.integers(0, slots + 1, lanes).astype(np.int32))
    return tg, jg, cand[:, 0].contiguous(), cand[:, 1:].contiguous(), has, base, count


def _jax_lane_first(out):
    """JAX 13-tuple (boards-last) -> numpy, lane-first."""
    top_t, stack_t, *mid, sol_t, over, nodes, sols, live, sweeps, steps = (
        np.asarray(x) for x in out)
    return [top_t.transpose(2, 0, 1).view(np.int32), stack_t.transpose(3, 0, 1, 2).view(np.int32),
            *mid, sol_t.transpose(2, 0, 1).view(np.int32), over, nodes, sols, live, sweeps, steps]


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


# -- rule validation -------------------------------------------------------------


@pytest.mark.parametrize("rule", [*ordering.LEGACY_RULES, *HEADS])
def test_validate_branch_accepts_every_shipped_rule(rule):
    ordering.validate_branch(rule)
    jord.validate_branch(rule)
    assert SolverConfig(branch=rule).branch == rule
    assert SolverConfig(branch=rule, step_impl="fused").branch == rule


@pytest.mark.parametrize("rule", ["head:nope", "bogus", "head:", "minrem "])
def test_validate_branch_rejects_unknown(rule):
    with pytest.raises(ValueError):
        ordering.validate_branch(rule)
    with pytest.raises(ValueError):
        SolverConfig(branch=rule)


def test_registry_and_weights():
    assert ordering.HEAD_NAMES == jord.HEAD_NAMES
    assert ordering.LEGACY_RULES == jord.LEGACY_RULES and ordering.BIG == jord.BIG
    port = REPO / "distributed_sudoku_solver_tpu_torch/ops/ordering_weights.json"
    assert port.read_bytes() == (REPO / "distributed_sudoku_solver_tpu/ops/ordering_weights.json").read_bytes()
    head = ordering.get_head("head:mlp")
    assert ordering.get_head("head:mlp") is head
    hash(head)
    want = jord.get_head("head:mlp")
    assert (head.w1, head.b1, head.w2, head.b2) == (want.w1, want.b1, want.w2, want.b2)


def test_load_mlp_weights_rejects_unknown_schema(tmp_path):
    p = tmp_path / "w.json"
    p.write_text('{"schema": "nope/9"}')
    with pytest.raises(ValueError, match="schema"):
        ordering.load_mlp_weights(str(p))


# -- pack_key --------------------------------------------------------------------


@pytest.mark.parametrize("n,quant", [(9, 1), (9, 2048), (9, 4096), (16, 4096), (4, 4096)])
def test_pack_key_matches_jax(n, quant):
    rng = np.random.default_rng(n * quant)
    qmax = jord._qmax(n)
    cells = n * n
    score = (rng.random(cells * 4) * 40 - 4).astype(np.float32)
    # Exact half quanta (ties round to even), and both clamp ends.
    score[:cells] = ((rng.integers(-20, 200, cells) + 0.5) / quant).astype(np.float32)
    score[cells : cells + 4] = [-1e9, -0.0, 1e9, (qmax + 3) / quant]
    und = rng.random(score.shape) < 0.8
    cell = np.tile(np.arange(cells, dtype=np.int32), 4)
    want = np.asarray(jord.pack_key(jnp.asarray(score), jnp.asarray(und), jnp.asarray(cell), n,
                                    quant))
    got = ordering.pack_key(torch.from_numpy(score), torch.from_numpy(und),
                            torch.from_numpy(cell), n, quant).numpy()
    assert np.array_equal(got, want)
    assert got.max() <= jord.BIG and (got[und] < jord.BIG).all()


# -- scores ----------------------------------------------------------------------


@pytest.mark.parametrize("rule", HEADS)
@pytest.mark.parametrize("bh,bw", [(3, 3), (4, 4)])
def test_score_full_bit_equal_to_jax(rule, bh, bw):
    tg, jg, states = _states(bh, bw, 48, seed=bh * 100)
    head, jhead = ordering.get_head(rule), jord.get_head(rule)
    want = jhead.score_full(jnp.asarray(states.view(np.uint32).transpose(1, 2, 0)), jg,
                            unit_sum=lambda x: _unit_full(x, jg, operator.add))
    got = head.score_full(torch.from_numpy(states), tg,
                          lambda x: ordering._unit_sums_lanes(x, tg))
    assert np.array_equal(_bits(got.numpy()), _bits(np.asarray(want).transpose(2, 0, 1)))


@pytest.mark.parametrize("rule", HEADS)
def test_score_lanes_vs_jax(rule):
    tg, jg, states = _states(3, 3, 294, seed=7)
    head, jhead = ordering.get_head(rule), jord.get_head(rule)
    want = np.asarray(jhead.score_lanes(jnp.asarray(states.view(np.uint32)), jg))
    got = head.score_lanes(torch.from_numpy(states), tg).numpy()
    n = tg.n
    pc = np.zeros(states.shape, np.int64)
    for d in range(n):
        pc += (states.astype(np.int64) >> d) & 1
    und = (pc > 1).reshape(len(states), n * n)
    cell = np.arange(n * n, dtype=np.int32)
    key_w = np.asarray(jord.pack_key(jnp.asarray(want), jnp.asarray(und), jnp.asarray(cell), n,
                                     jhead.quant))
    key_g = ordering.pack_key(torch.from_numpy(got), torch.from_numpy(und),
                              torch.from_numpy(cell), n, head.quant).numpy()
    if rule == "head:mlp":
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)
        differ = int((key_g != key_w).sum())
        print(f"mlp score_lanes: {int((got != want).sum())} of {got.size} scores (by at most "
              f"{float(np.abs(got - want).max()):.3g}) and {differ} "
              f"of {key_w.size} keys differ from JAX; branch cells differ on "
              f"{int((key_g.argmin(1) != key_w.argmin(1)).sum())} of {len(key_w)} boards")
        assert differ <= key_w.size // 100
    else:
        assert np.array_equal(_bits(got), _bits(want))
        assert np.array_equal(key_g, key_w)


def test_features_np_and_examples_equal_jax():
    g = np.asarray(HARD_9[0], dtype=np.int64)
    jg, tg = JGeometry(3, 3), Geometry(3, 3)
    m = np.full((9, 9), (1 << 9) - 1, dtype=np.int64)
    m[g > 0] = np.int64(1) << (g[g > 0] - 1)
    m_t, status_t = ordering._np_propagate(m, tg)
    m_j, status_j = jord._np_propagate(m, jg)
    assert status_t == status_j == "open" and np.array_equal(m_t, m_j)
    assert np.array_equal(ordering.features_np(m_t, tg), jord.features_np(m_j, jg))
    got = ordering.record_branch_examples(HARD_9[0], tg)
    want = jord.record_branch_examples(HARD_9[0], jg)
    assert got == want and got[1] > 0


# -- the composite step ----------------------------------------------------------


def _unsat_board():
    g = np.asarray(HARD_9[1]).copy()
    g[1, 6] = 8  # a consistent-looking wrong clue: needs deep exhaustion
    return g


def _corpus():
    jg = JGeometry(3, 3)
    boards = [make_puzzle(jg, 60 + i, n_clues=25, unique=False) for i in range(8)]
    return np.stack(boards + [np.asarray(EASY_9), _unsat_board()] + list(HARD_9)).astype(
        np.int32)


def _check_verdicts(got, ref, grids):
    assert np.array_equal(got.solved.numpy(), np.asarray(ref.solved))
    assert np.array_equal(got.unsat.numpy(), np.asarray(ref.unsat))
    for i in np.flatnonzero(got.solved.numpy()):
        sol = got.solution[i].numpy()
        assert is_valid_solution(sol)
        clue = grids[i] > 0
        assert (sol[clue] == grids[i][clue]).all()


@pytest.mark.parametrize("rule", HEADS)
def test_composite_solve_with_heads_vs_jax(rule):
    grids = _corpus()
    jcfg = JSolverConfig(min_lanes=16, stack_slots=32, max_steps=4096, branch=rule)
    want = jax_solve_batch(jnp.asarray(grids), JGeometry(3, 3), jcfg)
    got = solve_batch(grids, Geometry(3, 3), SolverConfig.from_fields(jcfg), device="cpu")
    if rule == "head:mlp":
        _check_verdicts(got, want, grids)
    else:
        for f in FIELDS:
            assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f
    assert bool(got.unsat[9]) and int(got.solved.sum()) == len(grids) - 1


@pytest.mark.parametrize("step_impl", ["xla", "fused"])
def test_head_minrem_bit_exact_to_minrem(step_impl):
    grids = _corpus()
    cfg = SolverConfig(min_lanes=16, stack_slots=32, max_steps=4096, step_impl=step_impl,
                       fused_steps=4)
    ref = solve_batch(grids, Geometry(3, 3), cfg, device="cpu")
    got = solve_batch(grids, Geometry(3, 3), dataclasses.replace(cfg, branch="head:minrem"),
                      device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.parametrize("step_impl", ["xla", "fused"])
def test_unsat_under_cw_slack_cross_checked_by_count_all(step_impl):
    grids = _unsat_board()[None].astype(np.int32)
    cfg = SolverConfig(min_lanes=8, stack_slots=32, max_steps=4096, branch="head:cw-slack",
                       step_impl=step_impl, fused_steps=4)
    res = solve_batch(grids, Geometry(3, 3), cfg, device="cpu")
    assert bool(res.unsat[0])
    cnt = solve_batch(grids, Geometry(3, 3), dataclasses.replace(cfg, count_all=True),
                      device="cpu")
    assert int(cnt.sol_count[0]) == 0 and not bool(cnt.overflowed[0])


# -- the fused round -------------------------------------------------------------


@pytest.mark.parametrize("count_mode", [False, True])
@pytest.mark.parametrize("rule", HEADS)
@pytest.mark.parametrize("bh,bw", [(3, 3), (4, 4)])
def test_plain_fused_rounds_with_heads_match_jax(bh, bw, rule, count_mode):
    tg, jg, top, stack, has, base, count = _round_inputs(bh, bw, seed=bh + len(rule))
    kw = dict(rules="extended", branch_rule=rule, max_sweeps=64, k_steps=4,
              count_mode=count_mode)
    want = _jax_lane_first(jax_fused_rounds(
        jnp.asarray(top.numpy().view(np.uint32).transpose(1, 2, 0)),
        jnp.asarray(stack.numpy().view(np.uint32).transpose(1, 2, 3, 0)),
        jnp.asarray(has.numpy()), jnp.asarray(base.numpy()), jnp.asarray(count.numpy()),
        jg, tile=64, **kw))
    cuda_step.fused_rounds_cuda.launches = 0
    got = cuda_step.fused_rounds(top, stack.clone(), has, base, count, tg, tile=64, **kw)
    assert cuda_step.fused_rounds_cuda.launches == 0  # CPU: plain version
    for i, (g, w) in enumerate(zip(got, want)):
        if i != 11:  # sweeps_total: per-lane in the port, per-tile in JAX
            assert np.array_equal(g.numpy(), w), i
    assert int(got[8].sum()) > 0


@pytest.mark.parametrize("rule", HEADS)
def test_fused_solve_with_heads_matches_jax_except_sweeps(rule):
    grids = _corpus()
    jcfg = JSolverConfig(min_lanes=32, stack_slots=32, max_steps=4096, branch=rule,
                         step_impl="fused", fused_steps=3, rules="extended")
    want = jax_solve_batch(jnp.asarray(grids), JGeometry(3, 3), jcfg)
    got = solve_batch(grids, Geometry(3, 3), SolverConfig.from_fields(jcfg), device="cpu")
    for f in FIELDS:
        if f != "sweeps":
            assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f
    _check_verdicts(got, want, grids)


def test_k2_head_params_round_like_jax():
    """K2's constants: each the f32 rounding of JAX's Python float."""
    head = ordering.get_head("head:mlp")
    p = cuda_step.head_params("head:mlp", Geometry(3, 3))
    assert p.dtype == np.float32 and p.shape == (77,)
    assert p[56 + 16] == np.float32(head.b2 + 8.0)
    assert p[-4] == np.float32(1.0 / 9) and p[-3] == np.float32(1.0 / 81)
    assert p[-2] == 4096 and p[-1] == np.float32(jord._qmax(9))
    assert cuda_step.head_params("minrem", Geometry(3, 3)) is None
    assert [cuda_step.rule_code(r) for r in (*ordering.LEGACY_RULES, *HEADS)] == list(range(7))
