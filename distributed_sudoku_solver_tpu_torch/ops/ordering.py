"""Branch-ordering heads: scored branch-cell selection (torch).

Port of the JAX package's ``ops/ordering.py``: the same rule spellings,
heads, packed keys, weights file and numpy host mirror.  A head is a
frozen, hashable dataclass with one seam in two layouts:

* ``score_lanes(cand, geom) -> f32[L, cells]``: the composite step
  (``models/sudoku.py:_branch_cell_onehot``);
* ``score_full(cand, geom, unit_sum) -> f32[..., n, n]``: the fused round
  (the plain version of K2 in ``ops/cuda_step.py``, which K2 reproduces
  in ``csrc/fixpoint.cuh``).  ``unit_sum`` gives the row/col/box sums.

Lower score = branch here.  :func:`pack_key` turns a score into the packed
int32 argmin key ``q * n^2 + cell`` (unique per cell, lowest cell wins a
tie); the ``minrem`` head reproduces the legacy ``pc * n^2 + cell`` key
integer for integer.

The two layouts keep JAX's two float orders, on purpose: ``MlpHead``'s
``score_lanes`` is one matrix product, then ``+ b2``, then ``+ 8.0``;
its ``score_full`` is a chain of separately rounded multiplies and adds in
feature order, then ``+ (b2 + 8.0)`` summed in double.  Every constant is
the f32 rounding of JAX's Python float (``pc * (1/n)``, not ``pc / n``).
Non-default heads promise verdict equality with ``minrem``, not equal
node counts.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.ops.bitmask import popcount

#: Decided/invalid cells take this key: any live score packs strictly smaller.
BIG = 2**30

#: The scored heads, in registry order (``head:<name>`` spellings).
HEAD_NAMES = ("minrem", "cw-slack", "mlp")

#: Legacy (non-head) branch rules.
LEGACY_RULES = ("minrem", "first", "mixed", "minrem-desc")

_WEIGHTS_FILE = os.path.join(os.path.dirname(__file__), "ordering_weights.json")


def is_head_rule(rule: str) -> bool:
    return isinstance(rule, str) and rule.startswith("head:")


def validate_branch(rule: str) -> None:
    """Config-time validation of a branch rule string (legacy or head):
    ``ValueError`` on anything unknown."""
    if rule in LEGACY_RULES:
        return
    if is_head_rule(rule):
        name = rule[len("head:"):]
        if name in HEAD_NAMES:
            return
        raise ValueError(
            f"unknown branch head {name!r} (known: {', '.join(HEAD_NAMES)})"
        )
    raise ValueError(
        f"unknown branch rule {rule!r} (legacy: {', '.join(LEGACY_RULES)}; "
        f"heads: {', '.join('head:' + h for h in HEAD_NAMES)})"
    )


def _qmax(n: int) -> int:
    # Largest quantized score that still packs under BIG with the cell
    # index in the low bits.
    return BIG // (n * n) - 1


def pack_key(score: torch.Tensor, und: torch.Tensor, cell, n: int, quant: int) -> torch.Tensor:
    """f32 score -> packed int32 argmin key (``q * n^2 + cell``).

    ``torch.round`` rounds halves to even, as ``jnp.round`` does; the clamp
    is in float (to the f32 rounding of ``_qmax(n)``) before the int cast,
    as ``jnp.clip`` is.  ``und`` masks decided cells to :data:`BIG`."""
    q = torch.clamp(torch.round(score * quant), 0, _qmax(n)).to(torch.int32)
    return torch.where(und, q * (n * n) + cell, torch.full_like(q, BIG))


def _unit_sums_lanes(x: torch.Tensor, geom):
    """Row/col/box int32 sums of ``x`` [L, n, n], each broadcast back to cells."""
    lanes, n = x.shape[0], geom.n
    row = x.sum(2, keepdim=True, dtype=torch.int32).expand(lanes, n, n)
    col = x.sum(1, keepdim=True, dtype=torch.int32).expand(lanes, n, n)
    boxes = x.reshape(lanes, geom.n_vboxes, geom.box_h, geom.n_hboxes, geom.box_w)
    box = boxes.sum((2, 4), keepdim=True, dtype=torch.int32).expand_as(boxes)
    return row, col, box.reshape(lanes, n, n)


# -- the heads -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MinremHead:
    """The legacy MRV rule as a head: score = candidate count, quant 1."""

    name: str = "minrem"
    quant: int = 1

    def score_lanes(self, cand, geom):
        return popcount(cand).reshape(cand.shape[0], geom.n * geom.n).to(torch.float32)

    def score_full(self, cand, geom, unit_sum):
        return popcount(cand).to(torch.float32)


#: Peer-slack saturation: one less than the cw-slack quant so the slack
#: tie-break can never carry into the candidate-count component.
_SLACK_CAP = 2047


@dataclasses.dataclass(frozen=True)
class CwSlackHead:
    """Constrainedness-weighted MRV: fewest candidates first, then the
    least peer slack (sum of ``candidates - 1`` over the undecided peers
    sharing the cell's row, column or box):
    ``score = pc + min(peer_slack, 2047) / 2048``, quant 2048, both
    components exact in f32."""

    name: str = "cw-slack"
    quant: int = 2048

    def score_lanes(self, cand, geom):
        # Elementwise over exact integer unit sums: one order for both layouts.
        score = self.score_full(cand, geom, lambda x: _unit_sums_lanes(x, geom))
        return score.reshape(cand.shape[0], geom.n * geom.n)

    def score_full(self, cand, geom, unit_sum):
        pc = popcount(cand)
        excess = torch.where(pc > 1, pc - 1, torch.zeros_like(pc))
        row, col, box = unit_sum(excess)
        peer = torch.clamp(row + col + box - 3 * excess, max=_SLACK_CAP).to(torch.float32)
        return pc.to(torch.float32) + peer * (1.0 / (_SLACK_CAP + 1))


def _cell_features(pc, excess, row_e, col_e, box_e, row_u, col_u, box_u, n):
    """The 7 per-cell feature maps the MLP scores, in fixed order (the
    twin of :func:`features_np`, which training reads)."""
    f32 = torch.float32
    inv_n = 1.0 / n
    inv_n2 = 1.0 / (n * n)
    return (
        pc.to(f32) * inv_n,                     # own candidate count
        (row_e - excess).to(f32) * inv_n2,      # row peer slack
        (col_e - excess).to(f32) * inv_n2,      # col peer slack
        (box_e - excess).to(f32) * inv_n2,      # box peer slack
        row_u.to(f32) * inv_n,                  # undecided row peers
        col_u.to(f32) * inv_n,
        box_u.to(f32) * inv_n,
    )


@dataclasses.dataclass(frozen=True)
class MlpHead:
    """Tiny learned branch prior: one hidden layer (ReLU) over the cell's
    7 bitmask-neighbourhood features, trained to predict log2(subtree
    nodes).  Weights are tuples of Python floats (hashable); the raw score
    is shifted by +8 into :func:`pack_key`'s clamp range; quant 4096."""

    w1: Tuple[Tuple[float, ...], ...]  # [F][H]
    b1: Tuple[float, ...]              # [H]
    w2: Tuple[float, ...]              # [H]
    b2: float
    name: str = "mlp"
    quant: int = 4096

    def _features(self, cand, geom, unit_sum):
        pc = popcount(cand)
        und = (pc > 1).to(torch.int32)
        excess = torch.where(pc > 1, pc - 1, torch.zeros_like(pc))
        row_e, col_e, box_e = unit_sum(excess)
        row_u, col_u, box_u = unit_sum(und)
        return _cell_features(
            pc, excess, row_e, col_e, box_e,
            row_u - und, col_u - und, box_u - und, geom.n,
        )

    def score_lanes(self, cand, geom):
        lanes = cand.shape[0]
        feats = self._features(cand, geom, unit_sum=lambda x: _unit_sums_lanes(x, geom))
        x = torch.stack([f.reshape(lanes, geom.n * geom.n) for f in feats], dim=-1)
        f32 = dict(dtype=torch.float32, device=cand.device)
        h = torch.clamp_min(
            torch.matmul(x, torch.tensor(self.w1, **f32)) + torch.tensor(self.b1, **f32), 0.0
        )
        out = torch.matmul(h, torch.tensor(self.w2, **f32)) + self.b2
        return out + 8.0  # shift into pack_key's non-negative clamp range

    def score_full(self, cand, geom, unit_sum):
        feats = self._features(cand, geom, unit_sum)
        hidden = []
        for j in range(len(self.b1)):
            acc = feats[0] * self.w1[0][j]
            for f in range(1, len(self.w1)):
                acc = acc + feats[f] * self.w1[f][j]
            hidden.append(torch.clamp_min(acc + self.b1[j], 0.0))
        out = hidden[0] * self.w2[0]
        for j in range(1, len(hidden)):
            out = out + hidden[j] * self.w2[j]
        return out + (self.b2 + 8.0)


# -- registry ------------------------------------------------------------------


def _to_tuples(rows):
    return tuple(tuple(float(v) for v in row) for row in rows)


def load_mlp_weights(path: Optional[str] = None) -> MlpHead:
    """Build the mlp head from a weights json (schema ``dsst-ordering-mlp/1``;
    the package's own copy of the JAX package's file by default)."""
    with open(path or _WEIGHTS_FILE) as fh:
        data = json.load(fh)
    if data.get("schema") != "dsst-ordering-mlp/1":
        raise ValueError(f"unknown ordering weights schema {data.get('schema')!r}")
    return MlpHead(
        w1=_to_tuples(data["w1"]),
        b1=tuple(float(v) for v in data["b1"]),
        w2=tuple(float(v) for v in data["w2"]),
        b2=float(data["b2"]),
    )


@functools.lru_cache(maxsize=None)
def get_head(rule: str):
    """Resolve ``'head:<name>'`` (or a bare head name) to THE head object
    (cached: one instance per name; the mlp head reads the committed
    weights)."""
    name = rule[len("head:"):] if is_head_rule(rule) else rule
    if name == "minrem":
        return MinremHead()
    if name == "cw-slack":
        return CwSlackHead()
    if name == "mlp":
        return load_mlp_weights()
    raise ValueError(
        f"unknown branch head {name!r} (known: {', '.join(HEAD_NAMES)})"
    )


# -- host-side mirror: numpy propagation + the branch-example recorder ---------
#
# Copied from the JAX package: the learned head trains on per-branch
# (state, chosen-cell, subtree-nodes) examples replayed on the host with
# the kernel's semantics (bitmask states, elimination + hidden singles,
# MRV / ascending-digit binary DFS).  numpy only.


def _np_propagate(m, geom, max_sweeps: int = 64):
    """Eliminations + hidden singles to a fixpoint on a bitmask board.

    Returns ``(m, status)`` with status 'solved' | 'unsat' | 'open'."""
    n = geom.n
    vb, hb, bh, bw = geom.n_vboxes, geom.n_hboxes, geom.box_h, geom.box_w
    digits = np.arange(n, dtype=np.int64)
    weights = np.int64(1) << digits

    def popcounts(mm):
        return ((mm[..., None] >> digits) & 1).sum(-1)

    for _ in range(max_sweeps):
        prev = m
        pc = popcounts(m)
        if (m == 0).any():
            return m, "unsat"
        singles = np.where(pc == 1, m, 0)
        sb = (singles[..., None] >> digits) & 1
        if (sb.sum(axis=1) > 1).any() or (sb.sum(axis=0) > 1).any():
            return m, "unsat"
        if (sb.reshape(vb, bh, hb, bw, n).sum(axis=(1, 3)) > 1).any():
            return m, "unsat"
        row_or = np.bitwise_or.reduce(singles, axis=1)
        col_or = np.bitwise_or.reduce(singles, axis=0)
        box_or = np.bitwise_or.reduce(
            np.bitwise_or.reduce(singles.reshape(vb, bh, hb, bw), axis=3),
            axis=1,
        )
        box_exp = np.repeat(np.repeat(box_or, bh, axis=0), bw, axis=1)
        m = m & ~((row_or[:, None] | col_or[None, :] | box_exp) & ~singles)
        if (m == 0).any():
            return m, "unsat"
        bits = (m[..., None] >> digits) & 1
        row_u = bits.sum(axis=1) == 1
        col_u = bits.sum(axis=0) == 1
        box_u = bits.reshape(vb, bh, hb, bw, n).sum(axis=(1, 3)) == 1
        box_u_exp = np.repeat(np.repeat(box_u, bh, axis=0), bw, axis=1)
        uniq = row_u[:, None, :] | col_u[None, :, :] | box_u_exp
        hid = m & (uniq * weights).sum(-1)
        if (popcounts(hid) > 1).any():
            return m, "unsat"
        m = np.where(hid != 0, hid, m)
        if np.array_equal(m, prev):
            break
    pc = popcounts(m)
    if (pc == 1).all():
        return m, "solved"
    return m, "open"


def features_np(m, geom):
    """f32[n, n, 7]: the numpy twin of the in-graph feature maps."""
    n = geom.n
    vb, hb, bh, bw = geom.n_vboxes, geom.n_hboxes, geom.box_h, geom.box_w
    digits = np.arange(n, dtype=np.int64)
    pc = ((m[..., None] >> digits) & 1).sum(-1)
    und = (pc > 1).astype(np.int64)
    excess = np.where(pc > 1, pc - 1, 0)

    def unit(x):
        row = np.repeat(x.sum(axis=1, keepdims=True), n, axis=1)
        col = np.repeat(x.sum(axis=0, keepdims=True), n, axis=0)
        box = x.reshape(vb, bh, hb, bw).sum(axis=(1, 3))
        box = np.repeat(np.repeat(box, bh, axis=0), bw, axis=1)
        return row, col, box

    row_e, col_e, box_e = unit(excess)
    row_u, col_u, box_u = unit(und)
    feats = np.stack(
        [
            pc / n,
            (row_e - excess) / (n * n),
            (col_e - excess) / (n * n),
            (box_e - excess) / (n * n),
            (row_u - und) / n,
            (col_u - und) / n,
            (box_u - und) / n,
        ],
        axis=-1,
    )
    return feats.astype(np.float32)


def record_branch_examples(grid, geom, max_nodes: int = 50_000):
    """Replay one solve host-side, journaling every branch decision.

    Returns ``(examples, nodes)``; each example is ``{"features": [7
    floats], "pc": int, "nodes": int}``: the chosen cell's features and
    the size of the subtree its guess opened."""
    n = geom.n
    g = np.asarray(grid, dtype=np.int64)
    full = (1 << n) - 1
    m0 = np.full((n, n), full, dtype=np.int64)
    nz = g > 0
    m0[nz] = np.int64(1) << (g[nz] - 1)
    digits = np.arange(n, dtype=np.int64)

    examples = []
    budget = [max_nodes]

    import sys

    # Rest-chains recurse one frame per candidate digit eliminated; a
    # pathological 9x9 tree can sit deeper than CPython's default 1000.
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 20_000))

    def dfs(m):
        """(solved, subtree_nodes) under the kernel's binary scheme: guess
        = lowest digit at the MRV cell, rest = the other candidates."""
        m, status = _np_propagate(m, geom)
        if status == "solved":
            return True, 0
        if status == "unsat" or budget[0] <= 0:
            return False, 0
        budget[0] -= 1
        pc = ((m[..., None] >> digits) & 1).sum(-1)
        key = np.where(pc > 1, pc * (n * n) + np.arange(n * n).reshape(n, n), BIG)
        cell = int(key.argmin())
        r, c = divmod(cell, n)
        feats = features_np(m, geom)[r, c]
        ex = {"features": [float(v) for v in feats], "pc": int(pc[r, c]), "nodes": 0}
        examples.append(ex)
        low = m[r, c] & -m[r, c]
        guess = m.copy()
        guess[r, c] = low
        solved, sub_g = dfs(guess)
        nodes = 1 + sub_g
        if not solved:
            rest = m.copy()
            rest[r, c] &= ~low
            solved, sub_r = dfs(rest)
            nodes += sub_r
        ex["nodes"] = nodes
        return solved, nodes

    try:
        solved, total = dfs(m0)
    finally:
        sys.setrecursionlimit(old_limit)
    return examples, total
