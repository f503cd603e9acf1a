"""Sudoku as a :class:`~distributed_sudoku_solver_tpu_torch.ops.csp.CSProblem`.

Candidate-bitmask boards with the propagation of :mod:`..ops.propagate`
and binary digit branching, as in the JAX package's ``models/sudoku.py``.
``propagator`` keeps that package's values: ``'pallas'`` selects the
hand-written fixpoint kernel (:mod:`..ops.cuda_propagate`), while
``'xla'`` and ``'slices'`` both run the plain torch fixpoint (the two JAX
backends differ only in layout, and compute the same masks).
"""

from __future__ import annotations

import dataclasses

import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops import ordering
from distributed_sudoku_solver_tpu_torch.ops.bitmask import highest_bit, lowest_bit, popcount
from distributed_sudoku_solver_tpu_torch.ops.propagate import RULE_TIERS, board_status, propagate

PROPAGATORS = ("xla", "pallas", "slices")


@dataclasses.dataclass(frozen=True)
class SudokuCSP:
    """Sudoku-family CSP at a fixed geometry (hashable).

    ``branch_rule``: 'minrem' (fewest candidates, MRV), 'first' (first
    undecided cell row-major, the oracle's order), 'minrem-desc' (MRV with
    descending digits), 'mixed' (a per-state hash picks minrem or first),
    or a scored head ``'head:<name>'`` (:mod:`..ops.ordering`).
    """

    geom: Geometry
    branch_rule: str = "minrem"
    max_sweeps: int = 64
    propagator: str = "xla"
    rules: str = "basic"

    def __post_init__(self) -> None:
        ordering.validate_branch(self.branch_rule)
        if self.propagator not in PROPAGATORS:
            raise ValueError(f"unknown propagator {self.propagator!r}")
        if self.rules not in RULE_TIERS:
            raise ValueError(f"unknown rules {self.rules!r}")

    @property
    def state_shape(self) -> tuple[int, int]:
        return (self.geom.n, self.geom.n)

    def propagate(self, states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if self.propagator == "pallas":
            from distributed_sudoku_solver_tpu_torch.ops.cuda_propagate import (
                propagate_fixpoint_pallas,
            )

            return propagate_fixpoint_pallas(
                states, self.geom, self.max_sweeps, rules=self.rules
            )
        return propagate(states, self.geom, self.max_sweeps, self.rules)

    def status(self, states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        st = board_status(states, self.geom)
        return st.solved, st.contradiction

    def branch(self, states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Split one cell binarily: lowest (or highest) candidate digit vs the rest."""
        onehot = self._branch_cell_onehot(states)
        pick = (
            highest_bit(states)
            if self.branch_rule == "minrem-desc"
            else lowest_bit(states)
        )
        guess = torch.where(onehot, pick, states)
        rest = torch.where(onehot, states & ~pick, states)
        return guess, rest

    def branch3(self, states: torch.Tensor):
        """Three-way split of the branch cell: two singleton children + rest.

        ``(guess, second, rest3, has_rest3)``; ``has_rest3`` is False when
        the cell had exactly two candidates (rest3 must then not be pushed)."""
        onehot = self._branch_cell_onehot(states)
        pick_low = self.branch_rule != "minrem-desc"
        b1 = lowest_bit(states) if pick_low else highest_bit(states)
        rem1 = states & ~b1
        b2 = lowest_bit(rem1) if pick_low else highest_bit(rem1)
        rem2 = rem1 & ~b2
        guess = torch.where(onehot, b1, states)
        second = torch.where(onehot, b2, states)
        rest3 = torch.where(onehot, rem2, states)
        has_rest3 = (onehot & (rem2 != 0)).flatten(-2).any(-1)
        return guess, second, rest3, has_rest3

    def _branch_cell_onehot(self, cand: torch.Tensor) -> torch.Tensor:
        """bool[L, n, n] one-hot of the cell to branch on per board."""
        n = self.geom.n
        lanes = cand.shape[0]
        pc = popcount(cand).reshape(lanes, n * n)
        cell_idx = torch.arange(n * n, dtype=torch.int32, device=cand.device)
        if ordering.is_head_rule(self.branch_rule):
            # Scored head: f32 score -> the same packed argmin key shape.
            head = ordering.get_head(self.branch_rule)
            score = head.score_lanes(cand, self.geom)
            key = ordering.pack_key(score, pc > 1, cell_idx, n, head.quant)
            chosen = torch.argmin(key, dim=-1)
            return (cell_idx[None, :] == chosen[:, None]).reshape(lanes, n, n)
        big = torch.full_like(pc, ordering.BIG)
        minrem_key = torch.where(pc > 1, pc * (n * n) + cell_idx, big)
        first_key = torch.where(pc > 1, cell_idx.expand_as(pc), big)
        if self.branch_rule in ("minrem", "minrem-desc"):
            key = minrem_key
        elif self.branch_rule == "first":
            key = first_key
        else:  # 'mixed': deterministic per-state hash picks the rule
            h = (pc * (cell_idx + 1)).sum(-1, dtype=torch.int32)
            key = torch.where((h & 1)[:, None] == 0, minrem_key, first_key)
        chosen = torch.argmin(key, dim=-1)
        onehot = cell_idx[None, :] == chosen[:, None]
        return onehot.reshape(lanes, n, n)

    def signature(self) -> str:
        return (
            f"sudoku:{self.geom.box_h}x{self.geom.box_w}"
            f":{self.branch_rule}:{self.max_sweeps}:{self.propagator}:{self.rules}"
        )
