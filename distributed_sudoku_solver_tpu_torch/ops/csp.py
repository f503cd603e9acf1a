"""The problem interface of the lane-stack engine: what a CSP must provide.

The search engine (:mod:`.frontier`: per-lane DFS stacks, work stealing,
cancellation) is generic over a *problem* object.  A problem owns the
meaning of a *state*, one ``int32[h, w]`` tensor per search node (uint32
bit patterns; a Sudoku candidate board).  The engine only stacks, ships and
hands states back to the problem's three batched functions:

* ``propagate(states) -> (states, sweeps)``: inference to a fixpoint
  (monotonic: may only restrict states).
* ``status(states) -> (solved, contradiction)``: classify each state.
* ``branch(states) -> (guess, rest)``: two children partitioning the
  parent (guess explored first).  Values for non-undecided lanes are
  ignored, so the functions must be total.

Problem objects are hashable and equality-stable, as in the JAX package.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch


@runtime_checkable
class CSProblem(Protocol):
    """Static problem definition consumed by the frontier engine."""

    @property
    def state_shape(self) -> tuple[int, int]:
        """(h, w) of one search state; states are int32[..., h, w]."""
        ...

    def propagate(self, states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """[L, h, w] -> (restricted states, int32 sweep count)."""
        ...

    def status(self, states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """[L, h, w] -> (solved bool[L], contradiction bool[L])."""
        ...

    def branch(self, states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """[L, h, w] -> (guess, rest): two children partitioning the parent."""
        ...

    def signature(self) -> str:
        """Stable identity string."""
        ...
