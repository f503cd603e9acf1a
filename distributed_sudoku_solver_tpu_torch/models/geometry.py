"""Board geometry: an n x n grid of (box_h x box_w) boxes.

The same frozen dataclass as the JAX package's ``models/geometry.py``, kept
as a copy so the port never imports that package.  Candidate masks are
``torch.int32`` tensors read as uint32 bit patterns: bit ``d`` set means
digit ``d+1`` is still possible, and n <= 32 keeps every digit inside one
word (bit 31 is the sign bit of the int32 carrier, which is why every bit
helper in :mod:`..ops.bitmask` shifts logically).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Sudoku-family board geometry: an n x n grid of (box_h x box_w) boxes."""

    box_h: int
    box_w: int

    def __post_init__(self) -> None:
        if self.box_h < 1 or self.box_w < 1:
            raise ValueError(f"box dims must be >= 1, got {self.box_h}x{self.box_w}")
        if self.n > 32:
            raise ValueError(f"n={self.n} exceeds uint32 mask capacity (32 digits)")

    @property
    def n(self) -> int:
        """Digits per unit == rows == cols (n = box_h * box_w)."""
        return self.box_h * self.box_w

    @property
    def n_cells(self) -> int:
        return self.n * self.n

    @property
    def full_mask(self) -> int:
        """Bitmask with all n digit bits set, as an unsigned Python int."""
        return (1 << self.n) - 1

    @property
    def full_mask_i32(self) -> int:
        """:attr:`full_mask` as the int32 value with the same bit pattern."""
        return as_i32(self.full_mask)

    @property
    def n_vboxes(self) -> int:
        """Boxes stacked vertically: n / box_h."""
        return self.n // self.box_h

    @property
    def n_hboxes(self) -> int:
        """Boxes side by side: n / box_w."""
        return self.n // self.box_w

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.n}x{self.n}({self.box_h}x{self.box_w})"


def as_i32(v: int) -> int:
    """Unsigned 32-bit Python int -> the int32 value with the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


SUDOKU_4 = Geometry(2, 2)
SUDOKU_6 = Geometry(2, 3)
SUDOKU_9 = Geometry(3, 3)
SUDOKU_16 = Geometry(4, 4)
SUDOKU_25 = Geometry(5, 5)

_BY_SIZE = {g.n: g for g in (SUDOKU_4, SUDOKU_6, SUDOKU_9, SUDOKU_16, SUDOKU_25)}


def geometry_for_size(n: int) -> Geometry:
    """Geometry for a square-box (or known) board size n."""
    try:
        return _BY_SIZE[n]
    except KeyError:
        root = int(round(n**0.5))
        if root * root == n:
            return Geometry(root, root)
        raise ValueError(f"no known geometry for board size {n}") from None
