"""Bitmask primitives for the candidate-tensor board encoding (torch).

A board is an ``int32[n, n]`` tensor of candidate bitmasks read as uint32
bit patterns: bit ``d`` set means digit ``d+1`` is still possible.  Every
helper here works on an arbitrary leading batch shape.

torch has no popcount or count-leading-zeros, and its ``>>`` on int32 is an
*arithmetic* shift (it copies the sign bit), so the helpers that would
smear or count bits widen to int64 and mask to the low 32 bits first: that
makes every shift logical and keeps bit 31 (digit 32) an ordinary digit.
"""

from __future__ import annotations

import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry

_LOW32 = 0xFFFFFFFF


def _u64(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> the same bits as a non-negative int64."""
    return x.to(torch.int64) & _LOW32


def _i32(u: torch.Tensor) -> torch.Tensor:
    """Non-negative int64 < 2**32 -> int32 carrying the same low 32 bits."""
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Number of set bits of each uint32 pattern (int32 result)."""
    u = _u64(x)
    u = u - ((u >> 1) & 0x55555555)
    u = (u & 0x33333333) + ((u >> 2) & 0x33333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F
    return (((u * 0x01010101) & _LOW32) >> 24).to(torch.int32)


def _smear(u: torch.Tensor) -> torch.Tensor:
    """Logical right-smear of a non-negative int64 < 2**32."""
    for s in (1, 2, 4, 8, 16):
        u = u | (u >> s)
    return u


def clz(x: torch.Tensor) -> torch.Tensor:
    """Leading zero bits of each uint32 pattern (32 for 0), int32."""
    return 32 - popcount(_i32(_smear(_u64(x))))


def lowest_bit(x: torch.Tensor) -> torch.Tensor:
    """Isolate the lowest set bit: the ascending-digit branch choice."""
    return x & (~x + 1)


def highest_bit(x: torch.Tensor) -> torch.Tensor:
    """Isolate the highest set bit: the descending-digit branch choice.

    Smears with logical shifts (see the module docstring): with int32's
    arithmetic ``>>`` a mask holding bit 31 would smear ones downward from
    the sign and lose its top edge.  0 stays 0."""
    u = _smear(_u64(x))
    return _i32(u ^ (u >> 1))


def is_single(x: torch.Tensor) -> torch.Tensor:
    """True where the cell is decided (exactly one candidate)."""
    return popcount(x) == 1


def mask_to_value(x: torch.Tensor) -> torch.Tensor:
    """Singleton mask -> digit value in 1..n; non-singletons -> 0 (int32)."""
    bit_index = 31 - clz(x)
    return torch.where(is_single(x), bit_index + 1, torch.zeros_like(bit_index))


def value_to_mask(v: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Digit value (1..n; 0 = empty) -> candidate mask (empty -> full mask).

    Out-of-range values (negative or > n) map to the empty mask 0, a
    contradiction: corrupt input yields a clean "unsat" verdict."""
    v = v.to(torch.int32)
    one = torch.ones_like(v)
    given = one << torch.clamp(v - 1, 0, geom.n - 1)
    full = torch.full_like(v, geom.full_mask_i32)
    out = torch.where(v > 0, given, full)
    in_range = (v >= 0) & (v <= geom.n)
    return torch.where(in_range, out, torch.zeros_like(v))


def encode_grid(grid: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """int grid [..., n, n] (0 = empty) -> candidate tensor int32 [..., n, n]."""
    return value_to_mask(torch.as_tensor(grid), geom)


def decode_grid(cand: torch.Tensor) -> torch.Tensor:
    """Candidate tensor -> int32 grid; undecided/contradicted cells -> 0."""
    return mask_to_value(cand)


def or_reduce(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Bitwise-OR reduction along one axis (log-depth tree of slices)."""
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    pow2 = 1 << (n - 1).bit_length()
    if pow2 != n:
        x = torch.nn.functional.pad(x, (0, pow2 - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] | x[..., h:]
    return x[..., 0]


def once_twice_reduce(x: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Along ``axis``: bits set in >=1 element (``once``) and >=2 (``twice``)."""
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    pow2 = 1 << (n - 1).bit_length()
    if pow2 != n:
        x = torch.nn.functional.pad(x, (0, pow2 - n))
    once, twice = x, torch.zeros_like(x)
    while once.shape[-1] > 1:
        h = once.shape[-1] // 2
        o1, o2 = once[..., :h], once[..., h:]
        t1, t2 = twice[..., :h], twice[..., h:]
        once, twice = o1 | o2, t1 | t2 | (o1 & o2)
    return once[..., 0], twice[..., 0]


def to_boxes(cand: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """[..., n, n] -> [..., n_boxes, cells_per_box]: box units, row-major cells."""
    lead = cand.shape[:-2]
    x = cand.reshape(*lead, geom.n_vboxes, geom.box_h, geom.n_hboxes, geom.box_w)
    x = torch.swapaxes(x, -3, -2)
    return x.reshape(*lead, geom.n, geom.n)


def from_boxes(boxes: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Inverse of :func:`to_boxes`."""
    lead = boxes.shape[:-2]
    x = boxes.reshape(*lead, geom.n_vboxes, geom.n_hboxes, geom.box_h, geom.box_w)
    x = torch.swapaxes(x, -3, -2)
    return x.reshape(*lead, geom.n, geom.n)

