"""Host<->device wire packing for the bulk path (byte-identical to the JAX package).

Formats, chosen statically by geometry:

* ``nibble`` (n <= 14): grids ``uint8[B, ceil(n²/2)]``, 4 bits a cell, code
  15 marking a corrupt cell; results ``uint8[B, ceil(n²/2) + 1]`` (cells,
  then the verdict byte).
* ``byte`` (n > 14): grids ``int8[B, n²]`` (corrupt -> -1); results
  ``int8[B, n² + 1]``.
* ``dense`` (n <= 9): three digits base (n+1) in a 10-bit group, four
  groups in a 5-byte block; a corrupt board is replaced on the host by a
  canonical contradictory one (two 1s in row 0).

Host functions are numpy; ``*_device`` functions are torch and run on the
tensor's device.  Integer work that would need uint32 runs in int64.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry

NIBBLE_MAX_N = 14
DENSE_MAX_N = 9

VERDICT_SOLVED = 1
VERDICT_UNSAT = 2
VERDICT_BRANCHED = 4


def uses_nibbles(geom: Geometry) -> bool:
    return geom.n <= NIBBLE_MAX_N


def grid_wire_width(geom: Geometry) -> int:
    n2 = geom.n * geom.n
    return (n2 + 1) // 2 if uses_nibbles(geom) else n2


def pack_grids_host(grids: np.ndarray, geom: Geometry) -> np.ndarray:
    """int grids [B, n, n] -> wire bytes (numpy, host side)."""
    b = grids.shape[0]
    flat = np.ascontiguousarray(grids).reshape(b, -1).astype(np.int64)
    bad = (flat < 0) | (flat > geom.n)
    if not uses_nibbles(geom):
        out = flat.astype(np.int8)
        out[bad] = -1
        return out
    cells = np.where(bad, 15, flat).astype(np.uint8)
    if cells.shape[1] % 2:
        cells = np.concatenate([cells, np.zeros((b, 1), np.uint8)], axis=1)
    return cells[:, 0::2] | (cells[:, 1::2] << 4)


def unpack_grids_device(packed: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Wire bytes -> int32 grids [B, n, n] (torch, on packed's device)."""
    b = packed.shape[0]
    n2 = geom.n * geom.n
    if not uses_nibbles(geom):
        return packed.to(torch.int32).reshape(b, geom.n, geom.n)
    u = packed.to(torch.uint8)
    cells = torch.stack([u & 15, u >> 4], dim=-1).reshape(b, -1)[:, :n2]
    return cells.to(torch.int32).reshape(b, geom.n, geom.n)


def _verdict(solved, unsat, branched) -> torch.Tensor:
    return (
        solved.to(torch.uint8) * VERDICT_SOLVED
        | unsat.to(torch.uint8) * VERDICT_UNSAT
        | branched.to(torch.uint8) * VERDICT_BRANCHED
    )


def pack_result_device(solution, solved, unsat, branched, geom: Geometry) -> torch.Tensor:
    """(solution int[B,n,n], verdict bools[B]) -> one wire tensor (torch)."""
    b = solution.shape[0]
    verdict = _verdict(solved, unsat, branched)
    flat = solution.reshape(b, -1)
    if not uses_nibbles(geom):
        return torch.cat([flat.to(torch.int8), verdict.to(torch.int8)[:, None]], dim=1)
    cells = flat.to(torch.uint8)
    if cells.shape[1] % 2:
        cells = torch.cat([cells, cells.new_zeros((b, 1))], dim=1)
    packed = cells[:, 0::2] | (cells[:, 1::2] << 4)
    return torch.cat([packed, verdict[:, None]], dim=1)


def unpack_result_host(wire, geom: Geometry):
    """Wire result -> (solution int32[B,n,n], solved, unsat, branched) (host)."""
    wire = np.asarray(wire)
    b = wire.shape[0]
    n2 = geom.n * geom.n
    verdict = wire[:, -1].astype(np.uint8)
    cells = wire[:, :-1]
    if uses_nibbles(geom):
        u = cells.astype(np.uint8)
        cells = np.stack([u & 15, u >> 4], axis=-1).reshape(b, -1)[:, :n2]
    solution = cells.astype(np.int32).reshape(b, geom.n, geom.n)
    return (
        solution,
        (verdict & VERDICT_SOLVED) > 0,
        (verdict & VERDICT_UNSAT) > 0,
        (verdict & VERDICT_BRANCHED) > 0,
    )


# -- dense format ---------------------------------------------------------------


def uses_dense(geom: Geometry) -> bool:
    return geom.n <= DENSE_MAX_N


def _dense_geometry(geom: Geometry) -> tuple[int, int, int]:
    """(cells, groups, blocks): 3 cells/group, 4 groups/5-byte block."""
    n2 = geom.n * geom.n
    groups = -(-n2 // 3)
    blocks = -(-groups // 4)
    return n2, groups, blocks


def grid_dense_width(geom: Geometry) -> int:
    return 5 * _dense_geometry(geom)[2]


def _digits_to_blocks_np(cells: np.ndarray, geom: Geometry) -> np.ndarray:
    """uint16 digits [B, n^2] -> packed uint8 [B, 5*blocks] (host numpy)."""
    b = cells.shape[0]
    n2, groups, blocks = _dense_geometry(geom)
    base = geom.n + 1
    pad = np.zeros((b, groups * 3 - n2), np.uint32)
    d = np.concatenate([cells.astype(np.uint32), pad], axis=1).reshape(b, groups, 3)
    g = d[:, :, 0] + base * d[:, :, 1] + base * base * d[:, :, 2]
    gpad = np.zeros((b, blocks * 4 - groups), np.uint32)
    g = np.concatenate([g, gpad], axis=1).reshape(b, blocks, 4)
    lo = g[:, :, 0] | (g[:, :, 1] << 10) | (g[:, :, 2] << 20) | ((g[:, :, 3] & 3) << 30)
    hi = (g[:, :, 3] >> 2).astype(np.uint8)
    out = np.empty((b, blocks, 5), np.uint8)
    for i in range(4):
        out[:, :, i] = (lo >> (8 * i)).astype(np.uint8)
    out[:, :, 4] = hi
    return out.reshape(b, blocks * 5)


def _blocks_to_digits_np(packed: np.ndarray, geom: Geometry) -> np.ndarray:
    """Inverse of :func:`_digits_to_blocks_np` -> int32 [B, n^2] (host)."""
    b = packed.shape[0]
    n2, groups, blocks = _dense_geometry(geom)
    base = geom.n + 1
    raw = packed.reshape(b, blocks, 5).astype(np.uint32)
    lo = raw[:, :, 0] | (raw[:, :, 1] << 8) | (raw[:, :, 2] << 16) | (raw[:, :, 3] << 24)
    g = np.stack(
        [lo & 1023, (lo >> 10) & 1023, (lo >> 20) & 1023,
         ((lo >> 30) & 3) | (raw[:, :, 4] << 2)],
        axis=2,
    ).reshape(b, blocks * 4)[:, :groups]
    d = np.stack([g % base, (g // base) % base, g // (base * base)], axis=2)
    return d.reshape(b, groups * 3)[:, :n2].astype(np.int32)


def pack_grids_dense_host(grids: np.ndarray, geom: Geometry) -> np.ndarray:
    """int grids [B, n, n] -> dense wire bytes; corrupt boards -> the
    canonical contradictory board (proven unsat by the solver)."""
    b = grids.shape[0]
    flat = np.ascontiguousarray(grids).reshape(b, -1).astype(np.int64)
    bad = ((flat < 0) | (flat > geom.n)).any(axis=1)
    cells = flat.astype(np.uint16)
    if bad.any():
        contra = np.zeros(geom.n * geom.n, np.uint16)
        contra[0] = contra[1] = 1
        cells[bad] = contra
    return _digits_to_blocks_np(cells, geom)


def unpack_grids_dense_device(packed: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Dense wire bytes -> int32 grids [B, n, n] (torch)."""
    b = packed.shape[0]
    n2, groups, blocks = _dense_geometry(geom)
    base = geom.n + 1
    raw = packed.reshape(b, blocks, 5).to(torch.int64)
    lo = raw[:, :, 0] | (raw[:, :, 1] << 8) | (raw[:, :, 2] << 16) | (raw[:, :, 3] << 24)
    g = torch.stack(
        [lo & 1023, (lo >> 10) & 1023, (lo >> 20) & 1023,
         ((lo >> 30) & 3) | (raw[:, :, 4] << 2)],
        dim=2,
    ).reshape(b, blocks * 4)[:, :groups]
    d = torch.stack(
        [g % base, torch.div(g, base, rounding_mode="floor") % base,
         torch.div(g, base * base, rounding_mode="floor")],
        dim=2,
    )
    cells = d.reshape(b, groups * 3)[:, :n2]
    return cells.to(torch.int32).reshape(b, geom.n, geom.n)


def pack_result_dense_device(solution, solved, unsat, branched, geom: Geometry) -> torch.Tensor:
    """(solution, verdicts) -> dense wire tensor [B, 5*blocks + 1] (torch)."""
    b = solution.shape[0]
    n2, groups, blocks = _dense_geometry(geom)
    base = geom.n + 1
    verdict = _verdict(solved, unsat, branched)
    flat = solution.reshape(b, -1).to(torch.int64) & 0xFFFFFFFF
    d = torch.nn.functional.pad(flat, (0, groups * 3 - n2)).reshape(b, groups, 3)
    g = d[:, :, 0] + base * d[:, :, 1] + base * base * d[:, :, 2]
    g = torch.nn.functional.pad(g, (0, blocks * 4 - groups)).reshape(b, blocks, 4)
    lo = (g[:, :, 0] | (g[:, :, 1] << 10) | (g[:, :, 2] << 20)
          | ((g[:, :, 3] & 3) << 30)) & 0xFFFFFFFF
    hi = ((g[:, :, 3] >> 2) & 0xFF).to(torch.uint8)
    parts = [((lo >> (8 * i)) & 0xFF).to(torch.uint8)[:, :, None] for i in range(4)]
    out = torch.cat([*parts, hi[:, :, None]], dim=2).reshape(b, blocks * 5)
    return torch.cat([out, verdict[:, None]], dim=1)


def unpack_result_dense_host(wire_bytes, geom: Geometry):
    """Dense wire result -> (solution, solved, unsat, branched) (host)."""
    wire_bytes = np.asarray(wire_bytes)
    b = wire_bytes.shape[0]
    verdict = wire_bytes[:, -1].astype(np.uint8)
    solution = _blocks_to_digits_np(wire_bytes[:, :-1], geom).reshape(b, geom.n, geom.n)
    return (
        solution,
        (verdict & VERDICT_SOLVED) > 0,
        (verdict & VERDICT_UNSAT) > 0,
        (verdict & VERDICT_BRANCHED) > 0,
    )


def best_format(geom: Geometry) -> str:
    """'dense' where it is strictly smaller than the legacy packing, else 'packed'."""
    if uses_dense(geom) and grid_dense_width(geom) < grid_wire_width(geom):
        return "dense"
    return "packed"


def pack_grids_for(grids: np.ndarray, geom: Geometry, fmt: str) -> np.ndarray:
    return pack_grids_dense_host(grids, geom) if fmt == "dense" else pack_grids_host(grids, geom)


def unpack_result_for(wire_arr, geom: Geometry, fmt: str):
    return (
        unpack_result_dense_host(wire_arr, geom)
        if fmt == "dense"
        else unpack_result_host(wire_arr, geom)
    )
