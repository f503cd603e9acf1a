"""Port parity: geometry and bitmask helpers against the JAX package.

Inputs come from numpy seeds and go through both packages; masks cross as
uint32 bit patterns (``np.view``).  Tolerance: exact equality everywhere.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import distributed_sudoku_solver_tpu.ops.bitmask as jb
import distributed_sudoku_solver_tpu_torch.ops.bitmask as tb
from distributed_sudoku_solver_tpu.models.geometry import Geometry as JGeometry
from distributed_sudoku_solver_tpu_torch.models import geometry as tgeo

GEOMS = [(2, 2), (2, 3), (3, 2), (3, 3), (2, 5), (3, 4), (4, 4), (4, 5), (5, 5)]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u(x) -> np.ndarray:
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.uint32) if a.dtype in (np.int32, np.uint32) else a


def _masks(seed: int, shape, bits: int = 32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**bits, size=shape, dtype=np.uint64).astype(np.uint32)
    flat = x.reshape(-1)
    flat[: flat.size // 4] |= np.uint32(1 << 31)  # bit 31 = the int32 sign bit
    flat[:: 7] = 0
    flat[1:: 11] = np.uint32(1 << 31)
    return x


@pytest.mark.parametrize("fn", ["popcount", "lowest_bit", "highest_bit", "is_single", "mask_to_value"])
def test_bit_helpers_match_jax_at_bit_31(fn):
    x = _masks(1, (4096,))
    want = np.asarray(getattr(jb, fn)(jnp.asarray(x)))
    got = getattr(tb, fn)(_t(x)).numpy()
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    assert np.array_equal(got, want.astype(got.dtype))


def test_clz_and_highest_bit_are_logical():
    x = np.array([0, 1, 2, 3, 0x80000000, 0xFFFFFFFF, 0x40000001, 0x00010000], np.uint32)
    assert tb.clz(_t(x)).tolist() == [32, 31, 30, 30, 0, 0, 1, 15]
    assert _u(tb.highest_bit(_t(x))).tolist() == [
        0, 1, 2, 2, 0x80000000, 0x80000000, 0x40000000, 0x00010000]
    assert tb.popcount(_t(x)).tolist() == [0, 1, 1, 2, 1, 32, 2, 1]
    assert tb.mask_to_value(_t(x)).tolist() == [0, 1, 2, 0, 32, 0, 0, 17]


@pytest.mark.parametrize("bh,bw", GEOMS)
def test_geometry_and_encoding_match(bh, bw):
    jg, tg = JGeometry(bh, bw), tgeo.Geometry(bh, bw)
    assert (jg.n, jg.full_mask, jg.n_vboxes, jg.n_hboxes) == (
        tg.n, tg.full_mask, tg.n_vboxes, tg.n_hboxes)
    rng = np.random.default_rng(bh * 10 + bw)
    grids = rng.integers(-1, jg.n + 2, size=(8, jg.n, jg.n)).astype(np.int32)
    enc_j = np.asarray(jb.encode_grid(jnp.asarray(grids), jg))
    enc_t = tb.encode_grid(torch.from_numpy(grids), tg)
    assert np.array_equal(_u(enc_t), enc_j)
    assert np.array_equal(tb.decode_grid(enc_t).numpy(), np.asarray(jb.decode_grid(enc_j)))
    cand = _masks(bh * 7 + bw, (5, jg.n, jg.n), bits=jg.n)
    for axis in (-1, -2):
        assert np.array_equal(_u(tb.or_reduce(_t(cand), axis)),
                              np.asarray(jb.or_reduce(jnp.asarray(cand), axis)))
        for a, b in zip(tb.once_twice_reduce(_t(cand), axis),
                        jb.once_twice_reduce(jnp.asarray(cand), axis)):
            assert np.array_equal(_u(a), np.asarray(b))
    boxes = tb.to_boxes(_t(cand), tg)
    assert np.array_equal(_u(boxes), np.asarray(jb.to_boxes(jnp.asarray(cand), jg)))
    assert np.array_equal(_u(tb.from_boxes(boxes, tg)), cand)


def test_geometry_admits_32_and_full_mask_is_all_ones():
    g = tgeo.Geometry(4, 8)
    assert g.n == 32 and g.full_mask == 0xFFFFFFFF and g.full_mask_i32 == -1
    enc = tb.encode_grid(torch.tensor([[0, 32, 33]]), g)
    assert _u(enc).tolist() == [[0xFFFFFFFF, 0x80000000, 0]]
    with pytest.raises(ValueError):
        tgeo.Geometry(3, 11)
    assert tgeo.geometry_for_size(16) == tgeo.SUDOKU_16
