"""The port's collectives (``parallel/collectives.py``) and the banded ring
all-reduces against the same JAX collectives under ``shard_map``.

Eight JAX CPU devices (conftest's forced host device count) against port
meshes of 1, 2, 4 and 8 shards on the CPU (``parallel.mesh.virtual_devices``).
Inputs are int32 words made from a seed with numpy, the sign bit included.
Tolerance: bit equality, and int32 in gives int32 out.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_sudoku_solver_tpu.parallel import board_sharded as jbs
from distributed_sudoku_solver_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distributed_sudoku_solver_tpu.parallel.mesh import shard_map
from distributed_sudoku_solver_tpu_torch.parallel import board_sharded, collectives as C
from distributed_sudoku_solver_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    virtual_devices,
    visible_devices,
)

SIZES = [1, 2, 4, 8]
ROWS = 3  # rows of each shard's block


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _data(n_dev: int, seed: int, cols: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-(2**31), 2**31, size=(n_dev * ROWS, cols), dtype=np.int64).astype(
        np.int32)


def _jax(fn, x: np.ndarray, n_dev: int) -> list:
    """``fn(block, axis)`` per device under shard_map; per-device outputs."""
    mesh = jax_make_mesh(jax.devices()[:n_dev])
    f = shard_map(lambda b: fn(b, "lanes")[None], mesh=mesh, in_specs=P("lanes"),
                  out_specs=P("lanes"), check_vma=False)
    out = np.asarray(jax.jit(f)(jnp.asarray(x)))
    return list(out)


def _port(fn, x: np.ndarray, n_dev: int) -> list:
    with virtual_devices(n_dev):
        mesh = make_mesh(device="cpu")
    assert mesh.size == n_dev
    blocks = [torch.from_numpy(x[i * ROWS:(i + 1) * ROWS].copy()) for i in range(n_dev)]
    out = fn(blocks, mesh)
    for o in out:
        assert o.device.type == "cpu"
    return [o.numpy() for o in out]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int32, g.dtype
        np.testing.assert_array_equal(g, np.asarray(w).astype(np.int32))


@pytest.mark.parametrize("n_dev", SIZES)
@pytest.mark.parametrize("name", ["psum", "pmin", "pmax"])
def test_reductions_match_jax(name, n_dev):
    x = _data(n_dev, seed=n_dev)
    want = _jax(lambda b, ax: getattr(jax.lax, name)(b, ax), x, n_dev)
    got = _port(lambda xs, m: getattr(C, name)(xs, m), x, n_dev)
    _assert_equal(got, want)


@pytest.mark.parametrize("n_dev", SIZES)
@pytest.mark.parametrize("tiled", [False, True])
def test_all_gather_matches_jax(tiled, n_dev):
    x = _data(n_dev, seed=10 + n_dev)
    want = _jax(lambda b, ax: jax.lax.all_gather(b, ax, axis=0, tiled=tiled), x, n_dev)
    got = _port(lambda xs, m: C.all_gather(xs, m, axis=0, tiled=tiled), x, n_dev)
    _assert_equal(got, want)


@pytest.mark.parametrize("n_dev", SIZES)
@pytest.mark.parametrize("which", ["forward", "backward", "partial"])
def test_ppermute_matches_jax(which, n_dev):
    """Both ring directions, and a permutation that leaves shards without a
    source (they get zeros)."""
    if which == "forward":
        perm = C.ring_forward(n_dev)
    elif which == "backward":
        perm = C.ring_backward(n_dev)
    else:
        perm = [(0, n_dev - 1)]
    x = _data(n_dev, seed=20 + n_dev)
    want = _jax(lambda b, ax: jax.lax.ppermute(b, ax, perm), x, n_dev)
    got = _port(lambda xs, m: C.ppermute(xs, perm, m), x, n_dev)
    _assert_equal(got, want)


@pytest.mark.parametrize("n_dev", SIZES)
def test_axis_index_matches_jax(n_dev):
    x = _data(n_dev, seed=0)
    want = _jax(lambda b, ax: jax.lax.axis_index(ax).astype(jnp.int32), x, n_dev)
    got = _port(lambda xs, m: C.axis_index(m), x, n_dev)
    _assert_equal(got, want)


@pytest.mark.parametrize("n_dev", SIZES)
def test_ring_or_and_once_twice_match_jax(n_dev):
    """The banded ring all-reduces against JAX's on the same blocks; the
    once-twice pair from the blocks' own (once, twice) partials."""
    x = _data(n_dev, seed=30 + n_dev)
    y = _data(n_dev, seed=40 + n_dev)
    want_or = _jax(lambda b, ax: jbs.ring_or(b, ax, n_dev), x, n_dev)
    want_o = _jax(lambda b, ax: jbs.ring_once_twice(b, b & 0x5A5A5A5A, ax, n_dev)[0], x, n_dev)
    want_t = _jax(lambda b, ax: jbs.ring_once_twice(b, b & 0x5A5A5A5A, ax, n_dev)[1], x, n_dev)
    got_or = _port(lambda xs, m: board_sharded.ring_or(xs, m), x, n_dev)
    got_o = _port(lambda xs, m: board_sharded.ring_once_twice(
        xs, [v & 0x5A5A5A5A for v in xs], m)[0], x, n_dev)
    got_t = _port(lambda xs, m: board_sharded.ring_once_twice(
        xs, [v & 0x5A5A5A5A for v in xs], m)[1], x, n_dev)
    _assert_equal(got_or, want_or)
    _assert_equal(got_o, want_o)
    _assert_equal(got_t, want_t)
    # The ring equals the one-device reduction of the whole array.
    full_or = functools.reduce(np.bitwise_or, list(y.reshape(n_dev, ROWS, -1)))
    got = _port(lambda xs, m: board_sharded.ring_or(xs, m), y, n_dev)
    for g in got:
        np.testing.assert_array_equal(g, full_or)


def test_psum_refuses_bool_and_keeps_int32():
    mesh = Mesh((torch.device("cpu"),) * 2)
    with pytest.raises(TypeError, match="bool"):
        C.psum([torch.ones(3, dtype=torch.bool)] * 2, mesh)
    big = torch.tensor([2**31 - 1], dtype=torch.int32)
    out = C.psum([big, big], mesh)[0]
    assert out.dtype == torch.int32 and int(out) == -2  # wraps as a uint32 sum would


def test_visible_devices_and_virtual_context():
    assert visible_devices("cpu") == [torch.device("cpu")]
    with virtual_devices(8):
        assert visible_devices("cpu") == [torch.device("cpu")] * 8
        with virtual_devices(3):
            assert len(make_mesh(device="cpu").devices) == 3
        assert make_mesh(device="cpu").size == 8
    assert make_mesh(device="cpu").size == 1
