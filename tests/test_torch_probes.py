"""Port parity: the two Mosaic probes (P16, PCV) against the JAX probes, and their kernels.

* P16: the JAX probe's ``build(jax, jnp, dtype)`` fixpoint (Pallas interpret
  mode on the CPU, as ``_interpret_default()`` gives there) and the port's
  :func:`fixpoint_probe_plain` on the same numpy inputs: 256 carved 24-clue
  boards (seed 7) plus random masks with empty cells (contradictions), in
  tiles of 128, uint32 and uint16.  Tolerance: exact equality.
* PCV: ``benchmarks/probe_cover_kernel.run(interpret=True)`` against
  :func:`cover_probe_plain` on the same seed-0 inputs: all four outputs
  exactly equal, and the pinned checksum.
* Card tests (``-m cuda``): each kernel against its plain version, exact.

The JAX probes are imported inside the tests that use them: the card
machine runs the ``cuda`` tests without JAX.
"""

import functools
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu_torch.probes import cover_kernel, uint16

REPO = Path(__file__).resolve().parents[1]


def _jax_probe(name):
    sys.path.insert(0, str(REPO / "benchmarks"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(REPO / "benchmarks"))


@functools.lru_cache(maxsize=None)
def _p16_boards() -> np.ndarray:
    """The probe's first 256 boards (unique puzzles: carving them costs
    seconds, so once per module)."""
    boards = uint16.probe_boards(256).numpy().view(np.uint32)
    boards.setflags(write=False)
    return boards


def _p16_inputs(seed=5):
    """256 probe boards, then 128 random 9-bit masks, 5 % of cells empty."""
    boards = _p16_boards()
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 512, size=(9, 9, 128)).astype(np.uint32)
    rand[rng.random(rand.shape) < 0.05] = 0
    return np.concatenate([boards, rand], axis=-1)


_NP = {"uint32": (np.uint32, np.int32, torch.int32), "uint16": (np.uint16, np.int16, torch.int16)}


@pytest.fixture(scope="module")
def p16_jax():
    """The JAX probe's fixpoint of the inputs, per dtype, in tiles of 128."""
    import jax
    import jax.numpy as jnp

    probe = _jax_probe("probe_uint16")
    cand = _p16_inputs()
    out = {}
    for name, (npdt, _, _) in _NP.items():
        fixpoint = probe.build(jax, jnp, getattr(jnp, name))
        out[name] = np.asarray(fixpoint(jnp.asarray(cand.astype(npdt)), tile=128))
    return cand, out


@pytest.mark.parametrize("dtype", ["uint32", "uint16"])
def test_p16_plain_matches_jax_probe(p16_jax, dtype):
    cand, want = p16_jax
    npdt, signed, _ = _NP[dtype]
    x = torch.from_numpy(cand.astype(npdt).view(signed))
    before = uint16.fixpoint_probe_cuda.launches
    got = uint16.fixpoint_probe(x)
    assert uint16.fixpoint_probe_cuda.launches == before  # CPU: the plain version
    assert got.dtype == x.dtype and got.shape == x.shape
    assert np.array_equal(got.numpy().view(npdt), want[dtype])
    # The boards did change, and no board reached the cap.
    assert not np.array_equal(want[dtype], cand.astype(npdt))
    assert int(uint16.probe_sweeps(x)[1].max()) < 64


def test_p16_low16_of_uint32_equals_uint16(p16_jax):
    cand, want = p16_jax
    assert np.array_equal(want["uint32"].astype(np.uint16), want["uint16"])
    x = torch.from_numpy(cand.view(np.int32))
    got32 = uint16.fixpoint_probe_plain(x)
    got16 = uint16.fixpoint_probe_plain(x.to(torch.int16))
    assert torch.equal(got32.to(torch.int16), got16)


@pytest.mark.parametrize("max_sweeps", [1, 2, 3])
def test_p16_capped_fixpoint_is_single_sweeps_in_turn(max_sweeps):
    """A cap below the fixpoint: the fixpoint is ``max_sweeps`` single
    sweeps run one after another (the JAX probe fixes its cap at 64)."""
    x = torch.from_numpy(_p16_inputs()[..., :200].view(np.int32).copy())
    got, sweeps = uint16.probe_sweeps(x, max_sweeps)
    step = x
    for _ in range(max_sweeps):
        step = uint16.fixpoint_probe_plain(step, 1)
    assert torch.equal(got, step)
    assert int(sweeps.max()) == max_sweeps


def test_p16_corpus_is_the_jax_probes():
    """The probe's boards are the JAX probe's corpus
    (``puzzle_batch(SUDOKU_9, 512, seed=7, n_clues=24)``, unique solutions),
    encoded boards-last: checked on its first 16 boards and tiled past them."""
    import jax.numpy as jnp

    from distributed_sudoku_solver_tpu.models.geometry import SUDOKU_9 as JSUDOKU_9
    from distributed_sudoku_solver_tpu.ops.bitmask import encode_grid as jencode_grid
    from distributed_sudoku_solver_tpu.utils.oracle import count_solutions
    from distributed_sudoku_solver_tpu.utils.puzzles import puzzle_batch as jpuzzle_batch

    base = jpuzzle_batch(JSUDOKU_9, 16, seed=7, n_clues=24)
    want = np.asarray(jencode_grid(jnp.asarray(base), JSUDOKU_9), np.uint32).transpose(1, 2, 0)
    got = uint16.probe_boards(16).numpy().view(np.uint32)
    assert got.shape == (9, 9, 16)
    assert np.array_equal(got, want)
    tiled = uint16.probe_boards(48, distinct=16).numpy().view(np.uint32)
    assert np.array_equal(tiled, np.concatenate([want] * 3, axis=-1))
    assert all((b > 0).sum() >= 24 for b in base)  # carving stops where uniqueness would break
    assert count_solutions(base[0], JSUDOKU_9, limit=2) == 1


def test_p16_entry_point_runs_on_cpu_when_asked():
    out = uint16.run_probe(batch=64, iters=2, reps=1, device="cpu")
    assert out["bit_equal_low16"] is True and out["device"] == "cpu"
    assert out["launches"] == {"uint32": 0, "uint16": 0}
    assert out["uint32_fixpoints_per_s"] > 0 and out["uint16_fixpoints_per_s"] > 0


def test_pcv_plain_matches_jax_probe():
    probe = _jax_probe("probe_cover_kernel")
    want = probe.run(interpret=True)
    inputs = cover_kernel.probe_inputs()
    before = cover_kernel.cover_probe_cuda.launches
    got = cover_kernel.cover_probe(*inputs)
    assert cover_kernel.cover_probe_cuda.launches == before
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert np.array_equal(g.numpy().view(w.dtype), w)
    assert cover_kernel.checksum(got[1]) == cover_kernel.PINNED_CHECKSUM == 653337268


@pytest.mark.parametrize("steps", [0, 1, 5])
def test_pcv_plain_matches_jax_probe_kernel_at_other_step_counts(steps):
    """The JAX probe's ``kernel`` body, interpreted, at other step counts."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    probe = _jax_probe("probe_cover_kernel")
    inc, packed, meta, stack = (x.numpy() for x in cover_kernel.probe_inputs())
    meta = (np.arange(8 * probe.T, dtype=np.int32).reshape(8, probe.T) % 5) - 2
    wlo, whi = probe._pack_consts()
    f = pl.pallas_call(
        functools.partial(probe.kernel, steps=steps),
        out_shape=(
            jax.ShapeDtypeStruct((probe.C, probe.T), jnp.int32),
            jax.ShapeDtypeStruct((probe.W, probe.T), jnp.uint32),
            jax.ShapeDtypeStruct((8, probe.T), jnp.int32),
            jax.ShapeDtypeStruct((probe.S, probe.W, probe.T), jnp.uint32),
        ),
        interpret=True,
    )
    want = f(jnp.asarray(inc), jnp.asarray(probe._unpack_consts()), jnp.asarray(wlo),
             jnp.asarray(whi), jnp.asarray(packed.view(np.uint32)), jnp.asarray(meta),
             jnp.asarray(stack.view(np.uint32)))
    got = cover_kernel.cover_probe_plain(torch.from_numpy(inc), torch.from_numpy(packed),
                                         torch.from_numpy(meta), torch.from_numpy(stack), steps)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.array_equal(g.numpy().view(w.dtype), w)


def test_pcv_entry_point_runs_on_cpu_when_asked():
    out = cover_kernel.run_probe("cpu")
    assert out == {"metric": "cover_kernel_probe", "bit_exact_vs_plain": True,
                   "packed_checksum": 653337268, "device": "cpu", "launches": 0}


def test_probe_wrappers_check_their_inputs():
    with pytest.raises(ValueError, match=r"\[9, 9, T\]"):
        uint16.fixpoint_probe(torch.zeros((9, 8, 4), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32 or torch.int16"):
        uint16.fixpoint_probe(torch.zeros((9, 9, 4), dtype=torch.int64))
    inc, packed, meta, stack = cover_kernel.probe_inputs()
    with pytest.raises(ValueError, match="R must be 32 W"):
        cover_kernel.cover_probe(inc[:200], packed, meta, stack)
    with pytest.raises(TypeError, match="float32"):
        cover_kernel.cover_probe(inc.double(), packed, meta, stack)


# -- card-only: each kernel against its plain version ---------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("boards", [4096, 4095, 1])
@pytest.mark.parametrize("max_sweeps", [64, 1, 2])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
def test_p16_kernel_matches_plain(cuda_device, dtype, max_sweeps, boards):
    rng = np.random.default_rng(boards)
    rand = rng.integers(0, 512, size=(9, 9, 257)).astype(np.int32)
    rand[rng.random(rand.shape) < 0.03] = 0
    x = torch.cat([uint16.probe_boards(boards), torch.from_numpy(rand)], -1)[..., :boards]
    x = x.contiguous().to(dtype).to(cuda_device)
    before = uint16.fixpoint_probe_cuda.launches
    got = uint16.fixpoint_probe(x, max_sweeps)
    assert uint16.fixpoint_probe_cuda.launches == before + 1
    assert torch.equal(got, uint16.fixpoint_probe_plain(x, max_sweeps))


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [3, 0, 1, 7])
def test_pcv_kernel_matches_plain(cuda_device, steps):
    inputs = [x.to(cuda_device) for x in cover_kernel.probe_inputs()]
    before = cover_kernel.cover_probe_cuda.launches
    got = cover_kernel.cover_probe(*inputs, steps)
    assert cover_kernel.cover_probe_cuda.launches == before + 1
    want = cover_kernel.cover_probe_plain(*inputs, steps)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if steps == 3:
        assert cover_kernel.checksum(got[1]) == cover_kernel.PINNED_CHECKSUM


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 5, 200, 3, 0.3), (3, 32, 130, 5, 0.05),
                                   (8, 28, 129, 8, 0.02)])
def test_pcv_kernel_matches_plain_at_other_shapes(cuda_device, shape):
    w, c, t, s, density = shape
    g = np.random.default_rng(w * 100 + c)
    inc = torch.from_numpy((g.random((32 * w, c)) < density).astype(np.float32))
    packed = torch.from_numpy(g.integers(0, 2**32, (w, t), dtype=np.uint32).view(np.int32))
    packed[:, :7] = 0  # lanes with no row available
    meta = torch.from_numpy(g.integers(-20, 20, (8, t)).astype(np.int32))
    stack = torch.from_numpy(g.integers(0, 2**32, (s, w, t), dtype=np.uint32).view(np.int32))
    inputs = [x.to(cuda_device) for x in (inc, packed, meta, stack)]
    got = cover_kernel.cover_probe(*inputs, 4)
    want = cover_kernel.cover_probe_plain(*inputs, 4)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
