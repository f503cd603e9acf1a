"""Port parity: the two Mosaic probes (P16, PCV) against the JAX probes, and their kernels.

* P16: the JAX probe's ``build(jax, jnp, dtype)`` fixpoint (Pallas interpret
  mode on the CPU, as ``_interpret_default()`` gives there) and the port's
  :func:`fixpoint_probe_plain` on the same numpy inputs: 256 carved 24-clue
  boards (seed 7) plus random masks with empty cells (contradictions), in
  tiles of 128, uint32 and uint16.  Tolerance: exact equality.
* PCV: ``benchmarks/probe_cover_kernel.run(interpret=True)`` against
  :func:`cover_probe_plain` on the same seed-0 inputs: all four outputs
  exactly equal, and the pinned checksum.
* P16's 16-bit lane algebra: the numpy model of the kernel's carry-free
  per-half identities (``uint16.swar_*``) against per-half arithmetic on
  every 16-bit value, with the other half at 0, 1, 0x8000 and 0xFFFF; and
  a numpy sweep built on the kernel's lane algebra (its naked step ``c &
  (one(c) | ~seen)`` at 32 bits, ``c & ~(seen & multi(c))`` on two boards a
  word at 16) against the plain sweep.  Exact.
* ``chip_smoke.window_ms`` and ``device_ms`` (how the smoke reads a
  profiled window): only windows with exactly the expected number of
  kernel events count, three at most, else the reading fails.
* Card tests (``-m cuda``): each kernel against its plain version, exact:
  P16 at the queue's edges (one board, the tiles' ragged ends, one tile a
  block and more, odd T at 16 bits, a solved board, full-width random
  masks, caps 64 / 1 / 2), PCV after an L2 flush too.

The JAX probes are imported inside the tests that use them: the card
machine runs the ``cuda`` tests without JAX.
"""

import functools
import importlib
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu_torch.probes import cover_kernel, uint16

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


# -- P16's 16-bit lane algebra (the kernel's Lanes<16>), as a numpy model --------


def _popcount16(h: np.ndarray) -> np.ndarray:
    return np.unpackbits(h.astype(">u2").view(np.uint8).reshape(-1, 2), axis=1).sum(1)


@pytest.mark.parametrize("other", [0, 1, 0x8000, 0xFFFF])
@pytest.mark.parametrize("half", [0, 1])
def test_swar16_identities_on_every_16_bit_value(half, other):
    """Every 16-bit value in one half, ``other`` in the other: each
    identity per half equals per-half arithmetic, and leaves the other
    half as the same identity of ``other`` (nothing crosses the halves)."""
    h = np.arange(1 << 16, dtype=np.uint32)
    x = (h << 16 | np.uint32(other)) if half else (np.uint32(other) << 16 | h)

    def halves(y):
        y = np.asarray(y, dtype=np.uint32)
        return ((y >> 16) if half else (y & 0xFFFF)), ((y & 0xFFFF) if half else (y >> 16))

    pop = _popcount16(h)
    o = np.array([other], dtype=np.uint32)
    opop = int(_popcount16(o)[0])
    full = np.uint32(0xFFFF)
    want = {
        "dec": ((h - 1) & 0xFFFF, (other - 1) & 0xFFFF),
        "nonzero": (np.where(h != 0, full, 0), 0xFFFF if other else 0),
        "multi": (np.where(pop >= 2, full, 0), 0xFFFF if opop >= 2 else 0),
        "single": (np.where(pop == 1, h, 0), other if opop == 1 else 0),
    }
    got = {"dec": uint16.swar_dec(x), "nonzero": uint16.swar_nonzero(x),
           "multi": uint16.swar_multi(x), "single": uint16.swar_single(x)}
    for name, y in got.items():
        mine, theirs = halves(y)
        assert np.array_equal(mine, want[name][0]), name
        assert np.all(theirs == want[name][1]), name
    flags = uint16.swar_nonzero_flags(x)
    assert not np.any(flags & ~np.uint32(0x80008000))


def _one32(x):
    pop = np.vectorize(lambda v: bin(int(v)).count("1"))(x)
    return np.where(pop == 1, np.uint32(0xFFFFFFFF), np.uint32(0))


def _nonzero32(x):
    return np.where(x != 0, np.uint32(0xFFFFFFFF), np.uint32(0))


# The kernel's lane algebra per width (csrc/probe_uint16.cu ``Lanes``):
# (decided, naked, nonzero).
_LANES = {
    32: (lambda c: c & _one32(c), lambda c, seen: c & (_one32(c) | ~seen), _nonzero32),
    16: (uint16.swar_single, lambda c, seen: c & ~(seen & uint16.swar_multi(c)),
         uint16.swar_nonzero),
}


def _sweep_model(c: np.ndarray, bits: int) -> np.ndarray:
    """The kernel's sweep on uint32 words ``[9, 9, P]`` (csrc/probe_uint16.cu
    ``sweep``), with its lane algebra for ``bits``."""
    decided, naked, nonzero = _LANES[bits]
    d = decided(c)
    boxes = lambda x: x.reshape(3, 3, 3, 3, -1).transpose(0, 2, 1, 3, 4).reshape(9, 9, -1)
    unbox = boxes  # the box permutation is its own inverse
    seen = (np.bitwise_or.reduce(d, axis=1)[:, None] | np.bitwise_or.reduce(d, axis=0)[None]
            | unbox(np.repeat(np.bitwise_or.reduce(boxes(d), axis=1)[:, None], 9, axis=1)))
    c = naked(c, seen)

    def exactly_once(x, axis):  # values seen once along axis
        once = np.zeros_like(np.take(x, 0, axis=axis))
        twice = np.zeros_like(once)
        for k in range(9):
            v = np.take(x, k, axis=axis)
            twice |= once & v
            once |= v
        return once & ~twice

    hidden = (exactly_once(c, 1)[:, None] | exactly_once(c, 0)[None]
              | unbox(np.repeat(exactly_once(boxes(c), 1)[:, None], 9, axis=1)))
    forced = c & hidden
    take = nonzero(forced)
    return (forced & take) | (c & ~take)


def _model_inputs(bits: int, seed: int = 11) -> np.ndarray:
    """64 probe boards, 64 random 9-bit masks with empty cells, 64 random
    full-width masks; boards-last uint ``[9, 9, 192]``."""
    rng = np.random.default_rng(seed)
    boards = _p16_boards()[..., :64].astype(np.uint64)
    nine = rng.integers(0, 512, size=(9, 9, 64)).astype(np.uint64)
    nine[rng.random(nine.shape) < 0.05] = 0
    wide = rng.integers(0, 1 << bits, size=(9, 9, 64), dtype=np.uint64)
    return np.concatenate([boards, nine, wide], axis=-1)


@pytest.mark.parametrize("bits", [32, 16])
def test_kernel_sweep_model_matches_plain_sweeps(bits):
    """Three sweeps of the kernel's algebra (at 16 bits two boards a word,
    board 2j in the low half) against three plain sweeps, board by board."""
    cand = _model_inputs(bits)
    signed = np.int32 if bits == 32 else np.int16
    unsigned = np.uint32 if bits == 32 else np.uint16
    want = torch.from_numpy(cand.astype(unsigned).view(signed)).permute(2, 0, 1)
    for _ in range(3):
        want = uint16._sweep_plain(want, bits)
    want = want.permute(1, 2, 0).numpy().view(unsigned)
    if bits == 32:
        got = cand.astype(np.uint32)
        for _ in range(3):
            got = _sweep_model(got, 32)
    else:
        words = (cand[..., 0::2] | cand[..., 1::2] << 16).astype(np.uint32)
        for _ in range(3):
            words = _sweep_model(words, 16)
        got = np.empty(cand.shape, dtype=np.uint32)
        got[..., 0::2], got[..., 1::2] = words & 0xFFFF, words >> 16
    assert np.array_equal(got.astype(unsigned), want)
    assert not np.array_equal(want, cand.astype(unsigned))


def test_profiler_window_counts_only_exact_windows():
    """``chip_smoke.window_ms``: the device time of the matching kernel
    events over their count (dividing by the launches read low when a
    window dropped events), and no reading from a window with another
    count than asked; runtime calls, which have no device time, never
    count."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    ev = lambda key, count, us: SimpleNamespace(key=key, count=count, self_device_time_total=us)
    window = [ev("void probe_fixpoint_kernel<32>(...)", 5, 500.0),
              ev("cudaLaunchKernel", 5, 0.0), ev("void other_kernel()", 3, 90.0)]
    assert chip_smoke.window_ms(window, "probe_fixpoint_kernel", 5) == (0.1, 5)
    assert chip_smoke.window_ms(window[:1] + [ev("probe_fixpoint_kernel", 0, 0.0)],
                                "probe_fixpoint_kernel", 5) == (0.1, 5)
    dropped = [ev("void probe_fixpoint_kernel<32>(...)", 3, 300.0)]
    assert chip_smoke.window_ms(dropped, "probe_fixpoint_kernel", 5) == (None, 3)
    assert chip_smoke.window_ms(dropped, "probe_fixpoint_kernel", 3) == (0.1, 3)
    assert chip_smoke.window_ms(window, "other_kernel", 3) == (0.03, 3)
    assert chip_smoke.window_ms(window, "Launch", 5) == (None, 0)


def test_profiler_window_reads_a_call_of_several_kernels():
    """``chip_smoke.window_ms`` with a tuple of names (the bookkeeping's
    three kernels): the device time of all of them per call, read only
    where each name has exactly the calls asked for."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    ev = lambda key, count, us: SimpleNamespace(key=key, count=count, self_device_time_total=us)
    names = chip_smoke.BOOKKEEP_KERNELS
    window = [ev(f"(anonymous namespace)::{n}(Args)", 5, 50.0 * (i + 1))
              for i, n in enumerate(names)] + [ev("cudaLaunchKernel", 15, 0.0)]
    assert chip_smoke.window_ms(window, names, 5) == (pytest.approx(0.06), 15)
    short = window[:1] + [ev(names[1], 4, 40.0), ev(names[2], 6, 150.0)]
    assert chip_smoke.window_ms(short, names, 5) == (None, 15)
    assert chip_smoke.window_ms(window[:2], names, 5) == (None, 10)


@pytest.mark.parametrize("windows, want", [
    ([3, 5], 0.1),      # a short window, then an exact one
    ([4, 6, 5], 0.1),   # short, long, exact
    ([3, 4, 3], None),  # three short windows: the reading fails
])
def test_device_ms_counts_only_exact_windows(monkeypatch, windows, want):
    """``chip_smoke.device_ms`` reads the first window with exactly
    ``reps`` kernel events, each opened by the primer launches, and fails
    after three windows without one (no reading from a short window)."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    import torch.profiler

    counts = iter(windows)
    calls = []
    zeros = torch.zeros

    class Window:
        def __enter__(self):
            self.n = next(counts)
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [SimpleNamespace(key="void probe_fixpoint_kernel<32>(...)", count=self.n,
                                    self_device_time_total=100.0 * self.n)]

    class Primer:
        def add_(self, v):
            calls.append("primer")

    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: Window())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch, "zeros", lambda *a, **kw: Primer() if kw.get("device") == "cuda"
                        else zeros(*a, **kw))
    fn = lambda a: calls.append("call")  # noqa: E731
    if want is None:
        with pytest.raises(AssertionError, match=r"recorded \[3, 4, 3\] events"):
            chip_smoke.device_ms(fn, 5, lambda: None, "probe_fixpoint_kernel")
        return
    assert chip_smoke.device_ms(fn, 5, lambda: None, "probe_fixpoint_kernel") == pytest.approx(want)
    windows_run = len(windows)
    assert calls.count("primer") == chip_smoke.PRIMERS * windows_run
    assert calls.count("call") == 1 + 5 * windows_run  # the warm-up, then reps a window


def test_queue_model_and_warp_divergence():
    """The smoke's divergence readings on hand-made sweep counts: equal
    counts diverge by 1; one long board in a warp of short ones costs the
    warp its length; the queue spreads boards over a block's slots."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    flat = torch.full((128,), 4, dtype=torch.int32)
    assert chip_smoke.warp_divergence(flat, 32) == 1.0
    one_long = flat.clone()
    one_long[0] = 36
    assert chip_smoke.warp_divergence(one_long, 32) == pytest.approx(((36 + 3 * 4) / 4) / (544 / 128))
    # 256 boards of 4 sweeps on 128 lanes: two boards a lane, 8 sweeps a warp.
    assert chip_smoke.queue_model(np.full(256, 4), 256, 128, 1) == {
        "max_warp_sweeps": 8, "divergence": 1.0}
    # Two slots a lane: the same boards take one round of 4 sweeps.
    assert chip_smoke.queue_model(np.full(256, 4), 256, 128, 2)["max_warp_sweeps"] == 4
    # A 20-sweep board in the tile ends its warp last.
    s = np.full(256, 4)
    s[5] = 20
    assert chip_smoke.queue_model(s, 256, 128, 1)["max_warp_sweeps"] == 20


# -- card-only: each kernel against its plain version ---------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# The queue's edges.  The kernel's tile is about T / SMs boards, a multiple
# of 8, at most what shared memory holds (mirrored from csrc/probe_uint16.cu
# ``plan``; were they to drift apart, these would still be valid cases):
# T = 8 SMs +- 1 end the last tile ragged or one board into it; T = SMs *
# (the largest tile) + 1 gives one block a second tile; twice that less 1
# gives every block two, the last ragged.  Odd T at 16 bits stages element
# by element, every other T in 4-byte pieces.
P16_EDGES = ["one", "tiles_of_8_less_1", "tiles_of_8", "tiles_of_8_plus_1",
             "tiles_of_8_plus_2", "probe", "full_tiles_plus_1", "two_tiles_a_block_less_1"]


def _p16_edge_boards(case: str, dtype, dev) -> torch.Tensor:
    props = torch.cuda.get_device_properties(dev)
    sms = props.multi_processor_count
    optin = getattr(props, "shared_memory_per_block_optin", 232448)
    per_slot = 1 if dtype == torch.int32 else 2  # boards a 84-word slot of the tile
    largest = (optin - 1024) // (84 * 4 + 1) // 32 * 32 * per_slot
    t = {"one": 1, "tiles_of_8_less_1": 8 * sms - 1, "tiles_of_8": 8 * sms,
         "tiles_of_8_plus_1": 8 * sms + 1, "tiles_of_8_plus_2": 8 * sms + 2, "probe": 65536,
         "full_tiles_plus_1": sms * largest + 1,
         "two_tiles_a_block_less_1": 2 * sms * largest - 1}[case]
    bits = 32 if dtype == torch.int32 else 16
    rng = np.random.default_rng(t)
    x = _p16_boards()[..., np.arange(t) % 256].astype(np.uint64)
    nine = rng.integers(0, 512, size=(9, 9, t), dtype=np.uint64)
    nine[rng.random(nine.shape) < 0.03] = 0
    x[..., 3::7] = nine[..., 3::7]  # contradictions and boards that run long
    x[..., 5::11] = rng.integers(0, 1 << bits, size=(9, 9, t), dtype=np.uint64)[..., 5::11]
    grid = (np.arange(9)[:, None] * 3 + np.arange(9)[:, None] // 3 + np.arange(9)) % 9
    x[..., 0] = (1 << grid).astype(np.uint64)  # a solved board
    unsigned, signed = (np.uint32, np.int32) if bits == 32 else (np.uint16, np.int16)
    return torch.from_numpy(np.ascontiguousarray(x.astype(unsigned)).view(signed)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("boards", P16_EDGES)
@pytest.mark.parametrize("max_sweeps", [64, 1, 2])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
def test_p16_kernel_matches_plain(cuda_device, dtype, max_sweeps, boards):
    x = _p16_edge_boards(boards, dtype, cuda_device)
    before = uint16.fixpoint_probe_cuda.launches
    got = uint16.fixpoint_probe(x, max_sweeps)
    assert uint16.fixpoint_probe_cuda.launches == before + 1
    want = uint16.fixpoint_probe_plain(x, max_sweeps)
    assert torch.equal(got, want)
    assert torch.equal(got[..., 0], x[..., 0])  # the solved board stays


@pytest.mark.cuda
def test_p16_kernel_low16_equals_16_bit_kernel(cuda_device):
    """The probe's ``bit_equal_low16`` on the kernels: the 32-bit fixpoint's
    low 16 bits equal the 16-bit fixpoint, on the probe's boards."""
    x = uint16.probe_boards(4096).to(cuda_device)
    got32 = uint16.fixpoint_probe_cuda(x)
    got16 = uint16.fixpoint_probe_cuda(x.to(torch.int16))
    assert torch.equal(got32.to(torch.int16), got16)


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
@pytest.mark.parametrize("steps", [0, 1, 3, 7])
def test_pcv_kernel_matches_plain_after_l2_flush(cuda_device, steps):
    """The kernel with its inputs out of the L2 cache: 128 MB written over
    the 50 MB cache just before the launch, which goes through the C entry
    point (the wrapper's 0/1 check would read the incidence back into L2)."""
    from distributed_sudoku_solver_tpu_torch.ops import cuda_build

    inputs = [x.to(cuda_device) for x in cover_kernel.probe_inputs()]
    want = cover_kernel.cover_probe_plain(*inputs, steps)
    inc, packed, meta, stack = inputs
    got = (torch.empty((inc.shape[1], packed.shape[1]), dtype=torch.int32, device=cuda_device),
           torch.empty_like(packed), torch.empty_like(meta), torch.empty_like(stack))
    fn = cover_kernel._lib()
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=cuda_device)
    flush.bitwise_not_()
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    err = fn(*(x.data_ptr() for x in (*inputs, *got)), packed.shape[0], inc.shape[1],
             packed.shape[1], stack.shape[0], steps, stream)
    cuda_build.check(err, "dsst_probe_cover")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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
