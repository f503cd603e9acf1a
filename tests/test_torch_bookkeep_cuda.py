"""The fused loop's bookkeeping kernel (``csrc/bookkeep.cu``) held bit-equal
to its plain version on the card.

Card-only (marked ``cuda``; a fixture skips them where no CUDA device is
visible), and free of JAX, so the chip machine runs them with
``--noconftest``.  Each case draws a frontier and a round kernel's outputs
on the card from its seed (K2 boards of 9x9 and 16x16, K3 states of 8 and 68
words), runs two dispatches of bookkeeping on each side, the kernel
(``ops/cuda_bookkeep.bookkeep_cuda``) and ``bookkeep_plain``
(``_kernel_outputs`` + ``_fused_bookkeeping`` + ``_fused_go``), and holds
every field of the next frontier, the kernel's top and the loop flag
equal, and the scratch's accumulators and scalars back at their initial
state.  Tolerance:
exact equality.  A whole 6x10 pentomino count through ``cover_fused_frontier``
runs with the kernel in the fused loop's graph.
"""

import types
import zlib

import pytest
import torch

from distributed_sudoku_solver_tpu_torch.models.pentomino import pentomino_cover
from distributed_sudoku_solver_tpu_torch.obs import trace
from distributed_sudoku_solver_tpu_torch.ops import cuda_bookkeep, cuda_cover, cuda_step
from distributed_sudoku_solver_tpu_torch.ops.frontier import Frontier, SolverConfig

# board shape, the tile clear's words (K2: the whole board)
FAMILIES = {"k2-9x9": ((9, 9), 81), "k2-16x16": ((16, 16), 256),
            "k3-8": ((1, 8), 5), "k3-68": ((1, 68), 44)}
STEALS = {"no-steal": (False, 0), "steal": (True, 0), "gang32": (True, 32)}
SCENARIOS = ("random", "all-dead", "no-donor")
SLOTS = 5
I32 = (-(2**31), 2**31)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _ints(gen, shape, lo, hi, dev, dtype=torch.int32):
    return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int64).to(dtype)


def _jobs(gen, lanes, jobs, dev):
    if jobs == lanes:
        job = torch.randperm(lanes, generator=gen, device=dev).to(torch.int32)
    else:
        job = _ints(gen, (lanes,), 0, jobs, dev)
    gone = torch.rand(lanes, generator=gen, device=dev) < 0.1
    return torch.where(gone, torch.full_like(job, -1), job)


def _frontier(gen, lanes, jobs, board, count_all, dev):
    rand = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    solved = rand(jobs) < 0.3
    sol_count = _ints(gen, (jobs,), 0, 3, dev) if count_all else solved.to(torch.int32)
    return Frontier(
        top=_ints(gen, (lanes, *board), *I32, dev),
        stack=_ints(gen, (lanes, SLOTS, *board), *I32, dev),
        has_top=rand(lanes) < 0.5,
        base=_ints(gen, (lanes,), 0, SLOTS, dev),
        count=_ints(gen, (lanes,), 0, SLOTS + 1, dev),
        job=_jobs(gen, lanes, jobs, dev),
        solved=solved,
        solution=_ints(gen, (jobs, *board), *I32, dev),
        overflowed=rand(jobs) < 0.1,
        nodes=_ints(gen, (jobs,), 0, 1000, dev),
        sol_count=sol_count,
        steps=_ints(gen, (), 0, 50, dev),
        sweeps=_ints(gen, (), 2**31 - 200, 2**31, dev),  # wraps, as int32 sums do
        expansions=_ints(gen, (), *I32, dev),
        steals=_ints(gen, (), 0, 1000, dev),
        lane_rounds=_ints(gen, (lanes,), 0, 100, dev),
    )


def _kernel_out(gen, lanes, board, words, scenario, dev):
    rand = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    has = (rand(lanes) < 0.6) & (scenario != "all-dead")
    count = _ints(gen, (lanes,), 0, SLOTS + 1, dev) * int(scenario != "no-donor")
    rows = [has.to(torch.int32), count, (rand(lanes) < 0.05).to(torch.int32),
            (rand(lanes) < 0.03).to(torch.int32), _ints(gen, (lanes,), 0, 9, dev),
            _ints(gen, (lanes,), 0, 3, dev), _ints(gen, (lanes,), 0, 9, dev),
            _ints(gen, (lanes,), 0, 100, dev)]
    return cuda_bookkeep.KernelOut(top=_ints(gen, (lanes, *board), *I32, dev),
                                   sol=_ints(gen, (lanes, *board), *I32, dev),
                                   lane_out=torch.stack(rows).contiguous(),
                                   tile=min(128, lanes), words=words)


def _clone(x):
    return type(x)(*(t.clone() if isinstance(t, torch.Tensor) else t for t in x))


@pytest.mark.cuda
@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("lanes", [96, 32768])
@pytest.mark.parametrize("jobs", ["1", "L", "L/4"])
@pytest.mark.parametrize("steal", list(STEALS))
@pytest.mark.parametrize("count_all", [False, True], ids=["first", "count_all"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_kernel_equals_the_plain_chain(cuda_device, family, count_all, steal, jobs, lanes,
                                       scenario):
    board, words = FAMILIES[family]
    n_jobs = {"1": 1, "L": lanes, "L/4": lanes // 4}[jobs]
    do_steal, gang = STEALS[steal]
    config = types.SimpleNamespace(count_all=count_all, steal=do_steal, steal_gang=gang)
    seed = zlib.crc32(repr((family, count_all, steal, jobs, lanes, scenario)).encode())
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    got = _frontier(gen, lanes, n_jobs, board, count_all, cuda_device)
    want = _clone(got)
    work = cuda_bookkeep.new_work(lanes, n_jobs, cuda_device)
    for dispatch in range(2):
        kout = _kernel_out(gen, lanes, board, words, scenario, cuda_device)
        kout_plain = _clone(kout)
        limit = got.steps.to(torch.int64) + _ints(gen, (), -3, 40, cuda_device, torch.int64)
        go, go_plain = (torch.zeros((), dtype=torch.bool, device=cuda_device) for _ in range(2))
        cuda_bookkeep.bookkeep_cuda(got, kout, limit, go, work, config)
        cuda_bookkeep.bookkeep_plain(want, kout_plain, limit, go_plain, None, config)
        torch.cuda.synchronize()
        for name, a, b in zip(got._fields, got._replace(top=kout.top),
                              want._replace(top=kout_plain.top)):
            assert torch.equal(a, b), (dispatch, name)
        assert bool(go) == bool(go_plain), dispatch
        held = 4 * n_jobs + cuda_bookkeep.N_SCALARS  # what carries from call to call
        assert torch.equal(work[:held], cuda_bookkeep.new_work(lanes, n_jobs, cuda_device)[:held])
        got, want = got._replace(top=kout.top), want._replace(top=kout_plain.top)
    if scenario == "all-dead":
        assert not bool(go)


@pytest.mark.cuda
def test_pentomino_6x10_counts_with_the_kernel_in_the_graph(cuda_device, monkeypatch):
    """Knuth's 6x10 box counted in full at the benchmark's width: 9,356
    tilings, every dispatch's bookkeeping a replay of the kernel, and each
    replay, not the capture, counted in ``bookkeep_cuda.launches``."""
    monkeypatch.setattr(cuda_step, "_GRAPHS", cuda_step._GraphCache(8))
    problem = pentomino_cover(6, 10)
    cfg = SolverConfig(lanes=32768, stack_slots=128, max_steps=1_000_000, count_all=True,
                       steal_rounds=4, step_impl="fused")
    root = torch.from_numpy(problem.initial_state()[None]).to(cuda_device)
    before = cuda_bookkeep.bookkeep_cuda.launches
    with trace.recording(keep=True) as rec:
        fs = cuda_cover.cover_fused_frontier(root, problem, cfg)
    counts = cuda_step.loop_counts(rec.counts, "k3_dispatches")
    assert int(fs.sol_count.sum()) == 9356
    assert not bool(fs.overflowed.any())
    runs = cuda_bookkeep.bookkeep_cuda.launches - before  # replays; the captures count none
    assert counts["k3_dispatches"] == counts["graph_rounds"] == runs > 0
