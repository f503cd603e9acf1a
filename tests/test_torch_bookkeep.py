"""The Python side of the fused loop's bookkeeping kernel, on the CPU.

``ops/cuda_bookkeep.bookkeep_plain`` writes the plain chain's results
(``_kernel_outputs`` + ``_fused_bookkeeping`` + ``_fused_go``) into the
buffers the kernel writes and never loads the library; ``bookkeep_cuda``
refuses what the kernel does not take before any launch; the scratch's
layout is the one ``csrc/bookkeep.cu`` states; and the fused loop on the
CPU runs no kernel.  The kernel itself is held bit-equal to the plain chain on
a card (``tests/test_torch_bookkeep_cuda.py``).
"""

import math
import re
import types

import pytest
import torch

from distributed_sudoku_solver_tpu_torch.obs import trace
from distributed_sudoku_solver_tpu_torch.ops import cuda_bookkeep, cuda_build, cuda_step
from distributed_sudoku_solver_tpu_torch.ops.frontier import Frontier

LANES, JOBS, SLOTS = 8, 3, 4
BOARD = (4, 4)


@pytest.fixture(autouse=True)
def _no_library(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(cuda_build, "load", refuse)


def _inputs(seed=0, lanes=LANES, jobs=JOBS, board=BOARD, words=None, count_all=False):
    """A frontier and a round's outputs drawn from ``seed``; ``words`` of
    the tile clear, the whole board by default (K2)."""
    gen = torch.Generator().manual_seed(seed)

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int64).to(torch.int32)

    def flags(shape, p):
        return torch.rand(shape, generator=gen) < p

    solved = flags((jobs,), 0.3)
    state = Frontier(
        top=ints((lanes, *board), -2**31, 2**31), stack=ints((lanes, SLOTS, *board), -2**31, 2**31),
        has_top=flags((lanes,), 0.5), base=ints((lanes,), 0, SLOTS),
        count=ints((lanes,), 0, SLOTS + 1), job=ints((lanes,), -1, jobs), solved=solved,
        solution=ints((jobs, *board), -2**31, 2**31), overflowed=flags((jobs,), 0.2),
        nodes=ints((jobs,), 0, 100),
        sol_count=ints((jobs,), 0, 3) if count_all else solved.to(torch.int32),
        steps=ints((), 0, 20), sweeps=ints((), 0, 100), expansions=ints((), 0, 100),
        steals=ints((), 0, 100), lane_rounds=ints((lanes,), 0, 50))
    rows = [flags((lanes,), 0.6).to(torch.int32), ints((lanes,), 0, SLOTS + 1),
            flags((lanes,), 0.3).to(torch.int32), flags((lanes,), 0.2).to(torch.int32),
            ints((lanes,), 0, 9), ints((lanes,), 0, 3), ints((lanes,), 0, 9),
            ints((lanes,), 0, 50)]
    kout = cuda_bookkeep.KernelOut(ints((lanes, *board), -2**31, 2**31),
                                   ints((lanes, *board), -2**31, 2**31), torch.stack(rows),
                                   min(128, lanes), math.prod(board) if words is None else words)
    limit = state.steps.to(torch.int64) + 10
    return state, kout, limit, torch.ones((), dtype=torch.bool)  # the flag at entry: a live loop


def _gate(state: Frontier) -> torch.Tensor:
    """The gated ``has_top`` as the fused loop's load leaves it."""
    return state.has_top.to(torch.int32)


def _config(count_all=False, steal=True, gang=0):
    return types.SimpleNamespace(count_all=count_all, steal=steal, steal_gang=gang)


@pytest.mark.parametrize("count_all", [False, True])
@pytest.mark.parametrize("steal,gang", [(False, 0), (True, 0), (True, 4)])
@pytest.mark.parametrize("family", ["k2", "k3"])
def test_cpu_tensors_take_the_plain_chain(family, steal, gang, count_all):
    """On CPU tensors ``bookkeep_plain`` writes what the eager loop's chain
    returns: every field into ``state`` but the top, which goes to the
    kernel's top, the flag into ``go`` and ``has_top & go`` into the
    gate."""
    board, words = (BOARD, None) if family == "k2" else ((1, 12), 7)
    config = _config(count_all, steal, gang)
    state, kout, limit, go = _inputs(3, board=board, words=words, count_all=count_all)
    out = cuda_bookkeep._kernel_outputs(kout.top, state.stack, state.base, kout.sol,
                                        kout.lane_out, kout.tile, kout.words)
    want = cuda_bookkeep._fused_bookkeeping(Frontier(*(t.clone() for t in state)), out, config)
    want_go = cuda_bookkeep._fused_go(want, limit)
    gate = _gate(state)
    cuda_bookkeep.bookkeep_plain(state, kout, limit, go, None, config, gate)
    for name, a, b in zip(want._fields, state._replace(top=kout.top), want):
        assert torch.equal(a, b), name
    assert bool(go) == bool(want_go)
    assert torch.equal(gate, (want.has_top & want_go).to(torch.int32))


FAULTS = {
    "lane_out shape": (ValueError, lambda s, k, w: (s, k._replace(lane_out=k.lane_out[:7]), w)),
    "solution shape": (ValueError, lambda s, k, w: (
        s._replace(solution=torch.zeros((JOBS + 1, *BOARD), dtype=torch.int32)), k, w)),
    "stack board": (ValueError, lambda s, k, w: (
        s._replace(stack=s.stack.reshape(LANES, SLOTS, 2, 8)), k, w)),
    "kernel top shape": (ValueError, lambda s, k, w: (s, k._replace(top=k.top[:, :3]), w)),
    "short scratch": (ValueError, lambda s, k, w: (s, k, w[:-1])),
    "job dtype": (TypeError, lambda s, k, w: (s._replace(job=s.job.long()), k, w)),
    "has_top dtype": (TypeError, lambda s, k, w: (s._replace(has_top=s.has_top.int()), k, w)),
    "steps dtype": (TypeError, lambda s, k, w: (s._replace(steps=s.steps.long()), k, w)),
    "non-contiguous top": (ValueError, lambda s, k, w: (
        s, k._replace(top=k.top.transpose(1, 2)), w)),
    "tile": (ValueError, lambda s, k, w: (s, k._replace(tile=3), w)),
    "clear words": (ValueError, lambda s, k, w: (s, k._replace(words=17), w)),
    "no jobs": (ValueError, lambda s, k, w: (s._replace(
        solved=s.solved[:0], solution=s.solution[:0], overflowed=s.overflowed[:0],
        nodes=s.nodes[:0], sol_count=s.sol_count[:0]), k, w)),
    "cpu tensors": (ValueError, lambda s, k, w: (s, k, w)),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_wrapper_refuses_what_the_kernel_does_not_take(fault):
    """Each fault raises before the library is loaded (the fixture makes a
    load fail the test)."""
    error, make = FAULTS[fault]
    state, kout, limit, go = _inputs()
    state, kout, work = make(state, kout, cuda_bookkeep.new_work(LANES, JOBS, "cpu"))
    with pytest.raises(error):
        cuda_bookkeep.bookkeep_cuda(state, kout, limit, go, work, _config(), _gate(state))
    assert cuda_bookkeep.bookkeep_cuda.launches == 0


GATE_FAULTS = {
    "gate shape": (ValueError, lambda g: g[:-1]),
    "gate dtype": (TypeError, lambda g: g.bool()),
    "non-contiguous gate": (ValueError, lambda g: g.repeat(2)[::2]),
}


@pytest.mark.parametrize("fault", list(GATE_FAULTS))
def test_wrapper_refuses_a_bad_gate(fault):
    """The gate is an int32 ``[L]`` buffer of the frontier's device, or
    the call raises before the library is loaded."""
    error, make = GATE_FAULTS[fault]
    state, kout, limit, go = _inputs()
    with pytest.raises(error, match="gate"):
        cuda_bookkeep.bookkeep_cuda(state, kout, limit, go,
                                    cuda_bookkeep.new_work(LANES, JOBS, "cpu"), _config(),
                                    make(_gate(state)))
    assert cuda_bookkeep.bookkeep_cuda.launches == 0


@pytest.mark.parametrize("what", ["limit dtype", "gang"])
def test_wrapper_refuses_a_bad_limit_or_gang(what):
    state, kout, limit, go = _inputs()
    config = _config(gang=3 if what == "gang" else 0)
    if what == "limit dtype":
        limit = limit.int()
    with pytest.raises(TypeError if what == "limit dtype" else ValueError):
        cuda_bookkeep.bookkeep_cuda(state, kout, limit, go, cuda_bookkeep.new_work(
            LANES, JOBS, "cpu"), config, _gate(state))


def test_a_gang_that_does_not_divide_is_taken_without_steals():
    """``steal_gang`` is read only when stealing is on, as in the plain
    chain; the refusal of the CPU tensors comes after every check."""
    state, kout, limit, go = _inputs()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cuda_bookkeep.bookkeep_cuda(state, kout, limit, go,
                                    cuda_bookkeep.new_work(LANES, JOBS, "cpu"),
                                    _config(steal=False, gang=3), _gate(state))


def _source() -> str:
    return (cuda_build.CSRC_DIR / "bookkeep.cu").read_text()


def test_scratch_layout_is_the_kernels():
    """BLOCK, the scalars and NO_LANE as ``csrc/bookkeep.cu`` states them,
    and the words the layout adds up to, in the order ``work_of`` lays it."""
    src = _source()
    assert int(re.search(r"constexpr int BLOCK = (\d+);", src).group(1)) == cuda_bookkeep.BLOCK
    scalars = re.search(r"enum \{([^}]*)\};", src).group(1).replace(" ", "").split(",")
    assert scalars[-1] == "N_SCALARS" and len(scalars) - 1 == cuda_bookkeep.N_SCALARS
    assert "constexpr int NO_LANE = INT_MAX;" in src and cuda_bookkeep.NO_LANE == 2**31 - 1
    assert re.search(
        r"return 4LL \* jobs \+ N_SCALARS \+ 4 \* nb \+ 2 \+ 2 \* nb \* WARPS \+ 1;", src)
    for lanes, jobs in ((1, 1), (96, 24), (256, 1), (257, 257), (32768, 32768)):
        nb = -(-lanes // 256)
        assert cuda_bookkeep.work_words(lanes, jobs) == 4 * jobs + 5 + 4 * nb + 2 + 16 * nb + 1


def test_new_scratch_is_the_kernels_idle_state():
    work = cuda_bookkeep.new_work(96, 24, "cpu")
    assert work.dtype == torch.int32 and work.shape == (cuda_bookkeep.work_words(96, 24),)
    assert bool((work[:24] == cuda_bookkeep.NO_LANE).all()) and not bool(work[24:].any())


def test_launch_arguments_match_the_c_signature():
    """The ctypes argument list matches ``dsst_bookkeep``'s parameters:
    22 pointers, the scratch's length, nine ints and the stream."""
    sig = re.search(r'extern "C" int dsst_bookkeep\(([^)]*)\)', _source()).group(1)
    kinds = [p.strip().rsplit(" ", 1)[0] for p in sig.split(",")]
    assert kinds == ["void*"] * 4 + ["void*"] * 10 + ["const void*", "void*", "const void*",
                                                      "const void*", "const void*", "void*",
                                                      "void*", "void*", "long long"] + [
                                                          "int"] * 9 + ["void*"]


@pytest.mark.parametrize("lanes,tile,refused", [
    (384, 96, True),    # three 96-lane tiles across the first block's end
    (96, 96, False),    # one block holds every lane
    (384, 128, False),  # the tile divides the block
    (512, 1, False),
])
def test_a_tile_must_not_cross_a_block(lanes, tile, refused):
    """The harvest takes each tile's most live rounds in one block's shared
    memory, so a tile that does not divide a block is refused where there
    is more than one block, by the wrapper and by ``dsst_bookkeep``; the
    rest pass every check up to the CPU tensors' refusal."""
    state, kout, limit, go = _inputs(lanes=lanes)
    work = cuda_bookkeep.new_work(lanes, JOBS, "cpu")
    match = "does not divide a block" if refused else "needs CUDA tensors"
    with pytest.raises(ValueError, match=match):
        cuda_bookkeep.bookkeep_cuda(state, kout._replace(tile=tile), limit, go, work, _config(),
                                    _gate(state))
    assert "(lanes > BLOCK && BLOCK % tile != 0)" in _source()


def test_the_eager_loop_counts_no_kernel_round():
    """The fused loop on the CPU runs ``bookkeep_plain``, uncaptured: no
    graph round, and no run of the bookkeeping kernel."""
    from distributed_sudoku_solver_tpu_torch.models.nqueens import nqueens_cover
    from distributed_sudoku_solver_tpu_torch.ops import cuda_cover
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig, init_frontier

    problem = nqueens_cover(5)
    cfg = SolverConfig(lanes=8, min_lanes=8, stack_slots=16, step_impl="fused", fused_steps=2,
                       count_all=True)
    state = init_frontier(torch.from_numpy(problem.initial_state()[None]), cfg)
    before = cuda_bookkeep.bookkeep_cuda.launches
    with trace.recording(keep=True) as rec:
        out = cuda_cover.advance_cover_fused(state, cfg.max_steps, problem, cfg)
    assert int(out.sol_count.sum()) == 10  # the 5-queens solutions
    counts = cuda_step.loop_counts(rec.counts, "k3_dispatches")
    assert counts["k3_dispatches"] > 0 and counts["graph_rounds"] == 0
    assert cuda_bookkeep.bookkeep_cuda.launches == before
