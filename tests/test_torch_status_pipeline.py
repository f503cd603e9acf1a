"""The serving contract of the port: one ``host_fetch`` per chunk, in-place
reuse that changes no value, and no host read of a chunk's step limit.

Twins of ``tests/test_status_pipeline.py``:

* the packed status word equals the JAX package's on the same frontier;
* in-place reuse is invisible: the advances update the frontier's stack
  in place (JAX donates it), the status word of chunk k is a fresh tensor
  that chunk k+1 does not write, and chunked advances are bit-identical to
  one long advance (and to JAX's chunked advance, composite);
* no host read of the step limit before a chunk's dispatch;
* the fetch-count guard: the serving loops read the device only through
  ``serving.engine.host_fetch``: exactly one ``status`` fetch per
  consumed chunk on static and resident flights, one per megastep
  flight, under each observability plane (untraced, traced, the compile
  watch with the critical-path monitor, the lock witness, the journal).
  The fused
  loop's own per-dispatch loop-condition reads (``_run_fused``) are not
  ``host_fetch`` calls: they are counted and pinned here too;
* padded-bucket job dimensions and the one-chunk reaction lag.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu.models.geometry import SUDOKU_9 as J9
from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JSolverConfig
from distributed_sudoku_solver_tpu.utils.checkpoint import (
    advance_frontier_status as jax_advance_status,
)
from distributed_sudoku_solver_tpu.utils.checkpoint import start_frontier as jax_start
import distributed_sudoku_solver_tpu_torch.serving.engine as engine_mod
from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
from distributed_sudoku_solver_tpu_torch.obs import lockdep, trace
from distributed_sudoku_solver_tpu_torch.ops import cuda_step
from distributed_sudoku_solver_tpu_torch.ops.cuda_step import advance_frontier_fused_status
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    Frontier,
    SolverConfig,
    frontier_from_numpy,
    unpack_status,
)
from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
from distributed_sudoku_solver_tpu_torch.serving.scheduler import ResidentConfig
from distributed_sudoku_solver_tpu_torch.utils.checkpoint import (
    advance_frontier_status,
    start_frontier,
)
from distributed_sudoku_solver_tpu_torch.utils.puzzles import EASY_9, HARD_9

SMALL = SolverConfig(min_lanes=8, stack_slots=16)
FUSED_SMALL = SolverConfig(min_lanes=8, stack_slots=16, step_impl="fused", fused_steps=2)
RC = ResidentConfig(job_slots=4, gang_lanes=4, queue_depth=32, attach_batch=4, chunk_steps=16)
GRIDS = np.stack([HARD_9[0], HARD_9[1], EASY_9]).astype(np.int32)


def wait_for(pred, timeout=30.0, every=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return False


def cpu_engine(**kw) -> SolverEngine:
    return SolverEngine(device="cpu", **kw)


def _clone(state):
    return type(state)(*(t.clone() for t in state))


def _advance(cfg):
    return advance_frontier_fused_status if cfg.step_impl == "fused" else advance_frontier_status


@pytest.fixture(autouse=True)
def port_lock_witness():
    with lockdep.installed(lockdep.manifest_witness(strict=True)) as w:
        yield w
    assert w.violations == [], w.violations


# -- the status word and in-place reuse ----------------------------------------


def test_chunked_status_and_state_equal_jax():
    """Four composite chunks from the same boards: every status word and
    the final frontier equal the JAX package's, field by field."""
    state = start_frontier(torch.from_numpy(GRIDS), SUDOKU_9, SMALL)
    jst = jax_start(jnp.asarray(GRIDS), J9, JSolverConfig(min_lanes=8, stack_slots=16))
    for _ in range(4):
        state, status = advance_frontier_status(state, 5, SUDOKU_9, SMALL)
        jst, jstatus = jax_advance_status(jst, jnp.int32(5), J9,
                                          JSolverConfig(min_lanes=8, stack_slots=16))
        np.testing.assert_array_equal(status.numpy().view(np.uint32),
                                      np.asarray(jstatus).view(np.uint32))
    want = frontier_from_numpy(jst)
    for name, a, b in zip(Frontier._fields, state, want, strict=True):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("cfg", [SMALL, FUSED_SMALL], ids=["xla", "fused"])
def test_four_chunks_bit_identical_to_one_long_advance(cfg):
    """The step limit is formed on the device, and chunking changes no
    value: 4 chunks of 6 rounds equal one advance of 24 on every field.
    (A fused dispatch runs ``fused_steps`` rounds and may overshoot its
    limit, as in JAX, so the chunk is a multiple of ``fused_steps``.)"""
    advance = _advance(cfg)
    base = start_frontier(torch.from_numpy(GRIDS), SUDOKU_9, cfg)
    long_state, _ = advance(_clone(base), 24, SUDOKU_9, cfg)
    state = _clone(base)
    for _ in range(4):
        state, _ = advance(state, 6, SUDOKU_9, cfg)
    for name, a, b in zip(Frontier._fields, state, long_state, strict=True):
        assert torch.equal(a, b), name
    assert int(state.steps) == 24  # the chunks really advanced, and live


@pytest.mark.parametrize("cfg", [SMALL, FUSED_SMALL], ids=["xla", "fused"])
def test_in_place_reuse_is_invisible(cfg):
    """The advance updates the stack in place (JAX donates it): a run on a
    clone gives the same values, chunk k's status word is a fresh tensor
    that chunk k+1's dispatch does not write, and the new state shares the
    old state's stack storage."""
    advance = _advance(cfg)
    state = start_frontier(torch.from_numpy(GRIDS), SUDOKU_9, cfg)
    state, status_k = advance(state, 3, SUDOKU_9, cfg)
    ref_state, ref_status = advance(_clone(state), 3, SUDOKU_9, cfg)
    kept = status_k.clone()
    new, status_k1 = advance(state, 3, SUDOKU_9, cfg)
    assert torch.equal(status_k, kept), "chunk k+1 wrote chunk k's status word"
    assert status_k.data_ptr() != status_k1.data_ptr()
    assert new.stack.data_ptr() == state.stack.data_ptr()  # reused in place
    assert torch.equal(status_k1, ref_status)
    for name, a, b in zip(Frontier._fields, new, ref_state, strict=True):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("cfg", [SMALL, FUSED_SMALL], ids=["xla", "fused"])
def test_no_host_read_of_the_step_limit(cfg, monkeypatch):
    """Neither status advance reads ``state.steps`` on the host before
    dispatching (``int()`` / ``.item()`` of a tensor raise here); the loop
    condition's per-round ``bool()`` is the only read."""
    advance = _advance(cfg)
    state = start_frontier(torch.from_numpy(GRIDS), SUDOKU_9, cfg)

    def refuse(self, *a, **k):
        raise AssertionError("host read of a tensor as an int")

    monkeypatch.setattr(torch.Tensor, "__int__", refuse)
    monkeypatch.setattr(torch.Tensor, "__index__", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    new, status = advance(state, torch.tensor(4, dtype=torch.int32), SUDOKU_9, cfg)
    monkeypatch.undo()
    assert int(new.steps) >= 4 and unpack_status(status, 3)["steps"] == int(new.steps)


def test_fused_loop_condition_reads_counted():
    """``_run_fused`` reads its loop condition on the host once per K2
    dispatch plus once to stop: counted, not hidden (the device-side loop
    that removes them is ROADMAP A8).  Dispatches are counted at
    ``cuda_step.fused_rounds``, the benchmark's hook, and reads as the
    loop's ``fused.sync`` spans."""
    dispatches = []
    rounds = cuda_step.fused_rounds

    def counting_rounds(*a, **k):
        dispatches.append(1)
        return rounds(*a, **k)

    cuda_step.fused_rounds = counting_rounds
    try:
        state = start_frontier(torch.from_numpy(GRIDS), SUDOKU_9, FUSED_SMALL)
        with trace.recording(keep=True) as rec:
            advance_frontier_fused_status(state, 8, SUDOKU_9, FUSED_SMALL)
    finally:
        cuda_step.fused_rounds = rounds
    # chunk_status reads no condition.
    assert len(dispatches) == rec.counts["fused.dispatch"] == 4  # 8 rounds at fused_steps=2
    assert rec.counts["fused.sync"] == len(dispatches) + 1


# -- the fetch-count guard ------------------------------------------------------


@pytest.fixture
def counted_fetches(monkeypatch):
    calls: list = []
    orig = engine_mod.host_fetch

    def counting(x, floor_s=0.0, tag="status"):
        calls.append(tag)
        return orig(x, floor_s=floor_s, tag=tag)

    monkeypatch.setattr(engine_mod, "host_fetch", counting)
    return calls


@pytest.fixture(params=["untraced", "traced", "watched", "lockdep", "journaled"])
def tracing(request, tmp_path):
    """The fetch-count guards under each plane.  ``watched`` installs the
    compile watch and the critical-path monitor beside the recorder: the
    cost seams price each flight from its shape on the host, so the counts
    must be identical (zero added syncs), and the seams must have run."""
    if request.param == "untraced":
        yield None
        return
    if request.param == "journaled":
        from distributed_sudoku_solver_tpu_torch.serving import journal as journal_wal

        with journal_wal.installed(journal_wal.Journal(str(tmp_path))) as jr:
            yield None
        assert jr.metrics()["accepted"] > 0
        assert jr.durable
        return
    if request.param == "lockdep":
        with lockdep.installed(lockdep.manifest_witness(strict=True)) as w:
            yield None
        assert w.violations == [], w.violations
        assert w.acquisitions > 0
        return
    rec = trace.TraceRecorder(ring=8192)
    if request.param == "watched":
        from distributed_sudoku_solver_tpu_torch.obs import compilewatch, critpath

        watch = compilewatch.CompileWatch(warmup_s=3600.0, peak_gflops=1000.0)
        with trace.installed(rec), compilewatch.installed(watch), \
                critpath.installed(critpath.CritPathMonitor()):
            yield rec
        assert watch.cost_metrics()["programs"], "no flight priced its advance"
        return
    with trace.installed(rec):
        yield rec


@pytest.mark.parametrize("cfg", [SMALL, FUSED_SMALL], ids=["xla", "fused"])
def test_static_loop_exactly_one_sync_per_chunk(counted_fetches, tracing, cfg):
    eng = cpu_engine(config=cfg, max_batch=8, chunk_steps=2).start()
    try:
        j = eng.submit(HARD_9[1])
        assert j.wait(120) and j.solved, j.error
        assert wait_for(lambda: not eng._flights, timeout=20)
    finally:
        eng.stop(timeout=2)
    statuses = counted_fetches.count("status")
    assert statuses == eng.chunk_wall.snapshot()["count"]
    assert statuses >= 3, "workload too easy to exercise the chunk loop"
    assert counted_fetches.count("finalize") == 1
    assert len(counted_fetches) == statuses + 1, counted_fetches
    if tracing is not None:
        names = [s["name"] for s in tracing.spans()]
        assert names.count("chunk.sync") == statuses
        assert "resolve" in names


@pytest.mark.parametrize("cfg", [SMALL, FUSED_SMALL], ids=["xla", "fused"])
def test_resident_loop_exactly_one_sync_per_chunk(counted_fetches, tracing, cfg):
    eng = cpu_engine(config=cfg, max_batch=8, resident=RC).start()
    try:
        j = eng.submit(HARD_9[1])
        assert j.wait(120) and j.solved, j.error
        rf = eng._resident[SUDOKU_9]
        assert wait_for(lambda: all(s is None for s in rf.slots), timeout=20)
        chunks = rf.chunks
    finally:
        eng.stop(timeout=2)
    statuses = counted_fetches.count("status")
    assert statuses == chunks >= 1
    assert counted_fetches.count("event") == 1
    assert counted_fetches.count("finalize") == 0
    assert len(counted_fetches) == statuses + 1, counted_fetches
    if tracing is not None:
        names = [s["name"] for s in tracing.spans()]
        assert names.count("resident.sync") == statuses
        assert names.count("verdict.sync") == 1
        adm = [s for s in tracing.spans() if s["name"] == "admission"]
        assert adm and adm[0]["attrs"]["route"] == "resident"


def _megastep_engine(cfg=SMALL):
    from distributed_sudoku_solver_tpu_torch.serving.megastep import MegastepConfig

    return cpu_engine(config=cfg, max_batch=8, latency_mode=True,
                      megastep=MegastepConfig(gang_lanes=8, chunk_steps=2, max_chunks=64)).start()


@pytest.mark.parametrize("cfg", [SMALL, FUSED_SMALL], ids=["xla", "fused"])
def test_megastep_exactly_one_status_sync_per_flight(counted_fetches, tracing, cfg):
    eng = _megastep_engine(cfg)
    try:
        j = eng.submit(HARD_9[1])
        assert j.wait(120) and j.solved, j.error
        mf = eng._megasteps[SUDOKU_9]
        flights, chunks = mf.flights, mf.chunks_total
    finally:
        eng.stop(timeout=2)
    assert flights == 1
    assert chunks >= 3, "workload too easy to exercise the chunk loop"
    assert counted_fetches == ["status"], counted_fetches
    if tracing is not None:
        names = [s["name"] for s in tracing.spans()]
        assert names.count("megastep.sync") == 1
        assert names.count("megastep.chunk.dispatch") == 1
        adm = [s for s in tracing.spans() if s["name"] == "admission"]
        assert adm and adm[0]["attrs"]["route"] == "megastep"


def test_megastep_early_exit_no_stale_verdict(counted_fetches):
    from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution

    boards = [HARD_9[1], HARD_9[0], EASY_9]
    eng = _megastep_engine()
    try:
        sols = []
        for b in boards:
            j = eng.submit(b)
            assert j.wait(120) and j.solved, j.error
            sols.append(np.asarray(j.solution))
        mf = eng._megasteps[SUDOKU_9]
        assert mf.flights == len(boards)
        assert mf.chunks_total < len(boards) * mf.cfg.max_chunks / 2
    finally:
        eng.stop(timeout=2)
    assert counted_fetches == ["status"] * len(boards), counted_fetches
    for b, sol in zip(boards, sols):
        assert is_valid_solution(sol)
        clues = np.asarray(b, np.int32)
        np.testing.assert_array_equal(sol[clues > 0], clues[clues > 0])
    assert not np.array_equal(sols[0], sols[1]), "stale verdict leaked"


# -- padded-bucket job dimension ------------------------------------------------


def _drive_flight(eng, fl, max_passes=400):
    for _ in range(max_passes):
        if eng._advance_flight(fl):
            return
    raise AssertionError("flight did not finish")


def _take_all(eng):
    batch = []
    while True:
        got = eng._take_batch(wait=False)
        if not got:
            return batch
        batch.extend(got)


def test_non_pow2_flight_cancel_purges_against_padded_bucket():
    eng = cpu_engine(config=SMALL, max_batch=8, chunk_steps=4)
    jobs = [eng.submit(HARD_9[i % 3]) for i in range(5)]
    batch = _take_all(eng)
    assert len(batch) == 5
    eng._launch_flights(SUDOKU_9, SMALL, batch)
    assert len(eng._flights) == 1
    fl = eng._flights[0]
    assert fl.state.solved.shape[0] == 8
    eng._advance_flight(fl)
    eng.cancel(jobs[3].uuid)
    _drive_flight(eng, fl)
    assert jobs[3].cancelled and not jobs[3].solved
    for i, j in enumerate(jobs):
        if i != 3:
            assert j.solved, (i, j.error)


def test_wide_flight_status_bitmasks_use_padded_bucket_width():
    eng = cpu_engine(config=SMALL, max_batch=128, chunk_steps=4)
    jobs = [eng.submit(HARD_9[i % 3] if i < 64 else EASY_9) for i in range(65)]
    batch = _take_all(eng)
    assert len(batch) == 65
    eng._launch_flights(SUDOKU_9, SMALL, batch)
    assert len(eng._flights) == 1
    fl = eng._flights[0]
    assert fl.state.solved.shape[0] == 128
    _drive_flight(eng, fl)
    for i, j in enumerate(jobs):
        assert j.solved, (i, j.error)
        assert not j.unsat


# -- reaction lag of the always-ahead loop ---------------------------------------


def test_cancel_honored_within_two_chunk_boundaries():
    eng = cpu_engine(config=SMALL, max_batch=8, chunk_steps=1, handicap_s=0.05).start()
    try:
        j = eng.submit(HARD_9[1])
        assert wait_for(lambda: len(eng._flights) > 0, timeout=30)
        fl = eng._flights[0]
        chunks_at_cancel = fl.chunks
        eng.cancel(j.uuid)
        assert j.wait(30), "cancelled job must resolve promptly"
        assert j.cancelled and not j.solved and not j.unsat
        assert fl.chunks - chunks_at_cancel <= 3, fl.chunks - chunks_at_cancel
        assert wait_for(lambda: not eng._flights, timeout=20)
    finally:
        eng.stop(timeout=2)


def test_deadline_honored_within_two_chunk_boundaries():
    eng = cpu_engine(config=SMALL, max_batch=8, chunk_steps=1, handicap_s=0.05).start()
    try:
        j = eng.submit(HARD_9[1], deadline_s=0.3)
        assert j.wait(30)
        assert j.error == "deadline expired"
        assert not j.solved and not j.unsat
        took = time.monotonic() - j.submitted_at
        assert took < 0.3 + 5.0, f"deadline reaction took {took:.2f}s"
        ok = eng.submit(EASY_9)
        assert ok.wait(60) and ok.solved
    finally:
        eng.stop(timeout=2)
