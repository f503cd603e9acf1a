"""The port engine's recovery lane (``serving/faults.py`` wired into the
engine and the resident scheduler) against the JAX package's.

Twins of the baseline and recovery lanes of ``tests/test_faults.py`` (its
unit lane, taxonomy, schedules, injector and breaker, is twinned in
``tests/test_torch_serving_host.py``): a permanent failure is confined to
its group; terminal ``fail()`` and ``stop()`` resolve every held job;
seeded schedules faulting at least 10 % of dispatches on the static and
resident paths finish every job with solutions bit-identical to the
fault-free run; the fused -> composite and lane-halving rungs (the latter
also on a real ``torch.cuda.OutOfMemoryError``); poison bisection; the
breaker on an injected clock; bulk retries over HTTP; retry budgets.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu.models.geometry import geometry_for_size as jgeometry
from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JSolverConfig
from distributed_sudoku_solver_tpu.ops.solve import solve_batch as jax_solve_batch
from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
from distributed_sudoku_solver_tpu_torch.obs import lockdep
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.serving import engine as engine_mod
from distributed_sudoku_solver_tpu_torch.serving import faults
from distributed_sudoku_solver_tpu_torch.serving.engine import Job, SolverEngine
from distributed_sudoku_solver_tpu_torch.serving.scheduler import ResidentConfig, ResidentFlight
from distributed_sudoku_solver_tpu_torch.utils.puzzles import EASY_9, HARD_9

SMALL = SolverConfig(min_lanes=8, stack_slots=16)
FUSED_SMALL = SolverConfig(min_lanes=8, stack_slots=16, step_impl="fused", fused_steps=2)
RC = ResidentConfig(job_slots=4, gang_lanes=4, queue_depth=32, attach_batch=4, chunk_steps=16)
BOARDS = [np.asarray(p) for p in HARD_9] * 2


def wait_for(pred, timeout=60.0, every=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return False


def cpu_engine(**kw) -> SolverEngine:
    return SolverEngine(device="cpu", **kw)


class FakeClock:
    def __init__(self, t0: float = 1000.0):
        self.t = t0
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            return self.t

    def advance(self, dt: float) -> None:
        with self._lock:
            self.t += dt


@pytest.fixture(autouse=True)
def port_lock_witness():
    with lockdep.installed(lockdep.manifest_witness(strict=True)) as w:
        yield w
    assert w.violations == [], w.violations


def _solve_all(eng, boards, timeout=180):
    jobs = [eng.submit(b) for b in boards]
    for j in jobs:
        assert j.wait(timeout), (j.error, j.fault_retries, j.last_fault)
    return jobs


@pytest.fixture(scope="module")
def jax_hard9():
    """HARD_9's unique solutions from the JAX package: every recovered
    run below must reproduce them."""
    res = jax_solve_batch(np.stack(HARD_9).astype(np.int32), jgeometry(9),
                          JSolverConfig(min_lanes=8, stack_slots=16))
    return np.asarray(res.solution)


# -- baseline lane --------------------------------------------------------------


def test_permanent_batch_failure_confined_to_its_group():
    eng = cpu_engine(config=SolverConfig(lanes=2, stack_slots=4), max_batch=8).start()
    try:
        bad_roots = np.ones((2 * (1 + 4) + 1, 9, 9), np.uint32)
        j = eng.submit_roots(bad_roots, SUDOKU_9)
        ok = eng.submit(EASY_9)
        assert j.wait(60)
        assert j.error and not j.solved
        assert "ValueError" in j.error
        assert ok.wait(60) and ok.solved, "other group caught the failure"
        assert eng.metrics()["faults"]["permanent_failures"] == 1
    finally:
        eng.stop(timeout=2)


def test_resident_fail_drains_queued_and_attached():
    eng = cpu_engine(config=SMALL, max_batch=8, resident=RC)
    rf = ResidentFlight(eng, SUDOKU_9, RC)
    attached = Job(uuid="a", grid=np.asarray(EASY_9, np.int32), geom=SUDOKU_9)
    queued = Job(uuid="q", grid=np.asarray(EASY_9, np.int32), geom=SUDOKU_9)
    rf.slots[1] = attached
    rf._pending.append(queued)
    rf.fail(RuntimeError("device exploded"))
    for job in (attached, queued):
        assert job.done.is_set(), "fail() stranded a held job"
        assert job.error and "device exploded" in job.error
    fresh = Job(uuid="f", grid=np.asarray(EASY_9, np.int32), geom=SUDOKU_9)
    assert not rf.try_admit(fresh)
    assert rf.closed_deflected == 1
    assert all(s is None for s in rf.slots)


def test_drain_on_stop_resolves_every_pending_event():
    eng = cpu_engine(config=SMALL, max_batch=8, chunk_steps=1, handicap_s=0.1,
                     resident=RC).start()
    warm = eng.submit(EASY_9)
    assert warm.wait(60)
    jobs = [eng.submit(HARD_9[1]) for _ in range(6)]
    jobs.append(eng.submit(HARD_9[0], config=SMALL))
    eng.stop(timeout=10)
    for j in jobs:
        assert j.wait(5), f"job {j.uuid} stranded by stop()"
        assert j.solved or j.error == "engine stopped"


# -- recovery lane ----------------------------------------------------------------


def test_static_path_transient_schedule_bit_identical(jax_hard9):
    eng = cpu_engine(config=SMALL, max_batch=4).start()
    try:
        baseline = _solve_all(eng, BOARDS)
    finally:
        eng.stop(timeout=2)
    inj = faults.FaultInjector(faults.FaultSchedule.seeded(
        seed=41, rate=0.3, sites=("engine.launch", "engine.advance", "fetch.status")))
    with faults.injected(inj):
        eng = cpu_engine(config=SMALL, max_batch=4,
                         recovery=faults.RecoveryPolicy(max_retries=25)).start()
        try:
            jobs = _solve_all(eng, BOARDS)
            m = eng.metrics()["faults"]
        finally:
            eng.stop(timeout=2)
    for i, (base, job) in enumerate(zip(baseline, jobs)):
        assert job.solved and job.error is None, (job.error, job.last_fault)
        np.testing.assert_array_equal(job.solution, base.solution)
        np.testing.assert_array_equal(job.solution, jax_hard9[i % 3])
    im = inj.metrics()
    injected = sum(im["injected"].values())
    dispatches = sum(im["dispatches"].values())
    assert injected >= 1 and injected / dispatches >= 0.10, (injected, dispatches)
    assert m["retries"] >= injected
    assert m["requeues"] >= 1 and m["budget_exhausted"] == 0


def test_resident_path_transient_schedule_bit_identical(jax_hard9):
    eng = cpu_engine(config=SMALL, max_batch=8, resident=RC).start()
    try:
        baseline = _solve_all(eng, BOARDS)
        assert eng.metrics()["resident"]["9x9"]["admitted"] >= len(BOARDS)
    finally:
        eng.stop(timeout=2)
    inj = faults.FaultInjector(faults.FaultSchedule.seeded(
        seed=5, rate=0.25, sites=("resident.attach", "resident.advance", "fetch.status")))
    with faults.injected(inj):
        eng = cpu_engine(config=SMALL, max_batch=8, resident=RC,
                         recovery=faults.RecoveryPolicy(max_retries=10,
                                                        rebuild_cooldown_s=0.0)).start()
        try:
            jobs = _solve_all(eng, BOARDS)
            m = eng.metrics()
        finally:
            eng.stop(timeout=2)
    for i, (base, job) in enumerate(zip(baseline, jobs)):
        assert job.solved and job.error is None, (job.error, job.last_fault)
        np.testing.assert_array_equal(job.solution, base.solution)
        np.testing.assert_array_equal(job.solution, jax_hard9[i % 3])
    im = inj.metrics()
    injected = sum(im["injected"].values())
    assert injected >= 1
    assert injected / sum(im["dispatches"].values()) >= 0.10
    rm = m["resident"]["9x9"]["faults"]
    assert rm["rebuilds"] >= 1 and rm["rebuild_requeued"] >= 1
    assert m["faults"]["budget_exhausted"] == 0


def test_fused_transient_fault_downgrades_to_composite(jax_hard9):
    inj = faults.FaultInjector(faults.FaultSchedule.at(
        {"engine.advance": {0: "runtime"}, "engine.launch": {1: "oom"}}))
    with faults.injected(inj):
        eng = cpu_engine(config=FUSED_SMALL, max_batch=8).start()
        try:
            j = eng.submit(HARD_9[0])
            assert j.wait(120), (j.error, j.last_fault)
            assert j.solved and j.error is None
            np.testing.assert_array_equal(j.solution, jax_hard9[0])
            m = eng.metrics()["faults"]
            assert m["downgrades"]["fused_to_composite"] >= 1
            assert m["downgrades"]["lanes_halved"] >= 1
        finally:
            eng.stop(timeout=2)


def test_oom_on_multijob_group_halves_and_stays_transient(jax_hard9):
    inj = faults.FaultInjector(faults.FaultSchedule.at({"engine.launch": {0: "oom"}}))
    with faults.injected(inj):
        eng = cpu_engine(config=SMALL, max_batch=8, batch_window_s=0.2).start()
        try:
            jobs = [eng.submit(p) for p in HARD_9[:4]]
            for i, j in enumerate(jobs):
                assert j.wait(120), (j.error, j.last_fault)
                assert j.solved and j.error is None, j.error
                np.testing.assert_array_equal(j.solution, jax_hard9[i])
            m = eng.metrics()["faults"]
            assert m["downgrades"]["lanes_halved"] >= 1
            assert m["bisections"] == 0, "transient OOM was bisected"
            assert m["permanent_failures"] == 0
        finally:
            eng.stop(timeout=2)


def test_real_cuda_oom_error_halves_lanes(monkeypatch, jax_hard9):
    """A real ``torch.cuda.OutOfMemoryError`` from the flight's seeding
    classifies transient and takes the lane-halving rung; the retried
    flight, at half the lanes, solves to the fault-free solutions."""
    seeded = []
    real = engine_mod.init_frontier_roots

    def oom_once(roots, job_of_root, n_jobs, cfg):
        seeded.append(cfg.resolve_lanes(roots.shape[0]))
        if len(seeded) == 1:
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.11 GiB total "
                "capacity; 78.02 GiB already allocated)")
        return real(roots, job_of_root, n_jobs, cfg)

    monkeypatch.setattr(engine_mod, "init_frontier_roots", oom_once)
    exc = torch.cuda.OutOfMemoryError("CUDA out of memory.")
    assert faults.classify(exc) == faults.TRANSIENT and faults.is_oom(exc)
    eng = cpu_engine(config=SolverConfig(min_lanes=16, stack_slots=16), max_batch=8,
                     batch_window_s=0.2).start()
    try:
        jobs = [eng.submit(p) for p in HARD_9]
        for i, j in enumerate(jobs):
            assert j.wait(120), (j.error, j.last_fault)
            assert j.solved and j.error is None and j.fault_retries == 1
            np.testing.assert_array_equal(j.solution, jax_hard9[i])
        m = eng.metrics()["faults"]
        assert m["downgrades"]["lanes_halved"] == 1 and m["bisections"] == 0
        assert seeded[0] == 16 and all(lanes <= 8 for lanes in seeded[1:])
    finally:
        eng.stop(timeout=2)


def test_poison_job_bisected_and_fails_alone():
    inj = faults.FaultInjector(poison_jobs=("poison-me",))
    with faults.injected(inj):
        eng = cpu_engine(config=SMALL, max_batch=8, batch_window_s=0.2).start()
        try:
            mates = [eng.submit(p) for p in HARD_9]
            poison = eng.submit(EASY_9, job_uuid="poison-me")
            mates.append(eng.submit(EASY_9))
            for j in mates:
                assert j.wait(120), (j.error, j.fault_retries)
                assert j.solved and j.error is None, j.error
            assert poison.wait(120)
            assert not poison.solved and poison.error
            assert "[permanent]" in poison.error
            m = eng.metrics()["faults"]
            assert m["bisections"] >= 1, m
            assert m["permanent_failures"] == 1
            ok = eng.submit(EASY_9)
            assert ok.wait(60) and ok.solved
        finally:
            eng.stop(timeout=2)


def test_resident_breaker_opens_halfopens_closes():
    clock = FakeClock()
    pol = faults.RecoveryPolicy(max_retries=10, rebuild_cooldown_s=0.0, breaker_failures=3,
                                breaker_cooldown_s=60.0, clock=clock)
    inj = faults.FaultInjector(faults.FaultSchedule.at(
        {"resident.advance": {0: "runtime", 1: "preempt", 2: "oom"}}))
    with faults.injected(inj):
        eng = cpu_engine(config=SMALL, max_batch=8, resident=RC, recovery=pol).start()
        try:
            rf = eng._resident_for(SUDOKU_9)
            assert rf is not None
            j1 = eng.submit(HARD_9[0])
            assert wait_for(lambda: rf.breaker.state == rf.breaker.OPEN)
            assert j1.wait(120), (j1.error, j1.fault_retries)
            assert j1.solved and j1.error is None
            assert rf.rebuilds == 2
            assert rf.requeued_static >= 1
            j2 = eng.submit(HARD_9[1], saturation="reject")
            assert j2.wait(120) and j2.solved
            assert rf.breaker_deflected >= 1
            assert eng.metrics()["faults"]["breaker"]["9x9"]["state"] == "open"
            before = rf.breaker.metrics()["transitions"]
            clock.advance(61.0)
            j3 = eng.submit(HARD_9[2])
            assert j3.wait(120) and j3.solved, (j3.error, j3.last_fault)
            assert wait_for(lambda: rf.breaker.state == rf.breaker.CLOSED)
            assert rf.breaker.metrics()["transitions"] >= before + 2
            admitted_before = rf.admitted
            j4 = eng.submit(EASY_9)
            assert rf.admitted == admitted_before + 1
            assert j4.wait(60) and j4.solved
            assert eng.metrics()["faults"]["breaker"]["9x9"]["state"] == "closed"
        finally:
            eng.stop(timeout=2)


def test_bulk_endpoint_retries_transient_chunk_faults():
    from distributed_sudoku_solver_tpu_torch.serving.http import ApiServer, StandaloneNode

    inj = faults.FaultInjector(faults.FaultSchedule.at({"bulk.dispatch": {0: "preempt"}}))
    with faults.injected(inj):
        eng = cpu_engine(config=SMALL, max_batch=8).start()
        node = StandaloneNode(engine=eng, address="127.0.0.1:test")
        api = ApiServer(node, host="127.0.0.1", port=0, solve_timeout_s=240).start()
        try:
            body = json.dumps({"boards": [np.asarray(EASY_9).tolist()] * 3}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{api.port}/solve_batch",
                                         data=body, method="POST")
            with urllib.request.urlopen(req, timeout=240) as resp:
                out = json.loads(resp.read())
                assert resp.status == 200
            assert out["solved"] == 3, out
            assert eng.fault_bulk_retries >= 1
            assert inj.metrics()["injected"] == {"bulk.dispatch:preempt": 1}
        finally:
            api.stop()
            eng.stop(timeout=2)


def test_retry_budget_exhaustion_fails_job_with_classified_error():
    inj = faults.FaultInjector(faults.FaultSchedule.seeded(
        seed=1, rate=1.0, kinds=("preempt",), sites=("engine.launch",)))
    with faults.injected(inj):
        eng = cpu_engine(config=SMALL, max_batch=8,
                         recovery=faults.RecoveryPolicy(max_retries=2)).start()
        try:
            j = eng.submit(EASY_9)
            assert j.wait(60)
            assert not j.solved
            assert "retry budget exhausted after 2 retries" in j.error
            assert "UNAVAILABLE" in j.error
            assert eng.metrics()["faults"]["budget_exhausted"] == 1
        finally:
            eng.stop(timeout=2)


# -- no fallback hides a failing kernel ----------------------------------------


@pytest.fixture
def k2_fails(monkeypatch):
    """K2 as it behaves on a node whose ``fused_step.cu`` failed to build:
    every dispatch raises ``KernelError`` (a ``RuntimeError``)."""
    from distributed_sudoku_solver_tpu_torch.ops import cuda_build, cuda_step

    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        raise cuda_build.KernelError("fused_step.cu : nvcc fused_step.cu failed (1)")

    monkeypatch.setattr(cuda_step, "fused_rounds", failing)
    return calls


def _assert_failed_loud(eng, jobs, k2_calls):
    for j in jobs:
        assert j.wait(120), "a job whose kernel failed never resolved"
        assert not j.solved and not j.unsat
        assert j.error and "KernelError" in j.error, j.error
    assert k2_calls, "the fused path was never dispatched"
    m = eng.metrics()
    fa = m["faults"]
    assert fa["downgrades"]["fused_to_composite"] == 0
    assert fa["downgrades"]["lanes_halved"] == 0
    assert m["fused_downgrades"] == 0
    assert fa["bisections"] == 0
    assert fa["permanent_failures"] == len(jobs)


@pytest.mark.parametrize("route", ["static", "resident"])
def test_failing_kernel_fails_jobs_without_fallback(k2_fails, route):
    """A ``KernelError`` is permanent: the jobs fail with it at once; the
    ladder neither downgrades them to the composite step nor bisects."""
    assert faults.classify(engine_mod.KernelError("x")) == faults.PERMANENT
    eng = cpu_engine(config=FUSED_SMALL, max_batch=8, batch_window_s=0.2,
                     resident=RC if route == "resident" else None).start()
    try:
        jobs = [eng.submit(p) for p in HARD_9]
        _assert_failed_loud(eng, jobs, k2_fails)
        if route == "resident":
            assert eng.metrics()["resident"]["9x9"]["faults"]["requeued_static"] >= 1
    finally:
        eng.stop(timeout=2)


def test_failing_kernel_answers_500_over_http_on_every_route(k2_fails):
    """``POST /solve`` and ``POST /solve?latency=1`` on a node whose K2
    fails answer 500 naming the kernel error, never 201 from a plain
    fallback; the megastep degrades to the chunked path, which fails."""
    from distributed_sudoku_solver_tpu_torch.serving.http import ApiServer, StandaloneNode

    eng = cpu_engine(config=FUSED_SMALL, max_batch=8).start()
    api = ApiServer(StandaloneNode(engine=eng, address="127.0.0.1:test"), host="127.0.0.1",
                    port=0, solve_timeout_s=120).start()
    try:
        for path in ("/solve", "/solve?latency=1"):
            body = json.dumps({"sudoku": np.asarray(HARD_9[0]).tolist()}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{api.port}{path}", data=body,
                                         method="POST")
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=120)
            assert err.value.code == 500, path
            assert "KernelError" in json.loads(err.value.read())["error"], path
        m = eng.metrics()
        assert m["faults"]["downgrades"]["fused_to_composite"] == 0
        assert m["fused_downgrades"] == 0
    finally:
        api.stop()
        eng.stop(timeout=2)
