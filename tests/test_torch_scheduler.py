"""The port's resident scheduler (``serving/scheduler.py``) against the JAX package's.

Twins of ``tests/test_scheduler.py``: attach mid-flight, detach on solve
and slot reuse, cancel and deadline expiry, saturation -> 429 +
Retry-After at the HTTP layer, and bit-equality of a job's solution
whether it ran resident or in a static flight.  Left out: the two cover
VMEM cases (they belong to the exact-cover kernel, which the engine does
not serve) and the wall-clock p95 comparison (a measurement, marked slow
in the JAX suite); its logic is twinned below on an injected engine clock.
The in-graph attach / advance / detach sequence is held bit-exact against
the JAX package's on every field; verdicts equal JAX's ``solve_batch``.
"""

import json
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu.ops import frontier as jfrontier
from distributed_sudoku_solver_tpu.ops.bitmask import encode_grid as jax_encode_grid
from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JSolverConfig
from distributed_sudoku_solver_tpu.ops.solve import finalize_frontier as jax_finalize
from distributed_sudoku_solver_tpu.ops.solve import solve_batch as jax_solve_batch
from distributed_sudoku_solver_tpu.models.geometry import SUDOKU_9 as J9
from distributed_sudoku_solver_tpu.models.geometry import geometry_for_size as jgeometry
from distributed_sudoku_solver_tpu.serving.scheduler import (
    ResidentConfig as JResidentConfig,
    resident_solver_config as jax_resident_solver_config,
)
from distributed_sudoku_solver_tpu.utils.checkpoint import advance_frontier as jax_advance
from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9, geometry_for_size
from distributed_sudoku_solver_tpu_torch.obs import lockdep
from distributed_sudoku_solver_tpu_torch.ops.bitmask import decode_grid, encode_grid
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    SolverConfig,
    attach_roots,
    detach,
    init_frontier_roots,
)
from distributed_sudoku_solver_tpu_torch.ops.solve import finalize_frontier
from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
from distributed_sudoku_solver_tpu_torch.serving.scheduler import (
    EngineSaturated,
    ResidentConfig,
    resident_solver_config,
)
from distributed_sudoku_solver_tpu_torch.utils.checkpoint import advance_frontier
from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution
from distributed_sudoku_solver_tpu_torch.utils.puzzles import EASY_9, HARD_9, make_puzzle

SMALL = SolverConfig(min_lanes=8, stack_slots=16)
RC = ResidentConfig(job_slots=4, gang_lanes=4, queue_depth=32, attach_batch=4, chunk_steps=16)
FIELDS = ("solution", "solved", "unsat", "overflowed", "nodes", "sol_count", "steps",
          "sweeps", "expansions", "steals")


def bad_board():
    bad = np.zeros((9, 9), np.int32)
    bad[0, 0] = bad[0, 1] = 5
    return bad


def wait_for(pred, timeout=30.0, every=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return False


def occupied(eng):
    m = eng.metrics().get("resident", {}).get("9x9")
    return m["occupied"] if m else 0


def cpu_engine(**kw) -> SolverEngine:
    return SolverEngine(device="cpu", **kw)


def slow_rc(**kw) -> ResidentConfig:
    base = dict(job_slots=4, gang_lanes=4, queue_depth=8, attach_batch=4, chunk_steps=1)
    return ResidentConfig(**{**base, **kw})


@pytest.fixture(autouse=True)
def port_lock_witness():
    with lockdep.installed(lockdep.manifest_witness(strict=True)) as w:
        yield w
    assert w.violations == [], w.violations


@pytest.fixture
def engine():
    eng = cpu_engine(config=SMALL, max_batch=8, resident=RC).start()
    yield eng
    eng.stop(timeout=2)


# -- flight-operation level: the attach / detach contract, against JAX --------


def test_attach_detach_slot_reuse_and_gang_invariant():
    cfg = resident_solver_config(SMALL, SUDOKU_9, RC)
    jcfg = jax_resident_solver_config(JSolverConfig(min_lanes=8, stack_slots=16), J9,
                                      JResidentConfig(**vars(RC)))
    assert JSolverConfig(**vars(cfg)) == jcfg
    gang, lanes = cfg.steal_gang, cfg.lanes
    assert lanes == RC.job_slots * gang
    st = init_frontier_roots(torch.zeros((lanes, 9, 9), dtype=torch.int32),
                             torch.full((lanes,), -1, dtype=torch.int32), RC.job_slots, cfg)
    jst = jfrontier.init_frontier_roots(jnp.zeros((lanes, 9, 9), jnp.uint32),
                                        jnp.full(lanes, -1, jnp.int32), RC.job_slots, jcfg)
    grids = np.stack([EASY_9, HARD_9[0]]).astype(np.int32)
    st = attach_roots(st, encode_grid(torch.from_numpy(grids), SUDOKU_9),
                      torch.tensor([0, 2], dtype=torch.int32), gang)
    jst = jfrontier.attach_roots(jst, jax_encode_grid(jnp.asarray(grids), J9),
                                 jnp.asarray([0, 2], jnp.int32), gang)
    st = advance_frontier(st, st.steps + 500, SUDOKU_9, cfg)
    jst = jax_advance(jst, jnp.int32(int(jst.steps) + 500), J9, jcfg)
    assert bool(st.solved[0]) and bool(st.solved[2])
    assert is_valid_solution(decode_grid(st.solution[2]).numpy())
    jobs = st.job.numpy()
    for g in range(RC.job_slots):
        owners = set(jobs[g * gang:(g + 1) * gang].tolist()) - {-1}
        assert owners <= {g}, (g, owners)
    st = detach(st, torch.tensor([True, False, False, False]))
    jst = jfrontier.detach(jst, jnp.asarray([True, False, False, False]))
    assert st.job[:gang].tolist() == [-1] * gang
    assert not bool(st.solved[0])
    st = attach_roots(st, encode_grid(torch.from_numpy(bad_board()[None]), SUDOKU_9),
                      torch.tensor([0], dtype=torch.int32), gang)
    jst = jfrontier.attach_roots(jst, jax_encode_grid(jnp.asarray(bad_board()[None]), J9),
                                 jnp.asarray([0], jnp.int32), gang)
    st = advance_frontier(st, st.steps + 500, SUDOKU_9, cfg)
    jst = jax_advance(jst, jnp.int32(int(jst.steps) + 500), J9, jcfg)
    res, want = finalize_frontier(st), jax_finalize(jst)
    assert bool(res.unsat[0]) and bool(res.solved[2])
    for f in FIELDS:
        got = getattr(res, f).numpy()
        if f == "solution":
            got = got.view(np.uint32)
        assert np.array_equal(got, np.asarray(getattr(want, f))), f


@pytest.mark.parametrize("slots,gang,stack", [(16, 8, 64), (16, 16, 64), (3, 50, 16),
                                              (1, 8, 64), (24, 8, 32)])
def test_resident_solver_config_matches_jax(slots, gang, stack):
    """The shape-stable config, fused and composite, equals JAX's (K2 and
    Mosaic agree on the lane rounding; these shapes are inside JAX's VMEM
    boundaries)."""
    rc = ResidentConfig(job_slots=slots, gang_lanes=gang)
    jrc = JResidentConfig(job_slots=slots, gang_lanes=gang)
    for impl in ("xla", "fused"):
        base = SolverConfig(stack_slots=stack, step_impl=impl)
        got = resident_solver_config(base, SUDOKU_9, rc)
        want = jax_resident_solver_config(JSolverConfig(**vars(base)), J9, jrc)
        assert vars(got) == vars(want)
        assert got.lanes % got.steal_gang == 0 and got.lanes // got.steal_gang == slots


# -- engine level --------------------------------------------------------------


def test_resident_serves_solved_and_unsat_and_recycles_slots(engine):
    jobs = [engine.submit(p) for p in HARD_9] + [engine.submit(EASY_9)
                                                  for _ in range(RC.job_slots)]
    ju = engine.submit(bad_board())
    for j in jobs:
        assert j.wait(120), j.error
        assert j.solved, (j.error, j.unsat)
        assert is_valid_solution(j.solution)
    assert ju.wait(120) and ju.unsat and not ju.solved
    m = engine.metrics()["resident"]["9x9"]
    assert m["admitted"] == len(jobs) + 1
    assert m["completed"] == len(jobs) + 1
    assert m["occupied"] == 0 and m["queued"] == 0
    assert engine.stats()["solved"] == len(jobs)
    assert engine.stats()["validations"] > 0


def test_resident_verdicts_equal_jax_solve_batch(engine):
    boards = [np.asarray(b) for b in HARD_9] + [EASY_9, bad_board()] + [
        make_puzzle(SUDOKU_9, 60 + i, n_clues=24, unique=False) for i in range(3)]
    want = jax_solve_batch(np.stack(boards).astype(np.int32), jgeometry(9),
                           JSolverConfig(min_lanes=8, stack_slots=16))
    jobs = [engine.submit(b) for b in boards]
    for i, j in enumerate(jobs):
        assert j.wait(120), j.error
        assert (j.solved, j.unsat) == (bool(np.asarray(want.solved)[i]),
                                       bool(np.asarray(want.unsat)[i]))
        if i < len(HARD_9):  # unique solutions
            np.testing.assert_array_equal(j.solution, np.asarray(want.solution)[i])
    assert engine.metrics()["resident"]["9x9"]["admitted"] == len(boards)


def test_resident_attach_mid_flight():
    eng = cpu_engine(config=SMALL, max_batch=8, handicap_s=0.06, resident=slow_rc()).start()
    try:
        hard = eng.submit(HARD_9[1])
        assert wait_for(lambda: occupied(eng) >= 1, timeout=30)
        easy = eng.submit(EASY_9)
        assert easy.wait(30), "mid-flight arrival starved behind the tenant"
        assert easy.solved
        assert not hard.done.is_set(), "the hard tenant finished first"
        assert hard.wait(120) and hard.solved
    finally:
        eng.stop(timeout=2)


def test_resident_cancel_frees_slot():
    eng = cpu_engine(config=SMALL, max_batch=8, handicap_s=0.06, resident=slow_rc()).start()
    try:
        j = eng.submit(HARD_9[1])
        assert wait_for(lambda: occupied(eng) >= 1, timeout=30)
        eng.cancel(j.uuid)
        assert j.wait(30), "cancelled resident job must resolve promptly"
        assert j.cancelled and not j.solved and not j.unsat
        assert wait_for(lambda: occupied(eng) == 0, timeout=20)
        ok = eng.submit(EASY_9)
        assert ok.wait(60) and ok.solved
        assert eng.metrics()["resident"]["9x9"]["cancelled"] >= 1
    finally:
        eng.stop(timeout=2)


def test_resident_deadline_expiry_frees_slot():
    eng = cpu_engine(config=SMALL, max_batch=8, handicap_s=0.06, resident=slow_rc()).start()
    try:
        j = eng.submit(HARD_9[1], deadline_s=0.3)
        assert j.wait(30)
        assert j.error == "deadline expired"
        assert not j.solved and not j.unsat
        assert wait_for(lambda: occupied(eng) == 0, timeout=20)
        assert eng.metrics()["resident"]["9x9"]["deadline_expired"] >= 1
        ok = eng.submit(EASY_9)
        assert ok.wait(60) and ok.solved, "slot not recycled after expiry"
    finally:
        eng.stop(timeout=2)


def test_cancelled_queued_job_resolves_without_free_slot():
    eng = cpu_engine(config=SMALL, max_batch=8, handicap_s=0.06,
                     resident=slow_rc(job_slots=1, queue_depth=4, attach_batch=1)).start()
    try:
        tenant = eng.submit(HARD_9[1])
        assert wait_for(lambda: occupied(eng) >= 1, timeout=30)
        queued = eng.submit(HARD_9[0])
        eng.cancel(queued.uuid)
        assert queued.wait(10), "dead queue entry stuck behind a busy slot pool"
        assert queued.cancelled and not queued.solved
        assert not tenant.done.is_set()
        assert tenant.wait(120) and tenant.solved
    finally:
        eng.stop(timeout=2)


def test_static_flight_deadline_expiry():
    eng = cpu_engine(config=SMALL, max_batch=8, chunk_steps=1, handicap_s=0.06).start()
    try:
        j = eng.submit(HARD_9[1], deadline_s=0.3)
        assert j.wait(30)
        assert j.error == "deadline expired"
        assert not j.solved and not j.unsat
        ok = eng.submit(EASY_9)
        assert ok.wait(60) and ok.solved, "loop died after deadline purge"
    finally:
        eng.stop(timeout=2)


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


def test_resident_deadline_and_admission_wait_on_an_injected_clock():
    """The logic the JAX suite's Poisson p95 measurement rests on, on an
    injected engine clock: admission waits and latencies are charged in
    engine-clock time, the resident default deadline is stamped from it,
    and a deadline expires when the clock says so, with no wall-clock
    sleep driving any of it."""
    clock = FakeClock()
    eng = cpu_engine(config=SMALL, max_batch=8, resident=slow_rc(job_slots=1, attach_batch=1),
                     clock=clock, handicap_s=0.02)
    tenant = eng.submit(HARD_9[1])
    waiting = eng.submit(HARD_9[0])
    assert tenant.deadline == pytest.approx(1000.0 + ResidentConfig().default_deadline_s)
    clock.advance(2.0)  # both waited 2 s of engine time before the loop ran
    eng.start()
    try:
        assert wait_for(lambda: occupied(eng) >= 1, timeout=30)
        clock.advance(ResidentConfig().default_deadline_s)  # past the tenant's deadline
        assert tenant.wait(30) and waiting.wait(30)
        assert tenant.error == "deadline expired" and waiting.error == "deadline expired"
        m = eng.metrics()["resident"]["9x9"]
        assert m["deadline_expired"] == 2
        assert m["admission_wait_ms"]["p50"] == pytest.approx(2000.0)
        lat = eng.latency.snapshot()
        assert lat["count"] == 2 and lat["p50"] >= 2.0 + ResidentConfig().default_deadline_s
    finally:
        eng.stop(timeout=2)


def test_resident_bit_equal_to_static_flight(engine):
    static = cpu_engine(config=SMALL, max_batch=8).start()
    try:
        for board in HARD_9:
            jr = engine.submit(board)
            js = static.submit(board)
            assert jr.wait(120) and jr.solved, jr.error
            assert js.wait(120) and js.solved, js.error
            np.testing.assert_array_equal(jr.solution, js.solution)
    finally:
        static.stop(timeout=2)


def test_ineligible_jobs_fall_back_to_static_flights(engine):
    import dataclasses

    warm = engine.submit(EASY_9)
    assert warm.wait(60) and warm.solved
    before = engine.metrics()["resident"]["9x9"]["admitted"]
    j = engine.submit(HARD_9[0], config=SMALL)
    jc = engine.submit(np.zeros((4, 4), np.int32),
                       config=dataclasses.replace(SMALL, count_all=True))
    assert j.wait(120) and j.solved
    assert jc.wait(120) and jc.sol_count == 288
    assert engine.metrics()["resident"]["9x9"].get("admitted", 0) == before


def test_mesh_devices_fall_back_or_raise():
    """``mesh_devices > 1``: with one device visible, the unfit-mesh
    fallback of the JAX engine (counted, served single-device); with
    enough devices visible (two virtual shards on the CPU), the mesh
    flight (``serving/mesh_scheduler.py``) and no ``mesh_unfit``."""
    from distributed_sudoku_solver_tpu_torch.parallel.mesh import virtual_devices
    from distributed_sudoku_solver_tpu_torch.serving.mesh_scheduler import MeshResidentFlight

    eng = cpu_engine(config=SMALL, max_batch=8,
                     resident=ResidentConfig(job_slots=2, gang_lanes=4, mesh_devices=2)).start()
    try:
        j = eng.submit(EASY_9)
        assert j.wait(60) and j.solved
        m = eng.metrics()
        assert m["mesh_unfit"] == 1 and m["resident"]["9x9"]["admitted"] == 1
        assert not isinstance(eng._resident[SUDOKU_9], MeshResidentFlight)
    finally:
        eng.stop(timeout=2)
    with virtual_devices(2):
        eng = cpu_engine(config=SMALL, max_batch=8,
                         resident=ResidentConfig(job_slots=2, gang_lanes=4, mesh_devices=2)).start()
        try:
            j = eng.submit(EASY_9)
            assert j.wait(60) and j.solved
            assert isinstance(eng._resident[SUDOKU_9], MeshResidentFlight)
            assert "mesh_unfit" not in eng.metrics()
        finally:
            eng.stop(timeout=2)


def _post(port, board):
    url = f"http://127.0.0.1:{port}/solve"
    body = json.dumps({"sudoku": np.asarray(board).tolist()}).encode()
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_saturation_rejects_and_http_429():
    from distributed_sudoku_solver_tpu_torch.serving.http import ApiServer, StandaloneNode

    eng = cpu_engine(config=SMALL, max_batch=8, handicap_s=0.03,
                     resident=slow_rc(job_slots=1, queue_depth=1, attach_batch=1)).start()
    node = StandaloneNode(engine=eng, address="127.0.0.1:test")
    api = ApiServer(node, host="127.0.0.1", port=0, solve_timeout_s=120).start()
    try:
        results = []
        lock = threading.Lock()

        def post():
            out = _post(api.port, HARD_9[1])
            with lock:
                results.append(out)

        threads = [threading.Thread(target=post) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
            assert not t.is_alive()
        codes = sorted(c for c, _, _ in results)
        assert 429 in codes, codes
        assert 201 in codes, codes
        for code, headers, body in results:
            if code == 429:
                assert int(headers["Retry-After"]) >= 1
                assert body["retry_after_s"] > 0
        assert eng.metrics()["resident"]["9x9"]["rejected"] >= 1
        with pytest.raises(EngineSaturated):
            for _ in range(8):
                eng.submit(HARD_9[1], saturation="reject")
        jf = eng.submit(EASY_9)
        assert jf.wait(120) and jf.solved, jf.error
        body = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{api.port}/metrics", timeout=30).read())
        r = body["resident"]["9x9"]
        assert r["slots"] == 1
        assert {"occupied", "queued", "admitted"} <= set(r)
        assert r["rejected"] >= 1
        assert r["admission_wait_ms"]["count"] >= 1
    finally:
        api.stop()
        eng.stop(timeout=2)


def test_poisson_smoke_resident(engine):
    from benchmarks.bench_poisson import poisson_load

    lats, jobs = poisson_load(engine, [np.asarray(p) for p in HARD_9] * 2, mean_gap_s=0.02,
                              seed=3)
    assert len(lats) == len(jobs) == 6
    assert all(j.solved for j in jobs)
    assert all(lat > 0 for lat in lats)


def test_resident_16x16_flight_serves_its_geometry(engine):
    """Flights group by geometry: 16x16 boards get a resident flight of
    their own beside the 9x9 one."""
    g16 = geometry_for_size(16)
    boards = [make_puzzle(g16, 100 + i, unique=False).astype(np.int32) for i in range(2)]
    jobs = [engine.submit(b) for b in boards] + [engine.submit(EASY_9)]
    for j in jobs:
        assert j.wait(120) and j.solved, j.error
    for b, j in zip(boards, jobs):
        assert is_valid_solution(j.solution, g16)
        assert np.array_equal(j.solution[b > 0], b[b > 0])
    m = engine.metrics()["resident"]
    assert m["16x16"]["admitted"] == 2 and m["9x9"]["admitted"] == 1
