"""The mesh-resident flight (``serving/mesh_scheduler.py``): the cases of
``tests/test_mesh_scheduler.py`` on port engines over CPU shards.

Every test but the fallback runs inside ``virtual_devices(8)``, the
counterpart of conftest's eight forced JAX CPU devices, so the flight's
shard programs, merges and ring steal run over a real four-shard mesh.
Nothing here asserts wall-clock scaling; these pin semantics: the engine
selects the mesh flight when ``mesh_devices`` fits and counts
``mesh_unfit`` when it does not; lifecycle, cancel and deadlines are
unchanged with slots spread over shards; the ring steal fires; verdicts
are bit-identical to the single-device flight's; one status fetch per
chunk; an injected fault at ``mesh.advance`` rebuilds through the breaker;
a ``KernelError`` under the mesh is permanent.  Then the mesh status word
against the JAX package's ``mesh_advance_status`` on the same state.
"""

import numpy as np
import pytest
import torch

import distributed_sudoku_solver_tpu_torch.serving.engine as engine_mod
from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.parallel.mesh import virtual_devices
from distributed_sudoku_solver_tpu_torch.serving import faults
from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
from distributed_sudoku_solver_tpu_torch.serving.mesh_scheduler import MeshResidentFlight
from distributed_sudoku_solver_tpu_torch.serving.scheduler import ResidentConfig, ResidentFlight
from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution
from distributed_sudoku_solver_tpu_torch.utils.puzzles import EASY_9, HARD_9
from tests.test_torch_scheduler import wait_for

SMALL = SolverConfig(min_lanes=8, stack_slots=16)
# 2 slots PER SHARD x 4 shards = 8 in all; gang 4 leaves 3 steal-installable
# lanes per gang (home lanes are excluded from ring installs).
MESH_RC = ResidentConfig(job_slots=2, gang_lanes=4, queue_depth=32, attach_batch=4,
                         chunk_steps=16, mesh_devices=4)
BOARDS = [EASY_9, HARD_9[0], HARD_9[1], HARD_9[2]]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def shards():
    with virtual_devices(8):
        yield


def _engine(**kw) -> SolverEngine:
    kw.setdefault("config", SMALL)
    kw.setdefault("max_batch", 8)
    return SolverEngine(device="cpu", **kw)


def _mesh_metrics(eng):
    return eng.metrics()["resident"]["9x9"].get("mesh")


def _solve_all(eng, boards, timeout=180):
    jobs = [eng.submit(b) for b in boards]
    for j in jobs:
        assert j.wait(timeout), "job timed out"
    return jobs


def test_mesh_flight_selected_and_pool_scales(shards):
    eng = _engine(resident=MESH_RC).start()
    try:
        for j in _solve_all(eng, BOARDS):
            assert j.solved and j.error is None, (j.error, j.last_fault)
            assert is_valid_solution(j.solution)
        rf = eng._resident[SUDOKU_9]
        assert isinstance(rf, MeshResidentFlight)
        assert rf.n_slots == MESH_RC.job_slots * MESH_RC.mesh_devices
        assert rf.config.lanes % MESH_RC.mesh_devices == 0
        m = _mesh_metrics(eng)
        assert m["devices"] == 4
        assert len(m["slot_occupancy"]) == 4 and len(m["shard_live_lanes"]) == 4
        assert m["rebuilds"] == 0 and m["fused_downgraded"] == 0
        assert eng.metrics().get("mesh_unfit", 0) == 0
    finally:
        eng.stop(timeout=2)


def test_mesh_lifecycle_occupies_multiple_shards(shards):
    """Six tenants on a 2-slot-per-shard mesh spread past shard 0 (slot s
    lives on shard s // job_slots), then everything drains."""
    eng = _engine(handicap_s=0.05, resident=ResidentConfig(
        job_slots=2, gang_lanes=4, queue_depth=32, attach_batch=8, chunk_steps=1,
        mesh_devices=4)).start()
    try:
        jobs = [eng.submit(b) for b in [HARD_9[0], HARD_9[1], HARD_9[2]] * 2]
        assert wait_for(
            lambda: sum(1 for s in _mesh_metrics(eng)["slot_occupancy"] if s > 0) >= 2,
            timeout=60), "tenants never spread past one shard"
        for j in jobs:
            assert j.wait(180) and j.solved, (j.error, j.last_fault)
            assert is_valid_solution(j.solution)
        assert wait_for(lambda: sum(_mesh_metrics(eng)["slot_occupancy"]) == 0, timeout=30)
    finally:
        eng.stop(timeout=2)


def test_mesh_cancel_and_deadline_across_shards(shards):
    eng = _engine(handicap_s=0.06, resident=ResidentConfig(
        job_slots=2, gang_lanes=4, queue_depth=32, attach_batch=8, chunk_steps=1,
        mesh_devices=4)).start()
    try:
        # Shard 0 holds two long tenants; the victims land on a later shard.
        pad = [eng.submit(HARD_9[0]), eng.submit(HARD_9[1])]
        victim = eng.submit(HARD_9[0])
        expiring = eng.submit(HARD_9[1], deadline_s=0.3)
        assert wait_for(lambda: sum(_mesh_metrics(eng)["slot_occupancy"][1:]) >= 1,
                        timeout=60), "victims never reached a non-zero shard"
        eng.cancel(victim.uuid)
        assert victim.wait(30), "a cancelled mesh tenant must resolve promptly"
        assert victim.cancelled and not victim.solved and not victim.unsat
        assert expiring.wait(60)
        assert expiring.error == "deadline expired"
        assert not expiring.solved and not expiring.unsat
        for j in pad:
            assert j.wait(180) and j.solved
        rm = eng.metrics()["resident"]["9x9"]
        assert rm["cancelled"] >= 1 and rm["deadline_expired"] >= 1
        ok = eng.submit(EASY_9)
        assert ok.wait(60) and ok.solved, "slot not recycled on the mesh"
    finally:
        eng.stop(timeout=2)


def test_cross_shard_steal_fires(shards):
    eng = _engine(resident=MESH_RC).start()
    try:
        j = eng.submit(HARD_9[0])
        assert j.wait(180) and j.solved, (j.error, j.last_fault)
        assert is_valid_solution(j.solution)
        assert j.nodes > 0, "board solved by propagation: nothing to steal"
        m = _mesh_metrics(eng)
        assert m["ring_shipped"] > 0, ("cross-shard steal never fired", m)
    finally:
        eng.stop(timeout=2)


def test_mesh_verdicts_bit_identical_to_single_chip(shards):
    boards = BOARDS * 2
    single = _engine(resident=ResidentConfig(job_slots=8, gang_lanes=4, queue_depth=32,
                                             attach_batch=4, chunk_steps=16)).start()
    try:
        base = _solve_all(single, boards)
        assert type(single._resident[SUDOKU_9]) is ResidentFlight
    finally:
        single.stop(timeout=2)
    mesh = _engine(resident=MESH_RC).start()
    try:
        got = _solve_all(mesh, boards)
        assert isinstance(mesh._resident[SUDOKU_9], MeshResidentFlight)
    finally:
        mesh.stop(timeout=2)
    for b, g in zip(base, got):
        assert b.solved and g.solved, (b.error, g.error)
        np.testing.assert_array_equal(g.solution, b.solution)
        assert g.sol_count == b.sol_count == 1


def test_mesh_fallback_when_too_few_devices():
    """More shards than devices visible (one CPU, no virtual devices): the
    engine counts mesh_unfit and serves on the single-device flight."""
    eng = _engine(resident=ResidentConfig(job_slots=4, gang_lanes=4, queue_depth=32,
                                          attach_batch=4, chunk_steps=16,
                                          mesh_devices=64)).start()
    try:
        j = eng.submit(HARD_9[0])
        assert j.wait(120) and j.solved, (j.error, j.last_fault)
        assert not isinstance(eng._resident[SUDOKU_9], MeshResidentFlight)
        assert eng.metrics()["mesh_unfit"] >= 1
        assert _mesh_metrics(eng) is None
    finally:
        eng.stop(timeout=2)


def test_mesh_loop_exactly_one_sync_per_chunk(shards, monkeypatch):
    """The status word (with the mesh telemetry appended) is ONE fetch per
    consumed chunk, plus the one verdict collection; merges never add one."""
    calls: list = []
    orig = engine_mod.host_fetch

    def counting(x, floor_s=0.0, tag="status"):
        calls.append(tag)
        return orig(x, floor_s=floor_s, tag=tag)

    monkeypatch.setattr(engine_mod, "host_fetch", counting)
    eng = _engine(resident=ResidentConfig(job_slots=2, gang_lanes=4, queue_depth=32,
                                          attach_batch=4, chunk_steps=2,
                                          mesh_devices=4)).start()
    try:
        j = eng.submit(HARD_9[1])
        assert j.wait(180) and j.solved, (j.error, j.last_fault)
        rf = eng._resident[SUDOKU_9]
        assert isinstance(rf, MeshResidentFlight)
        assert wait_for(lambda: all(s is None for s in rf.slots), timeout=20)
        chunks = rf.chunks
    finally:
        eng.stop(timeout=2)
    statuses = calls.count("status")
    assert statuses == chunks, (statuses, chunks)
    assert statuses >= 2, "workload too easy to exercise the mesh chunk loop"
    assert calls.count("event") == 1
    assert calls.count("finalize") == 0
    assert len(calls) == statuses + 1, calls


def test_mesh_breaker_rebuild_after_collective_fault(shards):
    """A runtime fault at the mesh.advance seam classifies transient: the
    state is dropped, held jobs requeue, the breaker rebuilds, every job
    completes, and the rebuild shows in both metric sections."""
    inj = faults.FaultInjector(faults.FaultSchedule.at({"mesh.advance": {0: "runtime"}}))
    with faults.injected(inj):
        eng = _engine(resident=MESH_RC, recovery=faults.RecoveryPolicy(
            max_retries=10, rebuild_cooldown_s=0.0)).start()
        try:
            for j in _solve_all(eng, [HARD_9[0], HARD_9[1]]):
                assert j.solved and j.error is None, (j.error, j.last_fault)
                assert is_valid_solution(j.solution)
            rm = eng.metrics()["resident"]["9x9"]
            assert rm["faults"]["rebuilds"] >= 1
            assert rm["mesh"]["rebuilds"] >= 1
            assert eng.metrics()["faults"]["budget_exhausted"] == 0
        finally:
            eng.stop(timeout=2)
    assert sum(inj.metrics()["injected"].values()) >= 1


def _pressure_stub(cls, pending: int, free: int, slots: int, depth: int):
    import threading
    from types import SimpleNamespace

    fl = object.__new__(cls)
    fl._lock = threading.Lock()
    fl._pending = [object()] * pending
    fl.slots = [None] * free + [object()] * (slots - free)
    fl.rcfg = SimpleNamespace(queue_depth=depth)
    fl.admission_wait = SimpleNamespace(snapshot=lambda: {})
    return fl


def test_mesh_admission_pressure_subtracts_free_slot_headroom():
    single = _pressure_stub(ResidentFlight, pending=4, free=3, slots=8, depth=8)
    mesh = _pressure_stub(MeshResidentFlight, pending=4, free=3, slots=8, depth=8)
    assert single.admission_pressure() == (0.5, 0.0)
    assert mesh.admission_pressure() == (0.125, 0.0)  # (4 - 3) / 8
    roomy = _pressure_stub(MeshResidentFlight, pending=2, free=6, slots=8, depth=8)
    assert roomy.admission_pressure() == (0.0, 0.0)
    full_s = _pressure_stub(ResidentFlight, pending=6, free=0, slots=8, depth=8)
    full_m = _pressure_stub(MeshResidentFlight, pending=6, free=0, slots=8, depth=8)
    assert full_m.admission_pressure() == full_s.admission_pressure() == (0.75, 0.0)


# -- beyond the JAX test file ------------------------------------------------------


def test_kernel_error_under_the_mesh_is_permanent(shards, monkeypatch):
    """K1 failing inside the mesh program (propagator='pallas') fails the
    jobs with the KernelError: the flight reroutes them to static flights
    (which fail the same way), nothing counts as mesh_unfit, nothing
    downgrades."""
    from distributed_sudoku_solver_tpu_torch.ops import cuda_build, cuda_propagate

    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        raise cuda_build.KernelError("propagate.cu : nvcc propagate.cu failed (1)")

    monkeypatch.setattr(cuda_propagate, "propagate_fixpoint_pallas", failing)
    eng = _engine(config=SolverConfig(min_lanes=8, stack_slots=16, propagator="pallas"),
                  resident=MESH_RC).start()
    try:
        jobs = [eng.submit(b) for b in HARD_9[:2]]
        for j in jobs:
            assert j.wait(120)
            assert not j.solved and not j.unsat
            assert j.error and "KernelError" in j.error, j.error
        assert calls
        assert isinstance(eng._resident[SUDOKU_9], MeshResidentFlight)
        m = eng.metrics()
        assert m.get("mesh_unfit", 0) == 0
        assert m["resident"]["9x9"]["faults"]["requeued_static"] >= 1
        assert m["faults"]["permanent_failures"] == len(jobs)
    finally:
        eng.stop(timeout=2)


def test_fused_base_config_runs_the_composite_mesh_flight(shards):
    eng = _engine(config=SolverConfig(min_lanes=8, stack_slots=16, step_impl="fused"),
                  resident=MESH_RC).start()
    try:
        j = eng.submit(HARD_9[0])
        assert j.wait(120) and j.solved, (j.error, j.last_fault)
        rf = eng._resident[SUDOKU_9]
        assert rf.config.step_impl == "xla" and rf.config.protect_home_lanes
        assert _mesh_metrics(eng)["fused_downgraded"] == 1
    finally:
        eng.stop(timeout=2)


def test_mesh_advance_status_matches_jax():
    """One attach and two advance chunks of the mesh programs against the
    JAX package's on the same boards: the status words equal word for
    word and the per-job rows bit-equal."""
    import jax
    import jax.numpy as jnp

    from distributed_sudoku_solver_tpu.models.geometry import SUDOKU_9 as J9
    from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JSolverConfig
    from distributed_sudoku_solver_tpu.parallel import make_mesh as jax_make_mesh
    from distributed_sudoku_solver_tpu.parallel import mesh_resident as jmr
    from distributed_sudoku_solver_tpu.serving.scheduler import resident_solver_config as jrsc
    from distributed_sudoku_solver_tpu.serving.scheduler import ResidentConfig as JRC
    from distributed_sudoku_solver_tpu_torch.parallel import mesh_resident as mr
    from distributed_sudoku_solver_tpu_torch.parallel.mesh import make_mesh
    from distributed_sudoku_solver_tpu_torch.serving.scheduler import resident_solver_config

    n_dev, slots = 4, 2
    rc = dict(job_slots=slots * n_dev, gang_lanes=4)
    jcfg = jrsc(JSolverConfig(min_lanes=8, stack_slots=16, protect_home_lanes=True), J9, JRC(**rc))
    cfg = resident_solver_config(SolverConfig(min_lanes=8, stack_slots=16,
                                              protect_home_lanes=True), SUDOKU_9,
                                 ResidentConfig(**rc))
    grids = np.stack([HARD_9[0], HARD_9[1], EASY_9]).astype(np.int32)
    ids = np.array([0, 3, 5], np.int32)
    jmesh = jax_make_mesh(jax.devices()[:n_dev])
    mesh = make_mesh([torch.device("cpu")] * n_dev)
    n_slots = slots * n_dev
    jst = jmr.mesh_init_resident(J9, jcfg, n_slots, jmesh)
    jst = jmr.mesh_attach(jst, jnp.asarray(grids), jnp.asarray(ids), J9, 4, mesh=jmesh)
    st = mr.mesh_init_resident(SUDOKU_9, cfg, n_slots, mesh)
    st = mr.mesh_attach(st, torch.from_numpy(grids), torch.from_numpy(ids), SUDOKU_9, 4, mesh)
    for _ in range(2):
        jst, jstatus = jmr.mesh_advance_status(jst, 3, J9, jcfg, jmesh)
        st, status = mr.mesh_advance_status(st, 3, SUDOKU_9, cfg, mesh)
        np.testing.assert_array_equal(status.numpy(), np.asarray(jstatus).astype(np.int32))
        for name in ("solved", "solution", "overflowed", "nodes", "sol_count", "steps",
                     "sweeps", "expansions", "steals"):
            w = np.asarray(getattr(jst, name))
            w = w.view(np.int32) if w.dtype == np.uint32 else w
            for s in st:
                np.testing.assert_array_equal(getattr(s, name).numpy(), w, err_msg=name)
    info = mr.unpack_mesh_status(status, n_slots, n_dev)
    assert set(info) >= {"ring_shipped", "shard_live", "shard_foreign", "solved", "has_work"}
