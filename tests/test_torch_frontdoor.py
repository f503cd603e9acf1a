"""The port's front door (``serving/frontdoor``) against the JAX package's.

Twins of ``tests/test_frontdoor.py`` (the symmetry-canonical equivalence
group, the result cache, the difficulty probe, and the end-to-end routing
acceptance: a hard board solved once answers every symmetry-equivalent
resubmission from the cache with zero device fetches), every engine on
``device="cpu"``.  The CLI's flags wait for the port's CLI (ROADMAP A11);
the JAX benchmark-mix tests are not the port's.  Then parity with the JAX
package: ``canonicalize`` (grid, transform, digest) and ``probe_propagate``
over 200 seeded boards and their random transforms, a cache snapshot
written by either package warming the other's, the twin routing's counts,
and a failing K2 answering 500 on the device route.  Tolerance: exact
equality.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from distributed_sudoku_solver_tpu.models.geometry import SUDOKU_4 as J4
from distributed_sudoku_solver_tpu.models.geometry import SUDOKU_6 as J6
from distributed_sudoku_solver_tpu.models.geometry import SUDOKU_9 as J9
from distributed_sudoku_solver_tpu.serving.frontdoor import cache as jcache_mod
from distributed_sudoku_solver_tpu.serving.frontdoor import canonical as jcanon
from distributed_sudoku_solver_tpu.serving.frontdoor import router as jrouter
from distributed_sudoku_solver_tpu_torch import native
from distributed_sudoku_solver_tpu_torch.models.geometry import (
    SUDOKU_4,
    SUDOKU_6,
    SUDOKU_9,
    SUDOKU_16,
)
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.serving.frontdoor import cache as cache_mod
from distributed_sudoku_solver_tpu_torch.serving.frontdoor import canonical as canon_mod
from distributed_sudoku_solver_tpu_torch.serving.frontdoor.canonical import (
    apply_transform,
    canonicalize,
    random_transform,
    restore_solution,
)
from distributed_sudoku_solver_tpu_torch.serving.frontdoor.router import (
    FrontDoorConfig,
    probe_propagate,
)
from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution
from distributed_sudoku_solver_tpu_torch.utils.puzzles import (
    EASY_9,
    HARD_9,
    make_puzzle,
)

SMALL = SolverConfig(min_lanes=8, stack_slots=24, max_steps=40_000)

#: A generated board the probe classifies easy-but-open (pinned by
#: test_probe_classifications below): the native-route fixture.
EASY_OPEN_SEED, EASY_OPEN_CLUES = 123, 30


def _easy_open_board() -> np.ndarray:
    return make_puzzle(SUDOKU_9, seed=EASY_OPEN_SEED, n_clues=EASY_OPEN_CLUES)


# -- equivalence-group property lane -------------------------------------------


def test_canonical_invariant_under_200_group_compositions():
    """The canonical form is invariant under random
    compositions of the group generators — 200 deterministic draws
    (fuzz-seeded), spread over four base boards, each transform itself a
    composition of relabel/row/col/band/stack permutations + transpose,
    and half the draws compose TWO such elements."""
    rng = np.random.default_rng(0xF00D)
    boards = [np.asarray(EASY_9)] + [np.asarray(b) for b in HARD_9]
    for i in range(200):
        board = boards[i % len(boards)]
        want = canonicalize(board, SUDOKU_9)
        b2 = apply_transform(board, random_transform(SUDOKU_9, rng))
        if i % 2:
            b2 = apply_transform(b2, random_transform(SUDOKU_9, rng))
        got = canonicalize(b2, SUDOKU_9)
        assert got.digest == want.digest, f"composition {i} broke invariance"
        assert np.array_equal(got.grid, want.grid)


def test_inverse_transform_round_trips_solution_bit_exactly():
    """The cache contract end to end, without an engine: the entry filled
    from representative A and hit from representative B must hand B its
    own frame's solution bit-exactly."""
    board = np.asarray(HARD_9[0])
    if native.available():
        solution, _ = native.solve(board)
    else:  # pragma: no cover - no compiler in the container
        from distributed_sudoku_solver_tpu_torch.utils.oracle import solve_oracle

        solution, _ = solve_oracle(board)
    rng = np.random.default_rng(0xBEEF)
    cf_a = canonicalize(board, SUDOKU_9)
    canon_sol_a = apply_transform(solution, cf_a.transform)
    for i in range(20):
        tr = random_transform(SUDOKU_9, rng)
        board_b = apply_transform(board, tr)
        sol_b = apply_transform(solution, tr)
        cf_b = canonicalize(board_b, SUDOKU_9)
        # Same orbit, same entry: B's canonical solution IS A's (unique
        # puzzle -> unique canonical solution whatever the filler).
        assert np.array_equal(
            apply_transform(sol_b, cf_b.transform), canon_sol_a
        ), f"draw {i}: canonical solutions diverged"
        # And the stored canonical solution maps back to B's frame.
        restored = restore_solution(canon_sol_a, cf_b.transform)
        assert np.array_equal(restored.astype(np.int64), sol_b), (
            f"draw {i}: inverse transform broke bit-exactness"
        )
        assert restored[board_b != 0].tolist() == board_b[board_b != 0].tolist()


def test_canonically_distinct_boards_never_collide():
    """Distinct orbits -> distinct canonical grids -> distinct digests
    (sha256 over the canonical bytes; a collision would need sha256 to
    collide on 81-byte inputs)."""
    boards = [np.asarray(EASY_9)] + [np.asarray(b) for b in HARD_9]
    boards += [make_puzzle(SUDOKU_9, seed=s, n_clues=30) for s in range(40, 60)]
    forms = [canonicalize(b, SUDOKU_9) for b in boards]
    digests = {}
    for b, cf in zip(boards, forms):
        key = cf.grid.tobytes()
        if cf.digest in digests:
            assert digests[cf.digest] == key, "digest collision across orbits"
        digests[cf.digest] = key
    # The generated boards are distinct puzzles; at least most orbits
    # must be distinct (sanity that the test is not vacuous).
    assert len(set(digests)) >= 20


def test_canonicalize_policy_bounds():
    # 16x16: beyond the enumeration bound -> uncacheable by policy.
    assert canonicalize(np.zeros((16, 16), np.int64), SUDOKU_16) is None
    # Small geometries stay exact (4x4 has a transpose frame, 6x6 none).
    rng = np.random.default_rng(3)
    g4 = np.zeros((4, 4), np.int64)
    g4[0, 0], g4[1, 2] = 1, 2
    want4 = canonicalize(g4, SUDOKU_4)
    g6 = np.zeros((6, 6), np.int64)
    g6[0, 0], g6[3, 4] = 1, 5
    want6 = canonicalize(g6, SUDOKU_6)
    for _ in range(10):
        got4 = canonicalize(
            apply_transform(g4, random_transform(SUDOKU_4, rng)), SUDOKU_4
        )
        got6 = canonicalize(
            apply_transform(g6, random_transform(SUDOKU_6, rng)), SUDOKU_6
        )
        assert got4.digest == want4.digest
        assert got6.digest == want6.digest
    # Out-of-range cell values are a caller bug, not an orbit.
    bad = np.zeros((9, 9), np.int64)
    bad[0, 0] = 11
    with pytest.raises(ValueError):
        canonicalize(bad, SUDOKU_9)


# -- difficulty probe ----------------------------------------------------------


def test_probe_classifications():
    pr = probe_propagate(np.asarray(EASY_9), SUDOKU_9)
    assert pr.status == "solved"
    assert is_valid_solution(pr.solution)
    mask = np.asarray(EASY_9) != 0
    assert (pr.solution[mask] == np.asarray(EASY_9)[mask]).all()
    # The published hard boards stay open with a score far above the
    # default easy threshold (they must never route native by accident).
    for b in HARD_9[:2]:
        pr = probe_propagate(np.asarray(b), SUDOKU_9)
        assert pr.status == "open"
        assert pr.score > FrontDoorConfig().easy_score
    # The native-route fixture: open but comfortably under the threshold.
    pr = probe_propagate(_easy_open_board(), SUDOKU_9)
    assert pr.status == "open"
    assert 0 < pr.score <= FrontDoorConfig().easy_score
    # A contradiction is a PROOF of unsatisfiability.
    bad = np.asarray(EASY_9).copy()
    bad[0, 0], bad[0, 1] = 5, 5
    assert probe_propagate(bad, SUDOKU_9).status == "unsat"
    # Out-of-range values: 'open' (the device path keeps its behavior).
    weird = np.zeros((9, 9), np.int64)
    weird[0, 0] = 12
    assert probe_propagate(weird, SUDOKU_9).status == "open"


def test_probe_solution_is_the_unique_solution():
    """A probe-completed grid is forced cell by cell, so it must agree
    with the independent solver's answer exactly."""
    board = np.asarray(HARD_9[2])  # the 17-clue board: propagation-solved
    pr = probe_propagate(board, SUDOKU_9)
    assert pr.status == "solved"
    assert is_valid_solution(pr.solution)
    if native.available():
        sol, _ = native.solve(board)
        assert np.array_equal(sol, pr.solution)


# -- result cache unit lane ----------------------------------------------------


def _entry(verdict=cache_mod.SOLVED, raw="r0"):
    sol = None if verdict == cache_mod.UNSAT else np.ones((9, 9), np.int8)
    return cache_mod.CacheEntry(
        verdict=verdict, solution=sol, nodes=7, raw_digest=raw, route="device"
    )


def test_result_cache_lru_negative_and_dup_counters():
    c = cache_mod.ResultCache(capacity=2)
    c.store_entry("a", _entry(raw="ra"))
    c.store_entry("b", _entry(verdict=cache_mod.UNSAT, raw="rb"))
    assert len(c) == 2
    # Hit from the SAME representative: no canonical dup.
    assert c.lookup_entry("a", "ra").verdict == cache_mod.SOLVED
    assert c.metrics()["canonical_dups"] == 0
    # Hit from a different representative of the orbit: a canonical dup;
    # an unsat entry is a negative hit.
    assert c.lookup_entry("b", "OTHER").verdict == cache_mod.UNSAT
    m = c.metrics()
    assert m["canonical_dups"] == 1 and m["negative_hits"] == 1
    # LRU: 'a' was touched after 'b'... but 'b' was touched last; insert
    # evicts the least recently used ('a').
    c.store_entry("c", _entry(raw="rc"))
    assert c.lookup_entry("a", "ra") is None  # evicted
    assert c.lookup_entry("b", "rb") is not None
    m = c.metrics()
    assert m["evictions"] == 1 and m["misses"] == 1 and m["entries"] == 2


# -- end-to-end routing acceptance ---------------------------------------------


@pytest.fixture(scope="module")
def frontdoor_engine():
    from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
    from distributed_sudoku_solver_tpu_torch.serving.scheduler import ResidentConfig

    eng = SolverEngine(
        config=SMALL,
        max_batch=8,
        chunk_steps=8,
        resident=ResidentConfig(job_slots=4, gang_lanes=4, queue_depth=16),
        frontdoor=FrontDoorConfig(),
        device="cpu",
    ).start()
    yield eng
    eng.stop(timeout=5)


def test_routing_acceptance_end_to_end(frontdoor_engine, monkeypatch):
    """The routing acceptance, in one flow:

    1. a hard board solved once (device route, resident flight);
    2. resubmitted under a random symmetry transform it answers from the
       cache with ZERO device fetches (the ``host_fetch`` seam is
       wrapped and must not fire during the cached request) and the
       returned solution maps bit-exactly to the transformed frame;
    3. an easy board routes native, a hard board routes resident
       (device), each verdict bit-identical to the direct engine path
       (``frontdoor=False``).
    """
    import distributed_sudoku_solver_tpu_torch.serving.engine as engine_mod

    eng = frontdoor_engine
    hard = np.asarray(HARD_9[0])

    # Direct path first (frontdoor=False): the bit-exactness oracle.
    direct = eng.submit(hard, frontdoor=False)
    assert direct.wait(300) and direct.solved, direct.error
    assert direct.route is None  # the bypass really bypassed

    # 1. Hard board through the front door: device route, resident
    #    admission (eligible plain submit on a resident-enabled engine).
    j_hard = eng.submit(hard)
    assert j_hard.wait(300) and j_hard.solved, j_hard.error
    assert j_hard.route == "device"
    assert np.array_equal(j_hard.solution, direct.solution)
    rm = eng.metrics()["resident"]["9x9"]
    assert rm["admitted"] >= 1, "hard board did not ride the resident flight"

    # 2. Symmetry-transformed resubmit: cache hit, zero device fetches.
    rng = np.random.default_rng(0xCAFE)
    tr = random_transform(SUDOKU_9, rng)
    transformed = apply_transform(hard, tr)
    fetches = []
    orig = engine_mod.host_fetch

    def counting(x, floor_s=0.0, tag="status"):
        fetches.append(tag)
        return orig(x, floor_s, tag)

    monkeypatch.setattr(engine_mod, "host_fetch", counting)
    j_cache = eng.submit(transformed)
    assert j_cache.wait(30) and j_cache.solved
    monkeypatch.setattr(engine_mod, "host_fetch", orig)
    assert j_cache.route == "cache"
    assert fetches == [], f"cached answer cost device fetches: {fetches}"
    # Bit-exact in the TRANSFORMED frame: the cached canonical solution
    # mapped through this request's own inverse transform.
    assert np.array_equal(
        j_cache.solution, apply_transform(direct.solution, tr)
    )
    assert is_valid_solution(j_cache.solution)

    # 3. Easy board: native route, verdict identical to the direct path.
    easy = _easy_open_board()
    direct_easy = eng.submit(easy, frontdoor=False)
    assert direct_easy.wait(300) and direct_easy.solved
    j_easy = eng.submit(easy.copy())
    assert j_easy.wait(60) and j_easy.solved, j_easy.error
    if native.available():
        assert j_easy.route == "native"
    assert is_valid_solution(j_easy.solution)
    # Unique puzzle (make_puzzle carves uniqueness-checked): any sound
    # engine returns THE solution.
    assert np.array_equal(j_easy.solution, direct_easy.solution)

    fd = eng.metrics()["frontdoor"]
    assert fd["routes"]["cache"] >= 1
    assert fd["routes"]["device"] >= 1
    assert fd["cache"]["hits"] >= 1
    assert fd["cache"]["canonical_dups"] >= 1


def test_propagation_and_negative_cache_routes(frontdoor_engine):
    eng = frontdoor_engine
    j = eng.submit(np.asarray(EASY_9))
    assert j.wait(30) and j.solved and j.route == "propagation"
    assert is_valid_solution(j.solution)
    # Proven-unsat boards cache as negative entries: second submission
    # of an EQUIVALENT board answers from the cache, still unsat.
    bad = np.asarray(EASY_9).copy()
    bad[0, 0], bad[0, 1] = 5, 5
    j1 = eng.submit(bad)
    assert j1.wait(30) and j1.unsat and j1.route == "propagation"
    tr = random_transform(SUDOKU_9, np.random.default_rng(1))
    j2 = eng.submit(apply_transform(bad, tr))
    assert j2.wait(30) and j2.unsat and j2.route == "cache"
    assert j2.solution is None
    # The engine verdict convention: unsat rides a COMPLETE refutation,
    # which a cluster node's finalization reads off `exhausted`.
    assert j1.exhausted and j2.exhausted


def test_frontdoor_stats_and_latency_histograms(frontdoor_engine):
    """Front-door-answered jobs count as the node's work (stats parity)
    and the per-route latency histograms are live."""
    eng = frontdoor_engine
    before = eng.stats()
    j = eng.submit(np.asarray(EASY_9))  # cache hit by now (earlier test)
    assert j.wait(30) and j.solved
    after = eng.stats()
    assert after["jobs_done"] == before["jobs_done"] + 1
    assert after["solved"] == before["solved"] + 1
    hist = eng.metrics()["hist"]
    assert "frontdoor_cache_ms" in hist or "frontdoor_propagation_ms" in hist
    assert "frontdoor_device_ms" in hist


def test_race_native_device_fallback_when_native_declines(monkeypatch):
    """race_native's seam contract: a native decline (no compiler) must
    fall through to the device entrant and still resolve the job with
    the right verdict."""
    from distributed_sudoku_solver_tpu_torch import native
    from distributed_sudoku_solver_tpu_torch.serving.engine import Job, SolverEngine
    from distributed_sudoku_solver_tpu_torch.serving.portfolio import race_native

    monkeypatch.setattr(native, "available", lambda: False)
    eng = SolverEngine(config=SMALL, max_batch=8, device="cpu").start()
    try:
        board = _easy_open_board()
        verdicts = []
        job = Job(uuid="race-fallback-test", grid=board, geom=SUDOKU_9)
        job.submitted_at = eng._clock()
        race_native(
            eng, job, head_start_s=0.05, on_verdict=lambda j: verdicts.append(j.route)
        )
        assert job.wait(300) and job.solved, job.error
        assert job.route == "device"
        assert verdicts == ["device"]
        assert is_valid_solution(job.solution)
    finally:
        eng.stop(timeout=5)


def test_race_native_late_win_counts_request_once(monkeypatch):
    """A native win AFTER the device fallback has been
    submitted must not double-count the request — the fallback is a
    shadow job (engine accounting skips it); the race's hook counts the
    one request, and the wall lands in the winning route's histogram."""
    from distributed_sudoku_solver_tpu_torch import native
    from distributed_sudoku_solver_tpu_torch.serving.engine import Job, SolverEngine
    from distributed_sudoku_solver_tpu_torch.serving.portfolio import race_native

    eng = SolverEngine(config=SMALL, max_batch=8, chunk_steps=4, device="cpu").start()
    release = threading.Event()
    try:
        board = np.asarray(HARD_9[0])
        expected, _ = native.solve(board) if native.available() else (None, 0)
        if expected is None:
            pytest.skip("native solver unavailable")
        pacer = threading.Event()
        # Park the device loop in an exclusive section so the submitted
        # fallback provably cannot win — the ONLY ordering under test is
        # "native verdict lands after the fallback is in flight".
        exclusive = threading.Thread(
            target=lambda: eng.run_exclusive(lambda: release.wait(60)),
            daemon=True,
        )
        exclusive.start()
        pacer.wait(0.1)  # let the loop claim the exclusive section

        def slow_native(grid, geom):
            # Lose the head start on purpose: return only once the
            # device fallback is definitely queued.
            for _ in range(5000):
                if eng.busy_depth() > 0:
                    break
                pacer.wait(0.01)
            pacer.wait(0.05)
            return expected.copy(), 12345

        monkeypatch.setattr(native, "available", lambda: True)
        monkeypatch.setattr(native, "solve", slow_native)
        before = eng.stats()
        resolutions = []
        job = Job(uuid="race-late-win", grid=board, geom=SUDOKU_9)
        job.submitted_at = eng._clock()
        race_native(eng, job, head_start_s=0.05,
                    on_verdict=lambda j: resolutions.append(j.route))
        assert job.wait(300) and job.solved
        assert job.route == "native" and resolutions == ["native"]
        release.set()
        exclusive.join(60)
        # Let the cancelled shadow fallback drain, then pin the engine's
        # books: the shadow resolution added NOTHING.
        for _ in range(200):
            if eng.busy_depth() == 0:
                break
            pacer.wait(0.05)
        after = eng.stats()
        assert after["jobs_done"] == before["jobs_done"]
        assert after["solved"] == before["solved"]
    finally:
        release.set()
        eng.stop(timeout=5)


def test_race_native_fallback_inherits_deadline(monkeypatch):
    """deadline_s survives the native route — the
    shadow fallback inherits the outer job's absolute deadline, so a
    caller's wall-clock budget is enforced even when the native entrant
    declines and the board lands on a device flight."""
    from distributed_sudoku_solver_tpu_torch import native
    from distributed_sudoku_solver_tpu_torch.serving.engine import Job, SolverEngine
    from distributed_sudoku_solver_tpu_torch.serving.portfolio import race_native

    monkeypatch.setattr(native, "available", lambda: False)
    eng = SolverEngine(config=SMALL, max_batch=8, chunk_steps=4, device="cpu").start()
    try:
        job = Job(uuid="race-deadline", grid=np.asarray(HARD_9[0]), geom=SUDOKU_9)
        job.submitted_at = eng._clock()
        job.deadline = eng._clock() - 1.0  # already expired
        race_native(eng, job, head_start_s=0.01)
        assert job.wait(60), "expired fallback never resolved"
        assert job.error == "deadline expired", (job.error, job.solved)
    finally:
        eng.stop(timeout=5)


def test_route_commit_skipped_when_placement_fails():
    """A device-routed submit that fails placement
    (here: engine stopped; the saturation-429 path is the same seam)
    must not inflate the device-route counters or park a cache-fill
    entry for a job that will never run."""
    from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine

    eng = SolverEngine(config=SMALL, max_batch=8, frontdoor=FrontDoorConfig(),
                       device="cpu").start()
    eng.stop(timeout=5)
    fd = eng.frontdoor
    before = fd.metrics()
    with pytest.raises(RuntimeError):
        eng.submit(np.asarray(HARD_9[0]))
    after = fd.metrics()
    assert after["routes"]["device"] == before["routes"]["device"]
    assert after["probe"]["hard"] == before["probe"]["hard"]
    assert after["pending_fills"] == 0


# -- parity with the JAX package -------------------------------------------------


def _parity_boards():
    """200 seeded boards (carved 9x9 at several clue counts, HARD_9, EASY_9,
    4x4 and 6x6, one unsat) as ``(board, port geometry, JAX geometry)``."""
    out = [(np.asarray(EASY_9), SUDOKU_9, J9)] + [(np.asarray(b), SUDOKU_9, J9) for b in HARD_9]
    bad = np.asarray(EASY_9).copy()
    bad[0, 0], bad[0, 1] = 5, 5
    out.append((bad, SUDOKU_9, J9))
    for s in range(170):
        out.append((make_puzzle(SUDOKU_9, 500 + s, n_clues=22 + s % 12, unique=False),
                    SUDOKU_9, J9))
    for s in range(13):
        out.append((make_puzzle(SUDOKU_4, s, n_clues=5, unique=False), SUDOKU_4, J4))
        if len(out) < 200:
            out.append((make_puzzle(SUDOKU_6, s, n_clues=12, unique=False), SUDOKU_6, J6))
    return out[:200]


def test_canonicalize_and_probe_equal_the_jax_package():
    """Each board and one seeded random transform of it: canonical grid,
    transform and sha256 digest equal, and the probe's status, solution,
    empties, score and sweeps equal."""
    boards = _parity_boards()
    assert len(boards) == 200
    rng, jrng = np.random.default_rng(0xD00D), np.random.default_rng(0xD00D)
    for i, (board, geom, jgeom) in enumerate(boards):
        tr, jtr = random_transform(geom, rng), jcanon.random_transform(jgeom, jrng)
        assert dataclasses.astuple(tr) == dataclasses.astuple(jtr), i
        for b in (board, apply_transform(board, tr)):
            cf, jcf = canonicalize(b, geom), jcanon.canonicalize(b, jgeom)
            assert cf.digest == jcf.digest, i
            assert np.array_equal(cf.grid, jcf.grid) and cf.grid.dtype == jcf.grid.dtype, i
            assert dataclasses.astuple(cf.transform) == dataclasses.astuple(jcf.transform), i
            pr, jpr = probe_propagate(b, geom), jrouter.probe_propagate(b, jgeom)
            assert (pr.status, pr.empties, pr.score, pr.sweeps) == (
                jpr.status, jpr.empties, jpr.score, jpr.sweeps), i
            assert (pr.solution is None) == (jpr.solution is None), i
            if pr.solution is not None:
                assert np.array_equal(pr.solution, jpr.solution), i
                assert pr.solution.dtype == jpr.solution.dtype


def _filled_cache(cache_cls, entry_cls, canon, geom, boards):
    """A cache holding each board's orbit: solved entries with the board's
    canonical-frame solution (native DFS), one negative entry."""
    c = cache_cls(capacity=64)
    for b in boards:
        cf = canon.canonicalize(b, geom)
        sol, nodes = native.solve(b)
        if sol is None:
            c.store_entry(cf.digest, entry_cls(verdict="unsat", solution=None, nodes=nodes,
                                               raw_digest="r", route="propagation"))
        else:
            c.store_entry(cf.digest, entry_cls(
                verdict="solved", solution=canon.apply_transform(sol, cf.transform).astype(
                    np.int8), nodes=nodes, raw_digest="r", route="device"))
    return c


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cache_snapshot_warms_the_other_package(tmp_path, direction):
    """A hot set exported (and journaled through ``Journal.save_frontdoor``)
    by one package imports into the other's cache, whose lookups from a
    transformed board then restore that board's own solution."""
    from distributed_sudoku_solver_tpu.serving.journal import Journal as JJournal
    from distributed_sudoku_solver_tpu_torch.serving.journal import Journal

    bad = np.asarray(EASY_9).copy()
    bad[0, 0], bad[0, 1] = 5, 5
    boards = [np.asarray(HARD_9[0]), np.asarray(HARD_9[1]), _easy_open_board(), bad]
    if direction == "jax_to_port":
        src = _filled_cache(jcache_mod.ResultCache, jcache_mod.CacheEntry, jcanon, J9, boards)
        writer, reader = JJournal(str(tmp_path)), Journal(str(tmp_path))
        dst, canon, geom = cache_mod.ResultCache(capacity=64), canon_mod, SUDOKU_9
    else:
        src = _filled_cache(cache_mod.ResultCache, cache_mod.CacheEntry, canon_mod, SUDOKU_9,
                            boards)
        writer, reader = Journal(str(tmp_path)), JJournal(str(tmp_path))
        dst, canon, geom = jcache_mod.ResultCache(capacity=64), jcanon, J9
    try:
        writer.save_frontdoor(src.export_hot())
        assert dst.import_hot(reader.load_frontdoor()) == len(boards)
    finally:
        writer.shutdown()
        reader.shutdown()
    rng = np.random.default_rng(7)
    for b in boards:
        tr = random_transform(SUDOKU_9, rng)
        tb = apply_transform(b, tr)
        cf = canon.canonicalize(tb, geom)
        entry = dst.lookup_entry(cf.digest, "other")
        assert entry is not None
        sol, _ = native.solve(tb)
        if sol is None:
            assert entry.verdict == cache_mod.UNSAT and entry.solution is None
        else:
            assert entry.verdict == cache_mod.SOLVED
            assert np.array_equal(canon.restore_solution(entry.solution, cf.transform), sol)
    assert dst.metrics()["canonical_dups"] == len(boards)


def test_routing_counts_equal_the_jax_engine():
    """The same five submissions through the JAX engine's front door and
    the port's: the same route per board, the same verdicts and solutions,
    and the same ``frontdoor`` counters (cache, probe, routes)."""
    from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JSolverConfig
    from distributed_sudoku_solver_tpu.serving.engine import SolverEngine as JSolverEngine
    from distributed_sudoku_solver_tpu.serving.frontdoor.router import (
        FrontDoorConfig as JFrontDoorConfig,
    )
    from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
    from tests.test_torch_native_parity import load_jax_native

    assert load_jax_native() and native.available()  # both front doors race natively
    bad = np.asarray(EASY_9).copy()
    bad[0, 0], bad[0, 1] = 5, 5
    tr = random_transform(SUDOKU_9, np.random.default_rng(3))
    hard = np.asarray(HARD_9[1])
    seq = [hard, apply_transform(hard, tr), _easy_open_board(), np.asarray(EASY_9), bad,
           apply_transform(bad, tr)]
    engines = [
        SolverEngine(config=SMALL, max_batch=8, frontdoor=FrontDoorConfig(),
                     device="cpu").start(),
        JSolverEngine(config=JSolverConfig(**vars(SMALL)), max_batch=8,
                      frontdoor=JFrontDoorConfig()).start(),
    ]
    got = []
    try:
        for eng in engines:
            rows = []
            for b in seq:
                j = eng.submit(b)
                assert j.wait(300), j.error
                rows.append((j.route, j.solved, j.unsat,
                             None if j.solution is None else np.asarray(j.solution).tolist()))
            fd = eng.metrics()["frontdoor"]
            got.append((rows, fd["routes"], fd["probe"], fd["cache"]["hits"],
                        fd["cache"]["canonical_dups"], fd["cache"]["entries"]))
    finally:
        for eng in engines:
            eng.stop(timeout=5)
    assert got[0] == got[1]
    assert [r[0] for r in got[0][0]] == ["device", "cache", "native", "propagation",
                                         "propagation", "cache"]


def test_failing_k2_answers_500_on_the_device_route(monkeypatch):
    """A K2 that cannot launch (``KernelError``) fails a front-door device
    job loudly: the request answers 500, the route counters say the job
    went to the device, and no fallback (native, composite) answers in
    its place.  Cache, propagation and native routes keep serving."""
    from distributed_sudoku_solver_tpu_torch.ops import cuda_build, cuda_step
    from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
    from distributed_sudoku_solver_tpu_torch.serving.http import ApiServer, StandaloneNode

    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        raise cuda_build.KernelError("fused_step.cu : nvcc fused_step.cu failed (1)")

    monkeypatch.setattr(cuda_step, "fused_rounds", failing)
    eng = SolverEngine(config=SolverConfig(min_lanes=8, stack_slots=24, step_impl="fused"),
                       max_batch=8, frontdoor=FrontDoorConfig(), device="cpu").start()
    api = ApiServer(StandaloneNode(eng), host="127.0.0.1", port=0, solve_timeout_s=120).start()

    def post(board):
        req = urllib.request.Request(f"http://127.0.0.1:{api.port}/solve", method="POST",
                                     data=json.dumps({"sudoku": board.tolist()}).encode())
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        status, body = post(np.asarray(HARD_9[0]))
        assert status == 500 and "KernelError" in body["error"], (status, body)
        assert calls, "the device route never dispatched K2"
        assert post(np.asarray(EASY_9))[0] == 201  # propagation
        assert post(_easy_open_board())[0] == 201  # native
        m = eng.metrics()
        fd = m["frontdoor"]
        assert fd["routes"] == {"cache": 0, "propagation": 1, "native": 1, "device": 1}
        assert fd["cache"]["entries"] == 2  # the failed job filled no entry
        assert m["faults"]["permanent_failures"] == 1
        assert m["faults"]["downgrades"] == {"fused_to_composite": 0, "lanes_halved": 0}
        assert m["fused_downgrades"] == 0 and m["faults"]["bisections"] == 0
    finally:
        api.stop()
        eng.stop(timeout=5)


@pytest.mark.parametrize("case", ["crossover", "thin"])
def test_fit_easy_score_equals_the_jax_package(case):
    """``learn.fit_easy_score`` is the JAX package's: on a journal whose
    native wall crosses the device's at score 100 the cut moves there; on
    a thin journal the default stays."""
    from distributed_sudoku_solver_tpu.serving.frontdoor import learn as jlearn
    from distributed_sudoku_solver_tpu_torch.serving.frontdoor import learn

    if case == "crossover":
        rows = []
        for s in (20, 40, 60, 80, 100):
            rows += [(s, "native", 1.0)] * 4 + [(s, "device", 5.0)] * 4
        for s in (120, 140):
            rows += [(s, "native", 50.0)] * 4 + [(s, "device", 5.0)] * 4
    else:
        rows = [(40, "native", 1.0)] * 3 + [(90, "device", 5.0)] * 20
    events = [{"kind": "route", "score": s, "route": r, "wall_ms": w, "solved": True,
               "unsat": False} for s, r, w in rows]
    got = learn.fit_easy_score(events, default=64, min_samples=8)
    assert got == jlearn.fit_easy_score(events, default=64, min_samples=8)
    assert got[0] == (100 if case == "crossover" else 64)


def test_learned_easy_score_reads_the_ports_ordering_trace(tmp_path):
    """A front-door engine with the ordering trace installed journals every
    route outcome with its probe score; ``learned_easy_score`` reads that
    journal as the JAX package's reads it."""
    from distributed_sudoku_solver_tpu.serving.frontdoor import learn as jlearn
    from distributed_sudoku_solver_tpu_torch.obs import ordertrace
    from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
    from distributed_sudoku_solver_tpu_torch.serving.frontdoor import learn

    path = str(tmp_path / "order.jsonl")
    rec = ordertrace.OrderTraceRecorder(path)
    boards = [np.asarray(HARD_9[0]), np.asarray(EASY_9), _easy_open_board()]
    try:
        with ordertrace.installed(rec):
            eng = SolverEngine(config=SMALL, max_batch=8, frontdoor=FrontDoorConfig(),
                               device="cpu").start()
            try:
                jobs = [eng.submit(b) for b in boards]
                for j in jobs:
                    assert j.wait(120) and j.solved, j.error
            finally:
                eng.stop(timeout=5)
    finally:
        rec.close()
    routes = [e for e in ordertrace.read_events(path) if e.get("kind") == "route"]
    assert sorted(e["route"] for e in routes) == ["device", "native", "propagation"]
    assert learn.learned_easy_score(path, min_samples=1) == jlearn.learned_easy_score(
        path, min_samples=1)


def test_http_stats_and_metrics_carry_the_front_door():
    """Over HTTP: ``/stats`` counts front-door answers as the node's work,
    ``/metrics`` carries the ``frontdoor`` section and the per-route
    histograms, and the Prometheus exposition stays promck-clean."""
    from distributed_sudoku_solver_tpu_torch.obs import promck
    from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
    from distributed_sudoku_solver_tpu_torch.serving.http import ApiServer, StandaloneNode

    eng = SolverEngine(config=SMALL, max_batch=8, frontdoor=FrontDoorConfig(),
                       device="cpu").start()
    api = ApiServer(StandaloneNode(eng), host="127.0.0.1", port=0, solve_timeout_s=120).start()

    def call(path, body=None):
        req = urllib.request.Request(f"http://127.0.0.1:{api.port}{path}",
                                     data=None if body is None else json.dumps(body).encode(),
                                     method="GET" if body is None else "POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            raw = resp.read().decode()
            return resp.status, (raw if "prometheus" in path else json.loads(raw))

    try:
        hard = np.asarray(HARD_9[0])
        tr = random_transform(SUDOKU_9, np.random.default_rng(9))
        for b in (hard, apply_transform(hard, tr), np.asarray(EASY_9)):
            assert call("/solve", {"sudoku": b.tolist()})[0] == 201
        st, stats = call("/stats")
        assert st == 200 and stats["all"]["solved"] == 3
        st, m = call("/metrics")
        assert m["frontdoor"]["routes"] == {"cache": 1, "propagation": 1, "native": 0,
                                            "device": 1}
        assert {"frontdoor_cache_ms", "frontdoor_propagation_ms",
                "frontdoor_device_ms"} <= set(m["hist"])
        st, text = call("/metrics?format=prometheus")
        assert st == 200 and "frontdoor" in text
        assert promck.check_text(text) == []
    finally:
        api.stop()
        eng.stop(timeout=5)
