"""Twin of ``tests/test_simnet.py`` on the port's cluster node.

The same deterministic scenarios over the port's in-memory ``SimNet`` on a
virtual clock, with port engines on the CPU; the conftest purity guard
(``simnet`` marker) holds the port's frames to the same contract as the
JAX package's: no real socket, no ``time.sleep``, no bare
``time.monotonic``.  The chaos soak is also run beside the JAX package's
on the same ``FaultSchedule`` seed and corpus, and their solutions must
agree with each other and with the native oracle.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu_torch.cluster.node import (
    ClusterConfig,
    ClusterNode,
    _Exec,
    pack_rows,
)
from distributed_sudoku_solver_tpu_torch.cluster.simnet import SimNet, wait_until
from distributed_sudoku_solver_tpu_torch.cluster.wire import WireError
from distributed_sudoku_solver_tpu_torch.obs import lockdep
from distributed_sudoku_solver_tpu_torch.serving.engine import Job as EngineJob
from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
from distributed_sudoku_solver_tpu_torch.serving.faults import FaultSchedule
from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution, solve_oracle
from distributed_sudoku_solver_tpu_torch.utils.puzzles import EASY_9, HARD_9

from tests.test_torch_cluster import a_geom, oracle_solve_fn

pytestmark = pytest.mark.simnet


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs six workers on a small box, and the
    nodes' own threads already share it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _port_lockdep():
    """The port's lock witness, armed as ``test_torch_engine.py`` arms it."""
    with lockdep.installed(lockdep.manifest_witness(strict=True)) as w:
        yield w


# Virtual-clock cluster config: the margins that make the socket lane's
# FAST config "err well on the side of patience" (its module note) are
# unnecessary here — detection takes 2.0 *virtual* seconds however loaded
# the CI machine is.
SIM = ClusterConfig(
    heartbeat_s=0.25,
    fail_factor=8.0,
    io_timeout_s=2.0,
    needwork=False,
    progress_interval_s=0.0,
    retry_delay_s=0.1,
    tombstone_probe_s=600.0,
)


@pytest.fixture
def net():
    n = SimNet()
    n.nodes = []  # sim_node() registers for teardown
    yield n
    for node in n.nodes:
        node.kill()
        node.engine.stop(timeout=1)
    n.close()


def sim_node(net, anchor=None, config=SIM, engine=None):
    eng = engine or SolverEngine(
        device="cpu",
        solve_fn=oracle_solve_fn(), batch_window_s=0.001
    ).start()
    node = ClusterNode(
        eng, anchor=anchor, config=config, transport=net.transport(),
        clock=net.clock,
    ).start()
    net.nodes.append(node)
    return node


def flight_engine():
    """Real chunked-flight engine (same shapes as test_cluster's
    _flight_node, so compiled programs are shared): part re-entry needs
    submit_roots, which the oracle solve_fn path rejects."""
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig

    return SolverEngine(
        device="cpu",
        config=SolverConfig(min_lanes=4, stack_slots=32, branch="first"),
        chunk_steps=1,
        batch_window_s=0.001,
    ).start()


def form_ring(net, k, config=SIM, engines=None):
    nodes = [sim_node(net, engine=(engines or {}).get(0), config=config)]
    for i in range(1, k):
        nodes.append(
            sim_node(
                net, anchor=nodes[0].addr, engine=(engines or {}).get(i),
                config=config,
            )
        )
    assert wait_until(
        net, lambda: all(len(n.network) == k for n in nodes), timeout=60
    ), "ring never formed"
    return nodes


# -- transport contract (SimNet itself) --------------------------------------


def test_simnet_send_request_and_partition_semantics(net):
    got = []

    t1 = net.transport()
    a1 = t1.bind("127.0.0.1", 0)
    t1.serve(lambda m: got.append(m) or (
        {"method": "PONG", "n": m["n"] + 1} if m["method"] == "PING" else None
    ))
    t2 = net.transport()
    t2.bind("127.0.0.1", 0)

    t2.send(a1, {"method": "HELLO"}, 2.0)
    net.settle()
    assert got and got[0]["method"] == "HELLO"
    assert net.transport().request(a1, {"method": "PING", "n": 1}, 2.0)["n"] == 2

    # Unbound peer: connect refused, delivery unambiguous.
    with pytest.raises(WireError) as ei:
        t2.send(("127.0.0.1", 9999), {"method": "X"}, 2.0)
    assert ei.value.ambiguous_delivery is False

    # Partitioned link: connect timeout, delivery unambiguous; heal restores.
    net.partition(["127.0.0.1:7001"], ["127.0.0.1:7000"])
    with pytest.raises(WireError):
        t2.send(a1, {"method": "X"}, 2.0)
    assert net.counters["blocked"] == 1
    net.heal()
    t2.send(a1, {"method": "AGAIN"}, 2.0)
    net.settle()
    assert got[-1]["method"] == "AGAIN"


def test_simnet_drop_dup_delay_faults(net):
    got = []
    srv = net.transport()
    addr = srv.bind("127.0.0.1", 0)
    srv.serve(lambda m: got.append(m["i"]))
    cli = net.transport()
    cli.bind("127.0.0.1", 0)
    link = "link:127.0.0.1:7001->127.0.0.1:7000:M"
    net.set_schedule(
        FaultSchedule.at({link: {0: "drop", 1: "dup", 2: "delay"}})
    )
    # Event 0: dropped — the sender sees an AMBIGUOUS WireError (bytes were
    # written; its retry would be at-least-once), and nothing is delivered.
    with pytest.raises(WireError) as ei:
        cli.send(addr, {"method": "M", "i": 0}, 2.0)
    assert ei.value.ambiguous_delivery is True
    # Event 1: duplicated — one send, two deliveries (second one delayed).
    cli.send(addr, {"method": "M", "i": 1}, 2.0)
    # Event 2: delayed past event 3 — reordering.
    cli.send(addr, {"method": "M", "i": 2}, 2.0)
    cli.send(addr, {"method": "M", "i": 3}, 2.0)
    assert wait_until(net, lambda: len(got) == 4, timeout=5)
    assert 0 not in got
    assert sorted(got) == [1, 1, 2, 3]
    assert got.index(3) < got.index(2), "delay fault did not reorder"
    assert net.counters["dropped"] == 1
    assert net.counters["duplicated"] == 1
    assert net.counters["delayed"] == 1


def test_simnet_virtual_clock_sleep_and_request_timeout(net):
    t = net.transport()
    addr = t.bind("127.0.0.1", 0)
    t.serve(lambda m: None)  # never replies

    woke = []

    def sleeper():
        net.clock.sleep(1.0)
        woke.append(net.clock.now())

    th = threading.Thread(target=sleeper, daemon=True)
    th.start()
    net.settle()
    assert not woke
    net.advance(0.5)
    assert not woke
    net.advance(0.6)
    th.join(5)
    assert woke and woke[0] >= 1.0

    # request() times out on VIRTUAL time — and a no-reply timeout is
    # ambiguous (the request may have been processed).
    err = []

    def requester():
        try:
            net.transport().request(addr, {"method": "Q"}, timeout=1.0)
        except WireError as e:
            err.append(e)

    th = threading.Thread(target=requester, daemon=True)
    th.start()
    assert wait_until(net, lambda: bool(err), timeout=5)
    assert err[0].ambiguous_delivery is True


# -- ported membership scenarios (socket lane's timing-fragile trio) ----------


def test_ring_formation_and_dispatch(net):
    a, b, c = form_ring(net, 3)
    assert all(n.coordinator == a.addr_s for n in (a, b, c))
    jobs = [a.submit(EASY_9) for _ in range(6)]
    assert wait_until(net, lambda: all(j.done.is_set() for j in jobs), timeout=60)
    assert all(j.solved and is_valid_solution(j.solution) for j in jobs)
    remote = b.engine.stats()["jobs_done"] + c.engine.stats()["jobs_done"]
    assert remote > 0, "least-outstanding dispatch never left the local engine"


def test_coordinator_death_promotes_detector(net):
    """Port of the socket lane's promotion scenario: same protocol, but
    `wait 2 s of detection` is a virtual advance, not wall-clock hope."""
    a, b, c = form_ring(net, 3)
    a.kill()
    assert wait_until(
        net,
        lambda: all(
            len(n.network) == 2 and n.coordinator != a.addr_s for n in (b, c)
        ),
        timeout=60,
    )
    assert b.coordinator == c.coordinator
    assert b.net_term == 1, "promotion must open a new term"


def test_false_death_eviction_and_rejoin(net):
    """The false-death scenario the socket lane could only avoid (its FAST
    config 'errs well on the side of patience'): a live member whose
    heartbeats are suppressed long enough IS evicted — and then heals:
    the coordinator keeps probing the tombstoned member with its view, the
    evictee rejoins through it, and partitions_healed counts the event."""
    a, b, c = form_ring(net, 3)
    net.partition([c.addr_s], [a.addr_s, b.addr_s])
    assert wait_until(
        net,
        lambda: len(a.network) == 2 and c.addr_s not in a.network,
        timeout=120,
    ), "suppressed heartbeats never produced the eviction"
    assert c.addr_s in a._evicted  # tombstoned: probed, not forgotten
    net.heal()
    assert wait_until(
        net,
        lambda: all(len(n.network) == 3 for n in (a, b, c))
        and all(n.coordinator == a.addr_s for n in (a, b, c)),
        timeout=120,
    ), "evicted-but-alive member never rejoined after heal"
    m = a.metrics_view()["cluster"]["faults"]
    assert m["partitions_healed"] >= 1
    # And the cluster still serves.
    job = a.submit(EASY_9)
    assert wait_until(net, lambda: job.done.is_set(), timeout=60)
    assert job.solved


def test_reexecution_after_member_death(net):
    """Port of the socket lane's ledger re-execution test: the in-flight
    window is held open by an Event-gated solve_fn instead of a real
    sleep, and detection runs on the virtual clock."""
    gate = threading.Event()
    base = oracle_solve_fn()

    def gated(grids, geom, cfg):
        gate.wait(30)  # bounded real wait, not time.sleep; never load-bearing
        return base(grids, geom, cfg)

    slow_engine = SolverEngine(device="cpu", solve_fn=gated, batch_window_s=0.001).start()
    a = sim_node(net)
    b = sim_node(net, anchor=a.addr, engine=slow_engine)
    assert wait_until(
        net, lambda: len(a.network) == 2 and len(b.network) == 2, timeout=60
    )
    job = a._submit_remote(np.asarray(EASY_9, dtype=np.int32), b.addr_s)
    assert wait_until(net, lambda: len(b._execs) == 1, timeout=30), (
        "TASK never landed on the member"
    )
    b.kill()  # TASK is in b's gated engine; b goes silent mid-execution
    assert wait_until(net, lambda: job.done.is_set(), timeout=120), (
        "forwarded job must be re-executed after member death"
    )
    assert job.solved
    assert is_valid_solution(job.solution)
    gate.set()


def test_part_deadline_rehomes_from_wedged_peer(net):
    """Satellite: the --part-deadline path pinned deterministically.  A part
    shed to a peer that stays ALIVE in the view (so view-change recovery
    never fires) blows the wall-clock deadline and is re-homed locally;
    the original executor is cancelled (first-win keeps the aggregate
    sound if it were to answer later)."""
    cfg = ClusterConfig(
        heartbeat_s=0.25,
        fail_factor=64.0,  # nobody dies in this test
        io_timeout_s=2.0,
        needwork=False,
        progress_interval_s=0.0,
        part_deadline_s=1.0,
        tombstone_probe_s=600.0,
    )
    a = sim_node(net, engine=flight_engine(), config=cfg)
    b = sim_node(net, anchor=a.addr, config=cfg)
    assert wait_until(
        net, lambda: len(a.network) == 2 and len(b.network) == 2, timeout=60
    )
    g = np.asarray(EASY_9, np.int32)
    ex = _Exec(a, EngineJob(uuid="x-deadline", grid=g, geom=a_geom(g)),
               on_final=lambda r: None)
    with a._lock:
        a._execs["x-deadline"] = ex
    # All-ones candidate rows: every cell pinned to digit 1 — an instantly
    # unsat subspace, so the local re-entry resolves in one chunk.
    rows = pack_rows(np.ones((2, 9, 9), np.uint32))
    assert ex.add_part("x-deadline#p1", b.addr_s, rows_packed=rows, config=None)
    net.advance(0.5)
    with ex.lock:
        assert not ex.parts["x-deadline#p1"]["rehomed"], "re-homed early"
    assert wait_until(
        net,
        lambda: a.rehomed_parts >= 1 and ex.parts["x-deadline#p1"]["done"],
        timeout=60,
    ), "blown deadline never re-homed the part"
    with ex.lock:
        assert ex.parts["x-deadline#p1"]["exhausted"]
    # First-win: the slow-but-alive original executor was cancelled.
    assert wait_until(
        net, lambda: "x-deadline#p1" in b.engine._cancelled, timeout=30
    )
    assert a.metrics_view()["cluster"]["faults"]["rehomed_parts"] >= 1


# -- at-least-once idempotence ------------------------------------------------


def test_duplicate_task_executes_once(net):
    """Acceptance: the same TASK frame delivered twice changes no counts —
    one execution, one SOLUTION, dedupe counter incremented."""
    a, b = form_ring(net, 2)
    link = f"link:{a.addr_s}->{b.addr_s}:TASK"
    net.set_schedule(FaultSchedule.at({link: {0: "dup"}}))
    job = a._submit_remote(np.asarray(EASY_9, np.int32), b.addr_s)
    assert wait_until(net, lambda: job.done.is_set(), timeout=60)
    assert job.solved and is_valid_solution(job.solution)
    assert wait_until(
        net, lambda: b.duplicates_dropped.get("TASK", 0) == 1, timeout=30
    ), "duplicate TASK was not detected"
    assert b.engine.stats()["jobs_done"] == 1, "duplicate TASK was executed"
    assert net.counters["duplicated"] == 1


def test_duplicate_solution_changes_no_counts(net):
    """Acceptance twin: a duplicated SOLUTION finalizes once and must not
    double-decrement the outstanding ledger (placement accounting)."""
    a, b = form_ring(net, 2)
    link = f"link:{b.addr_s}->{a.addr_s}:SOLUTION"
    net.set_schedule(FaultSchedule.at({link: {0: "dup"}}))
    job = a._submit_remote(np.asarray(EASY_9, np.int32), b.addr_s)
    assert wait_until(net, lambda: job.done.is_set(), timeout=60)
    assert job.solved
    assert wait_until(
        net, lambda: a.duplicates_dropped.get("SOLUTION", 0) == 1, timeout=30
    ), "duplicate SOLUTION was not detected"
    with a._lock:
        assert a._outstanding.get(b.addr_s, 0) == 0, (
            "duplicate SOLUTION skewed least-outstanding accounting"
        )
    assert job.uuid not in a._ledger


def test_dropped_solution_is_retried(net):
    """The sender half of at-least-once: a SOLUTION lost after bytes were
    written (ambiguous WireError) is re-sent under the bounded budget —
    without the retry, a drop-faulted link would strand the origin's
    ledger entry forever while the worker stays healthy in the view."""
    a, b = form_ring(net, 2)
    link = f"link:{b.addr_s}->{a.addr_s}:SOLUTION"
    net.set_schedule(FaultSchedule.at({link: {0: "drop"}}))
    job = a._submit_remote(np.asarray(EASY_9, np.int32), b.addr_s)
    assert wait_until(net, lambda: job.done.is_set(), timeout=60), (
        "dropped SOLUTION never retried"
    )
    assert job.solved and is_valid_solution(job.solution)
    assert net.counters["dropped"] == 1
    assert job.uuid not in a._ledger


def test_stale_view_and_duplicate_join_rejected(net):
    a, b = form_ring(net, 2)
    term, epoch = b.net_term, b.net_epoch
    # Replayed older view: rejected, counted.
    net.inject(
        b.addr,
        {
            "method": "UPDATE_NETWORK",
            "network": [b.addr_s],
            "coordinator": b.addr_s,
            "term": term,
            "epoch": max(0, epoch - 1),
        },
    )
    assert wait_until(net, lambda: b.stale_views_rejected >= 1, timeout=10)
    assert len(b.network) == 2 and b.coordinator == a.addr_s
    # Replayed JOIN_REQ: no epoch bump, no duplicate member.
    e0 = a.net_epoch
    for _ in range(3):
        net.inject(a.addr, {"method": "JOIN_REQ", "addr": b.addr_s})
    assert wait_until(
        net, lambda: a.duplicates_dropped.get("JOIN_REQ", 0) == 3, timeout=10
    )
    assert a.net_epoch == e0
    assert sorted(set(a.network)) == sorted(a.network)
    # Stale-term NODE_FAILED: a death verdict formed under a superseded
    # term is void (does not evict the member it names).
    net.inject(
        a.addr,
        {"method": "NODE_FAILED", "addr": b.addr_s, "term": -1, "epoch": 0},
    )
    net.settle()
    assert b.addr_s in a.network


# -- split-brain --------------------------------------------------------------


def test_split_brain_partition_heals_to_one_coordinator(net):
    """Acceptance: symmetric partition isolates the coordinator; the other
    side promotes (new term); on heal the two live coordinators converge —
    the lower (term, epoch) holder demotes, rejoins through the winner,
    and its in-flight part re-homes through the existing orphan path.
    All asserted via the /metrics cluster.faults counters."""
    engines = {0: flight_engine()}
    a, b, c, d, e = form_ring(net, 5, engines=engines)
    assert a.coordinator == a.addr_s
    # One in-flight part shed to b, rows retained at a (the shedder).
    g = np.asarray(EASY_9, np.int32)
    ex = _Exec(a, EngineJob(uuid="x-split", grid=g, geom=a_geom(g)),
               on_final=lambda r: None)
    with a._lock:
        a._execs["x-split"] = ex
    rows = pack_rows(np.ones((2, 9, 9), np.uint32))
    assert ex.add_part("x-split#p1", b.addr_s, rows_packed=rows, config=None)

    net.partition([a.addr_s], [n.addr_s for n in (b, c, d, e)])
    # Majority side: b (a's ring watcher) promotes into term 1 and evicts a.
    assert wait_until(
        net,
        lambda: b.coordinator == b.addr_s
        and b.net_term == 1
        and all(n.coordinator == b.addr_s for n in (c, d, e))
        and a.addr_s not in b.network,
        timeout=240,
    ), "partitioned majority never promoted a new coordinator"
    # Minority side: a (still a coordinator, lower view) evicts everyone it
    # cannot reach — and re-homes the part it had shed to b via the orphan
    # path (b left a's view).
    assert wait_until(
        net,
        lambda: len(a.network) == 1 and a.rehomed_parts >= 1
        and ex.parts["x-split#p1"]["done"],
        timeout=240,
    ), "isolated coordinator never re-homed its in-flight part"
    assert a.net_term == 0 and b.net_term == 1  # two live coordinators

    net.heal()
    assert wait_until(
        net,
        lambda: all(
            len(n.network) == 5 and n.coordinator == b.addr_s
            for n in (a, b, c, d, e)
        ),
        timeout=240,
    ), "healed partition never converged to one coordinator"
    fa = a.metrics_view()["cluster"]["faults"]
    fb = b.metrics_view()["cluster"]["faults"]
    assert fa["demotions"] == 1, "the losing coordinator must demote"
    assert fa["rehomed_parts"] >= 1
    assert fb["partitions_healed"] >= 1, "winner must re-admit the loser"
    assert fa["stale_views_rejected"] + fb["stale_views_rejected"] >= 1
    # The healed ring serves, and placement accounting survived the churn.
    jobs = [a.submit(EASY_9) for _ in range(5)]
    assert wait_until(
        net, lambda: all(j.done.is_set() and j.solved for j in jobs), timeout=120
    )


# -- the seeded chaos soak ----------------------------------------------------


def test_chaos_soak_drop_dup_reorder_partition(net):
    """Acceptance: a 5-node simulated ring solves a corpus while every link
    Bernoulli-drops/duplicates/delays at >=10% per event AND two
    partitions (one member, then the coordinator — a full split-brain
    cycle) strike mid-run.  Zero lost jobs; solutions bit-identical to the
    fault-free oracle; no real sockets, no wall-clock sleeps (enforced by
    the simnet marker guard)."""
    soak_cfg = ClusterConfig(
        heartbeat_s=0.25,
        fail_factor=8.0,
        io_timeout_s=2.0,
        needwork=False,
        progress_interval_s=0.0,
        send_retries=4,  # rate-0.12 links: bound the odds of an all-drops run
        retry_delay_s=0.1,
        tombstone_probe_s=600.0,
    )
    nodes = form_ring(net, 5, config=soak_cfg)
    a, b, c, d, e = nodes
    # Corpus: EASY_9 + the two quick HARD boards.  HARD_9[2] is excluded on
    # purpose — it costs ~40 s in the native oracle, which would turn this
    # protocol soak into a solver benchmark (and each engine execution of
    # it would stall a 2-core CI box for minutes).
    boards = [np.asarray(EASY_9, np.int32)] + [
        np.asarray(h, np.int32) for h in HARD_9[:2]
    ]
    expect = [solve_oracle(g, a_geom(g)) for g in boards]
    assert all(s is not None for s in expect)

    # Ring formed cleanly; now turn on the weather.
    net.set_schedule(
        FaultSchedule.seeded(seed=11, rate=0.12, kinds=("drop", "dup", "delay"))
    )
    jobs = [(i, a.submit(boards[i % len(boards)])) for i in range(6)]

    # Partition a non-coordinator member long enough for eviction, heal.
    net.partition([d.addr_s], [n.addr_s for n in nodes if n is not d])
    assert wait_until(net, lambda: d.addr_s not in a.network, timeout=240)
    jobs += [(i, a.submit(boards[i % len(boards)])) for i in range(6, 12)]
    net.heal()
    assert wait_until(
        net, lambda: all(len(n.network) == 5 for n in nodes), timeout=240
    ), "member partition never healed"

    # Partition the coordinator: full split-brain cycle under load.
    net.partition([a.addr_s], [n.addr_s for n in nodes[1:]])
    assert wait_until(net, lambda: b.net_term >= 1, timeout=240), (
        "coordinator partition never promoted"
    )
    jobs += [(i, a.submit(boards[i % len(boards)])) for i in range(12, 18)]
    net.heal()
    assert wait_until(
        net,
        lambda: all(
            len(n.network) == 5 and n.coordinator == nodes[1].addr_s
            for n in nodes
        ),
        timeout=240,
    ), "split brain never healed"

    assert wait_until(
        net, lambda: all(j.done.is_set() for _, j in jobs), timeout=600
    ), (
        f"lost jobs: "
        f"{[(i, j.error) for i, j in jobs if not j.done.is_set()]}"
    )
    for i, j in jobs:
        assert j.solved, f"job {i} ended unsolved: {j.error!r}"
        assert np.array_equal(j.solution, expect[i % len(boards)]), (
            f"job {i} solution not bit-identical to the fault-free run"
        )
    # The soak must actually have exercised the fault plane.
    assert net.counters["dropped"] > 0
    assert net.counters["duplicated"] > 0
    assert net.counters["delayed"] > 0
    assert net.counters["blocked"] > 0
    total_faults = sum(
        sum(n.duplicates_dropped.values())
        + n.stale_views_rejected
        + n.partitions_healed
        + n.demotions
        for n in nodes
    )
    assert total_faults > 0, "chaos soak never tripped a cluster fault counter"
    with a._lock:
        assert not a._ledger, "resolved jobs left ledger entries behind"
        assert all(v == 0 for v in a._outstanding.values()), (
            f"placement accounting skewed: {a._outstanding}"
        )


def _chaos_soak_solutions(pkg) -> list:
    """The soak's member-then-coordinator partition cycle under seeded
    weather (seed 11, rate 0.12), run on package ``pkg`` (the JAX package
    or the port): the 18 jobs' solutions in submission order."""
    import importlib

    node_mod = importlib.import_module(f"{pkg}.cluster.node")
    simnet_mod = importlib.import_module(f"{pkg}.cluster.simnet")
    engine_mod = importlib.import_module(f"{pkg}.serving.engine")
    faults_mod = importlib.import_module(f"{pkg}.serving.faults")
    oracle_mod = importlib.import_module(f"{pkg}.utils.oracle")

    def solve_fn(grids, geom, cfg):
        g = np.asarray(grids)
        sols = [oracle_mod.solve_oracle(g[i], geom) for i in range(g.shape[0])]
        solved = np.asarray([s is not None for s in sols])
        return SimpleNamespace(
            solved=solved, unsat=~solved, nodes=np.full(g.shape[0], 7),
            solution=np.stack([s if s is not None else np.zeros_like(g[0]) for s in sols]),
        )

    cfg = node_mod.ClusterConfig(
        heartbeat_s=0.25, fail_factor=8.0, io_timeout_s=2.0, needwork=False,
        progress_interval_s=0.0, send_retries=4, retry_delay_s=0.1,
        tombstone_probe_s=600.0,
    )
    kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
    net = simnet_mod.SimNet()
    nodes = []
    try:
        for i in range(5):
            eng = engine_mod.SolverEngine(solve_fn=solve_fn, batch_window_s=0.001, **kw).start()
            nodes.append(node_mod.ClusterNode(
                eng, anchor=nodes[0].addr if nodes else None, config=cfg,
                transport=net.transport(), clock=net.clock,
            ).start())
        wait = simnet_mod.wait_until
        assert wait(net, lambda: all(len(n.network) == 5 for n in nodes), timeout=60)
        a, b, c, d, e = nodes
        boards = [np.asarray(EASY_9, np.int32)] + [np.asarray(h, np.int32) for h in HARD_9[:2]]
        net.set_schedule(
            faults_mod.FaultSchedule.seeded(seed=11, rate=0.12, kinds=("drop", "dup", "delay"))
        )
        jobs = [a.submit(boards[i % 3]) for i in range(6)]
        net.partition([d.addr_s], [n.addr_s for n in nodes if n is not d])
        assert wait(net, lambda: d.addr_s not in a.network, timeout=240)
        jobs += [a.submit(boards[i % 3]) for i in range(6, 12)]
        net.heal()
        assert wait(net, lambda: all(len(n.network) == 5 for n in nodes), timeout=240)
        net.partition([a.addr_s], [n.addr_s for n in nodes[1:]])
        assert wait(net, lambda: b.net_term >= 1, timeout=240)
        jobs += [a.submit(boards[i % 3]) for i in range(12, 18)]
        net.heal()
        assert wait(net, lambda: all(j.done.is_set() for j in jobs), timeout=600), "lost jobs"
        assert all(j.solved for j in jobs)
        return [np.asarray(j.solution) for j in jobs]
    finally:
        for n in nodes:
            n.kill()
            n.engine.stop(timeout=1)
        net.close()


def test_chaos_soak_solutions_equal_jax_run_and_native_oracle():
    """The port's soak and the JAX package's, on the same ``FaultSchedule``
    seed and corpus, lose no job and return the same solutions, which are
    the native oracle's."""
    from distributed_sudoku_solver_tpu_torch import native

    port = _chaos_soak_solutions("distributed_sudoku_solver_tpu_torch")
    ref = _chaos_soak_solutions("distributed_sudoku_solver_tpu")
    assert len(port) == len(ref) == 18
    boards = [np.asarray(EASY_9, np.int32)] + [np.asarray(h, np.int32) for h in HARD_9[:2]]
    for i, (p, r) in enumerate(zip(port, ref)):
        assert np.array_equal(p, r), f"job {i}: port and JAX solutions differ"
        if native.available():
            sol, _ = native.solve(boards[i % 3])
            assert np.array_equal(p, sol), f"job {i}: not the native oracle's solution"
        assert is_valid_solution(p)
