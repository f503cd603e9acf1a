"""Twin of ``tests/test_dht.py`` on the port's DHT plane.

The hash ring, gossip membership and cluster cache (``cluster/dht/``) and
their wiring into the port's node: cache-affine routing, an L2 hit of a
transformed board at another member (bit-exact in the client's frame),
negative entries, suspicion and resurrection.  The ``slow`` 500-node soak
stays ``slow``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu_torch.cluster.dht.cluster_cache import ClusterCache
from distributed_sudoku_solver_tpu_torch.cluster.dht.hashring import HashRing
from distributed_sudoku_solver_tpu_torch.cluster.dht.membership import (
    ALIVE,
    DEAD,
    SUSPECT,
    Gossip,
)
from distributed_sudoku_solver_tpu_torch.cluster.node import ClusterConfig
from distributed_sudoku_solver_tpu_torch.cluster.simnet import wait_until
from distributed_sudoku_solver_tpu_torch.cluster.wire import WireError
from distributed_sudoku_solver_tpu_torch.obs import lockdep
from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
from distributed_sudoku_solver_tpu_torch.serving.faults import FaultSchedule
from distributed_sudoku_solver_tpu_torch.serving.frontdoor.canonical import (
    apply_transform,
    canonicalize,
    random_transform,
)
from distributed_sudoku_solver_tpu_torch.serving.frontdoor.router import FrontDoorConfig
from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution, solve_oracle
from distributed_sudoku_solver_tpu_torch.utils.puzzles import EASY_9, HARD_9

from tests.test_torch_cluster import a_geom, oracle_solve_fn
from tests.test_torch_simnet import SIM, form_ring, net, sim_node  # noqa: F401 - fixtures

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



# -- unit lane: HashRing ------------------------------------------------------


def test_hashring_deterministic_and_bounded_movement():
    members = [f"10.0.0.{i}:7000" for i in range(8)]
    r1, r2 = HashRing(vnodes=32), HashRing(vnodes=32)
    for m in members:
        r1.add(m)
    for m in reversed(members):  # insertion order must not matter
        r2.add(m)
    keys = [f"digest-{i:04x}" for i in range(2000)]
    owners = [r1.owner(k) for k in keys]
    assert owners == [r2.owner(k) for k in keys], (
        "converged views must agree on ownership regardless of join order"
    )
    # Every member owns a nontrivial share (vnode spreading).
    share = {m: owners.count(m) for m in members}
    assert all(share[m] > 0 for m in members), f"starved member: {share}"

    # A join moves only the arcs adjacent to the new member's points:
    # keys NOT owned by the joiner keep their old owner.
    r1.add("10.0.0.99:7000")
    moved = 0
    for k, old in zip(keys, owners):
        now = r1.owner(k)
        if now != old:
            moved += 1
            assert now == "10.0.0.99:7000", (
                f"key {k} moved {old} -> {now}: movement must only flow "
                "to the joining member"
            )
    # Expected movement ~ 1/9 of keys; assert a generous 3x bound.
    assert 0 < moved < len(keys) // 3
    # And the leave is the exact inverse.
    r1.remove("10.0.0.99:7000")
    assert [r1.owner(k) for k in keys] == owners

    # Replica sets: distinct members, owner first.
    reps = r1.replicas(keys[0], 3)
    assert reps[0] == r1.owner(keys[0])
    assert len(reps) == len(set(reps)) == 3

    summary = r1.summary()
    assert summary["members"] == 8
    assert abs(sum(summary["share"].values()) - 1.0) < 1e-9


def test_hashring_empty_and_single():
    r = HashRing()
    assert r.owner("x") is None and r.replicas("x") == []
    assert r.summary() == {"members": 0, "points": 0, "share": {}}
    r.add("a:1")
    assert r.owner("anything") == "a:1"
    assert r.replicas("anything", 5) == ["a:1"]


# -- unit lane: Gossip --------------------------------------------------------


def _gossip(addr="a:1", suspicion_s=2.0, piggyback=4):
    t = [0.0]
    g = Gossip(addr, lambda: t[0], suspicion_s=suspicion_s, piggyback=piggyback)
    return g, t


def test_gossip_suspicion_death_and_resurrection():
    g, t = _gossip()
    g.reconcile(["a:1", "b:1", "c:1"])
    assert g.state_of("b:1") == ALIVE and g.is_healthy("b:1")

    g.on_probe_fail("b:1")
    assert g.state_of("b:1") == SUSPECT
    assert not g.is_healthy("b:1")
    # Suspicion has not expired: no death reported yet.
    t[0] = 1.0
    _, newly_dead = g.tick()
    assert newly_dead == []
    # An ACK inside the window refutes the suspicion.
    g.on_ack("b:1")
    assert g.state_of("b:1") == ALIVE
    # Suspect again and let it expire: reported DEAD exactly once.
    g.on_probe_fail("b:1")
    t[0] = 4.0
    _, newly_dead = g.tick()
    assert newly_dead == ["b:1"]
    assert g.state_of("b:1") == DEAD
    _, again = g.tick()
    assert again == []
    # DEAD members are never probe targets.
    targets = {g.tick()[0] for _ in range(4)}
    assert targets == {"c:1"}
    # The authoritative view re-admitting the member IS the refutation.
    g.reconcile(["a:1", "b:1", "c:1"])
    assert g.state_of("b:1") == ALIVE
    m = g.metrics()
    assert m["suspicions"] == 2 and m["deaths"] == 1 and m["resurrections"] == 1


def test_gossip_incarnation_order_and_self_refutation():
    g, _ = _gossip()
    g.reconcile(["a:1", "b:1"])
    # Higher incarnation wins; stale (lower) incarnations are ignored.
    g.merge([{"m": "b:1", "s": SUSPECT, "i": 0}])
    assert g.state_of("b:1") == SUSPECT
    g.merge([{"m": "b:1", "s": ALIVE, "i": 1}])
    assert g.state_of("b:1") == ALIVE
    g.merge([{"m": "b:1", "s": DEAD, "i": 0}])
    assert g.state_of("b:1") == ALIVE, "stale incarnation must not regress state"
    assert g.metrics()["stale_ignored"] == 1
    # Tie: DEAD > SUSPECT > ALIVE.
    g.merge([{"m": "b:1", "s": DEAD, "i": 1}])
    assert g.state_of("b:1") == DEAD
    # Seeing ourselves suspected refutes by bumping our incarnation,
    # which rides the next updates() batch.
    g.merge([{"m": "a:1", "s": SUSPECT, "i": 0}])
    ups = g.updates()
    assert ups[0]["m"] == "a:1" and ups[0]["i"] == 1 and ups[0]["s"] == ALIVE
    assert g.metrics()["refutations"] == 1


def test_gossip_piggyback_is_bounded():
    g, _ = _gossip(piggyback=4)
    g.reconcile([f"m{i}:1" for i in range(32)] + ["a:1"])
    for i in range(16):
        g.on_probe_fail(f"m{i}:1")  # 16 fresh state changes to spread
    ups = g.updates()
    assert len(ups) <= 4, f"piggyback exceeded its bound: {len(ups)}"
    assert ups[0]["m"] == "a:1", "self entry must always lead the batch"
    # Spread budgets drain: repeated batches eventually carry only self.
    for _ in range(64):
        g.updates()
    assert len(g.updates()) == 1


# -- unit lane: ClusterCache --------------------------------------------------


class _FakeClock:
    def __init__(self):
        self.t = 0.0
        self.slept = []

    def now(self):
        return self.t

    def sleep(self, dt):
        self.slept.append(dt)
        self.t += dt


def test_cluster_cache_owner_routing_and_negative_hits():
    sent = []

    def request_fn(owner, frame, timeout):
        sent.append((owner, frame))
        raise WireError("owner unreachable")

    cc = ClusterCache(
        "a:1",
        owner_fn=lambda d: "b:1" if d.startswith("remote") else "a:1",
        request_fn=request_fn,
        put_fn=lambda o, f: None,
        clock=_FakeClock(),
        uuid_fn=lambda: "u-1",
        capacity=2,
    )
    # Remote miss path: a WireError is a miss, never an exception.
    assert cc.lookup("remote-1") is None
    assert sent[0][0] == "b:1" and sent[0][1]["method"] == "CACHE_GET"
    m = cc.metrics()
    assert m["remote_errors"] == 1 and m["misses"] == 1

    # Local shard: store, hit, negative hit, LRU eviction.
    cc.store("local-1", {"verdict": "solved", "solution": [[1]]})
    cc.store("local-2", {"verdict": "unsat", "solution": None})
    assert cc.lookup("local-1")["verdict"] == "solved"
    assert cc.lookup("local-2")["verdict"] == "unsat"
    assert cc.metrics()["negative_hits"] == 1
    cc.store("local-3", {"verdict": "solved", "solution": [[2]]})  # evicts LRU
    assert len(cc) == 2 and cc.metrics()["evictions"] == 1


def test_cluster_cache_put_retry_budget():
    clock = _FakeClock()
    attempts = []

    def put_fn(owner, frame):
        attempts.append(frame["uuid"])
        if len(attempts) < 3:
            raise WireError("flaky link")

    cc = ClusterCache(
        "a:1",
        owner_fn=lambda d: "b:1",
        request_fn=lambda o, f, t: {},
        put_fn=put_fn,
        clock=clock,
        uuid_fn=lambda: "put-uuid",
        put_retries=2,
        retry_delay_s=0.5,
    )
    # Drive the retry loop synchronously (store() runs it on a daemon
    # thread; the loop itself is the unit under test).
    cc._put_loop("b:1", {"method": "CACHE_PUT", "uuid": "put-uuid", "digest": "d", "entry": {}})
    assert attempts == ["put-uuid"] * 3, "every attempt must reuse the uuid"
    assert clock.slept == [0.5, 0.5]
    assert cc.metrics()["puts_sent"] == 1 and cc.metrics()["puts_failed"] == 0
    # Budget exhaustion counts a lost fill, not an error.
    attempts.clear()

    def always_fail(owner, frame):
        attempts.append(1)
        raise WireError("down")

    cc._put_fn = always_fail
    cc._put_loop("b:1", {"method": "CACHE_PUT", "uuid": "u2", "digest": "d", "entry": {}})
    assert len(attempts) == 3
    assert cc.metrics()["puts_failed"] == 1


# -- simnet lane --------------------------------------------------------------

#: Affinity off for the cache-path tests: the requester must answer
#: through CACHE_GET routing, not by forwarding the whole job to the
#: digest owner (that path gets its own test below).
SIM_NOAFF = dataclasses.replace(SIM, dht_affinity=False)


def fd_engine(calls=None):
    """Oracle-backed engine WITH a front door (the L2 seam's consumer).
    ``easy_score=0`` pins probed-open boards to the engine path — no
    native racer, so ``calls`` counts every non-cached solve exactly."""
    base = oracle_solve_fn()

    def solve(grids, geom, cfg):
        if calls is not None:
            calls.append(len(grids))
        return base(grids, geom, cfg)

    # batch_window_s is deliberately NOT microscopic: commit_device
    # attaches the cache-fill hook after submit() places the job, and an
    # instantaneous oracle behind a 1ms window can resolve first (a
    # documented bounded miss).  50ms makes the fill deterministic.
    return SolverEngine(
        device="cpu",
        solve_fn=solve,
        batch_window_s=0.05,
        frontdoor=FrontDoorConfig(easy_score=0),
    ).start()


def _digest_of(board) -> str:
    cf = canonicalize(np.asarray(board, np.int32), SUDOKU_9)
    assert cf is not None
    return cf.digest


def _dht_ring(net, k, config=SIM_NOAFF):
    """k-node ring of front-door engines; returns (nodes, per-node call
    counters)."""
    calls = [[] for _ in range(k)]
    engines = {i: fd_engine(calls[i]) for i in range(k)}
    nodes = form_ring(net, k, config=config, engines=engines)
    return nodes, calls


def _owner_node(nodes, digest):
    owner = nodes[0]._ring_owner(digest)
    return next(n for n in nodes if n.addr_s == owner)


def test_hit_anywhere_is_hit_everywhere(net):
    """Acceptance: a board solved once on any member answers every
    symmetry-equivalent resubmission from ANY other member bit-exactly,
    with zero solver dispatches at the requester (CACHE_GET to the
    digest owner, promoted into the requester's L1)."""
    nodes, calls = _dht_ring(net, 3)
    a = nodes[0]
    board = np.asarray(HARD_9[0], np.int32)
    expect = solve_oracle(board, a_geom(board))
    digest = _digest_of(board)

    # Warm: solve once through A's engine (local front door, device
    # route) — the fill replicates to the digest owner's shard.
    j0 = a.engine.submit(board)
    assert j0.wait(60) and j0.solved
    assert np.array_equal(j0.solution, expect)
    owner = _owner_node(nodes, digest)
    assert wait_until(net, lambda: len(owner.dcache) >= 1, timeout=30), (
        "cache fill never reached the digest owner's shard"
    )

    rng = np.random.default_rng(0xD147)
    for i, n in enumerate(nodes):
        if n is a:
            continue
        before = len(calls[i])
        # Same board AND a random symmetry transform of it: one orbit,
        # one entry, hit either way.
        tr = random_transform(SUDOKU_9, rng)
        for grid, want in (
            (board, expect),
            (apply_transform(board, tr), apply_transform(expect, tr)),
        ):
            j = n.engine.submit(grid)
            assert j.wait(60) and j.solved, f"node {i}: {j.error!r}"
            assert j.route == "cache", f"node {i} routed {j.route!r}"
            assert np.array_equal(j.solution, np.asarray(want, np.int32)), (
                f"node {i}: cached answer not bit-exact"
            )
            assert is_valid_solution(j.solution)
        assert len(calls[i]) == before, (
            f"node {i} dispatched its solver on a cached orbit"
        )
        if n is not owner:
            assert n.dcache.metrics()["remote_hits"] >= 1
        # Exactly one L2 round-trip per node: the first hit is promoted
        # into L1, so the transformed resubmit answers from L1 alone.
        assert n.engine.frontdoor.cluster_hits == 1
        assert n.engine.frontdoor.metrics()["cache"]["hits"] >= 1


def test_negative_entry_propagates(net):
    """An unsat proof on one member answers as a cached 'unsat' verdict
    cluster-wide — repeats of a contradictory orbit never re-probe."""
    nodes, calls = _dht_ring(net, 3)
    a, b = nodes[0], nodes[1]
    bad = np.asarray(EASY_9, np.int32).copy()
    row = bad[0]
    givens = row[row > 0]
    hole = int(np.flatnonzero(row == 0)[0])
    bad[0, hole] = givens[0]  # duplicate in row 0: propagation-proven unsat
    digest = _digest_of(bad)

    j0 = a.engine.submit(bad)
    assert j0.wait(60) and j0.unsat and not j0.solved
    assert j0.route == "propagation"
    owner = _owner_node(nodes, digest)
    assert wait_until(net, lambda: len(owner.dcache) >= 1, timeout=30), (
        "negative fill never reached the digest owner's shard"
    )

    before = len(calls[1])
    j1 = b.engine.submit(bad)
    assert j1.wait(60) and j1.unsat and not j1.solved
    assert j1.route == "cache", "negative verdict must come from the cache"
    assert len(calls[1]) == before
    assert b.dcache.metrics()["negative_hits"] >= 1


def test_owner_failure_mid_fill_falls_back_to_local_solve(net):
    """A partitioned digest owner turns lookups into misses and fills
    into bounded retries — the requester solves locally, the job
    completes bit-exactly, nothing is lost or raised."""
    nodes, calls = _dht_ring(net, 3)
    board = np.asarray(HARD_9[1], np.int32)
    expect = solve_oracle(board, a_geom(board))
    digest = _digest_of(board)
    owner = _owner_node(nodes, digest)
    others = [n for n in nodes if n is not owner]
    requester = others[0]
    r_idx = nodes.index(requester)

    net.partition([owner.addr_s], [n.addr_s for n in others])
    before = len(calls[r_idx])
    j = requester.engine.submit(board)
    assert j.wait(120) and j.solved, f"job lost to a dead owner: {j.error!r}"
    assert np.array_equal(j.solution, expect)
    assert len(calls[r_idx]) > before, "fallback must be a LOCAL solve"
    m = requester.dcache.metrics()
    assert m["remote_errors"] >= 1, "owner miss must be counted"
    # The L1 took the entry even though the cluster fill is stranded:
    # an immediate repeat answers from cache.
    j2 = requester.engine.submit(board)
    assert j2.wait(30) and j2.solved and j2.route == "cache"
    net.heal()


def test_cache_put_dedupe(net):
    """At-least-once fills: the same CACHE_PUT frame delivered twice
    applies once — the node-level uuid dedupe drops the duplicate."""
    nodes, _ = _dht_ring(net, 2)
    b = nodes[1]
    frame = {
        "method": "CACHE_PUT",
        "uuid": "put-dedupe-1",
        "digest": "f00d" * 16,
        "entry": {"verdict": "solved", "solution": [[1]], "nodes": 0},
        "from": nodes[0].addr_s,
    }
    net.inject(b.addr, dict(frame))
    net.inject(b.addr, dict(frame))
    assert wait_until(
        net, lambda: b.duplicates_dropped.get("CACHE_PUT", 0) == 1, timeout=30
    ), "duplicate CACHE_PUT was not deduped"
    m = b.dcache.metrics()
    assert m["puts_applied"] == 1, "duplicate CACHE_PUT mutated the shard"
    assert m["entries"] == 1


def test_affinity_routes_to_owner_and_declines_unhealthy(net):
    """Cache-affine placement: a cacheable submit lands on its digest
    owner; a suspected (probe-failing) owner is declined at the
    requester and the job still completes elsewhere."""
    nodes, calls = _dht_ring(net, 2, config=SIM)  # affinity ON
    board = np.asarray(HARD_9[1], np.int32)
    digest = _digest_of(board)
    owner = _owner_node(nodes, digest)
    requester = next(n for n in nodes if n is not owner)
    o_idx = nodes.index(owner)

    j = requester.submit(board)
    assert wait_until(net, lambda: j.done.is_set(), timeout=120)
    assert j.solved
    with requester._lock:
        assert requester.affinity_routed >= 1
    assert len(calls[o_idx]) >= 1, "affine job must solve at the digest owner"

    # Kill the requester->owner PROBE channel only: gossip suspects the
    # owner while the view (heartbeats untouched) keeps it a member.
    probe_link = f"link:{requester.addr_s}->{owner.addr_s}:PROBE"
    net.set_schedule(
        FaultSchedule(lambda site, idx: "drop" if site == probe_link else None)
    )
    assert wait_until(
        net,
        lambda: requester.gossip.state_of(owner.addr_s) == SUSPECT,
        timeout=60,
    ), "dropped probes never raised suspicion"
    assert owner.addr_s in requester.network  # still a member

    j2 = requester.submit(np.asarray(HARD_9[0], np.int32))
    assert wait_until(net, lambda: j2.done.is_set(), timeout=120)
    assert j2.solved
    with requester._lock:
        routed_after = requester.affinity_routed
        declined = requester.affinity_declined
    # Either the second board's owner was the suspect (declined) or it
    # hashed to the requester itself (routed, self is always healthy) —
    # both legal; what is pinned is that NOTHING was affinity-routed to
    # the suspected owner.
    if nodes[0]._ring_owner(_digest_of(HARD_9[0])) == owner.addr_s:
        assert declined >= 1, "suspected owner must be declined"
    else:
        assert routed_after >= 1
    net.set_schedule(None)


def test_dht_view_and_metrics_rollup(net):
    """The /network?scope=dht body and the cluster metrics rollup carry
    the DHT plane: gossip states, ring shares, shard counters; the
    agg merge sums gossip events and cache numerics across members."""
    nodes, _ = _dht_ring(net, 3)
    a = nodes[0]
    board = np.asarray(HARD_9[0], np.int32)
    digest = _digest_of(board)
    j = a.engine.submit(board)
    assert j.wait(60) and j.solved

    view = a.dht_view(owner_of=digest)
    assert set(view["members"]) == set(a.network)
    assert all(m["state"] == ALIVE for m in view["members"].values())
    assert view["ring"]["members"] == 3
    assert view["owner"]["digest"] == digest
    assert view["owner"]["owner"] == a._ring_owner(digest)
    assert view["owner"]["owner"] in view["owner"]["replicas"]
    assert view["cluster_cache"]["capacity"] > 0

    dht = a.metrics_view()["dht"]
    assert dht["gossip"]["alive"] == 3
    assert "cluster_cache" in dht and "affinity" in dht

    # 3 members' shards hold the one filled orbit between them, and the
    # rollup's entries sum IS the cluster cache size (disjoint shards).
    assert wait_until(
        net,
        lambda: a.cluster_metrics_view()["rollup"]["dht"]["cluster_cache"][
            "entries"
        ] >= 1,
        timeout=30,
    )
    roll = a.cluster_metrics_view()["rollup"]
    assert "gossip" in roll["dht"] and "merged" in roll["dht"]["gossip"]
    assert "capacity" not in roll["dht"]["cluster_cache"], (
        "per-node capacity must not sum across shards"
    )
    assert roll["members_total"] == 3 and roll["sampled"] is False

    # Sampled pull: bounded fan-out, deterministic rollup metadata.
    sampled = a.cluster_metrics_view(sample=1)
    assert sampled["rollup"]["members_total"] == 3
    assert sampled["rollup"]["sampled"] is True
    assert len(sampled["nodes"]) == 2  # self + one sampled peer


# -- the 500-node soak (slow lane) --------------------------------------------


@pytest.mark.slow
def test_500_node_gossip_soak_chaos_churn_coordinator_kill(net):
    """Acceptance: 500 virtual members form one view, survive
    seeded link chaos + a partition + member churn + a coordinator
    kill, and every job submitted through the storm completes with a
    solution bit-identical to the fault-free oracle.  Gossip keeps
    per-beat traffic O(1) per member the whole way (one PROBE each)."""
    n_nodes = 500
    soak_cfg = ClusterConfig(
        heartbeat_s=2.0,
        fail_factor=8.0,
        io_timeout_s=2.0,
        stats_timeout_s=1.0,
        needwork=False,
        progress_interval_s=0.0,
        send_retries=4,
        retry_delay_s=0.25,
        tombstone_probe_s=3600.0,
    )
    # 8 shared oracle engines: the soak exercises the PROTOCOL plane;
    # 500 independent engines would only stress the CI box.
    engines = [
        SolverEngine(device="cpu", solve_fn=oracle_solve_fn(), batch_window_s=0.001).start()
        for _ in range(8)
    ]
    nodes = [sim_node(net, config=soak_cfg, engine=engines[0])]
    for i in range(1, n_nodes):
        nodes.append(
            sim_node(
                net,
                anchor=nodes[0].addr,
                config=soak_cfg,
                engine=engines[i % len(engines)],
            )
        )
    a = nodes[0]
    assert wait_until(
        net,
        lambda: all(len(n.network) == n_nodes for n in nodes),
        timeout=1200,
        step=2.0,
    ), (
        f"view never converged: "
        f"{sorted({len(n.network) for n in nodes})[:5]}..."
    )

    boards = [np.asarray(EASY_9, np.int32)] + [
        np.asarray(h, np.int32) for h in HARD_9[:2]
    ]
    expect = [solve_oracle(g, a_geom(g)) for g in boards]
    assert all(s is not None for s in expect)

    # Weather on: low-rate seeded chaos across every link (at 500 nodes
    # a beat is ~1500 messages; 2% keeps the failure paths hot without
    # drowning the at-least-once budgets).
    net.set_schedule(
        FaultSchedule.seeded(seed=17, rate=0.02, kinds=("drop", "dup", "delay"))
    )
    # Stride starts at 1 so no job is submitted via nodes[0] (the
    # coordinator we kill later): indices 1, 38, 75, 112, 149, 186 all
    # stay live through the partition (100..109) and kills (200..204).
    jobs = [
        (i, nodes[(i * 37 + 1) % n_nodes].submit(boards[i % len(boards)]))
        for i in range(6)
    ]

    # Partition a 10-member block long enough for eviction, then heal.
    block = [n.addr_s for n in nodes[100:110]]
    net.partition(block, [n.addr_s for n in nodes if n.addr_s not in block])
    assert wait_until(
        net,
        lambda: all(m not in a.network for m in block),
        timeout=600,
        step=2.0,
    ), "partitioned block never evicted"
    jobs += [
        (i, nodes[(i * 37) % 100].submit(boards[i % len(boards)]))
        for i in range(6, 12)
    ]
    net.heal()
    assert wait_until(
        net,
        lambda: all(len(nodes[i].network) == n_nodes for i in range(0, 500, 50)),
        timeout=1200,
        step=2.0,
    ), "healed block never rejoined"

    # Churn: kill five members outright (they stay dead).
    killed = nodes[200:205]
    for n in killed:
        n.kill()
    dead_addrs = {n.addr_s for n in killed}
    live = [n for n in nodes if n.addr_s not in dead_addrs]

    # Coordinator kill under churn: promotion must reconverge the fleet.
    a.kill()
    dead_addrs.add(a.addr_s)
    live = [n for n in live if n is not a]
    assert wait_until(
        net,
        lambda: all(
            live[i].coordinator not in dead_addrs
            and len(live[i].network) == n_nodes - 6
            for i in range(0, len(live), 50)
        ),
        timeout=2400,
        step=2.0,
    ), "fleet never reconverged after churn + coordinator kill"
    coord = live[0].coordinator
    assert all(live[i].coordinator == coord for i in range(0, len(live), 97))

    jobs += [
        (i, live[(i * 41) % len(live)].submit(boards[i % len(boards)]))
        for i in range(12, 18)
    ]

    # Zero lost jobs, bit-identical solutions.  Every job was submitted
    # via a member that stays alive for the whole soak (the strides dodge
    # the partition block, the killed span, and the coordinator), so
    # at-least-once delivery must land every single one.
    assert wait_until(
        net,
        lambda: all(j.done.is_set() for _, j in jobs),
        timeout=2400,
        step=2.0,
    ), (
        f"lost jobs: {[(i, j.error) for i, j in jobs if not j.done.is_set()]}"
    )
    for i, j in jobs:
        assert j.solved, f"job {i} unsolved: {j.error!r}"
        assert np.array_equal(j.solution, expect[i % len(boards)]), (
            f"job {i} not bit-identical to the fault-free oracle"
        )

    # The storm actually blew: fault plane + gossip state machine hot.
    assert net.counters["dropped"] > 0
    assert net.counters["duplicated"] > 0
    assert net.counters["blocked"] > 0
    g_tot = {"suspicions": 0, "deaths": 0, "merged": 0}
    for i in range(0, len(live), 25):
        m = live[i].gossip.metrics()
        for k in g_tot:
            g_tot[k] += m[k]
    assert g_tot["merged"] > 0, "gossip piggyback never propagated state"
    assert g_tot["suspicions"] > 0, "chaos never raised a suspicion"
