"""Cluster-scope twins of the observability and durability tests, on the
port's cluster node.

From ``tests/test_cluster_obs.py``: the 3-node ``METRICS_PULL`` merge on
the virtual clock (the rollup is the vector sum of the per-node bodies,
bit-identical across two runs), a partitioned member flagged
``unreachable``, and the compile-watch and critpath federation.  From
``tests/test_obs.py``: the 2-node stitched trace with a permanent-fault
dump and its Perfetto export (checked by the port's ``obs/traceck``), and
promck over a live gossip member.  From
``tests/test_critpath.py``: the 2-node partition of a stitched trace on the
virtual clock.  From ``tests/test_journal.py``: drain with peer handoff and
the kill/restart chaos soak with zero accepted-job loss.
"""

import json
import logging
import os
import threading

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu_torch.cluster.node import ClusterConfig, ClusterNode
from distributed_sudoku_solver_tpu_torch.cluster.simnet import SimNet, wait_until
from distributed_sudoku_solver_tpu_torch.obs import (
    agg,
    compilewatch,
    critpath,
    hist,
    lockdep,
    prom,
    promck,
    slo,
    trace,
    traceck,
)
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.serving import faults
from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
from distributed_sudoku_solver_tpu_torch.serving.faults import FaultInjector, FaultSchedule
from distributed_sudoku_solver_tpu_torch.serving.journal import Journal
from distributed_sudoku_solver_tpu_torch.utils.oracle import solve_oracle
from distributed_sudoku_solver_tpu_torch.utils.puzzles import EASY_9, HARD_9

from tests.test_torch_cluster import a_geom, oracle_solve_fn

EASY = np.asarray(EASY_9, np.int32)

SIM = ClusterConfig(
    heartbeat_s=0.25,
    fail_factor=8.0,
    io_timeout_s=2.0,
    needwork=False,
    progress_interval_s=0.0,
    retry_delay_s=0.1,
    tombstone_probe_s=600.0,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _port_lockdep():
    """The port's lock witness, armed as ``test_torch_engine.py`` arms it."""
    with lockdep.installed(lockdep.manifest_witness(strict=True)) as w:
        yield w


@pytest.fixture(autouse=True)
def _clean_seams():
    """Every test leaves the process-wide obs seams empty."""
    yield
    trace.install(None)
    slo.install(None)
    critpath.install(None)
    compilewatch.install(None)


@pytest.fixture
def net():
    n = SimNet()
    n.nodes = []
    yield n
    for node in n.nodes:
        node.kill()
        node.engine.stop(timeout=1)
    n.close()


def _seed_samples(engines):
    """Deterministic histogram samples, distinct per node: node i records
    (i+1) samples at 2^i ms into sync_wall_ms — input the solver's wall
    clock never touches, so two runs must produce bit-identical merges."""
    for i, eng in enumerate(engines):
        for _ in range(i + 1):
            eng.hist["sync_wall_ms"].record((2.0 ** i) / 1e3)
        eng.rpc_floor.record((2.0 ** i) / 1e3)


def _ring3(net, cfg):
    from distributed_sudoku_solver_tpu_torch.cluster.node import ClusterNode
    from distributed_sudoku_solver_tpu_torch.cluster.simnet import wait_until

    from tests.test_torch_cluster import oracle_solve_fn

    engines = [
        SolverEngine(device="cpu", solve_fn=oracle_solve_fn(), batch_window_s=0.001).start()
        for _ in range(3)
    ]
    a = ClusterNode(engines[0], config=cfg, transport=net.transport(),
                    clock=net.clock).start()
    b = ClusterNode(engines[1], anchor=a.addr, config=cfg,
                    transport=net.transport(), clock=net.clock).start()
    c = ClusterNode(engines[2], anchor=a.addr, config=cfg,
                    transport=net.transport(), clock=net.clock).start()
    nodes = [a, b, c]
    assert wait_until(
        net, lambda: all(len(n.network) == 3 for n in nodes), timeout=60
    ), "ring never formed"
    return engines, nodes


def _cluster_cfg():
    from distributed_sudoku_solver_tpu_torch.cluster.node import ClusterConfig

    return ClusterConfig(
        heartbeat_s=0.25, fail_factor=50.0, io_timeout_s=2.0,
        needwork=False, progress_interval_s=0.0, stats_timeout_s=2.0,
    )


@pytest.mark.simnet
def test_cluster_scope_merge_sums_and_is_deterministic():
    """Acceptance: on a 3-node simnet ring, GET /metrics?scope=cluster's
    rollup histogram counts equal the vector sum of the per-node counts —
    and a seeded phase merges bit-identically across two fully
    independent runs on the virtual clock."""
    from distributed_sudoku_solver_tpu_torch.cluster.simnet import SimNet, wait_until

    net_views = []
    for _ in range(2):
        net = SimNet()
        engines, nodes = _ring3(net, _cluster_cfg())
        a = nodes[0]
        try:
            # Real traffic through the ring (remote dispatch populates the
            # wire histograms), then the deterministic seeded phase.
            jobs = [
                a._submit_remote(np.asarray(EASY_9, np.int32), n.addr_s)
                for n in nodes[1:]
            ]
            assert wait_until(
                net, lambda: all(j.done.is_set() for j in jobs), timeout=120
            ), "remote jobs never resolved"
            assert all(j.solved for j in jobs)
            _seed_samples(engines)
            cm = a.cluster_metrics_view()

            # Every member reachable, none stale, and the rollup is the
            # vector sum of the per-node histogram counts — per phase.
            assert len(cm["nodes"]) == 3
            assert all(
                not n["unreachable"] and not n["stale"]
                for n in cm["nodes"].values()
            )
            for phase, merged in cm["rollup"]["hist"].items():
                per_node = [
                    n["metrics"]["hist"][phase]["counts"]
                    for n in cm["nodes"].values()
                    if phase in n["metrics"].get("hist", {})
                ]
                vec_sum = [sum(col) for col in zip(*per_node)]
                assert merged["counts"] == vec_sum, phase
            # Counters too: the rollup's jobs_done is the per-node sum.
            assert cm["rollup"]["counters"]["jobs_done"] == sum(
                n["metrics"]["jobs_done"] for n in cm["nodes"].values()
            )
            # The seeded phase: 1+2+3 samples across known buckets.
            seeded = cm["rollup"]["hist"]["sync_wall_ms"]
            assert hist.hist_count(seeded) == 6
            # Cluster floor = min of member floors = 1 ms (node 0's seed).
            assert cm["rollup"]["rpc_floor_ms"]["min"] == pytest.approx(1.0)
            # Aggregation counters exported under cluster.agg.
            mv = a.metrics_view()
            assert mv["cluster"]["agg"]["pulls"] == 2
            assert mv["cluster"]["agg"]["merges"] == 1
            assert mv["cluster"]["agg"]["unreachable_peers"] == 0
            net_views.append(seeded["counts"])
        finally:
            for n in nodes:
                n.kill()
            for e in engines:
                e.stop(timeout=1)
            net.close()
    assert net_views[0] == net_views[1], (
        "cluster-scope merge not deterministic across two virtual-clock runs"
    )


@pytest.mark.simnet
def test_partitioned_member_flagged_unreachable_without_blocking(caplog):
    """Acceptance: the pull completes while a member is partitioned — the
    member is flagged unreachable (and the degradation logged with the
    peer identified), the reachable majority still merges."""
    from distributed_sudoku_solver_tpu_torch.cluster.simnet import SimNet

    net = SimNet()
    engines, nodes = _ring3(net, _cluster_cfg())
    a, b, c = nodes
    try:
        _seed_samples(engines)
        net.partition([c.addr_s], [a.addr_s, b.addr_s])
        with caplog.at_level(logging.WARNING):
            cm = a.cluster_metrics_view()
        assert cm["nodes"][c.addr_s]["unreachable"] is True
        assert cm["nodes"][c.addr_s]["metrics"] is None
        assert cm["nodes"][b.addr_s]["unreachable"] is False
        assert cm["rollup"]["unreachable"] == 1
        # Rollup covers exactly the reachable members (nodes 0 and 1:
        # 1 + 2 seeded sync samples).
        assert hist.hist_count(cm["rollup"]["hist"]["sync_wall_ms"]) == 3
        assert a.agg_unreachable == 1
        assert any(
            f"[peer {c.addr_s}]" in r.getMessage() for r in caplog.records
        ), "degraded aggregation must log the peer"
        # /status derives the degradation honestly.
        st = agg.status_from(cm)
        assert st["degraded"] is True and st["healthy"] is False
        # A stale member: bump our epoch so b's reply view disagrees.
        with a._lock:
            a.net_epoch += 1
        cm2 = a.cluster_metrics_view()
        assert cm2["nodes"][b.addr_s]["stale"] is True
        assert cm2["nodes"][b.addr_s]["metrics"] is not None  # still merged
    finally:
        for n in nodes:
            n.kill()
        for e in engines:
            e.stop(timeout=1)
        net.close()


@pytest.mark.simnet
def test_cluster_scope_merge_federates_critpath():
    """Twin of ``test_cluster_scope_merge_federates_compile_and_critpath``
    without its compile-watch half (the port has no compile watch until
    ROADMAP A14): critpath attribution totals sum across members with
    shares re-derived from the merged totals, and the per-phase
    ``critpath_*_ms`` histograms merge through the ``hist`` rule.  All
    three simnet nodes share the process-wide monitor, so the rollup must
    read exactly 3x each."""
    net = SimNet()
    rec = trace.TraceRecorder(ring=4096, clock=net.clock.now)
    mon = critpath.CritPathMonitor()
    engines, nodes = _ring3(net, _cluster_cfg())
    a = nodes[0]
    try:
        with trace.installed(rec), critpath.installed(mon):
            rec.record("u1", "admission", "engine.launch", 0.0, t1=0.1)
            rec.record(None, "chunk.sync", "fetch.status", 0.1, t1=0.4,
                       uuids=["u1"])
            rec.record("u1", "resolve", "engine.resolve", 0.4, t1=0.4)
            mon.observe_job("u1", 0.4)

            cm = a.cluster_metrics_view()
            per_node = [n["metrics"] for n in cm["nodes"].values()]
            assert len(per_node) == 3
            for body in per_node:
                assert body["critpath"]["jobs"] == 1
                assert "compile" not in body and "cost" not in body
            ru = cm["rollup"]
            cp = ru["critpath"]
            assert cp["jobs"] == 3
            assert cp["attribution_ms"]["sync"] == pytest.approx(900.0)
            assert cp["attribution_ms"]["queue"] == pytest.approx(300.0)
            assert cp["shares_pct"]["sync"] == pytest.approx(75.0)
            assert hist.hist_count(ru["hist"]["critpath_sync_ms"]) == 3
    finally:
        for n in nodes:
            n.kill()
        for e in engines:
            e.stop(timeout=1)
        net.close()


@pytest.mark.simnet
def test_cluster_scope_merge_federates_compile_and_critpath():
    """Twin of ``test_cluster_scope_merge_federates_compile_and_critpath``
    with its compile-watch half: per-library compile counts and build walls
    sum across members (wall histograms vector-add), beside the critpath
    totals.  All three simnet nodes share the process-wide watch and
    monitor, so every per-node body reports the same numbers and the
    rollup must read exactly 3x each.  The two compiles are a build of
    ``fused_step`` (0.5 s) and its first load."""
    net = SimNet()
    t = [0.0]
    watch = compilewatch.CompileWatch(warmup_s=1e9, clock=lambda: t[0])
    rec = trace.TraceRecorder(ring=4096, clock=net.clock.now)
    mon = critpath.CritPathMonitor()
    engines, nodes = _ring3(net, _cluster_cfg())
    a = nodes[0]
    try:
        with trace.installed(rec), compilewatch.installed(watch), critpath.installed(mon):
            watch.on_build("fused_step", 0.5)
            watch.on_load("fused_step", built=True)
            watch.on_build("fused_step_clocks", 0.25)
            rec.record("u1", "admission", "engine.launch", 0.0, t1=0.1)
            rec.record(None, "chunk.sync", "fetch.status", 0.1, t1=0.4, uuids=["u1"])
            rec.record("u1", "resolve", "engine.resolve", 0.4, t1=0.4)
            mon.observe_job("u1", 0.4)

            cm = a.cluster_metrics_view()
            per_node = [n["metrics"] for n in cm["nodes"].values()]
            assert len(per_node) == 3
            for body in per_node:
                prog = body["compile"]["programs"]["fused_step"]
                assert prog["count"] == 2 and prog["builds"] == 1 and prog["loads"] == 1
                assert body["critpath"]["jobs"] == 1
            ru = cm["rollup"]
            prog = ru["compile"]["programs"]["fused_step"]
            assert prog["count"] == 6
            assert prog["wall_ms_total"] == pytest.approx(3 * 500.0)
            assert sum(prog["wall_ms"]["counts"]) == 3
            assert ru["compile"]["programs"]["fused_step_clocks"]["count"] == 3
            assert ru["compile"]["compiles_total"] == 9
            cp = ru["critpath"]
            assert cp["jobs"] == 3
            assert cp["attribution_ms"]["sync"] == pytest.approx(900.0)
            assert cp["shares_pct"]["sync"] == pytest.approx(75.0)
            assert hist.hist_count(ru["hist"]["critpath_sync_ms"]) == 3
            assert promck.check_text(prom.render(cm["rollup"])) == []
    finally:
        for n in nodes:
            n.kill()
        for e in engines:
            e.stop(timeout=1)
        net.close()


@pytest.mark.simnet
def test_cluster_trace_stitching_fault_dump_and_perfetto(tmp_path):
    """Acceptance: a simnet cluster solve with an injected PERMANENT fault
    produces (1) a stitched multi-node trace for the job's uuid — spans
    recorded by both the origin and the worker, trace context having
    ridden the TASK/SOLUTION frames; (2) an automatic flight-recorder
    dump containing the fault span; (3) Perfetto export that passes the
    traceck validator.  Everything timestamps through the simnet virtual
    clock (the recorder's injected clock), and the simnet marker guard
    proves no sleeps/sockets."""
    from distributed_sudoku_solver_tpu_torch.cluster.node import (
        ClusterConfig,
        ClusterNode,
    )
    from distributed_sudoku_solver_tpu_torch.cluster.simnet import SimNet, wait_until

    from tests.test_torch_cluster import oracle_solve_fn

    cfg = ClusterConfig(
        heartbeat_s=0.25, fail_factor=8.0, io_timeout_s=2.0, needwork=False,
        progress_interval_s=0.0, retry_delay_s=0.1, tombstone_probe_s=600.0,
    )
    net = SimNet()
    rec = trace.TraceRecorder(
        ring=8192, clock=net.clock.now, node="driver", dump_dir=str(tmp_path)
    )
    # engine.launch #0 is the worker's first (and only) flight launch:
    # the poison dispatch a retry cannot cure.
    inj = FaultInjector(
        schedule=FaultSchedule.at({"engine.launch": {0: "permanent"}})
    )
    ea = eb = a = b = None
    try:
        with trace.installed(rec), faults.injected(inj):
            ea = SolverEngine(
                device="cpu",
                solve_fn=oracle_solve_fn(), batch_window_s=0.001
            ).start()
            eb = SolverEngine(
                device="cpu",
                config=SolverConfig(min_lanes=4, stack_slots=32, branch="first"),
                chunk_steps=1,
                batch_window_s=0.001,
            ).start()
            a = ClusterNode(ea, config=cfg, transport=net.transport(),
                            clock=net.clock).start()
            b = ClusterNode(eb, anchor=a.addr, config=cfg,
                            transport=net.transport(), clock=net.clock).start()
            assert wait_until(
                net, lambda: len(a.network) == 2 and len(b.network) == 2,
                timeout=60,
            ), "ring never formed"
            job = a._submit_remote(np.asarray(EASY_9, np.int32), b.addr_s)
            assert wait_until(net, lambda: job.done.is_set(), timeout=240), (
                "remote job never resolved"
            )
            assert job.error and "[permanent]" in job.error

            # (1) Stitched multi-node trace: the one uuid reconstructs the
            # whole distributed story, each span tagged with its recorder.
            spans = rec.spans(job.uuid)
            names = {s["name"] for s in spans}
            assert {"send.TASK", "recv.TASK", "admission",
                    "fault.permanent", "send.SOLUTION",
                    "recv.SOLUTION"} <= names, names
            span_nodes = {s["node"] for s in spans}
            assert {a.addr_s, b.addr_s} <= span_nodes, (
                f"trace not stitched across nodes: {span_nodes}"
            )
            # Timestamps ride the virtual clock: nothing precedes t=0 and
            # every span is monotone.
            assert all(0.0 <= s["t0"] <= s["t1"] for s in spans)

            # (2) The flight-recorder dump fired on the permanent fault
            # and holds the fault span for this uuid.  The dump is written
            # on the worker's device loop, concurrently with the SOLUTION
            # round-trip that resolved the handle — wait for the file, on
            # the virtual clock (wait_until yields real scheduler slices).
            assert wait_until(
                net,
                lambda: any(
                    f.endswith("permanent_fault.json")
                    for f in os.listdir(tmp_path)
                ),
                timeout=60,
            ), "no flight-recorder dump on the permanent fault"
            dumps = [f for f in os.listdir(tmp_path)
                     if f.endswith("permanent_fault.json")]
            doc = json.loads((tmp_path / dumps[0]).read_text())
            assert any(
                s["name"] == "fault.permanent" and s["trace"] == job.uuid
                for s in doc["spans"]
            )
            assert doc["metrics"]["faults"]["permanent_failures"] >= 1

            # (3) GET /trace?format=perfetto serves exactly this payload
            # (serving/http.py delegates to rec.perfetto()): it must pass
            # the traceck validator.
            assert traceck.check(rec.perfetto()) == []
    finally:
        for n in (a, b):
            if n is not None:
                n.kill()
        for e in (ea, eb):
            if e is not None:
                e.stop(timeout=1)
        net.close()


@pytest.mark.simnet
def test_promck_over_live_gossip_node():
    """Satellite (round 20): the prometheus body of a LIVE gossip member —
    a 3-node simnet ring with the DHT plane on, a cross-member cache hit
    behind it — passes promck and carries the dsst_dht_* families (gossip
    liveness, ring shape, cluster-cache shard, affinity counters) plus
    the round-20 partition-survival fault counters."""
    from distributed_sudoku_solver_tpu_torch.obs import promck
    from distributed_sudoku_solver_tpu_torch.cluster.simnet import SimNet, wait_until
    from tests.test_torch_dht import _dht_ring, _digest_of, _owner_node

    net = SimNet()
    net.nodes = []
    try:
        nodes, _calls = _dht_ring(net, 3)
        a = nodes[0]
        board = np.asarray(HARD_9[0], np.int32)
        j = a.engine.submit(board)
        assert j.wait(60) and j.solved, j.error
        owner = _owner_node(nodes, _digest_of(board))
        assert wait_until(net, lambda: len(owner.dcache) >= 1, timeout=30)
        requester = next(n for n in nodes if n is not a and n is not owner)
        j2 = requester.engine.submit(board)
        assert j2.wait(60) and j2.solved and j2.route == "cache"

        for member in (requester, owner):
            raw = prom.render(member.metrics_view())
            assert promck.check_text(raw) == [], promck.check_text(raw)[:5]
            assert "dsst_dht_gossip_alive 3" in raw
            assert "dsst_dht_ring_members 3" in raw
            assert "dsst_dht_cluster_cache_capacity" in raw
            assert "dsst_dht_affinity_routed" in raw
            assert "dsst_cluster_faults_results_parked 0" in raw
        assert (
            "dsst_dht_cluster_cache_remote_hits 1"
            in prom.render(requester.metrics_view())
        )
        # The owner served at least the requester's GET (A's warm-up
        # lookup may have landed there too — don't pin the count).
        assert owner.dcache.metrics()["gets_served"] >= 1
        assert "dsst_dht_cluster_cache_gets_served" in prom.render(
            owner.metrics_view()
        )
    finally:
        for n in net.nodes:
            n.kill()
            n.engine.stop(timeout=1)
        net.close()


def _assert_partition(d):
    s = sum(d["phases_ms"].values())
    assert s == pytest.approx(
        d["end_to_end_ms"], rel=critpath.SUM_TOLERANCE
    ), (s, d["end_to_end_ms"])


@pytest.mark.simnet
def test_stitched_two_node_trace_partitions_on_the_virtual_clock(tmp_path):
    """A remote job on a 2-node simnet ring: the stitched trace (wire
    spans from both nodes, admission/resolve from the worker) decomposes
    into phases that sum to the end-to-end wall within the documented
    tolerance — entirely on the virtual clock, no sleeps (the simnet
    purity guard enforces it)."""
    from distributed_sudoku_solver_tpu_torch.cluster.node import (
        ClusterConfig,
        ClusterNode,
    )
    from distributed_sudoku_solver_tpu_torch.cluster.simnet import SimNet, wait_until

    from tests.test_torch_cluster import oracle_solve_fn

    cfg = ClusterConfig(
        heartbeat_s=0.25, fail_factor=8.0, io_timeout_s=2.0, needwork=False,
        progress_interval_s=0.0, retry_delay_s=0.1, tombstone_probe_s=600.0,
    )
    net = SimNet()
    rec = trace.TraceRecorder(ring=8192, clock=net.clock.now, node="driver")
    mon = critpath.CritPathMonitor()
    ea = eb = a = b = None
    try:
        with trace.installed(rec), critpath.installed(mon):
            ea = SolverEngine(
                device="cpu",
                solve_fn=oracle_solve_fn(), batch_window_s=0.001
            ).start()
            # The worker's solve waits for the test to move the virtual
            # clock, so the job's window is never zero-wide however fast
            # the engine picks the TASK up (the JAX twin relies on its
            # engine being slower than a settle).
            entered, gate, base = threading.Event(), threading.Event(), oracle_solve_fn()

            def gated(grids, geom, c):
                entered.set()
                gate.wait(60)
                return base(grids, geom, c)

            eb = SolverEngine(
                device="cpu",
                solve_fn=gated, batch_window_s=0.001
            ).start()
            a = ClusterNode(ea, config=cfg, transport=net.transport(),
                            clock=net.clock).start()
            b = ClusterNode(eb, anchor=a.addr, config=cfg,
                            transport=net.transport(), clock=net.clock).start()
            assert wait_until(
                net, lambda: len(a.network) == 2 and len(b.network) == 2,
                timeout=60,
            ), "ring never formed"
            job = a._submit_remote(np.asarray(EASY_9, np.int32), b.addr_s)
            assert entered.wait(60), "the TASK never reached the worker's engine"
            net.advance(0.1)
            gate.set()
            assert wait_until(net, lambda: job.done.is_set(), timeout=240), (
                "remote job never resolved"
            )
            assert job.solved

            spans = rec.spans(job.uuid)
            nodes = {s["node"] for s in spans}
            assert {a.addr_s, b.addr_s} <= nodes, nodes
            d = critpath.decompose(spans)
            _assert_partition(d)
            # Cross-node frames are present and classified as wire (the
            # virtual clock stands still inside a simnet send, so their
            # WALLS are legitimately zero — the real-clock twin in
            # tests/test_api.py measures nonzero phases); every
            # timestamp rode the virtual clock.
            names = {s["name"] for s in spans}
            assert {"send.TASK", "recv.TASK"} <= names, names
            assert all(
                critpath.classify(s) == "wire"
                for s in spans
                if s["name"].startswith(("send.", "recv."))
            )
            assert all(0.0 <= s["t0"] <= s["t1"] for s in spans)
            assert set(d["nodes"]) >= {a.addr_s, b.addr_s}
            # The monitor aggregated the worker-side resolution too.
            assert mon.metrics()["jobs"] >= 1
    finally:
        for n in (a, b):
            if n is not None:
                n.kill()
        for e in (ea, eb):
            if e is not None:
                e.stop(timeout=1)
        net.close()


def sim_node(net, anchor=None, config=SIM, engine=None, port=0):
    eng = engine or SolverEngine(
        device="cpu",
        solve_fn=oracle_solve_fn(), batch_window_s=0.001
    ).start()
    node = ClusterNode(
        eng, port=port, anchor=anchor, config=config,
        transport=net.transport(), clock=net.clock,
    ).start()
    net.nodes.append(node)
    return node


def _crash(node, jr):
    """The crash-restart primitive's first half: network death + WAL
    batcher death WITHOUT the final drain — the in-memory pending resolve
    buffer is LOST, exactly as a ``kill -9`` would lose it.  The journal
    directory on disk is what the reborn node gets."""
    node.kill()
    jr._stop.set()
    jr._batcher.join(timeout=5)
    node.engine.journal = None  # post-mortem resolutions never reach the WAL


@pytest.mark.simnet
def test_drain_hands_off_to_healthy_peer(net, tmp_path):
    """Tentpole (b) on the cluster: a draining node ships its unstarted
    journaled jobs to a gossip-healthy ring peer over the existing TASK
    frame; the peer solves them; the drainer's WAL fully discharges —
    every accepted job was handed off or finished."""
    gate = threading.Event()
    entered = threading.Event()
    base = oracle_solve_fn()

    def gated(grids, geom, cfg):
        entered.set()
        gate.wait(600)
        return base(grids, geom, cfg)

    jr = Journal(str(tmp_path), fsync_interval_s=0.01)
    ea = SolverEngine(
        device="cpu",
        solve_fn=gated, batch_window_s=0.001, journal=jr
    ).start()
    a = sim_node(net, engine=ea)
    b = sim_node(net, anchor=a.addr)
    assert wait_until(
        net, lambda: len(a.network) == 2 and len(b.network) == 2, timeout=60
    ), "ring never formed"

    # One job in flight (held by the gate), three unstarted behind it —
    # submitted through the LOCAL path so none leave before the drain,
    # and only after the first solve has STARTED (batch window closed).
    j0 = a._submit_local(EASY, job_uuid="fly-0")
    assert entered.wait(30)
    queued = [
        a._submit_local(EASY, job_uuid=f"hand-{i}") for i in range(3)
    ]
    res = a.drain(timeout=0.1)
    assert res["state"] == "drained"
    assert res["handoffs"] == 3, res
    # Browning rode the gossip plane: peers stop affinity-routing here.
    if a.gossip is not None:
        assert a.gossip.view()[a.addr_s]["brown"] is True
    # The peer executes the handed-off TASKs (instant oracle solves).
    assert wait_until(
        net, lambda: b.engine.stats()["solved"] >= 3, timeout=120
    ), f"peer solved {b.engine.stats()['solved']}/3 handed-off jobs"
    # Handed-off entries discharged; the in-flight job finishes after the
    # gate opens — the WAL ends empty: nothing accepted was lost.
    gate.set()
    assert j0.wait(60) and j0.solved
    assert wait_until(
        net,
        lambda: (jr.sync_now() or True) and not jr.unresolved(),
        timeout=60,
    ), f"WAL entries stranded: {[e['uuid'] for e in jr.unresolved()]}"
    assert a.engine.metrics()["lifecycle"]["drain_handoffs"] == 3


@pytest.mark.simnet
def test_crash_restart_chaos_soak_zero_loss_bit_identical(net, tmp_path):
    """The acceptance soak: a 3-node ring under seeded drop/dup/delay
    chaos; the origin (journal-backed, its local solves gated so the
    crash catches real in-flight work) is killed mid-flight with its
    pending resolve buffer LOST, then reboots on the SAME address with
    the SAME journal directory, rejoins, and replays.  Every accepted
    job ends in a verdict bit-identical to the fault-free oracle; the
    WAL drains to empty — zero accepted-job loss."""
    wal_dir = str(tmp_path / "wal")
    boards = [EASY] + [np.asarray(h, np.int32) for h in HARD_9[:2]]
    expect = [solve_oracle(g, a_geom(g)) for g in boards]
    assert all(s is not None for s in expect)

    gate = threading.Event()
    base = oracle_solve_fn()

    def gated(grids, geom, cfg):
        gate.wait(600)
        return base(grids, geom, cfg)

    jr = Journal(wal_dir, fsync_interval_s=0.01)
    ea = SolverEngine(
        device="cpu",
        solve_fn=gated, batch_window_s=0.001, journal=jr
    ).start()
    a = sim_node(net, engine=ea)
    b = sim_node(net, anchor=a.addr)
    c = sim_node(net, anchor=a.addr)
    assert wait_until(
        net,
        lambda: all(len(n.network) == 3 for n in (a, b, c)),
        timeout=60,
    ), "ring never formed"

    # Ring formed cleanly; now the weather, then the work.
    net.set_schedule(
        FaultSchedule.seeded(seed=7, rate=0.05, kinds=("drop", "dup", "delay"))
    )
    uuids = [f"job-{i}" for i in range(9)]
    for i, u in enumerate(uuids):
        a.submit(boards[i % 3], job_uuid=u)
    # Let remote dispatches fly and some verdicts land (their WAL entries
    # discharge); a's own share stays gated in flight.
    net.advance(1.0)

    # CRASH: mid-flight, pending buffer lost, journal dir survives.
    addr = a.addr
    _crash(a, jr)
    gate.set()  # free the dead engine's device loop; journal already detached
    assert wait_until(
        net,
        lambda: addr_s(addr) not in b.network and addr_s(addr) not in c.network,
        timeout=240,
    ), "dead origin never evicted"

    # REBOOT: same address, same journal directory, fresh engine.
    jr2 = Journal(wal_dir, fsync_interval_s=0.01)
    ea2 = SolverEngine(
        device="cpu",
        solve_fn=oracle_solve_fn(), batch_window_s=0.001, journal=jr2
    ).start()
    a2 = ClusterNode(
        ea2, port=addr[1], anchor=b.addr, config=SIM,
        transport=net.transport(), clock=net.clock,
    ).start()
    net.nodes.append(a2)
    assert wait_until(
        net,
        lambda: all(len(n.network) == 3 for n in (a2, b, c)),
        timeout=240,
    ), "reborn origin never rejoined"

    replay = [ev["uuid"] for ev in jr2.unresolved()]
    assert replay, "crash caught no in-flight work — soak is vacuous"
    n = a2.recover()
    assert n == len(replay)
    assert ea2.metrics()["lifecycle"]["recovered_jobs"] == n

    # Every replayed job reaches a verdict bit-identical to the oracle.
    handles = {u: ea2._dup_job(u) for u in replay}
    assert all(h is not None for h in handles.values())
    assert wait_until(
        net,
        lambda: all(h.done.is_set() for h in handles.values()),
        timeout=240,
    ), f"replayed jobs stuck: {[u for u, h in handles.items() if not h.done.is_set()]}"
    for u, h in handles.items():
        i = int(u.split("-")[1])
        assert h.solved, f"replayed {u} ended unsolved: {h.error!r}"
        assert np.array_equal(h.solution, expect[i % 3]), (
            f"replayed {u} not bit-identical to the fault-free oracle"
        )
    # Zero loss: the WAL drains to empty once the replays discharge.
    assert wait_until(
        net,
        lambda: (jr2.sync_now() or True) and not jr2.unresolved(),
        timeout=60,
    ), f"WAL entries stranded: {[e['uuid'] for e in jr2.unresolved()]}"
    # The soak must actually have exercised the chaos plane.
    assert (
        net.counters["dropped"]
        + net.counters["duplicated"]
        + net.counters["delayed"]
    ) > 0, "seeded chaos never fired"
    ea2.stop(timeout=1)
    jr2.shutdown()


def addr_s(addr) -> str:
    return f"{addr[0]}:{addr[1]}"
