"""Port parity: the observability modules copied into the port (``obs``).

Twins of the reference's engine-free cases: ``tests/test_critpath.py``'s
decomposition and monitor lanes, ``tests/test_obs.py``'s Prometheus render
(byte-equal to ``tests/data/prometheus_golden.txt`` for the same
``PROM_SAMPLE``, the escape cases, promck clean), and
``tests/test_deadck.py``'s runtime lockdep cases; plus the port's copy of
the lock hierarchy against the JAX package's manifest.  Each case runs on
the JAX package's module and on the port's copy with the same inputs,
keeps the reference's own assertions for both, and requires equal outputs.
"""

import importlib
import json
import logging
import os

import pytest

from distributed_sudoku_solver_tpu.analysis import manifest
from distributed_sudoku_solver_tpu_torch.obs import lock_manifest
from tests.test_obs import GOLDEN, PROM_SAMPLE

PKGS = ("distributed_sudoku_solver_tpu", "distributed_sudoku_solver_tpu_torch")


def obs(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.obs.{name}")


def twin(case, *args):
    """``case(pkg, *args)`` for both packages; requires equal outputs."""
    ref, port = (case(pkg, *args) for pkg in PKGS)
    assert ref == port
    return ref


def test_lock_tables_equal_the_jax_manifest():
    assert lock_manifest.LOCK_RANKS == manifest.LOCK_RANKS
    assert lock_manifest.LOCK_EDGE_DECLARED == manifest.LOCK_EDGE_DECLARED
    w = obs(PKGS[1], "lockdep").manifest_witness(strict=True)
    assert w.ranks == manifest.LOCK_RANKS and w.declared == manifest.LOCK_EDGE_DECLARED


# -- critpath: decomposition and monitor lanes ------------------------------------


def _span(name, site, t0, t1, trace_id="u", node="n0"):
    return {"id": f"{node}/{t0}", "trace": trace_id, "name": name, "site": site,
            "t0": float(t0), "t1": float(t1), "node": node, "uuids": [], "attrs": {}}


def _decompose(pkg, spans, expect):
    critpath = obs(pkg, "critpath")
    d = critpath.decompose(spans)
    if expect is None:
        assert d is None
        return None
    assert sum(d["phases_ms"].values()) == pytest.approx(d["end_to_end_ms"],
                                                         rel=critpath.SUM_TOLERANCE)
    for key, want in expect.items():
        got = d["phases_ms"].get(key, 0.0) if key not in ("end_to_end_ms", "http_ms") else d[key]
        assert got == pytest.approx(want), key
    return d


DECOMPOSE_CASES = {
    "partition": ([
        _span("admission", "engine.launch", 0.0, 1.0),
        _span("chunk.dispatch", "engine.advance", 1.0, 1.2),
        _span("chunk.sync", "fetch.status", 1.2, 2.0),
        _span("verdict.sync", "fetch.event", 2.0, 2.2),
        _span("send.TASK", "cluster.send", 2.2, 2.3),
        _span("recovery.requeue", "engine.recovery", 2.3, 2.4),
        _span("resolve", "engine.resolve", 2.5, 2.5),
    ], {"end_to_end_ms": 2500.0, "queue": 1000.0, "dispatch": 200.0, "sync": 800.0,
        "event": 200.0, "wire": 100.0, "recovery": 100.0, "other": 100.0}),
    "overlap_by_priority": ([
        _span("chunk.dispatch", "engine.advance", 0.0, 1.0),
        _span("chunk.sync", "fetch.status", 0.5, 1.5),
        _span("resolve", "engine.resolve", 1.5, 1.5),
    ], {"sync": 1000.0, "dispatch": 500.0}),
    "empty": ([], None),
    "zero_width": ([_span("resolve", "engine.resolve", 1.0, 1.0)], None),
    "markers": ([
        _span("http.solve", "http", 0.0, 3.0),
        _span("admission", "engine.launch", 0.5, 1.0),
        _span("resolve", "engine.resolve", 2.0, 2.0),
    ], {"end_to_end_ms": 2000.0, "http_ms": 3000.0, "queue": 500.0}),
    "megastep_is_dispatch": ([
        _span("admission", "megastep.attach", 0.0, 1.0),
        _span("megastep.chunk.dispatch", "megastep.advance", 1.0, 2.5),
        _span("megastep.sync", "megastep.fetch.status", 2.3, 2.5),
        _span("resolve", "engine.resolve", 2.5, 2.5),
    ], {"end_to_end_ms": 2500.0, "queue": 1000.0, "dispatch": 1500.0, "sync": 0.0}),
}


@pytest.mark.parametrize("name", list(DECOMPOSE_CASES))
def test_critpath_decompose_case(name):
    spans, expect = DECOMPOSE_CASES[name]
    d = twin(_decompose, spans, expect)
    if name == "partition":
        assert d["shares"]["queue"] == pytest.approx(0.4)


def _classify(pkg):
    critpath = obs(pkg, "critpath")
    out = [critpath.classify(_span("megastep.sync", "megastep.fetch.status", 0, 1)),
           critpath.classify(_span("megastep.chunk.dispatch", "megastep.advance", 0, 1))]
    assert out == [None, "dispatch"]
    return out


def test_critpath_classify_megastep_sites():
    twin(_classify)


def _feed(rec, uuid, t0=0.0):
    rec.record(uuid, "admission", "engine.launch", t0 + 0.0, t1=t0 + 0.1)
    rec.record(None, "chunk.sync", "fetch.status", t0 + 0.1, t1=t0 + 0.4, uuids=[uuid])
    rec.event(uuid, "resolve", "engine.resolve")


def _monitor(pkg):
    trace, critpath = obs(pkg, "trace"), obs(pkg, "critpath")
    t = [0.5]
    rec = trace.TraceRecorder(clock=lambda: t[0])
    mon = critpath.CritPathMonitor(clock=lambda: t[0])
    try:
        with trace.installed(rec), critpath.installed(mon):
            for i in range(3):
                _feed(rec, f"u{i}")
                mon.observe_job(f"u{i}", 0.5)
    finally:
        critpath.install(None)
        trace.install(None)
    m = mon.metrics()
    assert m["jobs"] == 3
    assert m["attribution_ms"]["sync"] == pytest.approx(900.0)
    assert m["attribution_ms"]["queue"] == pytest.approx(300.0)
    assert m["shares_pct"]["sync"] == pytest.approx(60.0)
    assert m["slow_jobs"] == 0 and "threshold_ms" not in m
    hd = mon.hist_dicts()
    assert sum(hd["critpath_sync_ms"]["counts"]) == 3
    assert sum(hd["critpath_queue_ms"]["counts"]) == 3
    return m, hd, rec.spans("u1")


def test_critpath_monitor_aggregates_hists_and_shares():
    twin(_monitor)


def _watchdog(pkg, tmp_path, caplog):
    trace, critpath, slo = obs(pkg, "trace"), obs(pkg, "critpath"), obs(pkg, "slo")
    dump_dir = tmp_path / pkg
    dump_dir.mkdir()
    t = [1.0]
    rec = trace.TraceRecorder(clock=lambda: t[0], dump_dir=str(dump_dir))
    mon = critpath.CritPathMonitor(dump_cooldown_s=30.0, clock=lambda: t[0])
    caplog.clear()
    try:
        with trace.installed(rec), critpath.installed(mon):
            _feed(rec, "ua")
            mon.observe_job("ua", 9.9)
            assert mon.slow_jobs == 0
            slo.install(slo.SloMonitor(slo.parse_slo("solve_p95_ms<=250,job_p99_ms<=400"),
                                       clock=lambda: t[0]))
            assert mon.threshold_ms() == 250.0
            with caplog.at_level(logging.WARNING):
                _feed(rec, "ub")
                mon.observe_job("ub", 0.5)
            assert mon.slow_jobs == 1 and mon.slow_dumps == 1
            dumps = [f for f in os.listdir(dump_dir) if "slow_job" in f]
            assert len(dumps) == 1
            doc = json.loads((dump_dir / dumps[0]).read_text())
            assert doc["metrics"]["uuid"] == "ub"
            assert any("[critpath] slow job" in r.getMessage() for r in caplog.records)
            _feed(rec, "uc")
            mon.observe_job("uc", 0.5)
            assert mon.slow_jobs == 2 and mon.slow_dumps == 1
            t[0] += 31.0
            _feed(rec, "ud")
            mon.observe_job("ud", 0.5)
            assert mon.slow_dumps == 2
    finally:
        critpath.install(None)
        slo.install(None)
        trace.install(None)
    assert critpath.CritPathMonitor(slow_ms=7.0).threshold_ms() == 7.0
    return doc["metrics"], mon.metrics()


def test_critpath_watchdog_dumps_with_cooldown_and_slo_threshold(tmp_path, caplog):
    twin(_watchdog, tmp_path, caplog)


# -- Prometheus exposition and its lint ------------------------------------------------


def test_prometheus_render_matches_golden_file():
    want = open(GOLDEN).read()
    got = twin(lambda pkg: obs(pkg, "prom").render(PROM_SAMPLE))
    assert got == want


@pytest.mark.parametrize("sample", [
    {"s": 'a"b\\c\nd', "n": 1.25},
    {},
    {"nested": {"x": 1, "y": {"z": 2.5}}, "flag": True, "label": "v"},
], ids=["escapes", "empty", "nested"])
def test_prometheus_render_escapes_and_shapes(sample):
    out = twin(lambda pkg: obs(pkg, "prom").render(sample))
    if "s" in sample:
        assert 'dsst_s{s="a\\"b\\\\c\\nd"} 1' in out
        assert "dsst_n 1.25" in out and out.endswith("\n")
    if not sample:
        assert out == ""


def test_prometheus_sample_passes_promck():
    findings = twin(lambda pkg: obs(pkg, "promck").check_text(obs(pkg, "prom").render(
        PROM_SAMPLE)))
    assert findings == []
    bad = twin(lambda pkg: obs(pkg, "promck").check_text("dsst_x{a=1} 1\n"))
    assert bad


# -- lockdep: the runtime witness ---------------------------------------------------------


def _rank_violation(lockdep):
    w = lockdep.LockWitness(ranks={"lo": 1, "hi": 2}, declared={})
    lo, hi = lockdep.named_lock("lo"), lockdep.named_lock("hi")
    with lockdep.installed(w):
        with lo:
            with hi:
                pass
        with hi:
            with pytest.raises(lockdep.LockOrderError):
                lo.acquire()
    assert [v["edge"] for v in w.violations] == [["hi", "lo"]]
    assert ("lo", "hi") in set(w.graph())
    return w.report()


def _cycle(lockdep):
    w = lockdep.LockWitness(ranks={}, declared={("a", "b"): "r", ("b", "a"): "r"})
    a, b = lockdep.named_lock("a"), lockdep.named_lock("b")
    with lockdep.installed(w):
        with a:
            with b:
                pass
        with b:
            with pytest.raises(lockdep.LockOrderError):
                a.acquire()
    assert any("cycle" in v["problem"] for v in w.violations)
    return w.report()


def _self_deadlock(lockdep):
    w = lockdep.LockWitness(ranks={"x": 1}, declared={})
    x = lockdep.named_lock("x")
    with lockdep.installed(w):
        with x:
            with pytest.raises(lockdep.LockOrderError):
                x.acquire()
    assert any("self-deadlock" in v["problem"] for v in w.violations)
    return w.report()


def _unknown(lockdep):
    w = lockdep.LockWitness(ranks={"known": 1}, declared={})
    known, ghost = lockdep.named_lock("known"), lockdep.named_lock("ghost")
    with lockdep.installed(w):
        with known:
            with pytest.raises(lockdep.LockOrderError):
                ghost.acquire()
    assert "LOCK_RANKS" in w.violations[0]["problem"]
    return w.report()


def _rlock_reentry(lockdep):
    w = lockdep.LockWitness(ranks={"outer": 1, "inner": 2}, declared={})
    outer, inner = lockdep.named_rlock("outer"), lockdep.named_lock("inner")
    with lockdep.installed(w):
        with outer:
            with inner:
                with outer:
                    pass
    assert w.violations == []
    assert set(w.graph()) == {("outer", "inner")}
    return w.report()


LOCKDEP_CASES = {"rank_violation": _rank_violation, "cycle": _cycle,
                 "self_deadlock": _self_deadlock, "unknown_lock": _unknown,
                 "rlock_reentry": _rlock_reentry}


@pytest.mark.parametrize("name", list(LOCKDEP_CASES))
def test_lockdep_witness_case(name):
    twin(lambda pkg: LOCKDEP_CASES[name](obs(pkg, "lockdep")))


# -- histograms and the cluster roll-up --------------------------------------------------------


def _hist(pkg, values):
    hist, agg = obs(pkg, "hist"), obs(pkg, "agg")
    h = hist.LatencyHistogram()
    for v in values:
        h.record(v)
    d = h.to_dict()
    merged = hist.merge_hist(hist.merge_hist(None, d), d)
    assert hist.hist_count(merged) == 2 * len(values)
    quantiles = [hist.hist_quantile(merged, q) for q in (0.5, 0.99)]
    floor = hist.MinEstimator(window=8)
    for v in values[:8]:
        floor.record(v)
    body = {"hist": {"latency_ms": d}, "rpc_floor_ms": floor.to_dict(),
            "critpath": {"jobs": 1, "attribution_ms": {"sync": 3.0, "queue": 1.0}}}
    return d, merged, quantiles, agg.rollup([body, None, body])


@pytest.mark.parametrize("values", [[0.0005, 0.001, 0.002, 0.25, 10.0], [], [0.0033] * 100],
                         ids=["spread", "empty", "repeated"])
def test_latency_histogram_and_rollup_case(values):
    twin(_hist, values)
