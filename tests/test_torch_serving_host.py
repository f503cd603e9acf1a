"""Port parity: the serving host layers copied into the port (faults, journal, brownout, StatWindow).

Twins of the reference's engine-free cases (``tests/test_faults.py``'s unit
lane, ``tests/test_journal.py``'s WAL cases, ``tests/test_brownout.py``'s
unit lane, ``tests/test_profiling.py``'s ``StatWindow`` cases).  Each case
runs on the JAX package's module and on the port's copy with the same
inputs, keeps the reference's own assertions for both, and requires equal
outputs (for the journal: byte-identical segment files).
"""

import importlib
import os
import threading

import numpy as np
import pytest

PKGS = ("distributed_sudoku_solver_tpu", "distributed_sudoku_solver_tpu_torch")
EASY = np.asarray([[5, 3, 0, 0, 7, 0, 0, 0, 0]] * 9, np.int32)


def both(module: str) -> list:
    """The module in the JAX package and in the port."""
    return [importlib.import_module(f"{pkg}.{module}") for pkg in PKGS]


def twin(case, module: str, *args):
    """``case(mod, *args)`` on both packages' ``module``; returns the two
    outputs after requiring them equal."""
    ref, port = (case(m, *args) for m in both(module))
    assert ref == port
    return ref


class FakeClock:
    """Injectable clock: transitions advance when the test says so."""

    def __init__(self, t0: float = 1000.0):
        self.t = t0
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            return self.t

    def advance(self, dt: float) -> None:
        with self._lock:
            self.t += dt


# -- faults: the unit lane -------------------------------------------------------


def _taxonomy(faults):
    out = [
        faults.classify(faults.SimulatedFault("oom", "s", 0)),
        faults.classify(faults.SimulatedFault("preempt", "s", 0)),
        faults.classify(faults.SimulatedFault("permanent", "s", 0)),
        faults.classify(ValueError("shape mismatch")),
        faults.classify(RuntimeError("device hiccup")),
        faults.classify_message("ValueError: grid shape"),
        faults.classify_message("engine stopped"),
        faults.classify_message(None),
        faults.classify_message("INVALID_ARGUMENT: poisoned [permanent]"),
        faults.is_oom(faults.SimulatedFault("oom", "s", 0)),
        faults.is_oom("RESOURCE_EXHAUSTED: whatever"),
        faults.is_oom(RuntimeError("preempted")),
        str(faults.SimulatedFault("delay", "engine.advance", 4)),
    ]
    T, P = faults.TRANSIENT, faults.PERMANENT
    assert out[:12] == [T, T, P, P, T, P, T, T, P, True, True, False]
    return out


def test_fault_taxonomy():
    twin(_taxonomy, "serving.faults")


def _seeded(faults, seed, rate):
    a = faults.FaultSchedule.seeded(seed=seed, rate=rate)
    b = faults.FaultSchedule.seeded(seed=seed, rate=rate)
    fwd = [a.lookup("engine.advance", i) for i in range(200)]
    rev = [b.lookup("engine.advance", i) for i in reversed(range(200))]
    assert fwd == rev[::-1]
    hits = sum(1 for k in fwd if k is not None)
    assert 0.4 * rate * 200 <= hits <= 2 * rate * 200 + 10, hits
    other = [a.lookup("resident.advance", i) for i in range(200)]
    assert fwd != other
    c = faults.FaultSchedule.seeded(seed=seed + 1, rate=rate)
    assert fwd != [c.lookup("engine.advance", i) for i in range(200)]
    with pytest.raises(ValueError):
        faults.FaultSchedule.seeded(seed=1, rate=0.5, kinds=("nope",))
    bulk = [a.lookup("bulk.dispatch", i) for i in range(64)]
    return fwd, other, bulk


@pytest.mark.parametrize("seed,rate", [(11, 0.3), (0, 0.1), (12345, 0.5)])
def test_seeded_schedule_draws_the_same_bits(seed, rate):
    twin(_seeded, "serving.faults", seed, rate)


def _injector(faults):
    inj = faults.FaultInjector(faults.FaultSchedule.at({"x": {1: "preempt"}}),
                               poison_jobs=("bad",))
    inj.fire("x", uuids=("good",))
    with pytest.raises(faults.SimulatedFault) as exc:
        inj.fire("x", uuids=("good",))
    first = (exc.value.kind, exc.value.transient)
    assert first == ("preempt", True)
    with pytest.raises(faults.SimulatedFault) as exc:
        inj.fire("y", uuids=("good", "bad"))
    second = (exc.value.kind, exc.value.transient)
    assert second == ("permanent", False)
    m = inj.metrics()
    assert m["dispatches"] == {"x": 2, "y": 1}
    assert m["injected"] == {"x:preempt": 1, "y:permanent": 1}
    assert inj.dispatches() == 3
    faults.fire("anywhere", uuids=("bad",))  # nothing installed: a no-op
    with faults.injected(inj):
        faults.fire("x")
        assert faults.active() is inj
    assert faults.active() is None
    return first, second, inj.metrics()


def test_injector_counts_sites_and_poisons_jobs():
    twin(_injector, "serving.faults")


def _breaker(faults):
    clock = FakeClock()
    pol = faults.RecoveryPolicy(breaker_failures=3, breaker_cooldown_s=10.0, clock=clock)
    br = faults.CircuitBreaker(pol)
    seen = []

    def note():
        seen.append((br.state, br.consecutive_failures))

    assert br.state == br.CLOSED and br.allow()
    br.record_failure()
    br.record_failure()
    assert br.state == br.CLOSED and br.allow()
    br.record_failure()
    note()
    assert br.state == br.OPEN and not br.allow()
    clock.advance(9.9)
    assert not br.allow()
    clock.advance(0.2)
    assert br.allow() and br.state == br.HALF_OPEN
    assert not br.allow()
    note()
    clock.advance(10.1)
    assert br.allow() and br.state == br.HALF_OPEN
    assert not br.allow()
    br.record_failure()
    note()
    assert br.state == br.OPEN and not br.allow()
    clock.advance(10.1)
    assert br.allow() and br.state == br.HALF_OPEN
    br.record_success()
    note()
    assert br.state == br.CLOSED and br.consecutive_failures == 0
    assert br.metrics()["transitions"] == 5
    br.record_failure()
    br.record_success()
    br.record_failure()
    br.record_failure()
    assert br.state == br.CLOSED
    note()
    return seen, br.metrics()


def test_breaker_state_machine_on_fake_clock():
    twin(_breaker, "serving.faults")


# -- journal: the WAL unit layer ---------------------------------------------------


def _segments(path):
    return {n: open(os.path.join(path, n), "rb").read() for n in sorted(os.listdir(path))
            if n.startswith("wal-")}


def _journal_case(name, tmp_path, caplog):
    """Run one WAL case on each package's journal in its own directory;
    returns (outputs, segment files) per package."""
    results = []
    for pkg in PKGS:
        journal = importlib.import_module(f"{pkg}.serving.journal")
        faults = importlib.import_module(f"{pkg}.serving.faults")
        path = tmp_path / pkg
        path.mkdir()
        caplog.clear()
        out = JOURNAL_CASES[name](journal.Journal, faults, str(path), caplog)
        results.append((out, _segments(str(path))))
    assert results[0] == results[1]
    return results[0]


def _roundtrip(Journal, faults, path, caplog):
    jr = Journal(path, fsync_interval_s=60.0)
    jr.record_accepted("u1", grid=EASY, deadline_s=2.5)
    jr.record_accepted("u2", grid=EASY)
    jr.record_resolved("u1", {"solved": True, "nodes": 7})
    jr.sync_now()
    un = jr.unresolved()
    assert [ev["uuid"] for ev in un] == ["u2"]
    assert un[0]["grid"] == EASY.tolist()
    m = jr.metrics()
    assert m["accepted"] == 2 and m["resolved"] == 1 and m["durable"]
    jr.shutdown()
    jr2 = Journal(path)
    again = jr2.unresolved()
    assert [ev["uuid"] for ev in again] == ["u2"]
    jr2.shutdown()
    return un, m, again


def _torn_tail(Journal, faults, path, caplog):
    jr = Journal(path, fsync_interval_s=60.0)
    jr.record_accepted("u1", grid=EASY)
    jr.record_accepted("u2", grid=EASY)
    jr.sync_now()
    jr.shutdown()
    segs = sorted(n for n in os.listdir(path) if n.startswith("wal-"))
    target = next(os.path.join(path, n) for n in reversed(segs)
                  if os.path.getsize(os.path.join(path, n)) > 0)
    with open(target, "a", encoding="utf-8") as fh:
        fh.write('{"kind": "resolved", "uuid": "u')
    jr2 = Journal(path)
    first = sorted(ev["uuid"] for ev in jr2.unresolved())
    assert first == ["u1", "u2"], "torn tail corrupted recovery"
    jr2.record_accepted("u3", grid=EASY)
    jr2.sync_now()
    second = sorted(ev["uuid"] for ev in jr2.unresolved())
    assert second == ["u1", "u2", "u3"]
    jr2.shutdown()
    return first, second


def _append_fault(Journal, faults, path, caplog):
    jr = Journal(path, fsync_interval_s=60.0)
    with faults.injected(faults.FaultInjector(
            faults.FaultSchedule.at({"journal.append": {0: "runtime"}}))):
        with caplog.at_level("ERROR"):
            jr.record_accepted("u1", grid=EASY)  # must not raise
    assert not jr.durable
    m = jr.metrics()
    assert m["append_failures"] == 1
    assert any("DEGRADED" in r.getMessage() for r in caplog.records)
    jr.record_accepted("u2", grid=EASY)
    m2 = jr.metrics()
    assert m2["dropped_non_durable"] >= 1
    jr.shutdown()
    return m, m2


def _fsync_fault(Journal, faults, path, caplog):
    jr = Journal(path, fsync_interval_s=60.0)
    jr.record_accepted("u1", grid=EASY)
    with faults.injected(faults.FaultInjector(
            faults.FaultSchedule.at({"journal.fsync": {0: "runtime"}}))):
        jr.sync_now()  # must not raise
    assert not jr.durable
    m = jr.metrics()
    assert m["fsync_failures"] == 1
    jr.record_accepted("u2", grid=EASY)
    jr.shutdown()
    return m


def _two_scans(Journal, faults, path, caplog):
    import json

    jr = Journal(path, fsync_interval_s=60.0)
    for i in range(6):
        jr.record_accepted(f"u{i}", grid=EASY, deadline_s=float(i))
    jr.record_resolved("u1", {"solved": True})
    jr.record_resolved("u4", {"unsat": True})
    jr.sync_now()
    jr.shutdown()
    scans = []
    for _ in range(2):
        j = Journal(path)
        scans.append(json.dumps(j.unresolved(), sort_keys=True).encode())
        j.shutdown()
    assert scans[0] == scans[1]
    j = Journal(path)
    order = [ev["uuid"] for ev in j.unresolved()]
    j.shutdown()
    assert order == ["u0", "u2", "u3", "u5"]
    return scans[0], order


def _compaction(Journal, faults, path, caplog):
    jr = Journal(path, segment_bytes=4096, fsync_interval_s=60.0, compact_min_resolved=1)
    for i in range(64):
        jr.record_accepted(f"u{i}", grid=EASY)
        jr.record_resolved(f"u{i}", {"solved": True})
    jr.record_accepted("live", grid=EASY)
    jr.compact()
    m = jr.metrics()
    assert m["compactions"] >= 1 and m["segments_removed"] >= 1
    segs = [n for n in os.listdir(path) if n.startswith("wal-")]
    assert len(segs) == 1, f"compaction left segments behind: {segs}"
    assert [ev["uuid"] for ev in jr.unresolved()] == ["live"]
    jr.shutdown()
    jr2 = Journal(path)
    assert [ev["uuid"] for ev in jr2.unresolved()] == ["live"]
    jr2.shutdown()
    return m


JOURNAL_CASES = {
    "roundtrip": _roundtrip,
    "torn_tail": _torn_tail,
    "append_fault": _append_fault,
    "fsync_fault": _fsync_fault,
    "two_scans": _two_scans,
    "compaction": _compaction,
}


@pytest.mark.parametrize("name", list(JOURNAL_CASES))
def test_journal_wal_case(name, tmp_path, caplog):
    _journal_case(name, tmp_path, caplog)


# -- brownout: the unit lane -------------------------------------------------------


def _ctrl(brownout, clock, press, **cfg_kw):
    defaults = dict(enter=1.0, exit=0.5, quiet_s=5.0, hold_s=1.0, eval_interval_s=0.0)
    defaults.update(cfg_kw)
    return brownout.BrownoutController(brownout.BrownoutConfig(**defaults), clock=clock,
                                       signals={"burn": lambda: press[0]})


def _config_rejects(brownout):
    for kw in (dict(enter=1.0, exit=1.0), dict(enter=0.5, exit=0.8), dict(floor_drift=1.0)):
        with pytest.raises(ValueError):
            brownout.BrownoutConfig(**kw)
    return sorted(vars(brownout.BrownoutConfig()).items())


def _escalates(brownout):
    clock, press = FakeClock(), [2.0]
    ctrl = _ctrl(brownout, clock, press, hold_s=1.0)
    stages = [ctrl.evaluate()]
    for dt in (0.5, 0.6, 1.1, 10.0):
        clock.advance(dt)
        stages.append(ctrl.evaluate())
    assert stages == [1, 1, 2, 3, 3]
    assert ctrl.escalations == 3 and ctrl.transitions == 3
    assert ctrl.stage_entered == [0, 1, 1, 1]
    return stages, ctrl.metrics()


def _hysteresis(brownout):
    clock, press = FakeClock(), [2.0]
    ctrl = _ctrl(brownout, clock, press, quiet_s=2.0)
    ctrl.evaluate()
    assert ctrl.stage() == 1
    press[0] = 0.75
    for _ in range(10):
        clock.advance(5.0)
        assert ctrl.evaluate() == 1
    seen = []
    for p, dt in ((0.2, 1.0), (0.75, 1.5), (0.2, 1.0), (0.2, 2.1)):
        press[0] = p
        clock.advance(dt)
        seen.append(ctrl.evaluate())
    assert seen == [1, 1, 1, 0]
    assert ctrl.deescalations == 1 and ctrl.transitions == 2
    return seen, ctrl.metrics()


def _full_cycle(brownout):
    clock, press = FakeClock(), [1.5]
    ctrl = _ctrl(brownout, clock, press, hold_s=0.5, quiet_s=2.0)
    for _ in range(5):
        ctrl.evaluate()
        clock.advance(0.6)
    assert ctrl.stage() == 3
    press[0] = 0.0
    for _ in range(5):
        clock.advance(2.1)
        ctrl.evaluate()
    assert ctrl.stage() == 0
    assert ctrl.transitions == 6 and ctrl.escalations == 3 and ctrl.deescalations == 3
    press[0] = 1.5
    for _ in range(5):
        ctrl.evaluate()
        clock.advance(0.6)
    assert ctrl.stage() == 3 and ctrl.escalations == 6
    m = ctrl.metrics()
    assert m["transitions"] == 9
    assert m["stage_entered"] == [1, 3, 3, 2]
    assert sum(m["stage_residency_s"]) == pytest.approx(clock() - 1000.0, abs=1e-6)
    return m


def _gate_matrix(brownout):
    clock, press = FakeClock(), [2.0]
    ctrl = _ctrl(brownout, clock, press, hold_s=0.0)
    expected = {
        0: {"easy": brownout.SERVE, "hard": brownout.SERVE},
        1: {"easy": brownout.NATIVE_ONLY, "hard": brownout.SERVE},
        2: {"easy": brownout.SHED, "hard": brownout.SERVE},
        3: {"easy": brownout.SHED, "hard": brownout.SHED},
    }
    press[0] = 0.75
    rows = []
    for stage in range(4):
        for tier, want in expected[stage].items():
            got = ctrl.gate(tier)
            assert got == (want, stage), (stage, tier)
            rows.append(got)
        if stage < 3:
            press[0] = 2.0
            ctrl.evaluate()
            press[0] = 0.75
    statuses = (brownout.BrownoutShed(2, 1.0, "easy").status,
                brownout.BrownoutShed(3, 1.0, "hard").status)
    assert statuses == (503, 429)
    return rows, statuses


def _floor_signal(brownout):
    class _Floor:
        def __init__(self, d):
            self._d = d

        def to_dict(self):
            return self._d

    class _Eng:
        def __init__(self, d):
            self.rpc_floor = _Floor(d)

        def _resident_flights(self):
            return []

    cfg = brownout.BrownoutConfig(floor_drift=4.0)
    out = [brownout.engine_signals(_Eng({"type": "min_est", "min": 50.0, "recent": r}), cfg)
           ["floor"]() for r in (50.0, 200.0, 125.0)]
    assert out[0] == 0.0 and out[1] == pytest.approx(1.0)
    return out


def _broken_signals(brownout):
    def explode():
        raise RuntimeError("signal backend gone")

    ctrl = brownout.BrownoutController(brownout.BrownoutConfig(eval_interval_s=0.0),
                                       clock=FakeClock(),
                                       signals={"burn": explode, "queue": lambda: None})
    assert ctrl.evaluate() == 0
    assert ctrl.metrics()["pressure"] == {}
    return ctrl.metrics()


BROWNOUT_CASES = {
    "config_rejects": _config_rejects,
    "escalates": _escalates,
    "hysteresis": _hysteresis,
    "full_cycle": _full_cycle,
    "gate_matrix": _gate_matrix,
    "floor_signal": _floor_signal,
    "broken_signals": _broken_signals,
}


@pytest.mark.parametrize("name", list(BROWNOUT_CASES))
def test_brownout_unit_case(name):
    twin(BROWNOUT_CASES[name], "serving.brownout")


def _shed_observations(slo):
    clock = FakeClock()
    mon = slo.SloMonitor(slo.parse_slo("error_rate<=0.1,solve_p95_ms<=250"), window_s=60.0,
                         clock=clock, min_samples=1)
    for _ in range(5):
        mon.observe(300.0 / 1e3, error=False, stream="solve")
    for _ in range(50):
        mon.observe(0.001, error=False, stream="solve", shed=True)
    snap = mon.burn_snapshot()
    lat = snap["solve_p95_ms<=250"]
    assert lat["window_total"] == 5 and lat["window_bad"] == 5 and lat["burning"]
    err = snap["error_rate<=0.1"]
    assert err["window_total"] == 55 and err["window_bad"] == 0
    mon.observe(0.001, error=True, stream="solve", shed=True)
    after = mon.burn_snapshot()
    assert after["error_rate<=0.1"]["window_bad"] == 0
    return snap, after


def _burn_decay(slo):
    clock = FakeClock()
    mon = slo.SloMonitor(slo.parse_slo("error_rate<=0.1,solve_p95_ms<=250"), window_s=12.0,
                         clock=clock)
    for _ in range(20):
        mon.observe(0.01, error=True, stream="solve")
    snap = mon.burn_snapshot()
    err = snap["error_rate<=0.1"]
    assert err["burn_rate"] == pytest.approx(10.0)
    assert err["headroom"] == pytest.approx(1.0 - 10.0)
    assert err["burning"] and err["window_total"] == 20 and err["window_bad"] == 20
    lat = snap["solve_p95_ms<=250"]
    assert lat["burn_rate"] == 0.0 and not lat["burning"]
    clock.advance(15.0)
    snap2 = mon.burn_snapshot()
    assert snap2["error_rate<=0.1"]["burn_rate"] == 0.0
    assert snap2["error_rate<=0.1"]["window_total"] == 0
    return snap, snap2


@pytest.mark.parametrize("case", [_shed_observations, _burn_decay], ids=["shed", "decay"])
def test_slo_burn_snapshot_case(case):
    twin(case, "obs.slo")


# -- StatWindow ----------------------------------------------------------------------


def _window(profiling, capacity, values):
    w = profiling.StatWindow(capacity=capacity)
    assert w.snapshot() is None
    for v in values:
        w.record(v)
    snap = w.snapshot()
    assert snap["count"] == min(capacity, len(values)) and snap["total"] == len(values)
    survivors = values[-capacity:]
    assert min(survivors) <= snap["p50"] <= snap["p95"] <= snap["p99"] <= max(survivors)
    return snap


@pytest.mark.parametrize("capacity,values", [
    (8, [5.0]),  # one sample: every percentile is that sample
    (4, [1.0, 2.0, 3.0, 4.0, 5.0]),  # capacity + 1: the oldest is gone
    (8, [float(v) for v in range(1, 101)]),  # many wraps: 93..100 survive
], ids=["single", "capacity_plus_one", "full_wraparound"])
def test_statwindow_case(capacity, values):
    snap = twin(_window, "utils.profiling", capacity, values)
    if len(values) == 1:
        assert snap["p50"] == snap["p95"] == snap["p99"] == 5.0
    if capacity == 4:
        assert 3.0 <= snap["p50"] <= 4.0


def test_statwindow_concurrent_writer_reader_torn_window():
    """A reader racing the writer gets a consistent-enough snapshot: no
    exception, no value outside the recorded range, count within capacity."""
    from distributed_sudoku_solver_tpu_torch.utils.profiling import StatWindow

    w = StatWindow(capacity=64)
    stop = threading.Event()
    errors = []

    def writer():
        v = 0
        while not stop.is_set():
            w.record((v % 100) / 100.0)
            v += 1

    def reader():
        try:
            while not stop.is_set():
                snap = w.snapshot()
                if snap is None:
                    continue
                assert 1 <= snap["count"] <= 64
                assert 0.0 <= snap["p50"] <= snap["p99"] < 1.0
        except AssertionError as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=writer)] + [threading.Thread(target=reader)
                                                   for _ in range(3)]
    for t in threads:
        t.start()
    threading.Event().wait(0.3)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert w.snapshot()["total"] > 0
