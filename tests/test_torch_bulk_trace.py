"""Spans and sync counts inside ``solve_bulk`` and the fused dispatch loop.

One pass of the corpus of ``tests/test_torch_bulk.py`` through the fused
first pass and a fused rung (``FUSED``: 11 of the 290 boards reach it),
in four modes: with neither ``trace=`` nor a recorder installed, with
``trace={}``, with a recorder installed, and with both (a ring of 16, far
below the pass's spans).  The dispatches of ``cuda_step._run_fused`` are
counted at ``cuda_step.fused_rounds``, the benchmark's own hook, and its
loop-condition reads as the ``fused.sync`` spans of each call, under a
recording of the test's own where the pass opened none, as
``tests/test_torch_status_pipeline.py`` counts them.
"""

import collections

import numpy as np
import pytest

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.obs import trace, traceck
from distributed_sudoku_solver_tpu_torch.ops import cuda_step
from distributed_sudoku_solver_tpu_torch.ops.bulk import BulkConfig, solve_bulk
from distributed_sudoku_solver_tpu_torch.utils.puzzles import make_puzzle

GEOM = Geometry(2, 3)
FIELDS = ("solution", "solved", "unsat", "by_propagation", "searched")
FUSED = BulkConfig(chunk=64, stack_slots=1, first_pass_steps=1, max_sweeps=1,
                   step_impl="fused", rung_step_impl="fused")
MODES = ("neither", "trace", "recorder", "both")
TRACED = ("trace", "both")
SYNCS = ("fused.sync", "rung.sync", "drain.sync", "finalize.sync")


def _corpus():
    grids = np.stack([make_puzzle(GEOM, 300 + i, n_clues=13, unique=False)
                      for i in range(290)]).astype(np.int32)
    grids[7, 0, :2] = 1  # two 1s in one row: unsat
    return grids


def _reads(run, *a, **k):
    """``run(*a, **k)`` and its ``fused.sync`` spans: counted in the
    current recording, or in one of the test's own where none is open."""
    cur = trace.current()
    if cur is None:
        with trace.recording(keep=True) as own:
            return run(*a, **k), own.counts.get("fused.sync", 0)
    before = cur.counts.get("fused.sync", 0)
    out = run(*a, **k)
    return out, cur.counts["fused.sync"] - before


def _one_pass(grids, mode: str) -> dict:
    """A pass in ``mode`` with the fused loop's reads, rounds and each
    ``_run_fused`` call's current recording counted."""
    reads, rounds, seen = [], [], []
    fused_rounds, run = cuda_step.fused_rounds, cuda_step._run_fused

    def counting_rounds(*a, **k):
        rounds.append(1)
        return fused_rounds(*a, **k)

    def watching_run(*a, **k):
        seen.append(trace.current())
        out, n = _reads(run, *a, **k)
        reads.append(n)
        return out

    rec = trace.TraceRecorder(ring=16 if mode == "both" else 4096)
    tr = {} if mode in TRACED else None
    cuda_step.fused_rounds, cuda_step._run_fused = counting_rounds, watching_run
    try:
        if mode in ("recorder", "both"):
            with trace.installed(rec):
                res = solve_bulk(grids, GEOM, FUSED, trace=tr, device="cpu")
        else:
            res = solve_bulk(grids, GEOM, FUSED, trace=tr, device="cpu")
    finally:
        cuda_step.fused_rounds, cuda_step._run_fused = fused_rounds, run
    return {"res": res, "trace": tr, "reads": sum(reads), "rounds": len(rounds),
            "seen": seen, "recorder": rec, "active_after": trace.active()}


@pytest.fixture(scope="module")
def passes():
    grids = _corpus()
    return {mode: _one_pass(grids, mode) for mode in MODES}


def _spans(p: dict) -> list:
    """The pass's spans: ``trace["spans"]``, or the installed recorder's."""
    if p["trace"] is not None:
        return p["trace"]["spans"]
    return p["recorder"].spans()


def _count(spans, name: str) -> int:
    return sum(1 for s in spans if s["name"] == name)


@pytest.mark.parametrize("mode", MODES[1:])
def test_verdicts_and_syncs_are_those_of_an_untraced_pass(passes, mode):
    """Tracing changes no verdict or solution and adds no host read: the
    fused loop reads its condition and dispatches as often in every mode."""
    got, want = passes[mode], passes["neither"]
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(got["res"], f)),
                              np.asarray(getattr(want["res"], f))), f
    assert got["reads"] == want["reads"] > 0
    assert got["rounds"] == want["rounds"] > 0


def test_the_corpus_reaches_a_fused_rung(passes):
    tr = passes["trace"]["trace"]
    assert tr["remaining_after_first"] == 11 and tr["step_impl"] == "fused"
    assert [r["step_impl"] for r in tr["rungs"]] == ["fused"]
    assert passes["neither"]["res"].unsat[7]


@pytest.mark.parametrize("mode", MODES[1:])
def test_loop_spans_are_the_reads_and_the_dispatches(passes, mode):
    p = passes[mode]
    spans = _spans(p)
    if mode == "both":  # the ring kept 16; trace["spans"] kept every one
        assert len(p["recorder"].spans()) == 16 < len(spans)
    assert _count(spans, "fused.sync") == p["reads"]
    assert _count(spans, "fused.dispatch") == p["rounds"]
    (bulk_pass,) = [s for s in spans if s["name"] == "bulk.pass"]
    assert bulk_pass["attrs"]["k2_dispatches"] == p["rounds"]
    assert bulk_pass["attrs"]["host_syncs"] == sum(_count(spans, n) for n in SYNCS)
    assert bulk_pass["attrs"]["boards"] == 290 and bulk_pass["attrs"]["chunks"] == 5
    if p["trace"] is not None:
        assert p["trace"]["k2_dispatches"] == p["rounds"]
        assert p["trace"]["host_syncs"] == bulk_pass["attrs"]["host_syncs"]


@pytest.mark.parametrize("mode", MODES[1:])
def test_every_span_lies_inside_its_pass_and_carries_its_id(passes, mode):
    spans = _spans(passes[mode])
    (bulk_pass,) = [s for s in spans if s["name"] == "bulk.pass"]
    assert {s["trace"] for s in spans} == {bulk_pass["trace"]}
    assert all(bulk_pass["t0"] <= s["t0"] <= s["t1"] <= bulk_pass["t1"] for s in spans)
    if passes[mode]["trace"] is not None:
        assert passes[mode]["trace"]["trace_id"] == bulk_pass["trace"]
    names = collections.Counter(s["name"] for s in spans)
    for name in ("bulk.first_pass", "bulk.rung"):
        assert names[name] == 1, name
    for name in ("bulk.pack", "bulk.solve", "bulk.drain", "drain.sync"):
        assert names[name] == 5, name
    for name in ("rung.start", "rung.finalize", "finalize.sync"):
        assert names[name] == 1, name
    assert names["rung.advance"] == names["rung.sync"] >= 1


@pytest.mark.parametrize("mode", TRACED)
def test_stage_sums_are_the_sums_of_their_spans(passes, mode):
    tr = passes[mode]["trace"]
    spans = tr["spans"]
    for key, name in (("pack_s", "bulk.pack"), ("solve_s", "bulk.solve"),
                      ("drain_s", "bulk.drain"), ("first_pass_s", "bulk.first_pass")):
        assert tr[key] == sum(s["t1"] - s["t0"] for s in spans if s["name"] == name) > 0, key
    (rung_span,) = [s for s in spans if s["name"] == "bulk.rung"]
    (rung,) = tr["rungs"]
    assert rung["wall_s"] == rung_span["t1"] - rung_span["t0"]
    inside = [s for s in spans if rung_span["t0"] <= s["t0"] and s["t1"] <= rung_span["t1"]
              and s is not rung_span]
    assert rung["k2_dispatches"] == _count(inside, "fused.dispatch") > 0
    assert rung["host_syncs"] == sum(_count(inside, n) for n in SYNCS)
    assert rung["dispatches"] == _count(inside, "rung.advance")
    assert rung_span["attrs"]["k2_dispatches"] == rung["k2_dispatches"]
    assert rung_span["attrs"]["survivors_in"] == 11


def test_no_recording_is_opened_without_trace_or_recorder(passes):
    assert passes["neither"]["seen"] and all(s is None for s in passes["neither"]["seen"])
    assert passes["neither"]["recorder"].spans() == []
    for mode in MODES[1:]:
        seen = passes[mode]["seen"]
        assert seen and all(isinstance(s, trace.Recording) for s in seen), mode
    for mode in MODES:
        assert passes[mode]["active_after"] is None, mode
    assert trace.current() is None


@pytest.mark.parametrize("mode", MODES[1:])
def test_spans_are_kept_only_with_trace(passes, mode):
    """The recording keeps its spans only for ``trace=``; its counts by
    name hold in every mode, and a kept span has the recorder's schema
    whether or not a recorder made it."""
    p = passes[mode]
    (rec,) = set(p["seen"])
    assert rec.counts["fused.dispatch"] == p["rounds"]
    assert rec.counts["fused.sync"] == p["reads"]
    if p["trace"] is None:
        assert rec.spans == []
        return
    assert rec.spans == p["trace"]["spans"]
    made = trace.TraceRecorder().record("u", "x", "x.y", 1.0, t1=2.0)
    for s in rec.spans:
        assert s.keys() == made.keys()
        assert s["trace"] == rec.trace and s["uuids"] == []
    assert len({s["id"] for s in rec.spans}) == len(rec.spans)


def test_perfetto_export_lines_up_with_the_epoch_clock(passes):
    """``ts * 1000 + baseTimeNanoseconds`` is each span's start in epoch
    ns to within 1 µs, as kineto's Chrome export writes device events."""
    spans = passes["trace"]["trace"]["spans"]
    doc = passes["recorder"]["recorder"].perfetto(spans)
    assert traceck.check(doc) == []
    base = doc["baseTimeNanoseconds"]
    assert isinstance(base, int) and base > 1.6e18  # epoch ns, after 2020
    events = sorted((e for e in doc["traceEvents"] if e["ph"] == "X"), key=lambda e: e["ts"])
    starts = sorted(s["t0"] for s in spans)
    assert len(events) == len(starts)
    for e, t0 in zip(events, starts):
        assert abs(e["ts"] * 1000 + base - t0 * 1e9) <= 1000


def test_perfetto_base_on_an_injected_clock():
    rec = trace.TraceRecorder(clock=lambda: 12.5)
    rec.record("u", "a", "x.y", 12.0000014, t1=12.5)
    rec.record("u", "b", "x.y", 12.25, t1=12.5)
    doc = rec.perfetto()
    assert doc["baseTimeNanoseconds"] == 12_000_001_000
    assert [e["ts"] for e in doc["traceEvents"] if e["ph"] == "X"] == [0, 249_999]
    assert trace.TraceRecorder().perfetto()["baseTimeNanoseconds"] == 0
