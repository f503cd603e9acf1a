"""The benchmark's harness on the CPU: lookup by name, seeded inputs, the
open loop, the judge, the result line and the import rules.

    python -m pytest portbench/tests -q -p no:randomly

Tests marked ``cuda`` need a card and skip without one.
"""

from __future__ import annotations

import ast
import http.server
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from portbench import core
from portbench.gen import arrivals
from portbench.gen import boards as gen
from portbench.reference.sudoku import keeps_givens, right_answers, valid_grids
from portbench.tests.cells import later_bench

BENCH = core.spec()
LATER = later_bench()
PKG = os.path.join(core.ROOT, "portbench")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"] + LATER["workloads"]])
def test_every_piece_of_a_cell_is_found_by_name(workload):
    cell = core.resolve(workload, BENCH if workload in {w["name"] for w in BENCH["workloads"]}
                        else LATER)
    assert cell["config"]["name"] == cell["workload"]["config"]
    assert callable(core.driver(cell["traffic"]["kind"]).run)
    assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    for m in cell["per_layer"]:
        assert callable(core.reader(m["name"]))


def test_every_metric_has_a_reader_and_every_config_a_file():
    for bench in (BENCH, LATER):
        for m in bench["per_layer"]:
            assert callable(core.reader(m["name"])), m["name"]
            assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    with pytest.raises(KeyError):
        core.resolve("sudoku9-serve-device", BENCH)
    assert not cells & {w["name"] for w in LATER["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    for c in BENCH["configs"]:
        cfg = core.load_json(os.path.join(core.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])


def test_reader_of_a_missing_reading_returns_none():
    names = [f[:-3] for f in os.listdir(os.path.join(PKG, "metrics")) if f.endswith(".py")
             and f != "__init__.py"]
    assert {m["name"] for m in BENCH["per_layer"]} <= set(names)
    for name in names:
        assert core.reader(name)({}) is None, name


def _count_solutions(board: np.ndarray, box_h: int, box_w: int, limit: int = 2) -> int:
    """Solutions of ``board`` up to ``limit``, by a plain depth-first search
    with naked and hidden singles, branching on the cell with the fewest
    candidates (independent of ``corpus.c``)."""
    n = box_h * box_w
    full = (1 << n) - 1
    units = [[r * n + c for c in range(n)] for r in range(n)]
    units += [[r * n + c for r in range(n)] for c in range(n)]
    units += [[(br + i) * n + bc + j for i in range(box_h) for j in range(box_w)]
              for br in range(0, n, box_h) for bc in range(0, n, box_w)]
    peers = [set() for _ in range(n * n)]
    for u in units:
        for c in u:
            peers[c].update(u)
        for c in u:
            peers[c].discard(c)
    peers = [sorted(p) for p in peers]

    def assign(cand, c, bit):
        """Fix cell ``c`` to ``bit`` and propagate; False on a contradiction."""
        todo = [(c, bit)]
        while todo:
            c, bit = todo.pop()
            if not cand[c] & bit:
                return False
            cand[c] = bit
            for p in peers[c]:
                if cand[p] & bit:
                    cand[p] &= ~bit
                    if not cand[p]:
                        return False
                    if cand[p] & (cand[p] - 1) == 0:
                        todo.append((p, cand[p]))
        return True

    def hidden(cand):
        changed = True
        while changed:
            changed = False
            for u in units:
                for d in range(n):
                    bit = 1 << d
                    where = [c for c in u if cand[c] & bit]
                    if not where:
                        return False
                    if len(where) == 1 and cand[where[0]] != bit:
                        if not assign(cand, where[0], bit):
                            return False
                        changed = True
        return True

    cand = [full] * (n * n)
    for c, v in enumerate(int(v) for v in board.reshape(-1)):
        if v and not assign(cand, c, 1 << (v - 1)):
            return 0
    found = 0

    def go(cand):
        nonlocal found
        if not hidden(cand):
            return
        open_ = [c for c in range(n * n) if cand[c] & (cand[c] - 1)]
        if not open_:
            found += 1
            return
        c = min(open_, key=lambda c: bin(cand[c]).count("1"))
        m = cand[c]
        while m and found < limit:
            bit = m & -m
            m ^= bit
            nxt = list(cand)
            if assign(nxt, c, bit):
                go(nxt)

    go(cand)
    return found


@pytest.mark.parametrize("name,box,clues,sample", [("sudoku9-24", (3, 3), 24, 12),
                                                   ("sudoku16-93", (4, 4), 93, 2)])
def test_corpus_puzzles_have_their_solution_and_no_other(name, box, clues, sample):
    p, s, bh, bw = gen.corpus(name)
    assert (bh, bw) == box and p.shape == s.shape and p.shape[1:] == (bh * bw,) * 2
    assert right_answers(p, s, bh, bw).all()
    assert ((p > 0).reshape(len(p), -1).sum(1) == clues).all()
    # No two puzzles are alike, and none two that share a solution grid.
    assert len(np.unique(s.reshape(len(s), -1), axis=0)) == len(s)
    for i in gen.rng(1, "unique").choice(len(p), sample, replace=False):
        assert _count_solutions(p[i], bh, bw) == 1


def test_generators_are_deterministic_in_the_seed():
    a = gen.draw(7, "bulk0", 64, "sudoku9-24")
    b = gen.draw(7, "bulk0", 64, "sudoku9-24")
    c = gen.draw(8, "bulk0", 64, "sudoku9-24")
    d = gen.draw(7, "bulk1", 64, "sudoku9-24")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0]) and not np.array_equal(a[0], d[0])
    assert gen.draw(-5, "x", 4, "sudoku9-24")[0].shape == (4, 9, 9)
    assert right_answers(*a, 3, 3).all()


def test_every_seed_draws_every_corpus_puzzle_equally_often():
    size = len(gen.corpus("sudoku9-24")[0])
    for seed in (1, 2**33 + 7):
        p, s = gen.draw(seed, "bulk0", 2 * size, "sudoku9-24", transform=False)
        _, counts = np.unique(p.reshape(len(p), -1), axis=0, return_counts=True)
        assert len(counts) == size and set(counts) == {2}
    head = gen.draw(3, "w", 100, "sudoku9-24", transform=False)[0]
    tail = gen.draw(3, "w", 16, "sudoku9-24", start=size - 16, transform=False)[0]
    both = np.concatenate([head, tail]).reshape(116, -1)
    assert len(np.unique(both, axis=0)) == 116


def test_transforms_map_solutions_to_solutions_of_the_moved_board():
    p, s = gen.draw(3, "x", 300, "sudoku9-24", transform=False)
    tr = gen.transforms(gen.rng(3, "tr"), 300, 3, 3)
    tp, ts = gen.apply(tr, p), gen.apply(tr, s)
    assert right_answers(tp, ts, 3, 3).all()
    assert tr["transpose"].any() and not tr["transpose"].all()
    picks = gen.zipf_picks(gen.rng(1, "z"), 5000, 128, 1.1)
    assert picks.min() >= 0 and picks.max() < 128
    assert np.bincount(picks)[0] > np.bincount(picks, minlength=128)[64]


def test_open_loop_schedule_is_stratified_poisson():
    due = arrivals.poisson_due(gen.rng(1, "a"), 40.0, 20.0)
    assert len(due) == 800
    assert np.all(np.diff(due) > 0) and 0 < due[0] and due[-1] < 20.0
    other = arrivals.poisson_due(gen.rng(2, "a"), 40.0, 20.0)
    assert not np.array_equal(due, other)
    assert np.allclose(np.sort(np.diff(due, prepend=0)), np.sort(np.diff(other, prepend=0)))
    # The gaps are exponential: their coefficient of variation is near 1.
    gaps = np.diff(due)
    assert 0.9 < gaps.std() / gaps.mean() < 1.1


class _Slow(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_POST(self):  # noqa: N802
        self.rfile.read(int(self.headers["Content-Length"]))
        time.sleep(0.2)
        body = b'{"solution": []}'
        self.send_response(201)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_latency_runs_from_the_due_time_not_the_send():
    from portbench import loadgen

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Slow)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        job = {"port": srv.server_address[1], "bodies": ["{}", "{}", "{}"],
               "due": [0.0, 0.01, 0.5], "conns": 1, "wait_s": 10.0}
        res = loadgen.run(job, lambda: None)
    finally:
        srv.shutdown()
        srv.server_close()
    status, lat, late = zip(*[(r[0], r[1], r[2]) for r in res])
    assert status == (201, 201, 201)
    # One connection: the second request waits for the first's answer, and
    # that wait counts in its latency and in how late it was sent.
    assert late[1] > 0.15 and lat[1] > 0.35
    assert lat[2] < 0.3 and late[2] < 0.05


def test_the_judge_rejects_a_corrupted_solution_and_a_lost_given():
    p, s = gen.draw(11, "x", 50, "sudoku9-24")
    assert right_answers(p, s, 3, 3).all()
    bad = s.copy()
    bad[0, 0, 0] = bad[0, 0, 1]
    swapped = np.where(s == 1, 2, np.where(s == 2, 1, s))
    assert not right_answers(p[:1], bad[:1], 3, 3)[0]
    assert valid_grids(swapped, 3, 3).all()
    assert not keeps_givens(p, swapped).any()
    assert not right_answers(p, swapped, 3, 3).any()
    assert not right_answers(p[:1], np.zeros_like(s[:1]), 3, 3)[0]


def test_the_result_line_has_its_keys_in_order_and_checks_last():
    line = core.run_cell("sudoku9-bulk", 2**31 + 3, 0.5, False, time.perf_counter(),
                         device="cpu", bench=LATER, traffic={"batch": 32, "batches": 2})
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] >= 32 and line["failed"] == 0
    units = {m["name"]: m["unit"] for m in LATER["end_to_end"]}
    assert set(line["metrics"]) == {"boards_per_s", "setup_s"}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    assert set(line["checks"]) == {"wrong_answers", "unsolved_boards"}
    json.dumps(line)


def test_the_command_refuses_without_a_card_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "sudoku16-bulk", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=core.ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA card" in proc.stderr


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                top = {n.split(".")[0] for n in _imports(os.path.join(dirpath, f))}
                assert not top & set(core.FORBIDDEN), (f, top & set(core.FORBIDDEN))


def test_the_reference_imports_nothing_of_the_program():
    for f in os.listdir(os.path.join(PKG, "reference")):
        if f.endswith(".py"):
            top = {n.split(".")[0] for n in _imports(os.path.join(PKG, "reference", f))}
            assert top <= {"__future__", "numpy"}, (f, top)


def test_a_run_loads_no_forbidden_module_by_whole_top_level_name():
    code = (
        "import time, sys; t = time.perf_counter()\n"
        "from portbench import core\n"
        "from portbench.tests.cells import later_bench\n"
        "core.run_cell('sudoku9-bulk', 5, 0.2, False, t, device='cpu', bench=later_bench(),"
        " traffic={'batch': 16, 'batches': 1})\n"
        "for m in core.spec()['per_layer']: core.reader(m['name'])\n"
        "import portbench.drivers.serve, portbench.control, portbench.sweep\n"
        "import portbench.yardstick.k2_replay, portbench.yardstick.profwindow\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(core.forbidden_modules())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    tops = json.loads(proc.stdout.strip().splitlines()[-2].replace("'", '"'))
    assert "distributed_sudoku_solver_tpu_torch" in tops
    assert not set(tops) & set(core.FORBIDDEN)
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_the_forbidden_names_are_compared_whole():
    sys.modules.setdefault("jaxlike_name_for_test", sys)
    try:
        assert "jaxlike_name_for_test" not in core.forbidden_modules()
    finally:
        del sys.modules["jaxlike_name_for_test"]


@pytest.mark.parametrize("box,corpus,lanes", [((3, 3), "sudoku9-24", 256),
                                              ((4, 4), "sudoku16-93", 128)])
def test_k2_replay_counts_what_the_programs_plain_rounds_count(box, corpus, lanes):
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step
    from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
    from portbench.yardstick import k2_replay

    geom = Geometry(*box)
    p, _ = gen.draw(3, "k2", lanes, corpus)
    top = encode_grid(torch.from_numpy(p.astype(np.int32)), geom).contiguous()
    stack = torch.zeros((lanes, 12, geom.n, geom.n), dtype=torch.int32)
    has = torch.ones(lanes, dtype=torch.bool)
    z = torch.zeros(lanes, dtype=torch.int32)
    kw = dict(rules="extended", branch_rule="minrem", max_sweeps=64, k_steps=8, tile=128,
              count_mode=False, sweep_unroll=2)
    out = cuda_step.fused_rounds_plain(top, stack.clone(), has, z, z.clone(), geom, **kw)
    rep = k2_replay.replay(top, stack, has, z, z, k2_replay.Geo(*box), **kw)
    assert rep["sweeps"] == int(out[11])
    assert rep["live_rounds"] == int(out[10].sum())
    assert rep["pushes"] == int(out[8].sum())
    assert rep["pops"] == int((z + out[8] - out[4]).sum())
    with pytest.raises(ValueError):
        k2_replay.replay(top, stack, has, z, z, k2_replay.Geo(*box), branch_rule="first")


def test_the_window_keeps_a_uniform_seeded_sample_of_its_passes():
    from portbench.drivers.bulk import _Reservoir

    def kept(seed, passes):
        r = _Reservoir(8, gen.rng(seed, "judge"))
        for k in range(passes):
            r.offer(k)
        return sorted(r.kept)

    assert kept(1, 5) == [0, 1, 2, 3, 4]
    assert kept(1, 300) == kept(1, 300) and kept(1, 300) != kept(2, 300)
    assert len(kept(1, 300)) == 8 and len(set(kept(1, 300))) == 8
    hits = np.zeros(40)
    for seed in range(2000):
        hits[kept(seed, 40)] += 1
    # Each of 40 passes is kept with probability 8 / 40.
    assert np.abs(hits / 2000 - 0.2).max() < 0.05


class _FakeStep:
    """``ops.cuda_step`` as ``_k2_reading`` sees it: ``fused_rounds`` and the
    launch counter of ``fused_rounds_cuda``."""

    def __init__(self):
        step = self

        class Cuda:
            launches = 0

        self.fused_rounds_cuda = Cuda

        def fused_rounds(*args, **kw):
            step.fused_rounds_cuda.launches += 1

        self.fused_rounds = fused_rounds


@pytest.mark.parametrize("events,dispatches,raises", [
    (6, 2, None), (5, 2, "lost K2 records"), (6, 3, "dispatched K2 2 times")])
def test_the_k2_reading_sums_every_dispatch_of_the_pass_or_fails(monkeypatch, events,
                                                                  dispatches, raises):
    import torch

    from portbench.drivers import bulk
    from portbench.yardstick import k2_replay

    step = _FakeStep()
    device = [("void fused_kernel<3, 3>(...)", 1000 * j, 1000 * j + 250_000 * (j + 1))
              for j in range(events)]
    calls = []
    monkeypatch.setattr(k2_replay, "replay", lambda *a, **k: calls.append(a) or {})
    monkeypatch.setattr(k2_replay, "bound", lambda rep, g, rules: (0.1, "operations"))
    top = torch.zeros(4, 9, 9, dtype=torch.int32)

    def rerun():
        for _ in range(2):
            step.fused_rounds(top, None, None, None, None, "geom", rules="extended")

    in_pass = range(6 - dispatches, 6)
    if raises:
        with pytest.raises(RuntimeError, match=raises):
            bulk._k2_reading({"device": device}, 6, in_pass, rerun, step, 3, 3)
        return
    out = bulk._k2_reading({"device": device}, 6, in_pass, rerun, step, 3, 3)
    assert len(calls) == 2 and out["dispatches"] == out["replayed"] == 2
    assert out["bound_ms"] == pytest.approx(0.2)
    assert out["device_ms"] == pytest.approx((250_000 * 5 + 250_000 * 6) / 1e6)


def test_the_k2_reading_replays_evenly_spaced_dispatches_of_a_long_pass(monkeypatch):
    import torch

    from portbench.drivers import bulk
    from portbench.yardstick import k2_replay

    step = _FakeStep()
    total = 100
    device = [("fused_kernel", 10 * j, 10 * j + 1000 * (j + 1)) for j in range(total)]
    picks = []  # the launch counter before each replayed dispatch: its index in the pass

    def replay(*a, **k):
        picks.append(step.fused_rounds_cuda.launches)
        return {}

    monkeypatch.setattr(k2_replay, "replay", replay)
    monkeypatch.setattr(k2_replay, "bound", lambda rep, g, rules: (0.001, "bytes"))
    top = torch.zeros(4, 9, 9, dtype=torch.int32)

    def rerun():
        for _ in range(total - 10):
            step.fused_rounds(top, None, None, None, None, "geom")

    out = bulk._k2_reading({"device": device}, total, range(10, total), rerun, step, 3, 3)
    assert out["replayed"] == len(picks) == bulk.REPLAYED and out["dispatches"] == total - 10
    assert picks[0] == 0 and picks[-1] == total - 11
    assert out["device_ms"] == pytest.approx(sum(1000 * (10 + j + 1) for j in picks) / 1e6)


def test_frozen_copies_agree_with_the_program_today():
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9, SUDOKU_16
    from distributed_sudoku_solver_tpu_torch.obs.hist import LatencyHistogram, hist_quantile
    from distributed_sudoku_solver_tpu_torch.ops import cost as prog_cost
    from portbench.yardstick import cost, hist

    for g in (SUDOKU_9, SUDOKU_16):
        for rules in ("basic", "extended", "subsets"):
            assert cost.sweep_ops(g.n, g.box_h, g.n_hboxes, rules) == prog_cost.sweep_ops(g, rules)
        assert cost.round_ops(g.n) == prog_cost.round_ops(g)
    h = LatencyHistogram()
    for ms in (0.5, 3, 3, 7, 40, 41, 900):
        h.record(ms / 1e3)
    d = h.to_dict()
    for q in (0.5, 0.95):
        assert hist.quantile(hist.delta(None, d), q) == pytest.approx(hist_quantile(d, q))


def test_histogram_delta_counts_only_the_window():
    before = {"edge0_ms": 1e-3, "counts": [0, 2, 5, 0]}
    after = {"edge0_ms": 1e-3, "counts": [0, 2, 9, 1]}
    d = __import__("portbench.yardstick.hist", fromlist=["x"]).delta(before, after)
    assert d["counts"] == [0, 0, 4, 1]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_traced_bulk_run_on_the_card_reads_k2_roofline(card):
    line = core.run_cell("sudoku9-bulk", 2**31 + 99, 2.0, True, time.perf_counter(),
                         bench=LATER, traffic={"batch": 65536, "batches": 1})
    assert line["correct"]
    roof = line["metrics"]["k2_roofline_pct.bulk"]["value"]
    assert 0 < roof <= 105
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
