"""The port's HTTP node (``serving/http.py``) against the JAX package's.

Twins of ``tests/test_api.py`` (golden request/response pairs for
``/solve``, ``/stats``, ``/network``, bulk, enumeration, tracing,
Prometheus exposition, the profile window, the access log, the portfolio
race).  The JSON bodies of ``/solve``, ``/stats``, ``/network`` and
``/metrics`` are held against a JAX node serving the same board: same
status codes, same key structure.
"""

import json
import logging
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JSolverConfig
from distributed_sudoku_solver_tpu.serving.engine import SolverEngine as JSolverEngine
from distributed_sudoku_solver_tpu.serving.http import ApiServer as JApiServer
from distributed_sudoku_solver_tpu.serving.http import StandaloneNode as JStandaloneNode
from distributed_sudoku_solver_tpu_torch.obs import critpath, lockdep, promck, trace
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
from distributed_sudoku_solver_tpu_torch.serving.http import ApiServer, StandaloneNode
from distributed_sudoku_solver_tpu_torch.serving.megastep import MegastepConfig
from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution
from distributed_sudoku_solver_tpu_torch.utils.puzzles import EASY_9, HARD_9, to_line

SMALL = SolverConfig(min_lanes=8, stack_slots=24, max_steps=20_000)


def bad_board():
    bad = np.asarray(EASY_9).copy()
    bad[0, 0], bad[0, 1] = 5, 5
    return bad


@pytest.fixture(autouse=True)
def port_lock_witness():
    with lockdep.installed(lockdep.manifest_witness(strict=True)) as w:
        yield w
    assert w.violations == [], w.violations


@pytest.fixture(scope="module")
def server():
    engine = SolverEngine(config=SMALL, max_batch=8, megastep=MegastepConfig(chunk_steps=16),
                          device="cpu").start()
    node = StandaloneNode(engine=engine, address="127.0.0.1:test")
    api = ApiServer(node, host="127.0.0.1", port=0, solve_timeout_s=120).start()
    yield api
    api.stop()
    engine.stop()


@pytest.fixture(scope="module")
def jax_server():
    engine = JSolverEngine(config=JSolverConfig(**vars(SMALL)), max_batch=8).start()
    node = JStandaloneNode(engine=engine, address="127.0.0.1:test")
    api = JApiServer(node, host="127.0.0.1", port=0, solve_timeout_s=120).start()
    yield api
    api.stop()
    engine.stop()


def _request(api, path, body=None, headers=False):
    url = f"http://127.0.0.1:{api.port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method="POST" if data else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        out = e.code, json.loads(e.read()), dict(e.headers)
    return out if headers else out[:2]


def _shape(v):
    """Key structure of a JSON body: dicts by their keys (recursively),
    lists by their first element, leaves by their JSON kind."""
    if isinstance(v, dict):
        return {k: _shape(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_shape(v[0])] if v else []
    if isinstance(v, bool) or v is None:
        return type(v).__name__
    if isinstance(v, (int, float)):
        return "number"
    return type(v).__name__


def test_solve_endpoint(server):
    status, body = _request(server, "/solve", {"sudoku": np.asarray(EASY_9).tolist()})
    assert status == 201
    assert set(body) == {"solution", "duration"}
    sol = np.asarray(body["solution"])
    assert is_valid_solution(sol)
    mask = np.asarray(EASY_9) != 0
    assert np.array_equal(sol[mask], np.asarray(EASY_9)[mask])
    assert body["duration"] > 0


def test_solve_unsat_returns_422(server):
    status, body = _request(server, "/solve", {"sudoku": bad_board().tolist()})
    assert status == 422
    assert "unsat" in body["error"]


def test_solve_bad_body_returns_400(server):
    assert _request(server, "/solve", {"wrong_key": []})[0] == 400
    assert _request(server, "/solve", {"sudoku": [[1, 2], [3, 4], [5, 6]]})[0] == 400
    assert _request(server, "/solve", {"sudoku": [[1, 2], [3]]})[0] == 400
    assert _request(server, "/solve", {"sudoku": [[1, 2], [3]], "portfolio": True})[0] == 400
    assert _request(server, "/solve", {"sudoku": np.asarray(EASY_9).tolist(),
                                       "branch": "no-such-rule"})[0] == 400
    assert _request(server, "/solve", {"sudoku": np.asarray(EASY_9).tolist(), "uuid": ""})[0] \
        == 400


def test_solve_bodies_match_the_jax_node(server, jax_server):
    """Same board, same status and body keys from both nodes; HARD_9's
    unique solution equal."""
    for board in (EASY_9, HARD_9[0], bad_board()):
        got = _request(server, "/solve", {"sudoku": np.asarray(board).tolist()})
        want = _request(jax_server, "/solve", {"sudoku": np.asarray(board).tolist()})
        assert got[0] == want[0]
        assert set(got[1]) == set(want[1])
        if got[0] == 201 and board is HARD_9[0]:
            assert got[1]["solution"] == want[1]["solution"]


def test_stats_shape(server):
    status, body = _request(server, "/stats")
    assert status == 200
    assert set(body) == {"all", "nodes"}
    assert set(body["all"]) == {"solved", "validations"}
    assert body["all"]["solved"] >= 1
    assert isinstance(body["nodes"], list) and body["nodes"]
    assert {"address", "validations"} <= set(body["nodes"][0])


def test_network_shape(server):
    status, body = _request(server, "/network")
    assert status == 200
    for addr, (pred, succ) in body.items():
        assert isinstance(pred, str) and isinstance(succ, str)
    assert _request(server, "/network?scope=dht")[0] == 404
    assert _request(server, "/network?scope=bogus")[0] == 400


def test_stats_network_metrics_key_structure_matches_jax(server, jax_server):
    """One more identical solve on each node, then /stats, /network and
    /metrics: the same key structure (the numbers differ)."""
    for api in (server, jax_server):
        assert _request(api, "/solve", {"sudoku": np.asarray(HARD_9[1]).tolist()})[0] == 201
    for path in ("/stats", "/network"):
        assert _shape(_request(server, path)[1]) == _shape(_request(jax_server, path)[1])
    got = _request(server, "/metrics")[1]
    want = _request(jax_server, "/metrics")[1]
    # The port's node has flown a megastep (test_latency_route below may
    # have run first in this module); JAX's has not.
    got.pop("megastep", None)
    for k in list(got.get("hist", {})):
        if k not in want.get("hist", {}):
            got["hist"].pop(k)
    assert set(got) == set(want), set(got) ^ set(want)
    for key in ("faults", "lifecycle", "device"):
        assert _shape(got[key]) == _shape(want[key]), key
    for key in ("job_latency_ms", "batch_jobs", "chunk_wall_ms", "dispatch_wall_ms",
                "sync_wall_ms"):
        assert set(got[key]) == set(want[key]), key
    assert set(want["hist"]) <= set(got["hist"])
    assert got["device"]["platform"] == "cpu"


def test_unknown_paths(server):
    assert _request(server, "/nope")[0] == 404
    assert _request(server, "/nope", {"x": 1})[0] == 404


def test_solve_portfolio_option(server):
    """POST /solve with portfolio=true races the default strategy portfolio
    (``serving/portfolio.DEFAULT_PORTFOLIO``) and reports the winning branch
    rule; the solution keeps its givens and is the oracle's; an unsat board
    answers 422 with the strategy.  count_all and portfolio stay exclusive."""
    from distributed_sudoku_solver_tpu_torch import native

    board = np.asarray(HARD_9[0])
    status, body = _request(server, "/solve", {"sudoku": board.tolist(), "portfolio": True})
    assert status == 201
    assert set(body) == {"solution", "duration", "strategy"}
    sol = np.asarray(body["solution"])
    assert is_valid_solution(sol) and np.array_equal(sol[board > 0], board[board > 0])
    assert np.array_equal(sol, native.solve(board)[0])
    assert body["strategy"] in ("minrem", "minrem-desc", "first")
    status, body = _request(server, "/solve", {"sudoku": bad_board().tolist(), "portfolio": True})
    assert status == 422
    assert body["strategy"] in ("minrem", "minrem-desc", "first")
    assert _request(server, "/solve", {"sudoku": np.asarray(EASY_9).tolist(),
                                       "portfolio": True, "count_all": True})[0] == 400


def test_solve_portfolio_times_out_with_504():
    """A race with no verdict inside the request's timeout answers 504 and
    cancels its racers, as the JAX node does."""
    engine = SolverEngine(config=SMALL, max_batch=8, device="cpu").start()
    api = ApiServer(StandaloneNode(engine=engine), host="127.0.0.1", port=0,
                    solve_timeout_s=0.0).start()
    try:
        status, body = _request(api, "/solve", {"sudoku": np.asarray(HARD_9[0]).tolist(),
                                                "portfolio": True})
        assert status == 504 and "timed out" in body["error"]
        for _ in range(200):
            if engine.busy_depth() == 0:
                break
            time.sleep(0.05)
        assert engine.busy_depth() == 0
    finally:
        api.stop()
        engine.stop()


def test_solve_batch_endpoint_boards(server):
    boards = [np.asarray(EASY_9), np.asarray(HARD_9[0]), bad_board()]
    status, body = _request(server, "/solve_batch",
                            {"boards": [b.tolist() for b in boards], "chunk": 2})
    assert status == 200
    assert body["count"] == 3
    assert body["solved"] == 2
    assert body["unsat"] == 1
    assert body["solved_mask"] == [True, True, False]
    assert body["unsat_mask"] == [False, False, True]
    for i in (0, 1):
        sol = np.asarray(body["solutions"][i])
        assert is_valid_solution(sol)
        mask = boards[i] != 0
        assert np.array_equal(sol[mask], boards[i][mask])
    assert body["duration"] > 0


def test_solve_batch_endpoint_lines(server):
    status, body = _request(server, "/solve_batch",
                            {"lines": [to_line(np.asarray(EASY_9))], "size": 9})
    assert status == 200
    assert body["solved"] == 1
    sol_line = body["solutions"][0]
    assert len(sol_line) == 81 and "0" not in sol_line


def test_solve_batch_bad_body(server):
    assert _request(server, "/solve_batch", {"boards": [[1, 2]]})[0] == 400
    assert _request(server, "/solve_batch", {"nope": True})[0] == 400


def test_latency_route_and_branch_and_uuid(server):
    """``?latency=1`` flies the megastep; ``"branch"`` rides as a per-job
    config; a client ``uuid`` makes a resubmit answer the same job."""
    engine = server.httpd.solver_node.engine
    status, body = _request(server, "/solve?latency=1",
                            {"sudoku": np.asarray(HARD_9[1]).tolist()})
    assert status == 201 and is_valid_solution(np.asarray(body["solution"]))
    assert engine.metrics()["megastep"]["9x9"]["flights"] >= 1
    status, body = _request(server, "/solve", {"sudoku": np.asarray(HARD_9[0]).tolist(),
                                               "branch": "head:cw-slack"})
    assert status == 201 and is_valid_solution(np.asarray(body["solution"]))
    done = engine.stats()["jobs_done"]
    for _ in range(2):
        status, body = _request(server, "/solve", {"sudoku": np.asarray(EASY_9).tolist(),
                                                   "uuid": "client-key-1"})
        assert status == 201
    assert engine.stats()["jobs_done"] == done + 1  # the resubmit was not re-solved


def test_engine_batches_concurrent_jobs():
    engine = SolverEngine(config=SMALL, max_batch=8, batch_window_s=0.05, device="cpu").start()
    try:
        jobs = [engine.submit(EASY_9) for _ in range(5)]
        for job in jobs:
            assert job.wait(120)
            assert job.solved
            assert is_valid_solution(job.solution)
        assert engine.solved_count == 5
        assert engine.metrics()["batch_jobs"]["p95"] >= 2  # they shared flights
    finally:
        engine.stop()


def test_engine_cancel_before_run():
    engine = SolverEngine(config=SMALL, device="cpu")
    job = engine.submit(EASY_9)
    engine.cancel(job.uuid)
    engine.start()
    try:
        assert job.wait(60)
        assert job.cancelled
        assert not job.solved
    finally:
        engine.stop()


def test_metrics_endpoint_and_window():
    engine = SolverEngine(config=SolverConfig(min_lanes=8, stack_slots=16), device="cpu").start()
    api = ApiServer(StandaloneNode(engine), host="127.0.0.1", port=0).start()
    try:
        job = engine.submit(EASY_9)
        assert job.wait(120) and job.solved
        body = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{api.port}/metrics", timeout=30).read())
        assert body["jobs_done"] >= 1
        assert body["job_latency_ms"]["count"] >= 1
        assert body["job_latency_ms"]["p50"] > 0
        assert body["batch_jobs"]["p50"] >= 1
        assert "compile" not in body and "cost" not in body  # no compile watch installed
    finally:
        api.stop()
        engine.stop()


def test_stat_window_percentiles():
    from distributed_sudoku_solver_tpu_torch.utils.profiling import StatWindow

    w = StatWindow(capacity=8)
    assert w.snapshot() is None
    for v in range(1, 101):
        w.record(float(v))
    snap = w.snapshot()
    assert snap["total"] == 100 and snap["count"] == 8
    assert 93 <= snap["p50"] <= 100


def test_solve_count_all_endpoint(server, jax_server):
    body = {"sudoku": [[0] * 4 for _ in range(4)], "count_all": True}
    code, got = _request(server, "/solve", body)
    assert code == 200
    assert got["count"] == 288
    assert got["complete"] is True
    assert got["solution"] is not None
    code, want = _request(jax_server, "/solve", body)
    assert code == 200 and set(got) == set(want) and want["count"] == got["count"]


def test_trace_endpoints(server):
    from distributed_sudoku_solver_tpu_torch.obs import traceck

    status, body = _request(server, "/trace")
    assert status == 404 and "tracing disabled" in body["error"]
    rec = trace.TraceRecorder(ring=2048)
    with trace.installed(rec):
        status, _ = _request(server, "/solve", {"sudoku": np.asarray(EASY_9).tolist()})
        assert status == 201
        status, body = _request(server, "/trace")
        assert status == 200 and body["count"] >= 1
        http_spans = [s for s in body["spans"] if s["name"] == "http.solve"]
        assert http_spans, "no http.solve span in the ring"
        assert http_spans[-1]["attrs"]["status"] == 201
        uuid = http_spans[-1]["trace"]
        status, body = _request(server, f"/trace/{uuid}")
        assert status == 200 and body["uuid"] == uuid
        names = {s["name"] for s in body["spans"]}
        assert {"http.solve", "admission", "resolve"} <= names, names
        status, doc = _request(server, "/trace?format=perfetto")
        assert status == 200
        assert traceck.check(doc) == []
        assert _request(server, "/trace?limit=zzz")[0] == 400
    assert _request(server, "/trace")[0] == 404


def test_trace_analyze_and_hardening(server):
    rec = trace.TraceRecorder(ring=4096)
    with trace.installed(rec):
        status, _ = _request(server, "/solve", {"sudoku": np.asarray(EASY_9).tolist()})
        assert status == 201
        uuid = next(s["trace"] for s in reversed(rec.spans()) if s["name"] == "http.solve")
        status, body = _request(server, f"/trace/{uuid}?analyze=1")
        assert status == 200
        d = body["analysis"]
        assert body["analysis_tolerance"] == critpath.SUM_TOLERANCE
        total = sum(d["phases_ms"].values())
        assert abs(total - d["end_to_end_ms"]) <= d["end_to_end_ms"] * critpath.SUM_TOLERANCE
        assert d["phases_ms"]["sync"] >= 0 and "shares" in d
        status, body = _request(server, f"/trace/{uuid}?analyze=1&limit=1")
        assert status == 200 and len(body["spans"]) == 1
        assert body["analysis"]["end_to_end_ms"] == d["end_to_end_ms"]
        status, body = _request(server, "/trace/no-such-uuid")
        assert status == 404 and body["error"] == "unknown trace uuid"
        status, body = _request(server, f"/trace/{uuid}?analyze=2")
        assert status == 400 and "analyze" in body["error"]
        status, body = _request(server, f"/trace/{uuid}?limit=0")
        assert status == 400 and "limit" in body["error"]
        assert _request(server, "/trace?limit=-5")[0] == 400
        status, body = _request(server, "/trace?analyze=1")
        assert status == 400 and "uuid" in body["error"]


def test_metrics_prometheus_exposition(server):
    raw = urllib.request.urlopen(
        f"http://127.0.0.1:{server.port}/metrics?format=prometheus", timeout=30).read().decode()
    lines = [ln for ln in raw.splitlines() if ln]
    assert lines and all(ln.startswith("dsst_") for ln in lines)
    assert any(ln.startswith("dsst_jobs_done ") for ln in lines)
    assert any(ln.startswith("dsst_device_platform{") for ln in lines)
    assert promck.check_text(raw) == []
    status, body = _request(server, "/metrics")
    assert status == 200 and "jobs_done" in body


def test_status_slo_and_cluster_scope(server):
    status, body = _request(server, "/status")
    assert status == 200 and isinstance(body, dict)
    assert _request(server, "/slo")[0] == 404
    status, body = _request(server, "/metrics?scope=cluster")
    assert status == 200 and body["rollup"]["nodes"] == 1
    assert _request(server, "/metrics?scope=cluster&sample=0")[0] == 400


def test_profile_window_endpoint(server, tmp_path):
    from distributed_sudoku_solver_tpu_torch.utils import profiling

    assert _request(server, "/profile", {"secs": -1})[0] == 400
    status, body = _request(server, "/profile", {"secs": 0.2,
                                                 "logdir": str(tmp_path / "prof")})
    assert status == 200
    assert body["secs"] == 0.2
    assert _request(server, "/profile", {"secs": 0.2})[0] == 409  # one window at a time
    deadline = time.monotonic() + 15.0
    while profiling.profile_window_active() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not profiling.profile_window_active()
    assert os.path.isfile(os.path.join(body["logdir"], "trace.json"))


def test_device_trace_writes_a_trace(tmp_path):
    """``utils.profiling.device_trace``: a ``torch.profiler`` capture of the
    region, written as Chrome-trace JSON into the logdir."""
    import torch

    from distributed_sudoku_solver_tpu_torch.utils import profiling

    with profiling.device_trace(str(tmp_path / "region")):
        torch.ones(8).cumsum(0)
    doc = json.loads((tmp_path / "region" / "trace.json").read_text())
    assert doc["traceEvents"]


def test_access_log_opt_in(server, caplog):
    logger = "distributed_sudoku_solver_tpu_torch.serving.http.access"
    with caplog.at_level(logging.INFO, logger=logger):
        _request(server, "/stats")
        assert not [r for r in caplog.records if r.name.endswith("http.access")]
        server.httpd.access_log = True
        try:
            _request(server, "/stats")
        finally:
            server.httpd.access_log = False
    access = [r for r in caplog.records if r.name.endswith("http.access")]
    assert access and "GET /stats" in access[-1].getMessage()


def test_timeout_answers_504_with_uuid():
    eng = SolverEngine(config=SMALL, device="cpu", chunk_steps=1, handicap_s=0.2).start()
    api = ApiServer(StandaloneNode(eng), host="127.0.0.1", port=0, solve_timeout_s=0.3).start()
    try:
        status, body = _request(api, "/solve", {"sudoku": np.asarray(HARD_9[1]).tolist()})
        assert status == 504 and body["error"] == "solve timed out" and body["uuid"]
    finally:
        api.stop()
        eng.stop(timeout=2)


def test_admin_drain_then_503(tmp_path):
    from distributed_sudoku_solver_tpu_torch.serving.journal import Journal

    eng = SolverEngine(config=SMALL, device="cpu", journal=Journal(str(tmp_path))).start()
    api = ApiServer(StandaloneNode(eng), host="127.0.0.1", port=0).start()
    try:
        assert _request(api, "/solve", {"sudoku": np.asarray(EASY_9).tolist()})[0] == 201
        assert _request(api, "/admin/drain", {"timeout_s": -1})[0] == 400
        status, body = _request(api, "/admin/drain", {"timeout_s": 5})
        assert status == 200 and body["state"] == "drained"
        status, body, headers = _request(api, "/solve", {"sudoku": np.asarray(EASY_9).tolist()},
                                         headers=True)
        assert status == 503 and body["error"] == "draining" and int(headers["Retry-After"]) >= 1
        status, body = _request(api, "/admin/drain", {})
        assert status == 200 and body["already_draining"]
        assert eng.metrics()["journal"]["accepted"] >= 1
    finally:
        api.stop()
        eng.stop(timeout=2)


def test_concurrent_http_clients(server):
    """Eight clients at once: every answer a valid solution of its board."""
    boards = [HARD_9[i % 3] if i % 2 else EASY_9 for i in range(8)]
    out = [None] * len(boards)

    def post(i):
        out[i] = _request(server, "/solve", {"sudoku": np.asarray(boards[i]).tolist()})

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(boards))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    for b, (status, body) in zip(boards, out):
        sol = np.asarray(body["solution"])
        assert status == 201 and is_valid_solution(sol)
        assert np.array_equal(sol[np.asarray(b) > 0], np.asarray(b)[np.asarray(b) > 0])
