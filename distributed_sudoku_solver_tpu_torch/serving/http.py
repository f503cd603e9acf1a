"""HTTP API: the reference node's endpoints, JSON-shape compatible.

Port of the JAX package's ``serving/http.py``:

* ``POST /solve`` ``{"sudoku": [[...]]}`` -> 201 ``{"solution", "duration"}``;
  422 for a proven-unsatisfiable board; 400 for a malformed body; 429 +
  ``Retry-After`` (and ``retry_after_s`` in the body) when the resident
  admission queue is full; 503 + ``Retry-After`` while draining; 504 with
  the job's ``uuid`` on timeout.  Options: ``?latency=1`` (the megastep
  flight), ``"branch"`` (a per-request branch rule), ``"uuid"`` (an
  idempotency key), ``"count_all"`` (200 with the exact model count),
  ``"portfolio": true`` (race ``serving/portfolio.DEFAULT_PORTFOLIO`` on
  the board; the answer names the winning ``strategy``; 504 on timeout).
  With a front door on the engine (``StandaloneNode()`` builds one) a
  plain request crosses the canonical cache, the propagation probe and the
  native race before any device flight; ``count_all``, ``branch`` and
  ``portfolio`` requests bypass it (per-job configs).
* ``POST /solve_batch`` (``{"boards": ...}`` or ``{"lines": ..., "size"}``):
  chunks of ``ops.bulk.solve_bulk`` on the engine's device-owner thread
  (``SolverEngine.run_exclusive``), stragglers as ordinary engine jobs that
  bypass the front door (bulk is not memoised by canonical entries).
* ``POST /profile`` ``{"secs", "logdir"}``: a bounded ``torch.profiler``
  window (``utils/profiling.py``); 409 while one is open.
* ``POST /admin/drain``: the engine's drain ladder.
* ``GET /stats``, ``GET /network`` (the reference shapes), ``GET /metrics``
  (``?format=prometheus``), ``GET /status``, ``GET /slo``,
  ``GET /trace[/<uuid>]`` (``?analyze=1``, ``?limit``, ``?format=perfetto``).

The cluster scopes (``?scope=cluster``, ``?scope=dht``) belong to the
cluster node (``cluster/node.ClusterNode``): ``?scope=cluster`` fans a
METRICS_PULL over the ring and merges the members' bodies, ``?scope=dht``
shows the gossip view, the hash ring and the cache shard.  A standalone
node answers them as the JAX package's does (a one-member cluster view,
404 for DHT).  On a cluster node the portfolio's racers spread over the
members (``ClusterNode.race``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlsplit

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.obs import agg, critpath, prom, slo, trace
from distributed_sudoku_solver_tpu_torch.serving import faults
from distributed_sudoku_solver_tpu_torch.serving.brownout import BrownoutShed
from distributed_sudoku_solver_tpu_torch.serving.engine import EngineDraining, SolverEngine
from distributed_sudoku_solver_tpu_torch.serving.scheduler import EngineSaturated

_ACCESS_LOG = logging.getLogger(__name__ + ".access")


def _retry_header(seconds: float) -> dict:
    return {"Retry-After": str(max(1, int(-(-seconds // 1))))}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _now(self) -> float:
        """The server's injected wall clock (``ApiServer(clock=...)``)."""
        return self.server.clock()

    def do_POST(self):  # noqa: N802 (stdlib casing)
        url = urlsplit(self.path)
        if url.path == "/solve_batch":
            return self._solve_batch()
        if url.path == "/profile":
            return self._profile()
        if url.path == "/admin/drain":
            return self._admin_drain()
        if url.path != "/solve":
            return self._send(404, {"error": "not found"})
        latency = parse_qs(url.query).get("latency", ["0"])[0] not in ("", "0", "false")
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length))
            grid = payload["sudoku"]
        except (ValueError, KeyError, TypeError):
            return self._send(400, {"error": "body must be JSON {'sudoku': [[...]]}"})
        node = self.server.solver_node
        try:
            g = np.asarray(grid)  # ragged lists raise ValueError here
        except ValueError as e:
            return self._send(400, {"error": f"bad sudoku grid: {e}"})
        if g.ndim != 2 or g.shape[0] != g.shape[1] or g.shape[0] < 1:
            return self._send(400, {"error": f"sudoku must be a square grid, got shape {g.shape}"})
        client_uuid = payload.get("uuid")
        if client_uuid is not None and (
            not isinstance(client_uuid, str) or not client_uuid or len(client_uuid) > 120
        ):
            return self._send(400, {"error": "uuid must be a non-empty string (<=120 chars)"})
        start = self._now()
        rec = trace.active()
        t_http = rec.now() if rec is not None else 0.0
        timeout = self.server.solve_timeout_s
        config = None
        branch = payload.get("branch")
        if branch is not None:
            from distributed_sudoku_solver_tpu_torch.ops import ordering

            try:
                ordering.validate_branch(branch)
            except (TypeError, ValueError) as e:
                return self._send(400, {"error": str(e)})
            if payload.get("portfolio"):
                return self._send(400, {"error": "branch and portfolio are mutually exclusive"})
            engine = getattr(node, "engine", None)
            if engine is None:
                return self._send(500, {"error": "node has no engine"})
            config = dataclasses.replace(engine.config, branch=branch)
        if payload.get("count_all"):
            if payload.get("portfolio"):
                return self._send(400, {"error": "count_all and portfolio are mutually exclusive"})
            return self._solve_count_all(node, g, start, timeout, config=config)
        strategy = None
        if payload.get("portfolio"):
            try:
                res = self._race(node, grid, timeout)
            except ValueError as e:
                return self._send(400, {"error": str(e)})
            if res.winner is None:
                if res.timed_out:
                    self._record_solve(node, self._now() - start, 504)
                    return self._send(504, {"error": "portfolio race timed out"})
                # Every racer resolved without a verdict: a permanent
                # failure (budget, overflow, a kernel fault), not a timeout.
                err = next((j.error for j in res.jobs if j.error), None)
                self._record_solve(node, self._now() - start, 500)
                return self._send(500, {"error": err or "search budget exhausted"})
            job = res.winner
            strategy = res.strategy
        else:
            try:
                job = (
                    node.submit(grid, config=config, latency=True, job_uuid=client_uuid)
                    if latency
                    else node.submit(grid, config=config, job_uuid=client_uuid)
                )
            except ValueError as e:
                return self._send(400, {"error": str(e)})
            except EngineDraining as e:
                self._record_solve(node, self._now() - start, 503, shed=True)
                return self._send(
                    503,
                    {"error": "draining", "state": e.state,
                     "retry_after_s": round(e.retry_after_s, 3)},
                    headers=_retry_header(e.retry_after_s),
                )
            except BrownoutShed as e:
                self._trace_http(rec, t_http, e.uuid or "", e.status)
                self._record_solve(node, self._now() - start, e.status, shed=True)
                return self._send(
                    e.status,
                    {"error": str(e), "stage": e.stage,
                     "retry_after_s": round(e.retry_after_s, 3), "shed_tier": e.shed_tier},
                    headers=_retry_header(e.retry_after_s),
                )
            except EngineSaturated as e:
                self._record_solve(node, self._now() - start, 429, shed=True)
                return self._send(
                    429,
                    {"error": "server saturated", "retry_after_s": round(e.retry_after_s, 3)},
                    headers=_retry_header(e.retry_after_s),
                )
            if not job.wait(timeout):
                node.cancel(job.uuid)
                self._trace_http(rec, t_http, job.uuid, 504)
                self._record_solve(node, self._now() - start, 504)
                return self._send(504, {"error": "solve timed out", "uuid": job.uuid})
        duration = self._now() - start
        extra = {"strategy": strategy} if strategy is not None else {}
        if job.solved:
            status = 201
            body = {"solution": job.solution.tolist(), "duration": duration, **extra}
        elif job.unsat:
            status = 422
            body = {"error": "puzzle is unsatisfiable", "duration": duration, **extra}
        else:
            status = 500
            body = {"error": job.error or "search budget exhausted", "duration": duration}
        self._trace_http(rec, t_http, job.uuid, status)
        self._record_solve(node, duration, status)
        return self._send(status, body)

    @staticmethod
    def _trace_http(rec, t0: float, job_uuid: str, status: int) -> None:
        if rec is not None:
            rec.record(job_uuid, "http.solve", "http", t0, status=status)

    @staticmethod
    def _record_solve(node, duration: float, status: int, shed: bool = False) -> None:
        """One ``solve_ms`` sample and one SLO ``solve`` observation per
        completed ``/solve``; 5xx counts as an error unless it is
        deliberate shedding (``shed``)."""
        eng = getattr(node, "engine", None)
        if eng is not None:
            eng.hist["solve_ms"].record(duration)
        mon = slo.active()
        if mon is not None:
            mon.observe(duration, error=status >= 500 and not shed, stream="solve", shed=shed)

    def _solve_count_all(self, node, grid, start, timeout, config=None):
        """``POST /solve`` with ``"count_all": true``: 200 with the exact
        model count, the first solution found and whether the enumeration
        completed.  Runs on the local engine (``"scope": "local"``)."""
        engine = getattr(node, "engine", None)
        if engine is None:
            return self._send(500, {"error": "node has no engine"})
        try:
            job = engine.submit(
                grid,
                config=dataclasses.replace(
                    config if config is not None else engine.config, count_all=True
                ),
            )
        except ValueError as e:
            return self._send(400, {"error": str(e)})
        if not job.wait(timeout):
            engine.cancel(job.uuid)
            self._record_solve(node, self._now() - start, 504)
            return self._send(504, {"error": "enumeration timed out"})
        if job.error:
            self._record_solve(node, self._now() - start, 500)
            return self._send(500, {"error": job.error})
        body = {
            "count": int(job.sol_count),
            "complete": bool(job.unsat and not job.cancelled),
            "solution": job.solution.tolist() if job.sol_count > 0 else None,
            "duration": self._now() - start,
            "scope": "local",
        }
        self._record_solve(node, body["duration"], 200)
        return self._send(200, body)

    @staticmethod
    def _race(node, grid, timeout):
        """Race the default portfolio: over the members on a cluster node
        (``ClusterNode.race``), on the local engine otherwise."""
        from distributed_sudoku_solver_tpu_torch.serving.portfolio import (
            DEFAULT_PORTFOLIO,
            race,
        )

        if hasattr(node, "race"):
            return node.race(grid, DEFAULT_PORTFOLIO, timeout=timeout)
        return race(node.engine, grid, DEFAULT_PORTFOLIO, timeout=timeout)

    def _solve_batch(self):
        from distributed_sudoku_solver_tpu_torch.models.geometry import geometry_for_size
        from distributed_sudoku_solver_tpu_torch.ops.bulk import BulkConfig, solve_bulk
        from distributed_sudoku_solver_tpu_torch.utils.puzzles import parse_line, to_line

        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length))
            as_lines = "lines" in payload
            if as_lines:
                size = int(payload.get("size", 9))
                grids = np.stack([parse_line(s, size) for s in payload["lines"]]).astype(np.int32)
            else:
                grids = np.asarray(payload["boards"], dtype=np.int32)
            if grids.ndim != 3 or grids.shape[1] != grids.shape[2]:
                raise ValueError(f"boards must be [B, n, n], got {grids.shape}")
            n = grids.shape[1]
            geom = geometry_for_size(n)
            # Bound one exclusive slice's device occupancy: chunk width
            # scales with board area, the first pass gets a step cap.
            default_chunk = max(64, (8192 * 81) // (n * n))
            cfg = BulkConfig(
                rules=payload.get("rules", "extended"),
                chunk=max(1, min(int(payload.get("chunk", default_chunk)), 32768)),
                first_pass_steps=512,
                rungs=(),  # stragglers go through the engine below
            )
        except (ValueError, KeyError, TypeError) as e:
            return self._send(400, {"error": f"bad solve_batch body: {e}"})
        engine = getattr(self.server.solver_node, "engine", None)
        if engine is None:
            return self._send(500, {"error": "node has no engine"})
        start = self._now()
        deadline = start + self.server.solve_timeout_s
        solved = np.zeros(len(grids), bool)
        unsat = np.zeros(len(grids), bool)
        solutions = np.zeros_like(grids)
        for lo in range(0, len(grids), cfg.chunk):
            sl = grids[lo : lo + cfg.chunk]
            attempts = 0
            while True:
                try:
                    res = engine.run_exclusive(
                        lambda sl=sl: solve_bulk(sl, geom, cfg, device=engine.device),
                        timeout=max(1.0, deadline - self._now()),
                    )
                    break
                except RuntimeError as e:
                    # A transient chunk fault re-runs under the engine's
                    # recovery policy before the endpoint gives up.
                    if (
                        faults.classify_message(str(e)) == faults.TRANSIENT
                        and attempts < engine.recovery.max_retries
                        and self._now() < deadline
                    ):
                        attempts += 1
                        with engine._lock:
                            engine.fault_bulk_retries += 1
                        time.sleep(min(0.05 * 2**attempts, 1.0, max(0.0, deadline - self._now())))
                        continue
                    return self._send(500, {"error": str(e), "done": int(lo)})
            if res is None:
                return self._send(504, {"error": "bulk chunk timed out", "done": int(lo)})
            solved[lo : lo + len(sl)] = res.solved
            unsat[lo : lo + len(sl)] = res.unsat
            solutions[lo : lo + len(sl)] = res.solution
        # Stragglers (step cap hit) become ordinary engine jobs, outside the
        # front door: bulk work does not fill the result cache.
        pending = [
            (int(i), engine.submit(grids[i], geom=geom, frontdoor=False))
            for i in np.flatnonzero(~solved & ~unsat)
        ]
        for i, job in pending:
            if not job.wait(max(1.0, deadline - self._now())):
                for _, other in pending:
                    if not other.done.is_set():
                        engine.cancel(other.uuid)
                return self._send(504, {"error": "straggler solve timed out", "done": int(i)})
            solved[i] = job.solved
            unsat[i] = job.unsat
            if job.solved:
                solutions[i] = job.solution
        body = {
            "count": int(len(grids)),
            "solved": int(solved.sum()),
            "unsat": int(unsat.sum()),
            "solved_mask": solved.tolist(),
            "unsat_mask": unsat.tolist(),
            "duration": self._now() - start,
        }
        body["solutions"] = [to_line(s) for s in solutions] if as_lines else solutions.tolist()
        return self._send(200, body)

    def _profile(self):
        """``POST /profile``: a bounded ``torch.profiler`` window."""
        from distributed_sudoku_solver_tpu_torch.utils import profiling

        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length)) if length else {}
            secs = float(payload.get("secs", 1.0))
            if not (0.05 <= secs <= 300.0):
                raise ValueError(f"secs must be in [0.05, 300], got {secs}")
            logdir = str(payload.get("logdir") or tempfile.mkdtemp(prefix="dsst-profile-"))
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            return self._send(400, {"error": f"bad profile body: {e}"})
        try:
            started = profiling.start_profile_window(logdir, secs)
        except (RuntimeError, OSError) as e:
            return self._send(409, {"error": f"profiler unavailable: {e}"})
        if not started:
            return self._send(409, {"error": "a profile window is already open"})
        return self._send(200, {"logdir": logdir, "secs": secs})

    def _admin_drain(self):
        """``POST /admin/drain``: walk the drain ladder, answer its summary."""
        node = self.server.solver_node
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length)) if length else {}
            timeout_s = float(payload.get("timeout_s", 30.0))
            if not (0.0 <= timeout_s <= 600.0):
                raise ValueError(f"timeout_s must be in [0, 600], got {timeout_s}")
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            return self._send(400, {"error": f"bad drain body: {e}"})
        drain = getattr(node, "drain", None)
        if drain is None:
            return self._send(500, {"error": "node cannot drain"})
        return self._send(200, drain(timeout=timeout_s))

    def do_GET(self):  # noqa: N802
        node = self.server.solver_node
        url = urlsplit(self.path)
        path, query = url.path, parse_qs(url.query)
        if path == "/stats":
            return self._send(200, node.stats_view())
        if path == "/network":
            return self._network_view(node, query)
        if path == "/metrics":
            if query.get("scope", [""])[0] == "cluster":
                return self._cluster_metrics(node, query)
            if query.get("format", [""])[0] == "prometheus":
                return self._send_text(200, prom.render(self._metrics(node)))
            return self._send(200, self._metrics(node))
        if path == "/status":
            return self._send(200, agg.status_from(self._cluster_view(node)))
        if path == "/slo":
            mon = slo.active()
            if mon is None:
                return self._send(404, {"error": "no SLO configured (start the node with --slo)"})
            return self._send(200, {**mon.state(), "burn": mon.burn_snapshot()})
        if path == "/trace" or path.startswith("/trace/"):
            return self._trace_view(path, query)
        return self._send(404, {"error": "not found"})

    def _network_view(self, node, query: dict):
        scope = query.get("scope", [""])[0]
        if scope in ("", "ring"):
            return self._send(200, node.network_view())
        if scope != "dht":
            return self._send(400, {"error": f"scope must be 'dht', got {scope!r}"})
        if getattr(node, "gossip", None) is None:
            return self._send(404, {"error": "DHT disabled (single node, or started with"
                                             " dht=False)"})
        owner_of = query.get("owner", [""])[0] or None
        if owner_of is not None:
            try:
                int(owner_of, 16)
            except ValueError:
                return self._send(400, {"error": "owner must be a hex canonical digest,"
                                                 f" got {owner_of!r}"})
        return self._send(200, node.dht_view(owner_of))

    @staticmethod
    def _cluster_view(node, sample: int = 0) -> dict:
        """The node's cluster-scope metrics view: a one-member cluster for
        a standalone node."""
        fn = getattr(node, "cluster_metrics_view", None)
        if fn is not None:
            return fn(sample=sample) if sample else fn()
        engine = getattr(node, "engine", None)
        m = engine.metrics() if engine is not None else {}
        addr = getattr(node, "address", "local:0")
        return {
            "scope": "cluster",
            "address": addr,
            "coordinator": addr,
            "view": [0, 0],
            "nodes": {addr: {"unreachable": False, "stale": False, "view": [0, 0],
                             "metrics": m}},
            "rollup": {**agg.rollup([m]), "nodes": 1, "unreachable": 0},
        }

    def _cluster_metrics(self, node, query: dict):
        sample = 0
        if "sample" in query:
            try:
                sample = int(query["sample"][0])
            except ValueError:
                return self._send(400, {"error": "sample must be an integer"})
            if sample <= 0:
                return self._send(400, {"error": f"sample must be positive, got {sample}"})
        cm = self._cluster_view(node, sample)
        if query.get("format", [""])[0] == "prometheus":
            doc = {
                "cluster_rollup": cm.get("rollup", {}),
                "cluster_nodes": {
                    addr: {"unreachable": n.get("unreachable", False),
                           "stale": n.get("stale", False)}
                    for addr, n in cm.get("nodes", {}).items()
                },
            }
            return self._send_text(200, prom.render(doc))
        return self._send(200, cm)

    def _trace_view(self, path: str, query: dict):
        """``GET /trace`` and ``GET /trace/<uuid>``; structured 4xx on
        malformed input, never a 500."""
        rec = trace.active()
        if rec is None:
            return self._send(404, {"error": "tracing disabled (start the node with --trace)"})
        raw_analyze = query.get("analyze", ["0"])[0].lower()
        if raw_analyze in ("1", "true", "yes"):
            analyze = True
        elif raw_analyze in ("0", "false", "no", ""):
            analyze = False
        else:
            return self._send(400, {"error": f"analyze must be 0 or 1, got {raw_analyze!r}"})
        limit = None
        if "limit" in query:
            try:
                limit = int(query["limit"][0])
            except ValueError:
                return self._send(400, {"error": "limit must be an integer"})
            if limit <= 0:
                return self._send(400, {"error": f"limit must be positive, got {limit}"})
        if path.startswith("/trace/"):
            uuid = path[len("/trace/"):]
            spans = rec.spans(uuid)
            if not spans:
                return self._send(404, {"error": "unknown trace uuid", "uuid": uuid})
            body = {"uuid": uuid, "count": len(spans), "spans": spans}
            if analyze:
                # Decompose the full trace; the limit trims the echo only.
                body["analysis"] = critpath.decompose(spans)
                body["analysis_tolerance"] = critpath.SUM_TOLERANCE
            if limit is not None:
                body["spans"] = body["spans"][-limit:]
            return self._send(200, body)
        if analyze:
            return self._send(400, {"error": "analyze requires a job: GET /trace/<uuid>?analyze=1"})
        if query.get("format", [""])[0] == "perfetto":
            return self._send(200, rec.perfetto())
        spans = rec.spans(limit=limit if limit is not None else 1000)
        return self._send(200, {"count": len(spans), "spans": spans})

    @staticmethod
    def _metrics(node) -> dict:
        if hasattr(node, "metrics_view"):
            body = node.metrics_view()
        else:
            engine = getattr(node, "engine", None)
            body = engine.metrics() if engine is not None else {}
        engine = getattr(node, "engine", None)
        if engine is not None:
            dev = engine.device
            body["device"] = (
                {"kind": torch.cuda.get_device_name(dev), "platform": "gpu"}
                if dev.type == "cuda" else {"kind": "cpu", "platform": "cpu"}
            )
        return body

    def _send(self, code: int, body: dict, headers: Optional[dict] = None) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _send_text(self, code: int, text: str) -> None:
        data = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):
        if getattr(self.server, "access_log", False):
            _ACCESS_LOG.info("%s %s", self.address_string(), fmt % args)


class _Server(ThreadingHTTPServer):
    # A burst of clients connecting at once queues in the listen backlog
    # instead of waiting out SYN retransmits behind socketserver's 5.
    request_queue_size = 128


class ApiServer:
    """ThreadingHTTPServer wrapper bound to a solver node.

    ``access_log=True`` emits one INFO record per request on the
    ``...serving.http.access`` logger; ``verbose`` is its old alias."""

    def __init__(
        self,
        solver_node,
        host: str = "0.0.0.0",
        port: int = 8000,
        solve_timeout_s: float = 300.0,
        verbose: bool = False,
        access_log: bool = False,
        clock: Callable[[], float] = time.time,
    ):
        self.httpd = _Server((host, port), _Handler)
        self.httpd.solver_node = solver_node
        self.httpd.solve_timeout_s = solve_timeout_s
        self.httpd.access_log = access_log or verbose
        self.httpd.clock = clock
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "ApiServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                                        name="http-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(5)


class StandaloneNode:
    """Single-process node: engine + API, no cluster peers.

    With no engine given it builds ``SolverEngine(frontdoor=FrontDoorConfig())``
    on the CUDA device (raising without one), as the JAX package's node
    does; a caller that passes its own engine chooses its own front door."""

    def __init__(self, engine: Optional[SolverEngine] = None, address: str = "local:0"):
        if engine is None:
            from distributed_sudoku_solver_tpu_torch.serving.frontdoor.router import (
                FrontDoorConfig,
            )

            engine = SolverEngine(frontdoor=FrontDoorConfig()).start()
        self.engine = engine
        self.address = address

    def submit(self, grid, config=None, latency=None, job_uuid=None):
        g = np.asarray(grid, dtype=np.int32)
        if g.ndim != 2 or g.shape[0] != g.shape[1]:
            raise ValueError(f"grid must be square, got {g.shape}")
        # The serving node is where backpressure belongs: a full resident
        # queue raises EngineSaturated here (HTTP 429 + Retry-After).
        return self.engine.submit(g, saturation="reject", config=config, latency=latency,
                                  job_uuid=job_uuid)

    def cancel(self, job_uuid: str) -> None:
        self.engine.cancel(job_uuid)

    def drain(self, timeout: float = 30.0) -> dict:
        """No peers: every unstarted job journals for restart."""
        return self.engine.drain(timeout=timeout)

    def recover(self) -> int:
        return self.engine.recover()

    def stats_view(self) -> dict:
        s = self.engine.stats()
        return {
            "all": {"solved": s["solved"], "validations": s["validations"]},
            "nodes": [{"address": self.address, "validations": s["validations"]}],
        }

    def network_view(self) -> dict:
        return {self.address: [self.address, self.address]}
