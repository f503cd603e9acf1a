"""``POST /solve`` on the CLI's node, under an open loop of independent users.

The node is ``cli.main`` with the configuration's flags on loopback, in this
process on a thread of its own, so the profiler and ``memory_peak_bytes``
see its device work.  The load generator (``portbench/loadgen.py``) is a
child process.  Set-up boots the node, sends ``warm`` boards drawn like the
window's (their solves build or load every kernel library and run every
route the window runs) and, for a mix with a ``pool``, each pool board once,
which fills the front door's cache as a live deployment's would.

The window sends ``round(rate * seconds)`` requests at stratified Poisson
due times (``gen/arrivals.py``).  A request's latency runs from its due time
to the last byte of its answer.  Every answer is judged after the window in
the frame of the board the client sent; an answer still missing a minute
after the window is lost.

Boards come from the mix's ``corpus`` of puzzles with a unique solution
(``gen/boards.py``): with ``pool`` null every request is a puzzle that no
other request of the run sends; otherwise a pool board picked with
Zipf(``zipf``) popularity under a fresh symmetry transform (``transform``:
true), but for ``fresh_share`` of the requests, puzzles outside the pool.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

from portbench.core import ROOT, log
from portbench.gen import arrivals
from portbench.gen import boards as gen
from portbench.reference.sudoku import right_answers

# Seconds an answer may come after the window's last due time.
WAIT_S = 60.0
# A failed, refused or lost request's latency in the percentiles: it misses
# any limit a user could set.
FAILED_LATENCY_S = WAIT_S


def _free_ports(k: int) -> list:
    socks = []
    try:
        for _ in range(k):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _get(port: int, path: str, timeout: float = 60.0) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return json.loads(r.read())


def _post_boards(port: int, grids: np.ndarray, threads: int) -> list:
    """POST each board and wait for its answer (set-up traffic); a board
    that gets no answer reads status 0: the window judges the node."""
    from concurrent.futures import ThreadPoolExecutor

    def one(g):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/solve", data=json.dumps({"sudoku": g.tolist()}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=1800) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code
        except (OSError, http.client.HTTPException):
            return 0

    with ThreadPoolExecutor(max_workers=threads) as pool:
        return list(pool.map(one, grids))


def _ranges(ranges):
    """Host ranges around the node's HTTP handler and the front door's
    routing; returns the undo."""
    from distributed_sudoku_solver_tpu_torch.serving import http as http_mod
    from distributed_sudoku_solver_tpu_torch.serving.frontdoor import router

    saved = [(http_mod._Handler, "do_POST", "http.solve"),
             (router.FrontDoor, "route", "frontdoor.route")]
    originals = [getattr(cls, attr) for cls, attr, _ in saved]
    for (cls, attr, label), fn in zip(saved, originals):
        setattr(cls, attr, ranges.wrap(fn, label))

    def undo():
        for (cls, attr, _), fn in zip(saved, originals):
            setattr(cls, attr, fn)
    return undo


def window_boards(cell: dict, count: int, stream: str = "window") -> np.ndarray:
    """The boards the window sends, as the client sends them, drawn from
    the mix's ``corpus``.  With no ``pool``, ``count`` puzzles of the corpus
    none of which repeats, each under a fresh transform.  With a pool, pool
    boards (from ``corpus_seed``: the same for every seed) picked with
    Zipf(``zipf``) popularity, the run's seed ordering them and drawing the
    transforms; but for ``fresh_share`` of the requests, corpus puzzles
    outside the pool."""
    cfg, mix = cell["config"], cell["traffic"]
    bh, bw = cfg["box_h"], cfg["box_w"]
    if mix.get("pool") is None:
        return gen.draw(cell["seed"], stream, count, mix["corpus"])[0]
    corpus = int(mix["corpus_seed"])
    pool = pool_boards(cell)
    picks = gen.zipf_picks(gen.rng(corpus, stream), count, len(pool), float(mix["zipf"]))
    grids = pool[picks]
    # A fixed share of requests are puzzles no one sent before: the cache
    # misses them and the device solves them.
    fresh = int(round(float(mix.get("fresh_share", 0.0)) * count))
    if fresh:
        grids[:fresh] = gen.draw(corpus, "pool", fresh, mix["corpus"], start=len(pool),
                                 transform=False)[0]
    order = gen.rng(cell["seed"], stream + "-order")
    grids = grids[order.permutation(count)]
    if mix.get("transform"):
        grids = gen.apply(gen.transforms(order, count, bh, bw), grids)
    return grids


def pool_boards(cell: dict) -> np.ndarray:
    """The pool of published puzzles, as published (no transform)."""
    mix = cell["traffic"]
    return gen.draw(int(mix["corpus_seed"]), "pool", int(mix["pool"]), mix["corpus"],
                    transform=False)[0]


def boot(cell: dict):
    """Start the node; returns ``(port, stop)``, ``stop()`` ending it."""
    from distributed_sudoku_solver_tpu_torch import cli

    http_port, p2p_port = _free_ports(2)
    argv = ["-p", str(http_port), "-s", str(p2p_port), "--host", "127.0.0.1",
            *cell["config"]["serve_flags"]]
    ev = threading.Event()
    err: list = []

    def main():
        try:
            cli.main(argv, device=cell["device"], stop=ev)
        except BaseException as e:  # reported by boot's wait and by stop()
            err.append(e)
            raise

    th = threading.Thread(target=main, name="portbench-node", daemon=True)
    th.start()
    t0 = time.perf_counter()
    while True:
        if err or not th.is_alive():
            raise RuntimeError(f"the node did not start: {err[:1]}")
        try:
            _get(http_port, "/status", timeout=5)
            break
        except OSError:
            if time.perf_counter() - t0 > 600:
                raise RuntimeError("the node did not answer /status in 600 s") from None
            time.sleep(0.1)

    def stop():
        ev.set()
        th.join(120)
        if th.is_alive():
            raise RuntimeError("the node did not stop within 120 s")

    return http_port, stop


def warm_up(cell: dict, port: int) -> None:
    """Set-up traffic: ``warm`` corpus puzzles that the window never sends
    (the tail of the window's first permutation) and, for a mix with a
    pool, each pool board once and ``warm`` of them transformed."""
    cfg, mix = cell["config"], cell["traffic"]
    bh, bw = cfg["box_h"], cfg["box_w"]
    warm = int(mix["warm"])
    size = len(gen.corpus(mix["corpus"])[0])
    _post_boards(port, gen.draw(cell["seed"], "window", warm, mix["corpus"],
                                start=size - warm)[0], threads=8)
    if mix.get("pool") is not None:
        pool = pool_boards(cell)
        _post_boards(port, pool, threads=8)
        g = gen.rng(cell["seed"], "warm-transforms")
        _post_boards(port, gen.apply(gen.transforms(g, warm, bh, bw), pool[:warm]), threads=8)


def window(port: int, due, sent, conns: int, on_go=None) -> list:
    """Send ``sent[i]`` at ``due[i]`` from a load-generator process and
    return its per-request results; ``on_go()`` runs just before the first
    request is due (the context it returns spans the window)."""
    bodies = [json.dumps({"sudoku": g.tolist()}) for g in sent]
    child = subprocess.Popen(
        [sys.executable, "-m", "portbench.loadgen"], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        child.stdin.write(json.dumps({"port": port, "bodies": bodies, "due": list(map(float, due)),
                                      "conns": conns, "wait_s": WAIT_S}) + "\n")
        child.stdin.flush()
        if child.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")
        with on_go() if on_go is not None else contextlib.nullcontext():
            child.stdin.write("go\n")
            child.stdin.flush()
            out = child.stdout.readline()
        child.stdin.close()
        child.wait(30)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(30)
    return json.loads(out)


def judge(cell: dict, sent: np.ndarray, results: list) -> dict:
    """Every request of the window judged in the frame it was sent in, and
    its latency (a failed, refused or lost request's counted as
    ``FAILED_LATENCY_S`` at least)."""
    bh, bw = cell["config"]["box_h"], cell["config"]["box_w"]
    lat, wrong, lost, failed = [], 0, 0, 0
    solutions = np.zeros_like(sent)
    answered = np.zeros(len(sent), dtype=bool)
    statuses: dict = {}
    for i, (status, latency, _, _, _, body) in enumerate(results):
        statuses[str(status)] = statuses.get(str(status), 0) + 1
        if status == 201:
            try:
                solutions[i] = np.asarray(json.loads(body).get("solution"))
                answered[i] = True
            except (ValueError, TypeError):
                wrong += 1
            lat.append(latency)
        elif status == 0:
            lost += 1
            lat.append(FAILED_LATENCY_S)
        else:
            # 422 claims a satisfiable board unsatisfiable: wrong.  Any other
            # status (429, 500 unknown, 503, 504) is a request that failed.
            wrong += status == 422
            failed += status != 422
            lat.append(max(latency, FAILED_LATENCY_S))
    hook = cell.get("answers")
    if hook is not None:
        solutions, answered = hook(sent, solutions, answered)
    ok = right_answers(sent[answered], solutions[answered], bh, bw)
    wrong += int((~ok).sum())
    late = [r[2] for r in results if r[2] is not None]
    third = max(1, len(lat) // 3)
    return {"lat_ms": np.asarray(lat) * 1e3, "wrong": wrong, "lost": lost, "failed": failed,
            "p50_first_third_ms": float(np.median(lat[:third]) * 1e3),
            "p50_last_third_ms": float(np.median(lat[-third:]) * 1e3),
            "statuses": dict(sorted(statuses.items())),
            "late_p99_ms": float(np.percentile(late, 99) * 1e3) if late else None,
            "late_max_ms": float(max(late) * 1e3) if late else None}


def run(cell: dict) -> dict:
    import torch

    from portbench.yardstick import profwindow

    mix = cell["traffic"]
    on_cuda = torch.device(cell["device"] or "cuda").type == "cuda"
    rate, seconds = float(mix["rate_rps"]), float(cell["seconds"])
    due = arrivals.poisson_due(gen.rng(cell["seed"], "arrivals"), rate, seconds)
    sent = window_boards(cell, len(due))
    prof: list = []
    setup: list = []
    ranges = profwindow.Ranges()

    @contextlib.contextmanager
    def on_go():
        with contextlib.ExitStack() as stack:
            if on_cuda:
                torch.cuda.reset_peak_memory_stats()
            if cell["trace"]:
                stack.callback(_ranges(ranges))
                prof.append(stack.enter_context(profwindow.Window()))
            setup.append(time.perf_counter() - cell["t_start"])
            log(cell, "set-up done")
            yield

    port, stop = boot(cell)
    try:
        warm_up(cell, port)
        before = _get(port, "/metrics")
        results = window(port, due, sent, int(mix["conns"]), on_go)
        log(cell, "window done")
        after = _get(port, "/metrics")
        peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    finally:
        stop()

    j = judge(cell, sent, results)
    readings = {"metrics_before": before, "metrics_after": after}
    profile = None
    if cell["trace"]:
        client = [("client.request", r[3], r[4]) for r in results if r[3]]
        profile = profwindow.read(prof[0], ranges.spans + client)
        log(cell, f"trace read, {len(profile['device'])} device operations")
        readings["profile"] = profile
    return {
        "setup_s": setup[0],
        "e2e": {"solve_p50_ms": float(np.percentile(j["lat_ms"], 50)),
                "solve_p95_ms": float(np.percentile(j["lat_ms"], 95))},
        "attempted": len(results),
        "failed": j["failed"] + j["lost"] + j["wrong"],
        "checks": [("wrong_answers", j["wrong"], 0), ("lost_requests", j["lost"], 0)],
        "readings": readings,
        "profile": profile,
        "memory_peak_bytes": int(peak),
        "info": {"statuses": j["statuses"], "rate_rps": rate, "requests": len(results),
                 "p50_first_third_ms": j["p50_first_third_ms"],
                 "p50_last_third_ms": j["p50_last_third_ms"],
                 "late_p99_ms": j["late_p99_ms"], "late_max_ms": j["late_max_ms"]},
    }
