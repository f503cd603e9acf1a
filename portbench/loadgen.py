"""Open-loop HTTP load generator, run as a process of its own.

``python3 -m portbench.loadgen`` reads one JSON line from standard input:
``{"port", "bodies", "due", "conns", "wait_s"}``; it opens no connection
before it prints ``ready`` and reads the line ``go``.  From then on request
``i`` is sent at ``due[i]`` seconds after the go, whatever came back before,
by a pool of up to ``conns`` threads with a keep-alive connection each, and
its latency runs from its due time to the last byte of its answer.  A
request still unanswered ``wait_s`` seconds after the last due time is
given up.  The result is one JSON line on standard output: per request
``[status, latency_s, late_s, send_ns, done_ns, body]`` (status 0: no
answer), with ``send_ns`` and ``done_ns`` on the epoch clock.

It imports neither torch nor numpy, so that it starts in a fraction of a
second, and it runs apart from the node, so that its work never holds the
node's interpreter lock.
"""

from __future__ import annotations

import http.client
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait


def run(job: dict, go) -> list:
    port, bodies, due = job["port"], job["bodies"], job["due"]
    local = threading.local()
    results: list = [None] * len(bodies)
    t_go = [0.0]
    deadline = [0.0]

    def conn():
        c = getattr(local, "conn", None)
        if c is None:
            c = local.conn = http.client.HTTPConnection("127.0.0.1", port)
        c.timeout = max(1.0, deadline[0] - time.perf_counter())
        return c

    def send(i: int) -> None:
        due_at = t_go[0] + due[i]
        t_send = time.perf_counter()
        send_ns = time.time_ns()
        status, body = 0, ""
        for attempt in (0, 1):  # a keep-alive connection the server closed: reopen once
            c = conn()
            try:
                c.request("POST", "/solve", body=bodies[i],
                          headers={"Content-Type": "application/json"})
                resp = c.getresponse()
                body = resp.read().decode()
                status = resp.status
                break
            except (OSError, http.client.HTTPException) as e:
                c.close()
                local.conn = None
                body = f"{type(e).__name__}: {e}"
                if time.perf_counter() >= deadline[0]:
                    break
        t_done = time.perf_counter()
        results[i] = [status, t_done - due_at, t_send - due_at, send_ns, time.time_ns(), body]

    with ThreadPoolExecutor(max_workers=job["conns"]) as pool:
        go()
        t_go[0] = time.perf_counter()
        deadline[0] = t_go[0] + (due[-1] if due else 0.0) + job["wait_s"]
        futures = []
        for i, d in enumerate(due):
            delay = t_go[0] + d - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            futures.append(pool.submit(send, i))
        wait(futures, timeout=max(0.0, deadline[0] - time.perf_counter()) + 5.0)
    return [r if r is not None else [0, None, None, 0, 0, "no answer"] for r in results]


def main() -> int:
    job = json.loads(sys.stdin.readline())

    def go() -> None:
        print("ready", flush=True)
        if sys.stdin.readline().strip() != "go":
            raise SystemExit(2)

    print(json.dumps(run(job, go)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
