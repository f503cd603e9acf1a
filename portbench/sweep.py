"""Find a serving cell's knee: the highest open-loop rate it sustains.

    python3 -m portbench.sweep --config sudoku9 --traffic serve-device --seed <n> --rates 20,30,40 --seconds 10

boots the node of the configuration (``configs/<config>.json``) once, runs
the mix's set-up, then one window at each rate in turn, each with boards
and arrivals of its own from the seed, and prints one
JSON line per rate: the median and 95th percentile latency, the statuses,
how late the generator ran, the median latency of the window's first and
last thirds (a backlog that grows through the window shows as a last third
far slower than the first), the front door's routes and the node's
histograms over the window.  The knee is read from these lines and
written into ``PERF.md``; the cell's mix then holds 0.8 times it.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402

from portbench import core  # noqa: E402
from portbench.drivers import serve  # noqa: E402
from portbench.gen import arrivals  # noqa: E402
from portbench.gen import boards as gen  # noqa: E402
from portbench.yardstick import hist, readings  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.sweep")
    ap.add_argument("--config", required=True, help="a name under configs/")
    ap.add_argument("--traffic", required=True, help="a serve mix under traffic/")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests/s")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench.sweep needs a CUDA card")
    pkg = os.path.join(core.ROOT, "portbench")
    cell = {"config": core.load_json(os.path.join(pkg, "configs", f"{args.config}.json")),
            "traffic": core.load_json(os.path.join(pkg, "traffic", f"{args.traffic}.json")),
            "seed": args.seed,
            "seconds": args.seconds, "trace": False, "device": None, "t_start": T_START,
            "answers": None}
    port, stop = serve.boot(cell)
    try:
        serve.warm_up(cell, port)
        for rate in (float(r) for r in args.rates.split(",")):
            due = arrivals.poisson_due(gen.rng(args.seed, f"sweep-arrivals-{rate}"), rate,
                                       args.seconds)
            sent = serve.window_boards(cell, len(due), stream=f"sweep-{rate}")
            before = serve._get(port, "/metrics")
            results = serve.window(port, due, sent, int(cell["traffic"]["conns"]))
            after = serve._get(port, "/metrics")
            j = serve.judge(cell, sent, results)
            hists = {}
            for name in sorted(after.get("hist", {})):
                d = hist.delta(before.get("hist", {}).get(name), after["hist"][name])
                if sum(d["counts"]):
                    hists[name] = [sum(d["counts"]), hist.quantile(d, 0.5), hist.quantile(d, 0.95)]
            print(json.dumps({
                "rate_rps": rate, "requests": len(results),
                "p50_ms": float(np.percentile(j["lat_ms"], 50)),
                "p95_ms": float(np.percentile(j["lat_ms"], 95)),
                "first_third_p50_ms": j["p50_first_third_ms"],
                "last_third_p50_ms": j["p50_last_third_ms"],
                "statuses": j["statuses"], "wrong": j["wrong"], "lost": j["lost"],
                "late_p99_ms": j["late_p99_ms"], "late_max_ms": j["late_max_ms"],
                "routes": readings.route_counts(before, after),
                "hist_count_p50_p95_ms": hists,
                "card": torch.cuda.get_device_name(0)}), flush=True)
            first, last = j["p50_first_third_ms"], j["p50_last_third_ms"]
            if set(j["statuses"]) != {"201"} or last > 2 * first + 100:
                break  # past the knee: a higher rate only queues longer
            time.sleep(2.0)
    finally:
        stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
