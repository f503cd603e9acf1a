"""The harness: find a cell's pieces by name, run it, and make its result.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration is ``configs/<config>.json``, the mix ``traffic/<traffic>.json``,
whose ``"kind"`` names the driver ``drivers/<kind>.py``, and each per-layer
metric is read by ``metrics/<name>.py``.  Adding a cell, a mix, a driver or a
metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level modules that no process of the benchmark may hold (compared
# whole: the port's own name begins with the last one's).
FORBIDDEN = ("jax", "jaxlib", "flax", "distributed_sudoku_solver_tpu")


def log(cell: dict, what: str) -> None:
    """A progress line on standard error, with the seconds since the start."""
    print(f"portbench: {what} at {time.perf_counter() - cell['t_start']:.3f} s",
          file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def resolve(workload: str, bench: dict, root: str = ROOT) -> dict:
    """The cell ``workload`` of ``bench`` with its configuration, traffic
    mix and the metrics it reports, all loaded by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in the benchmark")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(root, "portbench", "traffic", f"{w['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"] in names else [])]
    return {"workload": w, "config": config, "traffic": traffic, "end_to_end": e2e,
            "per_layer": layer}


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def reader(metric: str, root: str = ROOT):
    """``metrics/<metric>.py``'s ``read``, loaded from its file (a metric's
    name may hold dots)."""
    path = os.path.join(root, "portbench", "metrics", f"{metric}.py")
    mod_spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             device=None, answers=None, bench: Optional[dict] = None,
             traffic: Optional[dict] = None) -> dict:
    """Run one cell once; returns the result line as a dict, with the
    compared numbers under ``checks``, last.  ``device`` (None: the card)
    and ``answers`` (a hook the control and the fault tests put between the
    program's answers and the judge) are for those tests; the command line
    passes none of them, nor ``traffic`` (keys that replace the mix's, so
    that a test on the CPU can run a cell at a small size)."""
    cell = resolve(workload, bench or spec())
    cell["traffic"].update(traffic or {})
    run = {
        "config": cell["config"], "traffic": cell["traffic"], "seed": int(seed),
        "seconds": float(seconds), "trace": bool(trace), "device": device,
        "t_start": t_start, "answers": answers,
    }
    got = driver(cell["traffic"]["kind"]).run(run)
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            value = reader(m["name"])(got["readings"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**got["e2e"], "setup_s": got["setup_s"]}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    checks = {name: {"value": value, "limit": limit} for name, value, limit in got["checks"]}
    line = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": got["attempted"],
        "failed": got["failed"],
        "metrics": metrics,
        "device": {"count": int(cell["workload"]["chips"]),
                   "memory_peak_bytes": got["memory_peak_bytes"]},
        "info": got["info"],
    }
    if trace and got["profile"] is not None:
        line["device"]["busy_s"] = got["profile"]["busy_s"]
        line["device"]["window_s"] = got["profile"]["window_s"]
        line["breakdown"] = {"device_ops": got["profile"]["device_ops"],
                             "idle_gaps": got["profile"]["idle_gaps"]}
    line["checks"] = checks
    return line
