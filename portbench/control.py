"""The control: the cell's run with one guarantee broken, which the judge
has to find.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 --seconds 5

runs the cell once per seed, on the card at the cell's own size, with the
program's answers passed through :func:`swap_digits` before the judge sees
them, and prints each run's compared numbers.  Swapping two digits keeps
every row, column and box valid and breaks "keeps its givens": it is what an
answer from the front door's cache looks like when its symmetry transform is
not undone on the way out.  Every run has to come out not correct.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402

from portbench import core  # noqa: E402


def swap_digits(grids: np.ndarray, a: int = 1, b: int = 2) -> np.ndarray:
    """``grids`` with digits ``a`` and ``b`` exchanged everywhere."""
    out = np.array(grids, copy=True)
    out[grids == a] = b
    out[grids == b] = a
    return out


def bulk_hook(puzzles, solution, solved, unsat):
    return swap_digits(solution), solved, unsat


def serve_hook(sent, solutions, answered):
    return swap_digits(solutions), answered


HOOKS = {"bulk": bulk_hook, "serve": serve_hook}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench.control needs a CUDA card")
    bench = core.spec()
    kind = core.resolve(args.workload, bench)["traffic"]["kind"]
    for seed in (int(s) for s in args.seeds.split(",")):
        line = core.run_cell(args.workload, seed, args.seconds, False, time.perf_counter(),
                             answers=HOOKS[kind], bench=bench)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "swap_digits",
                          "correct": line["correct"], "attempted": line["attempted"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
