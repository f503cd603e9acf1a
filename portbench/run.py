"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It needs the CUDA cards the cell asks for and
exits 2, printing no result, where there are fewer.  With ``--trace 0`` the
line holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, the device's busy time and a breakdown of the traced window.  The
compared numbers go last, on standard error and under ``checks`` in the
line.  The kernels are built once per checkout into the program's
``_build/`` and loaded from there; ``TRITON_CACHE_DIR`` and
``TORCH_EXTENSIONS_DIR`` point into ``.portbench_cache/`` of the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import core  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench.run", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache = os.path.join(core.ROOT, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    bench = core.spec()
    cell = core.resolve(args.workload, bench)
    import torch

    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line = core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START,
                         bench=bench)
    bad = core.forbidden_modules()
    if bad:
        print(f"portbench: the process holds forbidden modules: {bad}", file=sys.stderr)
        return 3
    line["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), **line["device"]}
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
