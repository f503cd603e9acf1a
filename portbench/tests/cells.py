"""Cells whose files are in ``portbench/`` but which ``BENCHMARK.json`` does
not register yet (PERF.md, Open questions), as a later change would
register them: the tests pass :func:`later_bench` to ``core.run_cell`` as
``bench``."""

from __future__ import annotations

from portbench import core

LATER_CELLS = [
    {"name": "sudoku9-bulk", "config": "sudoku9", "traffic": "bulk24", "chips": 1,
     "why": "back-to-back solve_bulk passes of 65,536 unique 24-clue boards"},
    {"name": "sudoku9-serve-device", "config": "sudoku9", "traffic": "serve-device", "chips": 1,
     "why": "open-loop Poisson POST /solve, unique corpus boards none of which repeats"},
    {"name": "sudoku9-serve-cached", "config": "sudoku9", "traffic": "serve-cached", "chips": 1,
     "why": "open-loop POST /solve, 128 pooled boards by Zipf(1.1) under fresh symmetries"},
]
SERVE = ["sudoku9-serve-device", "sudoku9-serve-cached"]


def later_bench() -> dict:
    bench = core.spec()
    return {
        **bench,
        "configs": bench["configs"] + [{"name": "sudoku9", "file": "portbench/configs/sudoku9.json"}],
        "workloads": LATER_CELLS,
        "end_to_end": [
            {"name": "boards_per_s", "unit": "boards/s", "better": "higher",
             "source": "host_clock", "workloads": ["sudoku9-bulk"]},
            {"name": "solve_p50_ms", "unit": "ms", "better": "lower", "source": "host_clock",
             "workloads": SERVE},
            {"name": "solve_p95_ms", "unit": "ms", "better": "lower", "source": "host_clock",
             "workloads": SERVE},
            {"name": "setup_s", "unit": "s", "better": "lower", "source": "host_clock"},
        ],
        "per_layer": [
            {"name": "k2_roofline_pct.bulk", "unit": "%", "better": "higher",
             "source": "device_trace", "layer": "K2", "moves": "boards_per_s",
             "workloads": ["sudoku9-bulk"]},
            {"name": "device_idle_pct.serve", "unit": "%", "better": "lower",
             "source": "device_trace", "layer": "device", "moves": "solve_p50_ms",
             "workloads": SERVE},
        ],
    }
