"""The benchmark of ``distributed_sudoku_solver_tpu_torch`` on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line (README.md).
Everything a cell needs is found by name: ``configs/<config>.json``,
``traffic/<mix>.json``, ``drivers/<kind>.py`` and ``metrics/<metric>.py``.
Nothing here imports ``jax``, ``jaxlib`` or ``distributed_sudoku_solver_tpu``.
"""
