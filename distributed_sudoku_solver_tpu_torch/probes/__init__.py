"""Ports of the JAX package's two Mosaic probes (``benchmarks/probe_*.py``).

Each module holds a hand-written CUDA kernel's wrapper, its plain torch
version and an entry point (``python -m distributed_sudoku_solver_tpu_torch.
probes.<name>``) that runs on the card unless ``--device cpu`` is given.
"""
