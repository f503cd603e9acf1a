"""PyTorch/CUDA port of distributed_sudoku_solver_tpu: batch and bulk Sudoku solving.

The JAX package ``distributed_sudoku_solver_tpu`` is the reference this
package is held against; nothing here imports it or JAX.  Entry points
(``ops.solve.solve_batch`` / ``solve_one``, ``ops.bulk.solve_bulk``) run on
CUDA unless the caller passes ``device="cpu"``, where the hand-written
kernels' plain torch versions run instead.  Kernel sources live in
``csrc/`` and are built by ``ops.cuda_build`` at first use.
"""
