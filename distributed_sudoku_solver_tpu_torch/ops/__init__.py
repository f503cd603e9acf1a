"""Solver ops: bit algebra, propagation, the frontier engine and the CUDA kernels."""
