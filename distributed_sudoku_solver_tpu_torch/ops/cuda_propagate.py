"""K1: the propagation fixpoint as a hand-written CUDA kernel, and its plain version.

Port of the JAX package's ``ops/pallas_propagate.py::propagate_fixpoint_pallas``.
The kernel (``csrc/propagate.cu``) gives each board one warp, keeps the
board in shared memory for the whole fixpoint and stops each board at its
own fixpoint; the returned sweep count is the maximum over boards, which is
what the TPU kernel's maximum over tiles and the plain batch-global loop
both count.  Boards are lane-first ``int32[B, n, n]`` (uint32 patterns).

:func:`propagate_fixpoint_pallas` takes the plain version
(:func:`propagate_fixpoint_plain`, i.e. ``ops.propagate.propagate``) only
for a tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
``propagate_fixpoint_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops import cuda_build
from distributed_sudoku_solver_tpu_torch.ops.propagate import RULE_TIERS, propagate

_P = ctypes.c_void_p
_I = ctypes.c_int


def _check_boards(cand: torch.Tensor, geom: Geometry, rules: str) -> None:
    if cand.ndim != 3 or tuple(cand.shape[1:]) != (geom.n, geom.n):
        raise ValueError(f"expected [B, {geom.n}, {geom.n}], got {tuple(cand.shape)}")
    if cand.dtype != torch.int32:
        raise TypeError(f"masks must be torch.int32, got {cand.dtype}")
    if rules not in RULE_TIERS:
        raise ValueError(f"unknown rules {rules!r}")


def propagate_fixpoint_plain(
    cand: torch.Tensor, geom: Geometry, max_sweeps: int = 64, rules: str = "basic"
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain torch fixpoint (batch-global loop), on any device."""
    _check_boards(cand, geom, rules)
    return propagate(cand, geom, max_sweeps, rules)


def _lib():
    lib = cuda_build.load("propagate")
    fn = lib.dsst_propagate
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def propagate_fixpoint_cuda(
    cand: torch.Tensor, geom: Geometry, max_sweeps: int = 64, rules: str = "basic"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on a CUDA tensor; returns (fixpoint, max sweeps) without a sync."""
    _check_boards(cand, geom, rules)
    if cand.device.type != "cuda":
        raise ValueError(f"propagate_fixpoint_cuda needs a CUDA tensor, got {cand.device}")
    if not cand.is_contiguous():
        raise ValueError("propagate_fixpoint_cuda needs a contiguous tensor")
    fn = _lib()
    b = cand.shape[0]
    out = torch.empty_like(cand)
    sweeps = torch.empty(b, dtype=torch.int32, device=cand.device)
    stream = torch.cuda.current_stream(cand.device).cuda_stream
    err = fn(cand.data_ptr(), out.data_ptr(), sweeps.data_ptr(), b, geom.box_h,
             geom.box_w, max_sweeps, RULE_TIERS.index(rules), stream)
    cuda_build.check(err, "dsst_propagate")
    propagate_fixpoint_cuda.launches += 1
    if b == 0:
        return out, torch.zeros((), dtype=torch.int32, device=cand.device)
    return out, sweeps.max()


propagate_fixpoint_cuda.launches = 0


def propagate_fixpoint_pallas(
    cand: torch.Tensor, geom: Geometry, max_sweeps: int = 64, rules: str = "basic"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for :func:`ops.propagate.propagate` on a ``[B, n, n]`` batch.

    The name keeps the JAX package's (``propagator='pallas'`` selects it).
    CPU tensor: the plain version.  CUDA tensor: the kernel."""
    if cand.device.type == "cpu":
        return propagate_fixpoint_plain(cand, geom, max_sweeps, rules)
    return propagate_fixpoint_cuda(cand, geom, max_sweeps, rules)
