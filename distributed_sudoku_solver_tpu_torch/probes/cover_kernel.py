"""PCV: the cover-primitive probe as a CUDA kernel, and its plain version.

Port of the JAX package's ``benchmarks/probe_cover_kernel.py`` (``run()``
and its ``kernel`` Pallas call).  On random data from seed 0 it runs three
steps of the exact-cover kernel's primitives per lane: take the lowest
available row of the lane's packed row words, clear every row that shares
a column with it (the row itself is kept), add 1 to all 8 meta rows when a
row was available, and store the words from before the step into stack
slot ``meta[0] mod S``; then the column counts ``inc^T . bits``.  The probe
pinned the checksum of the output words, 653,337,268.

Shapes (the probe's): incidence ``inc`` float32 0/1 ``[R, C]`` with
``R = 32 W``, row words ``packed`` ``[W, T]``, ``meta`` int32 ``[8, T]``,
``stack`` ``[S, W, T]``; words are ``torch.int32`` read as uint32.  Out:
``cnt`` int32 ``[C, T]``, ``packed``, ``meta``, ``stack``.

:func:`cover_probe` takes the plain version (:func:`cover_probe_plain`,
which computes the counts and the conflict rows with f32 products of 0/1
matrices, as the probe does; exact in float32 for these small integers)
only for tensors on the CPU; for any other tensors it launches the kernel
(``csrc/probe_cover.cu``, no product of any kind) or raises.
``cover_probe_cuda.launches`` counts kernel launches.

Run: ``python -m distributed_sudoku_solver_tpu_torch.probes.cover_kernel
[--device cpu]``; prints the probe's JSON line and fails unless the
output words reproduce the pinned checksum.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.ops import cuda_build
from distributed_sudoku_solver_tpu_torch.ops.solve import resolve_device

R, W, C, T, S = 224, 7, 28, 128, 8  # the probe's shape (queens-14-like)
STEPS = 3
PINNED_CHECKSUM = 653337268
NO_ROW = 1 << 22  # the probe's key for "no row available"
_P = ctypes.c_void_p
_I = ctypes.c_int


def probe_inputs(seed: int = 0) -> tuple[torch.Tensor, ...]:
    """The probe's inputs from ``default_rng(seed)``: ``inc`` (density 0.1),
    random ``packed`` words, zero ``meta`` and ``stack``."""
    rng = np.random.default_rng(seed)
    inc = (rng.random((R, C)) < 0.1).astype(np.float32)
    packed = rng.integers(0, 2**32, (W, T), dtype=np.uint32).view(np.int32)
    return (torch.from_numpy(inc), torch.from_numpy(packed),
            torch.zeros((8, T), dtype=torch.int32), torch.zeros((S, W, T), dtype=torch.int32))


def checksum(packed: torch.Tensor) -> int:
    """The probe's checksum: the sum of the words as uint32, mod 2**31."""
    return int(((packed.to(torch.int64) & 0xFFFFFFFF).sum() % (1 << 31)).item())


def _check(inc, packed, meta, stack) -> tuple[int, int, int, int]:
    if inc.ndim != 2 or packed.ndim != 2 or meta.ndim != 2 or stack.ndim != 3:
        raise ValueError("expected inc [R, C], packed [W, T], meta [8, T], stack [S, W, T]")
    (r, c), (w, t), s = inc.shape, packed.shape, stack.shape[0]
    if r != 32 * w or tuple(meta.shape) != (8, t) or tuple(stack.shape[1:]) != (w, t):
        raise ValueError(f"shapes disagree: inc {tuple(inc.shape)}, packed {tuple(packed.shape)},"
                         f" meta {tuple(meta.shape)}, stack {tuple(stack.shape)}; R must be 32 W")
    if not 1 <= c <= 32 or not 1 <= w <= 8 or s < 1:
        raise ValueError(f"need 1 <= C <= 32, 1 <= W <= 8 and S >= 1, got C={c} W={w} S={s}")
    if inc.dtype != torch.float32:
        raise TypeError(f"inc must be torch.float32, got {inc.dtype}")
    for name, x in (("packed", packed), ("meta", meta), ("stack", stack)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {x.dtype}")
    return r, c, w, s


def cover_probe_plain(inc, packed, meta, stack, steps: int = STEPS):
    """The probe's ``kernel`` as torch ops, on any device."""
    r, _, w, s = _check(inc, packed, meta, stack)
    rows = torch.arange(r, device=packed.device)
    shift = (rows % 32)[:, None]

    def unpack(p):  # [W, T] words -> int32 0/1 [R, T]
        return (p[rows // 32] >> shift) & 1

    def pack(bits):  # int32 0/1 [R, T] -> [W, T] words
        u = (bits.to(torch.int64) << shift).reshape(w, 32, -1).sum(1)
        return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)

    slots = torch.arange(s, device=packed.device)[:, None, None]
    for _ in range(steps):
        bits = unpack(packed)
        rmin = torch.where(bits > 0, rows[:, None], NO_ROW).min(0).values  # [T]
        rowsel = (rows[:, None] == rmin) & (bits > 0)
        colset = inc.T @ rowsel.to(torch.float32)  # [C, T]: the chosen row's columns
        conflict = inc @ colset.clamp(max=1.0)  # [R, T]: rows sharing one of them
        new_packed = pack(torch.where((conflict > 0) & ~rowsel, 0, bits))
        meta = meta + (rmin < NO_ROW).to(torch.int32)[None]
        stack = torch.where(slots == torch.remainder(meta[0], s), packed[None], stack)
        packed = new_packed
    cnt = (inc.T @ unpack(packed).to(torch.float32)).to(torch.int32)
    return cnt, packed, meta, stack


def _lib():
    fn = cuda_build.load("probe_cover").dsst_probe_cover
    fn.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    fn.restype = _I
    return fn


def cover_probe_cuda(inc, packed, meta, stack, steps: int = STEPS):
    """Launch the kernel on CUDA tensors; returns the four outputs without a sync."""
    _, c, w, s = _check(inc, packed, meta, stack)
    args = (inc, packed, meta, stack)
    if any(x.device.type != "cuda" for x in args):
        raise ValueError(f"cover_probe_cuda needs CUDA tensors, got {[str(x.device) for x in args]}")
    if any(not x.is_contiguous() for x in args):
        raise ValueError("cover_probe_cuda needs contiguous tensors")
    if bool(((inc != 0) & (inc != 1)).any()):
        raise ValueError("cover_probe_cuda takes a 0/1 incidence")
    fn = _lib()
    t = packed.shape[1]
    cnt = torch.empty((c, t), dtype=torch.int32, device=packed.device)
    outs = (cnt, torch.empty_like(packed), torch.empty_like(meta), torch.empty_like(stack))
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = fn(*(x.data_ptr() for x in args), *(x.data_ptr() for x in outs), w, c, t, s, steps,
             stream)
    cuda_build.check(err, "dsst_probe_cover")
    cover_probe_cuda.launches += 1
    return outs


cover_probe_cuda.launches = 0


def cover_probe(inc, packed, meta, stack, steps: int = STEPS):
    """The probe's function.  CPU tensors: the plain version.  Otherwise: the kernel."""
    if all(x.device.type == "cpu" for x in (inc, packed, meta, stack)):
        return cover_probe_plain(inc, packed, meta, stack, steps)
    return cover_probe_cuda(inc, packed, meta, stack, steps)


def run_probe(device=None) -> dict:
    """The probe on its seed-0 inputs: the function's four outputs against
    the plain version's on the same device, and the pinned checksum."""
    dev = resolve_device(device)
    inputs = [x.to(dev) for x in probe_inputs()]
    before = cover_probe_cuda.launches
    got = cover_probe(*inputs)
    want = cover_probe_plain(*inputs)
    out = {
        "metric": "cover_kernel_probe",
        "bit_exact_vs_plain": all(torch.equal(a, b) for a, b in zip(got, want)),
        "packed_checksum": checksum(got[1]),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "launches": cover_probe_cuda.launches - before,
    }
    if out["packed_checksum"] != PINNED_CHECKSUM or not out["bit_exact_vs_plain"]:
        raise AssertionError(f"cover probe: checksum {out['packed_checksum']} (pinned "
                             f"{PINNED_CHECKSUM}), bit-exact {out['bit_exact_vs_plain']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="'cpu' for the plain version (default: CUDA)")
    args = ap.parse_args(argv)
    print(json.dumps(run_probe(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
