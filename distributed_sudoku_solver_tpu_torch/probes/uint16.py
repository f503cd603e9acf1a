"""P16: the 9x9 fixpoint on 32- and 16-bit masks as a CUDA kernel, and its plain version.

Port of the JAX package's ``benchmarks/probe_uint16.py`` (``build()`` and
its ``fixpoint`` Pallas call).  The probe asks whether 16-bit candidate
masks pay: it runs the propagation fixpoint (naked singles, then hidden
singles, until no board changes or 64 sweeps) on boards-last ``[9, 9, T]``
tiles of uint32 masks and of uint16 masks, and times the two.

Masks are ``torch.int32`` (read as uint32) or ``torch.int16`` (read as
uint16), the port's rule for masks.  :func:`fixpoint_probe` takes the plain
version (:func:`fixpoint_probe_plain`) only for a tensor on the CPU; for
any other tensor it launches the kernel (``csrc/probe_uint16.cu``) or
raises.  ``fixpoint_probe_cuda.launches`` counts kernel launches.

Each board is iterated to its own fixpoint, capped at ``max_sweeps``.  The
TPU kernel looped per tile until no board of the tile changed; a sweep of
a board at its fixpoint changes nothing, so the output is the same.  The
kernel keeps each lane busy with a queue of boards in shared memory, so a
warp stops sweeping boards that have converged.  At 16 bits the kernel
packs two boards into a 32-bit word and sweeps both at once:
:func:`swar_dec`, :func:`swar_nonzero` and :func:`swar_multi` model its
per-half identities in numpy (the CPU tests check them on every 16-bit
value).

Run: ``python -m distributed_sudoku_solver_tpu_torch.probes.uint16
[--device cpu] [--batch 65536] [--iters 16]``; prints the probe's JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import time

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
from distributed_sudoku_solver_tpu_torch.ops import cuda_build
from distributed_sudoku_solver_tpu_torch.ops.bitmask import (
    encode_grid,
    from_boxes,
    once_twice_reduce,
    or_reduce,
    to_boxes,
)
from distributed_sudoku_solver_tpu_torch.ops.solve import resolve_device
from distributed_sudoku_solver_tpu_torch.utils.puzzles import puzzle_batch

_BITS = {torch.int32: 32, torch.int16: 16}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _check(cand_t: torch.Tensor) -> int:
    if cand_t.ndim != 3 or tuple(cand_t.shape[:2]) != (9, 9):
        raise ValueError(f"expected boards-last [9, 9, T], got {tuple(cand_t.shape)}")
    if cand_t.dtype not in _BITS:
        raise TypeError(f"masks must be torch.int32 or torch.int16, got {cand_t.dtype}")
    return _BITS[cand_t.dtype]


def _one_bit(x: torch.Tensor, bits: int) -> torch.Tensor:
    """True where the ``bits``-wide pattern holds exactly one set bit."""
    u = x.to(torch.int64) & ((1 << bits) - 1)
    return (u != 0) & ((u & (u - 1)) == 0)


def _unit_maps(x: torch.Tensor, reduce):
    """For each unit type (row, column, box) of lane-first ``[T, 9, 9]``
    boards: ``reduce`` (a tuple of per-unit tensors) over each unit's
    cells, every tensor broadcast back to the cells."""
    yield tuple(r[..., :, None].expand_as(x) for r in reduce(x, -1))
    yield tuple(r[..., None, :].expand_as(x) for r in reduce(x, -2))
    yield tuple(from_boxes(r[..., :, None].expand_as(x), SUDOKU_9)
                for r in reduce(to_boxes(x, SUDOKU_9), -1))


def _sweep_plain(c: torch.Tensor, bits: int) -> torch.Tensor:
    """The probe's ``sweep`` on lane-first ``[T, 9, 9]`` boards."""
    single = _one_bit(c, bits)
    decided = torch.where(single, c, torch.zeros_like(c))
    seen = torch.zeros_like(c)
    for (unit,) in _unit_maps(decided, lambda x, ax: (or_reduce(x, ax),)):
        seen = seen | unit
    c = torch.where(single, c, c & ~seen)
    forced = torch.zeros_like(c)
    for once, twice in _unit_maps(c, once_twice_reduce):
        forced = forced | (c & (once & ~twice))
    return torch.where(~single & (forced != 0), forced, c)


def probe_sweeps(cand_t: torch.Tensor, max_sweeps: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain fixpoint of ``[9, 9, T]`` boards and each board's sweep count
    (the sweeps its own loop runs, the last one that changes nothing
    included, at most ``max_sweeps``)."""
    bits = _check(cand_t)
    c = cand_t.permute(2, 0, 1)
    sweeps = torch.zeros(c.shape[0], dtype=torch.int32, device=c.device)
    active = torch.ones(c.shape[0], dtype=torch.bool, device=c.device)
    for _ in range(max_sweeps):
        nxt = _sweep_plain(c, bits)
        sweeps += active.to(torch.int32)
        active &= (nxt != c).flatten(1).any(1)
        c = nxt
        if not bool(active.any()):
            break
    return c.permute(1, 2, 0).contiguous(), sweeps


def fixpoint_probe_plain(cand_t: torch.Tensor, max_sweeps: int = 64) -> torch.Tensor:
    """The plain torch fixpoint (batch-global loop), on any device."""
    return probe_sweeps(cand_t, max_sweeps)[0]


# -- the kernel's 16-bit lane algebra, as a numpy model ------------------------
#
# A uint32 word holds two 16-bit masks; each identity below works on both
# halves at once with plain 32-bit operations and never carries or borrows
# from one half into the other, for any 16-bit values (csrc/probe_uint16.cu,
# ``Lanes<16>``, computes exactly these).

SWAR_H = np.uint32(0x80008000)  # bit 15 of each half
SWAR_L = np.uint32(0x7FFF7FFF)  # bits 0-14 of each half


def swar_dec(x: np.ndarray) -> np.ndarray:
    """Each half minus 1, mod 2**16: ``((x | H) - 0x00010001) ^ (~x & H)``."""
    x = np.asarray(x, dtype=np.uint32)
    return ((x | SWAR_H) - np.uint32(0x00010001)) ^ (~x & SWAR_H)


def swar_nonzero_flags(x: np.ndarray) -> np.ndarray:
    """Bit 15 of each half set where the half is not 0:
    ``(((x & L) + L) | x) & H``."""
    x = np.asarray(x, dtype=np.uint32)
    return (((x & SWAR_L) + SWAR_L) | x) & SWAR_H


def swar_widen(flags: np.ndarray) -> np.ndarray:
    """PRMT with selector 0xBB99: the sign of byte 1 replicated over bytes
    0-1, that of byte 3 over bytes 2-3 (bit 15 of each half spread over
    the half)."""
    f = np.asarray(flags, dtype=np.uint32)
    lo = np.where(f & np.uint32(0x8000), np.uint32(0x0000FFFF), np.uint32(0))
    hi = np.where(f & np.uint32(0x80000000), np.uint32(0xFFFF0000), np.uint32(0))
    return (lo | hi).astype(np.uint32)


def swar_nonzero(x: np.ndarray) -> np.ndarray:
    """All ones in each half that is not 0."""
    return swar_widen(swar_nonzero_flags(x))


def swar_multi(x: np.ndarray) -> np.ndarray:
    """All ones in each half that holds two bits or more:
    ``x & dec(x)`` is not 0 there."""
    x = np.asarray(x, dtype=np.uint32)
    return swar_widen(swar_nonzero_flags(x & swar_dec(x)))


def swar_single(x: np.ndarray) -> np.ndarray:
    """Each half where it holds exactly one bit, else 0 (the naked step's
    decided values): ``x & ~multi(x)``."""
    x = np.asarray(x, dtype=np.uint32)
    return x & ~swar_multi(x)


def _lib():
    fn = cuda_build.load("probe_uint16").dsst_probe_fixpoint
    fn.argtypes = [_P, _P, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def fixpoint_probe_cuda(cand_t: torch.Tensor, max_sweeps: int = 64) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor; returns the fixpoint without a sync."""
    bits = _check(cand_t)
    if cand_t.device.type != "cuda":
        raise ValueError(f"fixpoint_probe_cuda needs a CUDA tensor, got {cand_t.device}")
    if not cand_t.is_contiguous():
        raise ValueError("fixpoint_probe_cuda needs a contiguous tensor")
    if bits == 16 and cand_t.data_ptr() % 4:
        raise ValueError("fixpoint_probe_cuda reads int16 masks in pairs: 4-byte alignment")
    fn = _lib()
    out = torch.empty_like(cand_t)
    stream = torch.cuda.current_stream(cand_t.device).cuda_stream
    err = fn(cand_t.data_ptr(), out.data_ptr(), cand_t.shape[2], max_sweeps, bits, stream)
    cuda_build.check(err, "dsst_probe_fixpoint")
    fixpoint_probe_cuda.launches += 1
    return out


fixpoint_probe_cuda.launches = 0


def fixpoint_probe(cand_t: torch.Tensor, max_sweeps: int = 64) -> torch.Tensor:
    """The probe's fixpoint.  CPU tensor: the plain version.  Otherwise: the kernel."""
    if cand_t.device.type == "cpu":
        return fixpoint_probe_plain(cand_t, max_sweeps)
    return fixpoint_probe_cuda(cand_t, max_sweeps)


def probe_boards(batch: int, seed: int = 7, n_clues: int = 24, distinct: int = 512) -> torch.Tensor:
    """The probe's input, the JAX probe's corpus: ``distinct`` unique-
    solution ``n_clues``-clue 9x9 boards (``puzzle_batch``, seeds
    ``seed``..), tiled to ``batch``, encoded boards-last int32
    ``[9, 9, batch]``.  At a ``batch`` that is a multiple of ``distinct``
    the tensor equals the JAX probe's (``benchmarks/probe_uint16.py``); a
    smaller ``batch`` takes the first ``batch`` of its boards."""
    base = puzzle_batch(SUDOKU_9, min(distinct, batch), seed=seed, n_clues=n_clues)
    grids = base[np.arange(batch) % len(base)].astype(np.int32)
    return encode_grid(torch.from_numpy(grids), SUDOKU_9).permute(1, 2, 0).contiguous()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_probe(batch: int = 65536, iters: int = 16, reps: int = 3, device=None) -> dict:
    """The probe's A/B: for each dtype, ``iters`` fixpoint dispatches
    chained, each on the input rolled by its index along the boards (so no
    two dispatches see the same tensor), ORed into one result; the best of
    ``reps`` interleaved runs, host clock ending in a device sync.  Also
    the low 16 bits of the uint32 fixpoint against the uint16 one, and the
    kernel launches of each dtype."""
    dev = resolve_device(device)
    cand32 = probe_boards(batch).to(dev)
    cases = {"uint32": cand32, "uint16": cand32.to(torch.int16)}

    def chained(x):
        acc = torch.zeros_like(x)
        for i in range(iters):
            acc |= fixpoint_probe(torch.roll(x, i, dims=-1))
        return acc

    outs, best, launches = {}, {}, {}
    for name, x in cases.items():
        before = fixpoint_probe_cuda.launches
        outs[name] = fixpoint_probe(x)
        chained(x)  # warm-up (and the kernel's build, on the first call)
        launches[name] = fixpoint_probe_cuda.launches - before
        best[name] = float("inf")
    _sync(dev)
    for _ in range(reps):
        for name, x in cases.items():
            before = fixpoint_probe_cuda.launches
            t0 = time.perf_counter()
            chained(x)
            _sync(dev)
            best[name] = min(best[name], time.perf_counter() - t0)
            launches[name] += fixpoint_probe_cuda.launches - before
    out = {
        "metric": "uint16_probe",
        "batch": batch,
        "iters": iters,
        "bit_equal_low16": bool(torch.equal(outs["uint32"].to(torch.int16), outs["uint16"])),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    for name, dt in best.items():
        out[f"{name}_fixpoints_per_s"] = batch * iters / dt
        out[f"{name}_wall_s"] = dt
    out["speedup_uint16"] = best["uint32"] / best["uint16"]
    out["launches"] = launches
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="'cpu' for the plain version (default: CUDA)")
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=16)
    args = ap.parse_args(argv)
    print(json.dumps(run_probe(args.batch, args.iters, device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
