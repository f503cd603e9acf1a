#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels against their plain versions.

Run from the repository root, on a machine with one CUDA card and ``nvcc``:

    python3 chip_smoke.py                # every phase below
    python3 chip_smoke.py --breakdown    # phases 1-3 and K2's and K3's stage breakdowns only
    python3 chip_smoke.py --times        # phases 1, 3 and K1's / K2's / K3's device times only

Phases, each of which must pass (nothing is caught and skipped):

1. print the card's name, the device count and ``nvidia-smi``'s name and
   power limit;
2. build the kernels from ``distributed_sudoku_solver_tpu_torch/csrc``
   (one ``nvcc`` per library, started together: K1, K2, K3 and K2's and
   K3's counter builds) and print, per kernel instantiation (K1 and K2 are
   templates on the box shape, K3 on the instance's row and covered
   words), ptxas's registers, spills and stack frame and the warps an SM
   holds at that register count; fails if any instantiation spills;
3. generate the corpus: 65,533 seeded 24-clue 9x9 boards carved with
   ``make_puzzle(unique=False)`` plus ``HARD_9`` (every carved board keeps
   its parent solution, so no board may come back unsat);
4. K1 (fixpoint) against its plain version: 32,768 boards on every rule
   tier, plus 6x6, 12x12 (3x4 boxes, the run-time instantiation), 16x16
   and 25x25 batches; masks and sweep counts bit-equal;
5. K2 (fused rounds) against its plain version: one dispatch of a
   32,768-lane frontier seeded from the corpus (S=12, k_steps=8, extended
   rules) for every legacy branch rule, count_mode off and on; all 13
   outputs bit-equal (``sweeps_total`` under the port's per-lane sum);
   timed with minrem at that shape and on an 8,192-lane 16x16 frontier;
   then K2's counter build at the 9x9 shape with minrem and ``head:mlp``:
   each stage's share of the warps' ``clock64()`` cycles (the breakdown);
6. the main path, ``solve_bulk(corpus, SUDOKU_9, BulkConfig())`` twice:
   every solution valid and agreeing with its givens, no board unsat, K2's
   launch count above zero; boards/s of the second pass and its trace;
   then a third pass under torch.profiler for device time by kernel;
7. the composite path, ``solve_batch`` on 4,096 corpus boards with
   ``SolverConfig(propagator="pallas")``: verdicts checked, K1's launch
   count above zero;
8. K3 (cover rounds) against its plain version: a 4,096-lane, S=128
   frontier of ``nqueens_cover(14)``, ``pentomino_cover(6, 10)`` and
   ``sudoku_cover(SUDOKU_9)`` (HARD_9 clue roots), fanned out by driver
   rounds; one dispatch (k_steps=8) with count_mode off and on, all 13
   outputs bit-equal; the kernel's device time (torch.profiler), the
   wrapper's CUDA-event time, plain time and bound of each; then K3's
   counter build on each frontier: each stage's share of the warps'
   ``clock64()`` cycles, and the longest warp's cycles against the mean;
9. the cover path at full width, ``solve_csp`` with ``step_impl="fused"``,
   4,096 lanes, S=128, ``count_all``, ``steal_rounds=4``: n-queens 14 must
   count 365,596 and pentomino 6x10 9,356, exhausted, no overflow, K3's
   launch count above zero; wall, solutions/s and dispatches of the second
   run of each; then n-queens 14 once more under torch.profiler;
10. the composite cover path (``step_impl="xla"``): n-queens 12 must count
   14,200, and each HARD_9 board solved through ``sudoku_cover`` must
   decode to the copied oracle's solution;
11. K2 with each scored branch head (``head:minrem``, ``head:cw-slack``,
   ``head:mlp``) against its plain version at phase 5's shape (count_mode
   off), all 13 outputs bit-equal; the kernel's device time
   (torch.profiler), the plain version's time and the bound of each;
12. the head path at full width: ``solve_batch(step_impl="fused")`` on
   32,768 corpus boards (HARD_9 among them) at 32,768 lanes with
   ``minrem`` and each head: ``head:minrem``'s nodes and steps equal
   ``minrem``'s, every rule solves every board with valid, clue-keeping
   solutions (HARD_9 equal to the oracle's), K2 launched; boards/s and
   nodes per rule;
13. the latency flight as the serving megastep drives it: a one-slot,
   8-lane mailbox (``steal_gang=8``, no step budget, fused,
   ``head:cw-slack``) seeded from padding roots; per board (each HARD_9
   and the corpus's two boards with the most nodes): ``attach_roots`` ->
   ``advance_megastep_fused`` (64-round chunks, at most 64) -> the status
   word and verdict payload in one transfer -> ``detach``; each verdict
   equal to ``solve_one``'s; flight wall, chunks and host syncs (counted
   with ``torch.cuda.set_sync_debug_mode``);
14. snapshot resume: ``solve_batch_checkpointed`` on 4,096 boards,
   interrupted after its first chunk, resumed from the snapshot on disk,
   bit-identical to an uninterrupted run on every field;
15. the seconds the script took, the build's among them, then one JSON
   line ``{"kernels": [...]}`` (launches on the paths, times at the path's
   shape, the plain version's time, the bound; K2 once more for each
   head);
16. the last line, ``{"ok": true, "device": {...}}``.

Tolerance everywhere: exact equality (``max_abs_err`` 0), the kernels being
integer bit algebra.  Exits nonzero without a result where CUDA is absent.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))

# Peaks of one H100 SXM at 700 W.  HBM bandwidth, from NVIDIA's data sheet.
# The kernels do 32-bit integer work, which the data sheet does not rate: its
# 67 TFLOP/s float32 rate outside the tensor cores counts an FMA as two ops
# on 128 FP32 lanes per SM; compute capability 9.0 issues 64 32-bit integer
# ops (add, logic, shift, compare, min) per SM per clock (CUDA C++ Programming
# Guide, arithmetic instruction throughput), so 67e12 / 2 / 2 int32 ops/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 4

SIZES = dict(corpus=65536, k1_boards=32768, k2_lanes=32768, k2_lanes16=8192, composite=4096,
             n6=8192, n12=2048, n16=2048, n25=512, reps=5, cover_lanes=4096, cover_slots=128,
             cover_fanout_steps=160, cover_composite_lanes=1024, head_boards=32768,
             flight_extra=2, snapshot_boards=4096, snapshot_chunk=8)

HEAD_RULES = ("head:minrem", "head:cw-slack", "head:mlp")

# Enumeration counts the cover phases must reproduce exactly (OEIS A000170
# for n-queens 14; 2,339 tilings x 4 symmetries for pentomino 6x10).
COVER_COUNTS = {"nqueens14": 365_596, "pentomino6x10": 9_356, "nqueens12": 14_200}


def log(msg: str) -> None:
    print(msg, flush=True)


def sweep_ops(geom, rules: str) -> int:
    """Integer operations of one sweep of one board, counted on the plain
    algorithm: unit reductions at 1 op (OR) or 3 ops (once/twice) per cell
    per unit type, plus the per-cell combines of each stage."""
    n2 = geom.n * geom.n
    ops = (1 + 3 + 5) * n2 + (9 + 4) * n2  # elimination, hidden singles
    if rules in ("extended", "subsets"):
        ops += 2 * n2 * (3 + 2 * (geom.n_hboxes + geom.box_h)) + 2 * n2
    if rules == "subsets":
        ops += 21 * geom.n ** 3
    return ops


def round_ops(geom) -> int:
    """Integer operations of one round outside the fixpoint: status
    (3 unit types, 4 ops per cell each, + 2 per cell), branch key and
    argmin (3 per cell), row copy for the push or pop (1 per cell)."""
    return (12 + 2 + 3 + 1) * geom.n * geom.n


def _cols_per_row(problem) -> float:
    """Mean number of full columns (primary and secondary) of a row."""
    from distributed_sudoku_solver_tpu_torch.models.cover import _unpack_bits

    return float(_unpack_bits(problem.incidence, problem.n_cols_full).sum(1).mean())


def cover_dispatch_work(problem, top, stack, has_top, base, count, **kw) -> dict:
    """What one cover dispatch's data needs, from a plain run of it.

    ``columns``: the uncovered primary columns of every search pass of every
    live lane (each sweep, and the re-scan after a chain that the cap cut);
    ``loaded``: those of the states whose counts must be made from scratch,
    i.e. each live lane's first round and each round after a pop (every
    other round starts from the state the lane's own take left); ``takes``:
    the rows the sweeps took; ``decrements``: the primary columns of the
    rows that each take (forced, or a branch's guess) killed.  Covered
    columns need no count and are not charged."""
    import torch

    from distributed_sudoku_solver_tpu_torch.ops.cuda_step import _plain_rounds

    max_sweeps = kw.pop("max_sweeps")
    work = {"sweeps": 0, "columns": 0, "takes": 0, "loaded": 0, "decrements": 0}
    rl = torch.tensor(problem.row_list(), device=top.device)
    primary = ((rl >= 0) & (rl < problem.n_primary)).sum(1).to(torch.int64)  # per row
    shifts = torch.arange(32, device=top.device, dtype=torch.int32)
    undecided = {}  # the previous round's undecided lanes

    def killed_primary(before, after):
        gone = (before & ~after)[:, :, None] >> shifts & 1
        return (gone.flatten(1)[:, :problem.n_rows].to(torch.int64) * primary).sum(1)

    def propagate(states):
        # Dead lanes enter as zeros; a live state never is (it has rows
        # available or columns covered), and the sweep check below holds it.
        active = (states != 0).flatten(1).any(1)
        avail, covered = problem._split(states)
        fresh = active & ~undecided.get("lanes", torch.zeros_like(active))
        work["loaded"] += int((problem._counts(avail, covered)[1] & fresh[:, None]).sum())
        for _ in range(max_sweeps):
            work["sweeps"] += int(active.sum())
            work["columns"] += int((problem._counts(avail, covered)[1] & active[:, None]).sum())
            after, covered, took = problem._forced_take(avail, covered)
            active = active & took
            work["takes"] += int(active.sum())
            work["decrements"] += int(killed_primary(avail, after)[active].sum())
            avail = after
            if not bool(active.any()):
                break
        work["columns"] += int((problem._counts(avail, covered)[1] & active[:, None]).sum())
        return problem.propagate_per_lane(states, max_sweeps)

    def status(tops):
        slv, con = problem.status(tops)
        undecided["lanes"] = (tops != 0).flatten(1).any(1) & ~slv & ~con
        return slv, con

    def branch(tops):
        guess, rest = problem.branch(tops)
        dec = killed_primary(problem._split(tops)[0], problem._split(guess)[0])
        work["decrements"] += int(dec[undecided["lanes"]].sum())
        return guess, rest

    out = _plain_rounds(top, stack, has_top, base, count, propagate, status, branch,
                        words=problem.w_rows, **kw)
    if work["sweeps"] != int(out[11]):
        raise AssertionError(f"the work count saw {work['sweeps']} sweeps, the round {int(out[11])}")
    return work


def cover_dispatch_ops(problem, work: dict, nodes: int, copies: int) -> float:
    """Integer operations of one cover dispatch on its data, with the
    column counts kept from pass to pass: per uncovered column of a loaded
    state, AND, popcount and add per row word; per uncovered column of a
    search pass, one compare (the forced and MRV search); one decrement per
    primary column of a killed row; per row taken (forced, or a branch's
    guess), the lowest row (2 per row word), the take (one OR per row word
    per column of the row, 2 per row word to clear and keep, 1 per covered
    word); 1 per word of each state the stack pushes or pops."""
    wr, wc = problem.w_rows, problem.w_cols
    take = 2 * wr + (_cols_per_row(problem) + 2) * wr + wc
    return (work["loaded"] * 3 * wr + work["columns"] + work["decrements"]
            + (work["takes"] + nodes) * take + copies * (wr + wc))


def cover_dispatch_ops_recount(problem, work: dict, nodes: int, copies: int) -> float:
    """The bound of K3's first design, which counted every uncovered column
    at every search pass (AND, popcount and add per row word, 4 for the
    keys), the takes and copies as above; printed beside the bound of
    :func:`cover_dispatch_ops` for comparison."""
    wr, wc = problem.w_rows, problem.w_cols
    take = 2 * wr + (_cols_per_row(problem) + 2) * wr + wc
    return (work["columns"] * (3 * wr + 4) + (work["takes"] + nodes) * take
            + copies * (wr + wc))


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def event_ms(fn, reps: int, setup=None) -> float:
    """Mean CUDA-event time of ``fn(setup())`` over ``reps`` runs after one
    warm-up; ``setup`` runs outside the timed region."""
    import torch

    fn(setup() if setup else None)
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        arg = setup() if setup else None
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_ms(fn, reps: int, setup, match: str) -> float:
    """Mean device time per call of the kernels whose name contains
    ``match``, over ``reps`` calls of ``fn(setup())`` under torch.profiler
    after one warm-up; ``setup`` runs before the profiled region (profiled
    again, up to three windows, if one records no event of the kernel).
    For a kernel shorter than its wrapper's host work, where CUDA events
    around the wrapper would time the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(setup())
    for _ in range(3):  # a profiled window now and then records no kernel event
        args = [setup() for _ in range(reps)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for a in args:
                fn(a)
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages() if match in e.key)
        if us > 0:
            return us / reps / 1e3
    raise AssertionError(f"the profiler saw no device time of {match!r} in three windows")


def max_abs_err(a, b) -> int:
    """Largest absolute difference of two tensors' values (uint32 patterns
    compared as unsigned); raises on a shape or dtype mismatch."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype mismatch: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    if a.dtype == torch.bool:
        return int((a != b).sum().item() > 0)
    x = a.to(torch.int64)
    y = b.to(torch.int64)
    if a.dtype == torch.int32 and a.ndim >= 2:
        x, y = x & 0xFFFFFFFF, y & 0xFFFFFFFF
    return int((x - y).abs().max().item()) if x.numel() else 0


# -- phases ---------------------------------------------------------------------


def phase_device() -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    log(f"[1] device: {name} x{count}")
    log(smi[0])
    return {"kind": name, "count": count, "smi": smi[0]}


def phase_build() -> float:
    """Build every library (one nvcc each, all at once) and print ptxas's
    registers, spills and stack frame per kernel instantiation, with the
    warps an SM holds at that register count (4-warp blocks for K1 and K2,
    8 for K3; 64 warps at most).  No instantiation may spill."""
    from distributed_sudoku_solver_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    seconds = cuda_build.build(cuda_build.TARGETS + (("fused_step", "clocks"),
                                                      ("cover", "clocks")))
    build_s = time.perf_counter() - t0
    log(f"[2] build: {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
        f"total {build_s:.2f} s")
    spills = []
    for name in cuda_build.SOURCES:
        block = 256 if name == "cover" else 128  # threads per block
        for row in cuda_build.ptxas_kernels(cuda_build.ptxas_report(name)):
            geo = "" if row["geometry"] is None else f"<{', '.join(map(str, row['geometry']))}>"
            regs = row["registers"]
            warps = min(64, 65536 // (block * (-(-regs // 8) * 8)) * (block // 32))
            log(f"    {name} {row['kernel']}{geo}: {regs} registers, spill stores "
                f"{row['spill_stores']} B, spill loads {row['spill_loads']} B, stack frame "
                f"{row['stack_frame']} B; {warps} warps/SM by registers")
            if row["spill_stores"] or row["spill_loads"]:
                spills.append(f"{row['kernel']}{geo}")
    if spills:
        raise AssertionError(f"kernel instantiations spill: {spills}")
    return build_s


def make_corpus(geom, count: int, seed: int, n_clues=None, hard=()):
    import numpy as np

    from distributed_sudoku_solver_tpu_torch.utils.puzzles import make_puzzle

    boards = [np.asarray(h) for h in hard]
    boards += [make_puzzle(geom, seed + i, n_clues=n_clues, unique=False)
               for i in range(count - len(boards))]
    return np.stack(boards).astype(np.int32)


def phase_corpus(sizes):
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9

    t0 = time.perf_counter()
    corpus = make_corpus(SUDOKU_9, sizes["corpus"], seed=7, n_clues=24, hard=HARD_9)
    log(f"[3] corpus: {corpus.shape[0]} boards (HARD_9 + 24-clue carved, seed 7) "
        f"in {time.perf_counter() - t0:.2f} s")
    return corpus


def phase_k1(corpus, sizes, dev):
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import (
        SUDOKU_6,
        SUDOKU_9,
        SUDOKU_16,
        SUDOKU_25,
        Geometry,
    )
    from distributed_sudoku_solver_tpu_torch.ops import cuda_propagate as k1
    from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
    from distributed_sudoku_solver_tpu_torch.ops.propagate import RULE_TIERS, propagate_per_board

    batches = [
        (SUDOKU_9, torch.from_numpy(corpus[: sizes["k1_boards"]])),
        (SUDOKU_6, torch.from_numpy(make_corpus(SUDOKU_6, sizes["n6"], seed=17))),
        (Geometry(3, 4), torch.from_numpy(make_corpus(Geometry(3, 4), sizes["n12"], seed=19))),
        (SUDOKU_16, torch.from_numpy(make_corpus(SUDOKU_16, sizes["n16"], seed=11))),
        (SUDOKU_25, torch.from_numpy(make_corpus(SUDOKU_25, sizes["n25"], seed=13))),
    ]
    err = 0
    for geom, grids in batches:
        cand = encode_grid(grids.to(dev), geom).contiguous()
        for rules in RULE_TIERS:
            got, sw = k1.propagate_fixpoint_cuda(cand, geom, 64, rules)
            want, sw_plain = k1.propagate_fixpoint_plain(cand, geom, 64, rules)
            torch.cuda.synchronize()
            e = max_abs_err(got, want) + abs(int(sw) - int(sw_plain))
            log(f"[4] K1 {geom.n}x{geom.n} B={cand.shape[0]} {rules}: sweeps {int(sw)} "
                f"(plain {int(sw_plain)}) max_abs_err {e}")
            if e:
                raise AssertionError(f"K1 disagrees with its plain version: {geom} {rules}")
            err = max(err, e)

    # Timing at the composite path's shape: its first round propagates the
    # encoded corpus boards, basic rules (phase 7's SolverConfig).
    geom = SUDOKU_9
    cand = encode_grid(torch.from_numpy(corpus[: sizes["composite"]]).to(dev), geom).contiguous()
    def run(c, rules="basic"):
        return k1.propagate_fixpoint_cuda(c, geom, 64, rules)

    # The kernel's device time (profiler): the wrapper's CUDA-event time
    # also holds its host work and the sweep-count max.
    ms = device_ms(run, sizes["reps"], lambda: cand, "propagate_kernel")
    wrapper_ms = event_ms(lambda _: run(cand), sizes["reps"])
    plain_ms = event_ms(lambda _: k1.propagate_fixpoint_plain(cand, geom, 64, "basic"),
                        sizes["reps"])
    _, per_board = propagate_per_board(cand, geom, 64, "basic")
    n_bytes = 2 * cand.numel() * 4 + cand.shape[0] * 4
    n_ops = int(per_board.sum()) * sweep_ops(geom, "basic")
    bms, by = bound_ms(n_bytes, n_ops)
    wide = encode_grid(torch.from_numpy(corpus[: sizes["k1_boards"]]).to(dev), geom).contiguous()
    wide_ms = device_ms(lambda c: run(c, "extended"), sizes["reps"], lambda: wide,
                        "propagate_kernel")
    log(f"[4] K1 timing B={cand.shape[0]} basic: {ms:.4f} ms (kernel, profiler; wrapper "
        f"{wrapper_ms:.4f} ms, CUDA events), plain {plain_ms:.4f} ms, bound {bms:.6f} ms ({by}); "
        f"B={wide.shape[0]} extended: {wide_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}


def _seeded_frontier(corpus, lanes: int, slots: int, dev, geom=None):
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid

    geom = geom or SUDOKU_9
    top = encode_grid(torch.from_numpy(corpus[:lanes]).to(dev), geom).contiguous()
    stack = torch.zeros((lanes, slots, geom.n, geom.n), dtype=torch.int32, device=dev)
    has = torch.ones(lanes, dtype=torch.bool, device=dev)
    zeros = torch.zeros(lanes, dtype=torch.int32, device=dev)
    return top, stack, has, zeros, zeros.clone()


def _k2_check(frontier, geom, kw, what: str) -> int:
    """K2 and its plain version on one dispatch; all 13 outputs must agree."""
    import torch

    from distributed_sudoku_solver_tpu_torch.ops import cuda_step as k2

    top, stack, has, base, count = frontier
    got = k2.fused_rounds_cuda(top, stack.clone(), has, base, count, geom, **kw)
    want = k2.fused_rounds_plain(top, stack.clone(), has, base, count, geom, **kw)
    torch.cuda.synchronize()
    e = max(max_abs_err(a, b) for a, b in zip(got, want))
    log(f"[5] K2 {what} {kw['branch_rule']} count_mode={kw['count_mode']}: steps_max "
        f"{int(got[12])} sweeps_total {int(got[11])} nodes {int(got[8].sum())} max_abs_err {e}")
    if e:
        raise AssertionError(f"K2 disagrees with its plain version: {what} {kw}")
    return e


def _k2_timing(frontier, geom, kw, sizes, what: str) -> dict:
    """K2's device time on one dispatch (profiler; the wrapper's CUDA-event
    time beside it), its plain version's, and the bound from this
    dispatch's sweeps, rounds, pushes and pops."""
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step as k2

    top, stack, has, base, count = frontier
    lanes = top.shape[0]

    def run(s):
        return k2.fused_rounds_cuda(top, s, has, base, count, geom, **kw)

    ms = device_ms(run, sizes["reps"], stack.clone, "fused_kernel")
    wrapper_ms = event_ms(run, sizes["reps"], setup=stack.clone)
    plain_ms = event_ms(lambda s: k2.fused_rounds_plain(top, s, has, base, count, geom, **kw),
                        2, setup=stack.clone)
    out = k2.fused_rounds_cuda(top, stack.clone(), has, base, count, geom, **kw)
    nodes, live, sweeps_total = out[8], out[10], int(out[11])
    if bool(out[7].any()):
        raise AssertionError("the timed dispatch overflowed; the byte count assumes it does not")
    pushes = int(nodes.sum())
    pops = int((count + nodes - out[4]).sum())
    n2 = geom.n * geom.n
    n_bytes = (3 * lanes * n2 + (pushes + pops) * n2) * 4 + 11 * lanes * 4
    n_ops = sweeps_total * sweep_ops(geom, kw["rules"]) + int(live.sum()) * round_ops(geom)
    bms, by = bound_ms(n_bytes, n_ops)
    log(f"[5] K2 timing {what}: {ms:.4f} ms (kernel, profiler; wrapper {wrapper_ms:.4f} ms, "
        f"CUDA events), plain {plain_ms:.4f} ms, bound {bms:.6f} ms ({by}); pushes {pushes} "
        f"pops {pops} sweeps {sweeps_total}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}


def phase_k2(corpus, sizes, dev):
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9, SUDOKU_16
    from distributed_sudoku_solver_tpu_torch.ops.ordering import LEGACY_RULES

    geom = SUDOKU_9
    lanes, slots, k = sizes["k2_lanes"], 12, 8
    frontier = _seeded_frontier(corpus, lanes, slots, dev)
    what = f"L={lanes} S={slots} k={k}"
    err = 0
    for rule in LEGACY_RULES:
        for count_mode in (False, True):
            kw = dict(rules="extended", branch_rule=rule, max_sweeps=64, k_steps=k,
                      tile=128, count_mode=count_mode, sweep_unroll=2)
            err = max(err, _k2_check(frontier, geom, kw, what))

    # Timing at the bulk first pass's shape (BulkConfig(): S=12, 8 rounds per
    # dispatch, extended rules, minrem): the first dispatch of the chunk;
    # then the same dispatch on a 16x16 frontier.
    kw = dict(rules="extended", branch_rule="minrem", max_sweeps=64, k_steps=k, tile=128,
              count_mode=False, sweep_unroll=2)
    row = _k2_timing(frontier, geom, kw, sizes, f"9x9 {what}")
    lanes16 = sizes["k2_lanes16"]
    frontier16 = _seeded_frontier(make_corpus(SUDOKU_16, lanes16, seed=23), lanes16, slots, dev,
                                  SUDOKU_16)
    what16 = f"16x16 L={lanes16} S={slots} k={k}"
    err = max(err, _k2_check(frontier16, SUDOKU_16, kw, what16))
    _k2_timing(frontier16, SUDOKU_16, kw, sizes, what16)
    return {"max_abs_err": err, **row}


def phase_breakdown(corpus, sizes, dev) -> dict:
    """K2's counter build at phase 5's shape, minrem and head:mlp: the share
    of each stage in the warps' clock64() cycles ("other": loads, stores and
    loop control outside the stages)."""
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step as k2

    lanes, slots = sizes["k2_lanes"], 12
    top, stack, has, base, count = _seeded_frontier(corpus, lanes, slots, dev)
    out = {}
    for rule in ("minrem", "head:mlp"):
        cycles = k2.fused_rounds_stage_cycles(top, stack, has, base, count, SUDOKU_9,
                                              reps=sizes["reps"], branch_rule=rule)
        total = cycles.pop("total")
        cycles["other"] = total - sum(cycles.values())
        shares = {k: round(100 * v / total, 2) for k, v in cycles.items()}
        out[rule] = shares
        log(f"[5] K2 stage breakdown {rule} L={lanes} S={slots} k=8 extended "
            f"(% of {total} warp cycles over {sizes['reps']} launches): {json.dumps(shares)}")
    return out


def phase_times(corpus, sizes, dev) -> dict:
    """Kernel device times (torch.profiler) at the main path's shapes: K1 at
    the composite path's B=4,096 (basic) and at B=32,768 (extended), K2 at
    phase 5's shape with every branch rule and at 16x16, K3 at phase 8's
    three frontiers (count_mode on).  It calls only what
    every slice of the port provides, so a copy of this script run from
    the root of an older checkout times that checkout's kernels (the
    parent-versus-change comparison in PERF.md)."""
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9, SUDOKU_16
    from distributed_sudoku_solver_tpu_torch.ops import cuda_cover as k3
    from distributed_sudoku_solver_tpu_torch.ops import cuda_propagate as k1
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step as k2
    from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
    from distributed_sudoku_solver_tpu_torch.ops.ordering import LEGACY_RULES

    times = {}
    for boards, rules in ((sizes["composite"], "basic"), (sizes["k1_boards"], "extended")):
        cand = encode_grid(torch.from_numpy(corpus[:boards]).to(dev), SUDOKU_9).contiguous()
        times[f"K1 B={boards} {rules}"] = device_ms(
            lambda c, rules=rules: k1.propagate_fixpoint_cuda(c, SUDOKU_9, 64, rules),
            sizes["reps"], lambda cand=cand: cand, "propagate_kernel")
    lanes16 = sizes["k2_lanes16"]
    frontiers = [(SUDOKU_9, _seeded_frontier(corpus, sizes["k2_lanes"], 12, dev),
                  (*LEGACY_RULES, *HEAD_RULES)),
                 (SUDOKU_16, _seeded_frontier(make_corpus(SUDOKU_16, lanes16, seed=23), lanes16,
                                              12, dev, SUDOKU_16), ("minrem",))]
    for geom, (top, stack, has, base, count), rules in frontiers:
        for rule in rules:
            kw = dict(rules="extended", branch_rule=rule, max_sweeps=64, k_steps=8, tile=128,
                      count_mode=False, sweep_unroll=2)
            times[f"K2 {geom.n}x{geom.n} L={top.shape[0]} {rule}"] = device_ms(
                lambda st, kw=kw, f=(top, has, base, count), geom=geom: k2.fused_rounds_cuda(
                    f[0], st, f[1], f[2], f[3], geom, **kw),
                sizes["reps"], stack.clone, "fused_kernel")
    for name, problem, (top, stack, has, base, count) in cover_frontiers(sizes, dev):
        kw = dict(max_sweeps=problem.max_sweeps, k_steps=8, tile=128, count_mode=True)
        times[f"K3 {name} L={top.shape[0]}"] = device_ms(
            lambda st, kw=kw, f=(top, has, base, count), p=problem: k3.cover_fused_rounds_cuda(
                f[0], st, f[1], f[2], f[3], p, **kw),
            sizes["reps"], stack.clone, "cover_kernel")
    log(json.dumps({"times_ms": times}))
    return times


def check_solutions(grids, solution, solved, unsat, what: str) -> None:
    import numpy as np

    from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution

    if int(unsat.sum()):
        raise AssertionError(f"{what}: {int(unsat.sum())} boards came back unsat")
    if not bool(solved.all()):
        raise AssertionError(f"{what}: {int((~solved).sum())} boards unresolved")
    givens = grids > 0
    if not np.array_equal(solution[givens], grids[givens]):
        raise AssertionError(f"{what}: a solution disagrees with its givens")
    bad = [i for i in range(len(grids)) if not is_valid_solution(solution[i])]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} invalid solutions, first {bad[0]}")


def phase_main(corpus, dev):
    import numpy as np
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops import cuda_propagate, cuda_step
    from distributed_sudoku_solver_tpu_torch.ops.bulk import BulkConfig, solve_bulk
    from distributed_sudoku_solver_tpu_torch.utils.oracle import solve_oracle
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9

    cfg = BulkConfig()
    t0 = time.perf_counter()
    solve_bulk(corpus, SUDOKU_9, cfg, device=dev)
    torch.cuda.synchronize()
    log(f"[6] bulk pass 1: {time.perf_counter() - t0:.3f} s")

    cuda_step.fused_rounds_cuda.launches = 0
    cuda_propagate.propagate_fixpoint_cuda.launches = 0
    trace: dict = {}
    t0 = time.perf_counter()
    res = solve_bulk(corpus, SUDOKU_9, cfg, trace=trace, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K2": cuda_step.fused_rounds_cuda.launches,
                "K1": cuda_propagate.propagate_fixpoint_cuda.launches}
    check_solutions(corpus, res.solution, res.solved, res.unsat, "bulk")
    for i, h in enumerate(HARD_9):
        if not np.array_equal(res.solution[i], solve_oracle(h)):
            raise AssertionError(f"bulk: HARD_9[{i}] differs from the oracle's solution")
    if launches["K2"] <= 0:
        raise AssertionError("bulk main path launched K2 no time")
    log(f"[6] bulk pass 2: {len(corpus)} boards in {wall:.3f} s = "
        f"{len(corpus) / wall:.1f} boards/s; searched {res.searched}, by propagation "
        f"{int(res.by_propagation.sum())}; launches {launches}")
    log(f"[6] trace {json.dumps(trace, default=str)}")
    return launches


def phase_profile(corpus, dev) -> None:
    """A third bulk pass under torch.profiler: device time by kernel and
    the device's busy share of the pass's host wall clock (the profiler's
    own overhead lengthens that wall, so the share is a lower bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops.bulk import BulkConfig, solve_bulk

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve_bulk(corpus, SUDOKU_9, BulkConfig(), device=dev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    log(f"[6] profile: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f}% of wall)")
    for key, us, count in rows[:8]:
        log(f"    {us / 1e3:10.3f} ms  x{count:<6d} {key[:90]}")


def phase_composite(corpus, sizes, dev):
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops import cuda_propagate, cuda_step
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
    from distributed_sudoku_solver_tpu_torch.ops.solve import solve_batch

    grids = corpus[: sizes["composite"]]
    cfg = SolverConfig(propagator="pallas")
    cuda_step.fused_rounds_cuda.launches = 0
    cuda_propagate.propagate_fixpoint_cuda.launches = 0
    t0 = time.perf_counter()
    res = solve_batch(grids, SUDOKU_9, cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": cuda_propagate.propagate_fixpoint_cuda.launches,
                "K2": cuda_step.fused_rounds_cuda.launches}
    check_solutions(grids, res.solution.cpu().numpy(), res.solved.cpu().numpy(),
                    res.unsat.cpu().numpy(), "composite")
    if launches["K1"] <= 0:
        raise AssertionError("composite path launched K1 no time")
    log(f"[7] composite solve_batch: {len(grids)} boards in {wall:.3f} s, steps "
        f"{int(res.steps)}, sweeps {int(res.sweeps)}, steals {int(res.steals)}; "
        f"launches {launches}")
    return launches


def cover_instances(full: bool = True):
    """(name, problem, root states) of the cover phases: n-queens 14 and
    pentomino 6x10 from their single root, sudoku-cover 9x9 from the HARD_9
    clue roots (``full=False`` leaves the sudoku instance out)."""
    import numpy as np

    from distributed_sudoku_solver_tpu_torch.models.cover import sudoku_clue_rows, sudoku_cover
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.models.nqueens import nqueens_cover
    from distributed_sudoku_solver_tpu_torch.models.pentomino import pentomino_cover
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9

    out = []
    for name, problem in (("nqueens14", nqueens_cover(14)),
                          ("pentomino6x10", pentomino_cover(6, 10))):
        out.append((name, problem, problem.initial_state()[None]))
    if full:
        p = sudoku_cover(SUDOKU_9)
        roots = np.stack([p.state_with_rows_taken(sudoku_clue_rows(h)) for h in HARD_9])
        out.append(("sudoku-cover9x9", p, roots))
    return out


def cover_config(**kw):
    """The cover path's configuration (``benchmarks/bench_cover.py``'s width)."""
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig

    base = dict(lanes=SIZES["cover_lanes"], stack_slots=SIZES["cover_slots"],
                max_steps=1_000_000, count_all=True, steal_rounds=4, step_impl="fused")
    return SolverConfig(**{**base, **kw})


def cover_frontiers(sizes, dev):
    """(name, problem, (top, stack, has, base, count)) of phase 8: 4,096-lane
    frontiers of the three cover instances.  n-queens and pentomino grow
    from their one root through fused driver rounds (steals double the live
    lanes each dispatch); sudoku-cover seeds every lane with a HARD_9 clue
    root (cycled, one job each) and runs two dispatches so that stacks
    fill.  Calls only what every version of the cover port provides, so a
    copy of this script builds the same frontiers from an older checkout."""
    import numpy as np
    import torch

    from distributed_sudoku_solver_tpu_torch.ops import cuda_cover as k3
    from distributed_sudoku_solver_tpu_torch.ops.frontier import init_frontier

    lanes, k = sizes["cover_lanes"], 8
    out = []
    for name, problem, roots in cover_instances():
        cfg = cover_config()
        steps = sizes["cover_fanout_steps"]
        if roots.shape[0] > 1:
            roots = np.resize(roots, (lanes, *roots.shape[1:]))
            steps = 2 * k
        state = init_frontier(torch.from_numpy(roots).to(dev), cfg)
        state = k3.advance_cover_fused(state, steps, problem, cfg)
        frontier = (state.top, state.stack, state.has_top, state.base, state.count)
        log(f"[8] K3 {name} L={lanes} S={state.stack.shape[1]} D={state.top.shape[-1]}: "
            f"after {int(state.steps)} steps {int(state.has_top.sum())} lanes live, mean "
            f"stack {float(state.count.float().mean()):.1f}")
        out.append((name, problem, frontier))
    return out


def phase_k3(frontiers, sizes, dev):
    """K3 against its plain version on phase 8's frontiers, count_mode off
    and on; timing is at the enumeration path's mode (count_mode on)."""
    import torch

    from distributed_sudoku_solver_tpu_torch.ops import cuda_cover as k3

    lanes, k = sizes["cover_lanes"], 8
    err, rows = 0, {}
    for name, problem, (top, stack, has, base, count) in frontiers:
        for count_mode in (False, True):
            kw = dict(max_sweeps=problem.max_sweeps, k_steps=k, tile=128,
                      count_mode=count_mode)
            got = k3.cover_fused_rounds_cuda(top, stack.clone(), has, base, count, problem, **kw)
            want = k3.cover_fused_rounds_plain(top, stack.clone(), has, base, count, problem,
                                               **kw)
            torch.cuda.synchronize()
            e = max(max_abs_err(a, b) for a, b in zip(got, want))
            log(f"[8] K3 {name} count_mode={count_mode}: steps_max {int(got[12])} "
                f"sweeps_total {int(got[11])} nodes {int(got[8].sum())} sols "
                f"{int(got[9].sum())} max_abs_err {e}")
            if e:
                raise AssertionError(f"K3 disagrees with its plain version: {name} {count_mode}")
            err = max(err, e)

        kw = dict(max_sweeps=problem.max_sweeps, k_steps=k, tile=128, count_mode=True)

        def run(st):
            return k3.cover_fused_rounds_cuda(top, st, has, base, count, problem, **kw)

        ms = device_ms(run, sizes["reps"], stack.clone, "cover_kernel")
        wrapper_ms = event_ms(run, sizes["reps"], setup=stack.clone)
        plain_ms = event_ms(lambda st: k3.cover_fused_rounds_plain(top, st, has, base, count,
                                                                  problem, **kw),
                            1, setup=stack.clone)
        out = k3.cover_fused_rounds_cuda(top, stack.clone(), has, base, count, problem, **kw)
        nodes, live, sweeps_total = out[8], out[10], int(out[11])
        if bool(out[7].any()):
            raise AssertionError("the timed dispatch overflowed; the byte count assumes it does not")
        pushes = int(nodes.sum())
        pops = int((count + nodes - out[4]).sum())
        d = top.shape[-1]
        consts = problem.n_cols_full * problem.w_rows + problem.row_list().size
        n_bytes = (3 * lanes * d + (pushes + pops) * d + consts) * 4 + 11 * lanes * 4
        work = cover_dispatch_work(problem, top, stack.clone(), has, base, count, **kw)
        n_ops = cover_dispatch_ops(problem, work, pushes, pushes + pops)
        bms, by = bound_ms(n_bytes, n_ops)
        old_bms, _ = bound_ms(n_bytes, cover_dispatch_ops_recount(problem, work, pushes,
                                                                  pushes + pops))
        log(f"[8] K3 timing {name} L={lanes} count_mode: {ms:.4f} ms (kernel, profiler; "
            f"wrapper {wrapper_ms:.4f} ms, CUDA events), plain {plain_ms:.4f} ms, "
            f"bound {bms:.6f} ms ({by}; with a full count at every pass {old_bms:.6f} ms); "
            f"pushes {pushes} pops {pops} sweeps {sweeps_total} (forced takes "
            f"{work['takes']}, uncovered columns searched {work['columns']} of "
            f"{sweeps_total * problem.n_primary}, counted from scratch {work['loaded']}, "
            f"decrements {work['decrements']}) live rounds {int(live.sum())}")
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}
    return err, rows


def phase_cover_breakdown(frontiers, sizes) -> dict:
    """K3's counter build on phase 8's frontiers (k_steps=8, count_mode on):
    each stage's share of the warps' clock64() cycles ("other": output
    stores and loop control outside the stages), and the longest warp's
    cycles against the mean warp's (the dispatch waits for the longest)."""
    from distributed_sudoku_solver_tpu_torch.ops import cuda_cover as k3

    out = {}
    for name, problem, (top, stack, has, base, count) in frontiers:
        cycles = k3.cover_fused_rounds_stage_cycles(
            top, stack, has, base, count, problem, reps=sizes["reps"],
            max_sweeps=problem.max_sweeps, k_steps=8, count_mode=True)
        longest = cycles.pop("longest warp")
        total = cycles.pop("total")
        cycles["other"] = total - sum(cycles.values())
        shares = {k: round(100 * v / total, 2) for k, v in cycles.items()}
        mean = total / (sizes["reps"] * top.shape[0])
        out[name] = dict(shares, total=total, longest=longest, mean=mean)
        log(f"[8] K3 stage breakdown {name} L={top.shape[0]} S={stack.shape[1]} k=8 count_mode "
            f"(% of {total} warp cycles over {sizes['reps']} launches): {json.dumps(shares)}; "
            f"longest warp {longest} cycles, mean warp {mean:.0f} ({longest / mean:.2f}x)")
    return out


def _check_cover_solution(name, problem, solution) -> None:
    from distributed_sudoku_solver_tpu_torch.models.nqueens import decode_queens, is_valid_queens
    from distributed_sudoku_solver_tpu_torch.models.pentomino import decode_tiling, is_valid_tiling

    if name.startswith("nqueens"):
        n = int(name[len("nqueens"):])
        ok = is_valid_queens(decode_queens(problem, solution, n), n)
    else:
        ok = is_valid_tiling(decode_tiling(problem, solution, 6, 10))
    if not ok:
        raise AssertionError(f"{name}: the first solution found does not decode to a valid one")


def phase_cover_main(dev):
    """The cover path at full width: fused enumerations, second run timed."""
    import torch

    from distributed_sudoku_solver_tpu_torch.ops import cuda_cover, cuda_propagate, cuda_step
    from distributed_sudoku_solver_tpu_torch.ops.solve import solve_csp

    cfg = cover_config()
    launches = {}
    for name, problem, roots in cover_instances(full=False):
        t0 = time.perf_counter()
        solve_csp(roots, problem, cfg, device=dev)
        torch.cuda.synchronize()
        log(f"[9] {name} run 1: {time.perf_counter() - t0:.3f} s")
        cuda_cover.cover_fused_rounds_cuda.launches = 0
        cuda_step.fused_rounds_cuda.launches = 0
        cuda_propagate.propagate_fixpoint_cuda.launches = 0
        t0 = time.perf_counter()
        res = solve_csp(roots, problem, cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = cuda_cover.cover_fused_rounds_cuda.launches
        others = cuda_step.fused_rounds_cuda.launches + cuda_propagate.propagate_fixpoint_cuda.launches
        count = int(res.sol_count[0])
        if count != COVER_COUNTS[name]:
            raise AssertionError(f"{name}: counted {count}, expected {COVER_COUNTS[name]}")
        if not bool(res.unsat[0]) or bool(res.overflowed[0]):
            raise AssertionError(f"{name}: not exhausted ({bool(res.unsat[0])}) or overflowed "
                                 f"({bool(res.overflowed[0])})")
        if n <= 0 or others:
            raise AssertionError(f"{name}: K3 launched {n} times, K1/K2 {others} times")
        _check_cover_solution(name, problem, res.solution[0])
        launches[name] = n
        log(f"[9] {name} run 2: {count} solutions in {wall:.3f} s = {count / wall:.1f} "
            f"solutions/s; dispatches {n}, steps {int(res.steps)}, nodes "
            f"{int(res.nodes[0])}, sweeps {int(res.sweeps)}, steals {int(res.steals)}")
    return launches


def phase_cover_profile(dev) -> None:
    """n-queens 14 once more under torch.profiler: device time by kernel and
    the device's busy share of the host wall clock (a lower bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_sudoku_solver_tpu_torch.ops.solve import solve_csp

    name, problem, roots = cover_instances(full=False)[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve_csp(roots, problem, cover_config(), device=dev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    log(f"[9] profile {name}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f}% of wall)")
    for key, us, count in rows[:8]:
        log(f"    {us / 1e3:10.3f} ms  x{count:<6d} {key[:90]}")


def phase_cover_composite(sizes, dev):
    """The composite cover path: an n-queens 12 count and the HARD_9 boards
    solved as exact cover, each against the copied oracle."""
    import numpy as np
    import torch

    from distributed_sudoku_solver_tpu_torch.models.cover import (
        decode_sudoku_cover,
        sudoku_clue_rows,
        sudoku_cover,
    )
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.models.nqueens import nqueens_cover
    from distributed_sudoku_solver_tpu_torch.ops import cuda_cover
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
    from distributed_sudoku_solver_tpu_torch.ops.solve import solve_csp
    from distributed_sudoku_solver_tpu_torch.utils.oracle import solve_oracle
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9

    cuda_cover.cover_fused_rounds_cuda.launches = 0
    p = nqueens_cover(12)
    cfg = cover_config(lanes=sizes["cover_composite_lanes"], step_impl="xla")
    t0 = time.perf_counter()
    res = solve_csp(p.initial_state()[None], p, cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    count = int(res.sol_count[0])
    if count != COVER_COUNTS["nqueens12"] or not bool(res.unsat[0]) or bool(res.overflowed[0]):
        raise AssertionError(f"composite nqueens12: counted {count}, unsat "
                             f"{bool(res.unsat[0])}, overflowed {bool(res.overflowed[0])}")
    log(f"[10] composite nqueens12: {count} solutions in {wall:.3f} s, steps "
        f"{int(res.steps)}, sweeps {int(res.sweeps)}, nodes {int(res.nodes[0])}")

    p = sudoku_cover(SUDOKU_9)
    roots = np.stack([p.state_with_rows_taken(sudoku_clue_rows(h)) for h in HARD_9])
    t0 = time.perf_counter()
    res = solve_csp(roots, p, SolverConfig(min_lanes=64, stack_slots=64), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for i, h in enumerate(HARD_9):
        grid = decode_sudoku_cover(p, res.solution[i], 9)
        if not bool(res.solved[i]) or not np.array_equal(grid, solve_oracle(h)):
            raise AssertionError(f"sudoku-cover: HARD_9[{i}] differs from the oracle's solution")
    if cuda_cover.cover_fused_rounds_cuda.launches:
        raise AssertionError("the composite cover path launched K3")
    log(f"[10] composite sudoku-cover HARD_9: {len(HARD_9)} boards solved in {wall:.3f} s, "
        f"steps {int(res.steps)}, nodes {int(res.nodes.sum())}; all equal the oracle")


def head_score_ops(rule: str, n: int) -> tuple[int, int, int]:
    """A head's work on top of phase 5's round, counted on the plain
    algorithm: (int32 ops per branch: the unit sums, 4 per cell per unit
    type; int32 ops per undecided cell: unpacking 3 unit words, the peer
    and feature differences, the key and the min; float ops per undecided
    cell: conversions, the score, the quantization and its clamp)."""
    per_branch = 3 * n * n * 4
    if rule == "head:minrem":
        return per_branch, 3 + 6, 1 + 5
    if rule == "head:cw-slack":
        return per_branch, 6 + 5 + 3, 4 + 5
    # 7 features (convert + scale), 8 hidden units of 7 products, 6 sums,
    # the bias and the ReLU, 8 output products and 7 sums, the bias.
    return per_branch, 6 + 6 + 3, 7 + 7 + 8 * (7 + 6 + 2) + 8 + 7 + 1 + 5


def head_dispatch_work(top, stack, has, base, count, geom, rule, k) -> dict:
    """Branches and undecided cells one head dispatch scores on this data,
    from a plain replay of it (a dead lane enters as zeros, a contradiction,
    and is not counted)."""
    from distributed_sudoku_solver_tpu_torch.ops.bitmask import popcount
    from distributed_sudoku_solver_tpu_torch.ops.cuda_step import (
        _plain_rounds,
        head_branch_full,
        status_full,
    )
    from distributed_sudoku_solver_tpu_torch.ops.propagate import propagate_per_board

    work = {"branches": 0, "cells": 0}

    def branch(tops):
        solved, contra = status_full(tops, geom)
        und = ~solved & ~contra
        work["branches"] += int(und.sum())
        work["cells"] += int(((popcount(tops) > 1) & und[:, None, None]).sum())
        return head_branch_full(tops, geom, rule)

    out = _plain_rounds(top, stack, has, base, count,
                        lambda b: propagate_per_board(b, geom, 64, "extended", unroll=2),
                        lambda b: status_full(b, geom), branch, k, 128, False)
    if work["branches"] != int(out[8].sum()):
        raise AssertionError(f"the work count saw {work['branches']} branches, the round "
                             f"{int(out[8].sum())}")
    return work


def phase_k2_heads(corpus, sizes, dev):
    """K2 with each scored head against its plain version at phase 5's
    shape; device time from the profiler, the plain version's time, the
    bound (a float op counts as half an int32 op: the H100's non-FMA f32
    rate is twice its int32 rate)."""
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step as k2

    geom = SUDOKU_9
    lanes, slots, k = sizes["k2_lanes"], 12, 8
    top, stack, has, base, count = _seeded_frontier(corpus, lanes, slots, dev)
    rows = {}
    for rule in HEAD_RULES:
        kw = dict(rules="extended", branch_rule=rule, max_sweeps=64, k_steps=k, tile=128,
                  count_mode=False, sweep_unroll=2)
        got = k2.fused_rounds_cuda(top, stack.clone(), has, base, count, geom, **kw)
        want = k2.fused_rounds_plain(top, stack.clone(), has, base, count, geom, **kw)
        torch.cuda.synchronize()
        e = max(max_abs_err(a, b) for a, b in zip(got, want))
        log(f"[11] K2 L={lanes} S={slots} k={k} {rule}: steps_max {int(got[12])} sweeps_total "
            f"{int(got[11])} nodes {int(got[8].sum())} max_abs_err {e}")
        if e:
            raise AssertionError(f"K2 disagrees with its plain version: {rule}")

        def run(st, kw=kw):
            return k2.fused_rounds_cuda(top, st, has, base, count, geom, **kw)

        ms = device_ms(run, sizes["reps"], stack.clone, "fused_kernel")
        plain_ms = event_ms(lambda st, kw=kw: k2.fused_rounds_plain(top, st, has, base, count,
                                                                   geom, **kw),
                            1, setup=stack.clone)
        nodes, live, sweeps_total = got[8], got[10], int(got[11])
        if bool(got[7].any()):
            raise AssertionError("the dispatch overflowed; the byte count assumes it does not")
        pushes = int(nodes.sum())
        pops = int((count + nodes - got[4]).sum())
        n2 = geom.n * geom.n
        n_bytes = (3 * lanes * n2 + (pushes + pops) * n2) * 4 + 11 * lanes * 4
        work = head_dispatch_work(top, stack.clone(), has, base, count, geom, rule, k)
        per_branch, int_cell, float_cell = head_score_ops(rule, geom.n)
        n_ops = (sweeps_total * sweep_ops(geom, "extended") + int(live.sum()) * round_ops(geom)
                 + work["branches"] * per_branch + work["cells"] * (int_cell + float_cell / 2))
        bms, by = bound_ms(n_bytes, n_ops)
        log(f"[11] K2 timing {rule}: {ms:.4f} ms (kernel, profiler), plain {plain_ms:.4f} ms, "
            f"bound {bms:.6f} ms ({by}); branches {work['branches']} undecided cells scored "
            f"{work['cells']}")
        rows[rule] = {"max_abs_err": e, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                      "bound_by": by}
    return rows


def phase_heads_main(corpus, sizes, dev):
    """``solve_batch(step_impl="fused")`` at full width with minrem and
    each head; returns (launches per head, minrem's nodes per board)."""
    import numpy as np
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
    from distributed_sudoku_solver_tpu_torch.ops.solve import solve_batch
    from distributed_sudoku_solver_tpu_torch.utils.oracle import solve_oracle
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9

    grids = corpus[: sizes["head_boards"]]
    base = dict(step_impl="fused", rules="extended")
    solve_batch(grids, SUDOKU_9, SolverConfig(**base), device=dev)  # warm-up
    torch.cuda.synchronize()
    results, launches = {}, {}
    for rule in ("minrem", *HEAD_RULES):
        cuda_step.fused_rounds_cuda.launches = 0
        t0 = time.perf_counter()
        res = solve_batch(grids, SUDOKU_9, SolverConfig(branch=rule, **base), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[rule] = cuda_step.fused_rounds_cuda.launches
        res = res._replace(**{f: getattr(res, f).cpu() for f in res._fields})
        check_solutions(grids, res.solution.numpy(), res.solved.numpy(), res.unsat.numpy(),
                        f"heads {rule}")
        for i, h in enumerate(HARD_9):
            if not np.array_equal(res.solution[i].numpy(), solve_oracle(h)):
                raise AssertionError(f"{rule}: HARD_9[{i}] differs from the oracle's solution")
        if launches[rule] <= 0:
            raise AssertionError(f"{rule}: the head path launched K2 no time")
        results[rule] = res
        log(f"[12] {rule}: {len(grids)} boards in {wall:.3f} s = {len(grids) / wall:.1f} boards/s; "
            f"nodes {int(res.nodes.sum())}, steps {int(res.steps)}, steals {int(res.steals)}; "
            f"K2 launches {launches[rule]}")
    ref, same = results["minrem"], results["head:minrem"]
    if not (torch.equal(same.nodes, ref.nodes) and int(same.steps) == int(ref.steps)):
        raise AssertionError("head:minrem's nodes or steps differ from minrem's")
    return launches, ref.nodes.numpy()


def _count_syncs(fn, counts=None, stage=None):
    """``fn()``; with ``counts``, its host syncs (torch's sync debug mode)
    are added to ``counts[stage]``."""
    import torch

    if counts is None:
        return fn()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counts[stage] = counts.get(stage, 0) + sum("synchroniz" in str(w.message) for w in seen)
    return out


def _fly(mailbox, board, cfg, dev, syncs=None):
    """One latency flight: attach -> megastep -> status word and verdict
    payload in one transfer -> detach.  Returns (mailbox, verdict); with
    ``syncs`` (a dict), each stage's host syncs are counted into it."""
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops.bitmask import decode_grid, encode_grid
    from distributed_sudoku_solver_tpu_torch.ops.cuda_step import advance_megastep_fused
    from distributed_sudoku_solver_tpu_torch.ops.frontier import (
        attach_roots,
        detach,
        status_len,
        unpack_status,
    )

    def attach():
        root = encode_grid(torch.from_numpy(board[None]).to(dev), SUDOKU_9)
        return attach_roots(mailbox, root, torch.zeros(1, dtype=torch.int32, device=dev),
                            cfg.steal_gang)

    mailbox = _count_syncs(attach, syncs, "attach")
    mailbox, status, chunks = _count_syncs(
        lambda: advance_megastep_fused(mailbox, 64, 64, SUDOKU_9, cfg), syncs, "advance")
    payload = _count_syncs(
        lambda: torch.cat([status, mailbox.nodes, mailbox.sol_count,
                           mailbox.overflowed.to(torch.int32),
                           decode_grid(mailbox.solution).flatten()]).cpu().numpy(),
        syncs, "fetch")
    mailbox = _count_syncs(
        lambda: detach(mailbox, torch.ones(1, dtype=torch.bool, device=dev)), syncs, "detach")
    w = status_len(1)
    info = unpack_status(payload[:w], 1)
    verdict = dict(solved=bool(info["solved"][0]), has_work=bool(info["has_work"][0]),
                   chunks=chunks, nodes=int(payload[w]), overflowed=bool(payload[w + 2]),
                   solution=payload[w + 3:].reshape(9, 9), steps=info["steps"])
    return mailbox, verdict


def phase_flight(corpus, minrem_nodes, sizes, dev):
    """The latency flight, shaped as the serving megastep shapes it."""
    import numpy as np
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig, init_frontier_roots
    from distributed_sudoku_solver_tpu_torch.ops.solve import solve_one
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9

    gang = 8  # MegastepConfig(): gang_lanes 8, chunk_steps 64, max_chunks 64
    cfg = SolverConfig(step_impl="fused", branch="head:cw-slack", lanes=gang, min_lanes=gang,
                       steal_gang=gang, max_steps=(1 << 31) - 1)
    mailbox = init_frontier_roots(torch.zeros((gang, 9, 9), dtype=torch.int32, device=dev),
                                  torch.full((gang,), -1, dtype=torch.int32, device=dev), 1, cfg)
    hard = [int(i) for i in np.argsort(-minrem_nodes[len(HARD_9):])[: sizes["flight_extra"]]]
    boards = [(f"HARD_9[{i}]", np.asarray(h, np.int32)) for i, h in enumerate(HARD_9)]
    boards += [(f"corpus[{i + len(HARD_9)}]", corpus[i + len(HARD_9)]) for i in hard]
    mailbox, _ = _fly(mailbox, boards[0][1], cfg, dev)  # warm-up
    rows, launches = [], 0
    for name, board in boards:
        torch.cuda.synchronize()
        cuda_step.fused_rounds_cuda.launches = 0
        t0 = time.perf_counter()
        mailbox, v = _fly(mailbox, board, cfg, dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches += cuda_step.fused_rounds_cuda.launches
        # The same flight again, its host syncs counted by stage, then the reference.
        syncs = {}
        mailbox, again = _fly(mailbox, board, cfg, dev, syncs)
        sol, res = solve_one(board, SUDOKU_9, cfg, device=dev)
        unsat = not v["solved"] and not v["has_work"] and not v["overflowed"]
        if v["has_work"] or v["solved"] != bool(res.solved[0]) or unsat != bool(res.unsat[0]):
            raise AssertionError(f"flight {name}: verdict differs from solve_one's")
        if sol is not None and not np.array_equal(v["solution"], sol):
            raise AssertionError(f"flight {name}: solution differs from solve_one's")
        if v["nodes"] != int(res.nodes[0]) or again["solution"].tolist() != v["solution"].tolist():
            raise AssertionError(f"flight {name}: nodes or a repeated flight differ")
        rows.append(dict(board=name, wall_ms=wall_ms, chunks=v["chunks"], syncs=syncs,
                         nodes=v["nodes"], solved=v["solved"]))
        log(f"[13] flight {name}: {wall_ms:.3f} ms, chunks {v['chunks']}, host syncs "
            f"{sum(syncs.values())} {json.dumps(syncs)}, nodes {v['nodes']}, steps "
            f"{v['steps']}, solved {v['solved']}; equals solve_one")
    if launches <= 0:
        raise AssertionError("the flights launched K2 no time")
    return launches, rows


class _Interrupt(Exception):
    pass


def _interrupt(_state):
    raise _Interrupt


def phase_snapshot(corpus, sizes, dev):
    """A checkpointed solve interrupted after its first chunk and resumed
    from the snapshot on disk, against one never interrupted."""
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
    from distributed_sudoku_solver_tpu_torch.utils.checkpoint import solve_batch_checkpointed

    grids = corpus[: sizes["snapshot_boards"]]
    cfg = SolverConfig(propagator="pallas")
    kw = dict(chunk_steps=sizes["snapshot_chunk"], device=dev)
    t0 = time.perf_counter()
    whole = solve_batch_checkpointed(grids, SUDOKU_9, cfg, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frontier.npz")
        try:
            solve_batch_checkpointed(grids, SUDOKU_9, cfg, checkpoint_path=path,
                                     on_chunk=_interrupt, **kw)
            raise AssertionError("the checkpointed solve finished within its first chunk")
        except _Interrupt:
            pass
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        resumed = solve_batch_checkpointed(grids, SUDOKU_9, cfg, checkpoint_path=path, **kw)
        torch.cuda.synchronize()
        resume_wall = time.perf_counter() - t0
        if os.path.exists(path):
            raise AssertionError("the snapshot was not removed on completion")
    bad = [f for f in whole._fields if not torch.equal(getattr(whole, f), getattr(resumed, f))]
    if bad:
        raise AssertionError(f"the resumed solve differs from the uninterrupted one in {bad}")
    check_solutions(grids, resumed.solution.cpu().numpy(), resumed.solved.cpu().numpy(),
                    resumed.unsat.cpu().numpy(), "snapshot resume")
    log(f"[14] snapshot: {len(grids)} boards, {int(whole.steps)} steps; uninterrupted "
        f"{wall:.3f} s, resumed after step {sizes['snapshot_chunk']} from a {size} byte "
        f"snapshot in {resume_wall:.3f} s; bit-identical on every field")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--breakdown", action="store_true",
                    help="phases 1-3 and K2's and K3's stage breakdowns only (no result line)")
    ap.add_argument("--times", action="store_true",
                    help="phases 1 and 3 and the kernels' device times only (no result line); "
                         "runs against the checkout that holds this copy of the script")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from distributed_sudoku_solver_tpu_torch.ops import cuda_cover, cuda_propagate, cuda_step  # noqa: F401

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    device = phase_device()
    if args.times:
        phase_times(phase_corpus(dict(SIZES, corpus=SIZES["k2_lanes"])), SIZES, dev)
        return 0
    build_s = phase_build()
    if args.breakdown:
        phase_breakdown(phase_corpus(dict(SIZES, corpus=SIZES["k2_lanes"])), SIZES, dev)
        phase_cover_breakdown(cover_frontiers(SIZES, dev), SIZES)
        return 0
    corpus = phase_corpus(SIZES)
    k1 = phase_k1(corpus, SIZES, dev)
    k2 = phase_k2(corpus, SIZES, dev)
    phase_breakdown(corpus, SIZES, dev)
    main_launches = phase_main(corpus, dev)
    phase_profile(corpus, dev)
    comp_launches = phase_composite(corpus, SIZES, dev)
    frontiers = cover_frontiers(SIZES, dev)
    k3_err, k3_rows = phase_k3(frontiers, SIZES, dev)
    phase_cover_breakdown(frontiers, SIZES)
    del frontiers
    cover_launches = phase_cover_main(dev)
    phase_cover_profile(dev)
    phase_cover_composite(SIZES, dev)
    k2_heads = phase_k2_heads(corpus, SIZES, dev)
    head_launches, minrem_nodes = phase_heads_main(corpus, SIZES, dev)
    flight_launches, _ = phase_flight(corpus, minrem_nodes, SIZES, dev)
    head_launches["head:cw-slack"] += flight_launches
    phase_snapshot(corpus, SIZES, dev)
    log(f"[15] elapsed {time.perf_counter() - t_start:.1f} s, of which the build "
        f"{build_s:.1f} s")
    pkg = "distributed_sudoku_solver_tpu_torch/csrc"
    kernels = [
        dict(name="K1 propagate_fixpoint", route="cuda", source=f"{pkg}/propagate.cu",
             replaces="distributed_sudoku_solver_tpu/ops/pallas_propagate.py:441",
             launches=comp_launches["K1"], library_ms=None, **k1),
        dict(name="K2 fused_rounds", route="cuda", source=f"{pkg}/fused_step.cu",
             replaces="distributed_sudoku_solver_tpu/ops/pallas_step.py:510",
             launches=main_launches["K2"], library_ms=None, **k2),
        dict(name="K3 cover_fused_rounds", route="cuda", source=f"{pkg}/cover.cu",
             replaces="distributed_sudoku_solver_tpu/ops/pallas_cover.py:545",
             launches=sum(cover_launches.values()), max_abs_err=k3_err, library_ms=None,
             **k3_rows["pentomino6x10"]),
    ]
    kernels += [dict(name=f"K2 fused_rounds {rule}", route="cuda", source=f"{pkg}/fused_step.cu",
                     replaces="distributed_sudoku_solver_tpu/ops/pallas_step.py:510",
                     launches=head_launches[rule], library_ms=None, **k2_heads[rule])
                for rule in HEAD_RULES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
