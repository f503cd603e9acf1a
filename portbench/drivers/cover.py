"""Exact-cover enumeration: back-to-back ``ops/solve.solve_csp`` counts.

A board is one instance whose exact covers are all counted from its single
root: a pentomino rectangle of the mix's ``rectangles`` (``[height,
width]``), in that order, each with its published count under ``counts``.
Set-up builds each instance through the program (``pentomino_cover``) and
solves it once, which builds or loads K3 and captures the fused loop's
graph of every frontier shape the window uses.  The window then runs
passes back to back until ``seconds`` have passed, a pass being every
board in turn, each one ``solve_csp(root, problem, SolverConfig(**config
["solver_config"]))`` call; ``boards_per_s`` is the boards of the passes it
completed over the time from its start to the end of its last pass.  Each
call's count, verdicts and solution state are read as it ends, in one
fetch, and every board of every pass is judged after the window: its count
against the published one and the reference's, its search exhausted, no
subtree dropped, and its solution an exact cover of the instance's rows.
The reference (``reference/cover.py``) builds every instance itself and
counts it once on the host after the window; its seconds go under
``info``.

With tracing on, the window runs under the profiler and each call keeps
its ``trace={}`` (a program whose ``solve_csp`` takes none runs without).
For K3's roofline one pass of the window is drawn from the seed; after the
window its boards are solved again and ``REPLAYED`` of its K3 dispatches,
evenly spaced over the pass, are replayed from their inputs
(``yardstick/k3_replay.py``), against the device time of the same launches
of the window's pass.
"""

from __future__ import annotations

import contextlib
import inspect
import time

import numpy as np

from portbench.core import log
from portbench.gen import boards as gen
from portbench.reference import cover as ref

# K3 dispatches of the sampled pass replayed for the roofline.
REPLAYED = 24


def _boards(mix: dict) -> list:
    """``(name, program instance, reference incidence, primary columns,
    published count)`` for each board of a pass, in order."""
    from distributed_sudoku_solver_tpu_torch.models.pentomino import pentomino_cover

    made = [(f"pentomino{h}x{w}", pentomino_cover(h, w), *ref.pentomino_incidence(h, w))
            for h, w in mix["rectangles"]]
    counts = list(mix["counts"])
    if len(counts) != len(made):
        raise ValueError(f"{len(made)} boards and {len(counts)} published counts")
    return [(*b, int(c)) for b, c in zip(made, counts)]


def run(cell: dict) -> dict:
    import torch

    from distributed_sudoku_solver_tpu_torch.ops import cuda_cover, cuda_step
    from distributed_sudoku_solver_tpu_torch.ops import solve as solve_mod
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
    from portbench.yardstick import profwindow

    dev = torch.device(cell["device"] or "cuda")
    on_cuda = dev.type == "cuda"
    config = SolverConfig(**cell["config"]["solver_config"])
    boards = _boards(cell["traffic"])
    roots = [torch.from_numpy(np.asarray(p.initial_state())[None]).to(dev)
             for _, p, *_ in boards]

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    def solve(i: int, **kw):
        return solve_mod.solve_csp(roots[i], boards[i][1], config, device=dev, **kw)

    # Warm-up: every board once builds or loads K3 and captures the graph
    # of every frontier shape the window runs.
    for i in range(len(boards)):
        solve(i)
    sync()
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - cell["t_start"]
    log(cell, "set-up done")

    tracing = cell["trace"]
    traced = tracing and "trace" in inspect.signature(solve_mod.solve_csp).parameters
    answers, traces, marks = [], [], []
    board_s = [0.0] * len(boards)
    with contextlib.ExitStack() as stack:
        window = stack.enter_context(profwindow.Window()) if tracing else None
        launches0 = cuda_cover.cover_fused_rounds_cuda.launches
        captures0 = cuda_step._GRAPHS.built
        t0 = time.perf_counter()
        t_end = t0
        k = 0
        while t_end - t0 < cell["seconds"]:
            for i in range(len(boards)):
                tr = {} if traced else None
                res = solve(i, **({"trace": tr} if traced else {}))
                got = torch.cat([res.sol_count[:1], res.unsat[:1].to(torch.int32),
                                 res.overflowed[:1].to(torch.int32), res.solution[0].reshape(-1)])
                answers.append((i, got.cpu().numpy()))
                t = time.perf_counter()
                board_s[i] += t - t_end
                t_end = t
                if traced:
                    traces.append(tr)
            marks.append(cuda_cover.cover_fused_rounds_cuda.launches - launches0)
            k += 1
    window_s = t_end - t0
    captures = cuda_step._GRAPHS.built - captures0
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    log(cell, f"window done, {k} passes")

    t = time.perf_counter()
    ref_counts = [ref.count_exact_covers(inc, n_primary) for _, _, inc, n_primary, _ in boards]
    ref_s = time.perf_counter() - t
    log(cell, f"reference counted {ref_counts} in {ref_s:.3f} s")
    checks = _judge(boards, answers, ref_counts)
    failed = sum(1 for bad in checks.pop("bad") if bad)

    readings = {"cover_traces": traces}
    profile = None
    if tracing:
        profile = profwindow.read(window, [(s["name"], round(s["t0"] * 1e9), round(s["t1"] * 1e9))
                                           for tr in traces for s in tr.get("spans", ())])
        readings["profile"] = profile
        log(cell, f"trace read, {len(profile['device'])} device operations")
        sample = int(gen.rng(cell["seed"], "k3-sample").integers(0, k))
        first = marks[sample - 1] if sample else 0

        def rerun():
            for i in range(len(boards)):
                solve(i)
            sync()

        readings["k3"] = _k3_reading(profile, marks[-1], range(first, marks[sample]), rerun,
                                     cuda_cover)
        log(cell, f"K3 dispatches of pass {sample} replayed: {readings['k3']}")
    boards_done = k * len(boards)
    return {
        "setup_s": setup_s,
        "e2e": {"boards_per_s": boards_done / window_s},
        "attempted": boards_done,
        "failed": failed,
        "checks": [(name, value, 0) for name, value in checks.items()],
        "readings": readings,
        "profile": profile,
        "memory_peak_bytes": int(peak),
        "info": {"passes": k, "window_s": window_s,
                 "board_s": {b[0]: board_s[i] / k for i, b in enumerate(boards)},
                 "k3_launches": marks[-1], "graph_captures": captures,
                 "reference_counts": ref_counts,
                 "reference_s": ref_s},
    }


def _judge(boards: list, answers: list, ref_counts: list) -> dict:
    """The four checks over every answer, and ``bad``, one flag an answer.
    An answer is ``(board index, int32[3 + D])``: the count, the search
    exhausted (``unsat``), a subtree dropped (``overflowed``), then the
    solution state.  A count is wrong unless it equals both the published
    count and the reference's; a solution is invalid unless the instance
    holds the reference's rows and the state's rows cover it exactly."""
    wrong = unexhausted = overflowed = invalid = 0
    bad = []
    inc = [ref.bits(np.asarray(p.incidence).view(np.int32), p.n_cols_full)
           for _, p, *_ in boards]
    same = [ref.same_rows(a, b[2]) for a, b in zip(inc, boards)]
    for i, got in answers:
        name, p, _, n_primary, published = boards[i]
        flags = (int(got[0]) != published or int(got[0]) != ref_counts[i], not got[1], bool(got[2]),
                 not (same[i] and ref.is_exact_cover(inc[i], n_primary,
                                                    ref.chosen_rows(got[3:], p.n_rows))))
        wrong, unexhausted, overflowed, invalid = (
            a + int(f) for a, f in zip((wrong, unexhausted, overflowed, invalid), flags))
        bad.append(any(flags))
    return {"wrong_counts": wrong, "unexhausted_boards": unexhausted,
            "overflowed_boards": overflowed, "invalid_solutions": invalid, "bad": bad}


def _k3_reading(profile: dict, launches: int, in_pass: range, rerun, cuda_cover) -> dict:
    """K3's device time and bound over ``REPLAYED`` dispatches of one pass
    of the window, evenly spaced from its first to its last (all of them in
    a pass with no more).  The device times are those of the window's
    launches ``in_pass``, from a window that recorded every one of its
    ``launches``.  The bounds come from ``rerun()``, which solves the pass's
    boards again after the window: each picked K3 dispatch of the rerun is
    replayed in plain torch from its inputs just before it runs.  The
    enumeration is deterministic, so the rerun dispatches what the window's
    pass did.  A rerun with another number of dispatches, or a lost record,
    raises: the traced run then fails rather than drop the metric."""
    from portbench.yardstick import k3_replay, profwindow

    durations = profwindow.strict_durations(profile["device"], "cover_kernel", launches)
    if durations is None:
        raise RuntimeError(f"the traced window lost K3 records: {launches} launches counted")
    count = len(in_pass)
    picks = sorted({round(j * (count - 1) / max(REPLAYED - 1, 1)) for j in range(REPLAYED)}
                   if count > REPLAYED else range(count))
    bound_ms, by, seen, instances = [], set(), [0], {}
    orig = cuda_cover.cover_fused_rounds

    def replayed(top, stack, has_top, base, count_, problem, **kw):
        if seen[0] in picks:
            inst = instances.get(id(problem))
            if inst is None:
                inst = instances[id(problem)] = k3_replay.Instance(problem, top.device)
            _, work = k3_replay.rounds(top, stack, has_top, base, count_, inst, **kw)
            ms, what = k3_replay.bound(inst, work)
            bound_ms.append(ms)
            by.add(what)
        seen[0] += 1
        return orig(top, stack, has_top, base, count_, problem, **kw)

    before = cuda_cover.cover_fused_rounds_cuda.launches
    cuda_cover.cover_fused_rounds = replayed
    try:
        rerun()
    finally:
        cuda_cover.cover_fused_rounds = orig
    rerun_launches = cuda_cover.cover_fused_rounds_cuda.launches - before
    if not (seen[0] == rerun_launches == count) or len(bound_ms) != len(picks):
        raise RuntimeError(f"the rerun of the sampled pass dispatched K3 {seen[0]} times "
                           f"({rerun_launches} launches), the window's pass {count}")
    device_ms = sum(durations[in_pass[j]] for j in picks) / 1e6
    return {"launches": launches, "dispatches": count, "replayed": len(picks),
            "device_ms": device_ms, "bound_ms": sum(bound_ms), "bound_by": sorted(by)}
