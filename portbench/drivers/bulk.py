"""File solving: back-to-back ``ops/bulk.solve_bulk`` passes.

Set-up draws a pool of ``batches`` batches of ``batch`` boards from the
mix's ``corpus`` (puzzles with a unique solution, each under a fresh
symmetry transform; ``gen/boards.py``) and solves one pass on the first, which builds or loads every
kernel library and sizes the allocator.  The window then solves the pool's
batches in turn, each as one ``solve_bulk(grids, geom, BulkConfig())``
call, until ``seconds`` have passed; ``boards_per_s`` is every board of the
passes it completed over the time from its start to the end of its last
pass.  Each pass's verdicts are counted as it ends, and the answers of
``JUDGED_PASSES`` passes, a uniform sample drawn from the seed as the passes
come, are kept and judged in full after the window: the window holds no
more than those passes' answers.

With tracing on, the window runs under the profiler with host ranges around
each pass's pack, chunk solves and drains, and the program's own ``trace=``
stage clocks are kept per pass.  For K2's roofline one pass of the window
is drawn from the seed; after the window its batch is solved again and
``REPLAYED`` of its K2 dispatches, evenly spaced over the pass, are
replayed from their inputs (``yardstick/k2_replay.py``), against the device
time of the same launches of the window's pass.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from portbench.core import log
from portbench.gen import boards as gen
from portbench.reference.sudoku import right_answers

# Passes whose every solution is judged; the rest have their verdicts
# counted (an unsatisfiable or unknown board is a failure in any pass).
JUDGED_PASSES = 8
# K2 dispatches of the sampled pass replayed for the roofline: a 16x16 pass
# of unique boards dispatches K2 hundreds of times, most of them in the rungs.
REPLAYED = 24


def _ranges(bulk_mod, wire_mod, ranges):
    """Wrap the pass's calls into the wire and solve layers in host ranges;
    returns the undo."""
    saved = {
        (wire_mod, "pack_grids_for"): "bulk.pack",
        (wire_mod, "unpack_result_for"): "bulk.drain",
        (bulk_mod, "solve_batch_wire"): "bulk.solve",
    }
    originals = {key: getattr(*key) for key in saved}
    for (mod, attr), label in saved.items():
        setattr(mod, attr, ranges.wrap(originals[mod, attr], label))

    def undo():
        for (mod, attr), fn in originals.items():
            setattr(mod, attr, fn)
    return undo


class _Reservoir:
    """A uniform sample of ``k`` of the passes seen so far, drawn from the
    seed as they come (Algorithm R), so the window keeps only ``k`` passes'
    answers whatever its length."""

    def __init__(self, k: int, g: np.random.Generator):
        self.k, self.g, self.seen, self.kept = k, g, 0, []

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.kept.append(item)
        else:
            j = int(self.g.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = item
        self.seen += 1


def run(cell: dict) -> dict:
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
    from distributed_sudoku_solver_tpu_torch.ops import bulk as bulk_mod
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step
    from distributed_sudoku_solver_tpu_torch.ops import wire as wire_mod
    from portbench.yardstick import profwindow

    cfg, mix = cell["config"], cell["traffic"]
    bh, bw = cfg["box_h"], cfg["box_w"]
    geom = Geometry(bh, bw)
    dev = cell["device"]
    on_cuda = torch.device(dev or "cuda").type == "cuda"
    config = bulk_mod.BulkConfig(**cfg.get("bulk_config", {}))
    batch, n_batches = int(mix["batch"]), int(mix["batches"])
    pool = [gen.draw(cell["seed"], f"bulk{i}", batch, mix["corpus"])[0].astype(np.int32)
            for i in range(n_batches)]

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    # Warm-up: one pass on the first batch builds or loads every library and
    # runs every shape the window runs (chunks, rungs).
    bulk_mod.solve_bulk(pool[0], geom, config, device=dev)
    sync()
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - cell["t_start"]
    log(cell, "set-up done")

    # Every pass's verdicts are counted as it ends; the answers of
    # JUDGED_PASSES passes drawn from the seed are kept and judged in full
    # after the window.
    hook = cell.get("answers")
    judged = _Reservoir(JUDGED_PASSES, gen.rng(cell["seed"], "judge"))
    unsat = unsolved = 0
    tracing = cell["trace"]
    traces, marks = [], []
    with contextlib.ExitStack() as stack:
        ranges = profwindow.Ranges()
        window = None
        if tracing:
            stack.callback(_ranges(bulk_mod, wire_mod, ranges))
            window = stack.enter_context(profwindow.Window())
        launches0 = cuda_step.fused_rounds_cuda.launches
        t0 = time.perf_counter()
        t_end = t0
        k = 0
        while t_end - t0 < cell["seconds"]:
            i = k % n_batches
            tr = {} if tracing else None
            res = bulk_mod.solve_bulk(pool[i], geom, config, trace=tr, device=dev)
            t_end = time.perf_counter()
            answer = (res.solution, res.solved, res.unsat)
            if hook is not None:
                answer = hook(pool[i], *answer)
            unsat += int(answer[2].sum())
            unsolved += int((~answer[1] & ~answer[2]).sum())
            judged.offer((i, answer))
            marks.append(cuda_step.fused_rounds_cuda.launches - launches0)
            if tracing:
                traces.append(tr)
            k += 1
    window_s = t_end - t0
    boards = batch * k
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    log(cell, f"window done, {k} passes")

    wrong = unsat
    for i, (solution, solved, _) in judged.kept:
        wrong += int((~right_answers(pool[i][solved], solution[solved], bh, bw)).sum())
    judged.kept.clear()
    log(cell, "answers judged")

    readings = {"bulk_traces": traces, "boards": [batch] * len(traces)}
    profile = None
    if tracing:
        profile = profwindow.read(window, ranges.spans)
        readings["profile"] = profile
        log(cell, f"trace read, {len(profile['device'])} device operations")
        sample = int(gen.rng(cell["seed"], "k2-sample").integers(0, k))
        first = marks[sample - 1] if sample else 0
        readings["k2"] = _k2_reading(
            profile, marks[-1], range(first, marks[sample]),
            lambda: bulk_mod.solve_bulk(pool[sample % n_batches], geom, config, device=dev),
            cuda_step, bh, bw)
        log(cell, f"K2 dispatches of pass {sample} replayed: {readings['k2']}")
    return {
        "setup_s": setup_s,
        "e2e": {"boards_per_s": boards / window_s},
        "attempted": boards,
        "failed": wrong + unsolved,
        "checks": [("wrong_answers", wrong, 0), ("unsolved_boards", unsolved, 0)],
        "readings": readings,
        "profile": profile,
        "memory_peak_bytes": int(peak),
        "info": {"passes": k, "window_s": window_s, "k2_launches": marks[-1] if marks else 0},
    }


def _k2_reading(profile: dict, launches: int, in_pass: range, rerun, cuda_step,
                bh: int, bw: int) -> dict:
    """K2's device time and bound over ``REPLAYED`` dispatches of one pass
    of the window, evenly spaced from its first to its last (all of them in
    a pass with no more).  The device times are those of the window's
    launches ``in_pass``, from a window that recorded every one of its
    ``launches``.  The bounds come from ``rerun()``, which solves the pass's
    batch again after the window: each picked K2 dispatch of the rerun is
    replayed in plain torch from its inputs just before it runs.  The
    program is deterministic, so the rerun dispatches what the window's pass
    did.  A rerun with another number of dispatches, a lost record, or a
    dispatch that the replay cannot follow raises: the traced run then fails
    rather than drop the metric."""
    from portbench.yardstick import k2_replay, profwindow

    durations = profwindow.strict_durations(profile["device"], "fused_kernel", launches)
    if durations is None:
        raise RuntimeError(f"the traced window lost K2 records: {launches} launches counted")
    count = len(in_pass)
    picks = sorted({round(j * (count - 1) / max(REPLAYED - 1, 1)) for j in range(REPLAYED)}
                   if count > REPLAYED else range(count))
    g = k2_replay.Geo(bh, bw)
    bound_ms, by, seen = [], set(), [0]
    orig = cuda_step.fused_rounds

    def replayed(*args, **kw):
        if seen[0] in picks:
            rep = k2_replay.replay(*args[:5], g, **kw)
            ms, what = k2_replay.bound(rep, g, kw.get("rules", "extended"))
            bound_ms.append(ms)
            by.add(what)
        seen[0] += 1
        return orig(*args, **kw)

    before = cuda_step.fused_rounds_cuda.launches
    cuda_step.fused_rounds = replayed
    try:
        rerun()
    finally:
        cuda_step.fused_rounds = orig
    rerun_launches = cuda_step.fused_rounds_cuda.launches - before
    if not (seen[0] == rerun_launches == count) or len(bound_ms) != len(picks):
        raise RuntimeError(f"the rerun of the sampled pass dispatched K2 {seen[0]} times "
                           f"({rerun_launches} launches), the window's pass {count}")
    device_ms = sum(durations[in_pass[j]] for j in picks) / 1e6
    return {"launches": launches, "dispatches": count, "replayed": len(picks),
            "device_ms": device_ms, "bound_ms": sum(bound_ms), "bound_by": sorted(by)}
