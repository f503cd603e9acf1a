"""Portfolio racing: R solver configs per job, first verdict wins.

Port of the JAX package's ``serving/portfolio.py``.  A job races
heterogeneous strategies (branch heuristics, digit order, step engine) as
concurrent flights on one engine; the engine's round-robin chunk loop is
the scheduler, and the first racer to reach a *verdict* (solved or proven
unsat: every config is sound, so any verdict is final) cancels the rest,
the reference node's SOLUTION_FOUND purge between racers instead of
between peers.  :func:`race_native` races the native C++ DFS against a
delayed device fallback (the front door's easy tier); :func:`race_cover`
races exact-cover enumeration on the device against the native DFS.

Device seams against the JAX package: the engine-based races run on the
engine's device; :func:`race_cover` takes ``device=None`` (CUDA, raising
without it, unless ``device="cpu"`` is passed) and its device entrant
drives the port's composite ``ops.frontier.run_frontier`` there.  A racer
whose kernel fails (``ops.cuda_build.KernelError``) fails its job, as any
engine job does; no other entrant answers in its name.

DFS order is a classic heavy-tailed lottery: a unique solution living in
high digits is reached orders of magnitude faster descending than
ascending.  min-over-configs of a heavy-tailed cost beats every fixed
config over a board family.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Optional, Sequence

import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.obs import lockdep
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.ops.solve import resolve_device
from distributed_sudoku_solver_tpu_torch.serving.engine import Job, SolverEngine

#: The default portfolio (the JAX package's): the two digit orders hedge
#: each other's worst case; the reference-order racer adds cell-choice
#: diversity; the fused racer adds a step-engine axis, K2 on the card,
#: while the composite racers keep exact per-round purge/steal reactivity.
#: Where K2 cannot serve the racer's shape, the engine downgrades its
#: flight to the composite step at launch (``SolverEngine._fit_fused``,
#: counted as ``fused_downgrades`` on ``/metrics``) and it races on as a
#: fourth composite entrant.
DEFAULT_PORTFOLIO: tuple[SolverConfig, ...] = (
    SolverConfig(branch="minrem"),
    SolverConfig(branch="minrem-desc"),
    SolverConfig(branch="first"),
    SolverConfig(branch="minrem", step_impl="fused", fused_steps=4, stack_slots=32),
)


@dataclasses.dataclass
class PortfolioResult:
    winner: Optional[Job]  # first racer with a verdict; None if none got one
    winner_index: int  # index into `configs` (-1 if no winner)
    jobs: list  # every racer's Job, same order as `configs`
    duration_s: float
    # With winner=None these disambiguate: timed_out=True means the deadline
    # expired with racers still running (retryable); False means every racer
    # resolved without a verdict (permanent budget/overflow failure).
    timed_out: bool = False
    strategy: Optional[str] = None  # winning config's branch rule


def race_jobs(
    jobs: list,
    cancel,
    timeout: Optional[float] = None,
    start: Optional[float] = None,
    clock: Callable[[], float] = time.monotonic,
) -> PortfolioResult:
    """First-verdict-wins over already-submitted racer jobs.

    ``cancel(uuid)`` is called for every loser still running — on an engine
    that is :meth:`SolverEngine.cancel` (mid-flight purge within one chunk),
    on a cluster node it is :meth:`ClusterNode.cancel` (local purge + CANCEL
    to the executing member, which also fans out to any shed parts).

    Short-interval poll over the racers' events: verdicts arrive at chunk
    granularity (>= ms), so a 10 ms poll adds no meaningful latency and no
    per-race thread churn.  The poll pace is a bounded Event.wait yield,
    never ``time.sleep``; ``clock``
    (injected; default = real monotonic, bound at import) times the
    deadline and the result, and ``start`` — when the caller began
    submitting — must be a reading of the SAME clock.
    """
    start = clock() if start is None else start
    deadline = None if timeout is None else start + timeout
    winner, winner_index = None, -1
    timed_out = False
    pacer = threading.Event()  # never set: wait() is a bounded real yield
    while winner is None:
        if deadline is not None and clock() >= deadline:
            timed_out = True
            break
        for i, job in enumerate(jobs):
            if job.done.is_set() and (job.solved or job.unsat):
                winner, winner_index = job, i
                break
        if winner is None:
            if all(j.done.is_set() for j in jobs):
                break  # every racer resolved without a verdict (budget/overflow)
            pacer.wait(0.01)
    for job in jobs:
        if job is not winner and not job.done.is_set():
            cancel(job.uuid)
    return PortfolioResult(
        winner=winner,
        winner_index=winner_index,
        jobs=jobs,
        duration_s=clock() - start,
        timed_out=timed_out,
    )


_LOG = logging.getLogger(__name__)


def race_native(
    engine: SolverEngine,
    job: Job,
    head_start_s: float = 0.5,
    on_verdict: Optional[Callable[[Job], None]] = None,
    device_fallback: bool = True,
) -> Job:
    """Race the native C++ DFS against a *delayed* device fallback on one
    pre-built job — the find-one twin of :func:`race_cover`, and the seam
    the front door's easy tier routes through (``serving/frontdoor``).

    First verdict wins, same contract as :func:`race_jobs`:

    * **native**: ``native.solve`` on a daemon thread — the measured
      winner on easy boards, where the device path's dispatch floor
      dwarfs the search itself.  A native *decline* (no compiler,
      malformed grid) releases the fallback immediately.  Like the cover
      race, a losing native entrant cannot be interrupted mid-recursion:
      it finishes in the background and its verdict is discarded.
    * **device fallback**: waits ``head_start_s`` (or the native
      entrant's settle, whichever first), then submits the board to the
      engine as a *shadow* job (accounting-invisible — the race's hook
      counts the one user request exactly once whichever entrant wins)
      under the SAME uuid — so a caller-side ``engine.cancel(job.uuid)``
      (the HTTP timeout path) reaches the fallback flight — bypassing
      the front door (``frontdoor=False``: the race IS the front door's
      native tier; re-entering it would loop) and inheriting the outer
      job's absolute deadline.  A native win mid-flight cancels the
      fallback; a fallback resolution (including a cancellation or an
      expired deadline) resolves the job if the native entrant has not
      already.

    ``on_verdict`` (the front door's accounting + cache-fill hook) runs
    on the winning entrant's thread for EVERY resolution, with the
    verdict fields set, BEFORE the job's done event — a waiter that
    resubmits the moment it wakes sees the cache already filled.
    ``job.route`` tells it which entrant won ('native' or 'device').  No
    clock reads here: the deadline/latency math belongs to the caller,
    and the head start is a bounded ``Event.wait`` yield.

    ``device_fallback=False`` (brownout stage 1, ``serving/brownout.py``)
    runs the race **native-only**: the device shadow is never submitted,
    reclaiming its device lanes for the hard tail.  A backstop thread
    still settles the job if the native entrant declines or dies (a
    500-able error — rare by construction, since the front door only
    suppresses the fallback when ``native.available()`` held at boot).
    """
    # The settle lock guards ONLY the winner claim: the claiming thread
    # then fills the job, runs the verdict hook, and sets the done event
    # lock-free (single writer; the event's set is the release barrier),
    # so no other lock is ever acquired under it — it stays a leaf in the
    # deadck hierarchy whatever the hook touches.
    settle = lockdep.named_lock("frontdoor.race")  # lockck: name(frontdoor.race)
    claimed = [False]
    native_settled = threading.Event()
    device_submitted = threading.Event()

    def _finish(route, solved=False, solution=None, unsat=False, nodes=0,
                error=None, cancelled=False) -> bool:
        import numpy as np

        with settle:
            if claimed[0]:
                return False
            claimed[0] = True
        job.route = route
        job.solved = bool(solved)
        job.unsat = bool(unsat)
        # unsat here is always a COMPLETE proof (the native DFS ran its
        # space dry, or the device fallback's own exhaustion): mirror it
        # on `exhausted`, the field cluster finalization actually reads.
        job.exhausted = bool(unsat)
        job.cancelled = bool(cancelled)
        job.solution = (
            None if solution is None
            else np.asarray(solution, np.int32)  # the native DFS's host array
        )
        job.nodes = int(nodes)
        job.error = error
        if on_verdict is not None:
            # EVERY resolution fires the hook — the fallback runs as an
            # accounting-invisible shadow job, so this call is the one
            # place the request gets counted (the hook's cache fill
            # guards cancels/errors itself).
            try:
                on_verdict(job)
            except Exception:  # noqa: BLE001 - cache fill must not kill the race
                _LOG.exception(
                    "[portfolio] race_native verdict hook failed (%s)",
                    job.uuid,
                )
        job.done.set()
        return True

    def native_entrant() -> None:
        won = False
        try:
            try:
                from distributed_sudoku_solver_tpu_torch import native

                if not native.available():
                    return  # decline: the fallback covers it
                sol, nodes = native.solve(job.grid, job.geom)
            except Exception:  # noqa: BLE001 - any native failure is a decline
                return
            won = _finish(
                "native", solved=sol is not None, solution=sol,
                unsat=sol is None, nodes=nodes,
            )
        finally:
            native_settled.set()
        if won and device_submitted.is_set():
            engine.cancel(job.uuid)  # release the fallback flight

    def device_entrant() -> None:
        native_settled.wait(head_start_s)
        if job.done.is_set():
            return  # native already answered inside its head start
        try:
            # shadow=True: the fallback is accounting-invisible in the
            # engine (the race's verdict hook counts the ONE request);
            # sharing the outer uuid lets caller-side cancels reach it.
            inner = engine.submit(
                job.grid, geom=job.geom, job_uuid=job.uuid,
                frontdoor=False, shadow=True,
            )
        except Exception as e:  # noqa: BLE001 - engine stopped/rejecting
            native_settled.wait()  # the native entrant always settles
            if not job.done.is_set():
                _finish("device", error=f"device fallback unavailable: {e}")
            return
        # The caller's wall-clock budget survives the hop: the fallback
        # inherits the outer job's absolute deadline (chunk-granularity
        # enforcement reads it per pass, so setting it post-submit is at
        # worst one chunk late — the documented reaction lag).  The
        # native entrant itself is uninterruptible; an expired fallback
        # resolving "deadline expired" is what bounds the caller's wait.
        if job.deadline is not None:
            inner.deadline = job.deadline
        device_submitted.set()
        if job.done.is_set():
            engine.cancel(job.uuid)  # native won during our submit window
        inner.done.wait()
        _finish(
            "device", solved=inner.solved, solution=inner.solution,
            unsat=inner.unsat, nodes=inner.nodes, error=inner.error,
            cancelled=inner.cancelled,
        )

    def backstop() -> None:
        # Native-only mode: no device shadow exists, so a native decline
        # (native_entrant returning without claiming) must still resolve
        # the job — an unresolved done event would hang its waiter.
        native_settled.wait()
        if not job.done.is_set():
            _finish(
                "native",
                error="native engine declined (device fallback suppressed "
                "by brownout stage 1)",
            )

    threading.Thread(
        target=native_entrant, daemon=True, name="frontdoor-native"
    ).start()
    threading.Thread(
        target=device_entrant if device_fallback else backstop,
        daemon=True, name="frontdoor-native-fallback",
    ).start()
    return job


#: Include the native C++ DFS as a cover-race entrant only below this row
#: count (the JAX package's gate): the native MRV DFS wins small trees,
#: where a device dispatch's floor dominates; every shipped small instance
#: sits far below 4,096 rows (n-queens 12: 144), while the racer costs one
#: daemon thread when it loses.
NATIVE_COVER_MAX_ROWS = 4096


@dataclasses.dataclass
class CoverRaceResult:
    count: int  # exact model count from the winning engine
    winner: str  # 'native' | 'device'
    nodes: int  # winner's expanded nodes
    duration_s: float
    complete: bool  # enumeration ran to exhaustion (False: budget/overflow)


def race_cover(
    problem,
    config: Optional[SolverConfig] = None,
    timeout: Optional[float] = None,
    dispatch_steps: int = 256,
    native_head_start_s: float = 2.0,
    provisional_grace_s: float = 60.0,
    clock: Callable[[], float] = time.monotonic,
    device=None,
) -> CoverRaceResult:
    """Race exact-cover enumeration: device frontier vs the native C++ DFS.

    Both entrants count the IDENTICAL packed matrix, so any completed count
    is final — first finisher wins, same first-verdict-wins contract as
    :func:`race`:

    * **native** (small instances only, ``NATIVE_COVER_MAX_ROWS``): the
      recursive MRV DFS in ``native/src/solver.cc`` on a daemon thread.
      It cannot be interrupted mid-recursion, so a losing native entrant
      finishes in the background and is discarded.  The row gate is a
      heuristic, not a tree-size bound — an adversarial few-row instance
      with a huge tree leaves the daemon burning a core until process
      exit; serving callers therefore pass ``timeout``, which bounds THEIR
      wait unconditionally (the orphan thread is the accepted cost of an
      uninterruptible C recursion).
    * **device**: step-bounded enumeration dispatches of the composite
      ``run_frontier`` on ``device`` (``None``: CUDA, raising without it)
      that poll the race between dispatches, so a native win releases the
      device within one ``dispatch_steps`` chunk.

    Returns the first COMPLETE count.  A device result whose enumeration
    was cut short (step budget / stack overflow: ``complete=False``, the
    count is a lower bound) does not end the race while the native
    entrant is still running — it is held as the provisional answer and
    returned only if nothing better arrives.  With ``timeout=None`` the
    wait for that better answer is still bounded by
    ``provisional_grace_s`` once a provisional is in hand (the native
    entrant is uninterruptible, and "hold a finished lower bound hostage
    to a DFS that may run for days" is not a behavior any caller wants).
    Raises TimeoutError if no engine produced anything inside ``timeout``.
    """
    import queue as queue_mod

    dev = resolve_device(device)
    cfg = config or SolverConfig(
        min_lanes=256, stack_slots=64, count_all=True
    )
    if not cfg.count_all:
        cfg = dataclasses.replace(cfg, count_all=True)
    # Every entrant posts exactly once — a CoverRaceResult on a win, None
    # on any decline/failure path — so the consumer below can distinguish
    # "still racing" from "every entrant is out" and never blocks forever
    # on a silent double failure.
    results: "queue_mod.Queue[Optional[CoverRaceResult]]" = queue_mod.Queue()
    start = clock()
    done = threading.Event()  # a WINNING result exists
    native_settled = threading.Event()  # the native entrant is out of the
    #   race, win or decline — releases the device head-start early
    native_racer = problem.n_rows <= NATIVE_COVER_MAX_ROWS

    def native_entrant() -> None:
        try:
            try:
                from distributed_sudoku_solver_tpu_torch import native

                if not native.available():
                    results.put(None)  # no compiler: device covers it
                    return
                count, nodes = native.cover_count(problem)
            except Exception:
                results.put(None)  # malformed/compile failure: ditto
                return
            done.set()
            results.put(
                CoverRaceResult(
                    count=count, winner="native", nodes=nodes,
                    duration_s=clock() - start, complete=True,
                )
            )
        finally:
            native_settled.set()

    def device_entrant() -> None:
        # Where a native racer runs, give it a short head start before
        # paying the device path's set-up: on instances the DFS wins it
        # returns well inside this window and the device is never touched.
        # A native DECLINE (no compiler) releases the wait immediately via
        # native_settled.
        if native_racer:
            native_settled.wait(native_head_start_s)
            if done.is_set():
                results.put(None)  # native already won; never compile
                return
        try:
            from distributed_sudoku_solver_tpu_torch.ops.frontier import (
                frontier_live,
                init_frontier,
                run_frontier,
            )
            from distributed_sudoku_solver_tpu_torch.ops.solve import (
                _as_tensor,
                finalize_frontier,
            )

            state = init_frontier(_as_tensor(problem.initial_state()[None], dev), cfg)
            limit = 0
            while limit < cfg.max_steps and not done.is_set():
                limit = min(limit + dispatch_steps, cfg.max_steps)
                state = run_frontier(state, problem, cfg, step_limit=limit)
                # The between-dispatch liveness poll: one host read per chunk.
                if not bool(frontier_live(state).any()):
                    break
            if done.is_set():
                results.put(None)  # lost the race; release the device
                return
            res = finalize_frontier(state)
            count, unsat, nodes = (int(x) for x in torch.stack(
                (res.sol_count[0], res.unsat[0].to(torch.int32), res.nodes[0])).cpu())
            complete = bool(unsat)
            if complete:
                # Only a COMPLETE count ends the race: an exhausted step
                # budget or overflow yields a lower bound, and a live
                # native entrant may still deliver the exact count.
                done.set()
            results.put(
                CoverRaceResult(
                    count=count,
                    winner="device",
                    nodes=nodes,
                    duration_s=clock() - start,
                    complete=complete,
                )
            )
        except Exception:
            _LOG.exception("[portfolio] cover race device entrant failed")
            results.put(None)  # out of the race; consumer accounts for it

    threads = [threading.Thread(target=device_entrant, daemon=True)]
    if native_racer:
        threads.append(threading.Thread(target=native_entrant, daemon=True))
    for t in threads:
        t.start()
    deadline = None if timeout is None else start + timeout
    pending = len(threads)
    provisional: Optional[CoverRaceResult] = None  # incomplete device count
    while pending:
        remaining = (
            None if deadline is None
            else max(0.0, deadline - clock())
        )
        if remaining is None and provisional is not None:
            # No overall deadline, but a usable lower bound is in hand:
            # bound the wait for a strictly better answer (see docstring).
            remaining = provisional_grace_s
        try:
            res = results.get(timeout=remaining)
        except queue_mod.Empty:
            done.set()  # stop the survivors at their next poll
            if provisional is not None:
                return provisional  # a lower bound beats a timeout error
            raise TimeoutError(
                f"cover race finished no engine within {timeout}s"
            ) from None
        pending -= 1
        if res is not None and res.complete:
            return res
        if res is not None:
            provisional = res  # hold: a live entrant may still do better
    if provisional is not None:
        return provisional
    raise RuntimeError(
        "every cover-race entrant failed (native unavailable or declined, "
        "and the device enumeration raised)"
    )


def race(
    engine: SolverEngine,
    grid,
    configs: Sequence[SolverConfig] = DEFAULT_PORTFOLIO,
    geom: Optional[Geometry] = None,
    timeout: Optional[float] = None,
    clock: Callable[[], float] = time.monotonic,
) -> PortfolioResult:
    """Race ``configs`` on one board; cancel the losers on the first verdict.

    Every racer is an ordinary engine job with a per-job config override, so
    races interleave with regular traffic and inherit mid-flight
    cancellation: losers release the device within one chunk.
    """
    if not configs:
        raise ValueError("portfolio needs at least one config")
    start = clock()
    jobs = []
    try:
        for cfg in configs:
            jobs.append(engine.submit(grid, geom=geom, config=cfg, job_uuid=None))
    except BaseException:
        # A mid-list rejection (e.g. a config the engine refuses) must not
        # strand the already-submitted racers searching with no waiter.
        for j in jobs:
            engine.cancel(j.uuid)
        raise
    res = race_jobs(jobs, cancel=engine.cancel, timeout=timeout, start=start, clock=clock)
    if res.winner is not None:
        res.strategy = configs[res.winner_index].branch
    return res
