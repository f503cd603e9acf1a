"""Deterministic in-memory cluster plane: the wire contract without sockets.

``serving/faults.py`` gives the *device/serving* layer a deterministic,
sleep-free fault plane; this module is the same discipline one
layer up, at the cluster/network seam.  A :class:`SimNet` is a virtual
network + virtual clock that a :class:`ClusterNode` plugs into through the
transport/clock seam (``cluster/wire.py`` module note): nodes exchange the
same JSON frames with the same ``WireError`` surface, heartbeat loops
sleep on *virtual* time, and every hard distributed failure mode is a
programmable, seeded event instead of a wall-clock accident:

* **drop** — the frame is lost after the connect succeeded: the sender
  gets a ``WireError`` with ``ambiguous_delivery=True`` (exactly the TCP
  flavor where bytes were written before the reset), so its retry is
  honest at-least-once re-dispatch and the receiver's dedupe is what is
  actually under test;
* **dup** — the frame is delivered twice (the redelivery the sender never
  learns about);
* **delay** — delivery is deferred by a bounded, deterministically drawn
  virtual delay, i.e. reordering against later traffic on any link;
* **partitions** — one-way or symmetric: a blocked link refuses the
  connect (``ambiguous_delivery=False``), the way a partitioned TCP
  connect times out with no bytes written.

Per-link faults are driven by the existing seeded schedule machinery
(``serving/faults.FaultSchedule``) over *method-scoped link sites* —
``"link:<src>-><dst>:<METHOD>"`` with a per-site event index — so a unit
test can pin "drop the first SOLUTION from b to a" exactly
(:meth:`FaultSchedule.at`) and a chaos soak can Bernoulli-sample every
link event from one seed (:meth:`FaultSchedule.seeded`), independent of
thread interleaving on other sites.

Time is virtual: nothing in this module calls ``time.sleep``, and no test
driving it needs to.  ``advance(dt)`` moves the clock, wakes sleepers
(heartbeat loops), fires due deliveries, and waits — bounded, on real
condition variables — for the woken threads to take their scheduling
slice, so ``wait_until(net, pred)`` loops are fast and deterministic
where the socket lane's ``wait_for`` loops are wall-clock-bound and
fragile under CI load.  The ``simnet`` pytest marker's conftest guard
enforces the contract: a simnet-marked test that opens a real socket or
calls ``time.sleep`` fails.
"""

from __future__ import annotations

import heapq
import json
import logging
import random
import threading
import time as _time  # real time ONLY for bounded settling waits, never slept on
import zlib
from collections import deque
from typing import Callable, Iterable, Optional, Union

from distributed_sudoku_solver_tpu_torch.cluster.wire import (
    MAX_FRAME,
    Addr,
    WireError,
    addr_str,
)
from distributed_sudoku_solver_tpu_torch.obs import lockdep
from distributed_sudoku_solver_tpu_torch.serving.faults import FaultSchedule

_LOG = logging.getLogger(__name__)

# Safety cap for threads blocked on virtual time (sleepers, request
# waiters): a test that forgets to advance the clock re-checks here
# instead of hanging its daemon threads forever.
_REAL_WAIT_CAP_S = 60.0

# A woken sleeper that has not re-slept within this many REAL seconds has
# exited its loop (node stopped) — settle() stops waiting for it.  A live
# beat's work is sub-millisecond; the grace only delays settle() once per
# killed node.
_BETWEEN_GRACE_S = 0.25

# Delivery worker pool size.  Deliveries used to spawn one ephemeral
# thread each, which is fine for a 5-node ring and catastrophic for a
# 500-node soak (every advance() step forked hundreds of threads and the
# interpreter spent its time in thread setup/teardown, not handlers).  A
# small pool of persistent daemon workers drains the same queue with the
# same semantics.  The pool is safe because of a contract the repo's
# handlers already obey: a wire handler NEVER blocks on virtual time (it
# computes a reply and returns; slow work — solving, result send retries
# — happens on node/engine threads).  A handler that virtually slept
# would have broken settle() under the old design too (its delivery
# counted in ``_active`` until return).
_POOL_WORKERS = 16

_AddrLike = Union[Addr, str]

# Captured at import on purpose: the simnet purity guard
# (tests/conftest.py, banned list from analysis/manifest.py) monkeypatches
# ``time.monotonic`` itself during simnet-marked tests — a runtime-banned
# module attribute — so the bounded REAL settling waits below must hold
# the function object, not re-resolve it per call.  Never slept on.
_monotonic = _time.monotonic


def _addr_s(a: _AddrLike) -> str:
    return addr_str(a) if isinstance(a, tuple) else a


class SimClock:
    """Virtual monotonic clock over a SimNet (the node's ``clock`` seam):
    ``sleep`` blocks the calling thread until ``advance`` moves virtual
    time past the deadline — no wall-clock involvement."""

    def __init__(self, net: "SimNet"):
        self._net = net

    def now(self) -> float:
        return self._net.now()

    def sleep(self, dt: float) -> None:
        self._net.sleep(dt)


class _Reply:
    """One request's reply slot; completed by the delivery thread."""

    def __init__(self, net: "SimNet"):
        self._net = net
        self.done = False
        self.result: Optional[dict] = None
        self.error: Optional[WireError] = None

    def complete(self, result: Optional[dict], error: Optional[WireError]) -> None:
        with self._net._cond:
            if self.done:
                return  # dup fault: first delivery's reply wins
            self.done = True
            self.result = result
            self.error = error
            self._net._cond.notify_all()


class SimTransport:
    """Per-node facade implementing the wire transport contract."""

    def __init__(self, net: "SimNet"):
        self._net = net
        self._addr_s: Optional[str] = None

    def bind(self, host: str, port: int) -> Addr:
        addr = self._net._bind(host, port)
        self._addr_s = addr_str(addr)
        return addr

    def serve(self, handler, on_error=None, io_timeout: float = 5.0) -> None:
        self._net._serve(self._addr_s, handler, on_error)

    def close(self) -> None:
        if self._addr_s is not None:
            self._net._unbind(self._addr_s)

    def send(self, addr: _AddrLike, msg: dict, timeout: float) -> None:
        self._net._route(self._addr_s or "client:0", addr, msg)

    def request(self, addr: _AddrLike, msg: dict, timeout: float) -> dict:
        return self._net._request(self._addr_s or "client:0", addr, msg, timeout)


class SimNet:
    """The virtual network: address space, links, faults, and the clock.

    ``schedule`` maps ``(link site, event index) -> fault kind`` for kinds
    ``drop`` / ``dup`` / ``delay`` (``serving/faults.FAULT_KINDS``); it can
    be installed late (:meth:`set_schedule`) so a test forms its ring
    cleanly and then turns on chaos.  ``delay_range`` bounds every
    simulated delay (drawn deterministically per link event from ``seed``),
    which bounds reordering.
    """

    def __init__(
        self,
        schedule: Optional[FaultSchedule] = None,
        delay_range: tuple = (0.02, 0.2),
        seed: int = 0,
    ):
        self._schedule = schedule
        self._delay_lo, self._delay_hi = delay_range
        self._seed = seed
        self._cond = lockdep.named_condition("cluster.simnet")  # lockck: name(cluster.simnet)
        self._now = 0.0
        self._closed = False
        self._seq = 0
        self._queue: list = []  # heap of (deliver_at, seq, dst_s, payload, reply)
        self._bound: set = set()
        self._handlers: dict = {}  # addr_s -> (handler, on_error)
        self._blocked: set = set()  # directed (src_s, dst_s) pairs
        self._link_idx: dict = {}  # link site -> next event index
        self._sleepers: dict = {}  # token -> virtual deadline
        # Threads that woke from a virtual sleep and have not re-entered
        # one yet (a heartbeat loop mid-beat): settle() waits for them so
        # the beat's sends land before the driver advances time again —
        # without this, a galloping test clock can expire failure
        # detectors while the detector threads never got a real slice.
        # Entries carry the REAL wake time; one older than _BETWEEN_GRACE_S
        # belongs to a thread that exited its loop (node stopped) and is
        # purged.
        self._between: dict = {}  # thread ident -> real wake time
        self._active = 0  # deliveries enqueued or in a handler
        self._work: deque = deque()  # due deliveries awaiting a worker
        self._workers_started = 0
        self._idle_workers = 0
        self._worker_idents: set = set()  # pool + overflow thread idents
        self._next_port = 7000
        self.clock = SimClock(self)
        # Observability for tests: what the network actually did.
        self.counters = {
            "sent": 0,
            "delivered": 0,
            "dropped": 0,
            "duplicated": 0,
            "delayed": 0,
            "blocked": 0,
        }

    # -- clock ---------------------------------------------------------------
    def now(self) -> float:
        with self._cond:
            return self._now

    def sleep(self, dt: float) -> None:
        token = object()
        tid = threading.get_ident()
        with self._cond:
            self._between.pop(tid, None)
            deadline = self._now + dt
            self._sleepers[token] = deadline
            self._cond.notify_all()
            try:
                while self._now < deadline and not self._closed:
                    self._cond.wait(_REAL_WAIT_CAP_S)
            finally:
                del self._sleepers[token]
                if not self._closed:
                    self._between[tid] = _monotonic()
                self._cond.notify_all()

    def advance(self, dt: float = 0.05, settle: bool = True) -> None:
        """Move virtual time forward: wake due sleepers, fire due
        deliveries, then (bounded, real) wait for the woken threads to get
        a scheduling slice so their reactions land before the caller's
        next predicate check."""
        with self._cond:
            self._now += dt
            while self._queue and self._queue[0][0] <= self._now:
                self._enqueue_locked(heapq.heappop(self._queue))
            self._cond.notify_all()
            # Hand the CPU to woken sleepers (heartbeat loops): each
            # removes its entry on the way out of sleep().  The real
            # deadline scales mildly with population — 500 heartbeat
            # loops legitimately need more slices than 5.
            real_deadline = _monotonic() + max(2.0, 0.01 * len(self._sleepers))
            while any(d <= self._now for d in self._sleepers.values()):
                if _monotonic() >= real_deadline:
                    break
                self._cond.wait(0.005)
        if settle:
            self.settle()

    def settle(self, real_timeout: Optional[float] = None) -> bool:
        """Wait (real, bounded) until every due delivery has been handed to
        its handler, the handler returned, and every woken sleeper (a
        heartbeat loop mid-beat) has re-entered its sleep — the yield point
        between a virtual step and the next predicate check."""
        if real_timeout is None:
            # Scales with population: a 500-node beat's probe fan has far
            # more deliveries to drain through the pool than a 3-node ring.
            with self._cond:
                real_timeout = max(10.0, 0.05 * len(self._handlers))
        deadline = _monotonic() + real_timeout
        with self._cond:
            while True:
                while self._queue and self._queue[0][0] <= self._now:
                    self._enqueue_locked(heapq.heappop(self._queue))
                now_r = _monotonic()
                for tid in [
                    t
                    for t, ts in self._between.items()
                    if now_r - ts > _BETWEEN_GRACE_S
                ]:
                    del self._between[tid]  # thread exited its loop
                if (
                    self._active == 0
                    and not self._between
                    and not (self._queue and self._queue[0][0] <= self._now)
                ):
                    return True
                if now_r >= deadline:
                    return False
                self._cond.wait(0.005)

    # -- topology ------------------------------------------------------------
    def partition(
        self, a: Iterable[_AddrLike], b: Iterable[_AddrLike], one_way: bool = False
    ) -> None:
        """Block every link from ``a`` to ``b`` (and the reverse unless
        ``one_way``): a blocked send fails like a partitioned TCP connect —
        ``WireError``, no bytes written, delivery unambiguous."""
        aa = [_addr_s(x) for x in a]
        bb = [_addr_s(x) for x in b]
        with self._cond:
            for x in aa:
                for y in bb:
                    if x != y:
                        self._blocked.add((x, y))
                        if not one_way:
                            self._blocked.add((y, x))

    def heal(self) -> None:
        """Remove every partition (links carry traffic again)."""
        with self._cond:
            self._blocked.clear()

    def set_schedule(self, schedule: Optional[FaultSchedule]) -> None:
        """Install (or clear) the link-fault schedule mid-run — e.g. after
        forming a ring cleanly.  Event indices keep counting."""
        with self._cond:
            self._schedule = schedule

    def inject(self, dst: _AddrLike, msg: dict, src: str = "test:0") -> None:
        """Deliver a forged frame (the adversarial lane's ``send_msg``)."""
        self._route(src, dst, msg)

    def transport(self) -> SimTransport:
        return SimTransport(self)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._handlers.clear()
            self._cond.notify_all()

    # -- binding (SimTransport internals) ------------------------------------
    def _bind(self, host: str, port: int) -> Addr:
        with self._cond:
            if port == 0:
                port = self._next_port
                self._next_port += 1
            addr = (host, port)
            s = addr_str(addr)
            if s in self._bound:
                raise WireError(f"address {s} already bound")
            self._bound.add(s)
            return addr

    def _serve(self, addr_s: str, handler, on_error) -> None:
        with self._cond:
            self._handlers[addr_s] = (handler, on_error)

    def _unbind(self, addr_s: str) -> None:
        with self._cond:
            self._handlers.pop(addr_s, None)
            self._bound.discard(addr_s)

    # -- routing -------------------------------------------------------------
    def _delay_for(self, site: str, idx: int) -> float:
        # Same keying discipline as FaultSchedule.seeded: packed-int seed,
        # order-independent, free of hash randomization.
        key = (
            ((self._seed & 0xFFFFFFFF) << 96)
            | (zlib.crc32(site.encode()) << 64)
            | idx
        )
        rng = random.Random(key)
        return self._delay_lo + (self._delay_hi - self._delay_lo) * rng.random()

    def _route(self, src_s: str, dst: _AddrLike, msg: dict, reply=None) -> None:
        dst_s = _addr_s(dst)
        # The JSON round-trip is the wire contract: same serializability
        # requirement, same size cap, and the receiver gets an isolated
        # copy exactly as if it had been framed over a socket.
        payload = json.dumps(msg)
        if len(payload) > MAX_FRAME:
            raise WireError(f"frame too large: {len(payload)} bytes")
        with self._cond:
            if self._closed:
                raise WireError(f"connect to {dst_s} failed: simnet closed")
            if (src_s, dst_s) in self._blocked:
                self.counters["blocked"] += 1
                raise WireError(
                    f"connect to {dst_s} timed out (simulated partition)"
                )
            if dst_s not in self._handlers:
                raise WireError(f"connect to {dst_s} refused (not listening)")
            site = f"link:{src_s}->{dst_s}:{msg.get('method')}"
            idx = self._link_idx.get(site, 0)
            self._link_idx[site] = idx + 1
            kind = self._schedule.lookup(site, idx) if self._schedule else None
            self.counters["sent"] += 1
            now = self._now
            if kind == "drop":
                self.counters["dropped"] += 1
                deliveries = []
            elif kind == "dup":
                self.counters["duplicated"] += 1
                deliveries = [now, now + self._delay_for(site, idx)]
            elif kind == "delay":
                self.counters["delayed"] += 1
                deliveries = [now + self._delay_for(site, idx)]
            else:
                deliveries = [now]
            for at in deliveries:
                self._seq += 1
                item = (at, self._seq, dst_s, payload, reply)
                if at > now:
                    heapq.heappush(self._queue, item)
                else:
                    self._enqueue_locked(item)
        if kind == "drop":
            # The sender's view of a frame lost after connect: ambiguous —
            # its retry (if any) is honest at-least-once re-dispatch.
            raise WireError(
                f"send to {dst_s} reset mid-frame (simulated drop "
                f"[site={site} #{idx}])",
                ambiguous_delivery=True,
            )

    def _enqueue_locked(self, item) -> None:
        # Caller holds self._cond.  Hands a due delivery to the worker
        # pool, growing it (up to the cap) when the backlog outruns the
        # idle workers.
        self._active += 1
        self._work.append(item)
        if self._idle_workers < len(self._work):
            if self._workers_started < _POOL_WORKERS:
                self._workers_started += 1
                threading.Thread(
                    target=self._worker,
                    daemon=True,
                    name=f"sim-worker-{self._workers_started}",
                ).start()
            elif (
                self._idle_workers == 0
                and threading.get_ident() in self._worker_idents
            ):
                # A handler running ON the last free worker just issued a
                # nested send/request (e.g. a node forwarding during
                # dispatch).  With every worker occupied that delivery
                # could starve the pool the handler is waiting on, so a
                # transient overflow worker drains until the backlog dries.
                threading.Thread(
                    target=self._overflow_worker, daemon=True,
                    name="sim-overflow",
                ).start()
        self._cond.notify_all()

    def _worker(self) -> None:
        # Persistent delivery worker: drains self._work, calling each
        # handler OUTSIDE the condition (same invariant the per-delivery
        # threads had).  Exits when the net closes and the backlog is dry.
        self._register_worker()
        while True:
            with self._cond:
                self._idle_workers += 1
                try:
                    while not self._work and not self._closed:
                        self._cond.wait(_REAL_WAIT_CAP_S)
                    if not self._work:
                        return  # closed and dry
                    item = self._work.popleft()
                finally:
                    self._idle_workers -= 1
            self._deliver(item)

    def _overflow_worker(self) -> None:
        self._register_worker()
        while True:
            with self._cond:
                if not self._work:
                    self._worker_idents.discard(threading.get_ident())
                    return
                item = self._work.popleft()
            self._deliver(item)

    def _register_worker(self) -> None:
        with self._cond:
            self._worker_idents.add(threading.get_ident())

    def _deliver(self, item) -> None:
        _at, _seq, dst_s, payload, reply = item
        try:
            with self._cond:
                entry = self._handlers.get(dst_s)
            if entry is None:
                # Receiver died between send and delivery — like a frame
                # accepted by a dying process.
                if reply is not None:
                    reply.complete(
                        None,
                        WireError(
                            f"peer {dst_s} gone", ambiguous_delivery=True
                        ),
                    )
                return
            handler, on_error = entry
            result = None
            try:
                result = handler(json.loads(payload))
            except Exception as e:  # noqa: BLE001 - mirror TcpTransport:
                # handler failures are logged-and-dropped, never fatal.
                if on_error is not None:
                    on_error(e)
                else:
                    _LOG.error("[simnet] handler error at %s: %r", dst_s, e)
            with self._cond:
                self.counters["delivered"] += 1
            if reply is not None:
                if result is None:
                    # The request WAS processed; only the reply is missing —
                    # the ambiguous flavor, like wire.request's
                    # "failed awaiting reply".
                    reply.complete(
                        None,
                        WireError(
                            f"no reply from {dst_s}", ambiguous_delivery=True
                        ),
                    )
                else:
                    reply.complete(result, None)
        finally:
            with self._cond:
                self._active -= 1
                self._cond.notify_all()

    def _request(self, src_s: str, dst: _AddrLike, msg: dict, timeout: float) -> dict:
        reply = _Reply(self)
        self._route(src_s, dst, msg, reply=reply)
        with self._cond:
            deadline = self._now + timeout
            while not reply.done and self._now < deadline and not self._closed:
                self._cond.wait(_REAL_WAIT_CAP_S)
        if not reply.done:
            raise WireError(
                f"request to {_addr_s(dst)} timed out after {timeout}s (virtual)",
                ambiguous_delivery=True,
            )
        if reply.error is not None:
            raise reply.error
        return reply.result


def wait_until(
    net: SimNet,
    pred: Callable[[], bool],
    timeout: float = 120.0,
    step: float = 0.05,
    pace_s: float = 0.002,
) -> bool:
    """The simnet twin of the socket tests' ``wait_for``: advance virtual
    time in ``step`` increments until ``pred()`` holds or ``timeout``
    *virtual* seconds elapse.  Settles between steps so node threads react
    before each check, and yields ``pace_s`` of real scheduling time per
    step so work that lives OUTSIDE the virtual clock (engine device
    loops) progresses alongside it.  No protocol timing ever depends on
    the wall clock — real waits here are bounded scheduler yields, never
    ``time.sleep``."""
    deadline = net.now() + timeout
    pacer = threading.Event()  # never set: wait() is a bounded real yield
    while True:
        net.settle()
        if pred():
            return True
        if net.now() >= deadline:
            return pred()
        net.advance(step)
        if pace_s:
            pacer.wait(pace_s)
