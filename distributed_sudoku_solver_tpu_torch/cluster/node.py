"""Cluster node: coordinator membership + heartbeat + job dispatch + recovery.

Host-level re-design of the reference's overlay layer (SURVEY.md §1 L3,
§2.1 #8-#10) for the TPU world: each *node* is a host driving its own chip
mesh (the data plane lives in ``parallel/``).  Jobs are placed whole at
submit time (least-outstanding), and *live* jobs are additionally split
mid-flight: an idle node's NEEDWORK pulls bottom stack rows — the largest
unexplored subtrees — out of a busy peer's running frontier, exactly the
reference's dynamic guess-range split (the reference's ``DHT_Node.py:
491-510``) lifted to the host tier.

Capability map (reference -> here):

* coordinator-mediated join (the reference's ``DHT_Node.py:260-330``) ->
  JOIN_REQ forwarded to the coordinator, which appends to the member list
  and broadcasts UPDATE_NETWORK; ring positions (predecessor/successor) are
  *derived from list order* on every node, eliminating the reference's
  separate UPDATE_PREDECESSOR/UPDATE_NEIGHBOR splice messages and the
  inconsistency windows between them.
* heartbeat + 2x-timeout detection (``:43-62,158-163``) -> each node
  heartbeats its ring successor and watches its predecessor's arrivals.
* coordinator-led repair + self-promotion (``:167-199``) -> same roles:
  detector reports NODE_FAILED; the dead coordinator's successor-detector
  self-promotes (exactly one detector per corpse, so promotion is unique).
* re-execution from the delegator's ledger (``:47,497,509,201-209``) ->
  every forwarded job stays in ``self._ledger`` until its SOLUTION arrives;
  workers stream PROGRESS snapshots (their surviving subtree roots) back to
  the origin, so when a member dies its jobs *resume mid-subtree* from the
  last snapshot instead of restarting — strictly stronger than the
  reference's recompute-from-ledger.
* NEEDWORK work stealing (``:246-254,491-510``) -> an idle node NEEDWORKs
  its ring predecessor; the busy peer sheds bottom stack rows from its
  neediest live job (``serving/engine.shed_work``) and ships them as a
  SUBTASK; first-win cancellation and unsat-aggregation across the parts
  are handled by the per-job execution aggregate (:class:`_Exec`).
* STATS_REQ 1 s gather sleep (``:566-598``) -> parallel request/reply
  fan-out with per-peer timeouts.
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import logging
import socket
import threading
import time
import uuid as uuid_mod
from typing import Callable, Optional

import numpy as np

from distributed_sudoku_solver_tpu_torch.cluster import wire
from distributed_sudoku_solver_tpu_torch.cluster.dht import ClusterCache, Gossip, HashRing
from distributed_sudoku_solver_tpu_torch.cluster.wire import Addr, WireError, addr_str
from distributed_sudoku_solver_tpu_torch.models.geometry import geometry_for_size
from distributed_sudoku_solver_tpu_torch.obs import agg, lockdep, trace
from distributed_sudoku_solver_tpu_torch.obs.hist import LatencyHistogram
from distributed_sudoku_solver_tpu_torch.obs.logctx import ctx_log, job_log
from distributed_sudoku_solver_tpu_torch.serving import brownout as brownout_mod
from distributed_sudoku_solver_tpu_torch.serving import faults
from distributed_sudoku_solver_tpu_torch.serving.engine import Job, SolverEngine
from distributed_sudoku_solver_tpu_torch.serving.frontdoor import cache as fd_cache
from distributed_sudoku_solver_tpu_torch.serving.frontdoor import canonical as fd_canon

# Diagnostics go through logging (stderr via the root handler / logging's
# lastResort), not print(); failure-path messages carry the fault
# classification and keep their grep-compatible "[addr]" prefixes.
_LOG = logging.getLogger(__name__)


def local_ip() -> str:
    """Best-effort routable local address (UDP connect sends no packets)."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"


def pack_rows(rows: np.ndarray) -> dict:
    """Subtree roots (uint32 candidate masks) -> JSON-safe wire payload.

    Little-endian raw bytes under base64: the same rows that
    ``utils/checkpoint.py`` snapshots to npz, so the checkpoint format and
    the offload/progress wire format are one representation.
    """
    r = np.ascontiguousarray(np.asarray(rows, dtype="<u4"))
    return {
        "shape": list(r.shape),
        "data": base64.b64encode(r.tobytes()).decode("ascii"),
    }


def unpack_rows(d: dict) -> np.ndarray:
    shape = tuple(int(x) for x in d["shape"])
    raw = base64.b64decode(d["data"])
    rows = np.frombuffer(raw, dtype="<u4").reshape(shape)
    return rows.astype(np.uint32)


def _config_from_dict(d: Optional[dict]):
    """SolverConfig off the wire (None-tolerant): a shed part or resumed
    snapshot searches under the same config the job was submitted with —
    a portfolio racer's heterogeneity must survive the hop."""
    if not d:
        return None
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig

    return SolverConfig(**d)


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    heartbeat_s: float = 1.0
    fail_factor: float = 3.0  # declare dead after fail_factor * heartbeat_s
    io_timeout_s: float = 5.0
    stats_timeout_s: float = 2.0
    # At-least-once delivery for result-bearing messages (SOLUTION /
    # PART_RESULT): a failed send is re-attempted send_retries more times,
    # retry_delay_s apart (on the node clock, so virtual in simnet tests).
    # An ambiguous failure may already have been delivered, so receivers
    # dedupe these methods by uuid/part — see _handle's dedupe ledger.
    send_retries: int = 2
    retry_delay_s: float = 0.25
    # How long a coordinator keeps probing an evicted-but-possibly-alive
    # member with its current view (the split-brain heal channel: a
    # partitioned survivor learns the winning view and rejoins/demotes).
    # Probes ride the per-beat broadcast; a really-dead member costs one
    # failed connect per beat until the tombstone expires.
    tombstone_probe_s: float = 60.0
    # Mid-job offload + progress checkpointing:
    needwork: bool = True  # idle nodes pull subtree work from the ring
    shed_k: int = 8  # max stack rows shipped per SUBTASK
    progress_interval_s: float = 0.5  # worker -> origin snapshot cadence
    progress_max_rows: int = 4096  # skip snapshots larger than this
    # Shed parts are retained at the shedder and re-entered locally when the
    # part-executing peer leaves the network view (always on).  Optionally a
    # wall-clock deadline also re-homes parts stuck on a wedged-but-alive
    # peer; 0 disables (the failure detector covers actual deaths, and a
    # deep search can legitimately run long).
    part_deadline_s: float = 0.0
    # The DHT plane (cluster/dht/): SWIM gossip liveness +
    # consistent-hash ownership of the canonical digest space + the
    # cluster-wide result cache.  The (term,epoch) view stays the
    # membership authority; gossip adds O(1)-per-beat liveness (one PROBE
    # with piggybacked state per beat) and the ring adds cache-affine
    # routing.  ``dht=False`` restores the pre-DHT node exactly.
    dht: bool = True
    dht_vnodes: int = 32  # virtual points per member on the hash ring
    dht_piggyback: int = 8  # max gossip updates per PROBE/ACK frame
    dht_suspicion_s: float = 0.0  # 0 -> heartbeat_s * fail_factor
    dht_probe_timeout_s: float = 0.0  # 0 -> min(stats_timeout_s, heartbeat_s)
    dht_cache_entries: int = 65536  # per-node shard capacity
    dht_get_timeout_s: float = 0.0  # 0 -> min(1.0, io_timeout_s)
    # Cache-affine routing: submit() sends a cacheable board to its
    # digest owner when the owner is gossip-ALIVE and not browning, so
    # every orbit's repeats land where its entry lives.  Only engaged
    # when this node runs a front door (no front door -> no cache to be
    # affine to) — least-outstanding placement otherwise.
    dht_affinity: bool = True


class _DedupeLRU:
    """Bounded seen-set for at-least-once delivery: result/work-bearing
    messages (TASK, SUBTASK, SOLUTION, PART_RESULT) are deduped by their
    uuid so an ambiguous-failure retry that was in fact delivered twice
    executes once.  Bounded like the engine's stale-cancel ledger: a uuid
    evicted after 4096 newer ones has long since resolved, and a duplicate
    arriving later still hits the handlers' own idempotence (popped
    ledger, done-part) — this ledger exists to stop duplicate *execution*,
    not to be the only line of defense."""

    def __init__(self, cap: int = 4096):
        self._cap = cap
        self._seen: collections.OrderedDict = collections.OrderedDict()
        self._lock = lockdep.named_lock("cluster.dedupe")  # lockck: name(cluster.dedupe)

    def seen(self, key) -> bool:
        """True if ``key`` was recorded before; records it otherwise."""
        with self._lock:
            if key in self._seen:
                self._seen.move_to_end(key)
                return True
            self._seen[key] = None
            while len(self._seen) > self._cap:
                self._seen.popitem(last=False)
            return False


class _Exec:
    """One uuid's execution on this node: local engine job + shed parts.

    Finalization rules (the distributed counterpart of ``SolveResult``):

    * solved   — the local search or *any* part solves (first win; losers
                 are cancelled, the speculative-cancellation contract of
                 the reference's ``DHT_Node.py:348-387``);
    * unsat    — the local space is exhausted (nothing dropped, nothing
                 still shipped) AND every part reports its subspace
                 exhausted: the disjoint parts cover the job's space, so
                 exhaustion composes into a proof;
    * cancelled/error — propagate immediately, cancelling live parts;
    * nodes    — accumulate across the local run, all parts, and any
                 resumed predecessor (``base_nodes``).
    """

    def __init__(
        self,
        node: "ClusterNode",
        job: Job,
        on_final: Callable[[dict], None],
        base_nodes: int = 0,
    ):
        self.node = node
        self.uuid = job.uuid
        self.job = job
        self.on_final = on_final
        self.base_nodes = base_nodes
        self.parts: dict[str, dict] = {}  # part_uuid -> {peer, done, exhausted, nodes}
        self.part_failure: Optional[str] = None  # terminal part loss (see
        #   on_part_result): surfaces as the job's error if it ends unresolved
        self.progress_skip_warned = False  # one degraded-resume warning per job
        self.finalized = False
        self.lock = lockdep.named_lock("cluster.exec")  # lockck: name(cluster.exec)
        threading.Thread(
            target=self._watch_local, daemon=True, name=f"exec-{self.uuid[:8]}"
        ).start()

    def _watch_local(self) -> None:
        self.job.done.wait()
        self._maybe_finalize()

    def add_part(
        self, part_uuid: str, peer: str, rows_packed=None, config=None
    ) -> bool:
        """Register a shed part.  ``rows_packed``/``config`` are retained so
        the shedder can re-enter the subtree locally if ``peer`` dies — the
        recovery symmetry the worker-death resume path has (ADVICE r2 #1)."""
        with self.lock:
            if self.finalized:
                return False
            self.parts[part_uuid] = {
                "peer": peer,
                "done": False,
                "exhausted": False,
                "nodes": 0,
                "rows": rows_packed,
                "config": config,
                "t0": self.node._clock.now(),
                "rehomed": False,
            }
            return True

    def take_orphaned(self, live: set, deadline_s: float = 0.0) -> list:
        """Claim parts whose peer left ``live`` (or blew ``deadline_s``) for
        local re-execution: each is marked re-homed (so recovery fires once)
        and its retained rows/config returned.  ``peer`` is kept as the
        original executor so finalize still CANCELs a slow-but-alive peer
        that blew the deadline.  A false death verdict at worst duplicates
        the part's work — PART_RESULT first-wins dedupe keeps the aggregate
        sound."""
        now = self.node._clock.now()
        out = []
        with self.lock:
            if self.finalized:
                return out
            for pu, p in self.parts.items():
                if p["done"] or p["rehomed"] or p["rows"] is None:
                    continue
                if p["peer"] == self.node.addr_s:
                    continue
                dead = p["peer"] not in live
                late = deadline_s > 0 and now - p["t0"] > deadline_s
                if dead or late:
                    p["rehomed"] = True
                    out.append((pu, p["rows"], p["config"]))
        return out

    def mark_local(self, part_uuid: str) -> None:
        """Record that a part runs on this node (the WireError shed
        fallback), so view-change recovery never re-enters it."""
        with self.lock:
            p = self.parts.get(part_uuid)
            if p is not None:
                p["peer"] = self.node.addr_s
                p["rehomed"] = True

    def unmark_rehomed(self, part_uuid: str) -> None:
        """Local re-entry failed: clear the flag so a later recovery pass
        (next view change / deadline tick) can retry instead of the part
        being permanently lost."""
        with self.lock:
            p = self.parts.get(part_uuid)
            if p is not None:
                p["rehomed"] = False

    def on_part_result(self, part_uuid: str, msg: dict) -> None:
        if msg.get("error") and not msg.get("solved") and not msg.get("unsat"):
            # A FAILED execution, not an exhaustion verdict: the executor's
            # engine drained the part during shutdown, or its flight could
            # not launch (any no-verdict error qualifies — keying on one
            # error string would let other failures mark the part done,
            # free the recovery rows, and leave the subtree silently
            # unsearched; the SOLUTION-path twin of this hole lost a whole
            # job in the round-4 device-backed churn soak).
            if msg.get("local"):
                # Our own local re-entry failed — the last resort.  Mark
                # the part failed-done (exhaustion can never compose into
                # an unsat proof now) and remember the error so an
                # unresolved job surfaces it instead of hanging or looping:
                # re-entering again would fail identically forever.
                with self.lock:
                    info = self.parts.get(part_uuid)
                    if info is None or info["done"]:
                        return
                    info["done"] = True
                    info["rows"] = None
                    info["exhausted"] = False
                    self.part_failure = (
                        f"part {part_uuid} failed on its last-resort local "
                        f"re-entry: {msg['error']}"
                    )
                self._maybe_finalize()
                return
            # Remote failure: re-enter the retained rows locally right away
            # — waiting for view-change recovery would hang forever when
            # the peer stays in the view (engine restarted, node alive).
            # An already-rehomed part is left alone (a local re-entry owns
            # it; this is the original executor's late drain).  If re-entry
            # raises synchronously, the helper clears the flag so
            # deadline/view recovery retries later.
            with self.lock:
                info = self.parts.get(part_uuid)
                if info is None or info["done"] or self.finalized:
                    return
                if info["rehomed"]:
                    return
                rows_packed, cfg = info["rows"], info["config"]
                if rows_packed is None:
                    return  # nothing retained; view-change recovery owns it
                info["rehomed"] = True
            self.node._reenter_part(self, part_uuid, rows_packed, cfg)
            return
        with self.lock:
            info = self.parts.get(part_uuid)
            if info is None or info["done"]:
                return
            info["done"] = True
            # Drop the retained recovery rows: the part is done, nobody will
            # re-enter it (take_orphaned skips rows-None entries), and a
            # long-running job that sheds many parts must not hold every
            # part's packed stack rows until finalize (ADVICE r3).
            info["rows"] = None
            info["exhausted"] = bool(msg.get("unsat"))
            info["nodes"] = int(msg.get("nodes", 0))
            peer, rehomed = info["peer"], info["rehomed"]
        if rehomed:
            # A re-homed part has two executions (the original peer may be
            # alive — blown deadline / false death verdict — plus the local
            # re-entry).  First result wins: cancel both executors so the
            # loser doesn't burn an engine with no waiter (cancelling the
            # finished one is a harmless no-op).
            self.node._send_cancel(peer, part_uuid)
            if peer != self.node.addr_s:
                self.node._send_cancel(self.node.addr_s, part_uuid)
        if msg.get("solved") and msg.get("solution") is not None:
            self._finalize(
                solved=True, solution=np.asarray(msg["solution"], dtype=np.int32)
            )
            self.node.engine.cancel(self.uuid)  # stop the local loser
        else:
            self._maybe_finalize()

    def _maybe_finalize(self) -> None:
        job = self.job
        if not job.done.is_set():
            return  # local still running; parts alone conclude only via solve
        if job.solved:
            self._finalize(solved=True, solution=job.solution)
            return
        if job.cancelled:
            self._finalize(cancelled=True)
            return
        if job.error:
            self._finalize(error=job.error)
            return
        with self.lock:
            if any(not p["done"] for p in self.parts.values()):
                return  # exhausted locally, but shipped subtrees still out
            all_parts_exhausted = all(p["exhausted"] for p in self.parts.values())
            part_failure = self.part_failure
        unsat = job.exhausted and all_parts_exhausted
        if not unsat and part_failure:
            # A part's subtree was lost terminally (remote AND local
            # executions failed): the inconclusive outcome carries the
            # cause instead of reading like a mere budget exhaustion.
            self._finalize(error=part_failure)
            return
        self._finalize(unsat=unsat)

    def _finalize(
        self,
        solved: bool = False,
        solution=None,
        unsat: bool = False,
        cancelled: bool = False,
        error: Optional[str] = None,
    ) -> None:
        with self.lock:
            if self.finalized:
                return
            self.finalized = True
            part_nodes = sum(p["nodes"] for p in self.parts.values())
            losers = [
                (pu, p["peer"], p["rehomed"])
                for pu, p in self.parts.items()
                if not p["done"]
            ]
        for part_uuid, peer, rehomed in losers:
            self.node._send_cancel(peer, part_uuid)
            # A re-homed part has a *second* execution here (the original
            # peer may be alive too, e.g. a blown deadline): cancel both.
            if rehomed and peer != self.node.addr_s:
                self.node._send_cancel(self.node.addr_s, part_uuid)
        self.on_final(
            {
                "solved": solved,
                "solution": solution,
                "unsat": unsat,
                "cancelled": cancelled,
                "error": error,
                "nodes": self.base_nodes + int(self.job.nodes) + part_nodes,
            }
        )


class _L2Adapter:
    """The duck-typed L2 the front door calls (router.py's ``self.l2``),
    backed by the node's :class:`cluster.dht.ClusterCache`.

    This is the ONE place the wire's JSON-ready entry dicts and the
    front door's :class:`CacheEntry` meet: ``cluster/dht`` stays
    stdlib-closed (no numpy, no serving import) and ``serving/frontdoor``
    stays cluster-free — the conversion lives here, in the layer that
    already imports both."""

    def __init__(self, dcache: ClusterCache):
        self.dcache = dcache

    def lookup(self, digest: str, raw: str):
        d = self.dcache.lookup(digest)
        if d is None:
            return None
        verdict = d.get("verdict")
        if verdict not in (fd_cache.SOLVED, fd_cache.UNSAT):
            return None  # malformed wire entry: treat as a miss
        sol = d.get("solution")
        if verdict == fd_cache.SOLVED and sol is None:
            return None
        return fd_cache.CacheEntry(
            verdict=verdict,
            solution=None if sol is None else np.asarray(sol, dtype=np.int8),
            nodes=int(d.get("nodes", 0)),
            raw_digest=str(d.get("raw", raw)),
            route=str(d.get("route", "cluster")),
        )

    def store(self, digest: str, entry) -> None:
        self.dcache.store(
            digest,
            {
                "verdict": entry.verdict,
                "solution": None
                if entry.solution is None
                else np.asarray(entry.solution).tolist(),
                "nodes": int(entry.nodes),
                "raw": entry.raw_digest,
                "route": entry.route,
            },
        )


class ClusterNode:
    """One host in the solver cluster; wraps a local SolverEngine."""

    def __init__(
        self,
        engine: SolverEngine,
        host: str = "127.0.0.1",
        port: int = 0,
        anchor: Optional[Addr] = None,
        config: ClusterConfig = ClusterConfig(),
        advertise_host: Optional[str] = None,
        transport=None,
        clock=None,
    ):
        """``host`` is the bind address; ``advertise_host`` is the identity
        other members dial (defaults to ``host``, which is only correct for
        single-machine clusters — multi-host deployments must advertise a
        routable address, e.g. from :func:`local_ip`).

        ``transport``/``clock`` are the injectable network/time seam (the
        contract in ``cluster/wire.py``'s module note): real sockets and
        ``time.monotonic``/``time.sleep`` by default — zero production
        behavior change — or a ``cluster/simnet.py`` plane, which runs the
        identical protocol over an in-memory network with a virtual clock
        so partitions, duplicate delivery, reordering, and split-brain
        heal are deterministic, socket-free tests."""
        self.engine = engine
        self.config = config
        self._clock = clock or wire.SystemClock()
        self._transport = transport or wire.TcpTransport()
        bound = self._transport.bind(host, port)
        adv = advertise_host or bound[0]
        if adv in ("0.0.0.0", "::"):
            adv = local_ip()
        self.addr: Addr = (adv, bound[1])
        self.addr_s = addr_str(self.addr)
        self.anchor = anchor
        # Trace attribution (obs/trace.py): engine spans recorded on this
        # host carry the node's wire identity, so a stitched multi-node
        # trace shows WHICH member ran which chunk.
        engine.trace_node = self.addr_s

        self._lock = lockdep.named_rlock("cluster.node")  # lockck: name(cluster.node)
        self.network: list[str] = [self.addr_s]  # list order defines the ring
        self.coordinator: str = self.addr_s
        # Monotonic membership version, ordered as (term, epoch): the term
        # bumps on every coordinator promotion (so a successor's first view
        # supersedes anything the dead coordinator issued, even epochs the
        # detector never saw), the epoch bumps on every membership change
        # within a term.  UPDATE_NETWORK messages arrive on per-connection
        # threads, so two broadcasts can be *applied* out of order; this
        # ordering makes installation order-independent (stale views are
        # dropped), where the reference simply last-writer-wins
        # (the reference's ``DHT_Node.py:332-336``).
        self.net_term: int = 0
        self.net_epoch: int = 0
        self._last_hb = self._clock.now()
        self._ledger: dict[str, dict] = {}  # uuid -> {grid, member, job, rows?, nodes_done?}
        self._execs: dict[str, _Exec] = {}  # uuid -> live local execution
        self._parts: dict[str, str] = {}  # part_uuid -> root uuid (parts run here)
        self._outstanding: dict[str, int] = {}  # member -> in-flight count
        self._rr = 0
        # Idempotent client resubmit: client-supplied uuid ->
        # live handle, so a retry of an in-flight/resolved job returns the
        # existing verdict instead of double-solving (the engine keeps the
        # same registry for its own jobs; this one covers REMOTE dispatch
        # too).  Bounded; error terminals are evicted at lookup so a retry
        # after an infra failure runs fresh.
        self._client_jobs: dict[str, Job] = {}  # lockck: guard(_lock)
        # Shed-part counters: bumped by concurrent NEEDWORK/SUBTASK
        # handler threads (deadck guard inference caught subtasks_run
        # outside the lock — a lost-update race since round 10).
        self.subtasks_sent = 0  # lockck: guard(_lock)
        self.subtasks_run = 0  # lockck: guard(_lock)
        # PROGRESS snapshots dropped because the frontier was wider than
        # progress_max_rows: the job still completes, but a worker death
        # degrades its resume to root re-execution.  Silent until round 6
        # (VERDICT r5 missing #3) — now counted, logged, and exported on
        # /metrics so an operator can see which deployments run resumeless.
        self.progress_skipped = 0  # lockck: guard(_lock)
        # Jobs served by a resident flight run without progress streaming
        # at all (no snapshot surface): counted so an operator can see how
        # much of the fleet's work resumes from the root on a death.
        self.progress_resident = 0  # lockck: guard(_lock)
        # Where the ring's work ran: TASKs from peers executed here, and
        # ledger jobs re-executed here after their worker left the view
        # (``resumed``: of those, from a PROGRESS snapshot).  The port's
        # own counters (the JAX node logs these events without counting).
        self.tasks_run = 0  # lockck: guard(_lock)
        self.reexecuted = 0  # lockck: guard(_lock)
        self.resumed = 0  # lockck: guard(_lock)
        # At-least-once / split-brain machinery (round 10): the dedupe
        # ledger for result/work-bearing duplicates, the coordinator's
        # tombstones of suspected-dead members (probed with the current
        # view so a partitioned survivor can rejoin), per-peer
        # rate-limiting of stale-view reflections, and the fault counters
        # exported on /metrics (cluster.faults).
        self._dedupe = _DedupeLRU()
        self._evicted: dict[str, float] = {}  # member -> eviction time
        self._reflect_at: dict[str, float] = {}  # peer -> next reflect time
        self.duplicates_dropped: dict[str, int] = {}  # lockck: guard(_lock) — method -> count
        self.stale_views_rejected = 0  # lockck: guard(_lock)
        self.stale_view_reflections = 0  # lockck: guard(_lock)
        self.partitions_healed = 0  # lockck: guard(_lock)
        self.demotions = 0  # lockck: guard(_lock)
        self.rehomed_parts = 0  # lockck: guard(_lock)
        # Results whose at-least-once budget exhausted mid-partition wait
        # here for the next beat's re-offer (_flush_parked): a partition
        # longer than retries*delay degrades to a LATE delivery, not a
        # lost result.
        self._parked: list = []  # lockck: guard(_lock) — (peer, payload, first-try time)
        self.results_parked = 0  # lockck: guard(_lock)
        self.results_delivered_late = 0  # lockck: guard(_lock)
        # Cluster-scope observability (round 12, obs/): the node's own
        # mergeable wire-wall histograms (send = one egress through the
        # transport; ack = a result-bearing send's full at-least-once
        # round, retries included) — timed on the NODE clock, so the
        # simnet lane's numbers are virtual and deterministic — plus the
        # METRICS_PULL aggregation counters exported as cluster.agg.
        self._hist = {"send_ms": LatencyHistogram(), "ack_ms": LatencyHistogram()}
        # The DHT plane (cluster/dht/): gossip liveness, the
        # consistent-hash ring over the canonical digest space, and this
        # node's shard of the cluster-wide result cache.  The ring is
        # guarded by its own high-ranked lock (NOT the node lock): owner
        # lookups run on cache/front-door threads that may hold the
        # frontdoor locks, which rank above cluster.node.
        self.gossip: Optional[Gossip] = None
        self.ring: Optional[HashRing] = None
        self.dcache: Optional[ClusterCache] = None
        self._ring_lock = lockdep.named_lock("cluster.ring")  # lockck: name(cluster.ring)
        self.affinity_routed = 0  # lockck: guard(_lock) — submits sent to the digest owner
        self.affinity_declined = 0  # lockck: guard(_lock) — owner unhealthy/browning; local fallback
        if config.dht:
            suspicion = config.dht_suspicion_s or (
                config.heartbeat_s * config.fail_factor
            )
            self.gossip = Gossip(
                self.addr_s,
                self._clock.now,
                suspicion_s=suspicion,
                piggyback=config.dht_piggyback,
            )
            self.ring = HashRing(config.dht_vnodes)
            self.ring.add(self.addr_s)
            self.dcache = ClusterCache(
                self.addr_s,
                owner_fn=self._ring_owner,
                request_fn=self._dht_request,
                put_fn=self._dht_send,
                clock=self._clock,
                uuid_fn=lambda: str(uuid_mod.uuid4()),
                capacity=config.dht_cache_entries,
                get_timeout_s=config.dht_get_timeout_s
                or min(1.0, config.io_timeout_s),
                put_retries=config.send_retries,
                retry_delay_s=config.retry_delay_s,
            )
            # Wire the front door's L2 seam (router.py self.l2): L1
            # misses read through the cluster cache, fills replicate to
            # the digest owner.  No front door -> no seam (the node's
            # shard still serves CACHE_GET/CACHE_PUT for peers).
            fd = getattr(engine, "frontdoor", None)
            if fd is not None:
                fd.l2 = _L2Adapter(self.dcache)
        self.agg_pulls = 0  # lockck: guard(_lock) — peer METRICS_PULL requests issued
        self.agg_merges = 0  # lockck: guard(_lock) — cluster rollups computed
        self.agg_unreachable = 0  # lockck: guard(_lock) — pulls that found a peer unreachable
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ClusterNode":
        self._transport.serve(
            self._handle,
            on_error=self._log_bad_message,
            io_timeout=self.config.io_timeout_s,
        )
        t = threading.Thread(
            target=self._hb_loop, daemon=True, name=f"hb@{self.addr_s}"
        )
        t.start()
        self._threads.append(t)
        if self.anchor is not None:
            self._send(self.anchor, {"method": "JOIN_REQ", "addr": self.addr_s})
        return self

    def stop(self, graceful: bool = True) -> None:
        """Leave the ring (graceful drain analog of ``DHT_Node.stop``, :137-156)."""
        self._stop.set()
        if graceful and self.coordinator != self.addr_s:
            try:
                self._send(
                    self.coordinator,
                    {
                        "method": "LEAVE",
                        "addr": self.addr_s,
                        "term": self.net_term,
                        "epoch": self.net_epoch,
                    },
                )
            except WireError:
                pass
        self._transport.close()

    def kill(self) -> None:
        """Abrupt death for fault-injection tests: no LEAVE, just silence."""
        self.stop(graceful=False)

    # -- durable lifecycle ----------------------------------------
    def drain(self, timeout: float = 30.0) -> dict:
        """Graceful drain, cluster-aware: mark this member browning in the
        gossip plane (peers stop affinity-routing here immediately, ahead
        of the LEAVE), then walk the engine's lifecycle ladder with
        :meth:`_handoff_job` offered for every unstarted job — shipped to
        a gossip-healthy ring peer over the EXISTING TASK frame, so the
        receiving member needs no new wire surface.  Returns the engine's
        drain summary dict.  The caller still owns ``stop()``: drain
        quiesces the engine, it does not leave the ring."""
        if self.gossip is not None:
            self.gossip.set_brown(True)
        return self.engine.drain(timeout=timeout, handoff=self._handoff_job)

    def _handoff_job(self, job) -> bool:
        """Ship one detached (accepted, unstarted) job to a healthy peer
        during drain.  Placement mirrors submit(): the digest's ring owner
        when it is gossip-healthy and not us, else the least-outstanding
        healthy peer.  False (journal for restart instead) when no healthy
        peer exists or the send fails — handoff is an optimization over
        the WAL, never a second source of truth."""
        if job.grid is None:
            return False
        with self._lock:
            peers = [m for m in self.network if m != self.addr_s]
        peers = [
            m
            for m in peers
            if self.gossip is None or self.gossip.is_healthy(m)
        ]
        if not peers:
            return False
        target = None
        if (
            self.dcache is not None
            and self.config.dht_affinity
            and getattr(self.engine, "frontdoor", None) is not None
        ):
            owner = self._affinity_owner(job.grid)
            if owner is not None and owner != self.addr_s:
                target = owner
        if target is None:
            with self._lock:
                target = min(
                    (self._outstanding.get(m, 0), m) for m in peers
                )[1]
        cfg_dict = (
            dataclasses.asdict(job.config) if job.config is not None else None
        )
        payload = {
            "method": "TASK",
            "uuid": job.uuid,
            "grid": np.asarray(job.grid).tolist(),
            "origin": self.addr_s,
            "config": cfg_dict,
        }
        if trace.active() is not None:
            payload["trace"] = job.uuid
        try:
            self._send(target, payload)
        except WireError:
            return False
        self._track(target, +1)
        rec = trace.active()
        if rec is not None:
            rec.event(
                str(job.uuid), "drain.handoff", "engine.lifecycle",
                node=self.addr_s, member=target,
            )
        return True

    def recover(self) -> int:
        """Replay the WAL through the engine's normal submit seam
        (``SolverEngine.recover``) — called by the CLI after a restart
        rejoins the ring, so replayed jobs route exactly like fresh ones."""
        return self.engine.recover()

    # -- ring derivation -----------------------------------------------------
    def _ring(self) -> tuple[Optional[str], Optional[str]]:
        with self._lock:
            if len(self.network) < 2 or self.addr_s not in self.network:
                return None, None
            i = self.network.index(self.addr_s)
            pred = self.network[(i - 1) % len(self.network)]
            succ = self.network[(i + 1) % len(self.network)]
            return pred, succ

    # -- wire egress ---------------------------------------------------------
    def _send(self, peer, payload: dict) -> None:
        """The node's single wire-egress seam: every outbound cluster
        message leaves through here (all egress shares ``io_timeout_s``),
        so the fault-injection plane (``serving/faults.py``) can fail sends
        deterministically and the existing WireError recovery paths —
        ledger re-execution, part re-entry/local fallback, heartbeat
        suspicion — are exercised end to end.  ``peer`` is an addr string
        or a parsed ``Addr``.  An injected fault surfaces as
        :class:`WireError` whatever its class: to the *sender*, any failed
        send is just an undeliverable message, and the re-dispatch
        machinery (not this seam) owns the classification."""
        if faults.active() is not None:  # skip uuid extraction in production
            try:
                faults.fire(
                    "cluster.send",
                    uuids=tuple(
                        str(payload[k])
                        for k in ("uuid", "part")
                        if payload.get(k) is not None
                    ),
                )
            except faults.SimulatedFault as e:
                raise WireError(f"injected send fault: {e}") from e
        rec = trace.active()
        if rec is not None:
            # Wire-egress span for uuid-bearing frames only (heartbeats and
            # membership noise would drown the job spans); recorded BEFORE
            # the transport call so dropped sends still show in the trace.
            tid = payload.get("trace") or payload.get("uuid") or payload.get("part")
            if tid is not None:
                rec.event(
                    str(tid), f"send.{payload.get('method')}", "cluster.send",
                    node=self.addr_s,
                    peer=peer if isinstance(peer, str) else addr_str(peer),
                )
        addr = peer if isinstance(peer, tuple) else wire.parse_addr(peer)
        t0 = self._clock.now()
        self._transport.send(addr, payload, self.config.io_timeout_s)
        # Wire egress wall (mergeable, obs/hist.py): successful sends only
        # — a failed send's wall measures the failure mode, not the link.
        self._hist["send_ms"].record(self._clock.now() - t0)

    def _send_result(self, peer, payload: dict) -> bool:
        """At-least-once delivery for result-bearing messages (SOLUTION,
        PART_RESULT): a failed send is retried under a small bounded budget
        — an *ambiguous* failure (bytes written, then reset: see
        ``WireError.ambiguous_delivery``) may already have been delivered,
        so the receiver dedupes these methods by uuid (``_handle``); a
        lost-for-sure failure (connect refused/timed out) retries are what
        carry a result through a transient link fault at all.  Returns
        False when every attempt failed — the result is then PARKED and
        re-offered once per beat (``_flush_parked``) until the link heals
        or the origin stays gone past the tombstone horizon: a partition
        that outlives the retry budget must degrade to a late delivery
        (origin dedupes), never a lost result."""
        last: Optional[WireError] = None
        t0 = self._clock.now()
        for attempt in range(self.config.send_retries + 1):
            if attempt:
                self._clock.sleep(self.config.retry_delay_s)
                if self._stop.is_set():
                    return False
            try:
                self._send(peer, payload)
                # The ack wall: first attempt -> delivered, retry pacing
                # included — what a result actually pays to land.
                self._hist["ack_ms"].record(self._clock.now() - t0)
                return True
            except WireError as e:
                last = e
        if not self._stop.is_set():
            with self._lock:
                self.results_parked += 1
                self._parked.append((peer, payload, t0))
            _LOG.warning(
                "[%s] %s to %s undeliverable after %d attempts "
                "(uuid=%s): %r — parked for per-beat re-delivery",
                self.addr_s, payload.get("method"), peer,
                self.config.send_retries + 1,
                payload.get("uuid") or payload.get("part"), last,
            )
        return False

    def _flush_parked(self) -> None:
        """One re-delivery attempt per parked result (off the heartbeat
        thread: a wedged TCP connect must not starve the failure
        detector).  Items are swapped out under the lock so overlapping
        flushes never double-send; still-failing items re-park; items
        older than the tombstone horizon are dropped — by then the
        origin's own repair (ledger re-execution) owns the job."""
        now = self._clock.now()
        with self._lock:
            batch = self._parked
            self._parked = []
        keep = []
        for peer, payload, t0 in batch:
            if now - t0 > self.config.tombstone_probe_s:
                continue
            try:
                self._send(peer, payload)
                with self._lock:
                    self.results_delivered_late += 1
            except WireError:
                keep.append((peer, payload, t0))
        if keep:
            with self._lock:
                self._parked = keep + self._parked

    def _log_bad_message(self, e: BaseException) -> None:
        """Transport's handler-error sink: malformed or interrupted control
        traffic is logged-and-dropped (RuntimeError covers "engine stopped"
        during teardown; the catch is any Exception — arbitrary network
        input must never kill a serving thread or wedge a loop);
        reliability comes from sender-side errors, not server retries."""
        if not self._stop.is_set():
            _LOG.error(
                "[%s] bad message: %r [%s]", self.addr_s, e, faults.classify(e)
            )

    # -- background loops ----------------------------------------------------
    def _hb_loop(self) -> None:
        while not self._stop.is_set():
            self._clock.sleep(self.config.heartbeat_s)
            if self._stop.is_set():
                return
            with self._lock:
                is_coord = self.coordinator == self.addr_s
                have_tombstones = bool(self._evicted)
                orphaned = (
                    not is_coord and self.addr_s not in self.network
                    and len(self.network) > 0
                )
                coord = self.coordinator
                term, epoch = self.net_term, self.net_epoch
            # Coordinator re-broadcasts the view every beat: a member that
            # missed an UPDATE_NETWORK (send failure is fire-and-forget)
            # converges on the next beat instead of never.  Off-thread, so a
            # partitioned member's connect timeout cannot delay our own
            # heartbeats past the failure threshold.  Tombstoned (evicted
            # but possibly alive) members are probed with the same payload
            # — the split-brain heal channel — so the broadcast also runs
            # when the view has shrunk to just us.
            if is_coord and (have_tombstones or len(self.network) > 1):
                threading.Thread(
                    target=self._broadcast_send,
                    args=(self._broadcast_plan(),),
                    daemon=True,
                ).start()
            if orphaned:
                # Evicted from the view (false death / lost partition) and
                # the immediate rejoin in _on_update_network was lost:
                # retry every beat until a view contains us again.
                try:
                    self._send(coord, {"method": "JOIN_REQ", "addr": self.addr_s})
                except WireError:
                    pass
            # Deadline-based part re-homing must tick even for a solo node
            # (ring of one): it recovers work from wedged-but-alive peers
            # that are no longer in the view at all.
            if self.config.part_deadline_s > 0:
                self._recover_parts()
            # Parked results (at-least-once budget exhausted mid-partition)
            # get one re-offer per beat, off-thread.
            with self._lock:
                have_parked = bool(self._parked)
            if have_parked:
                threading.Thread(target=self._flush_parked, daemon=True).start()
            # SWIM beat (runs even solo/orphaned: suspicion expiry must
            # tick and a lone node's tick is a cheap no-probe).
            if self.gossip is not None:
                self._gossip_beat(term, epoch)
            pred, succ = self._ring()
            if succ is None:
                with self._lock:
                    self._last_hb = self._clock.now()
                continue
            try:
                self._send(
                    succ,
                    {
                        "method": "HEARTBEAT",
                        "from": self.addr_s,
                        "term": term,
                        "epoch": epoch,
                    },
                )
            except WireError:
                pass  # successor's own detector handles its death
            # Receiver-initiated stealing (``DHT_Node.py:246-248``): idle ->
            # ask my ring predecessor for a slice of a live search.
            if self.config.needwork and self.engine.busy_depth() == 0:
                try:
                    self._send(pred, {"method": "NEEDWORK", "addr": self.addr_s})
                except WireError:
                    pass
            limit = self.config.heartbeat_s * self.config.fail_factor
            with self._lock:
                expired = self._clock.now() - self._last_hb > limit
            if expired and pred is not None:
                self._on_peer_dead(pred)

    # -- message handling ----------------------------------------------------

    # Result/work-bearing one-shot methods and the field that identifies
    # the unit of work: duplicates (at-least-once redelivery) are dropped
    # here, before any handler runs, so a re-dispatch whose first copy DID
    # arrive executes once (duplicates_dropped counts the drops).
    _DEDUPE_KEYS = {
        "TASK": "uuid",
        "SOLUTION": "uuid",
        "SUBTASK": "part",
        "PART_RESULT": "part",
        # Cluster-cache fills are at-least-once (ClusterCache._put_loop
        # retries with the same uuid); a redelivered PUT is idempotent
        # anyway (deterministic solver), so the dedupe here exists to
        # keep puts_applied/insertions honest, not for correctness.
        "CACHE_PUT": "uuid",
    }

    @staticmethod
    def _addr_field(msg: dict, key: str) -> str:
        """Validated member-address field: membership handlers must never
        install non-address garbage into the view (a fuzzer's int joiner
        would poison ring math and every later dial)."""
        v = msg.get(key)
        if not isinstance(v, str) or ":" not in v:
            raise WireError(f"malformed {key!r} field: {v!r}")
        return v

    def _handle(self, msg: dict) -> Optional[dict]:
        """Dispatch one inbound message; returns the reply dict for
        request/reply methods (STATS_REQ), else None.  Raises on malformed
        input — the transport routes that to _log_bad_message."""
        method = msg["method"]
        dkey = self._DEDUPE_KEYS.get(method)
        if dkey is not None:
            uid = msg.get(dkey)
            if uid is not None and self._dedupe.seen((method, str(uid))):
                self._count_duplicate(method)
                return None
        if method == "JOIN_REQ":
            self._on_join_req(self._addr_field(msg, "addr"))
        elif method == "UPDATE_NETWORK":
            self._on_update_network(msg)
        elif method == "HEARTBEAT":
            self._on_heartbeat(msg)
        elif method == "NODE_FAILED":
            self._on_node_failed(
                self._addr_field(msg, "addr"),
                reporter_term=msg.get("term"),
                method="NODE_FAILED",
            )
        elif method == "LEAVE":
            # Same repair path, no suspicion (the member *chose* to go, so
            # no tombstone probing either) — and a leaver's intent is honored
            # whatever view version it held, unlike a failure *verdict*.
            self._on_node_failed(
                self._addr_field(msg, "addr"), suspected=False, method="LEAVE"
            )
        elif method == "TASK":
            self._on_task(msg)
        elif method == "SOLUTION":
            self._on_solution(msg)
        elif method == "CANCEL":
            self._on_cancel(msg["uuid"])
        elif method == "NEEDWORK":
            self._on_needwork(self._addr_field(msg, "addr"))
        elif method == "SUBTASK":
            self._on_subtask(msg)
        elif method == "PART_RESULT":
            self._on_part_result(msg)
        elif method == "PROGRESS":
            self._on_progress(msg)
        elif method == "PROBE":
            return self._on_probe(msg)
        elif method == "CACHE_GET":
            if self.dcache is None:
                return {"found": False, "entry": None}
            return self.dcache.handle_get(msg)
        elif method == "CACHE_PUT":
            if self.dcache is not None:
                self.dcache.handle_put(msg)
        elif method == "STATS_REQ":
            s = self.engine.stats()
            return {
                "method": "STATS_RES",
                "address": self.addr_s,
                "validations": s["validations"],
                "solved": s["solved"],
            }
        elif method == "METRICS_PULL":
            return self._on_metrics_pull(msg)
        else:
            _LOG.warning("[%s] unknown method %r", self.addr_s, method)
        return None

    def _count_duplicate(self, method: str) -> None:
        with self._lock:
            self.duplicates_dropped[method] = (
                self.duplicates_dropped.get(method, 0) + 1
            )
        _LOG.info("[%s] duplicate %s dropped", self.addr_s, method)

    def _on_metrics_pull(self, msg: dict) -> dict:
        """One member's half of ``GET /metrics?scope=cluster``: reply with
        the local metrics body plus our view version — the puller marks
        us ``stale`` when the versions disagree.  (term, epoch)-guarded
        like HEARTBEAT: a pull asserting a strictly older term is counted
        and gets our view reflected back (rate-limited) so a split-brain
        survivor aggregating its losing ring learns the winner — but the
        reply still carries honest data; staleness is the PULLER's flag
        to surface, not a reason to go dark."""
        term = msg.get("term")
        sender = msg.get("from")
        reflect_to = None
        with self._lock:
            if term is not None and int(term) < self.net_term:
                self.stale_views_rejected += 1
                if isinstance(sender, str) and ":" in sender:
                    reflect_to = self._reflect_ok_locked(sender)
            t, e = self.net_term, self.net_epoch
        if reflect_to:
            self._reflect_view(reflect_to)
        return {
            "method": "METRICS_RES",
            "address": self.addr_s,
            "term": t,
            "epoch": e,
            "metrics": self.metrics_view(),
        }

    def _on_heartbeat(self, msg: dict) -> None:
        """A heartbeat refreshes the failure detector — unless its sender
        holds a strictly older *term*: a pre-partition coordinator's ring
        mate must not suppress detection in the healed, promoted ring.  The
        stale sender gets our view reflected back (rate-limited) so it can
        demote/rejoin — membership-bearing messages all carry the
        (term, epoch) guard now, not just UPDATE_NETWORK."""
        term = msg.get("term")
        sender = msg.get("from")
        reflect_to = None
        with self._lock:
            if term is not None and int(term) < self.net_term:
                self.stale_views_rejected += 1
                if isinstance(sender, str) and ":" in sender:
                    reflect_to = self._reflect_ok_locked(sender)
            else:
                self._last_hb = self._clock.now()
        if reflect_to:
            self._reflect_view(reflect_to)

    # -- membership ----------------------------------------------------------
    def _broadcast_plan(self) -> tuple:
        """Snapshot the view payload and target list NOW, in the caller's
        thread.  The per-beat re-broadcast must carry the view as of the
        beat: a split-brain loser demoted between spawning its sender
        thread and the thread reading state would otherwise echo the
        winner's view instead of offering its stale one for rejection —
        the offer/reject/reflect exchange IS the heal channel."""
        now = self._clock.now()
        with self._lock:
            members = list(self.network)
            payload = {
                "method": "UPDATE_NETWORK",
                "network": members,
                "coordinator": self.coordinator,
                "term": self.net_term,
                "epoch": self.net_epoch,
                "from": self.addr_s,
            }
            # Tombstone probes: keep offering the winning view to members
            # we evicted on suspicion — a false-death or partition survivor
            # rejoins (or, if it is a rival coordinator with a HIGHER view,
            # rejects this as stale and reflects its view back, which
            # demotes us).  Expired tombstones stop being dialed.
            expired = [
                m
                for m, t in self._evicted.items()
                if now - t > self.config.tombstone_probe_s
            ]
            for m in expired:
                del self._evicted[m]
            probes = [m for m in self._evicted if m not in members]
        return payload, [m for m in members + probes if m != self.addr_s]

    def _broadcast_send(self, plan: tuple) -> None:
        payload, targets = plan
        for m in targets:
            try:
                self._send(m, payload)
            except WireError:
                pass  # its detector will notice soon enough

    def _broadcast_network(self) -> None:
        self._broadcast_send(self._broadcast_plan())

    def _on_join_req(self, joiner: str) -> None:
        if self.coordinator != self.addr_s:
            self._send(self.coordinator, {"method": "JOIN_REQ", "addr": joiner})
            return
        with self._lock:
            healed = self._evicted.pop(joiner, None) is not None
            if healed:
                # An evicted-but-alive member came back through the winner:
                # the observable end of a partition (or false death).
                self.partitions_healed += 1
            duplicate = joiner in self.network
            if not duplicate:
                self.network.append(joiner)
                self.net_epoch += 1
            self._last_hb = self._clock.now()
        if duplicate:
            # Idempotent replay: no epoch bump, no broadcast storm — the
            # per-beat view re-broadcast covers a joiner that missed ours.
            self._count_duplicate("JOIN_REQ")
            return
        self._dht_sync()
        self._broadcast_network()

    def _on_update_network(self, msg: dict) -> None:
        raw = msg["network"]
        if not isinstance(raw, list) or not all(
            isinstance(m, str) and ":" in m for m in raw
        ):
            raise WireError(f"malformed network field: {raw!r}")
        network = list(raw)
        coordinator = self._addr_field(msg, "coordinator")
        term, epoch = int(msg["term"]), int(msg["epoch"])
        sender = msg.get("from")
        rejoin = False
        reflect_to = None
        concede_to = None
        concede_payload = None
        gone: list = []
        with self._lock:
            if (term, epoch) <= (self.net_term, self.net_epoch):
                # Stale or duplicate view; ours is at least as new.  An
                # *equal* version is the steady-state per-beat re-broadcast;
                # a strictly older one is rejected loudly — and when it
                # comes from a rival coordinator (split-brain survivor
                # still broadcasting its losing view), our view is
                # reflected back so the loser can demote and rejoin.
                if (term, epoch) < (self.net_term, self.net_epoch):
                    self.stale_views_rejected += 1
                    if (
                        coordinator != self.coordinator
                        and isinstance(sender, str)
                        and ":" in sender
                    ):
                        reflect_to = self._reflect_ok_locked(sender)
                if reflect_to is None:
                    return
            else:
                if (
                    self.coordinator == self.addr_s
                    and coordinator != self.addr_s
                    and (self.net_term, self.net_epoch) > (0, 0)
                ):
                    # Split-brain resolution, losing side: someone holds a
                    # provably newer view in which we are not coordinator.
                    # Install it, stand down, and (below) rejoin if evicted
                    # — our in-flight work re-homes through the ordinary
                    # orphan paths against the new view.  A fresh node
                    # installing its anchor's first view is NOT a demotion
                    # (it was only ever coordinator of itself: (0,0) —
                    # a node that has issued no membership change).
                    self.demotions += 1
                    _LOG.warning(
                        "[%s] demoted: installing view (%d,%d) from %s "
                        "(ours was (%d,%d))",
                        self.addr_s, term, epoch, coordinator,
                        self.net_term, self.net_epoch,
                    )
                    # Concession: announce the superseded view to the
                    # winner as the last act of this coordinatorship.  The
                    # winner rejects it as stale, which leaves a durable
                    # record of the rivalry in ITS fault counters no matter
                    # which heal channel fired first (its tombstone probe
                    # teaching us, or our stale offer being reflected) —
                    # without this, a probe-first heal ends with neither
                    # side's stale_views_rejected showing a split-brain
                    # ever happened.
                    concede_to = coordinator
                    concede_payload = {
                        "method": "UPDATE_NETWORK",
                        "network": list(self.network),
                        "coordinator": self.coordinator,
                        "term": self.net_term,
                        "epoch": self.net_epoch,
                        "from": self.addr_s,
                    }
                    self._evicted.clear()  # no longer the membership authority
                self.network = network
                self.coordinator = coordinator
                self.net_term = term
                self.net_epoch = epoch
                self._last_hb = self._clock.now()
                # Evicted by a false death verdict (e.g. my heartbeats
                # starved): re-join through the coordinator rather than
                # orbiting alone.
                rejoin = self.addr_s not in network and not self._stop.is_set()
                # Only an INSTALLED view may drive re-execution — a ledger
                # scan against a rejected stale list would re-run jobs
                # whose members are perfectly alive in ours.
                gone = [
                    u
                    for u, e in self._ledger.items()
                    if e["member"] not in network
                ]
        if reflect_to:
            self._reflect_view(reflect_to)
            return
        if concede_to is not None:
            try:
                self._send(concede_to, concede_payload)
            except WireError:
                pass  # observability-only: the demotion itself is done
        self._dht_sync()
        for u in gone:
            self._reexecute(u)
        self._recover_parts()
        if rejoin:
            try:
                self._send(
                    coordinator, {"method": "JOIN_REQ", "addr": self.addr_s}
                )
            except WireError:
                pass  # retried every beat by _hb_loop while orphaned

    def _reflect_ok_locked(self, peer: str) -> Optional[str]:
        """Rate-limit stale-view reflections to one per peer per heartbeat
        (caller holds the lock); returns the peer when a reflection is due."""
        now = self._clock.now()
        if now < self._reflect_at.get(peer, 0.0):
            return None
        self._reflect_at[peer] = now + self.config.heartbeat_s
        self.stale_view_reflections += 1
        return peer

    def _reflect_view(self, peer: str) -> None:
        """Send our (newer) view to a peer that just asserted an older one —
        the anti-entropy half of split-brain healing."""
        with self._lock:
            payload = {
                "method": "UPDATE_NETWORK",
                "network": list(self.network),
                "coordinator": self.coordinator,
                "term": self.net_term,
                "epoch": self.net_epoch,
                "from": self.addr_s,
            }
        try:
            self._send(peer, payload)
        except WireError:
            pass

    def _on_node_failed(
        self,
        dead: str,
        suspected: bool = True,
        method: str = "NODE_FAILED",
        reporter_term=None,
    ) -> None:
        if dead == self.addr_s:
            # A frame naming US dead (forged, or a detector whose view is
            # hopelessly behind) must not make the node evict itself from
            # its own view; if the rest of the ring really thinks we died,
            # their next UPDATE_NETWORK triggers the rejoin path instead.
            _LOG.warning("[%s] ignoring %s naming this node", self.addr_s, method)
            return
        if self.coordinator == self.addr_s:
            with self._lock:
                if reporter_term is not None and int(reporter_term) < self.net_term:
                    # A death verdict formed under a superseded term: the
                    # reporter is behind a promotion (possibly ours); its
                    # suspicion predates the current ring and is void.
                    self.stale_views_rejected += 1
                    return
                if dead not in self.network:
                    # Already removed (duplicate report, replayed LEAVE):
                    # idempotent — no epoch bump, no broadcast storm.
                    self._count_duplicate_locked(method)
                    return
                self.network.remove(dead)
                self.net_epoch += 1
                if suspected:
                    # Keep probing: the "death" may be a partition, and the
                    # probe is how the survivor finds its way back.
                    self._evicted[dead] = self._clock.now()
                self._last_hb = self._clock.now()
                gone = [
                    u
                    for u, e in self._ledger.items()
                    if e["member"] not in self.network
                ]
            self._dht_sync()
            self._broadcast_network()
            for u in gone:
                self._reexecute(u)
            self._recover_parts()
        else:
            try:
                self._send(
                    self.coordinator,
                    {
                        "method": "NODE_FAILED",
                        "addr": dead,
                        "term": self.net_term,
                        "epoch": self.net_epoch,
                    },
                )
            except WireError:
                pass

    def _count_duplicate_locked(self, method: str) -> None:
        self.duplicates_dropped[method] = (
            self.duplicates_dropped.get(method, 0) + 1
        )

    def _on_peer_dead(self, dead: str) -> None:
        """My predecessor went silent (``check_neighbor`` analog, :158-209)."""
        with self._lock:
            if dead not in self.network:
                return
            if dead == self.coordinator:
                # I am the unique detector of the coordinator: self-promote
                # (``DHT_Node.py:191-193``).  A new term outranks every view
                # the dead coordinator issued, including epochs we missed.
                self.coordinator = self.addr_s
                self.net_term += 1
            self._last_hb = self._clock.now()
        self._on_node_failed(dead)

    # -- the DHT plane (cluster/dht/) ------------------------------
    def _dht_sync(self) -> None:
        """Reconcile gossip + ring with the authoritative (term,epoch)
        view.  Called after every installed membership change; the view
        advance doubles as the refutation channel for restarted members
        whose incarnation reset (membership.py reconcile note)."""
        if self.gossip is None:
            return
        with self._lock:
            members = list(self.network)
        self.gossip.reconcile(members)
        with self._ring_lock:
            want = set(members) | {self.addr_s}
            for m in self.ring.members():
                if m not in want:
                    self.ring.remove(m)
            for m in want:
                if m not in self.ring:
                    self.ring.add(m)

    def _ring_owner(self, digest: str) -> Optional[str]:
        """The cluster cache's owner_fn.  Runs on submit / device-loop /
        front-door threads — guarded by the ring's own high-ranked lock,
        never the node lock (frontdoor locks rank above cluster.node)."""
        if self.ring is None:
            return None
        with self._ring_lock:
            return self.ring.owner(digest)

    def _dht_request(self, peer: str, frame: dict, timeout: float) -> dict:
        """CACHE_GET request/reply (short deadline; a WireError is just
        a cache miss to the caller)."""
        return self._transport.request(wire.parse_addr(peer), frame, timeout)

    def _dht_send(self, peer: str, frame: dict) -> None:
        """CACHE_PUT egress: through the node's one egress seam so the
        fault plane, trace spans, and send-wall histogram all see it."""
        self._send(peer, frame)

    def _gossip_beat(self, term: int, epoch: int) -> None:
        """One SWIM beat: expire suspicions, probe one member with
        piggybacked state, merge the ack's piggyback.  O(1) traffic per
        beat regardless of ring size — the whole point."""
        g = self.gossip
        if g is None:
            return
        ctrl = brownout_mod.active()
        if ctrl is not None:
            # Self-report brownout on the piggyback: browning owners
            # decline cache-affine forwards at the REQUESTER, wire-free.
            g.set_brown(ctrl.stage() > 0)
        target, newly_dead = g.tick()
        for m in newly_dead:
            # Suspicion expired unrefuted: feed the existing eviction
            # machinery (coordinator evicts + tombstones; a non-
            # coordinator forwards NODE_FAILED with its term).
            self._on_node_failed(m)
        if target is None:
            return
        timeout = self.config.dht_probe_timeout_s or min(
            self.config.stats_timeout_s, self.config.heartbeat_s
        )
        payload = {
            "method": "PROBE",
            "from": self.addr_s,
            "term": term,
            "epoch": epoch,
            "updates": g.updates(),
        }
        try:
            reply = self._transport.request(
                wire.parse_addr(target), payload, timeout
            )
        except WireError:
            g.on_probe_fail(target)
            return
        g.on_ack(target)
        if isinstance(reply, dict):
            ups = reply.get("updates")
            if isinstance(ups, list):
                g.merge(ups)

    def _on_probe(self, msg: dict) -> dict:
        """PROBE handler: merge the sender's piggyback, answer with ours.
        (term,epoch)-guarded like HEARTBEAT — a probe asserting a stale
        term gets the view reflected back (rate-limited) instead of its
        gossip being trusted."""
        g = self.gossip
        if g is None:
            return {"method": "PROBE_ACK", "from": self.addr_s, "updates": []}
        term = msg.get("term")
        sender = msg.get("from")
        reflect_to = None
        with self._lock:
            if term is not None and int(term) < self.net_term:
                self.stale_views_rejected += 1
                if isinstance(sender, str) and ":" in sender:
                    reflect_to = self._reflect_ok_locked(sender)
        if reflect_to:
            self._reflect_view(reflect_to)
        elif isinstance(msg.get("updates"), list):
            g.merge(msg["updates"])
        return {"method": "PROBE_ACK", "from": self.addr_s, "updates": g.updates()}

    def _affinity_owner(self, g: np.ndarray) -> Optional[str]:
        """Cache-affine placement for submit(): the digest owner when it
        is gossip-healthy (ALIVE, not browning), else None (fall back to
        least-outstanding).  Only consulted when this node runs a front
        door — without one there is no cache to be affine to."""
        try:
            geom = geometry_for_size(g.shape[0])
            cf = fd_canon.canonicalize(g, geom)
        except Exception:
            return None  # malformed / uncanonicalizable: ordinary path
        if cf is None:
            return None
        owner = self._ring_owner(cf.digest)
        if owner is None:
            return None
        if owner != self.addr_s and (
            self.gossip is None or not self.gossip.is_healthy(owner)
        ):
            with self._lock:
                self.affinity_declined += 1
            return None
        with self._lock:
            self.affinity_routed += 1
        return owner

    def dht_view(self, owner_of: Optional[str] = None) -> dict:
        """``GET /network?scope=dht``: the gossip view (states,
        incarnations, brownout flags), ring ownership summary, and this
        node's shard counters; ``owner_of`` adds a digest's owner and
        replica set."""
        with self._lock:
            coord = self.coordinator
            view = [self.net_term, self.net_epoch]
        with self._ring_lock:
            ring = self.ring.summary()
            owner = self.ring.owner(owner_of) if owner_of else None
            replicas = self.ring.replicas(owner_of, 2) if owner_of else None
        out = {
            "address": self.addr_s,
            "coordinator": coord,
            "view": view,
            "members": self.gossip.view(),
            "ring": ring,
            "cluster_cache": self.dcache.metrics(),
        }
        if owner_of:
            out["owner"] = {
                "digest": owner_of,
                "owner": owner,
                "replicas": replicas,
            }
        return out

    # -- local execution (engine + shed parts) -------------------------------
    def _start_exec(
        self,
        on_final: Callable[[dict], None],
        grid: Optional[np.ndarray] = None,
        roots: Optional[np.ndarray] = None,
        geom=None,
        job_uuid: Optional[str] = None,
        base_nodes: int = 0,
        config=None,
        saturation: str = "fallback",
        latency: Optional[bool] = None,
    ) -> _Exec:
        """Run a job (or subtree part) on the local engine under an _Exec
        aggregate; ``on_final`` fires exactly once with the merged result.

        ``saturation`` is forwarded to ``engine.submit`` for grid jobs:
        client-facing dispatches (the HTTP ``/solve`` path through
        :meth:`submit`) pass ``'reject'`` so a saturated resident flight
        backpressures with 429 + Retry-After; internal re-dispatches
        (peer TASKs, failure re-execution, shed parts) keep the quiet
        static-flight fallback — work already accepted by the cluster must
        never bounce."""
        if roots is not None:
            ej = self.engine.submit_roots(
                roots, geom, job_uuid=job_uuid, config=config
            )
        else:
            ej = self.engine.submit(
                grid, job_uuid=job_uuid, config=config, saturation=saturation,
                latency=latency,
            )

        def wrapped(result: dict) -> None:
            with self._lock:
                self._execs.pop(ej.uuid, None)
            on_final(result)

        ex = _Exec(self, ej, wrapped, base_nodes=base_nodes)
        with self._lock:
            # A job the front door answered inside submit() has finalized
            # (and run ``wrapped``) already: registering it now would keep
            # a finished exec forever.
            if not ex.finalized:
                self._execs[ej.uuid] = ex
        return ex

    def _apply_result(self, handle: Job, r: dict) -> None:
        handle.solved = bool(r["solved"])
        handle.unsat = bool(r["unsat"])
        handle.nodes = int(r["nodes"])
        handle.cancelled = bool(r["cancelled"])
        handle.error = r["error"]
        if r["solution"] is not None:
            handle.solution = np.asarray(r["solution"], dtype=np.int32)
        handle.done.set()

    def _send_cancel(self, peer: str, job_uuid: str) -> None:
        if peer == self.addr_s:
            self._on_cancel(job_uuid)
            return
        try:
            self._send(peer, {"method": "CANCEL", "uuid": job_uuid})
        except WireError:
            pass

    def _on_cancel(self, job_uuid: str) -> None:
        self.engine.cancel(job_uuid)
        with self._lock:
            parts = [p for p, root in self._parts.items() if root == job_uuid]
        for p in parts:
            self.engine.cancel(p)

    # -- job dispatch --------------------------------------------------------
    def submit(self, grid, config=None, latency=None, job_uuid=None) -> Job:
        """Dispatch one job to the least-loaded member; ``config`` optionally
        overrides the solver strategy for this job (rides the TASK).

        ``latency`` opts a LOCAL dispatch into the engine's megastep tier
        (serving/megastep.py).  The flag deliberately does not ride the
        wire: latency-mode is a node-local serving decision — a member
        serves remote TASKs by its own engine's ``latency_mode`` default.

        ``job_uuid`` is the OPTIONAL client-supplied idempotency key:
        a resubmit of an in-flight or resolved job returns the
        existing handle — same verdict, no double solve, no double
        stats — and the uuid keys the WAL entry, so a client retrying a
        504 after a crash-restart dedupes against the replayed job."""
        g = np.asarray(grid, dtype=np.int32)
        if g.ndim != 2 or g.shape[0] != g.shape[1]:
            raise ValueError(f"grid must be square, got {g.shape}")
        if job_uuid is not None:
            with self._lock:
                prev = self._client_jobs.get(job_uuid)
                if (
                    prev is not None
                    and prev.done.is_set()
                    and prev.error is not None
                ):
                    # Infra-error terminal: evict so the retry runs fresh.
                    self._client_jobs.pop(job_uuid, None)
                    prev = None
            if prev is not None:
                return prev
        member = None
        if (
            self.dcache is not None
            and self.config.dht_affinity
            and getattr(self.engine, "frontdoor", None) is not None
        ):
            # Cache-affine routing: a cacheable board goes to
            # its canonical digest's ring owner — where the cluster-cache
            # entry lives or will live — when that owner is gossip-ALIVE
            # and not browning.  Unhealthy/browning owner: the requester
            # keeps the job (brownout-aware decline, solved locally).
            member = self._affinity_owner(g)
        if member is None:
            member = self._pick_member()
        if member == self.addr_s:
            # Client-facing dispatch: a saturated local resident flight
            # rejects (EngineSaturated -> HTTP 429 + Retry-After) instead
            # of quietly growing an unbounded queue.  Remote dispatch has
            # no cross-wire backpressure: the TASK lands in the member's
            # static path if its resident flight is full.
            handle = self._submit_local(
                g, config=config, saturation="reject", latency=latency,
                job_uuid=job_uuid,
            )
        else:
            handle = self._submit_remote(
                g, member, config=config, job_uuid=job_uuid
            )
        if job_uuid is not None:
            with self._lock:
                self._client_jobs[job_uuid] = handle
                while len(self._client_jobs) > 8192:
                    self._client_jobs.pop(next(iter(self._client_jobs)))
        return handle

    def race(self, grid, configs, timeout: Optional[float] = None):
        """Cluster-level portfolio: one racer per config, spread over the
        least-loaded members; the first verdict cancels every other racer
        (local purge + CANCEL to its executing member and any shed parts).

        The fleet analog of ``serving/portfolio.race`` — where the reference
        could only ever run its one recursive strategy per ring, a job here
        races heterogeneous strategies across *machines*, SOLUTION-style
        first-win cancellation included (the reference's ``DHT_Node.py:
        348-387``).
        """
        from distributed_sudoku_solver_tpu_torch.serving.portfolio import race_jobs

        if not configs:
            raise ValueError("portfolio needs at least one config")
        # Clock starts before the (blocking, wire-bound) submissions so the
        # caller's timeout bounds the whole race, not just the wait.  This
        # is deliberately the WALL clock, not self._clock: `start` must be
        # a reading of race_jobs' own (default, real-monotonic) clock —
        # racer engines and their done-events live outside the virtual
        # clock even under simnet, so a virtual `start` would corrupt the
        # deadline math.
        start = time.monotonic()  # clockck: allow(race deadline shares race_jobs' wall clock; the node clock may be virtual while racer engines are wall-bound)
        jobs = []
        try:
            for cfg in configs:
                jobs.append(self.submit(grid, config=cfg))
        except BaseException:
            for j in jobs:  # don't strand racers already placed on members
                self.cancel(j.uuid)
            raise
        res = race_jobs(jobs, cancel=self.cancel, timeout=timeout, start=start)
        if res.winner is not None:
            res.strategy = configs[res.winner_index].branch
        return res

    def cancel(self, job_uuid: str) -> None:
        self._on_cancel(job_uuid)
        with self._lock:
            entry = self._ledger.get(job_uuid)
        if entry is not None:
            self._send_cancel(entry["member"], job_uuid)

    def _pick_member(self) -> str:
        """Least-outstanding member; ties broken round-robin (load balance)."""
        with self._lock:
            members = list(self.network)
            if len(members) == 1:
                return self.addr_s
            self._rr += 1
            counts = [
                (self._outstanding.get(m, 0), (i + self._rr) % len(members), m)
                for i, m in enumerate(members)
            ]
        return min(counts)[2]

    def _track(self, member: str, delta: int) -> None:
        with self._lock:
            self._outstanding[member] = self._outstanding.get(member, 0) + delta

    def _submit_local(
        self, g: np.ndarray, config=None, saturation: str = "fallback",
        latency=None, job_uuid=None,
    ) -> Job:
        geom = geometry_for_size(g.shape[0])
        # A client-supplied uuid IS the job uuid end to end: it keys the
        # engine's resubmit registry and the WAL entry, so dedupe and
        # crash replay line up with what the client will retry with.
        ju = job_uuid if job_uuid is not None else str(uuid_mod.uuid4())
        handle = Job(uuid=ju, grid=g, geom=geom)
        self._track(self.addr_s, +1)

        def fin(r: dict) -> None:
            self._track(self.addr_s, -1)
            self._apply_result(handle, r)

        try:
            self._start_exec(
                fin, grid=g, job_uuid=ju, config=config, saturation=saturation,
                latency=latency,
            )
        except BaseException:
            # submit can raise (e.g. "engine stopped"); un-count or the +1
            # leaks and permanently skews least-outstanding placement.
            self._track(self.addr_s, -1)
            raise
        return handle

    def _submit_remote(
        self, g: np.ndarray, member: str, config=None, job_uuid=None
    ) -> Job:
        geom = geometry_for_size(g.shape[0])
        if job_uuid is not None:
            # A client-supplied uuid IS the job uuid end to end (dedupe
            # registry, WAL entry, TASK frame) — same contract as
            # _submit_local.
            ju = job_uuid
        else:
            # clockck: allow(uuid entropy, not a timing decision — ns-unique per node; virtualizing it would COLLIDE ids under simnet's frozen clock)
            ju = f"{self.addr_s}/{time.monotonic_ns()}"
        job = Job(uuid=ju, grid=g, geom=geom)
        cfg_dict = dataclasses.asdict(config) if config is not None else None
        with self._lock:
            self._ledger[job.uuid] = {
                "grid": g,
                "member": member,
                "job": job,
                "config": cfg_dict,
            }
        self._track(member, +1)
        jr = self.engine._journal()
        if jr is not None:
            # Remote dispatch never touches the local engine's submit
            # seam, so the WAL promise is kept HERE: the ORIGIN owns the
            # client's job, and an origin crash mid-dispatch must replay
            # it (the member's own journal, if any, only covers the
            # member's copy).  Discharged in _on_solution.
            jr.record_accepted(job.uuid, grid=g, config=cfg_dict)
        payload = {
            "method": "TASK",
            "uuid": job.uuid,
            "grid": g.tolist(),
            "origin": self.addr_s,
            "config": cfg_dict,
        }
        if trace.active() is not None:
            # Trace context rides the frame: the worker's spans land under
            # this uuid and ship back on the SOLUTION (obs/trace.py).
            payload["trace"] = job.uuid
        try:
            self._send(member, payload)
        except WireError:
            # Reliable transport tells us delivery failed -> immediate local
            # re-execution instead of the reference's silent loss (§2.5 #7).
            self._reexecute(job.uuid)
        return job

    def _reexecute(self, job_uuid: str) -> None:
        """Re-run a job whose worker left the network view.

        If the worker streamed PROGRESS snapshots, resume from its surviving
        subtree roots (skipping everything already searched) and carry its
        nodes counter; otherwise restart from the clue grid, like the
        reference's ledger re-queue (``DHT_Node.py:201-209``).
        """
        with self._lock:
            entry = self._ledger.pop(job_uuid, None)
            if entry is not None:
                self.reexecuted += 1
                self.resumed += entry.get("rows") is not None
        if entry is None:
            return
        self._track(entry["member"], -1)
        handle: Job = entry["job"]
        self._track(self.addr_s, +1)
        rec = trace.active()
        if rec is not None:
            rec.event(
                str(job_uuid), "recovery.reexecute", "cluster.recv",
                node=self.addr_s, member=entry["member"],
                resumed=entry.get("rows") is not None,
            )

        def fin(r: dict) -> None:
            self._track(self.addr_s, -1)
            self._apply_result(handle, r)

        rows_packed = entry.get("rows")
        try:
            if rows_packed is not None:
                rows = unpack_rows(rows_packed)
                geom = geometry_for_size(rows.shape[1])
                self._start_exec(
                    fin,
                    roots=rows,
                    geom=geom,
                    job_uuid=job_uuid,
                    base_nodes=int(entry.get("nodes_done", 0)),
                    config=_config_from_dict(entry.get("config")),
                )
            else:
                self._start_exec(
                    fin,
                    grid=entry["grid"],
                    job_uuid=job_uuid,
                    config=_config_from_dict(entry.get("config")),
                )
        except Exception as e:
            # Same counter leak as _submit_local, but swallow instead of
            # re-raise: _reexecute runs on recovery paths inside _hb_loop
            # (via _on_peer_dead -> _on_node_failed) and _on_update_network,
            # where a raise would kill the heartbeat thread and stop failure
            # detection entirely.  Fail the handle so waiters unblock.
            self._track(self.addr_s, -1)
            handle.error = f"re-execution failed: {e}"
            job_log(_LOG, job_uuid).error(
                "[%s] %s", self.addr_s, handle.error
            )
            handle.done.set()

    def _on_task(self, msg: dict) -> None:
        grid = np.asarray(msg["grid"], dtype=np.int32)
        origin = msg["origin"]
        ju = msg["uuid"]
        rec = trace.active()
        if rec is not None:
            tid = msg.get("trace")
            if isinstance(tid, str) and tid != ju:
                rec.link(ju, tid)
            rec.event(str(ju), "recv.TASK", "cluster.recv", node=self.addr_s,
                      origin=origin)

        def fin(r: dict) -> None:
            payload = {
                "method": "SOLUTION",
                "uuid": ju,
                "solved": r["solved"],
                "unsat": r["unsat"],
                "cancelled": r["cancelled"],
                "nodes": r["nodes"],
                "error": r["error"],
                "solution": r["solution"].tolist()
                if r["solution"] is not None
                else None,
            }
            rec_f = trace.active()
            if rec_f is not None:
                # Ship this node's spans for the trace back with the
                # result (bounded): the origin stitches them into ONE
                # trace for GET /trace/<uuid>.
                payload["trace"] = rec_f.resolve(ju)
                payload["spans"] = rec_f.export(ju)
            # At-least-once: retried on link faults (the origin dedupes by
            # uuid); if every attempt fails the origin died and its
            # successor's repair already re-executed the job.
            self._send_result(origin, payload)

        ex = self._start_exec(
            fin, grid=grid, job_uuid=ju, config=_config_from_dict(msg.get("config"))
        )
        with self._lock:
            self.tasks_run += 1
        if self.config.progress_interval_s > 0:
            threading.Thread(
                target=self._progress_loop,
                args=(ex, origin),
                daemon=True,
                name=f"progress-{ju[:8]}",
            ).start()

    def _progress_loop(self, ex: _Exec, origin: str) -> None:
        """Stream the job's surviving subtree roots to its origin so a death
        here resumes mid-subtree there (SURVEY.md §5.4's promise)."""
        while not self._stop.is_set() and not ex.finalized:
            self._clock.sleep(self.config.progress_interval_s)
            if ex.finalized:
                return
            if self.engine.job_is_resident(ex.uuid):
                # Resident-flight jobs (serving/scheduler.py) have no
                # snapshot surface: a death here resumes from the root via
                # the origin's ledger copy.  Degrade VISIBLY (the same
                # counter the over-cap snapshot path uses) instead of
                # polling a permanent None every interval.
                with self._lock:
                    self.progress_resident += 1
                return
            snap = self.engine.snapshot_rows(ex.uuid, timeout=2.0)
            if snap is None:
                continue
            rows, nodes, shed_parts, job_cfg = snap
            # Coverage gate: sheds and snapshots are serviced by the same
            # device-loop thread, so shed_parts==0 *at the cut* proves these
            # rows cover the job's entire remaining space.  Once anything
            # has been shed, stop streaming — the origin keeps the last
            # full-coverage snapshot (checking ex.parts here instead would
            # race the shed that _on_needwork runs before add_part).
            if shed_parts > 0:
                return
            if rows.shape[0] > self.config.progress_max_rows:
                # Too wide to ship — the origin keeps whatever snapshot it
                # last got (possibly none), so a death here re-executes from
                # the root.  Degrading VISIBLY: count + warn once per job
                # (the loop retries every interval; a per-iteration log
                # would spam a long search into the megabytes).
                if not ex.progress_skip_warned:
                    ex.progress_skip_warned = True
                    _LOG.warning(
                        "[cluster] progress snapshot for %s skipped: %d rows "
                        "> progress_max_rows=%d — resume degrades to root "
                        "re-execution (progress_skipped counter on /metrics)",
                        ex.uuid[:8], rows.shape[0], self.config.progress_max_rows,
                    )
                with self._lock:  # one _progress_loop thread PER JOB writes
                    self.progress_skipped += 1
                continue
            try:
                self._send(
                    origin,
                    {
                        "method": "PROGRESS",
                        "uuid": ex.uuid,
                        "rows": pack_rows(rows),
                        "nodes": int(nodes) + ex.base_nodes,
                        "config": job_cfg,
                    },
                )
            except WireError:
                continue  # transient link fault or origin death: keep trying
                # each interval — a PROGRESS is a pure refinement, and if the
                # origin really died the repair path reassigns regardless.

    def _on_progress(self, msg: dict) -> None:
        with self._lock:
            entry = self._ledger.get(msg["uuid"])
            if entry is not None:
                entry["rows"] = msg["rows"]
                entry["nodes_done"] = int(msg["nodes"])
                entry["config"] = msg.get("config")

    # -- mid-job offload (NEEDWORK -> SUBTASK -> PART_RESULT) ----------------
    def _on_needwork(self, requester: str) -> None:
        if requester == self.addr_s:
            return
        shed = self.engine.shed_work(k=self.config.shed_k, timeout=2.0)
        if shed is None:
            return  # nothing worth splitting (reference: no task, no range > 1)
        root_uuid, rows, job_cfg = shed
        with self._lock:
            ex = self._execs.get(root_uuid)
        # clockck: allow(uuid entropy, not a timing decision — ns-unique per node; virtualizing it would COLLIDE ids under simnet's frozen clock)
        part_uuid = f"{root_uuid}#p{time.monotonic_ns()}"
        rows_packed = pack_rows(rows)
        if ex is None or not ex.add_part(part_uuid, requester, rows_packed, job_cfg):
            return  # job resolved while we were shedding; rows are moot
        payload = {
            "method": "SUBTASK",
            "part": part_uuid,
            "root": root_uuid,
            "rows": rows_packed,
            "config": job_cfg,  # the part searches under the job's config
            "report_to": self.addr_s,
        }
        rec = trace.active()
        if rec is not None:
            # Trace context: the part's spans on the peer land under the
            # ROOT job's trace, not the derived part uuid — and the SAME
            # link is recorded HERE, on the shedder, so the part spans the
            # peer ships back in PART_RESULT (trace = part uuid) resolve
            # into the root on THIS recorder too (per-process recorders:
            # the peer's links never reach us).
            trace_id = rec.resolve(root_uuid)
            rec.link(part_uuid, trace_id)
            payload["trace"] = trace_id
        try:
            self._send(requester, payload)
            with self._lock:
                self.subtasks_sent += 1
        except WireError:
            # Requester vanished between NEEDWORK and now: run the part
            # ourselves so the shed subtrees are never lost.  Mark it local
            # first, or the requester's eviction from the view would make
            # _recover_parts re-enter the same part uuid a second time.
            ex.mark_local(part_uuid)
            self._on_subtask(payload)

    def _on_subtask(self, msg: dict) -> None:
        rows = unpack_rows(msg["rows"])
        part_uuid = msg["part"]
        root_uuid = msg["root"]
        report_to = msg["report_to"]
        geom = geometry_for_size(rows.shape[1])
        rec = trace.active()
        if rec is not None:
            tid = msg.get("trace")
            rec.link(
                str(part_uuid),
                tid if isinstance(tid, str) else str(root_uuid),
            )
            rec.event(
                str(part_uuid), "recv.SUBTASK", "cluster.recv",
                node=self.addr_s, rows=rows.shape[0],
            )
        with self._lock:
            self._parts[part_uuid] = root_uuid
            self.subtasks_run += 1

        def fin(r: dict) -> None:
            with self._lock:
                self._parts.pop(part_uuid, None)
            payload = {
                "method": "PART_RESULT",
                "part": part_uuid,
                "root": root_uuid,
                "solved": r["solved"],
                "unsat": r["unsat"],
                "nodes": r["nodes"],
                "error": r.get("error"),
                "solution": r["solution"].tolist()
                if r["solution"] is not None
                else None,
            }
            rec_f = trace.active()
            if rec_f is not None:
                payload["trace"] = rec_f.resolve(str(part_uuid))
                payload["spans"] = rec_f.export(str(part_uuid))
            if report_to == self.addr_s:
                # Tag self-reported results: a no-verdict error from a LOCAL
                # execution is terminal for the part (last resort failed),
                # where the same error from a remote executor triggers local
                # re-entry — on_part_result branches on this.
                payload["local"] = True
                self._on_part_result(payload)
                return
            # At-least-once: retried on link faults (the shedder dedupes by
            # part uuid); if every attempt fails the shedder died and the
            # origin's repair path re-covers the subtree.
            self._send_result(report_to, payload)

        self._start_exec(
            fin,
            roots=rows,
            geom=geom,
            job_uuid=part_uuid,
            config=_config_from_dict(msg.get("config")),
        )

    def _recover_parts(self) -> None:
        """Re-enter shed SUBTASK parts whose executing peer left the network
        view (or blew the optional part deadline).

        The rows were retained at shed time (:meth:`_Exec.add_part`), so the
        lost subtree re-runs locally under the same part uuid — mirroring the
        WireError fallback in :meth:`_on_needwork`.  Without this, the root
        _Exec waits forever on a dead part: the job never finalizes on the
        exhaustion path, and a solution in the lost subtree is never found
        (ADVICE r2 #1)."""
        with self._lock:
            execs = list(self._execs.values())
            live = set(self.network)
        for ex in execs:
            for part_uuid, rows_packed, cfg in ex.take_orphaned(
                live, self.config.part_deadline_s
            ):
                self._reenter_part(ex, part_uuid, rows_packed, cfg)

    def _reenter_part(self, ex: "_Exec", part_uuid: str, rows_packed, cfg) -> None:
        """Run a previously-shed part locally (recovery: its executor died,
        blew the deadline, or reported a no-verdict failure).  The caller
        must have marked the part re-homed; a synchronous re-entry failure
        clears the flag so a later recovery pass retries — and never kills
        the caller (a raise in _hb_loop would stop heartbeating entirely)."""
        try:
            self._on_subtask(
                {
                    "part": part_uuid,
                    "root": ex.uuid,
                    "rows": rows_packed,
                    "config": cfg,
                    "report_to": self.addr_s,
                }
            )
        except Exception as e:  # noqa: BLE001 - e.g. our own engine stopping
            ex.unmark_rehomed(part_uuid)
            if not self._stop.is_set():
                job_log(_LOG, part_uuid).error(
                    "[%s] part re-entry failed: %r [%s]",
                    self.addr_s, e, faults.classify(e),
                )
        else:
            with self._lock:
                self.rehomed_parts += 1
            rec = trace.active()
            if rec is not None:
                rec.event(
                    str(part_uuid), "recovery.rehome", "cluster.recv",
                    node=self.addr_s,
                )

    def _on_part_result(self, msg: dict) -> None:
        rec = trace.active()
        if rec is not None:
            part, root = msg.get("part"), msg.get("root")
            if part is not None and root is not None:
                # Defensive re-link (a restarted shedder's in-memory link
                # table is gone): the ingested part spans must resolve
                # into the root trace on this recorder.
                rec.link(str(part), rec.resolve(str(root)))
            rec.ingest(msg.get("spans"))
            if part is not None:
                rec.event(
                    str(part), "recv.PART_RESULT", "cluster.recv",
                    node=self.addr_s,
                )
        with self._lock:
            ex = self._execs.get(msg["root"])
        if ex is not None:
            ex.on_part_result(msg["part"], msg)

    def _on_solution(self, msg: dict) -> None:
        rec = trace.active()
        if rec is not None:
            rec.ingest(msg.get("spans"))
            if msg.get("uuid") is not None:
                rec.event(
                    str(msg["uuid"]), "recv.SOLUTION", "cluster.recv",
                    node=self.addr_s,
                )
        if (
            msg.get("error")
            and not msg.get("solved")
            and not msg.get("unsat")
            and not msg.get("cancelled")
        ):
            # A FAILED remote execution, not a verdict: the member's engine
            # drained the job during shutdown (a kill/stop racing the
            # dispatch), or its flight errored.  Such a result reaches us
            # BEFORE failure detection does, so without this filter it
            # would pop the ledger and finalize the client's job unsolved
            # while the death-repair re-execution path never gets its
            # chance.  Found by the round-4 device-backed churn soak (one
            # lost job in 2 h of churn; the oracle-backed lane's instant
            # solves could not hit the window).  Re-execute from the ledger
            # immediately — faster than waiting for the heartbeat deadline.
            # Since round 9 the re-dispatch decision uses the same
            # classifier as the engine's own recovery (serving/faults.py):
            # a TRANSIENT remote failure (shutdown race, preemption,
            # injected wire fault — and a remote retry-budget exhaustion,
            # whose "retry budget exhausted...: <transient fault>" text
            # classifies transient ON PURPOSE: the remote's storm may be
            # node-local, so one local re-execution is a fair last try)
            # re-executes from the ledger; a PERMANENT one (bad config,
            # poisoned job — an error retrying cannot cure) finalizes the
            # client's job with that error instead of burning a local
            # re-execution that must fail identically.
            if faults.classify_message(msg.get("error")) == faults.TRANSIENT:
                with self._lock:
                    known = msg["uuid"] in self._ledger
                if known:
                    self._reexecute(msg["uuid"])
                return
        with self._lock:
            entry = self._ledger.pop(msg["uuid"], None)
        if entry is None:
            return  # already re-executed or cancelled
        self._track(entry["member"], -1)
        handle: Job = entry["job"]
        handle.solved = bool(msg["solved"])
        handle.unsat = bool(msg["unsat"])
        handle.cancelled = bool(msg.get("cancelled", False))
        handle.nodes = int(msg["nodes"])
        handle.error = msg.get("error")
        if msg["solution"] is not None:
            handle.solution = np.asarray(msg["solution"], dtype=np.int32)
        if handle.error is None:
            # Real remote verdict: discharge the origin's WAL entry
            # (permanent remote errors stay accepted-only on purpose — a
            # restart replays them, the journal's at-least-once contract).
            jr = self.engine._journal()
            if jr is not None:
                jr.record_resolved(
                    handle.uuid,
                    {
                        "solved": bool(handle.solved),
                        "unsat": bool(handle.unsat),
                        "cancelled": bool(handle.cancelled),
                        "nodes": int(handle.nodes),
                    },
                )
        handle.done.set()

    # -- views (HTTP layer) --------------------------------------------------
    def stats_view(self) -> dict:
        """Reference `/stats` shape (``DHT_Node.py:573-586``), sleep-free.

        Per-peer requests run in parallel with individual timeouts, so a
        degraded cluster costs one timeout, not O(N) serial timeouts."""
        s = self.engine.stats()
        nodes = [{"address": self.addr_s, "validations": s["validations"]}]
        total_v, total_s = s["validations"], s["solved"]
        with self._lock:
            peers = [m for m in self.network if m != self.addr_s]
        results = wire.fanout_requests(
            self._transport, peers, {"method": "STATS_REQ"},
            self.config.stats_timeout_s,
        )
        for m, res in zip(peers, results):
            if res is None:
                nodes.append({"address": m, "validations": None})
            else:
                nodes.append(
                    {"address": res["address"], "validations": res["validations"]}
                )
                total_v += res["validations"]
                total_s += res["solved"]
        return {"all": {"solved": total_s, "validations": total_v}, "nodes": nodes}

    def metrics_view(self) -> dict:
        """Engine metrics + cluster-runtime counters (GET /metrics superset):
        membership/view version, dispatch ledger, mid-job offload traffic,
        and live local executions — the observability the reference's
        print-trace never had (SURVEY.md §5.5)."""
        body = self.engine.metrics()
        # The node's own mergeable histograms (wire send/ack walls) join
        # the engine's in one flat "hist" section, so cluster aggregation
        # sees every phase through a single key space.
        mine = {k: h.to_dict() for k, h in self._hist.items() if len(h)}
        if mine:
            body["hist"] = {**body.get("hist", {}), **mine}
        with self._lock:
            body["cluster"] = {
                "address": self.addr_s,
                "coordinator": self.coordinator,
                "members": len(self.network),
                "view": [self.net_term, self.net_epoch],
                "ledger_outstanding": len(self._ledger),
                "execs_running": len(self._execs),
                "parts_running": len(self._parts),
                "subtasks_sent": self.subtasks_sent,
                "subtasks_run": self.subtasks_run,
                # PROGRESS snapshots dropped for exceeding progress_max_rows:
                # nonzero means some jobs here run with degraded (root-only)
                # resume — VERDICT r5 missing #3 made visible.
                "progress_skipped": self.progress_skipped,
                # Jobs served resident (continuous batching) run without
                # progress streaming; slot occupancy / admission waits /
                # rejects ride the engine body's "resident" section.
                "progress_resident": self.progress_resident,
                "tasks_run": self.tasks_run,
                "reexecuted": self.reexecuted,
                "resumed": self.resumed,
                # The cluster fault plane (round 10): what at-least-once
                # delivery and membership versioning actually absorbed.
                # duplicates_dropped — per-method redeliveries executed 0
                # extra times; stale_views_rejected — membership assertions
                # from superseded (term, epoch) views; stale_view_
                # reflections — anti-entropy replies that teach a
                # split-brain loser the winning view; partitions_healed —
                # evicted-but-alive members re-admitted (coordinator side);
                # demotions — rival coordinators that stood down (loser
                # side); rehomed_parts — shed parts re-entered locally
                # after executor death/deadline.
                # results_parked / results_delivered_late — result sends
                # whose at-least-once budget exhausted mid-partition,
                # parked and re-offered per beat until the link healed.
                "faults": {
                    "duplicates_dropped": dict(self.duplicates_dropped),
                    "stale_views_rejected": self.stale_views_rejected,
                    "stale_view_reflections": self.stale_view_reflections,
                    "partitions_healed": self.partitions_healed,
                    "demotions": self.demotions,
                    "rehomed_parts": self.rehomed_parts,
                    "results_parked": self.results_parked,
                    "results_delivered_late": self.results_delivered_late,
                },
                # Cluster-scope aggregation health (round 12): pulls =
                # peer METRICS_PULL requests issued, merges = rollups
                # computed, unreachable_peers = peers a pull could not
                # reach (each one also logged via obs/logctx).
                "agg": {
                    "pulls": self.agg_pulls,
                    "merges": self.agg_merges,
                    "unreachable_peers": self.agg_unreachable,
                },
            }
        if self.gossip is not None:
            # The DHT plane: gossip liveness counters, ring
            # shape, the node's cluster-cache shard, and cache-affine
            # routing decisions.  Rolled up by obs/agg._merge_dht and
            # rendered as dsst_dht_* prometheus families.
            with self._ring_lock:
                ring_members = len(self.ring)
            with self._lock:
                affinity = {
                    "routed": self.affinity_routed,
                    "declined": self.affinity_declined,
                }
            body["dht"] = {
                "gossip": self.gossip.metrics(),
                "ring": {
                    "members": ring_members,
                    "vnodes": self.config.dht_vnodes,
                },
                "cluster_cache": self.dcache.metrics(),
                "affinity": affinity,
            }
        return body

    def cluster_metrics_view(self, sample: int = 0) -> dict:
        """``GET /metrics?scope=cluster``: fan a METRICS_PULL over the
        current view (bounded, per-peer ``stats_timeout_s`` deadlines —
        the handler thread never hangs on a partitioned member) and merge
        the reachable members' bodies into a rollup (``obs/agg.py``:
        histograms vector-add, whitelisted counters sum, floors min).

        Degrades honestly: an unreachable peer is flagged
        ``unreachable`` (and logged with the peer identified), a peer
        whose (term, epoch) disagrees with ours is flagged ``stale`` —
        its numbers still merge (they are real samples), but the reader
        knows the membership pictures differ.  Any member can serve
        this; the fan-out runs over the caller's own view.

        ``sample`` > 0 caps the pull at that many peers for large rings
        (``GET /metrics?scope=cluster&sample=N``): an evenly spaced,
        DETERMINISTIC subset — no RNG, so repeated scrapes and the
        simnet lane pull the same members — with the rollup flagged
        ``sampled`` and ``members_total`` carrying the true ring size."""
        with self._lock:
            peers = [m for m in self.network if m != self.addr_s]
            view = (self.net_term, self.net_epoch)
            coordinator = self.coordinator
        members_total = len(peers) + 1
        sampled = bool(sample) and len(peers) > sample
        if sampled:
            stride = len(peers) / sample
            peers = [peers[int(i * stride)] for i in range(sample)]
        payload = {
            "method": "METRICS_PULL",
            "from": self.addr_s,
            "term": view[0],
            "epoch": view[1],
        }
        results = wire.fanout_requests(
            self._transport, peers, payload, self.config.stats_timeout_s
        )
        nodes: dict = {
            self.addr_s: {
                "unreachable": False,
                "stale": False,
                "view": list(view),
                "metrics": self.metrics_view(),
            }
        }
        unreachable = 0
        for m, res in zip(peers, results):
            if res is None or not isinstance(res.get("metrics"), dict):
                nodes[m] = {
                    "unreachable": True,
                    "stale": False,
                    "view": None,
                    "metrics": None,
                }
                unreachable += 1
                # The aggregation-degraded event: peer identified, so an
                # operator greps the address straight to the evidence.
                ctx_log(_LOG, "peer", m).warning(
                    "[%s] cluster metrics pull got no usable reply — "
                    "rollup degrades to %d/%d members",
                    self.addr_s, len(peers) + 1 - unreachable, len(peers) + 1,
                )
            else:
                peer_view = (int(res.get("term", -1)), int(res.get("epoch", -1)))
                nodes[m] = {
                    "unreachable": False,
                    "stale": peer_view != view,
                    "view": list(peer_view),
                    "metrics": res["metrics"],
                }
        with self._lock:
            self.agg_pulls += len(peers)
            self.agg_merges += 1
            self.agg_unreachable += unreachable
        rollup = agg.rollup(
            [n["metrics"] for n in nodes.values() if n["metrics"] is not None]
        )
        rollup["nodes"] = len(nodes)
        rollup["unreachable"] = unreachable
        rollup["members_total"] = members_total
        rollup["sampled"] = sampled
        return {
            "scope": "cluster",
            "address": self.addr_s,
            "coordinator": coordinator,
            "view": list(view),
            "nodes": nodes,
            "rollup": rollup,
        }

    def status_view(self) -> dict:
        """``GET /status``: the compact SLO/health plane derived from one
        cluster-scope pull (member reachability/staleness, cluster
        quantiles, the RPC-floor estimate, SLO state)."""
        return agg.status_from(self.cluster_metrics_view())

    def network_view(self) -> dict:
        """Reference `/network` shape (``DHT_Node.py:600-614``)."""
        with self._lock:
            members = list(self.network)
        return {
            m: [
                members[(i - 1) % len(members)],
                members[(i + 1) % len(members)],
            ]
            for i, m in enumerate(members)
        }
