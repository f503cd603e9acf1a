"""The lock hierarchy that the runtime lockdep witness checks.

A copy of the two lock tables of the JAX package's ``analysis/manifest.py``
(``LOCK_RANKS`` and ``LOCK_EDGE_DECLARED``), which
:func:`obs.lockdep.manifest_witness` loads.  The port keeps its own copy so
that nothing here imports the JAX package; a test holds the two equal.
Pure data, stdlib only.
"""

# -- deadck --------------------------------------------------------------
#
# The thread-plane manifest: every lock in the repo, named and ranked.
# ``analysis/deadck.py`` (static) builds the whole-tree lock-acquisition
# graph and checks each edge against this hierarchy; ``obs/lockdep.py``
# (runtime) wraps the same named locks and raises on a violating or
# cycle-forming acquisition at the moment it happens.  One contract, two
# witnesses — the layerck/simnet split.
#
# The rule: a lock may be acquired only while every held lock has a
# STRICTLY SMALLER rank ("acquire rank-upward").  Rank gaps are left on
# purpose so a new lock slots in without renumbering.  The ordering
# encodes the call structure the repo actually has:
#
#   cluster.node (10) < cluster.exec (16)
#       the node's RLock is the outermost coordinator state; it calls
#       into per-job _Exec bookkeeping, engine submits, wire egress.
#   obs.slo (24) < serving.* (30..40)
#       obs.slo is deliberately NOT an obs leaf: the burn-dump holds it
#       across metrics_fn -> engine.metrics (see LOCK_EDGE_DECLARED), so
#       it must order BEFORE the serving locks — and the reverse nesting
#       (engine._lock held into slo.observe) is exactly the ABBA
#       deadlock this rank order makes a violation.
#   serving.engine (30) < serving.scheduler (34) < serving.breaker (38)
#       submit admits into resident flights under the engine lock; the
#       flight consults its circuit breaker under its own.
#   obs leaves (60..68)
#       pure sinks: metrics/trace/histogram recording.  Holding an obs
#       leaf while acquiring ANY serving/cluster lock is a violation by
#       construction (their ranks are above every coordination lock).
#   cluster.simnet (72)
#       the virtual network's condition is the terminal leaf: the
#       injected SimClock is read/slept-on under nearly every other
#       lock, and simnet's delivery path calls handlers only OUTSIDE it.
LOCK_RANKS = {
    "cluster.node": 10,       # cluster/node.py ClusterNode._lock (RLock)
    # Gossip sits just above the node lock: _gossip_beat / _dht_sync run
    # on the heartbeat and handler threads after releasing (or never
    # taking) the node lock, but reconcile() is reachable from paths
    # that held it — node (10) -> gossip (12) must be legal, the reverse
    # never happens (membership.py takes no other lock).
    "cluster.gossip": 12,     # cluster/dht/membership.py Gossip._lock
    "cluster.exec": 16,       # cluster/node.py _Exec.lock
    "obs.slo": 24,            # obs/slo.py SloMonitor._lock (RLock)
    # Between obs.slo and the serving coordination locks: the slo
    # burn-dump's metrics_fn closure reaches engine.metrics -> the
    # brownout section while HOLDING the slo RLock (so brownout must
    # rank above 24), and the controller's own lock is a LEAF by
    # construction — signal callables are read and transition side
    # effects fired with it released (serving/brownout.py evaluate), so
    # nothing is ever acquired under it.
    "serving.brownout": 28,   # serving/brownout.py BrownoutController._lock
    "serving.engine": 30,     # serving/engine.py SolverEngine._lock
    # The WAL lock sits just above the engine lock and BELOW the fault
    # injector: record_resolved runs under engine._lock on the
    # stop/drain sweep (30 -> 32 legal), and every append fires the
    # journal.append/journal.fsync fault sites while holding it
    # (32 -> 40 legal).  Nothing else is ever acquired under it — the
    # batcher thread takes it alone.
    "serving.journal": 32,    # serving/journal.py Journal._lock
    "serving.scheduler": 34,  # serving/scheduler.py ResidentFlight._lock
    # The mesh flight's telemetry lock sits between its parent's lock and
    # the megastep: MeshResidentFlight.metrics acquires the inherited
    # scheduler lock (34) and the mesh lock sequentially; rank 35 keeps
    # even a future nested acquisition (scheduler -> mesh telemetry)
    # rank-upward, while the reverse — holding the telemetry leaf into
    # admission state — is a violation by construction.
    "serving.mesh_scheduler": 35,  # serving/mesh_scheduler.py MeshResidentFlight._mesh_lock
    # Between the scheduler and the breaker: the megastep flight
    # (serving/megastep.py, round 19) is created under engine._lock
    # (30 < 36 legal) and consults its own circuit breaker under its
    # flight lock (36 < 38 legal) — the same nesting shape as the
    # resident flight one rank below.  solve() RELEASES the flight lock
    # before engine._finish_job so no obs/slo acquisition ever nests
    # under it.
    "serving.megastep": 36,   # serving/megastep.py MegastepFlight._lock
    "serving.breaker": 38,    # serving/faults.py CircuitBreaker._lock
    "serving.injector": 40,   # serving/faults.py FaultInjector._lock
    "serving.control": 42,    # serving/engine.py _Control.lock (dataclass field)
    "cluster.dedupe": 44,     # cluster/node.py _DedupeLRU._lock
    # The front door's two locks sit above the serving coordination
    # locks: route() runs on submit/handler threads holding nothing, and
    # the device loop's cache-fill hook (engine._finish_job ->
    # FrontDoor._device_resolved) may run under a flight lock — counter
    # bookkeeping (router, 45) and the LRU store (cache, 46) must both
    # be acquirable there.  Router before cache so a future "count under
    # the router lock while filling the store" nesting is legal; today
    # neither is ever held into the other.
    "frontdoor.router": 45,   # serving/frontdoor/router.py FrontDoor._lock
    "frontdoor.cache": 46,    # serving/frontdoor/cache.py ResultCache._lock
    "frontdoor.race": 47,     # serving/portfolio.py race_native settle lock
    #   (winner claim only — never held into another acquisition)
    # The DHT cache + ring locks rank ABOVE the front-door locks: the
    # router's L2 lookup/store seam (FrontDoor.route -> ClusterCache)
    # and the ring's owner_fn both run on front-door / device-loop
    # threads that may hold frontdoor.router/cache — and NEVER the node
    # lock (ClusterNode._ring_owner guards the ring with cluster.ring,
    # not cluster.node, for exactly this reason).  Cache before ring:
    # ClusterCache.lookup calls owner_fn BEFORE taking its own lock, so
    # neither nests under the other today; the order leaves "consult the
    # ring while holding the shard" legal if replication ever needs it.
    "cluster.dhtcache": 48,   # cluster/dht/cluster_cache.py ClusterCache._lock
    "cluster.ring": 49,       # cluster/node.py ClusterNode._ring_lock
    "native.build": 50,       # native/__init__.py _lock (libcsp build)
    "utils.profile_window": 52,  # utils/profiling.py _window_lock
    "obs.compilewatch": 60,   # obs/compilewatch.py CompileWatch._lock
    "obs.critpath": 62,       # obs/critpath.py CritPathMonitor._lock
    "obs.trace": 64,          # obs/trace.py TraceRecorder._lock
    "obs.hist": 66,           # obs/hist.py LatencyHistogram._lock
    "obs.ordertrace": 67,     # obs/ordertrace.py OrderTraceRecorder._lock
    "obs.minest": 68,         # obs/hist.py MinEstimator._lock
    "utils.statwindow": 69,   # utils/profiling.py StatWindow._lock (pure leaf)
    "cluster.simnet": 72,     # cluster/simnet.py SimNet._cond
}

# Blessed edges the rank order alone does not express — each carries its
# why, so the re-entrancy contracts review rounds kept re-deriving by
# hand are DECLARED, tool-checked facts (ISSUE 13).  deadck unions these
# into its predicted graph; lockdep allows them at runtime.
# The slo burn-dump re-entrancy (obs/slo.py _dump_locked): the monitor
# holds its RLock across metrics_fn -> engine.metrics() ->
# slo.active().metrics(), which re-enters the RLock.  Safe because
# (a) obs.slo ranks BEFORE serving.engine, so the reverse nesting is a
# violation, and (b) the engine feeds observe() lock-free (_finish_job
# runs outside engine._lock).  The whole metrics-snapshot closure is
# declared — engine.metrics reads every installed plane's lock — because
# metrics_fn is an injected callable deadck cannot see through: these
# edges exist only at run time, which is exactly why the runtime witness
# cross-checks against (static edges UNION this table).  Pinned by
# tests/test_deadck.py's re-entrancy test, not tribal knowledge.
_SLO_DUMP_REASON = (
    "burn-dump evidence capture: SloMonitor._dump_locked holds the "
    "monitor RLock across metrics_fn -> engine.metrics, which reads "
    "this plane's lock; the slo read-back re-enters the RLock, and the "
    "engine never holds its own lock into observe()"
)

LOCK_EDGE_DECLARED = {
    # Virtual-clock injection: a simnet-clocked SloMonitor (the replay
    # harness's virtual nodes, benchmarks/replay.py; any simnet-lane
    # monitor) reads clock=net.now — the SimNet condition — under its
    # own RLock.  Rank-legal by construction (obs.slo 24 < cluster.simnet
    # 72, the terminal leaf every injected SimClock read lands on), and
    # invisible to statics for the same injected-callable reason as the
    # burn-dump closure below.
    ("obs.slo", "cluster.simnet"): (
        "injected virtual clock: SloMonitor(clock=net.now) reads the "
        "SimNet condition inside its locked prune/observe paths"
    ),
    # Compile-under-lock (round 19): the megastep's FIRST flight
    # jit-compiles attach/advance/verdict inside the flight lock, and an
    # installed CompileWatch's jax monitoring callback records the
    # compile wall into a LatencyHistogram synchronously on the
    # compiling thread — so the flight lock transiently precedes
    # obs.hist.  Rank-upward (serving.megastep 36 < obs.hist 66) and
    # invisible to statics: the callback is registered with jax's
    # monitoring hook, not called from megastep source.  The direct
    # serving.megastep -> obs.compilewatch hop is already static (the
    # cost-plane capture_cost seam).
    ("serving.megastep", "obs.hist"): (
        "jax monitoring callback under the flight lock: the first "
        "flight's compile fires CompileWatch.on_duration -> "
        "LatencyHistogram.record on the compiling thread"
    ),
}
LOCK_EDGE_DECLARED.update({
    ("obs.slo", target): _SLO_DUMP_REASON
    for target in (
        # engine.metrics reads the brownout controller's counters when
        # one is installed (round 18) — same injected-callable closure.
        "serving.brownout",
        "serving.engine",
        # engine.metrics reads the installed journal's counters (round
        # 23) — same injected-callable closure, same rank-upward
        # legality (obs.slo 24 < serving.journal 32).
        "serving.journal",
        "serving.scheduler",
        # engine.metrics reads the mesh flight's telemetry section
        # (round 21) — same injected-callable closure, same rank-upward
        # legality (obs.slo 24 < serving.mesh_scheduler 35).
        "serving.mesh_scheduler",
        # engine.metrics reads the megastep flight counters (round 19) —
        # same injected-callable closure, same rank-upward legality
        # (obs.slo 24 < serving.megastep 36).
        "serving.megastep",
        "serving.breaker",
        "serving.injector",
        # engine.metrics also reads the front-door counters/cache
        # metrics when a front door is installed (round 17) — same
        # injected-callable closure, same rank-upward legality.
        "frontdoor.router",
        "frontdoor.cache",
        "obs.compilewatch",
        "obs.critpath",
        "obs.trace",
        "obs.hist",
        "obs.minest",
        "utils.statwindow",
    )
})
