"""Cluster-scope metrics aggregation: per-node bodies -> one honest rollup.

The coordinator-side half of ``GET /metrics?scope=cluster``: given the
``/metrics`` bodies of every reachable member (its own plus METRICS_PULL
replies, ``cluster/node.py``), :func:`rollup` merges exactly the things
that merge *soundly*:

* **Histograms** (``hist`` sections, ``obs/hist.py`` log2 dicts) merge by
  vector add — the whole reason the histogram plane exists.  Cluster
  quantiles are then estimated from the MERGED counts, which is the only
  honest way to get a cluster p95 (averaging per-node p95s is not).
* **A small counter whitelist** (``jobs_done`` / ``solved`` /
  ``validations``) sums.
* **RPC-floor estimates** (``rpc_floor_ms``) min-merge: the ring's floor
  is the best floor any member has measured.
* **Compile-watch sections** (``compile``, obs/compilewatch.py) sum
  per-program compile counts / recompiles / walls (wall histograms
  vector-add), so "which program is recompiling, cluster-wide?" has one
  answer; alarm state stays per-node.
* **Critical-path sections** (``critpath``, obs/critpath.py) sum jobs
  and per-phase attribution totals; cluster shares are re-derived from
  the merged totals (the per-phase ``critpath_*_ms`` histograms already
  merge through the ``hist`` rule above).
* **Brownout sections** (``brownout``, serving/brownout.py) sum
  transition/shed counters and residency vectors; the per-node stage
  max-merges (``stage_max``) with a browning-member count, and
  :func:`status_from` turns browning members AMBER.

Everything else — percentile snapshots, per-geometry breakdowns, string
state — is deliberately NOT rolled up: those live in the per-node
breakdown the endpoint returns alongside, where they are still true.

:func:`status_from` derives the compact ``GET /status`` health view from
a cluster view (member reachability/staleness flags, cluster quantiles,
the floor, and the SLO plane's state).

Stdlib + sibling ``obs`` modules only; never imports the serving or
cluster layers back.
"""

from __future__ import annotations

from typing import Iterable, Optional

from distributed_sudoku_solver_tpu_torch.obs import hist as hist_mod
from distributed_sudoku_solver_tpu_torch.obs import slo as slo_mod

# Scalar counters that sum soundly across members (lifetime totals with
# one writer each).  Windowed or ratio-shaped values never belong here.
SUM_COUNTERS = ("jobs_done", "solved", "validations")

QUANTILES = (("p50_ms", 0.50), ("p95_ms", 0.95), ("p99_ms", 0.99))


#: Per-program compile-section scalars that sum soundly across members
#: (lifetime totals, one writer each — the node's own compile watch).
_COMPILE_SUM_FIELDS = ("count", "recompiles", "wall_ms_total")


def _merge_compile(acc: dict, sec: dict) -> None:
    """Sum one member's ``compile`` section into the rollup: per-program
    counts/recompiles/walls (the federation the simnet 3-node test pins)
    plus the totals.  Warmup/armed state is deliberately NOT merged —
    alarm state is per-node truth and lives in the per-node breakdown."""
    programs = sec.get("programs")
    if isinstance(programs, dict):
        for name in sorted(programs, key=str):
            rec = programs[name]
            if not isinstance(rec, dict):
                continue
            slot = acc.setdefault("programs", {}).setdefault(str(name), {})
            for f in _COMPILE_SUM_FIELDS:
                v = rec.get(f)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    slot[f] = slot.get(f, 0) + v
            if hist_mod.is_hist(rec.get("wall_ms")):
                slot["wall_ms"] = hist_mod.merge_hist(
                    slot.get("wall_ms"), rec["wall_ms"]
                )
    for f in ("compiles_total", "recompiles_total", "dumps"):
        v = sec.get(f)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            acc[f] = acc.get(f, 0) + v


def _merge_brownout(acc: dict, sec: dict) -> None:
    """Sum one member's ``brownout`` section (serving/brownout.py):
    transition/shed counters and residency vectors sum soundly; the
    stage itself is per-node state, so the rollup carries the MAX stage
    across members plus a browning-member count — "is anyone shedding,
    and how hard" has one cluster answer while each node's own stage
    stays in the per-node breakdown."""
    for f in ("transitions", "escalations", "deescalations", "shed_total"):
        v = sec.get(f)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            acc[f] = acc.get(f, 0) + v
    stage = sec.get("stage")
    if isinstance(stage, int) and not isinstance(stage, bool):
        acc["stage_max"] = max(acc.get("stage_max", 0), stage)
        if stage > 0:
            acc["browning_members"] = acc.get("browning_members", 0) + 1
    shed = sec.get("shed")
    if isinstance(shed, dict):
        slot = acc.setdefault("shed", {})
        for t in sorted(shed, key=str):
            v = shed[t]
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                slot[str(t)] = slot.get(str(t), 0) + v
    res = sec.get("stage_residency_s")
    if isinstance(res, list) and all(
        isinstance(v, (int, float)) and not isinstance(v, bool) for v in res
    ):
        cur = acc.setdefault("stage_residency_s", [0.0] * len(res))
        for i, v in enumerate(res[: len(cur)]):
            cur[i] = round(cur[i] + v, 3)


#: Gossip EVENT counters that sum soundly across members.  The state
#: gauges (alive/suspect/dead/members, self incarnation) are per-node
#: truth — every member counts the whole ring, so summing them would
#: multiply the answer by the membership; they stay in the per-node
#: breakdown.
_DHT_GOSSIP_SUM = (
    "refutations",
    "suspicions",
    "deaths",
    "resurrections",
    "stale_ignored",
    "merged",
)


def _merge_dht(acc: dict, sec: dict) -> None:
    """Sum one member's ``dht`` section (cluster/dht/): gossip event
    counters, cluster-cache shard counters (summing ``entries`` across
    shards IS the cluster cache size — shards are disjoint by ring
    ownership; ``capacity`` is per-node policy and is deliberately NOT
    merged), and cache-affine routing decisions."""
    gossip = sec.get("gossip")
    if isinstance(gossip, dict):
        slot = acc.setdefault("gossip", {})
        for f in _DHT_GOSSIP_SUM:
            v = gossip.get(f)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                slot[f] = slot.get(f, 0) + v
    cache = sec.get("cluster_cache")
    if isinstance(cache, dict):
        slot = acc.setdefault("cluster_cache", {})
        for f in sorted(cache, key=str):
            if f == "capacity":
                continue
            v = cache[f]
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                slot[str(f)] = slot.get(str(f), 0) + v
    aff = sec.get("affinity")
    if isinstance(aff, dict):
        slot = acc.setdefault("affinity", {})
        for f in ("routed", "declined"):
            v = aff.get(f)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                slot[f] = slot.get(f, 0) + v


def _merge_critpath(acc: dict, sec: dict) -> None:
    """Sum one member's ``critpath`` section: jobs + per-phase
    attribution totals (ms sums merge soundly; shares are re-derived
    from the merged totals — averaging per-node shares would not be)."""
    for f in ("jobs", "slow_jobs", "slow_dumps"):
        v = sec.get(f)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            acc[f] = acc.get(f, 0) + v
    attr = sec.get("attribution_ms")
    if isinstance(attr, dict):
        slot = acc.setdefault("attribution_ms", {})
        for p in sorted(attr, key=str):
            v = attr[p]
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                slot[str(p)] = slot.get(str(p), 0.0) + v


def rollup(bodies: Iterable[Optional[dict]]) -> dict:
    """Merge member ``/metrics`` bodies (None/garbage entries skipped —
    the caller flags those peers unreachable) into the cluster rollup."""
    hists: dict = {}
    counters: dict = {}
    floor: Optional[dict] = None
    compile_acc: dict = {}
    critpath_acc: dict = {}
    brownout_acc: dict = {}
    dht_acc: dict = {}
    for body in bodies:
        if not isinstance(body, dict):
            continue
        h = body.get("hist")
        if isinstance(h, dict):
            for k in sorted(h, key=str):
                if hist_mod.is_hist(h[k]):
                    hists[str(k)] = hist_mod.merge_hist(hists.get(str(k)), h[k])
        for k in SUM_COUNTERS:
            v = body.get(k)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                counters[k] = counters.get(k, 0) + v
        f = body.get("rpc_floor_ms")
        if hist_mod.is_min_est(f):
            floor = hist_mod.merge_min_est(floor, f)
        if isinstance(body.get("compile"), dict):
            _merge_compile(compile_acc, body["compile"])
        if isinstance(body.get("critpath"), dict):
            _merge_critpath(critpath_acc, body["critpath"])
        if isinstance(body.get("brownout"), dict):
            _merge_brownout(brownout_acc, body["brownout"])
        if isinstance(body.get("dht"), dict):
            _merge_dht(dht_acc, body["dht"])
    quantiles = {}
    for k, h in hists.items():
        n = hist_mod.hist_count(h)
        if n == 0:
            continue
        quantiles[k] = {
            "count": n,
            **{
                name: round(hist_mod.hist_quantile(h, q), 3)
                for name, q in QUANTILES
            },
        }
    out = {"hist": hists, "counters": counters, "quantiles": quantiles}
    if floor is not None:
        out["rpc_floor_ms"] = floor
    if compile_acc:
        out["compile"] = compile_acc
    if brownout_acc:
        out["brownout"] = brownout_acc
    if dht_acc:
        out["dht"] = dht_acc
    if critpath_acc:
        total = sum(
            v for v in critpath_acc.get("attribution_ms", {}).values()
        )
        if total > 0:
            critpath_acc["shares_pct"] = {
                p: round(100.0 * v / total, 2)
                for p, v in critpath_acc["attribution_ms"].items()
            }
        out["critpath"] = critpath_acc
    return out


def status_from(cluster_view: dict) -> dict:
    """The ``GET /status`` body: membership health + cluster quantiles +
    the SLO plane, derived from a ``cluster_metrics_view()`` result."""
    nodes = cluster_view.get("nodes", {})
    members = {
        addr: {
            "stale": bool(n.get("stale")),
            "unreachable": bool(n.get("unreachable")),
        }
        for addr, n in nodes.items()
    }
    unreachable = sum(1 for m in members.values() if m["unreachable"])
    ru = cluster_view.get("rollup", {})
    mon = slo_mod.active()
    slo_state = mon.state() if mon is not None else None
    # Cluster health must see the MEMBERS' SLO planes too: each pulled
    # metrics body carries its node's slo section (when that node runs
    # --slo), and a member burning its budget is a cluster problem even
    # when the serving node's own monitor is green.  The local monitor
    # stays the fallback for bodies without the section.
    burning_members = sorted(
        addr
        for addr, n in nodes.items()
        if isinstance(n.get("metrics"), dict)
        and (n["metrics"].get("slo") or {}).get("burning")
    )
    burning = bool(slo_state and slo_state.get("burning")) or bool(
        burning_members
    )
    # A browning-out member turns the ring AMBER the way a burning one
    # turns it red: the member is still serving (cache/hard-tail answers
    # at stage <= 2), but it is refusing part of its traffic on purpose —
    # capacity planning should hear that before the budget burns.
    brownout_members = sorted(
        addr
        for addr, n in nodes.items()
        if isinstance(n.get("metrics"), dict)
        and int((n["metrics"].get("brownout") or {}).get("stage") or 0) > 0
    )
    return {
        "address": cluster_view.get("address"),
        "coordinator": cluster_view.get("coordinator"),
        "view": cluster_view.get("view"),
        "members": members,
        "unreachable": unreachable,
        "quantiles": ru.get("quantiles", {}),
        "rpc_floor_ms": ru.get("rpc_floor_ms"),
        "counters": ru.get("counters", {}),
        "slo": slo_state,
        "slo_burning_members": burning_members,
        "brownout_members": brownout_members,
        # The compact traffic light: red = an objective is burning
        # somewhere, amber = someone is shedding (or the rollup is
        # partial), green = all clear.  `healthy`/`degraded` keep their
        # pre-round-18 meanings for existing consumers.
        "state": (
            "red" if burning
            else "amber" if (brownout_members or unreachable > 0)
            else "green"
        ),
        # Degraded = the aggregation itself is partial (a member did not
        # answer); healthy additionally requires no objective burning
        # anywhere in the ring.
        "degraded": unreachable > 0,
        "healthy": unreachable == 0 and not burning,
    }
