"""Device idle time inside the fused dispatch loop, as a share of the
traced window in percent: the time in which the host is inside a
``fused.dispatch`` or ``fused.sync`` span of a pass (``solve_bulk(trace=)``'s
``spans``) and no device operation runs, over ``window_s``.  The spans are
on the epoch clock, as the profiler's device times are, and are compared
with them in ns.  None where the run was not traced or the program records
no such spans."""

from portbench.yardstick.profwindow import busy_intervals

LOOP = ("fused.dispatch", "fused.sync")


def idle_ns(host: list, busy: list) -> int:
    """The ns of the sorted, disjoint ``host`` intervals that the sorted,
    disjoint ``busy`` intervals leave uncovered."""
    covered, j = 0, 0
    for s, e in host:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return sum(e - s for s, e in host) - covered


def read(r):
    p = r.get("profile")
    if not p or p["window_s"] <= 0:
        return None
    loop = busy_intervals([(s["name"], round(s["t0"] * 1e9), round(s["t1"] * 1e9))
                           for t in r.get("bulk_traces") or [] for s in t.get("spans", ())
                           if s["name"] in LOOP])
    if not loop:
        return None
    return 100.0 * idle_ns(loop, busy_intervals(p["device"])) / 1e9 / p["window_s"]
