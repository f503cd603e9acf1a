"""Device idle time inside the fused dispatch loop, as a share of the
traced window in percent, read as ``dispatch_idle_pct.bulk`` reads it: the
time in which the host is inside a ``fused.dispatch`` or ``fused.sync``
span of a ``solve_csp(trace=)`` call and no device operation runs, over
``window_s``.  None where the run was not traced or the program records no
such spans."""

from portbench import core


def read(r):
    return core.reader("dispatch_idle_pct.bulk")(
        {"bulk_traces": r.get("cover_traces"), "profile": r.get("profile")})
