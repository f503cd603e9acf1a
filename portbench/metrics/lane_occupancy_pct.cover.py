"""Share of the frontier's lane-rounds in which a lane was live, in
percent: ``solve_csp(trace=)``'s ``live_lane_rounds`` (the frontier's
``lane_rounds`` summed) over ``lanes`` times ``steps``, summed over the
window's calls.  What it leaves below 100 is the single root's fan-out over
the lanes and the enumeration's tail.  None where the program counts no
live lane-rounds."""


def read(r):
    traces = [t for t in r.get("cover_traces") or [] if "live_lane_rounds" in t]
    slots = sum(t["lanes"] * t["steps"] for t in traces)
    if slots <= 0:
        return None
    return 100.0 * sum(t["live_lane_rounds"] for t in traces) / slots
