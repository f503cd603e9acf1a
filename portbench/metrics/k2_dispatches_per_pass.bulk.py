"""K2 dispatches a pass: the mean over the window's passes of
``solve_bulk(trace=)``'s ``k2_dispatches``, the count of the pass's
``fused.dispatch`` spans (one a K2 launch).  None where the program counts
no dispatches."""


def read(r):
    counts = [t["k2_dispatches"] for t in r.get("bulk_traces") or [] if "k2_dispatches" in t]
    return sum(counts) / len(counts) if counts else None
