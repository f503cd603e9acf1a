"""K3 dispatches a board: the mean over the window's ``solve_csp`` calls
of ``trace=``'s ``k3_dispatches``, the count of the call's
``fused.dispatch`` spans (one a K3 launch).  None where the program counts
no dispatches."""


def read(r):
    counts = [t["k3_dispatches"] for t in r.get("cover_traces") or [] if "k3_dispatches" in t]
    return sum(counts) / len(counts) if counts else None
