"""Share of the window's K3 dispatches whose job bookkeeping ran as a
replay of a captured CUDA graph, in percent: ``solve_csp(trace=)``'s
``graph_rounds`` over its ``k3_dispatches``, summed over the window's
calls.  None where the program counts no graph rounds."""


def read(r):
    traces = [t for t in r.get("cover_traces") or [] if "graph_rounds" in t]
    dispatches = sum(t["k3_dispatches"] for t in traces)
    if dispatches <= 0:
        return None
    return 100.0 * sum(t["graph_rounds"] for t in traces) / dispatches
