"""Share of the window's K2 dispatches whose job bookkeeping ran as a
replay of a captured CUDA graph, in percent: ``solve_bulk(trace=)``'s
``graph_rounds`` over its ``k2_dispatches``, summed over the window's
passes.  None where the program counts no graph rounds."""


def read(r):
    traces = [t for t in r.get("bulk_traces") or [] if "graph_rounds" in t]
    dispatches = sum(t["k2_dispatches"] for t in traces)
    if dispatches <= 0:
        return None
    return 100.0 * sum(t["graph_rounds"] for t in traces) / dispatches
