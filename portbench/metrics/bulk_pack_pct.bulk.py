"""Host packing and upload as a share of the first pass, in percent:
``solve_bulk(trace=)``'s ``pack_s`` over ``first_pass_s``, summed over the
window's passes."""


def read(r):
    traces = r.get("bulk_traces") or []
    first = sum(t["first_pass_s"] for t in traces)
    return 100.0 * sum(t["pack_s"] for t in traces) / first if first > 0 else None
