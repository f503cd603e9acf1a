"""Host syncs a pass: the mean over the window's passes of
``solve_bulk(trace=)``'s ``host_syncs``, the count of the pass's ``*.sync``
spans (the fused loop's condition reads, the rungs' status fetches, the
drains and the rungs' terminal fetches).  None where the program counts no
syncs."""


def read(r):
    counts = [t["host_syncs"] for t in r.get("bulk_traces") or [] if "host_syncs" in t]
    return sum(counts) / len(counts) if counts else None
