"""Share of boards that leave the first pass unresolved for the escalation
rungs, in percent: ``solve_bulk(trace=)``'s ``remaining_after_first`` over
the boards, summed over the window's passes."""


def read(r):
    traces = r.get("bulk_traces") or []
    boards = sum(r.get("boards") or [])
    if not traces or boards <= 0:
        return None
    return 100.0 * sum(t["remaining_after_first"] for t in traces) / boards
