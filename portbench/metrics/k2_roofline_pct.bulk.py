"""K2's share of its roofline, in percent, over the K2 dispatches of one
pass of the window drawn from the seed (every one, or 24 evenly spaced from
the pass's first to its last where it has more): the summed least time of the
dispatches (``yardstick/k2_replay.py``: each one's bytes over the HBM peak
or its int32 operations over the int32 peak, whichever is larger) over their
summed device time, read from a traced window that recorded every K2
launch.  None where there is no such reading (an untraced run; a traced
run whose window lost a record fails instead)."""


def read(r):
    k2 = r.get("k2")
    if not k2 or not k2.get("device_ms"):
        return None
    return 100.0 * k2["bound_ms"] / k2["device_ms"]
