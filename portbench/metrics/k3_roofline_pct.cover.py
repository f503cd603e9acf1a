"""K3's share of its roofline, in percent, over the K3 dispatches of one
pass of the window drawn from the seed (every one, or 24 evenly spaced from
the pass's first to its last where it has more): the summed least time of
the dispatches (``yardstick/k3_replay.py``: each one's bytes over the HBM
peak or its int32 operations over the int32 peak, whichever is larger) over
their summed device time, read from a traced window that recorded every K3
launch.  None where there is no such reading (an untraced run; a traced
run whose window lost a record fails instead)."""


def read(r):
    k3 = r.get("k3")
    if not k3 or not k3.get("device_ms"):
        return None
    return 100.0 * k3["bound_ms"] / k3["device_ms"]
