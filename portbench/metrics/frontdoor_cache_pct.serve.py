"""Share of the window's routed requests that the front door answered from
its canonical result cache, in percent: ``/metrics`` ``frontdoor.routes``."""

from portbench.yardstick.readings import route_share


def read(r):
    return route_share(r, "cache")
