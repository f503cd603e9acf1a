"""Share of the window's routed requests that the front door sent to the
device (resident flight, K2), in percent: ``/metrics`` ``frontdoor.routes``."""

from portbench.yardstick.readings import route_share


def read(r):
    return route_share(r, "device")
