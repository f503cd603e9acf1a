"""Median of the engine's ``latency_ms`` histogram over the window, in ms:
from submit to result inside the node."""

from portbench.yardstick.readings import hist_quantile


def read(r):
    return hist_quantile(r, "latency_ms", 0.5)
