"""Median of the front door's cache route over the window, in ms: the
``frontdoor_cache_ms`` histogram (canonical form and lookup, from submit)."""

from portbench.yardstick.readings import hist_quantile


def read(r):
    return hist_quantile(r, "frontdoor_cache_ms", 0.5)
