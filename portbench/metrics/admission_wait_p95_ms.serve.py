"""95th percentile of the resident scheduler's ``admission_wait_ms``
histogram over the window, in ms."""

from portbench.yardstick.readings import hist_quantile


def read(r):
    return hist_quantile(r, "admission_wait_ms", 0.95)
