"""Share of the traced counting window with no device operation running,
in percent (torch.profiler), read as ``device_idle_pct.bulk`` reads it."""

from portbench.yardstick.readings import idle_pct


def read(r):
    return idle_pct(r)
