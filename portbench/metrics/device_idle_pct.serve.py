"""Share of the traced serving window with no device operation running, in
percent (torch.profiler)."""

from portbench.yardstick.readings import idle_pct


def read(r):
    return idle_pct(r)
