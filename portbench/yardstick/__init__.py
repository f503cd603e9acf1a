"""Frozen measuring code: peaks, operation counts, the plain K2 replay and
the profiler readings.  Copied from the program's files named in each module,
so that a later change to the program cannot move the yardstick."""
