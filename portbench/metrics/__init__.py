"""One reader per per-layer metric, ``<metric name>.py`` with ``read(r)``.
A reader returns None where its run holds nothing to read."""
