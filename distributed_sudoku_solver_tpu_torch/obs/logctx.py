"""Log correlation: every record that concerns a job carries its uuid.

The engine/scheduler/cluster layers log through module-level loggers, and
until round 11 a failure record ("batch failed", "undeliverable after N
attempts") named the *site* but not the *job* — grep-ing a uuid from a
trace or an HTTP error found nothing.  Two helpers fix that without
touching handler/formatter configuration (the uuid rides the message text,
so it survives any formatter, and also lands on ``record.uuid`` for
structured handlers):

* :func:`job_log` — a ``LoggerAdapter`` for single-job records::

      job_log(_LOG, job.uuid).error("retry budget exhausted: %s", label)
      # -> "[job 1f2e3d4c] retry budget exhausted: ..."

* :func:`uuids_label` — a bounded inline label for batch-level records
  (a failed flight concerns many jobs)::

      _LOG.error("[engine] batch failed (%s): %r", uuids_label(jobs), e)
      # -> "... (uuids=1f2e3d4c,9a8b7c6d,+3) ..."

* :func:`ctx_log` — the generic form for non-job identities (an SLO
  objective's window, a peer whose metrics pull failed)::

      ctx_log(_LOG, "slo", "solve_p95_ms<=250").warning("burn rate ...")
      # -> "[slo solve_p95_ms<=250] burn rate ..."
      ctx_log(_LOG, "peer", addr).warning("metrics pull failed: ...")
      # -> "[peer 10.0.0.2:7000] metrics pull failed: ..."

Stdlib only.
"""

from __future__ import annotations

import logging
from typing import Iterable


def _short(uuid: str) -> str:
    return uuid[:8] if len(uuid) > 8 else uuid


class JobLogAdapter(logging.LoggerAdapter):
    """Prefixes messages with ``[job <uuid8>]`` and sets ``record.uuid``."""

    def __init__(self, logger: logging.Logger, uuid: str):
        super().__init__(logger, {"uuid": uuid})

    def process(self, msg, kwargs):
        extra = kwargs.setdefault("extra", {})
        extra.setdefault("uuid", self.extra["uuid"])
        return f"[job {self.extra['uuid']}] {msg}", kwargs


def job_log(logger: logging.Logger, uuid: str) -> JobLogAdapter:
    return JobLogAdapter(logger, uuid)


class CtxLogAdapter(logging.LoggerAdapter):
    """Prefixes messages with ``[<tag> <value>]`` and sets the record
    attribute ``<tag>`` for structured handlers — ``job_log`` generalized
    to any identity worth grepping for."""

    def __init__(self, logger: logging.Logger, tag: str, value):
        super().__init__(logger, {tag: value})
        self._tag = tag
        self._value = value

    def process(self, msg, kwargs):
        extra = kwargs.setdefault("extra", {})
        extra.setdefault(self._tag, self._value)
        return f"[{self._tag} {self._value}] {msg}", kwargs


def ctx_log(logger: logging.Logger, tag: str, value) -> CtxLogAdapter:
    return CtxLogAdapter(logger, tag, value)


def uuids_label(jobs_or_uuids: Iterable, limit: int = 4) -> str:
    """``uuids=aaaa,bbbb,+N`` for multi-job records; accepts Job objects
    (anything with a ``uuid`` attribute) or uuid strings."""
    uuids = [
        getattr(j, "uuid", j) for j in jobs_or_uuids
    ]
    shown = ",".join(_short(str(u)) for u in uuids[:limit])
    extra = len(uuids) - limit
    if extra > 0:
        shown += f",+{extra}"
    return f"uuids={shown or '-'}"
