"""Bounded content-addressed result cache keyed on canonical digests.

Values are verdicts in the CANONICAL frame: a solved entry stores the
canonical solution (mapped back to each requester's frame via that
request's own inverse transform — the entry itself is frame-free), an
unsat entry stores the negative verdict (proven unsatisfiability is an
orbit property, so one proof answers every equivalent board).  Overflowed
or errored searches are never cached: no verdict, no entry.

``lookup_entry``/``store_entry`` (named to stay unique in the repo's
method vocabulary — deadck resolves cross-module calls by name) do LRU
bookkeeping under a single deadck-ranked lock (``frontdoor.cache``,
acquired by HTTP handler threads at lookup, the device loop at device-
verdict insert, and the portfolio native-racer threads at native-verdict
insert; it nests inside the engine/scheduler locks rank-upward and holds
nothing further).  All counters are lockck-guarded.  Stdlib + numpy only.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np

from distributed_sudoku_solver_tpu_torch.obs import lockdep

#: Verdicts an entry may carry (``unsat`` entries are the negative form).
SOLVED, UNSAT = "solved", "unsat"


@dataclasses.dataclass(frozen=True)
class CacheEntry:
    verdict: str  # SOLVED | UNSAT
    solution: Optional[np.ndarray]  # int8[n, n] canonical frame; None for UNSAT
    nodes: int  # the original search's expanded nodes (stats parity)
    raw_digest: str  # digest of the submitted board that FILLED the entry
    #   (a later hit from a different representative is a canonical dup)
    route: str  # which tier produced the verdict (propagation/native/device)


class ResultCache:
    """Bounded LRU store: canonical digest -> :class:`CacheEntry`."""

    def __init__(self, capacity: int = 65536):
        self.capacity = max(1, int(capacity))
        self._lock = lockdep.named_lock("frontdoor.cache")  # lockck: name(frontdoor.cache)
        self._entries: "OrderedDict[str, CacheEntry]" = OrderedDict()
        self.hits = 0  # lockck: guard(_lock)
        self.negative_hits = 0  # lockck: guard(_lock) — hits answered from an UNSAT entry
        self.misses = 0  # lockck: guard(_lock)
        self.evictions = 0  # lockck: guard(_lock)
        self.insertions = 0  # lockck: guard(_lock)
        self.canonical_dups = 0  # lockck: guard(_lock) — hits whose submitted
        #   board differed from the entry's filler (a symmetry-transformed repeat)

    def lookup_entry(self, digest: str, raw_digest: str) -> Optional[CacheEntry]:
        with self._lock:
            entry = self._entries.get(digest)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(digest)
            self.hits += 1
            if entry.verdict == UNSAT:
                self.negative_hits += 1
            if entry.raw_digest != raw_digest:
                self.canonical_dups += 1
            return entry

    def store_entry(self, digest: str, entry: CacheEntry) -> None:
        with self._lock:
            if digest not in self._entries and len(self._entries) >= self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
            # Last write wins on a racing double-fill of the same orbit:
            # both verdicts are correct (solutions of a unique puzzle are
            # equal in any frame), so there is nothing to reconcile.
            self._entries[digest] = entry
            self._entries.move_to_end(digest)
            self.insertions += 1

    def export_hot(self, limit: int = 1024) -> list:
        """Drain-time snapshot (serving/journal.py sidecar): the hottest
        ``limit`` entries as JSON-able dicts, hottest LAST so re-importing
        in order restores the LRU recency ranking."""
        with self._lock:
            items = list(self._entries.items())[-max(1, int(limit)):]
        return [
            {
                "digest": digest,
                "verdict": e.verdict,
                "solution": None if e.solution is None
                else [[int(v) for v in row] for row in e.solution],
                "nodes": int(e.nodes),
                "raw_digest": e.raw_digest,
                "route": e.route,
            }
            for digest, e in items
        ]

    def import_hot(self, entries: list) -> int:
        """Restore a drain-time snapshot on boot (the cache-warm half of
        journal recovery).  Malformed entries are skipped — a stale or
        truncated snapshot degrades to a colder cache, never an error."""
        n = 0
        for d in entries:
            if not isinstance(d, dict):
                continue
            try:
                sol = d.get("solution")
                entry = CacheEntry(
                    verdict=str(d["verdict"]),
                    solution=None if sol is None else np.asarray(sol, np.int8),
                    nodes=int(d.get("nodes", 0)),
                    raw_digest=str(d.get("raw_digest", "")),
                    route=str(d.get("route", "restored")),
                )
            except (KeyError, TypeError, ValueError):
                continue
            self.store_entry(str(d["digest"]), entry)
            n += 1
        return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def metrics(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": int(self.hits),
                "negative_hits": int(self.negative_hits),
                "misses": int(self.misses),
                "evictions": int(self.evictions),
                "insertions": int(self.insertions),
                "canonical_dups": int(self.canonical_dups),
            }
