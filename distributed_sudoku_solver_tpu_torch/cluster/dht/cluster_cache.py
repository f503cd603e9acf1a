"""Cluster-wide result cache: canonical digests owned by ring members.

Each node holds the authoritative shard for the digests the hash ring
assigns it, as plain JSON-ready dicts (``{"verdict", "solution",
"nodes", "raw", "route"}``) — the dict <-> ``frontdoor.CacheEntry``
glue lives in ``cluster/node.py`` so this layer never imports serving.

The consistency model is the front door's, made distributed:

* lookups are read-through — a local (L1) miss asks the digest's owner
  with a SHORT timeout; any wire error is just a miss (the requester
  solves locally — no lost job, ever).
* fills are at-least-once and ASYNC — ``store`` on a non-owner ships a
  CACHE_PUT off-thread with the wire's retry budget and a dedupe uuid,
  so the solve path never blocks on a remote.  Duplicate puts are
  idempotent (same deterministic solution for the same canonical
  digest), so at-least-once is safe; the receiver's dedupe LRU keeps
  the counters honest.
* staleness is bounded by correctness, not freshness: entries are
  verdicts of a deterministic solver over a canonical form, so a
  "stale" entry is still the right answer — the only loss mode is a
  MISS (owner died with its shard), which degrades to a local solve.

All I/O and time goes through injected callables (``owner_fn``,
``request_fn``, ``put_fn``, ``clock``, ``uuid_fn``): the simnet lane
drives this deterministically and clockck sees no bare clock.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Optional

from ..wire import WireError
from ...obs import lockdep

__all__ = ["ClusterCache"]

NEGATIVE = "unsat"


class ClusterCache:
    """One node's view of the cluster cache: the local shard it owns
    plus wire routing to every other digest's owner."""

    def __init__(
        self,
        self_addr: str,
        owner_fn: Callable[[str], Optional[str]],
        request_fn: Callable[[str, dict, float], dict],
        put_fn: Callable[[str, dict], None],
        clock,
        uuid_fn: Callable[[], str],
        capacity: int = 65536,
        get_timeout_s: float = 1.0,
        put_retries: int = 2,
        retry_delay_s: float = 0.25,
    ):
        self.self_addr = self_addr
        self._owner_fn = owner_fn
        self._request_fn = request_fn  # (owner, frame, timeout) -> reply; raises WireError
        self._put_fn = put_fn          # (owner, frame) -> None; raises WireError
        self._clock = clock
        self._uuid_fn = uuid_fn
        self.capacity = max(1, int(capacity))
        self.get_timeout_s = float(get_timeout_s)
        self.put_retries = max(0, int(put_retries))
        self.retry_delay_s = float(retry_delay_s)
        self._lock = lockdep.named_lock("cluster.dhtcache")  # lockck: name(cluster.dhtcache)
        self._shard: "OrderedDict[str, dict]" = OrderedDict()  # lockck: guard(_lock)
        self.lookups = 0  # lockck: guard(_lock)
        self.local_hits = 0  # lockck: guard(_lock) — this node owns the digest
        self.remote_hits = 0  # lockck: guard(_lock) — answered by the owner over the wire
        self.negative_hits = 0  # lockck: guard(_lock) — hits on UNSAT entries
        self.misses = 0  # lockck: guard(_lock)
        self.remote_errors = 0  # lockck: guard(_lock) — owner unreachable; degraded to miss
        self.puts_sent = 0  # lockck: guard(_lock) — CACHE_PUT shipped (post-retry success)
        self.puts_failed = 0  # lockck: guard(_lock) — retry budget exhausted; fill lost
        self.puts_applied = 0  # lockck: guard(_lock) — CACHE_PUT stored on this shard
        self.gets_served = 0  # lockck: guard(_lock) — CACHE_GET answered from this shard
        self.insertions = 0  # lockck: guard(_lock)
        self.evictions = 0  # lockck: guard(_lock)

    # -- read path -------------------------------------------------------

    def lookup(self, digest: str) -> Optional[dict]:
        """The entry for ``digest``, from this shard or its owner.  Any
        failure is a miss — the caller just solves locally."""
        owner = self._owner_fn(digest)
        if owner is None or owner == self.self_addr:
            entry = self._local_get(digest)
            with self._lock:
                self.lookups += 1
                if entry is None:
                    self.misses += 1
                else:
                    self.local_hits += 1
                    if entry.get("verdict") == NEGATIVE:
                        self.negative_hits += 1
            return entry
        frame = {"method": "CACHE_GET", "digest": digest}
        try:
            reply = self._request_fn(owner, frame, self.get_timeout_s)
        except WireError:
            with self._lock:
                self.lookups += 1
                self.remote_errors += 1
                self.misses += 1
            return None
        entry = reply.get("entry") if isinstance(reply, dict) and reply.get("found") else None
        with self._lock:
            self.lookups += 1
            if entry is None:
                self.misses += 1
            else:
                self.remote_hits += 1
                if entry.get("verdict") == NEGATIVE:
                    self.negative_hits += 1
        return entry

    # -- write path ------------------------------------------------------

    def store(self, digest: str, entry: dict) -> None:
        """Fill the cluster cache.  Owner-local stores are synchronous
        (dict insert); remote fills ship async so the resolving thread
        (often the device loop) never waits on the wire."""
        owner = self._owner_fn(digest)
        if owner is None or owner == self.self_addr:
            self._store_local(digest, entry)
            return
        frame = {
            "method": "CACHE_PUT",
            "uuid": self._uuid_fn(),
            "digest": digest,
            "entry": entry,
        }
        threading.Thread(
            target=self._put_loop, args=(owner, frame), daemon=True,
            name="dht-put",
        ).start()

    def _put_loop(self, owner: str, frame: dict) -> None:
        # At-least-once with the wire's retry budget: same uuid every
        # attempt, so the receiver's dedupe LRU absorbs duplicates.
        for attempt in range(1 + self.put_retries):
            try:
                self._put_fn(owner, frame)
                with self._lock:
                    self.puts_sent += 1
                return
            except WireError:
                if attempt < self.put_retries:
                    self._clock.sleep(self.retry_delay_s)
        with self._lock:
            self.puts_failed += 1  # fill lost — a future miss, never a wrong answer

    # -- wire handlers (called from the node's _handle dispatch) ---------

    def handle_get(self, frame: dict) -> dict:
        entry = self._local_get(frame.get("digest", ""))
        with self._lock:
            self.gets_served += 1
        return {"found": entry is not None, "entry": entry}

    def handle_put(self, frame: dict) -> None:
        digest = frame.get("digest")
        entry = frame.get("entry")
        if not isinstance(digest, str) or not isinstance(entry, dict):
            return
        self._store_local(digest, entry)
        with self._lock:
            self.puts_applied += 1

    # -- shard -----------------------------------------------------------

    def _local_get(self, digest: str) -> Optional[dict]:
        with self._lock:
            entry = self._shard.get(digest)
            if entry is not None:
                self._shard.move_to_end(digest)
            return entry

    def _store_local(self, digest: str, entry: dict) -> None:
        with self._lock:
            if digest in self._shard:
                # Last-write-wins, same as the L1: deterministic solver,
                # so both writes carry the same verdict.
                self._shard.move_to_end(digest)
            self._shard[digest] = entry
            self.insertions += 1
            while len(self._shard) > self.capacity:
                self._shard.popitem(last=False)
                self.evictions += 1

    # -- reads -----------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._shard)

    def metrics(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._shard),
                "capacity": self.capacity,
                "lookups": self.lookups,
                "local_hits": self.local_hits,
                "remote_hits": self.remote_hits,
                "negative_hits": self.negative_hits,
                "misses": self.misses,
                "remote_errors": self.remote_errors,
                "puts_sent": self.puts_sent,
                "puts_failed": self.puts_failed,
                "puts_applied": self.puts_applied,
                "gets_served": self.gets_served,
                "insertions": self.insertions,
                "evictions": self.evictions,
            }
