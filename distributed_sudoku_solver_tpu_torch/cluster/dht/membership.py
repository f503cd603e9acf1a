"""SWIM-style gossip membership: probes, suspicion, incarnations.

The node's (term,epoch) view stays AUTHORITATIVE for who is in the
cluster — joins and evictions still flow through the coordinator's
guard machinery so the ledger/rehoming semantics are untouched.  What
gossip adds is O(1)-per-beat LIVENESS: each beat every node probes one
member (round-robin over a shuffled order) and piggybacks a bounded
batch of recent state updates on the PROBE/ACK frames, so "node X looks
dead" propagates epidemically instead of through per-beat full-view
broadcasts.

The SWIM pieces, mapped onto this repo:

* suspicion before death — a failed probe marks the target SUSPECT;
  only after ``suspicion_s`` with no refutation does it become DEAD and
  get reported (the node then feeds it to the existing NODE_FAILED /
  eviction path, which is where the authoritative view catches up).
* incarnation numbers — a node seeing itself suspected in a piggyback
  refutes by bumping its own incarnation; higher incarnation always
  wins, and on a tie DEAD > SUSPECT > ALIVE.
* bounded piggyback — every state change gets a finite retransmission
  budget (``_spread_budget``); ``updates()`` returns at most
  ``piggyback`` entries, freshest spread first, self always included.

State machine only: no wire, no threads.  The node drives it from the
heartbeat loop with its injected clock and owns all I/O, so the simnet
lane runs hundreds of these deterministically.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from ...obs import lockdep

__all__ = ["Gossip", "ALIVE", "SUSPECT", "DEAD"]

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"

_RANK = {ALIVE: 0, SUSPECT: 1, DEAD: 2}


class _Entry:
    __slots__ = ("state", "inc", "since", "brown", "spread")

    def __init__(self, state: str, inc: int, since: float):
        self.state = state
        self.inc = inc
        self.since = since   # clock time this state was entered
        self.brown = False   # peer self-reported brownout (decline affinity)
        self.spread = 0      # remaining piggyback retransmissions


class Gossip:
    """Per-node gossip table.  All methods are thread-safe (probe acks
    arrive on transport handler threads while the heartbeat loop ticks).
    """

    def __init__(
        self,
        self_addr: str,
        clock,
        suspicion_s: float,
        piggyback: int = 8,
    ):
        self.self_addr = self_addr
        self._clock = clock
        self.suspicion_s = float(suspicion_s)
        self.piggyback = max(1, int(piggyback))
        self._lock = lockdep.named_lock("cluster.gossip")  # lockck: name(cluster.gossip)
        self._members: Dict[str, _Entry] = {}  # lockck: guard(_lock)
        self._order: List[str] = []  # lockck: guard(_lock) — probe round-robin
        self._cursor = 0  # lockck: guard(_lock)
        self._self_inc = 0  # lockck: guard(_lock)
        self._self_brown = False  # lockck: guard(_lock)
        # Deterministic per-node shuffle: the simnet soak replays
        # identically for a given address set.
        self._rng = random.Random(self_addr)  # lockck: guard(_lock)
        self.refutations = 0  # lockck: guard(_lock) — self-suspicions refuted
        self.suspicions = 0  # lockck: guard(_lock)
        self.deaths = 0  # lockck: guard(_lock) — suspicions expired to DEAD
        self.resurrections = 0  # lockck: guard(_lock) — view re-admitted a DEAD member
        self.stale_ignored = 0  # lockck: guard(_lock) — lower-incarnation updates dropped
        self.merged = 0  # lockck: guard(_lock) — updates applied

    # -- view sync -------------------------------------------------------

    def reconcile(self, members: List[str]) -> None:
        """Sync with the authoritative (term,epoch) view.  New members
        start ALIVE at incarnation 0; members evicted from the view are
        dropped; a DEAD member the view re-admits (rejoin through the
        coordinator) is resurrected ALIVE — the view advance IS the
        refutation, covering restarts whose incarnation reset to 0."""
        now = self._clock()
        with self._lock:
            want = {m for m in members if m != self.self_addr}
            changed = False
            for m in list(self._members):
                if m not in want:
                    del self._members[m]
                    changed = True
            for m in want:
                ent = self._members.get(m)
                if ent is None:
                    self._members[m] = _Entry(ALIVE, 0, now)
                    changed = True
                elif ent.state == DEAD:
                    ent.state = ALIVE
                    ent.since = now
                    ent.spread = self._budget_locked()
                    self.resurrections += 1
            if changed:
                self._order = sorted(self._members)
                self._rng.shuffle(self._order)
                self._cursor = 0

    # -- beat ------------------------------------------------------------

    def tick(self) -> Tuple[Optional[str], List[str]]:
        """One heartbeat: returns (probe target or None, members whose
        suspicion just expired to DEAD — report these to eviction)."""
        now = self._clock()
        with self._lock:
            newly_dead = []
            for m, ent in self._members.items():
                if ent.state == SUSPECT and now - ent.since >= self.suspicion_s:
                    ent.state = DEAD
                    ent.since = now
                    ent.spread = self._budget_locked()
                    self.deaths += 1
                    newly_dead.append(m)
            target = None
            for _ in range(len(self._order)):
                cand = self._order[self._cursor % len(self._order)]
                self._cursor += 1
                ent = self._members.get(cand)
                if ent is not None and ent.state != DEAD:
                    target = cand
                    break
            return target, newly_dead

    # -- piggyback -------------------------------------------------------

    def set_brown(self, brown: bool) -> None:
        with self._lock:
            self._self_brown = bool(brown)

    def updates(self) -> List[dict]:
        """Bounded piggyback batch: self first, then the freshest spread
        budgets.  Decrements each included entry's budget."""
        with self._lock:
            out = [
                {
                    "m": self.self_addr,
                    "s": ALIVE,
                    "i": self._self_inc,
                    "b": self._self_brown,
                }
            ]
            pending = sorted(
                (m for m, e in self._members.items() if e.spread > 0),
                key=lambda m: (-self._members[m].spread, m),
            )
            for m in pending[: self.piggyback - 1]:
                ent = self._members[m]
                ent.spread -= 1
                out.append({"m": m, "s": ent.state, "i": ent.inc, "b": ent.brown})
            return out

    def merge(self, updates: List[dict]) -> None:
        """Apply a piggyback batch (from a PROBE we handled or an ACK we
        received).  Incarnation order; DEAD > SUSPECT > ALIVE on ties;
        self-suspicion refuted by bumping our incarnation."""
        if not updates:
            return
        now = self._clock()
        with self._lock:
            for upd in updates:
                try:
                    m = upd["m"]
                    state = upd["s"]
                    inc = int(upd["i"])
                except (KeyError, TypeError, ValueError):
                    continue
                if state not in _RANK:
                    continue
                if m == self.self_addr:
                    if state != ALIVE and inc >= self._self_inc:
                        self._self_inc = inc + 1
                        self.refutations += 1
                    continue
                ent = self._members.get(m)
                if ent is None:
                    continue  # not in the authoritative view (yet) — ignore
                if inc < ent.inc:
                    self.stale_ignored += 1
                    continue
                if inc == ent.inc and _RANK[state] <= _RANK[ent.state]:
                    if state == ent.state:
                        ent.brown = bool(upd.get("b", ent.brown))
                    continue
                if ent.state != state:
                    ent.since = now
                    ent.spread = self._budget_locked()
                    if state == SUSPECT:
                        self.suspicions += 1
                ent.state = state
                ent.inc = inc
                ent.brown = bool(upd.get("b", ent.brown))
                self.merged += 1

    # -- probe outcomes --------------------------------------------------

    def on_ack(self, target: str) -> None:
        """A probe of ``target`` answered: it is alive at >= its known
        incarnation (the ACK's own piggyback carries the fresh one)."""
        now = self._clock()
        with self._lock:
            ent = self._members.get(target)
            if ent is not None and ent.state == SUSPECT:
                ent.state = ALIVE
                ent.since = now
                ent.spread = self._budget_locked()

    def on_probe_fail(self, target: str) -> None:
        now = self._clock()
        with self._lock:
            ent = self._members.get(target)
            if ent is not None and ent.state == ALIVE:
                ent.state = SUSPECT
                ent.since = now
                ent.spread = self._budget_locked()
                self.suspicions += 1

    # -- reads -----------------------------------------------------------

    def is_healthy(self, addr: str) -> bool:
        """ALIVE and not self-reporting brownout — the affinity gate."""
        if addr == self.self_addr:
            return True
        with self._lock:
            ent = self._members.get(addr)
            return ent is not None and ent.state == ALIVE and not ent.brown

    def state_of(self, addr: str) -> Optional[str]:
        if addr == self.self_addr:
            return ALIVE
        with self._lock:
            ent = self._members.get(addr)
            return ent.state if ent is not None else None

    def view(self) -> dict:
        with self._lock:
            members = {
                m: {
                    "state": e.state,
                    "incarnation": e.inc,
                    "brown": e.brown,
                    "since": round(e.since, 6),
                }
                for m, e in sorted(self._members.items())
            }
            members[self.self_addr] = {
                "state": ALIVE,
                "incarnation": self._self_inc,
                "brown": self._self_brown,
                "since": 0.0,
            }
            return members

    def metrics(self) -> dict:
        with self._lock:
            alive = sum(1 for e in self._members.values() if e.state == ALIVE) + 1
            suspect = sum(1 for e in self._members.values() if e.state == SUSPECT)
            dead = sum(1 for e in self._members.values() if e.state == DEAD)
            return {
                "alive": alive,
                "suspect": suspect,
                "dead": dead,
                "incarnation": self._self_inc,
                "refutations": self.refutations,
                "suspicions": self.suspicions,
                "deaths": self.deaths,
                "resurrections": self.resurrections,
                "stale_ignored": self.stale_ignored,
                "merged": self.merged,
            }

    # -- internal --------------------------------------------------------

    def _budget_locked(self) -> int:
        # SWIM's lambda*log(n) retransmission budget, floored so tiny
        # rings still converge in a couple of beats.
        return max(3, (len(self._members) + 1).bit_length() + 1)
