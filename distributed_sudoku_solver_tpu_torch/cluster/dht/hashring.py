"""Consistent-hash ownership of the canonical-key space.

The front door's symmetry-canonical digest is a sha256 hex
string naming a whole symmetry orbit of boards.  The ring maps that key
space onto cluster members: each member contributes ``vnodes`` virtual
points (sha256 of ``"addr#i"``), keys are owned by the first point at
or clockwise-after the key's position, and a join/leave moves only the
key arcs adjacent to the member's points — O(keys/n) expected, never a
full reshuffle.  ``replicas(key, n)`` walks further clockwise for the
distinct successor members, which is the read-repair/replication set.

Pure data structure: no locks (callers synchronize — ``ClusterNode``
mutates it under the node lock, ``ClusterCache`` reads it through an
injected ``owner_fn``), no clock, no wire.  Deterministic for a given
member set by construction, which is what makes owner placement
reproducible across every node that has converged on the same view.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Tuple

__all__ = ["HashRing"]


def _position(key: str) -> int:
    # 64-bit prefix of sha256 — collision probability is irrelevant at
    # cluster scale and 8 bytes keeps bisect comparisons cheap.
    return int.from_bytes(hashlib.sha256(key.encode("utf-8")).digest()[:8], "big")


class HashRing:
    """Virtual-node consistent-hash ring over member address strings."""

    def __init__(self, vnodes: int = 32):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = int(vnodes)
        self._points: List[int] = []        # sorted vnode positions
        self._owner_at: Dict[int, str] = {}  # position -> member
        self._members: Dict[str, Tuple[int, ...]] = {}  # member -> its positions

    # -- membership ------------------------------------------------------

    def add(self, member: str) -> None:
        if member in self._members:
            return
        positions = []
        for i in range(self.vnodes):
            pos = _position(f"{member}#{i}")
            # Position collisions across members are broken by address
            # order so every converged view agrees on the winner.
            held = self._owner_at.get(pos)
            if held is not None:
                if held <= member:
                    continue
                self._members[held] = tuple(  # deadck: allow(externally synchronized pure structure: every mutating caller holds ClusterNode._ring_lock (cluster.ring, rank 49) — the docstring contract; the ring itself owns no lock so converged views stay a pure function of the member set)
                    p for p in self._members[held] if p != pos
                )
            else:
                bisect.insort(self._points, pos)
            self._owner_at[pos] = member  # deadck: allow(externally synchronized pure structure: same cluster.ring contract as _members above)
            positions.append(pos)
        self._members[member] = tuple(positions)

    def remove(self, member: str) -> None:
        positions = self._members.pop(member, None)
        if positions is None:
            return
        for pos in positions:
            if self._owner_at.get(pos) == member:
                del self._owner_at[pos]
                idx = bisect.bisect_left(self._points, pos)
                if idx < len(self._points) and self._points[idx] == pos:
                    del self._points[idx]

    def members(self) -> List[str]:
        return sorted(self._members)

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, member: str) -> bool:
        return member in self._members

    # -- ownership -------------------------------------------------------

    def owner(self, key: str) -> Optional[str]:
        """The member owning ``key``, or None on an empty ring."""
        return self._owner_at_pos(_position(key))

    def _owner_at_pos(self, pos: int) -> Optional[str]:
        if not self._points:
            return None
        idx = bisect.bisect_right(self._points, pos)
        if idx == len(self._points):
            idx = 0  # wrap past the top of the ring
        return self._owner_at[self._points[idx]]

    def replicas(self, key: str, n: int = 2) -> List[str]:
        """Owner plus the next distinct successor members, <= n total."""
        if not self._points or n < 1:
            return []
        out: List[str] = []
        pos = _position(key)
        idx = bisect.bisect_right(self._points, pos)
        for step in range(len(self._points)):
            member = self._owner_at[self._points[(idx + step) % len(self._points)]]
            if member not in out:
                out.append(member)
                if len(out) >= n:
                    break
        return out

    def summary(self, sample: int = 64) -> dict:
        """Ownership summary for /network?scope=dht: share estimates by
        sampling ``sample`` evenly spaced ring positions per member count
        (exact arc math is O(points) too — sampling keeps the view cheap
        and is plenty for an operator eyeballing balance)."""
        if not self._points:
            return {"members": 0, "points": 0, "share": {}}
        share: Dict[str, int] = {}
        span = (1 << 64) // max(1, sample)
        for i in range(sample):
            owner = self._owner_at_pos(i * span)
            share[owner] = share.get(owner, 0) + 1
        return {
            "members": len(self._members),
            "points": len(self._points),
            "share": {m: c / sample for m, c in sorted(share.items())},
        }
