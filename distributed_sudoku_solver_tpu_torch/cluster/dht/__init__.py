"""The DHT plane the reference paper only claimed to have.

Three stdlib-only pieces, composed by ``cluster/node.py``:

* ``hashring``   — consistent-hash ownership of the canonical-key space
  (the front door's symmetry-canonical digest): virtual-node ring over member
  addresses, ``owner(digest)`` plus a replica set, bounded key movement
  on join/leave.
* ``membership`` — SWIM-style gossip: one probe per beat with
  piggybacked state, suspicion before death, incarnation numbers for
  refutation.  O(1) per-beat traffic regardless of ring size, riding
  the node's existing (term,epoch) guard machinery for the
  authoritative view.
* ``cluster_cache`` — the cluster-wide result cache: lookup/store
  routed to the digest's owner over CACHE_GET/CACHE_PUT frames with the
  wire's at-least-once dedupe + retry budget.  Entries are plain
  JSON-ready dicts here; the dict <-> ``frontdoor.CacheEntry`` glue
  lives in ``cluster/node.py`` so this layer stays stdlib-closed
  (layerck: ``cluster.dht`` imports no jax, no numpy, no serving).

Every timing decision routes through an injected clock and every wire
interaction through injected callables — the simnet lane drives
hundreds of virtual DHT nodes deterministically.
"""

from distributed_sudoku_solver_tpu_torch.cluster.dht.cluster_cache import ClusterCache
from distributed_sudoku_solver_tpu_torch.cluster.dht.hashring import HashRing
from distributed_sudoku_solver_tpu_torch.cluster.dht.membership import (
    ALIVE,
    DEAD,
    SUSPECT,
    Gossip,
)

__all__ = ["HashRing", "Gossip", "ClusterCache", "ALIVE", "SUSPECT", "DEAD"]
