"""Mesh-resident serving programs: the resident flight's lane axis sharded
over a mesh.

Port of the JAX package's ``parallel/mesh_resident.py``.  The single-device
resident flight (``serving/scheduler.py``) keeps one long-lived frontier
per geometry and admits traffic between chunks; these are its mesh twins,
with the same slot / gang / attach / detach / status contract:

* **Slots are placed per shard.**  Total slots ``J = per_shard * D``;
  slot ``s`` lives on shard ``s // per_shard`` and its gang of lanes
  ``[s*gang, (s+1)*gang)`` falls inside that shard.  An attach touches one
  shard's lanes; the per-job rows are replicated and reset everywhere.
* **Cross-shard steal, minus home lanes.**  The ring steal of
  :mod:`.sharded`, but a slot's home lane (``slot * gang``) never receives
  a foreign row: the next attach overwrites it, so a row parked there
  would be lost (a false unsat).
* **Per-round merge** of solved flags and solutions, as in the bulk tier.
* **Counters re-replicate at the chunk boundary**: each shard's step
  scatters its own harvests into its copy of ``nodes`` / ``sol_count``,
  so the advance returns ``base + psum(delta)`` and any shard's rows read
  exact global counts between chunks.
* **One status word per chunk**: ``ops.frontier.chunk_status``'s layout
  with the lane reductions summed over shards, then the ring-steal volume
  and the live / foreign-live lanes of each shard (one all_gather).
  :func:`unpack_mesh_status` is the host's inverse.

The state is a list of per-shard ``Frontier``s.  Composite step only, as in
JAX: ``serving/mesh_scheduler.py`` downgrades a fused base config.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    SolverConfig,
    _pack_bits,
    _scatter_max_bool,
    _set_rows,
    detach,
    frontier_live,
    init_frontier_roots,
    status_len,
    unpack_status,
)
from distributed_sudoku_solver_tpu_torch.ops.solve import sudoku_csp
from distributed_sudoku_solver_tpu_torch.parallel import collectives as C
from distributed_sudoku_solver_tpu_torch.parallel.mesh import Mesh
from distributed_sudoku_solver_tpu_torch.parallel.sharded import _sharded_step_counted

# Mesh extension of the packed status word: the base ``status_len(J)``
# words are followed by
#   [base]                 ring-steal rows installed this chunk (all shards)
#   [base+1 : base+1+D]    live lanes per shard
#   [base+1+D : base+1+2D] live lanes per shard working a FOREIGN job (one
#                          whose home shard is elsewhere)
MESH_STATUS_RING = 0  # offsets relative to status_len(n_jobs)

_COUNTERS = ("nodes", "sol_count", "sweeps", "expansions", "steals")


def mesh_status_len(n_jobs: int, n_dev: int) -> int:
    return status_len(n_jobs) + 1 + 2 * n_dev


def unpack_mesh_status(status, n_jobs: int, n_dev: int) -> dict:
    """Host-side inverse of the mesh status word: ``ops.frontier.unpack_status``'s
    dict plus ``{ring_shipped, shard_live int64[D], shard_foreign int64[D]}``."""
    if isinstance(status, torch.Tensor):
        status = status.cpu().numpy()
    status = np.asarray(status)
    base = status_len(n_jobs)
    out = unpack_status(status[:base], n_jobs)
    out["ring_shipped"] = int(status[base + MESH_STATUS_RING])
    out["shard_live"] = status[base + 1:base + 1 + n_dev].astype(np.int64)
    out["shard_foreign"] = status[base + 1 + n_dev:base + 1 + 2 * n_dev].astype(np.int64)
    return out


def _home_excluded(n_local: int, gang: int, device) -> torch.Tensor:
    """bool[n_local]: lanes allowed to receive ring-stolen rows.  Gangs are
    shard-contained, so home lanes are exactly the locally gang-aligned ones."""
    return (torch.arange(n_local, dtype=torch.int32, device=device) % gang) != 0


def mesh_advance_status(states, steps_delta: int, geom: Geometry, config: SolverConfig,
                        mesh: Mesh):
    """One mesh-resident serving chunk: advance every shard in lockstep by at
    most ``steps_delta`` rounds; returns ``(new states, mesh status)``, the
    status an int32 tensor on the first shard's device.

    The loop condition is read on the host once per round: the liveness
    term folded into the round's one psum (one round late, as in JAX) and
    the step limit, formed on the device from the replicated counter."""
    n_dev = mesh.size
    d0 = mesh.devices[0]
    st0 = states[0]
    n_jobs = st0.solved.shape[0]
    per_shard = n_jobs // n_dev
    n_local = st0.has_top.shape[0]
    problem = sudoku_csp(geom, config)
    prev_steps = [s.steps for s in states]
    prev_rounds = [s.lane_rounds for s in states]
    base_counts = {name: getattr(st0, name) for name in _COUNTERS}
    limit = torch.clamp(st0.steps.to(d0) + int(steps_delta), max=config.max_steps)
    gang = max(config.steal_gang, 1)
    install_ok = [_home_excluded(n_local, gang, d) for d in mesh.devices]

    go = torch.stack([frontier_live(s).any().to(d0) for s in states]).any()
    ring = [torch.zeros((), dtype=torch.int32, device=d) for d in mesh.devices]
    while bool(go & (states[0].steps.to(d0) < limit)):
        states, shipped, live_count = _sharded_step_counted(
            states, problem, config, mesh, ring_install_ok=install_ok)
        ring = [r + s for r, s in zip(ring, shipped)]
        go = live_count > 0

    # --- the whole chunk boundary as ONE fused psum --------------------------
    fused, lives, foreign = [], [], []
    for i, st in enumerate(states):
        live = frontier_live(st)
        has_work = _scatter_max_bool(n_jobs, torch.clamp(st.job, 0, n_jobs - 1), live)
        delta = st.lane_rounds - prev_rounds[i]
        chunk_rounds = torch.clamp(st.steps - prev_steps[i], min=1)
        bucket = torch.clamp(torch.div(delta * 10, chunk_rounds, rounding_mode="floor"), 0, 9)
        hist = torch.zeros(10, dtype=torch.int32, device=delta.device)
        hist.scatter_add_(0, bucket.long(), torch.ones_like(bucket))
        fused.append(torch.cat(
            [(getattr(st, name) - base_counts[name].to(delta.device)).to(torch.int32).reshape(-1)
             for name in _COUNTERS]
            + [has_work.to(torch.int32), delta.sum(dtype=torch.int32).reshape(1), hist,
               ring[i].reshape(1)]))
        lives.append(live.sum(dtype=torch.int32))
        foreign.append((live & (torch.div(st.job, per_shard, rounding_mode="floor") != i))
                       .sum(dtype=torch.int32))
    total = C.psum(fused, mesh)[0]
    widths = (n_jobs, n_jobs, 1, 1, 1, n_jobs, 1, 10, 1)
    parts, o = [], 0
    for w in widths:
        parts.append(total[o:o + w])
        o += w
    nodes_d, sol_d, sweeps_d, exp_d, steals_d, hw, live_sum, hist, ring_sum = parts
    counts = {
        "nodes": base_counts["nodes"].to(d0) + nodes_d,
        "sol_count": base_counts["sol_count"].to(d0) + sol_d,
        "sweeps": base_counts["sweeps"].to(d0) + sweeps_d[0],
        "expansions": base_counts["expansions"].to(d0) + exp_d[0],
        "steals": base_counts["steals"].to(d0) + steals_d[0],
    }
    if not config.count_all:
        counts["sol_count"] = torch.clamp(counts["sol_count"], max=1)
    rep = {name: C.replicate(v, mesh) for name, v in counts.items()}
    states = [st._replace(**{name: rep[name][i] for name in _COUNTERS})
              for i, st in enumerate(states)]

    gathered = C.all_gather([torch.stack([a, b]) for a, b in zip(lives, foreign)], mesh)[0]
    st0 = states[0]
    status = torch.cat([
        torch.stack([st0.steps.to(d0).to(torch.int32), live_sum[0]]),
        hist,
        _pack_bits(st0.solved.to(d0)),
        _pack_bits(hw > 0),
        ring_sum,
        gathered[:, 0],
        gathered[:, 1],
    ])
    return states, status


def mesh_init_resident(geom: Geometry, config: SolverConfig, n_slots: int, mesh: Mesh) -> list:
    """The empty resident frontier, born sharded: each shard's lane block
    idle, the per-job rows zeros everywhere."""
    n_local = config.lanes // mesh.size
    local_cfg = dataclasses.replace(config, lanes=n_local, min_lanes=n_local)
    return [
        init_frontier_roots(
            torch.zeros((n_local, geom.n, geom.n), dtype=torch.int32, device=d),
            torch.full((n_local,), -1, dtype=torch.int32, device=d), n_slots, local_cfg)
        for d in mesh.devices
    ]


def mesh_attach(states, grids: torch.Tensor, slot_ids: torch.Tensor, geom: Geometry, gang: int,
                mesh: Mesh) -> list:
    """``ops.frontier.attach_roots`` on the sharded resident state: int
    ``grids`` [K, n, n] land on the shard owning each slot's home lane
    (global lane ``slot * gang``, rebased by the shard's offset; other
    shards drop them); the per-job resets are replicated."""
    roots = encode_grid(grids.to(torch.int32), geom)
    out = []
    for i, (st, dev) in enumerate(zip(states, mesh.devices)):
        n_local = st.has_top.shape[0]
        n_jobs = st.solved.shape[0]
        r = roots.to(dev).to(torch.int32)
        ids = slot_ids.to(dev).to(torch.int32)
        off = i * n_local
        ok = ids >= 0
        lane_g = ids * gang
        mine = ok & (lane_g >= off) & (lane_g < off + n_local)
        lane = torch.where(mine, lane_g - off, torch.full_like(ids, n_local))
        slot = torch.where(ok, ids, torch.full_like(ids, n_jobs))
        out.append(st._replace(
            top=_set_rows(st.top, lane, r),
            has_top=_set_rows(st.has_top, lane, mine),
            job=_set_rows(st.job, lane, ids),
            base=_set_rows(st.base, lane, 0),
            count=_set_rows(st.count, lane, 0),
            solved=_set_rows(st.solved, slot, False),
            solution=_set_rows(st.solution, slot, 0),
            overflowed=_set_rows(st.overflowed, slot, False),
            nodes=_set_rows(st.nodes, slot, 0),
            sol_count=_set_rows(st.sol_count, slot, 0),
        ))
    return out


def mesh_detach(states, slot_mask: torch.Tensor, mesh: Mesh) -> list:
    """``ops.frontier.detach`` per shard: lanes clear by their local job
    tags (which travel with ring-stolen rows, so a leaving job's foreign
    rows clear too); the per-job resets are replicated."""
    return [detach(st, slot_mask.to(d)) for st, d in zip(states, mesh.devices)]
