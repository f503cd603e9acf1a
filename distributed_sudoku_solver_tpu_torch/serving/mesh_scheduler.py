"""Pod-scale resident serving: the resident flight sharded over a mesh.

Port of the JAX package's ``serving/mesh_scheduler.py``.
``MeshResidentFlight`` IS a ``ResidentFlight``: the same admission queue,
FIFO fairness, deadlines, cancel, 429 backpressure, breaker-guarded
rebuild and one-sync-per-chunk loop, all inherited.  What changes is the
strategy under the hooks:

* the device programs are the mesh twins (``parallel/mesh_resident.py``):
  lane axis sharded over a 1-D mesh, per-round solved merge, cross-shard
  ring steal with home lanes excluded from installs;
* ``job_slots`` is the PER-SHARD slot count: the pool is ``job_slots *
  mesh_devices``, so admission capacity scales with the mesh while the
  per-job gang width stays fixed;
* the status word carries mesh telemetry (ring-steal volume, per-shard
  live / foreign-live lanes), decoded by ``_unpack`` into
  ``metrics()["mesh"]``: still ONE ``host_fetch`` per chunk;
* a failed program (a lost shard, or an injected fault at the ``mesh.*``
  sites) takes ``ResidentFlight.on_failure``'s path: a transient fault
  drops the state, requeues the held jobs and rebuilds through the
  breaker; a permanent one (``ops.cuda_build.KernelError``) fails them
  over to static flights, as on one device.

Composite step only: no fused resident twin exists, so a fused base config
runs the composite step here (``fused_downgraded`` in the mesh metrics
counts it); the single-device flight and the bulk fused-sharded tier are
unaffected.  Slot ``s`` lives on shard ``s // job_slots``.  With
``gang_lanes == 1`` every lane is a home lane and cross-shard steal has no
install capacity.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.obs import compilewatch, lockdep
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.parallel.mesh import make_mesh, visible_devices
from distributed_sudoku_solver_tpu_torch.parallel.mesh_resident import (
    mesh_advance_status,
    mesh_attach,
    mesh_detach,
    mesh_init_resident,
    unpack_mesh_status,
)
from distributed_sudoku_solver_tpu_torch.serving import engine as engine_mod
from distributed_sudoku_solver_tpu_torch.serving import faults
from distributed_sudoku_solver_tpu_torch.serving.scheduler import (
    ResidentConfig,
    ResidentFlight,
    resident_solver_config,
)


class MeshResidentFlight(ResidentFlight):
    """One long-lived MESH-resident frontier: ``ResidentFlight`` with the
    device programs swapped for the mesh twins.

    Raises ``ValueError`` when ``rcfg.mesh_devices < 2`` or more devices are
    requested than are visible (``parallel.mesh.visible_devices`` of the
    engine's device): the engine then serves on the single-device flight
    and counts ``mesh_unfit``, never silently under-sharded."""

    def __init__(self, engine, geom: Geometry, rcfg: ResidentConfig):
        n_dev = rcfg.mesh_devices
        if n_dev < 2:
            raise ValueError(f"mesh_devices must be >= 2 for a mesh flight, got {n_dev}")
        devices = visible_devices(engine.device)
        if len(devices) < n_dev:
            raise ValueError(f"mesh_devices={n_dev} but only {len(devices)} visible")
        self.mesh = make_mesh(devices[:n_dev])
        self.mesh_devices = n_dev
        self.fused_downgraded = 0
        super().__init__(engine, geom, rcfg)
        # Mesh telemetry decoded from the chunk status word (_unpack runs on
        # the device loop; metrics() reads from any thread).
        self._mesh_lock = lockdep.named_lock("serving.mesh_scheduler")  # lockck: name(serving.mesh_scheduler)
        self.ring_shipped = 0  # lockck: guard(_mesh_lock)
        self._shard_live = np.zeros(n_dev, np.int64)  # lockck: guard(_mesh_lock)
        self._shard_foreign = np.zeros(n_dev, np.int64)  # lockck: guard(_mesh_lock)

    # -- strategy hooks ------------------------------------------------------
    def _solver_config(self, base: SolverConfig, geom: Geometry, rcfg: ResidentConfig
                       ) -> SolverConfig:
        if base.step_impl == "fused":
            base = dataclasses.replace(base, step_impl="xla")
            self.fused_downgraded += 1
        # Home lanes never receive stolen rows on the mesh: ring steal makes
        # gangs tag-heterogeneous, and a foreign row relayed onto a freed
        # slot's home lane is destroyed by the next attach (a false unsat).
        base = dataclasses.replace(base, protect_home_lanes=True)
        total = dataclasses.replace(rcfg, job_slots=rcfg.job_slots * rcfg.mesh_devices)
        return resident_solver_config(base, geom, total)

    def _unpack(self, raw) -> dict:
        status = unpack_mesh_status(raw, self.n_slots, self.mesh_devices)
        with self._mesh_lock:
            self.ring_shipped += status["ring_shipped"]
            self._shard_live = status["shard_live"]
            self._shard_foreign = status["shard_foreign"]
        return status

    def _init_state(self):
        return mesh_init_resident(self.geom, self.config, self.n_slots, self.mesh)

    def _attach_state(self, grids: np.ndarray, slot_ids: np.ndarray):
        if faults.active() is not None:
            faults.fire("mesh.attach")
        d0 = self.mesh.devices[0]
        return mesh_attach(self.state, engine_mod.to_device(grids, d0),
                           engine_mod.to_device(slot_ids, d0), self.geom, self.gang, self.mesh)

    def _detach_state(self, slot_mask: np.ndarray):
        if faults.active() is not None:
            faults.fire("mesh.detach")
        return mesh_detach(self.state, engine_mod.to_device(slot_mask, self.mesh.devices[0]),
                           self.mesh)

    def _verdict_state(self):
        # Per-job rows are replicated, their counters re-replicated at
        # every chunk boundary: any shard's copy holds the verdicts.
        return self.state[0]

    def _rebase_state(self):
        return [s._replace(steps=torch.zeros_like(s.steps),
                           lane_rounds=torch.zeros_like(s.lane_rounds)) for s in self.state]

    def _advance_program(self) -> str:
        return compilewatch.MESH_ADVANCE_STATUS

    def _advance_state(self):
        if faults.active() is not None:
            faults.fire("mesh.advance", uuids=tuple(j.uuid for j in self.slots if j is not None))
        return mesh_advance_status(self.state, self.rcfg.chunk_steps, self.geom, self.config,
                                   self.mesh)

    # -- any-thread surface --------------------------------------------------
    def admission_pressure(self) -> tuple:
        """Mesh-aware brownout signal: pending jobs that fit the mesh's FREE
        shard slots attach on the next chunk, so they exert no sustained
        queue pressure; that headroom is subtracted before normalizing.  A
        full pool reads as the single-device flight does."""
        with self._lock:
            pending = len(self._pending)
            free = sum(1 for s in self.slots if s is None)
        frac = max(0, pending - free) / float(self.rcfg.queue_depth)
        aw = self.admission_wait.snapshot()
        return frac, (aw["p95"] if aw else 0.0)

    def metrics(self) -> dict:
        out = super().metrics()
        per = self.rcfg.job_slots
        with self._lock:
            occupancy = [
                sum(1 for s in self.slots[d * per:(d + 1) * per] if s is not None)
                for d in range(self.mesh_devices)
            ]
        with self._mesh_lock:
            out["mesh"] = {
                "devices": self.mesh_devices,
                "slot_occupancy": occupancy,  # per-shard occupied slots
                "shard_live_lanes": [int(x) for x in self._shard_live],
                "shard_foreign_lanes": [int(x) for x in self._shard_foreign],
                "ring_shipped": int(self.ring_shipped),
                "rebuilds": int(self.rebuilds),
                "fused_downgraded": int(self.fused_downgraded),
            }
        return out
