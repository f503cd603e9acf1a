"""The device mesh of the port: an ordered list of shards, one device each.

Port of the JAX package's ``parallel/mesh.py``.  JAX runs a mesh program as
one SPMD program under ``shard_map`` from one controller; the port's
counterpart is one process as well.  A :class:`Mesh` holds one
``torch.device`` per shard (a device may repeat), and the sharded drivers
keep per-shard tensors in Python lists and advance them in lockstep
phases: local work on every shard, a collective over the lists
(:mod:`.collectives`), local work again.

:func:`virtual_devices` is the counterpart of XLA's forced host device
count: inside it, :func:`visible_devices` gives ``n`` copies of one device,
so a mesh of ``n`` shards runs on one card or on the CPU.  Only the tests
and ``chip_smoke.py`` enter it; no default does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Iterator, Optional, Sequence

import torch

# Name of the mesh axis the frontier lane dimension is sharded over.
LANE_AXIS = "lanes"

_virtual_lock = threading.Lock()
_virtual_count = 0  # > 0 inside virtual_devices(n): n shards on one device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices[i]`` holds shard ``i``."""

    devices: tuple
    axis_name: str = LANE_AXIS

    def __post_init__(self) -> None:
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


@contextlib.contextmanager
def virtual_devices(n: int) -> Iterator[None]:
    """Within the block, :func:`visible_devices` gives ``n`` copies of the
    device it is asked about (the forced host device count of XLA)."""
    global _virtual_count
    if n < 1:
        raise ValueError(f"virtual_devices needs n >= 1, got {n}")
    with _virtual_lock:
        before, _virtual_count = _virtual_count, n
    try:
        yield
    finally:
        with _virtual_lock:
            _virtual_count = before


def visible_devices(device) -> list:
    """The devices a mesh on ``device``'s platform may use: every visible
    CUDA card (the CPU is one device), or ``n`` copies of ``device``
    inside :func:`virtual_devices`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _virtual_lock:
        n = _virtual_count
    if n:
        return [device] * n
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = LANE_AXIS,
              device=None) -> Mesh:
    """A 1-D mesh over ``devices`` (default: every visible device of
    ``device``'s platform; ``device=None`` means CUDA and raises without it)."""
    if devices is None:
        from distributed_sudoku_solver_tpu_torch.ops.solve import resolve_device

        devices = visible_devices(resolve_device(device))
    return Mesh(tuple(devices), axis_name)


def default_mesh(device=None) -> Mesh:
    return make_mesh(device=device)
