"""Collectives over per-shard lists: the ``jax.lax`` collectives of the JAX
package's ``parallel/*`` for the port's one-controller mesh.

Each function takes ``xs``, one tensor per shard of ``mesh`` (``xs[i]`` on
``mesh.devices[i]``), and returns one result per shard, each on its own
shard's device.  Every result is computed from the inputs as given, never
from a partly updated list, so a caller may rebind its list to the result
in one statement.  The reductions keep the input's dtype: an int32 psum
stays int32 (and wraps as JAX's uint32 sums of bit patterns do), so no
int64 mask can reach a kernel.  Results replicated over shards that share
a device are one tensor; the drivers never write them in place.
"""

from __future__ import annotations

import torch

from distributed_sudoku_solver_tpu_torch.parallel.mesh import Mesh


def _stacked(xs, mesh: Mesh) -> torch.Tensor:
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} shards given for a mesh of {mesh.size}")
    d0 = mesh.devices[0]
    return torch.stack([x.to(d0) for x in xs])


def replicate(x: torch.Tensor, mesh: Mesh) -> list:
    return [x.to(d) for d in mesh.devices]


def psum(xs, mesh: Mesh) -> list:
    """Sum over shards, in the input's dtype (bool is refused, as in JAX)."""
    if xs[0].dtype == torch.bool:
        raise TypeError("psum takes numbers; cast bool flags to int32 first")
    return replicate(_stacked(xs, mesh).sum(0, dtype=xs[0].dtype), mesh)


def pmin(xs, mesh: Mesh) -> list:
    return replicate(_stacked(xs, mesh).amin(0), mesh)


def pmax(xs, mesh: Mesh) -> list:
    return replicate(_stacked(xs, mesh).amax(0), mesh)


def all_gather(xs, mesh: Mesh, axis: int = 0, tiled: bool = False) -> list:
    """Every shard's value on every shard: stacked on a new leading axis,
    or, with ``tiled``, concatenated along ``axis``."""
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} shards given for a mesh of {mesh.size}")
    d0 = mesh.devices[0]
    parts = [x.to(d0) for x in xs]
    out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts)
    return replicate(out, mesh)


def ppermute(xs, perm, mesh: Mesh) -> list:
    """``out[dst] = xs[src]`` for each ``(src, dst)`` of ``perm``; a shard
    that is no destination gets zeros, as in JAX."""
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} shards given for a mesh of {mesh.size}")
    out = [torch.zeros_like(x) for x in xs]
    seen = set()
    for src, dst in perm:
        if dst in seen:
            raise ValueError(f"ppermute: shard {dst} is a destination twice")
        seen.add(dst)
        out[dst] = xs[src].to(mesh.devices[dst])
    return out


def axis_index(mesh: Mesh) -> list:
    """Each shard's index, as an int32 scalar on its device."""
    return [torch.tensor(i, dtype=torch.int32, device=d) for i, d in enumerate(mesh.devices)]


def ring_forward(n_dev: int) -> list:
    """The ring ``i -> i + 1``: a donor's payload to its successor."""
    return [(i, (i + 1) % n_dev) for i in range(n_dev)]


def ring_backward(n_dev: int) -> list:
    """The ring ``i -> i - 1``: a request to the predecessor."""
    return [(i, (i - 1) % n_dev) for i in range(n_dev)]
