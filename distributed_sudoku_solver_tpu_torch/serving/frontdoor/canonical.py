"""Symmetry-canonical forms under the sudoku equivalence group.

Two boards are *equivalent* when one maps to the other by a composition of
the standard validity-preserving symmetries:

* digit relabeling (any permutation of 1..n; empty cells stay empty),
* row permutations within a band, and band permutations,
* column permutations within a stack, and stack permutations,
* transpose (square-box geometries only — transposing a 2x3-box board
  yields the conjugate 3x2 geometry, a different board family).

For 9x9 that is 2 * (3! * 3!^3)^2 cell transforms (~3.36 million) times
9! relabelings — the ~3x10^6 published-puzzle aliasing the result cache
collapses.  :func:`canonicalize` returns the *orbit minimum*: the
lexicographically least grid (row-major, empty=0 sorting first, digits
relabeled by first appearance) over the full group, plus the transform
that maps the submitted board onto it.  Equivalent boards therefore
produce byte-identical canonical forms, and the transform's inverse maps
a cached canonical solution back to the submitted frame bit-exactly
(:func:`restore_solution`).

Pure host-side stdlib + numpy — no jax, no device.  The search is exact,
not heuristic, and fully vectorized: a frontier of partial candidates
(one per surviving column-transform/row-prefix/relabel-map combination)
advances one canonical row per step, keeping only prefix-minimal states
— every state proposes its legal next rows, all proposals are relabeled
under their states' partial digit maps in one batched numpy pass, and
only proposals matching the minimal relabeled row survive.  States whose
futures are provably identical (same partial map, same remaining row
content) deduplicate through an ``np.unique`` over integer key rows.
The walk's shape is conjugation-invariant, so the ``max_states`` safety
cap — which declares a pathologically symmetric board *uncacheable*
rather than burning CPU on it — triggers identically for every
representative of an orbit (the cache stays consistent).

Geometries whose column-transform count exceeds ``_MAX_COL_TRANSFORMS``
(16x16 and up: 24 * 24^4 per side) are uncacheable by policy: the exact
minimization is no longer enumerable host-side, and interactive repeat
traffic is 9x9-and-below in practice.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import itertools
from typing import Optional

import numpy as np

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry

#: Column-transform enumeration bound: 9x9 (3! * 3!^3 = 1296) is in,
#: 12x12 (3! * 4!^3 = 82944) and 16x16 (24 * 24^4) are out.
_MAX_COL_TRANSFORMS = 1500

#: Frontier-walk safety cap (see module docstring): orbit-invariant, so
#: "too symmetric to canonicalize cheaply" is a property of the board's
#: orbit, never of which representative arrived.  Measured frontiers on
#: real boards stay well under 100 states after deduplication.
MAX_STATES = 4096

#: Sorts after every real packed row in the dedupe keys (packed rows use
#: at most 62 bits, all non-negative).
_SENTINEL = np.int64(1) << 62


@dataclasses.dataclass(frozen=True)
class Transform:
    """A group element mapping a submitted board onto its canonical form.

    ``canonical[r, c] = relabel[g[row_perm[r], col_perm[c]]]`` where ``g``
    is the submitted grid, transposed first when ``transpose`` is set.
    ``relabel`` has length n+1 with ``relabel[0] == 0`` (empty is fixed);
    it is the greedy first-appearance map of the canonical scan, completed
    deterministically (unseen digits take the remaining labels in
    ascending digit order) so a full solution grid round-trips.
    """

    transpose: bool
    row_perm: tuple
    col_perm: tuple
    relabel: tuple


@dataclasses.dataclass(frozen=True)
class CanonicalForm:
    grid: np.ndarray  # int8[n, n], the orbit-minimal representative
    transform: Transform  # submitted frame -> canonical frame
    geom: Geometry

    @property
    def digest(self) -> str:
        """Content address of the orbit: sha256 over geometry + canonical
        bytes.  Distinct orbits collide only if sha256 does."""
        h = hashlib.sha256()
        h.update(f"{self.geom.box_h}x{self.geom.box_w}:".encode())
        h.update(np.ascontiguousarray(self.grid, dtype=np.uint8).tobytes())
        return h.hexdigest()


def apply_transform(grid, tr: Transform) -> np.ndarray:
    """Apply ``tr`` to a grid (puzzle or full solution) — submitted frame
    into the canonical frame."""
    g = np.asarray(grid)
    if tr.transpose:
        g = g.T
    rel = np.asarray(tr.relabel, dtype=g.dtype)
    return rel[g[np.ix_(np.asarray(tr.row_perm), np.asarray(tr.col_perm))]]


def restore_solution(canon_grid, tr: Transform) -> np.ndarray:
    """Invert ``tr``: map a canonical-frame grid (typically the cached
    solution) back to the submitted frame, bit-exactly."""
    c = np.asarray(canon_grid)
    n = c.shape[0]
    inv_rel = np.zeros(n + 1, dtype=c.dtype)
    for v, lab in enumerate(tr.relabel):
        inv_rel[lab] = v
    out = np.zeros_like(c)
    out[np.ix_(np.asarray(tr.row_perm), np.asarray(tr.col_perm))] = inv_rel[c]
    if tr.transpose:
        out = out.T
    return out


def random_transform(geom: Geometry, rng: np.random.Generator) -> Transform:
    """A uniformly random group element (the generator-composition tests
    and the bench's symmetry-transformed repeats both draw from here)."""
    n, bh, bw = geom.n, geom.box_h, geom.box_w
    row_perm = np.concatenate(
        [band * bh + rng.permutation(bh) for band in rng.permutation(geom.n_vboxes)]
    )
    col_perm = np.concatenate(
        [stack * bw + rng.permutation(bw) for stack in rng.permutation(geom.n_hboxes)]
    )
    relabel = np.concatenate([[0], rng.permutation(n) + 1])
    transpose = bool(bh == bw and rng.integers(2))
    return Transform(
        transpose=transpose,
        row_perm=tuple(int(r) for r in row_perm),
        col_perm=tuple(int(c) for c in col_perm),
        relabel=tuple(int(v) for v in relabel),
    )


@functools.lru_cache(maxsize=8)
def _col_transforms(box_w: int, n_stacks: int) -> Optional[np.ndarray]:
    """Every stack-respecting column order as an index array [C, n], or
    None when C exceeds the enumeration bound."""
    count = 1
    for k in range(2, n_stacks + 1):
        count *= k
    inner = 1
    for k in range(2, box_w + 1):
        inner *= k
    count *= inner**n_stacks
    if count > _MAX_COL_TRANSFORMS:
        return None
    stack_perms = list(itertools.permutations(range(n_stacks)))
    within = list(itertools.permutations(range(box_w)))
    orders = []
    for sp in stack_perms:
        for combo in itertools.product(within, repeat=n_stacks):
            order = []
            for pos, stack in enumerate(sp):
                order.extend(stack * box_w + w for w in combo[pos])
            orders.append(order)
    return np.asarray(orders, dtype=np.int64)


def _relabel_rows(rows: np.ndarray) -> np.ndarray:
    """First-appearance relabel of each row independently (vectorized):
    zeros stay zero; the j-th distinct nonzero value becomes j+1."""
    m, n = rows.shape
    eq = rows[:, None, :] == rows[:, :, None]  # eq[b, j, k]: rows[b,k]==rows[b,j]
    first = eq.argmax(axis=2)  # first index holding this value
    nz = rows != 0
    is_first = (first == np.arange(n)) & nz
    ranks = np.cumsum(is_first, axis=1)
    labels = np.take_along_axis(ranks, first, axis=1)
    return np.where(nz, labels, 0)


def _pack(rows: np.ndarray, n: int, bits: int) -> np.ndarray:
    shifts = (bits * (n - 1 - np.arange(n))).astype(np.int64)
    return (rows.astype(np.int64) << shifts).sum(axis=-1)


def canonicalize(
    grid, geom: Geometry, max_states: int = MAX_STATES
) -> Optional[CanonicalForm]:
    """The orbit-minimal form of ``grid`` under the full equivalence
    group, or None when the board is uncacheable (geometry beyond the
    enumeration bound, or a pathologically symmetric orbit tripping the
    conjugation-invariant ``max_states`` cap)."""
    n, bh, bw = geom.n, geom.box_h, geom.box_w
    nb = geom.n_vboxes
    bits = max(1, int(n).bit_length())
    if n * bits > 62:  # packed-row comparison must fit one int64
        return None
    ci = _col_transforms(bw, geom.n_hboxes)
    if ci is None:
        return None
    g = np.asarray(grid, dtype=np.int64)
    if g.shape != (n, n) or g.min() < 0 or g.max() > n:
        raise ValueError(f"grid must be int[{n},{n}] in 0..{n}, got {g.shape}")

    # Candidate-row tensor: aa[s, r] = source row r under the column
    # order of flat state s (transpose frame stacked after the plain one
    # — transpose is only in the group for square boxes; a non-square-box
    # transpose belongs to the conjugate geometry).
    c_count = ci.shape[0]
    g8 = g.astype(np.int8)  # n <= 25: int8 keeps the transform tensor small
    frames = [g8] if bh != bw else [g8, g8.T.copy()]
    aa = np.concatenate(
        [gf[:, ci].transpose(1, 0, 2) for gf in frames]
    )  # (S0, n, n) int8 with S0 = len(frames) * C
    s0 = aa.shape[0]
    band_of_row = np.repeat(np.arange(nb), bh)
    one_bit_weights = np.int64(1) << np.arange(n - 1, -1, -1, dtype=np.int64)
    # Level-0 skeleton scan: every candidate first row's empty/filled
    # pattern, packed one bit per cell (matmul: one pass, no int64
    # temporaries).  Computed on the whole transform set — everything
    # heavier below only ever touches the tiny surviving slice.
    patt0 = (aa != 0) @ one_bit_weights  # (S0, n)

    # Frontier state (one row per surviving partial candidate):
    fc = np.arange(s0)  # flat column-transform/frame id
    used = np.zeros((s0, n), dtype=bool)  # source rows consumed
    maps = np.zeros((s0, n + 1), dtype=np.int64)  # digit -> label (0 = unset)
    sizes = np.zeros(s0, dtype=np.int64)  # labels assigned so far
    last_band = np.full(s0, -1, dtype=np.int64)
    row_hist = np.zeros((s0, 0), dtype=np.int64)  # chosen source rows, in order

    canon_rows = []
    for _level in range(n):
        s = fc.shape[0]
        if _level == 0:
            # Every row of every transform is legal; the skeleton scan is
            # the exact prefilter (0 sorts before any label, so only
            # pattern-minimal rows can win the relabeled comparison).
            sidx, rsel = np.nonzero(patt0 == patt0.min())
        else:
            # Legal next rows: the current band's remaining rows while it
            # is incomplete, else any row of an untouched band.
            band_counts = used.reshape(s, nb, bh).sum(axis=2)
            lb_count = np.take_along_axis(
                band_counts, last_band[:, None], axis=1
            )[:, 0]
            in_cur = lb_count < bh
            allowed_cur = (band_of_row[None, :] == last_band[:, None]) & ~used
            allowed_new = (band_counts[:, band_of_row] == 0) & ~used
            allowed = np.where(in_cur[:, None], allowed_cur, allowed_new)
            sidx, rsel = np.nonzero(allowed)
        vals = aa[fc[sidx], rsel]  # (P, n) raw row values
        # Same exact skeleton prefilter on the in-walk proposals.
        patt = (vals != 0) @ one_bit_weights
        pre = np.flatnonzero(patt == patt.min())
        sidx, rsel, vals = sidx[pre], rsel[pre], vals[pre]
        # Batched greedy relabel under each proposal's partial map: mapped
        # digits read their label, unmapped nonzero digits get fresh
        # labels in first-appearance order starting at the map's size.
        base = np.take_along_axis(maps[sidx], vals, axis=1)
        unm = (vals > 0) & (base == 0)
        fresh = _relabel_rows(np.where(unm, vals, 0))
        final = base + np.where(fresh > 0, fresh + sizes[sidx, None], 0)

        packed = _pack(final, n, bits)
        best = packed.min()
        surv = np.flatnonzero(packed == best)
        canon_rows.append(np.asarray(final[surv[0]], dtype=np.int8))

        # Advance the surviving proposals into the next frontier.
        sidx_s, r_s = sidx[surv], rsel[surv]
        fc = fc[sidx_s]
        used = used[sidx_s].copy()
        used[np.arange(surv.size), r_s] = True
        maps = maps[sidx_s].copy()
        u0, u1 = np.nonzero(unm[surv])
        maps[u0, vals[surv][u0, u1]] = final[surv][u0, u1]
        sizes = sizes[sidx_s] + fresh[surv].max(axis=1)
        last_band = band_of_row[r_s]
        row_hist = np.concatenate([row_hist[sidx_s], r_s[:, None]], axis=1)

        # Dedupe states with provably identical futures: same partial
        # map, same remaining rows of the current band, same multiset of
        # untouched-band contents (sorted; consumed slots -> sentinel).
        # Pure pruning — skipping it on an already-tiny frontier is
        # cheaper than running it.
        k = fc.shape[0]
        if k <= 4:
            if k > max_states:  # pragma: no cover - k <= 4 here
                return None
            continue
        band_counts = used.reshape(k, nb, bh).sum(axis=2)
        band_rows = last_band[:, None] * bh + np.arange(bh)[None, :]
        # Packed raw rows of just the surviving states (k is tiny after
        # level 0 — packing all S0 transforms up front would dominate).
        rawp = _pack(aa[fc].reshape(-1, n), n, bits).reshape(k, n)
        band_sorted = np.sort(rawp.reshape(k, nb, bh), axis=2)
        in_band = np.take_along_axis(rawp, band_rows, axis=1)
        in_band = np.where(
            np.take_along_axis(used, band_rows, axis=1), _SENTINEL, in_band
        )
        in_band.sort(axis=1)
        other = np.where(
            (band_counts > 0)[:, :, None], _SENTINEL, band_sorted
        )
        other = np.ascontiguousarray(other)
        # Structured view: sorts the nb band-triples of each state
        # lexicographically without leaving numpy.
        view = other.view([(f"b{i}", np.int64) for i in range(bh)]).reshape(k, nb)
        view.sort(axis=1)
        key = np.concatenate(
            [maps, in_band, other.reshape(k, nb * bh)], axis=1
        )
        _, keep = np.unique(key, axis=0, return_index=True)
        keep.sort()
        fc, used, maps = fc[keep], used[keep], maps[keep]
        sizes, last_band, row_hist = sizes[keep], last_band[keep], row_hist[keep]
        if fc.shape[0] > max_states:
            return None

    # Any surviving state realizes the canonical grid; take the first.
    mapping = {d: int(maps[0, d]) for d in range(1, n + 1) if maps[0, d]}
    for d in range(1, n + 1):  # complete deterministically (see Transform)
        if d not in mapping:
            mapping[d] = len(mapping) + 1
    relabel = [0] * (n + 1)
    for d, lab in mapping.items():
        relabel[d] = lab
    tr = Transform(
        transpose=bool(fc[0] >= c_count),
        row_perm=tuple(int(r) for r in row_hist[0]),
        col_perm=tuple(int(c) for c in ci[int(fc[0]) % c_count]),
        relabel=tuple(relabel),
    )
    canon = np.asarray(canon_rows, dtype=np.int8)
    # The walk and the direct application must agree cell for cell; this
    # is the internal consistency check the round-trip contract rests on.
    check = apply_transform(g, tr).astype(np.int8)
    if not np.array_equal(check, canon):  # pragma: no cover - invariant
        raise AssertionError("canonical walk and transform disagree")
    return CanonicalForm(grid=canon, transform=tr, geom=geom)
