"""Seeded Sudoku boards: puzzles with a unique solution from the committed
corpus (``portbench/corpus/<name>.npz``, made by ``build_corpus.py``), each
sent under a fresh symmetry transform of its own.

``transforms`` / ``apply`` are a vectorised copy of ``random_transform`` /
``apply_transform`` in
``distributed_sudoku_solver_tpu_torch/serving/frontdoor/canonical.py``.  A
transform keeps a puzzle's solution count and its difficulty to a solver
that branches on counts, so a batch holds the corpus's puzzles as new
inputs, and every seed's batch holds the same puzzles.

Every draw takes a generator from :func:`rng`, keyed by the run's seed and a
stream name, so two streams of one seed never share numbers.
"""

from __future__ import annotations

import functools
import os
import zlib

import numpy as np

CORPUS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "corpus")


def rng(seed: int, stream: str) -> np.random.Generator:
    """The generator of ``stream`` under ``seed`` (any integer)."""
    return np.random.default_rng([int(seed) % (1 << 64), zlib.crc32(stream.encode())])


def _perms(g: np.random.Generator, shape: tuple, k: int) -> np.ndarray:
    """Random permutations of ``range(k)`` along a new last axis."""
    return g.random((*shape, k)).argsort(-1)


def _orders(g: np.random.Generator, b: int, blocks: int, size: int) -> np.ndarray:
    """Per board, a line order that permutes the blocks (bands or stacks)
    and the lines within each block: int[b, blocks * size]."""
    block = _perms(g, (b,), blocks)  # [b, blocks]
    within = _perms(g, (b, blocks), size)  # [b, blocks, size]
    return (block[:, :, None] * size + within).reshape(b, blocks * size)


@functools.lru_cache(maxsize=None)
def corpus(name: str) -> tuple:
    """``(puzzles, solutions, box_h, box_w)`` of ``corpus/<name>.npz``;
    uint8[N, n, n] puzzles and solutions: every puzzle has exactly one."""
    with np.load(os.path.join(CORPUS, f"{name}.npz")) as z:
        box_h, box_w = (int(v) for v in z["box"])
        return z["puzzles"], z["solutions"], box_h, box_w


def draw(seed: int, stream: str, count: int, name: str, start: int = 0,
         transform: bool = True) -> tuple:
    """``count`` boards and their solutions, uint8[count, n, n] each:
    entries ``start .. start + count`` of a run of seeded permutations of
    the corpus ``name``, each under a fresh transform (``transform``).  A
    ``count`` that is a multiple of the corpus's size holds every puzzle
    equally often, whatever the seed; a draw within one permutation holds no
    puzzle twice."""
    p, s, box_h, box_w = corpus(name)
    size = len(p)
    g = rng(seed, stream)
    perms = [g.permutation(size) for _ in range(-(-(start + count) // size))]
    idx = np.concatenate(perms)[start:start + count]
    p, s = p[idx], s[idx]
    if transform:
        tr = transforms(g, count, box_h, box_w)
        p, s = apply(tr, p), apply(tr, s)
    return p, s


def transforms(g: np.random.Generator, b: int, box_h: int, box_w: int) -> dict:
    """``b`` uniformly random elements of the board's symmetry group (digit
    relabel, band and stack orders, rows and columns within them, transpose
    for square boxes), the identity among them."""
    n = box_h * box_w
    relabel = np.concatenate([np.zeros((b, 1), np.uint8), _perms(g, (b,), n).astype(np.uint8) + 1], 1)
    rows = _orders(g, b, n // box_h, box_h)
    cols = _orders(g, b, n // box_w, box_w)
    flip = (g.random(b) < 0.5) if box_h == box_w else np.zeros(b, bool)
    return {"relabel": relabel, "rows": rows, "cols": cols, "transpose": flip}


def apply(tr: dict, grids: np.ndarray) -> np.ndarray:
    """Apply transform ``i`` of ``tr`` to ``grids[i]``:
    ``out[r, c] = relabel[g[rows[r], cols[c]]]``, ``g`` transposed first
    where ``transpose`` is set (``apply_transform``'s convention)."""
    g = np.array(grids, copy=True)
    g[tr["transpose"]] = g[tr["transpose"]].transpose(0, 2, 1)
    b, n, _ = g.shape
    idx = np.arange(b)[:, None, None]
    moved = g[idx, tr["rows"][:, :, None], tr["cols"][:, None, :]]
    return np.take_along_axis(tr["relabel"], moved.reshape(b, -1), 1).reshape(b, n, n)


def zipf_picks(g: np.random.Generator, count: int, pool: int, s: float) -> np.ndarray:
    """``count`` draws from ``range(pool)``, item ``k`` with weight
    ``1 / (k + 1) ** s``."""
    w = 1.0 / np.arange(1, pool + 1) ** s
    return g.choice(pool, size=count, p=w / w.sum())
