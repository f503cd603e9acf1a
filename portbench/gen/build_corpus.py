"""Build a corpus of Sudoku puzzles with unique solutions (``corpus.c``).

    python3 -m portbench.gen.build_corpus --box 3 3 --clues 24 --count 16384 \
        --seed 1 --workers 6 --out portbench/corpus/sudoku9-24.npz

Compiles ``corpus.c`` with the system's C compiler into
``.portbench_cache/corpus/``, runs ``--workers`` copies of it on seeds
``seed * 1000 + worker``, checks every record (a valid solution that keeps
every given, ``clues`` givens) and writes ``puzzles`` and ``solutions``,
uint8[count, n, n], to a compressed ``.npz``.  The corpus is committed; the
benchmark only reads it, so no run needs a compiler.  Uniqueness is the
generator's own check; the tests recount a sample by a separate search.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

from portbench.core import ROOT
from portbench.reference.sudoku import right_answers

HERE = os.path.dirname(os.path.abspath(__file__))


def build() -> str:
    out = os.path.join(ROOT, ".portbench_cache", "corpus")
    os.makedirs(out, exist_ok=True)
    exe = os.path.join(out, "corpus")
    subprocess.run(["cc", "-O2", "-o", exe, os.path.join(HERE, "corpus.c")], check=True)
    return exe


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.gen.build_corpus", description=__doc__.splitlines()[0])
    ap.add_argument("--box", type=int, nargs=2, required=True, metavar=("H", "W"))
    ap.add_argument("--clues", type=int, required=True)
    ap.add_argument("--count", type=int, required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    bh, bw = args.box
    n = bh * bw
    exe = build()
    shares = [args.count // args.workers + (w < args.count % args.workers) for w in range(args.workers)]
    outs = [os.path.join(os.path.dirname(exe), f"part{w}.bin") for w in range(args.workers)]
    procs = []
    for w, k in enumerate(shares):
        with open(outs[w], "wb") as f:
            procs.append(subprocess.Popen(
                [exe, str(bh), str(bw), str(args.clues), str(k), str(args.seed * 1000 + w)], stdout=f))
    if any([p.wait() for p in procs]):
        print("corpus: a generator failed", file=sys.stderr)
        return 1
    chunks = []
    for out in outs:
        with open(out, "rb") as f:
            chunks.append(f.read())
        os.remove(out)
    rec = np.frombuffer(b"".join(chunks), np.uint8).reshape(args.count, 2, n, n)
    puzzles, solutions = rec[:, 0].copy(), rec[:, 1].copy()
    clues = (puzzles > 0).reshape(args.count, -1).sum(1)
    assert (clues == args.clues).all(), "a record has another number of givens"
    assert right_answers(puzzles, solutions, bh, bw).all(), "a record's solution is wrong"
    np.savez_compressed(args.out, puzzles=puzzles, solutions=solutions,
                        box=np.array([bh, bw]), clues=np.array(args.clues), seed=np.array(args.seed))
    print(f"corpus: {args.count} puzzles of {args.clues} givens to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
