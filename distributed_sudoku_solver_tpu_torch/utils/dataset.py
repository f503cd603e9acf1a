"""Bulk puzzle dataset IO: file -> int32 batches -> bulk solver -> file.

Port of the JAX package's ``utils/dataset.py``.  Parsing is delegated to
the multithreaded native loader (``native/src/loader.cc``) when available,
with a pure-Python fallback, and batches stream so a million-board file
never materializes as Python objects.  :func:`solve_file` solves on the
port's ``ops.bulk.solve_bulk`` (K2 on the card) and takes ``device=None``
(CUDA, raising without it, unless ``device="cpu"`` is passed).

File format: one board per line, n*n chars, '.' or '0' = empty, digits then
lowercase base-36 letters ('a'=10) for larger geometries; Kaggle-style CSVs
work too (first comma-separated field is the board, header auto-skipped).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.utils.puzzles import parse_line, to_line


def _parse_python(data: bytes, n: int, allow_header: bool) -> np.ndarray:
    boards = []
    lines = [ln.strip() for ln in data.decode().splitlines() if ln.strip()]
    for i, raw in enumerate(lines):
        field = raw.split(",")[0].strip()
        # Header semantics must match loader.cc exactly: only a first line
        # whose field *length* differs from n*n may be skipped as a header;
        # a right-length line with a bad character is an error anywhere.
        if i == 0 and allow_header and len(field) != n * n:
            continue
        try:
            boards.append(parse_line(field, n))
        except ValueError:
            raise ValueError(f"malformed board at data line {len(boards)}")
    if not boards:
        return np.zeros((0, n, n), dtype=np.int32)
    return np.stack(boards).astype(np.int32)


def parse_boards(data: bytes, geom: Geometry, allow_header: bool = True) -> np.ndarray:
    """Board lines -> int32[B, n, n]; native multithreaded parse if possible.

    ``allow_header=False`` forbids the skip-unparseable-first-line heuristic,
    so a malformed line raises instead of being dropped — used for every
    chunk after the first when streaming, to keep output line-aligned.
    """
    from distributed_sudoku_solver_tpu_torch import native

    if native.available():
        return native.parse_boards(data, geom.n, allow_header=allow_header)
    return _parse_python(data, geom.n, allow_header)


def load_boards(path: str, geom: Geometry) -> np.ndarray:
    with open(path, "rb") as f:
        return parse_boards(f.read(), geom)


def iter_board_batches(
    path: str, geom: Geometry, batch: int = 65536
) -> Iterator[np.ndarray]:
    """Stream ``[<=batch, n, n]`` arrays from a board file of any size.

    Reads in ~batch-line byte chunks aligned to line boundaries, so memory
    stays O(batch) regardless of file size.
    """
    # +2 covers a solutions CSV column; a too-small guess only means more
    # read calls, never wrong results (the remainder carries over).
    approx_line = 2 * geom.n * geom.n + 2
    chunk_bytes = batch * approx_line
    with open(path, "rb") as f:
        rest = b""
        first = True
        n_done = 0
        while True:
            blob = f.read(chunk_bytes)
            if not blob:
                break
            data = rest + blob
            cut = data.rfind(b"\n")
            if cut < 0:
                rest = data
                continue
            rest, data = data[cut + 1 :], data[: cut + 1]
            # Only the true file head may hold a header line; later chunks
            # must parse every line or raise, to stay line-aligned.
            boards = _parse_chunk(data, geom, allow_header=first, offset=n_done)
            first = False
            n_done += len(boards)
            for lo in range(0, len(boards), batch):
                yield boards[lo : lo + batch]
        if rest.strip():
            boards = _parse_chunk(rest + b"\n", geom, allow_header=first, offset=n_done)
            for lo in range(0, len(boards), batch):
                yield boards[lo : lo + batch]


def _parse_chunk(data: bytes, geom: Geometry, allow_header: bool, offset: int):
    """parse_boards, rewriting chunk-relative error indices to file-absolute."""
    try:
        return parse_boards(data, geom, allow_header=allow_header)
    except ValueError as e:
        import re

        m = re.search(r"data line (\d+)", str(e))
        if m:
            raise ValueError(
                f"malformed board at data line {offset + int(m.group(1))}"
            ) from None
        raise


def save_boards(path: str, boards) -> None:
    """int[B, n, n] -> one base-36 line per board (atomic replace)."""
    g = np.ascontiguousarray(np.asarray(boards), dtype=np.int32)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(_format_lines(g))
    os.replace(tmp, path)


def _format_lines(boards: np.ndarray) -> bytes:
    from distributed_sudoku_solver_tpu_torch import native

    if native.available():
        return native.format_boards(boards)
    return ("\n".join(to_line(b) for b in boards) + "\n").encode() if len(boards) else b""


def solve_file(
    in_path: str,
    out_path: Optional[str],
    geom: Geometry,
    batch: int = 65536,
    bulk_config=None,
    resume: bool = True,
    device=None,
):
    """Solve every board in a file on ``device``; returns aggregate stats.

    With ``out_path``, solutions are written line-aligned with the input
    (unsolved lines all-zeros), streamed batch-by-batch to a temp file and
    atomically renamed — peak memory stays O(batch) end to end.

    **Crash-resumable** (the reference re-solves everything after any crash;
    here a sidecar ``{out_path}.progress`` records boards done, output bytes
    flushed, and running stats after every batch).  A rerun with ``resume``
    truncates the partial output to the last recorded byte, skips the
    already-solved boards, and appends — producing a byte-identical file to
    an uninterrupted run (solves are deterministic).  Both sidecars are
    removed on success.

    Stats: ``unresolved`` counts boards that exhausted every escalation rung
    (possible at 16x16/25x25 with tight ``max_steps``) — they end neither
    solved nor unsat and are written as all-zero lines, indistinguishable
    from unsat lines in the output file, so only this count exposes them.
    """
    import hashlib
    import json

    from distributed_sudoku_solver_tpu_torch.ops import bulk
    from distributed_sudoku_solver_tpu_torch.ops.solve import resolve_device

    dev = resolve_device(device)
    cfg = bulk_config or bulk.BulkConfig()
    stats = {"total": 0, "solved": 0, "unsat": 0, "searched": 0}
    tmp = f"{out_path}.partial" if out_path else None
    prog_path = f"{out_path}.progress" if out_path else None

    # A progress sidecar only matches a run with the same input file (head
    # hash + size), geometry, batch and solver config — resuming someone
    # else's sidecar would silently splice two runs into one output file.
    run_sig = None
    if tmp:
        st = os.stat(in_path)
        with open(in_path, "rb") as f:
            head = hashlib.sha256(f.read(65536)).hexdigest()[:16]
        run_sig = json.dumps(
            {
                "input": [head, st.st_size],
                "geom": [geom.box_h, geom.box_w],
                "batch": batch,
                "config": repr(cfg),
            }
        )

    # Open-then-lock-then-decide: the single lock holder makes every
    # truncate/resume decision, so concurrent runs cannot interleave.
    skip = 0
    out_f = open(tmp, "ab") if tmp else None
    if out_f is not None:
        # One writer per output path: resume needs a stable partial-file
        # name, so concurrent runs would otherwise interleave appends.
        # flock releases on crash; a second writer fails loudly instead.
        import fcntl

        try:
            fcntl.flock(out_f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            out_f.close()
            raise RuntimeError(
                f"another solve_file run is writing {out_path!r} "
                f"(lock on {tmp!r} is held)"
            ) from None
        prog = None
        if resume and os.path.exists(prog_path):
            with open(prog_path) as pf:
                prog = json.load(pf)
        if prog is not None and prog.get("run_sig") == run_sig:
            skip = int(prog["boards_done"])
            stats.update(prog["stats"])
            out_f.truncate(int(prog["bytes_done"]))  # drop post-record bytes
        else:  # fresh run, or stale sidecar from a different input/config
            out_f.truncate(0)
        out_f.seek(0, os.SEEK_END)
    # Software pipeline around the device: a reader thread prefetches and
    # parses batch k+1 and a writer thread formats/fsyncs batch k-1 while
    # the device solves batch k — wall clock becomes max(solve, io) instead
    # of their sum (measured: 1M boards 16.4 s serial -> ~12 s overlapped).
    # The writer alone touches the output file and the progress sidecar, in
    # batch order, so the crash-resume contract is unchanged.
    import queue as queue_mod
    import threading

    read_q: "queue_mod.Queue" = queue_mod.Queue(maxsize=2)
    stop_reading = threading.Event()

    def _put_cooperative(item) -> bool:
        """Bounded put that gives up when the consumer is gone — otherwise an
        error path would leak this thread (parked on a full queue forever)
        plus the open input-file handle, one per failed call."""
        while not stop_reading.is_set():
            try:
                read_q.put(item, timeout=0.2)
                return True
            except queue_mod.Full:
                continue
        return False

    def reader() -> None:
        try:
            for b in iter_board_batches(in_path, geom, batch):
                if not _put_cooperative(b):
                    return
            _put_cooperative(None)
        except BaseException as e:  # noqa: BLE001 - relayed to the main thread
            _put_cooperative(e)

    write_q: "queue_mod.Queue" = queue_mod.Queue(maxsize=2)
    write_err: list = []

    def writer() -> None:
        try:
            while True:
                item = write_q.get()
                if item is None:
                    return
                solution, stats_snapshot = item
                out_f.write(_format_lines(solution))
                out_f.flush()
                os.fsync(out_f.fileno())
                ptmp = f"{prog_path}.tmp"
                with open(ptmp, "w") as pf:
                    json.dump(
                        {
                            "run_sig": run_sig,
                            "boards_done": stats_snapshot["total"],
                            "bytes_done": out_f.tell(),
                            "stats": stats_snapshot,
                        },
                        pf,
                    )
                os.replace(ptmp, prog_path)
        except BaseException as e:  # noqa: BLE001
            write_err.append(e)
            while write_q.get() is not None:  # unblock the producer
                pass

    reader_t = threading.Thread(target=reader, daemon=True, name="solve-file-read")
    reader_t.start()
    writer_t = None
    if out_f:
        writer_t = threading.Thread(
            target=writer, daemon=True, name="solve-file-write"
        )
        writer_t.start()
    try:
        while True:
            boards = read_q.get()
            if boards is None:
                break
            if isinstance(boards, BaseException):
                raise boards
            if skip >= len(boards):  # already solved in the interrupted run
                skip -= len(boards)
                continue
            if skip:
                boards = boards[skip:]
                skip = 0
            res = bulk.solve_bulk(boards, geom, cfg, device=dev)
            stats["total"] += len(boards)
            stats["solved"] += int(res.solved.sum())
            stats["unsat"] += int(res.unsat.sum())
            stats["searched"] += res.searched
            if out_f:
                if write_err:
                    raise write_err[0]
                write_q.put((res.solution, dict(stats)))
        if out_f:
            write_q.put(None)
            writer_t.join()
            if write_err:
                raise write_err[0]
            out_f.close()
            out_f = None
            os.replace(tmp, out_path)
            if os.path.exists(prog_path):
                os.unlink(prog_path)
    finally:
        stop_reading.set()
        reader_t.join(10)
        if out_f:
            if writer_t is not None and writer_t.is_alive():
                write_q.put(None)
                writer_t.join(10)
            if writer_t is None or not writer_t.is_alive():
                out_f.close()  # keep tmp + progress: the next run resumes them
            # else: writer is wedged mid-write (e.g. a stalled fsync) — leave
            # the fd to it rather than close under an in-progress write; the
            # sidecar's bytes_done keeps any later resume byte-exact.
    stats["unresolved"] = stats["total"] - stats["solved"] - stats["unsat"]
    return stats
