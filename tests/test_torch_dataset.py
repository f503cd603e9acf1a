"""The port's dataset IO (``utils/dataset.py``) against the JAX package's.

Twins of ``tests/test_dataset.py`` (native loader vs Python fallback,
streaming, crash-resumable file solve), with every ``solve_file`` on
``device="cpu"``; then parity: the port's Python and native parsers and
its formatter give the JAX package's arrays and bytes on the same input.
Tolerance: exact equality.
"""

import os

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu import native as jnative
from distributed_sudoku_solver_tpu.models.geometry import SUDOKU_9 as JSUDOKU_9
from distributed_sudoku_solver_tpu.models.geometry import SUDOKU_16 as JSUDOKU_16
from distributed_sudoku_solver_tpu.utils import dataset as jdataset
from distributed_sudoku_solver_tpu_torch import native
from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_16
from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
from distributed_sudoku_solver_tpu_torch.ops.bulk import BulkConfig
from distributed_sudoku_solver_tpu_torch.utils import dataset
from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution
from distributed_sudoku_solver_tpu_torch.utils.puzzles import (
    EASY_9,
    HARD_9,
    puzzle_batch,
    to_line,
)


@pytest.fixture(scope="module")
def corpus():
    gen = puzzle_batch(SUDOKU_9, 10, seed=41, n_clues=30)
    return np.concatenate([np.stack([EASY_9, *HARD_9]), gen]).astype(np.int32)


def test_parse_roundtrip(corpus):
    blob = ("\n".join(to_line(b) for b in corpus) + "\n").encode()
    got = dataset.parse_boards(blob, SUDOKU_9)
    np.testing.assert_array_equal(got, corpus)


def test_parse_python_and_native_agree(corpus):
    blob = ("\n".join(to_line(b) for b in corpus) + "\n").encode()
    py = dataset._parse_python(blob, 9, allow_header=True)
    np.testing.assert_array_equal(py, corpus)
    if native.available():
        np.testing.assert_array_equal(native.parse_boards(blob, 9), corpus)


def test_parse_kaggle_csv_with_header(corpus):
    rows = [f"{to_line(b)},{to_line(b)}" for b in corpus]
    blob = ("quizzes,solutions\n" + "\n".join(rows) + "\n").encode()
    got = dataset.parse_boards(blob, SUDOKU_9)
    np.testing.assert_array_equal(got, corpus)


def test_parse_dot_notation():
    line = to_line(EASY_9).replace("0", ".")
    got = dataset.parse_boards((line + "\n").encode(), SUDOKU_9)
    np.testing.assert_array_equal(got[0], EASY_9)


def test_malformed_line_raises(corpus):
    blob = (to_line(corpus[0]) + "\nnot-a-board\n").encode()
    with pytest.raises(ValueError):
        dataset.parse_boards(blob, SUDOKU_9, allow_header=False)


def test_save_load_roundtrip(tmp_path, corpus):
    path = str(tmp_path / "boards.txt")
    dataset.save_boards(path, corpus)
    np.testing.assert_array_equal(dataset.load_boards(path, SUDOKU_9), corpus)


def test_iter_batches_streams_everything(tmp_path, corpus):
    big = np.tile(corpus, (20, 1, 1))
    path = str(tmp_path / "big.txt")
    dataset.save_boards(path, big)
    got = np.concatenate(list(dataset.iter_board_batches(path, SUDOKU_9, batch=64)))
    np.testing.assert_array_equal(got, big)


def test_solve_file_end_to_end(tmp_path, corpus):
    in_path = str(tmp_path / "in.txt")
    out_path = str(tmp_path / "out.txt")
    dataset.save_boards(in_path, corpus)
    stats = dataset.solve_file(
        in_path,
        out_path,
        SUDOKU_9,
        batch=8,
        bulk_config=BulkConfig(chunk=8),
        device="cpu",
    )
    assert stats["total"] == len(corpus) and stats["solved"] == len(corpus)
    sols = dataset.load_boards(out_path, SUDOKU_9)
    assert len(sols) == len(corpus)
    for g, s in zip(corpus, sols):
        assert is_valid_solution(s)
        assert ((g == 0) | (s == g)).all()


def test_solve_file_resumes_after_crash_byte_identical(tmp_path, corpus):
    """Kill solve-file mid-run, rerun, byte-identical output."""
    import distributed_sudoku_solver_tpu_torch.ops.bulk as bulk_mod

    big = np.tile(corpus, (3, 1, 1))  # 42 boards -> 6 batches of 8
    in_path = str(tmp_path / "in.txt")
    dataset.save_boards(in_path, big)
    cfg = BulkConfig(chunk=8)

    ref_path = str(tmp_path / "ref.txt")
    dataset.solve_file(in_path, ref_path, SUDOKU_9, batch=8, bulk_config=cfg, device="cpu")

    out_path = str(tmp_path / "out.txt")
    real = bulk_mod.solve_bulk
    calls = {"n": 0}

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise KeyboardInterrupt("simulated kill")
        return real(*a, **kw)

    bulk_mod.solve_bulk = dying
    try:
        with np.testing.assert_raises(KeyboardInterrupt):
            dataset.solve_file(in_path, out_path, SUDOKU_9, batch=8, bulk_config=cfg, device="cpu")
    finally:
        bulk_mod.solve_bulk = real

    import os

    assert os.path.exists(out_path + ".partial")  # partial output survives
    assert os.path.exists(out_path + ".progress")
    stats = dataset.solve_file(in_path, out_path, SUDOKU_9, batch=8, bulk_config=cfg, device="cpu")
    assert stats["total"] == len(big) and stats["solved"] == len(big)
    assert stats["unresolved"] == 0
    assert open(out_path, "rb").read() == open(ref_path, "rb").read()
    assert not os.path.exists(out_path + ".partial")
    assert not os.path.exists(out_path + ".progress")


def test_solve_file_resume_ignores_stale_partial_without_progress(tmp_path, corpus):
    in_path = str(tmp_path / "in.txt")
    out_path = str(tmp_path / "out.txt")
    dataset.save_boards(in_path, corpus)
    with open(out_path + ".partial", "wb") as f:
        f.write(b"garbage from an unrelated run\n")
    stats = dataset.solve_file(
        in_path, out_path, SUDOKU_9, batch=8, bulk_config=BulkConfig(chunk=8),
        device="cpu",
    )
    assert stats["solved"] == len(corpus)
    sols = dataset.load_boards(out_path, SUDOKU_9)
    assert len(sols) == len(corpus)


def test_solve_file_resume_rejects_other_runs_sidecar(tmp_path, corpus):
    """A progress sidecar from a different input must not be resumed."""
    import distributed_sudoku_solver_tpu_torch.ops.bulk as bulk_mod

    cfg = BulkConfig(chunk=8)
    in_a = str(tmp_path / "a.txt")
    in_b = str(tmp_path / "b.txt")
    out_path = str(tmp_path / "out.txt")
    dataset.save_boards(in_a, np.tile(corpus, (2, 1, 1)))
    dataset.save_boards(in_b, corpus[::-1].copy())

    real = bulk_mod.solve_bulk
    calls = {"n": 0}

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt("simulated kill")
        return real(*a, **kw)

    bulk_mod.solve_bulk = dying
    try:
        with np.testing.assert_raises(KeyboardInterrupt):
            dataset.solve_file(in_a, out_path, SUDOKU_9, batch=8, bulk_config=cfg, device="cpu")
    finally:
        bulk_mod.solve_bulk = real
    import os

    assert os.path.exists(out_path + ".progress")

    # Same out_path, different input: sidecar must be discarded, not spliced.
    stats = dataset.solve_file(in_b, out_path, SUDOKU_9, batch=8, bulk_config=cfg, device="cpu")
    assert stats["total"] == len(corpus)
    sols = dataset.load_boards(out_path, SUDOKU_9)
    assert len(sols) == len(corpus)
    for g, s in zip(corpus[::-1], sols):
        assert is_valid_solution(s)
        assert ((g == 0) | (s == g)).all()


def test_whitespace_lines_skipped_like_python(corpus):
    blob = (to_line(corpus[0]) + "\n   \n\t\n" + to_line(corpus[1]) + "\n").encode()
    got = dataset.parse_boards(blob, SUDOKU_9, allow_header=False)
    np.testing.assert_array_equal(got, corpus[:2])
    py = dataset._parse_python(blob, 9, allow_header=False)
    np.testing.assert_array_equal(py, corpus[:2])


def test_streaming_error_index_is_file_absolute(tmp_path, corpus):
    path = str(tmp_path / "bad.txt")
    lines = [to_line(b) for b in np.tile(corpus, (40, 1, 1))]
    lines.insert(500, "xx-not-a-board")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="data line 500"):
        for _ in dataset.iter_board_batches(path, SUDOKU_9, batch=64):
            pass


def test_solve_file_empty_input(tmp_path):
    in_path = str(tmp_path / "empty.txt")
    out_path = str(tmp_path / "out.txt")
    open(in_path, "w").close()
    stats = dataset.solve_file(in_path, out_path, SUDOKU_9, batch=8, device="cpu")
    assert stats == {
        "total": 0, "solved": 0, "unsat": 0, "searched": 0, "unresolved": 0,
    }
    assert open(out_path).read() == ""


def test_right_length_bad_first_line_raises_not_skips(corpus):
    # A first line with correct length but an invalid char is a malformed
    # board, NOT a header: silently skipping it would misalign every output.
    bad = "x" * 81  # 'x'=33 > 9, right length
    blob = (bad + "\n" + to_line(corpus[0]) + "\n").encode()
    with pytest.raises(ValueError):
        dataset.parse_boards(blob, SUDOKU_9, allow_header=True)
    py_err = None
    try:
        dataset._parse_python(blob, 9, allow_header=True)
    except ValueError as e:
        py_err = e
    assert py_err is not None


def test_padded_and_uppercase_lines_parse_same(corpus):
    line = "  " + to_line(corpus[0]).upper() + "  "
    blob = (line + "\n").encode()
    got = dataset.parse_boards(blob, SUDOKU_9, allow_header=False)
    py = dataset._parse_python(blob, 9, allow_header=False)
    np.testing.assert_array_equal(got, corpus[:1])
    np.testing.assert_array_equal(py, corpus[:1])


def test_space_before_comma_parses_like_python(corpus):
    blob = (to_line(corpus[0]) + " ,solutioncolumn\n").encode()
    got = dataset.parse_boards(blob, SUDOKU_9, allow_header=False)
    py = dataset._parse_python(blob, 9, allow_header=False)
    np.testing.assert_array_equal(got, corpus[:1])
    np.testing.assert_array_equal(py, corpus[:1])


def test_solve_file_stages_actually_overlap(tmp_path, monkeypatch):
    """The reader/solver/writer pipeline overlaps: all three stages are
    instrumented with sleeps + wall-clock intervals, and (a) a solve
    interval overlaps a read interval AND a write interval, and (b) total
    wall clock beats the serial sum — on any host, no device timing
    involved."""
    import time

    from distributed_sudoku_solver_tpu_torch.ops import bulk as bulk_mod

    n_batches, batch = 5, 8
    in_path = tmp_path / "boards.txt"
    line = to_line(np.asarray(EASY_9))
    in_path.write_text("\n".join([line] * (n_batches * batch)) + "\n")

    stage_sleep = 0.12
    intervals: dict[str, list] = {"read": [], "solve": [], "write": []}

    real_iter = dataset.iter_board_batches

    def slow_iter(path, geom, b):
        for boards in real_iter(path, geom, b):
            t0 = time.monotonic()
            time.sleep(stage_sleep)
            intervals["read"].append((t0, time.monotonic()))
            yield boards

    def slow_solve(boards, geom, cfg, device=None):
        t0 = time.monotonic()
        time.sleep(stage_sleep)
        k = len(boards)
        out = bulk_mod.BulkResult(
            solution=np.repeat(np.asarray(EASY_9)[None], k, axis=0),
            solved=np.ones(k, bool),
            unsat=np.zeros(k, bool),
            by_propagation=np.ones(k, bool),
            searched=0,
        )
        intervals["solve"].append((t0, time.monotonic()))
        return out

    real_format = dataset._format_lines

    def slow_format(boards):
        t0 = time.monotonic()
        time.sleep(stage_sleep)
        out = real_format(boards)
        intervals["write"].append((t0, time.monotonic()))
        return out

    monkeypatch.setattr(dataset, "iter_board_batches", slow_iter)
    monkeypatch.setattr(bulk_mod, "solve_bulk", slow_solve)
    monkeypatch.setattr(dataset, "_format_lines", slow_format)

    t0 = time.monotonic()
    stats = dataset.solve_file(
        str(in_path), str(tmp_path / "out.txt"), SUDOKU_9, batch=batch,
        device="cpu",
    )
    wall = time.monotonic() - t0
    assert stats["total"] == n_batches * batch
    assert stats["solved"] == n_batches * batch

    def overlaps(a, b):
        return any(s1 < e2 and s2 < e1 for s1, e1 in a for s2, e2 in b)

    assert overlaps(intervals["solve"], intervals["read"]), (
        "reader never ran concurrently with a solve"
    )
    assert overlaps(intervals["solve"], intervals["write"]), (
        "writer never ran concurrently with a solve"
    )
    serial = 3 * n_batches * stage_sleep
    assert wall < serial * 0.85, (
        f"pipeline gave no speedup: wall {wall:.2f}s vs serial {serial:.2f}s"
    )


# -- parity with the JAX package -------------------------------------------------


def _blobs(corpus):
    """Board files as bytes: plain lines, a Kaggle CSV with a header, dots,
    padding and blank lines, upper case, and 16x16 base-36 lines."""
    lines = [to_line(b) for b in corpus]
    b16 = [to_line(puzzle_batch(SUDOKU_16, 1, seed=s, n_clues=120, unique=False)[0])
           for s in range(3)]
    return {
        "plain": (("\n".join(lines) + "\n").encode(), 9),
        "csv": (("quizzes,solutions\n" + "\n".join(f"{x},{x}" for x in lines) + "\n").encode(),
                9),
        "messy": (("  " + lines[0].replace("0", ".") + "  \n\n\t\n" + lines[1].upper()
                   + " ,tail\n" + lines[2]).encode(), 9),
        "16x16": (("\n".join(b16) + "\n").encode(), 16),
    }


@pytest.mark.parametrize("which", ["plain", "csv", "messy", "16x16"])
def test_parse_and_format_equal_the_jax_package(corpus, which):
    from tests.test_torch_native_parity import load_jax_native

    assert load_jax_native() and native.available()
    blob, n = _blobs(corpus)[which]
    geom, jgeom = (SUDOKU_9, JSUDOKU_9) if n == 9 else (SUDOKU_16, JSUDOKU_16)
    want = jdataset.parse_boards(blob, jgeom)
    assert want.dtype == np.int32 and len(want) > 0
    for got in (dataset.parse_boards(blob, geom), dataset._parse_python(blob, n, True),
                native.parse_boards(blob, n)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jdataset._parse_python(blob, n, True), want)
    assert native.format_boards(want) == jnative.format_boards(want)
    assert dataset._format_lines(want) == jdataset._format_lines(want)


def test_malformed_input_raises_as_in_the_jax_package(corpus):
    lines = [to_line(b) for b in corpus]
    lines.insert(3, "x" * 81)
    blob = ("\n".join(lines) + "\n").encode()
    for parse in (lambda: dataset.parse_boards(blob, SUDOKU_9, allow_header=False),
                  lambda: jdataset.parse_boards(blob, JSUDOKU_9, allow_header=False)):
        with pytest.raises(ValueError, match="data line 3"):
            parse()


def test_solve_file_needs_cuda_unless_cpu_is_asked(tmp_path, corpus, monkeypatch):
    in_path = str(tmp_path / "in.txt")
    dataset.save_boards(in_path, corpus[:2])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dataset.solve_file(in_path, str(tmp_path / "out.txt"), SUDOKU_9, batch=8)
    assert not (tmp_path / "out.txt.partial").exists()
    stats = dataset.solve_file(in_path, None, SUDOKU_9, batch=8, device="cpu")
    assert stats["solved"] == 2


def test_puzzle_batch_and_its_cache_equal_the_jax_package(tmp_path):
    """``puzzle_batch`` gives the JAX package's boards for the same seeds, and
    the on-disk batch cache is one format: the same path, readable by
    either package."""
    from distributed_sudoku_solver_tpu.utils import puzzles as jpuzzles
    from distributed_sudoku_solver_tpu_torch.utils import puzzles

    kw = dict(count=6, seed=77, n_clues=26, unique=True, cache_dir=str(tmp_path))
    path = puzzles.batch_cache_path(SUDOKU_9, **kw)
    assert path == jpuzzles.batch_cache_path(JSUDOKU_9, **kw)
    want = jpuzzles.puzzle_batch(JSUDOKU_9, **kw)  # generates and writes the cache
    assert sorted(p.name for p in tmp_path.iterdir()) == [os.path.basename(path)]
    np.testing.assert_array_equal(puzzles.puzzle_batch(SUDOKU_9, **kw), want)  # reads it
    fresh = puzzles.puzzle_batch(SUDOKU_9, **dict(kw, cache_dir=str(tmp_path / "p")))
    np.testing.assert_array_equal(fresh, want)
    assert fresh.dtype == want.dtype
