"""The port's command line (``cli.py``, ``__main__.py``) against the JAX
package's.

The parser carries every flag of the JAX parser with the same default;
the compile-watch values are refused, naming the ROADMAP item they wait
for; ``--sharded`` serves through ``parallel.solve_batch_sharded``.  ``make_engine`` and ``main`` run on the card unless a
test passes ``device="cpu"``: without a card ``make_engine(args)`` raises
instead of running on the CPU.  ``solve-file`` writes the JAX CLI's lines,
and ``main`` boots a cluster node that serves HTTP and drains on stop.
"""

import argparse
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu import cli as jcli
from distributed_sudoku_solver_tpu.models.geometry import SUDOKU_9 as JSUDOKU_9
from distributed_sudoku_solver_tpu.ops.bulk import BulkConfig as JBulkConfig
from distributed_sudoku_solver_tpu.utils import dataset as jdataset
from distributed_sudoku_solver_tpu.utils.puzzles import make_puzzle as jmake_puzzle
from distributed_sudoku_solver_tpu.utils.puzzles import to_line as jto_line
from distributed_sudoku_solver_tpu_torch import cli
from distributed_sudoku_solver_tpu_torch.obs import lockdep
from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution
from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _port_lockdep():
    """The port's lock witness, armed as ``test_torch_engine.py`` arms it."""
    with lockdep.installed(lockdep.manifest_witness(strict=True)) as w:
        yield w


def _actions(ap: argparse.ArgumentParser) -> dict:
    return {a.dest: a for a in ap._actions if not isinstance(a, argparse._HelpAction)}


def _subparser(ap: argparse.ArgumentParser, name: str) -> argparse.ArgumentParser:
    (sub,) = [a for a in ap._actions if isinstance(a, argparse._SubParsersAction)]
    return sub.choices[name]


@pytest.mark.parametrize("which", ["node", "solve-file"])
def test_every_jax_flag_exists_with_an_equal_default(which):
    jap, pap = jcli.build_parser(), cli.build_parser()
    if which == "solve-file":
        jap, pap = _subparser(jap, which), _subparser(pap, which)
    ja, pa = _actions(jap), _actions(pap)
    assert set(ja) == set(pa)
    for dest, j in ja.items():
        p = pa[dest]
        assert p.option_strings == j.option_strings, dest
        assert p.default == j.default, dest
        assert p.type == j.type, dest
        assert p.choices == j.choices or (
            isinstance(j, argparse._SubParsersAction) and set(p.choices) == set(j.choices)
        ), dest
        assert p.nargs == j.nargs, dest
    assert vars(jap.parse_args([] if which == "node" else ["in.txt"])) == vars(
        pap.parse_args([] if which == "node" else ["in.txt"])
    )


@pytest.mark.parametrize(
    "argv, item",
    [
        (["--compile-warmup", "10"], "A14"),
        (["--compile-rearm", "1"], "A14"),
        (["--peak-gflops", "1000"], "A14"),
    ],
)
def test_unported_flags_exit_naming_their_roadmap_item(argv, item, capsys):
    with pytest.raises(SystemExit) as ei:
        cli.main(argv, device="cpu")
    assert ei.value.code == 2
    assert item in capsys.readouterr().err


def test_no_compile_watch_and_default_compile_values_are_accepted():
    ap = cli.build_parser()
    for argv in ([], ["--no-compile-watch"], ["--compile-warmup", "300"]):
        cli.check_port_flags(ap, ap.parse_args(argv))


def test_cli_frontdoor_flags():
    """Twin of ``test_frontdoor.py::test_cli_frontdoor_flags``."""
    ap = cli.build_parser()
    args = ap.parse_args(["--no-frontdoor"])
    eng = cli.make_engine(args, device="cpu")
    try:
        assert eng.frontdoor is None
    finally:
        eng.stop(timeout=1)
    args = ap.parse_args(["--cache-entries", "128", "--easy-score", "10"])
    eng = cli.make_engine(args, device="cpu")
    try:
        assert eng.frontdoor is not None
        assert eng.frontdoor.cache.capacity == 128
        assert eng.frontdoor.config.easy_score == 10
    finally:
        eng.stop(timeout=1)


def test_make_engine_defaults_match_the_jax_cli():
    args = cli.build_parser().parse_args([])
    eng = cli.make_engine(args, device="cpu")
    try:
        assert eng.device == torch.device("cpu")
        assert eng.max_batch == 256
        assert eng.config.stack_slots == 64 and eng.config.rules == "basic"
        assert eng.config.branch == "minrem" and eng.config.step_impl == "xla"
        assert eng.resident_config.job_slots == 16 and eng.resident_config.gang_lanes == 8
        assert eng.resident_config.queue_depth == 64
        assert eng.megastep_config.max_chunks == 64 and eng.frontdoor is not None
    finally:
        eng.stop(timeout=1)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_make_engine_needs_the_card_and_never_runs_on_the_cpu():
    args = cli.build_parser().parse_args([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.make_engine(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-p", "0", "-s", "0", "--host", "127.0.0.1"])


def test_make_engine_sharded_matches_the_jax_cli():
    """``--sharded``: the solve_fn is ``solve_batch_sharded`` over
    ``default_mesh()`` and, as in the JAX CLI, there is no resident or
    megastep flight to host."""
    from distributed_sudoku_solver_tpu_torch.parallel.mesh import virtual_devices

    jargs = jcli.build_parser().parse_args(["--sharded"])
    assert jargs.sharded
    with virtual_devices(4):
        eng = cli.make_engine(cli.build_parser().parse_args(["--sharded"]), device="cpu")
    try:
        assert eng.resident_config is None and eng.megastep_config is None
        assert not eng._use_flights
    finally:
        eng.stop(timeout=1)


def test_main_sharded_answers_solve_through_the_mesh(monkeypatch):
    """``cli.main([... "--sharded"])`` answers ``POST /solve`` through
    ``solve_batch_sharded`` over a four-shard mesh (the front door off, so
    the board reaches the device route)."""
    from distributed_sudoku_solver_tpu_torch.parallel import sharded
    from distributed_sudoku_solver_tpu_torch.parallel.mesh import virtual_devices

    meshes = []
    orig = sharded._solve_csp_sharded

    def counting(states0, problem, config, mesh):
        meshes.append(mesh.size)
        return orig(states0, problem, config, mesh)

    monkeypatch.setattr(sharded, "_solve_csp_sharded", counting)
    http_port, p2p_port = _free_port(), _free_port()
    stop = threading.Event()
    errors = []
    argv = ["-p", str(http_port), "-s", str(p2p_port), "--host", "127.0.0.1",
            "--advertise-host", "127.0.0.1", "--lanes", "16", "--sharded", "--no-frontdoor"]

    def run():
        try:
            cli.main(argv, device="cpu", stop=stop)
        except BaseException as e:  # surfaced below
            errors.append(e)

    with virtual_devices(4):
        t = threading.Thread(target=run, daemon=True)
        t.start()
        try:
            up = threading.Event()
            for _ in range(600):
                try:
                    _http(http_port, "/network", timeout=1)
                    up.set()
                    break
                except OSError:
                    up.wait(0.1)
            assert up.is_set(), errors
            code, body = _http(http_port, "/solve", {"sudoku": np.asarray(HARD_9[0]).tolist()})
            assert code == 201 and is_valid_solution(np.asarray(body["solution"]))
        finally:
            stop.set()
            t.join(60)
    assert not t.is_alive() and not errors, errors
    assert meshes and set(meshes) == {4}


def test_solve_file_main_equals_jax_solve_file_line_for_line(tmp_path, capsys):
    boards = [jmake_puzzle(JSUDOKU_9, 4000 + i, n_clues=26, unique=False) for i in range(62)]
    boards += [np.asarray(HARD_9[0]), np.asarray(HARD_9[1])]
    src = tmp_path / "boards.txt"
    src.write_text("".join(jto_line(b) + "\n" for b in boards))
    ref = tmp_path / "ref.txt"
    jdataset.solve_file(str(src), str(ref), JSUDOKU_9, batch=64, bulk_config=JBulkConfig(rules="extended"))
    out = tmp_path / "out.txt"
    cli.main(["solve-file", str(src), "-o", str(out), "--batch", "64"], device="cpu")
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["total"] == 64 and stats["boards_per_s"] > 0
    got, want = out.read_text().splitlines(), ref.read_text().splitlines()
    assert len(got) == len(want) == 64
    assert got == want
    assert stats["solved"] == sum(1 for line in want if set(line) != {"0"})


def _http(port, path, body=None, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("profile_secs", [None, "0", "0.2"])
def test_main_boots_a_node_that_serves_and_drains_on_stop(profile_secs, tmp_path, capsys):
    """``main`` on the CPU: a node that answers, then drains on stop; with
    ``--profile-dir`` a lifetime trace (``--profile-secs 0``) or a bounded
    window, each written as ``trace.json``."""
    http_port, p2p_port = _free_port(), _free_port()
    stop = threading.Event()
    errors = []
    argv = ["-p", str(http_port), "-s", str(p2p_port), "--host", "127.0.0.1",
            "--advertise-host", "127.0.0.1", "--lanes", "16"]
    if profile_secs is not None:
        argv += ["--profile-dir", str(tmp_path / "prof"), "--profile-secs", profile_secs]

    def run():
        try:
            cli.main(argv, device="cpu", stop=stop)
        except BaseException as e:  # surfaced below
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        up = threading.Event()
        for _ in range(600):
            try:
                code, net = _http(http_port, "/network", timeout=1)
                up.set()
                break
            except OSError:
                up.wait(0.1)
        assert up.is_set(), errors
        assert code == 200 and list(net) == [f"127.0.0.1:{p2p_port}"]
        code, body = _http(http_port, "/solve", {"sudoku": np.asarray(HARD_9[0]).tolist()})
        assert code == 201 and is_valid_solution(np.asarray(body["solution"]))
        code, stats = _http(http_port, "/stats")
        assert code == 200 and stats["all"]["solved"] == 1
    finally:
        stop.set()
        t.join(60)
    assert not t.is_alive() and not errors, errors
    out = capsys.readouterr().out
    assert f"node up: http=127.0.0.1:{http_port} p2p=127.0.0.1:{p2p_port}" in out
    assert "drain: {'state': 'drained'" in out
    if profile_secs is not None:
        from distributed_sudoku_solver_tpu_torch.utils import profiling

        closed = threading.Event()
        for _ in range(300):  # the bounded window may close after the node
            if (tmp_path / "prof" / "trace.json").exists() and not profiling.profile_window_active():
                break
            closed.wait(0.1)
        assert (tmp_path / "prof" / "trace.json").exists()


def test_profile_window_closes_on_its_own_thread_and_reports(tmp_path):
    """``--profile-secs``' bounded window: ``start_profile_window`` stops
    the trace on the thread that started it and then calls ``on_close``
    (where the CLI prints its line); ``--profile-secs 0`` takes
    ``device_trace`` for the node's life instead."""
    from distributed_sudoku_solver_tpu_torch.utils import profiling

    closed = threading.Event()
    assert profiling.start_profile_window(str(tmp_path), 0.05, on_close=closed.set)
    assert closed.wait(30)
    assert (tmp_path / "trace.json").exists()
    assert not profiling.profile_window_active()
