"""The port's cluster wire, rows, hash ring, gossip and cache against the
JAX package's, on the same inputs (seeded with numpy).

The wire is the contract between nodes, so a port node and a JAX node must
write the same bytes for the same frame, read each other's packed rows and
configs, and agree on every digest's owner.  The wire unit cases of
``tests/test_wire_adversarial.py`` (both ``ambiguous_delivery`` flavours)
run against the port's ``cluster/wire.py``; a subprocess pins that the
port's cluster and CLI load no JAX.
"""

import dataclasses
import json
import random
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu.cluster import node as jnode
from distributed_sudoku_solver_tpu.cluster import wire as jwire
from distributed_sudoku_solver_tpu.cluster.dht import ClusterCache as JCache
from distributed_sudoku_solver_tpu.cluster.dht import Gossip as JGossip
from distributed_sudoku_solver_tpu.cluster.dht import HashRing as JRing
from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JConfig
from distributed_sudoku_solver_tpu_torch.cluster import node as pnode
from distributed_sudoku_solver_tpu_torch.cluster import wire
from distributed_sudoku_solver_tpu_torch.cluster.dht import ClusterCache as PCache
from distributed_sudoku_solver_tpu_torch.cluster.dht import Gossip as PGossip
from distributed_sudoku_solver_tpu_torch.cluster.dht import HashRing as PRing
from distributed_sudoku_solver_tpu_torch.obs import lockdep
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig as PConfig

REPO = __file__.rsplit("/tests/", 1)[0]


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


def _frames(rng) -> list:
    """Seeded frames of the shapes the ring sends: TASK with a grid and a
    config, SUBTASK with packed rows, SOLUTION, gossip piggybacks."""
    grid = rng.integers(0, 10, size=(9, 9)).tolist()
    rows = rng.integers(0, 2**32, size=(3, 9, 9), dtype=np.uint64).astype(np.uint32)
    return [
        {"method": "TASK", "uuid": "a:1/x", "grid": grid, "origin": "a:1",
         "config": dataclasses.asdict(PConfig(branch="minrem-desc"))},
        {"method": "SUBTASK", "part": "p#1", "root": "r", "report_to": "a:1",
         "rows": pnode.pack_rows(rows)},
        {"method": "SOLUTION", "uuid": "u", "solved": True, "unsat": False,
         "nodes": int(rng.integers(1, 1000)), "error": None, "solution": grid},
        {"method": "HEARTBEAT", "from": "b:2", "gossip": [
            {"addr": "c:3", "state": "suspect", "inc": 2, "brown": False}]},
        {"method": "X", "text": "ünïcödé ✓", "f": float(rng.random())},
    ]


def _written(send_frame, msg) -> bytes:
    a, b = socket.socketpair()
    with a, b:
        send_frame(a, msg)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while chunk := b.recv(65536):
            out += chunk
    return out


def test_frame_bytes_equal_jax_and_read_across():
    rng = np.random.default_rng(0)
    for msg in _frames(rng):
        pb = _written(wire._send_frame, msg)
        jb = _written(jwire._send_frame, msg)
        assert pb == jb, f"{msg['method']}: frame bytes differ"
        # Each package reads the other's frame back to the same dict.
        for send, recv in ((wire._send_frame, jwire.recv_msg), (jwire._send_frame, wire.recv_msg)):
            a, b = socket.socketpair()
            with a, b:
                send(a, msg)
                assert recv(b) == json.loads(json.dumps(msg))
    assert wire.MAX_FRAME == jwire.MAX_FRAME


def test_pack_rows_unpack_rows_across_packages():
    rng = np.random.default_rng(1)
    for shape in [(1, 9, 9), (5, 9, 9), (3, 16, 16), (0, 9, 9)]:
        rows = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
        p, j = pnode.pack_rows(rows), jnode.pack_rows(rows)
        assert p == j
        assert np.array_equal(jnode.unpack_rows(p), rows)
        assert np.array_equal(pnode.unpack_rows(j), rows)
        assert pnode.unpack_rows(j).dtype == np.uint32


def test_hashring_owners_equal_over_1000_digests():
    rng = np.random.default_rng(2)
    members = [f"10.0.{rng.integers(256)}.{i}:{7000 + i}" for i in range(7)]
    digests = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)).hex() for _ in range(1000)]
    for vnodes in (1, 32, 64):
        p, j = PRing(vnodes=vnodes), JRing(vnodes=vnodes)
        for m in members:
            p.add(m)
            j.add(m)
        assert [p.owner(d) for d in digests] == [j.owner(d) for d in digests]
        assert [p.replicas(d, 3) for d in digests[:50]] == [j.replicas(d, 3) for d in digests[:50]]
        p.remove(members[3])
        j.remove(members[3])
        assert [p.owner(d) for d in digests] == [j.owner(d) for d in digests]
        assert p.summary() == j.summary()


def test_gossip_probe_order_equal_under_fake_clock():
    rng = random.Random(3)
    members = ["self:1"] + [f"m{i}:{7000 + i}" for i in range(9)]
    t = [0.0]
    p = PGossip("self:1", lambda: t[0], suspicion_s=2.0, piggyback=4)
    j = JGossip("self:1", lambda: t[0], suspicion_s=2.0, piggyback=4)
    for g in (p, j):
        g.reconcile(members)
    probes = ([], [])
    for step in range(40):
        t[0] = step * 0.25
        if step == 5:
            for g in (p, j):
                g.on_probe_fail("m3:7003")
        if step == 9:
            for g in (p, j):
                g.reconcile(members[:7] + ["new:9"])
        upd = [{"addr": rng.choice(members), "state": "suspect", "inc": step % 3, "brown": False}]
        for k, g in enumerate((p, j)):
            g.merge(upd)
            probes[k].append(g.tick())
            if probes[k][-1][0] is not None:
                g.on_ack(probes[k][-1][0])
    assert probes[0] == probes[1]
    assert p.view() == j.view()
    assert p.updates() == j.updates()
    assert p.metrics() == j.metrics()


class _NoClock:
    @staticmethod
    def sleep(dt):
        raise AssertionError("a local store never sleeps")


def test_cluster_cache_eviction_order_equal():
    rng = np.random.default_rng(4)
    caches = [
        cls("self:1", owner_fn=lambda d: "self:1", request_fn=None, put_fn=None,
            clock=_NoClock(), uuid_fn=lambda: "u", capacity=8)
        for cls in (PCache, JCache)
    ]
    keys = [f"d{int(k):03d}" for k in rng.integers(0, 20, size=200)]
    for i, k in enumerate(keys):
        for c in caches:
            if i % 3 == 0:
                c.lookup(k)
            else:
                c.store(k, {"verdict": "sat", "i": i})
    assert list(caches[0]._shard.items()) == list(caches[1]._shard.items())
    assert caches[0].metrics() == caches[1].metrics()


@pytest.mark.parametrize("cfg_kw", [
    {},
    {"branch": "minrem-desc", "rules": "extended", "lanes": 64},
    {"step_impl": "fused", "branch": "head:cw-slack", "count_all": True},
])
def test_config_round_trips_both_ways(cfg_kw):
    pc, jc = PConfig(**cfg_kw), JConfig(**cfg_kw)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    wire_p = json.loads(json.dumps(dataclasses.asdict(pc)))
    wire_j = json.loads(json.dumps(dataclasses.asdict(jc)))
    assert pnode._config_from_dict(wire_j) == pc
    assert jnode._config_from_dict(wire_p) == jc
    assert isinstance(pnode._config_from_dict(wire_j), PConfig)
    assert pnode._config_from_dict(None) is None


def test_port_cluster_and_cli_load_no_jax():
    code = (
        "import sys\n"
        "import distributed_sudoku_solver_tpu_torch.cli\n"
        "import distributed_sudoku_solver_tpu_torch.cluster\n"
        "import distributed_sudoku_solver_tpu_torch.cluster.simnet\n"
        "import distributed_sudoku_solver_tpu_torch.cluster.dht\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'distributed_sudoku_solver_tpu'\n"
        "             or m.startswith('distributed_sudoku_solver_tpu.'))\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- WireError delivery-ambiguity flavors (round 10) --------------------------
#
# Retry paths branch on WireError.ambiguous_delivery: False proves the
# frame never reached the peer (safe to re-dispatch with no duplicate
# possible), True means bytes were written first (the peer MAY have
# processed the frame — re-dispatch is at-least-once and receivers must
# dedupe).  Both flavors pinned here against the real socket layer.


def test_connect_failure_is_unambiguous():
    # Nothing listens on port 1: the connect itself fails, so no byte was
    # ever written — delivery provably did not happen.
    with pytest.raises(wire.WireError) as ei:
        wire.send_msg(("127.0.0.1", 1), {"method": "X"}, 0.5)
    assert ei.value.ambiguous_delivery is False
    with pytest.raises(wire.WireError) as ei:
        wire.request(("127.0.0.1", 1), {"method": "X"}, 0.5)
    assert ei.value.ambiguous_delivery is False


def test_reply_timeout_after_bytes_written_is_ambiguous():
    # A server that accepts, reads the whole request, and never replies:
    # the failure happens strictly after the frame went out, so the peer
    # may have processed it — the retry layer must assume at-least-once.
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    served = threading.Event()

    def serve_once():
        conn, _ = srv.accept()
        with conn:
            wire.recv_msg(conn)
            served.wait(5)  # hold the connection open, never reply

    t = threading.Thread(target=serve_once, daemon=True)
    t.start()
    try:
        with pytest.raises(wire.WireError) as ei:
            wire.request(("127.0.0.1", port), {"method": "PING"}, 0.5)
        assert ei.value.ambiguous_delivery is True
    finally:
        served.set()
        srv.close()


def test_send_failure_after_connect_is_ambiguous(monkeypatch):
    # A frame that dies mid-sendall (reset after the connect): some bytes
    # may be in the peer's buffers.  Forced deterministically — a real
    # loopback reset races kernel buffering.
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def boom(sock, msg):
        raise OSError("connection reset by peer (forced)")

    monkeypatch.setattr(wire, "_send_frame", boom)
    try:
        with pytest.raises(wire.WireError) as ei:
            wire.send_msg(("127.0.0.1", port), {"method": "X"}, 0.5)
        assert ei.value.ambiguous_delivery is True
    finally:
        srv.close()


def test_oversize_frame_refused_before_send_is_unambiguous():
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    try:
        with pytest.raises(wire.WireError) as ei:
            wire.send_msg(
                ("127.0.0.1", port),
                {"method": "X", "pad": "x" * (wire.MAX_FRAME + 1)},
                2.0,
            )
        # The size check rejects before any byte is written.
        assert ei.value.ambiguous_delivery is False
    finally:
        srv.close()
