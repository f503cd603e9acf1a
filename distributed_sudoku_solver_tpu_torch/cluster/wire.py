"""Typed, length-framed JSON messages over TCP — the control-plane transport.

Replaces the reference's wire layer (the reference's ``DHT_Node.py:74-99``)
and removes its three structural flaws by construction (SURVEY.md §2.3):

* **pickle → JSON**: no RCE surface from network input (`pickle.loads` at
  ``:83,99``);
* **UDP → TCP**: no silently-lost TASK messages (§2.5 #7) — delivery either
  succeeds or raises at the sender, which can then re-dispatch;
* **1024-byte recv cap → 4-byte length prefix**: 25x25 boards (1.5 KB
  pickled, truncated by the reference — §2.5 #8) frame like anything else.

Connection discipline is datagram-style on purpose: one connection per
message (optionally one reply on the same connection), so there is no
session state to repair after a peer dies — matching the reference's
fire-and-forget model with reliability added.

"Raises at the sender" has two flavors, and retry logic must tell them
apart (:attr:`WireError.ambiguous_delivery`): a failure *before* any frame
byte reached the peer (connect refused / connect timeout) proves the
message was not delivered, so a re-dispatch cannot duplicate it; a failure
*after* bytes were written (reset mid-``sendall``, reply timeout) proves
nothing — the peer may have received and acted on the whole frame, so any
re-dispatch is at-least-once delivery and the receiver must be idempotent
(``cluster/node.py`` dedupes result-bearing messages by uuid).

This module also hosts the *production* transport/clock pair behind
``ClusterNode``'s injectable seam (:class:`TcpTransport` /
:class:`SystemClock`); the deterministic in-memory twin lives in
``cluster/simnet.py``.
"""

from __future__ import annotations

import itertools
import json
import logging
import socket
import struct
import threading
import time
from typing import Callable, Optional, Tuple

_LOG = logging.getLogger(__name__)

Addr = Tuple[str, int]

MAX_FRAME = 16 * 1024 * 1024  # generous: a 25x25 grid message is ~2 KB
_LEN = struct.Struct(">I")


class WireError(Exception):
    """Transport-level failure: peer unreachable, bad frame, oversize.

    ``ambiguous_delivery`` is the retry-relevant distinction (module
    docstring): ``False`` — the message definitely did not reach the peer;
    ``True`` — bytes were written before the failure, so the peer *may*
    have processed the message and a re-dispatch implies duplicates.
    """

    def __init__(self, message: str, ambiguous_delivery: bool = False):
        super().__init__(message)
        self.ambiguous_delivery = ambiguous_delivery


def addr_str(addr: Addr) -> str:
    return f"{addr[0]}:{addr[1]}"


def parse_addr(s: str) -> Addr:
    host, _, port = s.rpartition(":")
    return host, int(port)


def _send_frame(sock: socket.socket, msg: dict) -> None:
    data = json.dumps(msg).encode()
    if len(data) > MAX_FRAME:
        raise WireError(f"frame too large: {len(data)} bytes")
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise WireError("connection closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock: socket.socket) -> dict:
    (length,) = _LEN.unpack(_recv_exact(sock, 4))
    if length > MAX_FRAME:
        raise WireError(f"frame too large: {length} bytes")
    msg = json.loads(_recv_exact(sock, length))
    if not isinstance(msg, dict) or "method" not in msg:
        raise WireError("malformed message: expected dict with 'method'")
    return msg


def reply_msg(sock: socket.socket, msg: dict) -> None:
    _send_frame(sock, msg)


def send_msg(addr: Addr, msg: dict, timeout: float = 5.0) -> None:
    """Fire-and-forget (but reliable): deliver one message, no reply."""
    try:
        sock = socket.create_connection(addr, timeout=timeout)
    except OSError as e:
        raise WireError(f"connect to {addr_str(addr)} failed: {e}") from e
    try:
        with sock:
            _send_frame(sock, msg)
    except WireError:
        raise  # oversize: refused before any byte was written
    except OSError as e:
        # The connection existed (sendall failure, or a close()-time reset
        # surfacing on `with` exit): some — possibly all — frame bytes may
        # have reached the peer before the failure.
        raise WireError(
            f"send to {addr_str(addr)} failed after connect: {e}",
            ambiguous_delivery=True,
        ) from e


def fanout_requests(
    transport, peers, payload: dict, timeout: float, max_threads: int = 32
) -> list:
    """Parallel request/reply fan-out with per-peer timeouts — the shape
    ``stats_view`` always used, now shared with the cluster metrics pull
    (METRICS_PULL, ``GET /metrics?scope=cluster``).

    At most ``max_threads`` daemon worker threads drain the peer list,
    each request bounded by ``timeout``; a peer that fails, is
    partitioned, or answers late yields ``None`` in its slot.  The
    bounded pool is what keeps a 500-member pull from forking 500
    threads per scrape; wall time is bounded by
    ~``ceil(peers/max_threads) * timeout`` worst-case but in practice by
    the slowest stragglers, never O(peers) serial timeouts — which is
    what keeps the aggregation endpoints from ever hanging an HTTP
    handler thread on a degraded ring.  ``peers`` are addr strings or
    parsed ``Addr`` tuples."""
    results: list = [None] * len(peers)
    if not peers:
        return results
    nworkers = max(1, min(int(max_threads), len(peers)))
    cursor = itertools.count()

    def ask(i: int, peer) -> None:
        addr = peer if isinstance(peer, tuple) else parse_addr(peer)
        try:
            results[i] = transport.request(addr, payload, timeout)
        except WireError:
            pass  # slot stays None: the caller flags the peer

    def drain() -> None:
        for i in cursor:
            if i >= len(peers):
                return
            ask(i, peers[i])

    threads = [
        threading.Thread(target=drain, daemon=True) for _ in range(nworkers)
    ]
    for t in threads:
        t.start()
    # Each worker serves ~peers/nworkers requests back to back; the join
    # budget covers that plus slack, so a wedged transport still cannot
    # hang the caller.
    budget = timeout * (len(peers) / nworkers + 1.0) + 1.0
    for t in threads:
        t.join(budget)
    # Snapshot: a straggler thread finishing after its join timeout must
    # not mutate what the caller is already iterating.
    return list(results)


def request(addr: Addr, msg: dict, timeout: float = 5.0) -> dict:
    """Send one message and wait for one reply frame on the same connection."""
    try:
        sock = socket.create_connection(addr, timeout=timeout)
    except OSError as e:
        raise WireError(f"request to {addr_str(addr)} failed: {e}") from e
    try:
        with sock:
            sock.settimeout(timeout)
            try:
                _send_frame(sock, msg)
            except OSError as e:
                raise WireError(
                    f"request to {addr_str(addr)} failed mid-send: {e}",
                    ambiguous_delivery=True,
                ) from e
            try:
                return recv_msg(sock)
            except (WireError, OSError) as e:
                # The request went out whole; only the reply failed — the
                # peer may well have processed it.
                raise WireError(
                    f"request to {addr_str(addr)} failed awaiting reply: {e}",
                    ambiguous_delivery=True,
                ) from e
    except WireError:
        raise
    except OSError as e:
        # close()-time failure on `with` exit, after the request was sent.
        raise WireError(
            f"request to {addr_str(addr)} failed at close: {e}",
            ambiguous_delivery=True,
        ) from e


# -- the production transport/clock pair --------------------------------------
#
# ClusterNode takes an injectable (transport, clock): these are the real
# ones (sockets + time.monotonic/time.sleep), with zero behavior change
# from the pre-seam node.  The transport contract, duck-typed and shared
# with cluster/simnet.py:
#
#   bind(host, port) -> Addr          allocate the listening address
#   serve(handler, on_error=None, io_timeout=5.0)
#                                     start delivering inbound messages;
#                                     handler(msg) returns an optional
#                                     reply dict (request/reply methods);
#                                     handler exceptions go to on_error
#   close()                           stop serving (idempotent)
#   send(addr, msg, timeout)          one message, no reply; raises WireError
#   request(addr, msg, timeout) -> dict


class SystemClock:
    """Production clock: real monotonic time, real sleeps.  Late-bound on
    purpose: the simnet purity guard (tests/conftest.py) monkeypatches
    ``time.sleep``, and a class-level ``sleep = time.sleep`` captured at
    import would let a simnet test that forgot ``clock=net.clock`` sleep
    real wall-clock seconds without the guard ever noticing."""

    @staticmethod
    def now() -> float:
        return time.monotonic()

    @staticmethod
    def sleep(dt: float) -> None:
        time.sleep(dt)


class TcpTransport:
    """Production transport: one listener, one thread per connection — the
    exact socket behavior ClusterNode always had, factored behind the
    transport seam so the simulated plane can replace it."""

    def __init__(self):
        self._listener: Optional[socket.socket] = None
        self._closed = threading.Event()
        self._handler: Optional[Callable[[dict], Optional[dict]]] = None
        self._on_error: Optional[Callable[[BaseException], None]] = None
        self._io_timeout = 5.0

    def bind(self, host: str, port: int) -> Addr:
        self._listener = socket.create_server((host, port))
        return (host, self._listener.getsockname()[1])

    def serve(
        self,
        handler: Callable[[dict], Optional[dict]],
        on_error: Optional[Callable[[BaseException], None]] = None,
        io_timeout: float = 5.0,
    ) -> None:
        if self._listener is None:
            raise RuntimeError("serve() before bind()")
        self._handler = handler
        self._on_error = on_error
        self._io_timeout = io_timeout
        threading.Thread(
            target=self._accept_loop, daemon=True, name="wire-accept"
        ).start()

    def close(self) -> None:
        self._closed.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            try:
                conn.settimeout(self._io_timeout)
                msg = recv_msg(conn)
                reply = self._handler(msg)
                if reply is not None:
                    reply_msg(conn, reply)
            except Exception as e:  # noqa: BLE001 - network input must never
                # kill the serving thread; reliability comes from sender-side
                # errors + retries, not server-side recovery.
                if not self._closed.is_set():
                    if self._on_error is not None:
                        self._on_error(e)
                    else:
                        _LOG.error("bad message: %r", e)

    def send(self, addr: Addr, msg: dict, timeout: float) -> None:
        send_msg(addr, msg, timeout)

    def request(self, addr: Addr, msg: dict, timeout: float) -> dict:
        return request(addr, msg, timeout)
