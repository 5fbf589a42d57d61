"""Stdlib-socket RPC for the serving fleet: length-prefixed CRC-checked
frames with deadline propagation (port of ``keystone_tpu/serving/fleet_rpc.py``).

The fleet router process does no device work (the planes own all of it),
so this module is stdlib + nothing: it names no ``torch`` at any scope
(``tests/test_torch_fleet_unit.py`` checks its syntax tree), has no numpy
requirement of its own (numpy objects travel opaquely inside pickled
payloads), and imports nothing of the port beyond the fault harness. (The
port's package root imports torch, so "clean" is a property of this
module's own imports, as it is of the reference's ``jax-clean-module``.)

Frame format (network byte order)::

    +--------+----------------+----------------+----------------+
    | magic  | payload length | crc32(payload) | payload bytes  |
    | 4 B    | 4 B unsigned   | 4 B unsigned   | length B       |
    +--------+----------------+----------------+----------------+

``magic = b"KFR1"``. The payload is a pickled dict. The CRC is checked
on EVERY receive — a mismatch raises :class:`FrameCorrupted`, never
yields a corrupt object (the same never-serve-wrong-bits posture as the
zoo's per-tensor CRCs; the plan ship additionally carries per-tensor
CRCs so weight corruption is caught even when framing survives). The
frames are the reference's byte for byte: either package reads the
other's.

Deadline propagation: requests carry ``deadline_ms`` — the REMAINING
deadline budget at send time, recomputed by the router from the
caller's original deadline minus queueing elapsed. The plane enforces
it through its own admission (earliest-deadline shedding), so a request
that burned its budget queueing at the router is shed at the plane door
instead of executing dead work.

Fault site: every client send fires ``fleet.rpc.send``
(:mod:`keystone_tpu_torch.utils.faults`) BEFORE any bytes hit the wire, so
an injected error is always safely retryable (at-most-once: once the
frame is written, the caller must NOT retry — the plane may have
executed).
"""

from __future__ import annotations

import logging
import pickle
import socket
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from keystone_tpu_torch.utils import faults

__all__ = [
    "FrameCorrupted",
    "RpcClient",
    "RpcServer",
    "recv_frame",
    "send_frame",
]

logger = logging.getLogger(__name__)

MAGIC = b"KFR1"
_HEADER = struct.Struct("!4sII")
#: Hard frame bound: a corrupt length field must not allocate unbounded
#: memory before the CRC check can reject the payload. The reference
#: bounds frames at 64 MiB, which a canary of TIMIT's full-width plan
#: overruns: its ship carries the 38.5 MB of weights twice (the pickled
#: skeleton and the split planes), a 77 MB ``offer`` frame. The port
#: bounds them at 256 MiB; frames within 64 MiB cross either way.
MAX_FRAME_BYTES = 256 * 1024 * 1024


class FrameCorrupted(RuntimeError):
    """A frame failed its magic/length/CRC check — the connection is
    poisoned and must be closed, never read past."""


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError(
                f"peer closed mid-frame ({len(buf)}/{n} bytes)"
            )
        buf.extend(chunk)
    return bytes(buf)


def send_frame(sock: socket.socket, obj: Any, fire_fault: bool = False) -> None:
    """Pickle ``obj`` and write one frame. ``fire_fault`` runs the
    ``fleet.rpc.send`` fault site BEFORE any bytes are written, so
    injected errors never leave a half-sent frame (and are therefore
    safely retryable by the client)."""
    if fire_fault:
        faults.maybe_fail(faults.SITE_FLEET_RPC_SEND)
    payload = pickle.dumps(obj, protocol=4)
    if len(payload) > MAX_FRAME_BYTES:
        raise ValueError(
            f"frame payload {len(payload)} B exceeds {MAX_FRAME_BYTES} B"
        )
    header = _HEADER.pack(MAGIC, len(payload), zlib.crc32(payload))
    sock.sendall(header + payload)


def recv_frame(sock: socket.socket,
               timeout_s: Optional[float] = None) -> Any:
    """Read one frame; verify magic, length bound and CRC; unpickle.
    Raises :class:`FrameCorrupted` on any integrity failure,
    ``socket.timeout`` past ``timeout_s``, ``ConnectionError`` on EOF."""
    sock.settimeout(timeout_s)
    header = _recv_exact(sock, _HEADER.size)
    magic, length, crc = _HEADER.unpack(header)
    if magic != MAGIC:
        raise FrameCorrupted(f"bad magic {magic!r}")
    if length > MAX_FRAME_BYTES:
        raise FrameCorrupted(f"frame length {length} exceeds bound")
    payload = _recv_exact(sock, length)
    if zlib.crc32(payload) != crc:
        raise FrameCorrupted(
            f"payload CRC mismatch ({length} B frame)"
        )
    return pickle.loads(payload)


class RpcServer:
    """Threaded request/response server over frames: one accept loop,
    one thread per connection, ``handler(dict) -> dict`` per request.

    The handler runs on the connection's thread; an exception inside it
    is converted into ``{"ok": False, "error": "handler_error", ...}``
    so a bad request never kills the connection loop. ``close()`` stops
    the accept loop, closes every live connection and joins all
    threads."""

    def __init__(self, handler: Callable[[Dict[str, Any]], Dict[str, Any]],
                 host: str = "127.0.0.1", port: int = 0):
        self._handler = handler
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()
        self._closed = threading.Event()
        self._lock = threading.Lock()
        self._conns: List[socket.socket] = []
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fleet-rpc-accept", daemon=True
        )
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="fleet-rpc-conn", daemon=True,
            )
            with self._lock:
                self._conns.append(conn)
                self._threads.append(t)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._closed.is_set():
                try:
                    req = recv_frame(conn, timeout_s=None)
                except (ConnectionError, OSError):
                    return
                except FrameCorrupted as e:
                    # Poisoned stream: reply once (best effort) and
                    # drop the connection — never resynchronize past a
                    # failed CRC.
                    try:
                        send_frame(conn, {"ok": False,
                                          "error": "frame_corrupted",
                                          "message": str(e)})
                    except OSError:
                        pass
                    return
                try:
                    resp = self._handler(req)
                except Exception as e:  # noqa: BLE001 — loud, conn survives
                    logger.warning("fleet rpc handler failed: %r", e)
                    resp = {"ok": False, "error": "handler_error",
                            "message": f"{type(e).__name__}: {e}"}
                try:
                    send_frame(conn, resp)
                except OSError:
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self, timeout: float = 5.0) -> None:
        self._closed.set()
        # shutdown() wakes the accept loop blocked in accept(); close()
        # alone does not on Linux, and its join would wait out the
        # timeout.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns, threads = list(self._conns), list(self._threads)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        self._accept_thread.join(timeout)
        for t in threads:
            t.join(timeout)

    def __enter__(self) -> "RpcServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RpcClient:
    """Pooled request/response client. Thread-safe: concurrent
    ``request()`` calls each borrow (or dial) a connection, so N router
    dispatcher threads drive N parallel in-flight requests to a plane.

    The ``fleet.rpc.send`` fault fires before any bytes are written, so
    ``send_retries`` bounded, paced retries are safe (at-most-once is
    preserved: a frame that hit the wire is NEVER resent — failures
    after the write surface to the caller as connection errors)."""

    def __init__(self, host: str, port: int,
                 connect_timeout_s: float = 5.0,
                 send_retries: int = 3,
                 retry_base_delay_s: float = 0.02):
        self.host, self.port = host, int(port)
        self.connect_timeout_s = float(connect_timeout_s)
        self.send_retries = int(send_retries)
        self.retry_base_delay_s = float(retry_base_delay_s)
        self._lock = threading.Lock()
        self._idle: List[socket.socket] = []
        self._closed = False

    def _dial(self) -> socket.socket:
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout_s
        )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _borrow(self) -> socket.socket:
        with self._lock:
            if self._closed:
                raise ConnectionError("client closed")
            if self._idle:
                return self._idle.pop()
        return self._dial()

    def _give_back(self, sock: socket.socket) -> None:
        with self._lock:
            if not self._closed and len(self._idle) < 32:
                self._idle.append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass

    def request(self, obj: Dict[str, Any],
                timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """One round trip. Pre-write failures (dial errors, injected
        ``fleet.rpc.send`` faults) retry up to ``send_retries`` times
        with paced exponential backoff; post-write failures raise
        immediately (at-most-once)."""
        attempt = 0
        while True:
            try:
                sock = self._borrow()
            except OSError as e:
                attempt += 1
                if attempt > self.send_retries:
                    raise ConnectionError(
                        f"dial {self.host}:{self.port} failed after "
                        f"{attempt} attempts: {e}"
                    ) from e
                time.sleep(self.retry_base_delay_s * (2 ** (attempt - 1)))
                continue
            wrote = False
            try:
                send_frame(sock, obj, fire_fault=True)
                wrote = True
                resp = recv_frame(sock, timeout_s=timeout_s)
            except Exception as e:
                try:
                    sock.close()
                except OSError:
                    pass
                if wrote:
                    raise
                # Injected send fault or stale pooled connection: the
                # frame never hit the wire, safe to retry (paced).
                attempt += 1
                if attempt > self.send_retries:
                    raise
                logger.debug("fleet rpc pre-write retry %d: %r", attempt, e)
                time.sleep(self.retry_base_delay_s * (2 ** (attempt - 1)))
                continue
            self._give_back(sock)
            return resp

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for sock in idle:
            try:
                sock.close()
            except OSError:
                pass

    def __enter__(self) -> "RpcClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
