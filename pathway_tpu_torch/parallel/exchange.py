"""The serve fabric's point-to-point wire (counterpart of the
``FramedStream`` half of ``pathway_tpu/parallel/exchange.py``).

One ``FramedStream`` is a token-authenticated, length-prefixed pickle
stream over one TCP connection: an 8-byte big-endian length (``_HDR``)
before each pickled frame, and a 32-byte session secret (``_TOKEN_LEN``)
that the accepting side reads first and checks with
``hmac.compare_digest`` BEFORE it parses any frame, since unpickling
bytes from an unauthenticated peer would hand it arbitrary code.  Any
thread may ``send`` (one send lock keeps frames whole); exactly one
thread should ``recv``.  A broken or closed connection surfaces as
``PeerLost``; a ``recv`` timeout with no frame started surfaces as
``socket.timeout`` so a caller can poll.

The frames carry the same dicts as the reference's (``serve``,
``result``, ``error``, ``ping``, ``pong``, ``absorb``, ``absorb_ack``,
``bye``), so a reference front can drive a port worker and back.

The reference module's other half, ``ExchangePlane`` (a BSP mesh that
carries the host dataflow engine's ``Delta`` records between ranks), is
not ported: the port does not port the engine, and its device data plane
runs on ``torch.distributed`` (``parallel/distributed.py``).
"""

from __future__ import annotations

import hmac
import pickle
import socket
import struct
import threading
from typing import Any, Optional

__all__ = ["FramedStream", "PeerLost"]

_HDR = struct.Struct("!Q")
_TOKEN_LEN = 32


class PeerLost(RuntimeError):
    """The peer disconnected (crashed, exited or closed the stream)."""


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("exchange connection closed")
        buf += chunk
    return bytes(buf)


class FramedStream:
    """One authenticated duplex frame stream (see the module docstring)."""

    __slots__ = ("_sock", "_send_lock", "_closed")

    def __init__(self, sock: socket.socket):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._send_lock = threading.Lock()
        self._closed = False

    @classmethod
    def connect(cls, host: str, port: int, token: bytes, timeout: float = 5.0) -> "FramedStream":
        """Dial a listener and present the session secret (client side)."""
        s = socket.create_connection((host, port), timeout=timeout)
        try:
            s.sendall(token)
        except OSError as exc:
            s.close()
            raise PeerLost(f"fabric connect to {host}:{port} failed: {exc!r}")
        s.settimeout(None)
        return cls(s)

    @classmethod
    def accept(cls, conn: socket.socket, token: bytes, timeout: float = 10.0) -> "FramedStream":
        """Authenticate one accepted connection (server side): the first
        ``_TOKEN_LEN`` bytes must equal the session secret, or the
        connection is closed before any frame is parsed."""
        try:
            conn.settimeout(timeout)
            offered = _recv_exact(conn, _TOKEN_LEN)
            if not hmac.compare_digest(offered, token):
                raise PermissionError("bad fabric token")
            conn.settimeout(None)
        except BaseException:
            try:
                conn.close()
            except OSError:
                pass
            raise
        return cls(conn)

    def send(self, obj: Any) -> None:
        """Pickle, frame and write ``obj`` (thread-safe)."""
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        frame = _HDR.pack(len(payload)) + payload
        try:
            with self._send_lock:
                self._sock.sendall(frame)
        except OSError as exc:
            raise PeerLost(f"fabric send failed: {exc!r}") from exc

    def recv(self, timeout: Optional[float] = None) -> Any:
        """The next frame, unpickled.  ``socket.timeout`` when ``timeout``
        elapses before a frame starts; ``PeerLost`` on disconnect."""
        try:
            self._sock.settimeout(timeout)
            hdr = _recv_exact(self._sock, _HDR.size)
            # once a header has landed the frame is in flight: the poll
            # timeout must not cut a slow payload short
            self._sock.settimeout(None)
            (length,) = _HDR.unpack(hdr)
            return pickle.loads(_recv_exact(self._sock, length))
        except socket.timeout:
            raise
        except (OSError, ConnectionError, EOFError) as exc:
            raise PeerLost(f"fabric recv failed: {exc!r}") from exc

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
