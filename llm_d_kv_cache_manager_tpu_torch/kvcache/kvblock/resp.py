"""Minimal RESP2 (Redis Serialization Protocol) client with pipelining.

Copy of the reference package's `kvcache/kvblock/resp.py`. No Redis client
library is used, so this module speaks the protocol directly: a thread-safe
connection supporting pipelined command
batches over TCP or Unix sockets, covering the command set the index needs
(PING, SET, GET, DEL, HSET, HDEL, HKEYS, HLEN, FLUSHALL).
"""

from __future__ import annotations

import socket
import threading
from typing import Any, List, Optional, Sequence, Tuple, Union
from urllib.parse import urlparse

RespValue = Union[None, int, bytes, str, list, Exception]


class RespError(Exception):
    """Server-side -ERR reply."""


class RespConnection:
    """One socket, thread-safe, pipelining-capable."""

    def __init__(self, url: str, timeout_s: float = 5.0):
        """`url`: redis://host:port[/db], valkey://host:port, or unix:///path."""
        self.url = _normalize_url(url)
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._mu = threading.Lock()

    # -- connection management ----------------------------------------------

    def connect(self) -> None:
        # Under _mu: swapping the socket/buffer while another thread is
        # mid-pipeline would tear its frames (it could read replies
        # belonging to the new connection's SELECT, or crash mid-write).
        with self._mu:
            parsed = urlparse(self.url)
            if parsed.scheme == "unix":
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.settimeout(self.timeout_s)
                sock.connect(parsed.path)
            else:
                host = parsed.hostname or "localhost"
                port = parsed.port or 6379
                sock = socket.create_connection(
                    (host, port), timeout=self.timeout_s
                )
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = sock
            self._buf = b""
            db = (urlparse(self.url).path or "").lstrip("/")
            if db and db.isdigit() and db != "0":
                self._execute_locked([("SELECT", db)])

    def close(self) -> None:
        with self._mu:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None

    # -- command execution ----------------------------------------------------

    def execute(self, *args: Union[str, bytes, int]) -> RespValue:
        """Execute one command; raises RespError on -ERR replies."""
        result = self.pipeline([args])[0]
        if isinstance(result, Exception):
            raise result
        return result

    def pipeline(self, commands: Sequence[Tuple]) -> List[RespValue]:
        """Send all commands in one write, read all replies (single RTT).

        Per-command errors are returned in-place as RespError values (like
        go-redis pipelines), not raised.
        """
        with self._mu:
            return self._execute_locked(commands)

    def ping(self) -> bool:
        return self.execute("PING") in (b"PONG", "PONG")

    # -- internals -----------------------------------------------------------

    def _execute_locked(self, commands: Sequence[Tuple]) -> List[RespValue]:
        if self._sock is None:
            raise ConnectionError("not connected (call connect() first)")
        payload = b"".join(_encode_command(cmd) for cmd in commands)
        try:
            self._sock.sendall(payload)
            return [self._read_reply() for _ in commands]
        except (OSError, ConnectionError):
            # Drop the broken socket so the caller can reconnect.
            try:
                self._sock.close()
            finally:
                self._sock = None
            raise

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:  # payload + trailing \r\n
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2:]
        return data

    def _read_reply(self) -> RespValue:
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest
        if kind == b"-":
            return RespError(rest.decode("utf-8", "replace"))
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            return self._read_exact(n)
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise ConnectionError(f"unknown RESP reply type: {line!r}")


def _encode_command(args: Tuple) -> bytes:
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, int):
            a = str(a).encode()
        elif isinstance(a, str):
            a = a.encode("utf-8")
        out.append(b"$%d\r\n%s\r\n" % (len(a), a))
    return b"".join(out)


def _normalize_url(url: str) -> str:
    """Accept valkey(s):// as an alias of redis(s)://, bare host:port too."""
    if "://" not in url:
        return f"redis://{url}"
    if url.startswith("valkeys://"):
        return "rediss://" + url[len("valkeys://"):]
    if url.startswith("valkey://"):
        return "redis://" + url[len("valkey://"):]
    return url
