"""A small HTTP/1.1 server on `asyncio` streams, for the scoring service.

The reference package serves `api/http_service.py` with aiohttp. This
module keeps the few names of `aiohttp.web` that the service uses
(`Request`, `Response`, `json_response`, `Application` with its
`router.add_get` / `add_post`, `run_app`), so the service's handlers stay
the reference's coroutines line for line, and stands on the standard
library alone.

Why `asyncio` streams and not `http.server.ThreadingHTTPServer`: every
scoring handler is a coroutine that hands its work to a worker thread
(`asyncio.to_thread`) under the admission gate, and the gate's bounds are
what shed load. One event loop holds every open connection, idle
keep-alive ones included, without a thread each, so the only threads
doing work are the ones the gate admits.

`AppServer` runs an `Application` on its own event loop in a background
thread (tests, an embedding process); `run_app` runs one in the calling
thread until interrupted (`python -m ...api.http_service`).

What the protocol side keeps: HTTP/1.1 keep-alive (closed on
`Connection: close` or after `KEEPALIVE_TIMEOUT_S` idle), `Content-Length`
and chunked request bodies, HEAD on every GET route, 404 for an unknown
path and 405 with `Allow` for a known path under another method, 413 past
`MAX_BODY_BYTES`, 400 for a request that does not parse, and 500 with the
error text when a handler raises.
"""

from __future__ import annotations

import asyncio
import json
import threading
from http import HTTPStatus
from typing import Awaitable, Callable, Dict, Iterable, List, Optional, Tuple
from urllib.parse import parse_qsl, urlsplit

Handler = Callable[["Request"], Awaitable["Response"]]

MAX_LINE_BYTES = 16384
MAX_HEADERS = 128
MAX_BODY_BYTES = 64 * 1024 * 1024
KEEPALIVE_TIMEOUT_S = 75.0


class CIMultiDict:
    """Case-insensitive header map; `get` returns the first value."""

    def __init__(self, items: Iterable[Tuple[str, str]] = ()):
        self._items: List[Tuple[str, str]] = []
        for k, v in items:
            self.add(k, v)

    def add(self, key: str, value: str) -> None:
        self._items.append((key, value))

    def get(self, key: str, default=None):
        low = key.lower()
        for k, v in self._items:
            if k.lower() == low:
                return v
        return default

    def __getitem__(self, key: str) -> str:
        value = self.get(key)
        if value is None:
            raise KeyError(key)
        return value

    def __contains__(self, key) -> bool:
        return self.get(key) is not None

    def __setitem__(self, key: str, value: str) -> None:
        low = key.lower()
        self._items = [(k, v) for k, v in self._items if k.lower() != low]
        self._items.append((key, value))

    def items(self) -> List[Tuple[str, str]]:
        return list(self._items)

    def __iter__(self):
        return (k for k, _ in self._items)

    def __len__(self) -> int:
        return len(self._items)


class Query(dict):
    """Query parameters; a repeated key keeps its first value (as
    aiohttp's `request.query.get` answers)."""

    @classmethod
    def parse(cls, raw: str) -> "Query":
        q = cls()
        for k, v in parse_qsl(raw, keep_blank_values=True):
            q.setdefault(k, v)
        return q


class Request:
    def __init__(self, method: str, target: str, version: str, headers: CIMultiDict,
                 body: bytes):
        self.method = method
        self.version = version
        parts = urlsplit(target)
        self.path = parts.path or "/"
        self.query = Query.parse(parts.query)
        self.headers = headers
        self._body = body

    async def read(self) -> bytes:
        return self._body

    async def text(self) -> str:
        return self._body.decode("utf-8")

    async def json(self, loads=json.loads):
        return loads(self._body.decode("utf-8"))


class Response:
    def __init__(
        self,
        body: Optional[bytes] = None,
        status: int = 200,
        headers: Optional[Dict[str, str]] = None,
        text: Optional[str] = None,
        content_type: Optional[str] = None,
        charset: Optional[str] = None,
    ):
        if body is not None and text is not None:
            raise ValueError("body and text are not allowed together")
        self.status = int(status)
        self.headers = CIMultiDict((headers or {}).items())
        if text is not None:
            self.body = text.encode(charset or "utf-8")
            ctype = content_type or "text/plain"
            self.headers["Content-Type"] = f"{ctype}; charset={charset or 'utf-8'}"
        else:
            self.body = bytes(body or b"")
            if content_type is not None:
                self.headers["Content-Type"] = content_type
            elif "Content-Type" not in self.headers:
                self.headers["Content-Type"] = "application/octet-stream"


def json_response(data, *, status: int = 200, headers: Optional[Dict[str, str]] = None,
                  dumps=json.dumps) -> Response:
    return Response(text=dumps(data), status=status, headers=headers,
                    content_type="application/json")


def _error(status: int, message: str, headers: Optional[Dict[str, str]] = None) -> Response:
    return json_response({"error": message}, status=status, headers=headers)


class Router:
    def __init__(self):
        self._routes: Dict[str, Dict[str, Handler]] = {}

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        methods = self._routes.setdefault(path, {})
        method = method.upper()
        if method in methods:
            raise ValueError(f"route {method} {path} registered twice")
        methods[method] = handler

    def add_get(self, path: str, handler: Handler) -> None:
        self.add_route("GET", path, handler)
        self.add_route("HEAD", path, handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self.add_route("POST", path, handler)

    def routes(self) -> List[Tuple[str, str]]:
        """(method, path) of every registration, HEAD left out."""
        return [(m, p) for p, ms in self._routes.items() for m in ms if m != "HEAD"]

    def resolve(self, method: str, path: str):
        """(handler, None) or (None, the error response)."""
        methods = self._routes.get(path)
        if methods is None:
            return None, _error(404, "Not Found")
        handler = methods.get(method.upper())
        if handler is None:
            allow = ", ".join(sorted(methods))
            return None, _error(405, "Method Not Allowed", {"Allow": allow})
        return handler, None


class Application:
    def __init__(self):
        self.router = Router()

    async def dispatch(self, request: Request) -> Response:
        handler, error = self.router.resolve(request.method, request.path)
        if error is not None:
            return error
        try:
            response = await handler(request)
        except Exception as e:  # noqa: BLE001 - a handler fault is a 500, never a dead connection
            return _error(500, f"{type(e).__name__}: {e}")
        return response


class _BadRequest(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


async def _read_line(reader: asyncio.StreamReader) -> bytes:
    try:
        line = await reader.readuntil(b"\n")
    except asyncio.LimitOverrunError as e:
        raise _BadRequest(431, "line too long") from e
    except asyncio.IncompleteReadError as e:
        if e.partial:
            raise _BadRequest(400, "truncated request") from e
        raise
    return line.rstrip(b"\r\n")


async def _read_chunked(reader: asyncio.StreamReader, limit: int) -> bytes:
    out = bytearray()
    while True:
        size_line = await _read_line(reader)
        try:
            size = int(size_line.split(b";", 1)[0].strip(), 16)
        except ValueError as e:
            raise _BadRequest(400, "bad chunk size") from e
        if size == 0:
            while await _read_line(reader):  # trailers, then the blank line
                pass
            return bytes(out)
        if len(out) + size > limit:
            raise _BadRequest(413, "request body too large")
        out += await reader.readexactly(size)
        await reader.readexactly(2)


async def _read_request(reader: asyncio.StreamReader) -> Request:
    line = await _read_line(reader)
    while not line:  # tolerate blank lines between requests
        line = await _read_line(reader)
    try:
        method, target, version = line.decode("latin-1").split(" ", 2)
    except ValueError as e:
        raise _BadRequest(400, "bad request line") from e
    if not version.startswith("HTTP/1."):
        raise _BadRequest(505, "HTTP version not supported")
    headers = CIMultiDict()
    while True:
        hl = await _read_line(reader)
        if not hl:
            break
        if len(headers) >= MAX_HEADERS:
            raise _BadRequest(431, "too many headers")
        name, sep, value = hl.decode("latin-1").partition(":")
        if not sep:
            raise _BadRequest(400, "bad header line")
        headers.add(name.strip(), value.strip())
    body = b""
    if headers.get("Transfer-Encoding", "").lower() == "chunked":
        body = await _read_chunked(reader, MAX_BODY_BYTES)
    elif "Content-Length" in headers:
        try:
            n = int(headers["Content-Length"])
        except ValueError as e:
            raise _BadRequest(400, "bad Content-Length") from e
        if n < 0:
            raise _BadRequest(400, "bad Content-Length")
        if n > MAX_BODY_BYTES:
            raise _BadRequest(413, "request body too large")
        body = await reader.readexactly(n)
    return Request(method.upper(), target, version, headers, body)


def _serialize(response: Response, head_only: bool, keep_alive: bool) -> bytes:
    try:
        reason = HTTPStatus(response.status).phrase
    except ValueError:
        reason = ""
    lines = [f"HTTP/1.1 {response.status} {reason}"]
    for k, v in response.headers.items():
        if k.lower() not in ("content-length", "connection"):
            lines.append(f"{k}: {v}")
    lines.append(f"Content-Length: {len(response.body)}")
    lines.append("Connection: keep-alive" if keep_alive else "Connection: close")
    head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
    return head if head_only else head + response.body


async def _serve_connection(app: Application, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
    try:
        while True:
            try:
                request = await asyncio.wait_for(
                    _read_request(reader), timeout=KEEPALIVE_TIMEOUT_S
                )
            except (asyncio.IncompleteReadError, asyncio.TimeoutError, ConnectionError):
                return
            except _BadRequest as e:
                writer.write(_serialize(_error(e.status, str(e)), False, False))
                await writer.drain()
                return
            conn = request.headers.get("Connection", "").lower()
            keep_alive = conn != "close" and not (
                request.version == "HTTP/1.0" and conn != "keep-alive"
            )
            response = await app.dispatch(request)
            writer.write(_serialize(response, request.method == "HEAD", keep_alive))
            await writer.drain()
            if not keep_alive:
                return
    except ConnectionError:
        return
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


class AppServer:
    """An `Application` served from a background thread's event loop."""

    def __init__(self, app: Application):
        self.app = app
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()

    def start(self, host: str = "127.0.0.1", port: int = 0, timeout_s: float = 10.0) -> int:
        """Bind, start serving, and return the bound port (`port=0`
        picks a free one)."""
        if self._thread is not None:
            raise RuntimeError("server already started")
        ready = threading.Event()
        failure: List[BaseException] = []
        self._loop = asyncio.new_event_loop()

        async def open_server():
            self._server = await asyncio.start_server(
                self._on_connection, host, port, limit=MAX_LINE_BYTES
            )
            sock = self._server.sockets[0]
            self.host, self.port = sock.getsockname()[:2]

        def run():
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(open_server())
            except BaseException as e:  # noqa: BLE001 - handed to start()
                failure.append(e)
                ready.set()
                return
            ready.set()
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, name="http-server", daemon=True)
        self._thread.start()
        if not ready.wait(timeout_s):
            raise TimeoutError("HTTP server did not start")
        if failure:
            self._thread.join(timeout_s)
            self._thread = None
            raise failure[0]
        return self.port

    async def _on_connection(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            await _serve_connection(self.app, reader, writer)
        finally:
            self._conns.discard(task)

    def stop(self, timeout_s: float = 10.0) -> None:
        """Close the listener and every connection, stop the loop and
        join its thread."""
        if self._thread is None or self._loop is None:
            return

        async def shutdown():
            if self._server is not None:
                self._server.close()
                await self._server.wait_closed()
            for task in list(self._conns):
                task.cancel()
            if self._conns:
                await asyncio.gather(*self._conns, return_exceptions=True)

        fut = asyncio.run_coroutine_threadsafe(shutdown(), self._loop)
        try:
            fut.result(timeout_s)
        finally:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout_s)
            if not self._thread.is_alive():
                self._loop.close()
            self._thread = None

    def __enter__(self) -> "AppServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def run_app(app: Application, host: str = "0.0.0.0", port: int = 8080) -> None:
    """Serve `app` in the calling thread until KeyboardInterrupt."""

    async def main():
        server = await asyncio.start_server(
            lambda r, w: _serve_connection(app, r, w), host, port, limit=MAX_LINE_BYTES
        )
        async with server:
            await server.serve_forever()

    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        pass
