"""A loopback HTTP client for the port's scoring service, with the calls
the reference package's HTTP tests make on aiohttp's test utilities.

The reference tests write
`async with TestClient(TestServer(service.make_app())) as client:` and then
`await client.get(...)`, `await client.post(..., json=...)`,
`resp.status`, `resp.headers[...]`, `await resp.json()`, `await resp.text()`
and `await resp.read()`. Pointed at the port (tests/test_torch_*.py rewrite
their `aiohttp.test_utils` import to this module), the same bodies run
against the port's `api/web.py` server over a real socket on 127.0.0.1:
`TestServer` serves the app from a background thread, `TestClient` sends
each request with `http.client` on a worker thread, with a timeout, on a
fresh connection.
"""

from __future__ import annotations

import asyncio
import http.client
import json as _json
from typing import Optional
from urllib.parse import urlencode

from llm_d_kv_cache_manager_tpu_torch.api.web import AppServer

REQUEST_TIMEOUT_S = 30.0


class TestServer:
    __test__ = False

    def __init__(self, app, host: str = "127.0.0.1", port: int = 0):
        self.app = app
        self.host = host
        self.port = port
        self._server: Optional[AppServer] = None

    async def start_server(self) -> None:
        if self._server is not None:
            return
        self._server = AppServer(self.app)
        self.port = await asyncio.to_thread(self._server.start, self.host, self.port)

    async def close(self) -> None:
        if self._server is not None:
            server, self._server = self._server, None
            await asyncio.to_thread(server.stop)


class ClientResponse:
    def __init__(self, status: int, reason: str, headers, body: bytes):
        self.status = status
        self.reason = reason
        self.headers = headers
        self._body = body

    async def read(self) -> bytes:
        return self._body

    async def text(self) -> str:
        return self._body.decode("utf-8")

    async def json(self):
        return _json.loads(self._body.decode("utf-8"))

    def release(self) -> None:
        pass


class TestClient:
    __test__ = False

    def __init__(self, server: TestServer, timeout_s: float = REQUEST_TIMEOUT_S):
        self.server = server
        self.timeout_s = timeout_s

    async def start_server(self) -> None:
        await self.server.start_server()

    async def close(self) -> None:
        await self.server.close()

    async def __aenter__(self) -> "TestClient":
        await self.start_server()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    def _send(self, method: str, path: str, body: Optional[bytes], headers: dict) -> ClientResponse:
        conn = http.client.HTTPConnection(self.server.host, self.server.port,
                                          timeout=self.timeout_s)
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            return ClientResponse(resp.status, resp.reason, resp.headers, data)
        finally:
            conn.close()

    async def request(self, method: str, path: str, *, json=None, data=None,
                      headers=None, params=None) -> ClientResponse:
        if self.server._server is None:
            await self.start_server()
        hdrs = dict(headers or {})
        body = None
        if json is not None:
            body = _json.dumps(json).encode("utf-8")
            hdrs.setdefault("Content-Type", "application/json")
        elif data is not None:
            body = data.encode("utf-8") if isinstance(data, str) else bytes(data)
        if params:
            path = path + ("&" if "?" in path else "?") + urlencode(params)
        return await asyncio.to_thread(self._send, method.upper(), path, body, hdrs)

    async def get(self, path: str, **kwargs) -> ClientResponse:
        return await self.request("GET", path, **kwargs)

    async def post(self, path: str, **kwargs) -> ClientResponse:
        return await self.request("POST", path, **kwargs)
