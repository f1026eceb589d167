"""In-process test client for the framework-free service core.

The equivalent of the reference's `fastapi.testclient.TestClient` usage
(SURVEY.md §4.2) without HTTP: requests go straight through `api.handle`.
"""

from __future__ import annotations

import json
from typing import Any, Optional

from .api import ApiRequest, ApiResponse, ServiceState, create_state

__all__ = ["LocalClient"]


class LocalResponse:
    def __init__(self, resp: ApiResponse):
        self._resp = resp
        self.status_code = resp.status
        self.headers = resp.headers

    def json(self) -> Any:
        body = self._resp.body
        if isinstance(body, (bytes, bytearray)):
            return json.loads(body.decode("utf-8"))
        return body

    @property
    def content(self) -> bytes:
        body = self._resp.body
        if isinstance(body, (bytes, bytearray)):
            return bytes(body)
        return json.dumps(body).encode("utf-8")

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")


class LocalClient:
    def __init__(self, state: Optional[ServiceState] = None):
        self.state = state or create_state()

    def request(
        self,
        method: str,
        path: str,
        json_body: Any = None,
        headers: Optional[dict[str, str]] = None,
        data: Optional[bytes] = None,
        query: Optional[dict[str, str]] = None,
        remote_ip: str = "127.0.0.1",
    ) -> LocalResponse:
        body = data if data is not None else (
            json.dumps(json_body).encode("utf-8") if json_body is not None else b""
        )
        req = ApiRequest(
            method=method.upper(),
            path=path,
            headers={k.lower(): v for k, v in (headers or {}).items()},
            body=body,
            remote_ip=remote_ip,
            query=query or {},
        )
        from .api import handle

        return LocalResponse(handle(self.state, req))

    def get(self, path: str, **kw) -> LocalResponse:
        return self.request("GET", path, **kw)

    def post(self, path: str, json_body: Any = None, **kw) -> LocalResponse:
        return self.request("POST", path, json_body=json_body, **kw)

    def put(self, path: str, json_body: Any = None, **kw) -> LocalResponse:
        return self.request("PUT", path, json_body=json_body, **kw)

    def delete(self, path: str, **kw) -> LocalResponse:
        return self.request("DELETE", path, **kw)
