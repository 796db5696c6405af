"""HTTP proxy: the REST surface (`/api/v4/<command>`) over the driver.

Ref shape: server/http_proxy (api.h, context.h) — a stateless daemon that
authenticates the request, resolves the command against the driver
registry, parses parameters from headers/query/body, streams table data
in wire formats, and forwards to the cluster.

Redesign: stdlib ThreadingHTTPServer over a client, one handler per
command call:

  POST /api/v4/select_rows   {"query": "..."}            → JSON rows
  PUT  /api/v4/write_table?path=//t  (body = format rows)
  GET  /api/v4/read_table?path=//t&format=json           → format rows
  GET  /api/v4/get?path=//home/@x                        → JSON value
  GET  /ping | /hosts | /api | /api/v4

The authenticated principal comes from `X-YT-User` (the reference reads
auth tokens; local clusters run unauthenticated with user stamping).
Parameters merge: query string < `X-YT-Parameters` header (JSON) < JSON
body — later wins, matching the reference's precedence.

Own copy of the JAX package's `server/http_proxy.py`. The port has no
remote client yet, so its proxy serves an in-process client through
`Driver(client)` (the reference's path for a client without `_execute`);
the selects run on the cluster's device. Every value of a reply must be a
plain Python value: a torch tensor that leaks out of a result is refused,
not printed.
"""

from __future__ import annotations

import collections
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from ytsaurus_tpu_torch.driver import COMMANDS
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.utils.logging import get_logger

logger = get_logger("HttpProxy")

_FORMAT_CONTENT_TYPES = {
    "json": "application/json",
    "yson": "application/x-yt-yson-binary",
    "dsv": "text/tab-separated-values",
    "schemaful_dsv": "text/tab-separated-values",
}


def _json_default(value):
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    if isinstance(value, torch.Tensor):
        raise TypeError(f"a torch tensor ({value.dtype}, {value.device}) "
                        "leaked into a reply")
    return str(value)


class HttpProxy:
    """Serves the REST API against a client (RemoteYtClient or YtClient)."""

    def __init__(self, client_factory, host: str = "127.0.0.1",
                 port: int = 0):
        """client_factory(user) → client executing as that principal."""
        self._client_factory = client_factory
        self._clients: "collections.OrderedDict[str, object]" = \
            collections.OrderedDict()
        self._clients_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _run(self):
                try:
                    outer._handle(self)
                except (ConnectionError, BrokenPipeError):
                    pass
                except Exception as exc:   # noqa: BLE001 — wire boundary
                    logger.exception("proxy request failed")
                    try:
                        outer._reply_error(self, YtError(repr(exc)))
                    except (ConnectionError, BrokenPipeError):
                        pass

            do_GET = do_POST = do_PUT = _run

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="http-proxy")
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    # -- request handling ------------------------------------------------------

    _MAX_CLIENTS = 64

    def _client(self, user: str):
        with self._clients_lock:
            client = self._clients.get(user)
            if client is not None:
                # LRU touch.
                self._clients.pop(user)
                self._clients[user] = client
                return client
            # X-YT-User is caller-supplied: bound the cache or unique
            # user strings leak one connection each.
            while len(self._clients) >= self._MAX_CLIENTS:
                _, evicted = self._clients.popitem(last=False)
                try:
                    evicted.close()
                except Exception:   # noqa: BLE001 — eviction best-effort
                    pass
            client = self._clients[user] = self._client_factory(user)
            return client

    def _handle(self, request) -> None:
        parsed = urllib.parse.urlsplit(request.path)
        path = parsed.path.rstrip("/") or "/"
        # ALWAYS drain the request body first: replying while unread body
        # bytes sit on a keep-alive connection corrupts the next request.
        length = int(request.headers.get("Content-Length") or 0)
        raw_body = request.rfile.read(length) if length else b""
        if path == "/ping":
            self._reply(request, 200, b"", "text/plain")
            return
        if path in ("/api", "/api/v4"):
            body = json.dumps(sorted(COMMANDS)).encode()
            self._reply(request, 200, body, "application/json")
            return
        if path == "/hosts":
            body = json.dumps([self.address]).encode()
            self._reply(request, 200, body, "application/json")
            return
        if not path.startswith("/api/v4/"):
            self._reply(request, 404, b"not found", "text/plain")
            return
        command = path[len("/api/v4/"):]
        if command not in COMMANDS:
            self._reply_error(request, YtError(
                f"Unknown command {command!r}",
                code=EErrorCode.NoSuchMethod), status=404)
            return
        user = request.headers.get("X-YT-User", "root")
        params, data_body = self._parse_parameters(request, parsed,
                                                   raw_body)
        # Serving-plane deadline: X-YT-Timeout (seconds) maps onto the
        # query gateway's deadline for lookup/select commands.
        header_timeout = request.headers.get("X-YT-Timeout")
        if header_timeout and command in ("select_rows", "lookup_rows"):
            try:
                params.setdefault("timeout", float(header_timeout))
            except ValueError:
                pass
        # Distributed tracing over HTTP: an X-YT-Trace-Id
        # header pins (and force-samples) the query's trace id, so the
        # caller can fetch the span tree from /traces/<id> afterwards;
        # the id is echoed on the response either way the trace rooted.
        trace_header = request.headers.get("X-YT-Trace-Id")
        from ytsaurus_tpu_torch.utils.tracing import NULL_SPAN, start_query_span
        span = NULL_SPAN
        if command in ("select_rows", "lookup_rows"):
            span = start_query_span(f"http.{command}",
                                    force=trace_header is not None,
                                    trace_id=trace_header or None,
                                    user=user)
        if span.trace_id:
            request.yt_trace_id = span.trace_id
        try:
            with span:
                result = self._execute(command, params, data_body, user)
        except YtError as err:
            self._reply_error(request, err)
            return
        self._reply_result(request, command, params, result)

    @staticmethod
    def _parse_parameters(request, parsed, body: bytes) -> tuple[dict, bytes]:
        params: dict = {}
        for key, value in urllib.parse.parse_qsl(parsed.query):
            try:
                params[key] = json.loads(value)
            except ValueError:
                params[key] = value
        header = request.headers.get("X-YT-Parameters")
        if header:
            params.update(json.loads(header))
        content_type = (request.headers.get("Content-Type") or "").split(
            ";")[0].strip()
        data_body = b""
        if body:
            if content_type == "application/json" and \
                    request.command == "POST":
                try:
                    params.update(json.loads(body))
                except ValueError:
                    data_body = body
            else:
                data_body = body       # table payload (write_table etc.)
        return params, data_body

    def _execute(self, command: str, params: dict, data_body: bytes,
                 user: str):
        client = self._client(user)
        descriptor = COMMANDS[command]
        if command == "write_table" and "rows" not in params:
            # Raw table payload in the request body (PUT/POST with a
            # format); JSON parameter rows take the registry path instead.
            params.setdefault("format", "json")
            return client.write_table(
                params["path"], data_body, format=params["format"],
                append=bool(params.get("append", False)))
        if command == "read_table":
            params.setdefault("format", "json")
        kwargs = dict(params)
        # The remote client mirrors driver commands as methods where the
        # shapes differ; everything else goes through the registry.
        if hasattr(client, "_execute"):
            return client._execute(command, kwargs, idempotent=not
                                   descriptor.is_mutating)
        from ytsaurus_tpu_torch.driver import Driver
        return Driver(client).execute(command, kwargs)

    def _reply_result(self, request, command: str, params: dict,
                      result) -> None:
        if isinstance(result, bytes):
            fmt = params.get("format", "json")
            ctype = _FORMAT_CONTENT_TYPES.get(fmt,
                                              "application/octet-stream")
            self._reply(request, 200, result, ctype)
            return
        body = json.dumps({"value": result}, default=_json_default).encode()
        self._reply(request, 200, body, "application/json")

    def _reply_error(self, request, err: YtError,
                     status: int = 400) -> None:
        from ytsaurus_tpu_torch.errors import retry_after_hint
        retry_after = None
        if err.contains(EErrorCode.RequestThrottled):
            # Admission rejection → 429 + Retry-After, the HTTP shape of
            # the serving plane's retry_after hint.
            status = 429
            retry_after = retry_after_hint(err)
        elif err.contains(EErrorCode.DeadlineExceeded):
            status = 504
        body = json.dumps(err.to_dict(), default=_json_default).encode()
        request.send_response(status)
        request.send_header("Content-Type", "application/json")
        trace_id = getattr(request, "yt_trace_id", None)
        if trace_id:
            request.send_header("X-YT-Trace-Id", trace_id)
        if retry_after is not None:
            request.send_header("Retry-After", f"{retry_after:.3f}")
        request.send_header("X-YT-Error", json.dumps(
            {"code": err.code, "message": err.message},
            default=_json_default)[:1024])
        request.send_header("Content-Length", str(len(body)))
        request.end_headers()
        request.wfile.write(body)

    @staticmethod
    def _reply(request, status: int, body: bytes, ctype: str) -> None:
        request.send_response(status)
        request.send_header("Content-Type", ctype)
        trace_id = getattr(request, "yt_trace_id", None)
        if trace_id:
            request.send_header("X-YT-Trace-Id", trace_id)
        request.send_header("Content-Length", str(len(body)))
        request.end_headers()
        request.wfile.write(body)
