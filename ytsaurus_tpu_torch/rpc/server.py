"""RPC server: services with method registries hosted on one TCP endpoint.

Ref shape: core/rpc/service_detail.h (method registry, per-method
concurrency limits, error-to-wire mapping) — redesigned on asyncio.
Handlers are plain sync callables (they do numpy/torch work) executed on
a thread pool; the event loop only frames/unframes packets, so one slow
handler never stalls the bus. A handler thread has no device of its own:
what it runs on the card takes the cluster's device explicitly.

Own copy of the JAX package's `rpc/server.py`.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextvars
import socket
import threading
import traceback

from ytsaurus_tpu_torch import yson
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.rpc.packet import PacketError, read_packet, write_packet
from ytsaurus_tpu_torch.rpc.wire import decode_body, encode_body
from ytsaurus_tpu_torch.utils import failpoints
from ytsaurus_tpu_torch.utils.logging import get_logger
from ytsaurus_tpu_torch.utils.profiling import Profiler
from ytsaurus_tpu_torch.utils.tracing import TraceContext

logger = get_logger("rpc")
_profiler = Profiler("/rpc/server")

# Server-side receive fault: `error`/`crash-once` drop the connection
# (the client sees exactly what a dying peer produces — a reset with no
# reply), `delay` stalls the reply (straggler server).
_FP_RECV = failpoints.register_site("rpc.server.recv")


def rpc_method(name: str | None = None, concurrency: int = 16):
    """Marks a Service method as remotely callable."""
    def wrap(fn):
        fn._rpc_name = name or fn.__name__
        fn._rpc_concurrency = concurrency
        return fn
    return wrap


class Service:
    """Base: subclasses define @rpc_method handlers.

    Handler signature: handler(body: dict, attachments: list[bytes])
    → body | (body, attachments).  Raise YtError for application errors."""

    name: str = "service"

    def rpc_methods(self) -> dict[str, tuple]:
        out = {}
        for attr in dir(self):
            fn = getattr(self, attr)
            if callable(fn) and hasattr(fn, "_rpc_name"):
                out[fn._rpc_name] = (fn, fn._rpc_concurrency)
        return out


def _error_to_wire(err: YtError) -> dict:
    return {
        "code": int(err.code),
        "message": err.message,
        "attributes": err.attributes or {},
        "inner_errors": [_error_to_wire(e) for e in err.inner_errors],
    }


def error_from_wire(wire: dict) -> YtError:
    return YtError(
        _text(wire.get("message", b"")),
        code=int(wire.get("code", EErrorCode.Generic)),
        attributes=wire.get("attributes") or {},
        inner_errors=[error_from_wire(w)
                      for w in wire.get("inner_errors", [])],
    )


def _text(v) -> str:
    return v.decode("utf-8", "replace") if isinstance(v, bytes) else str(v)


class RpcServer:
    """Hosts services on a TCP port inside a dedicated event-loop thread.

    `stats` counts the requests served and the packet bytes read and
    written (all parts, envelopes included); only the loop thread
    updates it."""

    def __init__(self, services, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 16):
        self.host = host
        self.port = port
        self._services = {}
        for svc in services:
            self.add_service(svc)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="rpc-worker")
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._server: asyncio.AbstractServer | None = None
        self._connections: set = set()
        self._started = threading.Event()
        self.stats = {"requests": 0, "bytes_in": 0, "bytes_out": 0}

    def add_service(self, svc) -> None:
        """Register a service (also usable after start: daemons bring up
        bootstrap services first, then the driver once state is recovered)."""
        self._services[svc.name] = {
            mname: (fn, asyncio.Semaphore(conc))
            for mname, (fn, conc) in svc.rpc_methods().items()}

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        """Starts the loop thread; returns once the port is bound."""
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rpc-server")
        self._thread.start()
        if not self._started.wait(timeout=30):
            raise YtError("RPC server failed to start")

    def serve_forever(self) -> None:
        """Runs the server on the CURRENT thread (daemon main loop)."""
        self._run()

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        self._loop.run_until_complete(self._bind())
        self._started.set()
        try:
            self._loop.run_forever()
        finally:
            self._loop.run_until_complete(self._loop.shutdown_asyncgens())
            self._loop.close()

    async def _bind(self) -> None:
        self._server = await asyncio.start_server(
            self._on_connection, self.host, self.port,
            family=socket.AF_INET)
        self.port = self._server.sockets[0].getsockname()[1]

    def stop(self) -> None:
        if self._loop is None:
            return
        def _shutdown():
            if self._server is not None:
                self._server.close()
            # Close live connections, or clients on a half-dead peer hang
            # until their call timeout instead of reconnecting.
            for writer in list(self._connections):
                writer.close()
            self._connections.clear()
            self._loop.stop()
        self._loop.call_soon_threadsafe(_shutdown)
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._pool.shutdown(wait=False, cancel_futures=True)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # -- connection handling ---------------------------------------------------

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername")
        write_lock = asyncio.Lock()
        self._connections.add(writer)
        try:
            while True:
                try:
                    parts = await read_packet(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    return
                except PacketError as exc:
                    logger.warning("dropping connection from %s: %s",
                                   peer, exc)
                    return
                asyncio.ensure_future(
                    self._dispatch(parts, writer, write_lock))
        finally:
            self._connections.discard(writer)
            writer.close()

    async def _dispatch(self, parts, writer, write_lock) -> None:
        self.stats["requests"] += 1
        self.stats["bytes_in"] += sum(len(p) for p in parts)
        act = _FP_RECV.fire()
        if act is not None:
            mode, ms = act
            if mode == "delay":
                await asyncio.sleep(ms / 1000.0)
            else:
                # Simulated peer death mid-request: no reply, reset.
                writer.close()
                return
        try:
            envelope = yson.loads(parts[0], encoding=None)
            rid = int(envelope["rid"])
            service = _text(envelope.get("service", b""))
            method = _text(envelope.get("method", b""))
        except Exception as exc:   # noqa: BLE001 — protocol garbage
            logger.warning("malformed envelope from peer: %r; dropping "
                           "connection", exc)
            writer.close()
            return
        try:
            svc = self._services.get(service)
            if svc is None:
                raise YtError(f"No such service {service!r}",
                              code=EErrorCode.NoSuchService)
            entry = svc.get(method)
            if entry is None:
                raise YtError(
                    f"No such method {service}.{method}",
                    code=EErrorCode.NoSuchMethod)
            fn, sem = entry
            body = decode_body(yson.loads(parts[1], encoding=None)) \
                if len(parts) > 1 else {}
            attachments = list(parts[2:])
            trace_wire = envelope.get("trace")

            def invoke():
                # Server span continues the caller's trace (ref: rpc
                # handlers run under the propagated TTraceContext).  An
                # UNtraced request gets the null span — handlers must
                # not mint root traces per RPC (the entry points that
                # own sampling are the gateway/scheduler/proxy).
                from ytsaurus_tpu_torch.utils.tracing import NULL_SPAN
                span = TraceContext.from_wire(
                    trace_wire, f"{service}.{method}") \
                    if trace_wire else NULL_SPAN
                with span:
                    span.add_tag("service", service)
                    prof = _profiler.with_tags(service=service,
                                               method=method)
                    prof.counter("request_count").increment()
                    with prof.timer("request_time"):
                        return fn(body, attachments)

            # EXPLICIT contextvars capture: the
            # handler runs on a pooled executor thread whose context is
            # whatever the PREVIOUS request left behind —
            # run_in_executor does not propagate or isolate contextvars.
            # Running inside a fresh copy of the (clean) loop context
            # both restores the caller's restored-from-wire trace and
            # guarantees a handler that leaked an ambient context cannot
            # poison the next request on the same thread.
            handler_ctx = contextvars.copy_context()
            async with sem:
                result = await asyncio.get_event_loop().run_in_executor(
                    self._pool, lambda: handler_ctx.run(invoke))
            if isinstance(result, tuple):
                out_body, out_attachments = result
            else:
                out_body, out_attachments = result, []
            reply_env = yson.dumps({"rid": rid, "kind": "rsp"}, binary=True)
            reply_body = yson.dumps(
                encode_body(out_body if out_body is not None else {}),
                binary=True)
            out = [reply_env, reply_body, *out_attachments]
        except YtError as err:
            out = [yson.dumps({"rid": rid, "kind": "err"}, binary=True),
                   yson.dumps(_error_to_wire(err), binary=True)]
        except Exception as exc:      # noqa: BLE001 — wire boundary
            logger.error("unhandled error in %s.%s: %s\n%s", service, method,
                         exc, traceback.format_exc())
            err = YtError(f"Unhandled server error: {exc!r}",
                          code=EErrorCode.Generic)
            out = [yson.dumps({"rid": rid, "kind": "err"}, binary=True),
                   yson.dumps(_error_to_wire(err), binary=True)]
        self.stats["bytes_out"] += sum(len(p) for p in out)
        try:
            async with write_lock:
                await write_packet(writer, out)
        except (ConnectionError, RuntimeError):
            pass
