"""Client channels: synchronous facade over the asyncio bus.

One shared background event-loop thread per process frames packets for all
channels (the analog of the reference's shared bus thread pool); callers
block on concurrent.futures handed across the loop boundary.  A
RetryingChannel wraps transport failures (never application YtErrors) with
reconnect + backoff, like core/rpc/retrying_channel.h.

Own copy of the JAX package's `rpc/channel.py`; `hedged_race` also serves
the client's replica-fallback lookups.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import itertools
import threading
import time

from ytsaurus_tpu_torch import yson
from ytsaurus_tpu_torch.config import retry_policy
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.rpc.packet import PacketError, read_packet, write_packet
from ytsaurus_tpu_torch.rpc.server import error_from_wire
from ytsaurus_tpu_torch.rpc.wire import decode_body, encode_body
from ytsaurus_tpu_torch.utils import failpoints
from ytsaurus_tpu_torch.utils.logging import get_logger
from ytsaurus_tpu_torch.utils import sanitizers

logger = get_logger("rpc")

# Injected send failures look exactly like a dropped connection (a
# dispatched transport error), so the retrying/failover/hedging wrappers
# exercise their real mid-call recovery ladders.
_FP_SEND = failpoints.register_site(
    "rpc.channel.send",
    error=lambda s: YtError(f"injected transport failure at {s}",
                            code=EErrorCode.TransportError))
# Raises ConnectionError, NOT YtError: the injected fault must walk the
# same never-dispatched path a real refused connect takes (the caller
# wraps it with dispatched=False, so even non-idempotent calls resend).
_FP_CONNECT = failpoints.register_site(
    "rpc.channel.connect",
    error=lambda s: ConnectionError(f"injected connect failure at {s}"))

# guards: _loop
_loop_lock = sanitizers.register_lock("channel._loop_lock", hot=False)
_loop: asyncio.AbstractEventLoop | None = None


def _shared_loop() -> asyncio.AbstractEventLoop:
    global _loop
    with _loop_lock:
        if _loop is None or _loop.is_closed():
            loop = asyncio.new_event_loop()
            thread = threading.Thread(
                target=loop.run_forever, daemon=True, name="rpc-client-loop")
            thread.start()
            _loop = loop
        return _loop


class _ConnState:
    """One live TCP connection: reader pump + pending request futures."""

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        self.pending: dict[int, asyncio.Future] = {}
        self.task: asyncio.Future | None = None
        self.alive = True


class Channel:
    """A connection to one RPC endpoint ("host:port")."""

    def __init__(self, address: str, timeout: float = 60.0):
        self.address = address
        host, port = address.rsplit(":", 1)
        self._host, self._port = host, int(port)
        self.timeout = timeout
        self._rid = itertools.count(1)
        # guards: _conn
        self._lock = sanitizers.register_lock("channel.Channel._lock")
        self._connect_lock: asyncio.Lock | None = None
        self._conn: _ConnState | None = None

    # -- wire ------------------------------------------------------------------

    async def _connect(self) -> "_ConnState":
        _FP_CONNECT.hit()
        reader, writer = await asyncio.open_connection(self._host, self._port)
        state = _ConnState(reader=reader, writer=writer)

        async def pump():
            try:
                while True:
                    parts = await read_packet(reader)
                    envelope = yson.loads(parts[0], encoding=None)
                    rid = int(envelope["rid"])
                    fut = state.pending.pop(rid, None)
                    if fut is not None and not fut.done():
                        fut.set_result((envelope, parts))
            except (asyncio.IncompleteReadError, ConnectionError,
                    PacketError, asyncio.CancelledError) as exc:
                state.alive = False
                for fut in state.pending.values():
                    if not fut.done():
                        fut.set_exception(ConnectionError(str(exc)))
                state.pending.clear()
                writer.close()

        state.task = asyncio.ensure_future(pump())
        return state

    async def _call_async(self, service: str, method: str, body,
                          attachments, timeout: float, trace_wire=None):
        if self._connect_lock is None:
            self._connect_lock = asyncio.Lock()
        async with self._connect_lock:
            # Serialized: concurrent first calls must share ONE connection
            # (unserialized, each would open and leak its own socket+pump).
            with self._lock:
                state = self._conn
            if state is None or not state.alive:
                try:
                    state = await self._connect()
                except (ConnectionError, OSError) as exc:
                    # The request was never sent: safe to resend even a
                    # non-idempotent call (see RetryingChannel).
                    raise YtError(
                        f"cannot connect to {self.address}: {exc}",
                        code=EErrorCode.TransportError,
                        attributes={"dispatched": False}) from exc
                with self._lock:
                    self._conn = state
        rid = next(self._rid)
        fut = asyncio.get_event_loop().create_future()
        state.pending[rid] = fut
        # No await between registration and this check, so the pump cannot
        # have died without either failing our future or being seen here.
        if not state.alive:
            state.pending.pop(rid, None)
            raise YtError(
                f"connection to {self.address} lost before dispatch",
                code=EErrorCode.TransportError,
                attributes={"dispatched": False})
        req = {"rid": rid, "kind": "req", "service": service,
               "method": method}
        if trace_wire is not None:
            req["trace"] = trace_wire
        envelope = yson.dumps(req, binary=True)
        wire_body = yson.dumps(encode_body(body if body is not None else {}),
                               binary=True)
        try:
            await write_packet(state.writer, [envelope, wire_body,
                                              *attachments])
            envelope, parts = await asyncio.wait_for(fut, timeout)
        except (ConnectionError, asyncio.IncompleteReadError):
            with self._lock:
                if self._conn is state:
                    self._conn = None
            raise
        except asyncio.TimeoutError:
            # A timed-out connection is suspect (half-dead peer, stopped
            # server loop) — drop it so the next attempt reconnects.
            state.pending.pop(rid, None)
            state.alive = False
            state.writer.close()
            with self._lock:
                if self._conn is state:
                    self._conn = None
            raise YtError(
                f"RPC {service}.{method} to {self.address} timed out "
                f"after {timeout}s", code=EErrorCode.RpcTimeout) from None
        kind = envelope["kind"]
        if kind == b"err":
            raise error_from_wire(yson.loads(parts[1], encoding=None))
        body = decode_body(yson.loads(parts[1], encoding=None)) \
            if len(parts) > 1 else {}
        return body, list(parts[2:])

    # -- public sync API -------------------------------------------------------

    def call(self, service: str, method: str, body=None,
             attachments=(), timeout: float | None = None,
             idempotent: bool = True):
        """Returns (body: dict, attachments: list[bytes]); raises YtError.
        `idempotent` is accepted (and ignored) so every channel shares
        one call signature — a bare Channel never resends, so the flag
        only matters to the retrying/failover/hedging wrappers."""
        timeout = timeout if timeout is not None else self.timeout
        _FP_SEND.hit()
        # Trace context is captured HERE, on the calling thread — contextvars
        # do not flow into the shared loop thread.
        from ytsaurus_tpu_torch.utils.tracing import current_trace
        ambient = current_trace()
        trace_wire = ambient.to_wire() if ambient is not None else None
        loop = _shared_loop()
        fut = asyncio.run_coroutine_threadsafe(
            self._call_async(service, method, body, list(attachments),
                             timeout, trace_wire), loop)
        try:
            return fut.result(timeout=timeout + 15)
        except concurrent.futures.TimeoutError as exc:
            fut.cancel()
            raise YtError(
                f"RPC {service}.{method} to {self.address} stalled on the "
                "client loop", code=EErrorCode.RpcTimeout) from exc
        except (ConnectionError, OSError, asyncio.IncompleteReadError) as exc:
            raise YtError(
                f"transport failure calling {service}.{method} on "
                f"{self.address}: {exc}",
                code=EErrorCode.TransportError) from exc

    def close(self) -> None:
        with self._lock:
            state, self._conn = self._conn, None
        if state is not None:
            loop = _shared_loop()
            if state.task is not None:
                loop.call_soon_threadsafe(state.task.cancel)
            loop.call_soon_threadsafe(state.writer.close)


def _never_dispatched(err: "YtError") -> bool:
    """True when a transport failure provably happened BEFORE the request
    was sent (connection refused), making even a non-idempotent resend
    safe.  A mid-call drop proves nothing — the peer may have executed
    the mutation before dying."""
    return err.code == EErrorCode.TransportError and \
        err.attributes.get("dispatched") is False


class _RetryBudget:
    """Token-bucket retry budget: each retry SPENDS one
    token; each successful call DEPOSITS `refill` tokens (capped at
    `capacity`); a throttled outcome deposits nothing — the budget is
    admission-aware, so a cluster that is shedding load watches retry
    traffic decay to the deposit rate instead of multiplying.

    Thread-safe; one budget per RetryingChannel instance, shared by
    every call through it (the budget models the CHANNEL's standing
    with the peer, not one request's patience)."""

    __slots__ = ("capacity", "refill", "_tokens", "_lock",
                 "spent_n", "exhausted_n")

    def __init__(self, capacity: int, refill: float):
        self.capacity = float(capacity)
        self.refill = refill
        self._tokens = float(capacity)     # starts full: first failures
        self._lock = threading.Lock()      # may retry immediately
        self.spent_n = 0
        self.exhausted_n = 0

    def try_spend(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.spent_n += 1
                return True
            self.exhausted_n += 1
            return False

    def deposit(self) -> None:
        with self._lock:
            self._tokens = min(self._tokens + self.refill, self.capacity)

    def snapshot(self) -> dict:
        with self._lock:
            return {"tokens": round(self._tokens, 3),
                    "capacity": self.capacity,
                    "spent": self.spent_n,
                    "exhausted": self.exhausted_n}


class RetryingChannel:
    """Retries TRANSPORT failures (peer restarting, dropped connection);
    application YtErrors pass through untouched.

    Attempts/backoff default to the process-wide retry policy
    (`config.retry_policy(policy)`) instead of per-call-site constants;
    backoff is exponential with a cap and decorrelating jitter
    (RetryPolicyConfig.delay).

    Serving-plane codes: RequestThrottled is
    retried even for non-idempotent calls — admission rejection means
    the request was NEVER executed — and the wait honors the error's
    `retry_after` hint instead of the generic backoff curve.
    DeadlineExceeded is TERMINAL: the deadline belongs to the caller's
    query, and a retry could not possibly land inside it.

    When the policy declares `retry_budget > 0`, retries draw
    from a token bucket refilled only by SUCCESSFUL calls (throttled
    outcomes refund nothing) — an exhausted budget fails fast, shedding
    load instead of feeding a retry storm.  Backoff sleeps are capped
    at the caller's `token.remaining()` (CancellationToken), and an
    already-expired deadline surfaces as DeadlineExceeded promptly
    instead of sleeping through it."""

    def __init__(self, channel: Channel, attempts: int | None = None,
                 backoff: float | None = None, policy: str = "rpc"):
        from ytsaurus_tpu_torch.config import RetryPolicyConfig
        cfg = retry_policy(policy)
        if attempts is not None or backoff is not None:
            # Caller overrides ride on a copy; the shared policy object
            # stays untouched.
            cfg = RetryPolicyConfig(
                attempts=attempts if attempts is not None else cfg.attempts,
                backoff=backoff if backoff is not None else cfg.backoff,
                backoff_cap=cfg.backoff_cap, jitter=cfg.jitter,
                retry_budget=cfg.retry_budget,
                retry_budget_refill=cfg.retry_budget_refill)
        self.channel = channel
        self._policy = cfg
        self.retry_budget: _RetryBudget | None = \
            _RetryBudget(cfg.retry_budget, cfg.retry_budget_refill) \
            if cfg.retry_budget > 0 else None

    @property
    def address(self) -> str:
        return self.channel.address

    @property
    def attempts(self) -> int:
        return self._policy.attempts

    def call(self, service: str, method: str, body=None,
             attachments=(), timeout: float | None = None,
             idempotent: bool = True, token=None):
        from ytsaurus_tpu_torch.errors import retry_after_hint
        from ytsaurus_tpu_torch.utils.tracing import child_span
        last: YtError | None = None
        budget = self.retry_budget
        for attempt in range(self._policy.attempts):
            if token is not None:
                # Surface an expired caller deadline NOW — before
                # dispatching (or sleeping toward) an attempt that
                # cannot possibly land inside it.
                token.check()
            try:
                # Fresh span PER ATTEMPT on the SAME trace: the wire
                # then carries a distinct parent span id for each try,
                # so retried server work nests under its own attempt
                # instead of aliasing the first.
                with child_span("rpc.call", service=service,
                                method=method, attempt=attempt):
                    result = self.channel.call(service, method, body,
                                               attachments, timeout)
                if budget is not None:
                    budget.deposit()
                return result
            except YtError as err:
                if err.contains(EErrorCode.DeadlineExceeded):
                    # Terminal: the caller's query deadline already
                    # passed on the server; a retry cannot beat it.
                    raise
                throttled = err.code == EErrorCode.RequestThrottled or \
                    err.contains(EErrorCode.RequestThrottled)
                # Neither a timeout NOR a dropped connection proves
                # non-execution (the mutation may have run on a dying
                # peer): a non-idempotent call is resent only when the
                # transport failure happened before dispatch (connect
                # refused — the request never left this process).  A
                # THROTTLE is always safe to resend: admission rejected
                # the request before anything executed.
                if throttled:
                    retryable = True
                elif idempotent:
                    retryable = err.code in (EErrorCode.TransportError,
                                             EErrorCode.RpcTimeout)
                else:
                    retryable = _never_dispatched(err)
                if not retryable:
                    raise
                last = err
                if attempt + 1 < self._policy.attempts:
                    # No sleep after the FINAL attempt: the failure is
                    # already decided, the caller shouldn't wait for it.
                    if budget is not None and not budget.try_spend():
                        # Budget dry: fail FAST — the cluster is
                        # already struggling, and N clients x M retries
                        # is exactly the storm the bucket caps.
                        raise YtError(
                            f"RPC to {self.channel.address}: retry "
                            f"budget exhausted after attempt "
                            f"{attempt + 1}",
                            code=EErrorCode.PeerUnavailable,
                            attributes={"retry_budget_exhausted": True},
                            inner_errors=[last])
                    hint = retry_after_hint(err) if throttled else None
                    delay = min(hint, self._policy.backoff_cap) \
                        if hint is not None \
                        else self._policy.delay(attempt)
                    if token is not None:
                        remaining = token.remaining()
                        if remaining is not None:
                            # Cap the backoff at the caller's deadline:
                            # sleeping past it only delays the
                            # DeadlineExceeded the next check raises.
                            delay = min(delay, remaining)
                    time.sleep(delay)
        if token is not None:
            token.check()
        raise YtError(
            f"RPC to {self.channel.address} failed after "
            f"{self._policy.attempts} attempts",
            code=EErrorCode.PeerUnavailable, inner_errors=[last])

    def close(self) -> None:
        self.channel.close()


# Cluster-wide cap on in-flight hedge threads: losing (slow) attempts
# park a daemon thread until they finish, so the cap must cover
# request_rate x slow_latency.  Past it, hedged_race degrades to running
# attempts sequentially in the caller's thread — safe, just unhedged.
_HEDGE_SLOTS = threading.BoundedSemaphore(64)


def hedged_race(attempts: "list", delay: float):
    """First-success race with staggered arming (ref
    core/rpc/hedging_channel.h generalized to N attempts): attempt 0
    starts immediately; attempt i+1 is armed after `delay` with no
    answer, or IMMEDIATELY when attempt i fails.  Raises the last
    YtError when every attempt fails; a NON-YtError from any attempt
    propagates immediately (a programming error must never be swallowed
    into a silent hang).  Losing attempts run on abandoned daemon
    threads — a wedged loser cannot block the caller or interpreter
    exit."""
    import queue as _queue

    if not attempts:
        raise YtError("hedged race with no attempts",
                      code=EErrorCode.PeerUnavailable)
    results: "_queue.SimpleQueue" = _queue.SimpleQueue()

    def run(fn):
        try:
            try:
                results.put(("ok", fn()))
            except BaseException as err:  # noqa: BLE001 — relayed below
                results.put(("err", err))
        finally:
            _HEDGE_SLOTS.release()

    started = 0
    pending = 0
    last: YtError | None = None
    while True:
        if started < len(attempts):
            fn = attempts[started]
            if _HEDGE_SLOTS.acquire(blocking=False):
                started += 1
                try:
                    threading.Thread(target=run, args=(fn,), daemon=True,
                                     name=f"hedge-{started}").start()
                except BaseException:
                    # Thread spawn failed (fd/thread exhaustion): the
                    # slot must not leak out of the global pool.
                    _HEDGE_SLOTS.release()
                    raise
                pending += 1
            elif pending == 0:
                # Saturated with nothing in flight: run inline
                # (sequential fallback) rather than spawning unboundedly.
                started += 1
                try:
                    return fn()
                except YtError as err:
                    last = err
                    continue
            # Saturated with attempts in flight: fall through and wait
            # on their results (a fast success must win over blocking
            # inline on the next attempt); arming retries next loop.
        if pending == 0 and started >= len(attempts):
            raise last
        try:
            kind, value = results.get(
                timeout=delay if started < len(attempts) else None)
        except _queue.Empty:
            continue                # stagger elapsed: arm the next
        pending -= 1
        if kind == "ok":
            return value
        if not isinstance(value, YtError):
            raise value             # programming error: surface, loudly
        last = value                # failure: arm the next immediately


class HedgingChannel:
    """Race a DELAYED backup request against the primary (ref
    core/rpc/hedging_channel.h): when the primary has not answered
    within `hedging_delay`, the same request is sent to the backup and
    the first success wins — tail latency of one slow peer is bounded by
    hedging_delay + the healthy peer's latency, instead of the slow
    peer's timeout.  A fast primary FAILURE hedges immediately.

    Hedging applies only to idempotent calls: a duplicated mutation
    would double-execute, so non-idempotent calls go primary-only."""

    def __init__(self, primary, backup, hedging_delay: float = 0.05):
        self.primary = primary
        self.backup = backup
        self.hedging_delay = hedging_delay

    @property
    def address(self) -> str:
        return self.primary.address

    def call(self, service: str, method: str, body=None,
             attachments=(), timeout: float | None = None,
             idempotent: bool = True):
        if not idempotent:
            # The flag must reach a wrapped RetryingChannel/Failover
            # channel too, or IT would resend the mutation.
            return self.primary.call(service, method, body, attachments,
                                     timeout, idempotent=False)
        return hedged_race(
            [lambda: self.primary.call(service, method, body, attachments,
                                       timeout),
             lambda: self.backup.call(service, method, body, attachments,
                                      timeout)],
            self.hedging_delay)

    def close(self) -> None:
        self.primary.close()
        self.backup.close()


class FailoverChannel:
    """Channel over several master addresses: sticks to the one that
    last answered, rotates on errors that mean "this peer cannot serve
    me" (dead process, or a follower without the service), and keeps
    cycling with backoff until the failover window closes — which is
    what rides out a leader election.

    Retry semantics extend RetryingChannel's: NoSuchService (follower —
    the call never dispatched) and never-dispatched connect failures
    rotate always; dispatched TransportError / RpcTimeout /
    PeerUnavailable rotate only for idempotent calls (the mutation may
    have executed on the dying peer).
    Ref: dynamic channel pools + peer rediscovery
    (yt/yt/core/rpc/dynamic_channel_pool.h)."""

    def __init__(self, addresses: "list[str]", timeout: float = 120.0,
                 failover_window: float = 45.0, backoff: float = 0.3):
        if not addresses:
            raise ValueError("FailoverChannel needs at least one address")
        self._channels = [Channel(a, timeout=timeout) for a in addresses]
        self._current = 0
        self.failover_window = failover_window
        self.backoff = backoff

    @property
    def address(self) -> str:
        return self._channels[self._current].address

    def call(self, service: str, method: str, body=None,
             attachments=(), timeout: float | None = None,
             idempotent: bool = True):
        deadline = time.monotonic() + self.failover_window
        last: YtError | None = None
        cycle = 0
        while True:
            channel = self._channels[self._current]
            try:
                return channel.call(service, method, body, attachments,
                                    timeout)
            except YtError as err:
                if idempotent:
                    rotatable = err.code in (
                        EErrorCode.NoSuchService, EErrorCode.TransportError,
                        EErrorCode.RpcTimeout, EErrorCode.PeerUnavailable)
                else:
                    # NoSuchService is the follower's answer — the call
                    # never executed there.  A dropped connection only
                    # rotates when the request provably never left this
                    # process; otherwise the mutation may have committed
                    # on the dying leader and a resend would double-run
                    # it (no server-side mutation-id dedup).
                    rotatable = err.code == EErrorCode.NoSuchService or \
                        _never_dispatched(err)
                if not rotatable:
                    raise
                last = err
                self._current = (self._current + 1) % len(self._channels)
                cycle += 1
                if time.monotonic() > deadline:
                    raise YtError(
                        "no master answered within the failover window "
                        f"({self.failover_window:.0f}s)",
                        code=EErrorCode.PeerUnavailable,
                        inner_errors=[last])
                if cycle % len(self._channels) == 0:
                    time.sleep(min(self.backoff *
                                   (2 ** (cycle // len(self._channels))),
                                   3.0))

    def close(self) -> None:
        for channel in self._channels:
            channel.close()
