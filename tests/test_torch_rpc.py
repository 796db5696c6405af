"""The port's RPC plane (`ytsaurus_tpu_torch/rpc/`) against the JAX
package's: the reference's own tests (tests/test_rpc.py, all 15) run on
the port; packets and YSON bodies are the reference's byte for byte for
seeded message parts; and each package's channel calls the other's
server with the same results, error codes and attributes, with the trace
context carried across.
"""

import asyncio
import itertools
import time

import numpy as np
import pytest

from tests.test_torch_client import call_twin, port_twin, twin_cases
from ytsaurus_tpu import native as ref_native
from ytsaurus_tpu import rpc as ref_rpc
from ytsaurus_tpu import yson as ref_yson
from ytsaurus_tpu.errors import YtError as RefYtError
from ytsaurus_tpu.rpc import packet as ref_packet
from ytsaurus_tpu.rpc import server as ref_server
from ytsaurus_tpu.rpc import wire as ref_wire
from ytsaurus_tpu.utils import tracing as ref_tracing
from ytsaurus_tpu_torch import native, rpc, yson
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.rpc import packet, server, wire
from ytsaurus_tpu_torch.utils import tracing

# --- the reference's tests, on the port --------------------------------------

_TWIN = port_twin("test_rpc")
_CASES = twin_cases(_TWIN)


def test_twin_list_is_whole():
    assert len(_CASES) == 15


@pytest.fixture(scope="module")
def twin_server():
    """The reference module's `server` fixture, on the port."""
    srv = _TWIN.RpcServer([_TWIN.EchoService()])
    srv.start()
    yield srv
    srv.stop()


@pytest.mark.parametrize("name", _CASES)
def test_reference_rpc_case_on_the_port(name, twin_server):
    channel = _TWIN.Channel(twin_server.address, timeout=30)
    try:
        call_twin(_TWIN, name, {"server": twin_server, "channel": channel})
    finally:
        channel.close()


# --- bytes on the wire --------------------------------------------------------


def _same_checksum_path() -> bool:
    """Both packages checksum through the host codec library, or both
    through the tagged numpy fallback."""
    return (native.lib() is None) == (ref_native.lib() is None)


def _seeded_parts(seed: int) -> list:
    rng = np.random.default_rng(seed)
    sizes = [0, 1, 7, 8, 63, 64, 4096, 65_537]
    return [rng.integers(0, 256, int(rng.choice(sizes)), dtype=np.uint8)
            .tobytes() for _ in range(int(rng.integers(1, 7)))]


def _seeded_body(rng, depth: int = 0):
    """A message body of every type the wire carries: text and bytes,
    int64 and doubles, booleans, None, nested lists and maps, and the
    escaped single-key `$`-maps."""
    kind = int(rng.integers(0, 9 if depth < 3 else 6))
    if kind == 0:
        return int(rng.integers(-2**62, 2**62))
    if kind == 1:
        return float(rng.standard_normal())
    if kind == 2:
        return "".join(chr(int(c)) for c in rng.integers(32, 0x2FF, 5))
    if kind == 3:
        return rng.integers(0, 256, int(rng.integers(0, 9)),
                            dtype=np.uint8).tobytes()
    if kind == 4:
        return bool(rng.integers(0, 2))
    if kind == 5:
        return None
    if kind == 6:
        return [_seeded_body(rng, depth + 1)
                for _ in range(int(rng.integers(0, 4)))]
    if kind == 7:
        return {f"k{i}": _seeded_body(rng, depth + 1)
                for i in range(int(rng.integers(0, 4)))}
    return {str(rng.choice(["$b", "$x", "$$b"])): _seeded_body(rng, depth + 1)}


@pytest.mark.parametrize("seed", range(6))
def test_packets_are_the_references_byte_for_byte(seed):
    assert _same_checksum_path()
    parts = _seeded_parts(seed)
    blob = packet.encode_packet(parts)
    assert blob == ref_packet.encode_packet(parts)

    async def read(data, read_packet):
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        return await read_packet(reader)

    loop = asyncio.new_event_loop()
    try:
        assert loop.run_until_complete(read(blob, ref_packet.read_packet)) \
            == parts
        assert loop.run_until_complete(
            read(ref_packet.encode_packet(parts), packet.read_packet)) == parts
    finally:
        loop.close()


@pytest.mark.parametrize("seed", range(8))
def test_bodies_are_the_references_byte_for_byte(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(20):
        body = {"value": _seeded_body(rng), "rows": [
            {"k": int(rng.integers(0, 99)), "s": _seeded_body(rng)}]}
        port_blob = yson.dumps(wire.encode_body(body), binary=True)
        ref_blob = ref_yson.dumps(ref_wire.encode_body(body), binary=True)
        assert port_blob == ref_blob
        back = wire.decode_body(yson.loads(ref_blob, encoding=None))
        assert back == ref_wire.decode_body(
            ref_yson.loads(port_blob, encoding=None))
        assert wire.wire_text(b"\xc3\xa9") == ref_wire.wire_text(
            b"\xc3\xa9") == "é"


def test_a_request_packet_is_the_references():
    """The envelope and body of one request as the channels build them."""
    trace = {"trace_id": "ab" * 16, "span_id": "cd" * 8, "sampled": True,
             "baggage": {"user": "alice"}}
    req = {"rid": 7, "kind": "req", "service": "driver",
           "method": "execute", "trace": trace}
    body = {"command": "select_rows",
            "parameters": {"query": "k FROM [//t]", "timeout": 2.5}}
    parts = [yson.dumps(req, binary=True),
             yson.dumps(wire.encode_body(body), binary=True), b"att"]
    ref_parts = [ref_yson.dumps(req, binary=True),
                 ref_yson.dumps(ref_wire.encode_body(body), binary=True),
                 b"att"]
    assert packet.encode_packet(parts) == ref_packet.encode_packet(ref_parts)


def test_errors_cross_the_wire_alike():
    inner = YtError("inner", code=EErrorCode.NoSuchNode,
                    attributes={"path": "//x"})
    err = YtError("outer", code=EErrorCode.PeerUnavailable,
                  attributes={"n": 3}, inner_errors=[inner])
    ref_err = RefYtError("outer", code=int(EErrorCode.PeerUnavailable),
                         attributes={"n": 3}, inner_errors=[RefYtError(
                             "inner", code=int(EErrorCode.NoSuchNode),
                             attributes={"path": "//x"})])
    port_wire = yson.dumps(server._error_to_wire(err), binary=True)
    assert port_wire == ref_yson.dumps(ref_server._error_to_wire(ref_err),
                                       binary=True)
    back = server.error_from_wire(yson.loads(port_wire, encoding=None))
    ref_back = ref_server.error_from_wire(
        ref_yson.loads(port_wire, encoding=None))
    assert (back.code, back.message, back.attributes) == \
        (ref_back.code, ref_back.message, ref_back.attributes)
    assert back.inner_errors[0].attributes == {"path": b"//x"}


def test_trace_context_wire_form_matches():
    ctx = tracing.TraceContext("call", trace_id="12" * 16, sampled=True,
                               baggage={"pool": "gold"})
    ref_ctx = ref_tracing.TraceContext("call", trace_id="12" * 16,
                                       sampled=True, baggage={"pool": "gold"})
    port_w, ref_w = ctx.to_wire(), ref_ctx.to_wire()
    assert sorted(port_w) == sorted(ref_w)
    assert (port_w["trace_id"], port_w["sampled"], port_w["baggage"]) == \
        (ref_w["trace_id"], ref_w["sampled"], ref_w["baggage"])
    wired = ref_yson.loads(ref_yson.dumps(ref_w, binary=True),
                           encoding=None)
    child = tracing.TraceContext.from_wire(wired, "svc.m")
    assert (child.trace_id, child.parent_span_id, child.baggage) == \
        (ref_ctx.trace_id, ref_ctx.span_id, {"pool": "gold"})
    assert tracing.NULL_SPAN.to_wire() is None
    assert tracing.TraceContext.from_wire(None, "fresh").trace_id


# --- each package's channel against the other's server ------------------------


def _echo_service(pkg):
    Service, rpc_method, Error = {
        "port": (server.Service, server.rpc_method, YtError),
        "reference": (ref_server.Service, ref_server.rpc_method,
                      RefYtError)}[pkg]
    tracing_mod = tracing if pkg == "port" else ref_tracing

    class Echo(Service):
        name = "echo"

        @rpc_method()
        def echo(self, body, attachments):
            return {"echo": body.get("value"), "n": len(attachments)}, \
                [bytes(a)[::-1] for a in attachments]

        @rpc_method()
        def fail(self, body, attachments):
            raise Error("intentional", code=int(EErrorCode.NoSuchNode),
                        attributes={"path": "//tmp/x", "n": 3},
                        inner_errors=[Error("cause", code=1)])

        @rpc_method()
        def crash(self, body, attachments):
            raise RuntimeError("boom")

        @rpc_method()
        def trace(self, body, attachments):
            ctx = tracing_mod.current_trace()
            return {"trace_id": ctx.trace_id if ctx else None,
                    "parent": ctx.parent_span_id if ctx else None}

    return Echo()


_SCRIPT = [
    ("echo", "echo", {"value": {"a": [1, 2.5, "x", b"\x00y", None, True]}},
     [b"one", b"", b"\x00" * 70_000]),
    ("echo", "echo", {"value": "été"}, []),
    ("echo", "fail", {}, []),
    ("echo", "crash", {}, []),
    ("echo", "nope", {}, []),
    ("ghost", "echo", {}, []),
]


def _outcome(call):
    try:
        return ("ok", call())
    except (YtError, RefYtError) as err:
        inner = [(e.code, e.message) for e in err.inner_errors]
        return ("err", int(err.code), err.message.split(":")[0],
                err.attributes, inner)


def _run_script(channel_cls, address):
    channel = channel_cls(address, timeout=30)
    try:
        return [_outcome(lambda s=s: channel.call(*s)) for s in _SCRIPT]
    finally:
        channel.close()


@pytest.mark.parametrize("server_pkg,channel_pkg",
                         [("reference", "port"), ("port", "reference")])
def test_cross_package_calls(server_pkg, channel_pkg):
    Server = ref_rpc.RpcServer if server_pkg == "reference" \
        else rpc.RpcServer
    Channel = rpc.Channel if channel_pkg == "port" else ref_rpc.Channel
    OtherChannel = ref_rpc.Channel if channel_pkg == "port" else rpc.Channel
    srv = Server([_echo_service(server_pkg)])
    srv.start()
    try:
        crossed = _run_script(Channel, srv.address)
        same_package = _run_script(OtherChannel, srv.address)
    finally:
        srv.stop()
    assert crossed == same_package
    assert crossed[0] == ("ok", ({"echo": {"a": [1, 2.5, "x", b"\x00y",
                                                 None, True]}, "n": 3},
                                 [b"eno", b"", b"\x00" * 70_000]))
    assert crossed[2] == ("err", int(EErrorCode.NoSuchNode), "intentional",
                          {"path": b"//tmp/x", "n": 3}, [(1, "cause")])
    assert crossed[3][:2] == ("err", int(EErrorCode.Generic))
    assert crossed[4][1] == int(EErrorCode.NoSuchMethod)
    assert crossed[5][1] == int(EErrorCode.NoSuchService)


@pytest.mark.parametrize("server_pkg", ["reference", "port"])
def test_trace_context_crosses_packages(server_pkg):
    Server = ref_rpc.RpcServer if server_pkg == "reference" \
        else rpc.RpcServer
    Channel, Ctx = (rpc.Channel, tracing.TraceContext) \
        if server_pkg == "reference" else \
        (ref_rpc.Channel, ref_tracing.TraceContext)
    srv = Server([_echo_service(server_pkg)])
    srv.start()
    channel = Channel(srv.address, timeout=30)
    try:
        untraced, _ = channel.call("echo", "trace", {})
        with Ctx("caller") as root:
            traced, _ = channel.call("echo", "trace", {})
    finally:
        channel.close()
        srv.stop()
    assert untraced == {"trace_id": None, "parent": None}
    assert traced == {"trace_id": root.trace_id, "parent": root.span_id}


def test_retrying_channel_rides_a_reference_server_restart():
    """A port RetryingChannel over a reference server that goes away and
    comes back on the same port."""
    srv = ref_rpc.RpcServer([_echo_service("reference")])
    srv.start()
    port = srv.port
    channel = rpc.RetryingChannel(rpc.Channel(srv.address, timeout=10))
    try:
        assert channel.call("echo", "echo", {"value": 1})[0]["echo"] == 1
        srv.stop()
        srv = ref_rpc.RpcServer([_echo_service("reference")], port=port)
        srv.start()
        assert channel.call("echo", "echo", {"value": 2})[0]["echo"] == 2
    finally:
        channel.close()
        srv.stop()


def test_hedged_race_is_the_clients():
    """The client's replica-fallback lookups race through rpc/channel.py's
    hedged_race (the client keeps no copy of its own)."""
    from ytsaurus_tpu_torch import client
    from ytsaurus_tpu_torch.rpc import channel
    assert not hasattr(client, "hedged_race")
    order = itertools.count()
    t0 = time.monotonic()
    winner = channel.hedged_race(
        [lambda: (time.sleep(1.0), next(order))[1],
         lambda: ("backup", next(order))], 0.02)
    assert winner == ("backup", 0) and time.monotonic() - t0 < 0.9
    with pytest.raises(YtError) as err:
        client._hedged_race([], 0.01, YtError("base", code=1))
    assert err.value.message == "base"


def test_rpc_retry_policy_is_the_references():
    import random

    from ytsaurus_tpu.config import retry_policy as ref_retry_policy
    from ytsaurus_tpu_torch.config import retry_policy
    policy, ref = retry_policy("rpc"), ref_retry_policy("rpc")
    for name in ("attempts", "backoff", "backoff_cap", "jitter",
                 "retry_budget", "retry_budget_refill"):
        assert getattr(policy, name) == getattr(ref, name), name
    for attempt in range(5):
        assert policy.delay(attempt, random.Random(attempt)) == \
            ref.delay(attempt, random.Random(attempt))
    channel = rpc.RetryingChannel(rpc.Channel("127.0.0.1:1"), attempts=2,
                                  backoff=0.5)
    assert (channel.attempts, channel._policy.backoff,
            channel.retry_budget) == (2, 0.5, None)
