"""The port's Kafka proxy and group coordinator (ytsaurus_tpu_torch/
server/kafka_proxy.py, kafka_groups.py) against the JAX package's.

- The reference's own tests (tests/test_kafka_proxy.py) run on the port
  through `port_twin`, all sixteen, with the port's client on the CPU;
  `test_kafka_proxy_in_cluster_daemon` starts a port `LocalCluster` whose
  primary serves `--kafka` (one edit: the reference pins jax to the CPU
  there, the port's cluster takes device="cpu" from the shim).
- Byte parity: the same request bytes to a reference proxy and a port
  proxy, each over its own package's client, get the same response bytes
  once the broker address and the group member ids are normalized.
"""

import re
import socket
import struct

import pytest

from tests.test_torch_client import call_twin, port_twin, twin_cases
from ytsaurus_tpu import client as ref_client
from ytsaurus_tpu.server import kafka_proxy as ref_kafka
from ytsaurus_tpu_torch import client as port_client
from ytsaurus_tpu_torch.server import kafka_proxy as kafka
from ytsaurus_tpu_torch.server.kafka_proxy import (
    API_FETCH,
    API_FIND_COORDINATOR,
    API_HEARTBEAT,
    API_JOIN_GROUP,
    API_LEAVE_GROUP,
    API_LIST_OFFSETS,
    API_METADATA,
    API_OFFSET_COMMIT,
    API_OFFSET_FETCH,
    API_PRODUCE,
    API_SYNC_GROUP,
    API_VERSIONS,
    array,
    bytes_,
    encode_message,
    i8,
    i16,
    i32,
    i64,
    string,
)

_TWIN = port_twin("test_kafka_proxy", edits={
    """    import jax
    jax.config.update("jax_platforms", "cpu")
""": ""})
_CASES = twin_cases(_TWIN)


def test_the_twin_holds_every_case():
    assert len(_CASES) == 16


@pytest.mark.parametrize("name", _CASES)
def test_reference_kafka_case_on_the_port(name, tmp_path):
    if name == "test_kafka_proxy_in_cluster_daemon":
        call_twin(_TWIN, name, {"tmp_path": tmp_path})
        return
    client = _TWIN.connect(str(tmp_path / "c"))
    proxy = _TWIN.KafkaProxy(client, topic_root="//kafka").start()
    try:
        call_twin(_TWIN, name, {"proxy": proxy, "tmp_path": tmp_path})
    finally:
        proxy.stop()


# --- byte parity -------------------------------------------------------------


def _exchange(proxy, api_key: int, body: bytes, version: int = 0,
              correlation: int = 91) -> bytes:
    """One framed request over a fresh socket: the whole response frame
    body (b"" when the connection closes without one)."""
    payload = i16(api_key) + i16(version) + i32(correlation) + \
        string("parity") + body
    with socket.create_connection((proxy.host, proxy.port),
                                  timeout=30) as sock:
        sock.sendall(struct.pack(">i", len(payload)) + payload)
        header = b""
        while len(header) < 4:
            chunk = sock.recv(4 - len(header))
            if not chunk:
                return b""
            header += chunk
        (length,) = struct.unpack(">i", header)
        data = b""
        while len(data) < length:
            chunk = sock.recv(length - len(data))
            assert chunk, "connection closed mid-response"
            data += chunk
    return data


_MEMBER = re.compile(rb"(grp[a-z]*)-[0-9a-f]{12}")


def _normalize(proxy, data: bytes) -> bytes:
    data = data.replace(string(proxy.host) + i32(proxy.port),
                        string("broker") + i32(0))
    return _MEMBER.sub(rb"\1-xxxxxxxxxxxx", data)


def _compressed_set() -> bytes:
    body = i8(0) + i8(1) + bytes_(b"k") + bytes_(b"gzipped?")
    return i64(0) + i32(len(body) + 4) + i32(0) + body


def _script(proxy) -> list:
    """The request sequence, the member id of each group read back from
    the proxy's own JoinGroup answer."""
    msgs = b"".join(encode_message(k, v, 0) for k, v in [
        (b"k1", b"alpha"), (None, b"beta"),
        ("ключ".encode(), "значение".encode())])
    msgs1 = b"".join(encode_message(k, v, 0) for k, v in [
        (b"k4", b"delta" * 7), (b"", None)])
    out = []

    def ask(label, api, body, version=0):
        raw = _exchange(proxy, api, body, version)
        out.append((label, _normalize(proxy, raw)))
        return raw

    ask("versions", API_VERSIONS, b"")
    ask("versions_v9", API_VERSIONS, b"", version=9)
    ask("metadata", API_METADATA, array([string("events")]))
    ask("metadata_all", API_METADATA, i32(-1))
    ask("produce_v0", API_PRODUCE, i16(1) + i32(30000) + array([
        string("events") + array([i32(0) + bytes_(msgs)])]))
    ask("produce_v1", API_PRODUCE, i16(-1) + i32(30000) + array([
        string("events") + array([i32(0) + bytes_(msgs1)])]), version=1)
    ask("produce_compressed", API_PRODUCE, i16(1) + i32(30000) + array([
        string("events") + array([i32(0) + bytes_(_compressed_set())])]))
    ask("produce_new_topic", API_PRODUCE, i16(1) + i32(30000) + array([
        string("audit") + array([i32(0) + bytes_(msgs1)])]))
    for label, offset, max_bytes, version in (
            ("fetch_all", 0, 1 << 20, 0), ("fetch_tail", 2, 1 << 20, 1),
            ("fetch_small", 0, 40, 0), ("fetch_past_end", 5, 1 << 20, 1)):
        ask(label, API_FETCH, i32(-1) + i32(0) + i32(0) + array([
            string("events") + array([i32(0) + i64(offset) +
                                      i32(max_bytes)])]), version=version)
    ask("fetch_unknown", API_FETCH, i32(-1) + i32(100) + i32(1) + array([
        string("nowhere") + array([i32(0) + i64(0) + i32(1024)])]))
    ask("list_offsets", API_LIST_OFFSETS, i32(-1) + array([
        string("events") + array([i32(0) + i64(-2) + i32(1),
                                  i32(0) + i64(-1) + i32(1)]),
        string("nowhere") + array([i32(0) + i64(-1) + i32(1)])]))
    ask("offset_commit", API_OFFSET_COMMIT, string("grp") + array([
        string("events") + array([i32(0) + i64(3) + string("meta")])]))
    ask("offset_fetch", API_OFFSET_FETCH, string("grp") + array([
        string("events") + array([i32(0)]),
        string("audit") + array([i32(0)])]))
    ask("find_coordinator", API_FIND_COORDINATOR, string("grpjoin"))
    raw = ask("join", API_JOIN_GROUP, string("grpjoin") + i32(30000) +
              string("") + string("consumer") + array([
                  string("range") + bytes_(b"topics:events"),
                  string("roundrobin") + bytes_(b"rr")]))
    r = kafka.Reader(raw)
    r.i32()
    assert r.i16() == 0
    generation = r.i32()
    r.string()
    r.string()
    member = r.string()
    ask("sync", API_SYNC_GROUP, string("grpjoin") + i32(generation) +
        string(member) + array([string(member) + bytes_(b"events:0")]))
    ask("heartbeat", API_HEARTBEAT, string("grpjoin") + i32(generation) +
        string(member))
    ask("heartbeat_stale", API_HEARTBEAT, string("grpjoin") +
        i32(generation + 3) + string(member))
    ask("heartbeat_ghost", API_HEARTBEAT, string("grpjoin") +
        i32(generation) + string("ghost"))
    ask("leave", API_LEAVE_GROUP, string("grpjoin") + string(member))
    ask("leave_again", API_LEAVE_GROUP, string("grpjoin") + string(member))
    ask("join_unknown_member", API_JOIN_GROUP, string("grpjoin") +
        i32(30000) + string("grpjoin-000000000000") + string("consumer") +
        array([string("range") + bytes_(b"")]))
    ask("unsupported_version", API_FETCH, b"", version=7)
    return out


def test_the_same_requests_get_the_same_response_bytes(tmp_path):
    ref = ref_kafka.KafkaProxy(ref_client.connect(str(tmp_path / "ref")),
                               topic_root="//kafka").start()
    port = kafka.KafkaProxy(port_client.connect(str(tmp_path / "port"),
                                                device="cpu"),
                            topic_root="//kafka").start()
    try:
        want = _script(ref)
        got = _script(port)
    finally:
        ref.stop()
        port.stop()
    assert [label for label, _ in got] == [label for label, _ in want]
    for (label, g), (_, w) in zip(got, want):
        assert g == w, label
    # The script reached every verb, with data in the fetches.
    fetched = dict(got)["fetch_all"]
    assert "значение".encode() in fetched and b"alpha" in fetched
    assert dict(got)["unsupported_version"] == b""


@pytest.mark.parametrize("value", [b"", b"x" * 300, None])
def test_the_codec_encodes_alike(value):
    for key in (None, b"", b"key"):
        for offset in (0, 7, 1 << 40):
            got = encode_message(key, value, offset)
            assert got == ref_kafka.encode_message(key, value, offset)
            assert kafka.decode_message_set(got) == \
                ref_kafka.decode_message_set(got) == [(key, value)]


def test_a_groups_first_commits_at_once_all_succeed(tmp_path):
    """Four connections commit one group's first offsets at once, one
    topic each: every commit answers NONE and every offset reads back
    (the reference's proxy answers UNKNOWN_TOPIC to all but the commit
    that created the group's consumer table; ROADMAP queue 3)."""
    import threading

    proxy = kafka.KafkaProxy(port_client.connect(str(tmp_path),
                                                 device="cpu")).start()
    topics = [f"t{i}" for i in range(4)]
    try:
        for topic in topics:
            _exchange(proxy, API_PRODUCE, i16(1) + i32(30000) + array([
                string(topic) + array([i32(0) + bytes_(encode_message(
                    b"k", b"v" * 9, 0) * 5)])]))
        answers = {}
        start = threading.Barrier(len(topics))

        def commit(i, topic):
            start.wait()
            answers[topic] = _exchange(proxy, API_OFFSET_COMMIT, string(
                "grp") + array([string(topic) + array([
                    i32(0) + i64(i + 1) + string("")])]))

        threads = [threading.Thread(target=commit, args=(i, t))
                   for i, t in enumerate(topics)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert {t: a[-2:] for t, a in answers.items()} == \
            {t: i16(0) for t in topics}
        fetched = _exchange(proxy, API_OFFSET_FETCH, string("grp") + array(
            [string(t) + array([i32(0)]) for t in topics]))
        r = kafka.Reader(fetched)
        r.i32()
        offsets = []
        for _ in range(r.i32()):
            r.string()
            r.i32()
            r.i32()
            offsets.append(r.i64())
            r.string()
            assert r.i16() == 0
        assert offsets == [1, 2, 3, 4]
    finally:
        proxy.stop()
