"""Kafka proxy: the Kafka wire protocol over ordered tables.

Ref: yt/yt/server/kafka_proxy/server.h (+ the kafka protocol codec under
yt/yt/client/kafka/) — the reference terminates the Kafka binary
protocol in front of queues so stock Kafka clients can produce/consume
YT queues.  The proxy speaks v0 for every API (the baseline all client
libraries support) and negotiates up to v1 for Produce/Fetch via
ApiVersions (v1 adds throttle_time_ms framing to those responses):

  ApiVersions(18)  Metadata(3)  ListOffsets(2)  Produce(0..1)
  Fetch(0..1)  OffsetCommit(8)  OffsetFetch(9)
  FindCoordinator(10)  JoinGroup(11)  Heartbeat(12)  LeaveGroup(13)
  SyncGroup(14)

Topic model: topic `name` maps to the ordered table `<root>/name`
(auto-created on first Metadata when auto_create, like Kafka's
auto.create.topics).  One partition (0) per topic — the ordered-table
model; partitioned topics become N tables, as the reference maps tablet
ranges.  Messages are (key, value) byte strings riding an ordered table
with string columns `key` and `value`; Kafka offsets ARE $row_index, so
monotone/gapless offset semantics fall straight out of the queue model.
Consumer groups map to consumer tables under `<root>/.consumers/<group>`
through the queue-agent registration machinery.

Own copy of the JAX package's `server/kafka_proxy.py`, in front of the
port's client: the same request bytes get the same response bytes. The
topics' ordered tablets live on the client's device. One repair: a
group's first OffsetCommits from two connections at once register its
consumer under a lock (in the reference both create the consumer table
and one commit answers UNKNOWN_TOPIC).
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import zlib
from typing import Optional

from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.schema import TableSchema
from ytsaurus_tpu_torch.server.kafka_groups import GroupCoordinator
from ytsaurus_tpu_torch.utils.logging import get_logger

logger = get_logger("kafka_proxy")

TOPIC_SCHEMA = TableSchema.make([("key", "string"), ("value", "string")])

API_PRODUCE = 0
API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_OFFSET_COMMIT = 8
API_OFFSET_FETCH = 9
API_FIND_COORDINATOR = 10
API_JOIN_GROUP = 11
API_HEARTBEAT = 12
API_LEAVE_GROUP = 13
API_SYNC_GROUP = 14
API_VERSIONS = 18

# api key → highest supported version.  v1 adds throttle_time_ms to
# Produce/Fetch responses (request bodies are unchanged), which is what
# ApiVersions-aware clients negotiate down to; everything else is v0.
SUPPORTED_VERSIONS = {
    API_PRODUCE: 1, API_FETCH: 1, API_LIST_OFFSETS: 0, API_METADATA: 0,
    API_OFFSET_COMMIT: 0, API_OFFSET_FETCH: 0, API_FIND_COORDINATOR: 0,
    API_JOIN_GROUP: 0, API_HEARTBEAT: 0, API_LEAVE_GROUP: 0,
    API_SYNC_GROUP: 0, API_VERSIONS: 0,
}
SUPPORTED_APIS = tuple(SUPPORTED_VERSIONS)

ERR_NONE = 0
ERR_CORRUPT_MESSAGE = 2
ERR_UNKNOWN_TOPIC = 3
ERR_UNSUPPORTED_VERSION = 35


# -- wire primitives (big-endian, per the public Kafka protocol spec) --------

class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def i8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        if n < 0:
            return None
        return self._take(n).decode("utf-8")

    def bytes_(self) -> Optional[bytes]:
        n = self.i32()
        if n < 0:
            return None
        return self._take(n)


def i8(v: int) -> bytes:
    return struct.pack(">b", v)


def i16(v: int) -> bytes:
    return struct.pack(">h", v)


def i32(v: int) -> bytes:
    return struct.pack(">i", v)


def i64(v: int) -> bytes:
    return struct.pack(">q", v)


def string(v: "Optional[str]") -> bytes:
    if v is None:
        return i16(-1)
    raw = v.encode("utf-8")
    return i16(len(raw)) + raw


def bytes_(v: "Optional[bytes]") -> bytes:
    if v is None:
        return i32(-1)
    return i32(len(v)) + v


def array(items: list) -> bytes:
    return i32(len(items)) + b"".join(items)


def encode_message(key: "Optional[bytes]", value: "Optional[bytes]",
                   offset: int) -> bytes:
    """One MessageSet entry (message format v0): offset + size + message,
    where message = crc32(magic..value) | magic | attrs | key | value."""
    body = i8(0) + i8(0) + bytes_(key) + bytes_(value)
    crc = struct.unpack(">i", struct.pack(">I",
                                          zlib.crc32(body) & 0xFFFFFFFF))[0]
    return i64(offset) + i32(len(body) + 4) + i32(crc) + body


def decode_message_set(data: bytes) -> "list[tuple[Optional[bytes], Optional[bytes]]]":
    """(key, value) pairs out of a v0 MessageSet blob (offsets assigned
    by the broker are ignored on the produce path)."""
    out = []
    r = Reader(data)
    while r.pos + 12 <= len(r.data):
        r.i64()                     # producer-side offset: ignored
        size = r.i32()
        if r.pos + size > len(r.data):
            break                   # partial trailing message: drop
        msg = Reader(r._take(size))
        msg.i32()                   # crc (trusted transport here)
        msg.i8()                    # magic
        attributes = msg.i8()
        if attributes & 0x07:
            # Compressed wrapper message: storing the compressed blob
            # verbatim would hand consumers garbage re-framed as
            # uncompressed.  Refuse loudly (clients fall back to
            # compression.type=none).
            raise YtError("compressed message sets are not supported",
                          code=ERR_CORRUPT_MESSAGE)
        key = msg.bytes_()
        value = msg.bytes_()
        out.append((key, value))
    return out


# -- the proxy ---------------------------------------------------------------

class KafkaProxy:
    """One TCP listener speaking Kafka v0 in front of a YtClient."""

    def __init__(self, client, topic_root: str = "//kafka",
                 host: str = "127.0.0.1", port: int = 0,
                 auto_create: bool = True, fetch_max_rows: int = 1000):
        self.client = client
        self.topic_root = topic_root.rstrip("/")
        self.auto_create = auto_create
        self.fetch_max_rows = fetch_max_rows
        proxy = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        header = _recv_exact(self.request, 4)
                        if header is None:
                            return
                        (length,) = struct.unpack(">i", header)
                        payload = _recv_exact(self.request, length)
                        if payload is None:
                            return
                        try:
                            response = proxy.handle_request(payload)
                        except Exception as exc:  # noqa: BLE001
                            # Unparseable request or internal failure:
                            # close the connection (broker behavior for
                            # protocol violations) rather than kill the
                            # server thread or desync framing.
                            logger.warning("kafka request failed: %s",
                                           exc)
                            return
                        if response is None:
                            continue            # acks=0: no response
                        self.request.sendall(
                            struct.pack(">i", len(response)) + response)
                except (ConnectionError, OSError):
                    return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread: "threading.Thread | None" = None
        # Consumer-group membership (ref group_coordinator.h): this
        # proxy IS every group's coordinator (single-proxy model).
        self.groups = GroupCoordinator()
        # Serializes a group's consumer registration: two connections
        # committing a group's first offsets at once would both create
        # its consumer table, and the second's commit would fail.
        self._register_lock = threading.Lock()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "KafkaProxy":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="kafka-proxy")
        self._thread.start()
        logger.info("kafka proxy serving on %s (topics under %s)",
                    self.address, self.topic_root)
        return self

    def stop(self) -> None:
        self.groups.stop()
        self._server.shutdown()
        self._server.server_close()

    # -- topic plumbing --------------------------------------------------------

    def _topic_path(self, topic: str) -> str:
        if "/" in topic or topic.startswith("."):
            raise YtError(f"Bad topic name {topic!r}")
        return f"{self.topic_root}/{topic}"

    def _topic_exists(self, topic: str) -> bool:
        try:
            return self.client.exists(self._topic_path(topic))
        except YtError:
            return False

    def _ensure_topic(self, topic: str) -> bool:
        if self._topic_exists(topic):
            self._tablet(topic)     # mount on demand (restarted primary)
            return True
        if not self.auto_create:
            return False
        path = self._topic_path(topic)
        try:
            self.client.create("table", path, recursive=True,
                               attributes={"schema": TOPIC_SCHEMA,
                                           "dynamic": True})
        except YtError:
            # Concurrent auto-create from another connection: fine as
            # long as the table exists (mount below is idempure enough).
            if not self._topic_exists(topic):
                return False
        try:
            self.client.mount_table(path)
        except YtError:
            pass                    # already mounted by the racer
        return True

    def _tablet(self, topic: str):
        """The topic's ordered tablet, mounting on demand (a restarted
        primary serves existing topics without an explicit mount)."""
        path = self._topic_path(topic)
        try:
            (tablet,) = self.client._mounted_tablets(path)
        except YtError:
            self.client.mount_table(path)
            (tablet,) = self.client._mounted_tablets(path)
        return tablet

    def _consumer_path(self, group: str) -> str:
        return f"{self.topic_root}/.consumers/{group}"

    # -- request dispatch ------------------------------------------------------

    def handle_request(self, payload: bytes) -> "Optional[bytes]":
        """Returns the response frame body, or None when the protocol
        says no response is sent (acks=0 produce, fatal version
        mismatch handled by closing)."""
        r = Reader(payload)
        api_key = r.i16()
        api_version = r.i16()
        correlation_id = r.i32()
        r.string()                  # client_id
        max_version = SUPPORTED_VERSIONS.get(api_key)
        if max_version is None:
            # Unknown API key: the right diagnosis is the KEY, and the
            # connection closes (no version of it has a known shape).
            raise YtError(f"unsupported api key {api_key}",
                          code=ERR_UNSUPPORTED_VERSION)
        if not 0 <= api_version <= max_version:
            if api_key == API_VERSIONS:
                # Spec: answer UNSUPPORTED_VERSION in the v0 shape so
                # the client can retry with a version we speak.
                return i32(correlation_id) + i16(
                    ERR_UNSUPPORTED_VERSION) + array(
                    [i16(k) + i16(0) + i16(SUPPORTED_VERSIONS[k])
                     for k in SUPPORTED_APIS])
            # Body shapes differ beyond the advertised version: raising
            # makes the connection handler CLOSE the socket (a None
            # return would mean "no response due" and leave the client
            # hanging on an open connection).
            raise YtError(f"unsupported api version {api_version} for "
                          f"key {api_key}",
                          code=ERR_UNSUPPORTED_VERSION)
        handler = {
            API_VERSIONS: self._api_versions,
            API_METADATA: self._metadata,
            API_PRODUCE: lambda rr: self._produce(rr, api_version),
            API_FETCH: lambda rr: self._fetch(rr, api_version),
            API_LIST_OFFSETS: self._list_offsets,
            API_OFFSET_COMMIT: self._offset_commit,
            API_OFFSET_FETCH: self._offset_fetch,
            API_FIND_COORDINATOR: self._find_coordinator,
            API_JOIN_GROUP: self._join_group,
            API_HEARTBEAT: self._heartbeat,
            API_LEAVE_GROUP: self._leave_group,
            API_SYNC_GROUP: self._sync_group,
        }.get(api_key)
        body = handler(r)
        if body is None:
            return None             # acks=0 produce
        return i32(correlation_id) + body

    def _api_versions(self, r: Reader) -> bytes:
        return i16(ERR_NONE) + array(
            [i16(k) + i16(0) + i16(SUPPORTED_VERSIONS[k])
             for k in SUPPORTED_APIS])

    def _metadata(self, r: Reader) -> bytes:
        n = r.i32()
        topics = [r.string() for _ in range(max(n, 0))]
        if not topics:
            # All known topics: children of the topic root.
            try:
                topics = [t for t in self.client.list(self.topic_root)
                          if not t.startswith(".")]
            except YtError:
                topics = []
        brokers = array([i32(0) + string(self.host) + i32(self.port)])
        topic_bodies = []
        for topic in topics:
            ok = self._ensure_topic(topic)
            partitions = array([
                i16(ERR_NONE) + i32(0) + i32(0) +
                array([i32(0)]) + array([i32(0)])]) if ok else array([])
            topic_bodies.append(
                i16(ERR_NONE if ok else ERR_UNKNOWN_TOPIC) +
                string(topic) + partitions)
        return brokers + array(topic_bodies)

    def _produce(self, r: Reader,
                 version: int = 0) -> "Optional[bytes]":
        acks = r.i16()
        r.i32()                     # timeout
        n_topics = r.i32()
        topic_bodies = []
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            part_bodies = []
            for _ in range(n_parts):
                partition = r.i32()
                message_set = r.bytes_() or b""
                try:
                    records = decode_message_set(message_set)
                except YtError:
                    part_bodies.append(
                        i32(partition) + i16(ERR_CORRUPT_MESSAGE) +
                        i64(-1))
                    continue
                if not self._ensure_topic(topic):
                    part_bodies.append(
                        i32(partition) + i16(ERR_UNKNOWN_TOPIC) + i64(-1))
                    continue
                rows = [{"key": k, "value": v} for k, v in records]
                base = self.client.push_queue(
                    self._topic_path(topic), rows) if rows else -1
                part_bodies.append(
                    i32(partition) + i16(ERR_NONE) + i64(base))
            topic_bodies.append(string(topic) + array(part_bodies))
        if acks == 0:
            # The client will not read a response; sending one would
            # desync its next request's framing.
            return None
        out = array(topic_bodies)
        if version >= 1:
            out += i32(0)               # throttle_time_ms (v1 tail)
        return out

    def _fetch(self, r: Reader, version: int = 0) -> bytes:
        import time as _time
        r.i32()                     # replica_id
        max_wait_ms = r.i32()
        min_bytes = r.i32()
        n_topics = r.i32()
        requests = []
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            parts = []
            for _ in range(n_parts):
                parts.append((r.i32(), r.i64(), r.i32()))
            requests.append((topic, parts))
        # Kafka long-poll: block up to max_wait_ms until data exists
        # past the requested offsets (capped — a poller must not pin a
        # handler thread forever).  The wait polls only row counts; the
        # full response is built ONCE on wake/timeout.  Error responses
        # (unknown topic) and min_bytes<=0 return immediately, like a
        # real broker.
        deadline = _time.monotonic() + min(max(max_wait_ms, 0), 30_000) \
            / 1000.0
        if min_bytes > 0:
            while _time.monotonic() < deadline:
                ready = False
                for topic, parts in requests:
                    if not self._topic_exists(topic):
                        ready = True            # error body: answer now
                        break
                    high = self._tablet(topic).row_count
                    if any(offset < high for _, offset, _ in parts):
                        ready = True
                        break
                if ready:
                    break
                _time.sleep(min(0.05,
                                max(deadline - _time.monotonic(), 0)))
        topic_bodies, _ = self._build_fetch(requests)
        prefix = i32(0) if version >= 1 else b""    # throttle_time_ms
        return prefix + array(topic_bodies)

    def _build_fetch(self, requests) -> "tuple[list[bytes], int]":
        topic_bodies = []
        data_bytes = 0
        for topic, parts in requests:
            part_bodies = []
            for partition, fetch_offset, max_bytes in parts:
                if not self._topic_exists(topic):
                    part_bodies.append(
                        i32(partition) + i16(ERR_UNKNOWN_TOPIC) + i64(-1) +
                        bytes_(b""))
                    continue
                path = self._topic_path(topic)
                tablet = self._tablet(topic)
                high = tablet.row_count
                rows = self.client.pull_queue(
                    path, offset=fetch_offset,
                    limit=self.fetch_max_rows) if fetch_offset < high else []
                out = bytearray()
                for idx, row in enumerate(rows):
                    msg = encode_message(row.get("key"), row.get("value"),
                                         fetch_offset + idx)
                    if len(out) + len(msg) > max_bytes and out:
                        break
                    out.extend(msg)
                data_bytes += len(out)
                part_bodies.append(
                    i32(partition) + i16(ERR_NONE) + i64(high) +
                    bytes_(bytes(out)))
            topic_bodies.append(string(topic) + array(part_bodies))
        return topic_bodies, data_bytes

    def _list_offsets(self, r: Reader) -> bytes:
        r.i32()                     # replica_id
        n_topics = r.i32()
        topic_bodies = []
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            part_bodies = []
            for _ in range(n_parts):
                partition = r.i32()
                timestamp = r.i64()
                r.i32()             # max_num_offsets
                if not self._topic_exists(topic):
                    part_bodies.append(
                        i32(partition) + i16(ERR_UNKNOWN_TOPIC) + array([]))
                    continue
                tablet = self._tablet(topic)
                if timestamp == -2:             # earliest
                    offset = getattr(tablet, "trimmed_count", 0)
                else:                           # latest
                    offset = tablet.row_count
                part_bodies.append(
                    i32(partition) + i16(ERR_NONE) + array([i64(offset)]))
            topic_bodies.append(string(topic) + array(part_bodies))
        return array(topic_bodies)

    def _offset_commit(self, r: Reader) -> bytes:
        group = r.string()
        n_topics = r.i32()
        topic_bodies = []
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            part_bodies = []
            for _ in range(n_parts):
                partition = r.i32()
                offset = r.i64()
                r.string()          # metadata
                err = ERR_NONE
                try:
                    path = self._topic_path(topic)
                    consumer = self._consumer_path(group)
                    with self._register_lock:
                        if not self.client.exists(consumer):
                            self.client.register_queue_consumer(
                                path, consumer, vital=False)
                        regs = self.client._table_node(
                            path).attributes.get("registrations") or {}
                        if consumer not in regs:
                            self.client.register_queue_consumer(
                                path, consumer, vital=False)
                    self.client.advance_consumer(consumer, path, offset)
                except YtError as exc:
                    logger.warning("offset commit failed: %s", exc)
                    err = ERR_UNKNOWN_TOPIC
                part_bodies.append(i32(partition) + i16(err))
            topic_bodies.append(string(topic) + array(part_bodies))
        return array(topic_bodies)

    # -- consumer groups (v0 shapes; ref group_coordinator.h) ------------------

    def _find_coordinator(self, r: Reader) -> bytes:
        r.string()                  # group_id: this proxy coordinates all
        return i16(ERR_NONE) + i32(0) + string(self.host) + i32(self.port)

    def _join_group(self, r: Reader) -> bytes:
        group_id = r.string() or ""
        session_timeout = r.i32()
        member_id = r.string() or ""
        protocol_type = r.string() or ""
        n = r.i32()
        protocols = []
        for _ in range(max(n, 0)):
            name = r.string() or ""
            protocols.append((name, r.bytes_() or b""))
        result = self.groups.join_group(group_id, session_timeout,
                                        member_id, protocol_type,
                                        protocols)
        if result.get("error"):
            return i16(result["error"]) + i32(-1) + string("") + \
                string("") + string(member_id) + array([])
        members = array([string(mid) + bytes_(meta)
                         for mid, meta in result["members"]])
        return i16(ERR_NONE) + i32(result["generation"]) + \
            string(result["protocol"]) + string(result["leader_id"]) + \
            string(result["member_id"]) + members

    def _sync_group(self, r: Reader) -> bytes:
        group_id = r.string() or ""
        generation = r.i32()
        member_id = r.string() or ""
        n = r.i32()
        assignments = []
        for _ in range(max(n, 0)):
            mid = r.string() or ""
            assignments.append((mid, r.bytes_() or b""))
        err, assignment = self.groups.sync_group(
            group_id, generation, member_id, assignments)
        return i16(err) + bytes_(assignment)

    def _heartbeat(self, r: Reader) -> bytes:
        group_id = r.string() or ""
        generation = r.i32()
        member_id = r.string() or ""
        return i16(self.groups.heartbeat(group_id, generation, member_id))

    def _leave_group(self, r: Reader) -> bytes:
        group_id = r.string() or ""
        member_id = r.string() or ""
        return i16(self.groups.leave_group(group_id, member_id))

    def _offset_fetch(self, r: Reader) -> bytes:
        group = r.string()
        n_topics = r.i32()
        topic_bodies = []
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            part_bodies = []
            for _ in range(n_parts):
                partition = r.i32()
                offset = -1
                try:
                    from ytsaurus_tpu_torch.server.queue_agent import (
                        _consumer_offset,
                    )
                    consumer = self._consumer_path(group)
                    if self.client.exists(consumer):
                        offset = _consumer_offset(
                            self.client, consumer, self._topic_path(topic))
                except YtError:
                    offset = -1
                part_bodies.append(
                    i32(partition) + i64(offset) + string("") +
                    i16(ERR_NONE))
            topic_bodies.append(string(topic) + array(part_bodies))
        return array(topic_bodies)


def _recv_exact(sock: socket.socket, n: int) -> "Optional[bytes]":
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf
