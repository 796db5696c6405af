"""Query tracker: persistent queries with async execution.

Ref mapping (server/query_tracker):
  start_query / get_query / list_queries /   → same verbs on QueryTracker
  abort_query / read_query_result              (and driver commands)
  query state machine (pending → running →   → "state" on the query record
  completed | failed | aborted)
  queries stored in dynamic tables           → query records are cypress
  (//sys/query_tracker)                        documents under //sys/queries
  engine field (ql/yql/chyt/spyt)            → "ql" (native) + any engine
                                               registered via
                                               register_engine (the CHYT/
                                               YQL plug point)

Design delta: execution runs on a worker thread against the in-process
cluster; results persist on the query record (row sets are bounded by
result_row_limit with a truncated flag, matching the reference's result
row caps).

Own copy of the JAX package's `server/query_tracker.py`: the engines run
through the client, so their selects run on the cluster's device.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, Optional

from ytsaurus_tpu_torch.cypress.security import (
    ROOT_USER,
    SUPERUSERS,
    authenticated_user,
    current_user,
)
from ytsaurus_tpu_torch.errors import EErrorCode, YtError

QUERIES_ROOT = "//sys/queries"

# engine name → fn(client, query_text) -> list[dict]
_ENGINES: dict[str, Callable] = {}


def register_engine(name: str, execute: Callable) -> None:
    """Plug in a query engine (the CHYT/YQL ecosystem hook)."""
    _ENGINES[name] = execute


def _ql_engine(client, query: str) -> list[dict]:
    return client.select_rows(query)


register_engine("ql", _ql_engine)


class QueryTracker:
    def __init__(self, client, result_row_limit: int = 10_000):
        self.client = client
        self.result_row_limit = result_row_limit
        self._threads: dict[str, threading.Thread] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ verbs

    def start_query(self, query: str, engine: str = "ql",
                    annotations: Optional[dict] = None,
                    sync: bool = False) -> str:
        if engine not in _ENGINES:
            # Ecosystem engines register on import; load them on first
            # use so `engine="chyt"` works without explicit wiring.
            import ytsaurus_tpu_torch.ecosystem.sql  # noqa: F401
        if engine not in _ENGINES:
            raise YtError(f"Unknown query engine {engine!r}; "
                          f"available: {sorted(_ENGINES)}",
                          code=EErrorCode.QueryUnsupported)
        query_id = uuid.uuid4().hex[:16]
        user = current_user()
        path = f"{QUERIES_ROOT}/{query_id}"
        # Records are SYSTEM state (//sys/queries is tracker-owned); only
        # the query itself executes under the caller's principal.
        with authenticated_user(ROOT_USER):
            self.client.create("document", path, recursive=True)
            self.client.set(path, {
                "id": query_id, "engine": engine, "query": query,
                "state": "pending", "annotations": annotations or {},
                "user": user,
                "start_time": time.time(), "finish_time": None,
                "error": None, "result": None, "truncated": False,
            })
        if sync:
            self._execute(query_id)
        else:
            thread = threading.Thread(
                target=self._execute, args=(query_id,), daemon=True)
            with self._lock:
                self._threads[query_id] = thread
            thread.start()
        return query_id

    def _check_access(self, record: dict) -> None:
        """Query records are private to their user (superusers see all) —
        results are served from the record, so the ACL enforced at
        execution time must also gate record reads."""
        user = current_user()
        if record.get("user") in (None, user) or user == ROOT_USER:
            return
        try:
            groups = self.client.cluster.security.groups_of(user)
        except YtError:
            groups = set()
        if SUPERUSERS not in groups:
            raise YtError(
                f"User {user!r} cannot access query {record['id']} "
                f"of user {record['user']!r}",
                code=EErrorCode.AuthorizationError)

    def get_query(self, query_id: str) -> dict:
        record = dict(self.client.get(self._path(query_id)))
        self._check_access(record)
        record.pop("result", None)      # results via read_query_result
        return record

    def list_queries(self, state: Optional[str] = None,
                     engine: Optional[str] = None) -> list[dict]:
        if not self.client.exists(QUERIES_ROOT):
            return []
        out = []
        for qid in self.client.list(QUERIES_ROOT):
            try:
                rec = self.get_query(qid)
            except YtError:
                continue                 # not this user's query
            if state is not None and rec["state"] != state:
                continue
            if engine is not None and rec["engine"] != engine:
                continue
            out.append(rec)
        return sorted(out, key=lambda r: r["start_time"])

    def read_query_result(self, query_id: str) -> list[dict]:
        record = self.client.get(self._path(query_id))
        self._check_access(record)
        if record["state"] != "completed":
            raise YtError(
                f"Query {query_id} is {record['state']}, not completed",
                code=EErrorCode.OperationFailed,
                attributes={"error": record.get("error")})
        return list(record["result"] or [])

    def abort_query(self, query_id: str) -> None:
        path = self._path(query_id)
        record = dict(self.client.get(path))
        self._check_access(record)
        if record["state"] in ("completed", "failed", "aborted"):
            raise YtError(f"Query {query_id} is already {record['state']}",
                          code=EErrorCode.OperationFailed)
        record["state"] = "aborted"
        record["finish_time"] = time.time()
        with authenticated_user(ROOT_USER):
            self.client.set(path, record)

    def wait(self, query_id: str, timeout: float = 60.0) -> dict:
        """Join the worker thread (test/ops helper), then return the record."""
        with self._lock:
            thread = self._threads.get(query_id)
        if thread is not None:
            thread.join(timeout)
        return self.get_query(query_id)

    # --------------------------------------------------------------- execution

    def _path(self, query_id: str) -> str:
        path = f"{QUERIES_ROOT}/{query_id}"
        if not self.client.exists(path):
            raise YtError(f"No such query {query_id!r}",
                          code=EErrorCode.ResolveError)
        return path

    def _execute(self, query_id: str) -> None:
        path = f"{QUERIES_ROOT}/{query_id}"
        with authenticated_user(ROOT_USER):
            record = dict(self.client.get(path))
            if record["state"] != "pending":    # aborted before it ran
                return
            record["state"] = "running"
            self.client.set(path, record)
        try:
            # The engine runs AS THE QUERY'S USER — worker threads reset
            # the contextvar to root, which must not leak into execution.
            with authenticated_user(record.get("user") or ROOT_USER):
                rows = _ENGINES[record["engine"]](
                    self.client, record["query"])
            truncated = len(rows) > self.result_row_limit
            record.update(
                state="completed", finish_time=time.time(),
                result=rows[:self.result_row_limit], truncated=truncated)
        except Exception as err:        # failures persist on the record
            record.update(state="failed", finish_time=time.time(),
                          error=str(err))
        with authenticated_user(ROOT_USER):
            current = dict(self.client.get(path))
            if current["state"] == "aborted":   # lost the race to abort
                return
            self.client.set(path, record)
