"""ExecNodeService: job slots hosted by data-node daemons.

Ref shape: exec_node slot manager + job controller
(yt/yt/server/node/exec_node/) and the per-job user process
(yt/yt/server/job_proxy/user_job.cpp).  The scheduler dispatches a
declarative JOB SPEC over RPC; the node materializes the input stripe
from chunks — LOCAL store first, peers by placement rank otherwise —
pipes formatted rows through the user command in its own process group,
and hands the stdout blob back to the controller on poll.

This moves the exec plane out of the primary: "distributed" means
distributed storage AND distributed compute.

Own copy of the JAX package's `server/exec_service.py`. A data node holds
bytes, not tensors, and opens no CUDA context: the stripe decodes with
`device="cpu"` stated, since its rows go to a subprocess's pipe.
"""

from __future__ import annotations

import subprocess
import threading
import time
import uuid
import weakref
from typing import Optional

from ytsaurus_tpu_torch.errors import EErrorCode, ThrottledError, YtError
from ytsaurus_tpu_torch.rpc import Service, rpc_method
from ytsaurus_tpu_torch.rpc.wire import wire_text as _text
from ytsaurus_tpu_torch.utils.logging import get_logger

logger = get_logger("exec_node")

STDERR_TAIL_BYTES = 16 << 10
# Jobs admitted but not yet holding a slot, per slot.  Past this the node
# answers RequestThrottled with a retry_after hint instead of queueing
# unboundedly — the scheduler's RetryingChannel honors the hint, and a
# persistent throttle surfaces as a dispatch failure the job quarantine
# can requeue elsewhere (serving-plane admission).
MAX_PENDING_PER_SLOT = 4
RESULT_TTL_SECONDS = 600.0
# Once the stdout blob has been handed to a poll, it is kept only this
# long (a lost poll RESPONSE can still be re-polled within the grace);
# the full TTL applies only to results nobody has fetched yet.  Must
# comfortably exceed the scheduler's poll RPC timeout + retry backoff
# (operations/jobs.py polls with a 30s channel timeout), or a timed-out
# delivery response could find the result swept on retry and double-run
# the job.
DELIVERED_GRACE_SECONDS = 120.0
SWEEP_INTERVAL_SECONDS = 60.0


def _sweep_loop(service_ref, stop: threading.Event) -> None:
    while not stop.wait(SWEEP_INTERVAL_SECONDS):
        service = service_ref()
        if service is None:
            return
        with service._lock:
            service._sweep_locked()
        del service


class ExecNodeService(Service):
    name = "exec_node"

    def __init__(self, store, slots: int = 4):
        self.store = store                    # local FsChunkStore
        self.slots = slots
        self._sem = threading.Semaphore(slots)
        self._jobs: dict[str, dict] = {}
        self._by_key: dict[str, str] = {}     # dedup: job_key -> job_id
        self._lock = threading.Lock()
        self._started_total = 0
        self._throttled_total = 0
        self._pending = 0          # admitted jobs not yet holding a slot
        # Timer-driven sweep: a burst of large-output jobs followed by
        # idle time must not pin the blobs until the next start_job.
        # The thread holds only a weakref (a dropped service instance
        # must not be pinned forever by its own sweeper) and exits on
        # close() or garbage collection.
        self._stop = threading.Event()
        self._sweeper = threading.Thread(
            target=_sweep_loop, args=(weakref.ref(self), self._stop),
            daemon=True, name="exec-job-sweeper")
        self._sweeper.start()

    def close(self) -> None:
        self._stop.set()

    # -- RPC surface -----------------------------------------------------------

    @rpc_method()
    def start_job(self, body, attachments):
        """spec: command, format, time_limit, env, and EITHER
        slices=[{chunk_id,start,end}] + peers=[addr...] (node-side
        materialization, local-first) OR an input blob attachment."""
        spec = {
            "command": _text(body["command"]),
            "format": _text(body.get("format") or "json"),
            "time_limit": body.get("time_limit"),
            "env": {_text(k): _text(v)
                    for k, v in (body.get("env") or {}).items()},
            "slices": [
                {"chunk_id": _text(s["chunk_id"]),
                 "start": int(s["start"]), "end": int(s["end"])}
                for s in (body.get("slices") or [])],
            "peers": [_text(p) for p in (body.get("peers") or [])],
            "job_id": _text(body.get("job_id") or ""),
            "op_id": _text(body.get("op_id") or ""),
            # Job environment enforcement (rlimits applied in the child;
            # operations/job_environment.py).
            "limits": {_text(k): int(v)
                       for k, v in (body.get("limits") or {}).items()}
            or None,
        }
        input_blob = attachments[0] if attachments else None
        job_key = _text(body.get("job_key") or "")
        job_id = uuid.uuid4().hex[:16]
        entry = {"state": "running", "stdout": None, "stderr": b"",
                 "error": None, "exit_code": None,
                 "proc": None, "aborted": False,
                 "created": time.monotonic()}
        with self._lock:
            self._sweep_locked()
            if job_key:
                # Transport-level retry of a delivered start_job: hand
                # back the ALREADY RUNNING job instead of a twin.
                existing = self._by_key.get(job_key)
                if existing is not None and existing in self._jobs:
                    return {"job_id": existing}
            if self._pending >= self.slots * MAX_PENDING_PER_SLOT:
                self._throttled_total += 1
                raise ThrottledError(
                    f"exec node job queue full ({self._pending} pending "
                    f"over {self.slots} slots)",
                    retry_after=round(min(max(
                        0.1 * self._pending / max(self.slots, 1), 0.05),
                        5.0), 3))
            if job_key:
                self._by_key[job_key] = job_id
            self._pending += 1
            self._jobs[job_id] = entry
            self._started_total += 1
        thread = threading.Thread(
            target=self._run, args=(job_id, entry, spec, input_blob),
            daemon=True, name=f"exec-job-{job_id}")
        thread.start()
        return {"job_id": job_id}

    @rpc_method()
    def poll_job(self, body, attachments):
        job_id = _text(body["job_id"])
        with self._lock:
            entry = self._jobs.get(job_id)
        if entry is None:
            raise YtError(f"No such job {job_id}",
                          code=EErrorCode.NoSuchOperation)
        out = {"state": entry["state"],
               "exit_code": entry["exit_code"],
               "stderr_tail": entry["stderr"].decode("utf-8", "replace")}
        if entry["error"] is not None:
            out["error"] = str(entry["error"])
        if entry["state"] == "completed":
            if entry.get("delivered") is None:
                entry["delivered"] = time.monotonic()
            return out, [entry["stdout"]]
        return out

    @rpc_method()
    def abort_job(self, body, attachments):
        job_id = _text(body["job_id"])
        with self._lock:
            entry = self._jobs.get(job_id)
        if entry is not None:
            entry["aborted"] = True
            self._kill(entry)
        return {}

    @rpc_method()
    def exec_stats(self, body, attachments):
        with self._lock:
            running = sum(1 for e in self._jobs.values()
                          if e["state"] == "running")
            return {"slots": self.slots, "running": running,
                    "pending": self._pending,
                    "started_total": self._started_total,
                    "throttled_total": self._throttled_total}

    # -- execution -------------------------------------------------------------

    def _sweep_locked(self) -> None:
        now = time.monotonic()
        for job_id in [j for j, e in self._jobs.items()
                       if e["state"] != "running"
                       and (now - e["created"] > RESULT_TTL_SECONDS
                            or (e.get("delivered") is not None and
                                now - e["delivered"] >
                                DELIVERED_GRACE_SECONDS))]:
            del self._jobs[job_id]
        self._by_key = {k: v for k, v in self._by_key.items()
                        if v in self._jobs}

    def _materialize(self, spec) -> bytes:
        """Stripe rows as a format blob: local chunks first, peers by
        placement rank for the rest (the local-first read the reference's
        exec nodes get from colocated data nodes)."""
        from ytsaurus_tpu_torch.chunks.columnar import concat_chunks
        from ytsaurus_tpu_torch.formats import dumps_rows
        from ytsaurus_tpu_torch.server.remote_store import RpcChunkStore

        remote = RpcChunkStore(lambda: spec["peers"])
        try:
            parts = []
            for item in spec["slices"]:
                chunk = None
                try:
                    if self.store.exists(item["chunk_id"]):
                        chunk = self.store.read_chunk(item["chunk_id"],
                                                      device="cpu")
                except Exception:   # noqa: BLE001 — fall back to peers
                    chunk = None
                if chunk is None:
                    chunk = remote.read_chunk(item["chunk_id"],
                                              device="cpu")
                if item["start"] != 0 or item["end"] != chunk.row_count:
                    chunk = chunk.slice_rows(item["start"], item["end"])
                parts.append(chunk)
            merged = concat_chunks(parts) if len(parts) > 1 else parts[0]
            return dumps_rows(merged.to_rows(), spec["format"])
        finally:
            remote.close()

    def _run(self, job_id: str, entry: dict, spec: dict,
             input_blob: Optional[bytes]) -> None:
        import os
        with self._sem:
            with self._lock:
                self._pending -= 1      # holding a slot now, not queued
            try:
                if entry["aborted"]:
                    raise YtError("job aborted before start",
                                  code=EErrorCode.Canceled)
                if input_blob is None:
                    input_blob = self._materialize(spec)
                from ytsaurus_tpu_torch.operations.job_environment import (
                    make_preexec,
                )
                proc = subprocess.Popen(
                    ["/bin/sh", "-c", spec["command"]],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, start_new_session=True,
                    preexec_fn=make_preexec(spec.get("limits")),
                    env={**os.environ, **spec["env"],
                         "YT_JOB_ID": spec["job_id"] or job_id,
                         "YT_OPERATION_ID": spec["op_id"]})
                entry["proc"] = proc
                if entry["aborted"]:
                    self._kill(entry)
                try:
                    stdout, stderr = proc.communicate(
                        input_blob, timeout=spec["time_limit"])
                except subprocess.TimeoutExpired:
                    self._kill(entry)
                    proc.communicate()
                    raise YtError("user job timed out",
                                  code=EErrorCode.Timeout)
                entry["stderr"] = stderr[-STDERR_TAIL_BYTES:]
                entry["exit_code"] = proc.returncode
                if entry["aborted"]:
                    raise YtError("job aborted", code=EErrorCode.Canceled)
                if proc.returncode != 0:
                    from ytsaurus_tpu_torch.operations.job_environment import (
                        classify_failure,
                    )
                    cause = classify_failure(
                        proc.returncode, entry["stderr"],
                        spec.get("limits"))
                    raise YtError(
                        f"user job exited {proc.returncode}",
                        code=EErrorCode.OperationFailed,
                        attributes={"probable_cause": cause}
                        if cause else {})
                entry["stdout"] = stdout
                entry["state"] = "completed"
            except YtError as err:
                entry["error"] = err
                entry["state"] = "aborted" if entry["aborted"] \
                    else "failed"
            except Exception as exc:    # noqa: BLE001 — job boundary
                entry["error"] = YtError(f"job crashed: {exc!r}")
                entry["state"] = "failed"
            finally:
                entry["proc"] = None

    @staticmethod
    def _kill(entry: dict) -> None:
        import os
        import signal
        proc = entry.get("proc")
        if proc is not None and proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (OSError, ProcessLookupError):
                try:
                    proc.kill()
                except OSError:
                    pass
