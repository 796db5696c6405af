"""Job execution plane: worker slots, user-job processes, speculation,
preemption.

Own copy of the JAX package's `operations/jobs.py` (ref exec_node slot
manager + job controller, job_proxy/user_job.cpp,
controllers/speculative_job_manager.h, the scheduler strategy's
preemption): `Job`; `JobManager`, whose slots are threads that run jobs
under fair share (operations/fair_share.py), split oversized pending
jobs, twin stragglers and preempt over-share pools; and
`run_command_job`, the user-job proxy: `/bin/sh -c <command>` in its own
session with formatted rows on stdin, the `YT_JOB_*` environment, the
stderr tail kept on the job, a timeout that kills the process group, and
the rlimits of operations/job_environment.py applied in the child. A
job's compute is a device program, host code or a child process, so
Python threads do not serialize the real work; each job names the
cluster's device itself and never relies on a thread's current CUDA
device.

`run_remote_command_job` dispatches a command job to an exec node
(`server/exec_service.py`) and polls it to completion.
Python-callable jobs cannot be killed, so they are neither preemptible
nor speculated; command jobs are both.
"""

from __future__ import annotations

import subprocess
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Optional

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.operations.fair_share import (
    PoolState,
    compute_fair_shares,
    find_preemptable,
    pick_pool,
)
from ytsaurus_tpu_torch.utils import failpoints
from ytsaurus_tpu_torch.utils.logging import get_logger
from ytsaurus_tpu_torch.utils.profiling import Profiler

STDERR_TAIL_BYTES = 16 << 10

logger = get_logger("Jobs")
_profiler = Profiler("/jobs")


def _job_error(site: str) -> YtError:
    return YtError(f"injected job fault at {site}",
                   code=EErrorCode.OperationFailed,
                   attributes={"failpoint": site})


# Execution-plane fault sites: start/finish bracket the user code (an
# injected error is a job failure, exercising the retry quarantine);
# worker_death in crash-once mode kills the slot THREAD mid-job — the
# manager must requeue the orphaned job and respawn the slot.
_FP_START = failpoints.register_site("jobs.start", error=_job_error)
_FP_FINISH = failpoints.register_site("jobs.finish", error=_job_error)
_FP_WORKER_DEATH = failpoints.register_site("jobs.worker_death",
                                            error=_job_error)


@dataclass
class Job:
    """One schedulable unit.  `run` does the work (already bound to its
    input stripe); command jobs also set `command` so the manager can
    kill/speculate them."""

    op_id: str
    index: int
    run: Callable[["Job"], object]
    pool: str = "default"
    preemptible: bool = False        # command jobs: killable + restartable
    id: str = field(default_factory=lambda: uuid.uuid4().hex[:16])
    state: str = "pending"           # pending|running|completed|failed|aborted
    result: object = None
    error: Optional[YtError] = None
    attempt: int = 0
    started_at: float = 0.0
    duration: float = 0.0
    stderr_tail: bytes = b""
    speculative_of: "Optional[Job]" = None
    on_done: Optional[Callable[["Job"], None]] = None
    # Job splitter (ref job_splitter.h): returns child jobs covering this
    # job's remaining input; the manager kills the straggler and settles
    # it from the children's results (in index order).
    splitter: "Optional[Callable[['Job'], list['Job']]]" = None
    split_children: "Optional[list['Job']]" = None
    # Split children run half-sized inputs: their durations must not feed
    # the straggler median, or healthy full-size jobs start "straggling".
    record_duration: bool = True
    # Failure quarantine (ref max_failed_job_count): a failing run with
    # failures < max_failures requeues instead of settling failed, so
    # transient faults (node death, injected error) don't fail the
    # operation on the first casualty.  `failures` counts GENUINE failed
    # runs only — preemption/worker-death/split requeues bump `attempt`
    # (address rotation) but must not burn the failure budget.
    max_failures: int = 1
    failures: int = 0
    _split_pending: bool = False     # chosen for split; blocks speculation
    # live process handle for kill-based preemption/speculation-loss
    _proc: Optional[subprocess.Popen] = None
    # `_settled` (read and written under the manager's lock) marks the
    # terminal state; `_done` wakes the waiters, and is set only once the
    # job's on_done observer has run: a controller woken earlier could
    # publish and clear the operation's snapshot while the observer was
    # still to record into it.
    _settled: bool = False
    # (address, remote job id) while running on an exec node
    _remote: "Optional[tuple[str, str]]" = None
    _done: threading.Event = field(default_factory=threading.Event)
    _lost: bool = False              # lost the speculative race
    _preempted: bool = False         # killed for fairness; will requeue


class JobManager:
    """Slots + fair-share pick + speculation + preemption for one process.

    Operations submit job lists and wait; the manager schedules across
    ALL live operations by pool fair share.
    """

    def __init__(self, slots: int = 4,
                 speculation_factor: float = 3.0,
                 min_speculation_seconds: float = 5.0,
                 pool_config: Optional[Callable[[str], dict]] = None,
                 slot_ban_after: int = 5,
                 slot_ban_seconds: float = 2.0):
        self.slots = slots
        self.speculation_factor = speculation_factor
        self.min_speculation_seconds = min_speculation_seconds
        # Slot quarantine: a slot whose last `slot_ban_after` runs ALL
        # failed is probably sitting on broken local state (bad disk,
        # leaked cgroup) — it cools off for `slot_ban_seconds` before
        # taking more work instead of chewing through the queue.  The
        # signal can't distinguish a poisoned slot from a poisoned queue
        # (one op mass-failing); that's accepted: the short cooldown then
        # acts as failure-storm throttling, bounded at slot_ban_seconds
        # per slot_ban_after failures per slot.
        self.slot_ban_after = slot_ban_after
        self.slot_ban_seconds = slot_ban_seconds
        self._pool_config = pool_config or (lambda name: {})
        # Config lookups may be Cypress RPCs; they run OUTSIDE the lock
        # (submit + monitor refresh this cache; scheduling reads it).
        self._pool_cfg_cache: dict[str, dict] = {}
        self._lock = threading.Condition()
        self._pending: list[Job] = []
        self._running: list[Job] = []
        self._workers: list[threading.Thread] = []
        self._monitor: Optional[threading.Thread] = None
        self._stop = False
        self._completed_durations: dict[str, list[float]] = {}
        self._split_parents: list[Job] = []

    # -- public ----------------------------------------------------------------

    def submit(self, jobs: "list[Job]") -> None:
        self._refresh_pool_configs({j.pool for j in jobs})
        with self._lock:
            self._pending.extend(jobs)
            self._ensure_workers()
            self._lock.notify_all()

    def _refresh_pool_configs(self, names) -> None:
        """Fetch pool configs WITHOUT holding the scheduling lock (they
        may be remote RPCs; a dead primary must not freeze the slots)."""
        for name in names:
            try:
                self._pool_cfg_cache[name] = self._pool_config(name) or {}
            except Exception:   # noqa: BLE001 — config must not fail jobs
                self._pool_cfg_cache.setdefault(name, {})

    def wait(self, jobs: "list[Job]", timeout: Optional[float] = None,
             raise_on_failure: bool = True) -> None:
        deadline = time.monotonic() + timeout if timeout else None
        for job in jobs:
            remaining = None if deadline is None else \
                max(deadline - time.monotonic(), 0.0)
            if not job._done.wait(remaining):
                raise YtError(f"Job {job.id} timed out",
                              code=EErrorCode.Timeout)
        if raise_on_failure:
            for job in jobs:
                if job.state == "failed":
                    raise job.error or YtError(
                        f"Job {job.id} failed",
                        code=EErrorCode.OperationFailed)

    def run_all(self, jobs: "list[Job]",
                timeout: Optional[float] = None) -> "list[object]":
        """Submit + wait; results in submission order (speculative winners
        folded in)."""
        self.submit(jobs)
        self.wait(jobs, timeout=timeout)
        return [j.result for j in jobs]

    def abort_operation(self, op_id: str) -> None:
        with self._lock:
            dropped = [j for j in self._pending if j.op_id == op_id]
            self._pending = [j for j in self._pending if j.op_id != op_id]
            for job in dropped:
                # Waiters may hold these: they must observe a terminal
                # state, not hang on a job that will never run.
                job.state = "aborted"
                job.error = YtError("operation aborted",
                                    code=EErrorCode.Canceled)
                job._settled = True
                job._done.set()
            for job in self._running:
                if job.op_id == op_id:
                    self._kill(job)
            for parent in list(self._split_parents):
                if parent.op_id == op_id:
                    parent.state = "aborted"
                    parent.error = YtError("operation aborted",
                                           code=EErrorCode.Canceled)
                    parent._settled = True
                    parent._done.set()
                    self._split_parents.remove(parent)
            self._completed_durations.pop(op_id, None)
            self._lock.notify_all()

    def finish_operation(self, op_id: str) -> None:
        """Drop per-operation bookkeeping once its jobs are settled (the
        duration history otherwise grows forever in a long-lived client)."""
        with self._lock:
            self._completed_durations.pop(op_id, None)

    def stats(self) -> dict:
        with self._lock:
            return {"pending": len(self._pending),
                    "running": len(self._running),
                    "slots": self.slots}

    # -- scheduling ------------------------------------------------------------

    def _ensure_workers(self) -> None:
        # Prune dead slots (worker-death crashes) before topping up, or a
        # crashed slot would count against the budget forever.
        self._workers = [w for w in self._workers
                         if w.is_alive() or w is threading.current_thread()
                         or not w.ident]
        while len(self._workers) < self.slots:
            worker = threading.Thread(target=self._worker_loop, daemon=True,
                                      name=f"job-slot-{len(self._workers)}")
            self._workers.append(worker)
            worker.start()
        if self._monitor is None:
            # Speculation + preemption must fire even when EVERY slot is
            # busy (exactly the starvation case), so they run on their own
            # cadence, not only from idle workers.
            self._monitor = threading.Thread(target=self._monitor_loop,
                                             daemon=True,
                                             name="job-monitor")
            self._monitor.start()

    def _monitor_loop(self) -> None:
        last_refresh = 0.0
        while not self._stop:
            time.sleep(0.25)
            now = time.monotonic()
            if now - last_refresh > 5.0:
                with self._lock:
                    names = {j.pool for j in self._pending + self._running}
                self._refresh_pool_configs(names)   # outside the lock
                last_refresh = now
            to_split: list[Job] = []
            settled: list[Job] = []
            with self._lock:
                try:
                    self._ensure_workers()   # heal crash-killed slots
                    to_split = self._split_candidates_locked()
                    self._maybe_speculate_locked()
                    self._maybe_preempt_locked()
                    settled = self._settle_splits_locked()
                except Exception:   # noqa: BLE001 — monitor must survive
                    logger.exception("job monitor pass failed")
            # User splitters and on_done observers may do RPCs/chunk IO —
            # NEVER under the scheduling lock (every slot would stall).
            for job in to_split:
                self._perform_split(job)
            for parent in settled:
                if parent.on_done is not None:
                    try:
                        parent.on_done(parent)
                    except Exception:   # noqa: BLE001 — observer boundary
                        pass
                parent._done.set()

    def _pool_states(self) -> "list[PoolState]":
        pools: dict[str, PoolState] = {}

        def state(name: str) -> PoolState:
            if name not in pools:
                cfg = self._pool_cfg_cache.get(name) or {}
                pools[name] = PoolState(
                    name=name,
                    weight=float(cfg.get("weight", 1.0)),
                    min_share_ratio=float(cfg.get("min_share_ratio", 0.0)),
                    max_running_jobs=cfg.get("max_running_jobs"))
            return pools[name]

        for job in self._pending:
            state(job.pool).pending += 1
        for job in self._running:
            state(job.pool).running += 1
        result = list(pools.values())
        compute_fair_shares(result, self.slots)
        return result

    def _next_job_locked(self) -> Optional[Job]:
        if not self._pending:
            return None
        pools = self._pool_states()
        chosen = pick_pool(pools)
        if chosen is None:
            return None
        for i, job in enumerate(self._pending):
            if job.pool == chosen.name:
                return self._pending.pop(i)
        return None

    def _worker_loop(self) -> None:
        consecutive_failures = 0
        while True:
            try:
                with self._lock:
                    job = self._next_job_locked()
                    while job is None:
                        if self._stop:
                            return
                        self._lock.wait(timeout=0.5)
                        job = self._next_job_locked()
                    job.state = "running"
                    job.started_at = time.monotonic()
                    self._running.append(job)
                try:
                    ok = self._execute(job)
                except failpoints.InjectedCrash:
                    # Simulated slot death mid-job: requeue the orphan
                    # and let this thread die (the monitor respawns a
                    # replacement) — the worker-death recovery path.
                    self._on_worker_death(job)
                    return
                if ok:
                    consecutive_failures = 0
                else:
                    consecutive_failures += 1
                    if consecutive_failures >= self.slot_ban_after:
                        logger.warning(
                            "job slot banned for %.1fs after %d "
                            "consecutive failures",
                            self.slot_ban_seconds, consecutive_failures)
                        _profiler.counter("slot_banned").increment()
                        consecutive_failures = 0
                        time.sleep(self.slot_ban_seconds)
            except Exception:   # noqa: BLE001 — a slot must never die
                logger.exception("job slot scheduling pass failed")
                time.sleep(0.1)

    def _on_worker_death(self, job: Job) -> None:
        """This slot thread is dying with `job` claimed: hand the job
        back (attempt+1) and drop the thread from the slot roster so
        _ensure_workers spawns a replacement."""
        with self._lock:
            if job in self._running:
                self._running.remove(job)
            if not job._settled and not job._lost:
                job._proc = None
                job.state = "pending"
                job.attempt += 1
                self._pending.append(job)
            me = threading.current_thread()
            if me in self._workers:
                self._workers.remove(me)
            _profiler.counter("worker_died").increment()
            self._ensure_workers()
            self._lock.notify_all()
        logger.warning("job slot died (injected crash); job %s requeued",
                       job.id)

    # -- execution -------------------------------------------------------------

    def _execute(self, job: Job) -> bool:
        """Run one claimed job to a settled (or requeued) state.  Returns
        False iff the job GENUINELY failed (the run raised and the job
        was not killed on purpose) — the slot's consecutive-failure
        quarantine counts on it, so preemption/speculation-loss/abort
        kills must not read as slot faults.  May raise InjectedCrash
        (worker-death failpoint); the caller owns that recovery."""
        prof = _profiler.with_tags(pool=job.pool)
        prof.counter("started").increment()
        try:
            # worker_death is meaningful as crash-once (InjectedCrash is
            # a BaseException, so it pierces this try); its error mode
            # degrades to an ordinary job failure.
            _FP_WORKER_DEATH.hit()
            _FP_START.hit()
            result = job.run(job)
            _FP_FINISH.hit()
            ok = True
        except YtError as err:
            ok = False
            error = err
        except Exception as exc:      # noqa: BLE001 — job boundary
            ok = False
            error = YtError(f"Job crashed: {exc!r}",
                            code=EErrorCode.OperationFailed)
        duration = time.monotonic() - job.started_at
        with self._lock:
            if job in self._running:
                self._running.remove(job)
            if job._settled:
                # Already settled by a winning speculative twin (result
                # copied, waiters woken) — this unwinding run must not
                # clobber the settled state or re-queue a delivered job.
                job._proc = None
                return True
            job.duration = duration
            if job._preempted:
                # Same object re-queues (waiters hold it); don't signal.
                # A preemption kill is not a slot fault.
                job._preempted = False
                job._proc = None
                job.state = "pending"
                job.attempt += 1
                self._pending.append(job)
                self._lock.notify_all()
                return True
            if job._lost and job.split_children is not None:
                # Killed FOR the split: stays unsettled until the children
                # deliver (the monitor's settle pass owns it now).
                job._proc = None
                return True
            slot_ok = True
            released: list[Job] = []
            if job._lost:
                job.state = "aborted"   # deliberate kill: not a slot fault
            elif ok:
                job.state = "completed"
                job.result = result
                job.error = None    # a quarantine-absorbed earlier failure
                # must not read as this (completed) job's error upstream.
                if job.record_duration:
                    self._completed_durations.setdefault(
                        job.op_id, []).append(duration)
                released = self._settle_speculation_locked(job)
            elif job.failures + 1 < job.max_failures:
                # Failure quarantine (ref max_failed_job_count): the
                # failure budget absorbs transient faults; waiters keep
                # their handle and only the LAST failure settles.
                prof.counter("retried").increment()
                job._proc = None
                job.state = "pending"
                job.attempt += 1
                job.failures += 1
                job.error = error
                self._pending.append(job)
                self._lock.notify_all()
                return False
            else:
                job.state = "failed"
                job.failures += 1
                job.error = error
                prof.counter("failed").increment()
                slot_ok = False
            job._settled = True
            self._lock.notify_all()
        if job.on_done is not None:
            try:
                job.on_done(job)
            except Exception:      # noqa: BLE001 — observer boundary
                pass
        # Waiters wake only now: the observer's record is in place.
        for settled in (job, *released):
            settled._done.set()
        return slot_ok

    def _kill(self, job: Job) -> None:
        job._lost = True
        _kill_job_process(job)

    # -- job splitting ---------------------------------------------------------

    def _straggler_threshold(self, op_id: str) -> Optional[float]:
        done = self._completed_durations.get(op_id) or []
        if not done:
            return None
        median = sorted(done)[len(done) // 2]
        return max(median * self.speculation_factor,
                   self.min_speculation_seconds)

    def _split_candidates_locked(self) -> "list[Job]":
        """Stragglers eligible for a split (ref job_splitter.h).  Splitting
        beats speculation when available: the duplicate would repeat ALL
        the work, the split halves it.  The user splitter itself runs
        OUTSIDE the lock (_perform_split)."""
        now = time.monotonic()
        out = []
        for job in list(self._running):
            if job.splitter is None or job.split_children is not None or \
                    job._split_pending or not job.preemptible or \
                    job.speculative_of is not None:
                continue
            if any(s.speculative_of is job
                   for s in self._pending + self._running):
                continue
            threshold = self._straggler_threshold(job.op_id)
            if threshold is None or now - job.started_at < threshold:
                continue
            job._split_pending = True     # blocks speculation meanwhile
            out.append(job)
        return out

    def _perform_split(self, job: Job) -> None:
        try:
            children = job.splitter(job)
        except Exception:   # noqa: BLE001 — splitter is user territory
            logger.exception("job splitter failed for %s", job.id)
            job.splitter = None
            job._split_pending = False
            return
        if len(children) < 2:
            job.splitter = None          # too small; speculation may apply
            job._split_pending = False
            return
        for child in children:
            child.record_duration = False
        with self._lock:
            # The job may have settled while the splitter ran.
            if job._settled or job not in self._running or \
                    job.split_children is not None:
                return
            logger.info("splitting job %s into %d children",
                        job.id, len(children))
            _profiler.counter("split").increment()
            job.split_children = children
            self._split_parents.append(job)
            self._kill(job)      # unwinds unsettled; children settle it
            self._pending.extend(children)
            self._lock.notify_all()

    def _settle_splits_locked(self) -> "list[Job]":
        """A split parent completes when every child has; the first child
        failure fails the parent.  Returns the settled parents — their
        on_done observers fire OUTSIDE the lock."""
        settled = []
        for parent in list(self._split_parents):
            children = parent.split_children or []
            failed = next((c for c in children if c.state == "failed"),
                          None)
            if failed is not None:
                parent.state = "failed"
                parent.error = failed.error
            elif all(c.state == "completed" for c in children):
                parent.state = "completed"
                result: list = []
                for child in children:
                    result.extend(child.result or [])
                parent.result = result
            else:
                continue
            self._split_parents.remove(parent)
            parent._settled = True
            self._lock.notify_all()
            settled.append(parent)
        return settled

    # -- speculation -----------------------------------------------------------

    def _maybe_speculate_locked(self) -> None:
        """Duplicate stragglers: a preemptible job running far beyond the
        operation's median completed duration gets a twin (first finisher
        wins, ref speculative_job_manager.h)."""
        now = time.monotonic()
        for job in list(self._running):
            if not job.preemptible or job.speculative_of is not None or \
                    job.split_children is not None or job._split_pending:
                continue
            if any(s.speculative_of is job
                   for s in self._pending + self._running):
                continue
            threshold = self._straggler_threshold(job.op_id)
            if threshold is None or now - job.started_at < threshold:
                continue
            twin = Job(op_id=job.op_id, index=job.index, run=job.run,
                       pool=job.pool, preemptible=True,
                       speculative_of=job, on_done=job.on_done)
            twin.attempt = job.attempt + 1
            logger.info("speculating job %s (running %.1fs > %.1fs)",
                        job.id, now - job.started_at, threshold)
            _profiler.counter("speculated").increment()
            self._pending.append(twin)

    def _settle_speculation_locked(self, winner: Job) -> "list[Job]":
        """First finisher wins; abort the twin. Returns the original job
        when the twin won: its waiters wake with the winner's, after the
        winner's on_done observer."""
        released = []
        rival = winner.speculative_of
        if rival is not None and not rival._settled:
            # Twin finished first: copy the result onto the original so
            # waiters (which hold the original) observe success.  The
            # logical job's on_done fires exactly once — here via the
            # twin's own _execute; the original's unwinding run takes the
            # settled-state early return BEFORE its callback.
            rival.result = winner.result
            rival.state = "completed"
            rival.duration = winner.duration
            self._kill(rival)
            rival._settled = True
            released.append(rival)
            if rival in self._running:
                self._running.remove(rival)
        for job in self._pending + self._running:
            if job.speculative_of is winner:
                if job in self._pending:
                    self._pending.remove(job)
                    job.state = "aborted"
                    job._settled = True
                    job._done.set()
                else:
                    self._kill(job)
        return released

    # -- preemption ------------------------------------------------------------

    def maybe_preempt(self) -> bool:
        """Kill the newest preemptible job of the most-over-share pool when
        another pool is starving; the victim re-queues (attempt + 1).
        Runs automatically from idle workers; public for direct prodding."""
        with self._lock:
            return self._maybe_preempt_locked()

    def _maybe_preempt_locked(self) -> bool:
        pools = self._pool_states()
        victim_pool = find_preemptable(pools)
        if victim_pool is None:
            return False
        victims = [j for j in self._running
                   if j.pool == victim_pool.name and j.preemptible
                   and not j._lost and not j._preempted]
        if not victims:
            return False
        victim = max(victims, key=lambda j: j.started_at)
        logger.info("preempting job %s of pool %s", victim.id, victim.pool)
        _profiler.counter("preempted").increment()
        # The SAME object re-queues when its killed run unwinds (see
        # _execute) — waiters keep their handle.
        victim._preempted = True
        _kill_job_process(victim)
        self._lock.notify_all()
        return True


# -- job processes -------------------------------------------------------------


def _kill_job_process(job: Job) -> None:
    """Kill the WHOLE process group of a job that runs a child process
    (`job._proc`): killing only the shell leaves its children holding
    the stdout pipe. A job running on an exec node gets a best-effort
    remote abort (its poll loop also aborts on the _lost/_preempted
    flags). A job without either is left to finish."""
    import os
    import signal
    proc = job._proc
    if proc is not None and proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (OSError, ProcessLookupError):
            try:
                proc.kill()
            except OSError:
                pass
    remote = job._remote
    if remote is not None:
        def _abort(addr=remote[0], rid=remote[1]):
            from ytsaurus_tpu_torch.rpc import Channel
            channel = Channel(addr, timeout=10)
            try:
                channel.call("exec_node", "abort_job", {"job_id": rid})
            except YtError:
                pass
            finally:
                channel.close()
        threading.Thread(target=_abort, daemon=True).start()


def run_remote_command_job(job: Job, address: str, body: dict,
                           input_blob: Optional[bytes] = None,
                           timeout: Optional[float] = None) -> bytes:
    """Dispatch one command job to an exec node and poll to completion;
    returns the job's stdout blob.

    Ref: the scheduler->exec-node allocation + job-proxy supervision
    hop (server/scheduler/node_shard.cpp, server/node/exec_node/job
    controller), collapsed to start/poll/abort RPCs."""
    from ytsaurus_tpu_torch.rpc import Channel, RetryingChannel
    from ytsaurus_tpu_torch.rpc.wire import wire_text as _text
    if job._lost or job._preempted:
        raise YtError("job canceled before start", code=EErrorCode.Canceled)
    # Attempts/backoff come from the process retry policy (config.py
    # "job_rpc"), not per-call-site constants: fail fast so the job
    # revives on another node.
    channel = RetryingChannel(Channel(address, timeout=30),
                              policy="job_rpc")
    remote_id = None
    delivered = False
    # Dedup key: a transport retry of start_job must not double-start
    # the command on the node (ExecNodeService keys running jobs by it).
    body = dict(body)
    body["job_key"] = f"{job.id}:{job.attempt}"
    try:
        res, _ = channel.call(
            "exec_node", "start_job", body,
            attachments=[input_blob] if input_blob is not None else (),
            idempotent=False)
        remote_id = _text(res["job_id"])
        job._remote = (address, remote_id)
        deadline = time.monotonic() + timeout if timeout else None
        interval = 0.1
        while True:
            if job._lost or job._preempted:
                raise YtError("job canceled", code=EErrorCode.Canceled)
            poll, attachments = channel.call(
                "exec_node", "poll_job", {"job_id": remote_id})
            state = _text(poll["state"])
            if state == "completed":
                delivered = True
                return attachments[0]
            if state in ("failed", "aborted"):
                raise YtError(
                    f"remote job failed on {address}: "
                    f"{_text(poll.get('error') or '')}",
                    code=EErrorCode.OperationFailed,
                    attributes={
                        "stderr": _text(poll.get("stderr_tail") or ""),
                        "exit_code": poll.get("exit_code")})
            if deadline is not None and time.monotonic() > deadline:
                raise YtError(f"remote job on {address} timed out",
                              code=EErrorCode.Timeout)
            time.sleep(interval)
            interval = min(interval * 1.6, 1.5)
    finally:
        if remote_id is not None and not delivered:
            # ANY non-success exit (cancel, poll-retry exhaustion, poll
            # timeout) must stop the remote process: the caller may
            # revive the job elsewhere, and an orphan would keep a slot
            # busy and re-run user side effects.
            try:
                channel.call("exec_node", "abort_job",
                             {"job_id": remote_id})
            except YtError:
                pass
        job._remote = None
        channel.close()


def run_command_job(job: Job, command: str, input_blob: bytes,
                    timeout: Optional[float] = None,
                    env: Optional[dict] = None,
                    limits: Optional[dict] = None) -> bytes:
    """Run a user command with formatted rows on stdin; returns stdout.

    Ref: job_proxy user_job.cpp — a separate process (own process group,
    the slot-isolation analog), wire-format pipes, stderr tail kept on
    the job, non-zero exit = job failure.  `limits` applies the job
    environment's resource enforcement (rlimits) in the child — see
    operations/job_environment.py.  The child runs /bin/sh in its own
    session and never touches the device."""
    import os

    from ytsaurus_tpu_torch.operations.job_environment import (
        classify_failure,
        make_preexec,
    )
    if job._lost or job._preempted:
        # Killed before the process spawned: don't start work that is
        # already condemned.
        raise YtError("job canceled before start", code=EErrorCode.Canceled)
    proc = subprocess.Popen(
        ["/bin/sh", "-c", command],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        start_new_session=True,
        preexec_fn=make_preexec(limits),
        env={**os.environ, **(env or {}),
             "YT_JOB_ID": job.id, "YT_JOB_INDEX": str(job.index),
             "YT_OPERATION_ID": job.op_id})
    job._proc = proc
    if job._lost or job._preempted:
        # A kill issued between the check above and _proc assignment saw
        # no process; finish the kill ourselves.
        _kill_job_process(job)
    try:
        stdout, stderr = proc.communicate(input_blob, timeout=timeout)
    except subprocess.TimeoutExpired:
        _kill_job_process(job)
        proc.communicate()
        raise YtError(f"User job {job.id} timed out",
                      code=EErrorCode.Timeout)
    finally:
        job._proc = None
    job.stderr_tail = stderr[-STDERR_TAIL_BYTES:]
    if job._lost:
        raise YtError("job preempted", code=EErrorCode.Canceled)
    if proc.returncode != 0:
        attributes = {"stderr": job.stderr_tail.decode("utf-8",
                                                       "replace"),
                      "exit_code": proc.returncode}
        cause = classify_failure(proc.returncode, job.stderr_tail,
                                 limits)
        if cause:
            attributes["probable_cause"] = cause
        raise YtError(
            f"User job {job.id} failed with exit code {proc.returncode}",
            code=EErrorCode.OperationFailed, attributes=attributes)
    return stdout
