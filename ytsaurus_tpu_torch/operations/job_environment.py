"""Job isolation environment: per-process resource enforcement for user
jobs. Own copy of the JAX package's `operations/job_environment.py`.

The child side of `make_preexec` runs between fork and exec in a process
that may hold a CUDA context and many threads: it calls
`resource.setrlimit` and `os.nice` only (no import, no logging, no
lock), and the child then execs /bin/sh without touching the device.

Ref: server/node/exec_node/job_environment.cpp:359,447 — the reference
offers simple / porto / CRI environments; porto/cgroups enforce memory,
CPU, and process limits per job container.

Redesign for this runtime: container managers need privileges a shared
research box does not grant, so enforcement rides POSIX rlimits applied
in the child between fork and exec (`preexec_fn`) — the same kernel
mechanisms cgroup v1 memory/cpu controllers wrap, scoped per process
group (jobs already run in their own session):

  memory_limit  → RLIMIT_AS   (allocation beyond it fails → job dies)
  cpu_limit     → RLIMIT_CPU  (seconds of CPU → SIGKILL past the hard
                               cap; distinct from wall-clock timeouts)
  max_open_files→ RLIMIT_NOFILE
  nice          → scheduling priority (the cpu.weight analog)

The resulting failure is classified so operators see "memory limit
exceeded", not a bare exit code.
"""

from __future__ import annotations

import signal
from typing import Callable, Optional

MIN_MEMORY_LIMIT = 32 << 20          # below this even /bin/sh won't exec


def limits_from_spec(spec: dict) -> "Optional[dict]":
    """Extract the enforcement keys a job spec may carry (ref user job
    spec memory_limit/cpu_limit)."""
    out = {}
    for key in ("memory_limit", "cpu_limit", "max_open_files", "nice"):
        if spec.get(key) is not None:
            out[key] = spec[key]
    return out or None


def make_preexec(limits: "Optional[dict]") -> "Optional[Callable]":
    """preexec_fn applying the limits in the CHILD (between fork and
    exec) — nothing leaks into the parent server process."""
    if not limits:
        return None
    # Imports resolved in the PARENT: the closure runs between fork and
    # exec, where taking the import lock (possibly held by another
    # parent thread) would deadlock the child.
    import os
    import resource
    memory = limits.get("memory_limit")
    cpu = limits.get("cpu_limit")
    nofile = limits.get("max_open_files")
    nice = limits.get("nice")

    def apply() -> None:
        if memory is not None:
            cap = max(int(memory), MIN_MEMORY_LIMIT)
            resource.setrlimit(resource.RLIMIT_AS, (cap, cap))
        if cpu is not None:
            seconds = max(int(cpu), 1)
            # Soft = SIGXCPU (classifiable), hard = +1s then SIGKILL.
            resource.setrlimit(resource.RLIMIT_CPU,
                               (seconds, seconds + 1))
        if nofile is not None:
            resource.setrlimit(resource.RLIMIT_NOFILE,
                               (int(nofile), int(nofile)))
        if nice is not None:
            os.nice(int(nice))
    return apply


def classify_failure(returncode: int, stderr: bytes,
                     limits: "Optional[dict]") -> "Optional[str]":
    """Human-readable probable cause when a limited job died the way its
    limit kills (ref job proxy's error attribution)."""
    if not limits:
        return None
    if limits.get("cpu_limit") is not None:
        if -returncode == signal.SIGXCPU:
            return "cpu limit exceeded (SIGXCPU)"
        if -returncode == signal.SIGKILL:
            # The hard cap (soft+1s) delivers SIGKILL to jobs that
            # ignore SIGXCPU.
            return "cpu limit exceeded (hard cap SIGKILL)"
    if limits.get("memory_limit") is not None:
        markers = (b"MemoryError", b"Cannot allocate memory",
                   b"std::bad_alloc", b"Killed")
        if returncode != 0 and any(m in stderr for m in markers):
            return "memory limit exceeded (RLIMIT_AS)"
        if -returncode == signal.SIGSEGV:
            return "memory limit exceeded (allocation failed under " \
                   "RLIMIT_AS)"
    return None
