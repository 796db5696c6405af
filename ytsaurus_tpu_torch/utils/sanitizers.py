"""Named locks.

Own copy of the JAX package's `utils/sanitizers.py::register_lock` and
`register_rlock` / `register_condition` as far as they name a lock: the reference's concurrency
sanitizer (lock-order edges, hold budgets, sync-under-lock checks) has no
counterpart, so the calls return a plain `threading.Lock` / `RLock` /
`Condition` and record its name, and `snapshot()` reports the sanitizer
as off, as the reference's does when it is not enabled.
"""

from __future__ import annotations

import threading

_names: set = set()


def register_lock(name: str, lock=None, *, hot: bool = True):
    """A lock registered under `name` (`lock` if one is given). `hot` is
    accepted for the reference's call sites and has no effect."""
    _names.add(name)
    return lock if lock is not None else threading.Lock()


def register_rlock(name: str, lock=None, *, hot: bool = True):
    """A re-entrant lock registered under `name` (`lock` if one is
    given). `hot` is accepted for the reference's call sites and has no
    effect."""
    _names.add(name)
    return lock if lock is not None else threading.RLock()


def register_condition(name: str, cond=None, *, hot: bool = True):
    """A condition variable registered under `name` (`cond` if one is
    given). `hot` is accepted for the reference's call sites and has no
    effect."""
    _names.add(name)
    return cond if cond is not None else threading.Condition()


def snapshot() -> dict:
    """The monitoring `/sanitizer` and orchid report: off, with the
    registered lock names."""
    return {"enabled": False, "registered_sites": sorted(_names)}
