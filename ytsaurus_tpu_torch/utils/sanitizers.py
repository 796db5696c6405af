"""Named locks.

Own copy of the JAX package's `utils/sanitizers.py::register_lock` and
`register_rlock` as far as they name a lock: the reference's concurrency
sanitizer (lock-order edges, hold budgets, sync-under-lock checks) has no
counterpart, so the calls return a plain `threading.Lock` / `RLock` and
record its name.
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
