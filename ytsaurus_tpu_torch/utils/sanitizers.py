"""Named locks.

Own copy of the JAX package's `utils/sanitizers.py::register_lock` as far
as it names a lock: the reference's concurrency sanitizer (lock-order
edges, hold budgets, sync-under-lock checks) has no counterpart, so the
call returns a plain `threading.Lock` and records its name.
"""

from __future__ import annotations

import threading

_names: set = set()


def register_lock(name: str, lock=None, *, hot: bool = True):
    """A lock registered under `name` (`lock` if one is given). `hot` is
    accepted for the reference's call sites and has no effect."""
    _names.add(name)
    return lock if lock is not None else threading.Lock()
