"""Deterministic failpoint injection.

Own copy of the JAX package's `utils/failpoints.py` as far as the port's
fault sites use it: every interesting execution boundary names a **site**
(`query.shard_execute`, `parallel.all_to_all`, ...), and a **schedule**
activated per process decides, reproducibly, which hits of which sites
misbehave and how.

A spec is `site=mode[:k=v]...` entries joined by `;`:

    query.shard_execute=error:times=2;parallel.gather=delay:ms=5:1in=3

Modes: `error` (raise the site's registered error), `delay` (sleep
`ms` milliseconds) and `torn-write` (write sites only, through
`write_hit`: the payload is cut to its first half, and the caller writes
that to its staging file and then fails without publishing it). Knobs: `p` (trigger probability per hit, from a
per-site RNG seeded by (seed, site)), `1in` (every n-th eligible hit),
`times` (at most this many triggers), `after` (skip the first n hits),
`ms` (delay length). Activation is `active(spec, seed)` (a context
manager) or `activate`. The reference's crash-once mode (process death), its
environment activation and its sensors are not ported.

On a mesh every rank holds its own schedule: give every rank the same
spec, and the sites (hit before any collective of their step) trigger on
every rank alike, so the ranks degrade together.

The disabled fast path is one module-global read per hit.
"""

from __future__ import annotations

import contextlib
import random
import time
from typing import Callable, Optional

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.utils import sanitizers

MODES = ("error", "delay", "torn-write")


def _default_error(site_name: str) -> BaseException:
    return YtError(f"injected fault at failpoint {site_name!r}",
                   code=EErrorCode.Generic,
                   attributes={"failpoint": site_name})


class _Rule:
    """One parsed `site=mode:...` entry plus its runtime trigger state."""

    __slots__ = ("mode", "p", "one_in", "times", "after", "ms",
                 "hits", "triggered", "rng")

    def __init__(self, mode: str, p: float = 1.0, one_in: int = 0,
                 times: Optional[int] = None, after: int = 0,
                 ms: float = 10.0):
        if mode not in MODES:
            raise YtError(f"Unknown failpoint mode {mode!r} "
                          f"(expected one of {MODES})",
                          code=EErrorCode.InvalidConfig)
        self.mode = mode
        self.p = p
        self.one_in = one_in
        self.times = times
        self.after = after
        self.ms = ms
        self.hits = 0
        self.triggered = 0
        self.rng: Optional[random.Random] = None   # bound at activation


class _State:
    """One activation: rules by site name + the seed of the p-based
    decisions."""

    def __init__(self, rules: "dict[str, _Rule]", seed: int, spec: str):
        self.rules = rules
        self.seed = seed
        self.spec = spec
        for name, rule in rules.items():
            rule.rng = random.Random(f"{seed}:{name}")


# The ONE global read on the disabled fast path.
_STATE: Optional[_State] = None
# guards: _STATE, _SITES
_LOCK = sanitizers.register_lock("failpoints._LOCK", hot=False)
_SITES: "dict[str, FailpointSite]" = {}


class FailpointSite:
    """A named fault site; `hit()` is its probe."""

    __slots__ = ("name", "error_factory", "hits", "triggers")

    def __init__(self, name: str,
                 error: Optional[Callable[[str], BaseException]] = None):
        self.name = name
        self.error_factory = error or _default_error
        self.hits = 0        # cumulative, only counted while active
        self.triggers = 0

    def fire(self, write: bool = False) -> "Optional[tuple[str, float]]":
        """Evaluate the schedule for one hit: (mode, ms) when a fault
        fires, None otherwise. Neither raises nor sleeps. A torn-write
        rule fires only on a write probe (`write=True`)."""
        state = _STATE
        if state is None:
            return None
        with _LOCK:
            self.hits += 1
            rule = state.rules.get(self.name)
            if rule is None:
                return None
            rule.hits += 1
            if rule.mode == "torn-write" and not write:
                return None
            if rule.hits <= rule.after:
                return None
            if rule.times is not None and rule.triggered >= rule.times:
                return None
            if rule.one_in and (rule.hits - rule.after - 1) % rule.one_in:
                return None
            if rule.p < 1.0 and rule.rng.random() >= rule.p:
                return None
            rule.triggered += 1
            self.triggers += 1
        return rule.mode, rule.ms

    def hit(self) -> None:
        """The probe: may sleep (delay) or raise the site's error."""
        if _STATE is None:      # disabled fast path: one global read
            return
        act = self.fire()
        if act is None:
            return
        mode, ms = act
        if mode == "delay":
            time.sleep(ms / 1000.0)
        else:
            raise self.error_factory(self.name)

    def write_hit(self, blob: bytes) -> "tuple[bytes, bool]":
        """The write-site probe: (payload, torn). With torn=True the
        caller writes `payload` (a truncated prefix) to its staging
        location and then fails the write without publishing it."""
        if _STATE is None:
            return blob, False
        act = self.fire(write=True)
        if act is None:
            return blob, False
        mode, ms = act
        if mode == "delay":
            time.sleep(ms / 1000.0)
            return blob, False
        if mode == "error":
            raise self.error_factory(self.name)
        return blob[: max(len(blob) // 2, 1)], True


def register_site(name: str,
                  error: Optional[Callable[[str], BaseException]] = None
                  ) -> FailpointSite:
    """Get-or-create a site. Registration at module import keeps the
    site list enumerable."""
    with _LOCK:
        site = _SITES.get(name)
        if site is None:
            site = _SITES[name] = FailpointSite(name, error=error)
        return site


def parse_spec(spec: str) -> "dict[str, _Rule]":
    """`site=mode[:k=v]...;site2=...` → rules by site name."""
    rules: dict[str, _Rule] = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise YtError(f"Bad failpoint entry {entry!r} "
                          "(expected site=mode[:k=v]...)",
                          code=EErrorCode.InvalidConfig)
        name, _, rest = entry.partition("=")
        parts = rest.split(":")
        mode = parts[0].strip()
        kwargs: dict = {}
        for kv in parts[1:]:
            if not kv:
                continue
            key, _, value = kv.partition("=")
            key = key.strip()
            try:
                if key == "p":
                    kwargs["p"] = float(value)
                elif key == "1in":
                    kwargs["one_in"] = int(value)
                elif key == "times":
                    kwargs["times"] = int(value)
                elif key == "after":
                    kwargs["after"] = int(value)
                elif key == "ms":
                    kwargs["ms"] = float(value)
                else:
                    raise YtError(
                        f"Unknown failpoint knob {key!r} in {entry!r}",
                        code=EErrorCode.InvalidConfig)
            except ValueError as exc:
                raise YtError(f"Bad failpoint value {kv!r} in {entry!r}",
                              code=EErrorCode.InvalidConfig) from exc
        rules[name.strip()] = _Rule(mode, **kwargs)
    return rules


def activate(spec: str, seed: int = 0) -> None:
    """Replace the active schedule. Unknown site names are allowed (the
    hosting module may not be imported yet); they never match."""
    global _STATE
    state = _State(parse_spec(spec), seed=seed, spec=spec)
    with _LOCK:
        _STATE = state if state.rules else None


@contextlib.contextmanager
def active(spec: str, seed: int = 0):
    """Scoped activation; nested use restores the previous schedule."""
    global _STATE
    with _LOCK:
        prev = _STATE
    activate(spec, seed=seed)
    try:
        yield
    finally:
        with _LOCK:
            _STATE = prev
