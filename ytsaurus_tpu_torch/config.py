"""Process-wide configuration that the port reads.

An own copy of what the port needs from the JAX package's `config.py`,
as plain dataclasses with the reference's defaults and bounds (the
reference's `YsonStruct` layer and its daemon configs have no
counterpart):

  RetryPolicyConfig  the jittered exponential backoff of the per-shard
                     retry in `query/coordinator.py` and of the
                     replicated chunk read ladder
                     (`chunks/replicated.py`) (`retry_policy`)
  CompileConfig      `whole_plan` (the top rung of the degradation
                     ladder), `whole_plan_headroom` (the overflow
                     escalation's slack) and `broadcast_join_rows`
                     (`query/planner.py`)
  TelemetryConfig    `mesh_telemetry` (the telemetry lanes of the
                     whole-plan read) and `mesh_max_imbalance` (the skew
                     above which the mesh observatory counts an execution
                     as skewed)
  TabletConfig       the tablet's read-path knobs: the host-plane LRU's
                     size, the snapshot cache, and the version count at
                     which the MVCC merge goes columnar

The reference's CompileConfig knobs for compile caches, AOT artifacts and
buffer donation have no counterpart: nothing here is compiled.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass
from typing import Optional

from ytsaurus_tpu_torch.errors import EErrorCode, YtError


def _check(name: str, value: float, ge: Optional[float] = None,
           le: Optional[float] = None) -> None:
    if (ge is not None and value < ge) or (le is not None and value > le):
        bounds = " and ".join(b for b in (
            f">= {ge}" if ge is not None else "",
            f"<= {le}" if le is not None else "") if b)
        raise YtError(f"{name} = {value!r} must be {bounds}",
                      code=EErrorCode.InvalidConfig)


@dataclass
class RetryPolicyConfig:
    """Delay for attempt i is `min(backoff * 2^i, backoff_cap) *
    (1 - jitter * U[0,1))`: the jitter decorrelates retry storms after a
    common-cause failure."""

    attempts: int = 5
    backoff: float = 0.2
    backoff_cap: float = 3.0
    jitter: float = 0.2

    def __post_init__(self):
        _check("attempts", self.attempts, ge=1)
        _check("backoff", self.backoff, ge=0.0)
        _check("backoff_cap", self.backoff_cap, ge=0.0)
        _check("jitter", self.jitter, ge=0.0, le=1.0)

    def delay(self, attempt: int, rng=None) -> float:
        base = min(self.backoff * (2 ** attempt), self.backoff_cap)
        if self.jitter <= 0.0 or base <= 0.0:
            return base
        u = (rng or _random).random()
        return base * (1.0 - self.jitter * u)


_RETRY_POLICIES: dict[str, RetryPolicyConfig] = {}
_RETRY_DEFAULTS: dict[str, dict] = {
    # Replicated chunk read ladder: rotate fast, short waits.
    "chunk_read": dict(attempts=3, backoff=0.05, backoff_cap=1.0,
                       jitter=0.5),
    # Per-shard retry inside coordinate_and_execute.
    "query_shard": dict(attempts=3, backoff=0.05, backoff_cap=0.5,
                        jitter=0.5),
}


def retry_policy(name: str) -> RetryPolicyConfig:
    policy = _RETRY_POLICIES.get(name)
    if policy is None:
        defaults = _RETRY_DEFAULTS.get(name)
        if defaults is None:
            raise YtError(f"Unknown retry policy {name!r}",
                          code=EErrorCode.InvalidConfig)
        policy = _RETRY_POLICIES[name] = RetryPolicyConfig(**defaults)
    return policy


@dataclass
class CompileConfig:
    """- `whole_plan`: serve fusable distributed plans on the whole-plan
      rung (parallel/whole_plan.py), the top of the degradation ladder.
      Off forces the stitched rungs.
    - `whole_plan_headroom`: multiplier applied when an overflow
      escalates an exchange or expansion quota; first guesses and
      settled quotas round to pow2 without it.
    - `broadcast_join_rows`: the foreign row count up to which
      query/planner.py picks a broadcast join."""

    whole_plan: bool = True
    whole_plan_headroom: float = 1.5
    broadcast_join_rows: int = 65536

    def __post_init__(self):
        _check("whole_plan_headroom", self.whole_plan_headroom, ge=1.0)
        _check("broadcast_join_rows", self.broadcast_join_rows, ge=0)


@dataclass
class TelemetryConfig:
    """- `mesh_telemetry`: stack the mesh telemetry lanes (per-shard rows,
      transfer matrices, quota demand) onto the whole-plan rung's one
      host read, and publish the block.
    - `mesh_max_imbalance`: max-shard / mean-shard output rows above
      which an execution counts as skewed (the MESH_SKEW_SLO's bad
      events)."""

    mesh_telemetry: bool = True
    mesh_max_imbalance: float = 4.0

    def __post_init__(self):
        _check("mesh_max_imbalance", self.mesh_max_imbalance, ge=1.0)


_COMPILE_CONFIG: Optional[CompileConfig] = None
_TELEMETRY_CONFIG: Optional[TelemetryConfig] = None


def compile_config() -> CompileConfig:
    global _COMPILE_CONFIG
    if _COMPILE_CONFIG is None:
        _COMPILE_CONFIG = CompileConfig()
    return _COMPILE_CONFIG


def set_compile_config(config: Optional[CompileConfig]) -> None:
    """Install a process-wide compile config (None restores defaults)."""
    global _COMPILE_CONFIG
    _COMPILE_CONFIG = config


def telemetry_config() -> TelemetryConfig:
    global _TELEMETRY_CONFIG
    if _TELEMETRY_CONFIG is None:
        _TELEMETRY_CONFIG = TelemetryConfig()
    return _TELEMETRY_CONFIG


def set_telemetry_config(config: Optional[TelemetryConfig]) -> None:
    """Install a process-wide telemetry config (None restores defaults)."""
    global _TELEMETRY_CONFIG
    _TELEMETRY_CONFIG = config


@dataclass
class TabletConfig:
    """Tablet read-path knobs (tablet/tablet.py):

    - `host_plane_cache_capacity`: entries in the per-tablet LRU of
      host numpy views of chunk planes (promote on hit; the lookup
      probe's device → host staging cache).
    - `snapshot_cache_enabled`: memoize the materialized visible chunk
      per (flush generation, store mutation count) for latest-timestamp
      reads; any write, flush or compaction invalidates it.
    - `vectorized_scan_min_rows`: version count at and above which the
      MVCC merge (read_snapshot, flush, compact) runs as the columnar
      device pipeline (tablet/mvcc.py); below it the Python merge runs.
      0 forces the columnar path."""

    host_plane_cache_capacity: int = 64
    snapshot_cache_enabled: bool = True
    vectorized_scan_min_rows: int = 1024

    def __post_init__(self):
        _check("host_plane_cache_capacity", self.host_plane_cache_capacity,
               ge=1)
        _check("vectorized_scan_min_rows", self.vectorized_scan_min_rows,
               ge=0)


_TABLET_CONFIG: Optional[TabletConfig] = None


def tablet_config() -> TabletConfig:
    global _TABLET_CONFIG
    if _TABLET_CONFIG is None:
        _TABLET_CONFIG = TabletConfig()
    return _TABLET_CONFIG


def set_tablet_config(config: Optional[TabletConfig]) -> None:
    """Install a process-wide tablet config (None restores defaults)."""
    global _TABLET_CONFIG
    _TABLET_CONFIG = config
