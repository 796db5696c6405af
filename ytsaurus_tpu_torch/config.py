"""Process-wide configuration that the port reads.

An own copy of what the port needs from the JAX package's `config.py`,
as plain dataclasses with the reference's defaults and bounds (the
reference's `YsonStruct` layer and its daemon configs have no
counterpart):

  RetryPolicyConfig  the jittered exponential backoff of the per-shard
                     retry in `query/coordinator.py`, of the
                     replicated chunk read ladder
                     (`chunks/replicated.py`) and of the RPC channels'
                     transport retries with their retry budget
                     (`rpc/channel.py`) (`retry_policy`)
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
  FailpointsConfig   a fault-injection schedule for
                     `utils/failpoints.py::configure`
  ViewsConfig        the materialized views' refresh loop
                     (query/views.py, server/view_daemon.py)
  TracingConfig      the query flight recorder: sampling, the slow-query
                     threshold and the bounded logs (utils/tracing.py,
                     query/profile.py)
  WorkloadConfig     the workload recorder (query/workload.py)
  ServingConfig      the serving gateway (query/serving.py): admission
                     slots and pools, the brown-out ladder, deadlines and
                     lookup micro-batching

  SloConfig          one service-level objective over the telemetry
                     history rings (utils/slo.py); `view_lag_slo` builds
                     the view-freshness one

The daemons' configs are declarative, as the reference's are: a
`YsonStruct` subclass declares `param(...)`s with defaults, types and
bounds; values load from YSON-shaped dicts (bytes keys tolerated), merge
recursively and round-trip through `to_dict`. `RpcConfig`,
`ChunkStoreConfig`, `MasterConfig` and `SchedulerConfig` are such
structs, and `DaemonConfig` nests them with the plain configs above (a
plain config loads from a map of its fields). `DynamicConfigManager`
polls a patch source, validates the merged config and keeps the last
good one.

The reference's CompileConfig knobs for compile caches, AOT artifacts and
buffer donation, and its tiering and sanitizer configs, have no
counterpart: nothing here is compiled, and the port's locks are plain.
"""

from __future__ import annotations

import dataclasses
import random as _random
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.utils.logging import get_logger

logger = get_logger("Config")


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
    common-cause failure.

    Token-bucket retry budget: each retry spends one token, each
    SUCCESSFUL call deposits `retry_budget_refill` tokens (capped at
    `retry_budget`), and a throttled outcome deposits nothing, so an
    overloaded cluster sees its retry traffic decay instead of a retry
    storm. 0 disables the budget."""

    attempts: int = 5
    backoff: float = 0.2
    backoff_cap: float = 3.0
    jitter: float = 0.2
    retry_budget: int = 0
    retry_budget_refill: float = 0.1

    def __post_init__(self):
        _check("attempts", self.attempts, ge=1)
        _check("backoff", self.backoff, ge=0.0)
        _check("backoff_cap", self.backoff_cap, ge=0.0)
        _check("jitter", self.jitter, ge=0.0, le=1.0)
        _check("retry_budget", self.retry_budget, ge=0)
        _check("retry_budget_refill", self.retry_budget_refill, ge=0.0)

    def delay(self, attempt: int, rng=None) -> float:
        base = min(self.backoff * (2 ** attempt), self.backoff_cap)
        if self.jitter <= 0.0 or base <= 0.0:
            return base
        u = (rng or _random).random()
        return base * (1.0 - self.jitter * u)


_RETRY_POLICIES: dict[str, RetryPolicyConfig] = {}
_RETRY_DEFAULTS: dict[str, dict] = {
    # General RPC transport retries (rpc/channel.py::RetryingChannel).
    "rpc": {},
    # Remote job start / poll: fail fast so the job revives on another
    # node.
    "job_rpc": dict(attempts=2, backoff=0.1, backoff_cap=1.0),
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
class SloConfig:
    """One service-level objective over the metrics-history rings
    (utils/profiling.MetricsHistory), alerted on by burn rate
    (utils/slo.SloTracker).

    - `availability` / `ratio`: `good_sensor` / `bad_sensor` counters;
      the SLI over a window is bad / (good + bad) from their deltas.
    - `latency`: a histogram `sensor` and `bound_ms`; observations above
      the tightest bucket bound containing `bound_ms` are the errors.
    - `tags`: subset filter on the series (empty sums every series).

    Burn rate = error_rate / (1 - objective). The alert fires when the
    fast and the slow window both exceed `burn_threshold`, and resolves
    once the fast window recovers."""

    kind: str = "availability"
    sensor: str = ""
    good_sensor: str = ""
    bad_sensor: str = ""
    tags: dict = field(default_factory=dict)
    objective: float = 0.99
    bound_ms: float = 0.0
    fast_window: float = 300.0
    slow_window: float = 3600.0
    burn_threshold: float = 10.0

    def __post_init__(self):
        if self.kind not in ("availability", "ratio", "latency"):
            raise _invalid(f"SLO kind {self.kind!r} not one of "
                           "['availability', 'latency', 'ratio']")
        _check("objective", self.objective, ge=0.0, le=1.0)
        for name in ("bound_ms", "fast_window", "slow_window",
                     "burn_threshold"):
            _check(name, getattr(self, name), ge=0.0)
        self.tags = _str_keys(self.tags)
        if self.kind == "latency":
            if not self.sensor or self.bound_ms <= 0:
                raise _invalid(
                    "latency SLO requires `sensor` (a histogram) and a "
                    "positive `bound_ms`")
        elif not self.good_sensor or not self.bad_sensor:
            raise _invalid(f"{self.kind} SLO requires `good_sensor` and "
                           f"`bad_sensor` counters")


@dataclass
class TelemetryConfig:
    """- `enabled` / `sample_period`: the sampler thread snapshots every
      registered sensor this often into the history rings (0 disables
      sampling; tests drive `sample_once()` with synthetic timestamps).
    - `fine_capacity` / `coarse_every` / `coarse_capacity`: the ring
      tiers (1 h at 10 s plus 24 h at 5 min by default).
    - `slos`: name -> SloConfig (or its map), evaluated after every
      sample.
    - `mesh_telemetry`: stack the mesh telemetry lanes (per-shard rows,
      transfer matrices, quota demand) onto the whole-plan rung's one
      host read, and publish the block.
    - `mesh_max_imbalance`: max-shard / mean-shard output rows above
      which an execution counts as skewed (the MESH_SKEW_SLO's bad
      events)."""

    enabled: bool = True
    sample_period: float = 10.0
    fine_capacity: int = 360
    coarse_every: int = 30
    coarse_capacity: int = 288
    slos: dict = field(default_factory=dict)
    mesh_telemetry: bool = True
    mesh_max_imbalance: float = 4.0

    def __post_init__(self):
        _check("sample_period", self.sample_period, ge=0.0)
        _check("fine_capacity", self.fine_capacity, ge=1)
        _check("coarse_every", self.coarse_every, ge=1)
        _check("coarse_capacity", self.coarse_capacity, ge=1)
        _check("mesh_max_imbalance", self.mesh_max_imbalance, ge=1.0)
        parsed = {}
        for name, spec in _str_keys(self.slos).items():
            if isinstance(spec, dict):
                spec = _dataclass_from_dict(SloConfig, spec, f"slos/{name}")
            elif not isinstance(spec, SloConfig):
                raise _invalid(f"SLO {name!r}: expected map, got {spec!r}")
            parsed[name] = spec
        self.slos = parsed


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
    """Install a process-wide telemetry config (None restores defaults);
    rebuilds the global history rings and SLO tracker to its shape."""
    global _TELEMETRY_CONFIG
    _TELEMETRY_CONFIG = config
    from ytsaurus_tpu_torch.utils import profiling, slo
    # The tracker first: configure_telemetry restarts a running sampler,
    # whose new thread must hook the new tracker's evaluate.
    slo.configure(config)
    profiling.configure_telemetry(config)


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


@dataclass
class FailpointsConfig:
    """A fault-injection schedule (utils/failpoints.py): `spec` in the
    `site=mode[:k=v]...;...` syntax, `seed` fixing the p-based rolls.
    Applied with `failpoints.configure(config)`."""

    spec: str = ""
    seed: int = 0


@dataclass
class ViewsConfig:
    """Materialized-view knobs (query/views.py, server/view_daemon.py):

    - `enable`: the view daemon's refresh loop runs; off pauses every
      view (the committed offsets make resuming lossless).
    - `poll_interval`: the daemon's sleep between passes once every view
      is drained.
    - `default_batch_rows`: the micro-batch of a view created without
      one.
    - `max_batches_per_pass`: batches one view drains in one daemon pass
      (fairness across views; 0 drains to the head).
    - `lag_slo_rows`: the freshness objective each refresh pass votes
      into `/views/lag_ok` or `/views/lag_breach`.
    - `paused`: view names paused by configuration (besides a view's own
      paused state)."""

    enable: bool = True
    poll_interval: float = 0.05
    default_batch_rows: int = 1024
    max_batches_per_pass: int = 64
    lag_slo_rows: int = 65536
    paused: list = field(default_factory=list)

    def __post_init__(self):
        _check("poll_interval", self.poll_interval, ge=0.0)
        _check("default_batch_rows", self.default_batch_rows, ge=1)
        _check("max_batches_per_pass", self.max_batches_per_pass, ge=0)
        _check("lag_slo_rows", self.lag_slo_rows, ge=0)


_VIEWS_CONFIG: Optional[ViewsConfig] = None


def views_config() -> ViewsConfig:
    global _VIEWS_CONFIG
    if _VIEWS_CONFIG is None:
        _VIEWS_CONFIG = ViewsConfig()
    return _VIEWS_CONFIG


def set_views_config(config: Optional[ViewsConfig]) -> None:
    """Install a process-wide views config (None restores defaults)."""
    global _VIEWS_CONFIG
    _VIEWS_CONFIG = config


def view_lag_slo(view: Optional[str] = None, objective: float = 0.99,
                 burn_threshold: float = 10.0, fast_window: float = 300.0,
                 slow_window: float = 3600.0) -> SloConfig:
    """The view-freshness SLO: a ratio SLI over the per-view lag votes
    (`/views/lag_ok` vs `/views/lag_breach`, cast against
    `ViewsConfig.lag_slo_rows` by every refresh pass); `view=None` sums
    every view's series."""
    return SloConfig(
        kind="ratio", good_sensor="/views/lag_ok",
        bad_sensor="/views/lag_breach",
        tags={"view": view} if view else {},
        objective=objective, burn_threshold=burn_threshold,
        fast_window=fast_window, slow_window=slow_window)


@dataclass
class TracingConfig:
    """Query flight recorder knobs (utils/tracing.py + query/profile.py):

    - `enabled`: master switch; False turns every span site into the
      NULL fast path.
    - `sample_rate`: probability a new ROOT trace records its spans
      (entry points: gateway select/lookup, scheduler operations).
      explain_analyze always samples.
    - `slow_query_threshold`: queries at/above this wall time (seconds)
      are ALWAYS retained in the flight recorder's slow-query log;
      faster queries are retained at `sample_rate`.
    - `slow_log_capacity` / `recent_log_capacity`: bounded profile logs.
    - `ring_capacity`: finished-span ring buffer size."""

    enabled: bool = True
    sample_rate: float = 1.0
    slow_query_threshold: float = 0.5
    slow_log_capacity: int = 128
    recent_log_capacity: int = 128
    ring_capacity: int = 4096

    def __post_init__(self):
        _check("sample_rate", self.sample_rate, ge=0.0, le=1.0)
        _check("slow_query_threshold", self.slow_query_threshold, ge=0.0)
        _check("slow_log_capacity", self.slow_log_capacity, ge=1)
        _check("recent_log_capacity", self.recent_log_capacity, ge=1)
        _check("ring_capacity", self.ring_capacity, ge=1)


_TRACING_CONFIG: Optional[TracingConfig] = None


def tracing_config() -> TracingConfig:
    global _TRACING_CONFIG
    if _TRACING_CONFIG is None:
        _TRACING_CONFIG = TracingConfig()
    return _TRACING_CONFIG


def set_tracing_config(config: Optional[TracingConfig]) -> None:
    """Install a process-wide tracing config (None restores defaults);
    pushes the fast-path mirrors into utils/tracing."""
    global _TRACING_CONFIG
    _TRACING_CONFIG = config
    from ytsaurus_tpu_torch.utils import tracing
    tracing.configure(config)


@dataclass
class WorkloadConfig:
    """Workload recorder knobs (query/workload.py):

    - `enabled`: master switch; False turns every observe site into one
      config read.
    - `sample_rate`: probability an admitted query folds a record into
      the workload log.
    - `capacity`: bounded in-memory record ring.
    - `fingerprint_capacity`: bounded per-fingerprint roll-up map; new
      fingerprints past the cap count as dropped.
    - `log_dir`: when set, sampled records ALSO append to a rotated
      on-disk JSONL log (`workload.jsonl`, header line carries the
      schema version) bounded by `rotate_bytes` x `max_files`.
    - `lookup_keys_per_record`: lookup records retain at most this many
      key tuples.

    The reference's compilation-observatory knobs (artifact capture,
    the compile cache's bound) have no counterpart: nothing is
    compiled."""

    enabled: bool = True
    sample_rate: float = 1.0
    capacity: int = 4096
    fingerprint_capacity: int = 1024
    log_dir: Optional[str] = None
    rotate_bytes: int = 4 << 20
    max_files: int = 4
    lookup_keys_per_record: int = 16

    def __post_init__(self):
        _check("sample_rate", self.sample_rate, ge=0.0, le=1.0)
        _check("capacity", self.capacity, ge=1)
        _check("fingerprint_capacity", self.fingerprint_capacity, ge=1)
        _check("rotate_bytes", self.rotate_bytes, ge=4096)
        _check("max_files", self.max_files, ge=1)
        _check("lookup_keys_per_record", self.lookup_keys_per_record, ge=0)


_WORKLOAD_CONFIG: Optional[WorkloadConfig] = None


def workload_config() -> WorkloadConfig:
    global _WORKLOAD_CONFIG
    if _WORKLOAD_CONFIG is None:
        _WORKLOAD_CONFIG = WorkloadConfig()
    return _WORKLOAD_CONFIG


def set_workload_config(config: Optional[WorkloadConfig]) -> None:
    """Install a process-wide workload config (None restores defaults);
    rebinds the global workload log to the new shape."""
    global _WORKLOAD_CONFIG
    _WORKLOAD_CONFIG = config
    from ytsaurus_tpu_torch.query import workload
    workload.configure(config)


def _str_keys(mapping) -> dict:
    """YSON-loaded maps may carry bytes keys; pool names are strings."""
    return {(k.decode("utf-8") if isinstance(k, bytes) else k): v
            for k, v in (mapping or {}).items()}


def _invalid(message: str) -> YtError:
    return YtError(message, code=EErrorCode.InvalidConfig)


@dataclass
class ServingConfig:
    """Query serving plane knobs (query/serving.py QueryGateway):
    admission control (weighted per-pool concurrency slots over a
    bounded wait queue), deadline propagation, and continuous
    micro-batching of lookups.

    - `slots`: total concurrent query slots, shared by every pool under
      fair-share admission (min shares first, then weight-proportional
      water filling capped by live demand).
    - `pools`: pool name -> weight; unknown pools use `default_pool`.
    - `min_shares`: pool -> guaranteed share of `slots` in [0, 1].
    - `pool_limits`: pool -> hard cap on concurrently running queries.
    - Brown-out ladder: rung 0 full execution, rung 1 bounded-staleness
      snapshot-cache reads, rung 2 reject-with-retry_after, driven by
      the estimated queue drain time (total_waiting * hold_ewma /
      slots); rungs step up at once and down one at a time after
      `brownout_min_dwell_seconds` below `threshold *
      brownout_hysteresis`.
    - `staleness_bounds`: pool -> max staleness (seconds) a rung-1 read
      may serve; `default_staleness_seconds` otherwise; 0 opts out.
    - `max_queue`: admitted-but-waiting requests per pool; overflow
      raises ThrottledError.
    - `default_timeout`: deadline when the caller passes none (0 = none).
    - `flush_window_ms` / `max_batch_size`: lookup micro-batching.
    - `min_bucket`: pow2 floor for the batched probe's needle arrays.
    - `max_tablet_fanout`: parallel per-tablet fan-out width."""

    enabled: bool = True
    slots: int = 16
    pools: dict = field(default_factory=lambda: {"default": 1.0})
    default_pool: str = "default"
    min_shares: dict = field(default_factory=dict)
    pool_limits: dict = field(default_factory=dict)
    brownout_enabled: bool = True
    brownout_rung1_seconds: float = 0.5
    brownout_rung2_seconds: float = 2.0
    brownout_hysteresis: float = 0.5
    brownout_min_dwell_seconds: float = 1.0
    staleness_bounds: dict = field(default_factory=dict)
    default_staleness_seconds: float = 5.0
    max_queue: int = 128
    default_timeout: float = 30.0
    flush_window_ms: float = 2.0
    max_batch_size: int = 1024
    min_bucket: int = 8
    max_tablet_fanout: int = 8

    def __post_init__(self):
        _check("slots", self.slots, ge=1)
        for name in ("brownout_rung1_seconds", "brownout_rung2_seconds",
                     "brownout_min_dwell_seconds",
                     "default_staleness_seconds", "default_timeout",
                     "flush_window_ms"):
            _check(name, getattr(self, name), ge=0.0)
        _check("brownout_hysteresis", self.brownout_hysteresis, ge=0.0,
               le=1.0)
        _check("max_queue", self.max_queue, ge=0)
        _check("max_batch_size", self.max_batch_size, ge=1)
        _check("min_bucket", self.min_bucket, ge=1)
        _check("max_tablet_fanout", self.max_tablet_fanout, ge=1)
        self.pools = _str_keys(self.pools)
        for name, weight in self.pools.items():
            if isinstance(weight, bool) or \
                    not isinstance(weight, (int, float)) or weight < 0:
                raise _invalid(
                    f"Serving pool {name!r}: weight must be a "
                    f"non-negative number, got {weight!r}")
        if self.default_pool not in self.pools:
            raise _invalid(
                f"Serving default_pool {self.default_pool!r} is not in "
                f"pools {sorted(self.pools)!r}")
        self.min_shares = _str_keys(self.min_shares)
        for name, ratio in self.min_shares.items():
            if isinstance(ratio, bool) or \
                    not isinstance(ratio, (int, float)) or \
                    not 0.0 <= ratio <= 1.0:
                raise _invalid(
                    f"Serving pool {name!r}: min_share must be in "
                    f"[0, 1], got {ratio!r}")
        if sum(self.min_shares.values()) > 1.0 + 1e-9:
            raise _invalid(
                f"Serving min_shares sum to "
                f"{sum(self.min_shares.values()):.3f} > 1.0 — the "
                f"guarantees are not satisfiable")
        self.pool_limits = _str_keys(self.pool_limits)
        for name, limit in self.pool_limits.items():
            if isinstance(limit, bool) or not isinstance(limit, int) \
                    or limit < 1:
                raise _invalid(
                    f"Serving pool {name!r}: pool_limit must be a "
                    f"positive int, got {limit!r}")
        self.staleness_bounds = _str_keys(self.staleness_bounds)
        for name, bound in self.staleness_bounds.items():
            if isinstance(bound, bool) or \
                    not isinstance(bound, (int, float)) or bound < 0:
                raise _invalid(
                    f"Serving pool {name!r}: staleness bound must be a "
                    f"non-negative number, got {bound!r}")
        if self.brownout_rung2_seconds < self.brownout_rung1_seconds:
            raise _invalid("Serving brownout_rung2_seconds must be >= "
                           "brownout_rung1_seconds")


# ---------------------------------------------------------------------------
# The declarative layer and the daemons' configs.
# ---------------------------------------------------------------------------


def _dataclass_from_dict(cls, data: dict, path: str):
    """A plain config from a map of its fields; unknown keys and values
    its checks refuse raise InvalidConfig naming the path."""
    data = _str_keys(data)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - names)
    if unknown:
        raise _invalid(f"Unrecognized config keys at {path or '/'}: "
                       f"{unknown!r}")
    kwargs = {k: (v.decode("utf-8") if isinstance(v, bytes) else v)
              for k, v in data.items() if v is not None}
    try:
        return cls(**kwargs)
    except YtError as err:
        raise _invalid(f"Config {path}: {err.message}") from err
    except TypeError as err:
        raise _invalid(f"Config {path}: {err}") from err


def _is_struct(kind) -> bool:
    return isinstance(kind, type) and issubclass(kind, YsonStruct)


def _is_plain(kind) -> bool:
    return isinstance(kind, type) and dataclasses.is_dataclass(kind)


class _Param:
    """One declared parameter: default, type, constraints."""

    __slots__ = ("name", "default", "default_factory", "type", "ge", "le",
                 "choices", "validator")

    def __init__(self, default=None, *, default_factory=None, type=None,
                 ge=None, le=None, choices=None, validator=None):
        self.name: str = ""            # filled by __set_name__
        self.default = default
        self.default_factory = default_factory
        self.type = type
        self.ge = ge
        self.le = le
        self.choices = choices
        self.validator = validator

    def __set_name__(self, owner, name):
        self.name = name

    def make_default(self):
        if self.default_factory is not None:
            return self.default_factory()
        if (_is_struct(self.type) or _is_plain(self.type)) \
                and self.default is None:
            return self.type()
        return self.default

    def check(self, value, path: str) -> Any:
        if value is None:
            # An explicit null resets to the default (it must not bypass
            # validation and hand consumers an unexpected None).
            return self.make_default()
        if self.type is not None:
            if _is_struct(self.type) or _is_plain(self.type):
                if isinstance(value, dict):
                    value = self.type.from_dict(value, path=path) \
                        if _is_struct(self.type) \
                        else _dataclass_from_dict(self.type, value, path)
                elif not isinstance(value, self.type):
                    raise _invalid(f"Config {path}: expected map for "
                                   f"{self.type.__name__}, got {value!r}")
            elif self.type is float and isinstance(value, int) \
                    and not isinstance(value, bool):
                value = float(value)
            elif self.type is str and isinstance(value, bytes):
                value = value.decode("utf-8")
            elif not isinstance(value, self.type) \
                    or (self.type is int and isinstance(value, bool)):
                raise _invalid(f"Config {path}: expected "
                               f"{self.type.__name__}, got {value!r}")
        if self.ge is not None and value < self.ge:
            raise _invalid(f"Config {path}: {value!r} < minimum {self.ge!r}")
        if self.le is not None and value > self.le:
            raise _invalid(f"Config {path}: {value!r} > maximum {self.le!r}")
        if self.choices is not None and value not in self.choices:
            raise _invalid(f"Config {path}: {value!r} not one of "
                           f"{sorted(self.choices)!r}")
        if self.validator is not None:
            self.validator(value)
        return value


def param(default=None, **kwargs) -> Any:
    """Declare a config parameter on a YsonStruct subclass."""
    return _Param(default, **kwargs)


class YsonStruct:
    """Base for declarative configs. Subclasses declare parameters:

        class StoreConfig(YsonStruct):
            capacity_bytes = param(1 << 30, type=int, ge=0)
            codec = param("lz4", type=str, choices={"none", "lz4", "zstd"})

    Unknown keys raise; set `keep_unrecognized = True` to keep them
    (in `.unrecognized`)."""

    keep_unrecognized = False
    _params: dict[str, _Param] = {}

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        merged: dict[str, _Param] = dict(cls.__mro__[1]._params) \
            if hasattr(cls.__mro__[1], "_params") else {}
        for name, value in list(vars(cls).items()):
            if isinstance(value, _Param):
                merged[name] = value
        cls._params = merged

    def __init__(self, **overrides):
        self.unrecognized: dict[str, Any] = {}
        for name, p in self._params.items():
            setattr(self, name, p.make_default())
        for name, value in overrides.items():
            if name not in self._params:
                raise _invalid(f"Unknown config parameter {name!r}")
            setattr(self, name, self._params[name].check(value, name))
        self.postprocess()

    def postprocess(self) -> None:
        """Cross-field validation; override in subclasses."""

    @classmethod
    def from_dict(cls, data: dict, path: str = "") -> "YsonStruct":
        self = cls.__new__(cls)
        self.unrecognized = {}
        data = _str_keys(data)
        for name, p in cls._params.items():
            here = f"{path}/{name}" if path else name
            if name in data:
                setattr(self, name, p.check(data.pop(name), here))
            else:
                setattr(self, name, p.make_default())
        if data:
            if cls.keep_unrecognized:
                self.unrecognized = data
            else:
                raise _invalid(f"Unrecognized config keys at {path or '/'}: "
                               f"{sorted(data)!r}")
        self.postprocess()
        return self

    def to_dict(self) -> dict:
        out = {}
        for name in self._params:
            value = getattr(self, name)
            if isinstance(value, YsonStruct):
                value = value.to_dict()
            elif dataclasses.is_dataclass(value):
                value = dataclasses.asdict(value)
            out[name] = value
        out.update(self.unrecognized)
        return out

    def merge(self, patch: Optional[dict]) -> "YsonStruct":
        """Recursive merge into a NEW validated instance; `self` is
        untouched (the dynamic-config manager keeps the old config when
        the merged one fails validation)."""
        return type(self).from_dict(_deep_merge(self.to_dict(), patch or {}))

    def __eq__(self, other):
        return type(other) is type(self) and other.to_dict() == self.to_dict()

    def __repr__(self):
        inner = ", ".join(f"{k}={getattr(self, k)!r}" for k in self._params)
        return f"{type(self).__name__}({inner})"


def _deep_merge(base: dict, patch: dict) -> dict:
    out = dict(base)
    for key, value in patch.items():
        if isinstance(key, bytes):
            key = key.decode("utf-8")
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = value
    return out


class RpcConfig(YsonStruct):
    bind_host = param("127.0.0.1", type=str)
    port = param(0, type=int, ge=0, le=65535)
    max_workers = param(16, type=int, ge=1)
    call_timeout = param(30.0, type=float, ge=0.0)
    retry_attempts = param(2, type=int, ge=1)
    retry_backoff = param(0.1, type=float, ge=0.0)


class ChunkStoreConfig(YsonStruct):
    cache_capacity_bytes = param(1 << 30, type=int, ge=0)
    replication_factor = param(2, type=int, ge=1)
    erasure_codec = param("none", type=str,
                          choices={"none", "rs_6_3", "rs_3_2"})


class MasterConfig(YsonStruct):
    snapshot_every = param(1024, type=int, ge=1)
    journal_nodes = param(2, type=int, ge=0)
    bootstrap_timeout = param(60.0, type=float, ge=0.0)


class SchedulerConfig(YsonStruct):
    fair_share_update_period = param(0.1, type=float, ge=0.0)
    max_running_jobs = param(8, type=int, ge=1)
    speculative_after = param(5.0, type=float, ge=0.0)


class DaemonConfig(YsonStruct):
    """Top-level daemon config (`--config file.yson`). `device` is where
    the primary and scheduler roles run their evaluator, chunk cache and
    operation controllers."""

    role = param("primary", type=str, choices={"primary", "node", "proxy"})
    root = param(None, type=str)
    device = param("cuda", type=str)
    rpc = param(type=RpcConfig)
    chunk_store = param(type=ChunkStoreConfig)
    master = param(type=MasterConfig)
    scheduler = param(type=SchedulerConfig)
    serving = param(type=ServingConfig)
    tablet = param(type=TabletConfig)
    tracing = param(type=TracingConfig)
    telemetry = param(type=TelemetryConfig)
    workload = param(type=WorkloadConfig)
    compile = param(type=CompileConfig)

    def postprocess(self):
        if self.role == "node" and self.chunk_store.replication_factor < 1:
            raise _invalid("node role requires replication_factor >= 1")

    @classmethod
    def load(cls, path: str) -> "DaemonConfig":
        from ytsaurus_tpu_torch import yson
        with open(path, "rb") as f:
            return cls.from_dict(yson.loads(f.read()))


class DynamicConfigManager:
    """Polls a patch source (a Cypress document, as a rule) and applies
    it: fetch, merge onto the base config, validate, fire the
    subscribers on change; a bad patch keeps the last good config and
    shows in `last_error`."""

    def __init__(self, fetch: Callable[[], Optional[dict]],
                 base_config: YsonStruct, period: float = 1.0):
        self._fetch = fetch
        self._base = base_config
        self._period = period
        self._lock = threading.Lock()
        self._current = base_config
        self._last_patch: Optional[dict] = None
        self.last_error: Optional[YtError] = None
        self.update_count = 0
        self._subscribers: list[Callable[[YsonStruct], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def config(self) -> YsonStruct:
        with self._lock:
            return self._current

    def subscribe(self, callback: Callable[[YsonStruct], None]) -> None:
        self._subscribers.append(callback)

    def poll_once(self) -> bool:
        """One fetch + merge + apply cycle; True if the config changed."""
        try:
            patch = self._fetch()
        except Exception as exc:   # noqa: BLE001 — the fetch is an RPC
            # boundary; the poll loop outlives transport errors.
            self.last_error = exc if isinstance(exc, YtError) else \
                YtError(f"dynamic config fetch failed: {exc!r}")
            return False
        if patch == self._last_patch:
            return False
        try:
            new_config = self._base.merge(patch)
        except YtError as exc:
            self.last_error = exc
            logger.warning("rejecting dynamic config patch: %s", exc)
            return False
        self._last_patch = patch
        self.last_error = None
        with self._lock:
            if new_config == self._current:
                return False
            self._current = new_config
        self.update_count += 1
        for callback in self._subscribers:
            try:
                callback(new_config)
            except Exception as exc:   # noqa: BLE001 — subscriber boundary
                logger.error("dynamic config subscriber failed: %r", exc)
        return True

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dynamic-config")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._period):
            self.poll_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
