"""View daemon: the continuous-query refresh loop. Own copy of the JAX
package's `server/view_daemon.py`.

One daemon per cluster tails EVERY registered materialized view
(query/views.py): each pass walks the //sys/views registry, reloads
specs (so `yt view pause` and spec edits take effect between batches),
and drains each running view's ordered-source cursor in micro-batches —
each batch's target upsert and offset commit in one 2PC transaction, so
killing the daemon anywhere (including mid-batch) and starting a new one
resumes from the committed offsets with no loss and no double-apply.

Restart recovery is therefore trivial by construction: the daemon keeps
NO durable state of its own — the consumer table IS the checkpoint (and
the port compiles nothing a fresh daemon would have to rebuild).

Pause/resume arrives two ways, both honored per pass:
  - per-view registry state (`yt view pause|resume` → @view_spec.state);
  - dynamic config (config.ViewsConfig): `paused` names and the global
    `enable` switch — `daemon.apply_config` installs a new one.

The daemon registers itself in a process-wide set; `views_snapshot()`
gives every live daemon's view states (the reference serves it on the
monitoring `/views` endpoint, which waits for the server slice).
"""

from __future__ import annotations

import threading
import weakref
from typing import Optional

from ytsaurus_tpu_torch.config import ViewsConfig, views_config
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.query.views import (
    ViewRefresher,
    list_views,
    load_view,
    view_status,
)
from ytsaurus_tpu_torch.utils.profiling import Profiler
from ytsaurus_tpu_torch.utils import sanitizers

_DAEMONS: "weakref.WeakSet[ViewDaemon]" = weakref.WeakSet()

_passes_counter = Profiler("/views").counter("daemon_passes")


class ViewDaemon:
    """Background refresher over the whole view registry."""

    def __init__(self, client, config: Optional[ViewsConfig] = None,
                 evaluator=None):
        self.client = client
        self._config = config
        self._evaluator = evaluator
        # guards: _refreshers, _stats
        self._lock = sanitizers.register_lock(
            "view_daemon.ViewDaemon._lock")
        self._refreshers: dict[str, ViewRefresher] = {}
        self._stats: dict[str, dict] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.passes = 0
        _DAEMONS.add(self)

    @property
    def config(self) -> ViewsConfig:
        return self._config if self._config is not None \
            else views_config()

    def apply_config(self, config: ViewsConfig) -> None:
        """Dynamic-config subscriber hook: the next pass sees the new
        pause set / enable switch / batching knobs."""
        self._config = config

    # -- one pass --------------------------------------------------------------

    def _refresher(self, name: str) -> ViewRefresher:
        spec = load_view(self.client, name)
        with self._lock:
            current = self._refreshers.get(name)
            if current is not None and \
                    current.spec.query == spec.query and \
                    current.spec.batch_rows == spec.batch_rows:
                current.spec = spec      # pick up state/pool edits
                return current
            refresher = ViewRefresher(self.client, spec,
                                      evaluator=self._evaluator,
                                      config_provider=lambda: self.config)
            self._refreshers[name] = refresher
            return refresher

    def _is_paused(self, name: str, state: str) -> bool:
        """The ONE pause predicate (step AND snapshot share it): the
        dynamic-config master switch, per-view registry state, and the
        dynamic-config pause list."""
        cfg = self.config
        return (not cfg.enable or state == "paused"
                or name in (cfg.paused or []))

    def step(self) -> dict:
        """One pass over the registry: drain every running view (up to
        max_batches_per_pass each).  Per-view errors are recorded and do
        not stop the pass; an InjectedCrash (simulated process death)
        deliberately pierces — a dead daemon doesn't finish its pass."""
        cfg = self.config
        out: dict[str, dict] = {}
        names = list_views(self.client)
        with self._lock:
            for gone in set(self._refreshers) - set(names):
                self._refreshers.pop(gone, None)
        for name in names:
            try:
                refresher = self._refresher(name)
                if self._is_paused(name, refresher.spec.state):
                    out[name] = {"view": name, "paused": True}
                    continue
                report = refresher.refresh(
                    max_batches=cfg.max_batches_per_pass)
                out[name] = report
                self._note(name, report, None)
            except Exception as err:   # noqa: BLE001 — one broken view
                # (bad spec, dropped source, an XLA error escaping the
                # evaluator) must not stop the other views' refreshes;
                # InjectedCrash is a BaseException and still pierces.
                if isinstance(err, YtError) and \
                        err.code == EErrorCode.TransactionLockConflict:
                    # The documented-safe writer race (a manual
                    # `yt view refresh` won the batch): the loser
                    # replays next pass — a conflict, not a failure.
                    out[name] = {"view": name, "conflict": True}
                    continue
                out[name] = {"view": name, "error": str(err)}
                self._note(name, None, err)
        self.passes += 1
        _passes_counter.increment()
        return out

    def _note(self, name: str, report: Optional[dict],
              err: Optional[Exception]) -> None:
        with self._lock:
            stats = self._stats.setdefault(name, {
                "batches": 0, "rows_in": 0, "rows_out": 0,
                "errors": 0, "last_error": None})
            if report is not None:
                stats["batches"] += report["batches"]
                stats["rows_in"] += report["rows_in"]
                stats["rows_out"] += report["rows_out"]
            if err is not None:
                stats["errors"] += 1
                stats["last_error"] = str(err)

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "ViewDaemon":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="view-daemon")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.step()
            except Exception:   # noqa: BLE001 — registry-level hiccup
                # (e.g. a view dropped mid-pass): the loop survives;
                # per-view errors were recorded.  A real crash
                # (InjectedCrash, BaseException) still kills the thread
                # the way process death would.
                pass
            self._stop.wait(self.config.poll_interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- monitoring ------------------------------------------------------------

    def snapshot(self) -> dict:
        cfg = self.config
        views: dict[str, dict] = {}
        for name in list_views(self.client):
            try:
                status = view_status(self.client, name)
            except YtError as err:
                views[name] = {"error": str(err)}
                continue
            with self._lock:
                stats = dict(self._stats.get(name) or {})
            status["daemon"] = stats
            status["paused"] = self._is_paused(name, status["state"])
            views[name] = status
        return {"running": self.running, "passes": self.passes,
                "enable": cfg.enable, "paused": list(cfg.paused or []),
                "poll_interval": cfg.poll_interval, "views": views}


def views_snapshot() -> list:
    """Every live daemon's snapshot (what the reference's /views
    monitoring endpoint and orchid mount serve)."""
    return [daemon.snapshot() for daemon in list(_DAEMONS)]
