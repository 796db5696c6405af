"""The `yt` command-line interface.

Ref shape: yt/python/yt/wrapper/cli_impl.py — one binary, subcommand per
driver command, `--proxy` (or YT_PROXY env) selects the cluster, table
data flows through stdin/stdout in wire formats.

Usage (python -m ytsaurus_tpu_torch.cli):

  yt --proxy 127.0.0.1:9013 list /
  yt create map_node //home/me -r
  yt write-table //t --format json   < rows.json
  yt read-table //t --format dsv
  yt select-rows 'k, sum(v) AS s FROM [//t] GROUP BY k'
  yt map 'grep foo' --src //in --dst //out
  yt sort --src //in --dst //out --sort-by k
  yt start-tx / commit-tx / lock ...

The proxy address is the PRIMARY RPC endpoint (the thin-client plane);
`--user` stamps the authenticated principal.

Own copy of the JAX package's `cli.py`, over the port's
`remote_client.RemoteYtClient`. The reference pins its CLI to the CPU;
here `--device` (default cuda; `YT_CLI_PLATFORM=cpu` or `--device cpu`
asks for the CPU) is where the thin client decodes chunks and runs its
operation controllers. It is resolved at start: without a card the CLI
exits non-zero naming the device. The CUDA context opens only when a
command's work reaches the device (`yt list /` opens none).

`yt prewarm` and `yt compile-cache top` exit 1 naming themselves as not
applicable in the port: nothing is compiled, so there are no
executables to warm and no compile cache to rank. `yt analyze` runs the
repo's `tools/analyze` passes over the port's own tree and reports raw
findings: the committed baseline counts the JAX package's findings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from ytsaurus_tpu_torch.errors import EErrorCode, YtError


def _json_default(value):
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    return str(value)


def _print(value) -> None:
    if value is None:
        return
    if isinstance(value, bytes):
        sys.stdout.buffer.write(value)
        if not value.endswith(b"\n"):
            sys.stdout.buffer.write(b"\n")
        return
    print(json.dumps(value, default=_json_default, indent=2))


def _rows_arg(rows: Optional[str]):
    blob = rows.encode() if rows else sys.stdin.buffer.read()
    return blob


def _decode_deep(value):
    """Bytes → str recursively (orchid values round-tripped through the
    YSON wire carry byte strings)."""
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    if isinstance(value, dict):
        return {_decode_deep(k): _decode_deep(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_decode_deep(v) for v in value]
    return value


def _fetch_trace(cl, trace_id: str):
    """Span tree of one trace: the remote orchid (`/tracing/traces/<id>`
    — what the monitoring /traces endpoint also renders) when the client
    has one, else this process's own collector."""
    tree = None
    if hasattr(cl, "get_orchid"):
        try:
            tree = cl.get_orchid(f"/tracing/traces/{trace_id}")
        except YtError:
            tree = None
    if not tree:
        from ytsaurus_tpu_torch.utils.tracing import span_tree
        tree = span_tree(trace_id)
    return _decode_deep(tree) if tree else None


def _fetch_accounting(cl) -> dict:
    """The /accounting snapshot: the remote orchid when the client has
    one (daemon-side usage), else this process's own accountant.  A
    FAILING remote read propagates — silently falling back to this
    short-lived process's empty accountant would print an all-zero
    table and read as "cluster idle" when the daemon is broken."""
    if hasattr(cl, "get_orchid"):
        return _decode_deep(cl.get_orchid("/accounting") or {})
    from ytsaurus_tpu_torch.query.accounting import get_accountant
    return get_accountant().snapshot()


# The `yt top` table columns (a readable subset of USAGE_FIELDS).
_TOP_COLUMNS = ("queries", "lookups", "rows_read", "bytes_read",
                "compile_seconds", "execute_seconds", "wall_seconds",
                "throttled", "jobs")

# Fair-share columns appended when --by pool: the admission
# controller's live allocation next to the historical usage — share is
# the pool's fair allocation in slots, use its running queries, demand
# running + queued.  demand >> share is the "who is being squeezed"
# signal the brown-out ladder and the SLO bench act on.
_FAIR_COLUMNS = ("share", "use", "demand")


def _serving_pool_rollup(gateways: list) -> dict:
    """Aggregate per-pool fair-share state across the live gateways."""
    rollup: dict = {}
    for gw in gateways or []:
        admission = (gw or {}).get("admission") or {}
        for name, pool in (admission.get("pools") or {}).items():
            agg = rollup.setdefault(
                name, {"share": 0.0, "use": 0, "demand": 0})
            agg["share"] += float(pool.get("fair_slots", 0.0))
            agg["use"] += int(pool.get("in_flight", 0))
            agg["demand"] += int(pool.get("demand",
                                          pool.get("in_flight", 0) +
                                          pool.get("waiting", 0)))
    return rollup


def _format_top(snapshot: dict, by: str, sort_key: str,
                limit: int, serving: Optional[dict] = None) -> str:
    """`yt top --by pool`: per-tenant resource usage, heaviest first —
    the serving-plane answer to "who is eating the cluster"."""
    rollup = dict(snapshot.get(f"by_{by}") or {})
    fair = _serving_pool_rollup((serving or {}).get("gateways")) \
        if by == "pool" else {}
    # A pool can be queued (demand) before any query of it finishes
    # (usage) — fair-share-only pools still get a row.
    for name in fair:
        rollup.setdefault(name, {})
    rows = sorted(rollup.items(),
                  key=lambda kv: -float(kv[1].get(sort_key, 0.0)))
    if limit > 0:
        rows = rows[:limit]
    totals = snapshot.get("totals") or {}

    def fmt(record, field):
        value = float(record.get(field, 0.0))
        if field.endswith("_seconds"):
            return f"{value:.3f}"
        if field == "bytes_read":
            return f"{value / 1e6:.1f}MB" if value >= 1e6 \
                else f"{value:.0f}"
        return f"{value:.0f}"

    def fair_cells(name):
        if not fair:
            return []
        pool = fair.get(name)
        if pool is None:
            return ["-"] * len(_FAIR_COLUMNS)
        return [f"{pool['share']:.2f}", f"{pool['use']:.0f}",
                f"{pool['demand']:.0f}"]

    fair_header = list(_FAIR_COLUMNS) if fair else []
    header = [by, *_TOP_COLUMNS, *fair_header]
    table = [[name, *[fmt(record, f) for f in _TOP_COLUMNS],
              *fair_cells(name)]
             for name, record in rows]
    fair_totals = []
    if fair:
        fair_totals = [
            f"{sum(p['share'] for p in fair.values()):.2f}",
            f"{sum(p['use'] for p in fair.values()):.0f}",
            f"{sum(p['demand'] for p in fair.values()):.0f}"]
    table.append(["TOTAL", *[fmt(totals, f) for f in _TOP_COLUMNS],
                  *fair_totals])
    widths = [max(len(str(row[i])) for row in [header, *table])
              for i in range(len(header))]
    lines = ["  ".join(str(cell).rjust(width)
                       for cell, width in zip(row, widths))
             for row in [header, *table]]
    return "\n".join(lines)


def _fetch_serving(cl) -> dict:
    """The /serving snapshot (fair-share admission state) for the
    `yt top --by pool` share/use/demand columns.  Best-effort: a
    cluster without a serving plane just drops the columns — usage
    history still renders."""
    try:
        if hasattr(cl, "get_orchid"):
            return _decode_deep(cl.get_orchid("/serving") or {})
        from ytsaurus_tpu_torch.query.serving import serving_snapshot
        return {"gateways": serving_snapshot()}
    except Exception:   # noqa: BLE001 — the fair-share columns are an
        # overlay on the usage table, not the table itself.
        return {}


def _fetch_workload(cl) -> dict:
    """The /workload snapshot: remote orchid when the client has one,
    else this process's own workload log (same propagate-don't-mask
    policy as `yt top`)."""
    if hasattr(cl, "get_orchid"):
        return _decode_deep(cl.get_orchid("/workload") or {})
    from ytsaurus_tpu_torch.query.workload import get_workload_log
    return get_workload_log().snapshot()


def _fetch_mesh(cl) -> dict:
    """The /mesh snapshot (mesh execution observatory)."""
    if hasattr(cl, "get_orchid"):
        return _decode_deep(cl.get_orchid("/mesh") or {})
    from ytsaurus_tpu_torch.parallel.mesh_observatory import (
        get_mesh_observatory,
    )
    return get_mesh_observatory().snapshot()


def _format_table(header: list, rows: list) -> str:
    table = [header, *rows]
    widths = [max(len(str(row[i])) for row in table)
              for i in range(len(header))]
    return "\n".join("  ".join(str(cell).rjust(width)
                               for cell, width in zip(row, widths))
                     for row in table)


_MESH_TOP_SORT = {"skew": "skew_max", "bytes": "exchange_bytes",
                  "memory": "memory_watermark_bytes"}

_MESH_TOP_COLUMNS = ("path", "shards", "executions", "skew_max",
                     "exchange_bytes", "quota_headroom",
                     "memory_watermark_bytes", "drift_max", "skewed")


def _format_mesh_top(snapshot: dict, sort_key: str, limit: int) -> str:
    """`yt mesh top`: SPMD program fingerprints ranked by shard skew /
    exchange bytes / memory watermark — the observability answer to
    "which program is hot and where"."""
    field = _MESH_TOP_SORT.get(sort_key, sort_key)
    rows = list(snapshot.get("programs") or [])
    rows.sort(key=lambda r: -float(r.get(field) or 0.0))
    if limit > 0:
        rows = rows[:limit]

    def fmt(record, col):
        value = record.get(col)
        if col == "path":
            return str(value or "-")
        if col in ("skew_max", "quota_headroom", "drift_max"):
            return f"{float(value or 0.0):.3f}"
        return f"{int(value or 0)}"

    body = [[r.get("fingerprint", "?"),
             *[fmt(r, col) for col in _MESH_TOP_COLUMNS]] for r in rows]
    totals = snapshot.get("totals") or {}
    lines = [_format_table(["fingerprint", *_MESH_TOP_COLUMNS], body)]
    lines.append(
        f"totals: {int(totals.get('executions', 0))} executions "
        f"({int(totals.get('balanced', 0))} balanced / "
        f"{int(totals.get('skewed', 0))} skewed) over "
        f"{int(totals.get('programs', 0))} programs, "
        f"{int(totals.get('compiled', 0))} compile captures")
    return "\n".join(lines)


def _format_replay_report(report: dict) -> str:
    lat = report.get("latency") or {}
    lines = [
        f"replayed {report.get('queries', 0)} queries in "
        f"{report.get('elapsed_seconds', 0.0):.3f}s "
        f"(offered {report.get('offered_rate') or 'max'}/s, achieved "
        f"{report.get('achieved_rate')}/s)",
        f"outcomes: {report.get('ok', 0)} ok, "
        f"{report.get('throttled', 0)} throttled, "
        f"{report.get('deadline', 0)} deadline, "
        f"{report.get('error', 0)} error",
        f"latency: p50 {lat.get('p50_ms', 0)}ms  p99 "
        f"{lat.get('p99_ms', 0)}ms  p999 {lat.get('p999_ms', 0)}ms  "
        f"max {lat.get('max_ms', 0)}ms",
    ]
    slowest = report.get("slowest") or []
    if slowest:
        lines.append("slowest (trace ids -> /traces or `yt trace`):")
        for entry in slowest:
            lines.append(
                f"  {entry.get('wall_ms', 0)}ms  "
                f"trace={entry.get('trace_id') or '<unsampled>'}  "
                f"[{entry.get('outcome')}] {entry.get('query')}")
    return "\n".join(lines)


def _format_profile(profile) -> str:
    """ExecutionProfile object (in-process client) OR its dict form
    (remote client / HTTP proxy) → the pretty EXPLAIN ANALYZE text, via
    the one shared renderer in query/profile.py."""
    if hasattr(profile, "format"):
        return profile.format()
    from ytsaurus_tpu_torch.query.profile import format_profile_dict
    return format_profile_dict(_decode_deep(dict(profile)))


_ANALYZE_HELP = ("tools/analyze over ytsaurus_tpu_torch/; it reports raw "
                 "findings, as the reference's --no-baseline does (the "
                 "committed baseline counts the JAX package's findings)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="yt")
    parser.add_argument("--proxy", default=os.environ.get("YT_PROXY"),
                        help="primary address host:port (env YT_PROXY)")
    parser.add_argument("--user", default=os.environ.get("YT_USER", "root"))
    parser.add_argument("--device", default=_default_device(),
                        help="where the thin client decodes chunks and "
                             "runs its operation controllers: cuda "
                             "(default) or cpu (env YT_CLI_PLATFORM=cpu)")
    sub = parser.add_subparsers(dest="subcommand", required=True)

    def cmd(name, *args_defs, **kw):
        p = sub.add_parser(name, **kw)
        for flags, opts in args_defs:
            p.add_argument(*flags, **opts)
        return p

    cmd("list", (("path",), {"nargs": "?", "default": "/"}))
    cmd("get", (("path",), {}))
    cmd("set", (("path",), {}), (("value",), {}))
    cmd("exists", (("path",), {}))
    cmd("create", (("type",), {}), (("path",), {}),
        (("-r", "--recursive"), {"action": "store_true"}),
        (("-i", "--ignore-existing"), {"action": "store_true"}),
        (("--attributes",), {"default": None}))
    cmd("remove", (("path",), {}),
        (("-f", "--force"), {"action": "store_true"}))
    cmd("copy", (("src",), {}), (("dst",), {}),
        (("-r", "--recursive"), {"action": "store_true"}))
    cmd("move", (("src",), {}), (("dst",), {}),
        (("-r", "--recursive"), {"action": "store_true"}))
    cmd("link", (("target",), {}), (("link",), {}))
    cmd("write-table", (("path",), {}),
        (("--format",), {"default": "json"}),
        (("--append",), {"action": "store_true"}),
        (("--rows",), {"default": None, "help": "inline rows (else stdin)"}))
    cmd("read-table", (("path",), {}), (("--format",), {"default": "json"}))
    cmd("select-rows", (("query",), {}),
        (("--explain-analyze",), {"action": "store_true",
                                  "help": "print the per-query "
                                          "ExecutionProfile (wall/"
                                          "compile/execute split + span "
                                          "tree) instead of rows"}),
        (("--param",), {"action": "append", "default": None,
                        "dest": "params",
                        "help": "bind the next `?` placeholder (JSON "
                                "value; a JSON list binds a query "
                                "vector); repeat per placeholder"}))
    cmd("nearest-rows", (("path",), {}), (("column",), {}),
        (("query_vector",), {"help": "JSON list of floats"}),
        (("k",), {"type": int}),
        (("--metric",), {"default": "l2",
                         "choices": ["l2", "cosine", "dot"]}))
    cmd("trace", (("trace_id",), {}),
        (("--json",), {"action": "store_true",
                       "help": "raw span tree instead of the pretty "
                               "rendering"}))
    cmd("top", (("--by",), {"default": "pool",
                            "choices": ["pool", "user"],
                            "help": "roll resource usage up by pool "
                                    "(default) or user"}),
        (("--sort",), {"default": "wall_seconds",
                       "help": "usage column to sort by (descending); "
                               "e.g. rows_read, bytes_read, queries"}),
        (("--limit",), {"type": int, "default": 20}),
        (("--json",), {"action": "store_true",
                       "help": "raw accounting snapshot instead of the "
                               "table"}))
    cmd("workload", (("action",), {"choices": ["capture", "export",
                                               "import", "show"],
                                   "help": "capture: pull the cluster's "
                                           "workload log into --out; "
                                           "export: this process's log; "
                                           "import: load a capture into "
                                           "the local log; show: "
                                           "fingerprint roll-up"}),
        (("--out",), {"default": None,
                      "help": "capture file to write (capture/export)"}),
        (("--file",), {"default": None,
                       "help": "capture file to read (import)"}),
        (("--limit",), {"type": int, "default": 0,
                        "help": "cap records written/shown (0 = all "
                                "retained)"}),
        (("--json",), {"action": "store_true"}))
    cmd("replay", (("--capture",), {"required": True,
                                    "help": "versioned workload capture "
                                            "(yt workload capture/"
                                            "export)"}),
        (("--speed",), {"type": float, "default": 1.0,
                        "help": "time-compression of the recorded "
                                "inter-arrival spacing"}),
        (("--rate",), {"type": float, "default": None,
                       "help": "fixed open-loop offered rate (qps); "
                               "overrides recorded spacing"}),
        (("--limit",), {"type": int, "default": 0,
                        "help": "replay only the first N records"}),
        (("--workers",), {"type": int, "default": 16}),
        (("--pool",), {"default": None}),
        (("--timeout",), {"type": float, "default": None}),
        (("--json",), {"action": "store_true",
                       "help": "raw report instead of the pretty "
                               "rendering"}))
    cmd("prewarm", (("--capture",), {"required": True,
                                     "help": "not applicable in the "
                                             "port: nothing is compiled, "
                                             "so a capture has no "
                                             "programs to warm (exits "
                                             "1)"}),
        (("--limit",), {"type": int, "default": 0,
                        "help": "prewarm only the first N select "
                                "records (0 = all)"}),
        (("--json",), {"action": "store_true"}))
    cmd("analyze",
        # No `choices` here: the pass registry lives in tools/analyze
        # (PASSES); the driver validates, so a new pass needs no CLI
        # lockstep edit.
        (("--pass",), {"dest": "passes", "action": "append",
                       "default": None,
                       "help": "run only this pass (repeatable; "
                               "default: all — locks, guards, jax, "
                               "coverage, errors, sensors)"}),
        (("--json",), {"action": "store_true",
                       "help": "machine-readable findings (pass, rule, "
                               "path, line, message, severity) + "
                               "lock-order graph + the guards "
                               "reconciliation graph (inferred locks, "
                               "superset edges, sanitizer site map)"}),
        (("--analyze-root",), {"default": None,
                               "help": "repo root to analyze (default: "
                                       "the checkout this package lies "
                                       "in)"}),
        help=_ANALYZE_HELP, description=_ANALYZE_HELP)
    cmd("view", (("action",), {"choices": ["create", "list", "show",
                                           "pause", "resume", "remove",
                                           "refresh"],
                               "help": "continuous queries: "
                                       "create registers an incremental "
                                       "materialized view over an "
                                       "ordered table; list/show read "
                                       "the registry + lag/freshness; "
                                       "pause/resume gate the daemon; "
                                       "refresh drains the cursor "
                                       "inline"}),
        (("name",), {"nargs": "?", "default": None}),
        (("--query",), {"default": None,
                        "help": "view QL (create), e.g. 'g, sum(v) AS "
                                "s FROM [//q] GROUP BY g'"}),
        (("--source",), {"default": None,
                         "help": "ordered source table (defaults to "
                                 "the query's FROM table)"}),
        (("--target",), {"default": None,
                         "help": "sorted target table (default: "
                                 "//sys/views/<name>/target)"}),
        (("--pool",), {"default": "views",
                       "help": "resource pool the refresh work is "
                               "accounted under"}),
        (("--batch-rows",), {"type": int, "default": None}),
        (("--max-batches",), {"type": int, "default": 0,
                              "help": "refresh: cap drained batches "
                                      "(0 = to the head)"}),
        (("--drop-target",), {"action": "store_true",
                              "help": "remove: also drop the target "
                                      "table"}),
        (("--json",), {"action": "store_true"}))
    cmd("compile-cache", (("action",), {"choices": ["top"],
                                        "help": "not applicable in the "
                                                "port: nothing is "
                                                "compiled (exits 1)"}),
        (("--limit",), {"type": int, "default": 20}),
        (("--sort",), {"default": "compile_seconds",
                       "help": "observatory column to rank by "
                               "(descending); e.g. compiles, "
                               "shape_count, evictions"}),
        (("--json",), {"action": "store_true"}))
    cmd("mesh", (("action",), {"choices": ["top"]}),
        (("--limit",), {"type": int, "default": 20}),
        (("--sort",), {"default": "skew",
                       "help": "rank programs by skew | bytes | memory "
                               "(or any roll-up column, e.g. "
                               "executions, drift_max)"}),
        (("--json",), {"action": "store_true"}))
    cmd("insert-rows", (("path",), {}),
        (("--rows",), {"default": None}))
    cmd("lookup-rows", (("path",), {}), (("--keys",), {"required": True}))
    cmd("mount-table", (("path",), {}))
    cmd("unmount-table", (("path",), {}))
    cmd("map", (("mapper_command",), {}),
        (("--src",), {"required": True}), (("--dst",), {"required": True}),
        (("--format",), {"default": "json"}),
        (("--pool",), {"default": "default"}),
        (("--job-count",), {"type": int, "default": None}))
    cmd("sort", (("--src",), {"required": True}),
        (("--dst",), {"required": True}),
        (("--sort-by",), {"required": True,
                          "help": "comma-separated key columns"}))
    cmd("reduce", (("reducer_command",), {}),
        (("--src",), {"required": True}), (("--dst",), {"required": True}),
        (("--reduce-by",), {"required": True,
                            "help": "comma-separated key columns"}),
        (("--sort-by",), {"default": None}),
        (("--format",), {"default": "json"}),
        (("--job-count",), {"type": int, "default": None}))
    cmd("map-reduce", (("reducer_command",), {}),
        (("--mapper-command",), {"default": None}),
        (("--src",), {"required": True}), (("--dst",), {"required": True}),
        (("--reduce-by",), {"required": True}),
        (("--sort-by",), {"default": None}),
        (("--partition-count",), {"type": int, "default": None}),
        (("--format",), {"default": "json"}))
    cmd("merge", (("--src",), {"required": True,
                               "help": "comma-separated input tables"}),
        (("--dst",), {"required": True}),
        (("--mode",), {"default": "unordered"}))
    cmd("erase", (("path",), {}))
    cmd("vanilla", (("--tasks",), {"required": True,
                                   "help": "JSON: {name: {job_count, "
                                           "command}}"}),
        (("--max-gang-restarts",), {"type": int, "default": 2}))
    cmd("remote-copy", (("--cluster",), {"required": True,
                                         "help": "source cluster "
                                                 "host:port"}),
        (("--src",), {"required": True}), (("--dst",), {"required": True}))
    cmd("abort-op", (("op_id",), {}))
    cmd("start-tx")
    cmd("commit-tx", (("tx",), {}))
    cmd("abort-tx", (("tx",), {}))
    cmd("lock", (("path",), {}), (("--tx",), {"required": True}),
        (("--mode",), {"default": "exclusive"}))
    cmd("create-user", (("name",), {}))
    cmd("create-account", (("name",), {}))
    cmd("check-permission", (("user",), {}), (("permission",), {}),
        (("path",), {}))
    cmd("get-operation", (("op_id",), {}))
    cmd("orchid", (("path",), {"nargs": "?", "default": "/"}))
    return parser


def _default_device() -> str:
    """`--device`'s default: the CPU when YT_CLI_PLATFORM asks for it,
    else the card."""
    platform = os.environ.get("YT_CLI_PLATFORM", "")
    if platform in ("", "cuda", "gpu"):
        return "cuda"
    return platform


def _resolve_cli_device(name: str):
    """`--device` as a torch.device, checked at start: a CUDA device
    without a card raises a YtError naming it. Opens no CUDA context."""
    import torch
    from ytsaurus_tpu_torch.device import resolve_device
    try:
        dev = torch.device(name)
    except RuntimeError as err:
        raise YtError(f"yt: bad --device {name!r}: {err}",
                      code=EErrorCode.InvalidConfig)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise YtError(
                f"yt: device {name!r} was asked for but no CUDA device is "
                "present; pass --device cpu (or YT_CLI_PLATFORM=cpu)",
                code=EErrorCode.InvalidConfig)
        if dev.index is None:
            # An explicit index: resolving it reads no current device,
            # so no context opens before a command's work needs one.
            dev = torch.device("cuda", 0)
    return resolve_device(dev)


def _run_analyze(a) -> int:
    """`yt analyze`: the repo's static-analysis suite (tools/analyze) over
    the port's own tree, run OFFLINE: no proxy, no cluster, no device.
    The analyzer is loaded from the repo checkout next to this package.
    It reports raw findings (the reference's --no-baseline reading): the
    committed baseline counts the JAX package's findings, not the
    port's. Exit 0 when there are none, 1 when there are."""
    repo = a.analyze_root or os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    if not os.path.exists(os.path.join(repo, "tools", "analyze",
                                       "__init__.py")):
        print(f"error: analyzer not found under {repo}/tools/analyze "
              "(run from a repo checkout, or pass --analyze-root)",
              file=sys.stderr)
        return 2
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from tools import analyze
    from tools.analyze import guard_inference, lock_discipline
    if a.passes:
        unknown = [n for n in a.passes if n not in analyze.PASSES]
        if unknown:
            print(f"error: unknown pass(es) {unknown}; available: "
                  f"{sorted(analyze.PASSES)}", file=sys.stderr)
            return 2
    files = analyze.load_files(repo, package=_PACKAGE)
    findings = analyze.run_passes(files, only=a.passes, root=repo)
    violations = [f.format() for f in findings]
    if a.json:
        payload = {
            "package": _PACKAGE,
            "findings": [f.to_dict() for f in findings],
            "violations": violations,
            "counts": analyze.aggregate(findings),
            "lock_order": lock_discipline.order_graph_snapshot(files),
            "clean": not violations,
        }
        if a.passes is None or "guards" in a.passes:
            payload["reconciliation"] = \
                guard_inference.reconciliation_graph(files)
        print(json.dumps(payload, indent=2, default=_json_default))
        return 1 if violations else 0
    for violation in violations:
        print(violation, file=sys.stderr)
    if violations:
        print(f"{len(violations)} static-analysis finding(s) over "
              f"{_PACKAGE}/ (raw: the committed baseline counts the JAX "
              "package's findings)", file=sys.stderr)
        return 1
    print(f"static analysis clean over {_PACKAGE}/")
    return 0


_PACKAGE = "ytsaurus_tpu_torch"

# Subcommands that run locally, without a cluster connection.
_OFFLINE_COMMANDS = {"analyze"}


def run(argv: "list[str] | None" = None,
        client=None) -> int:
    args = build_parser().parse_args(argv)
    if args.subcommand in _OFFLINE_COMMANDS:
        return _run_analyze(args)
    caller_owns_client = client is not None
    if client is None:
        if not args.proxy:
            print("error: --proxy (or YT_PROXY) is required",
                  file=sys.stderr)
            return 2
        # The device first: without a card the CLI exits naming it,
        # never carrying on on the CPU.
        from ytsaurus_tpu_torch.remote_client import RemoteYtClient
        try:
            device = _resolve_cli_device(args.device)
        except YtError as err:
            print(json.dumps(err.to_dict(), default=_json_default),
                  file=sys.stderr)
            return 1
        client = RemoteYtClient(args.proxy, user=args.user, device=device)
    try:
        _print(_dispatch(client, args))
        return 0
    except YtError as err:
        print(json.dumps(err.to_dict(), default=_json_default),
              file=sys.stderr)
        return 1
    finally:
        if not caller_owns_client and hasattr(client, "close"):
            client.close()


def _dispatch(cl, a):
    c = a.subcommand
    if c == "list":
        return cl.list(a.path)
    if c == "get":
        return cl.get(a.path)
    if c == "set":
        return cl.set(a.path, json.loads(a.value))
    if c == "exists":
        return cl.exists(a.path)
    if c == "create":
        attributes = json.loads(a.attributes) if a.attributes else None
        return cl.create(a.type, a.path, attributes=attributes,
                         recursive=a.recursive,
                         ignore_existing=a.ignore_existing)
    if c == "remove":
        return cl.remove(a.path, force=a.force)
    if c == "copy":
        return cl.copy(a.src, a.dst, recursive=a.recursive)
    if c == "move":
        return cl.move(a.src, a.dst, recursive=a.recursive)
    if c == "link":
        return cl.link(a.target, a.link)
    if c == "write-table":
        return cl.write_table(a.path, _rows_arg(a.rows), format=a.format,
                              append=a.append)
    if c == "read-table":
        return cl.read_table(a.path, format=a.format)
    if c == "select-rows":
        params = [json.loads(p) for p in a.params] if a.params else None
        if a.explain_analyze:
            profile = cl.select_rows(a.query, explain_analyze=True,
                                     params=params)
            print(_format_profile(profile))
            return None
        return cl.select_rows(a.query, params=params)
    if c == "nearest-rows":
        return cl.nearest_rows(a.path, a.column,
                               json.loads(a.query_vector), a.k,
                               metric=a.metric)
    if c == "trace":
        tree = _fetch_trace(cl, a.trace_id)
        if not tree:
            raise YtError(f"no such trace {a.trace_id!r} "
                          "(unsampled, evicted, or wrong cluster)")
        if a.json:
            return tree
        from ytsaurus_tpu_torch.query.profile import format_span_tree
        print(f"trace {a.trace_id}")
        print("\n".join(format_span_tree(tree)))
        return None
    if c == "top":
        snapshot = _fetch_accounting(cl)
        serving = _fetch_serving(cl) if a.by == "pool" else None
        if a.json:
            if serving:
                snapshot = dict(snapshot)
                snapshot["serving"] = serving
            return snapshot
        print(_format_top(snapshot, a.by, a.sort, a.limit, serving))
        return None
    if c == "workload":
        from ytsaurus_tpu_torch.query import workload as wl
        if a.action in ("capture", "export"):
            if not a.out:
                raise YtError("workload capture/export requires --out")
            if a.action == "capture":
                snapshot = _fetch_workload(cl)
                records = [wl.WorkloadRecord.from_dict(r)
                           for r in snapshot.get("records") or []]
            else:
                records = wl.get_workload_log().records()
            written = wl.write_capture(a.out, records,
                                       limit=a.limit or None)
            return {"written": written, "path": a.out}
        if a.action == "import":
            if not a.file:
                raise YtError("workload import requires --file")
            return {"imported":
                    wl.get_workload_log().import_capture(a.file)}
        snapshot = _fetch_workload(cl)            # show
        if a.json:
            return snapshot
        rows = snapshot.get("fingerprints") or []
        if a.limit:
            rows = rows[:a.limit]
        print(_format_table(
            ["fingerprint", "kind", "count", "ok", "throttled",
             "deadline", "errors", "wall_s", "compile_s", "query"],
            [[r.get("fingerprint"), r.get("kind"), r.get("count"),
              r.get("ok"), r.get("throttled"), r.get("deadline"),
              r.get("errors"),
              f"{float(r.get('wall_seconds') or 0):.3f}",
              f"{float(r.get('compile_seconds') or 0):.3f}",
              str(r.get("query"))[:60]] for r in rows]))
        return None
    if c == "replay":
        from ytsaurus_tpu_torch.query import workload as wl
        records = wl.load_capture(a.capture)   # fails loudly on version
        report = wl.replay(cl, records, speed=a.speed, rate=a.rate,
                           max_workers=a.workers, pool=a.pool,
                           timeout=a.timeout, limit=a.limit or None)
        if a.json:
            return report
        print(_format_replay_report(report))
        return None
    if c in ("prewarm", "compile-cache"):
        # Recorded as not applicable: the port runs eagerly and compiles
        # no executables, so there is nothing to prewarm and no compile
        # cache to rank.
        verb = "prewarm" if c == "prewarm" else f"compile-cache {a.action}"
        raise YtError(f"yt {verb} is not applicable in the port: nothing "
                      "is compiled (no XLA executables, no compile cache)",
                      code=EErrorCode.InvalidConfig)
    if c == "view":
        return _dispatch_view(cl, a)
    if c == "mesh":
        snapshot = _fetch_mesh(cl)
        if a.json:
            return snapshot
        print(_format_mesh_top(snapshot, a.sort, a.limit))
        return None
    if c == "insert-rows":
        rows = json.loads(_rows_arg(a.rows))
        return cl.insert_rows(a.path, rows)
    if c == "lookup-rows":
        keys = [tuple(k) for k in json.loads(a.keys)]
        return cl.lookup_rows(a.path, keys)
    if c == "mount-table":
        return cl.mount_table(a.path)
    if c == "unmount-table":
        return cl.unmount_table(a.path)
    if c == "map":
        kw = {"format": a.format, "pool": a.pool}
        if a.job_count:
            kw["job_count"] = a.job_count
        op = cl.run_map(a.mapper_command, a.src, a.dst, **kw)
        return {"operation_id": op.id, "state": op.state}
    if c == "sort":
        op = cl.run_sort(a.src, a.dst, a.sort_by.split(","))
        return {"operation_id": op.id, "state": op.state}
    if c == "reduce":
        kw = {"format": a.format}
        if a.sort_by:
            kw["sort_by"] = a.sort_by.split(",")
        if a.job_count:
            kw["job_count"] = a.job_count
        op = cl.run_reduce(a.reducer_command, a.src, a.dst,
                           reduce_by=a.reduce_by.split(","), **kw)
        return {"operation_id": op.id, "state": op.state}
    if c == "map-reduce":
        kw = {"format": a.format}
        if a.sort_by:
            kw["sort_by"] = a.sort_by.split(",")
        if a.partition_count:
            kw["partition_count"] = a.partition_count
        op = cl.run_map_reduce(a.mapper_command, a.reducer_command,
                               a.src, a.dst,
                               reduce_by=a.reduce_by.split(","), **kw)
        return {"operation_id": op.id, "state": op.state}
    if c == "merge":
        op = cl.run_merge(a.src.split(","), a.dst, mode=a.mode)
        return {"operation_id": op.id, "state": op.state}
    if c == "erase":
        op = cl.run_erase(a.path)
        return {"operation_id": op.id, "state": op.state}
    if c == "vanilla":
        op = cl.run_vanilla(json.loads(a.tasks),
                            max_gang_restarts=a.max_gang_restarts)
        return {"operation_id": op.id, "state": op.state,
                "result": op.result}
    if c == "remote-copy":
        op = cl.run_remote_copy(a.cluster, a.src, a.dst)
        return {"operation_id": op.id, "state": op.state,
                "result": op.result}
    if c == "abort-op":
        op = cl.abort_operation(a.op_id)
        return {"operation_id": op.id, "state": op.state}
    if c == "start-tx":
        return cl.start_tx()
    if c == "commit-tx":
        return cl.commit_tx(a.tx)
    if c == "abort-tx":
        return cl.abort_tx(a.tx)
    if c == "lock":
        return cl.lock(a.path, mode=a.mode, tx=a.tx)
    if c == "create-user":
        return cl.create_user(a.name)
    if c == "create-account":
        return cl.create_account(a.name)
    if c == "check-permission":
        return cl.check_permission(a.user, a.permission, a.path)
    if c == "get-operation":
        return cl._execute("get_operation", {"operation_id": a.op_id})
    if c == "orchid":
        return cl.get_orchid(a.path)
    raise AssertionError(c)


def _dispatch_view(cl, a):
    """`yt view <action>` — the continuous-query verbs."""
    def require_name():
        if not a.name:
            raise YtError(f"view {a.action} requires a view name")
        return a.name

    if a.action == "create":
        if not a.query:
            raise YtError("view create requires --query")
        return cl.create_materialized_view(
            require_name(), a.query, source=a.source, target=a.target,
            pool=a.pool, batch_rows=a.batch_rows)
    if a.action == "list":
        statuses = []
        for name in cl.list_views():
            try:
                statuses.append(cl.get_view(name))
            except YtError as err:
                # One broken view (dropped source, unmounted tablet)
                # must not hide the registry — least of all the entry
                # the operator wants to remove.  JSON keeps the error
                # in its own field; placeholders are render-only.
                statuses.append({"name": name, "error": str(err)})
        if a.json:
            return statuses
        print(_format_table(
            ["view", "state", "source", "target", "offset", "lag",
             "pool"],
            [[s["name"], s.get("state", "error"),
              s.get("source", s.get("error", "")[:60]),
              s.get("target", "-"), s.get("offset", "-"),
              s.get("lag_rows", "-"), s.get("pool", "-")]
             for s in statuses]))
        return None
    if a.action == "show":
        return cl.get_view(require_name())
    if a.action == "pause":
        return cl.pause_view(require_name())
    if a.action == "resume":
        return cl.resume_view(require_name())
    if a.action == "remove":
        cl.remove_view(require_name(), drop_target=a.drop_target)
        return {"removed": a.name}
    if a.action == "refresh":
        return cl.refresh_view(require_name(),
                               max_batches=a.max_batches)
    raise AssertionError(a.action)


def main() -> None:
    raise SystemExit(run())


if __name__ == "__main__":
    main()
