"""The port's workload recorder (its recording half) against the JAX
package's: the reference's own tests of normalization, the bounded and
sampled log, its rotated disk tier, versioned captures, and the select
and lookup folds (tests/test_workload.py) run on the port, and the same
traffic through both clients records the same normalized text, literals
and fingerprints. The port runs with device="cpu".

The replay half runs too: the reference's replay, pacing and
`synthesize_mix` cases and its CLI case (`yt workload export|show`,
`yt replay`). One edit, in the replay and pacing cases: the port compiles
nothing, so its statistics carry no compile-cache counters and its
replay report no `compile_cache` section, where the reference's hit
rates are 1.0 (the sanctioned divergence of EXPLAIN ANALYZE's compile
fields). `yt compile-cache top` and `yt prewarm` are refused by name on
the port (nothing is compiled); the same seed synthesizes the same mix
in both packages, the port's records with an empty stage split.

Left out: the compilation observatory, the recompilation-storm SLO, the
capacity buckets (nothing is compiled, so there are no compile records
to observe), and the monitoring endpoints, which
tests/test_torch_daemons.py holds against the reference's."""

import pytest
import torch

from tests.test_torch_client import call_twin, port_twin
from ytsaurus_tpu import client as ref_client
from ytsaurus_tpu.errors import YtError as RefYtError
from ytsaurus_tpu.query import workload as ref_wl
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu_torch import client as port_client
from ytsaurus_tpu_torch import config as port_config
from ytsaurus_tpu_torch.config import ServingConfig
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.query import workload as wl
from ytsaurus_tpu_torch.schema import TableSchema

torch.set_num_threads(1)

_TWIN = port_twin("test_workload", edits={
    """    # Every shape was compiled during recording: the replay itself is
    # all hits — the steady-state discipline ROADMAP 1 will gate on.
    assert cache["hit_rate"] == 1.0
    assert cache["steady_hit_rate"] == 1.0""":
    """    # The port compiles nothing: no compile-cache section.
    assert cache is None""",
    """    cache = report["compile_cache"]""":
    """    cache = report.get("compile_cache")""",
    """    assert report["compile_cache"]["hit_rate"] == 1.0""":
    """    assert "compile_cache" not in report"""})
_CASES = [
    "test_normalize_hoists_literals_and_round_trips",
    "test_normalize_is_literal_invariant",
    "test_substitute_mismatch_fails_loudly",
    "test_log_is_bounded_and_sampled", "test_fingerprint_rollup_is_bounded",
    "test_disk_log_rotates_with_versioned_headers",
    "test_capture_roundtrip_and_version_check",
    "test_planner_feedback_ledger_roundtrip",
    "test_throttled_select_records_outcome",
    "test_lookup_folds_workload_record",
    "test_replay_reports_latency_hit_rate_and_traces",
    "test_replay_paces_by_recorded_spacing", "test_synthesize_mix_shapes",
    "test_cli_workload_and_replay"]


@pytest.fixture(autouse=True)
def _workload_defaults():
    wl.get_workload_log().clear()
    yield
    port_config.set_workload_config(None)
    wl.configure(None)


def _wl_table(c, Schema):
    schema = Schema.make([("k", "int64", "ascending"), ("v", "int64")],
                         unique_keys=True)
    c.create("table", "//wl/t",
             attributes={"schema": schema, "dynamic": True},
             recursive=True)
    c.mount_table("//wl/t")
    c.insert_rows("//wl/t", [{"k": i, "v": i * 2} for i in range(100)])
    return c


@pytest.fixture(scope="module")
def wl_client(tmp_path_factory):
    """The reference module's `client` fixture, on the port."""
    c = port_client.connect(str(tmp_path_factory.mktemp("workload")),
                            device="cpu")
    c.cluster.serving_config = ServingConfig(
        pools={"default": 1.0, "other": 1.0})
    return _wl_table(c, TableSchema)


@pytest.mark.parametrize("name", _CASES)
def test_reference_workload_case_on_the_port(name, wl_client, tmp_path,
                                            capsys):
    call_twin(_TWIN, name, {"client": wl_client, "tmp_path": tmp_path,
                            "capsys": capsys})


@pytest.mark.parametrize("argv", [
    ["compile-cache", "top", "--limit", "5"],
    ["prewarm", "--capture", "unused.json"]])
def test_compile_verbs_are_refused_by_name(argv, wl_client, capsys):
    from ytsaurus_tpu_torch.cli import run
    assert run(argv, client=wl_client) == 1
    err = capsys.readouterr().err
    verb = " ".join(argv[:2]) if argv[0] == "compile-cache" else argv[0]
    assert f"yt {verb} is not applicable in the port" in err


@pytest.mark.parametrize("seed", [0, 7])
def test_the_same_seed_synthesizes_the_same_mix(seed):
    shapes = ["g, sum(v) AS s FROM [//t] WHERE v < {} GROUP BY g",
              "count(*) AS c FROM [//t] WHERE g = {} AND v > {}"]
    got = wl.synthesize_mix(shapes, count=40, distinct=16, seed=seed,
                            pool="p")
    want = ref_wl.synthesize_mix(shapes, count=40, distinct=16, seed=seed,
                                 pool="p")
    assert all(r.stages == {} for r in got)
    assert [_without_stages(r.to_dict()) for r in got] == \
        [r.to_dict() for r in want]


def _without_stages(record: dict) -> dict:
    """A port record as the reference writes it: the port's records add
    the stage split (`stages`), which the reference has not."""
    return {k: v for k, v in record.items() if k != "stages"}


def test_select_folds_workload_record_on_the_port(wl_client):
    """The reference's select fold, less its capacity buckets (nothing
    is compiled, so none ride the record)."""
    log = wl.get_workload_log()
    wl_client.select_rows("k, v FROM [//wl/t] WHERE k < 7")
    rec = log.records()[-1]
    assert rec.kind == "select" and rec.outcome == "ok"
    assert rec.query == "k, v FROM [//wl/t] WHERE k < ?"
    assert rec.literals == [["int64", 7]]
    assert rec.pool == "default" and rec.wall_time > 0
    assert rec.capacity_buckets == [] and rec.execution_tier == "eager"
    assert rec.trace_id
    assert rec.compile_time > 0 and rec.rows_returned == 7
    assert rec.stages["wall_time"] == rec.wall_time
    assert rec.stages["compile_time"] == rec.compile_time
    rollup = log.fingerprints()
    assert rollup[0]["count"] >= 1 and rollup[0]["ok"] >= 1


_TRAFFIC = [
    ("select", "k, v FROM [//wl/t] WHERE k < 7"),
    ("select", "k FROM [//wl/t] WHERE k = 42 AND v > 1.5"),
    ("select", "k FROM [//wl/t] WHERE k = 43 AND v > 2.5"),
    ("select", "sum(v) AS s FROM [//wl/t] WHERE k IN (1, 2, 3) GROUP BY 1"),
    ("lookup", [(3,), (5,), (1000,)]),
    ("error", "k FROM [//wl/missing]"),
]


def _record_traffic(c, Error, workload) -> list:
    for kind, arg in _TRAFFIC:
        if kind == "select":
            c.select_rows(arg)
        elif kind == "lookup":
            c.lookup_rows("//wl/t", arg)
        else:
            with pytest.raises(Error):
                c.select_rows(arg)
    return [(r.kind, r.query, r.literals, r.fingerprint, r.outcome,
             r.table, r.keys, r.rows_read, r.rows_returned, r.pool, r.user)
            for r in workload.get_workload_log().records()]


def test_the_same_traffic_records_the_same_workload(tmp_path):
    ref_wl.get_workload_log().clear()
    ref = _wl_table(ref_client.connect(str(tmp_path / "ref")), RefSchema)
    port = _wl_table(port_client.connect(str(tmp_path / "port"),
                                         device="cpu"), TableSchema)
    ref_wl.get_workload_log().clear()
    wl.get_workload_log().clear()
    want = _record_traffic(ref, RefYtError, ref_wl)
    got = _record_traffic(port, YtError, wl)
    assert got == want
    assert [e["count"] for e in wl.get_workload_log().fingerprints(0)] == \
        [e["count"] for e in ref_wl.get_workload_log().fingerprints(0)]


def test_captures_load_across_packages(tmp_path):
    log = wl.WorkloadLog(port_config.WorkloadConfig())
    for i in range(3):
        log.observe(wl.WorkloadRecord(query="v FROM [//t] WHERE k = ?",
                                      literals=[["int64", i]], pool="p"))
    path = tmp_path / "capture.json"
    log.export_capture(str(path))
    records = ref_wl.load_capture(str(path))
    assert [r.to_dict() for r in records] == \
        [_without_stages(r.to_dict()) for r in wl.load_capture(str(path))]
    ref_path = tmp_path / "ref.json"
    ref_wl.write_capture(str(ref_path), records)
    assert [r.literals for r in wl.load_capture(str(ref_path))] == \
        [[["int64", i]] for i in range(3)]
