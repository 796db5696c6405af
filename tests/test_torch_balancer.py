"""The port's tablet balancer (ytsaurus_tpu_torch/tablet/balancer.py)
against the JAX package's: the reference's own tests (tests/
test_balancer.py) run on the port through `port_twin`, all three, and
`compute_pivots` over the same tables in both packages gives the same
pivots on int64, double, non-ASCII string and composite keys, the
reference's sorting row tuples in Python, the port's sorting the
snapshots' key planes with `ops/segments.py::lexsort_indices`. A null
key raises a YtError on the port (the reference's tuple sort raises
TypeError)."""

import numpy as np
import pytest

from tests.test_torch_client import call_twin, port_twin, twin_cases
from ytsaurus_tpu import client as ref_client
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu.tablet.balancer import TabletBalancer as RefBalancer
from ytsaurus_tpu_torch import client as port_client
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.schema import TableSchema
from ytsaurus_tpu_torch.tablet.balancer import TabletBalancer

_TWIN = port_twin("test_balancer")
_CASES = twin_cases(_TWIN)


def test_the_twin_holds_every_case():
    assert len(_CASES) == 3


@pytest.mark.parametrize("name", _CASES)
def test_reference_balancer_case_on_the_port(name, tmp_path):
    call_twin(_TWIN, name, {"client": _TWIN.connect(str(tmp_path))})


_WORDS = ["äpfel", "zebra", "Ωmega", "ёж", "apple", "日本語", "naïve",
          "Zürich", "ab", "a", "", "東京", "straße", "ß", "émile"]


def _rows(kind: str, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    if kind == "int64":
        keys = rng.permutation(1 << 20)[:n] - (1 << 19)
        return [{"k": int(k), "v": i} for i, k in enumerate(keys)]
    if kind == "double":
        keys = rng.normal(0, 1e3, n)
        keys[:4] = [0.0, -0.0, 1e308, -1e-300]
        return [{"k": float(k), "v": i} for i, k in enumerate(keys)]
    if kind == "string":
        words = [f"{_WORDS[i % len(_WORDS)]}{j}" for j, i in
                 enumerate(rng.permutation(n))]
        return [{"k": w, "v": i} for i, w in enumerate(words)]
    # composite: (g string, k int64)
    return [{"g": _WORDS[int(rng.integers(len(_WORDS)))],
             "k": int(rng.integers(-50, 50)), "v": i} for i in range(n)]


def _schema(Schema, kind):
    if kind == "composite":
        return Schema.make([("g", "string", "ascending"),
                            ("k", "int64", "ascending"), ("v", "int64")],
                           unique_keys=True)
    return Schema.make([("k", kind, "ascending"), ("v", "int64")],
                       unique_keys=True)


def _pivots(client, Schema, Balancer, kind, rows, pivots, desired):
    client.create("table", "//b/t", recursive=True,
                  attributes={"schema": _schema(Schema, kind),
                              "dynamic": True})
    if pivots:
        client.reshard_table("//b/t", pivots)
    client.mount_table("//b/t")
    for lo in range(0, len(rows), 500):
        client.insert_rows("//b/t", rows[lo:lo + 500])
    return Balancer(client).compute_pivots("//b/t", desired)


_START_PIVOTS = {"int64": [(-100_000,), (0,), (250_000,)],
                 "double": [(-500.0,), (0.0,), (700.0,)],
                 "string": [("m",), ("ё",)],
                 "composite": [("b", 0), ("z", -10)]}


@pytest.mark.parametrize("desired", [97, 400, 5000])
@pytest.mark.parametrize("kind", ["int64", "double", "string",
                                  "composite"])
def test_pivots_match_the_reference(kind, desired, tmp_path):
    rows = _rows(kind, 1500, seed=len(kind))
    if kind == "composite":
        seen, unique = set(), []
        for r in rows:
            if (r["g"], r["k"]) not in seen:
                seen.add((r["g"], r["k"]))
                unique.append(r)
        rows = unique
    want = _pivots(ref_client.connect(str(tmp_path / "ref")), RefSchema,
                   RefBalancer, kind, rows, _START_PIVOTS[kind], desired)
    got = _pivots(port_client.connect(str(tmp_path / "port"),
                                      device="cpu"), TableSchema,
                  TabletBalancer, kind, rows, _START_PIVOTS[kind], desired)
    assert got == want
    assert len(got) == max(-(-len(rows) // desired), 1) - 1 or \
        kind == "composite"


def test_a_null_key_is_a_yt_error(tmp_path):
    client = port_client.connect(str(tmp_path), device="cpu")
    schema = TableSchema.make([("g", "string", "ascending"),
                               ("k", "int64", "ascending"), ("v", "int64")],
                              unique_keys=True)
    client.create("table", "//b/n", recursive=True,
                  attributes={"schema": schema, "dynamic": True})
    client.mount_table("//b/n")
    client.insert_rows("//b/n", [{"g": "a", "k": i, "v": i}
                                 for i in range(10)] +
                       [{"g": None, "k": 3, "v": 0}])
    with pytest.raises(YtError, match="null"):
        TabletBalancer(client).compute_pivots("//b/n", 4)


def test_an_empty_table_has_no_pivots(tmp_path):
    client = port_client.connect(str(tmp_path), device="cpu")
    client.create("table", "//b/e", recursive=True,
                  attributes={"schema": _schema(TableSchema, "int64"),
                              "dynamic": True})
    client.mount_table("//b/e")
    assert TabletBalancer(client).compute_pivots("//b/e", 10) == []


def test_step_reports_nested_tables_by_their_path(tmp_path):
    """The report's key of a table below the root is its Cypress path
    ("//a/b/t"); the reference's writes "////a/b/t", one more slash per
    level (ROADMAP queue 3)."""
    for module, Schema, Balancer, name in (
            (port_client, TableSchema, TabletBalancer, "port"),
            (ref_client, RefSchema, RefBalancer, "ref")):
        client = module.connect(str(tmp_path / name)) if name == "ref" \
            else module.connect(str(tmp_path / name), device="cpu")
        client.create("table", "//a/b/t", recursive=True, attributes={
            "schema": _schema(Schema, "int64"), "dynamic": True,
            "desired_tablet_row_count": 10})
        client.mount_table("//a/b/t")
        client.insert_rows("//a/b/t", [{"k": i, "v": i} for i in range(40)])
        report = Balancer(client).step()
        if name == "port":
            assert report == {"//a/b/t": True}
            assert len(Balancer(client).tablet_row_counts("//a/b/t")) == 4
        else:
            assert report == {"////a/b/t": True}
