"""The port's Hive mailboxes, portals and Sequoia ground tables against
the JAX package's.

Two kinds of case:

- the reference's own tests, run on the port through
  `tests/test_torch_client.py::port_twin`: `test_hive.py` and
  `test_multicell.py` whole, and `test_sequoia.py` less the case that
  starts a `LocalCluster` (the daemons, `environment/local.py`, are not
  ported);
- one script of portal and Sequoia operations driven alike through both
  clients: the same Cypress answers, the same resolve rows and the same
  `verify()` result.
"""

import inspect

import numpy as np
import pytest
import torch

from tests.test_torch_client import call_twin, port_twin, twin_cases

torch.set_num_threads(1)


def _fixtures(twin, name: str, tmp_path, monkeypatch) -> dict:
    """The twin's module fixtures its case names, built on the CPU."""
    fixtures = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    for param in inspect.signature(getattr(twin, name)).parameters:
        if param not in fixtures:
            fixtures[param] = getattr(twin, param).__wrapped__(tmp_path)
    return fixtures


_HIVE_TWIN = port_twin("test_hive")
_HIVE_CASES = twin_cases(_HIVE_TWIN)
_MULTICELL_TWIN = port_twin("test_multicell")
_MULTICELL_CASES = twin_cases(_MULTICELL_TWIN)
_SEQUOIA_TWIN = port_twin("test_sequoia")
# Left out: test_multiprocess_randomized_workload_stays_consistent starts
# a LocalCluster and a remote client (environment/local.py and
# remote_client.py are not ported).
_SEQUOIA_CASES = twin_cases(_SEQUOIA_TWIN, exclude={
    "test_multiprocess_randomized_workload_stays_consistent"})


def test_twin_case_counts():
    assert (len(_HIVE_CASES), len(_MULTICELL_CASES),
            len(_SEQUOIA_CASES)) == (9, 13, 18)


@pytest.mark.parametrize("name", _HIVE_CASES)
def test_reference_hive_case_on_the_port(name, tmp_path, monkeypatch):
    call_twin(_HIVE_TWIN, name,
              _fixtures(_HIVE_TWIN, name, tmp_path, monkeypatch))


@pytest.mark.parametrize("name", _MULTICELL_CASES)
def test_reference_multicell_case_on_the_port(name, tmp_path, monkeypatch):
    call_twin(_MULTICELL_TWIN, name,
              _fixtures(_MULTICELL_TWIN, name, tmp_path, monkeypatch))


@pytest.mark.parametrize("name", _SEQUOIA_CASES)
def test_reference_sequoia_case_on_the_port(name, tmp_path, monkeypatch):
    call_twin(_SEQUOIA_TWIN, name,
              _fixtures(_SEQUOIA_TWIN, name, tmp_path, monkeypatch))


# --- one script of portals and Sequoia through both clients ------------------

def _cells_script(c, Schema, Error, root, mods) -> dict:
    """Portals (routed verbs, table data, a delegated select, removal
    through Hive) and Sequoia (sync, mutations, a transaction that
    aborts, the read path, verify) on one client."""
    from tests.test_torch_client import _code, _mask

    out = {}
    cell_root = str(root / "cell")
    c.create("portal_entrance", "//cell", recursive=True,
             attributes={"cell_root": cell_root, "cell_tag": 3})
    c.create("map_node", "//cell/home/a", recursive=True)
    c.set("//cell/home/a/@owner", "team")
    c.create("document", "//cell/home/doc", attributes={"value": {"x": 1}})
    rng = np.random.default_rng(13)
    rows = [{"k": int(i), "g": int(g), "v": int(v)} for i, g, v in
            zip(range(400), rng.integers(0, 17, 400),
                rng.integers(0, 1000, 400))]
    c.write_table("//cell/t", rows)
    out["cypress"] = _mask([c.list("//cell"), c.list("//cell/home"),
                            c.get("//cell/home/a/@owner"),
                            c.get("//cell/home/doc"),
                            c.exists("//cell/home/b"),
                            c.get("//cell/t/@row_count"),
                            c.get("//cell/@cell_tag")])
    query = ("g, sum(v) AS s FROM [//cell/t] GROUP BY g "
             "ORDER BY sum(v) DESC, g LIMIT 5")
    # select_rows does not route across a portal in either package: the
    # primary's own select finds no table; the routed front door
    # (delegate_for, with the entrance's ACL check) reaches the cell.
    out["primary_select"] = _code(lambda: c.select_rows(query), Error)
    delegate = mods["multicell"].delegate_for(c, "//cell/t", "read")
    with mods["multicell"].as_cell_principal():
        out["select"] = delegate.select_rows(query)
    out["tx_under_portal"] = _code(
        lambda: c.create("map_node", "//cell/x",
                         tx=c.start_transaction()), Error)
    cell = mods["multicell"].cell_client(c, cell_root)
    out["exit"] = _mask(cell.get("//cell/home/a/@owner"))
    c.remove("//cell", recursive=True)
    hive = mods["multicell"].hive_of(c)
    cell_hive = mods["multicell"].hive_of(cell)
    out["hive"] = [c.exists("//cell"), cell.exists("//cell"),
                   cell_hive.last_applied(hive.cell_id) > 0,
                   hive.pending(cell_hive.cell_id)]

    c.create("map_node", "//pre/existing", recursive=True)
    seq = mods["sequoia"].SequoiaResolver(c).enable()
    for i in range(6):
        c.create("document", f"//tree/m{i % 2}/d{i}", recursive=True,
                 attributes={"value": {"i": i}})
    c.set("//tree/m0/d0", {"i": 100})
    c.set("//tree/m1/@tag", "t")
    c.remove("//tree/m1/d3")
    tx = c.start_tx()
    c.create("document", "//tree/txnode", recursive=True, tx=tx)
    c.abort_tx(tx)
    paths = ["//pre/existing", "//tree", "//tree/m0", "//tree/m0/d0",
             "//tree/m1/d3", "//tree/txnode", "//missing"]
    out["resolve"] = [None if (r := seq.resolve(p)) is None else
                      (r["node_type"], r["node_id"] == c.get(p + "/@id"))
                      for p in paths]
    out["read"] = [seq.read_list("//tree"), seq.read_list("//tree/m1"),
                   seq.read_get("//tree/m0"), seq.read_get("//tree", 1),
                   seq.read_exists("//tree/m0/d2"),
                   seq.read_attribute("//tree/m1", "tag"),
                   _code(lambda: seq.read_list("//missing"), Error)]
    out["verify"] = seq.verify()
    return out


def test_cells_script_matches_the_reference(tmp_path):
    from tests.test_torch_client import _assert_rows, _connect
    from ytsaurus_tpu import client as ref_client
    from ytsaurus_tpu.cypress import multicell as ref_multicell
    from ytsaurus_tpu.cypress import sequoia as ref_sequoia
    from ytsaurus_tpu.errors import YtError as RefYtError
    from ytsaurus_tpu.schema import TableSchema as RefSchema
    from ytsaurus_tpu_torch import client as port_client
    from ytsaurus_tpu_torch.cypress import multicell, sequoia
    from ytsaurus_tpu_torch.errors import YtError
    from ytsaurus_tpu_torch.schema import TableSchema

    ref = _cells_script(_connect(ref_client, tmp_path / "ref"), RefSchema,
                        RefYtError, tmp_path / "ref",
                        {"multicell": ref_multicell,
                         "sequoia": ref_sequoia})
    port_cl = _connect(port_client, tmp_path / "port")
    port = _cells_script(port_cl, TableSchema, YtError, tmp_path / "port",
                         {"multicell": multicell, "sequoia": sequoia})
    _assert_rows(port.pop("select"), ref.pop("select"), True)
    assert port == ref
    assert port["verify"] == []
    assert port["hive"] == [False, False, True, 0]
    # The cell opened on the primary's device.
    cell = multicell.cell_client(port_cl, str(tmp_path / "port" / "cell"))
    assert cell.cluster.device == port_cl.cluster.device
