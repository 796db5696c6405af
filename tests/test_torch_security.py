"""The port's master transactions, locks and security against the JAX
package's: the reference's own tests (tests/test_security_tx.py) run on
the port, and scripts that drive both clients alike and compare error
codes and Cypress state. Left out: `test_remote_security_and_tx`, which
needs the daemon cluster (`environment/`, `remote_client.py`), not
ported.

Identity crosses threads as the reference's does: `current_user` is a
contextvar, the gateway captures it on the caller's thread into the
admitted request's token, and the accounting folds under it."""

import pytest
import torch

from tests.test_torch_client import (
    _both,
    _code,
    _cypress,
    call_twin,
    port_twin,
    twin_cases,
)
from ytsaurus_tpu.cypress.security import authenticated_user as ref_as_user
from ytsaurus_tpu.query.accounting import get_accountant as ref_accountant
from ytsaurus_tpu_torch import client as port_client
from ytsaurus_tpu_torch.cypress.security import authenticated_user
from ytsaurus_tpu_torch.query.accounting import get_accountant

torch.set_num_threads(1)

_TWIN = port_twin("test_security_tx")
_CASES = twin_cases(_TWIN, exclude={"test_remote_security_and_tx"})


@pytest.mark.parametrize("name", _CASES)
def test_reference_security_case_on_the_port(name, tmp_path):
    call_twin(_TWIN, name, {
        "client": lambda: _TWIN.YtClient(_TWIN.YtCluster(
            str(tmp_path / "cluster"))),
        "tmp_path": tmp_path})


def _as_user(client):
    return ref_as_user if type(client).__module__.startswith(
        "ytsaurus_tpu.") else authenticated_user


def _security_script(c, Schema, Error) -> dict:
    as_user = _as_user(c)
    out = {}
    sec = c.cluster.security
    sec.create_user("alice")
    sec.create_user("bob")
    sec.create_group("devs", members=["alice"])
    sec.create_account("small", resource_limits={"node_count": 3,
                                                 "disk_space": 1 << 20})
    c.create("map_node", "//prod/team", recursive=True)
    c.set("//prod/@account", "small")
    c.set("//prod/@acl", [{"action": "allow", "subjects": ["devs"],
                           "permissions": ["read", "write", "remove"]}])
    codes = {}
    with as_user("alice"):
        c.create("map_node", "//prod/team/a")
        c.write_table("//prod/team/t", [{"k": i} for i in range(10)])
        codes["alice_read"] = len(c.read_table("//prod/team/t"))
        codes["alice_quota"] = _code(
            lambda: c.create("map_node", "//prod/team/b"), Error)
    with as_user("bob"):
        codes["bob_write"] = _code(lambda: c.set("//prod/@x", 1), Error)
        codes["bob_read"] = c.get("//prod/team/a")
        codes["bob_remove"] = _code(lambda: c.remove("//prod/team/a"),
                                    Error)
    with as_user("ghost"):
        codes["ghost"] = _code(lambda: c.get("//sys"), Error)
    tx = c.start_tx()
    c.lock("//prod/team", mode="exclusive", tx=tx)
    codes["locked"] = _code(lambda: c.set("//prod/team/@y", 1), Error)
    inner = c.start_tx(parent=tx)
    c.set("//prod/team/@y", 2, tx=inner)
    c.commit_tx(inner)
    c.abort_tx(tx)
    codes["after_abort"] = c.exists("//prod/team/@y")
    codes["lock_without_tx"] = _code(lambda: c.lock("//prod"), Error)
    codes["usage"] = c.get("//sys/accounts/small/@resource_usage")
    out["codes"] = codes
    out["cypress"] = _cypress(c)
    return out


def test_acls_accounts_and_transactions_match(tmp_path):
    ref, port = _both(_security_script, tmp_path)
    assert port["codes"] == ref["codes"]
    assert port["cypress"] == ref["cypress"]


def _identity_script(c, Schema, Error) -> dict:
    """Selects and lookups under a user run on the gateway's threads; the
    accountant must attribute them to that user, the lookups' batch to
    the cohort's opener."""
    as_user = _as_user(c)
    accountant = ref_accountant() if as_user is ref_as_user \
        else get_accountant()
    c.cluster.security.create_user("alice")
    schema = Schema.make([("k", "int64", "ascending"), ("v", "int64")],
                         unique_keys=True)
    c.create("table", "//id/t", recursive=True,
             attributes={"schema": schema, "dynamic": True})
    c.mount_table("//id/t")
    c.insert_rows("//id/t", [{"k": i, "v": i} for i in range(50)])
    c.set("//id/t/@acl", [{"action": "allow", "subjects": ["alice"],
                           "permissions": ["read"]}])

    def alice_usage():
        snap = accountant.snapshot()["by_user"].get("alice", {})
        return {k: snap.get(k, 0.0) for k in (
            "queries", "rows_read", "rows_written", "lookups",
            "lookup_keys", "lookup_rows_found")}

    before = alice_usage()
    with as_user("alice"):
        rows = c.select_rows("k, v FROM [//id/t] WHERE k < 5")
        found = c.lookup_rows("//id/t", [(1,), (2,), (99,)])
    after = alice_usage()
    return {"rows": sorted((r["k"], r["v"]) for r in rows),
            "found": found,
            "usage": {k: after[k] - before[k] for k in after}}


def test_identity_crosses_into_the_gateway_threads(tmp_path):
    ref, port = _both(_identity_script, tmp_path)
    assert port == ref
    assert port["usage"]["queries"] == 1
    assert port["usage"]["lookup_keys"] == 3


def test_identity_reaches_coalesced_lookups_from_threads(tmp_path):
    """Two users' lookups from their own threads: each request's keys fold
    under its own user, whichever opened the batch."""
    import threading
    client = port_client.connect(str(tmp_path), device="cpu")
    sec = client.cluster.security
    for user in ("u1", "u2"):
        sec.create_user(user)
    schema = port_client.TableSchema.make(
        [("k", "int64", "ascending"), ("v", "int64")], unique_keys=True)
    client.create("table", "//id/t", recursive=True,
                  attributes={"schema": schema, "dynamic": True})
    client.mount_table("//id/t")
    client.insert_rows("//id/t", [{"k": i, "v": -i} for i in range(64)])
    accountant = get_accountant()

    def keys_of(user):
        return accountant.snapshot()["by_user"].get(user, {}).get(
            "lookup_keys", 0.0)

    before = {u: keys_of(u) for u in ("u1", "u2")}
    barrier = threading.Barrier(2)
    results = {}

    def work(user, keys):
        with authenticated_user(user):
            barrier.wait()
            results[user] = client.lookup_rows("//id/t",
                                               [(k,) for k in keys])

    threads = [threading.Thread(target=work, args=("u1", range(5))),
               threading.Thread(target=work, args=("u2", range(40, 47)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert [r["v"] for r in results["u1"]] == [-k for k in range(5)]
    assert [r["v"] for r in results["u2"]] == [-k for k in range(40, 47)]
    assert keys_of("u1") - before["u1"] == 5
    assert keys_of("u2") - before["u2"] == 7
