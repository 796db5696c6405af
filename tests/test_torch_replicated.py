"""Parity of the port's replicated chunk store with the JAX package on the CPU.

`ytsaurus_tpu_torch.chunks.replicated.ReplicatedChunkStore` against
`ytsaurus_tpu.chunks.replicated`: twins of the 9 replicated cases of
tests/test_chunk_store.py (on its schema, `any` column included), the
placement order for 1,000 chunk ids, the files each package writes (a
re-replicated copy byte for byte the survivor's), each package reading
the other's layout, the read ladder's retries under the `chunks.store.read`
failpoint, the aggregate error's code and inner errors, the location
blacklist's TTL, and the `chunk_read` retry policy.
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch

from ytsaurus_tpu.chunks.columnar import ColumnarChunk as RefChunk
from ytsaurus_tpu.chunks.replicated import ReplicatedChunkStore as RefRepl
from ytsaurus_tpu.config import retry_policy as ref_retry_policy
from ytsaurus_tpu.errors import YtError as RefYtError
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu.utils import failpoints as ref_failpoints
from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.chunks.replicated import ReplicatedChunkStore
from ytsaurus_tpu_torch.config import retry_policy
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.schema import TableSchema
from ytsaurus_tpu_torch.utils import failpoints

torch.set_num_threads(1)

SPEC = [("k", "int64", "ascending"), ("u", "uint64"), ("d", "double"),
        ("b", "boolean"), ("s", "string"), ("a", "any")]


def _rows(n=100, seed=0):
    """tests/test_chunk_store.py's `_chunk` rows."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        rows.append({
            "k": i,
            "u": int(rng.integers(0, 2**63)) * 2 + 1,
            "d": float(rng.uniform(-1, 1)) if i % 7 else None,
            "b": bool(i % 2) if i % 5 else None,
            "s": f"value-{i % 13}" if i % 3 else None,
            "a": {"i": i} if i % 4 == 0 else [1, i],
        })
    return rows


def _chunk(n=100, seed=0):
    return ColumnarChunk.from_rows(TableSchema.make(SPEC), _rows(n, seed),
                                   device="cpu")


def _ref_chunk(n=100, seed=0):
    return RefChunk.from_rows(RefSchema.make(SPEC), _rows(n, seed))


def _replicated(tmp_path, n=3, rf=2, **kwargs):
    return ReplicatedChunkStore(
        [str(tmp_path / f"loc{i}") for i in range(n)], replication_factor=rf,
        **kwargs)


def _ref_replicated(tmp_path, n=3, rf=2, **kwargs):
    return RefRepl([str(tmp_path / f"loc{i}") for i in range(n)],
                   replication_factor=rf, **kwargs)


def _copies(store, cid) -> int:
    return sum(1 for loc in store.locations if loc.exists(cid))


def _tree(root) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


# --- twins of tests/test_chunk_store.py:140-260 --------------------------------

def test_replicated_write_places_rf_copies(tmp_path):
    store = _replicated(tmp_path)
    chunk = _chunk(32)
    cid = store.write_chunk(chunk)
    assert _copies(store, cid) == 2
    assert store.read_chunk(cid, device="cpu").to_rows() == chunk.to_rows()


def test_replicated_read_survives_location_loss(tmp_path):
    store = _replicated(tmp_path)
    chunk = _chunk(32)
    cid = store.write_chunk(chunk)
    holder = next(loc for loc in store._placement(cid) if loc.exists(cid))
    shutil.rmtree(holder.root)
    os.makedirs(holder.root, exist_ok=True)
    assert store.read_chunk(cid, device="cpu").to_rows() == chunk.to_rows()
    # Repair-on-read restored the lost replica.
    assert _copies(store, cid) == 2


def test_replicated_total_loss_raises(tmp_path):
    store = _replicated(tmp_path)
    cid = store.write_chunk(_chunk(8))
    for loc in store.locations:
        loc.remove_chunk(cid)
    with pytest.raises(YtError):
        store.read_chunk(cid, device="cpu")
    assert not store.exists(cid)


def test_replicated_erasure_passthrough(tmp_path):
    store = _replicated(tmp_path)
    chunk = _chunk(64)
    cid = store.write_chunk(chunk, erasure="rs_3_2")
    assert store.exists(cid)
    assert store.read_chunk(cid, device="cpu").to_rows() == chunk.to_rows()


def test_replicated_remove_and_list(tmp_path):
    store = _replicated(tmp_path)
    ids = sorted(store.write_chunk(_chunk(8, seed=i)) for i in range(4))
    assert store.list_chunks() == ids
    for cid in ids:
        store.remove_chunk(cid)
    assert store.list_chunks() == []


def test_replicated_erasure_not_duplicated_on_read(tmp_path):
    store = _replicated(tmp_path)
    cid = store.write_chunk(_chunk(64), erasure="rs_3_2")
    store.read_chunk(cid, device="cpu")
    # No full plain replica may appear on other locations.
    assert sum(1 for loc in store.locations
               if os.path.exists(loc._path(cid))) == 0


def test_replicated_placement_process_stable(tmp_path):
    import hashlib
    store = _replicated(tmp_path)
    cid = "deadbeef" * 4
    want = sorted(range(3), key=lambda i: hashlib.sha256(
        f"{cid}:{i}".encode()).digest())
    assert [store.locations.index(s) for s in store._placement(cid)] == want


def test_replicated_spilled_write_not_over_replicated(tmp_path):
    store = _replicated(tmp_path)
    chunk = _chunk(16)
    cid_probe = "feedface" * 4
    placement = store._placement(cid_probe)
    os.chmod(placement[1].root, 0o500)
    try:
        cid = store.write_chunk(chunk, chunk_id=cid_probe)
    finally:
        os.chmod(placement[1].root, 0o700)
    assert _copies(store, cid) == 2
    # Location recovered: a read must NOT add a third copy.
    store.read_chunk(cid, device="cpu")
    assert _copies(store, cid) == 2


def test_replicated_read_survives_unreadable_location(tmp_path):
    store = _replicated(tmp_path)
    chunk = _chunk(16)
    cid = store.write_chunk(chunk)
    holder = next(loc for loc in store._placement(cid) if loc.exists(cid))
    path = holder._path(cid)
    os.chmod(path, 0o000)
    try:
        assert store.read_chunk(cid, device="cpu").to_rows() == \
            chunk.to_rows()
    finally:
        os.chmod(path, 0o600)


# --- against the JAX package --------------------------------------------------

def test_placement_order_matches_for_1000_ids(tmp_path):
    store = _replicated(tmp_path, n=5)
    ref = _ref_replicated(tmp_path, n=5)
    rng = np.random.default_rng(9)
    for _ in range(1000):
        cid = rng.bytes(16).hex()
        assert [s.root for s in store._placement(cid)] == \
            [s.root for s in ref._placement(cid)]


@pytest.mark.parametrize("rf", [1, 2, 3])
def test_files_match_and_each_reads_the_other(tmp_path, rf):
    store = _replicated(tmp_path / "port", n=4, rf=rf)
    ref = _ref_replicated(tmp_path / "ref", n=4, rf=rf)
    ids = ["%032x" % (i * 7919 + 13) for i in range(6)]
    for i, cid in enumerate(ids):
        store.write_chunk(_chunk(50, seed=i), chunk_id=cid)
        ref.write_chunk(_ref_chunk(50, seed=i), chunk_id=cid)
    for loc, ref_loc in zip(store.locations, ref.locations):
        assert _tree(loc.root) == _tree(ref_loc.root)
    assert store.list_chunks() == ref.list_chunks() == sorted(ids)
    cross = ReplicatedChunkStore([loc.root for loc in ref.locations],
                                 replication_factor=rf)
    ref_cross = RefRepl([loc.root for loc in store.locations],
                        replication_factor=rf)
    for i, cid in enumerate(ids):
        want = _ref_chunk(50, seed=i).to_rows()
        assert cross.read_chunk(cid, device="cpu").to_rows() == want
        assert ref_cross.read_chunk(cid).to_rows() == want


def test_rereplicated_copies_match_the_survivors(tmp_path):
    """A dead location: both packages re-replicate on read, and every new
    copy is byte for byte the surviving one."""
    store = _replicated(tmp_path / "port", n=4, rf=3)
    ref = _ref_replicated(tmp_path / "ref", n=4, rf=3)
    ids = ["%032x" % (i * 104729 + 1) for i in range(8)]
    for i, cid in enumerate(ids):
        store.write_chunk(_chunk(60, seed=i), chunk_id=cid)
        ref.write_chunk(_ref_chunk(60, seed=i), chunk_id=cid)
    for s in (store, ref):
        shutil.rmtree(s.locations[1].root)
        os.makedirs(s.locations[1].root)
    for i, cid in enumerate(ids):
        assert store.read_chunk(cid, device="cpu").to_rows() == \
            ref.read_chunk(cid).to_rows()
        assert _copies(store, cid) == 3
        blobs = {loc.get_blob(cid) for loc in store.locations
                 if loc.exists(cid)}
        assert len(blobs) == 1
    for loc, ref_loc in zip(store.locations, ref.locations):
        assert _tree(loc.root) == _tree(ref_loc.root)


def test_flipped_byte_is_quarantined_and_served_elsewhere(tmp_path):
    store = _replicated(tmp_path, n=4, rf=3)
    chunk = _chunk(40)
    cid = store.write_chunk(chunk)
    bad = store._placement(cid)[0]
    path = bad._path(cid)
    with open(path, "rb") as f:
        blob = bytearray(f.read())
    blob[len(blob) // 2] ^= 0x40
    with open(path, "wb") as f:
        f.write(bytes(blob))
    assert not bad.verify_chunk(cid)
    bad.quarantine_chunk(cid)
    assert os.path.exists(path + ".quarantine") and not bad.exists(cid)
    assert store.read_chunk(cid, device="cpu").to_rows() == chunk.to_rows()
    assert _copies(store, cid) == 3


def test_ladder_retries_under_the_read_failpoint(tmp_path):
    store = _replicated(tmp_path, n=3, rf=3)
    ref = _ref_replicated(tmp_path / "ref", n=3, rf=3)
    chunk = _chunk(20)
    cid = store.write_chunk(chunk, chunk_id="c" * 32)
    ref.write_chunk(_ref_chunk(20), chunk_id="c" * 32)
    with failpoints.active("chunks.store.read=error:times=1"):
        assert store.read_chunk(cid, device="cpu").to_rows() == \
            chunk.to_rows()
        rule = failpoints._STATE.rules["chunks.store.read"]
        assert rule.triggered == 1 and rule.hits == 2
    # The failing location is banned: the next read skips it.
    assert len(store._banned_until) == 1
    with ref_failpoints.active("chunks.store.read=error:times=1"):
        ref.read_chunk(cid)
    assert [os.path.basename(r) for r in store._banned_until] == \
        [os.path.basename(r) for r in ref._banned_until] == \
        [os.path.basename(store._placement(cid)[0].root)]


def test_aggregate_error_code_and_inner_errors(tmp_path):
    store = _replicated(tmp_path, n=3, rf=2, blacklist_ttl=0.0)
    ref = _ref_replicated(tmp_path, n=3, rf=2, blacklist_ttl=0.0)
    cid = "%032x" % 12345
    # Absent everywhere: NoSuchChunk, one inner error a location, no wait.
    t = time.perf_counter()
    with pytest.raises(YtError) as err:
        store.read_chunk(cid, device="cpu")
    with pytest.raises(RefYtError) as ref_err:
        ref.read_chunk(cid)
    assert time.perf_counter() - t < 0.5
    assert err.value.code == ref_err.value.code == 1100
    assert len(err.value.inner_errors) == len(ref_err.value.inner_errors) == 3
    assert str(err.value) == str(ref_err.value)
    # A disk-shaped failure on every location: ChunkFormatError wins.
    store.write_chunk(_chunk(4), chunk_id=cid)
    ref.write_chunk(_ref_chunk(4), chunk_id=cid)
    with failpoints.active("chunks.store.read=error"):
        with pytest.raises(YtError) as err:
            store.read_chunk(cid, device="cpu")
    with ref_failpoints.active("chunks.store.read=error"):
        with pytest.raises(RefYtError) as ref_err:
            ref.read_chunk(cid)
    assert err.value.code == ref_err.value.code
    assert [e.code for e in err.value.inner_errors] == \
        [e.code for e in ref_err.value.inner_errors]
    assert [e.attributes["location"] for e in err.value.inner_errors] == \
        [e.attributes["location"] for e in ref_err.value.inner_errors]


def test_blacklist_ttl(tmp_path):
    store = _replicated(tmp_path, n=3, rf=2, blacklist_ttl=0.2)
    locs = store.locations
    store._ban(locs[0])
    assert store._usable(locs) == locs[1:]
    for loc in locs:
        store._ban(loc)
    assert store._usable(locs) == locs        # all banned: desperation round
    time.sleep(0.25)
    assert store._usable(locs) == locs and store._banned_until == {}
    off = _replicated(tmp_path, n=3, rf=2, blacklist_ttl=0.0)
    off._ban(off.locations[0])
    assert off._banned_until == {}


def test_chunk_read_policy_matches():
    policy, ref = retry_policy("chunk_read"), ref_retry_policy("chunk_read")
    assert (policy.attempts, policy.backoff, policy.backoff_cap,
            policy.jitter) == (ref.attempts, ref.backoff, ref.backoff_cap,
                               ref.jitter) == (3, 0.05, 1.0, 0.5)
    import random
    for attempt in range(4):
        assert policy.delay(attempt, random.Random(attempt)) == \
            ref.delay(attempt, random.Random(attempt))


def test_meta_and_stats_through_the_ladder(tmp_path):
    store = _replicated(tmp_path)
    ref = _ref_replicated(tmp_path)
    cid = store.write_chunk(_chunk(30))
    assert store.read_meta(cid)["row_count"] == ref.read_meta(cid)[
        "row_count"] == 30
    from ytsaurus_tpu import yson as ref_yson
    from ytsaurus_tpu_torch import yson
    assert yson.dumps(store.read_stats(cid), binary=True) == \
        ref_yson.dumps(ref.read_stats(cid), binary=True)


def test_needs_a_location():
    with pytest.raises(YtError):
        ReplicatedChunkStore([])
