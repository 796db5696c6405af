"""Tablet balancer: keep tablet sizes bounded by automatic resharding.

Ref mapping:
  server/tablet_balancer (+ master-side     → TabletBalancer.step scans
  tablet_manager reshard actions)             mounted sorted dynamic
                                              tables and reshards the
                                              unbalanced ones
  partition sample keys                      → pivot selection cuts the
  (tablet_node/partition.h:39-49)             live keys at row-count
                                              quantiles
  @enable_tablet_balancer / desired sizes    → same attributes here
  (bundle/tablet config)

Design delta: resharding is the existing pivot-rewrite path (unmount →
reshard → remount), so balancing is a policy loop over row-count stats,
not a separate data mover.

Own copy of the JAX package's `tablet/balancer.py`. `compute_pivots`
gives the reference's pivots (the key at each quantile position when
every tablet's key tuples are put in sorted order) from the snapshots'
key planes on the tablets' device: one stable `ops/segments.py::
lexsort_indices` over the concatenated planes (the radix kernels on the
card), then one read of the few pivot rows. The reference builds row
tuples and sorts them in Python. A key with a null raises a YtError
(the reference's tuple sort raises TypeError there). `step` reports a
nested table under its path ("//a/b"; the reference's report writes
"///a/b").
"""

from __future__ import annotations

import numpy as np
import torch

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.ops.segments import lexsort_indices
from ytsaurus_tpu_torch.schema import EValueType

DEFAULT_DESIRED_ROWS = 1_000_000

# Key types whose order is a plane's order (after the string remap).
_ORDERED_TYPES = (EValueType.int64, EValueType.uint64, EValueType.double,
                  EValueType.boolean, EValueType.string)


class TabletBalancer:
    def __init__(self, client,
                 desired_tablet_rows: int = DEFAULT_DESIRED_ROWS):
        self.client = client
        self.desired_tablet_rows = desired_tablet_rows

    def _table_desired(self, node) -> int:
        return int(node.attributes.get("desired_tablet_row_count")
                   or self.desired_tablet_rows)

    def tablet_row_counts(self, path: str) -> list[int]:
        return [t.read_snapshot().row_count
                for t in self.client._mounted_tablets(path)]

    def needs_balancing(self, path: str) -> bool:
        """Split-worthy: a tablet over 2x desired; merge-worthy: two
        adjacent tablets together under half the desired size."""
        node = self.client._table_node(path)
        desired = self._table_desired(node)
        counts = self.tablet_row_counts(path)
        if any(c > 2 * desired for c in counts):
            return True
        return any(counts[i] + counts[i + 1] < desired // 2
                   for i in range(len(counts) - 1))

    def compute_pivots(self, path: str, desired: int) -> list[tuple]:
        """Quantile pivots over the live keys (sample-key analog)."""
        tablets = self.client._mounted_tablets(path)
        key_cols = tablets[0].schema.key_columns
        chunks = [t.read_snapshot() for t in tablets]
        total = sum(c.row_count for c in chunks)
        if total == 0:
            return []
        n_tablets = max(-(-total // desired), 1)
        positions = [i * total // n_tablets for i in range(1, n_tablets)]
        if not positions:
            return []
        planes, decoders = [], []
        for col in key_cols:
            plane, decode = _key_plane(col, chunks)
            planes.append(plane)
            decoders.append(decode)
        # lexsort_indices takes the major key last.
        order = lexsort_indices(list(reversed(planes)))
        at = order[torch.tensor(positions, dtype=torch.int64,
                                device=order.device)]
        values = [decode(plane[at].cpu().numpy())
                  for (plane, _), decode in zip(planes, decoders)]
        pivots: list[tuple] = []
        for pivot in zip(*values):
            if not pivots or pivot > pivots[-1]:
                pivots.append(pivot)
        return pivots

    def balance_table(self, path: str) -> bool:
        """Reshard one table if unbalanced.  Returns True when resharded."""
        node = self.client._table_node(path)
        if not self.needs_balancing(path):
            return False
        desired = self._table_desired(node)
        pivots = self.compute_pivots(path, desired)
        self.client.unmount_table(path)
        try:
            self.client.reshard_table(path, pivots)
        finally:
            self.client.mount_table(path)
        return True

    def step(self) -> dict:
        """One balancer pass over every mounted sorted dynamic table with
        balancing enabled (@enable_tablet_balancer, default True)."""
        out = {}
        stack = [("/", self.client.cluster.master.tree.root)]
        while stack:
            path, node = stack.pop()
            for name, child in node.children.items():
                # "//a" under the root, "//a/b" below it (the reference
                # prefixes one more slash per level: "///a/b").
                stack.append((f"/{path}{name}" if path == "/" else
                              f"{path}/{name}", child))
            if node.type != "table" or \
                    not node.attributes.get("dynamic") or \
                    node.attributes.get("tablet_state") != "mounted":
                continue
            if node.attributes.get("enable_tablet_balancer") is False:
                continue
            try:
                tablets = self.client.cluster.tablets.get(node.id)
                if not tablets or not tablets[0].schema.is_sorted:
                    continue
                out[path] = self.balance_table(path)
            except YtError as err:
                out[path] = str(err)
        return out


def _key_plane(col, chunks: list):
    """One key column of every tablet's snapshot as a single plane on the
    tablets' device, in the order of Python's comparison of its values
    (a string column as ranks in the union of the tablets' sorted
    vocabularies), with the decoder of the plane's values to the row
    values `to_rows` gives. Raises a YtError on a null key or a key type
    Python's tuple sort does not order."""
    if col.type not in _ORDERED_TYPES:
        raise YtError(f"Cannot balance on key column {col.name!r} of type "
                      f"{col.type.value}", code=EErrorCode.InvalidConfig)
    columns = [(c.columns[col.name], c.row_count) for c in chunks]
    for column, n in columns:
        if n and not bool(column.valid[:n].all()):
            raise YtError(f"Cannot balance on key column {col.name!r}: it "
                          "holds a null, which has no order against its "
                          "values", code=EErrorCode.InvalidConfig)
    if col.type is EValueType.string:
        vocabs = [np.asarray(c.dictionary if c.dictionary is not None
                             else [], dtype=object) for c, _ in columns]
        union = np.unique(np.concatenate(vocabs)) if any(
            len(v) for v in vocabs) else np.array([], dtype=object)
        parts = []
        for (column, n), vocab in zip(columns, vocabs):
            rank = torch.from_numpy(np.searchsorted(union, vocab).astype(
                np.int64)).to(column.data.device)
            codes = column.data[:n].to(torch.int64)
            parts.append(rank[codes] if len(vocab) else codes)
        plane = torch.cat(parts)
        return (plane, False), lambda ranks: [bytes(union[r])
                                              for r in ranks.tolist()]
    plane = torch.cat([column.data[:n] for column, n in columns])
    if col.type is EValueType.uint64:
        return (plane, True), lambda v: v.view(np.uint64).tolist()
    if col.type is EValueType.boolean:
        return (plane, False), lambda v: v.astype(bool).tolist()
    if col.type is EValueType.double:
        return (plane, False), lambda v: v.astype(np.float64).tolist()
    return (plane, False), lambda v: v.tolist()
