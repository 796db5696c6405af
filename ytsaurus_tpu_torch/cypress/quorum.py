"""WAL backend of the master, the local part.

Own copy of the JAX package's `cypress/quorum.py` as far as `Master`
needs it: `LocalWal`, the fsync'd changelog file of one location (ref
Hydra file changelogs), and `record_epoch`, the epoch a record was
created under. `QuorumWal`, the quorum of journal locations on data
nodes, waits for the port's `server/` slice.
"""

from __future__ import annotations

import os
from typing import Optional

from ytsaurus_tpu_torch.cypress.master import Changelog
from ytsaurus_tpu_torch.errors import YtError

# Key under which a record carries the epoch of the writer that created
# it.  Tagged in place (records are master-mutation dicts); records
# written before epoch tagging existed read as epoch 0.
EPOCH_KEY = "$qe"


def record_epoch(record) -> int:
    """Epoch the record was created under (0 for pre-tagging records)."""
    if isinstance(record, dict):
        return int(record.get(EPOCH_KEY, 0))
    return 0


class LocalWal:
    """Single-location WAL: today's fsync'd changelog file.

    A `.init` marker distinguishes "this location has legitimately empty
    history" from "this is a fresh disk that never saw the log" — a fresh
    disk must NOT vote a zero-length prefix in quorum recovery (it would
    truncate acknowledged records)."""

    def __init__(self, path: str):
        self.path = path
        self._log: Optional[Changelog] = None
        self._last_offset: Optional[int] = None
        self.was_initialized = os.path.exists(path + ".init") or \
            os.path.exists(path)

    def _mark_initialized(self) -> None:
        marker = self.path + ".init"
        if not os.path.exists(marker):
            os.makedirs(os.path.dirname(marker) or ".", exist_ok=True)
            with open(marker, "wb") as f:
                f.flush()
                os.fsync(f.fileno())

    def recover(self) -> list[dict]:
        records, valid = Changelog.read_all(self.path)
        self._mark_initialized()
        # Drop a torn tail so future appends stay recoverable.
        if os.path.exists(self.path) and \
                os.path.getsize(self.path) > valid:
            with open(self.path, "r+b") as f:
                f.truncate(valid)
                f.flush()
                os.fsync(f.fileno())
        self._log = Changelog(self.path)
        return records

    def append(self, record: dict) -> None:
        self._last_offset = self._log.append(record)

    def drop_last(self) -> None:
        """Remove exactly the most recent append — O(1), no rewrite.
        Valid only immediately after an append (the offset is not
        tracked across recover/reset)."""
        if self._last_offset is None:
            raise YtError("no append to drop")
        self._log.truncate_to(self._last_offset)
        self._last_offset = None

    def reset(self) -> None:
        """Truncate after a snapshot."""
        self._log.close()
        self._last_offset = None
        if os.path.exists(self.path):
            os.unlink(self.path)
        self._log = Changelog(self.path)

    def close(self) -> None:
        if self._log is not None:
            self._log.close()

    # Snapshot replication is a no-op for a single-location WAL.
    def store_snapshot(self, seq: int, blob: bytes) -> None:
        pass

    def fetch_snapshot(self) -> "tuple[int, bytes] | None":
        return None
