"""The quorum WAL's append rate over data nodes on 127.0.0.1.

    python3 -m ytsaurus_tpu_torch.bench.wal_rate [appends]

from the repo root. Three `DataNodeService`s, each behind an `RpcServer`
with a chunk location and a journal directory in a temporary directory,
take a `QuorumWal` (write quorum 2 of the 3 journals, the local copy
earning no credit, as CELLS's master runs it). It times `appends` appends
with all three nodes up and then with the third stopped, and prints one
JSON line of appends/s. Needs no card.
"""

from __future__ import annotations

import json
import logging
import sys
import tempfile
import time


def main() -> int:
    from ytsaurus_tpu_torch import rpc
    from ytsaurus_tpu_torch.chunks.store import FsChunkStore
    from ytsaurus_tpu_torch.cypress.quorum import QuorumWal
    from ytsaurus_tpu_torch.server.services import DataNodeService
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 500
    # Each append with a node down logs its failed catch-up.
    logging.getLogger("ytsaurus_tpu_torch.quorum").setLevel(logging.ERROR)
    out = {"appends": n}
    with tempfile.TemporaryDirectory() as root:
        servers = []
        for i in range(3):
            service = DataNodeService(FsChunkStore(f"{root}/loc{i}"),
                                      f"{root}/journal{i}")
            servers.append(rpc.RpcServer([service], port=0))
            servers[-1].start()
        wal = QuorumWal(f"{root}/master.log", "master_wal",
                        [rpc.Channel(s.address, timeout=30) for s in servers],
                        quorum=2, count_local_ack=False,
                        bootstrap_from_local=True)
        wal.recover()
        for label in ("three_up", "one_down"):
            if label == "one_down":
                servers.pop().stop()
            t = time.perf_counter()
            for i in range(n):
                wal.append({"op": "set", "args": {"path": f"//w/{i}",
                                                  "value": i}})
            out[f"{label}_per_s"] = n / (time.perf_counter() - t)
        wal.close()
        for server in servers:
            server.stop()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
