"""Daemon entry: `python -m ytsaurus_tpu_torch.server.daemon --role primary|node`.

The multiplexed-binary pattern (ref server/all/main.cpp): one entry point,
role picked by flag.

  primary  — metadata master + tablet host + transaction coordinator +
             scheduler + driver proxy, with chunk data placed on remote
             data nodes (RpcChunkStore) once any register; falls back to a
             local store location until then.
  node     — blob chunk store + journal location, heartbeating to the
             primary.

The bound port is written to <root>/<role>.port for launcher discovery.

Own copy of the JAX package's `server/daemon.py`, with its roles
primary, node, clock, proxy, tcp_proxy, scheduler and master_cache. The
reference pins every daemon to the CPU; here the `primary` and
`scheduler` roles take `--device` (default cuda, resolved by
`device.py::resolve_device`, which raises when no card is present: the
daemon then exits non-zero before it binds a port) and run their
evaluator, chunk cache, chunk merger and operation controllers there.
The node, clock and proxy roles hold bytes and open no CUDA context.

The primary's orchid mounts `/query/device`: its device, the card's
name and the launch counts of the port's radix kernels in this process,
so a caller in another process sees the kernels run; and
`/query/device/trace/start` / `.../stop`, a device trace that gives the
device time of what ran between the two reads (`DeviceTrace`). The
reference's AOT artifact store, tier ladder and capture prewarm have no
counterpart (nothing is compiled). Not ported yet, each refused with a YtError that
names its module: `--kafka` (server/kafka_proxy.py) and the continuous
profiler that `YT_TPU_PROFILER_INTERVAL` arms (utils/profiler.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time


def _write_port_file(root: str, role: str, port: int) -> None:
    path = os.path.join(root, f"{role}.port")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(port))
    os.replace(tmp, path)


def run_primary(root: str, port: int, replication_factor: int = 2,
                journal_nodes: int = 3,
                bootstrap_timeout: float = 60.0,
                election: bool = False, master_index: int = 0,
                lease_ttl: float = 6.0, kafka: bool = False,
                clocks: "str | None" = None,
                device: str = "cuda") -> None:
    from ytsaurus_tpu_torch import yson
    from ytsaurus_tpu_torch.device import resolve_device
    from ytsaurus_tpu_torch.client import YtClient, YtCluster
    from ytsaurus_tpu_torch.cypress.election import LeaderElector
    from ytsaurus_tpu_torch.cypress.master import Master
    from ytsaurus_tpu_torch.cypress.quorum import QuorumWal
    from ytsaurus_tpu_torch.errors import YtError
    from ytsaurus_tpu_torch.rpc import Channel, RetryingChannel, RpcServer
    from ytsaurus_tpu_torch.server.remote_store import RpcChunkStore
    from ytsaurus_tpu_torch.server.services import (
        DriverService,
        MasterService,
        NodeTracker,
        NodeTrackerService,
    )

    from ytsaurus_tpu_torch.server.monitoring import MonitoringServer
    from ytsaurus_tpu_torch.server.orchid import OrchidService, default_orchid

    # The card first: a primary that cannot open it exits before it
    # binds a port, never serving from the CPU instead.
    device = resolve_device(device)
    trace = DeviceTrace(device)
    if kafka:
        raise YtError("--kafka is not ported yet (server/kafka_proxy.py, "
                      "server/kafka_groups.py)")
    if os.environ.get("YT_TPU_PROFILER_INTERVAL", "") not in ("", "0"):
        raise YtError("YT_TPU_PROFILER_INTERVAL arms the continuous "
                      "profiler, which is not ported yet "
                      "(utils/profiler.py)")
    os.makedirs(root, exist_ok=True)
    tracker = NodeTracker()
    # Bootstrap service set first: nodes must be able to register before
    # the master recovers (quorum WAL recovery reads their journals).
    role = {"value": "follower" if election else "leader"}
    server = RpcServer([NodeTrackerService(tracker),
                        MasterService(role)], port=port)
    server.start()
    _write_port_file(root, "primary", server.port)
    orchid = default_orchid()
    orchid.register("/node_tracker/alive", tracker.alive)
    orchid.register("/master/role", lambda: role["value"])
    server.add_service(OrchidService(orchid))
    monitoring = MonitoringServer(orchid)
    monitoring.start()
    _write_port_file(root, "primary.monitoring", monitoring.port)
    print(f"primary bootstrap on {server.address}", flush=True)

    # Journal membership is STICKY: chosen once, persisted, reused across
    # restarts so recovery always consults the same journal owners.
    journal_cfg_path = os.path.join(root, "journal_config.yson")
    wanted: list[str] | None = None
    if os.path.exists(journal_cfg_path):
        with open(journal_cfg_path, "rb") as f:
            wanted = [j.decode() if isinstance(j, bytes) else j
                      for j in yson.loads(f.read())["journal_node_ids"]]
    def _fetch_published_membership(
            ) -> "tuple[list[str] | None, bool]":
        """(highest-epoch membership record found on any alive node,
        every-alive-node-answered).  Under multi-master election the
        journal nodes are the shared source of truth for WHICH nodes
        form the quorum set — each master guessing from its own
        registration-order view could yield non-intersecting quorum
        sets (acked-write loss).  The completeness bit gates choosing a
        FRESH membership: "no record found" only counts when every node
        actually answered."""
        best: "tuple[int, list[str]] | None" = None
        complete = True
        for _, addr in sorted(tracker.alive().items()):
            channel = Channel(addr, timeout=5)
            try:
                body, _ = channel.call("data_node",
                                       "journal_membership_get",
                                       {"journal": "master_wal"})
                members = body.get("member_ids")
                if members is not None:
                    members = [m.decode() if isinstance(m, bytes) else m
                               for m in members]
                    epoch = int(body.get("epoch", 0))
                    if best is None or epoch > best[0]:
                        best = (epoch, members)
            except YtError:
                complete = False
                continue
            finally:
                channel.close()
        return (best[1] if best is not None else None), complete

    deadline = time.monotonic() + bootstrap_timeout
    chosen: dict[str, str] = {}
    had_prior_config = wanted is not None
    fresh_bootstrap = False
    clean_sweeps = 0
    if election:
        # Under election the sticky LOCAL config is advisory only: the
        # record published on the journal nodes (highest epoch) always
        # wins, since membership may have been upgraded by another
        # master while this one was down.
        wanted = None
    while time.monotonic() < deadline:
        alive = tracker.alive()
        if election:
            # Prefer membership already published to the journal nodes
            # (a previous leader's choice) over choosing our own.
            published, complete = _fetch_published_membership()
            if published is not None:
                if published != wanted:
                    wanted = published
                    continue
            elif wanted is None:
                # A fresh membership may be chosen ONLY by master 0, on
                # a root with no prior config (a restart implies a
                # published record exists somewhere — wait for it), and
                # only after two consecutive COMPLETE sweeps of enough
                # nodes found nothing (a transiently unreachable node
                # may be the one holding the record).
                clean_sweeps = clean_sweeps + 1 \
                    if complete and len(alive) >= journal_nodes else 0
                if master_index != 0 or had_prior_config or \
                        clean_sweeps < 2:
                    time.sleep(0.3)
                    continue
                chosen = dict(sorted(alive.items())[:journal_nodes])
                fresh_bootstrap = True
                break
        if wanted is not None:
            if all(i in alive for i in wanted):
                chosen = {i: alive[i] for i in wanted}
                break
        elif len(alive) >= journal_nodes:
            chosen = dict(sorted(alive.items())[:journal_nodes])
            break
        time.sleep(0.2)
    else:
        if wanted is not None:
            raise YtError(f"journal nodes {wanted} did not register within "
                          f"{bootstrap_timeout}s")
        if election:
            # No degraded bootstrap under election: divergent degraded
            # sets across masters can fail to intersect.
            raise YtError(
                f"election bootstrap needs {journal_nodes} journal nodes "
                f"(or a published membership) within {bootstrap_timeout}s")
        # Fewer nodes than asked for: take what registered rather than
        # collapsing to a local-only WAL.  Epoch acquisition needs a
        # strict majority of remotes, so an ODD remote count (default 3)
        # keeps takeover live under one dead journal node; an even count
        # still appends fine but requires all remotes up at takeover.
        alive = tracker.alive()
        if alive and journal_nodes > 0:
            chosen = dict(sorted(alive.items())[:journal_nodes])
            print(f"# only {len(chosen)}/{journal_nodes} journal nodes "
                  f"registered within {bootstrap_timeout}s; using "
                  f"{sorted(chosen)} (membership upgrades after recovery "
                  "as more nodes register)", flush=True)
        else:
            print(f"# no data nodes within {bootstrap_timeout}s; "
                  "falling back to local-only WAL", flush=True)

    def _persist_journal_config(ids: list[str]) -> None:
        tmp = journal_cfg_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(yson.dumps({"journal_node_ids": sorted(ids)},
                               binary=True))
        os.replace(tmp, journal_cfg_path)

    if chosen and wanted is None:
        _persist_journal_config(sorted(chosen))

    master_dir = os.path.join(root, "master")
    os.makedirs(master_dir, exist_ok=True)
    wal = None
    elector = None

    def _build_channels(members: dict) -> list:
        return [RetryingChannel(Channel(addr, timeout=30),
                                attempts=2, backoff=0.1)
                for _, addr in sorted(members.items())]

    if chosen:
        channels = _build_channels(chosen)

        def make_wal():
            # First adoption of this quorum config (we just wrote the
            # journal membership): any existing local log predates the
            # quorum and is authoritative — it seeds the replicas
            # instead of being outvoted by their empty journals.  Under
            # election only a verified FRESH bootstrap (master 0, no
            # prior config, complete no-record sweeps) may treat local
            # history as authoritative: anything else would reset the
            # journals from a stale or empty local log.
            # Election mode uses a REMOTE-ONLY quorum: a failover
            # successor recovers with a fresh local location, so read
            # and write quorums must intersect over the shared journal
            # nodes alone (see QuorumWal.count_local_ack).
            locations = 1 + len(channels)
            return QuorumWal(
                os.path.join(master_dir, Master.CHANGELOG),
                journal_name="master_wal",
                remote_channels=channels,
                quorum=(len(channels) // 2 + 1) if election
                else locations // 2 + 1,
                count_local_ack=not election,
                bootstrap_from_local=(
                    fresh_bootstrap if election else wanted is None),
                lease_ttl=lease_ttl if election else 0.0)

        wal = make_wal()
        print(f"quorum WAL over local + {sorted(chosen)} "
              f"(quorum {wal.quorum})", flush=True)
    if election and wal is None:
        raise YtError("--election requires journal nodes (the journal "
                      "plane carries votes and leases)")
    def _publish_membership() -> None:
        """Write the (epoch-stamped) membership to every journal node so
        any master resolves the same quorum set."""
        for replica in wal.replicas:
            try:
                replica.channel.call(
                    "data_node", "journal_membership_put",
                    {"journal": wal.journal_name, "epoch": wal.epoch,
                     "writer": wal.writer_id,
                     "member_ids": sorted(chosen)}, idempotent=False)
            except YtError as err:
                print(f"# membership publish failed on one node: {err}",
                      flush=True)

    if election:
        # Candidate loop: wait for the lease plane to be takeover-free,
        # then try to win the epoch (which also claims the lease on each
        # granting location).  A lost race returns to standby.
        while True:
            elector = LeaderElector(
                "master_wal",
                lambda: [r.channel for r in wal.replicas],
                wal.writer_id, lease_ttl=lease_ttl,
                hold_down=master_index * (lease_ttl / 4.0))
            print(f"standby (master {master_index}): awaiting "
                  "leadership", flush=True)
            elector.wait_until_electable()
            # Re-resolve membership RIGHT BEFORE takeover: the previous
            # leader may have upgraded it while this standby slept, and
            # recovering over a stale subset could drop records acked on
            # the newer set (then re-publish the stale set at a higher
            # epoch, poisoning future bootstraps).
            latest, _ = _fetch_published_membership()
            if latest is not None and sorted(latest) != sorted(chosen):
                alive_now = tracker.alive()
                if all(i in alive_now for i in latest):
                    print(f"membership changed to {sorted(latest)}; "
                          "rebuilding WAL", flush=True)
                    elector.stop()
                    wal.close()
                    chosen.clear()
                    chosen.update({i: alive_now[i] for i in latest})
                    _persist_journal_config(sorted(chosen))
                    channels = _build_channels(chosen)
                    wal = make_wal()
                    continue
            try:
                master = Master(master_dir, wal=wal)
                break
            except YtError as err:
                print(f"takeover failed: {err}; back to standby",
                      flush=True)
                elector.stop()
                wal.close()          # no fd leak across retries
                time.sleep(1.0)
                wal = make_wal()     # fresh writer identity for next try
        _publish_membership()
    else:
        master = Master(master_dir, wal=wal)
    # A membership persisted while under-strength (slow node startup on a
    # previous boot) upgrades here, AFTER recovery: new locations are
    # seeded with the full committed log before the larger quorum is
    # adopted, so the sticky config never pins the cluster to a degraded
    # journal set forever.
    if wal is not None and len(chosen) < journal_nodes:
        extra = {i: a for i, a in sorted(tracker.alive().items())
                 if i not in chosen}
        extra = dict(list(extra.items())[:journal_nodes - len(chosen)])
        adopted = {}
        for node_id, addr in sorted(extra.items()):
            channel = RetryingChannel(Channel(addr, timeout=30),
                                      attempts=2, backoff=0.1)
            # One node at a time: only nodes the WAL actually KEPT are
            # persisted — a failed catch-up must not become a phantom
            # quorum member that outvotes acknowledged records next boot.
            if wal.extend([channel]) == 1:
                adopted[node_id] = addr
        if adopted:
            chosen.update(adopted)
            _persist_journal_config(sorted(chosen))
            if election:
                _publish_membership()
            print(f"quorum WAL membership upgraded to "
                  f"{sorted(chosen)} (quorum {wal.quorum})",
                  flush=True)
    if election and elector is not None:
        def on_lease_lost():
            # The automaton may be ahead of what a new leader recovered;
            # serving (even reads) risks confusion — fail-stop for a
            # supervised restart as a follower (Hydra restart semantics).
            master._poisoned = True
            role["value"] = "follower"
            print("leadership lost (lease not renewable); exiting for "
                  "supervised restart", flush=True)
            os._exit(17)

        # Epoch via callable: _maybe_reacquire bumps it after orphaned
        # fences, and renewals must follow or a healthy leader's
        # renewals are denied everywhere.
        elector.start_renewing(lambda: wal.epoch, on_lease_lost)
    # The primary holds NO chunk location of its own: all chunk data lives
    # on data-node processes.
    store = RpcChunkStore(tracker.alive_nodes,
                          replication_factor=replication_factor)
    cluster = YtCluster(root, chunk_store=store, master=master,
                        device=device)
    cluster.node_directory = tracker.alive    # enables exec-node dispatch
    if clocks:
        # Tablet commits take timestamps from the CLOCK QUORUM, not an
        # in-process provider: timestamps stay monotone across master
        # failover because the oracle outlives any master (ref
        # clock_server/cluster_clock).
        from ytsaurus_tpu_torch.tablet.clock import QuorumTimestampProvider
        provider = QuorumTimestampProvider(
            [a.strip() for a in clocks.split(",") if a.strip()])
        cluster.transactions.timestamps = provider
        print(f"tablet timestamps from clock quorum: {clocks}",
              flush=True)
    client = YtClient(cluster)
    server.add_service(DriverService(client))
    # The device plane: where this primary's evaluator, chunk cache and
    # chunk merger run, the launches of the port's kernels there, and a
    # device trace a caller in another process opens and closes.
    orchid.register("/query/device", lambda: _device_state(device))
    orchid.register("/query/device/trace/start", trace.start)
    orchid.register("/query/device/trace/stop", trace.stop)
    # Background re-replication: a dead node's chunks regain their
    # replication factor within ~interval, read or no read (ref
    # chunk_replicator.h).  A follower's empty node tracker makes its
    # scans no-ops, so starting unconditionally is safe under election.
    # Liveness from the metadata tree keeps deleted chunks from being
    # resurrected off a node that missed their removal.
    from ytsaurus_tpu_torch.server.chunk_replicator import ChunkReplicator
    replicator = ChunkReplicator(
        tracker.alive_nodes, replication_factor=replication_factor,
        liveness_provider=client.referenced_chunk_ids)
    replicator.start()
    orchid.register("/chunk_replicator", lambda: dict(replicator.stats))
    # Small-chunk background compaction (ref chunk_merger.h:136).
    from ytsaurus_tpu_torch.server.chunk_merger import ChunkMerger
    merger = ChunkMerger(client).start()
    orchid.register("/chunk_merger", lambda: dict(merger.stats))
    # Generalized service discovery (ref server/discovery_server): any
    # process can publish into named groups; NodeTracker stays the
    # data-node special case.
    from ytsaurus_tpu_torch.server.discovery import (
        DAEMONS_GROUP,
        DiscoveryService,
        DiscoveryTracker,
        announce_daemon,
    )
    discovery = DiscoveryTracker()
    server.add_service(DiscoveryService(discovery))
    orchid.register("/discovery", discovery.list_groups)
    # Cluster telemetry plane: start the sampler that fills
    # the metrics-history rings + evaluates SLO burn rates, register
    # this primary's monitoring endpoint in /daemons, and wire the
    # /cluster roll-up to scrape every registered member.
    from ytsaurus_tpu_torch.utils.profiling import start_telemetry
    start_telemetry()
    announce_daemon(discovery, "primary", monitoring.address,
                    role="primary")
    monitoring.cluster_members = \
        lambda: discovery.list_members(DAEMONS_GROUP)
    if os.environ.get("YT_TPU_SEQUOIA", "") not in ("", "0"):
        # Sequoia resolve ground table (cypress/sequoia.py): path
        # resolution served from a dynamic table, kept consistent off
        # the mutation stream.
        from ytsaurus_tpu_torch.cypress.sequoia import SequoiaResolver
        sequoia = SequoiaResolver(client).enable()
        # verify() is a full tree walk + three ground-table scans under
        # the mutation lock — far too heavy to run on EVERY /sequoia
        # Orchid read (each read would stall the whole mutation stream).
        # Reads serve cached counters; verification runs on a background
        # cadence, and /sequoia/verify is the explicit on-demand action.
        verify_state = {"divergent": [], "verify_runs": 0,
                        "verified_at": None}

        def _sequoia_verify():
            # The tree walk compares live tree vs table snapshots: hold
            # the mutation lock so a concurrent mutation can't produce a
            # torn (spuriously divergent) read.
            with client.cluster.master.mutation_lock:
                divergent = sequoia.verify()
            verify_state["divergent"] = divergent
            verify_state["verify_runs"] += 1
            verify_state["verified_at"] = time.time()
            return {"divergent": divergent,
                    "verify_runs": verify_state["verify_runs"]}

        def _sequoia_state():
            return {"enabled": True,
                    "records": len(sequoia._paths),
                    "divergent": list(verify_state["divergent"]),
                    "verify_runs": verify_state["verify_runs"],
                    "verified_at": verify_state["verified_at"]}

        _sequoia_verify()                  # one startup pass seeds the cache
        verify_interval = float(
            os.environ.get("YT_TPU_SEQUOIA_VERIFY_INTERVAL", 60))

        def _sequoia_verify_loop() -> None:
            while True:
                time.sleep(verify_interval)
                try:
                    _sequoia_verify()
                except Exception as exc:  # noqa: BLE001 — keep the cadence
                    print(f"# sequoia verify failed: {exc}", flush=True)

        if verify_interval > 0:
            threading.Thread(target=_sequoia_verify_loop, daemon=True,
                             name="sequoia-verify").start()
        orchid.register("/sequoia", _sequoia_state)
        orchid.register("/sequoia/verify", _sequoia_verify)
        print("sequoia ground tables enabled", flush=True)
    role["value"] = "leader"
    print(f"primary serving on {server.address} (device {device})"
          + (f" (leader, master {master_index})" if election else ""),
          flush=True)
    threading.Event().wait()       # serve until killed


def _device_state(device) -> dict:
    """The primary's `/query/device`: its device, the card's name, and
    the launch counts of the port's radix kernels in this process (on a
    CPU device the kernels' plain versions run and count nothing)."""
    import torch

    from ytsaurus_tpu_torch.ops import radix
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    return {"device": str(device), "name": name,
            "launches": dict(radix.launches)}


# torch.cuda._sleep cycles of the pads that open and close a device trace
# (the profiler drops device events its clock places outside the
# session): ≈ 20 ms at the H100's top SM clock.
_TRACE_PAD_CYCLES = 40_000_000
_TRACE_KERNELS = {"radix_upsweep": "radix_upsweep_kernel",
                  "radix_onesweep": "radix_onesweep_kernel"}


class DeviceTrace:
    """A torch.profiler session over the primary's card that two orchid
    reads open and close (`/query/device/trace/start`, `.../stop`, as
    `/sequoia/verify` is an action), so that a client in another process
    reads the device time its requests cost here: the kernels' busy
    time (the union of their spans), the idle share of the window, and
    the port's kernels traced. CUDA activity only: the kernels of every
    thread of the process. The session lives on a thread of its own,
    since torch stops a profiler only on the thread that started it. On
    a CPU device both reads raise: there is no device time to trace.

    A process's first profiler session spends seconds initializing the
    tracer (10.4 and 11.1 s in one chip_smoke run on the H100's host), so
    on a CUDA device an empty session runs on a thread of its own as
    soon as the object is made, while the daemon starts; the first
    `start` waits for it."""

    def __init__(self, device):
        self.device = device
        self._lock = threading.Lock()
        self._open = None              # (stop event, thread, result box)
        self._warm = None
        if device.type == "cuda":
            self._warm = threading.Thread(target=self._warm_up, daemon=True,
                                          name="device-trace-warm-up")
            self._warm.start()

    @staticmethod
    def _warm_up() -> None:
        from torch.profiler import ProfilerActivity, profile
        try:
            with profile(activities=[ProfilerActivity.CUDA]):
                pass
        except Exception as exc:   # noqa: BLE001 — `start` reports it
            print(f"# device trace warm-up failed: {exc!r}", flush=True)

    def start(self) -> dict:
        from ytsaurus_tpu_torch.errors import EErrorCode, YtError
        if self.device.type != "cuda":
            raise YtError(f"a device trace needs a CUDA device, this "
                          f"primary runs on {self.device}",
                          code=EErrorCode.InvalidConfig)
        with self._lock:
            if self._open is not None:
                raise YtError("a device trace is already open")
            self._warm.join()
            started, stop, box = threading.Event(), threading.Event(), {}
            thread = threading.Thread(target=self._session,
                                      args=(started, stop, box),
                                      daemon=True, name="device-trace")
            thread.start()
            started.wait()
            if "error" in box:
                thread.join()
                raise YtError(f"device trace failed to start: "
                              f"{box['error']}")
            self._open = (stop, thread, box)
        return {"open": True}

    def stop(self) -> dict:
        from ytsaurus_tpu_torch.errors import EErrorCode, YtError
        if self.device.type != "cuda":
            raise YtError(f"a device trace needs a CUDA device, this "
                          f"primary runs on {self.device}",
                          code=EErrorCode.InvalidConfig)
        with self._lock:
            if self._open is None:
                raise YtError("no device trace is open")
            stop, thread, box = self._open
            self._open = None
        stop.set()
        thread.join()
        if "error" in box:
            raise YtError(f"device trace failed: {box['error']}")
        return box["result"]

    def _session(self, started, stop, box) -> None:
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        try:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            with torch.cuda.device(self.device):
                torch.cuda._sleep(_TRACE_PAD_CYCLES)
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
        except Exception as exc:   # noqa: BLE001 — reported to the caller
            box["error"] = repr(exc)
            started.set()
            return
        started.set()
        stop.wait()
        try:
            torch.cuda.synchronize(self.device)
            wall_us = (time.perf_counter() - t0) * 1e6
            with torch.cuda.device(self.device):
                torch.cuda._sleep(_TRACE_PAD_CYCLES)
            torch.cuda.synchronize(self.device)
            prof.stop()
            spans, traced = [], dict.fromkeys(_TRACE_KERNELS, 0)
            for e in prof.profiler.kineto_results.events():
                name = e.name()
                if e.device_type() != DeviceType.CUDA or \
                        "spin_kernel" in name or \
                        getattr(e, "is_user_annotation", lambda: False)():
                    continue
                spans.append((e.start_ns() / 1e3, e.end_ns() / 1e3))
                for kernel, trace_name in _TRACE_KERNELS.items():
                    traced[kernel] += trace_name in name
            busy_us, reach = 0.0, float("-inf")
            for begin, end in sorted(spans):
                if end > reach:
                    busy_us += end - max(begin, reach)
                    reach = end
            box["result"] = {"wall_ms": wall_us / 1e3,
                             "device_busy_ms": busy_us / 1e3,
                             "idle_share": 1 - busy_us / wall_us,
                             "kernels": len(spans), "traced": traced}
        except Exception as exc:   # noqa: BLE001 — reported to the caller
            box["error"] = repr(exc)


def run_node(root: str, port: int, primary_address: str,
             node_id: str | None = None) -> None:
    from ytsaurus_tpu_torch.chunks.store import FsChunkStore
    from ytsaurus_tpu_torch.rpc import Channel, RetryingChannel, RpcServer
    from ytsaurus_tpu_torch.server.services import DataNodeService

    from ytsaurus_tpu_torch.server.monitoring import MonitoringServer
    from ytsaurus_tpu_torch.server.orchid import OrchidService, default_orchid

    from ytsaurus_tpu_torch.server.exec_service import ExecNodeService

    os.makedirs(root, exist_ok=True)
    node_id = node_id or os.path.basename(os.path.normpath(root))
    store = FsChunkStore(os.path.join(root, "chunks"))
    service = DataNodeService(store, os.path.join(root, "journals"))
    exec_service = ExecNodeService(store)
    orchid = default_orchid()
    orchid.register("/data_node", lambda: {
        "id": node_id, "chunk_count": len(store.list_chunks())})
    orchid.register("/exec_node", lambda: exec_service.exec_stats({}, ()))
    # Periodic checksum scrub: corrupt chunks quarantine themselves and
    # the master's replicator restores RF from healthy holders.
    scrub_interval = float(os.environ.get("YT_TPU_SCRUB_INTERVAL", 300))
    scrub_state = {"checked": 0, "corrupt": 0}

    def scrub_loop() -> None:
        while True:
            time.sleep(scrub_interval)
            try:
                out = service.scrub_chunks({}, ())
                scrub_state["checked"] += out["checked"]
                scrub_state["corrupt"] += len(out["corrupt"])
            except Exception as exc:  # noqa: BLE001 — keep scrubbing
                print(f"# scrub failed: {exc}", file=sys.stderr,
                      flush=True)

    if scrub_interval > 0:
        threading.Thread(target=scrub_loop, daemon=True,
                         name="chunk-scrubber").start()
    orchid.register("/data_node/scrub", lambda: dict(scrub_state))
    server = RpcServer([service, exec_service,
                        OrchidService(orchid)], port=port)
    server.start()
    _write_port_file(root, "node", server.port)
    # P2P hot-chunk distribution (ref data_node/p2p.h TP2PDistributor):
    # reads past the heat threshold seed copies onto peers, discovered
    # through the primary's node tracker.
    from ytsaurus_tpu_torch.server.p2p import P2PDistributor
    self_address = f"127.0.0.1:{server.port}"

    def p2p_peers() -> list:
        from ytsaurus_tpu_torch.errors import YtError as _YtError
        from ytsaurus_tpu_torch.rpc import Channel
        # Every primary answers (the node already heartbeats them all);
        # falling over keeps discovery alive when one master is down.
        for addr in primary_address.split(","):
            if not addr.strip():
                continue
            channel = Channel(addr.strip(), timeout=10)
            try:
                body, _ = channel.call("node_tracker", "list_nodes", {})
                return [a.decode() if isinstance(a, bytes) else a
                        for a in body.get("alive") or []]
            except _YtError:
                continue
            finally:
                channel.close()
        return []

    p2p = P2PDistributor(
        store, lambda: self_address, p2p_peers,
        hot_threshold=int(os.environ.get("YT_TPU_P2P_THRESHOLD", 50)),
        window=float(os.environ.get("YT_TPU_P2P_WINDOW", 5.0)),
        cooldown=float(os.environ.get("YT_TPU_P2P_COOLDOWN", 120.0)),
    ).start()
    service.p2p = p2p
    orchid.register("/data_node/p2p", lambda: dict(p2p.stats))
    monitoring = MonitoringServer(orchid)
    monitoring.start()
    _write_port_file(root, "node.monitoring", monitoring.port)
    # Telemetry plane: every daemon samples its own sensors
    # into bounded history rings; the primary's /cluster scrapes them.
    from ytsaurus_tpu_torch.server.discovery import DAEMONS_GROUP
    from ytsaurus_tpu_torch.utils.profiling import start_telemetry
    start_telemetry()
    print(f"data node {node_id} serving on {server.address}", flush=True)

    # Multi-master: heartbeat EVERY primary (comma-separated), each on
    # its OWN thread — a hung (not dead) master must not stall the
    # heartbeats that keep this node alive on the healthy leader.
    address = server.address

    def beat(primary: str) -> None:
        channel = RetryingChannel(Channel(primary, timeout=10),
                                  attempts=2, backoff=0.1)
        while True:
            try:
                channel.call("node_tracker", "heartbeat",
                             {"id": node_id, "address": address})
                # Telemetry membership rides the same cadence: the
                # primary's /cluster roll-up scrapes every /daemons
                # member's monitoring endpoint.  Own try: the discovery
                # service only comes up after WAL recovery, and its
                # absence during bootstrap must not spam the log (the
                # node_tracker beat above already succeeded).
                try:
                    channel.call("discovery", "heartbeat",
                                 {"group": DAEMONS_GROUP,
                                  "member_id": node_id,
                                  "address": monitoring.address,
                                  "attributes": {"role": "node"}})
                except Exception:   # noqa: BLE001
                    pass
            except Exception as exc:  # noqa: BLE001 — keep heartbeating
                print(f"# heartbeat to {primary} failed: {exc}",
                      file=sys.stderr, flush=True)
            time.sleep(2.0)

    primaries = [a.strip() for a in primary_address.split(",")
                 if a.strip()]
    for primary in primaries[1:]:
        threading.Thread(target=beat, args=(primary,),
                         daemon=True, name=f"heartbeat-{primary}").start()
    beat(primaries[0])


def run_clock(root: str, port: int, journals: "str | None", index: int,
              lease_ttl: float,
              journals_file: "str | None" = None) -> None:
    """Clock-quorum peer (ref server/clock_server/cluster_clock +
    server/timestamp_provider): serves HLC timestamps under a
    quorum-persisted ceiling, independent of the masters — tablet
    commits keep taking timestamps with the primary down.

    The RPC port binds FIRST (answering NotClockLeader until the core
    exists), so launchers can learn the address before the journal
    plane is even up; --journals-file is polled for the journal
    addresses, breaking the clock↔node startup ordering cycle without
    pre-allocating ports."""
    import time as _time

    from ytsaurus_tpu_torch.rpc import Channel, RpcServer
    from ytsaurus_tpu_torch.tablet.clock import (
        ClockServer,
        ClockService,
        NotClockLeader,
    )

    os.makedirs(root, exist_ok=True)
    holder: dict = {"clock": None}

    class _LateBound:
        def generate_batch(self, count=1):
            clock = holder["clock"]
            if clock is None:
                raise NotClockLeader()
            return clock.generate_batch(count)

        @property
        def is_leader(self):
            clock = holder["clock"]
            return bool(clock is not None and clock.is_leader)

    server = RpcServer([ClockService(_LateBound())], port=port)
    server.start()
    _write_port_file(root, "clock", server.port)
    print(f"clock peer {index} serving on {server.address}", flush=True)
    if journals is None:
        while True:
            try:
                with open(journals_file) as f:
                    journals = f.read().strip()
                if journals:
                    break
            except FileNotFoundError:
                pass
            _time.sleep(0.2)
    channels = [Channel(a.strip(), timeout=10)
                for a in journals.split(",") if a.strip()]
    holder["clock"] = ClockServer(root, channels, index=index,
                                  lease_ttl=lease_ttl).start()
    threading.Event().wait()


def run_proxy(root: str, port: int, primary_address: str) -> None:
    """HTTP proxy daemon: REST /api/v4 bridged to the primary's RPC plane
    (ref: the standalone http_proxy process, server/http_proxy)."""
    from ytsaurus_tpu_torch.remote_client import RemoteYtClient
    from ytsaurus_tpu_torch.server.http_proxy import HttpProxy

    os.makedirs(root, exist_ok=True)
    # The proxy holds no card: its clients run on the CPU.
    proxy = HttpProxy(
        lambda user: RemoteYtClient(primary_address, user=user,
                                    device="cpu"),
        port=port)
    _write_port_file(root, "proxy", proxy.port)
    print(f"http proxy serving on {proxy.address} -> {primary_address}",
          flush=True)
    proxy.serve_forever()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--role",
                        choices=("primary", "node", "proxy",
                                 "master_cache", "tcp_proxy", "clock",
                                 "scheduler"),
                        required=True)
    parser.add_argument("--journals", default=None,
                        help="journal-node addresses (clock role)")
    parser.add_argument("--journals-file", default=None,
                        help="file to poll for journal addresses "
                             "(clock role; alternative to --journals)")
    parser.add_argument("--clocks", default=None,
                        help="clock-peer addresses (primary role): take "
                             "tablet timestamps from the clock quorum")
    parser.add_argument("--root", required=True)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--primary", default=None,
                        help="primary address (node role)")
    parser.add_argument("--replication-factor", type=int, default=2)
    parser.add_argument("--journal-nodes", type=int, default=3,
                        help="remote WAL locations (0 = local-only WAL); "
                             "odd counts keep takeover live under one "
                             "dead journal node")
    parser.add_argument("--node-id", default=None)
    parser.add_argument("--bootstrap-timeout", type=float, default=60.0)
    parser.add_argument("--election", action="store_true",
                        help="multi-master mode: lease-based leader "
                             "election over the journal plane")
    parser.add_argument("--master-index", type=int, default=0,
                        help="this master's index (staggers takeover "
                             "attempts; index 0 bootstraps fresh "
                             "clusters)")
    parser.add_argument("--lease-ttl", type=float, default=6.0)
    parser.add_argument("--kafka", action="store_true",
                        help="serve the Kafka wire protocol over queues "
                             "(primary role; not ported yet: refused)")
    parser.add_argument("--device", default=None,
                        help="primary and scheduler roles: the device of "
                             "the evaluator, chunk cache and operation "
                             "controllers (default cuda; no fallback)")
    args = parser.parse_args()
    if args.device is not None and args.role not in ("primary",
                                                     "scheduler"):
        parser.error(f"--device applies to the primary and scheduler "
                     f"roles, not to --role {args.role}")
    device = args.device or "cuda"

    if args.role == "primary":
        run_primary(args.root, args.port, args.replication_factor,
                    journal_nodes=args.journal_nodes,
                    bootstrap_timeout=args.bootstrap_timeout,
                    election=args.election,
                    master_index=args.master_index,
                    lease_ttl=args.lease_ttl, kafka=args.kafka,
                    clocks=args.clocks, device=device)
    elif args.role == "proxy":
        if not args.primary:
            parser.error("--primary is required for --role proxy")
        run_proxy(args.root, args.port, args.primary)
    elif args.role == "master_cache":
        if not args.primary:
            parser.error("--primary is required for --role master_cache")
        from ytsaurus_tpu_torch.server.master_cache import run_master_cache
        run_master_cache(args.root, args.port, args.primary)
    elif args.role == "scheduler":
        if not args.primary:
            parser.error("--primary is required for --role scheduler")
        from ytsaurus_tpu_torch.server.scheduler_daemon import run_scheduler
        run_scheduler(args.root, args.port, args.primary, device=device)
    elif args.role == "clock":
        if not args.journals and not args.journals_file:
            parser.error("--journals or --journals-file is required "
                         "for --role clock")
        run_clock(args.root, args.port, args.journals,
                  args.master_index, args.lease_ttl,
                  journals_file=args.journals_file)
    elif args.role == "tcp_proxy":
        if not args.primary:
            parser.error("--primary is required for --role tcp_proxy")
        from ytsaurus_tpu_torch.server.tcp_proxy import TcpProxy
        os.makedirs(args.root, exist_ok=True)
        proxy = TcpProxy([a.strip() for a in args.primary.split(",")
                          if a.strip()], port=args.port).start()
        _write_port_file(args.root, "tcp_proxy", proxy.port)
        print(f"tcp proxy serving on {proxy.address} -> {args.primary}",
              flush=True)
        threading.Event().wait()
    else:
        if not args.primary:
            parser.error("--primary is required for --role node")
        run_node(args.root, args.port, args.primary, node_id=args.node_id)


if __name__ == "__main__":
    main()
