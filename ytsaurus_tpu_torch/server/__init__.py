"""Server processes: the multi-host half of the cluster.

Ref mapping (design, not translation):
  data node chunk and journal service, node tracker, driver proxy
                                                → services.py
  ytserver-all multiplexed binary (server/all/main.cpp)
                                                → daemon.py --role
  Orchid and the monitoring pull endpoint       → orchid.py, monitoring.py
  discovery, master cache, chunk replicator and merger, P2P seeding,
  exec nodes, the scheduler / controller agent  → discovery.py,
    master_cache.py, chunk_replicator.py, chunk_merger.py, p2p.py,
    exec_service.py, scheduler_daemon.py
  the HTTP and TCP proxies, the query tracker, the queue agent and the
  view daemon (also run inside one process)     → http_proxy.py,
    tcp_proxy.py, query_tracker.py, queue_agent.py, view_daemon.py
  YTInstance local clusters
    (yt/python/yt/environment/yt_env.py:179)    → ../environment/local.py
"""
