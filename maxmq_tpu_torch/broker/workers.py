"""Multi-core delivery: SO_REUSEPORT workers federated as an in-box
cluster (ADR 021, superseding the ADR-005 fan-out bus).

Copy of the JAX package's ``broker/workers.py`` with the same names.
Where it differs:

* ``device`` is threaded through: ``run_pool``, ``run_worker``,
  ``inprocess_pool`` and ``build_worker_broker`` take the keyword that
  ``bootstrap.build_broker`` and ``run_server`` take, and the sidecar's
  engines (``_engine_factory``) run on it — the card unless the parent
  was asked for the CPU.
* A worker is spawned as ``python -m maxmq_tpu_torch start --no-banner``
  with the parent's ``--device``.
* Workers hold no CUDA context: with ``matcher = "service"`` and the
  default ``filter_backend = "numpy"`` nothing in a worker touches the
  card, so the pool parent is the one process of the box that owns it.
* The pool parent's metrics endpoint (``pool_metrics_address``) also
  serves the sidecar's matcher counts and device counts (its batches,
  bypassed topics, kernel launches, shadow probes, table lag); a worker
  logs its matcher counts as it stops, and the parent each worker's exit
  code.
* The sidecar's engine warms its buckets as ``bootstrap.build_matcher``
  warms a broker's, and the service refreshes its tables as OP_SUB
  frames arrive, off the match path (F27).

The reference gets per-connection parallelism for free — one goroutine
per client spread over every host core (vendor/github.com/mochi-co/
mqtt/v2/clients.go:190-202, server.go:221). An asyncio broker caps
per-message work (decode, QoS bookkeeping, encode, socket writes) on a
single core, so N worker processes each run the FULL broker for the
connections the kernel hands them (``SO_REUSEPORT`` shards accepts with
no parent in the accept path).

Each worker IS a cluster node — ``w0..wN-1`` — meshed over unix-domain
bridge links (the ``local`` link flavor: connect-by-path, budget-exempt,
skew pinned to zero), so cross-worker publish forwarding, route-table
aggregation, retained convergence, epoch-fenced session takeover,
cluster-wide ``$share`` through the ShareLedger, and the ADR-018
``cluster_fwd_durability`` barriers are all the cluster federation's
machinery, not a parallel implementation. What this module owns is
process supervision (spawn, respawn-with-throttle, pool metrics) and the
per-worker config derivation.

Shared singletons per box (the perf point of ADR 021):

* ONE matcher sidecar — when the box config asks for a device engine
  (``sig``/``nfa``/``dense``), the pool parent runs a
  :class:`~..matching.service.MatcherService` on a pool socket and
  every worker attaches as a ``matcher=service`` client behind its own
  ADR-011 supervisor. Table compiles happen once per box, and match
  requests from all workers coalesce into the same device
  micro-batches.
* ONE write-behind journal — only ``worker_journal_owner`` (default 0)
  keeps ``storage_backend``; the owner restores the cluster session
  buckets at boot and the ADR-016 claim path routes each session to
  whichever worker its client reconnects to.

Mixed pool+cluster composition: ``cluster_peers`` entries are appended
to EVERY worker's peer list (full peering), so an external node that
lists each worker as a peer composes with the mesh under one set of
``cluster_share_balance`` ownership rules.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

from .. import faults

POOL_DIR_ENV = "MAXMQ_POOL_DIR"

# matcher engines the pool parent hoists into the shared sidecar; a
# box already on ``service`` points at an external sidecar, and the
# CPU trie stays per-worker (no card to share)
_SIDECAR_MATCHERS = ("sig", "nfa", "dense")


def worker_sock(pool_dir: str, worker_id: int) -> str:
    """The unix-domain socket worker ``worker_id`` accepts sibling
    bridge links on."""
    return os.path.join(pool_dir, f"w{worker_id}.sock")


def matcher_sock(pool_dir: str) -> str:
    return os.path.join(pool_dir, "matcher.sock")


def worker_node_id(conf, worker_id: int) -> str:
    """Cluster node id of one worker: ``w<i>``, prefixed with the box's
    own cluster identity when it has one (so a mixed pool+cluster mesh
    stays globally unambiguous)."""
    base = conf.cluster_node_id
    return f"{base}.w{worker_id}" if base else f"w{worker_id}"


def worker_conf(conf, worker_id: int, pool_dir: str):
    """Derive worker ``worker_id``'s Config from the box config.

    The worker mesh is expressed entirely through the ``cluster_*``
    surface: node id ``w<i>``, peers = every sibling over ``unix:``
    links plus the box's external ``cluster_peers`` verbatim, session
    sync per ``worker_session_sync`` (default ``always`` — a SIGKILLed
    worker's sibling must redeliver every PUBACKed message). Singleton
    ownership: only ``worker_journal_owner`` keeps the storage backend,
    only worker 0 keeps the unshareable listeners (unix socket, $SYS
    HTTP) and serves the metrics address, and device matchers are
    rewritten to ``service`` against the shared sidecar.
    """
    siblings = ",".join(
        f"{worker_node_id(conf, j)}@unix:{worker_sock(pool_dir, j)}"
        for j in range(conf.workers) if j != worker_id)
    peers = ",".join(p for p in (siblings, conf.cluster_peers.strip(", "))
                     if p)
    kw = dict(cluster_node_id=worker_node_id(conf, worker_id),
              cluster_peers=peers,
              cluster_session_sync=conf.worker_session_sync)
    if worker_id != conf.worker_journal_owner:
        kw["storage_backend"] = ""
    if worker_id != 0:
        # SO_REUSEPORT shards the TCP/WS listeners; the unix-socket and
        # $SYS-HTTP listeners (and metrics) cannot share an address
        kw["mqtt_unix_socket"] = ""
        kw["mqtt_sys_http_address"] = ""
    if conf.matcher in _SIDECAR_MATCHERS:
        kw["matcher"] = "service"
        kw["matcher_socket"] = matcher_sock(pool_dir)
    return dataclasses.replace(conf, **kw)


def _tune_local_links(manager, conf) -> None:
    """Apply the ``worker_link_*`` knobs to the loopback links ONLY —
    a mixed box's external TCP links keep the ``cluster_link_*``
    budget/keepalive they were built with."""
    if manager is None:
        return
    for link in manager.links.values():
        if link.local:
            link.byte_budget = conf.worker_link_byte_budget
            link.keepalive = float(conf.worker_link_keepalive)


def build_worker_broker(wconf, logger, worker_id: int, pool_dir: str,
                        device=None):
    """One worker's broker: the standard bootstrap build (so cluster,
    storage, tracing, and overload wiring are production-parity) plus
    the sibling-bridge unix listener every peer worker dials."""
    from ..bootstrap import build_broker
    from .listeners import UnixListener

    broker = build_broker(wconf, logger, device=device)
    path = worker_sock(pool_dir, worker_id)
    with contextlib.suppress(OSError):
        os.unlink(path)     # stale socket from a crashed incarnation
    broker.add_listener(UnixListener("peer-bridge", path))
    _tune_local_links(broker.cluster, wconf)
    return broker


async def run_worker(conf, logger, worker_id: int, pool_dir: str,
                     ready: asyncio.Event | None = None,
                     stop: asyncio.Event | None = None,
                     device=None) -> None:
    """One pool worker process: derive the worker config, run the full
    broker with its sibling mesh, serve until stopped."""
    from ..bootstrap import (_close_matcher, _maybe_attach_service,
                             _signal_stop_event, build_metrics)

    wconf = worker_conf(conf, worker_id, pool_dir)
    broker = build_worker_broker(wconf, logger, worker_id, pool_dir,
                                 device=device)
    # service matcher attaches BEFORE metrics so the matcher families
    # register (same ordering contract as run_server)
    await _maybe_attach_service(wconf, broker)
    metrics = build_metrics(wconf, broker, logger) if worker_id == 0 else None
    await broker.serve()
    if metrics is not None:
        metrics.start()
    logger.with_prefix("worker").info(
        "pool worker started", worker=worker_id, node=wconf.cluster_node_id,
        restore_s=broker.boot_seconds.get("restore", 0.0),
        replica_restore_s=getattr(getattr(broker.cluster, "sessions", None),
                                  "boot_seconds", {}).get("restore", 0.0))
    if ready is not None:
        ready.set()
    if stop is None:
        stop = _signal_stop_event()
    if faults.fire(faults.POOL_WORKER):
        # injected worker death (armed through the MAXMQ_FAULTS env the
        # pool parent propagates): exit now so the parent's supervision
        # loop observes the exit and respawns us
        stop.set()
    try:
        await stop.wait()
    finally:
        _log_worker_counts(logger, worker_id, broker)
        await broker.close()
        if metrics is not None:
            metrics.stop()
        await _close_matcher(broker)
        with contextlib.suppress(OSError):
            os.unlink(worker_sock(pool_dir, worker_id))


def _log_worker_counts(logger, worker_id: int, broker) -> None:
    """The worker's matcher counts over its life, logged as it stops
    (only worker 0 serves ``/metrics``): trie answers by reason, breaker
    trips, pipeline degrades, and this process's K1 launches (0 in a
    worker: the sidecar runs the kernel)."""
    from ..matching.sig_kernel import sig_match_fixed

    matcher = broker.matcher
    logger.with_prefix("worker").info(
        "pool worker stopping", worker=worker_id,
        fallbacks=dict(getattr(matcher, "fallbacks_by_reason", {})),
        breaker_trips=getattr(matcher, "breaker_trips", 0),
        degrades=broker.matcher_degrades,
        launches=sig_match_fixed.launches)


class PoolStats:
    """Supervision counters for one pool parent, exported as the
    ``maxmq_pool_*`` family (metrics.register_pool_metrics)."""

    def __init__(self) -> None:
        self.worker_restarts = 0


# process-wide default (one pool parent per process); tests construct
# their own and pass it to _supervise_workers
POOL_STATS = PoolStats()


async def _supervise_workers(procs, spawn, boot, stats: PoolStats = None,
                             interval: float = 2.0) -> None:
    """A worker that dies (crash, OOM kill, injected fault) is logged,
    counted (stats.worker_restarts -> maxmq_pool_worker_restarts_total),
    and respawned — the pool must not silently degrade to N-1.
    Throttled per slot so a crash loop can't fork-bomb the host. The
    respawned incarnation re-binds its SO_REUSEPORT share and its
    sibling bridge socket; peers reconnect through the local links'
    fast backoff and re-exchange routes/sessions (epoch-fenced, so the
    dead incarnation's state flushes on arrival)."""
    stats = stats if stats is not None else POOL_STATS
    last_spawn = [0.0] * len(procs)
    while True:
        await asyncio.sleep(interval)
        for i, p in enumerate(procs):
            rc = p.poll()
            if rc is None:
                continue
            wait = max(0.0, 5.0 - (time.monotonic() - last_spawn[i]))
            boot.error("pool worker exited; restarting", worker=i,
                       rc=rc, backoff_s=round(wait, 1))
            if wait:
                await asyncio.sleep(wait)
            last_spawn[i] = time.monotonic()
            procs[i] = spawn(i)
            stats.worker_restarts += 1


async def await_mesh(brokers, timeout: float = 10.0) -> None:
    """Wait until every worker's link to every sibling is connected —
    the pool's "serving" point. Route/session exchange starts at each
    link-up, so callers that need a specific filter visible on a
    specific worker poll :func:`await_routes` after subscribing."""
    deadline = time.monotonic() + timeout
    while True:
        down = [(b.cluster.node_id, peer)
                for b in brokers
                for peer, link in b.cluster.links.items()
                if link.local and not link.connected]
        if not down:
            return
        if time.monotonic() >= deadline:
            raise TimeoutError(f"worker mesh not converged: {down}")
        await asyncio.sleep(0.01)


async def await_routes(broker, topic: str, n: int = 1,
                       timeout: float = 5.0) -> None:
    """Poll until ``broker``'s route table forwards ``topic`` to at
    least ``n`` peers. Publish forwarding is route-driven, so a
    subscribe on one worker is visible to a publisher on another only
    after the route advertisement lands — tests hop this barrier
    explicitly instead of sleeping."""
    deadline = time.monotonic() + timeout
    while len(broker.cluster.routes.nodes_for(topic)) < n:
        if time.monotonic() >= deadline:
            raise TimeoutError(f"route for {topic!r} never reached "
                               f"{broker.cluster.node_id}")
        await asyncio.sleep(0.01)


@contextlib.asynccontextmanager
async def inprocess_pool(n: int = 2, link_dir: str | None = None,
                         conf=None, converge: bool = True, device=None):
    """N pool workers in ONE process: the same build_worker_broker
    wiring the subprocess pool runs — per-worker ClusterManager, unix
    mesh links, shared-singleton config derivation — minus the process
    boundary (which only the kernel's SO_REUSEPORT accept sharding
    cares about; here each worker binds its own ephemeral port so
    tests can target a specific worker). Yields (brokers, ports).
    Also the embedding surface for hosts that want a pool without
    subprocesses."""
    from ..utils.config import Config
    from ..utils.logger import new_logger

    link_dir = link_dir or f"/tmp/maxmq-pool-inproc-{os.getpid()}"
    os.makedirs(link_dir, exist_ok=True)
    base = dataclasses.replace(
        conf or Config(), workers=n,
        mqtt_tcp_address="127.0.0.1:0", mqtt_unix_socket="",
        mqtt_sys_http_address="", mqtt_sys_topic_interval=0,
        metrics_enabled=False)
    logger = new_logger(fmt="json", level="error")
    brokers, ports = [], []
    try:
        for i in range(n):
            wconf = worker_conf(base, i, link_dir)
            b = build_worker_broker(wconf, logger, i, link_dir,
                                    device=device)
            await b.serve()
            brokers.append(b)
            lst = b.listeners.get("tcp")
            ports.append(lst._server.sockets[0].getsockname()[1])
        if converge:
            await await_mesh(brokers)
        yield brokers, ports
    finally:
        for b in brokers:
            await b.close()
        for i in range(n):
            with contextlib.suppress(OSError):
                os.unlink(worker_sock(link_dir, i))


def _engine_factory(conf, device=None):
    """The sidecar's engine build, mirroring bootstrap.build_matcher's
    device branches (sig/nfa/dense, mesh-sharded when configured) on
    ``device`` (None: the card) — the ONE table compile per box the
    workers share."""
    def factory(index):
        from ..matching.batcher import MicroBatcher
        if conf.matcher_mesh:
            from ..parallel.sharded import (ShardedNFAEngine,
                                            ShardedSigEngine, make_mesh)
            rows, _, cols = conf.matcher_mesh.partition("x")
            shape = (int(rows), int(cols or 1))
            mesh = make_mesh(shape=shape, devices=(
                None if device is None
                else [device] * (shape[0] * shape[1])))
            if conf.matcher == "nfa":
                engine = ShardedNFAEngine(index, mesh=mesh,
                                          max_levels=conf.matcher_max_levels)
            else:
                engine = ShardedSigEngine(index, mesh=mesh)
                engine.emit_intents = conf.matcher_intents
        elif conf.matcher == "nfa":
            from ..matching.engine import NFAEngine
            engine = NFAEngine(index, max_levels=conf.matcher_max_levels,
                               device=device)
        elif conf.matcher == "dense":
            from ..matching.dense import DenseEngine
            engine = DenseEngine(index, max_levels=conf.matcher_max_levels,
                                 device=device)
        else:
            from ..matching.sig import SigEngine
            engine = SigEngine(index, max_levels=conf.matcher_max_levels,
                               device=device)
            engine.emit_intents = conf.matcher_intents
        # as bootstrap.build_matcher warms a broker's engine: the bucket
        # ladder up to the batch cap, captured again after each rotation
        # (the service refreshes the tables as its index changes, F27)
        warm = getattr(engine, "warm_buckets", None)
        if warm is not None:
            warm(conf.matcher_max_batch)
        return MicroBatcher(engine,
                            window_us=conf.matcher_batch_window_us,
                            max_batch=conf.matcher_max_batch)
    return factory


async def _maybe_pool_matcher_service(conf, pool_dir: str, device=None):
    """ADR 021: one card-owning matcher sidecar per box. The parent
    owns it (N workers each holding a CUDA context would contend for
    the card and its memory), workers attach as ``matcher=service``
    clients behind their own ADR-011 supervisors, so a sidecar crash
    degrades every worker to its CPU trie and the reconnect ladder
    reseeds — never a pool-wide wedge."""
    if conf.matcher not in _SIDECAR_MATCHERS:
        return None
    from ..matching.service import MatcherService
    svc = MatcherService(matcher_sock(pool_dir),
                         engine_factory=_engine_factory(conf, device))
    await svc.start()
    return svc


def _worker_spawner(env: dict, device=None):
    """Build the pool's spawn(i) closure, scoping pool.worker faults
    to mean "kill A worker", not "kill every worker forever":
    MAXMQ_FAULTS is parsed at import in EACH subprocess, so an unscoped
    spec would re-arm in all N workers AND in every respawned
    replacement — a throttled permanent crash loop instead of a
    kill-once/recover drill. The first spawn keeps the pool.worker
    entries; every other spawn (other slots, and all respawns) gets
    them stripped. Each worker runs the port's CLI, with ``--device``
    where the parent has one."""
    fault_spec = env.get("MAXMQ_FAULTS", "")
    entries = [e.strip() for e in fault_spec.split(",") if e.strip()]
    kept = ",".join(e for e in entries
                    if not e.startswith(faults.POOL_WORKER))
    has_kill = any(e.startswith(faults.POOL_WORKER) for e in entries)
    delivered = [not has_kill]    # nothing to scope -> strip never
    argv = [sys.executable, "-m", "maxmq_tpu_torch", "start", "--no-banner"]
    if device is not None:
        argv += ["--device", str(device)]

    def spawn(i: int):
        wenv = dict(env)
        wenv["MAXMQ_WORKER_ID"] = str(i)
        if fault_spec and delivered[0]:
            if kept:
                wenv["MAXMQ_FAULTS"] = kept
            else:
                wenv.pop("MAXMQ_FAULTS", None)
        delivered[0] = True
        return subprocess.Popen(argv, env=wenv)

    return spawn


async def run_pool(conf, logger, ready: asyncio.Event | None = None,
                   stop: asyncio.Event | None = None, device=None) -> None:
    """The pool parent: shared matcher sidecar (on ``device``; None:
    the card) + N worker subprocesses + supervision. The parent never
    touches a client socket — the kernel (SO_REUSEPORT) shards accepts
    directly onto the workers — and never relays a message either: the
    workers mesh directly over their unix bridge sockets."""
    from ..bootstrap import _signal_stop_event
    from ..utils.config import config_as_dict

    boot = logger.with_prefix("pool")
    pool_dir = conf.worker_link_dir or f"/tmp/maxmq-pool-{os.getpid()}"
    os.makedirs(pool_dir, exist_ok=True)
    service = await _maybe_pool_matcher_service(conf, pool_dir, device)

    env = dict(os.environ)
    env[POOL_DIR_ENV] = pool_dir
    env["MAXMQ_POOL_CONF"] = json.dumps(config_as_dict(conf))
    spawn = _worker_spawner(env, device)

    procs = [spawn(i) for i in range(conf.workers)]
    stats = PoolStats()
    metrics = None
    if conf.pool_metrics_address:
        # parent-side metrics (worker 0 owns the broker metrics
        # address, so the pool family gets its own endpoint); with an
        # engine in the sidecar, also its matcher counts (batches,
        # bypassed topics, round trip) and the process's device counts
        # (kernel launches, shadow probes, table lag), as a single
        # broker's /metrics has them
        from ..bootstrap import _register_device_counts
        from ..metrics import (MetricsServer, Registry,
                               register_matcher_stats, register_pool_metrics)
        registry = Registry()
        register_pool_metrics(registry, stats)
        if service is not None:
            register_matcher_stats(registry, service.matcher)
            _register_device_counts(registry, service.matcher)
        metrics = MetricsServer(conf.pool_metrics_address, registry,
                                path=conf.metrics_path,
                                logger=logger.with_prefix("pool-metrics"))
        metrics.start()
    boot.info("worker pool started", workers=conf.workers,
              pool_dir=pool_dir, tcp=conf.mqtt_tcp_address,
              matcher_sidecar=bool(service),
              device="" if device is None else str(device))
    if ready is not None:
        ready.set()
    if stop is None:
        stop = _signal_stop_event()

    watcher = asyncio.get_running_loop().create_task(
        _supervise_workers(procs, spawn, boot, stats=stats))
    try:
        await stop.wait()
    finally:
        watcher.cancel()
        if metrics is not None:
            metrics.stop()
        boot.info("shutting down worker pool")
        for p in procs:
            p.terminate()
        for i, p in enumerate(procs):
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            boot.info("pool worker stopped", worker=i, pid=p.pid,
                      rc=p.returncode)
        if service is not None:
            await service.close()
            # the engine's background refresh and warm-up threads end
            # before the process does (no torch work caught at exit)
            engine_close = getattr(getattr(service.matcher, "engine", None),
                                   "close", None)
            if engine_close is not None:
                await asyncio.get_running_loop().run_in_executor(
                    None, engine_close)
        for i in range(conf.workers):
            with contextlib.suppress(OSError):
                os.unlink(worker_sock(pool_dir, i))
        with contextlib.suppress(OSError):
            os.rmdir(pool_dir)
