"""Process bootstrap: config → logger → broker + metrics server → run until
signalled.

Parity surface: internal/cli/start.go in the reference — ``runServer``
(start.go:111-181) loads config, builds the snowflake-ID logger, spawns the
metrics and MQTT servers concurrently, waits for SIGINT/SIGTERM
(start.go:69-77), and optionally writes CPU/heap profiles (128-137,165-180).

Copy of the JAX package's ``bootstrap.py``. ``build_matcher``,
``build_broker`` and ``run_server`` take one keyword the reference lacks,
``device``: the engines and the content plane's torch evaluator run on the
card unless the caller names another device (``"cpu"``), and without CUDA
and without a device the device engines raise — nothing is moved to the
CPU on its own. Cluster mode (``cluster_node_id``) runs the federation
with its federated sessions (``cluster_session_replication = true``, the
default). ``workers > 1`` runs the delivery-worker pool
(``broker/workers.py``): this process becomes the pool parent, whose
matcher sidecar owns the card, and each worker process re-enters
``run_server`` with ``MAXMQ_WORKER_ID`` set.
"""

from __future__ import annotations

import asyncio
import os
import signal

from .broker import Broker, BrokerOptions, Capabilities, TCPListener
from .broker.listeners import HTTPStatsListener, UnixListener, WSListener
from .hooks import AllowHook
from .hooks.logging import LoggingHook
from .hooks.storage import MemoryStore, SQLiteStore, StorageHook
from .metrics import MetricsServer, Registry, register_broker_metrics
from .utils.config import Config, config_as_dict
from .utils.logger import Logger
from .utils.snowflake import Snowflake

BANNER = r"""
  __  __            __  __  ___    _____ ___ _   _
 |  \/  | __ ___  _|  \/  |/ _ \  |_   _| _ \ | | |
 | |\/| |/ _` \ \/ / |\/| | (_) |   | | |  _/ |_| |
 |_|  |_|\__,_|_|\_\_|  |_|\__\_\   |_| |_|  \___/
        MQTT broker, PyTorch/CUDA port
"""


def capabilities_from_config(conf: Config) -> Capabilities:
    """Map the flat config onto broker capabilities, the way the reference's
    facade maps its Config into mochi Capabilities (internal/mqtt/
    server.go:76-91)."""
    return Capabilities(
        maximum_session_expiry_interval=conf.mqtt_session_expiry_interval,
        maximum_message_expiry_interval=conf.mqtt_max_message_expiry_interval,
        receive_maximum=conf.mqtt_receive_maximum,
        maximum_qos=conf.mqtt_max_qos,
        retain_available=conf.mqtt_retain_available,
        maximum_packet_size=conf.mqtt_max_packet_size,
        topic_alias_maximum=conf.mqtt_max_topic_alias,
        wildcard_sub_available=conf.mqtt_wildcard_subscription_available,
        sub_id_available=conf.mqtt_subscription_id_available,
        shared_sub_available=conf.mqtt_shared_subscription_available,
        minimum_protocol_version=conf.mqtt_min_protocol_version,
        buffer_size=conf.mqtt_buffer_size,    # clamped in Capabilities
        shutdown_timeout=float(conf.mqtt_shutdown_timeout),
        maximum_keepalive=conf.mqtt_max_keep_alive,
        maximum_client_writes_pending=conf.mqtt_max_outbound_queue,
        maximum_inflight=conf.mqtt_max_inflight_messages,
        sys_topic_interval=float(conf.mqtt_sys_topic_interval),
        # overload-protection ladder (ADR 012)
        client_byte_budget=conf.broker_client_byte_budget,
        broker_byte_budget=conf.broker_byte_budget,
        connect_rate=float(conf.connect_rate),
        connect_burst=conf.connect_burst,
        connect_half_open_max=conf.connect_half_open_max,
        stall_deadline_ms=conf.stall_deadline_ms,
        overload_high_water=float(conf.broker_overload_high_water),
        overload_low_water=float(conf.broker_overload_low_water),
        # publish-path tracing (ADR 015)
        trace_sample_n=conf.trace_sample_n,
        trace_slow_ms=float(conf.trace_slow_ms),
        trace_ring=conf.trace_ring,
        # zero-copy fan-out (ADR 019)
        native_encode=conf.broker_native_encode,
        flush_coalesce=conf.broker_flush_coalesce,
        # MQTT+ content plane (ADR 023)
        content_filtering=conf.filter_enabled,
        filter_backend=conf.filter_backend,
        filter_max_subscriptions=conf.filter_max_subscriptions,
        filter_max_expr_len=conf.filter_max_expr_len,
        filter_max_fields=conf.filter_max_fields,
        filter_batch_max=conf.filter_batch_max,
        filter_window_min_s=float(conf.filter_window_min_s),
        filter_window_max_s=float(conf.filter_window_max_s),
    )


def install_event_loop(policy: str, logger: Logger | None = None) -> str:
    """Install the configured asyncio event-loop policy BEFORE
    asyncio.run (ADR 023 satellite). ``auto`` takes uvloop when the
    package is installed; ``uvloop`` warns and falls back cleanly when
    it is not — a config written for a uvloop box must still boot a
    bare one. Returns the name of what was installed."""
    policy = (policy or "auto").strip().lower()
    if policy not in ("auto", "asyncio", "uvloop"):
        raise ValueError(f"unknown broker_event_loop {policy!r} "
                         "(want auto|asyncio|uvloop)")
    if policy in ("auto", "uvloop"):
        try:
            import uvloop
        except ImportError:
            if policy == "uvloop" and logger is not None:
                logger.with_prefix("bootstrap").warn(
                    "uvloop requested but not installed; "
                    "falling back to asyncio")
        else:
            asyncio.set_event_loop_policy(uvloop.EventLoopPolicy())
            return "uvloop"
    asyncio.set_event_loop_policy(asyncio.DefaultEventLoopPolicy())
    return "asyncio"


def build_matcher(conf: Config, broker: Broker, device=None):
    """Attach the configured matcher engine to the broker.

    ``trie`` is the CPU reference path (broker default, no attach needed);
    ``nfa``/``dense``/``sig`` are the device paths; a ``matcher_mesh``
    like "2x4" shards the engine over a device mesh (cluster mode);
    ``service`` connects to an external card-owning matcher service at
    ``matcher_socket`` (attached by the start path — it needs the loop).

    ``device`` is where the engine runs: None is the card (every CUDA
    device for a mesh), and raises without CUDA; a named device (``"cpu"``)
    takes every cell of a mesh."""
    if conf.matcher in ("", "trie", "service"):
        return None
    if conf.matcher_mesh:
        from .parallel.sharded import (ShardedNFAEngine, ShardedSigEngine,
                                       make_mesh)
        rows, _, cols = conf.matcher_mesh.partition("x")
        shape = (int(rows), int(cols or 1))
        mesh = make_mesh(shape=shape, devices=(
            None if device is None else [device] * (shape[0] * shape[1])))
        if conf.matcher == "nfa":
            engine = ShardedNFAEngine(broker.topics, mesh=mesh,
                                      max_levels=conf.matcher_max_levels)
        else:
            # the sharded sig engine derives its depth window from the
            # corpus (DEPTH_CAP-bounded); matcher_max_levels is a
            # word-path/nfa/dense knob
            engine = ShardedSigEngine(broker.topics, mesh=mesh)
            engine.emit_intents = conf.matcher_intents   # ADR 007
    elif conf.matcher == "nfa":
        from .matching.engine import NFAEngine
        engine = NFAEngine(broker.topics,
                           max_levels=conf.matcher_max_levels, device=device)
    elif conf.matcher == "dense":
        from .matching.dense import DenseEngine
        engine = DenseEngine(broker.topics,
                             max_levels=conf.matcher_max_levels,
                             device=device)
    elif conf.matcher == "sig":
        from .matching.sig import SigEngine
        engine = SigEngine(broker.topics,
                           max_levels=conf.matcher_max_levels, device=device)
        # fan-out-ready DeliveryIntents from the native decode (ADR 007)
        # — the broker handles both result shapes, so this is safe to
        # default on; matcher_intents = false restores merged sets
        engine.emit_intents = conf.matcher_intents
    else:
        raise ValueError(f"unknown matcher {conf.matcher!r}")
    from .matching.batcher import MicroBatcher
    batcher = MicroBatcher(engine,
                           window_us=conf.matcher_batch_window_us,
                           max_batch=conf.matcher_max_batch)
    # ADR 015: the batcher stamps dispatch/result marks on match
    # futures when the broker's tracer is sampling, so per-publish
    # traces split coalescing wait from device time
    batcher.tracer = broker.tracer
    attach = batcher
    if conf.matcher_supervised:
        # ADR 011: per-batch deadline + trie hedge + circuit breaker
        # around every device call — publishes complete (bit-equal to
        # the CPU trie) through device errors, hangs, failed recompiles
        from .matching.supervisor import SupervisedMatcher
        attach = SupervisedMatcher(batcher, index=broker.topics,
                                   logger=broker.log,
                                   **supervisor_kwargs(conf))
    broker.attach_matcher(attach)
    warm = getattr(engine, "warm_buckets", None)
    if warm is not None:
        warm(conf.matcher_max_batch)    # background bucket precompile
    prewarm = getattr(engine, "prewarm_decode_bases", None)
    if prewarm is not None:
        prewarm()    # chained-decode anchors at the boot quiescent point
    return attach


def supervisor_kwargs(conf: Config) -> dict:
    """The ADR-011 SupervisedMatcher knobs as a kwargs dict (shared by
    the in-process matcher build and the service attach)."""
    return dict(deadline_ms=conf.matcher_deadline_ms,
                breaker_threshold=conf.matcher_breaker_threshold,
                breaker_window_s=conf.matcher_breaker_window_s,
                backoff_initial_s=conf.matcher_breaker_backoff_s,
                backoff_max_s=conf.matcher_breaker_backoff_max_s)


def build_cluster(conf: Config, broker: Broker, logger: Logger | None = None):
    """Attach the federation manager (ADR 013) when ``cluster_node_id``
    is set: bridge links to every ``cluster_peers`` entry, the
    aggregated route table, and $cluster/* inbound handling. The links
    start with broker.serve()."""
    if not conf.cluster_node_id:
        return None
    from .cluster import ClusterManager
    from .cluster.membership import parse_peers
    manager = ClusterManager(
        broker, conf.cluster_node_id, parse_peers(conf.cluster_peers),
        link_qos=conf.cluster_link_qos,
        max_hops=conf.cluster_max_hops,
        link_byte_budget=conf.cluster_link_byte_budget,
        keepalive=float(conf.cluster_link_keepalive),
        session_replication=conf.cluster_session_replication,
        session_sync=conf.cluster_session_sync,
        session_sync_timeout_ms=conf.cluster_session_sync_timeout_ms,
        fwd_durability=conf.cluster_fwd_durability,
        replica_expiry_s=float(conf.cluster_replica_expiry_s),
        share_balance=conf.cluster_share_balance,
        session_takeover_timeout_ms=(
            conf.cluster_session_takeover_timeout_ms),
        trace_propagation=conf.cluster_trace_propagation,
        trace_return=conf.cluster_trace_return,
        telemetry_interval_s=float(conf.cluster_telemetry_interval_s),
        telemetry_full_every=conf.cluster_telemetry_full_every,
        rtt_deadline_k=float(conf.cluster_rtt_deadline_k),
        content_routes=conf.cluster_content_routes,
        logger=logger.with_prefix("cluster") if logger else None)
    broker.attach_cluster(manager)
    return manager


def build_storage(conf: Config) -> "StorageHook | None":
    """The ADR-014 persistence pipeline: backend store (SQLite opened
    with the ``storage_sync``-derived synchronous pragma) behind a
    write-behind journal, so hook writes never fsync on the event loop
    and QoS acks can ride the durability barrier under ``always``."""
    if not conf.storage_backend:
        return None
    from .hooks.faultstore import FaultInjectingStore
    from .hooks.journal import SQLITE_SYNC_BY_POLICY, WriteBehindStore
    policy = conf.storage_sync
    if policy not in SQLITE_SYNC_BY_POLICY:
        raise ValueError(f"unknown storage_sync {policy!r} "
                         f"(want always|batched|off)")
    if conf.storage_backend == "memory":
        inner = MemoryStore()
    else:
        inner = SQLiteStore(conf.storage_path,
                            synchronous=SQLITE_SYNC_BY_POLICY[policy])
    # the disk.* fault shim (ADR 024) wraps unconditionally: every site
    # is consulted off the event loop and the unarmed fast path is one
    # empty-dict membership test per commit
    inner = FaultInjectingStore(inner)
    store = WriteBehindStore(
        inner, policy=policy,
        batch_ms=conf.storage_batch_ms,
        batch_ops=conf.storage_batch_ops,
        queue_bytes=conf.storage_queue_bytes,
        breaker_threshold=conf.storage_breaker_threshold,
        backoff_s=float(conf.storage_breaker_backoff_s),
        backoff_max_s=float(conf.storage_breaker_backoff_max_s))
    return StorageHook(store)


def build_broker(conf: Config, logger: Logger, device=None) -> Broker:
    """Assemble a broker from config: capabilities, listeners, hooks,
    matcher. Mirrors internal/mqtt/server.go:38-118. ``device`` is where
    the matcher engine and the content plane's torch evaluator run (None:
    the card)."""
    broker = Broker(BrokerOptions(capabilities=capabilities_from_config(conf),
                                  logger=logger.with_prefix("mqtt"),
                                  device=device))
    broker.add_hook(LoggingHook(logger.with_prefix("mqtt")))
    if conf.log_level == "trace":
        # per-packet tx logging lives in its own hook: its
        # on_packet_sent override disables zero-copy fan-out (ADR 019),
        # so it is only attached when TRACE would actually emit
        from .hooks.logging import PacketTxLogHook
        broker.add_hook(PacketTxLogHook(logger.with_prefix("mqtt")))
    if conf.auth_ledger:
        from .hooks.auth import Ledger, LedgerHook
        broker.add_hook(LedgerHook(Ledger.from_file(conf.auth_ledger)))
    else:
        broker.add_hook(AllowHook())
    storage = build_storage(conf)
    if storage is not None:
        broker.add_hook(storage)
    if conf.mqtt_tcp_address:
        broker.add_listener(TCPListener("tcp", conf.mqtt_tcp_address,
                                        reuse_port=conf.workers > 1))
    if conf.mqtt_ws_address:
        broker.add_listener(WSListener("ws", conf.mqtt_ws_address,
                                       reuse_port=conf.workers > 1))
    if conf.mqtt_unix_socket:
        broker.add_listener(UnixListener("unix", conf.mqtt_unix_socket))
    if conf.mqtt_sys_http_address:
        broker.add_listener(HTTPStatsListener(
            "sys-http", conf.mqtt_sys_http_address, lambda: broker.info))
    # the session-replication refusal comes before the matcher starts its
    # background warm-up (the reference attaches a cluster after the
    # matcher; nothing in either depends on the other's order)
    build_cluster(conf, broker, logger)
    build_matcher(conf, broker, device=device)
    return broker


def build_metrics(conf: Config, broker: Broker,
                  logger: Logger) -> MetricsServer | None:
    if not conf.metrics_enabled:
        return None
    registry = Registry()
    register_broker_metrics(registry, broker)
    if broker.matcher is not None:
        _register_device_counts(registry, broker.matcher)
    # ADR 017: with a cluster attached, ANY node serves the federated
    # /cluster/metrics page from its telemetry plane
    telemetry = getattr(broker.cluster, "telemetry", None) \
        if broker.cluster is not None else None
    return MetricsServer(conf.metrics_address, registry,
                         path=conf.metrics_path,
                         profiling=conf.metrics_profiling,
                         logger=logger.with_prefix("metrics"),
                         tracer=broker.tracer,
                         cluster_metrics=(telemetry.cluster_exposition
                                          if telemetry is not None
                                          else None))


def _register_device_counts(registry: Registry, matcher) -> None:
    """The process's launches of each hand-written CUDA kernel (each
    kernel's ``launches`` count; ``sig_kernel``'s docstring says where a
    launch is counted, never for a plain-version call): what the device
    matcher ran, beside its batches. With a batcher, also the topics of
    its batches and its shadow probes: bypassed batches sent to the
    device only to time it (one launch each at most), whose answers
    serve no publish; how far the engine's tables lag its index, and
    whether its background refresh runs; and the process's garbage
    collection pauses and full collections."""
    import gc

    from .matching.dense_kernel import dense_walk_words
    from .matching.sig_kernel import sig_match_fixed
    from .matching.supervisor import gc_paused_s

    for fn in (sig_match_fixed, dense_walk_words):
        registry.counter_func(
            "maxmq_matcher_kernel_launches_total",
            "CUDA kernel launches of this process, by kernel",
            lambda fn=fn: fn.launches, labels={"kernel": fn.__name__})
    if hasattr(matcher, "shadow_probes"):
        registry.counter_func(
            "maxmq_matcher_batched_topics_total",
            "Topics in the micro-batches formed (device and bypass)",
            lambda: matcher.batched_topics)
        registry.counter_func(
            "maxmq_matcher_shadow_probes_total",
            "Bypassed batches duplicated to the device to refresh the "
            "round-trip estimate (their answers are dropped)",
            lambda: matcher.shadow_probes)
    registry.counter_func(
        "maxmq_matcher_gc_paused_seconds_total",
        "Seconds this process spent in garbage collections, which the "
        "matcher's deadline leaves out once",
        gc_paused_s)
    registry.counter_func(
        "maxmq_matcher_gc_full_collections_total",
        "Full (oldest-generation) garbage collections of this process",
        lambda: gc.get_stats()[2]["collections"])
    engine = getattr(getattr(matcher, "inner", matcher), "engine", None)
    if hasattr(engine, "index") and hasattr(engine, "tables"):
        registry.gauge_func(
            "maxmq_matcher_tables_behind",
            "Subscription changes of the index that the engine's device "
            "tables do not hold yet (a dispatch starts the background "
            "refresh that catches up)",
            lambda: engine.index.sub_version - engine.tables.version)
        registry.gauge_func(
            "maxmq_matcher_refreshing",
            "1 while the engine's background refresh (recompile, bucket "
            "re-warm, decode prewarm) runs",
            lambda: int(any(t is not None and t.is_alive() for t in (
                getattr(engine, "_bg_thread", None),
                getattr(engine, "_warm_thread", None)))))


def new_logger_from_config(conf: Config) -> Logger:
    from .utils.logger import new_logger
    sf = Snowflake(machine_id=conf.machine_id)
    return new_logger(fmt=conf.log_format, level=conf.log_level,
                      log_id_gen=sf.next_id)


def matcher_device(broker: Broker) -> str:
    """Where the broker's matching runs, for the start line: the engine's
    device (every cell's, for a mesh), ``service`` for an external
    matcher service, ``cpu`` for the broker's own trie."""
    m = broker.matcher
    if m is None:
        return "cpu"
    m = vars(m).get("inner", m)         # a supervisor: what it guards
    engine = vars(m).get("engine", m)   # a batcher: its engine
    mesh = getattr(engine, "mesh", None)
    if mesh is not None:
        return ",".join(sorted({str(d) for d in mesh.devices.flat}))
    device = getattr(engine, "device", None)
    return str(device) if device is not None else "service"


async def _maybe_attach_service(conf: Config, broker: Broker) -> None:
    """matcher = "service": connect to the external card-owning matcher
    (``python -m maxmq_tpu_torch matcher-service``) at conf.matcher_socket."""
    if conf.matcher == "service":
        from .matching.service import attach_matcher_service
        await attach_matcher_service(
            broker, conf.matcher_socket,
            supervisor=(supervisor_kwargs(conf)
                        if conf.matcher_supervised else None))


def _signal_stop_event() -> asyncio.Event:
    """A stop event set by SIGINT/SIGTERM (start.go:71-77 analogue)."""
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass
    return stop


async def run_server(conf: Config, logger: Logger,
                     ready: asyncio.Event | None = None,
                     stop: asyncio.Event | None = None,
                     broker_out: list | None = None,
                     device=None) -> None:
    """Run broker + metrics until ``stop`` is set or SIGINT/SIGTERM.

    ``ready``/``stop`` let tests drive the full bootstrap in-process the way
    the reference's start_test.go runs runServer with a cancellable context;
    ``broker_out`` (a list the built Broker is appended to) lets them
    assert on the wired components without reaching into module state.
    ``device`` goes to ``build_broker`` (None: the card).
    """
    boot = logger.with_prefix("bootstrap")
    boot.debug("effective configuration", **config_as_dict(conf))

    if await _maybe_run_pool(conf, logger, ready, stop, device):
        return

    profiler = _start_profiling(conf)

    broker = build_broker(conf, logger, device=device)
    if broker_out is not None:
        broker_out.append(broker)
    # service matcher must attach BEFORE the metrics registry is built,
    # or the matcher/pipeline metrics never register in service mode
    await _maybe_attach_service(conf, broker)
    metrics = build_metrics(conf, broker, logger)

    if stop is None:
        stop = _signal_stop_event()

    if metrics is not None:
        metrics.start()
    try:
        await broker.serve()
    except BaseException:
        # a failed boot (a listener that cannot bind, a restore that
        # raises) still stops the engine's background work: the
        # interpreter's teardown would abort torch work caught mid-op
        if metrics is not None:
            metrics.stop()
        await _close_matcher(broker)
        raise
    boot.info("server started", tcp=conf.mqtt_tcp_address,
              matcher=conf.matcher or "trie", device=matcher_device(broker),
              restore_s=broker.boot_seconds.get("restore", 0.0),
              compile_s=broker.boot_seconds.get("compile", 0.0),
              replica_restore_s=getattr(
                  getattr(broker.cluster, "sessions", None), "boot_seconds",
                  {}).get("restore", 0.0))
    if ready is not None:
        ready.set()

    try:
        await stop.wait()
    finally:
        boot.info("shutting down")
        await broker.close()
        if metrics is not None:
            metrics.stop()
        await _close_matcher(broker)
        if profiler is not None:
            _stop_profiling(profiler, conf, boot)
        boot.info("server stopped")


async def _close_matcher(broker: Broker) -> None:
    """Close the attached matcher, then wait (off the loop) for its
    engine's background refresh and bucket warm-up threads, so the process
    exits with no torch work in flight."""
    matcher = broker.matcher
    if matcher is None:
        return
    if hasattr(matcher, "close"):
        await matcher.close()
    engine_close = getattr(getattr(matcher, "engine", None), "close", None)
    if engine_close is not None:
        await asyncio.get_running_loop().run_in_executor(None, engine_close)


async def _maybe_run_pool(conf: Config, logger, ready, stop,
                          device=None) -> bool:
    """Delivery-worker pool (ADR 005/021): the parent runs the shared
    matcher sidecar (on ``device``) and spawns SO_REUSEPORT workers,
    which mesh as an in-box cluster over unix bridge links; a worker
    subprocess re-enters run_server with MAXMQ_WORKER_ID set and takes
    the worker branch. False: this process runs the broker itself."""
    worker_id = os.environ.get("MAXMQ_WORKER_ID")
    if worker_id is not None:
        from .broker.workers import POOL_DIR_ENV, run_worker
        conf = pool_worker_config(conf)
        await run_worker(conf, logger, int(worker_id),
                         os.environ[POOL_DIR_ENV], ready=ready, stop=stop,
                         device=device)
        return True
    if conf.workers > 1:
        from .broker.workers import run_pool
        await run_pool(conf, logger, ready=ready, stop=stop, device=device)
        return True
    return False


def pool_worker_config(conf: Config) -> Config:
    """A pool worker's box config: the parent's, handed over as JSON in
    ``MAXMQ_POOL_CONF``, where that is set; else ``conf``."""
    pool_conf = os.environ.get("MAXMQ_POOL_CONF")
    if not pool_conf:
        return conf
    import json
    return Config(**json.loads(pool_conf))


def _start_profiling(conf: Config):
    if not conf.profile:
        return None
    import cProfile
    import tracemalloc
    profiler = cProfile.Profile()
    profiler.enable()
    tracemalloc.start()
    return profiler


def _stop_profiling(profiler, conf: Config, boot) -> None:
    import tracemalloc
    profiler.disable()
    profiler.dump_stats(f"{conf.profile_path}/cpu.prof")
    snap = tracemalloc.take_snapshot()
    with open(f"{conf.profile_path}/heap.prof", "w") as f:
        for s in snap.statistics("lineno")[:256]:
            f.write(str(s) + "\n")
    tracemalloc.stop()
    boot.info("profiles written", path=conf.profile_path)
