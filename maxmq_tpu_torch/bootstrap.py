"""Process bootstrap, the part that builds the broker's matcher: config →
broker capabilities, and the configured matcher engine stacked under the
broker (engine → ``MicroBatcher`` → tracer → ``SupervisedMatcher``), warmed
as the reference warms it.

Parity surface: internal/cli/start.go in the reference (the facade's
Config → Capabilities mapping, internal/mqtt/server.go:76-91).

Copy of ``capabilities_from_config``, ``build_matcher`` and
``supervisor_kwargs`` of the JAX package's ``bootstrap.py``.
``build_matcher`` takes one keyword the reference lacks, ``device``: the
engines run on the card unless the caller names another device (``"cpu"``),
and without CUDA and without a device they raise — the matcher is never
moved to the CPU on its own.
"""

from __future__ import annotations

from .broker import Broker, Capabilities
from .utils.config import Config


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
