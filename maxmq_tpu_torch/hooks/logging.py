"""Structured-logging hook: one leveled log event per observable broker event.

Parity surface: internal/mqtt/logging.go in the reference — a hook
implementing 20 of the 35 events (logging.go:43-66), emitting structured
leveled logs for packet rx/tx (TRACE), connect/disconnect, subscribe/
unsubscribe, publish, QoS flow, retained messages, wills and expiry
(logging.go:69-422).

Copy of the JAX package's ``hooks/logging.py``, over the port's codec
and logger.
"""

from __future__ import annotations

from ..protocol.codec import PacketType
from ..utils.logger import Logger
from .base import Hook

_TYPE_NAMES = {v: k for k, v in vars(PacketType).items()
               if isinstance(v, int) and not k.startswith("_")}


def _ptype(t: int) -> str:
    return _TYPE_NAMES.get(t, str(t))


def _cid(client) -> str:
    return getattr(client, "id", "") or "?"


def _trace_fields(packet) -> dict:
    """Correlation fields for publish-path events (ADR 015/017): when
    this publish rode the sampled pipeline tracer, every log line about
    it carries the same ``trace`` id the flight recorder / Chrome
    export uses. On the RECEIVING node of a cross-node forward the
    trace is an adopted one and logs as ``<origin>:<id>`` — one grep
    correlates the publish across every node of a cluster run."""
    tr = getattr(packet, "_trace", None)
    if tr is not None:
        return {"trace": f"{tr.origin}:{tr.id}" if tr.origin else tr.id}
    ref = getattr(packet, "_trace_ref", None)
    if ref is not None:
        return {"trace": f"{ref[0]}:{ref[1]}"}
    return {}


class LoggingHook(Hook):
    """Logs every broker event at the same levels the reference uses:
    packet-level rx/tx at TRACE, protocol milestones at DEBUG/INFO,
    losses at WARN."""

    id = "logging"

    def __init__(self, logger: Logger) -> None:
        self.log = logger

    # -- lifecycle ----------------------------------------------------------
    def on_started(self) -> None:
        self.log.info("broker started")

    def on_stopped(self) -> None:
        self.log.info("broker stopped")

    # -- connection ---------------------------------------------------------
    def on_connect(self, client, packet) -> None:
        self.log.debug("received CONNECT packet", client=_cid(client),
                       listener=client.listener, version=packet.protocol_version,
                       clean=packet.clean_start)

    def on_session_established(self, client, packet) -> None:
        self.log.info("client connected", client=_cid(client),
                      remote=client.remote, listener=client.listener,
                      keepalive=client.keepalive,
                      inflight=len(client.inflight))

    def on_disconnect(self, client, err, expire: bool) -> None:
        # a reason-code-0 "error" is a clean client DISCONNECT, not a failure
        if err is not None and getattr(getattr(err, "code", None),
                                       "value", 1) != 0:
            self.log.warn("client disconnected with error",
                          client=_cid(client), error=str(err), expire=expire)
        else:
            self.log.info("client disconnected", client=_cid(client),
                          expire=expire)

    def on_client_expired(self, client) -> None:
        self.log.debug("session expired", client=_cid(client))

    # -- packet flow (TRACE) ------------------------------------------------
    def on_packet_read(self, packet, client):
        self.log.trace("received packet", client=_cid(client),
                       type=_ptype(packet.fixed.type), id=packet.packet_id,
                       bytes=packet.fixed.remaining)
        return packet

    def on_packet_id_exhausted(self, client, packet) -> None:
        self.log.warn("packet ids exhausted", client=_cid(client))

    # -- subscribe / unsubscribe -------------------------------------------
    def on_subscribed(self, client, packet, reason_codes, counts) -> None:
        self.log.info("client subscribed", client=_cid(client),
                      filters=[s.filter for s in packet.filters],
                      reason_codes=reason_codes)

    def on_unsubscribed(self, client, packet) -> None:
        self.log.info("client unsubscribed", client=_cid(client),
                      filters=[s.filter for s in packet.filters])

    # -- publish ------------------------------------------------------------
    def on_publish(self, packet, client):
        self.log.debug("received PUBLISH", client=_cid(client),
                       topic=packet.topic, qos=packet.fixed.qos,
                       retain=packet.fixed.retain,
                       bytes=len(packet.payload or b""),
                       **_trace_fields(packet))
        return packet

    def on_published(self, client, packet) -> None:
        self.log.debug("message published", client=_cid(client),
                       topic=packet.topic, **_trace_fields(packet))

    def on_publish_dropped(self, client, packet) -> None:
        self.log.warn("publish dropped (slow consumer)",
                      client=_cid(client), topic=packet.topic,
                      **_trace_fields(packet))

    # -- retained -----------------------------------------------------------
    def on_retain_message(self, client, packet, stored: int) -> None:
        self.log.debug("retained message changed", client=_cid(client),
                       topic=packet.topic, stored=stored)

    def on_retained_expired(self, filter_: str) -> None:
        self.log.debug("retained message expired", topic=filter_)

    # -- QoS ----------------------------------------------------------------
    def on_qos_publish(self, client, packet, sent: float, resends: int) -> None:
        self.log.trace("inflight message queued", client=_cid(client),
                       id=packet.packet_id, resends=resends)

    def on_qos_complete(self, client, packet) -> None:
        self.log.trace("qos flow complete", client=_cid(client),
                       id=packet.packet_id)

    def on_qos_dropped(self, client, packet) -> None:
        self.log.warn("inflight message dropped", client=_cid(client),
                      id=packet.packet_id)

    # -- wills --------------------------------------------------------------
    def on_will_sent(self, client, packet) -> None:
        self.log.debug("will message sent", client=_cid(client),
                       topic=packet.topic)


class PacketTxLogHook(Hook):
    """TRACE-level per-packet tx logging, as its own hook because an
    ``on_packet_sent`` override anywhere forces every fan-out delivery
    onto the per-client encode path (the hook must observe a real
    Packet, ADR 019) — attached by bootstrap only when the configured
    level actually emits TRACE, so the default deployment keeps
    zero-copy fan-out."""

    id = "logging-tx"

    def __init__(self, logger: Logger) -> None:
        self.log = logger

    def on_packet_sent(self, client, packet, nbytes: int) -> None:
        self.log.trace("sent packet", client=_cid(client),
                       type=_ptype(packet.fixed.type), id=packet.packet_id,
                       bytes=nbytes)
