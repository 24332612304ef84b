"""The broker engine: connection establishment, per-packet dispatch, QoS 1/2
state machines, publish fan-out, retained/will/session lifecycles, $SYS.

Parity surface: vendor/github.com/mochi-co/mqtt/v2/server.go in the reference
(Server, Capabilities, EstablishConnection, processPublish,
publishToSubscribers, publishToClient, event loop). Re-designed around
asyncio: the per-connection read loop serializes that client's packets; the
topic matcher is pluggable so a device engine on the card can replace the
CPU trie.

Copy of the JAX package's ``broker/server.py``. The content plane's device
backend is ``torch`` (the reference's ``jnp``); ``BrokerOptions.device``
names the device it evaluates on (the card when it names none).
"""

from __future__ import annotations

import asyncio
import heapq
import math
import threading
import time
from dataclasses import dataclass, field
from zlib import crc32

from .. import faults
from ..filtering.expr import ExprError, decode_payload
from ..filtering.plane import (ContentPlane, ContentQuota,
                               USER_PROP_KEY as FILTER_PROP_KEY)
from ..hooks.base import Hook, Hooks, RejectPacket
from ..trace import MAX_DRAIN_SPANS, PipelineTracer
from ..matching.topics import valid_filter, valid_topic_name
from ..matching.trie import (SubscriberSet, TopicIndex,
                             VersionedTopicCache)
from ..protocol import codes, wire
from ..protocol.codec import (FixedHeader, MalformedPacketError,
                              PacketType as PT, write_varint)
from ..protocol.packets import Packet, ProtocolError, Subscription
from .client import (Client, ClientRegistry, FlushScheduler,
                     PacketIDExhausted)
from .listeners import Listener, Listeners
from .overload import OverloadState, TokenBucket, top_offenders
from .sys_info import SysInfo

__version__ = "0.1.0"


def _current_rss_bytes() -> int:
    """Current resident set size. /proc on linux; best-effort elsewhere
    (a failed probe reports 0 — the $SYS tick must never die over it)."""
    try:
        with open("/proc/self/status", encoding="ascii") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        import sys as _sys
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return rss if _sys.platform == "darwin" else rss * 1024
    except Exception:
        return 0


@dataclass
class Capabilities:
    """Feature flags/limits advertised to v5 clients and enforced for all.

    Parity: v2/server.go:35-70 (Capabilities + defaults).
    """

    maximum_session_expiry_interval: int = 0xFFFFFFFF
    maximum_message_expiry_interval: int = 60 * 60 * 24
    receive_maximum: int = 1024
    maximum_qos: int = 2
    retain_available: bool = True
    maximum_packet_size: int = 0  # 0 = unlimited
    topic_alias_maximum: int = 65535
    wildcard_sub_available: bool = True
    sub_id_available: bool = True
    shared_sub_available: bool = True
    minimum_protocol_version: int = 3
    maximum_clients: int = 0  # 0 = unlimited
    maximum_keepalive: int = 0  # 0 = unlimited; else clamp + v5 ServerKeepAlive
    maximum_client_writes_pending: int = 1024 * 8
    maximum_inflight: int = 1024 * 8
    buffer_size: int = 65536          # per-connection read-chunk bytes
    shutdown_timeout: float = 15.0    # graceful-close deadline, seconds

    def __post_init__(self) -> None:
        # read(0) returns b'' and reads as EOF, killing every
        # connection at the first loop turn — clamp on the field so
        # direct Capabilities(...) construction is as safe as config
        self.buffer_size = max(self.buffer_size, 1024)
    sys_topic_interval: float = 30.0  # seconds; 0 disables
    keepalive_grace: float = 1.5      # deadline = keepalive * grace

    # -- overload-protection ladder (ADR 012); 0 disables each rung ----
    client_byte_budget: int = 0       # per-client queued outbound bytes
    broker_byte_budget: int = 0       # global queued outbound bytes
    connect_rate: float = 0.0         # CONNECT admissions/sec per listener
    connect_burst: int = 0            # bucket depth; 0 = max(1, rate)
    connect_half_open_max: int = 0    # handshakes awaiting CONNECT
    stall_deadline_ms: int = 0        # writer no-progress disconnect
    overload_high_water: float = 0.8  # shed above budget * high_water
    overload_low_water: float = 0.5   # recover below budget * low_water

    # -- publish-path tracing (ADR 015); sample_n = 0 disables ---------
    trace_sample_n: int = 0           # trace every Nth publish
    trace_slow_ms: float = 0.0        # flight-record only e2e >= this
    trace_ring: int = 64              # flight-recorder entries kept

    # -- zero-copy fan-out (ADR 019) -----------------------------------
    native_encode: bool = True        # C frame-head assembly when the
                                      # maxmq_decode extension is built;
                                      # False pins the Python builder
    flush_coalesce: bool = True       # coalesce writer wakes to one
                                      # flush per loop iteration

    # -- MQTT+ content plane (ADR 023) ---------------------------------
    content_filtering: bool = True    # parse ?$expr/?$agg SUBSCRIBE
                                      # options; False leaves '?' a
                                      # plain topic character
    filter_backend: str = "numpy"     # numpy | torch | auto
    filter_max_subscriptions: int = 10000  # content subs per broker
    filter_max_expr_len: int = 512    # $expr source-length bound
    filter_max_fields: int = 64       # distinct decoded fields bound
    filter_batch_max: int = 256       # pipeline publishes per eval flush
    filter_window_min_s: float = 0.5  # accepted $win range
    filter_window_max_s: float = 3600.0


@dataclass
class BrokerOptions:
    capabilities: Capabilities = field(default_factory=Capabilities)
    logger: object | None = None
    inline_client: bool = True
    # the content plane's evaluator device ("cpu" or "cuda"); None is
    # the card
    device: str | None = None


class Broker:
    """A single-process MQTT broker instance."""

    def __init__(self, options: BrokerOptions | None = None) -> None:
        self.options = options or BrokerOptions()
        self.capabilities = self.options.capabilities
        self.log = self.options.logger
        self.clients = ClientRegistry()
        self.topics = TopicIndex()
        self.listeners = Listeners()
        self.hooks = Hooks()
        self.info = SysInfo(version=__version__, started=int(time.time()))
        self.matcher = None  # optional device matcher engine (set via attach)
        self._housekeeper: asyncio.Task | None = None
        self._sys_task: asyncio.Task | None = None
        self._will_delays: dict[str, tuple[float, Packet]] = {}
        # lower bounds the housekeeping sweeps keep (-inf: not swept yet):
        # no disconnected session expires before ``_expiry_due``, and no
        # inflight message was received before ``_inflight_oldest``, so a
        # tick before either skips its sweep over every session
        self._expiry_due = -math.inf
        self._inflight_oldest = -math.inf
        # client-id -> Client parked in the ADR-016 takeover await of
        # _attach_client (after _inherit_session, before clients.add):
        # a concurrent CONNECT for the same id must fence it off there
        self._mid_connect: dict[str, Client] = {}
        self._retained_expiry: list[tuple[float, str]] = []
        # topic -> latest due time: the heap uses lazy deletion, and a
        # retained topic REPUBLISHED often (1Hz sensor state) would
        # otherwise grow the heap by one stale entry per publish for a
        # full expiry interval (~86K entries/day/topic) — found by
        # tools/soak.py
        self._retained_due: dict[str, float] = {}
        # publish topics repeat heavily, and a trie walk costs ~20us;
        # entries self-invalidate on any subscription change
        self._match_cache = VersionedTopicCache()
        # MQTT+ content plane (ADR 023): payload-predicate masks +
        # windowed aggregates. Constructed whenever the capability is
        # on; with no content subscriptions registered .active is
        # False and every publish-path hook reduces to one check
        self.content = (ContentPlane(self, device=self.options.device)
                        if self.capabilities.content_filtering else None)
        # matcher-mode publish pipeline: (match future, origin, packet)
        # consumed in arrival order, so per-publisher delivery order holds
        # [MQTT-4.6.0] while many publishes ride the device concurrently
        self._pub_queue: asyncio.Queue | None = None
        self._pub_consumer: asyncio.Task | None = None
        # publishes whose match future failed and were served from the
        # broker's own trie (the rung BELOW the ADR-011 supervisor —
        # nonzero here means a failure got past the supervised matcher)
        self.matcher_degrades = 0
        # overload-protection ladder (ADR 012): global byte ledger +
        # watermark state, half-open handshake count, and retained
        # deliveries parked while shedding (drained on recovery)
        self.overload = OverloadState(self.capabilities)
        self._half_open = 0
        # zero-copy fan-out (ADR 019): per-loop-iteration writer-wake
        # coalescing — one flush pass wakes every writer a fan-out
        # touched, after its full backlog is queued. None disables
        # (direct wakes), for latency-sensitive single-subscriber
        # deployments that prefer the pre-019 behavior.
        self.flush_sched = (FlushScheduler()
                            if self.capabilities.flush_coalesce else None)
        # (client_id, filter) -> (sub, existing): keyed so a client
        # re-SUBSCRIBing during the shed window gets ONE delivery on
        # recovery and the ledger is bounded by the subscription count
        self._deferred_retained: dict[tuple[str, str],
                                      tuple[Subscription, bool]] = {}
        # cluster federation manager (ADR 013); attached via
        # attach_cluster, started/stopped with the broker lifecycle
        self.cluster = None
        # crash-consistent storage pipeline (ADR 014): the storage
        # hook/journal discovered at serve(); under storage_sync=always
        # QoS acks release through the journal's durability barrier
        self._storage_hook = None
        self._journal = None
        self.boot_epoch = 0             # persisted monotonic boot counter
        self.storage_barrier_waits = 0  # acks that waited on a barrier
        self.boot_seconds: dict = {}    # serve()'s restore and compile
        # publish-path tracer (ADR 015): always constructed — the
        # stage-error counters are fed even with sampling off; span
        # stamping is gated on tracer.sample_n at every site
        self.tracer = PipelineTracer(
            sample_n=self.capabilities.trace_sample_n,
            slow_ms=self.capabilities.trace_slow_ms,
            ring=self.capabilities.trace_ring)
        self._sys_trace_topics: set[str] = set()  # retained while sampling
        self._running = False
        self.loop: asyncio.AbstractEventLoop | None = None

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def _spawn(self, coro, what: str) -> asyncio.Task:
        """Fire-and-forget task with failure logging: a lost will fan-out
        or a failed forced disconnect must not vanish silently."""
        task = self.loop.create_task(coro)

        def _done(t: asyncio.Task) -> None:
            if t.cancelled():
                return
            exc = t.exception()
            if exc is None:
                return
            if self.log is not None:
                self.log.with_prefix("broker").error(
                    "background task failed", task=what, error=repr(exc))
            else:
                import logging
                logging.getLogger("maxmq").error(
                    "background task %s failed: %r", what, exc)

        task.add_done_callback(_done)
        return task

    def add_hook(self, hook: Hook, config=None) -> Hook:
        return self.hooks.add(hook, config)

    def add_listener(self, listener: Listener) -> Listener:
        return self.listeners.add(listener)

    def attach_matcher(self, matcher) -> None:
        """Install a pluggable matcher engine (e.g. the sig engine). It must
        expose ``subscribers(topic) -> SubscriberSet``."""
        self.matcher = matcher

    def attach_cluster(self, manager) -> None:
        """Install the federation manager (ADR 013): bridge links start
        with serve(), publishes consult its route table in the fan-out,
        and inbound ``$cluster/*`` traffic is diverted to it."""
        self.cluster = manager

    async def serve(self) -> None:
        self.loop = asyncio.get_running_loop()
        self._running = True
        # ADR 014: find the persistence hook (and its write-behind
        # journal, if it rides one) before restore — the durability
        # barrier and boot-epoch bump both hang off it
        self._storage_hook = next(
            (h for h in self.hooks if hasattr(h, "bump_boot_epoch")), None)
        self._journal = getattr(self._storage_hook, "journal", None)
        if self._journal is not None:
            # ADR 015: the writer thread feeds the journal_commit stage
            # histogram + commit-failure stage errors through the tracer
            self._journal.tracer = self.tracer
        t0 = time.perf_counter()
        await self._restore_from_storage()
        t1 = time.perf_counter()
        await self._compile_matcher_tables()
        # the boot's two long steps (s), for the start path's log line
        self.boot_seconds = {"restore": t1 - t0,
                             "compile": time.perf_counter() - t1}
        if self.capabilities.connect_rate > 0:
            # per-listener CONNECT token bucket (ADR 012): armed before
            # accepting so the very first storm is already gated
            for listener in self.listeners.all():
                if listener.gate is None:
                    listener.gate = TokenBucket(
                        self.capabilities.connect_rate,
                        self.capabilities.connect_burst)
        await self.listeners.serve_all(self._establish)
        self._housekeeper = self.loop.create_task(self._housekeeping_loop())
        if self.capabilities.sys_topic_interval > 0:
            self._sys_task = self.loop.create_task(self._sys_topic_loop())
        if self.cluster is not None:
            # after listeners: peers dialing back must find us accepting
            await self.cluster.start()
        self.hooks.notify("on_started")

    async def _compile_matcher_tables(self) -> None:
        """Compile the matcher's initial tables at the boot quiescent
        point — after storage restore, before listeners accept traffic.
        A restore that loaded a large subscription set would otherwise
        defer the first table compile (and its gc.freeze, ADR 009) to
        the first publish, freezing mid-traffic transients along with
        the tables. Off the event loop: the compile can take seconds at
        1M subscriptions, and nothing is being served yet.

        Prewarm rides the same executor call: a synchronous refresh()
        alone never populates the chained-decode anchors (only
        _bg_refresh does), so a broker restored with a large
        subscription set would pay the anchor-population ramp across
        its first few hundred thousand publishes (ADVICE r5 #1)."""
        if self.matcher is None or self.topics.subscription_count == 0:
            return
        engine = getattr(self.matcher, "engine", self.matcher)
        refresh = getattr(engine, "refresh", None)
        if refresh is None:
            return

        def compile_and_prewarm():
            refresh()
            # the buckets ``build_matcher`` warmed before the restore ran
            # on the tables of that time (none, for a restored corpus):
            # warm them again on the compiled ones, as a background
            # refresh does after each rotation
            warm_max = getattr(engine, "_warm_max", None)
            if warm_max:
                engine.warm_buckets(warm_max, background=False)
            prewarm = getattr(engine, "prewarm_decode_bases", None)
            if prewarm is None:
                return
            try:
                prewarm()
            except Exception as exc:
                # prewarm is a warm-up optimization: the compiled
                # tables above are live either way, so a prewarm
                # failure must not be reported as a compile failure
                if self.log is not None:
                    self.log.warn("boot-time decode prewarm failed",
                                  error=repr(exc)[:200])
        try:
            await self.loop.run_in_executor(None, compile_and_prewarm)
        except Exception as exc:
            # lazy refresh on first batch remains the fallback
            if self.log is not None:
                self.log.warn("boot-time matcher compile failed",
                              error=repr(exc)[:200])

    async def close(self) -> None:
        if not self._running:
            return
        self._running = False
        for task in (self._housekeeper, self._sys_task):
            if task is not None:
                task.cancel()
        if self.cluster is not None:
            # bridges first: a dying broker must stop forwarding before
            # its local fan-out stops
            await self.cluster.close()
        self.listeners.stop_accepting_all()
        stops = []
        for client in self.clients.connected():
            self.disconnect_client(client, codes.ErrServerShuttingDown)
            stops.append(asyncio.ensure_future(
                client.stop(ProtocolError(codes.ErrServerShuttingDown))))
        if stops:
            # one shared graceful deadline for ALL clients; stragglers
            # are cancelled, not waited on sequentially
            _done, pending = await asyncio.wait(
                stops, timeout=self.capabilities.shutdown_timeout)
            for p in pending:
                p.cancel()
        if self._pub_consumer is not None:
            # intake is stopped (listeners + read loops), so the queue
            # can only shrink: give the backlog a bounded drain (inline
            # clients may still take delivery; closed ones no-op), then
            # stop the consumer and reset so a re-serve()d broker
            # lazily recreates both
            try:
                await asyncio.wait_for(
                    self._pub_queue.join(),
                    timeout=self.capabilities.shutdown_timeout)
            except (asyncio.TimeoutError, TimeoutError):
                pass
            self._pub_consumer.cancel()
            self._pub_consumer = None
            self._pub_queue = None
        await self.listeners.close_all()
        self.hooks.notify("on_stopped")
        self.hooks.stop_all()

    # ------------------------------------------------------------------
    # Connection establishment
    # ------------------------------------------------------------------

    async def _establish(self, listener_id: str, reader, writer) -> None:
        if not await self._admit_connection(listener_id):
            try:
                writer.close()
            except Exception:
                pass
            return
        client = Client(self, reader, writer, listener_id)
        client._half_open = True
        self._half_open += 1
        try:
            await self._attach_client(client)
        except (ProtocolError, MalformedPacketError, ConnectionError, OSError):
            pass
        finally:
            self._settle_half_open(client)
            await client.stop()

    async def _admit_connection(self, listener_id: str) -> bool:
        """Admission control (ADR 012): deterministic accept fault site,
        per-listener CONNECT token bucket, half-open handshake cap. A
        False refuses the socket before any handshake work is queued."""
        try:
            hit = faults.fire_detail(faults.LISTENER_ACCEPT)
        except faults.InjectedFault:
            self.overload.connects_refused += 1
            return False
        if hit is not None and hit[0] == "hang":
            await asyncio.sleep(hit[1])
        listener = self.listeners.get(listener_id)
        gate = getattr(listener, "gate", None)
        if gate is not None and not gate.allow():
            self.overload.connects_refused += 1
            return False
        caps = self.capabilities
        if (caps.connect_half_open_max
                and self._half_open >= caps.connect_half_open_max):
            self.overload.half_open_refused += 1
            return False
        return True

    def _settle_half_open(self, client: Client) -> None:
        if getattr(client, "_half_open", False):
            client._half_open = False
            self._half_open -= 1

    async def _attach_client(self, client: Client) -> None:
        packet, leftover = await self._read_connect(client)
        client.parse_connect(packet)
        self._validate_connect(client, packet)

        self.hooks.notify("on_connect", client, packet)
        if not self.hooks.any_allow("on_connect_authenticate", client, packet):
            self._send_connack(client, codes.ErrBadUsernameOrPassword, False)
            raise ProtocolError(codes.ErrBadUsernameOrPassword)

        if packet.will is not None:
            client.properties.will = self.hooks.modify(
                "on_will", packet.will, client)

        self.hooks.notify("on_session_establish", client, packet)
        session_present = self._inherit_session(client)
        sessions = self._cluster_sessions()
        if sessions is not None:
            # ADR 016: epoch-fenced cross-node takeover BEFORE CONNACK —
            # a session owned by a peer is claimed, transferred (or
            # rebuilt from the replicated ledger) and installed here, so
            # the client sees session-present=1 on any node. Bounded:
            # every remote leg degrades instead of wedging the CONNECT.
            # The await opens a same-id race _inherit_session cannot
            # see (this client is not in the registry yet): a parked
            # predecessor is fenced off like a registered one, and if a
            # successor supersedes US while parked, this CONNECT loses.
            prev = self._mid_connect.get(client.id)
            if prev is not None and prev is not client:
                prev.taken_over = True
                if not prev.closed:
                    self.disconnect_client(prev, codes.ErrSessionTakenOver)
                    self._spawn(
                        prev.stop(ProtocolError(codes.ErrSessionTakenOver)),
                        "takeover-stop")
            self._mid_connect[client.id] = client
            try:
                session_present = await sessions.on_local_connect(
                    client, session_present)
            finally:
                if self._mid_connect.get(client.id) is client:
                    del self._mid_connect[client.id]
            if client.taken_over:
                raise ProtocolError(codes.ErrSessionTakenOver)
        self._will_delays.pop(client.id, None)  # reconnect cancels delayed will
        self.clients.add(client)
        client.connected_at = time.time()
        self.info.clients_connected += 1
        self.info.clients_maximum = max(self.info.clients_maximum,
                                        self.info.clients_connected)
        self.info.clients_total += 1
        client.start()
        self._send_connack(client, codes.Success, session_present)
        self._settle_half_open(client)     # handshake completed
        if session_present:
            client.resend_inflight()
            # quota-parked (held) messages resumed with the session:
            # nothing acked yet, so kick the drain once (ADR 018)
            self._release_held(client)
        self.hooks.notify("on_session_established", client, packet)

        err: ProtocolError | None = None
        try:
            await client.read_loop(self._receive_packet, initial=leftover)
        except ProtocolError as e:
            err = e
        except MalformedPacketError:
            err = ProtocolError(codes.ErrMalformedPacket)
        finally:
            await self._detach_client(client, err)

    async def _read_connect(self, client: Client
                            ) -> tuple[Packet, bytearray]:
        """The first inbound packet must be CONNECT [MQTT-3.1.0-1].
        Returns (packet, leftover bytes read past it) — a client may
        pipeline further packets in the same TCP segment."""
        from ..protocol.packets import parse_stream

        assert client.reader is not None
        buf = bytearray()
        deadline = time.monotonic() + 5.0
        while True:
            for fh, body in parse_stream(
                    buf, self.capabilities.maximum_packet_size):
                self.info.packets_received += 1
                if fh.type != PT.CONNECT:
                    raise ProtocolError(codes.ErrProtocolViolation,
                                        "first packet was not CONNECT")
                return Packet.decode(fh, body), buf
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                raise ProtocolError(codes.ErrKeepAliveTimeout)
            try:
                chunk = await asyncio.wait_for(
                    client.reader.read(self.capabilities.buffer_size),
                    timeout)
            except asyncio.TimeoutError:
                raise ProtocolError(codes.ErrKeepAliveTimeout) from None
            if not chunk:
                raise ConnectionError("eof before CONNECT")
            self.info.bytes_received += len(chunk)
            buf.extend(chunk)

    def _validate_connect(self, client: Client, packet: Packet) -> None:
        caps = self.capabilities
        if packet.protocol_version < caps.minimum_protocol_version:
            self._send_connack(client, codes.ErrUnsupportedProtocolVersion, False)
            raise ProtocolError(codes.ErrUnsupportedProtocolVersion)
        if caps.maximum_clients and len(self.clients) >= caps.maximum_clients:
            self._send_connack(client, codes.ErrServerBusy, False)
            raise ProtocolError(codes.ErrServerBusy)
        if not packet.client_id:
            if not packet.clean_start and packet.protocol_version < 5:
                # [MQTT-3.1.3-8]: zero-byte id requires clean session pre-v5
                self._send_connack(client, codes.ErrClientIdentifierNotValid,
                                   False)
                raise ProtocolError(codes.ErrClientIdentifierNotValid)
            client.id = f"auto-{int(time.time() * 1000):x}-{id(client):x}"
            client.assigned_id = True
        else:
            client.assigned_id = False

    def _inherit_session(self, client: Client) -> bool:
        """Session takeover/resume. Returns session-present for CONNACK.

        Parity: v2/server.go:451-495 (inheritClientSession).
        """
        existing = self.clients.get(client.id)
        if existing is None or existing is client:
            return False
        existing.taken_over = True
        if not existing.closed:
            self.disconnect_client(existing, codes.ErrSessionTakenOver)
            self._spawn(
                existing.stop(ProtocolError(codes.ErrSessionTakenOver)),
                "takeover-stop")
        if client.properties.clean_start:
            self._purge_session(existing)
            return False
        client.subscriptions = dict(existing.subscriptions)
        client.inflight = existing.inflight.clone()
        client.inflight.maximum_send = (client.properties.receive_maximum
                                        or self.capabilities.receive_maximum)
        client.inflight.send_quota = client.inflight.maximum_send
        client.inflight.maximum_receive = self.capabilities.receive_maximum
        client.inflight.receive_quota = client.inflight.maximum_receive
        client.pubrec_inbound = set(existing.pubrec_inbound)
        # held-but-unsent pids stay parked across the resume (ADR 018):
        # resend skips them, _release_held drains them under quota
        client.held_pids = type(client.held_pids)(existing.held_pids)
        return bool(client.subscriptions) or len(client.inflight) > 0

    def _purge_session(self, client: Client) -> None:
        for filt in list(client.subscriptions):
            if self.topics.unsubscribe(client.id, filt):
                self.info.subscriptions -= 1
                if self.cluster is not None:
                    self.cluster.note_unsubscribe(filt)
        client.subscriptions.clear()
        if self.content is not None:
            self.content.drop_client(client.id)
        self.clients.delete(client.id)
        sessions = self._cluster_sessions()
        if sessions is not None:
            # ADR 016: an expired/discarded session is purged
            # cluster-wide, not resurrected from a peer's replica
            sessions.note_purge(client.id)

    def _cluster_sessions(self):
        """The ADR-016 session-federation manager, when attached."""
        return (getattr(self.cluster, "sessions", None)
                if self.cluster is not None else None)

    def _note_pubrec(self, client: Client, pid: int, add: bool) -> None:
        """ADR 018: stream receiver-side QoS2 dedup (PUBREC-pending)
        changes to the session federation, so a dead-owner failover
        keeps the dedup set instead of redelivering on PUBLISH retry."""
        sessions = self._cluster_sessions()
        if sessions is not None:
            sessions.note_pubrec(client, pid, add)

    def _send_connack(self, client: Client, code: codes.Code,
                      session_present: bool) -> None:
        packet = Packet(fixed=FixedHeader(type=PT.CONNACK),
                        protocol_version=client.properties.protocol_version,
                        session_present=session_present,
                        reason_code=codes.connack_for_version(
                            code, client.properties.protocol_version))
        if client.properties.protocol_version >= 5 and not code.is_error:
            self._fill_connack_props(client, packet.properties)
        client.send_now(packet)

    def _fill_connack_props(self, client: Client, pr) -> None:
        """Advertise the server capability set on a v5 CONNACK
        [MQTT-3.2.2]; None leaves a property off the wire."""
        caps = self.capabilities
        pr.session_expiry = min(
            client.properties.session_expiry,
            caps.maximum_session_expiry_interval) \
            if client.properties.session_expiry_set else None
        pr.receive_maximum = caps.receive_maximum or None
        if caps.maximum_qos < 2:
            pr.maximum_qos = caps.maximum_qos
        if caps.maximum_packet_size:
            pr.maximum_packet_size = caps.maximum_packet_size
        pr.topic_alias_max = caps.topic_alias_maximum or None
        for prop, available in (
                ("retain_available", caps.retain_available),
                ("wildcard_sub_available", caps.wildcard_sub_available),
                ("sub_id_available", caps.sub_id_available),
                ("shared_sub_available", caps.shared_sub_available)):
            setattr(pr, prop, None if available else 0)
        if getattr(client, "assigned_id", False):
            pr.assigned_client_id = client.id
        if (caps.maximum_keepalive
                and client.keepalive != client.requested_keepalive):
            pr.server_keep_alive = client.keepalive

    async def _detach_client(self, client: Client, err: ProtocolError | None) -> None:
        """Connection teardown: will handling, registry bookkeeping, expiry."""
        if err is not None and err.code.is_error and client.writer is not None:
            self.disconnect_client(client, err.code)
        await client.stop(err)
        self.info.clients_connected -= 1
        self.info.clients_disconnected += 1

        if client.taken_over:
            current = self.clients.get(client.id)
            if current is not client:
                # session continues elsewhere; suppress will per delay rules
                self.hooks.notify("on_disconnect", client, err, False)
                return
        # A clean client DISCONNECT cleared the will in _process_disconnect;
        # anything still present fires (abnormal close, or v5 reason 0x04).
        if client.properties.will is not None:
            self._queue_will(client)
        if client.properties.protocol_version >= 5:
            expire = (client.properties.session_expiry == 0
                      if client.properties.session_expiry_set
                      else client.properties.clean_start)
        else:
            expire = client.properties.clean_start
        self.hooks.notify("on_disconnect", client, err, expire)
        if expire:
            self._purge_session(client)

    # ------------------------------------------------------------------
    # Packet dispatch
    # ------------------------------------------------------------------

    async def _receive_packet(self, client: Client, packet: Packet) -> None:
        packet = self.hooks.modify("on_packet_read", packet, client)
        err = None
        try:
            await self._process_packet(client, packet)
        except ProtocolError as e:
            err = e
            raise
        finally:
            self.hooks.notify("on_packet_processed", client, packet, err)

    async def _process_packet(self, client: Client, packet: Packet) -> None:
        t = packet.type
        if t == PT.PUBLISH:
            await self.process_publish(client, packet)
            return
        handler = self._DISPATCH.get(t)
        if handler is None:
            raise ProtocolError(codes.ErrProtocolViolation,
                                f"unexpected packet type {t}")
        handler(self, client, packet)

    def _process_pingreq(self, client: Client, packet: Packet) -> None:
        client.send(Packet(fixed=FixedHeader(type=PT.PINGRESP),
                           protocol_version=client.properties.protocol_version))

    def _process_auth(self, client: Client, packet: Packet) -> None:
        if not packet.reason_code_valid():
            raise ProtocolError(codes.ErrProtocolViolation,
                                "invalid AUTH reason code"
                                )  # [MQTT-3.15.2-1]
        self.hooks.modify("on_auth_packet", packet, client)

    def _process_second_connect(self, client: Client,
                                packet: Packet) -> None:
        raise ProtocolError(codes.ErrProtocolViolation,
                            "second CONNECT on live connection")

    def _process_disconnect(self, client: Client, packet: Packet) -> None:
        if (packet.protocol_version >= 5
                and packet.properties.session_expiry is not None):
            if (not client.properties.session_expiry_set
                    and packet.properties.session_expiry > 0):
                # [MQTT-3.1.2-23]: can't resurrect expiry after connecting with 0
                raise ProtocolError(codes.ErrProtocolViolation,
                                    "session expiry raised at disconnect")
            client.properties.session_expiry = packet.properties.session_expiry
            client.properties.session_expiry_set = True
        if packet.reason_code == codes.DisconnectWithWill.value:
            pass  # keep the will: abnormal-close path will fire it
        else:
            client.properties.will = None  # normal disconnect discards will
        raise ProtocolError(codes.Success)  # terminates read loop cleanly

    # ------------------------------------------------------------------
    # PUBLISH inbound
    # ------------------------------------------------------------------

    async def process_publish(self, client: Client, packet: Packet) -> None:
        """Parity: v2/server.go:674-754 (processPublish)."""
        if self.tracer.sample_n:        # ADR 015: one branch when off
            self._trace_begin(client, packet)
        packet.validate_publish()
        packet.protocol_version = client.properties.protocol_version
        packet.origin = client.id
        packet.created = time.time()

        self._resolve_inbound_alias(client, packet)
        if packet.topic.startswith("$") and not client.inline:
            # clients may not publish into reserved $ topics — except
            # $cluster/* arriving over an authenticated bridge link,
            # which is the federation wire (ADR 013)
            await self._process_cluster_inbound(client, packet)
            return
        if not self.hooks.any_allow("on_acl_check", client, packet.topic, True):
            # [MQTT-3.3.5-2]: ack but do not deliver (behind any acks
            # still parked on a durability barrier, [MQTT-4.6.0-2])
            self._ack_publish_ordered(client, packet, success=False)
            return
        if not self._check_publish_qos(client, packet):
            return  # QoS2 dedup re-acked without re-delivery

        try:
            packet = self.hooks.modify("on_publish", packet, client)
        except RejectPacket as r:
            self._ack_publish_ordered(client, packet, success=r.ack_success)
            return

        self.info.messages_received += 1
        if packet.fixed.retain:
            self.retain_message(client, packet)
        await self._route_publish(client, packet)

    def _trace_begin(self, client: Client, packet: Packet) -> None:
        """ADR 015: admit this publish into the sampling stride. The
        read loop timed the decode (packet._decode_ns) when tracing was
        on; the trace's start is backdated to the decode start so e2e
        covers wire-bytes -> terminal stage."""
        tracer = self.tracer
        dec = packet.__dict__.pop("_decode_ns", 0)
        now = tracer.clock()
        tr = tracer.sample(packet.topic, packet.fixed.qos, client.id,
                           start_ns=now - dec)
        if tr is None:
            return
        if dec:
            tr.span("decode", now - dec, now)
        tr.t_admit = now
        packet._trace = tr

    def _packet_trace(self, packet: Packet):
        # the gate opens for local sampling OR while an ADOPTED
        # cross-node trace is live (ADR 017) — a receiving node stamps
        # child spans even when its own sampling stride is off
        t = self.tracer
        return (packet.__dict__.get("_trace")
                if t.sample_n or t.adopted_open else None)

    async def _route_publish(self, client: Client, packet: Packet) -> None:
        """Ack + fan out an accepted publish. Durability barrier
        (ADR 014, storage_sync=always): the QoS ack must cover the
        publish's storage writes — and those are enqueued by the
        FAN-OUT (inflight records for QoS subscribers) as well as the
        retain rewrite — so under a barrier the ack moves after fan-out
        and releases on the journal's commit."""
        tr = self._packet_trace(packet)
        if tr is not None:
            tr.span("admission", tr.t_admit, self.tracer.clock())
        durable = self._needs_durable_ack(client, packet)
        if not durable:
            if tr is None:
                self._ack_publish(client, packet, success=True)
            else:
                t0 = self.tracer.clock()
                self._ack_publish(client, packet, success=True)
                tr.span("ack", t0, self.tracer.clock())
        elif packet.fixed.qos == 2:
            # the QoS2 dedup window opens NOW, not when the barrier
            # resolves: a client that times out and retransmits the
            # same id mid-barrier must be deduped, not redelivered
            # (_ack_publish re-adds on send — a set, idempotent)
            if packet.packet_id not in client.pubrec_inbound:
                client.pubrec_inbound.add(packet.packet_id)
                self._note_pubrec(client, packet.packet_id, True)
        if self.matcher is None:
            if tr is None:
                subscribers = self._match_cached(packet.topic)
            else:
                t0 = self.tracer.clock()
                subscribers = self._match_cached(packet.topic)
                tr.span("match_device", t0, self.tracer.clock())
            if durable:
                # shared with the pipeline consumer: fan-out failures
                # are logged, and the ack STILL releases durably
                self._pub_deliver(subscribers, client, packet, True)
            else:
                self._fan_out(subscribers, packet)
                self.hooks.notify("on_published", client, packet)
                if tr is not None:
                    self.tracer.finish(tr)
        else:
            # pipelined: dispatch the match NOW, fan out in arrival order
            # from the consumer task. The read loop returns immediately,
            # so a single connection can keep thousands of publishes in
            # flight — that in-flight depth is what lets the MicroBatcher
            # form device-sized batches instead of per-connection pairs.
            await self._enqueue_publish(client, packet, durable_ack=durable)

    async def _process_cluster_inbound(self, client: Client,
                                       packet: Packet) -> None:
        """``$cluster/*`` publishes from a recognized bridge peer are
        the federation wire: hand them to the ClusterManager, then ack
        on the normal QoS path (the link QoS is the delivery guarantee
        between nodes). Everything else in the ``$`` namespace from a
        network client stays dropped.

        The ack moves AFTER the apply (ADR 018): a QoS1 sess/fwd
        message is PUBACKed only once its op is applied and enqueued to
        the journal — the sender's replication/fwd barrier then means
        "the peer holds it", not "the peer's socket read it", closing
        the MQTT-ack-vs-apply window ADR 016 left open. The inbound
        half of the directed ``cluster.partition`` site sits before
        everything: a dropped message is in-flight loss (no ack, no
        apply), exactly what a blackholed path does."""
        mgr = self.cluster
        if (mgr is None or not packet.topic.startswith("$cluster/")
                or not mgr.is_bridge_client(client)):
            return
        sender = mgr.bridge_peer(client)
        try:
            hit = faults.fire_detail(
                faults.CLUSTER_PARTITION,
                key=faults.partition_key(sender, mgr.node_id))
        except faults.InjectedFault:
            hit = ("drop", 0.0)
        if hit is not None:
            if hit[0] == "hang":
                await asyncio.sleep(hit[1])
            else:
                mgr.partition_drops_in += 1
                return      # lost in flight: no ack, no apply
        # ADR 022: the WAN shape's receive-side loss draw — same
        # in-flight semantics as a partition drop (no ack, no apply),
        # so the sender's blip audit / parked retry machinery sees it
        # as real path loss rather than a link flap. Delay/jitter/rate
        # were already applied on the SENDER's writer; applying only
        # loss here keeps a one-process harness (one fault registry
        # serving both link ends) from shaping the same hop twice.
        shp = faults.REGISTRY.get_shape(
            faults.partition_key(sender, mgr.node_id))
        if shp is not None and shp.lose():
            mgr.shape_drops_in += 1
            faults.REGISTRY.count_fired(
                f"{faults.CLUSTER_SHAPE}#{sender}->{mgr.node_id}")
            return      # shaped loss: no ack, no apply
        if not self._check_publish_qos(client, packet):
            return  # repeated QoS2 id: already re-acked
        self.info.messages_received += 1
        await mgr.handle_inbound(client, packet)
        self._ack_publish(client, packet, success=True)

    @staticmethod
    def _resolve_inbound_alias(client: Client, packet: Packet) -> None:
        """Inbound v5 topic-alias resolution [MQTT-3.3.2-7..12]."""
        if client.properties.protocol_version < 5 or client.aliases is None:
            return
        alias = packet.properties.topic_alias
        if alias is None:
            return
        resolved = client.aliases.resolve_inbound(packet.topic, alias)
        if resolved is None:
            raise ProtocolError(codes.ErrTopicAliasInvalid)
        packet.topic = resolved
        packet.properties.topic_alias = None

    def _select_subscribers(self, subscribers: SubscriberSet,
                            packet: Packet) -> SubscriberSet:
        """Run the on_select_subscribers modify chain without exposing
        the (possibly cached) matched set to mutation.

        Accepts a materialized SubscriberSet or a DeliveryIntents
        (ADR 007) and materializes the cheapest safe form per tier:

        * ``select_subscribers_shared_only`` on every overrider (the
          worker-pool $share ownership filter): the hook only drops
          keys from the OUTER shared dict — shared-free publishes pass
          the set through untouched, shared ones re-wrap that one dict.
        * default: fresh dicts (hooks may add/drop/replace entries
          anywhere) over ALIASED Subscription records — records are
          immutable by contract (hooks/base.py, ADR 009; the churn
          suite's graft check enforces it), so selection-style hooks
          pay O(entries) dict copies built in C, never per-record
          copies.
        * ``select_subscribers_mutates_records`` on any overrider: the
          hook rewrites record fields (qos downgrades etc.) and gets a
          full ``deep_copy()`` per publish."""
        overriders = self.hooks._overriders("on_select_subscribers")
        intents_select = getattr(subscribers, "select_set", None)
        if any(getattr(h, "select_subscribers_mutates_records", False)
               for h in overriders):
            base = (subscribers.to_set() if intents_select is not None
                    else subscribers)
            return self.hooks.modify("on_select_subscribers",
                                     base.deep_copy(), packet)
        if all(getattr(h, "select_subscribers_shared_only", False)
               for h in overriders):
            base = (subscribers.to_set() if intents_select is not None
                    else subscribers)
            if not base.shared:
                return base
            sel = type(base)(base.subscriptions, dict(base.shared))
        elif intents_select is not None:
            sel = intents_select()
        else:
            sel = subscribers.select_copy()
        return self.hooks.modify("on_select_subscribers", sel, packet)

    def _check_publish_qos(self, client: Client, packet: Packet) -> bool:
        """Capability limits + QoS2 dedup + receive quota; False means
        the packet was already re-acked (repeated QoS2 id)."""
        if packet.fixed.qos > self.capabilities.maximum_qos:
            raise ProtocolError(codes.ErrQosNotSupported)
        if packet.fixed.retain and not self.capabilities.retain_available:
            raise ProtocolError(codes.ErrRetainNotSupported)
        # QoS2 dedup: a repeated packet id re-acks without re-delivery
        if packet.fixed.qos == 2 and packet.packet_id in client.pubrec_inbound:
            client.send(Packet(fixed=FixedHeader(type=PT.PUBREC),
                               protocol_version=packet.protocol_version,
                               packet_id=packet.packet_id))
            return False
        if packet.fixed.qos > 0 and not client.inflight.take_receive_quota():
            raise ProtocolError(codes.ErrReceiveMaximumExceeded)
        return True

    def _match_cached(self, topic: str) -> SubscriberSet:
        # safe even with on_select_subscribers hooks installed:
        # _select_subscribers hands hooks fresh dicts (records aliased
        # but immutable per the ADR 009 contract; a declared
        # select_subscribers_mutates_records hook gets a deep copy)
        version = self.topics.sub_version
        hit = self._match_cache.get(topic, version)
        if hit is not None:
            return hit
        result = self.topics.subscribers(topic)
        self._match_cache.put(topic, version, result)
        return result

    def _ack_publish(self, client: Client, packet: Packet, success: bool) -> None:
        qos = packet.fixed.qos
        if qos == 0 or client.inline:
            if qos > 0:
                client.inflight.return_receive_quota()
            return
        reason = 0 if success else codes.ErrNotAuthorized.value
        if qos == 1:
            client.inflight.return_receive_quota()
            self._send_ack(client, PT.PUBACK, packet, reason)
        elif qos == 2:
            if success:
                if packet.packet_id not in client.pubrec_inbound:
                    client.pubrec_inbound.add(packet.packet_id)
                    self._note_pubrec(client, packet.packet_id, True)
                tracer = self.tracer
                if ((tracer.sample_n or tracer.adopted_open)
                        and packet.__dict__.get("_trace") is not None):
                    # ADR 017 (closing the ADR-015 NOT-traced item):
                    # arm the release-leg stopwatch — PUBREC out ->
                    # PUBREL in, observed histogram-only (it waits on
                    # the publisher's network round trip). Bounded by
                    # the sampling stride; the dict dies with the
                    # client and _process_pubrel pops it either way.
                    client._qos2_release_t0[packet.packet_id] = \
                        tracer.clock()
            else:
                client.inflight.return_receive_quota()
            self._send_ack(client, PT.PUBREC, packet, reason)

    def _ack_publish_durable(self, client: Client, packet: Packet) -> None:
        """Release the success ack through the journal's durability
        barrier (ADR 014, ``storage_sync=always``): PUBACK/PUBREC go
        out only once every storage write this publish enqueued —
        retained rewrite + per-subscriber inflight records — has been
        group-committed. The event loop never waits: the barrier is a
        future resolved from the writer thread. A degraded journal
        (breaker open) returns no barrier — a dead disk must not wedge
        every QoS1 publisher.

        Acks drain through a per-client FIFO: a later publish whose
        barrier clears first (or that needed none) must not overtake an
        earlier ack still waiting [MQTT-4.6.0-2]."""
        jr = self._journal
        fut = jr.barrier(self.loop) if jr is not None else None
        if fut is not None:
            # counted here, not at the combined-future wait below: the
            # replication-only case must not inflate the ADR-014 storage
            # metric (sessions keep their own sync_barrier_waits)
            self.storage_barrier_waits += 1
        sessions = self._cluster_sessions()
        if sessions is not None and sessions.ack_coupled:
            # ADR 016: under cluster_session_sync=always the ack also
            # waits for peers to acknowledge the inflight replication
            # covering this publish — that is what a kill-failover to a
            # peer can redeliver. Both barriers are bounded/degradable.
            fut = self._combine_barriers(fut,
                                         sessions.sync_barrier(self.loop))
        if self.cluster is not None and getattr(self.cluster,
                                               "fwd_coupled", False):
            # ADR 018: cross-node publish durability — the ack also
            # waits (bounded) for every peer this publish forwarded to
            # to PUBACK the forward; the peer acks only after its own
            # apply+journal enqueue, so a released PUBACK means the
            # remote subscriber's node holds the message. Timed-out or
            # stranded forwards are parked for retry-after-heal
            # (degraded + counted, never a wedged publisher).
            fut = self._combine_barriers(
                fut, self.cluster.fwd_barrier(self.loop, packet))
        tr = self._packet_trace(packet)
        if tr is not None:
            tr.t_barrier = self.tracer.clock()
        if fut is None and not client.pending_durable_acks:
            self._ack_traced(client, packet, True, tr)
            return
        client.pending_durable_acks.append((fut, packet, True))
        if fut is None:
            self._drain_durable_acks(client)
        else:
            fut.add_done_callback(
                lambda _f: self._drain_durable_acks(client))

    def _needs_durable_ack(self, client: Client, packet: Packet) -> bool:
        """True when this publish's QoS ack must release through a
        barrier: the ADR-014 journal fsync (storage_sync=always) and/or
        the ADR-016 peer-replication ack (cluster_session_sync=always)."""
        if packet.fixed.qos == 0 or client.inline:
            return False
        if self._journal is not None and self._journal.barrier_needed:
            return True
        if (self.cluster is not None
                and getattr(self.cluster, "fwd_coupled", False)
                and self.cluster.links):
            return True     # ADR 018: the fwd leg may owe a barrier
        sessions = self._cluster_sessions()
        return sessions is not None and sessions.ack_coupled

    def _combine_barriers(self, a, b):
        """AND of two optional barrier futures (journal durability +
        session replication, ADR 014/016): resolves once both have."""
        if a is None or b is None:
            return a if b is None else b
        both = self.loop.create_future()

        def _one(_f) -> None:
            if a.done() and b.done() and not both.done():
                both.set_result(None)

        a.add_done_callback(_one)
        b.add_done_callback(_one)
        return both

    def _ack_traced(self, client: Client, packet: Packet, success: bool,
                    tr) -> None:
        """Release one (possibly traced) publish ack: the barrier span
        closes when the ack is unparked, the ack span covers its wire
        build/enqueue, and the trace finishes here — the publisher's
        terminal stage."""
        if tr is None:
            self._ack_publish(client, packet, success=success)
            return
        tracer = self.tracer
        now = tracer.clock()
        if tr.t_barrier:
            tr.span("barrier", tr.t_barrier, now)
        self._ack_publish(client, packet, success=success)
        tr.span("ack", now, tracer.clock())
        tracer.finish(tr)

    def _ack_publish_ordered(self, client: Client, packet: Packet,
                             success: bool) -> None:
        """A barrier-free ack (ACL refusal, rejected publish) that must
        still honor per-client ack order: if earlier acks are parked on
        a barrier, queue behind them instead of overtaking."""
        if not client.pending_durable_acks:
            self._ack_publish(client, packet, success)
            return
        client.pending_durable_acks.append((None, packet, success))

    def _drain_durable_acks(self, client: Client) -> None:
        q = client.pending_durable_acks
        while q and (q[0][0] is None or q[0][0].done()):
            _fut, packet, success = q.popleft()
            self._ack_traced(client, packet, success,
                             self._packet_trace(packet))

    def _send_ack(self, client: Client, ptype: int, packet: Packet,
                  reason: int) -> None:
        """QoS acks run once per QoS>0 publish: a success ack is a fixed
        4-byte wire (v5 elides the zero reason code + empty properties,
        [MQTT-3.4.2.1]), built directly unless a hook watches the encode
        or sent events."""
        pid = packet.packet_id
        if reason == 0 and not self.hooks.overrides("on_packet_encode") \
                and not self.hooks.overrides("on_packet_sent"):
            # PUBACK/PUBREC/PUBCOMP only (flags 0). Broker-side PUBREL
            # cannot take this path: it needs an inflight Packet copy
            # for resend (_process_pubrec).
            client.send_wire(bytes((ptype << 4, 2, pid >> 8, pid & 0xFF)))
            return
        client.send(Packet(fixed=FixedHeader(type=ptype),
                           protocol_version=packet.protocol_version,
                           packet_id=pid, reason_code=reason))

    def retain_message(self, client: Client, packet: Packet) -> None:
        stored = self.topics.retain(packet.copy())
        self.info.retained += stored
        self._note_retained_expiry(packet)
        self.hooks.notify("on_retain_message", client, packet, stored)

    # ------------------------------------------------------------------
    # PUBLISH fan-out — the hot loop the device matcher accelerates
    # ------------------------------------------------------------------

    # bound on publishes awaiting fan-out; a full queue backpressures the
    # offending connection's read loop instead of growing without limit
    PUB_PIPELINE_BOUND = 8192
    # the consumer's longest run on the loop (s): past it, it yields once
    # between two publishes, so the matches of later batches settle
    # while a fleet's fan-out runs (the supervisor's deadline timer would
    # otherwise fire on a result that had already come back)
    PUB_YIELD_S = 0.005

    async def _enqueue_publish(self, client: Client, packet: Packet,
                               durable_ack: bool = False) -> None:
        """Matcher-mode publish path: start the match immediately (the
        batcher coalesces concurrent ones into device batches) and queue
        the (future, packet) pair for the in-order fan-out consumer.
        ``durable_ack`` carries the ADR-014 barrier obligation: the
        consumer acks after fan-out, through the journal barrier."""
        if self._pub_consumer is None:
            if not self._running:
                # late publish after close() tore the pipeline down (the
                # queue is already drained, so order can't be violated):
                # serve it synchronously off the CPU trie
                self._fan_out(self.topics.subscribers(packet.topic), packet)
                self.hooks.notify("on_published", client, packet)
                if durable_ack:
                    self._ack_publish_durable(client, packet)
                return
            self._pub_queue = asyncio.Queue(maxsize=self.PUB_PIPELINE_BOUND)
            self._pub_consumer = self.loop.create_task(
                self._pub_pipeline_loop(), name="publish-pipeline")
        fut = self._dispatch_match(packet.topic)
        tr = self._packet_trace(packet)
        if tr is not None:
            tr.t_match = self.tracer.clock()
        await self._pub_queue.put((fut, client, packet, durable_ack))

    def _dispatch_match(self, topic: str) -> asyncio.Future:
        enq = getattr(self.matcher, "enqueue", None)
        if enq is not None:
            return enq(topic)
        return asyncio.ensure_future(self._match_async(topic))

    async def _pub_pipeline_loop(self) -> None:
        """Drain the publish pipeline in arrival order: await each match
        result, fan out, fire on_published. A matcher failure degrades
        that one publish to the CPU trie — delivery never silently drops.

        With content subscriptions registered (ADR 023) the loop drains
        every already-queued publish into one flush — bounded by
        filter_batch_max — so the content plane decodes payloads and
        evaluates every (publish x predicate) pair in one vectorized
        pass; arrival order is preserved end to end. With the plane
        inactive the pre-023 single-item path runs unchanged.

        Awaiting a match that is already done does not yield, so a run of
        settled publishes fans out in one callback: the consumer yields
        once it has held the loop ``PUB_YIELD_S``. Arrival order holds
        (it is the only consumer)."""
        clock = time.perf_counter
        held = clock()
        while True:
            if clock() - held >= self.PUB_YIELD_S:
                await asyncio.sleep(0)
                held = clock()
            item = await self._pub_queue.get()
            cp = self.content
            if cp is not None and cp.active:
                batch = [item]
                while len(batch) < cp.batch_max:
                    try:
                        batch.append(self._pub_queue.get_nowait())
                    except asyncio.QueueEmpty:
                        break
                await self._pub_deliver_batch(batch)
                continue
            fut, client, packet, durable_ack = item
            try:
                subscribers = await self._await_match(fut, packet)
                if self.tracer.sample_n or self.tracer.adopted_open:
                    self._trace_match_spans(fut, packet)
                self._pub_deliver(subscribers, client, packet, durable_ack)
            finally:
                self._pub_queue.task_done()

    async def _await_match(self, fut, packet: Packet):
        """Await one match future with the pipeline's degrade ladder:
        a cancelled future (not a cancelled consumer) or a matcher
        failure serves that one publish from the CPU trie."""
        try:
            return await fut
        except asyncio.CancelledError:
            # CancelledError is a BaseException: catch it
            # explicitly or a batcher-close cancelling a MATCH
            # future kills the consumer. cancelling() (3.11+)
            # distinguishes "we are being cancelled" from "only
            # the future was"; without it, stay conservative.
            me = asyncio.current_task()
            cancelling = getattr(me, "cancelling", None)
            if cancelling is None or cancelling():
                raise
            return self.topics.subscribers(packet.topic)
        except Exception as exc:
            self.matcher_degrades += 1
            self.tracer.note_error("match_device", "matcher_failed")
            tr = self._packet_trace(packet)
            if tr is not None:
                tr.degraded = "pipeline_trie"
            if self.log is not None:
                self.log.with_prefix("broker").error(
                    "matcher failed; trie fallback",
                    topic=packet.topic, error=repr(exc))
            return self.topics.subscribers(packet.topic)

    async def _pub_deliver_batch(self, batch: list) -> None:
        """One content-plane flush (ADR 023): resolve every match in
        arrival order, evaluate the batch's predicate matrix once,
        then deliver in the same order. task_done fires once per item
        even when a resolve raises mid-batch (consumer cancellation)."""
        try:
            resolved = []
            for fut, client, packet, durable_ack in batch:
                subscribers = await self._await_match(fut, packet)
                resolved.append(
                    (fut, subscribers, client, packet, durable_ack))
            cp = self.content
            if cp is not None and cp.active:
                cp.apply([(packet, subscribers)
                          for _f, subscribers, _c, packet, _d in resolved])
            clock = time.perf_counter
            held = clock()
            for fut, subscribers, client, packet, durable_ack in resolved:
                if clock() - held >= self.PUB_YIELD_S:
                    await asyncio.sleep(0)     # as _pub_pipeline_loop
                    held = clock()
                if self.tracer.sample_n or self.tracer.adopted_open:
                    self._trace_match_spans(fut, packet)
                self._pub_deliver(subscribers, client, packet, durable_ack)
        finally:
            for _ in batch:
                self._pub_queue.task_done()

    def _trace_match_spans(self, fut, packet: Packet) -> None:
        """ADR 015: decompose the matcher leg of one sampled publish.
        The batcher stamps ``_t_dispatch``/``_t_done`` on the match
        future (the supervisor forwards them), splitting coalescing
        wait from device/trie time; whatever the consumer waited past
        the result — in-order fan-out behind earlier publishes — is
        the pipeline_wait segment."""
        tr = packet.__dict__.get("_trace")
        if tr is None or not tr.t_match:
            return
        tracer = self.tracer
        now = tracer.clock()
        td = getattr(fut, "_t_dispatch", 0)
        tdone = getattr(fut, "_t_done", 0)
        if td:
            tr.span("match_queue", tr.t_match, td)
            tr.span("match_device", td, tdone or now)
        else:
            tr.span("match_device", tr.t_match, tdone or now)
        if tdone and now > tdone:
            tr.span("pipeline_wait", tdone, now)
        rung = getattr(self.matcher, "breaker_state_name", None)
        if rung and rung != "closed":
            tr.degraded = rung      # ADR-011 supervisor rung label

    def _pub_deliver(self, subscribers, client, packet: Packet,
                     durable_ack: bool) -> None:
        """One pipeline delivery: fan out, notify, and (under the
        ADR-014 barrier) release the publisher's ack durably."""
        try:
            self._fan_out(subscribers, packet)
            if client is not None:
                self.hooks.notify("on_published", client, packet)
        except Exception as exc:
            # a raising hook must cost this publish, not the
            # consumer: a dead consumer would wedge every
            # matcher-mode publisher behind a full queue
            self.tracer.note_error("fanout", "hook_error")
            if self.log is not None:
                self.log.with_prefix("broker").error(
                    "publish fan-out failed", topic=packet.topic,
                    error=repr(exc))
        if durable_ack and client is not None:
            # even after a failed fan-out the ack must release (the
            # barrier covers what DID get written) or the publisher
            # wedges behind a PUBACK that never comes
            self._ack_publish_durable(client, packet)
        else:
            tr = self._packet_trace(packet)
            if tr is not None:
                self.tracer.finish(tr)

    async def publish_to_subscribers(self, packet: Packet) -> None:
        """Parity: v2/server.go:766-868. Matching goes through the pluggable
        matcher (a device engine) when attached, else the CPU trie; hooks
        may then override via on_select_subscribers, mirroring the
        reference.

        When the publish pipeline is active, out-of-band producers (wills,
        $SYS, inline/injected publishes) enqueue behind it rather than
        fanning out directly — a will must not overtake its own client's
        still-queued publishes."""
        if self.matcher is not None:
            if self._pub_consumer is not None:
                await self._pub_queue.put(
                    (self._dispatch_match(packet.topic), None, packet,
                     False))
                return
            subscribers = await self._match_async(packet.topic)
        else:
            subscribers = self.topics.subscribers(packet.topic)
        self._fan_out(subscribers, packet)

    def _fan_out(self, subscribers, packet: Packet) -> None:
        """Local fan-out + cluster forwarding (ADR 013). Every publish
        path funnels through here exactly once, so the route-table
        consult happens once per publish regardless of matcher mode —
        and the ADR-015 fanout/bridge spans are stamped once too."""
        cp = self.content
        if (cp is not None and cp.active
                and "_content_skip" not in packet.__dict__):
            # trie-path / will / $SYS / inline publishes reach here
            # without riding the pipeline flush: evaluate them as a
            # single-packet batch (the pipeline path already stamped
            # its packets, which is what the sentinel key records)
            cp.apply(((packet, subscribers),))
        tr = self._packet_trace(packet)
        if tr is None:
            self._fan_out_local(subscribers, packet)
            if self.cluster is not None:
                self.cluster.maybe_forward(packet)
            return
        clock = self.tracer.clock
        t0 = clock()
        self._fan_out_local(subscribers, packet)
        t1 = clock()
        tr.span("fanout", t0, t1)
        if self.cluster is not None:
            self.cluster.maybe_forward(packet)
            tr.span("bridge", t1, clock())

    def _fan_out_local(self, subscribers, packet: Packet) -> None:
        """Sync fan-out half (no awaits): shared-group selection + per-
        subscriber delivery. The trie path calls it directly so a QoS0
        publish costs no extra coroutine hop.

        ``subscribers`` is either a SubscriberSet or a DeliveryIntents
        (ADR 007: the native decode's fan-out-ready form — iterable of
        (cid, sub) with a ``shared`` dict and ``has_client``). Intents
        skip the merged-dict materialization on the hot path; the hook
        override path materializes the cheapest safe SubscriberSet form
        via _select_subscribers' tiers."""
        to_set = getattr(subscribers, "to_set", None)
        if self.hooks.overrides("on_select_subscribers"):
            # shared_only hooks (the worker-pool $share ownership
            # filter) only drop keys from the outer shared dict: on a
            # shared-free intents result they are identity, so the fast
            # path survives — pool deployments must not pay set
            # materialization on every publish
            shared_only = to_set is not None and all(
                getattr(h, "select_subscribers_shared_only", False)
                for h in self.hooks._overriders("on_select_subscribers"))
            if not (shared_only and len(subscribers) == subscribers.n):
                subscribers = self._select_subscribers(subscribers, packet)
                to_set = None
        if to_set is None:
            shared = subscribers.shared
            if shared:
                plain = subscribers.subscriptions
                self._fan_out_shared(shared, plain.__contains__, packet)
            for cid, sub in subscribers.subscriptions.items():
                self._publish_to_client(cid, sub, packet, shared=False)
            return
        # intents fast path: flat entries, no dict in sight
        if len(subscribers) != subscribers.n:   # any shared candidates?
            self._fan_out_shared(subscribers.shared,
                                 subscribers.has_client, packet)
        for cid, sub in subscribers:
            self._publish_to_client(cid, sub, packet, shared=False)

    def _fan_out_shared(self, shared, has_plain, packet: Packet) -> None:
        """$share: pick one member per (group, filter), merging per
        client; a client already receiving a plain delivery is skipped
        [MQTT-4.8.2-4]."""
        selected: dict[str, Subscription] = {}
        sessions = self._cluster_sessions()
        token = None
        if (sessions is not None
                and sessions.manager.routes.shares.balance == "weighted"):
            # ADR 018: fairness-aware cluster $share — every node
            # derives the same per-publish token from the same bytes,
            # so the weighted rotation stays exactly-once cluster-wide
            # (pin mode never reads it: skip the payload hash)
            token = crc32(packet.payload,
                          crc32(packet.topic.encode()))
        for (group, filt), candidates in shared.items():
            if sessions is not None and not sessions.owns_share(
                    group, filt, token):
                # ADR 016/018: cluster-wide $share — another node owns
                # this (group, filter) pick for this publish; its
                # forward copy delivers there, so the group receives
                # the publish exactly once cluster-wide
                continue
            pick = self.topics.select_shared(
                group, filt, candidates,
                alive=lambda cid: (c := self.clients.get(cid)) is not None
                and not c.closed)
            if pick is not None:
                cid, sub = pick
                prev = selected.get(cid)
                if prev is None or sub.qos > prev.qos:
                    selected[cid] = sub
        for cid, sub in selected.items():
            if not has_plain(cid):
                self._publish_to_client(cid, sub, packet, shared=True)

    async def _match_async(self, topic: str) -> SubscriberSet:
        async_fn = getattr(self.matcher, "subscribers_async", None)
        if async_fn is not None:
            return await async_fn(topic)
        result = self.matcher.subscribers(topic)
        if asyncio.iscoroutine(result):
            result = await result
        return result

    def _fast_qos0_eligible(self, client: Client, sub: Subscription,
                            packet: Packet) -> bool:
        """True when the delivered packet carries no per-subscriber state
        (qos 0 out, retain cleared, no v5 subscription ids / aliases) —
        its wire bytes are then IDENTICAL for every such subscriber and
        ONE shared bytes object serves them all. Per-subscriber feature
        flags no longer force the copy+encode slow path: they select
        the patched-template strategy instead (_send_template_qos0 /
        _send_template_qos, ADR 019). Disabled when any hook watches
        the encode/sent events."""
        return (min(packet.fixed.qos, sub.qos,
                    self.capabilities.maximum_qos) == 0
                and not client.closed
                and not (sub.retain_as_published and packet.fixed.retain)
                and not (client.properties.protocol_version >= 5
                         and (sub.identifiers or sub.identifier
                              or client.properties.topic_alias_maximum))
                and not client.properties.maximum_packet_size
                and not self.hooks.overrides("on_packet_encode")
                and not self.hooks.overrides("on_packet_sent"))

    @staticmethod
    def _delivery_form(packet: Packet, version: int) -> Packet:
        """The normalized QoS0 delivery copy (what the fast path encodes
        and what drop hooks observe)."""
        out = packet.copy()
        out.protocol_version = version
        out.fixed.qos = 0
        out.fixed.dup = False
        out.fixed.retain = False
        out.packet_id = 0
        if version >= 5:
            out.properties.subscription_ids = []
            out.properties.topic_alias = None
        else:
            out.properties = type(out.properties)()
        return out

    def _send_fast_qos0(self, client: Client, packet: Packet) -> None:
        """Encode once per (packet, version) and enqueue raw bytes —
        per-subscriber copy + encode is the dominant fan-out cost."""
        version = client.properties.protocol_version
        cache = packet.__dict__.get("_wire0")
        if cache is None:
            cache = {}
            packet.__dict__["_wire0"] = cache
        wire = cache.get(version)
        if wire is None:
            if version < 5 or packet.properties.is_empty():
                # direct wire build — the common no-properties delivery
                # needs no Packet/Properties copies at all
                tb = packet.topic.encode()
                body = bytearray(len(tb).to_bytes(2, "big"))
                body += tb
                if version >= 5:
                    body.append(0)          # empty properties block
                body += packet.payload
                wire_b = bytearray([0x30])  # PUBLISH, qos0/dup0/retain0
                write_varint(wire_b, len(body))
                wire = bytes(wire_b + body)
            else:
                wire = self._delivery_form(packet, version).encode()
            cache[version] = wire
            self.overload.template_builds += 1
        if not client.send_wire(wire):
            self.info.messages_dropped += 1
            if self.hooks.overrides("on_publish_dropped"):
                self.hooks.notify("on_publish_dropped", client,
                                  self._delivery_form(packet, version))
            return
        # ADR 019 ledger: the single shared bytes object is enqueued
        # per subscriber — every delivered byte is reused, none copied
        self.overload.template_sends += 1
        self.overload.shared_bytes += len(wire)
        if self.tracer.sample_n or self.tracer.adopted_open:
            self._trace_drain(client, packet)

    def _trace_drain(self, client: Client, packet: Packet) -> None:
        """ADR 015: register one subscriber's enqueue->flush watcher on
        the ORIGINAL publish's trace (delivery copies don't alias it);
        the client's writer task settles it after its next flush, so
        the span crosses into the writer-task domain."""
        tr = packet.__dict__.get("_trace")
        if tr is not None and tr.n_drain < MAX_DRAIN_SPANS:
            tr.n_drain += 1
            client._drain_traces.append(
                (tr, self.tracer.clock(), client.outbound.enqueued))

    def _template_eligible(self, client: Client) -> bool:
        """ADR 019: per-subscriber frame variation (QoS flags, packet
        id, v5 subscription ids / topic alias / retain-as-published /
        max-packet-size) selects a patch strategy over the shared wire
        template instead of the per-subscriber copy+encode. Encode/sent
        hook overrides force the slow path — those hooks must observe
        each delivery as a real mutable Packet — and so does an
        instance-patched ``send``/``send_buffers`` (the embedder/test
        seam for intercepting shaped deliveries)."""
        d = client.__dict__
        return ("send" not in d and "send_buffers" not in d
                and not self.hooks.overrides("on_packet_encode")
                and not self.hooks.overrides("on_packet_sent"))

    def _template_for(self, packet: Packet, version: int):
        """The (packet, version) shared template, counted on first
        build (the ledger term the fan-out bench divides by)."""
        cache = packet.__dict__.get("_tmpl")
        if cache is None or (5 if version >= 5 else 4) not in cache:
            self.overload.template_builds += 1
        return wire.publish_template(packet, version)

    def _send_template_qos0(self, client: Client, sub: Subscription,
                            packet: Packet) -> bool:
        """One QoS0 delivery whose frame VARIES per subscriber
        (retain-as-published, v5 subscription ids / topic alias, a
        client max-packet-size to honor): patch the shared template
        instead of copy+encode (ADR 019). Returns False to fall back
        to the per-subscriber encode — only when the worst-case frame
        could exceed the client's maximum packet size, decided BEFORE
        any outbound alias is consumed so the fallback's own
        ``assign_outbound`` is the only assignment."""
        version = client.properties.protocol_version
        tmpl = self._template_for(packet, version)
        retain = bool(sub.retain_as_published and packet.fixed.retain)
        ids: list = []
        alias = None
        alias_topic = False
        mid = b""
        if version >= 5:
            ids = sorted(set(sub.identifiers.values())
                         or ({sub.identifier} if sub.identifier
                             else set()))
            mid = wire.sid_alias_seg(ids, None)
            aliases_on = (client.aliases is not None
                          and client.properties.topic_alias_maximum)
            mps = client.properties.maximum_packet_size
            if mps and tmpl.frame_size(
                    len(mid) + (3 if aliases_on else 0), False) > mps:
                return False    # encode_under may shed user properties
            if aliases_on:
                a, first = client.aliases.assign_outbound(packet.topic)
                if a:
                    alias = a
                    alias_topic = not first
                    mid = wire.sid_alias_seg(ids, alias)
        bufs, size = tmpl.patch(0, retain, 0, mid, alias_topic,
                                native=self.capabilities.native_encode)
        if not client.send_buffers(bufs, size):
            self.info.messages_dropped += 1
            if self.hooks.overrides("on_publish_dropped"):
                out = self._delivery_form(packet, version)
                out.fixed.retain = retain
                if version >= 5:
                    out.properties.subscription_ids = ids
                    out.properties.topic_alias = alias
                    if alias_topic:
                        out.topic = ""
                self.hooks.notify("on_publish_dropped", client, out)
            return True
        overload = self.overload
        overload.template_sends += 1
        overload.shared_bytes += tmpl.shared_len
        overload.copied_bytes += size - tmpl.shared_len
        if self.tracer.sample_n or self.tracer.adopted_open:
            self._trace_drain(client, packet)
        return True

    def _send_template_qos(self, client: Client, out: Packet,
                           packet: Packet) -> bool:
        """One QoS>0 first transmission patched from the shared
        template (ADR 019). ``out`` is the inflight-registered shaped
        copy from _build_outbound — the patch derives flags, packet id
        and the spliced v5 segment from it, so session resume, DUP
        resends and the ack state machines keep operating on real
        Packets. Returns False to fall back to _send_outbound (frame
        over the client's max packet size: encode_under may still
        save it by shedding user properties)."""
        version = client.properties.protocol_version
        tmpl = self._template_for(packet, version)
        mid = b""
        alias_topic = False
        if version >= 5:
            pr = out.properties
            mid = wire.sid_alias_seg(pr.subscription_ids,
                                     pr.topic_alias)
            alias_topic = not out.topic
        bufs, size = tmpl.patch(out.fixed.qos, out.fixed.retain,
                                out.packet_id, mid, alias_topic,
                                native=self.capabilities.native_encode)
        mps = client.properties.maximum_packet_size
        if mps and size > mps:
            return False
        if not client.send_buffers(bufs, size):
            self._count_refused_send(client, out)
            return True
        overload = self.overload
        overload.template_sends += 1
        overload.shared_bytes += tmpl.shared_len
        overload.copied_bytes += size - tmpl.shared_len
        if self.tracer.sample_n or self.tracer.adopted_open:
            self._trace_drain(client, packet)
        return True

    def _publish_to_client(self, client_id: str, sub: Subscription,
                           packet: Packet, shared: bool) -> None:
        """Parity: v2/server.go:795-868 (publishToClient)."""
        client = self.clients.get(client_id)
        if client is None:
            return
        if sub.no_local and packet.origin == client_id:
            return  # v5 NoLocal [MQTT-3.8.3-3]
        skip = packet.__dict__.get("_content_skip")
        if skip is not None and not shared and client_id in skip:
            return  # ADR 023: every claim this client has on the topic
            #         is content-gated and none passed (shared picks
            #         are exempt: $share filters carry no options)
        if self._shed_qos0(client, sub, packet):
            return  # above the high-water mark: QoS0 fan-out shed
        if self._fast_qos0_eligible(client, sub, packet):
            self._send_fast_qos0(client, packet)
            return
        template = self._template_eligible(client)
        if (template and not client.closed
                and min(packet.fixed.qos, sub.qos,
                        self.capabilities.maximum_qos) == 0
                and self._send_template_qos0(client, sub, packet)):
            return

        out = self._build_outbound(client, sub, packet)
        if client.closed and out.fixed.qos == 0:
            return  # QoS0 is not queued for offline clients
        if out.fixed.qos > 0 and not self._enqueue_qos(client, out):
            return  # dropped, exhausted, or parked on send quota
        if client.closed:
            return  # queued in inflight for session resume
        if (template and out.fixed.qos > 0
                and self._send_template_qos(client, out, packet)):
            return
        self._send_outbound(client, out, packet)

    def _send_outbound(self, client: Client, out: Packet,
                       packet: Packet) -> None:
        """Enqueue one shaped delivery: a refusal rolls back (ADR 012),
        an accepted one registers its ADR-015 drain watcher."""
        if not client.send(out):
            self._count_refused_send(client, out)
        elif self.tracer.sample_n or self.tracer.adopted_open:
            self._trace_drain(client, packet)

    def _shed_qos0(self, client: Client, sub: Subscription,
                   packet: Packet) -> bool:
        """Global load-shed (ADR 012): while above the high-water mark
        effective-QoS0 fan-out is shed outright; QoS>0 continues on the
        session/inflight rules."""
        if (not self.overload.shedding or client.closed
                or min(packet.fixed.qos, sub.qos,
                       self.capabilities.maximum_qos) > 0):
            return False
        self.overload.shed_messages += 1
        self.info.messages_dropped += 1
        client.note_drop("shed")
        return True

    def _count_refused_send(self, client: Client, out: Packet) -> None:
        """A delivery the outbound queue/byte budget refused. QoS>0 is
        rolled back so it neither leaks send quota nor leaves a stale
        inflight entry, and counts under its own reason — not the
        generic messages_dropped (docs/migration.md, round 8)."""
        self.hooks.notify("on_publish_dropped", client, out)
        if out.fixed.qos > 0:
            self._rollback_refused_qos(client, out)
        else:
            self.info.messages_dropped += 1

    def _rollback_refused_qos(self, client: Client, out: Packet,
                              release_held: bool = True) -> None:
        """The one QoS>0 rollback invariant (ADR 012): a refused
        delivery leaks nothing — inflight entry dropped, send quota
        returned, counted under qos_drops — and the freed quota is
        offered to any PARKED message, which would otherwise wedge in
        held_pids waiting for an ack that can never come."""
        self.overload.qos_drops += 1
        client.inflight.delete(out.packet_id)
        client.inflight.return_send_quota()
        self.info.inflight -= 1
        if release_held:
            self._release_held(client)

    def _build_outbound(self, client: Client, sub: Subscription,
                        packet: Packet) -> Packet:
        """Shape the delivery copy for one subscriber: effective QoS,
        retain-as-published, and the v5 property set (subscription ids,
        outbound topic alias)."""
        out = packet.copy()
        tr = self._packet_trace(packet)
        if tr is not None:
            # ADR 017: a lightweight (origin, id) tag — NOT the trace
            # itself (delivery copies must not alias the span list) —
            # so downstream hooks (session replication) can correlate
            out._trace_ref = (tr.origin or self.tracer.node_id, tr.id)
        out.protocol_version = client.properties.protocol_version
        out.fixed.qos = min(packet.fixed.qos, sub.qos,
                            self.capabilities.maximum_qos)
        out.fixed.dup = False
        if not sub.retain_as_published:
            out.fixed.retain = False
        if client.properties.protocol_version < 5:
            out.properties = type(out.properties)()
            return out
        ids = sorted(set(sub.identifiers.values())
                     or ({sub.identifier} if sub.identifier else set()))
        out.properties.subscription_ids = ids
        out.properties.topic_alias = None
        if client.aliases is not None and client.properties.topic_alias_maximum:
            alias, first = client.aliases.assign_outbound(out.topic)
            if alias and not first:
                out.properties.topic_alias = alias
                out.topic = ""
            elif alias:
                out.properties.topic_alias = alias
        return out

    def _enqueue_qos(self, client: Client, out: Packet) -> bool:
        """QoS>0 inflight bookkeeping; returns False when the message
        was dropped (cap), exhausted (no free packet id), or parked
        until an ack returns send quota (_release_held)."""
        if len(client.inflight) >= self.capabilities.maximum_inflight:
            self.info.inflight_dropped += 1
            self.hooks.notify("on_qos_dropped", client, out)
            return False
        try:
            out.packet_id = client.next_packet_id()
        except PacketIDExhausted:
            self.hooks.notify("on_packet_id_exhausted", client, out)
            return False
        out.created = time.time()
        client.inflight.set(out.copy())
        self._note_inflight(out)
        self.info.inflight += 1
        if not client.inflight.take_send_quota():
            client.held_pids.append(out.packet_id)
            # ADR 018 (satellite): a quota-parked message is IN the
            # window — notify now so the storage hook journals it and
            # the session federation replicates it (held=True rides the
            # record); the release notifies again, clearing the flag.
            # Without this, a crash or takeover silently dropped every
            # held message (the shared ADR-014/016 NOT-done gap).
            self.hooks.notify("on_qos_publish", client, out,
                              out.created, 0)
            return False
        self.hooks.notify("on_qos_publish", client, out, out.created, 0)
        return True

    # ------------------------------------------------------------------
    # QoS acknowledgement state machines (v2/server.go:909-987)
    # ------------------------------------------------------------------

    def _release_held(self, client: Client) -> None:
        """Send parked QoS messages as send quota becomes available."""
        while client.held_pids:
            if not client.inflight.take_send_quota():
                return
            pid = client.held_pids.popleft()
            held = client.inflight.get(pid)
            if held is None:
                client.inflight.return_send_quota()
                continue
            out = held.copy()
            # encoded for this connection, as resend_inflight does
            out.protocol_version = client.properties.protocol_version
            self.hooks.notify("on_qos_publish", client, out, time.time(), 0)
            if not client.closed and not client.send(out):
                # roll back the whole release: keeping the inflight
                # entry while the quota stayed taken (the pre-ADR-012
                # behavior) leaked quota and wedged a stale entry.
                # release_held=False: the enclosing loop IS the drain.
                self._rollback_refused_qos(client, out,
                                           release_held=False)
                self.hooks.notify("on_publish_dropped", client, out)

    def _process_puback(self, client: Client, packet: Packet) -> None:
        if client.inflight.delete(packet.packet_id):
            self.info.inflight -= 1
            client.inflight.return_send_quota()
            self.hooks.notify("on_qos_complete", client, packet)
            self._release_held(client)

    def _process_pubrec(self, client: Client, packet: Packet) -> None:
        if client.inflight.get(packet.packet_id) is None:
            # unknown id -> PUBREL with not-found (v5)
            # [MQTT-4.3.3-7]; checked before the reason, as the
            # reference does (server.go:926-936)
            client.send(Packet(
                fixed=FixedHeader(type=PT.PUBREL),
                protocol_version=client.properties.protocol_version,
                packet_id=packet.packet_id,
                reason_code=codes.ErrPacketIdentifierNotFound.value
                if client.properties.protocol_version >= 5 else 0))
            return
        if packet.reason_code >= 0x80 or not packet.reason_code_valid():
            # [MQTT-4.3.3-4]: error or out-of-spec reason ends the QoS2
            # flow (MQTT5 §4.13.2 ¶2; reference server.go:930-936)
            if client.inflight.delete(packet.packet_id):
                self.info.inflight -= 1
                client.inflight.return_send_quota()
            self.hooks.notify("on_qos_dropped", client, packet)
            self._release_held(client)
            return
        rel = Packet(fixed=FixedHeader(type=PT.PUBREL),
                     protocol_version=client.properties.protocol_version,
                     packet_id=packet.packet_id)
        rel.created = time.time()
        client.inflight.set(rel.copy())
        self._note_inflight(rel)
        client.send(rel)

    def _process_pubrel(self, client: Client, packet: Packet) -> None:
        t0 = client._qos2_release_t0.pop(packet.packet_id, None)
        if t0 is not None:
            # QoS2 release leg (ADR 017): PUBREC sent -> PUBREL
            # received, for sampled publishes only
            self.tracer.observe(
                "release", max(self.tracer.clock() - t0, 0) / 1e9)
        if packet.packet_id not in client.pubrec_inbound:
            # unknown id -> PUBCOMP (not-found on v5) [MQTT-4.3.3-7];
            # checked before the reason, as the reference does
            # (server.go:946-957)
            if client.properties.protocol_version < 5:
                self._send_ack(client, PT.PUBCOMP, packet, 0)
            else:
                client.send(Packet(
                    fixed=FixedHeader(type=PT.PUBCOMP),
                    protocol_version=client.properties.protocol_version,
                    packet_id=packet.packet_id,
                    reason_code=codes.ErrPacketIdentifierNotFound.value))
            return
        client.pubrec_inbound.discard(packet.packet_id)
        self._note_pubrec(client, packet.packet_id, False)
        client.inflight.return_receive_quota()
        if packet.reason_code >= 0x80 or not packet.reason_code_valid():
            # [MQTT-4.3.3-9]: the receiver abandons the inbound QoS2
            # message (reference server.go:951-957)
            self.hooks.notify("on_qos_dropped", client, packet)
            return
        self._send_ack(client, PT.PUBCOMP, packet, 0)
        self.hooks.notify("on_qos_complete", client, packet)

    def _process_pubcomp(self, client: Client, packet: Packet) -> None:
        if client.inflight.delete(packet.packet_id):
            self.info.inflight -= 1
            client.inflight.return_send_quota()
            self.hooks.notify("on_qos_complete", client, packet)
            self._release_held(client)

    # ------------------------------------------------------------------
    # SUBSCRIBE / UNSUBSCRIBE (v2/server.go:990-1129)
    # ------------------------------------------------------------------

    def _process_subscribe(self, client: Client, packet: Packet) -> None:
        packet = self.hooks.modify("on_subscribe", packet, client)
        caps = self.capabilities
        reason_codes: list[int] = []
        counts: list[int] = []
        accepted: list[Subscription] = []
        specs = self._content_specs(client, packet)
        for sub in packet.filters:
            filt = sub.filter
            spec = None
            if specs is not None:
                # ADR 023: split/parse content options (?$expr / ?$agg
                # suffix, or the v5 user-property carriage); malformed
                # options reject THIS filter cleanly
                options = None
                if "?" in filt:
                    filt, _, options = filt.partition("?")
                elif filt in specs:
                    options = specs[filt]
                if options is not None:
                    try:
                        if filt.startswith("$share/"):
                            raise ExprError(
                                "content options on a $share filter")
                        spec = self.content.parse_spec(options)
                    except ExprError:
                        self.content.rejected_subscribes += 1
                        reason_codes.append(
                            codes.ErrTopicFilterInvalid.value)
                        counts.append(0)
                        continue
                    sub.filter = filt   # index/cluster/session all see
                    #                     the base filter from here on
                    # ADR 023/024: the storage hook persists the raw
                    # option string with the subscription record so
                    # the spec survives restart + session restore
                    sub.content_options = options
            if not valid_filter(filt,
                                shared_allowed=caps.shared_sub_available,
                                wildcards_allowed=caps.wildcard_sub_available):
                if not valid_filter(filt):
                    reason_codes.append(codes.ErrTopicFilterInvalid.value)
                elif filt.startswith("$share/"):
                    reason_codes.append(
                        codes.ErrSharedSubscriptionsNotSupported.value)
                else:
                    reason_codes.append(
                        codes.ErrWildcardSubscriptionsNotSupported.value)
                counts.append(0)
                continue
            if filt.startswith("$share/") and sub.no_local:
                # [MQTT-3.8.3-4]: NoLocal on shared subscription is an error
                raise ProtocolError(codes.ErrProtocolViolation,
                                    "no-local shared subscription")
            if not self.hooks.any_allow("on_acl_check", client, filt, False):
                reason_codes.append(codes.ErrNotAuthorized.value)
                counts.append(0)
                continue
            granted = min(sub.qos, caps.maximum_qos)
            sub.qos = granted
            if not caps.sub_id_available:
                sub.identifier = 0
            if spec is not None:
                try:
                    self.content.register(client.id, filt, spec)
                except ContentQuota:
                    # refused BEFORE the topic index sees it: nothing
                    # to roll back, the quota answer is the SUBACK code
                    self.content.rejected_subscribes += 1
                    reason_codes.append(codes.ErrQuotaExceeded.value)
                    counts.append(0)
                    continue
            elif self.content is not None:
                # a plain re-SUBSCRIBE on the same filter replaces any
                # earlier content options (resubscribe semantics)
                self.content.unregister(client.id, filt)
            is_new = self.topics.subscribe(client.id, sub)
            if is_new:
                self.info.subscriptions += 1
            client.subscriptions[filt] = sub
            accepted.append((sub, is_new))
            reason_codes.append(granted)
            counts.append(1 if is_new else 0)
        client.send(Packet(fixed=FixedHeader(type=PT.SUBACK),
                           protocol_version=client.properties.protocol_version,
                           packet_id=packet.packet_id,
                           reason_codes=reason_codes))
        self.hooks.notify("on_subscribed", client, packet, reason_codes, counts)
        self._cluster_note_subs(accepted)
        for sub, is_new in accepted:
            self._publish_retained_to(client, sub, existing=not is_new)

    def _content_specs(self, client: Client,
                       packet: Packet) -> dict[str, str] | None:
        """ADR 023: the v5 user-property carriage of content options —
        each ``maxmq-filter`` property holds ``<filter>?<options>``
        and applies to the matching filter in this SUBSCRIBE. Returns
        None when the content plane is off (then ``?`` stays a plain
        topic character, the documented opt-in)."""
        if self.content is None:
            return None
        out: dict[str, str] = {}
        if client.properties.protocol_version >= 5:
            for key, val in packet.properties.user_properties:
                if key == FILTER_PROP_KEY:
                    base, sep, options = val.partition("?")
                    if sep:
                        out[base] = options
        return out

    def _cluster_note_subs(self, accepted) -> None:
        """Feed brand-new subscriptions into the federation route
        table (ADR 013) so peers learn them as aggregated deltas."""
        if self.cluster is None:
            return
        for sub, is_new in accepted:
            if is_new:
                self.cluster.note_subscribe(sub.filter)

    def _publish_retained_to(self, client: Client, sub: Subscription,
                             existing: bool) -> None:
        """Retained delivery per v5 retain-handling. Shared subscriptions get
        none [MQTT-3.3.1-13]."""
        if sub.filter.startswith("$share/"):
            return
        csub = (self.content.get(client.id, sub.filter)
                if self.content is not None else None)
        if csub is not None and csub.window is not None:
            return  # ADR 023: aggregate subs receive synthesized
            #         window publishes, never the raw retained state
        if sub.retain_handling == 2:
            return
        if sub.retain_handling == 1 and existing:
            return
        if self.overload.shedding:
            # above the high-water mark retained bursts are deferred,
            # not dropped: housekeeping re-runs this delivery once the
            # broker recovers below the low-water mark (ADR 012)
            if (client.id, sub.filter) not in self._deferred_retained:
                self.overload.deferred_retained += 1
            self._deferred_retained[(client.id, sub.filter)] = \
                (sub, existing)
            return
        # delivering now satisfies any parked deferral for this pair —
        # a stale entry would double-deliver at the next drain tick
        self._deferred_retained.pop((client.id, sub.filter), None)
        now = time.time()
        maxexp = self.capabilities.maximum_message_expiry_interval
        for msg in self.topics.retained_for(sub.filter):
            if (csub is not None and csub.pred is not None
                    and not csub.pred.eval_reference(
                        decode_payload(msg.payload))):
                continue    # ADR 023: retained state is predicate-
                #             gated via the scalar reference evaluator
                #             (a cold path; no batch to vectorize)
            if not self._message_expired(msg, now, maxexp):
                self._send_retained(client, sub, msg, now)

    def _send_retained(self, client: Client, sub: Subscription,
                       msg: Packet, now: float) -> None:
        out = msg.copy()
        out.protocol_version = client.properties.protocol_version
        out.fixed.retain = True
        out.fixed.qos = min(out.fixed.qos, sub.qos)
        out.fixed.dup = False
        if out.protocol_version < 5:
            out.properties = type(out.properties)()
        else:
            # retained deliveries carry the establishing subscription's
            # identifier like any forwarded publish [MQTT-3.3.4-3]
            out.properties.subscription_ids = \
                [sub.identifier] if sub.identifier else []
        if out.fixed.qos > 0:
            if len(client.inflight) >= self.capabilities.maximum_inflight:
                self.info.inflight_dropped += 1
                return
            try:
                out.packet_id = client.next_packet_id()
            except PacketIDExhausted:
                return
            out.created = now
            client.inflight.set(out.copy())
            self._note_inflight(out)
            self.info.inflight += 1
            if not client.inflight.take_send_quota():
                # respect the client's receive maximum [MQTT-3.3.4-9];
                # parked retained deliveries persist+replicate like any
                # held message (ADR 018)
                client.held_pids.append(out.packet_id)
                self.hooks.notify("on_qos_publish", client, out, now, 0)
                return
        if client.send(out):
            self.hooks.notify("on_retain_published", client, out)
        elif out.fixed.qos > 0:
            # refused retained delivery: same no-leak rollback as
            # _count_refused_send (ADR 012)
            self._rollback_refused_qos(client, out)

    def _process_unsubscribe(self, client: Client, packet: Packet) -> None:
        packet = self.hooks.modify("on_unsubscribe", packet, client)
        reason_codes = []
        for sub in packet.filters:
            filt = sub.filter
            if self.content is not None:
                if "?" in filt:     # ADR 023: clients unsubscribe with
                    filt = filt.partition("?")[0]  # the suffixed form;
                    #                 the index holds the base filter
                self.content.unregister(client.id, filt)
            existed = self.topics.unsubscribe(client.id, filt)
            if existed:
                self.info.subscriptions -= 1
                if self.cluster is not None:
                    self.cluster.note_unsubscribe(filt)
            client.subscriptions.pop(filt, None)
            reason_codes.append(codes.Success.value if existed
                                else codes.NoSubscriptionExisted.value)
        client.send(Packet(fixed=FixedHeader(type=PT.UNSUBACK),
                           protocol_version=client.properties.protocol_version,
                           packet_id=packet.packet_id,
                           reason_codes=reason_codes))
        self.hooks.notify("on_unsubscribed", client, packet)

    # ------------------------------------------------------------------
    # Wills
    # ------------------------------------------------------------------

    def _queue_will(self, client: Client) -> None:
        will = client.properties.will
        if will is None:
            return
        packet = Packet(fixed=FixedHeader(type=PT.PUBLISH, qos=will.qos,
                                          retain=will.retain),
                        topic=will.topic, payload=will.payload,
                        origin=client.id, created=time.time(),
                        properties=will.properties.copy())
        packet.properties.will_delay = None
        delay = client.properties.will_delay
        if delay > 0:
            self._will_delays[client.id] = (time.time() + delay, packet)
        else:
            self._fire_will(client, packet)
        client.properties.will = None

    def _fire_will(self, client: Client | None, packet: Packet) -> None:
        if packet.fixed.retain:
            self.topics.retain(packet.copy())
            self._note_retained_expiry(packet)
        self._spawn(self.publish_to_subscribers(packet), "will-fanout")
        self.hooks.notify("on_will_sent", client, packet)

    # ------------------------------------------------------------------
    # Inline publish / packet injection
    # ------------------------------------------------------------------

    async def publish(self, topic: str, payload: bytes, qos: int = 0,
                      retain: bool = False, **props) -> None:
        """Server-side publish without a network client (InjectPacket
        equivalent, v2/server.go:637-671)."""
        if not valid_topic_name(topic) and not topic.startswith("$"):
            raise ProtocolError(codes.ErrTopicNameInvalid)
        packet = Packet(fixed=FixedHeader(type=PT.PUBLISH, qos=qos,
                                          retain=retain),
                        topic=topic, payload=payload, origin="inline",
                        created=time.time())
        for k, v in props.items():
            setattr(packet.properties, k, v)
        if retain:
            self.topics.retain(packet.copy())
            self._note_retained_expiry(packet)
        await self.publish_to_subscribers(packet)

    async def inject(self, client: Client, packet: Packet) -> None:
        """Process a packet as if ``client`` had sent it over the network."""
        await self._receive_packet(client, packet)

    def new_inline_client(self, client_id: str = "inline") -> Client:
        client = Client(self, None, None, "inline", inline=True)
        client.id = client_id
        return client

    # ------------------------------------------------------------------
    # Housekeeping + $SYS (v2/server.go:284-305, 1185-1237, 1436-1493)
    # ------------------------------------------------------------------

    def disconnect_client(self, client: Client, code: codes.Code) -> None:
        """Send DISCONNECT (v5) before dropping the connection."""
        if client.properties.protocol_version >= 5 and not client.closed:
            client.send_now(Packet(fixed=FixedHeader(type=PT.DISCONNECT),
                                   protocol_version=5,
                                   reason_code=code.value))

    @staticmethod
    def _message_expired(packet: Packet, now: float, maximum: int) -> bool:
        expiry = packet.properties.message_expiry
        if expiry is None:
            expiry = maximum if maximum else 0
        if expiry <= 0:
            return False
        return now > packet.created + expiry

    # the housekeeping sweeps visit at most this many sessions between two
    # yields to the loop: a broker holding 100,000 restored sessions would
    # otherwise hold its loop ~0.4 s every second (the keepalive, expiry,
    # inflight and stall sweeps), past the matcher's 250 ms deadline
    SWEEP_CHUNK = 5_000

    async def _housekeeping_loop(self) -> None:
        try:
            while True:
                await asyncio.sleep(1.0)
                await self._housekeeping_tick(time.time(), time.monotonic())
        except asyncio.CancelledError:
            pass

    async def _housekeeping_tick(self, now: float, mono: float) -> None:
        """One housekeeping pass, the reference's checks in its order; the
        expiry and inflight sweeps run only when a session or a message
        may be due (``_expiry_due``, ``_inflight_oldest``)."""
        await self._sweep(self._check_keepalives, mono, True)
        if now > self._expiry_due:
            self._expiry_due = math.inf
            await self._sweep(self._check_client_expiry, now, False)
        self._check_will_delays(now)
        self._check_expired_retained(now)
        maximum = self.capabilities.maximum_message_expiry_interval
        if maximum and now > self._inflight_oldest + maximum:
            self._inflight_oldest = math.inf
            await self._sweep(self._check_expired_inflight, now, False)
        await self._sweep(self._check_stalled_writers, mono, True)
        self._check_overload_recovery()
        if self.content is not None:
            self.content.tick(now)

    async def _sweep(self, check, clock: float, connected: bool) -> None:
        """Run one per-session housekeeping check over every session (the
        connected ones where ``connected``), in registry order, as one
        call while the registry holds at most ``SWEEP_CHUNK`` sessions,
        else in slices of that many with a yield to the loop between two.
        A session that left the registry, or (``connected``) closed,
        during a yield is skipped."""
        everyone = self.clients.all()
        if len(everyone) <= self.SWEEP_CHUNK:
            check(clock)
            return
        registry = self.clients
        for i in range(0, len(everyone), self.SWEEP_CHUNK):
            if i:
                await asyncio.sleep(0)
            check(clock, [c for c in everyone[i:i + self.SWEEP_CHUNK]
                          if registry.get(c.id) is c
                          and not (connected and c.closed)])

    def _check_stalled_writers(self, mono: float,
                               clients: list | None = None) -> None:
        """Slow-consumer policy (ADR 012): a connected client whose
        writer made no progress past the stall deadline while work is
        queued — or whose writer died outright — is disconnected with
        v5 QuotaExceeded/ServerBusy instead of eating drops forever.
        The whole rung is off at stall_deadline_ms = 0, dead-writer
        reaping included (the 'disabled by a zero' contract)."""
        deadline = self.capabilities.stall_deadline_ms / 1000.0
        if deadline <= 0:
            return
        for client in (self.clients.connected() if clients is None
                       else clients):
            dead = client.write_error is not None
            # no progress since the later of the writer's last flush and
            # the wake-up for its queued work: a writer idle past the
            # deadline whose first item arrives while the loop is held
            # (a fan-out) is waiting for the loop, not stalled
            stalled = (client.outbound.bytes > 0
                       and mono - max(client.write_progress,
                                      client.outbound.woken) > deadline)
            if not (dead or stalled):
                continue
            self.overload.stalled_disconnects += 1
            client.note_drop("stall")
            code = (codes.ErrServerBusy if dead
                    else codes.ErrQuotaExceeded)
            self.disconnect_client(client, code)
            self._spawn(client.stop(ProtocolError(code)), "stall-stop")

    def _check_overload_recovery(self) -> None:
        """Watermark hysteresis backstop + deferred-retained drain: the
        inline note_get path flips shedding off as queues drain, but a
        broker whose queues were released wholesale (client teardown)
        or idled must still recover and deliver parked retained."""
        over = self.overload
        if over.shedding and over.below_low_water():
            over.shedding = False
            over.recoveries += 1
        if over.shedding or not self._deferred_retained:
            return
        for key in list(self._deferred_retained):
            if over.shedding:
                return  # a drained delivery re-entered shedding: stop
            entry = self._deferred_retained.pop(key, None)
            if entry is None:
                continue
            sub, existing = entry
            cid, filt = key
            client = self.clients.get(cid)
            if client is None or filt not in client.subscriptions:
                continue    # session purged or unsubscribed: drop it
            if client.closed:
                # persistent session offline at drain time: keep the
                # delivery parked (no recount) — a resumed session
                # never re-sends SUBSCRIBE, so discarding here would
                # lose the retained message permanently; the entry
                # dies with the session
                self._deferred_retained[key] = entry
                continue
            self._publish_retained_to(client, sub, existing)

    def _check_keepalives(self, mono: float,
                          clients: list | None = None) -> None:
        grace = self.capabilities.keepalive_grace
        for client in (self.clients.connected() if clients is None
                       else clients):
            if client.keepalive <= 0:
                continue
            if mono - client.last_received > client.keepalive * grace:
                self.disconnect_client(client, codes.ErrKeepAliveTimeout)
                self._spawn(
                    client.stop(ProtocolError(codes.ErrKeepAliveTimeout)),
                    "keepalive-stop")

    def _check_client_expiry(self, now: float,
                             clients: list | None = None) -> None:
        maximum = self.capabilities.maximum_session_expiry_interval
        for client in (self.clients.all() if clients is None else clients):
            if not client.closed:
                continue
            due = client.expires_at(maximum)
            if now > due:
                self.hooks.notify("on_client_expired", client)
                self._purge_session(client)
            elif due < self._expiry_due:
                self._expiry_due = due

    def note_session_closed(self, client: Client) -> None:
        """A session's connection ended (``Client.stop``): the expiry
        sweep's bound moves to its expiry time if that comes sooner."""
        due = client.expires_at(
            self.capabilities.maximum_session_expiry_interval)
        if due < self._expiry_due:
            self._expiry_due = due

    def _note_inflight(self, packet: Packet) -> None:
        """A message entered a session's inflight window: the inflight
        sweep's bound moves to its receipt time if that is older."""
        if 0 < packet.created < self._inflight_oldest:
            self._inflight_oldest = packet.created

    def _check_will_delays(self, now: float) -> None:
        for cid in list(self._will_delays):
            due, packet = self._will_delays[cid]
            if now >= due:
                del self._will_delays[cid]
                self._fire_will(self.clients.get(cid), packet)

    def _note_retained_expiry(self, packet: Packet) -> None:
        """Index a stored retained message for the expiry sweep: min-heap
        of (due, topic) with lazy revalidation on pop, so each tick costs
        O(due entries) instead of rescanning every retained message (the
        reference sweeps its whole retained map each tick,
        v2/server.go:1436-1476 — a per-second host stall at IoT scale).
        $-topics are broker-owned and never expire (the old '#'-scan
        skipped them the same way)."""
        maximum = self.capabilities.maximum_message_expiry_interval
        if not maximum or packet.topic.startswith("$"):
            return
        if not packet.payload:          # retained CLEAR, from any path
            self._retained_due.pop(packet.topic, None)
            return
        expiry = packet.properties.message_expiry
        if expiry is None:
            expiry = maximum
        if expiry <= 0:
            return
        due = packet.created + expiry
        self._retained_due[packet.topic] = due
        heap = self._retained_expiry
        heapq.heappush(heap, (due, packet.topic))
        if len(heap) > 64 and len(heap) > 4 * len(self._retained_due):
            # compact the lazy-deleted majority: rebuild from the live
            # per-topic dues (bounded by the retained-message count)
            self._retained_expiry = [
                (d, t) for t, d in self._retained_due.items()]
            heapq.heapify(self._retained_expiry)

    def _check_expired_retained(self, now: float) -> None:
        maximum = self.capabilities.maximum_message_expiry_interval
        if not maximum:
            return
        heap = self._retained_expiry
        while heap and heap[0][0] <= now:
            due, topic = heapq.heappop(heap)
            if self._retained_due.get(topic) != due:
                continue        # superseded by a later republish
            self._retained_due.pop(topic, None)   # entry consumed
            p = self.topics.retained_get(topic)
            if p is None or not self._message_expired(p, now, maximum):
                continue        # cleared or replaced since: stale entry
            clear = Packet(fixed=FixedHeader(type=PT.PUBLISH, retain=True),
                           topic=topic, payload=b"")
            self.topics.retain(clear)
            self.info.retained -= 1
            self.hooks.notify("on_retained_expired", topic)

    def _check_expired_inflight(self, now: float,
                                clients: list | None = None) -> None:
        maximum = self.capabilities.maximum_message_expiry_interval
        if not maximum:
            return
        for client in (self.clients.all() if clients is None else clients):
            expired = 0
            for packet in client.inflight.all():
                if packet.created > 0 and now > packet.created + maximum:
                    if client.inflight.delete(packet.packet_id):
                        self.info.inflight -= 1
                        self.info.inflight_dropped += 1
                        client.inflight.return_send_quota()
                        expired += 1
                        self.hooks.notify("on_qos_dropped", client, packet)
                else:
                    self._note_inflight(packet)
            if expired and not client.closed:
                # the returned quota must reach parked messages: with
                # nothing left inflight no ack will ever drain held_pids
                self._release_held(client)

    async def _sys_topic_loop(self) -> None:
        try:
            while True:
                await asyncio.sleep(self.capabilities.sys_topic_interval)
                self.publish_sys_topics()
        except asyncio.CancelledError:
            pass

    def publish_sys_topics(self) -> None:
        """Refresh + retain the $SYS/broker tree. Parity: server.go:1185-1237."""
        info = self.info
        info.time = int(time.time())
        info.uptime = info.time - info.started
        info.retained = self.topics.retained_count
        info.subscriptions = self.topics.subscription_count
        info.memory_alloc = _current_rss_bytes()
        info.threads = threading.active_count()
        self.hooks.notify("on_sys_info_tick", info)
        entries = {
            "$SYS/broker/version": info.version,
            "$SYS/broker/uptime": info.uptime,
            "$SYS/broker/time": info.time,
            "$SYS/broker/started": info.started,
            "$SYS/broker/load/bytes/received": info.bytes_received,
            "$SYS/broker/load/bytes/sent": info.bytes_sent,
            "$SYS/broker/clients/connected": info.clients_connected,
            "$SYS/broker/clients/disconnected": info.clients_disconnected,
            "$SYS/broker/clients/maximum": info.clients_maximum,
            "$SYS/broker/clients/total": info.clients_total,
            "$SYS/broker/messages/received": info.messages_received,
            "$SYS/broker/messages/sent": info.messages_sent,
            "$SYS/broker/messages/dropped": info.messages_dropped,
            "$SYS/broker/messages/inflight": info.inflight,
            # reference spellings (server.go:1214-1216) + our older
            # /count aliases, kept for consumers already scraping them
            "$SYS/broker/retained": info.retained,
            "$SYS/broker/subscriptions": info.subscriptions,
            "$SYS/broker/messages/retained/count": info.retained,
            "$SYS/broker/subscriptions/count": info.subscriptions,
            "$SYS/broker/packets/received": info.packets_received,
            "$SYS/broker/packets/sent": info.packets_sent,
            "$SYS/broker/system/memory": info.memory_alloc,
            "$SYS/broker/system/threads": info.threads,
        }
        entries.update(self._sys_overload_entries())
        if self.cluster is not None:
            entries.update(self._sys_cluster_entries())
        if self._storage_hook is not None:
            entries.update(self._sys_storage_entries())
        if self.tracer.sample_n:
            # ADR 015: the trace subtree appears only while sampling is
            # on — an untraced broker's $SYS surface is unchanged
            trace_entries = self.tracer.sys_entries()
            entries.update(trace_entries)
            self._sys_trace_topics = set(trace_entries)
        elif self._sys_trace_topics:
            # sampling just turned off: clear the subtree's retained
            # entries (empty payload = retained clear) so stale values
            # can't masquerade as live ones
            entries.update((t, "") for t in self._sys_trace_topics)
            self._sys_trace_topics = set()
        for topic, value in entries.items():
            packet = Packet(fixed=FixedHeader(type=PT.PUBLISH, retain=True),
                            topic=topic, payload=str(value).encode(),
                            origin="$SYS", created=time.time())
            self.topics.retain(packet.copy())
            if self.loop is not None:
                self._spawn(self.publish_to_subscribers(packet),
                            "sys-fanout")

    def _sys_overload_entries(self) -> dict:
        """The ADR-012 overload ladder's $SYS subtree, incl. the bounded
        top-offender report under $SYS/broker/clients/."""
        import json
        over = self.overload
        return {
            "$SYS/broker/overload/queued_bytes": over.queued_bytes,
            "$SYS/broker/overload/shedding": int(over.shedding),
            "$SYS/broker/overload/sheds": over.sheds,
            "$SYS/broker/overload/recoveries": over.recoveries,
            "$SYS/broker/overload/shed_messages": over.shed_messages,
            "$SYS/broker/overload/budget_drops": over.budget_drops,
            "$SYS/broker/overload/deferred_retained":
                over.deferred_retained,
            "$SYS/broker/overload/connects_refused":
                over.connects_refused + over.half_open_refused,
            "$SYS/broker/overload/stalled_disconnects":
                over.stalled_disconnects,
            "$SYS/broker/messages/qos_dropped": over.qos_drops,
            "$SYS/broker/clients/top_dropped":
                json.dumps(top_offenders(self.clients.all())),
        }

    def _sys_storage_entries(self) -> dict:
        """The ADR-014 storage-pipeline subtree: journal pressure,
        commit health, breaker state, and what restore had to set
        aside — readable from any MQTT client subscribed to $SYS."""
        hook = self._storage_hook
        entries = {
            "$SYS/broker/storage/boot_epoch": self.boot_epoch,
            "$SYS/broker/storage/quarantined": hook.quarantined,
            "$SYS/broker/storage/journal_sheds": hook.journal_sheds,
            "$SYS/broker/storage/barrier_waits": self.storage_barrier_waits,
        }
        jr = self._journal
        if jr is not None:
            entries.update({
                "$SYS/broker/storage/policy": jr.policy,
                "$SYS/broker/storage/queue_depth": jr.queue_depth,
                "$SYS/broker/storage/queued_bytes": jr.queued_bytes_now,
                "$SYS/broker/storage/commits": jr.commits,
                "$SYS/broker/storage/commit_failures": jr.commit_failures,
                "$SYS/broker/storage/breaker_state": jr.breaker_state,
                "$SYS/broker/storage/degraded_seconds":
                    round(jr.degraded_seconds, 3),
                "$SYS/broker/storage/dirty": int(jr.dirty),
            })
        backing = jr.inner if jr is not None else hook.store
        corruptions = getattr(backing, "corruptions", None)
        if corruptions is not None:
            entries["$SYS/broker/storage/corruptions"] = corruptions
        return entries

    def _sys_cluster_entries(self) -> dict:
        """The ADR-013 federation subtree: link/route health at a
        glance from any MQTT client subscribed to $SYS."""
        mgr = self.cluster
        entries = {
            "$SYS/broker/cluster/node_id": mgr.node_id,
            "$SYS/broker/cluster/links_up": mgr.links_up,
            "$SYS/broker/cluster/link_flaps": mgr.link_flaps,
            "$SYS/broker/cluster/routes_held":
                mgr.routes.remote_route_count,
            "$SYS/broker/cluster/forwards_sent": mgr.forwards_sent,
            "$SYS/broker/cluster/forwards_delivered":
                mgr.forwards_delivered,
            "$SYS/broker/cluster/loops_dropped": mgr.loops_dropped,
            # ADR 018: cross-node publish durability + partition health
            "$SYS/broker/cluster/fwd_parked":
                getattr(mgr, "fwd_parked_now", 0),
            "$SYS/broker/cluster/fwd_parked_resent":
                getattr(mgr, "fwd_parked_resent", 0),
            "$SYS/broker/cluster/fwd_barrier_degraded":
                getattr(mgr, "fwd_barrier_degraded", 0),
            "$SYS/broker/cluster/partition_drops":
                (getattr(mgr, "partition_drops_in", 0)
                 + getattr(mgr, "partition_drops_out", 0)),
            # ADR 020: hop-chained relay durability + blip audit
            "$SYS/broker/cluster/relay_chain_waits":
                getattr(mgr, "relay_chain_waits", 0),
            "$SYS/broker/cluster/relay_chain_timeouts":
                getattr(mgr, "relay_chain_timeouts", 0),
            "$SYS/broker/cluster/blips_detected":
                getattr(mgr, "blips_detected", 0),
            "$SYS/broker/cluster/blip_resyncs":
                getattr(mgr, "blip_resyncs", 0),
            "$SYS/broker/cluster/route_sync_waits":
                getattr(mgr, "route_sync_waits", 0),
            "$SYS/broker/cluster/route_sync_timeouts":
                getattr(mgr, "route_sync_timeouts", 0),
        }
        # ADR 017: per-peer health — link state, staleness, queue
        # pressure, replication lag and the clock-skew estimate, the
        # operator view failover/sharding work is judged against.
        # Bounded to the metrics layer's per-peer series cap.
        entries.update(self._sys_cluster_health_entries(mgr))
        sess = getattr(mgr, "sessions", None)
        if sess is not None:
            # ADR 016: the session-federation subtree — takeover and
            # replication health readable from any MQTT client
            entries.update({
                "$SYS/broker/cluster/sessions/ledger": sess.ledger_size,
                "$SYS/broker/cluster/sessions/local":
                    sess.local_sessions,
                "$SYS/broker/cluster/sessions/takeovers":
                    sess.takeovers,
                "$SYS/broker/cluster/sessions/takeovers_degraded":
                    sess.takeovers_degraded,
                "$SYS/broker/cluster/sessions/lost":
                    sess.sessions_lost,
                "$SYS/broker/cluster/sessions/sync_degraded":
                    sess.sync_degraded,
                "$SYS/broker/cluster/sessions/sync_faults":
                    sess.sync_faults,
                "$SYS/broker/cluster/sessions/share_groups":
                    sess.share_groups,
                # ADR 018: dead-owner lifecycle
                "$SYS/broker/cluster/sessions/replica_expiries":
                    sess.replica_expiries,
                "$SYS/broker/cluster/sessions/wills_fired":
                    sess.wills_fired,
            })
        return entries

    def _sys_cluster_health_entries(self, mgr) -> dict:
        """``$SYS/broker/cluster/health/<peer>/*`` (ADR 017)."""
        from ..metrics import CLUSTER_PEER_SERIES
        entries: dict = {}
        sess = getattr(mgr, "sessions", None)
        now = time.monotonic()
        peers = sorted(mgr.membership.peers.items())[:CLUSTER_PEER_SERIES]
        for peer, st in peers:
            base = f"$SYS/broker/cluster/health/{peer}"
            entries[f"{base}/state"] = int(st.connected)
            entries[f"{base}/last_seen_s"] = (
                round(max(now - st.last_seen, 0.0), 1)
                if st.last_seen else -1)
            entries[f"{base}/flaps"] = st.flaps
            entries[f"{base}/skew_ms"] = round(st.skew_ns / 1e6, 3)
            entries[f"{base}/rtt_ms"] = round(st.rtt_ns / 1e6, 3)
            link = mgr.links.get(peer)
            if link is not None:
                entries[f"{base}/queue_bytes"] = link.outbound.bytes
                # route replication lag: filters the peer should hold
                # but our link has not (successfully) advertised yet
                desired = mgr.routes.advertisement_for(peer)
                entries[f"{base}/route_lag"] = (
                    len(desired) if link.needs_snapshot
                    else len(desired ^ link.advertised))
            if sess is not None:
                entries[f"{base}/sess_lag"] = max(
                    sess._peer_ack_target.get(peer, 0)
                    - sess._peer_acked.get(peer, 0), 0)
        return entries

    # ------------------------------------------------------------------
    # Persistence restore (v2/server.go:1297-1434)
    # ------------------------------------------------------------------

    async def _restore_from_storage(self) -> None:
        self._restore_sessions()
        for rec in self.hooks.first_non_empty("stored_retained_messages"):
            packet = rec.to_packet()
            self.topics.retain(packet)
            self._note_retained_expiry(packet)
            self.info.retained += 1
        for rec in self.hooks.first_non_empty("stored_inflight_messages"):
            client = self.clients.get(rec.client_id)
            if client is not None:
                packet = rec.to_packet()
                client.inflight.set(packet)
                # restored FROM the store: resend-on-resume must not
                # rewrite a byte-identical record (ADR 014)
                client.inflight.note_stored(packet.packet_id)
                self.info.inflight += 1
                if getattr(rec, "held", False):
                    # ADR 018: quota-parked at crash time — re-park, so
                    # the resumed session's _release_held (not resend)
                    # sends it within the client's receive maximum
                    client.held_pids.append(packet.packet_id)
        stored_info = self.hooks.first_non_empty("stored_sys_info")
        if stored_info is not None:
            for k in ("bytes_received", "bytes_sent", "messages_received",
                      "messages_sent", "messages_dropped", "packets_received",
                      "packets_sent", "clients_maximum", "clients_total"):
                setattr(self.info, k, getattr(stored_info, k, 0))
        self._bump_boot_epoch()

    def _restore_sessions(self) -> None:
        for rec in self.hooks.first_non_empty("stored_clients"):
            client = Client(self, None, None, rec.listener)
            client.id = rec.client_id
            client.properties.protocol_version = rec.protocol_version
            client.properties.username = rec.username
            client.properties.clean_start = rec.clean
            client.properties.session_expiry = rec.session_expiry
            client.properties.session_expiry_set = rec.session_expiry_set
            client.disconnected_at = rec.disconnected_at or time.time()
            # a restored session is a DISCONNECTED session: without
            # this, `closed` stays False (stop() never ran on the fresh
            # object), deliveries take the live-send path and are
            # refused+rolled back as slow-consumer drops instead of
            # queueing in inflight for the resume — every message
            # published to the session between restart and reconnect
            # was silently lost (found by the ADR-018 kill-restart
            # verify drive) — and the expiry sweep never purged it
            client._stopped.set()
            self.clients.add(client)
        for rec in self.hooks.first_non_empty("stored_subscriptions"):
            sub = Subscription(filter=rec.filter, qos=rec.qos,
                               no_local=rec.no_local,
                               retain_as_published=rec.retain_as_published,
                               retain_handling=rec.retain_handling,
                               identifier=rec.identifier)
            if self.topics.subscribe(rec.client_id, sub):
                self.info.subscriptions += 1
            client = self.clients.get(rec.client_id)
            if client is not None:
                client.subscriptions[rec.filter] = sub
            options = getattr(rec, "options", "")
            if options and self.content is not None:
                # ADR 023/024: re-register the persisted content spec;
                # a spec this build can't parse (downgrade, tightened
                # caps) degrades THIS subscription to unfiltered,
                # loudly, instead of failing the restore
                try:
                    self.content.register(rec.client_id, rec.filter,
                                          self.content.parse_spec(options))
                except Exception as exc:
                    self.content.rejected_subscribes += 1
                    if self.log is not None:
                        self.log.with_prefix("broker").error(
                            "restored subscription content spec "
                            "rejected; subscription is unfiltered",
                            client=rec.client_id, filter=rec.filter,
                            error=repr(exc)[:200])

    def _bump_boot_epoch(self) -> None:
        """Persisted monotonic boot epoch (ADR 014): strictly increases
        across restarts/kills; the cluster layer (ADR 013) adopts it in
        place of wall-clock epochs. No storage hook (or a failed bump):
        wall-clock ms keeps the pre-ADR-014 behavior."""
        bump = getattr(self._storage_hook, "bump_boot_epoch", None)
        if bump is not None:
            try:
                self.boot_epoch = bump()
            except Exception as exc:
                if self.log is not None:
                    self.log.with_prefix("broker").error(
                        "boot-epoch bump failed", error=repr(exc)[:200])
        if not self.boot_epoch:
            self.boot_epoch = int(time.time() * 1000)

    # non-PUBLISH packet dispatch (PUBLISH stays inline in
    # _process_packet: it is the only async handler and the hot path)
    _DISPATCH = {
        PT.PUBACK: _process_puback,
        PT.PUBREC: _process_pubrec,
        PT.PUBREL: _process_pubrel,
        PT.PUBCOMP: _process_pubcomp,
        PT.SUBSCRIBE: _process_subscribe,
        PT.UNSUBSCRIBE: _process_unsubscribe,
        PT.PINGREQ: _process_pingreq,
        PT.DISCONNECT: _process_disconnect,
        PT.AUTH: _process_auth,
        PT.CONNECT: _process_second_connect,
    }
