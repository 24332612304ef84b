"""Per-connection client session state and transport loops.

Parity surface: vendor/github.com/mochi-co/mqtt/v2/clients.go (Client,
ClientState, read/write loops, packet-id allocation, inflight resend).
Re-designed around asyncio: one reader task + one writer task per client,
outbound delivery through a bounded asyncio queue.

Copy of the JAX package's ``broker/client.py``.
"""

from __future__ import annotations

import asyncio
import math
import time
from collections import deque
from dataclasses import dataclass

from .. import faults
from ..matching.trie import TopicAliases
from ..protocol.codec import PacketType as PT
from ..protocol.packets import Packet, ProtocolError, Subscription, Will, parse_stream
from .inflight import Inflight


@dataclass
class ClientProperties:
    protocol_version: int = 4
    username: bytes = b""
    clean_start: bool = False
    will: Will | None = None
    will_delay: int = 0
    session_expiry: int = 0
    session_expiry_set: bool = False
    receive_maximum: int = 0        # client's stated receive maximum
    topic_alias_maximum: int = 0    # client's stated inbound alias maximum
    maximum_packet_size: int = 0
    request_problem_info: int = 1


class PacketIDExhausted(Exception):
    pass


def _estimate_wire(packet: Packet) -> int:
    """Cheap wire-size estimate for byte accounting: exact encoding is
    deferred to the writer task, so the budget ledger uses topic+payload
    plus a flat header/property allowance. The estimate is stored with
    the queued item, so enqueue/dequeue accounting is always symmetric.
    Since ADR 019 converted fan-out to exact-sized wire entries this
    covers only the residual Packet paths (hook-override deliveries,
    resends, retained sends, acks) — the variable-length v5 properties
    are summed in so the watermarks fire on real bytes, not a flat
    allowance an adversarial publisher can hide a kilobyte of user
    properties under."""
    if packet.type == PT.PUBLISH:
        est = 32 + len(packet.topic) + len(packet.payload or b"")
        if packet.protocol_version >= 5:
            pr = packet.properties
            if pr.content_type:
                est += 3 + len(pr.content_type)
            if pr.response_topic:
                est += 3 + len(pr.response_topic)
            if pr.correlation_data:
                est += 3 + len(pr.correlation_data)
            for k, v in pr.user_properties:
                est += 5 + len(k) + len(v)
        return est
    return 32


def _droppable_qos0(item) -> bool:
    """True for queued items the slow-consumer policy may shed: QoS0
    PUBLISH deliveries only — never acks, control packets, QoS>0
    publishes (those park on session rules), or the shutdown sentinel.
    Items are ``bytes`` (pre-encoded wire), ``tuple`` (ADR 019 shared-
    template buffer sequences, first buffer = frame head), a Packet,
    or None."""
    t = type(item)
    if t is bytes:
        return (item[0] >> 4) == PT.PUBLISH and (item[0] & 0x06) == 0
    if t is tuple:
        head = item[0]
        return (head[0] >> 4) == PT.PUBLISH and (head[0] & 0x06) == 0
    return (item is not None and item.type == PT.PUBLISH
            and item.fixed.qos == 0)


class FlushScheduler:
    """Per-loop-iteration getter-wake coalescing (ADR 019). A 1→N
    fan-out enqueues its N deliveries synchronously; completing each
    parked getter future inline schedules N task wake-ups before the
    fan-out loop finishes, and a client hit K times in one iteration
    is scheduled K times. Deferring the completions to one
    ``loop.call_soon`` callback wakes each writer exactly once per
    iteration — after its FULL backlog is queued, so the greedy burst
    sees everything on its first dequeue."""

    __slots__ = ("_pending", "_scheduled", "flushes", "deferred",
                 "coalesced")

    def __init__(self) -> None:
        self._pending: list = []
        self._scheduled = False
        self.flushes = 0        # call_soon flush passes run
        self.deferred = 0       # wakes parked for a flush pass
        self.coalesced = 0      # duplicate wakes absorbed by one park

    def defer(self, q: "OutboundQueue") -> bool:
        """Park one queue's getter wake; False when no loop is running
        (inline/test contexts), letting the caller wake directly."""
        if q._wake_deferred:
            self.coalesced += 1
            return True
        if not self._scheduled:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return False
            loop.call_soon(self._flush)
            self._scheduled = True
        q._wake_deferred = True
        self._pending.append(q)
        self.deferred += 1
        return True

    def _flush(self) -> None:
        self._scheduled = False
        pending, self._pending = self._pending, []
        self.flushes += 1
        for q in pending:
            q._wake_deferred = False
            g = q._getter
            if g is not None and not g.done():
                g.set_result(None)


class OutboundQueue:
    """Bounded single-consumer outbound queue with wire-byte accounting
    (ADR 012). Each entry carries the byte size charged at enqueue, so
    the per-client ledger (``self.bytes``) and the broker-global ledger
    (``overload.queued_bytes``) stay exact without re-deriving sizes at
    dequeue. The sole consumer is the client's writer task."""

    def __init__(self, maxsize: int, overload=None,
                 scheduler: FlushScheduler | None = None) -> None:
        self._q: deque = deque()
        self._maxsize = maxsize
        self._getter: asyncio.Future | None = None
        self._overload = overload
        # ADR 019: getter wakes route through the broker's per-loop-
        # iteration flush scheduler when one is attached; direct wake
        # otherwise (inline clients, queues built outside a broker)
        self._scheduler = scheduler
        self._wake_deferred = False
        self.bytes = 0
        # cumulative entry counters (ADR 015): a drain-span watcher
        # registered at enqueue seq S is settled by the first flush
        # whose removal count reaches S — not by whatever flush happens
        # to complete next (which may predate S's delivery entirely)
        self.enqueued = 0
        self.removed = 0
        # monotonic time of the last put that found the writer parked
        # idle: the stall detector's clock starts no earlier (a writer
        # that has not yet been woken for its work is not stalled)
        self.woken = 0.0

    def qsize(self) -> int:
        return len(self._q)

    def put_nowait(self, item, size: int = 0) -> None:
        if self._maxsize and len(self._q) >= self._maxsize:
            raise asyncio.QueueFull
        self._q.append((item, size))
        self.bytes += size
        self.enqueued += 1
        if self._overload is not None:
            self._overload.note_put(size)
        g = self._getter
        if g is not None and not g.done():
            if not self._wake_deferred:
                self.woken = time.monotonic()
            s = self._scheduler
            if s is None or not s.defer(self):
                g.set_result(None)

    def get_nowait(self):
        if not self._q:
            raise asyncio.QueueEmpty
        item, size = self._q.popleft()
        self._account_out(size)
        self.removed += 1
        return item

    async def get(self):
        while not self._q:
            self._getter = asyncio.get_running_loop().create_future()
            try:
                await self._getter
            finally:
                self._getter = None
        return self.get_nowait()

    def _account_out(self, size: int) -> None:
        self.bytes -= size
        if self._overload is not None:
            self._overload.note_get(size)

    def drop_oldest_qos0(self, need: int) -> tuple[list, int]:
        """Shed the oldest droppable (QoS0 PUBLISH) entries until at
        least ``need`` bytes are freed or none remain; other entries
        keep their order. Returns (dropped items, bytes freed) — the
        items so the caller can fire drop hooks for Packet entries."""
        freed = 0
        dropped: list = []
        kept: deque = deque()
        while self._q and freed < need:
            item, size = self._q.popleft()
            if _droppable_qos0(item):
                freed += size
                dropped.append(item)
                self._account_out(size)
                self.removed += 1
            else:
                kept.append((item, size))
        while kept:
            self._q.appendleft(kept.pop())
        return dropped, freed

    def release_all(self) -> None:
        """Drop everything still queued and settle both byte ledgers
        (client teardown: abandoned bytes must not pin the global
        watermark above the recovery threshold forever)."""
        while self._q:
            _item, size = self._q.popleft()
            self._account_out(size)


class Client:
    """One MQTT session (possibly outliving several network connections)."""

    def __init__(self, server, reader: asyncio.StreamReader | None,
                 writer: asyncio.StreamWriter | None, listener_id: str = "",
                 inline: bool = False) -> None:
        self.server = server
        self.reader = reader
        self.writer = writer
        self.listener = listener_id
        self.inline = inline
        self.id = ""
        self.remote = ""
        if writer is not None:
            peer = writer.get_extra_info("peername")
            if peer:
                self.remote = f"{peer[0]}:{peer[1]}" if len(peer) >= 2 else str(peer)

        self.properties = ClientProperties()
        self.subscriptions: dict[str, Subscription] = {}
        self.inflight = Inflight()
        # QoS2 publishes we have PUBRECed but not yet PUBRELed (dedup set)
        self.pubrec_inbound: set[int] = set()
        # outbound QoS packets parked on an exhausted send quota, FIFO;
        # released as acks return quota (see Broker._release_held)
        self.held_pids: deque[int] = deque()
        # inbound QoS acks awaiting the storage durability barrier
        # (ADR 014), FIFO: [MQTT-4.6.0-2] PUBACK order must match
        # PUBLISH arrival order even when a later publish's barrier
        # clears first (see Broker._ack_publish_durable)
        self.pending_durable_acks: deque = deque()
        self.aliases: TopicAliases | None = None
        self.keepalive = 0
        self.requested_keepalive = 0
        self.last_received = time.monotonic()
        self.connected_at = 0.0
        self.disconnected_at = 0.0
        self.taken_over = False
        self.assigned_id = False
        self.stop_cause: ProtocolError | None = None
        self._stopped = asyncio.Event()
        self._packet_id_cursor = 0

        maxq = server.capabilities.maximum_client_writes_pending
        # bytes items are pre-encoded wire (QoS0 fan-out fast path);
        # tuple items are ADR-019 shared-template buffer sequences;
        # None is the writer-shutdown sentinel. Byte-accounted against
        # the per-client and broker budgets (ADR 012).
        self.outbound = OutboundQueue(
            maxq, overload=getattr(server, "overload", None),
            scheduler=getattr(server, "flush_sched", None))
        self._writer_task: asyncio.Task | None = None
        self._reader_task: asyncio.Task | None = None
        # slow-consumer ledger (ADR 012): writer progress timestamp for
        # the stall detector, the first fatal writer error, and
        # per-client drop accounting surfaced via $SYS + /metrics
        self.write_progress = time.monotonic()
        self.write_error: str | None = None
        self.dropped_msgs = 0
        self.dropped_bytes = 0
        self.drops_by_reason: dict[str, int] = {}
        # ADR 015 drain watchers: (trace, enqueue_ns, enqueue_seq)
        # triples the server registers for sampled deliveries; the
        # writer loop settles each after the first flush that covers
        # its seq (one branch per burst when empty)
        self._drain_traces: list = []
        # ADR 017 QoS2 release-leg stopwatches: pid -> PUBREC-sent ns
        # for SAMPLED inbound QoS2 publishes; popped at PUBREL
        self._qos2_release_t0: dict[int, int] = {}

    # ------------------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._stopped.is_set()

    def parse_connect(self, packet: Packet) -> None:
        """Absorb CONNECT fields into session properties."""
        p = self.properties
        p.protocol_version = packet.protocol_version
        p.clean_start = packet.clean_start
        p.username = packet.username
        self.id = packet.client_id
        self.requested_keepalive = packet.keepalive
        self.keepalive = packet.keepalive
        caps_ka = self.server.capabilities.maximum_keepalive
        if caps_ka and (self.keepalive == 0 or self.keepalive > caps_ka):
            # clamp to the operator limit; v5 clients learn the new value
            # via ServerKeepAlive in CONNACK [MQTT-3.1.2-21]
            self.keepalive = caps_ka
        if packet.protocol_version >= 5:
            self._absorb_v5_connect_props(packet.properties)
        caps = self.server.capabilities
        self.inflight = Inflight(
            receive_maximum=caps.receive_maximum,
            send_maximum=p.receive_maximum or caps.receive_maximum)
        self.aliases = TopicAliases(caps.topic_alias_maximum)
        if packet.will is not None:
            w = packet.will
            p.will = w
            p.will_delay = w.properties.will_delay or 0

    def _absorb_v5_connect_props(self, pr) -> None:
        p = self.properties
        p.session_expiry = pr.session_expiry or 0
        p.session_expiry_set = pr.session_expiry is not None
        p.receive_maximum = pr.receive_maximum or 0
        p.topic_alias_maximum = pr.topic_alias_max or 0
        p.maximum_packet_size = pr.maximum_packet_size or 0
        if pr.request_problem_info is not None:
            p.request_problem_info = pr.request_problem_info

    def next_packet_id(self) -> int:
        """Allocate an unused outbound packet id; raises when all 65535 are
        inflight."""
        for _ in range(65535):
            self._packet_id_cursor = (self._packet_id_cursor % 65535) + 1
            if self.inflight.get(self._packet_id_cursor) is None:
                return self._packet_id_cursor
        raise PacketIDExhausted()

    # ------------------------------------------------------------------
    # Transport
    # ------------------------------------------------------------------

    def start(self) -> None:
        if self.writer is not None:
            budget = self.server.capabilities.client_byte_budget
            transport = getattr(self.writer, "transport", None)
            if budget and transport is not None:
                # cap the transport's own buffering so a slow consumer
                # blocks the writer's drain() (and so shows up in the
                # byte-accounted queue + stall detector) instead of
                # hiding inside an unbounded transport buffer
                try:
                    transport.set_write_buffer_limits(
                        high=min(budget, 65536))
                except (AttributeError, RuntimeError):
                    pass
            self.write_progress = time.monotonic()
            self._writer_task = asyncio.get_running_loop().create_task(
                self._write_loop(), name=f"mq-write-{self.id or id(self)}")

    async def read_loop(self, on_packet, initial: bytearray | None = None
                        ) -> None:
        """Frame the inbound byte stream and dispatch packets until EOF,
        error, or stop. ``on_packet`` is the server's receive entry point.
        ``initial`` seeds the buffer with bytes read past the CONNECT
        packet (a client may pipeline SUBSCRIBE/PUBLISH in the same
        segment)."""
        assert self.reader is not None
        buf = initial if initial is not None else bytearray()
        maxsize = self.server.capabilities.maximum_packet_size
        tracer = self.server.tracer
        while not self.closed:
            for fh, body in parse_stream(buf, maxsize):
                self.server.info.packets_received += 1
                if tracer.sample_n and fh.type == PT.PUBLISH:
                    # ADR 015: time the decode; process_publish folds
                    # it into the trace when this publish is sampled
                    t0 = tracer.clock()
                    packet = Packet.decode(
                        fh, body, self.properties.protocol_version)
                    packet._decode_ns = tracer.clock() - t0
                else:
                    packet = Packet.decode(
                        fh, body, self.properties.protocol_version)
                await on_packet(self, packet)
                if self.closed:
                    return
            try:
                chunk = await self.reader.read(
                    self.server.capabilities.buffer_size)
            except (ConnectionError, asyncio.CancelledError, OSError):
                return
            if not chunk:
                return
            self.server.info.bytes_received += len(chunk)
            self.last_received = time.monotonic()
            buf.extend(chunk)

    def _write_fault_delay(self) -> float:
        """0.0 unless a client.write fault applies to this client —
        then the seconds the writer must stall (hang mode). Kept sync
        and gated on any_armed() so the idle-registry production cost
        is one predicate call per written packet; raise-mode faults
        propagate to the write loop as a recorded writer death."""
        if not faults.REGISTRY.any_armed():
            return 0.0
        hit = faults.fire_detail(faults.CLIENT_WRITE, key=self.id)
        return hit[1] if hit is not None and hit[0] == "hang" else 0.0

    # greedy-burst byte cap: past this, the writer drains before
    # dequeuing more, so a wedged consumer keeps its backlog in the
    # ACCOUNTED queue (visible to stall detector + watermarks) instead
    # of de-accounted inside the transport buffer (ADR 012)
    BURST_BYTES = 65536

    def _flush_bufs(self, bufs: list) -> None:
        """Hand one burst's collected wire buffers to the transport in
        a single writev-style call (ADR 019): shared template segments
        are joined once at the socket layer per burst, not copied once
        per subscriber at fan-out. Writer facades without writelines
        (WS / embedder stream shims expose only write) get the burst
        as one joined write — same bytes, one frame."""
        writelines = getattr(self.writer, "writelines", None)
        if writelines is not None:
            writelines(bufs)
        else:
            self.writer.write(b"".join(bufs))
        overload = getattr(self.server, "overload", None)
        if overload is not None:
            overload.writev_batches += 1
            overload.writev_buffers += len(bufs)
        bufs.clear()

    async def _write_loop(self) -> None:
        assert self.writer is not None
        get_nowait = self.outbound.get_nowait
        info = self.server.info
        # wire buffers collected across the burst, flushed through ONE
        # transport.writelines per burst (or before any Packet item,
        # which must encode+write in order)
        bufs: list = []
        try:
            while True:
                packet = await self.outbound.get()
                burst = 0
                # greedy drain: one task wake-up flushes everything queued
                # (one await per BURST, not per packet), bounded in bytes
                while packet is not None:
                    stall = self._write_fault_delay()
                    if stall:
                        # deterministic slow consumer: stall THIS writer
                        # without blocking the loop (tests/bench arm
                        # client.write#<id>; see faults.fire_detail)
                        await asyncio.sleep(stall)
                    t = type(packet)
                    if t is bytes:             # pre-encoded fast path
                        bufs.append(packet)
                        n = len(packet)
                        info.bytes_sent += n
                        info.packets_sent += 1
                        burst += n
                        if packet[0] >> 4 == PT.PUBLISH:
                            info.messages_sent += 1
                    elif t is tuple:           # ADR 019 buffer sequence
                        n = 0
                        for b in packet:
                            n += len(b)
                        bufs.extend(packet)
                        info.bytes_sent += n
                        info.packets_sent += 1
                        burst += n
                        if packet[0][0] >> 4 == PT.PUBLISH:
                            info.messages_sent += 1
                    else:
                        if bufs:               # keep the wire in order
                            self._flush_bufs(bufs)
                        self._write_packet(packet)
                        burst += _estimate_wire(packet)
                    if burst >= self.BURST_BYTES:
                        break
                    try:
                        packet = get_nowait()
                    except asyncio.QueueEmpty:
                        break
                else:
                    break                      # drained a None: stop
                if bufs:
                    self._flush_bufs(bufs)
                await self._flush_burst()
            if bufs:
                self._flush_bufs(bufs)
            await self._drain()
        except asyncio.CancelledError:
            pass
        except (ConnectionError, OSError, faults.InjectedFault) as exc:
            # a dead writer must be visible to the stall detector and
            # stop_cause — not an apparently-healthy idle one
            self.write_error = self.write_error or repr(exc)

    async def _flush_burst(self) -> None:
        """One burst's transport flush. The removed-counter snapshot
        happens BEFORE awaiting: deliveries enqueued while drain() is
        in flight were not carried by this flush, so their ADR-015
        watchers must wait for a later one. drain() is the flow
        control: past the transport high-water mark it blocks until
        the consumer catches up, backpressuring into the
        byte-accounted queue where the stall detector and budgets can
        see it (ADR 012)."""
        self.write_progress = time.monotonic()
        flushed = self.outbound.removed
        await self.writer.drain()
        self.write_progress = time.monotonic()
        if self._drain_traces:
            self._settle_drain_traces(flushed)

    def _write_packet(self, packet: Packet) -> None:
        packet = self.server.hooks.modify("on_packet_encode", packet, self)
        # oversize outbound packets first shed their optional problem-
        # info properties [MQTT-3.2.2-19/20]; still-oversize ones drop
        # [MQTT-3.1.2-25]
        wire = packet.encode_under(self.properties.maximum_packet_size)
        if wire is None:
            self.server.info.messages_dropped += 1
            return
        assert self.writer is not None
        self.writer.write(wire)
        self.server.info.bytes_sent += len(wire)
        self.server.info.packets_sent += 1
        if packet.type == PT.PUBLISH:
            self.server.info.messages_sent += 1
            overload = getattr(self.server, "overload", None)
            if overload is not None:
                # ADR 019 ledger: a Packet entry reaching the writer is
                # a per-subscriber encode the template path didn't cover
                overload.slow_encodes += 1
                overload.copied_bytes += len(wire)
        self.server.hooks.notify("on_packet_sent", self, packet, len(wire))

    async def _drain(self) -> None:
        if self.writer is not None:
            try:
                await self.writer.drain()
            except (ConnectionError, OSError) as exc:
                # swallowed (shutdown path), but recorded: the stall
                # detector and stop_cause must see the dead writer
                self.write_error = self.write_error or repr(exc)

    def _settle_drain_traces(self, flushed: int) -> None:
        """Close the ADR-015 drain watchers whose delivery the flush
        that just completed actually carried — those registered at an
        enqueue seq the writer has dequeued (seq <= ``flushed``).
        Watchers for deliveries still sitting in the outbound queue
        (burst byte-cap leftovers, enqueues racing an in-flight drain)
        keep accruing real latency until their own flush."""
        tracer = self.server.tracer
        now = tracer.clock()
        keep = []
        for tr, t0, seq in self._drain_traces:
            if seq <= flushed:
                tracer.drain_span(tr, self.id, t0, now)
            else:
                keep.append((tr, t0, seq))
        self._drain_traces = keep

    def note_drop(self, reason: str, n: int = 1, size: int = 0) -> None:
        """Per-client drop/stall accounting (ADR 012): what $SYS
        top-offender reporting and the labelled metric read. Also feeds
        the ADR-015 per-stage error counter, so write-path drops show
        up next to the drain-stage latency they explain."""
        self.dropped_msgs += n
        self.dropped_bytes += size
        self.drops_by_reason[reason] = \
            self.drops_by_reason.get(reason, 0) + n
        tracer = getattr(self.server, "tracer", None)
        if tracer is not None:
            tracer.note_error("drain", reason, n)

    def _refuse_publish(self, size: int) -> str | None:
        """Byte-budget admission for one queued PUBLISH delivery: free
        room by shedding this client's oldest queued QoS0 publishes
        first (oldest-first slow-consumer policy), then check the
        global broker budget. Returns the refusal reason for the NEW
        delivery, or None when admitted. The distinction matters for
        attribution: "byte_budget" is THIS client's backpressure,
        "global_budget" is broker-wide pressure some other consumer
        caused — top_offenders only ranks the former."""
        caps = self.server.capabilities
        overload = self.server.overload
        budget = caps.client_byte_budget
        if budget and self.outbound.bytes + size > budget:
            items, freed = self.outbound.drop_oldest_qos0(
                self.outbound.bytes + size - budget)
            if items:
                self.note_drop("byte_budget", len(items), freed)
                overload.budget_drops += len(items)
                self.server.info.messages_dropped += len(items)
                hooks = self.server.hooks
                if hooks.overrides("on_publish_dropped"):
                    for item in items:
                        # pre-encoded wire/buffer-sequence sheds have no
                        # Packet to hand the hook; the counters above
                        # remain authoritative
                        if type(item) not in (bytes, tuple):
                            hooks.notify("on_publish_dropped",
                                         self, item)
            if self.outbound.bytes + size > budget:
                return "byte_budget"
        if (caps.broker_byte_budget
                and overload.queued_bytes + size > caps.broker_byte_budget):
            return "global_budget"
        return None

    def send(self, packet: Packet, *, count_drops: bool = True) -> bool:
        """Enqueue a packet for the writer task; False when the queue or
        byte budget refused it (caller decides whether that drops a
        message). Control packets are exempt from the byte budget —
        they are small, and dropping acks would wedge the protocol.
        ``count_drops=False`` suppresses refusal accounting for callers
        whose refused message is NOT lost (inflight resend: it stays
        parked and lands on a later resume)."""
        if self.closed or self.writer is None:
            return False
        size = _estimate_wire(packet)
        if packet.type == PT.PUBLISH and \
                (reason := self._refuse_publish(size)) is not None:
            if count_drops:
                self.note_drop(reason, 1, size)
                self.server.overload.budget_drops += 1
            return False
        try:
            self.outbound.put_nowait(packet, size)
            return True
        except asyncio.QueueFull:
            if count_drops:
                self.note_drop("queue_full", 1, size)
            return False

    def send_wire(self, wire: bytes) -> bool:
        """Enqueue pre-encoded bytes (the broker's QoS0 fan-out fast path:
        one encode shared by every subscriber on the same fixed flags)."""
        if self.closed or self.writer is None:
            return False
        size = len(wire)
        if (wire[0] >> 4) == PT.PUBLISH and \
                (reason := self._refuse_publish(size)) is not None:
            self.note_drop(reason, 1, size)
            self.server.overload.budget_drops += 1
            return False
        try:
            self.outbound.put_nowait(wire, size)
            return True
        except asyncio.QueueFull:
            self.note_drop("queue_full", 1, size)
            return False

    def send_buffers(self, bufs: tuple, size: int,
                     publish: bool = True) -> bool:
        """Enqueue one ADR-019 buffer-sequence delivery (shared
        template segments + a per-subscriber head) with its EXACT wire
        size — the writer hands the buffers to transport.writelines
        unchanged, so enqueue accounting equals socket bytes. Refusal
        accounting mirrors send_wire: one refusal, one reason, one
        budget_drops increment, on both fast and slow paths."""
        if self.closed or self.writer is None:
            return False
        if publish and (reason := self._refuse_publish(size)) is not None:
            self.note_drop(reason, 1, size)
            self.server.overload.budget_drops += 1
            return False
        try:
            self.outbound.put_nowait(bufs, size)
            return True
        except asyncio.QueueFull:
            self.note_drop("queue_full", 1, size)
            return False

    def send_now(self, packet: Packet) -> None:
        """Write synchronously, bypassing the queue (CONNACK, shutdown)."""
        if self.writer is not None:
            self._write_packet(packet)

    async def stop(self, cause: ProtocolError | None = None) -> None:
        """Terminate the network connection (the session may persist)."""
        if self._stopped.is_set():
            return
        self.stop_cause = self.stop_cause or cause
        self._stopped.set()
        self.disconnected_at = time.time()
        note = getattr(self.server, "note_session_closed", None)
        if note is not None:
            note(self)
        if self._writer_task is not None:
            try:
                self.outbound.put_nowait(None)
            except asyncio.QueueFull:
                self._writer_task.cancel()
            try:
                await asyncio.wait_for(self._writer_task, timeout=1.0)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                self._writer_task.cancel()
        # settle the byte ledgers for anything never written: abandoned
        # bytes must not pin the global watermark in shedding forever
        self.outbound.release_all()
        if self.writer is not None:
            try:
                self.writer.close()
            except Exception:
                pass
        if self._reader_task is not None and self._reader_task is not asyncio.current_task():
            self._reader_task.cancel()

    # ------------------------------------------------------------------

    def resend_inflight(self, force_dup: bool = True) -> int:
        """Queue all unacked messages again (session resume [MQTT-4.4.0-1]).
        Returns the number of packets queued."""
        n = 0
        held = set(self.held_pids)
        for p in self.inflight.all():
            if p.packet_id in held:
                # held-but-unsent (ADR 018): was never on the wire, so
                # it is not a resend — _release_held sends it fresh
                # (no DUP) as send quota opens
                continue
            q = p.copy()
            # encoded for this connection: a message restored from the
            # store carries no version of its own (a v5 session would
            # get a v3.1.1 frame, which it cannot parse)
            q.protocol_version = self.properties.protocol_version
            if q.type == PT.PUBLISH and force_dup:
                q.fixed.dup = True
            # a refused resend is parked, not dropped (it stays in
            # inflight for the next resume): keep it off the drop books
            if self.send(q, count_drops=False):
                self.server.hooks.notify("on_qos_publish", self, q,
                                         time.time(), 1)
                n += 1
        return n

    def expired(self, now: float, maximum_expiry: int) -> bool:
        """True when a disconnected session has outlived its expiry window."""
        return now > self.expires_at(maximum_expiry)

    def expires_at(self, maximum_expiry: int) -> float:
        """The time after which this disconnected session is expired
        (``expired``); infinity when it never disconnected."""
        if self.disconnected_at == 0:
            return math.inf
        if self.properties.protocol_version >= 5:
            expiry = self.properties.session_expiry
            if self.properties.session_expiry_set:
                expiry = min(expiry, maximum_expiry) if maximum_expiry else expiry
            else:
                expiry = 0 if self.properties.clean_start else maximum_expiry
        else:
            expiry = 0 if self.properties.clean_start else maximum_expiry
        return self.disconnected_at + expiry


class ClientRegistry:
    """Session registry keyed by client id."""

    def __init__(self) -> None:
        self._clients: dict[str, Client] = {}

    def get(self, client_id: str) -> Client | None:
        return self._clients.get(client_id)

    def add(self, client: Client) -> None:
        self._clients[client.id] = client

    def delete(self, client_id: str) -> None:
        self._clients.pop(client_id, None)

    def __len__(self) -> int:
        return len(self._clients)

    def all(self) -> list[Client]:
        return list(self._clients.values())

    def connected(self) -> list[Client]:
        return [c for c in self._clients.values() if not c.closed]
