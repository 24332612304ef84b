"""Outbound bridge link to one cluster peer (ADR 013).

Copy of the JAX package's ``cluster/bridge.py``.

A bridge is an ordinary MQTT v3.1.1 client connection (built on
``mqtt_client.MQTTClient``) from this node to a peer broker, carrying
three kinds of traffic on reserved ``$cluster/*`` topics: route
snapshots/deltas, sync requests, and forwarded publishes. The peer
recognizes the link by its ``$maxmq-cluster/<node>`` client id and
diverts those topics to its own ClusterManager before the normal
``$``-namespace drop (broker/server.py).

Robustness rails, mirroring the ADR-011 supervisor and the ADR-012
ledger:

* **Reconnect** — one supervisor task per link: capped exponential
  backoff between attempts, reset on a successful CONNACK; every
  attempt and flap is counted. The deterministic ``cluster.link``
  fault site (keyed per peer: ``cluster.link#<node>``) can kill or
  hang the link on demand.
* **Backpressure** — outbound traffic rides a byte-accounted
  :class:`~..broker.client.OutboundQueue` wired into the broker's
  ADR-012 overload ledger, so a slow/partitioned peer counts against
  the global watermarks instead of buffering unboundedly. Forwarded
  publishes past the link byte budget are refused (QoS0) or refused
  *and rolled back* (QoS1: the provisional ack entry is withdrawn —
  nothing leaks awaiting an ack that can never come); route/control
  messages are budget-exempt, like acks in the broker's own queues.
* **Liveness** — an idle link pings every ``keepalive`` seconds; a
  failed ping tears the link down into the reconnect loop and marks
  the peer down in the membership ledger.
* **Partition tolerance (ADR 018)** — the directed
  ``cluster.partition`` fault site fires at every boundary this link's
  bytes cross (connect, ping, per-item writer), so a chaos harness can
  blackhole or delay one direction deterministically; and QoS1
  forwards that a partition strands (refused by a down link, or
  unacked when the link dies) PARK in a bounded, journal-backed buffer
  and re-send on link-up — the receiver's per-(origin, epoch) msgid
  dedup makes the retry at-most-once-delivered, so a PUBACKed publish
  survives the partition instead of vanishing with the link.
* **WAN shaping (ADR 022)** — the directed ``cluster.shape`` spec
  (delay/jitter/token-bucket rate/loss) rides the same boundaries:
  connect and keepalive pay the emulated round trip (with the
  RTT-adaptive ping deadline keeping a healthy slow link alive), and
  the writer releases items through a non-blocking reorder-preserving
  deferral queue, so a shaped link throttles without wedging the
  event loop or reordering the FIFO stream the blip audit relies on.
"""

from __future__ import annotations

import asyncio
import json
import time
from collections import deque

from .. import faults
from ..broker.client import OutboundQueue
from ..mqtt_client import MQTTClient, MQTTError
from ..protocol.codec import FixedHeader, PacketType as PT
from ..protocol.packets import Packet

BRIDGE_ID_PREFIX = "$maxmq-cluster/"

# per-link queue entry cap (the byte budget is the real limit; this
# bounds entry-count bookkeeping the same way broker queues are capped)
LINK_QUEUE_MAX = 8192
BURST_BYTES = 65536

# parked-forward bound (ADR 018): QoS1 forwards stranded by a down or
# partitioned link awaiting retry-after-heal; oldest dropped (counted)
# past the cap — the bounded-staleness contract, never unbounded memory
PARKED_MAX = 2048

# journal bucket for parked forwards (survives the PARKING node's own
# crash; restored by ClusterManager.start)
FWD_BUCKET = "cluster_fwd"

# ADR 022: cap on wire items stamped into the writer's deferral queue
# ("in flight on the shaped link"). Items past the cap stay in the
# outbound queue — still byte-accounted on the ADR-012 ledger — so a
# slow shaped link back-pressures instead of un-accounting unboundedly,
# exactly like a full egress ring on a real NIC
DEFER_MAX = 512


class BridgeLink:
    """One supervised outbound link to a peer broker."""

    def __init__(self, manager, spec, *, node_id: str, qos: int = 0,
                 byte_budget: int = 4 << 20, keepalive: float = 10.0,
                 backoff_initial_s: float = 0.5,
                 backoff_max_s: float = 30.0,
                 connect_timeout: float = 5.0) -> None:
        self.manager = manager
        self.spec = spec
        self.node_id = node_id          # OUR node id (client identity)
        self.peer = spec.node_id
        self.qos = qos
        self.byte_budget = byte_budget
        self.keepalive = keepalive
        self.backoff_initial_s = backoff_initial_s
        self.backoff_max_s = backoff_max_s
        self.connect_timeout = connect_timeout
        # ADR 021: unix-domain loopback link (worker mesh) — connects
        # by path, skips clock-skew probes (one host, one clock), and
        # the pool wiring passes byte_budget=0 (budget-exempt)
        self.local = spec.local
        if self.local:
            # a sibling's socket appears within milliseconds of its
            # boot/respawn; the TCP backoff floor would dominate pool
            # start and post-crash reconvergence
            self.backoff_initial_s = min(self.backoff_initial_s, 0.05)

        broker = manager.broker
        self.outbound = OutboundQueue(
            LINK_QUEUE_MAX, overload=getattr(broker, "overload", None))
        self.client: MQTTClient | None = None
        self.connected = False
        # what this link last told the peer (split-horizon aggregated
        # set) + the per-link monotonic delta sequence; needs_snapshot
        # marks a link whose last snapshot failed to enqueue and must
        # be retried before any delta may flow
        self.advertised: set[str] = set()
        # ADR 023 stretch: the predicate annotations last sent on this
        # link (None while content routes are off / before the first
        # annotated snapshot) — annotation drift forces a snapshot
        self.advertised_preds: dict[str, list[str]] | None = None
        self.route_seq = 0
        self.needs_snapshot = False

        self.connect_attempts = 0
        self.forwards_sent = 0
        self.forwards_refused = 0
        self.forwards_acked = 0
        self.forward_ack_failures = 0
        self.control_sent = 0
        self.session_sent = 0       # ADR-016 session-federation messages
        # ADR 018: parked QoS1 forwards awaiting retry-after-heal
        # [(envelope topic, payload, journal key), ...]; the key set
        # mirrors it for O(1) already-parked checks
        self.parked: deque[tuple[str, bytes, str]] = deque()
        self._parked_keys: set[str] = set()
        self.forwards_parked = 0
        self.parked_dropped = 0     # oldest shed past PARKED_MAX
        self.parked_resent = 0
        self.partition_drops = 0    # writer items the fault blackholed
        # ADR 022 WAN shaping: the writer-side deferral queue —
        # [(depart_ns, wire item), ...] FIFO, release times monotonic
        # by construction (ShapeSpec clamps) — plus its counters and
        # the persistent outbound getter (never cancelled mid-get: a
        # cancelled get can lose an already-popped, de-accounted item)
        self._deferred: deque[tuple[int, bytes]] = deque()
        self._pending_get: asyncio.Future | None = None
        self.shape_deferrals = 0    # writer items the shape delayed
        # ADR 020 sub-keepalive blip detection: per-connection monotonic
        # heartbeat seq + cumulative data-item enqueue count (both reset
        # at connect — the peer's fresh server-side client resets its
        # mirror), and the debounce stamp for peer-reported blips
        self.hb_seq = 0
        self.items_sent = 0
        self.last_blip_resync = 0.0
        self._task: asyncio.Task | None = None
        self._closed = False

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(
            self._run(), name=f"cluster-link-{self.peer}")

    async def close(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        await self._teardown("closed")

    async def _run(self) -> None:
        backoff = self.backoff_initial_s
        while not self._closed:
            self.connect_attempts += 1
            st = self.manager.membership.get(self.peer)
            if st is not None:
                st.connect_attempts += 1
            try:
                await self._fire_link_fault()
                await self._connect_once()
                backoff = self.backoff_initial_s
                await self._pump()
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                await self._teardown(repr(exc)[:200])
            if self._closed:
                return
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, self.backoff_max_s)

    async def _fire_link_fault(self) -> None:
        """Deterministic link fault (ADR 013): ``raise`` kills this
        attempt/iteration into the reconnect backoff, ``hang`` stalls
        the link without blocking the loop."""
        hit = faults.fire_detail(faults.CLUSTER_LINK, key=self.peer)
        if hit is not None and hit[0] == "hang":
            await asyncio.sleep(hit[1])

    async def _fire_partition(self, liveness: bool) -> None:
        """The ADR-018 directed-partition site on this link's outbound
        direction. ``liveness`` sites (connect, ping) RAISE under drop
        — a blackholed path fails its handshake/keepalive, so the link
        is detected down and enters reconnect backoff until healed;
        data sites handle drop themselves. ``hang`` delays either."""
        hit = faults.fire_detail(
            faults.CLUSTER_PARTITION,
            key=faults.partition_key(self.node_id, self.peer))
        if hit is None:
            return
        mode, delay = hit
        if mode == "hang":
            await asyncio.sleep(delay)
        elif liveness:
            raise ConnectionError(
                f"partitioned: {self.node_id}->{self.peer}")

    def _shape(self):
        """This link's outbound-direction WAN shape, or None (ADR 022;
        the common case is one dict get on an empty dict)."""
        return faults.REGISTRY.get_shape(
            faults.partition_key(self.node_id, self.peer))

    def _shape_rtt_s(self) -> float:
        """The emulated ping round trip on a shaped link: this
        direction's one-way propagation plus the reverse direction's
        when armed (asymmetric shapes yield asymmetric RTT halves)."""
        out = self._shape()
        if out is None:
            return 0.0
        back = faults.REGISTRY.get_shape(
            faults.partition_key(self.peer, self.node_id))
        return out.oneway_s + (back.oneway_s if back is not None else 0.0)

    async def _fire_shape_liveness(self) -> None:
        """ADR 022 liveness half of the shape site: a connect/ping
        probe crossing a shaped link pays the round trip in real time,
        and each loss draw (either direction) costs one RETRANSMIT
        round trip on top — TCP loss recovery never kills a healthy
        connection outright, it makes the probe slower, so sustained
        loss shows up as a blown deadline budget (the caller's ping
        timeout), not as an instant flap. Bounded at 8 retransmits so
        a pathological loss setting cannot wedge the keepalive loop
        past its own deadline check."""
        out = self._shape()
        if out is None:
            return
        rtt_s = self._shape_rtt_s()
        if rtt_s > 0:
            await asyncio.sleep(rtt_s)
        back = faults.REGISTRY.get_shape(
            faults.partition_key(self.peer, self.node_id))
        retransmits = 0
        while retransmits < 8 and (
                out.lose() or (back is not None and back.lose())):
            faults.REGISTRY.count_fired(
                f"{faults.CLUSTER_SHAPE}#"
                f"{faults.partition_key(self.node_id, self.peer)}")
            retransmits += 1
            if rtt_s > 0:
                await asyncio.sleep(rtt_s)

    async def _connect_once(self) -> None:
        await self._fire_partition(liveness=True)
        await self._fire_shape_liveness()
        client = MQTTClient(
            client_id=BRIDGE_ID_PREFIX + self.node_id,
            keepalive=max(int(self.keepalive * 3), 1))
        if self.local:
            # ADR 021 local flavor: unix-domain transport to a sibling
            # worker on this box — no TCP handshake, no network in the
            # failure model (the peer process dying IS the link dying)
            await client.connect(path=self.spec.path,
                                 timeout=self.connect_timeout)
        else:
            await client.connect(self.spec.host, self.spec.port,
                                 timeout=self.connect_timeout)
        self.client = client
        self.hb_seq = 0             # fresh connection, fresh audit frame
        self.items_sent = 0
        self.connected = True
        self.manager.membership.note_up(self.peer)
        self.manager.on_link_up(self)

    async def _teardown(self, reason: str) -> None:
        was_up = self.connected
        self.connected = False
        self.outbound.release_all()     # settle the ADR-012 ledger
        # deferred items were "in flight" on the shaped link: they die
        # with the connection like bytes in a dead TCP window (QoS1
        # forwards re-park through their failed ack futures below)
        self._deferred.clear()
        if self._closed and self._pending_get is not None:
            self._pending_get.cancel()
            self._pending_get = None
        client, self.client = self.client, None
        if client is not None:
            await client.close()
            # ack futures registered AFTER the client's read loop died
            # (the peer was SIGKILLed mid-burst) were missed by its own
            # shutdown sweep — fail them here or their forwards never
            # reclassify as stranded and a PUBACKed publish is lost
            # (ADR 018; found by the kill-restart verify drive)
            for fut in client._acks.values():
                if not fut.done():
                    fut.set_exception(MQTTError("bridge link down"))
            client._acks.clear()
        self.manager.membership.note_down(self.peer, reason)
        if was_up:
            self.manager.on_link_down(self, reason)

    # ------------------------------------------------------------------
    # Writer pump + keepalive
    # ------------------------------------------------------------------

    async def _pump(self) -> None:
        """Writer + keepalive, each its own task, first failure tears
        the link down. NOT wait_for(outbound.get(), ...): pre-3.12
        wait_for can cancel the inner await after get_nowait() already
        popped an item, silently losing an (already de-accounted)
        forward — the same reason the broker's writer loop awaits its
        queue bare (broker/client.py)."""
        tasks = [
            asyncio.get_running_loop().create_task(
                self._writer_loop(self.client),
                name=f"cluster-write-{self.peer}"),
            asyncio.get_running_loop().create_task(
                self._keepalive_loop(self.client),
                name=f"cluster-ping-{self.peer}")]
        try:
            done, _pending = await asyncio.wait(
                tasks, return_when=asyncio.FIRST_EXCEPTION)
        finally:
            for t in tasks:
                if not t.done():
                    t.cancel()
            results = await asyncio.gather(*tasks,
                                           return_exceptions=True)
        for r in results:
            if isinstance(r, Exception):
                raise r
        raise ConnectionError("bridge pump ended")    # unreachable

    async def _writer_loop(self, client: MQTTClient) -> None:
        while True:
            item = await self._next_item()
            burst = 0
            while True:
                await self._fire_link_fault()
                if await self._partition_drops_item():
                    self.partition_drops += 1
                else:
                    client.writer.write(item)
                    burst += len(item)
                if burst >= BURST_BYTES:
                    break
                item = self._next_item_nowait()
                if item is None:
                    break
            await client.writer.drain()
            self.manager.membership.note_alive(self.peer)

    # -- WAN-shape deferral queue (ADR 022) ----------------------------

    def _stamp(self, item: bytes) -> None:
        """Stamp one item's departure time into the deferral queue (or
        behind the current tail when the shape was disarmed mid-drain —
        FIFO order survives an unshape)."""
        reg = faults.REGISTRY
        shp = self._shape()
        if shp is None:
            t = self._deferred[-1][0] if self._deferred else 0
        else:
            now = reg.clock_ns()
            t = shp.depart_ns(now, len(item))
            if t > now:
                self.shape_deferrals += 1
            if self._deferred and t < self._deferred[-1][0]:
                t = self._deferred[-1][0]
        self._deferred.append((t, item))

    def _stamp_available(self) -> None:
        """While the head of the deferral queue ripens, pull every
        immediately-available outbound item and stamp it NOW — the
        configured delay is pipeline latency (all items in a burst are
        in flight concurrently), not a per-item serial sleep. Bounded
        by DEFER_MAX so a slow link back-pressures on the ledger."""
        while len(self._deferred) < DEFER_MAX:
            try:
                item = self.outbound.get_nowait()
            except asyncio.QueueEmpty:
                return
            self._stamp(item)

    async def _next_item(self) -> bytes:
        """The writer's item source: the unshaped fast path is the old
        bare ``outbound.get()``; with a shape armed, items flow through
        the deferral queue and are released at their stamped departure
        times, in order, without ever blocking the event loop. The
        pending getter is NEVER cancelled between iterations (a
        cancelled get can drop an already-popped item — the same
        pre-3.12 hazard ``_pump`` documents); it persists across
        reconnects on the instance and is only cancelled at close."""
        reg = faults.REGISTRY
        while True:
            timeout = None
            if self._deferred:
                self._stamp_available()
                now = reg.clock_ns()
                head = self._deferred[0][0]
                if head <= now:
                    return self._deferred.popleft()[1]
                timeout = (head - now) / 1e9
            if self._pending_get is None:
                self._pending_get = asyncio.ensure_future(
                    self.outbound.get())
            done, _pending = await asyncio.wait({self._pending_get},
                                                timeout=timeout)
            if self._pending_get not in done:
                continue            # head came due; release it FIFO
            fut, self._pending_get = self._pending_get, None
            item = fut.result()
            if not self._deferred and self._shape() is None:
                return item         # unshaped fast path
            self._stamp(item)

    def _next_item_nowait(self) -> bytes | None:
        """Burst refill: the next item that may hit the wire right now,
        or None (queue empty, or the shaped head is still in flight)."""
        if self._deferred:
            self._stamp_available()
            if self._deferred[0][0] <= faults.REGISTRY.clock_ns():
                return self._deferred.popleft()[1]
            return None
        try:
            item = self.outbound.get_nowait()
        except asyncio.QueueEmpty:
            return None
        if self._shape() is None:
            return item
        self._stamp(item)
        if self._deferred[0][0] <= faults.REGISTRY.clock_ns():
            return self._deferred.popleft()[1]
        return None

    async def _partition_drops_item(self) -> bool:
        """ADR 018: one writer item crossing the partitioned direction
        — drop blackholes it in flight (already de-accounted, exactly
        like bytes lost inside a dead TCP window), hang delays it."""
        hit = faults.fire_detail(
            faults.CLUSTER_PARTITION,
            key=faults.partition_key(self.node_id, self.peer))
        if hit is None:
            return False
        mode, delay = hit
        if mode == "hang":
            await asyncio.sleep(delay)
            return False
        return True

    async def _keepalive_loop(self, client: MQTTClient) -> None:
        while True:
            await asyncio.sleep(self.keepalive)
            self._send_hb()
            await self._fire_link_fault()
            await self._fire_partition(liveness=True)
            # ADR 022: the ping budget is the RTT-adaptive deadline
            # (floor + k x measured RTT); the emulated WAN round trip
            # spends part of it, and a shaped RTT the unstretched floor
            # cannot cover is exactly the false flap the adaptation
            # exists to prevent
            deadline = self.manager.link_deadline(self.peer,
                                                  self.connect_timeout)
            rtt_s = self._shape_rtt_s()
            if rtt_s >= deadline:
                raise ConnectionError(
                    f"keepalive past deadline: {self.node_id}->"
                    f"{self.peer} rtt {rtt_s:.3f}s >= {deadline:.3f}s")
            t0 = time.monotonic()
            await self._fire_shape_liveness()
            spent = time.monotonic() - t0
            if spent >= deadline:
                # emulated retransmits ate the whole budget: the link
                # is lossy past what the deadline tolerates
                raise ConnectionError(
                    f"keepalive past deadline: {self.node_id}->"
                    f"{self.peer} probe {spent:.3f}s >= {deadline:.3f}s")
            await client.ping(timeout=deadline - spent)
            self.manager.membership.note_alive(self.peer)
            # ADR 017: the proved-alive link refreshes its clock-skew
            # estimate at the keepalive cadence
            self.manager.on_link_alive(self)

    def _send_hb(self) -> None:
        """ADR 020: one audit heartbeat through the WRITER QUEUE (so it
        crosses the same partition drop site the data does — a healed
        blip shows as a seq gap), carrying this connection's monotonic
        seq and the cumulative data-item enqueue count. FIFO order
        makes the claim exact: everything counted in ``n`` was written
        (or blackholed) before this heartbeat. Uncounted on both ends;
        a full queue just skips the beat. Capability-gated like every
        post-013 wire kind: a pre-020 peer that never announced
        ``blip-hb`` is not sent frames it would count as rejected."""
        if not self.manager._peer_has_cap(self.peer, "blip-hb"):
            return
        payload = json.dumps({"seq": self.hb_seq + 1,
                              "n": self.items_sent}).encode()
        wire = self._encode_publish(f"$cluster/hb/{self.node_id}",
                                    payload, 0, False)
        try:
            self.outbound.put_nowait(wire, len(wire))
        except asyncio.QueueFull:
            return
        self.hb_seq += 1

    # ------------------------------------------------------------------
    # Enqueue side (called synchronously from the fan-out path)
    # ------------------------------------------------------------------

    def _encode_publish(self, topic: str, payload: bytes, qos: int,
                        retain: bool, packet_id: int = 0) -> bytes:
        return Packet(fixed=FixedHeader(type=PT.PUBLISH, qos=qos,
                                        retain=retain),
                      protocol_version=4, topic=topic, payload=payload,
                      packet_id=packet_id).encode()

    def forward(self, topic: str, payload: bytes, qos: int = 0,
                collect: list | None = None, park: bool = False,
                _parked_key: str | None = None) -> bool:
        """Enqueue one forwarded publish; False = refused (link down,
        byte budget, or queue full). A refused QoS1 forward rolls its
        provisional ack entry back — the ADR-012 no-leak invariant
        applied to the bridge. Ledger charges are the EXACT encoded
        wire bytes (ADR 012's pre-encoded-wire discipline).

        ADR 018: ``collect`` (a list) receives the QoS1 PUBACK future —
        the fwd-durability barrier waits on it. ``park=True`` makes a
        refused or never-acked QoS1 forward PARK for retry-after-heal
        instead of being lost (the envelope's origin msgid makes the
        receiver dedup the retry)."""
        client = self.client
        if (not self.connected or client is None
                or client._closed.is_set()):
            # _closed: the client's read loop is already dead (peer
            # killed) even though the supervisor hasn't torn the link
            # down yet — an ack registered now could never resolve
            if park and qos > 0:
                self._park(topic, payload, _parked_key)
            return False
        pid = 0
        cb = None
        if qos > 0:
            pid = client._alloc_id()
            fut = client._await_ack(PT.PUBACK, pid)
            cb = self._fwd_ack_cb(topic, payload, park, _parked_key)
            fut.add_done_callback(cb)
            if collect is not None:
                collect.append(fut)
        wire = self._encode_publish(topic, payload, qos, False, pid)
        if ((self.byte_budget
                and self.outbound.bytes + len(wire) > self.byte_budget)
                or not self._try_put(wire)):
            self._handle_refusal(client, pid, qos, cb, collect, park,
                                 topic, payload, _parked_key)
            return False
        self.forwards_sent += 1
        return True

    def _handle_refusal(self, client: MQTTClient, pid: int, qos: int,
                        cb, collect: list | None, park: bool,
                        topic: str, payload: bytes,
                        parked_key: str | None) -> None:
        """One refused enqueue: count + roll the ack entry back, drop
        the cancelled future from the barrier's collect list (the
        caller counts this refusal's degrade exactly once off the
        False return), and park the copy for retry when asked."""
        self._refuse_forward(client, pid, qos, cb)
        if qos > 0:
            if collect is not None:
                collect.pop()
            if park:
                self._park(topic, payload, parked_key)

    def _try_put(self, wire: bytes) -> bool:
        try:
            self.outbound.put_nowait(wire, len(wire))
        except asyncio.QueueFull:
            return False
        self.items_sent += 1    # ADR 020: audited by the heartbeat
        return True

    def _fwd_ack_cb(self, topic: str, payload: bytes, park: bool,
                    parked_key: str | None):
        """The QoS1 forward's ack outcome: success settles (and clears
        a parked-retry journal row); a dead link's failed ack re-parks
        the forward when fwd durability is on (ADR 018) — the retry
        fires on the next link-up."""
        def cb(fut: asyncio.Future) -> None:
            if fut.cancelled() or fut.exception() is not None:
                self.forward_ack_failures += 1
                if park:
                    self._park(topic, payload, parked_key)
            else:
                self.forwards_acked += 1
                if parked_key is not None:
                    self._journal_delete(parked_key)
        return cb

    def _refuse_forward(self, client: MQTTClient, pid: int, qos: int,
                        cb=None) -> None:
        """One refused forward: count it, roll back a QoS1 ack entry,
        and attribute it to the bridge stage on the ADR-015 error
        counter so the loss shows up next to the bridge latency."""
        self.forwards_refused += 1
        tracer = getattr(self.manager.broker, "tracer", None)
        if tracer is not None:
            tracer.note_error("bridge", "refused")
        if qos > 0:
            self._rollback_refused_ack(client, pid, cb)

    def _rollback_refused_ack(self, client: MQTTClient, pid: int,
                              cb=None) -> None:
        """Withdraw the ack entry a refused QoS1 forward registered:
        the publish never hit the wire, so nothing may sit waiting for
        a PUBACK that cannot come (mirrors the broker's
        ``_rollback_refused_qos``). The park-on-failure callback is
        removed FIRST — the refusal path parks explicitly, and the
        cancel must not park a second copy."""
        fut = client._acks.pop((PT.PUBACK, pid), None)
        if fut is not None and not fut.done():
            if cb is not None:
                fut.remove_done_callback(cb)
            fut.cancel()

    # -- parked forwards (ADR 018) -------------------------------------

    def _park(self, topic: str, payload: bytes,
              key: str | None = None) -> None:
        """Park one stranded QoS1 forward for retry-after-heal: bounded
        (oldest dropped + counted past PARKED_MAX) and journaled (the
        ``cluster_fwd`` bucket — a crash of THIS node mid-partition
        still redelivers after restart; ADR-014 write-behind rules
        apply)."""
        if key is None:
            # `$cluster/fwd/<origin>/<epoch>/<msgid>/...`: the identity
            # the receiver dedups on — one journal row per message
            levels = topic.split("/", 5)
            ident = ":".join(levels[2:5]) if len(levels) > 5 else topic
            key = f"{self.peer}|{ident}"
        if key in self._parked_keys:
            return      # already parked (refused enqueue + failed ack)
        while len(self.parked) >= PARKED_MAX:
            _t, _p, old_key = self.parked.popleft()
            self._parked_keys.discard(old_key)
            self.parked_dropped += 1
            self._journal_delete(old_key)
        self.parked.append((topic, payload, key))
        self._parked_keys.add(key)
        self.forwards_parked += 1
        store = self._fwd_store()
        if store is not None:
            store.put(FWD_BUCKET, key,
                      json.dumps({"t": topic, "p": payload.hex()}))

    def drain_parked(self) -> int:
        """Re-send every parked forward on a fresh link (called from
        ClusterManager.on_link_up). Failures re-park with the same
        journal key; the receiver's per-(origin, epoch) msgid dedup
        drops any copy that did land before the partition."""
        items, self.parked = self.parked, deque()
        self._parked_keys.clear()
        n = 0
        for topic, payload, key in items:
            if self.forward(topic, payload, qos=1, park=True,
                            _parked_key=key):
                n += 1
        self.parked_resent += n
        return n

    def _fwd_store(self):
        hook = getattr(self.manager.broker, "_storage_hook", None)
        return None if hook is None else hook.store

    def _journal_delete(self, key: str) -> None:
        store = self._fwd_store()
        if store is not None:
            store.delete(FWD_BUCKET, key)

    def send_session(self, topic: str, payload: bytes,
                     on_ack=None) -> bool:
        """Enqueue one ADR-016 session-federation message. Budget-exempt
        like route control (dropping a session update would silently
        desync the ledger), but sent at QoS1 when ``on_ack`` is given:
        the peer broker's PUBACK is the replication acknowledgement the
        sync barrier couples publisher acks to. ``on_ack(ok)`` runs on
        the loop once the ack lands (or the link dies — ok=False, so a
        barrier never waits on a dead connection's ack)."""
        client = self.client
        if not self.connected or client is None:
            return False
        pid = 0
        if on_ack is not None:
            pid = client._alloc_id()
            fut = client._await_ack(PT.PUBACK, pid)

            def _done(f, cb=on_ack):
                cb(not f.cancelled() and f.exception() is None)

            fut.add_done_callback(_done)
        wire = self._encode_publish(topic, payload,
                                    1 if on_ack is not None else 0,
                                    False, pid)
        try:
            self.outbound.put_nowait(wire, len(wire))
        except asyncio.QueueFull:
            if pid:
                f = client._acks.pop((PT.PUBACK, pid), None)
                if f is not None and not f.done():
                    f.cancel()
            return False
        self.session_sent += 1
        self.items_sent += 1    # ADR 020: audited by the heartbeat
        return True

    def send_control(self, topic: str, payload: bytes,
                     retain: bool = False,
                     counted: bool = True) -> bool:
        """Enqueue a route/control message. Budget-exempt (dropping
        route deltas to save bytes would desync the mesh — the same
        reasoning that exempts acks from the broker's client budgets),
        but still accounted on the ledgers. ``counted=False`` keeps a
        message out of the ADR-020 heartbeat audit — only for the audit
        plane's OWN messages (blip notices), which the receiver equally
        excludes from its mirror count."""
        if not self.connected or self.client is None:
            return False
        wire = self._encode_publish(topic, payload, 0, retain)
        try:
            self.outbound.put_nowait(wire, len(wire))
        except asyncio.QueueFull:
            return False
        self.control_sent += 1
        if counted:
            self.items_sent += 1    # ADR 020: audited by the heartbeat
        return True
