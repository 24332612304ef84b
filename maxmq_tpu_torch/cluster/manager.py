"""ClusterManager: the federation brain wired into one broker (ADR 013).

Copy of the JAX package's ``cluster/manager.py``.

Links N broker processes into one logical broker: outbound
:class:`~.bridge.BridgeLink` per seed peer, an aggregated
:class:`~.routes.RouteTable` answering "which peers need this publish",
and the ``$cluster/*`` inbound dispatch the broker diverts to us from
``process_publish``. Forwarding is route-driven and transitive (a
middle node re-forwards using its own table, so a line topology spans
hops), with three loop-prevention rails proven by the 3-node-cycle
test: an origin-node guard (a node never accepts or forwards its own
publishes back), a hop cap (``cluster_max_hops``), and per-origin
message-id dedup (redundant paths in a cyclic mesh deliver once).

Reserved wire topics (all inside the operator-reserved ``$cluster/#``
namespace; ordinary clients cannot publish ``$`` topics):

* ``$cluster/routes/<node>``          retained compressed snapshot
* ``$cluster/routes/<node>/delta``    incremental add/del, per-link seq
* ``$cluster/sync/<node>``            "resend me your snapshot"
* ``$cluster/fwd/<origin>/<epoch>/<msgid>/<hops>/<flags>/<topic...>``
  forwarded publish: origin node id, origin's boot epoch, per-origin
  monotonic message id, hops traversed, flags = original QoS digit
  (+ ``r`` for retained, + ``t`` when an ADR-017 trace segment
  ``<trace_id>.<t0_ns>`` is inserted before the topic — sent only to
  peers that announced the ``fwd-trace`` capability, so an old binary
  never sees the extra segment), then the original topic verbatim.
  The epoch scopes the dedup window: a restarted origin restarts its
  message ids, and without the epoch every peer would silently drop
  its first window of forwards as replayed duplicates.
* ``$cluster/hello/<node>`` wire-capability announcement (ADR 017),
  sent at link-up; ``$cluster/telemetry/<node>``, ``$cluster/clock/
  <node>[/reply]`` and ``$cluster/trace/<origin>`` are the federated-
  metrics gossip, clock-skew probes and trace span-return legs — all
  handled by :class:`~.telemetry.ClusterTelemetry`.
"""

from __future__ import annotations

import asyncio
import json
import time
from collections import deque

from .. import faults
from ..matching.topics import (filter_matches_topic, parse_share,
                               valid_topic_name)
from ..protocol.codec import FixedHeader, PacketType as PT
from ..protocol.packets import Packet
from .bridge import BRIDGE_ID_PREFIX, BridgeLink
from .membership import Membership, PeerSpec, valid_node_id
from ..filtering.expr import ExprError, compile_expr, decode_payload
from .routes import (RouteTable, RouteWireError, decode_delta,
                     decode_snapshot_preds, encode_delta,
                     encode_snapshot)

DEDUP_WINDOW = 8192     # per-origin forwarded-message-id memory
REHOME_INTENT_TTL_S = 60.0   # how long a deferred takeover-rehome waits
                             # for the winner to advertise the route


class DedupWindow:
    """Bounded per-(origin, boot-epoch) seen-set: admits each message
    id once. The epoch tags which origin incarnation the window
    belongs to — a fresh epoch replaces the window wholesale."""

    __slots__ = ("_seen", "_order", "cap", "epoch")

    def __init__(self, cap: int = DEDUP_WINDOW, epoch: int = 0) -> None:
        self._seen: set[int] = set()
        self._order: deque[int] = deque()
        self.cap = cap
        self.epoch = epoch

    def admit(self, msgid: int) -> bool:
        if msgid in self._seen:
            return False
        self._seen.add(msgid)
        self._order.append(msgid)
        if len(self._order) > self.cap:
            self._seen.discard(self._order.popleft())
        return True


class ClusterManager:
    """Federation state + forwarding policy for one broker process."""

    def __init__(self, broker, node_id: str, peers: list[PeerSpec], *,
                 link_qos: int = 0, max_hops: int = 3,
                 link_byte_budget: int = 4 << 20,
                 keepalive: float = 10.0,
                 backoff_initial_s: float = 0.5,
                 backoff_max_s: float = 30.0,
                 epoch: int | None = None, logger=None,
                 session_replication: bool = True,
                 session_sync: str = "batched",
                 session_sync_timeout_ms: int = 750,
                 session_takeover_timeout_ms: int = 750,
                 fwd_durability: str = "coupled",
                 replica_expiry_s: float = 3600.0,
                 share_balance: str = "weighted",
                 trace_propagation: bool = True,
                 trace_return: bool = True,
                 telemetry_interval_s: float = 5.0,
                 telemetry_full_every: int = 10,
                 rtt_deadline_k: float = 4.0,
                 content_routes: bool = False) -> None:
        if not valid_node_id(node_id):
            raise ValueError(f"bad cluster node id {node_id!r}")
        if any(p.node_id == node_id for p in peers):
            raise ValueError("cluster_peers lists this node itself")
        if fwd_durability not in ("coupled", "always", "chained", "off"):
            raise ValueError(f"unknown cluster_fwd_durability "
                             f"{fwd_durability!r} "
                             f"(want coupled/always/chained/off)")
        if share_balance not in ("weighted", "pin"):
            raise ValueError(f"unknown cluster_share_balance "
                             f"{share_balance!r} (want weighted/pin)")
        self.broker = broker
        self.node_id = node_id
        self.link_qos = min(max(link_qos, 0), 1)
        self.max_hops = max_hops
        self.log = logger
        # ADR 018: cross-node publish durability policy — when active,
        # QoS>0 forwards ride QoS1 on the link, strand-park for
        # retry-after-heal, and (when coupled) the publisher's ack
        # waits on the peers' forward PUBACKs
        self.fwd_durability = fwd_durability
        self.fwd_timeout = max(session_sync_timeout_ms, 1) / 1000.0
        # ADR 022: per-link deadline stretch — every liveness/barrier
        # timeout becomes floor + k x measured RTT (the PeerState EWMA
        # the keepalive-driven clock probes maintain), so a healthy
        # 150ms link never flaps as dead while a truly dead link is
        # still detected at the floor
        self.rtt_deadline_k = max(float(rtt_deadline_k), 0.0)
        # ADR 023 stretch: predicate-annotated routes — snapshots carry
        # the local content plane's fully-gated filter->exprs map, and
        # the forwarder reference-evaluates a peer's annotations to
        # skip forwards its content plane would fully mask. Off by
        # default; purely an optimization (fail open on any doubt).
        self.content_routes = content_routes
        self._pred_cache: dict[str, object] = {}
        self.routes = RouteTable(
            node_id, epoch if epoch is not None
            else int(time.time() * 1000))
        self.routes.shares.balance = share_balance
        self._epoch_pinned = epoch is not None
        self.membership = Membership(peers)
        self._link_kw = dict(node_id=node_id, qos=self.link_qos,
                             byte_budget=link_byte_budget,
                             keepalive=keepalive,
                             backoff_initial_s=backoff_initial_s,
                             backoff_max_s=backoff_max_s)
        self.links: dict[str, BridgeLink] = {
            p.node_id: BridgeLink(self, p, **self._link_kw)
            for p in peers}
        self._seen: dict[str, DedupWindow] = {}
        self._next_msg_id = 0
        self._refresh_pending = False
        self._retry_pending = False
        self._started = False
        # federated sessions (ADR 016): replication + takeover +
        # cluster-wide $share, registered as a broker hook so the
        # QoS/subscription/disconnect events feed replication
        self.sessions = None
        if session_replication:
            from .sessions import SessionFederation
            self.sessions = SessionFederation(
                self, sync=session_sync,
                sync_timeout_ms=session_sync_timeout_ms,
                takeover_timeout_ms=session_takeover_timeout_ms,
                replica_expiry_s=replica_expiry_s)
            broker.add_hook(self.sessions)
        # cluster observability plane (ADR 017): telemetry gossip,
        # clock-skew probes, and the trace span-return leg. Always
        # constructed — skew/trace handling have no periodic cost;
        # telemetry_interval_s = 0 disables only the gossip task.
        self.trace_propagation = trace_propagation
        from .telemetry import ClusterTelemetry
        self.telemetry = ClusterTelemetry(
            self, interval_s=telemetry_interval_s,
            full_every=telemetry_full_every, trace_return=trace_return)

        # counters (read tear-free by the metrics scrape thread)
        self.forwards_delivered = 0     # remote publishes fanned out here
        self.loops_dropped = 0          # origin echo + duplicate path
        self.hops_dropped = 0           # onward forward past the cap
        self.forwards_skipped_down = 0  # target peer's link was down
        self.snapshots_applied = 0
        self.deltas_applied = 0
        self.route_desyncs = 0
        self.route_apply_failures = 0
        self.syncs_sent = 0
        self.inbound_rejected = 0       # malformed/spoofed $cluster wire
        self.content_route_skips = 0    # ADR 023: pred-gated forwards
        # ADR 018: fwd-durability barrier + partition-harness health
        self.fwd_barrier_waits = 0      # publisher acks that waited on
                                        # a cross-node forward PUBACK
        self.fwd_barrier_timeouts = 0   # barriers released by timeout
        self.fwd_barrier_degraded = 0   # barriers released without
                                        # full peer forward durability
        self.fwd_restore_errors = 0     # parked-forward journal rows
                                        # that failed to parse at boot
        self.partition_drops_in = 0     # inbound $cluster messages the
                                        # partition site dropped in flight
        # WAN shaping + RTT-adaptive liveness (ADR 022)
        self.shape_drops_in = 0         # inbound $cluster messages the
                                        # shape's loss draw ate in flight
        self.rtt_adaptive_extended = 0  # deadline computations stretched
                                        # past their floor by k x RTT
        self.fwd_parked_rehomed = 0     # parked forwards re-routed off a
                                        # dead owner's link after an
                                        # epoch-fenced takeover moved the
                                        # subscription (closes the ADR-021
                                        # dead-owner blackhole)
        self._rehome_pending = False
        self._pending_rehomes: list = []  # [dead, winner, filters, deadline]
        # chained multi-hop durability (ADR 020): relay-side upstream
        # PUBACKs held for the downstream forward chain
        self.relay_chain_waits = 0      # relayed fwds whose upstream ack
                                        # waited on the downstream chain
        self.relay_chain_timeouts = 0   # relay waits released degraded
                                        # by the bounded timeout
        # sub-keepalive blip detection (ADR 020): heartbeat-gap resyncs
        self.blip_resyncs = 0           # debounced resyncs triggered by
                                        # a peer's blip notice
        self.blips_detected = 0         # hb seq gaps / item deficits
                                        # seen on inbound links
        # relay route-sync gate (ADR 020): a freshly restarted relay
        # can receive an upstream's parked-forward drain BEFORE the
        # downstream peer's route snapshot arrives — it would fan out
        # to nobody, relay nothing onward, and still ack upstream,
        # losing a PUBACKed message forever. Inbound forwards wait
        # (bounded) until every configured peer's first route
        # advertisement landed; a node with fewer than two peers can
        # never relay and is ready immediately.
        self.route_sync_waits = 0       # inbound fwds held for the
                                        # initial route convergence
        self.route_sync_timeouts = 0    # holds released degraded by
                                        # the bounded timeout
        self._route_synced: set[str] = set()
        self._routes_ready = asyncio.Event()
        if len(self.links) < 2:
            self._routes_ready.set()

    # ------------------------------------------------------------------
    # Lifecycle (driven by Broker.serve / Broker.close)
    # ------------------------------------------------------------------

    async def start(self) -> None:
        if self._started:
            return
        self._started = True
        # adopt the broker's PERSISTED monotonic boot epoch (ADR 014;
        # closes the ADR-013 wall-clock limitation: a clock that steps
        # backwards across a restart can no longer make peers swallow
        # this incarnation's routes/messages as stale replays). Runs
        # before any link starts, so no advertisement has carried the
        # constructor's wall-clock fallback yet. An explicit epoch=
        # constructor arg (tests) stays authoritative.
        boot_epoch = getattr(self.broker, "boot_epoch", 0)
        if boot_epoch and not self._epoch_pinned:
            self.routes.epoch = boot_epoch
        # seed the aggregated local set from pre-existing (restored)
        # subscriptions; everything after flows through note_subscribe
        for filt, _cid, _sub, _group in \
                self.broker.topics.all_subscriptions():
            self._note_filter(filt, add=True, refresh=False)
        if self.sessions is not None:
            # after the epoch adoption above and the broker's own
            # restore: the ledger rebuild must see the final boot epoch
            self.sessions.start()
        self._restore_parked_forwards()
        self.telemetry.start()
        for link in self.links.values():
            link.start()

    def _restore_parked_forwards(self) -> None:
        """ADR 018: reload journal-parked forwards (QoS1 forwards a
        partition stranded before this node crashed/restarted) into
        their links' park buffers — drained at each link-up, deduped
        by the receiver's per-(origin, epoch) msgid window."""
        if not self.fwd_park_active:
            return
        hook = getattr(self.broker, "_storage_hook", None)
        if hook is None:
            return
        from .bridge import FWD_BUCKET, PARKED_MAX
        for key, raw in hook.store.all(FWD_BUCKET).items():
            peer, _, _ident = key.partition("|")
            link = self.links.get(peer)
            if link is None:
                hook.store.delete(FWD_BUCKET, key)  # peer left the
                continue                            # seed list
            try:
                d = json.loads(raw)
                topic, payload = str(d["t"]), bytes.fromhex(d["p"])
            except Exception:
                self.fwd_restore_errors += 1
                hook.store.delete(FWD_BUCKET, key)
                continue
            if len(link.parked) < PARKED_MAX \
                    and key not in link._parked_keys:
                link.parked.append((topic, payload, key))
                link._parked_keys.add(key)

    async def close(self) -> None:
        self._started = False
        if self.sessions is not None:
            self.sessions.close()
        self.telemetry.close()
        for link in self.links.values():
            await link.close()

    def add_peer(self, spec: PeerSpec) -> BridgeLink:
        """Dynamically admit a peer beyond the boot seed list (node
        join): registers it in membership and starts its bridge link.
        Existing peers learn the newcomer's routes transitively."""
        from .membership import PeerState
        if spec.node_id == self.node_id or spec.node_id in self.links:
            raise ValueError(f"peer {spec.node_id!r} already present")
        self.membership.peers[spec.node_id] = PeerState(spec=spec)
        link = BridgeLink(self, spec, **self._link_kw)
        self.links[spec.node_id] = link
        if self._started:
            link.start()
        return link

    def is_bridge_client(self, client) -> bool:
        cid = getattr(client, "id", "")
        return (cid.startswith(BRIDGE_ID_PREFIX)
                and cid[len(BRIDGE_ID_PREFIX):] in self.membership.peers)

    @staticmethod
    def bridge_peer(client) -> str:
        """The peer node id behind a recognized bridge client."""
        return client.id[len(BRIDGE_ID_PREFIX):]

    # ------------------------------------------------------------------
    # Local subscription tracking (called by broker/server.py)
    # ------------------------------------------------------------------

    def note_subscribe(self, filt: str) -> None:
        self._note_filter(filt, add=True)

    def note_unsubscribe(self, filt: str) -> None:
        self._note_filter(filt, add=False)

    def _note_filter(self, filt: str, add: bool,
                     refresh: bool = True) -> None:
        group, inner = parse_share(filt)
        filt = inner if group else filt
        if not filt or filt.startswith("$"):
            return      # $-topics are never federated
        if add:
            changed = self.routes.note_local_subscribe(filt)
        else:
            changed = self.routes.note_local_unsubscribe(filt)
        # under content_routes every subscription change may flip a
        # filter's gating (a plain holder joining a gated filter must
        # un-gate it at the peers) even when the aggregated set is
        # unchanged — the refresh pass diffs annotations per link
        if refresh and (changed or self.content_routes):
            self._schedule_refresh()

    def note_content_change(self) -> None:
        """ADR 023 stretch: the content plane's registry changed —
        re-advertise so peers see the fresh gating annotations."""
        if self.content_routes:
            self._schedule_refresh()

    # ------------------------------------------------------------------
    # Route advertisement (split-horizon deltas, snapshot on link-up)
    # ------------------------------------------------------------------

    def _schedule_refresh(self) -> None:
        """Debounced re-advertisement: one pass per loop turn no matter
        how many subscriptions changed in it."""
        if self._refresh_pending or not self._started:
            return
        self._refresh_pending = True
        loop = getattr(self.broker, "loop", None)
        if loop is None:
            self._refresh_pending = False
            return
        loop.call_soon(self._refresh_advertisements)

    def _refresh_advertisements(self) -> None:
        self._refresh_pending = False
        preds_map = self._content_preds()
        for link in self.links.values():
            if not link.connected:
                continue    # the reconnect snapshot will catch it up
            if link.needs_snapshot:
                self._send_snapshot(link)   # unsent snapshot first: a
                continue                    # delta atop it would gap
            desired = self.routes.advertisement_for(link.peer)
            if preds_map is not None:
                pdes = {f: preds_map[f]
                        for f in desired if f in preds_map}
                if pdes != link.advertised_preds:
                    # deltas never carry annotations (ADR 023): any
                    # gating change rides a full snapshot
                    self._send_snapshot(link)
                    continue
            if desired == link.advertised:
                continue
            add = desired - link.advertised
            rem = link.advertised - desired
            ok = link.send_control(
                f"$cluster/routes/{self.node_id}/delta",
                encode_delta(self.node_id, self.routes.epoch,
                             link.route_seq + 1, add, rem))
            if ok:
                link.route_seq += 1
                link.advertised = desired
            else:
                # a delta we couldn't queue would silently desync the
                # peer: fall back to a full snapshot on this link
                self._send_snapshot(link)

    def _content_preds(self) -> dict[str, list[str]] | None:
        """The local content plane's fully-gated filter->exprs map, or
        None when predicate-annotated routes are off (ADR 023). Only
        LOCAL filters ever carry annotations: transitive routes from
        other peers stay un-annotated, so a relay never gates traffic
        on behalf of a node it cannot see into."""
        if not self.content_routes:
            return None
        cp = getattr(self.broker, "content", None)
        if cp is None:
            return None
        try:
            gated = cp.gated_filters()
        except Exception:
            return None     # fail open: plain, annotation-free routes
        if gated:
            # a remote holder of the same filter string rides our
            # transitive advertisement — its subscribers are not
            # gated by OUR predicates, so the filter must stay plain
            for nr in self.routes.nodes.values():
                for f in nr.filters & gated.keys():
                    gated.pop(f, None)
        return gated

    def _send_snapshot(self, link: BridgeLink) -> bool:
        """Send the full advertisement on one link. ``advertised``/
        ``route_seq`` advance ONLY on a successful enqueue — marking a
        never-sent snapshot as delivered would leave the peer
        routeless while we believe it is caught up; failures mark the
        link and retry shortly."""
        desired = self.routes.advertisement_for(link.peer)
        preds_map = self._content_preds()
        pdes = ({f: preds_map[f] for f in desired if f in preds_map}
                if preds_map is not None else None)
        ok = link.send_control(
            f"$cluster/routes/{self.node_id}",
            encode_snapshot(self.node_id, self.routes.epoch,
                            link.route_seq + 1, desired, preds=pdes),
            retain=True)
        if ok:
            link.route_seq += 1
            link.advertised = desired
            link.advertised_preds = pdes
            link.needs_snapshot = False
        else:
            link.needs_snapshot = True
            self._retry_refresh_later()
        return ok

    def _retry_refresh_later(self) -> None:
        """A failed control enqueue (wedged link queue) retries on a
        short delay instead of spinning the loop turn."""
        loop = getattr(self.broker, "loop", None)
        if loop is None or self._retry_pending:
            return
        self._retry_pending = True

        def fire() -> None:
            self._retry_pending = False
            self._refresh_advertisements()

        loop.call_later(0.1, fire)

    def on_link_up(self, link: BridgeLink) -> None:
        self._send_hello(link)
        self._send_snapshot(link)
        if self.sessions is not None:
            self.sessions.on_link_up(link)
        if self.fwd_park_active:
            # ADR 018: retry the forwards the partition stranded —
            # before new traffic piles in behind them
            link.drain_parked()
        self.telemetry.on_link_up(link)

    def on_link_alive(self, link: BridgeLink) -> None:
        """Keepalive ping round-tripped (bridge.py): refresh the
        ADR-017 clock-skew estimate at the keepalive cadence."""
        self.telemetry.on_link_alive(link)

    # ------------------------------------------------------------------
    # RTT-adaptive deadlines (ADR 022)
    # ------------------------------------------------------------------

    def peer_rtt_s(self, peer: str) -> float:
        """The peer's measured round trip (ADR-017 clock-probe EWMA),
        seconds; 0 until the first probe lands. A DEAD peer keeps its
        last estimate — its deadlines stay stretched by the RTT it had,
        which is exactly the bound a judge should honor."""
        st = self.membership.get(peer)
        if st is None or not st.skew_samples:
            return 0.0
        return st.rtt_ns / 1e9

    def max_rtt_s(self) -> float:
        """The slowest measured peer RTT — the stretch for barriers
        that wait on ALL peers at once (fwd/sync/route-sync gates)."""
        return max((st.rtt_ns for st in self.membership.peers.values()
                    if st.skew_samples), default=0.0) / 1e9

    def link_deadline(self, peer: str | None, floor_s: float) -> float:
        """ADR 022: one liveness/barrier deadline, stretched per link —
        ``floor + k x RTT`` (``peer=None`` takes the slowest peer, for
        whole-mesh barriers). At loopback RTT the k-term is ~0 and
        every deadline is exactly its pre-022 floor; on a 150ms link
        the keepalive ping, blip debounce, willfire grace and barrier
        waits all stretch together, so "slow" stops reading as
        "dead"."""
        rtt = self.max_rtt_s() if peer is None else self.peer_rtt_s(peer)
        ext = self.rtt_deadline_k * rtt
        if ext > 0:
            self.rtt_adaptive_extended += 1
        return floor_s + ext

    def _send_hello(self, link: BridgeLink) -> None:
        """Announce wire capabilities (ADR 017 version negotiation).
        An old peer counts the unknown kind as inbound_rejected and
        carries on; a peer that never heard OUR hello sends us plain
        pre-017 envelopes, which we parse fine."""
        from .telemetry import WIRE_CAPS
        link.send_control(f"$cluster/hello/{self.node_id}",
                          json.dumps({"v": 1,
                                      "caps": list(WIRE_CAPS)}).encode())

    def on_link_down(self, link: BridgeLink, reason: str) -> None:
        # routes are KEPT: a flapping link must not churn the mesh's
        # tables; a peer that actually restarted re-announces with a
        # fresh epoch, which flushes its old routes on arrival
        if self.sessions is not None:
            self.sessions.on_link_down(link)
        if self.log is not None:
            self.log.warn("cluster link down", peer=link.peer,
                          reason=reason)

    # ------------------------------------------------------------------
    # Forwarding decision (called from the broker fan-out, sync)
    # ------------------------------------------------------------------

    @property
    def fwd_park_active(self) -> bool:
        """ADR 018: QoS>0 forwards ride QoS1 on the link and park for
        retry-after-heal when stranded (any ``cluster_fwd_durability``
        but ``off``)."""
        return self.fwd_durability != "off"

    @property
    def fwd_coupled(self) -> bool:
        """ADR 018: the publisher's QoS ack additionally waits (bounded)
        on the peers' forward PUBACKs — ``always``/``chained``, or
        ``coupled`` when ``cluster_session_sync=always`` already couples
        acks to peers."""
        if self.fwd_durability in ("always", "chained"):
            return True
        return (self.fwd_durability == "coupled"
                and self.sessions is not None
                and self.sessions.sync == "always")

    @property
    def fwd_chained(self) -> bool:
        """ADR 020: relays extend the fwd-ack chain hop-by-hop — a relay
        PUBACKs its upstream only after its own onward forwards are
        acked or journal-parked, so the publisher's released PUBACK
        covers the whole route (a 3-node line, not just direct peers).
        Each hop's wait is bounded by ``fwd_timeout``."""
        return self.fwd_durability == "chained"

    def maybe_forward(self, packet: Packet) -> None:
        """Forward one locally fanned-out publish to every peer whose
        advertised routes match (retained messages flood so any future
        remote subscriber finds them), once per peer, guarded by the
        origin/hop rails. Under ADR-018 fwd durability QoS>0 publishes
        ride QoS1 on the link (parked when stranded) and their PUBACK
        futures are collected on the packet for the ack barrier. The
        relay-chain future a chained ``_handle_fwd`` planted (ADR 020)
        is settled on EVERY exit — including the no-target and
        hop-capped early returns — or the relay's bounded upstream-ack
        wait would always run to its timeout."""
        try:
            self._forward_targets(packet)
        finally:
            self._settle_relay(packet)

    def _forward_targets(self, packet: Packet) -> None:
        topic = packet.topic
        if topic.startswith("$"):
            return
        origin, epoch, msgid, via, hops = self._fwd_identity(packet)
        if packet.fixed.retain:
            targets = set(self.links)       # flood retained state
        else:
            targets = set(self.routes.nodes_for(topic))
        targets.discard(origin)
        targets.discard(via)
        if (self.content_routes and targets
                and not packet.fixed.retain):
            targets = self._content_gate(targets, topic, packet)
        if not targets:
            return
        if hops >= self.max_hops:
            self.hops_dropped += 1
            # per-origin stage attribution (ADR 015): a hop-capped drop
            # is explained cross-node loss — the macroday harness
            # asserts no loss is counted ONLY by the aggregate
            tracer = getattr(self.broker, "tracer", None)
            if tracer is not None:
                tracer.note_error("bridge", "hop_cap")
            return
        park = self.fwd_park_active and packet.fixed.qos > 0
        qos = 1 if park else min(packet.fixed.qos, self.link_qos)
        collect = [] if park and self.fwd_coupled else None
        flags = f"{qos}" + ("r" if packet.fixed.retain else "")
        base = f"$cluster/fwd/{origin}/{epoch}/{msgid}/{hops + 1}/"
        envelope = base + flags + "/" + topic
        traced_env = self._traced_envelope(packet, base, flags, topic)
        for node in targets:
            self._forward_to(node, envelope, traced_env, packet, qos,
                             collect, park)
        if collect:
            packet._fwd_waits = collect

    def _content_gate(self, targets: set[str], topic: str,
                      packet: Packet) -> set[str]:
        """ADR 023 stretch: drop forward targets whose EVERY matching
        advertised filter carries predicate annotations none of which
        pass this payload — the peer's content plane would mask every
        delivery anyway. Fail open on any doubt (un-annotated filter,
        compile error, eval error): correctness over savings."""
        obj = None
        decoded = False
        keep = set()
        for node in targets:
            exprs = self.routes.pred_gate(node, topic)
            if exprs is None:
                keep.add(node)
                continue
            if not decoded:
                obj = decode_payload(packet.payload)
                decoded = True
            if self._any_pred_passes(exprs, obj):
                keep.add(node)
            else:
                self.content_route_skips += 1
        return keep

    def _any_pred_passes(self, exprs, obj) -> bool:
        for e in exprs:
            pred = self._pred_cache.get(e)
            if pred is None:
                try:
                    pred = compile_expr(e)
                except ExprError:
                    return True     # un-compilable annotation: fail open
                if len(self._pred_cache) > 512:
                    self._pred_cache.clear()
                self._pred_cache[e] = pred
            try:
                if pred.eval_reference(obj):
                    return True
            except Exception:
                return True
        return False

    def _fwd_identity(self, packet: Packet) -> tuple:
        """(origin, epoch, msgid, via, hops) for one forward — local
        publishes mint a fresh per-origin msgid, relayed ones carry
        theirs verbatim."""
        via = getattr(packet, "_cluster_via", None)
        hops = getattr(packet, "_cluster_hops", 0)
        origin = getattr(packet, "_cluster_origin", None)
        if origin is None:
            self._next_msg_id += 1
            return (self.node_id, self.routes.epoch, self._next_msg_id,
                    via, hops)
        return (origin, packet._cluster_epoch, packet._cluster_msgid,
                via, hops)

    def _forward_to(self, node: str, envelope: str,
                    traced_env: str | None, packet: Packet, qos: int,
                    collect: list | None, park: bool) -> None:
        """Enqueue one forward on one peer's link; a down link counts
        the skip and (under fwd durability) still PARKS the copy for
        the heal — the publish's durability at that peer is pending,
        so a coupled barrier counts the degrade."""
        link = self.links.get(node)
        if link is not None and link.connected:
            ok = link.forward(self._env_for(node, envelope, traced_env),
                              packet.payload, qos=qos, collect=collect,
                              park=park)
            if not ok and collect is not None:
                # parked without an ack future (dead-read-loop window,
                # budget refusal): this release lacks that peer's
                # durability — count the degrade the barrier can't see
                self.fwd_barrier_degraded += 1
            return
        self.forwards_skipped_down += 1
        tracer = getattr(self.broker, "tracer", None)
        if tracer is not None:
            tracer.note_error("bridge", "link_down")
        if park and link is not None:
            link.forward(envelope, packet.payload, qos=1, park=True)
            if collect is not None:
                self.fwd_barrier_degraded += 1

    def fwd_barrier(self, loop, packet: Packet):
        """The ADR-018 cross-node durability barrier for one publish:
        a future resolved once every collected forward PUBACK has
        landed, or after ``fwd_timeout`` (degraded + counted — a
        partitioned peer costs latency once, never a wedged publisher).
        ``None`` when the publish forwarded nowhere or everything is
        already acked."""
        waits = packet.__dict__.pop("_fwd_waits", None)
        if not waits:
            return None
        pending = self._fwd_pending(waits)
        if not pending:
            return None
        self.fwd_barrier_waits += 1
        fut = loop.create_future()
        state = {"n": len(pending)}

        def _one(f) -> None:
            if f.cancelled() or f.exception() is not None:
                self.fwd_barrier_degraded += 1
            state["n"] -= 1
            if state["n"] == 0 and not fut.done():
                fut.set_result(None)

        def _timeout() -> None:
            if not fut.done():
                self.fwd_barrier_timeouts += 1
                self.fwd_barrier_degraded += 1
                fut.set_result(None)

        for f in pending:
            f.add_done_callback(_one)
        # ADR 022: a barrier waits on PUBACKs from every forwarded
        # peer, so its timeout stretches with the slowest measured RTT
        loop.call_later(self.link_deadline(None, self.fwd_timeout),
                        _timeout)
        return fut

    def _settle_relay(self, packet: Packet) -> None:
        """ADR 020 (chained durability): resolve the relay-chain future
        ``_handle_fwd`` planted on a relayed publish once this node's
        own onward forwards are durable. No onward targets (or dedup'd/
        hop-capped copies) resolve immediately; otherwise the standard
        ``fwd_barrier`` — bounded by ``fwd_timeout``, degrades counted —
        is chained into it, so the upstream PUBACK releases exactly when
        a local publisher's would."""
        fut = packet.__dict__.pop("_relay_chain", None)
        if fut is None or fut.done():
            return
        barrier = self.fwd_barrier(fut.get_loop(), packet)
        if barrier is None:
            fut.set_result(None)
            return

        def _done(_f) -> None:
            if not fut.done():
                fut.set_result(None)

        barrier.add_done_callback(_done)

    def _fwd_pending(self, waits: list) -> list:
        """Split one publish's forward-ack futures: already-failed ones
        (refused at enqueue -> parked for retry-after-heal) count a
        degrade NOW — that release lacks peer durability even if
        nothing is left to wait on — and the still-pending rest come
        back for the barrier."""
        failed = sum(1 for f in waits if f.done()
                     and (f.cancelled() or f.exception() is not None))
        if failed:
            self.fwd_barrier_degraded += failed
        return [f for f in waits if not f.done()]

    def _env_for(self, node: str, envelope: str,
                 traced_env: str | None) -> str:
        """Capability gate: only peers that announced ``fwd-trace``
        get the traced envelope (old binaries keep the pre-017 wire)."""
        if traced_env is not None and self._peer_has_cap(node,
                                                         "fwd-trace"):
            return traced_env
        return envelope

    def _traced_envelope(self, packet: Packet, base: str, flags: str,
                         topic: str) -> str | None:
        """ADR 017: when this publish rides a sampled trace (local or
        adopted), capability-negotiated peers get a flag bit + trace
        segment — id + t0 in OUR clock frame, re-translated per hop —
        so the whole line shares one correlation id. Zero cost
        untraced."""
        tracer = self.broker.tracer
        if not (self.trace_propagation
                and (tracer.sample_n or tracer.adopted_open)):
            return None
        tr = packet.__dict__.get("_trace")
        if tr is None:
            return None
        return base + flags + "t/" + f"{tr.id}.{tr.start_ns}/" + topic

    def _peer_has_cap(self, node: str, cap: str) -> bool:
        st = self.membership.get(node)
        return st is not None and cap in st.caps

    # ------------------------------------------------------------------
    # Inbound $cluster/* dispatch (from broker.process_publish)
    # ------------------------------------------------------------------

    async def handle_inbound(self, client, packet: Packet) -> None:
        sender = client.id[len(BRIDGE_ID_PREFIX):]
        levels = packet.topic.split("/")
        kind = levels[1] if len(levels) > 1 else ""
        if kind == "hb" and len(levels) == 3:
            # counted OUTSIDE _cluster_rx on both ends: heartbeats
            # audit the data stream, they are not part of it
            self._handle_hb(client, sender, levels, packet)
            return
        if kind == "blip" and len(levels) == 3:
            self._handle_blip(sender, levels)
            return
        # per-connection inbound data count (ADR 020 blip detection):
        # compared against the sender's enqueue count carried on its
        # next heartbeat — a deficit is sub-keepalive in-flight loss
        client._cluster_rx = getattr(client, "_cluster_rx", 0) + 1
        if kind == "fwd" and len(levels) >= 8:
            await self._handle_fwd(client, sender, levels, packet)
        elif kind == "routes" and len(levels) >= 3:
            self._handle_routes(sender, levels, packet)
        elif kind == "sync" and len(levels) == 3:
            self._handle_sync(levels[2])
        elif (kind == "sess" and len(levels) >= 4
                and self.sessions is not None):
            if levels[2] != sender:
                self.inbound_rejected += 1  # spoofed session message
            else:
                await self.sessions.handle_inbound(sender, levels, packet)
        else:
            self._handle_observability(kind, sender, levels, packet)

    def _handle_observability(self, kind: str, sender: str,
                              levels: list[str], packet: Packet) -> None:
        """The ADR-017 plane's control kinds (hello/clock/telemetry/
        trace) — dispatched to ClusterTelemetry; anything else (or an
        unknown future kind) counts as rejected, exactly the behavior
        an old binary shows our new kinds."""
        if kind == "hello" and len(levels) == 3:
            self._handle_hello(sender, levels, packet)
        elif kind == "clock" and len(levels) >= 3:
            if levels[2] != sender:
                self.inbound_rejected += 1  # spoofed probe identity
            else:
                self.telemetry.handle_clock(sender, levels, packet)
        elif kind == "telemetry" and len(levels) == 3:
            self.telemetry.handle_snapshot(sender, levels, packet)
        elif kind == "trace" and len(levels) == 3:
            self.telemetry.handle_trace(sender, levels, packet)
        else:
            self.inbound_rejected += 1

    def _handle_hb(self, client, sender: str, levels: list[str],
                   packet: Packet) -> None:
        """ADR 020 (sub-keepalive blip detection, receive side): one
        per-link heartbeat — monotonic per-connection seq plus the
        sender's cumulative data-item enqueue count. A seq gap (a
        heartbeat itself was blackholed) or an item deficit (data
        enqueued before this heartbeat never arrived on the FIFO
        stream) means the path dropped bytes WITHOUT flapping the link:
        notify the sender over our own outbound link so it resyncs.
        The count re-baselines to the sender's after a detection — only
        NEW loss re-triggers, so a healed blip costs one notice."""
        if levels[2] != sender:
            self.inbound_rejected += 1      # spoofed identity
            return
        try:
            d = json.loads(packet.payload)
            seq, n_sent = int(d["seq"]), int(d["n"])
        except Exception:
            self.inbound_rejected += 1
            return
        rx = getattr(client, "_cluster_rx", 0)
        last_seq = getattr(client, "_hb_seq", 0)
        client._hb_seq = seq
        if seq > last_seq + 1 or rx < n_sent:
            self.blips_detected += 1
            client._cluster_rx = n_sent     # re-baseline
            link = self.links.get(sender)
            if link is not None and link.connected:
                link.send_control(f"$cluster/blip/{self.node_id}", b"",
                                  counted=False)
            if self.log is not None:
                self.log.warn("cluster blip detected", peer=sender,
                              hb_gap=seq - last_seq - 1,
                              item_deficit=max(n_sent - rx, 0))

    def _handle_blip(self, sender: str, levels: list[str]) -> None:
        """ADR 020 (blip detection, send side): the peer saw a gap on
        OUR link to it — some of what we enqueued vanished in flight
        while the connection stayed up, the loss class a keepalive-
        driven flap can never catch. Debounced per link (one resync per
        keepalive window): fail the pending forward PUBACK futures so
        their park-on-failure callbacks journal the copies, re-snapshot
        the routes, resync sessions, and drain the parked forwards —
        the receiver's per-(origin, epoch) dedup keeps it at-most-once."""
        if levels[2] != sender:
            self.inbound_rejected += 1
            return
        link = self.links.get(sender)
        if link is None:
            return
        now = time.monotonic()
        # ADR 022: the debounce window stretches with the measured link
        # RTT — on a 150ms WAN link a resync's own round trips overlap
        # the next keepalive window, and re-triggering mid-resync reads
        # healthy slowness as repeated loss
        if now - link.last_blip_resync < self.link_deadline(
                sender, link.keepalive):
            return      # debounce: one resync per keepalive window
        link.last_blip_resync = now
        self.blip_resyncs += 1
        client = link.client
        if client is not None:
            from ..mqtt_client import MQTTError
            # ONLY the forward PUBACK futures: a blanket sweep would
            # also fail an in-flight PINGRESP future and the keepalive
            # loop's ping await would tear the link down — the exact
            # flap the resync exists to avoid
            for key in [k for k, f in client._acks.items()
                        if k[0] == PT.PUBACK and not f.done()]:
                fut = client._acks.pop(key)
                fut.set_exception(MQTTError("blip resync"))
        link.needs_snapshot = True
        self._refresh_advertisements()
        if self.sessions is not None:
            self.sessions.on_link_up(link)
        if self.fwd_park_active:
            # the failed acks re-park through done-callbacks the
            # event loop runs via call_soon — defer the drain one
            # loop pass so it sees the re-parked copies, not an
            # empty buffer
            asyncio.get_running_loop().call_soon(link.drain_parked)
        if self.log is not None:
            self.log.warn("cluster blip resync", peer=sender)

    def _handle_hello(self, sender: str, levels: list[str],
                      packet: Packet) -> None:
        """ADR-017 capability announcement: record what wire the peer
        can parse (pre-017 peers never send one and get pre-017
        envelopes forever)."""
        if levels[2] != sender:
            self.inbound_rejected += 1      # spoofed identity
            return
        st = self.membership.get(sender)
        if st is None:
            return
        try:
            caps = json.loads(packet.payload).get("caps") or []
            st.caps = frozenset(str(c) for c in caps)
        except Exception:
            self.inbound_rejected += 1

    async def _handle_fwd(self, client, sender: str, levels: list[str],
                          packet: Packet) -> None:
        try:
            origin, epoch = levels[2], int(levels[3])
            msgid, hops, flags = int(levels[4]), int(levels[5]), levels[6]
            # ADR 018: with fwd durability on, the sender upgrades QoS>0
            # forwards to a QoS1 link leg — honor that here even when
            # link_qos is 0, or the local fan-out silently downgrades
            # the durable copy; still capped at 1 (a peer can never
            # smuggle QoS2 wire through the bridge)
            qos_cap = max(self.link_qos, 1) if self.fwd_park_active \
                else self.link_qos
            qos = min(int(flags[0]), qos_cap)
            retain = "r" in flags
        except (ValueError, IndexError):
            self.inbound_rejected += 1
            return
        trace_ctx = None
        ti = 7
        if "t" in flags:
            trace_ctx = self._parse_fwd_trace(levels)
            if trace_ctx is None:
                self.inbound_rejected += 1
                return
            ti = 8
        topic = "/".join(levels[ti:])
        if topic.startswith("$") or not valid_topic_name(topic):
            # a bridge peer must never smuggle $-state overwrites or
            # wildcard "topics" into the local fan-out/retain store
            self.inbound_rejected += 1
            return
        if origin == self.node_id:
            self.loops_dropped += 1     # our own publish came back
            return
        if not self._admit_fwd(origin, epoch, msgid):
            return
        if not self._routes_ready.is_set() and self.fwd_park_active:
            await self._await_route_sync()
        out = Packet(fixed=FixedHeader(type=PT.PUBLISH, qos=qos,
                                       retain=retain),
                     topic=topic, payload=packet.payload,
                     origin=f"$cluster/{origin}", created=time.time())
        out._cluster_origin = origin
        out._cluster_epoch = epoch
        out._cluster_via = sender
        out._cluster_hops = hops
        out._cluster_msgid = msgid
        if retain:
            self.broker.retain_message(client, out)
        self.forwards_delivered += 1
        relay_fut = None
        if self.fwd_chained and packet.fixed.qos > 0:
            # ADR 020: the upstream sent this leg QoS1 and its barrier
            # counts OUR PUBACK — plant the chain future maybe_forward
            # settles once the onward forwards are acked/parked, and
            # hold the upstream ack (bounded) on it below. Dedup'd
            # duplicates returned above already acked immediately, so
            # a cyclic mesh cannot chain waits into a loop.
            relay_fut = asyncio.get_running_loop().create_future()
            out._relay_chain = relay_fut
        tr = self._adopt_trace(sender, origin, trace_ctx, out, hops)
        try:
            # re-enters the normal local fan-out (order-preserving
            # publish pipeline when a matcher is attached) AND
            # maybe_forward for the onward hop
            await self.broker.publish_to_subscribers(out)
        except BaseException:
            # a raising fan-out/enqueue must still settle the adopted
            # trace or tracer.adopted_open leaks and the stamping
            # gates stay open forever (finish is idempotent, so this
            # is safe even if the pipeline consumer got the packet)
            if tr is not None:
                self.broker.tracer.finish(tr)
            raise
        self._finish_adopted(tr)
        if relay_fut is not None:
            await self._await_relay_chain(relay_fut)

    async def _await_route_sync(self) -> None:
        """ADR 020: hold an inbound forward until this node's FIRST
        route convergence — every configured peer advertised once —
        so a relay restarted mid-heal doesn't apply an upstream's
        parked-forward drain against an empty route table (fan out to
        nobody, ack upstream, PUBACKed message gone). Bounded like the
        relay chain itself; a peer that never comes up degrades the
        gate once, permanently, counted — never a wedge."""
        self.route_sync_waits += 1
        try:
            # ADR 022: convergence needs a round trip per peer — the
            # gate stretches with the slowest measured link RTT
            await asyncio.wait_for(self._routes_ready.wait(),
                                   self.link_deadline(
                                       None, self.fwd_timeout * 2))
        except asyncio.TimeoutError:
            self.route_sync_timeouts += 1
            self._routes_ready.set()

    def _note_route_sync(self, node: str) -> None:
        if self._routes_ready.is_set():
            return
        self._route_synced.add(node)
        if self._route_synced >= set(self.links):
            self._routes_ready.set()

    async def _await_relay_chain(self, relay_fut) -> None:
        """ADR 020: hold the upstream PUBACK for this relayed forward
        until the onward chain settles — bounded by ``fwd_timeout`` on
        top of the barrier's own timeout (pipeline mode fans out from
        the consumer task, so the barrier may not even EXIST yet when
        the inbound handler gets here). A timeout releases the ack
        degraded + counted: the upstream's publisher sees bounded
        latency, never a wedge, and the parked/journaled copies keep
        the retry-after-heal promise."""
        self.relay_chain_waits += 1
        try:
            # ADR 022: the onward hop's PUBACK rides the slowest shaped
            # link — stretch by the mesh's max measured RTT
            await asyncio.wait_for(asyncio.shield(relay_fut),
                                   self.link_deadline(
                                       None, self.fwd_timeout * 2))
        except asyncio.TimeoutError:
            self.relay_chain_timeouts += 1
            self.fwd_barrier_degraded += 1

    def _admit_fwd(self, origin: str, epoch: int, msgid: int) -> bool:
        """Epoch-scoped per-origin dedup (ADR 013): a fresh incarnation
        replaces the window wholesale (its message ids restarted, so
        the old window no longer means "already delivered"); stale
        incarnations and redundant mesh paths are dropped + counted."""
        window = self._seen.get(origin)
        if window is None or epoch > window.epoch:
            window = self._seen[origin] = DedupWindow(epoch=epoch)
        elif epoch < window.epoch:
            self.loops_dropped += 1     # stale incarnation replay
            return False
        if not window.admit(msgid):
            self.loops_dropped += 1     # redundant path in the mesh
            return False
        return True

    def _parse_fwd_trace(self, levels: list[str]) -> tuple | None:
        """ADR-017 trace segment "<trace_id>.<t0_ns>" before the
        topic; the flag bit is capability-negotiated, so it only
        arrives from peers that meant it — malformed is rejected (None
        here), never misread as topic levels."""
        try:
            tid_s, t0_s = levels[7].split(".", 1)
            return (int(tid_s), int(t0_s), self.broker.tracer.clock())
        except (ValueError, IndexError):
            return None

    def _adopt_trace(self, sender: str, origin: str, ctx: tuple | None,
                     out: Packet, hops: int):
        """Open the receiving-node child span chain of a cross-node
        trace (ADR 017): origin's id, start backdated to the origin t0
        translated through the per-peer skew estimate, rooted at a
        ``bridge_in`` span. Also stamps the ``mq-trace`` user property
        so v5 subscriber deliveries (and their log records) carry
        ``<origin>:<id>`` — the cross-node grep key. A None ctx (the
        untraced common case) is a no-op."""
        if ctx is None:
            return None
        tracer = self.broker.tracer
        tid, t0, t_in = ctx
        t0_local = t0 - self.telemetry.skew_ns(sender)
        tr = tracer.adopt(origin, tid, out.topic, out.fixed.qos, hops,
                          min(t0_local, t_in))
        tr.span("bridge_in", t_in, tracer.clock())
        out._trace = tr
        out.properties.user_properties.append(
            ("mq-trace", f"{origin}:{tid}"))
        if self.log is not None:
            # the RECEIVING node's delivered-publish record: one grep
            # of trace=<origin>:<id> correlates every node's logs
            self.log.debug("forward delivered", topic=out.topic,
                           origin=origin, hops=hops,
                           trace=f"{origin}:{tid}")
        return tr

    def _finish_adopted(self, tr) -> None:
        """Synchronous fan-out path: the adopted trace is terminal
        once publish_to_subscribers returned; in pipeline mode the
        consumer's _pub_deliver finishes it after the ordered fan-out
        actually ran (finish is idempotent either way)."""
        if tr is not None and (self.broker.matcher is None
                               or self.broker._pub_consumer is None):
            self.broker.tracer.finish(tr)

    def _handle_routes(self, sender: str, levels: list[str],
                       packet: Packet) -> None:
        node = levels[2]
        if node != sender:
            self.inbound_rejected += 1  # spoofed advertisement
            return
        is_delta = len(levels) >= 4 and levels[3] == "delta"
        try:
            faults.fire(faults.CLUSTER_ROUTE_APPLY)
            if is_delta:
                self._apply_delta(node, packet.payload)
            else:
                self._apply_snapshot(node, packet.payload)
        except (faults.InjectedFault, RouteWireError):
            # a failed SNAPSHOT apply must desync too: the sender has
            # already marked this link caught-up, so without a resync
            # request no delta would ever repair the hole
            self.route_apply_failures += 1
            self._desync(node)

    def _apply_snapshot(self, node: str, payload: bytes) -> None:
        wnode, epoch, seq, filters, preds = \
            decode_snapshot_preds(payload)
        if wnode != node:
            self.inbound_rejected += 1
            return
        if not self.content_routes:
            preds = {}      # ADR 023 off: never gate on annotations
        if self.routes.apply_snapshot(node, epoch, seq, filters,
                                      preds=preds):
            self.snapshots_applied += 1
            self._note_route_sync(node)
            self.membership.note_alive(node)
            st = self.membership.get(node)
            if st is not None:
                st.epoch = epoch
            self._retain_observable(node, payload)
            self._schedule_refresh()    # transitive re-advertisement
            self._schedule_rehome()     # moved subs may strand parks

    def _apply_delta(self, node: str, payload: bytes) -> None:
        wnode, epoch, seq, add, rem = decode_delta(payload)
        if wnode != node:
            self.inbound_rejected += 1
            return
        if self.routes.apply_delta(node, epoch, seq, add, rem):
            self.deltas_applied += 1
            self._note_route_sync(node)
            self.membership.note_alive(node)
            self._schedule_refresh()
            self._schedule_rehome()
        else:
            self._desync(node)

    def _desync(self, node: str) -> None:
        """A delta gap/epoch mismatch: flush what we hold for the node
        (stale routes must not forward) and ask it for a fresh
        snapshot over OUR link to it."""
        self.route_desyncs += 1
        self.routes.flush_node(node)
        self._schedule_refresh()
        link = self.links.get(node)
        if link is not None and link.connected:
            if link.send_control(f"$cluster/sync/{self.node_id}", b""):
                self.syncs_sent += 1

    def _handle_sync(self, requester: str) -> None:
        link = self.links.get(requester)
        if link is not None and link.connected:
            self._send_snapshot(link)

    def _retain_observable(self, node: str, payload: bytes) -> None:
        """Keep the latest applied snapshot retained in the local trie
        so operators can inspect cluster state by subscribing to
        ``$cluster/routes/#`` on any node."""
        self.broker.topics.retain(Packet(
            fixed=FixedHeader(type=PT.PUBLISH, retain=True),
            topic=f"$cluster/routes/{node}", payload=payload,
            origin=f"$cluster/{node}", created=time.time()))

    # ------------------------------------------------------------------
    # Parked-forward rehoming (ADR 022, closes the ADR-021 blackhole)
    # ------------------------------------------------------------------
    #
    # ADR 018 parks a stranded QoS1 forward against the link it was
    # ROUTED to — and ADR 021 documented the hole: if that owner dies
    # for good and an epoch-fenced takeover moves the subscription to
    # a surviving node, the parked copies sit pinned to a link that
    # will never come up, so "PUBACKed => delivered after heal" broke
    # across owner death. The takeover is visible to us as a ROUTE
    # CHANGE (the winner re-advertises the subscription), so every
    # applied snapshot/delta schedules one debounced rehome pass:
    # parked forwards on a DOWN link whose inner topic now routes
    # elsewhere are re-forwarded (or re-parked) against a live routed
    # link. The receiver's per-(origin, epoch) msgid dedup keeps the
    # move at-most-once even if the old owner later heals and the
    # journal had both copies.

    def _schedule_rehome(self) -> None:
        if self._rehome_pending or not self.fwd_park_active:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return      # unit tests applying routes outside a loop
        self._rehome_pending = True
        loop.call_soon(self._rehome_parked)

    def _rehome_parked(self) -> None:
        self._rehome_pending = False
        now = time.monotonic()
        still = []
        for intent in self._pending_rehomes:
            dead, winner, filters, deadline = intent
            if now < deadline and not self._try_rehome(dead, winner,
                                                       filters):
                still.append(intent)
        self._pending_rehomes = still
        for link in list(self.links.values()):
            if not link.connected and link.parked:
                self._rehome_from(link)

    def _rehome_from(self, link) -> None:
        """Move the dead link's strays: every parked forward whose
        inner topic no longer routes to that peer goes to the first
        connected link that IS routed (never the envelope origin — it
        already holds the message). Still-routed or unroutable copies
        stay parked; the old owner may yet heal."""
        kept: deque = deque()
        for topic, payload, key in link.parked:
            parsed = self._fwd_inner_topic(topic)
            target = None
            if parsed is not None:
                origin, inner = parsed
                targets = self.routes.nodes_for(inner)
                if link.peer not in targets:
                    target = self._rehome_target(targets,
                                                 {origin, link.peer})
            if target is None:
                kept.append((topic, payload, key))
                continue
            link._parked_keys.discard(key)
            link._journal_delete(key)
            # the target computes its own peer-prefixed journal key
            target.forward(topic, payload, qos=1, park=True)
            self.fwd_parked_rehomed += 1
        link.parked = kept

    def rehome_for_takeover(self, dead: str, winner: str,
                            filters: list[str]) -> None:
        """The precise rehome: an epoch-fenced takeover moved a session
        off ``dead`` (whose link is down) to ``winner`` — every parked
        forward on the dead link whose inner topic matches one of the
        session's filters is re-sent against the winner's link (same
        envelope, so the receiver's per-(origin, epoch) msgid dedup
        keeps the move at-most-once), or re-injected into the local
        fan-out when the winner is THIS node. Non-matching copies stay
        parked — the dead owner may yet heal and its other subscribers
        still deserve them.

        The move is GATED on the winner advertising a matching route:
        a claim lands before the winner's install (its state pull is
        still in flight), and a copy shipped that early would be
        admitted into the winner's dedup window, fanned out to nobody,
        and lost forever. Until the route shows up the intent parks in
        ``_pending_rehomes`` and retries on every applied route change
        (bounded — an intent the winner never backs expires)."""
        if not self.fwd_park_active or not filters:
            return
        link = self.links.get(dead)
        if link is None or link.connected or not link.parked:
            return
        if not self._try_rehome(dead, winner, list(filters)):
            self._pending_rehomes.append(
                [dead, winner, list(filters),
                 time.monotonic() + REHOME_INTENT_TTL_S])

    def _try_rehome(self, dead: str, winner: str,
                    filters: list[str]) -> bool:
        """One rehome attempt; True = nothing left to wait for (done,
        or the parked set no longer holds a matching copy)."""
        link = self.links.get(dead)
        if link is None or link.connected or not link.parked:
            return True
        local = winner == self.node_id
        target = None
        if not local:
            target = self.links.get(winner)
            if target is None or not target.connected:
                return False
        flevels = [f.split("/") for f in filters]
        kept: deque = deque()
        waiting = False
        moved = 0
        for topic, payload, key in link.parked:
            parsed = self._fwd_inner_topic(topic)
            if parsed is None or not any(
                    filter_matches_topic(fl, parsed[1].split("/"),
                                         False) for fl in flevels):
                kept.append((topic, payload, key))
                continue
            if not local and winner not in self.routes.nodes_for(
                    parsed[1]):
                # the winner has not advertised the subscription yet
                kept.append((topic, payload, key))
                waiting = True
                continue
            link._parked_keys.discard(key)
            link._journal_delete(key)
            if target is not None:
                target.forward(topic, payload, qos=1, park=True)
            else:
                # winner is us: local fan-out reaches the freshly
                # installed subscription (QoS1 at-least-once — a local
                # subscriber that already saw the original publish may
                # see one duplicate; the alternative is PUBACKed loss)
                self._reinject_fwd(topic, payload)
            self.fwd_parked_rehomed += 1
            moved += 1
        link.parked = kept
        if moved and self.log is not None:
            self.log.info("parked forwards rehomed", dead=dead,
                          winner=winner, moved=moved,
                          parked_left=len(kept))
        return not waiting

    def _reinject_fwd(self, envelope: str, payload: bytes) -> None:
        """Replay one parked forward into OUR local fan-out, keeping
        its cluster identity (origin/epoch/msgid) so any onward
        forwarding stays dedup-protected at the receivers."""
        levels = envelope.split("/")
        try:
            origin, epoch, msgid = levels[2], int(levels[3]), \
                int(levels[4])
            hops, flags = int(levels[5]), levels[6]
            qos = min(int(flags[0]), max(self.link_qos, 1))
        except (ValueError, IndexError):
            return
        ti = 8 if "t" in flags else 7
        topic = "/".join(levels[ti:])
        out = Packet(fixed=FixedHeader(type=PT.PUBLISH, qos=qos),
                     topic=topic, payload=payload,
                     origin=f"$cluster/{origin}", created=time.time())
        out._cluster_origin = origin
        out._cluster_epoch = epoch
        out._cluster_via = self.node_id
        out._cluster_hops = hops
        out._cluster_msgid = msgid
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        loop.create_task(self.broker.publish_to_subscribers(out))

    def _rehome_target(self, targets, exclude: set):
        for node in sorted(targets):
            if node in exclude:
                continue
            lk = self.links.get(node)
            if lk is not None and lk.connected:
                return lk
        return None

    @staticmethod
    def _fwd_inner_topic(envelope: str) -> tuple[str, str] | None:
        """``$cluster/fwd/<origin>/<epoch>/<msgid>/<hops>/<flags>/
        [trace/]<topic>`` -> (origin, topic); None for anything that
        isn't a well-formed forward envelope."""
        levels = envelope.split("/")
        if len(levels) < 8 or levels[0] != "$cluster" \
                or levels[1] != "fwd":
            return None
        ti = 8 if "t" in levels[6] else 7
        if len(levels) <= ti:
            return None
        return levels[2], "/".join(levels[ti:])

    # ------------------------------------------------------------------
    # Aggregates for metrics / $SYS
    # ------------------------------------------------------------------

    @property
    def shape_deferrals(self) -> int:
        """ADR 022: outbound items the WAN shape held in a deferral
        queue before the writer released them."""
        return sum(lk.shape_deferrals for lk in self.links.values())

    @property
    def forwards_sent(self) -> int:
        return sum(lk.forwards_sent for lk in self.links.values())

    @property
    def forwards_refused(self) -> int:
        return sum(lk.forwards_refused for lk in self.links.values())

    @property
    def forwards_parked(self) -> int:
        return sum(lk.forwards_parked for lk in self.links.values())

    @property
    def fwd_parked_now(self) -> int:
        return sum(len(lk.parked) for lk in self.links.values())

    @property
    def fwd_parked_dropped(self) -> int:
        return sum(lk.parked_dropped for lk in self.links.values())

    @property
    def fwd_parked_resent(self) -> int:
        return sum(lk.parked_resent for lk in self.links.values())

    @property
    def partition_drops_out(self) -> int:
        return sum(lk.partition_drops for lk in self.links.values())

    @property
    def link_flaps(self) -> int:
        return sum(st.flaps for st in self.membership.peers.values())

    @property
    def connect_attempts(self) -> int:
        return sum(lk.connect_attempts for lk in self.links.values())

    @property
    def links_up(self) -> int:
        return sum(1 for lk in self.links.values() if lk.connected)
