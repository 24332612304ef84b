"""Federated sessions: epoch-safe cross-node session takeover,
cluster-wide ``$share``, and replicated session/inflight state (ADR 016).

ADR 013 federates *publishes* but pins all session state — the
subscriptions, the inflight window, the ``$share`` memberships — to the
node the client happened to connect to. Behind a plain TCP load
balancer that breaks the moment a client reconnects elsewhere or a
node dies. This module closes that gap on top of the existing bridge
links:

* **Replication** — every locally-owned session's metadata
  (subscriptions, session-expiry, ``$share`` memberships, an
  inflight-window digest) and its QoS1/2 inflight records stream to
  bridge peers over the reserved ``$cluster/sess/*`` control
  namespace, relayed transitively (hop-capped, per-origin-epoch
  deduped, exactly like the ADR-013 forward rails) so a line topology
  converges end to end. Received state is journaled through the
  ADR-014 write-behind store (``cluster_sessions`` /
  ``cluster_inflight`` buckets), so a replica survives its holder's
  crash.
* **Epoch-fenced takeover** — a CONNECT at any node claims the session
  with a fencing token ``(session_epoch, boot_epoch, node_id)``,
  compared lexicographically; the highest token wins. ``session_epoch``
  increments on every claim (strictly increasing across takeovers),
  ``boot_epoch`` is the ADR-014 persisted monotonic boot counter (a
  restarted claimant can never be fenced by its own past), and the
  node id breaks exact ties deterministically on every node. The
  losing node disconnects its live client with v5 SessionTakenOver,
  ships its state to the winner (the *pull* leg), and drops its local
  replica. The winner installs subscriptions + parked inflight before
  CONNACK, so the client sees session-present=1 and the parked QoS1/2
  window survives the move.
* **Durability coupling** — with ``cluster_session_sync = always`` the
  publisher's QoS ack rides a *replication barrier* next to the
  ADR-014 journal barrier: the PUBACK releases only once every direct
  peer has acknowledged the inflight-record replication covering the
  publish (bounded by ``cluster_session_sync_timeout_ms``). That is
  what makes "SIGKILL the node, reconnect to a peer, zero PUBACKed
  loss" a property instead of a hope. ``batched`` replicates
  asynchronously (a crash can lose the in-flight window — documented
  in the ADR), ``off`` replicates metadata only.
* **Cluster-wide ``$share``** — memberships feed the
  :class:`~.routes.ShareLedger` in the route table; for every publish
  the lowest node id with live members owns the (group, filter) pick,
  so a group spanning nodes receives each matching publish exactly
  once cluster-wide instead of once per node. The in-process delivery
  pool (broker/workers.py) routes its worker gossip through the same
  ledger class, so pool and cluster ownership compose.

Degradation is first-class (the ADR 011/012/014 shape): a replication
send/apply can be failed or hung via the ``cluster.session_sync``
fault site (keyed per peer), the takeover handoff via
``cluster.takeover`` (keyed per prior owner). A partitioned or lagging
peer (past ``SYNC_LAG_WINDOW`` unacked messages) degrades the
replication barrier to local-only durability, a dead prior owner
degrades the takeover to the local replica (or a fresh session) after
a bounded wait — CONNECT never wedges, and every degrade is counted in
``maxmq_cluster_session_*`` and ``$SYS/broker/cluster/sessions/*``.

Copy of the JAX package's ``cluster/sessions.py``, with two changes of
pace, and none of outcome, for ledgers of 100,000 sessions:

* the dead-owner sweep (``_sweep``) walks the ledger only while some
  peer's link is down. It acts on no entry whose owner's link is up, so
  with every link up the reference's walk of the whole ledger (every
  session of the cluster, every ``REPLICA_SWEEP_S``) does nothing; with
  a link down the walk is the reference's, in its order;
* the per-link resync at link-up (``on_link_up``) ships its messages a
  slice at a time while the link's outbound queue has room and the peer
  has acknowledged all but ``RESYNC_WINDOW`` of them (``RESYNC_SLICE``,
  ``RESYNC_QUEUE_SHARE``). The reference enqueues them all in one call:
  past the queue's bound (``LINK_QUEUE_MAX`` items) the link refuses the
  rest, every refusal schedules a full resync that starts over, and a
  node owning more sessions than the bound never converges its peers'
  ledgers; below the bound, tens of thousands of messages queued ahead
  of the link's keepalive ping hold it past its deadline, and the link
  drops and resyncs again. The messages are the reference's, in its
  order;

and two changes of outcome, repairs of the reference's: a relay for a
link that is down or full is held and sent when the link comes up or has
room, where the reference drops it for good (a line's ends then miss
each other's sessions when the middle node's links come up after an
end's resync reached it); and a replica orders an origin's
messages by the origin's boot epoch and then its seq (``handle_inbound``).
The reference orders them by the seq alone, which starts over when the
origin restarts, so a replica fenced off the restarted owner's inflight
chunks (and its updates of an unchanged token) until the new seqs passed
the old incarnation's: its copy of the window went stale, by an amount
that depends on how many messages the old incarnation had sent.
"""

from __future__ import annotations

import asyncio
import json
import time
from collections import deque

from .. import faults
from ..hooks.base import Hook
from ..hooks.storage import MessageRecord, SubscriptionRecord
from ..matching.topics import parse_share, valid_filter, valid_topic_name
from ..protocol import codes
from ..protocol.codec import FixedHeader, PacketType as PT
from ..protocol.packets import Packet, ProtocolError, Subscription
from .bridge import BRIDGE_ID_PREFIX, LINK_QUEUE_MAX

SESS_WIRE_VERSION = 1
SYNC_POLICIES = ("always", "batched", "off")

# dead-owner lifecycle (ADR 018): sweep cadence for the replica-side
# expiry/will timers, and the base grace between "owner link down" and
# the first judge acting. Judges stagger by rank (lowest live node id
# acts first; the willfire/purge broadcast clears the others before
# their slot), so grace also spaces the ranks.
REPLICA_SWEEP_S = 0.25
WILL_FIRE_GRACE_S = 1.0

# unacked replication messages per peer before it is considered
# LAGGING and excluded from new replication barriers (degraded,
# counted) — replication lag must slow the dashboard, not the broker
SYNC_LAG_WINDOW = 512

# inflight replication ops per wire message (bounds one message's size;
# a resync of a deep parked window ships several)
OPS_PER_MESSAGE = 200

# delay before the per-link resync that heals a refused replication
# send on a live link — long enough for the refusing outbound queue to
# drain, short next to any takeover/barrier timeout
RESYNC_DELAY_S = 0.05

# resync pacing (the port's): owned sessions shipped per loop turn at
# most, and the share of the link's outbound queue (1/RESYNC_QUEUE_SHARE
# of LINK_QUEUE_MAX items) a resync fills before it waits RESYNC_DELAY_S
# for the writer to drain it; the rest stays free for live replication,
# relayed messages and route control
RESYNC_SLICE = 512
RESYNC_QUEUE_SHARE = 4
# resync messages sent and not yet acknowledged by the peer, at most (in
# seqs: the peer's ack target less its acked seq): bounds what a peer has
# to work through ahead of the link's keepalive ping; below
# SYNC_LAG_WINDOW, so a resync alone never marks its peer lagging
RESYNC_WINDOW = 256

# journal buckets for replicated (remote-owned) state
SESS_BUCKET = "cluster_sessions"
INFLIGHT_BUCKET = "cluster_inflight"

# purge tombstones remembered (cid -> last session_epoch) so a session
# RE-CREATED after its purge claims above the old epoch even if a peer
# missed the purge broadcast — without this the stale replica's higher
# token fences the new incarnation forever
TOMBSTONES_MAX = 4096


class SessionEntry:
    """One session as the cluster ledger sees it: who owns it, under
    which fencing token, and the replicated state a takeover installs.
    ``inflight`` (pid -> MessageRecord json) is populated only for
    remote-owned entries — a locally-owned session's inflight lives in
    its :class:`~..broker.client.Client`."""

    __slots__ = ("cid", "owner", "session_epoch", "boot_epoch", "expiry",
                 "expiry_set", "protocol_version", "connected", "subs",
                 "shares", "digest", "will", "inflight", "pubrec",
                 "applied_seq", "infl_seq", "disconnected_seen")

    def __init__(self, cid: str, owner: str, session_epoch: int = 1,
                 boot_epoch: int = 0, expiry: int = 0,
                 expiry_set: bool = False, protocol_version: int = 4,
                 connected: bool = False, subs=None, shares=None,
                 digest=(0, 0), will=None) -> None:
        self.cid = cid
        self.owner = owner
        self.session_epoch = session_epoch
        self.boot_epoch = boot_epoch
        self.expiry = expiry
        self.expiry_set = expiry_set
        self.protocol_version = protocol_version
        self.connected = connected
        # [[filter, qos, no_local, retain_as_published, retain_handling,
        #   identifier], ...]
        self.subs: list = list(subs or [])
        self.shares: list = list(shares or [])   # [[group, filter], ...]
        self.digest = tuple(digest)              # (count, xor of pids)
        # ADR 018 will transfer: [topic, payload_hex, qos, retain,
        # delay_s] while the owner's client is connected with a will —
        # or, once disconnected, while the will sits in the owner's
        # _will_delays countdown with delay_s the REMAINING delay
        # (ADR 019 satellite) plus a 6th element: the absolute
        # wall-clock DEADLINE (ADR 020 satellite), so a judge that
        # applied the entry cold (restart, late resync — no local
        # disconnect observation) still fires on the owner's schedule
        # instead of re-charging the full delay — else None. A replica
        # can fire it if the owner node dies.
        self.will = list(will) if will else None
        self.inflight: dict[int, str] = {}
        self.pubrec: list[int] = []
        # wire seqs of the last applied update / inflight chunk
        # (transient, not serialized): fence same-token messages a
        # redundant relay path delivered out of order
        self.applied_seq = 0
        self.infl_seq = 0
        # local monotonic time we learned the session is disconnected
        # (transient): seeds the replica-side expiry countdown (ADR 018)
        self.disconnected_seen = 0.0

    @property
    def token(self) -> tuple:
        return (self.session_epoch, self.boot_epoch, self.owner)

    def share_keys(self) -> set[tuple[str, str]]:
        return {(g, f) for g, f in self.shares}

    def meta_json(self) -> str:
        return json.dumps({
            "v": SESS_WIRE_VERSION, "cid": self.cid, "owner": self.owner,
            "se": self.session_epoch, "be": self.boot_epoch,
            "exp": self.expiry, "exps": int(self.expiry_set),
            "pv": self.protocol_version, "conn": int(self.connected),
            "subs": self.subs, "shares": self.shares,
            "dig": list(self.digest), "will": self.will})

    @classmethod
    def from_meta_json(cls, raw: str) -> "SessionEntry":
        d = json.loads(raw)
        return cls(str(d["cid"]), str(d["owner"]), int(d["se"]),
                   int(d.get("be", 0)), int(d.get("exp", 0)),
                   bool(d.get("exps", 0)), int(d.get("pv", 4)),
                   bool(d.get("conn", 0)), d.get("subs") or [],
                   d.get("shares") or [], d.get("dig") or (0, 0),
                   d.get("will"))


def _entry_update_dict(entry: SessionEntry) -> dict:
    return {"cid": entry.cid, "se": entry.session_epoch,
            "be": entry.boot_epoch, "exp": entry.expiry,
            "exps": int(entry.expiry_set), "pv": entry.protocol_version,
            "conn": int(entry.connected), "subs": entry.subs,
            "shares": entry.shares, "dig": list(entry.digest),
            "will": entry.will}


class SessionFederation(Hook):
    """Session replication + takeover protocol for one broker, attached
    to its :class:`~.manager.ClusterManager` and registered as a broker
    hook (the QoS/subscription/disconnect events feed replication)."""

    id = "cluster-sessions"

    def __init__(self, manager, *, sync: str = "batched",
                 sync_timeout_ms: int = 750,
                 takeover_timeout_ms: int = 750,
                 replica_expiry_s: float = 3600.0) -> None:
        if sync not in SYNC_POLICIES:
            raise ValueError(f"unknown cluster_session_sync {sync!r} "
                             f"(want one of {SYNC_POLICIES})")
        self.manager = manager
        self.broker = manager.broker
        self.node_id = manager.node_id
        self.sync = sync
        self.sync_timeout = max(sync_timeout_ms, 1) / 1000.0
        self.takeover_timeout = max(takeover_timeout_ms, 1) / 1000.0
        # ADR 018 dead-owner lifecycle: fallback expiry for replicas
        # whose session carries no expiry metadata (0 = never), and the
        # death-detection grace before the elected judge acts
        self.replica_expiry = max(float(replica_expiry_s), 0.0)
        self.will_grace = WILL_FIRE_GRACE_S

        self.ledger: dict[str, SessionEntry] = {}
        self._seen: dict[str, object] = {}      # origin -> DedupWindow
        self._next_seq = 0                      # per-origin message seq
        self._pending_ops: list = []            # inflight replication ops
        self._dirty_cids: set[str] = set()
        self._flush_scheduled = False
        self._peer_acked: dict[str, int] = {}
        # per-peer highest ACK-REQUESTED seq: barriers wait on this, not
        # on _next_seq — claim/purge/state broadcasts are never acked,
        # and a per-link resync's seqs exist only on that link
        self._peer_ack_target: dict[str, int] = {}
        self._peer_send_failed: set[str] = set()
        self._resync_pending: set[str] = set()
        # peer -> generation of its newest resync walk: a link-up or a
        # gap-healing resync supersedes a walk still under way; and the
        # walk waiting to go on (link, cids, next index, generation)
        self._resync_gen: dict[str, int] = {}
        self._resync_waiting: dict[str, tuple] = {}
        # peer -> its ack target when its newest walk began: what was
        # sent before (a dead connection's unacked messages) never holds
        # the walk's window
        self._resync_floor: dict[str, int] = {}
        # peer -> relays held for its link while it was down or full,
        # in order (the port's: the reference drops them)
        self._held_relays: dict[str, deque] = {}
        self._relay_flush_pending: set[str] = set()
        self._sync_barriers: list = []          # [targets, required, fut]
        self._pulls: dict[str, asyncio.Future] = {}
        self._suppress_purge: set[str] = set()
        # cid -> session_epoch at purge (journaled in SESS_BUCKET as a
        # {"tomb": se} row, superseded by any later live entry's put)
        self._tombstones: dict[str, int] = {}
        # per-owner aggregated live $share counts feeding routes.shares
        self._share_counts: dict[str, dict[tuple[str, str], int]] = {}
        self._started = False
        self._started_mono = 0.0
        # wall clock, swappable so scripted-clock tests can drive the
        # replicated will-DEADLINE comparison (ADR 020 satellite)
        self._wall = time.time
        self._expiry_task: asyncio.Task | None = None
        # the port's boot timing (s): the ledger's rebuild from the
        # journal in start(), for the start path's log line
        self.boot_seconds: dict = {}

        # counters (read tear-free by the metrics scrape thread)
        self.takeovers = 0              # remote sessions taken locally
        self.takeovers_degraded = 0     # takeover fell to fresh/replica
        self.takeovers_stale = 0        # pull timed out; replica used
        self.sessions_lost = 0          # local sessions claimed away
        self.state_transfers = 0        # full state handoffs received
        self.claims_rejected = 0        # stale claims fenced off
        self.purges = 0                 # purge broadcasts applied
        self.relays = 0                 # messages relayed onward
        self.sync_flushes = 0
        self.sync_ops = 0               # inflight ops replicated out
        self.sync_acks = 0
        self.sync_degraded = 0          # barriers released undurable
        self.sync_timeouts = 0
        self.sync_faults = 0            # injected session_sync trips
        self.sync_send_failures = 0     # link refused a sess message
        self.sync_resyncs = 0           # live-link gap-healing resyncs
        self.sync_barrier_waits = 0
        self.digest_mismatches = 0      # installed inflight != digest
        self.restore_errors = 0         # journal rows that failed parse
        self.inbound_rejected = 0
        # ADR 018 dead-owner lifecycle
        self.replica_expiries = 0       # orphaned replicas purged by the
                                        # replica-side expiry timer
        self.wills_fired = 0            # transferred wills fired here
                                        # for a dead owner's session
        self.wills_cleared = 0          # replica wills cleared by a
                                        # peer's willfire broadcast
        self.trace_ops_applied = 0      # ADR 017: replicated inflight
                                        # ops that carried trace identity
        self.relays_held = 0            # the port's: relays held for a
        self.relays_dropped = 0         # link down or full; held ones
                                        # dropped past the bound

    # ------------------------------------------------------------------
    # Lifecycle (driven by ClusterManager.start/close)
    # ------------------------------------------------------------------

    def start(self) -> None:
        """Rebuild the ledger from the journal (runs after the broker's
        own restore + boot-epoch bump). Self-owned rows keep only their
        epoch — the broker's restore is authoritative for local state —
        and are marked disconnected until the client returns."""
        self._started = True
        self._started_mono = time.monotonic()
        loop = getattr(self.broker, "loop", None)
        if loop is not None:
            # ADR 018: the dead-owner sweep — replica-side expiry
            # timers + transferred-will firing
            self._expiry_task = loop.create_task(
                self._sweep_loop(), name="cluster-sess-sweep")
        hook = getattr(self.broker, "_storage_hook", None)
        if hook is None:
            return
        t0 = time.perf_counter()
        self._restore_ledger(hook)
        self.boot_seconds["restore"] = time.perf_counter() - t0

    def _restore_ledger(self, hook) -> None:
        for cid, raw in hook.store.all(SESS_BUCKET).items():
            try:
                d = json.loads(raw)
                if "tomb" in d:
                    self._note_tombstone(cid, int(d["tomb"]),
                                         journal=False)
                    continue
                entry = SessionEntry.from_meta_json(raw)
            except Exception:
                self.restore_errors += 1
                continue
            entry.connected = False
            self._apply_entry(entry, journal=False)
        for key, raw in hook.store.all(INFLIGHT_BUCKET).items():
            cid, _, pid = key.rpartition("|")
            entry = self.ledger.get(cid)
            if entry is None or entry.owner == self.node_id:
                continue
            try:
                if pid.startswith("r"):
                    # ADR 018: streamed PUBREC-pending (QoS2 release-
                    # leg dedup) rows ride the same bucket as r<pid>
                    p = int(pid[1:])
                    if p not in entry.pubrec:
                        entry.pubrec.append(p)
                else:
                    entry.inflight[int(pid)] = raw
            except ValueError:
                self.restore_errors += 1

    def close(self) -> None:
        self._started = False
        if self._expiry_task is not None:
            self._expiry_task.cancel()
            self._expiry_task = None
        for b in self._sync_barriers:
            if not b[2].done():
                b[2].set_result(None)
        self._sync_barriers.clear()
        for fut in self._pulls.values():
            if not fut.done():
                fut.cancel()
        self._pulls.clear()
        self._held_relays.clear()

    def stop(self) -> None:            # Hook contract (broker close)
        self.close()

    # ------------------------------------------------------------------
    # Aggregates ($SYS / metrics)
    # ------------------------------------------------------------------

    @property
    def ledger_size(self) -> int:
        return len(self.ledger)

    @property
    def local_sessions(self) -> int:
        return sum(1 for e in self.ledger.values()
                   if e.owner == self.node_id)

    @property
    def share_groups(self) -> int:
        return self.manager.routes.shares.group_count

    @property
    def ack_coupled(self) -> bool:
        """True when QoS acks must ride the replication barrier
        (``cluster_session_sync = always`` with peers configured)."""
        return self.sync == "always" and bool(self.manager.links)

    # ------------------------------------------------------------------
    # $share ownership (consulted by Broker._fan_out_shared)
    # ------------------------------------------------------------------

    def owns_share(self, group: str, filt: str,
                   token: int | None = None) -> bool:
        """``token`` (a per-publish content hash, identical on every
        node) drives the ADR-018 weighted rotation; None falls back to
        lowest-member-id pinning."""
        return self.manager.routes.shares.owns((group, filt), token)

    # ------------------------------------------------------------------
    # CONNECT-side takeover (called by Broker._attach_client)
    # ------------------------------------------------------------------

    def _tracked(self, client) -> bool:
        return (not getattr(client, "inline", False)
                and not client.id.startswith(BRIDGE_ID_PREFIX))

    async def on_local_connect(self, client, session_present: bool) -> bool:
        """Claim the session cluster-wide and, when a peer owned it,
        run the epoch-fenced takeover BEFORE the caller sends CONNACK.
        Bounded: every remote leg degrades on fault/timeout instead of
        wedging the handshake."""
        if not self._tracked(client) or not self.manager.links:
            return session_present
        cid = client.id
        entry = self.ledger.get(cid)
        clean = client.properties.clean_start
        # a re-created session claims ABOVE its purge tombstone: a peer
        # that missed the purge still holds the old epoch, and a fresh
        # epoch-1 claim would be fenced by that stale replica forever
        new_epoch = (entry.session_epoch + 1) if entry is not None \
            else self._tombstones.get(cid, 0) + 1
        remote = entry is not None and entry.owner != self.node_id
        if remote and not clean:
            session_present = await self._traced_takeover(
                client, entry, new_epoch, session_present)
        else:
            self._send_claim(cid, new_epoch, purge=clean)
        self._become_owner(client, new_epoch)
        return session_present

    async def _traced_takeover(self, client, entry: SessionEntry,
                               new_epoch: int,
                               session_present: bool) -> bool:
        """The remote-takeover leg with its ADR-015 span + the
        fresh-session degrade on an injected fault. When sampling is
        on, the takeover rides a full trace whose id travels on the
        claim (ADR 017): the prior owner's state-ship leg reports its
        span back, so one correlated trace shows claim -> remote ship
        -> install."""
        tracer = getattr(self.broker, "tracer", None)
        t0 = tracer.clock() if tracer is not None else 0
        tr = None
        if tracer is not None and tracer.sample_n:
            tr = tracer.sample(f"$takeover/{client.id}", 0, client.id,
                               start_ns=t0)
        try:
            installed = await self._take_over(client, entry, new_epoch,
                                              trace=tr)
            session_present = session_present or installed
            self.takeovers += 1
        except faults.InjectedFault:
            # fresh session + counted loss, never a wedged CONNECT
            self.takeovers_degraded += 1
            if tracer is not None:
                tracer.note_error("takeover", "fault")
        except Exception:
            # same contract for anything a peer's replica can throw at
            # the handoff (malformed state, a codec bug): the client
            # gets a fresh session, the CONNECT never fails over it
            self.takeovers_degraded += 1
            if tracer is not None:
                tracer.note_error("takeover", "error")
        if tracer is not None:
            now = tracer.clock()
            tracer.observe("takeover", (now - t0) / 1e9)
            if tr is not None:
                tr.span("takeover", t0, now)
                tracer.finish(tr, now)
        return session_present

    async def _take_over(self, client, entry: SessionEntry,
                         new_epoch: int, trace=None) -> bool:
        """One remote takeover: claim (with pull), wait bounded for the
        prior owner's state handoff, install the freshest copy we hold.
        ``cluster.takeover`` fault site keyed by the prior owner."""
        cid, owner = entry.cid, entry.owner
        hit = faults.fire_detail(faults.CLUSTER_TAKEOVER, key=owner)
        if hit is not None:
            if hit[0] == "hang":
                await asyncio.sleep(hit[1])
            else:   # drop: the handoff path is unusable this time —
                # still claim ownership, then degrade through the same
                # except-branch as raise mode so the takeovers /
                # takeovers_degraded counters agree across fault modes
                self._send_claim(cid, new_epoch, purge=False)
                raise faults.InjectedFault(faults.CLUSTER_TAKEOVER)
        fut = self.broker.loop.create_future()
        self._pulls[cid] = fut
        try:
            self._send_claim(cid, new_epoch, pull=True, trace=trace)
            if any(lk.connected for lk in self.manager.links.values()):
                try:
                    # ADR 022: the pull round-trips the prior owner's
                    # link — stretch by the mesh's max measured RTT so
                    # a WAN roam doesn't absorb stale replica state
                    state = await asyncio.wait_for(
                        asyncio.shield(fut),
                        self.manager.link_deadline(
                            None, self.takeover_timeout))
                    self._absorb_state_into(entry, state)
                except (asyncio.TimeoutError, TimeoutError):
                    # dead/partitioned prior owner: the replicated
                    # ledger copy is the best state that exists
                    self.takeovers_stale += 1
        finally:
            # a concurrent takeover for the same cid (double-CONNECT on
            # this node) may have replaced the waiter — pop only our own
            if self._pulls.get(cid) is fut:
                del self._pulls[cid]
            if not fut.done():
                fut.cancel()
        self._install(client, entry)
        # ADR 022: WE are the winner — parked forwards pinned to the
        # dead prior owner's link for this session's topics re-enter
        # the local fan-out the install just wired up
        link = self.manager.links.get(owner)
        if link is not None and not link.connected and entry.subs:
            self.manager.rehome_for_takeover(
                owner, self.node_id,
                [str(rec[0]) for rec in entry.subs if rec])
        return bool(entry.subs) or bool(entry.inflight)

    def _absorb_state_into(self, entry: SessionEntry, d: dict) -> None:
        """Fold a state handoff into the entry about to be installed
        (fresher than the asynchronously-replicated ledger copy)."""
        entry.subs = d.get("subs") or entry.subs
        entry.digest = tuple(d.get("dig") or entry.digest)
        infl = d.get("infl") or {}
        for pid, raw in infl.items():
            entry.inflight[int(pid)] = raw
        entry.pubrec = [int(p) for p in d.get("pubrec") or []]
        self.state_transfers += 1

    def _install(self, client, entry: SessionEntry) -> None:
        """Materialize the replicated session on this node: trie
        subscriptions (advertised to peers), parked inflight into the
        client's window, QoS2 dedup set — and persist it all through
        OUR storage hook, because this node now owes it durability."""
        broker = self.broker
        hook = getattr(broker, "_storage_hook", None)
        cid = client.id
        for rec in entry.subs:
            try:
                filt = str(rec[0])
                if not valid_filter(filt):
                    continue  # a peer must not smuggle junk in the trie
                sub = Subscription(
                    filter=filt, qos=int(rec[1]), no_local=bool(rec[2]),
                    retain_as_published=bool(rec[3]),
                    retain_handling=int(rec[4]), identifier=int(rec[5]))
            except (IndexError, ValueError, TypeError):
                self.restore_errors += 1
                continue    # a malformed replicated row degrades to a
                            # skipped subscription, never a failed CONNECT
            if broker.topics.subscribe(cid, sub):
                broker.info.subscriptions += 1
                self.manager.note_subscribe(filt)
            client.subscriptions[filt] = sub
            if hook is not None:
                hook.store.put(
                    "subscriptions", f"{cid}|{filt}",
                    SubscriptionRecord(
                        client_id=cid, filter=filt, qos=sub.qos,
                        no_local=sub.no_local,
                        retain_as_published=sub.retain_as_published,
                        retain_handling=sub.retain_handling,
                        identifier=sub.identifier).to_json())
        self._install_inflight(client, entry, hook)
        client.pubrec_inbound.update(entry.pubrec)
        if entry.digest and tuple(entry.digest) != client.inflight.digest():
            self.digest_mismatches += 1
        # the replicated copy's journal rows moved into the live
        # buckets above; drop the remote-owned shadow
        if hook is not None:
            hook.store.delete_prefix(INFLIGHT_BUCKET, cid + "|")

    def _install_inflight(self, client, entry: SessionEntry,
                          hook) -> None:
        """Materialize the replicated window into the live client:
        parked messages enter the inflight dict (re-journaled under the
        live bucket), quota-parked (held) records re-park in held_pids
        (ADR 018 — resend skips them, _release_held drains them under
        the receive window)."""
        broker = self.broker
        cid = client.id
        for pid in sorted(entry.inflight):
            raw = entry.inflight[pid]
            try:
                rec = MessageRecord.from_json(raw)
                packet = rec.to_packet()
            except Exception:
                self.restore_errors += 1
                continue
            # resend encodes with the packet's own version: it must
            # match the session's protocol or a v5 client reads a v4
            # wire (no properties block) as malformed
            packet.protocol_version = client.properties.protocol_version
            if client.inflight.set(packet):
                broker.info.inflight += 1
            if rec.held:
                client.held_pids.append(pid)
            if hook is not None:
                hook.store.put("inflight", f"{cid}|{pid}", raw)
                client.inflight.note_stored(pid)

    def _become_owner(self, client, epoch: int) -> None:
        entry = self._entry_from_client(client, epoch, connected=True)
        clean = client.properties.clean_start
        if clean:
            # a clean start discards the replicated shadow window too:
            # peers purge via the claim's purge flag, this is OUR copy
            # (or a later double-failover resurrects pre-clean parked
            # messages the client asked to forget)
            hook = getattr(self.broker, "_storage_hook", None)
            if hook is not None:
                hook.store.delete_prefix(INFLIGHT_BUCKET,
                                         client.id + "|")
        self._apply_entry(entry, keep_inflight=not clean)
        self._mark_dirty(client.id)

    @staticmethod
    def _subs_shares(client) -> tuple[list, list]:
        """A live client's replicated subscription rows + ``$share``
        keys — ONE shape for the replication and state-pull legs."""
        subs, shares = [], []
        for filt, sub in client.subscriptions.items():
            subs.append([filt, sub.qos, int(sub.no_local),
                         int(sub.retain_as_published),
                         sub.retain_handling, sub.identifier or 0])
            group, _inner = parse_share(filt)
            if group:
                shares.append([group, filt])
        return subs, shares

    def _entry_from_client(self, client, epoch: int,
                           connected: bool) -> SessionEntry:
        subs, shares = self._subs_shares(client)
        p = client.properties
        will = None
        if connected and p.will is not None and p.will.topic:
            # ADR 018 will transfer: the will rides the replicated
            # metadata while the client is live, so a replica can fire
            # it if this whole node dies. A disconnect (normal close
            # fired/discarded it locally, abnormal close fired it
            # locally) replicates will=None — peers stand down.
            will = [p.will.topic, p.will.payload.hex(),
                    int(p.will.qos), int(p.will.retain),
                    float(p.will_delay or 0)]
        elif not connected:
            # ADR 019 (satellite): a will-delay-parked will is STILL
            # pending on this owner (_queue_will parked it before the
            # disconnect hook fired), so it must keep riding the
            # replicated entry with its REMAINING delay — an owner
            # dying mid-countdown used to lose the will cluster-wide.
            # The judge resumes the countdown from disconnected_seen;
            # the owner's own local fire replicates the stand-down
            # (on_will_sent below).
            parked = self.broker._will_delays.get(client.id)
            if parked is not None:
                due, wp = parked
                # 6th element (ADR 020 satellite): the ABSOLUTE
                # wall-clock deadline, so a cold-applied replica fires
                # on schedule instead of re-charging the duration
                will = [wp.topic, wp.payload.hex(), int(wp.fixed.qos),
                        int(wp.fixed.retain),
                        max(due - self._wall(), 0.0), float(due)]
        return SessionEntry(
            client.id, self.node_id, epoch, self.broker.boot_epoch,
            p.session_expiry, p.session_expiry_set, p.protocol_version,
            connected, subs, shares, client.inflight.digest(), will)

    # ------------------------------------------------------------------
    # Hook events (replication feed; the broker calls these)
    # ------------------------------------------------------------------

    def on_subscribed(self, client, packet, reason_codes, counts) -> None:
        self._note_client(client)

    def on_unsubscribed(self, client, packet) -> None:
        self._note_client(client)

    def on_disconnect(self, client, err, expire: bool) -> None:
        if not expire:      # expiry rides the purge path instead
            self._note_client(client, connected=False)

    def on_will_sent(self, client, packet) -> None:
        """ADR 019 (satellite): the owner's own will fired locally —
        including a delayed will whose _will_delays countdown just
        elapsed, where the client object is already gone. Clear the
        replicated copy and broadcast the stand-down, or a judge
        sweeping this node's later death would fire the will a second
        time from the stale entry."""
        cid = getattr(packet, "origin", "")
        if not cid:
            return
        entry = self.ledger.get(cid)
        if entry is None or entry.owner != self.node_id \
                or entry.will is None:
            return
        entry.will = None
        hook = getattr(self.broker, "_storage_hook", None)
        if hook is not None:
            hook.store.put(SESS_BUCKET, entry.cid, entry.meta_json())
        if self.manager.links:
            self._mark_dirty(cid)

    def on_qos_publish(self, client, packet, sent: float,
                       resends: int) -> None:
        if resends or self.sync == "off" or not self._tracked(client) \
                or not self.manager.links:
            return
        rec = MessageRecord.from_packet(packet, client.id)
        if packet.packet_id in getattr(client, "held_pids", ()):
            # ADR 018 (satellite): quota-parked held-but-unsent state
            # replicates, so a takeover re-parks instead of resending
            # past the client's receive maximum (or dropping it)
            rec.held = True
        op = [client.id, packet.packet_id, "set", rec.to_json()]
        # ADR 017: a sampled publish's replication op carries its trace
        # identity (stamped on the delivery copy by _build_outbound) so
        # the REPLICA side can correlate; zero cost untraced
        ref = packet.__dict__.get("_trace_ref")
        if ref is not None:
            op.append(list(ref))
        self._note_op(op)

    def on_qos_complete(self, client, packet) -> None:
        self._note_del(client, packet)

    def on_qos_dropped(self, client, packet) -> None:
        self._note_del(client, packet)

    def _note_del(self, client, packet) -> None:
        if self.sync == "off" or not self._tracked(client) \
                or not self.manager.links:
            return
        self._note_op([client.id, packet.packet_id, "del"])

    def note_pubrec(self, client, pid: int, add: bool) -> None:
        """ADR 018 (satellite): stream broker-side inbound PUBREC-
        pending changes (the QoS2 release-leg dedup set) as inflight
        ops instead of the pull-only transfer — a dead-owner failover
        keeps the receiver-side dedup set, so a publisher retrying
        PUBLISH/PUBREL against the new owner is deduped, not
        redelivered."""
        if self.sync == "off" or not self._tracked(client) \
                or not self.manager.links:
            return
        self._note_op([client.id, pid, "rec" if add else "recdel"])

    def _note_client(self, client, connected: bool | None = None) -> None:
        if not self._tracked(client) or not self.manager.links:
            return
        entry = self.ledger.get(client.id)
        if entry is None or entry.owner != self.node_id:
            return
        live = not client.closed if connected is None else connected
        self._apply_entry(self._entry_from_client(
            client, entry.session_epoch, connected=live))
        self._mark_dirty(client.id)

    def note_purge(self, cid: str) -> None:
        """Called by Broker._purge_session: the session expired or was
        cleanly discarded — remove the ledger entry and tell the
        cluster (suppressed while a takeover-away is mid-transfer)."""
        if cid in self._suppress_purge:
            return
        entry = self.ledger.get(cid)
        if entry is None or entry.owner != self.node_id:
            return
        self._remove_entry(cid)
        self._note_tombstone(cid, entry.session_epoch)
        if self.manager.links:
            self._broadcast("purge", {"cid": cid, "se": entry.session_epoch,
                                      "be": entry.boot_epoch})

    def _note_tombstone(self, cid: str, epoch: int,
                        journal: bool = True) -> None:
        """Remember a purged session's last epoch (bounded, journaled):
        the purge broadcast is fire-and-forget and resyncs replay only
        live sessions, so a re-created session must claim ABOVE the old
        epoch or a peer's missed-purge replica fences it forever."""
        while len(self._tombstones) >= TOMBSTONES_MAX:
            self._tombstones.pop(next(iter(self._tombstones)))
        self._tombstones[cid] = max(self._tombstones.get(cid, 0), epoch)
        if journal:
            hook = getattr(self.broker, "_storage_hook", None)
            if hook is not None:
                hook.store.put(SESS_BUCKET, cid, json.dumps(
                    {"v": SESS_WIRE_VERSION, "tomb": epoch}))

    # ------------------------------------------------------------------
    # Ledger bookkeeping (+ $share counts + journal)
    # ------------------------------------------------------------------

    def _apply_entry(self, entry: SessionEntry, journal: bool = True,
                     keep_inflight: bool = True) -> None:
        """Install/replace one ledger entry (always a FRESH object —
        in-place mutation would corrupt the share-count diff below).
        ``keep_inflight`` carries the old replicated inflight window
        forward (metadata updates don't restate it); purge paths pass
        False."""
        self._tombstones.pop(entry.cid, None)   # a live entry supersedes
        old = self.ledger.get(entry.cid)
        if not entry.connected:
            # seed/carry the replica-expiry countdown (ADR 018): the
            # clock starts when we FIRST see the session disconnected
            # and survives metadata refreshes; any connected update
            # resets it (the returning owner/client wins)
            entry.disconnected_seen = (
                old.disconnected_seen
                if old is not None and not old.connected
                and old.disconnected_seen else time.monotonic())
        if old is not None:
            assert old is not entry, "ledger entries are replaced, not mutated"
            if keep_inflight and not entry.inflight:
                entry.inflight = old.inflight
                if old.owner == entry.owner:
                    # seqs are PER-ORIGIN: carrying the old owner's
                    # fence across a takeover would drop every chunk
                    # from the new owner until its counter caught up
                    entry.infl_seq = old.infl_seq
            self._share_account(old, -1)
        self.ledger[entry.cid] = entry
        self._share_account(entry, +1)
        if journal:
            hook = getattr(self.broker, "_storage_hook", None)
            if hook is not None:
                hook.store.put(SESS_BUCKET, entry.cid, entry.meta_json())

    def _remove_entry(self, cid: str) -> None:
        entry = self.ledger.pop(cid, None)
        if entry is None:
            return
        self._share_account(entry, -1)
        hook = getattr(self.broker, "_storage_hook", None)
        if hook is not None:
            hook.store.delete(SESS_BUCKET, cid)
            hook.store.delete_prefix(INFLIGHT_BUCKET, cid + "|")

    def _share_account(self, entry: SessionEntry, sign: int) -> None:
        if not entry.connected or not entry.shares:
            return
        counts = self._share_counts.setdefault(entry.owner, {})
        shares = self.manager.routes.shares
        for key in entry.share_keys():
            n = counts.get(key, 0) + sign
            if n > 0:
                counts[key] = n
            else:
                counts.pop(key, None)
                n = 0
            shares.set_member(entry.owner, key, n)

    # ------------------------------------------------------------------
    # Outbound wire (broadcast + transitive relay over bridge links)
    # ------------------------------------------------------------------

    def _send_claim(self, cid: str, epoch: int, purge: bool = False,
                    pull: bool = False, trace=None) -> None:
        d = {"cid": cid, "se": epoch, "be": self.broker.boot_epoch,
             "purge": int(purge), "pull": int(pull)}
        if trace is not None:
            # ADR 017: the takeover trace's identity travels with the
            # claim so the prior owner's ship leg can report its span
            # back to this (origin) node
            d["tr"] = [self.node_id, trace.id]
        self._broadcast("claim", d)

    def _envelope(self, d: dict, to: str | None = None) -> dict:
        """One ``$cluster/sess`` wire envelope (bumps the per-origin
        seq — every envelope built is considered sent)."""
        self._next_seq += 1
        msg = {"v": SESS_WIRE_VERSION, "o": self.node_id,
               "e": self.broker.boot_epoch, "q": self._next_seq,
               "h": 1, "d": d}
        if to is not None:
            msg["to"] = to
        return msg

    def _broadcast(self, kind: str, d: dict, to: str | None = None,
                   ack: bool = False) -> int:
        msg = self._envelope(d, to)
        payload = json.dumps(msg).encode()
        topic = f"$cluster/sess/{self.node_id}/{kind}"
        for link in self.manager.links.values():
            self._send_to_link(link, topic, payload,
                               msg["q"] if ack else None)
        return msg["q"]

    def _send_to_link(self, link, topic: str, payload: bytes,
                      ack_seq: int | None) -> None:
        peer = link.peer
        if ack_seq is not None:
            # raise the peer's barrier target even when the message
            # ends up dropped/faulted: a barrier must then time out
            # (degraded, counted), never pass against a stale target
            self._peer_ack_target[peer] = ack_seq
        try:
            hit = faults.fire_detail(faults.CLUSTER_SESSION_SYNC, key=peer)
        except faults.InjectedFault:
            self.sync_faults += 1
            return
        if hit is not None:
            mode, delay = hit
            self.sync_faults += 1
            if mode == "hang" and self.broker.loop is not None:
                self.broker.loop.call_later(
                    delay, self._deliver_to_link, link, topic, payload,
                    ack_seq)
            return      # drop (and hang delivers late, out of band)
        self._deliver_to_link(link, topic, payload, ack_seq)

    def _deliver_to_link(self, link, topic: str, payload: bytes,
                         ack_seq: int | None) -> None:
        peer = link.peer
        on_ack = None
        if ack_seq is not None:
            def on_ack(ok, p=peer, s=ack_seq):
                self._on_sync_ack(p, s, ok)
        if link.send_session(topic, payload, on_ack=on_ack):
            self._peer_send_failed.discard(peer)
        else:
            self.sync_send_failures += 1
            self._peer_send_failed.add(peer)
            # the peer's replica now has a GAP that later acks would
            # silently mask (acks are a high-watermark) — heal it with
            # a debounced full per-link resync once the queue drains
            self._schedule_resync(link)

    def _relay(self, kind: str, msg: dict, exclude: set[str]) -> None:
        """Pass a peer's message on to our other peers (hop-capped). A
        relay for a link that is down, or whose queue holds half its
        bound, or behind relays held before it, is held and sent when the
        link comes up or has room (``_hold_relay``)."""
        if msg["h"] >= self.manager.max_hops:
            return
        out = dict(msg)
        out["h"] = msg["h"] + 1
        payload = json.dumps(out).encode()
        topic = f"$cluster/sess/{self.node_id}/{kind}"
        sent = False
        for peer, link in self.manager.links.items():
            if peer in exclude:
                continue
            if (peer in self._held_relays or not link.connected
                    or link.outbound.qsize() >= LINK_QUEUE_MAX // 2):
                self._hold_relay(link, topic, payload)
            else:
                self._send_to_link(link, topic, payload, None)
            sent = True
        if sent:
            self.relays += 1

    def _hold_relay(self, link, topic: str, payload: bytes) -> None:
        """Hold one relay for ``link``, in order behind those held before
        it (the oldest dropped past ``LINK_QUEUE_MAX`` held), until
        ``_flush_relays`` sends it. The reference drops it: a relay is
        sent once and no resync replays it, so the peer's replica of a
        third node's session missed that message for good (F23)."""
        held = self._held_relays.setdefault(link.peer, deque())
        if len(held) >= LINK_QUEUE_MAX:
            held.popleft()
            self.relays_dropped += 1
        held.append((topic, payload))
        self.relays_held += 1
        self._schedule_relay_flush(link.peer)

    def _schedule_relay_flush(self, peer: str) -> None:
        loop = getattr(self.broker, "loop", None)
        if (loop is not None and self._started
                and peer not in self._relay_flush_pending):
            self._relay_flush_pending.add(peer)
            loop.call_later(RESYNC_DELAY_S, self._flush_relays, peer)

    def _flush_relays(self, peer: str) -> None:
        """Send ``peer``'s held relays, in order, while its link is up and
        its queue under half its bound; what is left waits for the next
        flush (a timer, or the link coming up)."""
        self._relay_flush_pending.discard(peer)
        held = self._held_relays.get(peer)
        link = self.manager.links.get(peer)
        if not held or link is None:
            self._held_relays.pop(peer, None)
            return
        if not link.connected:
            return          # on_link_up flushes
        while held and link.outbound.qsize() < LINK_QUEUE_MAX // 2:
            topic, payload = held.popleft()
            self._send_to_link(link, topic, payload, None)
        if held:
            self._schedule_relay_flush(peer)
        else:
            del self._held_relays[peer]

    # ------------------------------------------------------------------
    # Replication batching + the ack-coupled sync barrier
    # ------------------------------------------------------------------

    def _note_op(self, op: list) -> None:
        self._pending_ops.append(op)
        self.sync_ops += 1
        self._schedule_flush()

    def _mark_dirty(self, cid: str) -> None:
        self._dirty_cids.add(cid)
        self._schedule_flush()

    def _schedule_flush(self) -> None:
        if self._flush_scheduled or not self._started:
            return
        loop = getattr(self.broker, "loop", None)
        if loop is None:
            return
        self._flush_scheduled = True
        loop.call_soon(self._flush)

    def _flush(self) -> None:
        """Drain pending session updates + inflight ops onto the wire
        (one debounced pass per loop turn; the ack-coupled barrier
        flushes eagerly so its target seq is known)."""
        # ADR 024 crash point: replication accepted and debounced but
        # not yet on the wire — a node dying here is the widest
        # replica-lag window a single loop turn can leave
        faults.crash_point("replica_flush")
        self._flush_scheduled = False
        if self._dirty_cids:
            for cid in list(self._dirty_cids):
                entry = self.ledger.get(cid)
                if entry is not None and entry.owner == self.node_id:
                    self._broadcast("up", _entry_update_dict(entry),
                                    ack=True)
            self._dirty_cids.clear()
            self.sync_flushes += 1
        digests = self._flush_digests()
        while self._pending_ops:
            chunk = self._pending_ops[:OPS_PER_MESSAGE]
            del self._pending_ops[:OPS_PER_MESSAGE]
            cids = {op[0] for op in chunk}
            self._broadcast(
                "infl",
                {"ops": chunk,  # only THIS chunk's digests ride along
                 "dig": {c: d for c, d in digests.items() if c in cids}},
                ack=True)
            self.sync_flushes += 1
        self._check_barriers()

    def _flush_digests(self) -> dict:
        """Flush-time digests ride WITH the ops so a replica's digest
        tracks the window it actually holds (a digest only refreshed by
        metadata updates would go stale as parked messages accumulate
        and trip the install check spuriously)."""
        digests: dict = {}
        for op in self._pending_ops:
            cid = op[0]
            if cid not in digests:
                cl = self.broker.clients.get(cid)
                if cl is not None:
                    digests[cid] = list(cl.inflight.digest())
        return digests

    def sync_barrier(self, loop) -> asyncio.Future | None:
        """A future resolved once every reachable direct peer has acked
        the replication covering everything enqueued so far, or
        ``None`` when no wait is required (policy, no reachable peers —
        degraded and counted — or everything already acked). Bounded by
        ``sync_timeout``: a peer that stops acking costs latency, not a
        wedged publisher."""
        if self.sync != "always":
            return None
        if self._pending_ops or self._dirty_cids:
            self._flush()
        required = self._barrier_required()
        if not required:
            return None
        # each peer waits on its OWN last ack-requested seq — never on
        # _next_seq, which also counts unacked claim/purge/state
        # broadcasts and other links' resync messages that this peer
        # can never ack (a barrier against those would always time out)
        targets = {p: self._peer_ack_target.get(p, 0) for p in required}
        if all(self._peer_acked.get(p, 0) >= targets[p]
               for p in required):
            return None
        fut = loop.create_future()
        self._sync_barriers.append([targets, required, fut])
        self.sync_barrier_waits += 1
        # ADR 022: replication acks ride the slowest shaped link —
        # the barrier timeout stretches with the mesh's max RTT
        loop.call_later(
            self.manager.link_deadline(None, self.sync_timeout),
            self._barrier_timeout, fut)
        return fut

    def _barrier_required(self) -> set[str]:
        """The peers a fresh sync barrier must wait on: connected, not
        lagging, no refused send outstanding. Excluding ANY configured
        peer is a degrade (down, lagging, or refused a send) even when
        other peers still cover the release — the operator must see it."""
        required = {p for p, lk in self.manager.links.items()
                    if lk.connected and p not in self._peer_send_failed
                    and not self._peer_lagging(p)}
        if len(required) < len(self.manager.links):
            self.sync_degraded += 1
        return required

    def _peer_lagging(self, peer: str) -> bool:
        return (self._peer_ack_target.get(peer, 0)
                - self._peer_acked.get(peer, 0) > SYNC_LAG_WINDOW)

    def _barrier_timeout(self, fut) -> None:
        if fut.done():
            return
        fut.set_result(None)
        self.sync_timeouts += 1
        self.sync_degraded += 1
        self._sync_barriers = [b for b in self._sync_barriers
                               if b[2] is not fut]

    def _on_sync_ack(self, peer: str, seq: int, ok: bool) -> None:
        if ok and seq > self._peer_acked.get(peer, 0):
            self._peer_acked[peer] = seq
            self.sync_acks += 1
        self._check_barriers()
        if (peer in self._resync_waiting
                and self._resync_lag(peer) < RESYNC_WINDOW // 2):
            self._resync_resume(peer)

    def _check_barriers(self) -> None:
        done = []
        for b in self._sync_barriers:
            targets, required, fut = b
            if fut.done():
                done.append(b)
                continue
            degraded = False
            satisfied = True
            for p in required:
                link = self.manager.links.get(p)
                if link is None or not link.connected:
                    degraded = True     # partitioned peer: don't wait
                elif self._peer_acked.get(p, 0) < targets[p]:
                    satisfied = False
                    break
            if satisfied:
                if degraded:
                    self.sync_degraded += 1
                fut.set_result(None)
                done.append(b)
        for b in done:
            self._sync_barriers.remove(b)

    # ------------------------------------------------------------------
    # Link lifecycle (called by ClusterManager)
    # ------------------------------------------------------------------

    def on_link_up(self, link) -> None:
        """Full per-link resync: ship every locally-owned session's
        metadata + live inflight snapshot so a (re)joined peer's
        replica converges; the final message's ack fast-forwards the
        peer's acked seq past everything it may have missed. The walk
        is paced (``_resync_walk``); a new one supersedes the last."""
        peer = link.peer
        self._flush_relays(peer)    # relays held while it was down first
        gen = self._resync_gen[peer] = self._resync_gen.get(peer, 0) + 1
        self._resync_floor[peer] = self._peer_ack_target.get(peer, 0)
        owned = [cid for cid, entry in self.ledger.items()
                 if entry.owner == self.node_id]
        if not owned:
            # nothing owned = nothing the peer owes an ack for: clear
            # any stale target left by an ack lost to the link's death
            # (its session may since have been purged/claimed away), or
            # every future barrier would stall the full sync timeout
            self._peer_ack_target[peer] = self._peer_acked.get(peer, 0)
        self._resync_walk(link, owned, 0, gen)
        self._peer_send_failed.discard(peer)

    def _resync_walk(self, link, cids: list, i: int, gen: int) -> None:
        """Ship the resync messages of ``cids[i:]`` that are still owned
        here: at most ``RESYNC_SLICE`` sessions this call, none while the
        link's outbound queue holds ``LINK_QUEUE_MAX //
        RESYNC_QUEUE_SHARE`` items or ``RESYNC_WINDOW`` seqs await the
        peer's ack; the rest on a later loop turn: at once after a full
        slice, else once the peer's acks have caught up or
        ``RESYNC_DELAY_S`` has passed. Stops when a newer walk started
        or the link is down."""
        peer = link.peer
        if (self._resync_gen.get(peer) != gen or not link.connected
                or (i and not self._started)):
            return
        loop = getattr(self.broker, "loop", None)
        room = LINK_QUEUE_MAX // RESYNC_QUEUE_SHARE
        window = RESYNC_WINDOW
        stop = min(i + RESYNC_SLICE, len(cids))
        if loop is None:        # no loop to come back on: one pass
            room, window, stop = LINK_QUEUE_MAX, float("inf"), len(cids)
        while (i < stop and link.outbound.qsize() < room
               and self._resync_lag(peer) < window):
            entry = self.ledger.get(cids[i])
            i += 1
            if entry is None or entry.owner != self.node_id:
                continue
            msg = self._envelope(_entry_update_dict(entry))
            self._send_to_link(link, f"$cluster/sess/{self.node_id}/up",
                               json.dumps(msg).encode(), msg["q"])
            ops = self._live_inflight_ops(entry.cid)
            cl = self.broker.clients.get(entry.cid)
            dig = {entry.cid: list(cl.inflight.digest())} \
                if cl is not None else {}
            for k in range(0, len(ops), OPS_PER_MESSAGE):
                msg = self._envelope({"ops": ops[k:k + OPS_PER_MESSAGE],
                                      "dig": dig})
                self._send_to_link(
                    link, f"$cluster/sess/{self.node_id}/infl",
                    json.dumps(msg).encode(), msg["q"])
        if i < len(cids) and loop is not None:
            self._resync_waiting[peer] = (link, cids, i, gen)
            if i < stop:        # held by the queue or the acks
                loop.call_later(RESYNC_DELAY_S, self._resync_resume, peer)
            else:
                loop.call_soon(self._resync_resume, peer)

    def _resync_lag(self, peer: str) -> int:
        """Seqs sent to ``peer`` since its walk began and not acked."""
        return (self._peer_ack_target.get(peer, 0)
                - max(self._peer_acked.get(peer, 0),
                      self._resync_floor.get(peer, 0)))

    def _resync_resume(self, peer: str) -> None:
        """Go on with ``peer``'s waiting resync walk, if any (the timer,
        the next loop turn and an ack may each call this; the first one
        takes the walk)."""
        waiting = self._resync_waiting.pop(peer, None)
        if waiting is not None:
            self._resync_walk(*waiting)

    def _schedule_resync(self, link) -> None:
        """Debounced gap-healer for a live link that refused a
        replication send: without it the peer's replica would stay
        permanently short one op while its high-watermark acks make it
        look caught up — exactly the silent hole ``sync=always``
        promises not to have."""
        peer = link.peer
        if peer in self._resync_pending or not self._started:
            return
        loop = getattr(self.broker, "loop", None)
        if loop is None:
            return
        self._resync_pending.add(peer)
        loop.call_later(RESYNC_DELAY_S, self._run_resync, link)

    def _run_resync(self, link) -> None:
        self._resync_pending.discard(link.peer)
        if self._started and link.connected:
            self.sync_resyncs += 1
            self.on_link_up(link)   # a failing resync reschedules itself

    def on_link_down(self, link) -> None:
        self._check_barriers()      # partitioned peers must not wedge acks

    # ------------------------------------------------------------------
    # Dead-owner lifecycle (ADR 018): replica expiry + will firing
    # ------------------------------------------------------------------

    async def _sweep_loop(self) -> None:
        """Periodic replica-side sweep: for every remote-owned session
        whose owner's link is down, run the expiry countdown and the
        transferred-will timer. A sweep bug degrades to a logged skip,
        never a dead task."""
        try:
            while True:
                await asyncio.sleep(REPLICA_SWEEP_S)
                try:
                    self._sweep(time.monotonic())
                except Exception as exc:
                    log = self.manager.log
                    if log is not None:
                        log.warn("session sweep failed",
                                 error=repr(exc)[:200])
        except asyncio.CancelledError:
            pass

    def _judge_rank(self, dead_owner: str) -> int | None:
        """This node's deterministic stagger slot among the peers that
        can judge ``dead_owner`` dead, or None when we hold no direct
        link to it (a transitive replica trusts the judges). Rank 0
        acts first; higher ranks wait one extra grace each, and the
        rank-0 node's willfire/purge broadcast stands them down — so
        one death yields one will even though election needs no
        topology knowledge. Two judges partitioned from EACH OTHER
        both see rank 0 and both act (documented split-brain floor)."""
        if dead_owner not in self.manager.links:
            return None
        ids = sorted({self.node_id}
                     | {p for p, lk in self.manager.links.items()
                        if p != dead_owner and lk.connected})
        return ids.index(self.node_id)

    def _sweep(self, now: float) -> None:
        if all(lk.connected for lk in self.manager.links.values()):
            return      # every owner reachable: no entry to judge
        for cid in list(self.ledger):
            entry = self.ledger.get(cid)
            if entry is None or entry.owner == self.node_id:
                continue
            link = self.manager.links.get(entry.owner)
            if link is None or link.connected:
                continue        # owner reachable (or not ours to judge)
            rank = self._judge_rank(entry.owner)
            if rank is not None:
                self._sweep_entry(entry, now, rank)

    def _sweep_entry(self, entry: SessionEntry, now: float,
                     rank: int) -> None:
        """One dead-owner replica at this judge's stagger slot: fire a
        due transferred will, then run the expiry countdown."""
        st = self.manager.membership.get(entry.owner)
        last = st.last_seen if st is not None and st.last_seen \
            else self._started_mono
        down_for = now - last
        # ADR 022: the grace stretches with the dead owner's measured
        # link RTT — on a 150ms WAN link the death observation itself
        # lags by round trips, and a loopback-tuned grace would fire
        # wills for owners that are merely far away. A truly dead
        # peer's last RTT estimate is finite, so detection stays
        # bounded (floor + k x RTT), just WAN-honest.
        grace = self.manager.link_deadline(entry.owner, self.will_grace)
        stagger = grace * (1 + rank)
        if entry.will is not None:
            try:
                delay = float(entry.will[4]) \
                    if len(entry.will) > 4 else 0.0
            except (TypeError, ValueError):
                # malformed replicated delay (hostile/buggy peer): act
                # now — the fire path validates the rest and degrades
                # to a counted skip, so one bad entry can never wedge
                # the whole sweep round
                delay = 0.0
            if entry.connected:
                # died with the client attached: the will-delay clock
                # starts at the owner's death
                if down_for >= stagger + delay:
                    self._fire_replica_will(entry)
            elif entry.disconnected_seen:
                # ADR 019 (satellite): the owner died while the will
                # sat in ITS _will_delays countdown — the replicated
                # entry carries the delay REMAINING at disconnect, so
                # the judge resumes that countdown from the disconnect
                # it observed instead of restarting it at owner death
                # (which double-charged the delay and, pre-fix, never
                # fired at all: disconnected entries were skipped).
                # The rank stagger applies at the FIRE instant — every
                # judge's countdown expires at the same moment, so
                # staggering only the death observation would let all
                # ranks fire together before the stand-down lands
                if (down_for >= stagger
                        and now - entry.disconnected_seen
                        >= delay + grace * rank):
                    self._fire_replica_will(entry)
            else:
                # no observed disconnect instant (entry applied cold:
                # judge restarted or joined late). ADR 020 satellite —
                # prefer the replicated wall-clock DEADLINE (6th
                # element) so the fire stays on the owner's original
                # schedule; restarting the countdown at owner death
                # double-charged the delay. 5-element entries from
                # older peers keep the duration fallback.
                wd = None
                if len(entry.will) > 5:
                    try:
                        wd = float(entry.will[5])
                    except (TypeError, ValueError):
                        wd = None
                if wd is not None:
                    if (down_for >= stagger and self._wall()
                            >= wd + grace * rank):
                        self._fire_replica_will(entry)
                elif down_for >= stagger + delay:
                    self._fire_replica_will(entry)
        self._maybe_expire(entry, now, down_for, stagger)

    def _maybe_expire(self, entry: SessionEntry, now: float,
                      down_for: float, stagger: float) -> None:
        """The replica-side expiry timer: seeded from the replicated
        expiry metadata (``cluster_replica_expiry_s`` fallback when the
        session carries none; 0 disables the fallback), counted from
        the disconnect we observed — or from the owner's death when it
        died with the client attached. Tombstone-fenced like any purge:
        a returning owner's live update supersedes, a re-created
        session claims above the purged epoch."""
        if entry.expiry_set:
            limit = float(entry.expiry)
        elif self.replica_expiry > 0:
            limit = self.replica_expiry
        else:
            return
        elapsed = (now - entry.disconnected_seen) \
            if (not entry.connected and entry.disconnected_seen) \
            else down_for
        if elapsed < limit + stagger:
            return
        if entry.will is not None:
            # ADR 019 (satellite): an expiring session with a still-
            # pending transferred will fires it on the way out — expiry
            # ends the will delay early per [MQTT-3.1.2-10] (session
            # end publishes the will), and silently purging it lost
            # the will entirely
            self._fire_replica_will(entry)
        self.replica_expiries += 1
        self._remove_entry(entry.cid)
        self._note_tombstone(entry.cid, entry.session_epoch)
        # third-party purge: ``ow`` + the exact token tell transitive
        # replica holders (who may hold no link to the dead owner)
        # which incarnation was judged expired — fenced so a newer
        # claim/update is never purged by a stale judgement
        self._broadcast("purge", {"cid": entry.cid,
                                  "se": entry.session_epoch,
                                  "be": entry.boot_epoch,
                                  "ow": entry.owner})

    def _fire_replica_will(self, entry: SessionEntry) -> None:
        """Fire a dead owner's transferred will exactly once: the will
        is consumed locally FIRST (reentrancy-safe), broadcast-cleared
        on every replica (epoch-fenced), then fanned out through the
        normal will path — local subscribers, retained store, and the
        ADR-013 forward rails for remote subscribers."""
        w, entry.will = entry.will, None
        hook = getattr(self.broker, "_storage_hook", None)
        if hook is not None:
            hook.store.put(SESS_BUCKET, entry.cid, entry.meta_json())
        self._broadcast("willfire", {"cid": entry.cid,
                                     "se": entry.session_epoch,
                                     "be": entry.boot_epoch,
                                     "ow": entry.owner})
        try:
            topic = str(w[0])
            payload = bytes.fromhex(str(w[1]))
            qos, retain = int(w[2]), bool(w[3])
        except (IndexError, ValueError, TypeError):
            self.restore_errors += 1
            return
        if not valid_topic_name(topic) or topic.startswith("$"):
            self.restore_errors += 1    # a peer must not smuggle junk
            return
        self.wills_fired += 1
        packet = Packet(
            fixed=FixedHeader(type=PT.PUBLISH, qos=min(qos, 2),
                              retain=retain),
            topic=topic, payload=payload, origin=entry.cid,
            created=time.time())
        self.broker._fire_will(None, packet)
        log = self.manager.log
        if log is not None:
            log.warn("transferred will fired", cid=entry.cid,
                     owner=entry.owner, topic=topic)

    def _apply_willfire(self, origin: str, d: dict) -> None:
        """A judge fired (or is about to fire) this session's will:
        stand down — but only for the exact incarnation it judged; a
        takeover or reconnect since then owns a fresh will."""
        entry = self.ledger.get(str(d["cid"]))
        if entry is None or entry.will is None:
            return
        token = (int(d["se"]), int(d.get("be", 0)),
                 str(d.get("ow", "")))
        if entry.token != token:
            return
        entry.will = None
        self.wills_cleared += 1
        hook = getattr(self.broker, "_storage_hook", None)
        if hook is not None:
            hook.store.put(SESS_BUCKET, entry.cid, entry.meta_json())

    def _live_inflight_ops(self, cid: str) -> list:
        client = self.broker.clients.get(cid)
        if client is None:
            return []
        ops = []
        held = set(client.held_pids)
        for p in client.inflight.all():
            rec = MessageRecord.from_packet(p, cid)
            if p.packet_id in held:
                rec.held = True     # ADR 018: held-ness survives resync
            ops.append([cid, p.packet_id, "set", rec.to_json()])
        for pid in sorted(client.pubrec_inbound):
            ops.append([cid, pid, "rec"])   # ADR 018: QoS2 dedup set
        return ops

    # ------------------------------------------------------------------
    # Inbound dispatch (from ClusterManager.handle_inbound)
    # ------------------------------------------------------------------

    async def handle_inbound(self, sender: str, levels: list[str],
                             packet) -> None:
        kind = levels[3]
        msg = self._admit_envelope(packet.payload)
        if msg is None:
            return
        origin = str(msg["o"])
        to = msg.get("to")
        if to is None or to == self.node_id:
            try:
                hit = faults.fire_detail(faults.CLUSTER_SESSION_SYNC,
                                         key=origin)
            except faults.InjectedFault:
                self.sync_faults += 1
                return
            if hit is not None:
                self.sync_faults += 1
                if hit[0] == "hang":
                    await asyncio.sleep(hit[1])
                else:
                    return      # drop: the update never applies here
            # the port's fence key: the origin's boot epoch above its
            # seq, so the seqs of a restarted origin's new incarnation
            # order after its last one's (its seqs start over)
            self._dispatch(kind, origin, msg.get("d") or {},
                           (int(msg["e"]) << 32) + int(msg["q"]))
        if to != self.node_id:
            self._relay(kind, msg, exclude={sender, origin})

    def _admit_envelope(self, payload: bytes) -> dict | None:
        """Parse + dedup one sess envelope: per-(origin, boot-epoch)
        windows exactly like the ADR-013 forward rails, so redundant
        relay paths and stale-incarnation replays apply once/never."""
        from .manager import DedupWindow
        try:
            msg = json.loads(payload)
            origin = str(msg["o"])
            epoch = int(msg["e"])
            seq = int(msg["q"])
        except Exception:
            self.inbound_rejected += 1
            return None
        if origin == self.node_id:
            return None     # our own message relayed around a cycle
        win = self._seen.get(origin)
        if win is None or epoch > win.epoch:
            win = self._seen[origin] = DedupWindow(epoch=epoch)
        elif epoch < win.epoch:
            return None     # stale incarnation replay
        if not win.admit(seq):
            return None     # redundant relay path
        return msg

    def _dispatch(self, kind: str, origin: str, d: dict,
                  seq: int = 0) -> None:
        try:
            if kind == "up":
                self._apply_update(origin, d, seq)
            elif kind == "claim":
                self._apply_claim(origin, d)
            elif kind == "state":
                self._apply_state(origin, d)
            elif kind == "infl":
                self._apply_inflight(origin, d, seq)
            elif kind == "purge":
                self._apply_purge(origin, d)
            elif kind == "willfire":
                self._apply_willfire(origin, d)
            else:
                self.inbound_rejected += 1
        except (KeyError, ValueError, TypeError):
            self.inbound_rejected += 1

    def _entry_from_wire(self, origin: str, d: dict) -> SessionEntry:
        return SessionEntry(
            str(d["cid"]), origin, int(d["se"]), int(d.get("be", 0)),
            int(d.get("exp", 0)), bool(d.get("exps", 0)),
            int(d.get("pv", 4)), bool(d.get("conn", 0)),
            d.get("subs") or [], d.get("shares") or [],
            d.get("dig") or (0, 0), d.get("will"))

    def _apply_update(self, origin: str, d: dict, seq: int = 0) -> None:
        new = self._entry_from_wire(origin, d)
        new.applied_seq = seq
        cur = self.ledger.get(new.cid)
        if cur is not None:
            if new.token < cur.token:
                return      # fenced: an older incarnation's update
            if (new.token == cur.token and seq and cur.applied_seq
                    and seq < cur.applied_seq):
                return      # same-owner updates reordered by a relay
            if cur.owner == self.node_id and new.token > cur.token:
                # an update outran its claim: treat it as one
                self._lose_session(new.cid, to=origin, pull=False,
                                   purge=False, token=new.token)
        self._apply_entry(new)

    def _apply_claim(self, origin: str, d: dict) -> None:
        cid = str(d["cid"])
        token = (int(d["se"]), int(d.get("be", 0)), origin)
        purge = bool(d.get("purge", 0))
        pull = bool(d.get("pull", 0))
        cur = self.ledger.get(cid)
        if cur is not None and cur.owner == self.node_id:
            if token > cur.token:
                self._lose_session(cid, to=origin, pull=pull,
                                   purge=purge, token=token,
                                   on_shipped=self._ship_reporter(
                                       d.get("tr")))
            else:
                # stale claimant: correct it with our own state record
                self.claims_rejected += 1
                self._broadcast("up", _entry_update_dict(cur), to=origin)
            return
        if cur is not None and token <= cur.token:
            self.claims_rejected += 1
            return
        # ADR 022 (closes the ADR-021 dead-owner blackhole): this claim
        # moved the session off a DEAD prior owner — any QoS1 forwards
        # we parked against that owner's link for the session's topics
        # now have a live home at the claimant
        if (cur is not None and not purge and cur.subs
                and cur.owner not in (origin, self.node_id)):
            self.manager.rehome_for_takeover(
                cur.owner, origin, [str(rec[0]) for rec in cur.subs
                                    if rec])
        entry = self._reowned_entry(cid, cur, token, purge)
        if purge:
            hook = getattr(self.broker, "_storage_hook", None)
            if hook is not None:
                hook.store.delete_prefix(INFLIGHT_BUCKET, cid + "|")
        self._apply_entry(entry, keep_inflight=not purge)

    @staticmethod
    def _reowned_entry(cid: str, cur: SessionEntry | None, token: tuple,
                       purge: bool) -> SessionEntry:
        """A fresh entry for a session whose ownership just moved:
        state carries over from the previous replica unless purged.
        The WILL never carries over (ADR 018): a claim means a live
        client at the claimant, whose own CONNECT will replicates with
        the claimant's next update — and a reconnect cancels a pending
        dead-owner will, exactly like a local reconnect cancels a
        delayed will."""
        keep = cur is not None and not purge
        return SessionEntry(
            cid, token[2], token[0], token[1],
            cur.expiry if keep else 0, cur.expiry_set if keep else False,
            cur.protocol_version if keep else 4, True,
            cur.subs if keep else [], cur.shares if keep else [],
            cur.digest if keep else (0, 0))

    def _lose_session(self, cid: str, to: str, pull: bool, purge: bool,
                      token: tuple, on_shipped=lambda: None) -> None:
        """A higher fencing token seized a session we own: disconnect
        the live client with v5 SessionTakenOver, hand the state to the
        winner when asked, and drop every local trace — the session now
        lives (and persists) at the claimant. ``on_shipped`` fires once
        the handoff is on the wire (the ADR-017 ship-leg span reporter,
        a no-op for untraced claims)."""
        self.sessions_lost += 1
        broker = self.broker
        client = broker.clients.get(cid)
        state = None
        if client is not None and pull and not purge:
            state = self._state_dict(client, token)
        if client is not None:
            self._evict_lost_client(cid, client)
        if state is not None:
            self._broadcast("state", state, to=to)
        on_shipped()
        self._seed_replica_of_winner(cid, token, purge, state)

    def _evict_lost_client(self, cid: str, client) -> None:
        """Disconnect + deregister the local client whose session was
        claimed away: trie subscriptions withdrawn (and un-advertised),
        live storage rows dropped — the claimant persists it now."""
        broker = self.broker
        client.taken_over = True
        # ADR 019 (satellite): a pending delayed will is cancelled by
        # the takeover — the session lives on at the claimant, and the
        # will-delay contract [MQTT-3.1.3-9] says a session resumption
        # before the delay elapses suppresses the will
        broker._will_delays.pop(cid, None)
        if not client.closed:
            broker.disconnect_client(client, codes.ErrSessionTakenOver)
            broker._spawn(
                client.stop(ProtocolError(codes.ErrSessionTakenOver)),
                "sess-takeover-stop")
        self._suppress_purge.add(cid)
        try:
            for filt in list(client.subscriptions):
                if broker.topics.unsubscribe(cid, filt):
                    broker.info.subscriptions -= 1
                    self.manager.note_unsubscribe(filt)
            client.subscriptions.clear()
            broker.info.inflight -= len(client.inflight)
            broker.clients.delete(cid)
            hook = getattr(broker, "_storage_hook", None)
            if hook is not None:
                hook.store.delete("clients", cid)
                hook.store.delete_prefix("subscriptions", cid + "|")
                hook.store.delete_prefix("inflight", cid + "|")
        finally:
            self._suppress_purge.discard(cid)

    def _seed_replica_of_winner(self, cid: str, token: tuple,
                                purge: bool, state: dict | None) -> None:
        """Install our replica of the session at its new owner — seeded
        from the SAME accurate snapshot we just shipped it (the old
        self-owned entry's dict may predate acks the live client
        drained), journal mirrored."""
        entry = self._reowned_entry(cid, self.ledger.get(cid), token,
                                    purge)
        keep = not purge
        if state is not None and not purge:
            entry.subs = state["subs"]
            entry.shares = state["shares"]
            entry.digest = tuple(state["dig"])
            entry.inflight = {int(p): str(r)
                              for p, r in (state.get("infl") or {}).items()}
            entry.pubrec = [int(p) for p in state.get("pubrec") or []]
            keep = False
        self._apply_entry(entry, keep_inflight=keep)
        if not keep:
            hook = getattr(self.broker, "_storage_hook", None)
            if hook is not None:
                hook.store.delete_prefix(INFLIGHT_BUCKET, cid + "|")
                for pid, raw in entry.inflight.items():
                    hook.store.put(INFLIGHT_BUCKET, f"{cid}|{pid}", raw)
                for pid in entry.pubrec:
                    # the QoS2 dedup set must survive OUR crash too —
                    # the prefix delete above swept its r-rows
                    hook.store.put(INFLIGHT_BUCKET, f"{cid}|r{pid}",
                                   "1")

    def _ship_reporter(self, trace):
        """ADR 017: a closure reporting the ship-leg span back to the
        claimant — how long the prior owner spent disconnecting +
        packaging the handoff. A claim without trace identity gets a
        no-op, so _lose_session stays branch-free about tracing."""
        tracer = getattr(self.broker, "tracer", None)
        if trace is None or tracer is None:
            return lambda: None
        t_ship0 = tracer.clock()

        def fire() -> None:
            try:
                dur_us = max(tracer.clock() - t_ship0, 0) // 1000
                self.manager.telemetry.send_report(
                    str(trace[0]), int(trace[1]),
                    [["sess_ship", 0, dur_us]], e2e_us=dur_us,
                    kind="sess")
            except (TypeError, ValueError, IndexError):
                pass    # malformed trace identity: the handoff stands

        return fire

    def _state_dict(self, client, token: tuple) -> dict:
        subs, shares = self._subs_shares(client)
        infl = {}
        held = set(client.held_pids)
        for p in client.inflight.all():
            rec = MessageRecord.from_packet(p, client.id)
            if p.packet_id in held:
                rec.held = True     # ADR 018: held-ness survives the
            infl[str(p.packet_id)] = rec.to_json()  # state-pull leg too
        return {"cid": client.id, "se": token[0], "be": token[1],
                "subs": subs, "shares": shares,
                "dig": list(client.inflight.digest()),
                "pubrec": sorted(client.pubrec_inbound),
                "infl": infl}

    def _apply_state(self, origin: str, d: dict) -> None:
        fut = self._pulls.get(str(d.get("cid", "")))
        if fut is not None and not fut.done():
            fut.set_result(d)
        # no waiter: a late handoff — the claim already resolved the
        # ownership, and the owner's next update supersedes this

    def _apply_inflight(self, origin: str, d: dict, seq: int = 0) -> None:
        hook = getattr(self.broker, "_storage_hook", None)
        for op in d.get("ops") or []:
            cid, pid, kind = str(op[0]), int(op[1]), str(op[2])
            entry = self.ledger.get(cid)
            if entry is None or entry.owner != origin:
                continue    # stale: the session moved since this op
            if seq and entry.infl_seq > seq:
                continue    # a relay path reordered this chunk behind
                            # a newer one: a late 'set' must not
                            # resurrect a completed message
            entry.infl_seq = max(entry.infl_seq, seq)
            self._apply_one_op(entry, cid, pid, kind, op, hook)
        self._apply_digests(origin, d.get("dig") or {}, hook, seq)

    def _apply_one_op(self, entry: SessionEntry, cid: str, pid: int,
                      kind: str, op: list, hook) -> None:
        """One replicated inflight op against one replica entry:
        ``set``/``del`` maintain the parked window, ``rec``/``recdel``
        (ADR 018) the streamed receiver-side QoS2 dedup set — each
        mirrored into the cluster_inflight journal bucket."""
        if kind == "set":
            raw = str(op[3])
            entry.inflight[pid] = raw
            self._note_trace_op(cid, pid, op)
            if hook is not None:
                hook.store.put(INFLIGHT_BUCKET, f"{cid}|{pid}", raw)
        elif kind == "rec":
            if pid not in entry.pubrec:
                entry.pubrec.append(pid)
            if hook is not None:
                hook.store.put(INFLIGHT_BUCKET, f"{cid}|r{pid}", "1")
        elif kind == "recdel":
            if pid in entry.pubrec:
                entry.pubrec.remove(pid)
            if hook is not None:
                hook.store.delete(INFLIGHT_BUCKET, f"{cid}|r{pid}")
        else:       # "del"
            entry.inflight.pop(pid, None)
            if hook is not None:
                hook.store.delete(INFLIGHT_BUCKET, f"{cid}|{pid}")

    def _note_trace_op(self, cid: str, pid: int, op: list) -> None:
        """ADR 017: when the op carried its publish's trace identity,
        count + log it — one grep of trace=<origin>:<id> correlates
        the replica write with the origin's pipeline trace across
        nodes."""
        if len(op) <= 4 or not op[4]:
            return
        ref = op[4]
        self.trace_ops_applied += 1
        log = self.manager.log
        if log is not None:
            try:
                log.debug("inflight replica applied", cid=cid, pid=pid,
                          trace=f"{ref[0]}:{ref[1]}")
            except (IndexError, TypeError):
                pass

    def _apply_digests(self, origin: str, digests: dict, hook,
                       seq: int = 0) -> None:
        """Flush-time digests riding the ops keep the replica's digest
        aligned with the window it holds (ADR 016)."""
        for cid, dig in digests.items():
            entry = self.ledger.get(str(cid))
            if entry is not None and entry.owner == origin \
                    and not (seq and entry.infl_seq > seq):
                entry.digest = tuple(dig)
                if hook is not None:    # same-key writes coalesce in
                    hook.store.put(SESS_BUCKET, str(cid),  # the journal
                                   entry.meta_json())

    def _apply_purge(self, origin: str, d: dict) -> None:
        cid = str(d["cid"])
        entry = self.ledger.get(cid)
        if entry is None:
            return
        if "ow" in d:
            # ADR 018: a third-party purge — a judge expired a dead
            # owner's replica on our behalf (we may hold no link to
            # the owner). Fenced to the EXACT incarnation it judged:
            # any later claim/update owns a higher token and survives.
            if (entry.owner != str(d["ow"])
                    or entry.session_epoch != int(d.get("se", 0))
                    or entry.boot_epoch != int(d.get("be", 0))):
                return
        elif entry.owner != origin:
            return      # we (or a third node) own a newer incarnation
        self.purges += 1
        self._remove_entry(cid)
        self._note_tombstone(cid, int(d.get("se", 0)))
