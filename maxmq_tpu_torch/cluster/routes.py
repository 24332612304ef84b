"""Aggregated cluster route table + snapshot/delta wire codec (ADR 013).

Each node advertises the set of topic filters it (or anything reachable
through it) has subscribers for. The table here stores what REMOTE
peers advertised — keyed by direct-peer node id — and answers the one
hot-path question ``nodes_for(topic)``: which peers need a copy of this
publish. Remote filters live in a :class:`~..matching.trie.TopicIndex`
whose "client ids" are node ids, so matching reuses the exact wildcard
semantics (and C-backed SubscriberSet) of the local matcher instead of
a second, subtly different matcher; results are memoized in a
``VersionedTopicCache`` keyed on the index's subscription version.

Advertisements are *aggregated*: a filter subsumed by a broader one
from the same advertiser is never put on the wire (``sport/#`` at a
peer subsumes ``sport/+/score`` — arXiv:1811.07088's subscription
aggregation), so route-table size tracks the distinct filter shapes,
not the subscription count.

Wire format (versioned, JSON payloads on reserved ``$cluster/routes/*``
topics):

* snapshot — zlib-compressed ``{"v":1,"node","epoch","seq","filters"}``
  published to ``$cluster/routes/<node>`` (retained on the receiving
  broker for observability); replaces everything known about the node.
* delta — plain ``{"v":1,"node","epoch","seq","add","del"}`` published
  to ``$cluster/routes/<node>/delta``; applies only when ``epoch``
  matches and ``seq`` is exactly ``last_seq + 1`` — any gap is a
  desync and the receiver must request a fresh snapshot.

Epochs are per-process-boot monotonic stamps: a restarted peer's first
snapshot carries a higher epoch, flushing every stale route the old
incarnation advertised (including a stale RETAINED snapshot replayed
by a broker — lower epochs are ignored).

Copy of the JAX package's ``cluster/routes.py``. The aggregated cover
(``IncrementalCover``) keeps its members in a trie of their levels; its
cover sets are the reference's.
"""

from __future__ import annotations

import json
import zlib

from ..matching.topics import filter_matches_topic, split_levels
from ..matching.trie import TopicIndex, VersionedTopicCache
from ..protocol.packets import Subscription

WIRE_VERSION = 1

# topic level budget for route payloads; a snapshot beyond this refuses
# to decode rather than let one peer OOM the cluster control plane
MAX_SNAPSHOT_BYTES = 8 << 20


class RouteWireError(ValueError):
    """A route snapshot/delta payload that failed to decode."""


def filter_subsumes(general: str, specific: str) -> bool:
    """True when every topic matching ``specific`` also matches
    ``general`` (so advertising ``general`` alone loses nothing).
    Level rules mirror the trie walk: ``#`` covers the parent level and
    everything deeper [MQTT-4.7.1.2], ``+`` covers exactly one level
    [MQTT-4.7.1-3]. ``$``-prefixed filters are never advertised (the
    cluster refuses to forward ``$`` topics), so the root-level
    dollar exception never arises here."""
    if general == specific:
        return True
    glv = split_levels(general)
    slv = split_levels(specific)
    for i, gl in enumerate(glv):
        if gl == "#":
            return True
        if i >= len(slv):
            return False
        sl = slv[i]
        if gl == "+":
            if sl == "#":
                return False    # specific reaches deeper than one level
            continue
        if gl != sl:
            return False        # literal mismatch, or specific is the
    return len(glv) == len(slv)  # broader one ('+'/'#' vs literal)


def minimal_cover(filters) -> set[str]:
    """The aggregated advertisement: drop every filter subsumed by a
    DIFFERENT filter in the set. O(n^2) level walks — kept as the
    reference implementation the incremental :class:`IncrementalCover`
    is equivalence-tested against; the hot path no longer calls it per
    change (ADR 016 / the ROADMAP open item)."""
    fs = set(filters)
    out = set()
    for f in fs:
        if not any(g != f and filter_subsumes(g, f) for g in fs):
            out.add(f)
    return out


class _CoverTrie:
    """The cover's members in a trie of their levels, answering the two
    subsumption questions by walking it: which member subsumes a filter
    (at most three branches a level: the literal, ``+`` and ``#``), and
    which members a filter subsumes."""

    __slots__ = ("root",)

    def __init__(self) -> None:
        self.root: list = [{}, None]        # [children, member or None]

    def insert(self, filt: str) -> None:
        node = self.root
        for lv in split_levels(filt):
            node = node[0].setdefault(lv, [{}, None])
        node[1] = filt

    def delete(self, filt: str) -> None:
        path = [self.root]
        levels = split_levels(filt)
        for lv in levels:
            path.append(path[-1][0][lv])
        path[-1][1] = None
        for k in range(len(levels), 0, -1):      # prune empty nodes
            node = path[k]
            if node[0] or node[1] is not None:
                break
            del path[k - 1][0][levels[k - 1]]

    def subsumer(self, filt: str) -> str | None:
        """A member ``g != filt`` with ``filter_subsumes(g, filt)``."""
        levels = split_levels(filt)
        n = len(levels)

        def walk(node, i):
            hash_node = node[0].get("#")
            if hash_node is not None and hash_node[1] is not None:
                return hash_node[1]
            if i == n:
                return node[1]
            lv = levels[i]
            if lv == "#":
                return None
            for key in ((lv, "+") if lv != "+" else ("+",)):
                child = node[0].get(key)
                if child is not None:
                    hit = walk(child, i + 1)
                    if hit is not None:
                        return hit
            return None

        hit = walk(self.root, 0)
        return hit if hit != filt else None

    def subsumed(self, filt: str) -> list[str]:
        """Every member ``c != filt`` with ``filter_subsumes(filt, c)``."""
        levels = split_levels(filt)
        n = len(levels)
        out: list[str] = []

        def everything(node):
            if node[1] is not None:
                out.append(node[1])
            for child in node[0].values():
                everything(child)

        def walk(node, i):
            if i == n:
                if node[1] is not None:
                    out.append(node[1])
                return
            lv = levels[i]
            if lv == "#":
                everything(node)
            elif lv == "+":
                for key, child in node[0].items():
                    if key != "#":
                        walk(child, i + 1)
            else:
                child = node[0].get(lv)
                if child is not None:
                    walk(child, i + 1)

        walk(self.root, 0)
        return [c for c in out if c != filt]


class IncrementalCover:
    """Refcounted filter set with an incrementally-maintained minimal
    cover (the ROADMAP open item: the O(n^2) per-change recompute dies
    before per-user filter shapes meet the session ledger).

    * ``add(f)``    — either ``f`` hides behind a cover member that
      subsumes it (recorded with that member as its *witness*), or
      ``f`` joins the cover and demotes every member it subsumes (their
      hidden filters are re-witnessed by ``f`` — subsumption is
      transitive, so witnesses stay valid).
    * ``remove(f)`` — when a cover member's refcount hits zero, only
      the filters it witnessed are re-examined: each re-hides behind a
      surviving cover member or promotes (promotion reuses the add
      path, so two re-exposed filters that subsume each other still
      collapse).

    Invariant (equivalence-tested against the JAX package's class and
    ``minimal_cover``): ``self.cover == minimal_cover(self.refs.keys())``
    after any sequence of add/remove.

    The JAX package's class scans the whole cover on every add and the
    whole witness map on every demotion and removal: O(n x cover) to
    seed, which at a third of the ``mixed_100k`` corpus (33,334 filters,
    a cover of 2,277, nearly all of it ``+``-headed) takes minutes a
    peer. Here the members sit in a trie of their levels
    (:class:`_CoverTrie`) and each member keeps the set of filters it
    witnesses. Which member witnesses a hidden filter may differ from
    the reference's choice; the cover, the one thing read outside the
    class, is the same set."""

    __slots__ = ("refs", "cover", "_witness", "_hides", "_trie")

    def __init__(self, filters=()) -> None:
        self.refs: dict[str, int] = {}
        self.cover: set[str] = set()
        self._witness: dict[str, str] = {}   # hidden filter -> cover member
        self._hides: dict[str, set[str]] = {}  # cover member -> its hidden
        self._trie = _CoverTrie()
        for f in filters:
            self.add(f)

    def _hide(self, filt: str, member: str) -> None:
        self._witness[filt] = member
        self._hides.setdefault(member, set()).add(filt)

    def add(self, filt: str) -> None:
        n = self.refs.get(filt, 0)
        self.refs[filt] = n + 1
        if n:
            return                          # already placed
        member = self._trie.subsumer(filt)
        if member is not None:
            self._hide(filt, member)
        else:
            self._promote(filt)

    def _promote(self, filt: str) -> None:
        """Install ``filt`` as a cover member, demoting every member it
        subsumes (and re-witnessing their hidden filters to ``filt``)."""
        hides = self._hides.setdefault(filt, set())
        for c in self._trie.subsumed(filt):
            self.cover.discard(c)
            self._trie.delete(c)
            for h in self._hides.pop(c, ()):
                self._witness[h] = filt
                hides.add(h)
            self._witness[c] = filt
            hides.add(c)
        self.cover.add(filt)
        self._trie.insert(filt)

    def remove(self, filt: str) -> None:
        n = self.refs.get(filt, 0)
        if n > 1:
            self.refs[filt] = n - 1
            return
        if n == 0:
            return
        del self.refs[filt]
        if filt in self._witness:
            self._hides[self._witness.pop(filt)].discard(filt)
            return
        self.cover.discard(filt)
        self._trie.delete(filt)
        exposed = self._hides.pop(filt, set())
        for h in exposed:
            del self._witness[h]
        for h in exposed:
            member = self._trie.subsumer(h)
            if member is not None:
                self._hide(h, member)
            else:
                self._promote(h)


class ShareLedger:
    """Cluster-wide ``$share`` group-membership ledger (ADR 016/018).

    Maps ``(group, filter)`` to live-member counts per *member id* —
    node ids for the federation, worker ids for the in-process delivery
    pool (broker/workers.py routes its gossip through this same class,
    so a filter shared across both a pool and a peer node resolves
    ownership through one set of rules). Ownership is deterministic
    with no coordination round; two balance modes (ADR 018):

    * ``pin`` — the lowest member id with a live count owns the pick
      for every publish (the ADR-005 fairness trade; the in-process
      worker pool keeps this mode).
    * ``weighted`` — the owner rotates per publish, weighted by each
      member's live-subscriber count: every node derives the same
      owner from the same ``token`` (a content hash of the publish)
      and the same converged ledger, so the exactly-once invariant
      holds while a node with 3 live group members receives ~3x the
      picks of a node with 1. A ``token=None`` caller (or a
      single-member key) falls back to ``pin``.

    A key nobody (else) claims is owned locally. Divergence window
    (both modes, ADR 016/018): while gossip is in flight two nodes can
    disagree on the ledger and a publish can double- or zero-deliver
    for that round — ``pin`` diverges only on membership-set changes,
    ``weighted`` also on member-count changes (and on mixed-version
    clusters: run ``pin`` until every node speaks ADR 018 — see
    migration.md). The window is one gossip round, bounded by the
    session-replication debounce."""

    __slots__ = ("self_id", "_members", "balance")

    def __init__(self, self_id, balance: str = "pin") -> None:
        self.self_id = self_id
        self.balance = balance
        # (group, filter) -> member id -> live local-subscription count
        self._members: dict[tuple[str, str], dict] = {}

    def set_member(self, member, key: tuple[str, str], n: int) -> None:
        per = self._members.get(key)
        if n > 0:
            if per is None:
                per = self._members[key] = {}
            per[member] = n
        elif per is not None:
            per.pop(member, None)
            if not per:
                del self._members[key]

    def set_local(self, key: tuple[str, str], n: int) -> None:
        self.set_member(self.self_id, key, n)

    def replace_member(self, member, counts: dict) -> None:
        """Full per-member replacement: keys absent from ``counts`` are
        cleared (a restarted member's stale claims must not linger)."""
        for key in [k for k, per in self._members.items()
                    if member in per and k not in counts]:
            self.set_member(member, key, 0)
        for key, n in counts.items():
            self.set_member(member, key, int(n))

    def drop_member(self, member) -> None:
        self.replace_member(member, {})

    def members_for(self, key: tuple[str, str]) -> list:
        per = self._members.get(key)
        return sorted(m for m, n in (per or {}).items() if n > 0)

    def owner_for(self, key: tuple[str, str], token: int | None = None):
        """The member that owns this publish's pick, or None when the
        key has no live members. Deterministic on every node from the
        (converged) ledger: ``weighted`` walks the sorted members with
        their live counts as weights, indexed by ``token``; anything
        else — or no token — pins to the lowest member id."""
        per = self._members.get(key)
        members = sorted(m for m, n in (per or {}).items() if n > 0)
        if not members:
            return None
        if (token is None or self.balance != "weighted"
                or len(members) == 1):
            return members[0]
        weights = [per[m] for m in members]
        slot = token % sum(weights)
        for m, w in zip(members, weights):
            slot -= w
            if slot < 0:
                return m
        return members[-1]      # unreachable (slot < sum of weights)

    def owns(self, key: tuple[str, str],
             token: int | None = None) -> bool:
        owner = self.owner_for(key, token)
        # nobody claims it: local delivery is safe
        return owner is None or owner == self.self_id

    @property
    def group_count(self) -> int:
        return len(self._members)


# ----------------------------------------------------------------------
# Wire codec
# ----------------------------------------------------------------------


def encode_snapshot(node: str, epoch: int, seq: int, filters,
                    preds=None) -> bytes:
    d = {"v": WIRE_VERSION, "node": node, "epoch": epoch, "seq": seq,
         "filters": sorted(filters)}
    if preds:
        # ADR 023 stretch: per-filter predicate annotations, present
        # only for filters whose EVERY local holder is content-gated.
        # Decoders that predate the key ignore it (same wire version:
        # the snapshot stays fully readable without it).
        d["preds"] = {f: sorted(preds[f]) for f in sorted(preds)}
    return zlib.compress(json.dumps(d).encode())


def decode_snapshot(payload: bytes) -> tuple[str, int, int, list[str]]:
    node, epoch, seq, filters, _preds = decode_snapshot_preds(payload)
    return node, epoch, seq, filters


def decode_snapshot_preds(
        payload: bytes
) -> tuple[str, int, int, list[str], dict[str, tuple[str, ...]]]:
    """Snapshot decode that also surfaces the optional ADR-023
    predicate annotations ({} when the sender carried none)."""
    try:
        raw = zlib.decompress(payload, bufsize=65536)
        if len(raw) > MAX_SNAPSHOT_BYTES:
            raise RouteWireError("snapshot too large")
        d = json.loads(raw)
        if d.get("v") != WIRE_VERSION:
            raise RouteWireError(f"unknown wire version {d.get('v')!r}")
        preds = {str(f): tuple(str(e) for e in exprs)
                 for f, exprs in (d.get("preds") or {}).items()}
        return (str(d["node"]), int(d["epoch"]), int(d["seq"]),
                [str(f) for f in d["filters"]], preds)
    except RouteWireError:
        raise
    except Exception as exc:
        raise RouteWireError(f"bad snapshot: {exc!r}") from exc


def encode_delta(node: str, epoch: int, seq: int,
                 add, remove) -> bytes:
    return json.dumps(
        {"v": WIRE_VERSION, "node": node, "epoch": epoch, "seq": seq,
         "add": sorted(add), "del": sorted(remove)}).encode()


def decode_delta(payload: bytes
                 ) -> tuple[str, int, int, list[str], list[str]]:
    try:
        d = json.loads(payload)
        if d.get("v") != WIRE_VERSION:
            raise RouteWireError(f"unknown wire version {d.get('v')!r}")
        return (str(d["node"]), int(d["epoch"]), int(d["seq"]),
                [str(f) for f in d["add"]], [str(f) for f in d["del"]])
    except RouteWireError:
        raise
    except Exception as exc:
        raise RouteWireError(f"bad delta: {exc!r}") from exc


# ----------------------------------------------------------------------
# The table
# ----------------------------------------------------------------------


class NodeRoutes:
    """What one direct peer currently advertises. ``preds`` holds the
    ADR-023 content-gating annotations: filter -> predicate exprs for
    filters whose every holder at the peer requires a predicate."""

    __slots__ = ("epoch", "seq", "filters", "preds")

    def __init__(self, epoch: int, seq: int, filters: set[str],
                 preds: dict[str, tuple[str, ...]] | None = None) -> None:
        self.epoch = epoch
        self.seq = seq
        self.filters = filters
        self.preds = preds or {}


class RouteTable:
    """Local aggregated filters + per-peer advertised filter sets.

    Single-threaded: every mutation and query runs on the broker's
    asyncio loop (the inner TopicIndex carries its own lock, but this
    class adds no cross-thread contract)."""

    def __init__(self, node_id: str, epoch: int) -> None:
        self.node_id = node_id
        self.epoch = epoch
        # local aggregated refcounts: filter -> live subscription count
        self.local: dict[str, int] = {}
        self.nodes: dict[str, NodeRoutes] = {}
        self._index = TopicIndex()          # remote filters, cid=node
        self._cache = VersionedTopicCache(maxsize=2048)
        # per-peer incrementally-maintained advertisement covers
        # (ADR 016): each holds local filters + every OTHER peer's
        # filters (split horizon), updated in O(cover) per change
        # instead of the old O(n^2) minimal_cover recompute per link
        self._covers: dict[str, IncrementalCover] = {}
        # cluster-wide $share group-membership ledger (ADR 016): fed by
        # cluster/sessions.py, consulted by the broker's shared fan-out
        self.shares = ShareLedger(node_id)

    # -- local side ----------------------------------------------------

    def note_local_subscribe(self, filt: str) -> bool:
        """Count one local subscription under its aggregated filter;
        True when the filter is new (advertisements may change)."""
        n = self.local.get(filt, 0)
        self.local[filt] = n + 1
        if n == 0:
            for cov in self._covers.values():
                cov.add(filt)
        return n == 0

    def note_local_unsubscribe(self, filt: str) -> bool:
        n = self.local.get(filt, 0)
        if n <= 1:
            existed = self.local.pop(filt, None) is not None
            if existed:
                for cov in self._covers.values():
                    cov.remove(filt)
            return existed
        self.local[filt] = n - 1
        return False

    def _cover_update(self, node: str, add, remove) -> None:
        """Apply one remote node's effective filter changes to every
        per-peer cover except the node's own (split horizon)."""
        for peer, cov in self._covers.items():
            if peer == node:
                continue
            for f in add:
                cov.add(f)
            for f in remove:
                cov.remove(f)

    def advertisement_for(self, peer: str) -> set[str]:
        """The aggregated filter set this node advertises to ``peer``:
        local filters plus everything learned from OTHER peers (routes
        are transitive — a line topology forwards across the middle
        node), minus anything learned only from ``peer`` itself (split
        horizon: never advertise a peer's own routes back at it).
        Maintained incrementally per peer (ADR 016); the one full
        build happens lazily at first ask for that peer."""
        cov = self._covers.get(peer)
        if cov is None:
            cov = self._covers[peer] = IncrementalCover(self.local)
            for node, nr in self.nodes.items():
                if node != peer:
                    for f in nr.filters:
                        cov.add(f)
        return set(cov.cover)

    # -- remote side ---------------------------------------------------

    def apply_snapshot(self, node: str, epoch: int, seq: int,
                       filters, preds=None) -> bool:
        """Replace everything known about ``node``. False = stale
        (older epoch, or an older seq within the same epoch — e.g. a
        retained snapshot from before the peer restarted)."""
        nr = self.nodes.get(node)
        if nr is not None and (epoch < nr.epoch
                               or (epoch == nr.epoch and seq < nr.seq)):
            return False
        fresh = set(filters)
        if nr is not None:
            removed = nr.filters - fresh
            for f in removed:
                self._index.unsubscribe(node, f)
            add = fresh - nr.filters
        else:
            removed = set()
            add = fresh
        for f in add:
            self._index.subscribe(node, Subscription(filter=f))
        kept = ({f: tuple(exprs) for f, exprs in preds.items()
                 if f in fresh} if preds else None)
        self.nodes[node] = NodeRoutes(epoch, seq, fresh, kept)
        self._cover_update(node, add, removed)
        return True

    def apply_delta(self, node: str, epoch: int, seq: int,
                    add, remove) -> bool:
        """Apply an incremental update; False = desync (unknown node,
        epoch mismatch, or a sequence gap) — the caller must flush and
        request a fresh snapshot."""
        nr = self.nodes.get(node)
        if nr is None or epoch != nr.epoch or seq != nr.seq + 1:
            return False
        removed, added = [], []
        for f in remove:
            if f in nr.filters:
                nr.filters.discard(f)
                nr.preds.pop(f, None)
                self._index.unsubscribe(node, f)
                removed.append(f)
        for f in add:
            if f not in nr.filters:
                nr.filters.add(f)
                # deltas never carry annotations (ADR 023): a delta-added
                # filter is conservatively un-gated until the next
                # snapshot re-establishes it
                nr.preds.pop(f, None)
                self._index.subscribe(node, Subscription(filter=f))
                added.append(f)
        nr.seq = seq
        self._cover_update(node, added, removed)
        return True

    def flush_node(self, node: str) -> int:
        """Drop everything a peer advertised (restart with a fresh
        epoch, or a desync awaiting resync). Returns routes dropped."""
        nr = self.nodes.pop(node, None)
        if nr is None:
            return 0
        for f in nr.filters:
            self._index.unsubscribe(node, f)
        self._cover_update(node, (), nr.filters)
        return len(nr.filters)

    def nodes_for(self, topic: str) -> frozenset[str]:
        """Direct peers whose advertised filters match ``topic`` — the
        forward target set, memoized per (topic, table version)."""
        version = self._index.sub_version
        hit = self._cache.get(topic, version)
        if hit is not None:
            return hit
        matched = self._index.subscribers(topic)
        result = frozenset(matched.subscriptions)
        self._cache.put(topic, version, result)
        return result

    def pred_gate(self, node: str, topic: str
                  ) -> tuple[str, ...] | None:
        """ADR 023 stretch: when EVERY advertised filter of ``node``
        matching ``topic`` carries a predicate annotation, return the
        union of those predicate expressions — the forwarder may skip
        the peer when none passes, because the peer's own content
        plane would mask every delivery anyway. None = not fully gated
        (a matching filter with a plain holder, a transitive route, or
        an annotation-free advertisement): the forward must go."""
        nr = self.nodes.get(node)
        if nr is None or not nr.preds:
            return None
        tlevels = split_levels(topic)
        dollar = topic.startswith("$")
        exprs: list[str] = []
        matched = False
        for f in nr.filters:
            if not filter_matches_topic(split_levels(f), tlevels,
                                        dollar):
                continue
            matched = True
            fexprs = nr.preds.get(f)
            if fexprs is None:
                return None
            exprs.extend(fexprs)
        if not matched:
            return None
        return tuple(dict.fromkeys(exprs))

    @property
    def remote_route_count(self) -> int:
        return sum(len(nr.filters) for nr in self.nodes.values())
