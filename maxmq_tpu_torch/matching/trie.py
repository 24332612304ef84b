"""CPU reference topic matcher: a subscription trie with full MQTT wildcard
semantics. It is the matcher service's index, the exact fallback for
topics the device path overflows, and the semantic oracle the device
path is tested against.

Copy of the subscription half of the JAX package's ``matching/trie.py``
(retained messages and topic aliases belong to the broker, which this
package does not carry yet). ``SubscriberSet`` is always the Python
class here: the native decode extension is not loaded.
"""

from __future__ import annotations

import threading
from collections import deque

from ..protocol.packets import Subscription
from .topics import is_dollar, parse_share, split_levels

JOURNAL_CAP = 4096   # mutations kept for overlay replay; beyond this a
                     # matcher serves staleness via the CPU trie instead


def subs_version(index) -> int:
    """The subscription-only version of an index (falls back to the full
    version for index-likes without one): what device matchers key their
    staleness on."""
    v = getattr(index, "sub_version", None)
    return v if v is not None else getattr(index, "version", 0)


class VersionedTopicCache:
    """FIFO-bounded topic -> result cache keyed on a subscription
    version: any subscribe/unsubscribe bumps the version and silently
    invalidates every entry. Cached results are SHARED objects; consumers
    must treat them as immutable and deep_copy before mutating."""

    __slots__ = ("_cache", "maxsize")

    def __init__(self, maxsize: int = 8192) -> None:
        self._cache: dict[str, tuple[int, object]] = {}
        self.maxsize = maxsize

    def get(self, topic: str, version: int):
        hit = self._cache.get(topic)
        if hit is not None and hit[0] == version:
            return hit[1]
        return None

    def put(self, topic: str, version: int, result) -> None:
        cache = self._cache
        if topic not in cache and len(cache) >= self.maxsize:
            cache.pop(next(iter(cache)))
        cache[topic] = (version, result)

    def __len__(self) -> int:
        return len(self._cache)


def merge_subscription(base: Subscription | None, new: Subscription,
                       filter_: str) -> Subscription:
    """Merge overlapping matching filters for one client: max QoS wins, v5
    subscription identifiers union (keyed by filter), flags from the newer.
    """
    if base is None and not new.identifier and not new.identifiers:
        # single matching filter, no v5 subscription identifier — the
        # common fan-out case: no copy needed (consumers never mutate
        # the returned Subscription)
        return new
    merged = Subscription(
        filter=new.filter, qos=new.qos, no_local=new.no_local,
        retain_as_published=new.retain_as_published,
        retain_handling=new.retain_handling, identifier=new.identifier,
        identifiers=dict(new.identifiers))
    if new.identifier:
        merged.identifiers[filter_] = new.identifier
    if base is not None:
        merged.identifiers.update(base.identifiers)
        if base.qos > merged.qos:
            merged.qos = base.qos
        if base.no_local:
            merged.no_local = True
    return merged


def _copy_subscription(s: Subscription) -> Subscription:
    """Field copy of one Subscription record (deep_copy's unit step)."""
    return Subscription(filter=s.filter, qos=s.qos, no_local=s.no_local,
                        retain_as_published=s.retain_as_published,
                        retain_handling=s.retain_handling,
                        identifier=s.identifier,
                        identifiers=dict(s.identifiers))


class SubscriberSet:
    """Result of a topic match: per-client merged non-shared subscriptions and
    shared-group candidate maps (group -> client -> subscription)."""

    __slots__ = ("subscriptions", "shared")

    def __init__(self, subscriptions: dict[str, Subscription] | None = None,
                 shared: dict[tuple[str, str],
                              dict[str, Subscription]] | None = None):
        self.subscriptions = {} if subscriptions is None else subscriptions
        # (group, filter) -> client -> subscription: each pair delivers to
        # exactly one of its members [MQTT-4.8.2-4].
        self.shared = {} if shared is None else shared

    def __eq__(self, other) -> bool:
        try:
            return (self.subscriptions == other.subscriptions
                    and self.shared == other.shared)
        except AttributeError:
            return NotImplemented

    def __repr__(self) -> str:
        return (f"SubscriberSet(subscriptions={self.subscriptions!r}, "
                f"shared={self.shared!r})")

    def add(self, client_id: str, sub: Subscription, filter_: str) -> None:
        self.subscriptions[client_id] = merge_subscription(
            self.subscriptions.get(client_id), sub, filter_)

    def deep_copy(self) -> "SubscriberSet":
        """Copies of every Subscription record (matching aliases the
        stored records)."""
        cp = _copy_subscription
        return SubscriberSet(
            subscriptions={c: cp(s) for c, s in self.subscriptions.items()},
            shared={k: {c: cp(s) for c, s in m.items()}
                    for k, m in self.shared.items()})

    def add_shared(self, group: str, filter_: str, client_id: str,
                   sub: Subscription) -> None:
        self.shared.setdefault((group, filter_), {})[client_id] = sub

    def __len__(self) -> int:
        return len(self.subscriptions) + sum(len(g) for g in self.shared.values())


class _Node:
    __slots__ = ("children", "subscriptions", "shared")

    def __init__(self) -> None:
        self.children: dict[str, _Node] = {}
        self.subscriptions: dict[str, Subscription] = {}
        self.shared: dict[str, dict[str, Subscription]] = {}

    def empty(self) -> bool:
        return not self.children and not self.subscriptions and not self.shared


class TopicIndex:
    """Thread-safe subscription trie."""

    def __init__(self) -> None:
        self._root = _Node()
        self._lock = threading.RLock()
        self.subscription_count = 0
        # bumped on every mutation; device matchers key staleness on it
        self.version = 0
        self.sub_version = 0
        # journal of recent subscription mutations, so matchers can serve
        # adds/removes as a host-side overlay while a recompile runs in
        # the background: (sub_version, op '+'|'-', client_id, filter,
        # sub-or-None, group, trie_path)
        self._journal: deque = deque(maxlen=JOURNAL_CAP)

    # ------------------------------------------------------------------
    # Mutation
    # ------------------------------------------------------------------

    def subscribe(self, client_id: str, sub: Subscription) -> bool:
        """Install a subscription; returns True when it is brand new (False
        when it replaced an existing subscription of the same client+filter)."""
        group, inner = parse_share(sub.filter)
        levels = split_levels(inner if group else sub.filter)
        with self._lock:
            node = self._root
            for level in levels:
                node = node.children.setdefault(level, _Node())
            if group:
                holders = node.shared.setdefault(group, {})
                is_new = client_id not in holders
                holders[client_id] = sub
            else:
                is_new = client_id not in node.subscriptions
                node.subscriptions[client_id] = sub
            if is_new:
                self.subscription_count += 1
            self.version += 1
            self.sub_version += 1
            self._journal.append((self.sub_version, "+", client_id,
                                  sub.filter, sub, group,
                                  "/".join(levels)))
            return is_new

    def unsubscribe(self, client_id: str, filter_: str) -> bool:
        group, inner = parse_share(filter_)
        levels = split_levels(inner if group else filter_)
        with self._lock:
            path: list[tuple[_Node, str]] = []
            node = self._root
            for level in levels:
                child = node.children.get(level)
                if child is None:
                    return False
                path.append((node, level))
                node = child
            if group:
                holders = node.shared.get(group)
                if not holders or client_id not in holders:
                    return False
                del holders[client_id]
                if not holders:
                    del node.shared[group]
            else:
                if client_id not in node.subscriptions:
                    return False
                del node.subscriptions[client_id]
            self.subscription_count -= 1
            self._trim(path, node)
            self.version += 1
            self.sub_version += 1
            self._journal.append((self.sub_version, "-", client_id,
                                  filter_, None, group, "/".join(levels)))
            return True

    def _trim(self, path: list[tuple[_Node, str]], node: _Node) -> None:
        for parent, level in reversed(path):
            if node.empty():
                del parent.children[level]
                node = parent
            else:
                return

    def journal_since(self, version: int):
        """Subscription mutations after ``version`` in order, or None when
        the journal no longer reaches back that far (the caller must do a
        full resync). Entries: (sub_version, op, client_id, filter, sub,
        group, trie_path)."""
        with self._lock:
            if version >= self.sub_version:
                return []
            # versions are consecutive: scan from the newest end and stop
            # at the first already-applied entry (O(new), not O(cap))
            entries = []
            for e in reversed(self._journal):
                if e[0] <= version:
                    break
                entries.append(e)
            entries.reverse()
            if not entries or entries[0][0] != version + 1:
                return None
            return entries

    # ------------------------------------------------------------------
    # Matching
    # ------------------------------------------------------------------

    def subscribers(self, topic: str) -> SubscriberSet:
        """All subscriptions matching a published topic name.

        Per level the walk tries the literal child, '+', and '#'; a '#' child
        also matches the parent level itself (spec 4.7.1.2), and topics whose
        first level begins with '$' never match root-level wildcards
        [MQTT-4.7.2-1].
        """
        levels = split_levels(topic)
        out = SubscriberSet()
        dollar = is_dollar(topic)
        with self._lock:
            # stack of (node, depth): node's path matches levels[:depth]
            stack: list[tuple[_Node, int]] = [(self._root, 0)]
            while stack:
                node, depth = stack.pop()
                wildcard_ok = not (dollar and depth == 0)
                if wildcard_ok:
                    hash_child = node.children.get("#")
                    if hash_child is not None:
                        self._collect(out, hash_child)
                if depth == len(levels):
                    self._collect(out, node)
                    continue
                lit = node.children.get(levels[depth])
                if lit is not None:
                    stack.append((lit, depth + 1))
                if wildcard_ok:
                    plus = node.children.get("+")
                    if plus is not None:
                        stack.append((plus, depth + 1))
        return out

    def _collect(self, out: SubscriberSet, node: _Node) -> None:
        for client_id, sub in node.subscriptions.items():
            out.add(client_id, sub, sub.filter)
        for group, holders in node.shared.items():
            for client_id, sub in holders.items():
                out.add_shared(group, sub.filter, client_id, sub)

    # ------------------------------------------------------------------
    # Introspection (signature compiler input)
    # ------------------------------------------------------------------

    def all_subscriptions(self) -> list[tuple[str, str, Subscription, str]]:
        """All (filter, client_id, subscription, group) entries, materialized
        under the lock so callers iterate a stable snapshot. ``group`` is ''
        for non-shared."""
        out: list[tuple[str, str, Subscription, str]] = []
        with self._lock:
            stack: list[tuple[_Node, list[str]]] = [(self._root, [])]
            while stack:
                node, path = stack.pop()
                filt = "/".join(path)
                for client_id, sub in node.subscriptions.items():
                    out.append((filt, client_id, sub, ""))
                for group, holders in node.shared.items():
                    for client_id, sub in holders.items():
                        out.append((filt, client_id, sub, group))
                for name, child in node.children.items():
                    stack.append((child, path + [name]))
        return out
