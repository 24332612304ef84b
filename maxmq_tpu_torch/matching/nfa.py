"""NFA compiler: flatten the subscription trie into the tables of the
batched NFA matcher (``engine.match_batch_body``).

Copy of the JAX package's ``matching/nfa.py``, plus ``hash32_t``, the
torch twin of ``hash32``. The compiled form (all numpy; the engine moves
it to the device):

* literal edges -> open-addressing hash table keyed on (node, token):
  ``hash_node/hash_tok/hash_val`` with linear probing bounded by MAX_PROBES
  (the builder grows the table until every key probes within the bound)
* ``plus_child[n]`` -> node id of the '+' child (-1 absent)
* ``node_mask[n]`` / ``hash_mask[n]`` -> *row id* for the subscriber set of
  n itself / of n's '#' child (-1 none; '#' is always a leaf per MQTT
  filter validity, so it needs no node of its own)
* ``row_entries[r]`` -> host-side tuple of entry indices for row r. The
  device returns the (few) matched row ids per topic and the host unions
  the entry lists. Row 0 is reserved empty.

Each *entry* is one subscription — a (client, filter) pair for ordinary
subscriptions, or one `$share` (group, filter) pair — so the host can
reconstruct exact merge semantics (max QoS + id union) after matching.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..protocol.packets import Subscription
from .sig_torch import MASK32, mul32
from .topics import intern_level, split_levels, tokenize_cached

MAX_PROBES = 8   # linear-probe bound enforced at build time

_MIX1 = np.uint32(0x9E3779B1)
_MIX2 = np.uint32(0x85EBCA77)
_MIX3 = np.uint32(0xC2B2AE35)


def hash32(node, tok):
    """Vectorizable (node, token) -> uint32 hash (numpy, the builder's).
    Negative inputs hash as their uint32 bit pattern."""
    with np.errstate(over="ignore"):  # uint32 wraparound is the point
        h = node.astype(np.uint32) * _MIX1 + tok.astype(np.uint32) * _MIX2
        h = h ^ (h >> np.uint32(15))
        h = h * _MIX3
        h = h ^ (h >> np.uint32(13))
        return h


def hash32_t(node: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """``hash32`` on torch integer tensors (broadcasting): an int64 tensor
    of the uint32 hash. Inputs are masked to 32 bits first, so -1 (a pad
    level) hashes as 0xFFFFFFFF, as numpy's ``astype(np.uint32)`` makes
    it; every product goes through ``sig_torch.mul32`` (an int64 product
    of two uint32 values would overflow)."""
    n = node.to(torch.int64) & MASK32
    t = tok.to(torch.int64) & MASK32
    h = (mul32(n, int(_MIX1)) + mul32(t, int(_MIX2))) & MASK32
    h = h ^ (h >> 15)
    h = mul32(h, int(_MIX3))
    return h ^ (h >> 13)


def hash_slot(node, tok, table_mask):
    """Builder-side slot index (numpy)."""
    return (hash32(node, tok) & np.uint32(table_mask)).astype(np.int32)


@dataclass
class Entry:
    """One subscriber bit: an ordinary (client, sub) or a shared pair."""

    client_id: str = ""
    subscription: Subscription | None = None
    group: str = ""          # non-empty => shared pair
    filter: str = ""
    # shared pairs carry the full candidate map
    candidates: dict[str, Subscription] = field(default_factory=dict)

    @property
    def shared(self) -> bool:
        return bool(self.group)


class EntryBuilder:
    """Accumulates Entry records with `$share` (group, filter) dedup — the
    subscriber-bit construction shared by every compiled-table flavor, so
    merge semantics can never diverge between them."""

    def __init__(self) -> None:
        self.entries: list[Entry] = []
        self._shared: dict[tuple[str, str], int] = {}

    def add(self, filt: str, client_id: str, sub: Subscription,
            group: str) -> int | None:
        """Record one subscription. Returns the bit index to place on the
        row, or None when this shared (group, filter) pair already has
        its bit placed (the new member only joins the candidate map)."""
        if group:
            key = (group, sub.filter)
            bit = self._shared.get(key)
            if bit is not None:
                self.entries[bit].candidates[client_id] = sub
                return None
            bit = len(self.entries)
            self._shared[key] = bit
            entry = Entry(group=group, filter=sub.filter)
            entry.candidates[client_id] = sub
            self.entries.append(entry)
            return bit
        bit = len(self.entries)
        self.entries.append(Entry(client_id=client_id, subscription=sub,
                                  filter=filt))
        return bit


@dataclass
class NFATables:
    """The flattened matcher, plus the host-side decode table."""

    n_nodes: int
    hash_node: np.ndarray    # int32[H]
    hash_tok: np.ndarray     # int32[H]
    hash_val: np.ndarray     # int32[H]
    plus_child: np.ndarray   # int32[N]
    node_mask: np.ndarray    # int32[N]
    hash_mask: np.ndarray    # int32[N]
    row_entries: list[tuple[int, ...]]   # row id -> entry indices
    vocab: dict[str, int]
    entries: list[Entry]
    version: int = -1

    @property
    def table_size(self) -> int:
        return len(self.hash_node)

    def tokenize(self, topics: list[str], max_levels: int):
        """Host-side topic prep (``topics.tokenize_cached``)."""
        return tokenize_cached(self, topics, max_levels)


class _BuildNode:
    __slots__ = ("children", "plus", "entry_bits", "hash_bits")

    def __init__(self) -> None:
        self.children: dict[str, _BuildNode] = {}
        self.plus: _BuildNode | None = None
        self.entry_bits: list[int] = []   # bits for subscribers at this node
        self.hash_bits: list[int] = []    # bits for '#'-child subscribers


class TableFull(Exception):
    """A fixed-size edge table could not place every edge within the probe
    bound (caller should grow the size and retry)."""


def compile_trie(index, version: int | None = None) -> NFATables:
    """Compile a TopicIndex (or anything with ``all_subscriptions()``) into
    NFATables."""
    # Read the version BEFORE snapshotting: a mutation racing the snapshot
    # then stamps the tables older than the index, forcing one extra (safe)
    # recompile rather than silently freezing stale tables.
    if version is None:
        from .trie import subs_version
        version = subs_version(index)
    return compile_subscriptions(index.all_subscriptions(), version)


def compile_subscriptions(subs, version: int = 0,  # qa: complex
                          table_size: int | None = None,
                          vocab: dict[str, int] | None = None) -> NFATables:
    """Compile a subscription list (as produced by
    ``TopicIndex.all_subscriptions()``) into NFATables.

    ``table_size`` fixes the edge-table size (power of two) — the sharded
    engine uses this to give every mesh shard identically-shaped tables;
    raises TableFull if the edges don't fit within the probe bound.
    ``vocab`` shares one token-intern dict across shard compiles so the
    same level string gets the same token id in every shard (topics are
    tokenized once for every shard).
    """
    builder = EntryBuilder()
    root = _BuildNode()
    if vocab is None:
        vocab = {}

    for filt, client_id, sub, group in subs:
        # `filt` is the trie path: already '$share'-stripped for shared subs
        levels = split_levels(filt)
        terminal_is_hash = levels and levels[-1] == "#"
        walk_levels = levels[:-1] if terminal_is_hash else levels
        node = root
        for level in walk_levels:
            if level == "+":
                if node.plus is None:
                    node.plus = _BuildNode()
                node = node.plus
            else:
                intern_level(vocab, level)
                child = node.children.get(level)
                if child is None:
                    child = node.children[level] = _BuildNode()
                node = child
        bit = builder.add(filt, client_id, sub, group)
        if bit is None:
            continue  # shared pair: the group's bit is already on the node
        if terminal_is_hash:
            node.hash_bits.append(bit)
        else:
            node.entry_bits.append(bit)
    entries = builder.entries

    # ---- number nodes breadth-first --------------------------------------
    nodes: list[_BuildNode] = [root]
    order: dict[int, int] = {id(root): 0}
    i = 0
    while i < len(nodes):
        node = nodes[i]
        i += 1
        for child in node.children.values():
            order[id(child)] = len(nodes)
            nodes.append(child)
        if node.plus is not None:
            order[id(node.plus)] = len(nodes)
            nodes.append(node.plus)
    n_nodes = len(nodes)

    # ---- row table (host-side decode lists) ------------------------------
    rows: list[tuple[int, ...]] = [()]   # row 0 reserved empty

    def mask_row(bits: list[int]) -> int:
        if not bits:
            return -1
        rows.append(tuple(bits))
        return len(rows) - 1

    plus_child = np.full(n_nodes, -1, dtype=np.int32)
    node_mask = np.full(n_nodes, -1, dtype=np.int32)
    hash_mask = np.full(n_nodes, -1, dtype=np.int32)
    edges: list[tuple[int, int, int]] = []  # (node, token, child)
    for node in nodes:
        nid = order[id(node)]
        if node.plus is not None:
            plus_child[nid] = order[id(node.plus)]
        node_mask[nid] = mask_row(node.entry_bits)
        hash_mask[nid] = mask_row(node.hash_bits)
        for level, child in node.children.items():
            edges.append((nid, vocab[level], order[id(child)]))

    # ---- open-addressing edge table --------------------------------------
    if table_size is None:
        size = 1
        while size < max(len(edges) * 2, 8):
            size *= 2
    else:
        size = table_size
    # Linear probing in edge order, as the reference places them one by
    # one; the home slots come from one vectorized hash and the occupancy
    # from a bytearray, then the arrays fill in one scatter: the same
    # tables, without numpy element access per probe.
    edge_arr = np.asarray(edges, dtype=np.int32).reshape(-1, 3)
    while True:
        table_mask = size - 1
        bases = hash_slot(edge_arr[:, 0], edge_arr[:, 1], table_mask).tolist()
        used = bytearray(size)
        slots = []
        for h in bases:
            for p in range(MAX_PROBES):
                slot = (h + p) & table_mask
                if not used[slot]:
                    used[slot] = 1
                    slots.append(slot)
                    break
            else:
                break
        if len(slots) == len(edges):
            break
        if table_size is not None:
            raise TableFull(size)
        size *= 2  # probe bound exceeded: grow and rebuild
    hash_node = np.full(size, -1, dtype=np.int32)
    hash_tok = np.full(size, -1, dtype=np.int32)
    hash_val = np.full(size, -1, dtype=np.int32)
    placed = np.asarray(slots, dtype=np.int64)
    hash_node[placed] = edge_arr[:, 0]
    hash_tok[placed] = edge_arr[:, 1]
    hash_val[placed] = edge_arr[:, 2]

    return NFATables(
        n_nodes=n_nodes,
        hash_node=hash_node, hash_tok=hash_tok, hash_val=hash_val,
        plus_child=plus_child, node_mask=node_mask, hash_mask=hash_mask,
        row_entries=rows,
        vocab=vocab, entries=entries, version=version,
    )
