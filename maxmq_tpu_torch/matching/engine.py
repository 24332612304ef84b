"""Batched NFA matcher: the compiled subscription NFA evaluated in torch
on the device, bound to a TopicIndex, with the CPU trie as its exact
fallback.

Counterpart of the JAX package's ``matching/engine.py``. One loop step
per topic level over the whole batch (the reference's ``lax.scan``): the
active node set advances through literal edges (vectorized
open-addressing probes) and '+' edges, while subscriber-carrying nodes
emit their *row ids*. A final sort compacts the emitted ids into at most
``max_rows`` matches per topic; the host unions the rows' entry lists
(NFATables.row_entries). Static shapes throughout: fixed batch (bucket
padded), fixed max levels, fixed active-set width, fixed max_rows, with
per-topic overflow flags routing too-wide/too-deep topics to the exact
CPU trie.

The walk is plain torch ops (the reference computes it in XLA, outside
Pallas): a few dozen kernels a level, no hand-written kernel.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import faults
from .nfa import MAX_PROBES, NFATables, compile_trie, hash32_t
from .sig import _device_errors, resolve_device
from .topics import pad_topic_batch
from .trie import SubscriberSet, TopicIndex, subs_version

_I32_MAX = int(np.iinfo(np.int32).max)

NFA_ARRAYS = ("hash_node", "hash_tok", "hash_val", "plus_child",
              "node_mask", "hash_mask")


def nfa_device_tables(tables, device) -> tuple[torch.Tensor, ...]:
    """The six int32 table arrays of a compiled ``NFATables`` (either
    package's) as device tensors, in ``match_batch_body``'s order."""
    dev = torch.device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(
        getattr(tables, name), dtype=np.int32)).to(dev)
        for name in NFA_ARRAYS)


def _lookup_literal(hash_node, hash_tok, hash_val, active, tok,
                    table_mask: int) -> torch.Tensor:
    """(node, token) -> child via bounded linear probing, for every
    active node. active: [B, W] (clamped to >= 0), tok: [B, 1]."""
    base = hash32_t(active, tok) & table_mask
    child = torch.full_like(active, -1)
    for p in range(MAX_PROBES):
        slot = (base + p) & table_mask
        hit = (hash_node[slot] == active) & (hash_tok[slot] == tok)
        child = torch.where((child < 0) & hit, hash_val[slot], child)
    return child


def match_batch_body(hash_node, hash_tok, hash_val, plus_child, node_mask,
                     hash_mask, toks, lengths, dollar,
                     width: int, table_mask: int, max_rows: int):
    """The batched NFA match on the tensors' device.

    Args:
      hash_node..hash_mask: int32 tables (``nfa_device_tables``)
      toks: int32[B, Lmax] level-token ids, -1 padded
      lengths: int32[B] level counts (-1 = too deep -> overflow)
      dollar: bool[B] first level begins with '$'
    Returns:
      rows: int32[B, max_rows] matched row ids, ascending, -1 padded
      overflow: bool[B] active set exceeded `width`, topic too deep, or
        matches exceeded `max_rows` (caller falls back to the CPU trie)
    """
    batch, max_levels = toks.shape
    dev = toks.device
    active = torch.full((batch, width), -1, dtype=torch.int32, device=dev)
    active[:, 0] = 0
    overflow = lengths < 0
    pad_tok = torch.full((batch,), -1, dtype=toks.dtype, device=dev)
    emitted = []
    # max_levels + 1 steps: step L does the final (exact-depth) emission
    for level in range(max_levels + 1):
        tok = toks[:, level] if level < max_levels else pad_tok
        valid = active >= 0                    # [B, W]
        not_done = level < lengths             # topic still has levels
        at_end = lengths == level              # exact depth reached
        # [MQTT-4.7.2-1]: '$'-topics never match root-level wildcards
        wild_ok = ~dollar if level == 0 else torch.ones_like(dollar)

        # '#'-terminal emission: matches at every prefix depth incl. parent
        emit_hash = (not_done | at_end) & wild_ok
        a0 = active.clamp(min=0)
        idx = a0.to(torch.int64)
        hash_rows = torch.where(valid & emit_hash[:, None],
                                hash_mask[idx], -1)
        self_rows = torch.where(valid & at_end[:, None], node_mask[idx], -1)
        emitted.append(torch.cat([hash_rows, self_rows], dim=1))  # [B, 2W]

        # transitions (only for topics that still have levels)
        lit = _lookup_literal(hash_node, hash_tok, hash_val, a0,
                              tok[:, None], table_mask)
        lit = torch.where(valid & not_done[:, None], lit, -1)
        plus = torch.where(valid & (not_done & wild_ok)[:, None],
                           plus_child[idx], -1)
        cand = torch.cat([lit, plus], dim=1)   # [B, 2W]

        n_valid = (cand >= 0).sum(dim=1)
        overflow = overflow | (n_valid > width)
        order = torch.argsort((cand < 0).to(torch.int32), dim=1,
                              stable=True)
        packed = torch.gather(cand, 1, order)[:, :width]
        active = torch.where(not_done[:, None], packed, active)

    # emitted: L+1 of [B, 2W] row ids (-1 = none). Compact per topic: sort
    # ascending with -1 mapped to +inf, keep the first max_rows.
    emitted = torch.stack(emitted, dim=1).reshape(batch, -1)
    emitted = torch.where(emitted < 0, _I32_MAX, emitted)
    emitted = torch.sort(emitted, dim=1).values
    n_matched = (emitted != _I32_MAX).sum(dim=1)
    overflow = overflow | (n_matched > max_rows)
    rows = emitted[:, :max_rows]
    rows = torch.where(rows == _I32_MAX, -1, rows)
    return rows, overflow


class NFAEngine:
    """Device-resident NFA matcher bound to a TopicIndex.

    Compiles the trie into NFA tables, keeps them on ``device`` (the card
    unless the caller asks for ``"cpu"``; double-buffered: a publish sees
    either the old or new tables, never torn ones) and answers
    ``subscribers()`` with exact SubscriberSet semantics, falling back to
    the CPU trie for overflow topics.
    """

    def __init__(self, index: TopicIndex, width: int = 32,
                 max_levels: int = 16, max_rows: int = 128, device=None,
                 auto_refresh: bool = True) -> None:
        self.index = index
        self.width = width
        self.max_levels = max_levels
        self.max_rows = max_rows
        self.device = resolve_device(device)
        self.auto_refresh = auto_refresh
        self._lock = threading.Lock()
        self._tables: NFATables | None = None
        self._device_tables = None
        self.fallbacks = 0
        self.matches = 0
        self.refresh(force=True)

    # ------------------------------------------------------------------

    def refresh(self, force: bool = False) -> bool:
        """Recompile + upload if the index changed. Cheap no-op otherwise."""
        if (not force and self._tables is not None
                and self._tables.version == subs_version(self.index)):
            return False
        faults.fire(faults.DEVICE_RECOMPILE)
        tables = compile_trie(self.index)
        dev = nfa_device_tables(tables, self.device)
        with self._lock:
            self._tables = tables
            self._device_tables = dev
        return True

    @property
    def tables(self) -> NFATables:
        return self._tables

    @property
    def device_tables(self) -> tuple[torch.Tensor, ...]:
        """The live snapshot's device tables (``nfa_device_tables``)."""
        return self._device_tables

    # ------------------------------------------------------------------

    def program(self, dev, toks: torch.Tensor, lengths: torch.Tensor,
                dollar: torch.Tensor, table_mask: int):
        """The device program on one tokenized batch: (rows, overflow)
        device tensors, enqueued without a wait."""
        return match_batch_body(*dev, toks, lengths, dollar,
                                width=self.width, table_mask=table_mask,
                                max_rows=self.max_rows)

    def match_raw(self, topics: list[str]):
        """Device match of a topic batch. Returns (rows int32[B, max_rows],
        overflow bool[B], tables) — the tables the batch actually ran on."""
        if self.auto_refresh:
            self.refresh()
        faults.fire(faults.DEVICE_MATCH)
        with self._lock:
            tables = self._tables
            dev = self._device_tables
        toks, lengths, dollar = tables.tokenize(topics, self.max_levels)
        # bucket the batch axis: the same padded shapes as the reference;
        # per-topic outputs trim clean
        b = len(topics)
        arrays = pad_topic_batch(toks, lengths, dollar)
        with _device_errors("NFA match"):
            args = [torch.from_numpy(a).to(self.device) for a in arrays]
            rows, overflow = self.program(dev, *args,
                                          table_mask=tables.table_size - 1)
            return (rows.cpu().numpy()[:b], overflow.cpu().numpy()[:b],
                    tables)

    def subscribers_batch(self, topics: list[str]) -> list[SubscriberSet]:
        rows, overflow, tables = self.match_raw(topics)
        out = []
        for i, topic in enumerate(topics):
            self.matches += 1
            if overflow[i]:
                self.fallbacks += 1
                out.append(self.index.subscribers(topic))
            else:
                out.append(self.decode(rows[i], tables))
        return out

    def subscribers(self, topic: str) -> SubscriberSet:
        """Single-topic match (the broker's pluggable-matcher entry point)."""
        return self.subscribers_batch([topic])[0]

    async def subscribers_async(self, topic: str) -> SubscriberSet:
        """Event-loop-friendly match: recompiles and matches in a worker
        thread so the caller's asyncio loop never stalls behind the table
        swap."""
        import asyncio

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self.subscribers, topic)

    @staticmethod
    def decode(row_ids: np.ndarray, tables: NFATables,
               into: SubscriberSet | None = None) -> SubscriberSet:
        """Union the matched rows' entry lists into an exact SubscriberSet."""
        result = SubscriberSet() if into is None else into
        entries = tables.entries
        row_entries = tables.row_entries
        for r in row_ids:
            if r < 0:
                break  # -1 padding is sorted to the tail
            for b in row_entries[r]:
                entry = entries[b]
                if entry.shared:
                    for cid, sub in entry.candidates.items():
                        result.add_shared(entry.group, sub.filter, cid, sub)
                else:
                    sub = entry.subscription
                    result.add(entry.client_id, sub, sub.filter)
        return result
