"""Dense leveled matcher: the trie walk as a level loop over static slot
arrays, bound to a TopicIndex, with the CPU trie as its exact fallback.

Counterpart of the JAX package's ``matching/dense.py``:

* Per trie level ℓ, the *slots* are all children of level-ℓ nodes in BFS
  order, with static arrays ``child_tok[S]`` (global token id, or PLUS/HASH
  sentinels) and ``parent_idx[S]``.
* The active state is a dense boolean vector ``s_ℓ ∈ {0,1}^{S_ℓ}`` per
  topic. One step is
      ``s_{ℓ+1} = s_ℓ[:, parent_idx] & match(tok_ℓ, child_tok)``.
* MQTT semantics fall out of the compare against sentinels:
  - '+' slots match any *real* token (tok >= 0) — [MQTT-4.7.1-3];
  - '#' slots match any token *including the first padding -1* — the
    spec's parent-match rule [MQTT-4.7.1.2] ("sport/#" matches "sport");
  - exact-subscriber slots emit only when ``lengths == ℓ+1``;
  - the '$'-topic guard [MQTT-4.7.2-1] masks wildcard slots at level 0.
* Emissions land in a [B, R] matrix whose columns ARE the row ids, packed
  to uint32 words; the matched words are recovered with ``torch.topk``
  over nonzero word indices — a few int32s per topic.

Two device programs compute the same words: the walk in torch ops
(``dense_match_body``, the reference's XLA walk, then this sparse
extract) and the hand-written CUDA kernel ``dense_walk_words``
(``dense_kernel``, the port of the Pallas kernel K4), which does the
walk, the pack and the extract in one launch.

Unlike the reference, the engine takes no ``use_pallas`` option: it
serves from the kernel whenever the compiled tables fit its capacity
(``dense_kernel.fits``) and from the walk once they outgrow it, which is
the reference's ``use_pallas="auto"``. ``kernel_active`` (the reference's
``pallas_active``) says which route the current tables take.

uint32 words travel as int32 tensors carrying the same bits (torch's
``uint32`` lacks shifts and reductions on the CPU); ``match_raw`` hands
them out as numpy ``uint32``, as the reference does.

Semantics parity surface: vendor/github.com/mochi-co/mqtt/v2/
topics.go:484-555 (`Subscribers`/`scanSubscribers`).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from .nfa import Entry, EntryBuilder
from .sig import resolve_device
from .sig_torch import to_int32_bits
from .topics import (intern_level, pad_topic_batch, split_levels,
                     tokenize_cached)
from .trie import SubscriberSet, TopicIndex, subs_version

PLUS = -2    # '+' sentinel in child_tok
HASH = -3    # '#' sentinel in child_tok


@dataclass
class LevelArrays:
    """Static per-level structure (host numpy; device copies in engine)."""

    child_tok: np.ndarray    # int32[S] global token id, PLUS or HASH
    parent_idx: np.ndarray   # int32[S] index into previous level's slots
    # emitting (subscriber-carrying) slots are the level's prefix [0, T)
    emit_exact: np.ndarray   # bool[T] True = exact (gated by at_end)


@dataclass
class DenseTables:
    """Compiled dense matcher + host-side decode tables."""

    levels: list[LevelArrays]
    row_entries: list[tuple[int, ...]]   # column/row id -> entry indices
    entries: list[Entry]
    vocab: dict[str, int]
    n_rows: int
    version: int = -1

    def tokenize(self, topics: list[str], max_levels: int):
        """Host-side topic prep (``topics.tokenize_cached``)."""
        return tokenize_cached(self, topics, max_levels)


class _Node:
    __slots__ = ("children", "bits")

    def __init__(self) -> None:
        self.children: dict[str, _Node] = {}
        self.bits: list[int] = []


def compile_dense(index, version: int | None = None,
                  vocab: dict[str, int] | None = None) -> DenseTables:
    """Compile a TopicIndex (or anything with ``all_subscriptions()``)."""
    if version is None:
        version = subs_version(index)
    return compile_dense_subscriptions(index.all_subscriptions(), version,
                                       vocab=vocab)


def compile_dense_subscriptions(subs, version: int = 0,
                                vocab: dict[str, int] | None = None
                                ) -> DenseTables:
    """Build the leveled slot arrays from a subscription snapshot:
    (filter, client_id, subscription, group) tuples, the filter already
    '$share'-stripped for shared subscriptions."""
    builder = EntryBuilder()
    if vocab is None:
        vocab = {}
    root = _build_filter_trie(subs, vocab, builder)
    levels, rows = _bfs_levels(root, vocab)
    return DenseTables(levels=levels, row_entries=rows,
                       entries=builder.entries, vocab=vocab,
                       n_rows=len(rows), version=version)


def _build_filter_trie(subs, vocab, builder) -> "_Node":
    root = _Node()
    for filt, client_id, sub, group in subs:
        node = root
        for level in split_levels(filt):
            if level not in ("+", "#"):
                intern_level(vocab, level)
            child = node.children.get(level)
            if child is None:
                child = node.children[level] = _Node()
            node = child
        bit = builder.add(filt, client_id, sub, group)
        if bit is not None:
            node.bits.append(bit)
    return root


def _bfs_levels(root, vocab):
    """BFS levels: slots = children of previous level. Subscriber-
    carrying slots are ordered FIRST within each level, so a level's
    emission is a prefix of its slots."""
    levels: list[LevelArrays] = []
    rows: list[tuple[int, ...]] = []
    frontier: list[_Node] = [root]
    while True:
        wild_toks = {"+": PLUS, "#": HASH}
        triples = []     # (emit_key, tok, parent, node, is_hash)
        for p, node in enumerate(frontier):
            for key, child in node.children.items():
                tok = wild_toks.get(key)
                if tok is None:
                    tok = vocab[key]
                triples.append((0 if child.bits else 1, tok, p, child,
                                key == "#"))
        if not triples:
            break
        triples.sort(key=lambda t: t[0])   # stable: emitters first
        child_tok = np.asarray([t[1] for t in triples], dtype=np.int32)
        parent_idx = np.asarray([t[2] for t in triples], dtype=np.int32)
        emit_exact: list[bool] = []
        for emit, _tok, _p, child, hashy in triples:
            if emit == 0:
                emit_exact.append(not hashy)
                rows.append(tuple(child.bits))
        levels.append(LevelArrays(
            child_tok=child_tok,
            parent_idx=parent_idx,
            emit_exact=np.asarray(emit_exact, dtype=bool),
        ))
        frontier = [t[3] for t in triples]
    return levels, rows


def dense_arrays(tables) -> dict:
    """The numpy arrays of a compiled ``DenseTables`` (either package's)
    that the device state is made from: per level ``child_tok``,
    ``parent_idx`` and ``emit_exact``, and ``n_rows``."""
    return {
        "child_tok": [np.asarray(lv.child_tok, dtype=np.int32)
                      for lv in tables.levels],
        "parent_idx": [np.asarray(lv.parent_idx, dtype=np.int32)
                       for lv in tables.levels],
        "emit_exact": [np.asarray(lv.emit_exact, dtype=bool)
                       for lv in tables.levels],
        "n_rows": int(tables.n_rows),
    }


def dense_device_tables(arrays: dict, device) -> dict:
    """Device state of the walk for one compiled table set: ``levels``, a
    tuple of (child_tok int32[S], parent_idx int64[S], emit_exact
    bool[T]) per level, and ``n_rows``. The kernel's staged layout is
    ``dense_kernel.stage`` of the same arrays."""
    dev = torch.device(device)
    levels = tuple(
        (torch.from_numpy(ct).to(dev),
         torch.from_numpy(pi.astype(np.int64)).to(dev),
         torch.from_numpy(ee).to(dev))
        for ct, pi, ee in zip(arrays["child_tok"], arrays["parent_idx"],
                              arrays["emit_exact"]))
    return {"device": dev, "levels": levels, "n_rows": arrays["n_rows"]}


def walk_step(s, parent_idx, tok, child_tok, dollar=None):
    """One level of the walk: ``s[:, parent_idx] & match(tok, child_tok)``.

    ``s`` bool[B, S'] is the previous level's state (level 0: the root,
    any all-ones column that ``parent_idx`` indexes), ``tok`` int32[B, 1]
    the level's tokens (-1 past the topic's end), ``child_tok`` int32[S].
    '+' slots match any real token (tok >= 0) [MQTT-4.7.1-3]; '#' slots
    match any token, the first pad -1 included (the parent match,
    [MQTT-4.7.1.2]); ``dollar`` bool[B], given at level 0 only, turns the
    wildcards off for '$' topics [MQTT-4.7.2-1]."""
    ct = child_tok[None, :]
    wild = ((ct == PLUS) & (tok >= 0)) | (ct == HASH)
    if dollar is not None:
        wild = wild & ~dollar[:, None]
    return s[:, parent_idx] & ((tok == ct) | wild)


def dense_match_body(level_consts, toks, lengths, dollar, n_rows: int,
                     max_words: int):
    """Dense match of one topic batch in torch ops (the walk).

    Args:
      level_consts: per level (child_tok int32[S], parent_idx int64[S],
        emit_exact bool[T]) tensors (``dense_device_tables``' ``levels``).
      toks: int32[B, Lmax], -1 padded; lengths: int32[B] (-1 too deep);
      dollar: bool[B].
    Returns:
      word_idx: int32[B, K] indices of matched uint32 words (-1 padded)
      word_val: int32[B, K] the matched words' bits
      overflow: bool[B] too deep / more than K nonzero words
    """
    batch, max_levels = toks.shape
    # One trailing -1 column so a '#' slot at level index max_levels still
    # sees its parent-match pad token (filter 'a/.../#' with max_levels
    # literal levels vs the exactly-max_levels-deep topic).
    toks = torch.cat([toks, torch.full((batch, 1), -1, dtype=torch.int32,
                                       device=toks.device)], dim=1)
    s = torch.ones((batch, 1), dtype=torch.bool, device=toks.device)
    emitted: list[torch.Tensor] = []
    for lvl, (child_tok, parent_idx, emit_exact) in enumerate(level_consts):
        if lvl > max_levels:
            # no topic can reach this depth within the tokenizer window;
            # deeper filters ('#' aside) only match topics that overflow
            break
        s = walk_step(s, parent_idx, toks[:, lvl][:, None], child_tok,
                      dollar if lvl == 0 else None)
        n_emit = emit_exact.shape[0]
        if n_emit:
            cols = s[:, :n_emit]     # emitters are the level's slot prefix
            at_end = (lengths == lvl + 1)[:, None]
            emitted.append(torch.where(emit_exact[None, :], cols & at_end,
                                       cols))
    if emitted:
        matched = torch.cat(emitted, dim=1)          # [B, R] col == row id
    else:
        matched = torch.zeros((batch, 0), dtype=torch.bool,
                              device=toks.device)
    return pack_and_extract(matched, lengths, n_rows, max_words)


def pack_words(matched: torch.Tensor, n_words: int) -> torch.Tensor:
    """[B, R] bool matched rows -> int32[B, n_words] carrying the uint32
    words: bit r of word w is row 32w + r (rows past R are 0)."""
    batch = matched.shape[0]
    pad = n_words * 32 - matched.shape[1]
    if pad:
        matched = torch.cat([matched, torch.zeros(
            (batch, pad), dtype=torch.bool, device=matched.device)], dim=1)
    bits = matched.reshape(batch, n_words, 32)
    words = torch.zeros((batch, n_words), dtype=torch.int64,
                        device=matched.device)
    for j in range(32):      # [B, W] passes: no [B, W, 32] int64 temporary
        words |= bits[:, :, j].to(torch.int64) << j
    return to_int32_bits(words)


def pack_and_extract(matched, lengths, n_rows: int, max_words: int):
    """Shared tail of the walk: pack the [B, R] matched-row matrix into
    uint32 words and extract the (few) nonzero words sparsely."""
    n_words = max((n_rows + 31) // 32, max_words)
    return extract_nonzero_words(pack_words(matched, n_words), lengths,
                                 max_words)


def extract_nonzero_words(words, lengths, max_words: int):
    """Sparse tail of the walk and of the kernel's plain version: pick the
    ≤max_words nonzero words of ``words`` int32[B, W] (uint32 bits) in
    ascending word order."""
    nz = words != 0
    n_nz = nz.sum(dim=1)
    overflow = (lengths < 0) | (n_nz > max_words)
    # top_k over (nz ? BIG - word_index : -1): picks nonzero words,
    # ascending word index; returns their original indices.
    n = words.shape[1]
    index = torch.arange(n, dtype=torch.int32, device=words.device)
    key = torch.where(nz, (1 << 30) - index[None, :], -1)
    k = min(max_words, n)
    topv, topi = torch.topk(key, k, dim=1, largest=True, sorted=True)
    word_idx = torch.where(topv > 0, topi.to(torch.int32), -1)
    word_val = torch.where(topv > 0, torch.gather(words, 1, topi), 0)
    if k < max_words:        # tiny tables: pad out to the fixed contract
        pad = max_words - k
        word_idx = torch.cat([word_idx, torch.full(
            (word_idx.shape[0], pad), -1, dtype=torch.int32,
            device=words.device)], dim=1)
        word_val = torch.cat([word_val, torch.zeros(
            (word_val.shape[0], pad), dtype=word_val.dtype,
            device=words.device)], dim=1)
    return word_idx, word_val, overflow


class DenseEngine:
    """Device-resident dense matcher bound to a TopicIndex.

    Same contract as the reference's DenseEngine (subscribers /
    subscribers_batch / match_raw + CPU-trie fallback on overflow).
    ``device`` is where the tables live and the program runs: the card
    by default; ``"cpu"`` runs the kernel's plain version, or the walk,
    there (and must be asked for). Each compile picks its route: the
    kernel while the tables fit it, the walk beyond."""

    def __init__(self, index: TopicIndex, max_levels: int = 16,
                 max_words: int = 32, device=None,
                 auto_refresh: bool = True) -> None:
        self.index = index
        self.max_levels = max_levels
        self.max_words = max_words
        self.device = resolve_device(device)
        self.auto_refresh = auto_refresh
        self.kernel_active = False
        # (tables, program): swapped as ONE attribute so a concurrent
        # match_raw always sees a consistent compile
        self._state = None
        self._refresh_lock = threading.Lock()
        self.fallbacks = 0
        self.matches = 0
        self.refresh(force=True)

    # ------------------------------------------------------------------

    def refresh(self, force: bool = False) -> bool:
        """Recompile + upload if the index changed. Cheap no-op otherwise.
        Readers grab self._state once, and refresh replaces it in one
        assignment."""
        with self._refresh_lock:
            state = self._state
            if (not force and state is not None
                    and state[0].version == subs_version(self.index)):
                return False
            tables = compile_dense(self.index)
            from . import dense_kernel
            if dense_kernel.fits(tables):
                program = dense_kernel.KernelMatcher(
                    tables, self.max_levels, self.max_words,
                    device=self.device)
                self.kernel_active = True
                self._state = (tables, program)
                return True
            self.kernel_active = False
            dev = dense_device_tables(dense_arrays(tables), self.device)
            n_rows, max_words = tables.n_rows, self.max_words

            def program(toks, lengths, dollar):
                return dense_match_body(dev["levels"], toks, lengths,
                                        dollar, n_rows=n_rows,
                                        max_words=max_words)

            self._state = (tables, program)
            return True

    @property
    def tables(self) -> DenseTables:
        return self._state[0]

    # ------------------------------------------------------------------

    def _run(self, program, toks, lengths, dollar):
        """Upload one tokenized batch and enqueue the device program:
        (word_idx, word_val, overflow) tensors on the device."""
        dev = self.device
        return program(torch.from_numpy(np.ascontiguousarray(toks)).to(dev),
                       torch.from_numpy(np.ascontiguousarray(lengths)).to(dev),
                       torch.from_numpy(np.ascontiguousarray(dollar)).to(dev))

    @staticmethod
    def _fetch(out):
        """Device outputs -> numpy (word_idx int32, word_val uint32,
        overflow bool)."""
        word_idx, word_val, overflow = (t.cpu().numpy() for t in out)
        return word_idx, word_val.view(np.uint32), overflow

    def match_raw(self, topics: list[str]):
        """Device match of a topic batch. Returns (word_idx int32[B, K],
        word_val uint32[B, K], overflow bool[B], tables)."""
        if self.auto_refresh:
            self.refresh()
        tables, program = self._state
        toks, lengths, dollar = tables.tokenize(topics, self.max_levels)
        # bucket the batch axis as the reference does; per-topic outputs
        # trim clean
        b = len(topics)
        toks, lengths, dollar = pad_topic_batch(toks, lengths, dollar)
        word_idx, word_val, overflow = self._fetch(
            self._run(program, toks, lengths, dollar))
        return word_idx[:b], word_val[:b], overflow[:b], tables

    def match_raw_many(self, batches: list[list[str]]):
        """Match a stack of equal-sized topic batches in one device
        dispatch (one flattened batch: topics are independent). Returns
        (word_idx int32[I, B, K], word_val uint32[I, B, K], overflow
        bool[I, B], tables)."""
        if self.auto_refresh:
            self.refresh()
        tables, program = self._state
        toks, lengths, dollar = [], [], []
        for topics in batches:
            t, ln, d = tables.tokenize(topics, self.max_levels)
            toks.append(t)
            lengths.append(ln)
            dollar.append(d)
        toks = np.stack(toks)
        n, b = toks.shape[:2]
        word_idx, word_val, overflow = self._fetch(self._run(
            program, toks.reshape(n * b, -1), np.stack(lengths).reshape(-1),
            np.stack(dollar).reshape(-1)))
        return (word_idx.reshape(n, b, -1), word_val.reshape(n, b, -1),
                overflow.reshape(n, b), tables)

    def subscribers_batch(self, topics: list[str]) -> list[SubscriberSet]:
        return self.decode_batch(topics, *self.match_raw(topics))

    def decode_batch(self, topics: list[str], word_idx, word_val, overflow,
                     tables: DenseTables) -> list[SubscriberSet]:
        """Host half of ``subscribers_batch`` after ``match_raw``: decode
        each topic's words, the CPU trie for overflow topics (split out
        so harnesses can time fetch and decode apart)."""
        out = []
        for i, topic in enumerate(topics):
            self.matches += 1
            if overflow[i]:
                self.fallbacks += 1
                out.append(self.index.subscribers(topic))
            else:
                out.append(self.decode(word_idx[i], word_val[i], tables))
        return out

    def subscribers(self, topic: str) -> SubscriberSet:
        """Single-topic match (the broker's pluggable-matcher entry point)."""
        return self.subscribers_batch([topic])[0]

    async def subscribers_async(self, topic: str) -> SubscriberSet:
        """Event-loop-friendly match (worker thread)."""
        import asyncio

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self.subscribers, topic)

    @staticmethod
    def decode(word_idx: np.ndarray, word_val: np.ndarray,
               tables: DenseTables,
               into: SubscriberSet | None = None) -> SubscriberSet:
        """Union the matched words' row entry lists into a SubscriberSet."""
        result = SubscriberSet() if into is None else into
        entries = tables.entries
        row_entries = tables.row_entries
        for w, bits in zip(word_idx, word_val):
            if w < 0:
                break
            base = int(w) << 5
            bits = int(bits)
            while bits:
                low = bits & -bits
                row = base + low.bit_length() - 1
                bits ^= low
                if row >= len(row_entries):
                    continue  # padding bits, never set
                for b in row_entries[row]:
                    entry = entries[b]
                    if entry.shared:
                        for cid, sub in entry.candidates.items():
                            result.add_shared(entry.group, sub.filter, cid,
                                              sub)
                    else:
                        sub = entry.subscription
                        result.add(entry.client_id, sub, sub.filter)
        return result


__all__ = ["DenseEngine", "DenseTables", "LevelArrays", "compile_dense",
           "compile_dense_subscriptions", "dense_arrays",
           "dense_device_tables", "dense_match_body", "walk_step",
           "pack_and_extract",
           "extract_nonzero_words", "PLUS", "HASH"]
