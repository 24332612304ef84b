"""The fused dense kernel's function (walk, pack and sparse extract in one
launch) against the JAX package's Pallas dense matcher, and the kernel's
staged layout and dataflow.

``dense_walk_words_plain`` is the kernel's plain version; the JAX side runs
``PallasMatcher`` (the Pallas kernel in interpret mode, then its pack and
top_k) on the CPU, as its own tests do. ``emulate_kernel`` repeats the CUDA
kernel's dataflow in numpy — 32 topics a warp, each slot's parent read
through the staged (word offset, bit mask) entry, the state word built from
the per-chunk '+', '#' and exact masks, the extract streamed word by word —
so the staged encoding and the kernel's formulas are held against the plain
version here; tests/test_torch_gpu.py holds the CUDA kernel itself against
the plain version on the card."""

import random

import numpy as np
import pytest
import torch

import chip_smoke
from maxmq_tpu.matching import TopicIndex as RefIndex
from maxmq_tpu.matching import pallas_kernel as ref_pk
from maxmq_tpu.matching.dense import compile_dense as ref_compile
from maxmq_tpu.matching.dense import DenseEngine as RefDenseEngine
from maxmq_tpu.matching.topics import pad_topic_batch as ref_pad
from maxmq_tpu.matching.topics import valid_filter
from maxmq_tpu.protocol import Subscription as RefSubscription
from maxmq_tpu_torch.matching import dense_kernel as dk
from maxmq_tpu_torch.matching.dense import HASH, PLUS, dense_arrays

MAX_LEVELS = 16


def dense_index(full_width: bool):
    """A ``dense_2k``-shaped table (one subscription per filter: 2,000 rows,
    8 levels) or a narrow one, with topics that cover '$' topics, a
    too-deep topic, an empty topic and topics one level past the tree."""
    kw = ({"n_filters": 2000, "n_subs": 2000} if full_width else
          {"n_filters": 40, "n_subs": 400, "width": 20, "seed": 43})
    subs, gen = chip_smoke.build_dense_corpus(**kw)
    idx = RefIndex()
    for cid, f, qos in subs:
        idx.subscribe(cid, RefSubscription(filter=f, qos=qos))
    topics = gen(300, seed2=7)
    topics += ["$SYS/l0t1", "$" + topics[0], topics[1] + "/a" * 20, ""]
    return idx, topics


_TABLES = {}


def tables_for(name: str):
    if name not in _TABLES:
        idx, topics = dense_index(name == "dense_2k")
        _TABLES[name] = (ref_compile(idx), topics)
    return _TABLES[name]


@pytest.mark.parametrize("max_words", [1, 4, 32, 100])
@pytest.mark.parametrize("table", ["dense_2k", "narrow"])
def test_fused_plain_matches_pallas_matcher(table, max_words):
    """(word_idx, word_val, overflow) of every row of a bucket-padded
    batch, max_words below and above the table's words."""
    tables, topics = tables_for(table)
    toks, lengths, dollar = ref_pad(*tables.tokenize(topics, MAX_LEVELS))
    assert len(lengths) > len(topics)                # bucket-pad rows
    assert (lengths < 0).sum() == 1                  # the too-deep topic
    ref = ref_pk.PallasMatcher(tables, MAX_LEVELS, max_words)
    want = [np.asarray(x) for x in ref(toks, lengths, dollar)]
    port = dk.KernelMatcher(tables, MAX_LEVELS, max_words, device="cpu")
    got = [t.numpy() for t in port(toks, lengths, dollar)]
    assert got[0].shape == got[1].shape == (len(lengths), max_words)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1].view(np.uint32), want[1])
    assert np.array_equal(got[2], want[2])
    row_words = (tables.n_rows + 31) // 32
    n_nz = (want[0] >= 0).sum(axis=1)
    # real matches; dense_2k topics reach several words
    assert n_nz.max() >= (min(max_words, 2) if table == "dense_2k" else 1)
    if max_words == 1 and table == "dense_2k":
        # topics with more nonzero words than max_words overflow, their
        # first word still extracted
        over = want[2] & (lengths >= 0)
        assert over.any() and (want[0][over, 0] >= 0).all()
    if max_words > row_words:
        assert (want[0][:, row_words:] == -1).all()


def test_fused_plain_on_empty_index_matches_reference_walk():
    """F8: the reference's Pallas route raises on an empty index; the
    port's kernel route matches nothing there, as the reference's walk."""
    idx = RefIndex()
    topics = ["a/b", "$SYS/x", "", "a/" + "/".join("b" * 20)]
    walk = RefDenseEngine(idx, max_levels=MAX_LEVELS, max_words=4)
    want = walk.match_raw(topics)[:3]
    tables = ref_compile(idx)
    toks, lengths, dollar = ref_pad(*tables.tokenize(topics, MAX_LEVELS))
    got = [t.numpy()[:len(topics)] for t in dk.KernelMatcher(
        tables, MAX_LEVELS, 4, device="cpu")(toks, lengths, dollar)]
    assert np.array_equal(got[0], want[0]) and (got[0] == -1).all()
    assert np.array_equal(got[1].view(np.uint32), want[1])
    assert np.array_equal(got[2], want[2]) and got[2].sum() == 1


def _staged(name):
    tables, _ = tables_for(name)
    return dk.stage(dense_arrays(tables), max_levels=MAX_LEVELS)


@pytest.mark.parametrize("table", ["dense_2k", "narrow"])
def test_slot_entries_decode_to_stage(table):
    """Each slot's {child_tok, parent word byte offset, parent bit} entry
    reads back to ``stage``'s child_tok and parent_idx."""
    pt = _staged(table)
    ent = dk.slot_entries(pt)
    assert ent.shape == (pt.n_levels, pt.slots, 4) and ent.dtype == np.int32
    assert np.array_equal(ent[..., 0], pt.child_tok)
    assert (ent[..., 1] % 128 == 0).all() and (ent[..., 3] == 0).all()
    mask = ent[..., 2].view(np.uint32)
    assert (np.bitwise_count(mask) == 1).all()
    bit = np.log2(mask.astype(np.float64)).astype(np.int64)
    assert np.array_equal(ent[..., 1] // 128 * 32 + bit, pt.parent_idx)


@pytest.mark.parametrize("table", ["dense_2k", "narrow"])
def test_chunk_masks_match_stage(table):
    """Each chunk's '+', '#' and exact masks hold bit i for slot 32c + i
    exactly when ``stage``'s arrays say so."""
    pt = _staged(table)
    m = dk.chunk_masks(pt).view(np.uint32)
    assert m.shape == (pt.n_levels, pt.slots // 32, 4)
    bits = (m[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    bits = bits.transpose(0, 1, 3, 2).reshape(pt.n_levels, pt.slots, 4)
    exact = np.zeros((pt.n_levels, pt.slots), dtype=bool)
    for l, t in enumerate(pt.n_emit):
        exact[l, :t] = pt.emit_exact[l, :t] != 0
    assert np.array_equal(bits[..., 0] == 1, pt.child_tok == PLUS)
    assert np.array_equal(bits[..., 1] == 1, pt.child_tok == HASH)
    assert np.array_equal(bits[..., 2] == 1, exact)
    assert not bits[..., 3].any()
    assert (pt.child_tok == PLUS).any() and exact.any()


def emulate_kernel(toks, lengths, dollar, kt: dict, max_words: int):
    """The CUDA kernel's dataflow in numpy, one warp of 32 topics at a
    time (lanes are array positions)."""
    tab = kt["slot_tab"].numpy().astype(np.int64)
    masks = kt["chunk_masks"].numpy().view(np.uint32)
    width, n_emit, emit_base = (kt["meta"].numpy()[i] for i in range(3))
    toks, lengths, dollar = toks.numpy(), lengths.numpy(), dollar.numpy()
    batch, n_cols = toks.shape
    full = np.uint32(0xFFFFFFFF)
    word_idx = np.full((batch, max_words), -1, dtype=np.int32)
    word_val = np.zeros((batch, max_words), dtype=np.uint32)
    overflow = np.zeros(batch, dtype=bool)
    for base in range(0, batch, 32):
        lanes = np.arange(base, min(base + 32, batch))
        n = len(lanes)
        prev = np.full((16, n), full)                # [word][lane]
        cur = np.zeros((16, n), dtype=np.uint32)
        open_idx = np.full(n, -1)
        open_val = np.zeros(n, dtype=np.uint32)
        count = np.zeros(n, dtype=np.int64)

        def close(lane):
            if open_idx[lane] >= 0:
                if count[lane] < max_words:
                    word_idx[lanes[lane], count[lane]] = open_idx[lane]
                    word_val[lanes[lane], count[lane]] = open_val[lane]
                count[lane] += 1

        def add(r, v):
            for lane in np.nonzero(v)[0]:
                if open_idx[lane] != r:
                    close(lane)
                    open_idx[lane], open_val[lane] = r, 0
                open_val[lane] |= v[lane]

        alive = np.ones(n, dtype=bool)
        for l in range(kt["n_levels"]):
            if not alive.any():
                break
            tok = (toks[lanes, l] if l < n_cols else np.full(n, -1))
            wild_ok = ~dollar[lanes] if l == 0 else np.ones(n, dtype=bool)
            plus_on = np.where(wild_ok & (tok >= 0), full, np.uint32(0))
            hash_on = np.where(wild_ok, full, np.uint32(0))
            any_emit = np.where(lengths[lanes] == l + 1, full, np.uint32(0))
            any_bits = np.zeros(n, dtype=np.uint32)
            for c in range(-(-int(width[l]) // 32)):
                par = np.zeros(n, dtype=np.uint32)
                eq = np.zeros(n, dtype=np.uint32)
                for i in range(32):
                    ct, off, pm, _ = tab[l, c * 32 + i]
                    pw = prev[off // 128]
                    p = (pw & np.uint32(pm & 0xFFFFFFFF)) != 0
                    par |= np.where(p, np.uint32(1 << i), np.uint32(0))
                    eq |= np.where(p & (tok == ct), np.uint32(1 << i),
                                   np.uint32(0))
                plus, hsh, ex, _ = masks[l, c]
                word = eq | (par & ((plus & plus_on) | (hsh & hash_on)))
                cur[c] = word
                any_bits |= word
                left = int(n_emit[l]) - c * 32
                if left > 0:
                    emitters = full if left >= 32 else np.uint32(
                        (1 << left) - 1)
                    em = word & emitters & (any_emit | ~ex)
                    r, sh = (int(emit_base[l]) >> 5) + c, int(emit_base[l]) & 31
                    add(r, em << np.uint32(sh))
                    if sh:
                        add(r + 1, em >> np.uint32(32 - sh))
            alive = any_bits != 0
            prev, cur = cur, prev
        for lane in range(n):
            close(lane)
        overflow[lanes] = (lengths[lanes] < 0) | (count > max_words)
    return word_idx, word_val.view(np.int32), overflow


@pytest.mark.parametrize("max_words", [1, 32])
@pytest.mark.parametrize("table", ["dense_2k", "narrow"])
def test_kernel_dataflow_matches_plain(table, max_words):
    tables, topics = tables_for(table)
    toks, lengths, dollar = (torch.from_numpy(a) for a in ref_pad(
        *tables.tokenize(topics, MAX_LEVELS)))
    kt = dk.device_stage(dk.stage(dense_arrays(tables),
                                  max_levels=MAX_LEVELS), "cpu")
    want = dk.dense_walk_words_plain(toks, lengths, dollar, kt, max_words)
    got = emulate_kernel(toks, lengths, dollar, kt, max_words)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    assert (want[0][:, 0] >= 0).sum() > len(topics) // 8


def test_random_tables_dataflow_matches_plain():
    """Random corpora with '+' and '#' at every depth, '$' topics and
    emitter prefixes that straddle word boundaries."""
    from test_nfa_parity import rand_corpus

    rng = random.Random(61)
    filters, topics = rand_corpus(rng, n_filters=150, n_clients=20)
    idx = RefIndex()
    for i, f in enumerate(filters):
        if valid_filter(f):
            idx.subscribe(f"c{i % 20}", RefSubscription(filter=f, qos=0))
    tables = ref_compile(idx)
    topics += ["$SYS/t1", "t1/" + "/".join(["t2"] * 30)]
    toks, lengths, dollar = (torch.from_numpy(a) for a in ref_pad(
        *tables.tokenize(topics, 6)))
    kt = dk.device_stage(dk.stage(dense_arrays(tables), max_levels=6), "cpu")
    assert any(b % 32 for b in kt["emit_base"] if b)
    want = dk.dense_walk_words_plain(toks, lengths, dollar, kt, 3)
    got = emulate_kernel(toks, lengths, dollar, kt, 3)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
