"""The port's signature-table compiler (maxmq_tpu_torch.matching.sig_tables)
against the JAX package's: on the same subscriptions both must produce
bit-equal device arrays, the same group order and the same row layout.
Tolerance: exact (integer tables)."""

import random

import numpy as np
import pytest

from bench import build_corpus
from maxmq_tpu.matching import TopicIndex as RefIndex
from maxmq_tpu.matching.sig import compile_sig as ref_compile_sig
from maxmq_tpu.matching.topics import valid_filter
from maxmq_tpu.protocol import Subscription as RefSubscription
from maxmq_tpu_torch.matching import sig_tables
from maxmq_tpu_torch.matching.trie import TopicIndex
from maxmq_tpu_torch.protocol import Subscription

from test_nfa_parity import rand_corpus

ARRAYS = ("row_sig", "row_sig16", "fold_mult", "group_w16", "group_words",
          "topo_coef", "depth_coef", "min_depth", "is_hash", "wild_first")


def twin_indexes(filters, rng):
    """The same subscriptions in a reference index and a port index."""
    ref, port = RefIndex(), TopicIndex()
    for i, f in enumerate(filters):
        if not valid_filter(f):
            continue
        cid, qos, ident = f"c{i % 30}", rng.randint(0, 2), rng.randint(0, 5)
        ref.subscribe(cid, RefSubscription(filter=f, qos=qos,
                                           identifier=ident))
        port.subscribe(cid, Subscription(filter=f, qos=qos,
                                         identifier=ident))
    return ref, port


def entry_key(e):
    sub = e.subscription
    return (e.client_id, e.group, e.filter,
            None if sub is None else (sub.filter, sub.qos, sub.identifier),
            tuple(sorted((c, s.qos) for c, s in e.candidates.items())))


def assert_same_tables(ref, port):
    for name in ARRAYS:
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    assert [(g.is_hash, g.depth, g.kept, g.rows) for g in ref.groups] == \
        [(g.is_hash, g.depth, g.kept, g.rows) for g in port.groups]
    assert ref.row_levels == port.row_levels
    assert ref.row_entries == port.row_entries
    assert [entry_key(e) for e in ref.entries] == \
        [entry_key(e) for e in port.entries]
    assert ref.vocab == port.vocab
    assert (ref.n_rows, ref.max_depth, ref.probe_depth, ref.version) == \
        (port.n_rows, port.max_depth, port.probe_depth, port.version)
    assert sorted(ref.host_exact) == sorted(port.host_exact)
    for d in ref.host_exact:
        assert np.array_equal(ref.host_exact[d].sigs, port.host_exact[d].sigs)
        assert np.array_equal(ref.host_exact[d].rows, port.host_exact[d].rows)
    for name in ("host_plus", "host_hash"):
        rp, pp = getattr(ref, name), getattr(port, name)
        assert sorted(rp) == sorted(pp), name
        for d in rp:
            for field in ("coef", "dc", "wildf"):
                assert np.array_equal(getattr(rp[d], field),
                                      getattr(pp[d], field)), (name, field)
            for s1, s2 in zip(rp[d].sigs + rp[d].rows,
                              pp[d].sigs + pp[d].rows):
                assert np.array_equal(s1, s2), name


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_compile_matches_reference_on_rand_corpus(seed):
    rng = random.Random(seed)
    filters, _ = rand_corpus(rng, n_filters=300, n_clients=30)
    ref, port = twin_indexes(filters, random.Random(seed + 100))
    assert_same_tables(ref_compile_sig(ref), sig_tables.compile_sig(port))


@pytest.mark.parametrize("share_frac", [0.0, 0.1])
def test_compile_matches_reference_on_bench_corpus(share_frac):
    filters, _ = build_corpus(2000, seed=7, share_frac=share_frac)
    ref, port = twin_indexes(filters, random.Random(3))
    r, p = ref_compile_sig(ref), sig_tables.compile_sig(port)
    assert_same_tables(r, p)
    assert p.group_w16.any()          # 16-bit planes are exercised


def test_host_probes_match_reference():
    """prepare_batch's numpy host half (tokens, length encoding, exact and
    '+' candidate rows) and the '#' host probe equal the reference's."""
    from maxmq_tpu.matching import sig as ref_sig

    filters, topic_gen = build_corpus(1500, seed=11, share_frac=0.1)
    ref, port = twin_indexes(filters, random.Random(5))
    rt, pt = ref_compile_sig(ref), sig_tables.compile_sig(port)
    topics = topic_gen(200, seed2=3) + ["$SYS/x", "a0/b1", "/".join(["c2"] * 90)]
    r_toks, r_lens, r_toks32, r_lengths = ref_sig.tokenize_compact(rt,
                                                                   topics)
    p_toks, p_lens, p_toks32, p_lengths = sig_tables.tokenize_compact(
        pt, topics)
    assert r_toks.dtype == p_toks.dtype
    assert np.array_equal(r_toks, p_toks) and np.array_equal(r_lens, p_lens)
    r_rows = ref_sig.host_exact_rows(rt, r_toks32, r_lengths)
    ref_sig.host_plus_rows(rt, r_toks, r_lengths, r_lens < 0, into=r_rows)
    _, _, p_rows = sig_tables.prepare_batch(pt, topics)
    assert [sorted(r.tolist()) for r in r_rows] == \
        [sorted(r.tolist()) for r in p_rows]
    r_hash = ref_sig.host_hash_rows(rt, r_toks, r_lengths, r_lens < 0)
    p_hash = sig_tables.host_hash_rows(pt, p_toks, p_lengths, p_lens < 0)
    assert [sorted(r.tolist()) for r in r_hash] == \
        [sorted(r.tolist()) for r in p_hash]
