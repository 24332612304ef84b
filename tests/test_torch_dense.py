"""The port's dense matcher (``maxmq_tpu_torch.matching.dense``) against
the JAX package's (``maxmq_tpu/matching/dense.py``).

Both packages get the same subscriptions and topics, made from a seed.
The JAX side runs its XLA walk on the CPU and its Pallas kernel K4 in
interpret mode (``DenseEngine(use_pallas=True)``), as its own tests do;
the port runs on the CPU (``device="cpu"``), where the kernel wrapper
runs its plain version. The port's engine has one route (the kernel
while the tables fit, the walk beyond: the reference's "auto"), held
against each of the reference's. Every output is compared exactly: the
compiled tables array for array, the walk, the pack and extract, the raw
(word_idx, word_val, overflow), and the decoded sets, which must also
equal the CPU trie."""

import asyncio
import dataclasses
import os
import random
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from maxmq_tpu.matching import TopicIndex as RefIndex
from maxmq_tpu.matching import dense as ref_dense
from maxmq_tpu.matching.topics import valid_filter
from maxmq_tpu.protocol import Subscription as RefSubscription
from maxmq_tpu_torch.matching import dense, dense_kernel
from maxmq_tpu_torch.matching.batcher import MicroBatcher
from maxmq_tpu_torch.matching.dense import (DenseEngine, compile_dense,
                                            dense_arrays,
                                            dense_device_tables)
from maxmq_tpu_torch.matching.service import MatcherService, ServiceMatcher
from maxmq_tpu_torch.matching.trie import TopicIndex
from maxmq_tpu_torch.protocol import Subscription

from test_nfa_parity import normalize, rand_corpus

# the reference's routes (its use_pallas values), each held against the
# port's one route
MODES = [False, True, "auto"]
MODE_IDS = ["walk", "kernel", "auto"]


def both(subs):
    """(JAX index, port index) holding the same subscriptions, given as
    (client, filter, Subscription keyword arguments)."""
    ref, port = RefIndex(), TopicIndex()
    for cid, f, kw in subs:
        ref.subscribe(cid, RefSubscription(filter=f, **kw))
        port.subscribe(cid, Subscription(filter=f, **kw))
    return ref, port


def rand_subs(seed: int, n_filters: int = 100):
    rng = random.Random(seed)
    filters, topics = rand_corpus(rng, n_filters=n_filters, n_clients=25)
    subs = [(f"c{i % 25}", f, {"qos": rng.randint(0, 2),
                               "identifier": rng.randint(0, 5)})
            for i, f in enumerate(filters) if valid_filter(f)]
    return subs, topics + ["t0/" + "/".join(["t1"] * 30)]


def dense_2k_small(seed: int = 42):
    subs, gen = chip_smoke.build_dense_corpus(
        n_filters=300, n_subs=3000, width=60, seed=seed)
    topics = gen(300, seed2=7) + ["$SYS/l0t1", "$l0t1/l1t2",
                                  "l0t1/" + "/".join(["x"] * 20)]
    return [(c, f, {"qos": q}) for c, f, q in subs], topics


# The cases of the JAX package's tests/test_pallas.py:
# name -> (subscriptions, topics, engine keyword arguments, fallbacks)
CASES = {
    "wildcards": ([("c1", "a/b/c", {"qos": 1}), ("c2", "a/+/c", {"qos": 2}),
                   ("c3", "a/#", {}), ("c4", "#", {}), ("c5", "+", {})],
                  ["a/b/c", "a/x/c", "a", "a/b", "x", "x/y", "a/b/c/d",
                   "$SYS/x", "$SYS"], {}, 0),
    "hash_parent_dollar": ([("c1", "sport/tennis/#", {}),
                            ("c2", "$SYS/#", {}), ("c3", "$SYS/+/x", {}),
                            ("c4", "+/tennis/+", {})],
                           ["sport/tennis", "sport/tennis/p1", "sport",
                            "$SYS/broker/x", "$SYS/broker", "$SYS",
                            "a/tennis/b"], {}, 0),
    "share_merge": ([("w1", "$share/g1/t/+", {}), ("w2", "$share/g1/t/+", {}),
                     ("w3", "$share/g2/t/a", {}),
                     ("c1", "t/+", {"qos": 0, "identifier": 3}),
                     ("c1", "t/a", {"qos": 2, "identifier": 9}),
                     ("c1", "t/#", {"qos": 1, "identifier": 4})],
                    ["t/a", "t/b", "t", "x"], {}, 0),
    "hash_at_max_levels": ([("c1", "l0/l1/l2/l3/#", {})], ["l0/l1/l2/l3"],
                           {"max_levels": 4}, 0),
    "too_deep_falls_back": ([("c1", "a/#", {})],
                            ["a/" + "/".join(str(i) for i in range(40))],
                            {"max_levels": 8}, 1),
    "tile_padding": ([("c1", "a/+", {}), ("c2", "b/#", {})],
                     [f"a/{i}" for i in range(7)] + ["b", "b/x/y", "c"],
                     {}, 0),
}


def assert_raw_equal(got, want):
    """Port (word_idx, word_val, overflow, tables) against the JAX one."""
    for g, w in zip(got[:3], want[:3]):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def check_engines(subs, topics, mode, **kw):
    """The port's engine against the reference's in one of its modes, on
    the same corpus: raw outputs equal, decoded sets equal to each other
    and to the CPU trie, counters equal. Returns the port engine."""
    ref_idx, idx = both(subs)
    ref = ref_dense.DenseEngine(ref_idx, use_pallas=mode, **kw)
    eng = DenseEngine(idx, device="cpu", **kw)
    assert eng.kernel_active == dense_kernel.fits(eng.tables)
    assert_raw_equal(eng.match_raw(topics), ref.match_raw(topics))
    got, want = eng.subscribers_batch(topics), ref.subscribers_batch(topics)
    for topic, g, w in zip(topics, got, want):
        assert normalize(g) == normalize(w) == normalize(
            idx.subscribers(topic)), topic
    assert (eng.matches, eng.fallbacks) == (ref.matches, ref.fallbacks)
    return eng


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax_and_trie(case, mode):
    subs, topics, kw, fallbacks = CASES[case]
    eng = check_engines(subs, topics, mode, **kw)
    assert eng.kernel_active
    assert eng.fallbacks == fallbacks


@pytest.mark.parametrize("mode", [False, True], ids=["walk", "kernel"])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_randomized_engine_parity(seed, mode):
    subs, topics = rand_subs(seed)
    check_engines(subs, topics, mode, max_levels=5)


@pytest.mark.parametrize("mode", [False, True], ids=["walk", "kernel"])
def test_dense_2k_small_matches_jax_and_trie(mode):
    subs, topics = dense_2k_small()
    eng = check_engines(subs, topics, mode)
    assert len(eng.tables.levels) == 8 and dense_kernel.fits(eng.tables)
    assert eng.fallbacks == 1                  # the too-deep topic


def _entry_key(e):
    """Comparable form of an Entry of either package."""
    sub = dataclasses.astuple(e.subscription) if e.subscription else None
    cands = {c: dataclasses.astuple(s) for c, s in e.candidates.items()}
    return (e.client_id, e.group, e.filter, sub, cands)


@pytest.mark.parametrize("corpus", ["rand", "share_merge", "dense_2k_small"])
def test_compile_dense_equals_reference(corpus):
    if corpus == "rand":
        subs, _ = rand_subs(14, n_filters=200)
    elif corpus == "share_merge":
        subs = CASES["share_merge"][0]
    else:
        subs, _ = dense_2k_small(seed=5)
    ref_idx, idx = both(subs)
    ref, got = ref_dense.compile_dense(ref_idx), compile_dense(idx)
    assert (got.n_rows, got.version, got.vocab) == (ref.n_rows, ref.version,
                                                    ref.vocab)
    assert len(got.levels) == len(ref.levels)
    for g, r in zip(got.levels, ref.levels):
        for name in ("child_tok", "parent_idx", "emit_exact"):
            a, b = getattr(g, name), getattr(r, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.row_entries == ref.row_entries
    assert [_entry_key(e) for e in got.entries] == \
        [_entry_key(e) for e in ref.entries]


def _jax_consts(arrays):
    return tuple((jnp.asarray(ct), jnp.asarray(pi), jnp.asarray(ee))
                 for ct, pi, ee in zip(arrays["child_tok"],
                                       arrays["parent_idx"],
                                       arrays["emit_exact"]))


@pytest.mark.parametrize("seed,max_levels", [(21, 8), (22, 3), (23, 1)])
def test_dense_match_body_matches_jax_walk(seed, max_levels):
    """The walk alone, on the JAX tables' arrays, including levels cut by
    a tokenizer window shallower than the trie."""
    subs, topics = rand_subs(seed)
    ref_idx, _ = both(subs)
    tables = ref_dense.compile_dense(ref_idx)
    arrays = dense_arrays(tables)
    toks, lengths, dollar = tables.tokenize(topics, max_levels)
    want = ref_dense.dense_match_body(
        _jax_consts(arrays), jnp.asarray(toks), jnp.asarray(lengths),
        jnp.asarray(dollar), n_rows=tables.n_rows, max_words=4)
    dev = dense_device_tables(arrays, "cpu")
    got = dense.dense_match_body(
        dev["levels"], torch.from_numpy(toks), torch.from_numpy(lengths),
        torch.from_numpy(dollar), n_rows=tables.n_rows, max_words=4)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy().view(np.uint32),
                          np.asarray(want[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("n_rows,width,max_words",
                         [(70, 70, 1), (300, 290, 4), (5, 5, 32)])
def test_pack_and_extract_matches_jax(n_rows, width, max_words):
    """Random matched-row matrices (narrower than n_rows, as when levels
    are cut), with too-deep rows and words of bit 31."""
    rng = np.random.default_rng(n_rows)
    matched = rng.random((64, width)) < 0.05
    matched[:, 31:width:32] |= rng.random((64, len(range(31, width, 32)))) < .5
    lengths = rng.integers(-1, 6, size=64).astype(np.int32)
    want = ref_dense.pack_and_extract(jnp.asarray(matched),
                                      jnp.asarray(lengths), n_rows, max_words)
    got = dense.pack_and_extract(torch.from_numpy(matched),
                                 torch.from_numpy(lengths), n_rows, max_words)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy().view(np.uint32),
                          np.asarray(want[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


def test_extract_nonzero_words_pads_small_word_sets():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 32, size=(40, 3), dtype=np.uint64)
    words[rng.random((40, 3)) < 0.4] = 0
    words = words.astype(np.uint32)
    lengths = np.full(40, 2, dtype=np.int32)
    want = ref_dense.extract_nonzero_words(jnp.asarray(words),
                                           jnp.asarray(lengths), 8)
    got = dense.extract_nonzero_words(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(lengths), 8)
    assert got[0].shape == (40, 8)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy().view(np.uint32),
                          np.asarray(want[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


def test_capacity_gate():
    """The route follows the capacity gate on every compile: the kernel
    while the tables fit, the walk with kernel_active false once the
    index outgrows it (the reference's "auto"; its use_pallas=True
    raises there), and the kernel again when it shrinks back."""
    subs = [(f"c{i}", f"t/{i}", {}) for i in range(3000)]
    ref_idx, idx = both(subs[:100])
    eng = DenseEngine(idx, device="cpu")
    ref = ref_dense.DenseEngine(ref_idx, use_pallas="auto")
    assert eng.kernel_active and ref.pallas_active
    topics = ["t/7", "t/2999", "t/x", "t"]
    assert_raw_equal(eng.match_raw(topics), ref.match_raw(topics))
    for cid, f, _kw in subs[100:]:
        ref_idx.subscribe(cid, RefSubscription(filter=f))
        idx.subscribe(cid, Subscription(filter=f))
    assert not dense_kernel.fits(compile_dense(idx))
    with pytest.raises(ValueError):
        ref_dense.DenseEngine(ref_idx, use_pallas=True)
    assert_raw_equal(eng.match_raw(topics), ref.match_raw(topics))
    assert not eng.kernel_active and not ref.pallas_active
    assert sorted(eng.subscribers("t/2999").subscriptions) == ["c2999"]
    for cid, f, _kw in subs[100:]:
        idx.unsubscribe(cid, f)
    assert sorted(eng.subscribers("t/7").subscriptions) == ["c7"]
    assert eng.kernel_active


@pytest.mark.parametrize("mode", [False, True], ids=["walk", "kernel"])
def test_match_raw_many_matches_jax(mode):
    subs, topics = rand_subs(15)
    topics = topics[:96]
    batches = [topics[i:i + 32] for i in range(0, 96, 32)]
    ref_idx, idx = both(subs)
    ref = ref_dense.DenseEngine(ref_idx, use_pallas=mode, max_levels=6)
    eng = DenseEngine(idx, device="cpu", max_levels=6)
    got, want = eng.match_raw_many(batches), ref.match_raw_many(batches)
    assert got[0].shape == (3, 32, 32)
    assert_raw_equal(got, want)
    # the same rows as one batch at a time
    for i, batch in enumerate(batches):
        one = eng.match_raw(batch)
        assert np.array_equal(got[0][i], one[0])
        assert np.array_equal(got[1][i], one[1])


def test_device_tables_equal_from_either_package():
    """dense_arrays of the JAX tables and of the port's give the same
    device state, for the walk and for the kernel."""
    subs, _ = rand_subs(16)
    ref_idx, idx = both(subs)
    a_ref = dense_arrays(ref_dense.compile_dense(ref_idx))
    a_port = dense_arrays(compile_dense(idx))
    d_ref = dense_device_tables(a_ref, "cpu")
    d_port = dense_device_tables(a_port, "cpu")
    assert d_ref["n_rows"] == d_port["n_rows"] > 0
    assert len(d_ref["levels"]) == len(d_port["levels"])
    for lr, lp in zip(d_ref["levels"], d_port["levels"]):
        for tr, tp in zip(lr, lp):
            assert tr.dtype == tp.dtype and torch.equal(tr, tp)
    k_ref = dense_kernel.device_stage(dense_kernel.stage(a_ref), "cpu")
    k_port = dense_kernel.device_stage(dense_kernel.stage(a_port), "cpu")
    for name in ("child_tok", "parent_idx", "emit_exact", "meta"):
        assert torch.equal(k_ref[name], k_port[name]), name


def test_empty_index_and_refresh():
    """No subscriptions (one empty staged level), then a subscription
    picked up by auto_refresh, against every reference mode. On an empty
    index the
    reference's Pallas route raises (its staged level lists are empty),
    so the empty case is held against its walk."""
    for mode in MODES:
        ref_idx, idx = both([])
        walk = ref_dense.DenseEngine(ref_idx)
        eng = DenseEngine(idx, device="cpu")
        assert_raw_equal(eng.match_raw(["a", "$x"]),
                         walk.match_raw(["a", "$x"]))
        ref = ref_dense.DenseEngine(ref_idx, use_pallas=mode)
        assert not eng.subscribers("a").subscriptions
        for i in (ref_idx, idx):
            pkg = RefSubscription if i is ref_idx else Subscription
            i.subscribe("c1", pkg(filter="a/+", qos=1))
        assert_raw_equal(eng.match_raw(["a/b", "a"]),
                         ref.match_raw(["a/b", "a"]))
        assert eng.subscribers("a/b").subscriptions["c1"].qos == 1
        assert not eng.refresh()                     # already current


async def test_subscribers_async_and_decode_into():
    subs = CASES["share_merge"][0]
    _ref_idx, idx = both(subs)
    eng = DenseEngine(idx, device="cpu")
    got = await eng.subscribers_async("t/a")
    assert normalize(got) == normalize(idx.subscribers("t/a"))
    word_idx, word_val, _over, tables = eng.match_raw(["t/b", "t/a"])
    into = eng.decode(word_idx[0], word_val[0], tables)
    merged = eng.decode(word_idx[1], word_val[1], tables, into=into)
    assert merged is into
    want = idx.subscribers("t/b")
    for cid, sub in idx.subscribers("t/a").subscriptions.items():
        want.add(cid, sub, sub.filter)
    for (g, f), members in idx.subscribers("t/a").shared.items():
        for cid, sub in members.items():
            want.add_shared(g, f, cid, sub)
    assert normalize(merged) == normalize(want)


def _sock_path() -> str:
    return os.path.join(tempfile.mkdtemp(prefix="maxmq-torch-dense-"),
                        "m.sock")


async def test_service_with_dense_engine_factory():
    """The port's MatcherService serving through the dense engine: the
    factory is the only new code on the service path."""
    subs, topics = dense_2k_small(seed=6)
    path = _sock_path()
    svc = MatcherService(path, engine_factory=lambda index: MicroBatcher(
        DenseEngine(index, device="cpu"), window_us=0,
        cpu_bypass=False))
    await svc.start()
    try:
        m = ServiceMatcher(path)
        await m.connect()
        want = TopicIndex()
        for cid, f, kw in subs:
            m.forward_subscribe(cid, Subscription(filter=f, **kw))
            want.subscribe(cid, Subscription(filter=f, **kw))
        got = await m.subscribers_batch_async(topics)
        for t, g in zip(topics, got):
            assert normalize(g) == normalize(want.subscribers(t)), t
        single = await asyncio.gather(*(m.enqueue(t) for t in topics[:40]))
        assert [normalize(g) for g in single] == \
            [normalize(g) for g in got[:40]]
        assert svc.index.subscription_count == len(subs)
        await m.close()
    finally:
        await svc.close()
    engine = svc.matcher.engine
    assert engine.kernel_active and engine.matches >= len(topics)
