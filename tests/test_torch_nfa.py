"""The port's NFA engine (``maxmq_tpu_torch.matching.nfa`` and
``engine``) against the JAX package's (``maxmq_tpu/matching/nfa.py``,
``engine.py``).

Both packages get the same subscriptions and topics, made from a seed.
The JAX side runs its jitted ``match_batch_device`` on the CPU; the port
runs its torch level loop on the CPU (``device="cpu"``). Every output is
integer and compared exactly: the compiled tables array for array, the
hash, the device function's (rows, overflow) on the JAX package's own
numpy tables, and the decoded sets, which must also equal the CPU trie."""

import asyncio
import os
import random
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxmq_tpu import faults as ref_faults
from maxmq_tpu.matching import TopicIndex as RefIndex
from maxmq_tpu.matching import engine as ref_engine
from maxmq_tpu.matching import nfa as ref_nfa
from maxmq_tpu.matching.topics import pad_topic_batch as ref_pad
from maxmq_tpu.matching.topics import valid_filter
from maxmq_tpu.protocol import Subscription as RefSubscription
from maxmq_tpu_torch import faults
from maxmq_tpu_torch.matching import nfa
from maxmq_tpu_torch.matching.batcher import MicroBatcher
from maxmq_tpu_torch.matching.engine import (NFAEngine, match_batch_body,
                                             nfa_device_tables)
from maxmq_tpu_torch.matching.service import MatcherService, ServiceMatcher
from maxmq_tpu_torch.matching.trie import TopicIndex
from maxmq_tpu_torch.protocol import Subscription

from test_nfa_parity import normalize, rand_corpus

ARRAYS = ("hash_node", "hash_tok", "hash_val", "plus_child", "node_mask",
          "hash_mask")


def both(subs):
    """(JAX index, port index) holding the same subscriptions, given as
    (client, filter, Subscription keyword arguments)."""
    ref, port = RefIndex(), TopicIndex()
    for cid, f, kw in subs:
        ref.subscribe(cid, RefSubscription(filter=f, **kw))
        port.subscribe(cid, Subscription(filter=f, **kw))
    return ref, port


def rand_subs(seed: int, n_filters: int = 120):
    rng = random.Random(seed)
    filters, topics = rand_corpus(rng, n_filters=n_filters, n_clients=30)
    subs = [(f"c{i % 30}", f, {"qos": rng.randint(0, 2),
                               "identifier": rng.randint(0, 5)})
            for i, f in enumerate(filters) if valid_filter(f)]
    return subs, topics + ["t0/" + "/".join(["t1"] * 30), "$t1/t2", ""]


def basic_subs():
    return [("c1", "a/b/c", {"qos": 1}), ("c2", "a/+/c", {"qos": 2}),
            ("c3", "a/#", {}), ("c4", "#", {}), ("c5", "+", {}),
            ("c6", "$SYS/#", {}), ("c7", "$SYS/+/x", {}),
            ("w1", "$share/g1/t/+", {}), ("w2", "$share/g1/t/+", {}),
            ("c1", "m/+", {"qos": 0, "identifier": 3}),
            ("c1", "m/x", {"qos": 2, "identifier": 9}),
            ("c8", "/", {}), ("c9", "a//b", {})]


BASIC_TOPICS = ["a/b/c", "a/x/c", "a", "a/b", "x", "x/y", "a/b/c/d",
                "$SYS/x", "$SYS", "$SYS/b/x", "t/a", "t", "m/x", "m/y",
                "/", "a//b", "never-seen/x", ""]

# name -> (subscriptions, extra topics)
CORPORA = {
    "empty": ([], []),
    "basic": (basic_subs(), []),
    "probe_growth": ([("c", f"lvl{i}/x{i % 7}/end", {}) for i in range(500)],
                     ["lvl3/x3/end", "lvl3/x4/end"]),
    "random1": rand_subs(1),
    "random2": rand_subs(2),
}


def corpus(name):
    subs, extra = CORPORA[name]
    if name.startswith("random"):
        return subs, extra
    return subs, BASIC_TOPICS + extra


def assert_tables_equal(got, want):
    for name in ARRAYS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert got.n_nodes == want.n_nodes
    assert got.row_entries == want.row_entries
    assert got.vocab == want.vocab
    assert got.version == want.version
    assert [(e.client_id, e.group, e.filter, sorted(e.candidates))
            for e in got.entries] == \
        [(e.client_id, e.group, e.filter, sorted(e.candidates))
         for e in want.entries]


def test_hash32_t_equals_numpy_hash32():
    rng = np.random.default_rng(3)
    edge = np.array([-1, 0, 1, 2**31 - 1, -2**31, 7], dtype=np.int32)
    node = np.concatenate([np.repeat(edge, len(edge)),
                           rng.integers(-2**31, 2**31, 4096)]).astype(np.int32)
    tok = np.concatenate([np.tile(edge, len(edge)),
                          rng.integers(-2**31, 2**31, 4096)]).astype(np.int32)
    want = ref_nfa.hash32(node, tok)
    got = nfa.hash32_t(torch.from_numpy(node), torch.from_numpy(tok))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert np.array_equal(nfa.hash32(node, tok), want)
    mask = 255
    assert np.array_equal(nfa.hash_slot(node, tok, mask),
                          ref_nfa.hash_slot(node, tok, mask))


@pytest.mark.parametrize("name", list(CORPORA))
def test_compiled_tables_equal_reference(name):
    subs, _topics = corpus(name)
    ref, port = both(subs)
    got, want = nfa.compile_trie(port), ref_nfa.compile_trie(ref)
    assert_tables_equal(got, want)
    if name == "probe_growth":
        # the builder grew the table past 2 x edges to keep the bound
        mask = got.table_size - 1
        for slot in np.flatnonzero(got.hash_node >= 0):
            base = int(nfa.hash_slot(got.hash_node[slot:slot + 1],
                                     got.hash_tok[slot:slot + 1], mask)[0])
            assert (int(slot) - base) & mask < nfa.MAX_PROBES


def test_fixed_table_size_raises_table_full():
    subs = [("c", f"lvl{i}/x{i % 7}/end", {}) for i in range(200)]
    ref, port = both(subs)
    psubs, rsubs = port.all_subscriptions(), ref.all_subscriptions()
    for size in (8, 64):
        with pytest.raises(nfa.TableFull):
            nfa.compile_subscriptions(psubs, table_size=size)
        with pytest.raises(ref_nfa.TableFull):
            ref_nfa.compile_subscriptions(rsubs, table_size=size)
    size = nfa.compile_subscriptions(psubs).table_size * 2
    assert_tables_equal(nfa.compile_subscriptions(psubs, 3, table_size=size),
                        ref_nfa.compile_subscriptions(rsubs, 3,
                                                      table_size=size))


def test_shared_vocab_across_shards():
    subs, _ = rand_subs(4)
    ref, port = both(subs)
    psubs, rsubs = port.all_subscriptions(), ref.all_subscriptions()
    pvocab, rvocab = {}, {}
    for k in range(3):
        got = nfa.compile_subscriptions(psubs[k::3], 1, vocab=pvocab)
        want = ref_nfa.compile_subscriptions(rsubs[k::3], 1, vocab=rvocab)
        assert_tables_equal(got, want)
        assert got.vocab is pvocab
    assert pvocab == rvocab


# name -> (corpus, engine keyword arguments): the overflow causes
BODY_CASES = {
    "basic": ("basic", {}),
    "random": ("random1", {}),
    "width_overflow": ("wide", {"width": 2}),
    "max_rows_overflow": ("random2", {"max_rows": 2}),
    "too_deep": ("random1", {"max_levels": 4}),
    "empty": ("empty", {}),
}


def wide_corpus():
    """8 overlapping '+' filters: the active set explodes past width 2."""
    subs = []
    for i in range(8):
        pattern = [("+" if (i >> b) & 1 else "L") for b in range(3)]
        subs.append((f"c{i}", "/".join(pattern), {}))
    return subs, ["L/L/L", "L/x/L", "L", "$L/L/L"]


@pytest.mark.parametrize("case", list(BODY_CASES))
def test_match_batch_body_equals_reference(case):
    """The port's device function fed the JAX package's numpy tables and
    tokenized, bucket-padded batch equals ``match_batch_device``."""
    cname, kw = BODY_CASES[case]
    subs, topics = wide_corpus() if cname == "wide" else corpus(cname)
    ref, _port = both(subs)
    tables = ref_nfa.compile_trie(ref)
    width = kw.get("width", 32)
    max_levels = kw.get("max_levels", 16)
    max_rows = kw.get("max_rows", 128)
    arrays = ref_pad(*tables.tokenize(topics, max_levels))
    assert len(arrays[1]) > len(topics)          # pad rows ride along
    want = ref_engine.match_batch_device(
        *[jnp.asarray(getattr(tables, n)) for n in ARRAYS],
        *[jnp.asarray(a) for a in arrays], width=width,
        table_mask=tables.table_size - 1, max_rows=max_rows)
    got = match_batch_body(
        *nfa_device_tables(tables, "cpu"),
        *[torch.from_numpy(a) for a in arrays], width=width,
        table_mask=tables.table_size - 1, max_rows=max_rows)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)
    overflow = np.asarray(want[1])[:len(topics)]
    if case in ("width_overflow", "max_rows_overflow", "too_deep"):
        assert overflow.any() and not overflow.all()
    elif case != "random":
        assert not overflow.any()


@pytest.mark.parametrize("name", ["basic", "random1", "random2",
                                  "probe_growth", "empty"])
def test_engine_equals_reference_and_trie(name):
    subs, topics = corpus(name)
    ref, port = both(subs)
    want_eng = ref_engine.NFAEngine(ref, max_levels=8)
    eng = NFAEngine(port, max_levels=8, device="cpu")
    got_raw, want_raw = eng.match_raw(topics), want_eng.match_raw(topics)
    for g, w in zip(got_raw[:2], want_raw[:2]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
        assert len(g) == len(topics)             # bucket pads trimmed
    got = eng.subscribers_batch(topics)
    want = want_eng.subscribers_batch(topics)
    for t, g, w in zip(topics, got, want):
        assert normalize(g) == normalize(w) == \
            normalize(port.subscribers(t)), t
    assert (eng.matches, eng.fallbacks) == \
        (want_eng.matches, want_eng.fallbacks)
    assert eng.device == torch.device("cpu")


def test_engine_overflow_falls_back_exactly():
    subs, topics = wide_corpus()
    _ref, port = both(subs)
    eng = NFAEngine(port, width=2, device="cpu")
    for t, g in zip(topics, eng.subscribers_batch(topics)):
        assert normalize(g) == normalize(port.subscribers(t)), t
    assert eng.fallbacks > 0


def test_engine_refresh_after_mutation():
    idx = TopicIndex()
    idx.subscribe("c1", Subscription(filter="a/b"))
    eng = NFAEngine(idx, device="cpu")
    assert set(eng.subscribers("a/b").subscriptions) == {"c1"}
    idx.subscribe("c2", Subscription(filter="a/+"))
    assert sorted(eng.subscribers("a/b").subscriptions) == ["c1", "c2"]
    idx.unsubscribe("c1", "a/b")
    assert sorted(eng.subscribers("a/b").subscriptions) == ["c2"]
    v = eng.tables.version
    assert eng.refresh() is False and eng.tables.version == v
    eng.auto_refresh = False
    idx.subscribe("c3", Subscription(filter="#"))
    assert sorted(eng.subscribers("a/b").subscriptions) == ["c2"]
    assert eng.refresh() is True
    assert sorted(asyncio.run(eng.subscribers_async("a/b")).subscriptions) \
        == ["c2", "c3"]


@pytest.mark.parametrize("site", ["DEVICE_MATCH", "DEVICE_RECOMPILE"])
def test_fault_sites_raise_like_reference(site):
    ref, port = both([("c1", "a/#", {}), ("c2", "a/+", {})])
    engines = (ref_engine.NFAEngine(ref), NFAEngine(port, device="cpu"))
    raised = []
    for mod, eng, idx, sub in ((ref_faults, engines[0], ref, RefSubscription),
                               (faults, engines[1], port, Subscription)):
        mod.clear()
        try:
            mod.arm(getattr(mod, site), "raise", 1)
            if site == "DEVICE_MATCH":
                call = lambda: eng.subscribers_batch(["a/b"])
            else:
                idx.subscribe("c3", sub(filter="b/#"))
                call = lambda: eng.refresh()
            with pytest.raises(mod.DeviceMatchError) as exc:
                call()
            raised.append(exc.value)
            assert mod.fired[getattr(mod, site)] == 1
        finally:
            mod.clear()
    assert [type(e).__name__ for e in raised] == ["InjectedFault"] * 2
    # after the fault the engine serves again
    assert set(engines[1].subscribers("a/b").subscriptions) >= {"c1", "c2"}


async def test_service_with_nfa_engine_factory():
    """The port's MatcherService serving through the NFA engine: the
    factory is the only new code on the service path."""
    subs, topics = rand_subs(9, n_filters=200)
    path = os.path.join(tempfile.mkdtemp(prefix="maxmq-torch-nfa-"),
                        "m.sock")
    svc = MatcherService(path, engine_factory=lambda index: MicroBatcher(
        NFAEngine(index, device="cpu"), window_us=0, cpu_bypass=False))
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
        await m.close()
    finally:
        await svc.close()
    engine = svc.matcher.engine
    assert isinstance(engine, NFAEngine)
    assert engine.matches >= len(set(topics)) - engine.fallbacks
