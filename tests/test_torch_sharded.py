"""The port's cluster mode (``maxmq_tpu_torch.parallel.sharded``) against
the JAX package's (``maxmq_tpu/parallel/sharded.py``).

The JAX side runs ``shard_map`` over the conftest's 8 virtual CPU
devices; the port runs the same mesh shapes over one CPU device named
once per cell. Both packages get the same subscriptions and topics, made
from a seed, and every output is integer and compared exactly: the shard
tables array for array, the word path on the JAX package's stacked
arrays, both engines' ``match_raw``, and the decoded sets, which must
also equal the CPU trie."""

import asyncio
import os
import random
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxmq_tpu.matching import sig as ref_sig
from maxmq_tpu.matching.trie import TopicIndex as RefIndex
from maxmq_tpu.matching.topics import valid_filter
from maxmq_tpu.parallel import sharded as ref
from maxmq_tpu.protocol.packets import Subscription as RefSubscription
from maxmq_tpu_torch.matching import sig_tables
from maxmq_tpu_torch.matching.batcher import MicroBatcher
from maxmq_tpu_torch.matching.service import MatcherService, ServiceMatcher
from maxmq_tpu_torch.matching.sig import DeviceMatchingDeclined
from maxmq_tpu_torch.matching.sig_torch import (fixed_slots_from_words,
                                                sig_match_words_gather,
                                                token_tensor)
from maxmq_tpu_torch.matching.trie import TopicIndex
from maxmq_tpu_torch.parallel import sharded
from maxmq_tpu_torch.parallel.sharded import (ShardedNFAEngine,
                                              ShardedSigEngine, make_mesh,
                                              make_multislice_mesh)
from maxmq_tpu_torch.protocol import Subscription

from test_nfa_parity import normalize
from test_sharded import random_corpus

CPU = torch.device("cpu")
SHAPES = [(1, 8), (2, 4), (4, 2)]
NFA_ARRAYS = ("hash_node", "hash_tok", "hash_val", "plus_child",
              "node_mask", "hash_mask")


def cpu_mesh(shape):
    return make_mesh(shape=shape, devices=[CPU] * (shape[0] * shape[1]))


def both(filters, qos_of=lambda i: i % 3):
    """(JAX index, port index) with client c{i} subscribed to filter i."""
    r, p = RefIndex(), TopicIndex()
    for i, f in enumerate(filters):
        r.subscribe(f"c{i}", RefSubscription(filter=f, qos=qos_of(i)))
        p.subscribe(f"c{i}", Subscription(filter=f, qos=qos_of(i)))
    return r, p


def rand_clients(seed, n=250, n_topics=120):
    """A corpus where clients hold several filters (the client-hash
    partition matters), with identifiers."""
    filters, topics = random_corpus(n, n_topics, seed)
    rng = random.Random(seed)
    r, p = RefIndex(), TopicIndex()
    for i, f in enumerate(filters):
        if not valid_filter(f):
            continue
        kw = {"qos": rng.randint(0, 2), "identifier": rng.randint(0, 3)}
        r.subscribe(f"cl{i % 60}", RefSubscription(filter=f, **kw))
        p.subscribe(f"cl{i % 60}", Subscription(filter=f, **kw))
    return r, p, topics


def extra_topics(topics):
    """'$' topics, a too-deep topic, an empty one and an unseen token."""
    return topics + ["$SYS/alpha", "$alpha/beta", "",
                     "/".join(["alpha"] * 80), "never/seen"]


def assert_sets(got, index, topics):
    for t, g in zip(topics, got):
        assert normalize(g) == normalize(index.subscribers(t)), t


# -------------------------------------------------------------- meshes


def test_make_mesh_shapes_and_repeated_devices():
    mesh = make_mesh(devices=[CPU] * 8)
    assert mesh.axis_names == ("data", "subs")
    assert mesh.shape == {"data": 2, "subs": 4}
    assert make_mesh(devices=[CPU] * 6).shape == {"data": 1, "subs": 6}
    assert make_mesh((1, 3), devices=[CPU] * 8).devices.shape == (1, 3)
    assert all(d == CPU for d in mesh.devices.flat)
    with pytest.raises(ValueError):
        make_mesh((2, 4), devices=[CPU] * 4)


def test_multislice_mesh_forced_split_and_errors():
    mesh = make_multislice_mesh(n_slices=2, shape=(2, 2), devices=[CPU] * 8)
    assert mesh.axis_names == ("slice", "data", "subs")
    assert mesh.devices.shape == (2, 2, 2)
    assert make_multislice_mesh(devices=[CPU] * 4).devices.shape == (1, 1, 4)
    with pytest.raises(ValueError, match="slices"):
        make_multislice_mesh(n_slices=9, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="per-slice shape"):
        make_multislice_mesh(n_slices=2, shape=(2, 4), devices=[CPU] * 8)
    with pytest.warns(UserWarning, match="idle"):
        make_multislice_mesh(n_slices=2, shape=(1, 3), devices=[CPU] * 8)


# -------------------------------------------------------- shard tables


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_nfa_shard_tables_equal_reference(n_shards):
    filters, _ = random_corpus(300, 0, seed=n_shards)
    r, p = both(filters)
    want = ref.compile_shards(r.all_subscriptions(), n_shards, 3)
    got = sharded.compile_shards(p.all_subscriptions(), n_shards, 3)
    assert len(got) == len(want) == n_shards
    assert len({t.table_size for t in got}) == 1
    for g, w in zip(got, want):
        for name in NFA_ARRAYS:
            assert np.array_equal(getattr(g, name), getattr(w, name)), name
        assert g.row_entries == w.row_entries and g.vocab == w.vocab
        assert g.vocab is got[0].vocab           # one intern pool


@pytest.mark.parametrize("by_client", [True, False])
def test_sig_shard_stacks_equal_reference(by_client):
    r, p, _ = rand_clients(5)
    want = ref.compile_sig_shards(r.all_subscriptions(), 8, 2,
                                  by_client=by_client)
    got = sharded.compile_sig_shards(p.all_subscriptions(), 8, 2,
                                     by_client=by_client)
    assert [len(t.entries) for t in got] == [len(t.entries) for t in want]
    assert sum(len(t.entries) == 0 for t in got) == \
        sum(len(t.entries) == 0 for t in want)
    (gs, gd), (ws, wd) = (sharded._pad_and_stack_shards(got, 8),
                          ref._pad_and_stack_shards(want, 8))
    assert gd == wd
    for g, w in zip(gs, ws):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# ------------------------------------------------------------ word path


def word_path_case(seed):
    """The JAX package's stacked shard arrays and a prepared batch; the
    port's ``prepare_batch_sig`` on its own shards gives the same batch."""
    r, p, topics = rand_clients(seed, n=400)
    topics = extra_topics(topics)
    prepared, stacks = [], []
    for mod, index in ((ref, r), (sharded, p)):
        shards = mod.compile_sig_shards(index.all_subscriptions(), 2, 1)
        stacked, d_max = mod._pad_and_stack_shards(shards, 2)
        stacks.append(stacked)
        union = {}
        for t in shards:
            union.update(t.host_exact or {})
        prep = (ref_sig if mod is ref else sig_tables).prepare_batch_sig
        prepared.append(prep(shards[0], topics, window=d_max,
                             host_exact=union))
    for g, w in zip(prepared[1], prepared[0]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    toks, lens_enc = prepared[0][:2]
    return stacks[0], toks, lens_enc


@pytest.mark.parametrize("sel_blocks,max_rows,fmt16", [
    (8, 7, False), (8, 7, True), (1, 14, False), (2, 3, True),
    (64, 14, False)])
def test_word_path_equals_reference(sel_blocks, max_rows, fmt16):
    """``sig_match_words_gather`` + ``fixed_slots_from_words`` on the JAX
    package's stacked arrays: the words and the packed slots, bit for
    bit. sel_blocks 1 overflows topics with words in two blocks; 64 is
    more blocks than the tables have (the top_k's -1 keys tie)."""
    stacked, toks, lens_enc = word_path_case(11)
    names = ("topo_coef", "depth_coef", "min_depth", "is_hash",
             "wild_first")
    dollar = lens_enc < 0
    lengths = np.abs(lens_enc.astype(np.int32))
    too_deep = lengths >= 127
    outs = []
    for s in range(2):
        consts = {n: jnp.asarray(a[s]) for n, a in zip(names, stacked)}
        w_words = ref_sig.sig_match_words_gather(
            consts, jnp.asarray(stacked[5][s]), jnp.asarray(stacked[6][s]),
            jnp.asarray(toks.astype(np.int32)), jnp.asarray(lengths),
            jnp.asarray(dollar))
        w_out = ref_sig.fixed_slots_from_words(
            w_words, jnp.asarray(too_deep), sel_blocks, max_rows, fmt16)
        tables = sharded._upload_sig_tables(tuple(a[s] for a in stacked),
                                            CPU)
        g_words = sig_match_words_gather(
            tables, tables["planes"], tables["grp_of_word"],
            token_tensor(toks, CPU), torch.from_numpy(lengths).long(),
            torch.from_numpy(dollar))
        assert np.array_equal(g_words.numpy(),
                              np.asarray(w_words).astype(np.int64))
        g_out = fixed_slots_from_words(g_words, torch.from_numpy(too_deep),
                                       sel_blocks, max_rows, fmt16)
        w_out = np.asarray(w_out)
        assert np.array_equal(g_out.numpy(), w_out.astype(np.int64))
        outs.append(w_out)
    cnt = np.concatenate([o[:, 0] >> 28 if fmt16 else o[:, 0] for o in outs])
    assert (cnt == 0xF).any() and ((cnt > 0) & (cnt < 0xF)).any()


def test_word_path_fewer_nonzero_blocks_than_selected():
    """Topics with 0, 1 or 2 nonzero 32-word blocks under sel_blocks 4:
    the unselected -1 keys tie and their slots stay zero."""
    words = np.zeros((6, 200), dtype=np.uint32)
    words[1, 37] = 0x80000001
    words[2, 5] = 1 << 7
    words[2, 190] = 0x3
    words[3, 64:70] = 1
    words[4, :200:33] = 3                        # 7 blocks: overflow
    words[5, 199] = 0x3FFF
    too_deep = np.zeros(6, dtype=bool)
    for fmt16 in (False, True):
        want = np.asarray(ref_sig.fixed_slots_from_words(
            jnp.asarray(words), jnp.asarray(too_deep), 4, 14, fmt16))
        got = fixed_slots_from_words(
            torch.from_numpy(words.astype(np.int64)),
            torch.from_numpy(too_deep), 4, 14, fmt16)
        assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert list(want[:, 0] >> 28) == [0, 2, 3, 6, 0xF, 14]


# ------------------------------------------------------------- engines


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_sig_match_raw_equals_reference(shape):
    filters, topics = random_corpus(300, 64, seed=shape[0] * 17 + shape[1])
    r, p = both(filters)
    topics = extra_topics(topics)
    want = ref.ShardedSigEngine(r, mesh=ref.make_mesh(shape=shape))
    eng = ShardedSigEngine(p, mesh=cpu_mesh(shape))
    w, g = want.match_raw(topics), eng.match_raw(topics)
    assert g[0].dtype == w[0].dtype == np.uint32
    assert g[0].shape == (shape[1], len(topics), 8)
    assert np.array_equal(g[0], w[0])
    for gh, wh in zip(g[1], w[1]):
        assert [list(x) for x in gh] == [list(x) for x in wh]
    assert np.array_equal(g[3], w[3]) and np.array_equal(g[4], w[4])
    got = eng.subscribers_batch(topics)
    assert_sets(got, p, topics)
    assert [normalize(x) for x in got] == \
        [normalize(x) for x in want.subscribers_batch(topics)]
    assert (eng.matches, eng.fallbacks) == (want.matches, want.fallbacks)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_nfa_match_raw_equals_reference(shape):
    filters, topics = random_corpus(300, 64, seed=shape[0] * 31 + shape[1])
    r, p = both(filters)
    topics = extra_topics(topics)
    want = ref.ShardedNFAEngine(r, mesh=ref.make_mesh(shape=shape),
                                max_levels=8)
    eng = ShardedNFAEngine(p, mesh=cpu_mesh(shape), max_levels=8)
    w, g = want.match_raw(topics), eng.match_raw(topics)
    for gi, wi in zip(g[:2], w[:2]):
        assert gi.dtype == wi.dtype and np.array_equal(gi, wi)
    assert g[0].shape == (shape[1], len(topics), 128)
    assert_sets(eng.subscribers_batch(topics), p, topics)
    assert eng.fallbacks == 1                    # the too-deep topic


def test_sharded_nfa_narrow_overflow_equals_reference():
    filters, topics = random_corpus(300, 64, seed=3)
    r, p = both(filters)
    want = ref.ShardedNFAEngine(r, mesh=ref.make_mesh(shape=(2, 4)),
                                width=2, max_rows=2, max_levels=8)
    eng = ShardedNFAEngine(p, mesh=cpu_mesh((2, 4)), width=2, max_rows=2,
                           max_levels=8)
    w, g = want.match_raw(topics), eng.match_raw(topics)
    for gi, wi in zip(g[:2], w[:2]):
        assert np.array_equal(gi, wi)
    assert 0 < g[1].any(axis=0).sum() < len(topics)
    assert_sets(eng.subscribers_batch(topics), p, topics)


def test_sharded_padding_words_cannot_fire():
    """Padding word slots point at the all-zero-coefficient padding group
    (signature 0 for every topic, never the 0xFFFFFFFF poison plane)."""
    filters, _topics = random_corpus(60, 0, seed=3)
    _r, p = both(filters)
    eng = ShardedSigEngine(p, mesh=cpu_mesh((1, 8)))
    state = eng._state
    topo, dc, _mind, _ish, _wild, planes, grp = state.stacked
    for s, t in enumerate(state.shards):
        w = int(t.group_words.sum())
        pad_groups = np.unique(grp[s, w:])
        assert topo[s, pad_groups].sum() == 0, s
        assert dc[s, pad_groups].sum() == 0, s
        assert (planes[s, :, w:] == 0xFFFFFFFF).all()


def test_heavy_client_falls_back_to_round_robin(monkeypatch):
    """One client whose wildcard shapes overflow a client-hash bucket's
    MAX_GROUPS keeps the device path: refresh re-partitions round-robin,
    as the reference's does."""
    monkeypatch.setattr(sig_tables, "MAX_GROUPS", 4)
    monkeypatch.setattr(ref_sig, "MAX_GROUPS", 4)
    subs = [("bridge", "/".join(["alpha"] * d) + "/#") for d in range(2, 10)]
    subs.append(("plain", "alpha/beta"))
    r, p = RefIndex(), TopicIndex()
    for cid, f in subs:
        r.subscribe(cid, RefSubscription(filter=f, qos=1))
        p.subscribe(cid, Subscription(filter=f, qos=1))
    want = ref.ShardedSigEngine(r, mesh=ref.make_mesh(shape=(1, 8)))
    eng = ShardedSigEngine(p, mesh=cpu_mesh((1, 8)))
    assert eng._state.program is not None, "device path must stay alive"
    assert eng._state.chain_ok is False is want._state[7]
    topics = ["alpha/beta", "alpha/alpha/x", "alpha/alpha/alpha/y"]
    assert np.array_equal(eng.match_raw(topics)[0],
                          want.match_raw(topics)[0])
    assert_sets(eng.subscribers_batch(topics), p, topics)


def test_declined_corpus_serves_from_trie(monkeypatch):
    monkeypatch.setattr(sig_tables, "MAX_GROUPS", 0)
    _r, p = both(["alpha/#", "beta/+/#"])
    eng = ShardedSigEngine(p, mesh=cpu_mesh((1, 2)))
    assert eng._state.program is None
    with pytest.raises(DeviceMatchingDeclined):
        eng.match_raw(["alpha/x"])
    topics = ["alpha/x", "beta/y/z"]
    assert_sets(eng.subscribers_batch(topics), p, topics)
    assert_sets(eng.subscribers_host_batch(topics), p, topics)
    assert eng.fallbacks == 4


@pytest.mark.parametrize("engine", ["sig", "nfa"])
def test_uneven_and_empty_shards(engine):
    filters = ["alpha/beta", "alpha/+", "gamma/#"]
    r, p = both(filters)
    topics = ["alpha/beta", "gamma/x/y", "delta", "alpha", "gamma"]
    if engine == "sig":
        want = ref.ShardedSigEngine(r, mesh=ref.make_mesh(shape=(1, 8)))
        eng = ShardedSigEngine(p, mesh=cpu_mesh((1, 8)))
    else:
        want = ref.ShardedNFAEngine(r, mesh=ref.make_mesh(shape=(1, 8)))
        eng = ShardedNFAEngine(p, mesh=cpu_mesh((1, 8)))
    assert np.array_equal(eng.match_raw(topics)[0],
                          want.match_raw(topics)[0])
    assert_sets(eng.subscribers_batch(topics), p, topics)
    empty = ShardedSigEngine(TopicIndex(), mesh=cpu_mesh((2, 2))) \
        if engine == "sig" else ShardedNFAEngine(TopicIndex(),
                                                 mesh=cpu_mesh((2, 2)))
    assert [len(x) for x in empty.subscribers_batch(topics)] == [0] * 5


def test_reshard_equals_reference():
    """Drop from a (2, 4) mesh to (1, 4): the state re-partitions and
    both packages still agree bit for bit, and with the trie."""
    r, p, topics = rand_clients(7, n=500)
    topics = extra_topics(topics)
    want = ref.ShardedSigEngine(r, mesh=ref.make_mesh(shape=(2, 4)))
    eng = ShardedSigEngine(p, mesh=cpu_mesh((2, 4)))
    assert np.array_equal(eng.match_raw(topics)[0],
                          want.match_raw(topics)[0])
    v = eng._state.version
    want.reshard(ref.make_mesh(shape=(1, 4)))
    eng.reshard(cpu_mesh((1, 4)))
    assert (eng.sp, eng.dp) == (4, 1) and eng._state.version == v
    g, w = eng.match_raw(topics), want.match_raw(topics)
    assert g[0].shape[0] == 4 and np.array_equal(g[0], w[0])
    assert_sets(eng.subscribers_batch(topics), p, topics)


def test_multislice_mesh_equals_reference():
    filters, topics = random_corpus(400, 48, seed=21)
    r, p = both(filters)
    for shape in [(1, 2), (2, 2)]:
        want = ref.ShardedSigEngine(r, mesh=ref.make_multislice_mesh(
            n_slices=2, shape=shape))
        eng = ShardedSigEngine(p, mesh=make_multislice_mesh(
            n_slices=2, shape=shape, devices=[CPU] * 8))
        assert eng.sp == want.sp == 2 * shape[1]
        assert np.array_equal(eng.match_raw(topics)[0],
                              want.match_raw(topics)[0])
        assert_sets(eng.subscribers_batch(topics), p, topics)
    nfa = ShardedNFAEngine(p, mesh=make_multislice_mesh(
        n_slices=2, shape=(1, 2), devices=[CPU] * 4))
    assert nfa.sp == 2
    assert_sets(nfa.subscribers_batch(topics), p, topics)


@pytest.mark.parametrize("seed", [21, 22])
def test_host_batch_equals_trie(seed):
    r, p, topics = rand_clients(seed)
    topics = extra_topics(topics)
    eng = ShardedSigEngine(p, mesh=cpu_mesh((2, 4)))
    assert_sets(eng.subscribers_host_batch(topics), p, topics)
    # the too-deep topic is served by the trie, not counted as a host match
    assert eng.host_matches == len(topics) - 1 and eng.fallbacks == 1


def test_engines_track_index_mutations():
    filters, _ = random_corpus(50, 0, seed=9)
    _r, p = both(filters)
    sig = ShardedSigEngine(p, mesh=cpu_mesh((2, 4)))
    nfa = ShardedNFAEngine(p, mesh=cpu_mesh((2, 4)), max_levels=8)
    p.subscribe("late", Subscription(filter="alpha/#", qos=1))
    assert "late" in nfa.subscribers("alpha/beta").subscriptions
    got = asyncio.run(sig.subscribers_async("alpha/beta"))
    assert "late" in got.subscriptions
    sig.close()
    assert sig.refresh() is False                # the background refresh ran
    assert sig._state.version == p.sub_version
    deep = "/".join(["alpha"] * 80)
    p.subscribe("deepc", Subscription(filter=deep))
    assert_sets([sig.subscribers(deep)], p, [deep])
    assert_sets([asyncio.run(nfa.subscribers_async(deep))], p, [deep])


async def test_service_with_sharded_engine_factory():
    """The port's MatcherService serving through the sharded signature
    engine on a CPU mesh, host bypass on (its device-free path)."""
    _r, p, topics = rand_clients(31)
    path = os.path.join(tempfile.mkdtemp(prefix="maxmq-torch-shard-"),
                        "m.sock")
    svc = MatcherService(path, engine_factory=lambda index: MicroBatcher(
        ShardedSigEngine(index, mesh=cpu_mesh((2, 2))), window_us=0))
    await svc.start()
    try:
        m = ServiceMatcher(path)
        await m.connect()
        for _f, cid, sub, _g in p.all_subscriptions():
            m.forward_subscribe(cid, sub)
        got = await m.subscribers_batch_async(topics)
        assert_sets(got, p, topics)
        await m.close()
    finally:
        await svc.close()
    assert isinstance(svc.matcher.engine, ShardedSigEngine)
    assert svc.matcher.engine.matches > 0


def test_sharded_engines_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError):
        ShardedSigEngine(TopicIndex())
    with pytest.raises(RuntimeError):
        ShardedNFAEngine(TopicIndex())
    with pytest.raises(RuntimeError):
        make_mesh(devices=["cuda"] * 2)
