"""The CUDA kernels on the card, held against their plain versions, and
the torch device programs (the NFA engine, both sharded engines) on the
card held against the same programs on the CPU.

This file imports only the port (no JAX), so it runs on a machine that
has a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Elsewhere its tests skip; whether there is a card is decided when a test
runs (the ``cuda_card`` fixture), never at import."""

import random

import pytest
import torch

import chip_smoke
from maxmq_tpu_torch.matching import dense_kernel, sig_kernel
from maxmq_tpu_torch.matching.dense import DenseEngine, compile_dense
from maxmq_tpu_torch.matching.sig import (SigEngine, device_tables,
                                          pad_to_bucket, table_arrays)
from maxmq_tpu_torch.matching.sig_tables import compile_sig, prepare_batch
from maxmq_tpu_torch.matching.topics import pad_topic_batch
from maxmq_tpu_torch.matching.trie import TopicIndex
from maxmq_tpu_torch.protocol import Subscription

SEGS = [f"s{i}" for i in range(12)]


@pytest.fixture
def cuda_card():
    """The card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc)")
    return torch.device("cuda")


def corpus(seed: int, plus_in_prefix: bool):
    """'#'-heavy corpus with one wide (32-bit plane) group; with
    ``plus_in_prefix`` it has more than 40 device groups."""
    rng = random.Random(seed)
    filters = [f"big/{i}/#" for i in range(1100)]
    while len(filters) < 3000:
        depth = rng.randint(1, 6)
        levels = [rng.choice(SEGS) for _ in range(depth)]
        levels = levels[:rng.randint(1, depth)]
        if plus_in_prefix:
            for _ in range(rng.randint(1, 2)):
                levels[rng.randrange(len(levels))] = "+"
        filters.append("/".join(levels + ["#"]))
    idx = TopicIndex()
    for i, f in enumerate(filters):
        idx.subscribe(f"c{i}", Subscription(filter=f, qos=i % 3))
    topics = ["/".join(rng.choice(SEGS) for _ in range(rng.randint(1, 7)))
              for _ in range(1000)]
    topics += [f"big/{i}/x" for i in range(0, 1100, 7)]
    topics += ["$SYS/s1", "$" + topics[0], "s1/" + "/".join(["s2"] * 130)]
    return idx, topics


@pytest.mark.gpu
@pytest.mark.parametrize("plus_in_prefix", [False, True],
                         ids=["le40_groups", "gt40_groups"])
@pytest.mark.parametrize("kernel_width", ["auto", "32"])
def test_cuda_kernel_matches_plain(cuda_card, plus_in_prefix, kernel_width):
    idx, topics = corpus(5, plus_in_prefix)
    tables = compile_sig(idx)
    assert (len(tables.groups) > 40) == plus_in_prefix
    arrays = table_arrays(tables)
    kplan = sig_kernel.plan(arrays["group_words"], arrays["group_w16"],
                            force_width32=kernel_width == "32")
    dev = device_tables(arrays, cuda_card)
    toks8, lens_enc, _ = prepare_batch(tables, topics)
    toks8, lens_enc = pad_to_bucket(tables, toks8, lens_enc)
    sig, deep = sig_kernel.prologue(dev, kplan, toks8, lens_enc)
    p32, p16 = sig_kernel.region_planes(dev, kplan)
    before = sig_kernel.sig_match_fixed.launches
    got = sig_kernel.sig_match_fixed(sig, deep, dev["grp_of_word"], p32, p16,
                                     6)
    want = sig_kernel.sig_match_fixed_plain(sig, deep, dev["grp_of_word"],
                                            p32, p16, 6)
    torch.cuda.synchronize()
    assert sig_kernel.sig_match_fixed.launches == before + 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert (want[0] == 0xFF).any() and (want[0] != 0xFF).sum() > 100


@pytest.mark.gpu
def test_engine_on_card_matches_trie(cuda_card):
    idx, topics = corpus(6, False)
    engine = SigEngine(idx, device=cuda_card, auto_refresh=False)
    before = sig_kernel.sig_match_fixed.launches
    got = engine.subscribers_fixed_batch(topics)
    assert sig_kernel.sig_match_fixed.launches == before + 1
    for t, g in zip(topics, got):
        want = idx.subscribers(t)
        assert set(g.subscriptions) == set(want.subscriptions), t
        assert set(g.shared) == set(want.shared), t


@pytest.mark.gpu
@pytest.mark.parametrize("intents", [False, True], ids=["sets", "intents"])
def test_engine_on_card_native_decode_matches_trie(cuda_card, intents):
    """The production signature path on the card: the fused C++
    tokenize + probe, the kernel, and the C verify + union decode in both
    result forms (merged sets, DeliveryIntents), every answer against the
    trie. Where the toolchain builds the decode extension, it must serve."""
    from maxmq_tpu_torch import native

    if native.compiler() and native.python_include():
        assert native.decode_module() is not None, native.build_errors
    idx, topics = corpus(7, False)
    engine = SigEngine(idx, device=cuda_card, auto_refresh=False)
    engine.emit_intents = intents
    route = ("python" if native.decode_module() is None else
             "native-intents" if intents else "native-sets")
    assert (engine.prewarm_decode_bases() > 0) == (route == "native-intents")
    before = sig_kernel.sig_match_fixed.launches
    got = engine.subscribers_fixed_batch(topics)
    assert sig_kernel.sig_match_fixed.launches == before + 1
    assert engine.decoded[route] == len(topics)
    for t, g in zip(topics, got):
        assert chip_smoke.normalize(g) == chip_smoke.normalize(
            idx.subscribers(t)), t


def dense_corpus(full_width: bool):
    """``dense_2k`` at full width (2,000 rows, 8 levels), or a narrow
    tree whose slots are not a multiple of 128; topics with '$' topics,
    a too-deep topic and an empty one."""
    kw = {} if full_width else {"n_filters": 40, "n_subs": 400, "width": 20}
    subs, gen = chip_smoke.build_dense_corpus(**kw)
    idx = TopicIndex()
    for cid, f, qos in subs:
        idx.subscribe(cid, Subscription(filter=f, qos=qos))
    topics = gen(1000, seed2=7)
    topics += ["$SYS/l0t1", "$" + topics[0], topics[1] + "/a" * 20, ""]
    return idx, topics


@pytest.mark.gpu
@pytest.mark.parametrize("full_width", [True, False],
                         ids=["dense_2k", "narrow"])
def test_dense_kernel_matches_plain(cuda_card, full_width):
    idx, topics = dense_corpus(full_width)
    tables = compile_dense(idx)
    matcher = dense_kernel.KernelMatcher(tables, 16, device=cuda_card)
    if not full_width:
        assert matcher.pt.slots % 128 != 0
    toks, lengths, dollar = pad_topic_batch(*tables.tokenize(topics, 16))
    args = [torch.from_numpy(a).to(cuda_card) for a in (toks, lengths,
                                                          dollar)]
    before = dense_kernel.dense_walk_words.launches
    got = dense_kernel.dense_walk_words(*args, matcher.kt, matcher.max_words)
    want = dense_kernel.dense_walk_words_plain(*args, matcher.kt,
                                               matcher.max_words)
    torch.cuda.synchronize()
    assert dense_kernel.dense_walk_words.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (want[0][:, 0] >= 0).sum() > len(topics) // 8


@pytest.mark.gpu
@pytest.mark.parametrize("max_words", [1, 4, 100])
def test_dense_kernel_max_words_edges(cuda_card, max_words):
    """max_words below dense_2k's 63 row words (topics with more nonzero
    words than it overflow, their first words still extracted) and above
    them (the rows pad out)."""
    idx, topics = dense_corpus(True)
    tables = compile_dense(idx)
    matcher = dense_kernel.KernelMatcher(tables, 16, max_words=max_words,
                                         device=cuda_card)
    arrays = pad_topic_batch(*tables.tokenize(topics, 16))
    args = [torch.from_numpy(a).to(cuda_card) for a in arrays]
    got = matcher(*args)
    want = dense_kernel.dense_walk_words_plain(*args, matcher.kt, max_words)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if max_words == 1:
        assert want[2].sum() > 1 + len(topics) // 20


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    ("overflow", 1037, 200, 100, 6), ("overflow", 1037, 0, 300, 6),
    ("mixed", 1037, 400, 0, 14), ("mixed", 1037, 0, 500, 6),
    ("mixed", 70_001, 300, 200, 7)],
    ids=["overflow_first_tile", "overflow_first_tile_16", "no_16bit_words",
         "no_32bit_words", "full_blocks_odd_batch"])
def test_cuda_kernel_edges(cuda_card, case):
    """The kernel's edges on synthetic operands: every topic overflowing in
    the first word tile, batches that are no multiple of a block's
    topics, tables without 16-bit or without 32-bit words."""
    mode, batch, n32, n16, mr = case
    sig, deep, grp, p32, p16 = (
        torch.from_numpy(a).to(cuda_card)
        for a in chip_smoke.synthetic_sig(7, batch, n32, n16, mode, mr))
    p32 = p32[:, :n32]
    got = sig_kernel.sig_match_fixed(sig, deep, grp, p32, p16, mr)
    want = sig_kernel.sig_match_fixed_plain(sig, deep, grp, p32, p16, mr)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    over = int((want[0] == 0xFF).sum())
    assert over == batch if mode == "overflow" else 0 < over < batch


@pytest.mark.gpu
def test_dense_engine_on_card_matches_trie(cuda_card):
    idx, topics = dense_corpus(False)
    engine = DenseEngine(idx, device=cuda_card, auto_refresh=False)
    assert engine.kernel_active
    before = dense_kernel.dense_walk_words.launches
    got = engine.subscribers_batch(topics)
    assert dense_kernel.dense_walk_words.launches == before + 1
    for t, g in zip(topics, got):
        assert chip_smoke.normalize(g) == chip_smoke.normalize(
            idx.subscribers(t)), t
    assert engine.fallbacks == 1                 # the too-deep topic


def nfa_corpus(n_filters: int = 3000, seed: int = 9):
    """``chip_smoke.build_corpus``'s mixed corpus (10 % '$share') in a port
    TopicIndex, and topics with '$' topics, too-deep and empty ones."""
    filters, gen = chip_smoke.build_corpus(n_filters, seed=seed,
                                           share_frac=0.1)
    idx = TopicIndex()
    for i, f in enumerate(filters):
        idx.subscribe(f"c{i}", Subscription(filter=f, qos=i % 3))
    topics = gen(2000, seed2=3)
    topics += ["$SYS/a0", "$" + topics[0], "/".join(["a1"] * 40), ""]
    return idx, topics


@pytest.mark.gpu
@pytest.mark.parametrize("width,max_rows", [(32, 128), (4, 4)])
def test_nfa_engine_on_card_matches_cpu(cuda_card, width, max_rows):
    from maxmq_tpu_torch.matching.engine import NFAEngine

    idx, topics = nfa_corpus()
    card = NFAEngine(idx, width=width, max_rows=max_rows, device=cuda_card)
    cpu = NFAEngine(idx, width=width, max_rows=max_rows, device="cpu")
    got, want = card.match_raw(topics), cpu.match_raw(topics)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and (g == w).all()
    assert want[1].any() and not want[1].all()
    for t, g in zip(topics, card.subscribers_batch(topics)):
        assert chip_smoke.normalize(g) == chip_smoke.normalize(
            idx.subscribers(t)), t


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["sig", "nfa"])
def test_sharded_engines_on_card_match_cpu(cuda_card, engine):
    from maxmq_tpu_torch.parallel.sharded import (ShardedNFAEngine,
                                                  ShardedSigEngine,
                                                  make_mesh)

    idx, topics = nfa_corpus()
    cls = ShardedSigEngine if engine == "sig" else ShardedNFAEngine
    n = 1 if engine == "sig" else 2       # outputs: slots, or rows + overflow
    shapes = [(2, 4), (1, 4)] if engine == "sig" else [(2, 4)]
    card = cls(idx, mesh=make_mesh(shapes[0], devices=[cuda_card] * 8))
    for shape in shapes:
        if shape != shapes[0]:
            card.reshard(make_mesh(shape, devices=[cuda_card] * 4))
        cpu = cls(idx, mesh=make_mesh(shape, devices=["cpu"] * 8))
        got, want = card.match_raw(topics), cpu.match_raw(topics)
        for g, w in zip(got[:n], want[:n]):
            assert g.dtype == w.dtype and (g == w).all()
        for t, g in zip(topics, card.subscribers_batch(topics)):
            assert chip_smoke.normalize(g) == chip_smoke.normalize(
                idx.subscribers(t)), t


@pytest.mark.gpu
def test_sharded_engines_across_cards(cuda_card):
    """The default mesh spans every card (``make_mesh()``): each shard's
    tables live on its own card; both engines equal their CPU twins and
    the trie. Needs two cards or more."""
    from maxmq_tpu_torch.parallel.sharded import (ShardedNFAEngine,
                                                  ShardedSigEngine,
                                                  make_mesh)

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards or more")
    idx, topics = nfa_corpus()
    mesh = make_mesh()
    assert {d.index for d in mesh.devices.flat} == set(range(n))
    for cls, n_out in ((ShardedSigEngine, 1), (ShardedNFAEngine, 2)):
        card = cls(idx, mesh=mesh)
        cpu = cls(idx, mesh=make_mesh(mesh.devices.shape,
                                      devices=["cpu"] * n))
        got, want = card.match_raw(topics), cpu.match_raw(topics)
        for g, w in zip(got[:n_out], want[:n_out]):
            assert (g == w).all()
        for t, g in zip(topics, card.subscribers_batch(topics)):
            assert chip_smoke.normalize(g) == chip_smoke.normalize(
                idx.subscribers(t)), t


@pytest.mark.gpu
@pytest.mark.parametrize("preds,msgs", [(64, 4096), (10_000, 256)],
                         ids=["bench_64x4096", "bounds_10000x256"])
def test_content_evaluator_on_the_card(cuda_card, preds, msgs):
    """The content evaluator's torch backend on the card equals NumPy at
    the reference benchmark's shape and at the configured bounds, with no
    breaker fallback, its matrix computed on the card."""
    from maxmq_tpu_torch.filtering.columnar import (
        ColumnarEvaluator, build_columns, device_matrix, eval_batch_numpy)
    from maxmq_tpu_torch.filtering.expr import compile_expr

    exprs, objs = chip_smoke.mqttplus_inputs(preds, msgs)
    compiled = [compile_expr(e) for e in exprs]
    fields = tuple(dict.fromkeys(f for p in compiled for f in p.fields))
    programs = [p.program for p in compiled]
    cols = build_columns(objs, fields)
    ev = ColumnarEvaluator(backend="torch", device=cuda_card)
    got = ev.eval_batch(programs, cols, msgs)
    want = eval_batch_numpy(programs, cols, msgs)
    assert ev.device_fallbacks == 0
    assert got.shape == (preds, msgs) and (got == want).all()
    assert device_matrix(programs, cols, msgs, cuda_card).is_cuda


@pytest.mark.gpu
def test_sig_surfaces_on_card_match_cpu(cuda_card):
    """The word and compact programs of SigEngine and the fixed path's
    row-matrix unpack on the card equal the same calls on the CPU, and
    their answers the trie's."""
    idx, topics = corpus(8, False)
    card = SigEngine(idx, device=cuda_card, auto_refresh=False)
    cpu = SigEngine(idx, device="cpu", auto_refresh=False)
    got, want = card.match_raw(topics), cpu.match_raw(topics)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and (g == w).all()
    assert want[2].any() and want[1].any()
    got, want = card.match_compact(topics), cpu.match_compact(topics)
    n = min(want[2], len(want[1]))
    assert (got[0] == want[0]).all() and got[2] == want[2]
    assert (got[1][:n] == want[1][:n]).all()
    before = sig_kernel.sig_match_fixed.launches
    got, want = card.match_fixed(topics), cpu.match_fixed(topics)
    assert sig_kernel.sig_match_fixed.launches == before + 1
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and (g == w).all()
    ctx = card.dispatch_fixed(topics)
    answers = {"decode_fixed": card.decode_fixed(
        topics, *card.match_fixed([], out=ctx), ctx[4], ctx[5])}
    for fn in ("subscribers_batch", "subscribers_compact_batch"):
        answers[fn] = getattr(card, fn)(topics)
    for fn, got in answers.items():
        for t, g in zip(topics, got):
            assert chip_smoke.normalize(g) == chip_smoke.normalize(
                idx.subscribers(t)), (fn, t)
