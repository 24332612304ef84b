"""The rest of the port's SigEngine device surface (device="cpu") against
the JAX package's SigEngine on its CPU backend: the word path (match_raw,
subscribers_batch, decode), the compact path (match_compact,
subscribers_compact_batch) and the fixed path's row-matrix surface
(match_fixed, counts_fixed, decode_fixed) over the kernel's stream, on
the same seeded corpora and topics.

Device outputs are compared bit for bit. The compact stream is compared
up to ``total``: past it the reference holds rows that depend on how its
``top_k`` orders tied keys, and no consumer reads there. Answers are
compared order-free (``normalize``), as the JAX package's own tests do."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxmq_tpu import faults as ref_faults
from maxmq_tpu.matching import TopicIndex as RefIndex
from maxmq_tpu.matching import sig as ref_sig
from maxmq_tpu.matching.sig import SigEngine as RefEngine
from maxmq_tpu.matching.topics import valid_filter
from maxmq_tpu.protocol import Subscription as RefSubscription
from maxmq_tpu_torch import faults
from maxmq_tpu_torch.matching import sig as sigmod
from maxmq_tpu_torch.matching import sig_kernel, sig_torch
from maxmq_tpu_torch.matching.sig import SigEngine
from maxmq_tpu_torch.matching.sig_tables import _compact_dtype
from maxmq_tpu_torch.matching.trie import TopicIndex
from maxmq_tpu_torch.protocol import Subscription

from test_nfa_parity import normalize, rand_corpus


@pytest.fixture(autouse=True)
def _always_device_path(monkeypatch):
    """Keep the small-corpus router from serving these tests from the
    trie (parity would pass vacuously) — in both packages."""
    monkeypatch.setattr(SigEngine, "ROUTE_SUBS_MAX", -1)
    monkeypatch.setattr(RefEngine, "ROUTE_SUBS_MAX", -1)


def twin(subs):
    ref, port = RefIndex(), TopicIndex()
    for cid, f, kw in subs:
        ref.subscribe(cid, RefSubscription(filter=f, **kw))
        port.subscribe(cid, Subscription(filter=f, **kw))
    return ref, port


def edge_topics(rng, tokens, n):
    """Random topics over ``tokens`` plus the edges: '$' topics, a topic
    deeper than the 16-level window, one at depth >= 127, empty ones."""
    topics = ["/".join(rng.choice(tokens) for _ in range(rng.randint(1, 6)))
              for _ in range(n)]
    return topics + ["$SYS/" + topics[0], "$" + topics[1],
                     "/".join([tokens[0]] * 20),
                     "/".join([tokens[1]] * 130), "", "/"]


def width_corpus(width: str, seed: int = 5):
    """(subs, topics) whose vocabulary gives uint8, uint16 or int32 compact
    tokens: wildcard filters over a small token set, padded with exact
    filters of unique levels to reach the vocabulary size."""
    rng = random.Random(seed)
    tokens = [f"t{i}" for i in range(12)]
    filters, _ = rand_corpus(rng, n_filters=250, n_clients=30, alphabet=12)
    subs = [(f"c{i % 30}", f, {"qos": i % 3, "identifier": i % 4})
            for i, f in enumerate(filters) if valid_filter(f)]
    fill = {"uint8": 0, "uint16": 150, "int32": 21_700}[width]
    subs += [(f"x{i % 50}", f"u{i}/v{i}/w{i}", {}) for i in range(fill)]
    topics = edge_topics(rng, tokens, 180)
    topics += [f"u{i}/v{i}/w{i}" for i in range(0, fill, max(fill // 20, 1))]
    return subs, topics


_CORPORA = {}


def corpus(width: str):
    if width not in _CORPORA:
        _CORPORA[width] = width_corpus(width)
    return _CORPORA[width]


def pair(subs, **kw):
    ref, port = twin(subs)
    return (RefEngine(ref, auto_refresh=False, **kw),
            SigEngine(port, device="cpu", auto_refresh=False, **kw), port)


def rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(np.asarray(g).tolist()) == sorted(
            np.asarray(w).tolist())


# -- the word path ------------------------------------------------------------

@pytest.mark.parametrize("width", ["uint8", "uint16", "int32"])
def test_match_raw_bit_equal(width):
    subs, topics = corpus(width)
    ref, eng, _ = pair(subs)
    assert _compact_dtype(eng.tables)[0].__name__ == width
    got, want = eng.match_raw(topics), ref.match_raw(topics)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    assert want[2].any() and not want[2].all()     # some overflow, not all
    assert want[1].any()                           # device rows matched
    rows_equal(got[3], want[3])


def test_match_words_concat_form_equals_gather_form():
    """The reference's concat-of-broadcasts expansion and the port's
    gather form give the same [B, W] word matrix."""
    subs, topics = corpus("uint16")
    ref, eng, _ = pair(subs)
    tables = ref.tables
    consts = ref._state[1]
    n_words = int(tables.group_words.sum())
    planes = np.ascontiguousarray(tables.row_sig.reshape(n_words, 32).T)
    toks, lengths, dollar = tables.tokenize(topics, 16)
    sig_adj = ref_sig.adjusted_signatures(
        consts, jnp.asarray(toks), jnp.asarray(lengths), jnp.asarray(dollar))
    want = np.asarray(ref_sig.match_words(consts, jnp.asarray(planes),
                                          sig_adj))
    dev = sigmod.device_tables(sigmod.table_arrays(tables), "cpu")
    got = sig_torch.sig_match_words_gather(
        dev, dev["planes"], dev["grp_of_word"],
        torch.from_numpy(toks).to(torch.int64) & sig_torch.MASK32,
        torch.from_numpy(lengths).to(torch.int64), torch.from_numpy(dollar))
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert want.any()


def test_empty_device_table_word_and_compact_paths():
    """Only host-probed (exact) filters: the device tables hold no words,
    and every path still answers as the reference does."""
    subs = [("c1", "a/b", {}), ("c2", "a/c", {"qos": 1})]
    ref, eng, port = pair(subs)
    topics = ["a/b", "a/c", "a", "$SYS/a"]
    got, want = eng.match_raw(topics), ref.match_raw(topics)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, w)
    gc, wc = eng.match_compact(topics), ref.match_compact(topics)
    assert np.array_equal(gc[0], wc[0]) and gc[2] == wc[2] == 0
    for fn in ("subscribers_batch", "subscribers_compact_batch"):
        for t, g in zip(topics, getattr(eng, fn)(topics)):
            assert normalize(g) == normalize(port.subscribers(t)), (fn, t)


# -- the compact path ---------------------------------------------------------

def compact_equal(got, want):
    counts, stream, total = got[:3]
    assert counts.dtype == want[0].dtype == np.uint8
    assert np.array_equal(counts, want[0])
    assert int(total) == int(want[2])
    assert stream.dtype == want[1].dtype and stream.shape == want[1].shape
    n = min(int(total), stream.shape[-1])
    assert np.array_equal(stream[..., :n], want[1][..., :n])


@pytest.mark.parametrize("width", ["uint8", "uint16", "int32"])
def test_match_compact_bit_equal(width):
    subs, topics = corpus(width)
    ref, eng, _ = pair(subs)
    got, want = eng.match_compact(topics), ref.match_compact(topics)
    compact_equal(got, want)
    assert (want[0] == 255).any() and want[2] > 0
    rows_equal(got[3], want[3])


def test_compact_stream_overflow_sends_the_batch_to_the_trie():
    subs = ([(f"c{i}", f"s/{i}/#", {}) for i in range(20)]
            + [(f"p{i}", f"+/{i}/#", {}) for i in range(20)]
            + [("h1", "s/#", {}), ("h2", "+/#", {}), ("h3", "#", {})])
    ref, eng, port = pair(subs)
    topics = [f"s/{i}/{i % 5}" for i in range(20)]
    got, want = eng.match_compact(topics), ref.match_compact(topics)
    compact_equal(got, want)
    assert got[2] > got[1].shape[0]                # total past the cap
    for e in (eng, ref):
        e.fallbacks = e.matches = 0
        answers = e.subscribers_compact_batch(topics)
        assert e.fallbacks == e.matches == len(topics)
    for t, g, w in zip(topics, eng.subscribers_compact_batch(topics),
                       ref.subscribers_compact_batch(topics)):
        assert normalize(g) == normalize(w) == normalize(
            port.subscribers(t)), t
    assert answers


# -- the fixed path's row-matrix surface --------------------------------------

def test_match_fixed_counts_and_decode_fixed():
    """The reference's Pallas kernel (interpret mode) against the port's
    kernel plain version, through the stream unpack."""
    subs, topics = corpus("uint16")
    ref, eng, port = pair(subs, fixed_max_rows=4)
    assert ref.pallas_active
    want_fmt = ref.fixed_program[1]
    assert eng.fixed_program[1] == {"kind": want_fmt["kind"],
                                    "max_rows": want_fmt["max_rows"]} == {
        "kind": "stream", "max_rows": 4}
    got, want = eng.match_fixed(topics), ref.match_fixed(topics)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    assert len(got[0]) > len(topics)               # bucket-long
    assert (want[0] == 15).any() and (want[0][:len(topics)] < 15).any()
    rows_equal(got[2], want[2])
    gctx, wctx = eng.dispatch_fixed(topics), ref.dispatch_fixed(topics)
    gc, wc = eng.counts_fixed(gctx), ref.counts_fixed(wctx)
    assert np.array_equal(gc[0], wc[0])
    gctx, wctx = eng.dispatch_fixed(topics), ref.dispatch_fixed(topics)
    gm = eng.match_fixed([], out=gctx)
    wm = ref.match_fixed([], out=wctx)
    g_ans = eng.decode_fixed(topics, *gm, gctx[4], gctx[5])
    w_ans = ref.decode_fixed(topics, *wm, wctx[4], wctx[5])
    collected = eng.collect_fixed(topics, eng.dispatch_fixed(topics))
    for t, g, w, c in zip(topics, g_ans, w_ans, collected):
        assert normalize(g) == normalize(w) == normalize(c) == \
            normalize(port.subscribers(t)), t


def test_fixed_slots_fmt32_on_synthetic_words():
    """The sharded engine's slots tail in both wire formats, on synthetic
    words past 65,536 rows (a corpus that large would take long to
    compile): both packages' fixed_slots_from_words."""
    rng = np.random.default_rng(3)
    batch, n_words = 64, 2_100
    words = np.zeros((batch, n_words), dtype=np.uint32)
    for b in range(batch):
        for w in rng.choice(n_words, size=rng.integers(0, 12),
                            replace=False):
            words[b, w] = rng.integers(1, 1 << 32, dtype=np.uint64)
    words[5, :] = 0
    words[6, 2_099] = 1 << 31
    too_deep = np.zeros(batch, dtype=bool)
    too_deep[7] = True
    for fmt16 in (False, True):
        want = np.asarray(ref_sig.fixed_slots_from_words(
            jnp.asarray(words), jnp.asarray(too_deep), 8, 14, fmt16))
        got = sig_torch.fixed_slots_from_words(
            torch.from_numpy(words.astype(np.int64)),
            torch.from_numpy(too_deep), 8, 14, fmt16)
        assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert (want[:, 0] >> 28 == 0xF).any()


def test_dispatch_context_keeps_its_snapshot():
    """A batch dispatched before a refresh unpacks and decodes with the
    snapshot it ran on, never the live one's tables or memo."""
    subs, topics = corpus("uint8")
    _ref, eng, port = pair(subs)
    ctx = eng.dispatch_fixed(topics)
    old = eng._state
    assert ctx.tables is old.tables and ctx.fragments is old.fragments
    port.subscribe("late", Subscription(filter="t1/#"))
    eng.refresh()
    assert eng._state is not old
    cnt, rows, hostrows, tables = eng.match_fixed(
        [], out=eng.dispatch_fixed(topics[:4]))
    assert tables is eng._state.tables
    cnt, rows, hostrows, tables = eng.match_fixed([], out=ctx)
    assert tables is old.tables and rows.shape[1] == eng.fixed_max_rows
    # the old snapshot's rows, decoded with its memo; the journal overlay
    # adds the subscription made since, so answers stay current
    got = eng.collect_fixed(topics, ctx)
    for t, g in zip(topics, got):
        assert normalize(g) == normalize(port.subscribers(t)), t
    assert any("late" in g.subscriptions for g in got)


# -- answers, overlay and resync ----------------------------------------------

@pytest.mark.parametrize("path", ["batch", "compact", "decode_fixed"])
def test_answers_equal_reference_and_trie(path):
    subs, topics = corpus("uint16")
    ref, eng, port = pair(subs)

    def run(e):
        if path == "batch":
            return e.subscribers_batch(topics)
        if path == "compact":
            return e.subscribers_compact_batch(topics)
        ctx = e.dispatch_fixed(topics)
        return e.decode_fixed(topics, *e.match_fixed([], out=ctx),
                              ctx[4], ctx[5])

    for t, g, w in zip(topics, run(eng), run(ref)):
        assert normalize(g) == normalize(w) == normalize(
            port.subscribers(t)), t


def test_word_form_decode_equals_reference():
    subs, topics = corpus("uint8")
    ref, eng, _ = pair(subs)
    got, want = eng.match_raw(topics), ref.match_raw(topics)
    for i, t in enumerate(topics):
        if want[2][i]:
            continue
        g = SigEngine.decode(t, got[0][i], got[1][i], got[4])
        w = RefEngine.decode(t, want[0][i], want[1][i], want[4])
        assert normalize(g) == normalize(w), t


def _frozen_pair(subs):
    ref, port = twin(subs)
    out = []
    for cls, idx, kw in ((RefEngine, ref, {}),
                         (SigEngine, port, {"device": "cpu"})):
        e = cls(idx, **kw)
        e.refresh_soon = lambda: None
        out.append(e)
    return ref, port, out


@pytest.mark.parametrize("path", ["batch", "compact", "decode_fixed"])
def test_overlay_window_and_resync(path):
    ref, port, engines = _frozen_pair([("c1", "a/+", {"qos": 1}),
                                       ("c2", "a/b", {}),
                                       ("c5", "a/#", {})])
    for idx, sub in ((ref, RefSubscription), (port, Subscription)):
        idx.subscribe("c3", sub(filter="a/#", qos=2))
        idx.unsubscribe("c2", "a/b")
        idx.subscribe("c1", sub(filter="a/+", qos=0))
        idx.subscribe("s1", sub(filter="$share/g/a/+"))
    topics = ["a/b", "a", "x"]

    def run(e):
        if path == "batch":
            return e.subscribers_batch(topics)
        if path == "compact":
            return e.subscribers_compact_batch(topics)
        ctx = e.dispatch_fixed(topics)
        return e.decode_fixed(topics, *e.match_fixed([], out=ctx),
                              ctx[4], ctx[5])

    want, got = run(engines[0]), run(engines[1])
    for t, g, w in zip(topics, got, want):
        assert normalize(g) == normalize(w) == normalize(
            port.subscribers(t)), t
    assert engines[1]._overlay is not None and not engines[1]._overlay.empty
    # a journal gap: the batch is served from the trie
    for idx, sub in ((ref, RefSubscription), (port, Subscription)):
        idx._journal = type(idx._journal)(maxlen=4)
        for i in range(50):
            idx.subscribe(f"g{i}", sub(filter=f"q/{i}"))
    topics = ["q/7", "a/b"]
    fell = []
    for e in engines:
        before = e.fallbacks
        for t, g in zip(topics, run(e)):
            assert normalize(g) == normalize(port.subscribers(t)), t
        fell.append(e.fallbacks - before)
    assert fell[0] == fell[1] == len(topics)


# -- the constructor ------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"fixed_max_rows": 0}, {"fixed_max_rows": 15},
    {"kernel_width": "16"}])
def test_constructor_validation_matches_reference(kw):
    ref, port = twin([("c1", "a/#", {})])
    with pytest.raises(ValueError):
        RefEngine(ref, **kw)
    with pytest.raises(ValueError):
        SigEngine(port, device="cpu", **kw)


@pytest.mark.parametrize("name,port_value", [
    ("max_levels", None), ("fixed_max_rows", None), ("kernel_width", None),
    ("max_words", sigmod.MAX_WORDS),
    ("compact_word_slots", sigmod.COMPACT_WORD_SLOTS),
    ("compact_max_rows", sigmod.COMPACT_MAX_ROWS),
    ("compact_cap_per_topic", sigmod.COMPACT_CAP_PER_TOPIC)])
def test_defaults_equal_the_reference(name, port_value):
    """The constructor's defaults, and the word and compact bounds the
    port fixes, are the reference constructor's defaults."""
    ref, port = twin([("c1", "a/#", {}), ("c2", "a/+/b", {})])
    r = RefEngine(ref)
    e = SigEngine(port, device="cpu")
    got = getattr(e, name) if port_value is None else port_value
    assert got == getattr(r, name)
    assert e.tables.max_depth == r.tables.max_depth


def test_max_levels_reaches_the_compile_and_the_window():
    subs = [("c1", "/".join(["d"] * 10), {}), ("c2", "d/#", {})]
    ref, eng, port = pair(subs, max_levels=6)
    topics = ["/".join(["d"] * 10), "d/d", "/".join(["d"] * 7)]
    got, want = eng.match_raw(topics), ref.match_raw(topics)
    assert got[0].shape == want[0].shape
    assert np.array_equal(got[2], want[2]) and list(got[2]) == [
        True, False, True]
    assert eng.tables.max_depth == ref.tables.max_depth
    for t, g in zip(topics, eng.subscribers_batch(topics)):
        assert normalize(g) == normalize(port.subscribers(t)), t


# -- fault sites and error types ----------------------------------------------

def test_device_match_fires_where_the_reference_fires():
    """DEVICE_MATCH fires in match_raw and dispatch_fixed only: an armed
    fault fails subscribers_batch with DeviceMatchError (not the trie),
    and match_compact passes it by unconsumed."""
    subs, topics = corpus("uint8")
    ref, eng, _ = pair(subs)
    seen = []
    for mod, e in ((ref_faults, ref), (faults, eng)):
        mod.clear()
        try:
            mod.arm(mod.DEVICE_MATCH, "raise", 1)
            e.match_compact(topics)
            assert mod.fired.get(mod.DEVICE_MATCH, 0) == 0
            assert mod.armed(mod.DEVICE_MATCH)
            with pytest.raises(mod.DeviceMatchError) as exc:
                e.subscribers_batch(topics)
            assert mod.fired[mod.DEVICE_MATCH] == 1
            mod.arm(mod.DEVICE_MATCH, "raise", 1)
            with pytest.raises(mod.DeviceMatchError):
                e.match_fixed(topics)
            seen.append(type(exc.value).__name__)
        finally:
            mod.clear()
    assert seen == ["InjectedFault"] * 2


def test_declined_corpus_raises_and_is_served_by_the_trie(monkeypatch):
    monkeypatch.setattr(sigmod, "MAX_GROUPS", 2)
    monkeypatch.setattr(ref_sig, "MAX_GROUPS", 2)
    subs = [("c1", "a/+/#", {}), ("c2", "+/b/#", {}), ("c3", "a/b/c/#", {}),
            ("c4", "x/#", {})]
    ref, eng, port = pair(subs)
    topics = ["a/b/c", "x/y"]
    for e in (ref, eng):
        for call in (lambda: e.match_raw(topics),
                     lambda: e.match_compact(topics),
                     lambda: e.match_fixed(topics)):
            with pytest.raises(RuntimeError):
                call()
        for fn in ("subscribers_batch", "subscribers_compact_batch"):
            for t, g in zip(topics, getattr(e, fn)(topics)):
                assert normalize(g) == normalize(port.subscribers(t)), t
    with pytest.raises(sigmod.DeviceMatchingDeclined):
        eng.match_raw(topics)


@pytest.mark.parametrize("body,surface", [
    ("sig.sig_match_body", "subscribers_batch"),
    ("sig.sig_match_body", "match_raw"),
    ("sig.sig_match_compact_body", "subscribers_compact_batch"),
    ("sig.sig_match_compact_body", "match_compact"),
    ("sig_kernel.sig_match_fixed", "subscribers_fixed_batch")])
def test_device_runtime_error_surfaces_as_device_match_error(
        monkeypatch, body, surface):
    """A torch/CUDA RuntimeError inside a device surface reaches the
    caller as DeviceMatchError; only a declined corpus is served by the
    trie."""
    subs, topics = corpus("uint8")
    _ref, eng, _ = pair(subs)

    def boom(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    module, attr = body.split(".")
    monkeypatch.setattr({"sig": sigmod, "sig_kernel": sig_kernel}[module],
                        attr, boom)
    before = eng.fallbacks
    with pytest.raises(faults.DeviceMatchError, match="illegal memory"):
        getattr(eng, surface)(topics)
    assert eng.fallbacks == before
