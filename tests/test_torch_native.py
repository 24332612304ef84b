"""The port's native host runtime (``maxmq_tpu_torch/native.py`` over its
own copies of the C++ sources, built into ``build/maxmq_tpu_torch/``)
against the port's Python paths and the JAX package's native runtime.

Inputs come from numpy seeds. Every comparison is exact: token matrices
and signatures array for array, probe hits as sorted (topic, row) pairs,
frame ranges as lists, and decoded results as canonical (client, filter,
qos, flags, identifiers) tuples (the packages' result types differ)."""

import numpy as np
import pytest

from maxmq_tpu import native as ref_native
from maxmq_tpu.matching import sig as ref_sig
from maxmq_tpu.matching import trie as ref_trie
from maxmq_tpu.matching.trie import TopicIndex as RefIndex
from maxmq_tpu.protocol import Subscription as RefSubscription
from maxmq_tpu_torch import native
from maxmq_tpu_torch.matching import sig_tables, trie
from maxmq_tpu_torch.matching.sig import SigEngine
from maxmq_tpu_torch.matching.topics import tokenize_topics, valid_filter
from maxmq_tpu_torch.matching.trie import TopicIndex
from maxmq_tpu_torch.protocol import Subscription

WORDS = ["a", "b", "c", "", "temp", "température", "日本", "séance",
         "\U0001f600", "x" * 40]


def canon_sub(s):
    return (s.filter, s.qos, s.no_local, s.retain_as_published,
            s.retain_handling, s.identifier,
            tuple(sorted(s.identifiers.items())))


def canon(result, order_free=False):
    """Canonical form of a SubscriberSet, DeliveryIntents or
    ChainedIntents of either package. A client holding several matching
    filters gets one merged record that keeps the newest filter's
    ``filter``, flags and ``identifier`` (``merge_subscription``), so
    these follow the union order: the C pass unions a topic's row set in
    its own order, the Python union in pair order, the trie in walk
    order. ``order_free`` keeps only the fields every order agrees on
    (QoS, no_local, the identifiers by filter)."""
    ss = result.to_set() if hasattr(result, "to_set") else result
    subs = tuple(sorted(
        (c, (s.qos, s.no_local, tuple(sorted(s.identifiers.items())))
         if order_free else canon_sub(s))
        for c, s in ss.subscriptions.items()))
    shared = tuple(sorted(
        (key, tuple(sorted((c, canon_sub(s)) for c, s in m.items())))
        for key, m in ss.shared.items()))
    return subs, shared


def rand_topics(rng, n, words=WORDS, max_depth=7):
    """Topics of 1..max_depth levels over ``words`` (empty and non-ASCII
    levels included), some '$'-prefixed, plus edge topics: the empty
    topic, '/', leading/trailing/double slashes, 70 levels (too deep for
    every tokenizer window) and unseen levels."""
    out = []
    for _ in range(n):
        depth = int(rng.integers(1, max_depth + 1))
        t = "/".join(words[int(i)] for i in rng.integers(0, len(words),
                                                         depth))
        if rng.random() < 0.1:
            t = "$" + t
        out.append(t)
    out += ["", "/", "a//b", "/a", "a/", "$SYS", "$SYS/x/y",
            "/".join(["a"] * 70), "/".join(["b"] * 17), "unseen/level",
            "$", "日本/temp/"]
    return out


def rand_filters(rng, n, words=WORDS, max_depth=6, share=0.15):
    out = []
    while len(out) < n:
        depth = int(rng.integers(1, max_depth + 1))
        levels = [words[int(i)] for i in rng.integers(0, len(words), depth)]
        r = rng.random()
        if r < 0.3:
            levels[int(rng.integers(0, depth))] = "+"
        elif r < 0.5:
            levels = levels[:int(rng.integers(0, depth)) + 1] + ["#"]
        if rng.random() < 0.05:
            levels = ["$SYS"] + levels
        f = "/".join(levels)
        if rng.random() < share:
            f = f"$share/g{int(rng.integers(0, 3))}/{f}"
        if valid_filter(f):
            out.append(f)
    return out


def twin_index(filters, rng, n_clients):
    """(reference index, port index) with the same subscriptions: client
    ids repeat (so one client merges several filters), random QoS, flags
    and v5 identifiers."""
    ref, port = RefIndex(), TopicIndex()
    for i, f in enumerate(filters):
        cid = f"c{int(rng.integers(0, n_clients))}"
        kw = {"qos": int(rng.integers(0, 3)),
              "no_local": bool(rng.random() < 0.2),
              "retain_as_published": bool(rng.random() < 0.2),
              "retain_handling": int(rng.integers(0, 3)),
              "identifier": int(rng.integers(1, 9))
              if rng.random() < 0.3 else 0}
        ref.subscribe(cid, RefSubscription(filter=f, **kw))
        port.subscribe(cid, Subscription(filter=f, **kw))
    return ref, port


def sorted_pairs(ti, rw):
    pairs = np.stack([np.asarray(ti, dtype=np.int64),
                      np.asarray(rw, dtype=np.int64)], axis=1)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def list_pairs(rows_by_topic):
    ti = np.repeat(np.arange(len(rows_by_topic)),
                   [len(r) for r in rows_by_topic])
    rw = (np.concatenate([np.asarray(r, dtype=np.int64)
                          for r in rows_by_topic])
          if len(ti) else np.zeros(0, dtype=np.int64))
    return sorted_pairs(ti, rw)


def test_runtime_is_built_from_the_ports_sources():
    assert native.available() and native.decode_module() is not None, \
        native.build_errors
    for source in native.SOURCES:
        path = native.library_path(source)
        assert path.exists()
        assert path.parent == native.BUILD_DIR
        assert "native" not in path.parent.parts[-1]
    mod = native.decode_module()
    assert mod.__name__ == "maxmq_torch_decode"
    assert trie.SubscriberSet is mod.SubscriberSet
    assert trie.SubscriberSet is not ref_trie.SubscriberSet
    assert native.chain_params_in_effect(mod) == mod._get_chain_params()


# ---------------------------------------------------------------- tokenizer


@pytest.mark.parametrize("seed,max_levels", [(0, 16), (1, 4), (2, 1)])
def test_tokenize_equals_python_and_reference(seed, max_levels):
    rng = np.random.default_rng(seed)
    vocab = {}
    for w in WORDS[:7] + ["$SYS", "x" * 40]:
        vocab.setdefault(w, len(vocab) + 1)
    topics = rand_topics(rng, 300)
    got = native.NativeVocab(vocab).tokenize(topics, max_levels)
    want = tokenize_topics(vocab, topics, max_levels)
    ref = ref_native.NativeVocab(vocab).tokenize(topics, max_levels)
    assert len(native.NativeVocab(vocab)) == len(vocab)
    for g, w, r in zip(got, want, ref):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)
    assert (got[1] == -1).any() and got[2].any()


def test_tokenize_cached_takes_the_native_tokenizer():
    _ref, port = twin_index(["a/+", "temp/#", "日本/b"],
                            np.random.default_rng(3), 2)
    tables = sig_tables.compile_sig(port)
    topics = rand_topics(np.random.default_rng(4), 50)
    from maxmq_tpu_torch.matching.topics import tokenize_cached

    got = tokenize_cached(tables, topics, 8)
    assert isinstance(tables.__dict__["_native_vocab"], native.NativeVocab)
    for g, w in zip(got, tokenize_topics(tables.vocab, topics, 8)):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------- probes


def probe_tables(seed, n_filters=400):
    rng = np.random.default_rng(seed)
    filters = rand_filters(rng, n_filters)
    _ref, port = twin_index(filters, rng, 60)
    tables = sig_tables.compile_sig(port)
    assert tables.host_exact and tables.host_plus and tables.host_hash
    return tables, rand_topics(rng, 500)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_tokenize_sig_equals_numpy(seed):
    tables, topics = probe_tables(seed)
    window = max(tables.probe_depth, 1)
    dtype, _pad = sig_tables._compact_dtype(tables)
    toks, lens, esig = native.tokenize_sig(
        native.NativeVocab(tables.vocab), topics, window, dtype,
        native.ExactSigTable(tables.host_exact))
    w_toks, w_lens, toks32, lengths = sig_tables.tokenize_compact(
        tables, topics, window)
    np.testing.assert_array_equal(toks, w_toks)
    np.testing.assert_array_equal(lens, w_lens)
    assert toks.dtype == w_toks.dtype and lens.dtype == w_lens.dtype
    has = np.isin(lengths, list(tables.host_exact))
    assert has.any()
    np.testing.assert_array_equal(
        esig[has], sig_tables.exact_sigs(tables.host_exact, toks32,
                                         lengths)[has])


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_probes_equal_numpy(seed):
    tables, topics = probe_tables(seed)
    window = max(tables.probe_depth, 1)
    dtype, _pad = sig_tables._compact_dtype(tables)
    toks, lens_enc, toks32, lengths = sig_tables.tokenize_compact(
        tables, topics, window)
    dollar = lens_enc < 0
    esig = sig_tables.exact_sigs(tables.host_exact, toks32, lengths)
    want = sig_tables.host_exact_rows_from_sig(tables, esig, lengths)
    sig_tables.host_plus_rows(tables, toks, lengths, dollar, into=want)
    want = list_pairs(want)
    assert len(want)

    probe = native.NativeProbe(tables.host_exact, tables.host_plus)
    ti, rw = probe.run(np.ascontiguousarray(toks), lens_enc)
    np.testing.assert_array_equal(sorted_pairs(ti, rw), want)

    nv = native.NativeVocab(tables.vocab)
    f_toks, f_lens, f_ti, f_rw = native.tokenize_probe(nv, probe, topics,
                                                       window, dtype)
    np.testing.assert_array_equal(f_toks, toks)
    np.testing.assert_array_equal(f_lens, lens_enc)
    np.testing.assert_array_equal(sorted_pairs(f_ti, f_rw), want)

    # the '#' probe in depth->= mode against host_hash_rows
    hp = native.NativeProbe({}, tables.host_hash, ge_depth=True)
    h_ti, h_rw = hp.run(np.ascontiguousarray(toks), lens_enc)
    want_h = list_pairs(sig_tables.host_hash_rows(tables, toks, lengths,
                                                  dollar))
    assert len(want_h)
    np.testing.assert_array_equal(sorted_pairs(h_ti, h_rw), want_h)


@pytest.mark.parametrize("seed", [8, 9])
def test_prepare_batch_native_equals_numpy(seed):
    """The fused C++ pass (``HostRows``) against the numpy path of the
    same function, topic by topic."""
    tables, topics = probe_tables(seed)
    toks, lens_enc, hostrows = sig_tables.prepare_batch(tables, topics)
    assert isinstance(hostrows, sig_tables.HostRows)
    tables.__dict__["_native_fused"] = None        # numpy path from here
    tables.__dict__["_native_sig"] = None
    w_toks, w_lens, w_rows = sig_tables.prepare_batch(tables, topics)
    assert isinstance(w_rows, list)
    np.testing.assert_array_equal(toks, w_toks)
    np.testing.assert_array_equal(lens_enc, w_lens)
    assert len(hostrows) == len(w_rows) == len(topics)
    for i, (got, want) in enumerate(zip(hostrows, w_rows)):
        assert sorted(got.tolist()) == sorted(np.asarray(want).tolist())
        assert hostrows[i].tolist() == got.tolist()
    # _pairs_with_host takes either form and gives the same pairs
    fall = np.zeros(len(topics), dtype=bool)
    empty = np.zeros(0, dtype=np.int64)
    got = sig_tables._pairs_with_host(len(topics), empty, empty, hostrows,
                                      fall, tables)
    want = sig_tables._pairs_with_host(len(topics), empty, empty, w_rows,
                                       fall, tables)
    np.testing.assert_array_equal(sorted_pairs(*got), sorted_pairs(*want))


def test_prepare_batch_sig_native_equals_numpy():
    tables, topics = probe_tables(10)
    got = sig_tables.prepare_batch_sig(tables, topics, window=5)
    assert tables.__dict__["_native_sig"] is not None
    tables.__dict__["_native_sig"] = None
    want = sig_tables.prepare_batch_sig(tables, topics, window=5)
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        np.testing.assert_array_equal(g, w)
    lengths = want[3]
    has = np.isin(lengths, list(tables.host_exact))
    np.testing.assert_array_equal(got[2][has], want[2][has])


@pytest.mark.parametrize("prep", ["prepare_batch", "prepare_batch_sig",
                                  "tokenize_cached"])
def test_host_prep_routes_are_counted(prep):
    """Each host-prep function counts its topics under the route that
    served them: the C++ pass while the runtime is loaded, numpy (or the
    Python loop) once the snapshot's native handles are gone."""
    from maxmq_tpu_torch.matching import topics as topics_mod

    tables, topics = probe_tables(11)
    if prep == "tokenize_cached":
        counts, cache, slow = topics_mod.tokenized, "_native_vocab", "python"
        run = lambda: topics_mod.tokenize_cached(tables, topics, 8)
    else:
        counts, slow = sig_tables.prepared, "numpy"
        cache = {"prepare_batch": "_native_fused",
                 "prepare_batch_sig": "_native_sig"}[prep]
        run = lambda: getattr(sig_tables, prep)(tables, topics)
    for route in ("native", slow):
        before = dict(counts)
        got = run()
        assert {k: v - before[k] for k, v in counts.items()} == {
            "native": len(topics) if route == "native" else 0,
            slow: len(topics) if route == slow else 0}
        assert (tables.__dict__[cache] is None) == (route == slow)
        if route == "native":
            want = got
            tables.__dict__[cache] = None
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ frame scanner


def rand_frames(rng, n):
    """``n`` MQTT frames: a type/flags byte (types 1..15), the remaining
    length as a variable-byte integer (1..3 bytes) and that many bytes."""
    out = bytearray()
    for _ in range(n):
        out.append(int(rng.integers(1, 16)) << 4 | int(rng.integers(0, 16)))
        rem = int(rng.choice([rng.integers(0, 128), rng.integers(128, 700),
                              rng.integers(16384, 20000)],
                             p=[0.6, 0.35, 0.05]))
        v = rem
        while True:
            b = v & 0x7F
            v >>= 7
            out.append(b | (0x80 if v else 0))
            if not v:
                break
        out += rng.integers(0, 256, rem, dtype=np.uint8).tobytes()
    return bytes(out)


def scan_both(data, max_frames=4096):
    """(port C, port Python, reference C) results, or the exception
    message each raised."""
    out = []
    for fn in (native.scan_frames, native.scan_frames_py,
               ref_native.scan_frames):
        try:
            out.append(fn(data, max_frames))
        except (native.MalformedFrame, ref_native.MalformedFrame) as exc:
            out.append(("malformed", str(exc)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scan_frames_equals_python(seed):
    rng = np.random.default_rng(seed)
    data = rand_frames(rng, 3000)
    c, py, ref = scan_both(data)
    assert c == py == ref
    assert len(c[0]) == 3000 and c[1] == len(data)
    # cut at random points: partial varints and partial bodies wait
    for cut in rng.integers(0, len(data), 40):
        c, py, ref = scan_both(data[:int(cut)])
        assert c == py == ref
    # the frame cap
    c, py, ref = scan_both(data, max_frames=17)
    assert c == py == ref and len(c[0]) == 17


def test_scan_frames_malformed_equals_python():
    rng = np.random.default_rng(3)
    good = rand_frames(rng, 50)
    cases = [b"\x00\x00", good + b"\x00\x05hello",
             good + b"\x30\xff\xff\xff\xff\x01",   # 5-byte varint
             b"\x30\x80\x80\x80\x80"]
    for data in cases:
        c, py, ref = scan_both(data)
        assert c == py == ref
        assert c[0] == "malformed"
    with pytest.raises(native.MalformedFrame):
        native.scan_frames(cases[1])


# ------------------------------------------------------------------- decode


@pytest.fixture
def ref_capsule(monkeypatch):
    """The JAX package's native decode table of a compiled snapshot. Its
    import-time rebind binds only an extension already built; here the
    extension is built, configured with the JAX package's own callbacks,
    and its result type is the one ``_native_decode`` checks against for
    the length of the test."""
    mod = ref_native.decode_module()
    assert mod is not None
    mod.configure(ref_trie.merge_subscription, ref_trie._copy_subscription)
    monkeypatch.setattr(ref_sig, "SubscriberSet", mod.SubscriberSet)

    def capsule(tables):
        tables.__dict__.pop("_native_decode", None)
        nd = ref_sig._native_decode(tables)
        assert nd is not None
        return nd
    return capsule


def decode_inputs(seed, n_filters=500, n_topics=600):
    """Twin indexes, both packages' compiled tables (the same rows), and
    one batch's (toks, lens_enc, ti, rw): every candidate the three host
    probes find, plus random rows that fail verification."""
    rng = np.random.default_rng(seed)
    filters = rand_filters(rng, n_filters, share=0.2)
    ref, port = twin_index(filters, rng, 80)
    tables = sig_tables.compile_sig(port)
    ref_tables = ref_sig.compile_sig(ref)
    assert ref_tables.row_levels == tables.row_levels
    assert ref_tables.vocab == tables.vocab
    topics = rand_topics(rng, n_topics)
    toks, lens_enc, toks32, lengths = sig_tables.tokenize_compact(tables,
                                                                  topics)
    dollar = lens_enc < 0
    rows = sig_tables.host_exact_rows_from_sig(
        tables, sig_tables.exact_sigs(tables.host_exact, toks32, lengths),
        lengths)
    sig_tables.host_plus_rows(tables, toks, lengths, dollar, into=rows)
    sig_tables.host_hash_rows(tables, toks, lengths, dollar, into=rows)
    real = list_pairs(rows)
    n_rows = len(tables.row_levels)
    cand = np.stack([rng.integers(0, len(topics), 3 * len(topics)),
                     rng.integers(0, n_rows, 3 * len(topics))], axis=1)
    seen = {tuple(p) for p in real.tolist()}
    junk = np.unique(np.array([p for p in cand.tolist()
                               if tuple(p) not in seen],
                              dtype=np.int64).reshape(-1, 2), axis=0)
    ti = np.concatenate([real[:, 0], junk[:, 0]])
    rw = np.concatenate([real[:, 1], junk[:, 1]])
    too_deep = lengths < 0
    keep = ~too_deep[ti]
    return (ref, port, tables, ref_tables, topics, toks, lens_enc,
            np.ascontiguousarray(ti[keep]), np.ascontiguousarray(rw[keep]))


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_decode_equals_python_and_reference(seed, ref_capsule):
    (ref, port, tables, ref_tables, topics, toks, lens_enc, ti,
     rw) = decode_inputs(seed)
    batch = len(topics)
    _dt, pad = sig_tables._compact_dtype(tables)
    args = (toks, toks.dtype.itemsize, int(pad), lens_enc, batch, ti, rw)
    mod, cap = sig_tables._native_decode(tables)
    sets = mod.decode_batch(cap, *args)
    intents = mod.decode_batch_intents(cap, *args)
    python = SigEngine._decode_python(tables, {}, toks, lens_enc, batch, ti,
                                      rw, None)
    rmod, rcap = ref_capsule(ref_tables)
    ref_sets = rmod.decode_batch(rcap, *args)
    ref_intents = rmod.decode_batch_intents(rcap, *args)
    assert all(type(s) is trie.SubscriberSet for s in sets)
    assert all(type(s) is mod.DeliveryIntents for s in intents)
    stored = {id(e.subscription) for e in tables.entries if not e.group}
    shared = merged = aliased = 0
    for i, topic in enumerate(topics):
        # the two packages' C passes are one code: every field agrees
        want = canon(sets[i])
        assert canon(ref_sets[i]) == want, topic
        assert canon(ref_intents[i]) == canon(intents[i]), topic
        # across the set and intents forms (whose unions run in orders of
        # their own), the Python union and the trie: the order-free
        # fields, and every field of a record no merge made
        free = canon(sets[i], order_free=True)
        assert canon(intents[i], order_free=True) == free, topic
        assert canon(python[i], order_free=True) == free, topic
        for cid, sub in python[i].subscriptions.items():
            if id(sub) in stored:
                aliased += 1
                for got in (sets[i], intents[i].to_set()):
                    assert canon_sub(got.subscriptions[cid]) == \
                        canon_sub(sub), (topic, cid)
        if abs(int(lens_enc[i])) != 127:
            assert canon(port.subscribers(topic), order_free=True) == \
                free, topic
        shared += bool(want[1])
        merged += any(len(s[2]) > 1 for _c, s in free[0])
    # shared groups, identifier merges and plain records all ran
    assert shared and merged and aliased
    assert len(ti) > int(
        sig_tables.verify_pairs(tables, *_verify_args(tables, toks,
                                                      lens_enc), ti,
                                rw).sum())           # rejected pairs ran


def _verify_args(tables, toks, lens_enc):
    dtype, pad = sig_tables._compact_dtype(tables)
    toks32 = toks.astype(np.int32)
    if dtype is not np.int32:
        toks32[toks32 == pad] = -1
    return toks32, np.abs(lens_enc.astype(np.int32)), lens_enc < 0


def test_decode_prewarm_and_intents_surface():
    (_ref, port, tables, _rt, topics, toks, lens_enc, ti,
     rw) = decode_inputs(14, n_filters=300, n_topics=200)
    assert sig_tables.prewarm_tables(tables) > 0
    mod, cap = sig_tables._native_decode(tables)
    _dt, pad = sig_tables._compact_dtype(tables)
    batch = len(topics)
    got = mod.decode_batch_intents(cap, toks, toks.dtype.itemsize, int(pad),
                                   lens_enc, batch, ti, rw)
    for topic, r in zip(topics, got):
        s = r.to_set()
        assert r.to_set() is s                # cached on the object
        by_iter = dict(iter(r))
        assert by_iter == s.subscriptions
        assert r.n == len(by_iter)
        assert len(r) == len(s)
        assert r.shared == s.shared
        for cid in by_iter:
            assert r.has_client(cid)
        assert not r.has_client("no-such-client")
