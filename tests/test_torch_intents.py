"""The signature engines' result forms on the port's native decode:
merged ``SubscriberSet``s and ``DeliveryIntents`` (``SigEngine``), and
``ChainedIntents`` in cluster mode (``ShardedSigEngine``), against the
CPU trie and the JAX package's engines, on the CPU.

Results are compared exactly in their order-free form (``normalize``:
per client QoS and v5 identifiers, per shared group its members): the C
pass unions a topic's rows in an order of its own, the trie in walk
order, and a merged record keeps the newest filter's flags."""

import os
import random
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from maxmq_tpu.matching import TopicIndex as RefIndex
from maxmq_tpu.matching import trie as ref_trie
from maxmq_tpu.matching.sig import SigEngine as RefEngine
from maxmq_tpu.parallel import sharded as ref_sharded
from maxmq_tpu.protocol import Subscription as RefSubscription
from maxmq_tpu_torch import native
from maxmq_tpu_torch.matching import trie
from maxmq_tpu_torch.matching.sig import SigEngine
from maxmq_tpu_torch.matching.topics import valid_filter
from maxmq_tpu_torch.matching.trie import TopicIndex
from maxmq_tpu_torch.parallel.sharded import (ChainedIntents,
                                              ShardedSigEngine, make_mesh)
from maxmq_tpu_torch.protocol import Subscription

from test_nfa_parity import normalize, rand_corpus

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def as_set(result):
    return result.to_set() if hasattr(result, "to_set") else result


def corpus(seed, n_filters=200, n_clients=50):
    """(reference index, port index, topics): the randomized corpora the
    JAX package's intents tests use, with v5 identifiers and QoS from the
    seed; client ids repeat, so records merge."""
    rng = random.Random(seed)
    filters, topics = rand_corpus(rng, n_filters=n_filters,
                                  n_clients=n_clients)
    ref, port = RefIndex(), TopicIndex()
    for i, f in enumerate(filters):
        if not valid_filter(f):
            continue
        cid = f"c{i % n_clients}"
        kw = {"qos": rng.randint(0, 2), "identifier": rng.randint(0, 5)}
        ref.subscribe(cid, RefSubscription(filter=f, **kw))
        port.subscribe(cid, Subscription(filter=f, **kw))
    return ref, port, topics


def engines(ref, port, intents, **kw):
    want = RefEngine(ref, **kw)
    eng = SigEngine(port, device="cpu", **kw)
    for e in (want, eng):
        e.emit_intents = intents
        e.route_small = False       # parity must not pass through the trie
    return want, eng


@pytest.mark.parametrize("path", ["fixed", "host"])
@pytest.mark.parametrize("intents", [True, False])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_sig_engine_forms_equal_trie_and_reference(seed, intents, path):
    ref, port, topics = corpus(seed)
    want_eng, eng = engines(ref, port, intents)
    run = {"fixed": lambda e: e.subscribers_fixed_batch(topics),
           "host": lambda e: e.subscribers_host_batch(topics)}[path]
    got, want = run(eng), run(want_eng)
    mod = native.decode_module()
    kind = mod.DeliveryIntents if intents else trie.SubscriberSet
    route = "native-intents" if intents else "native-sets"
    assert eng.decoded == {"native-sets": 0, "native-intents": 0,
                           "python": 0, route: len(topics)}
    for topic, g, w in zip(topics, got, want):
        assert type(g) is kind, topic
        assert normalize(as_set(g)) == normalize(as_set(w)), topic
        assert normalize(as_set(g)) == normalize(port.subscribers(topic)), \
            topic
    if intents:
        _w, sets_eng = engines(ref, port, False)
        for topic, g, s in zip(topics, got,
                               sets_eng.subscribers_fixed_batch(topics)):
            assert normalize(g.to_set()) == normalize(s), topic
            by_iter = dict(iter(g))
            assert set(by_iter) == set(s.subscriptions), topic
            assert g.n == len(by_iter)
            assert len(g) == len(s), topic


def test_intents_repeat_topics_share_one_result():
    """Results are shared and immutable: a repeated row set resolves to
    one cached object, whose ``to_set()`` is cached too."""
    port = TopicIndex()
    for i in range(50):
        port.subscribe(f"c{i}", Subscription(filter="hot/#", qos=1))
    eng = SigEngine(port, device="cpu")
    eng.emit_intents = True
    eng.route_small = False
    t = ["hot/x"] * 4 + ["hot/y"] * 4
    got = eng.subscribers_fixed_batch(t)
    assert got[0] is got[3] and got[0] is got[4]
    assert got[0].to_set() is got[0].to_set()
    assert len(got[0].to_set().subscriptions) == 50


def test_overlay_window_degrades_to_sets():
    """A subscription newer than the compiled tables is served through
    the overlay, which mutates its results: those batches keep the set
    form (the Python union) until the recompile lands."""
    ref, port, topics = corpus(21)
    eng = SigEngine(port, device="cpu", auto_refresh=False)
    eng.emit_intents = True
    eng.route_small = False
    for t in topics[:20]:
        port.subscribe("late", Subscription(filter=t, qos=2))
    got = eng.subscribers_fixed_batch(topics)
    assert eng.decoded["python"] == len(topics)
    assert eng.decoded["native-intents"] == 0
    for topic, g in zip(topics, got):
        assert type(g) is trie.SubscriberSet, topic
        assert normalize(g) == normalize(port.subscribers(topic)), topic
    assert "late" in got[0].subscriptions
    eng.refresh()                       # the recompile lands: intents again
    got = eng.subscribers_fixed_batch(topics)
    assert eng.decoded["native-intents"] == len(topics)
    for topic, g in zip(topics, got):
        assert normalize(g.to_set()) == normalize(port.subscribers(topic))


def test_prewarm_decode_bases_counts_chunks():
    port = TopicIndex()
    for i in range(300):
        port.subscribe(f"c{i % 120}", Subscription(filter=f"p/{i % 7}/#"))
    eng = SigEngine(port, device="cpu")
    assert eng.prewarm_decode_bases() == 0            # intents off
    eng.emit_intents = True
    assert eng.prewarm_decode_bases(chunk=2) > 0


# ------------------------------------------------------------ cluster mode


def cluster_corpus(seed):
    """A corpus whose '$share' groups hold many clients, so client-hash
    sharding spreads every group's members over several shards."""
    rng = random.Random(seed)
    ref, port = RefIndex(), TopicIndex()
    alphabet = ["a", "b", "c", "d"]
    for i in range(400):
        depth = rng.randint(1, 4)
        levels = [rng.choice(alphabet) for _ in range(depth)]
        r = rng.random()
        if r < 0.3:
            levels[rng.randrange(depth)] = "+"
        elif r < 0.45:
            levels = levels[:rng.randint(1, depth)] + ["#"]
        f = "/".join(levels)
        if rng.random() < 0.3:
            f = f"$share/g{rng.randint(0, 1)}/{f}"
        cid = f"c{rng.randrange(150)}"
        kw = {"qos": rng.randint(0, 2), "identifier": rng.randint(0, 3)}
        ref.subscribe(cid, RefSubscription(filter=f, **kw))
        port.subscribe(cid, Subscription(filter=f, **kw))
    topics = ["/".join(rng.choice(alphabet) for _ in range(rng.randint(1, 5)))
              for _ in range(300)]
    topics += ["$SYS/a", "a//b", "/a", "/".join(["a"] * 70)]
    return ref, port, topics


# whether the JAX package's trie bound its C ``SubscriberSet`` at import
# (``maxmq_tpu/matching/trie.py:163-176``: only when
# ``native/maxmq_decode.so`` was already built): its sharded engine chains
# intents only then, and answers merged sets otherwise
REF_NATIVE_SETS = ref_trie.SubscriberSet is not ref_trie._PySubscriberSet


def sharded_pair(ref, port, shape=(2, 4)):
    want = ref_sharded.ShardedSigEngine(
        ref, mesh=ref_sharded.make_mesh(shape=shape))
    eng = ShardedSigEngine(port, mesh=make_mesh(
        shape, devices=[CPU] * (shape[0] * shape[1])))
    want.emit_intents = eng.emit_intents = True
    return want, eng


@pytest.mark.parametrize("path", ["batch", "host"])
def test_sharded_chained_intents_equal_reference(path):
    ref, port, topics = cluster_corpus(31)
    want_eng, eng = sharded_pair(ref, port)
    assert eng._state.chain_ok
    run = {"batch": lambda e: e.subscribers_batch(topics),
           "host": lambda e: e.subscribers_host_batch(topics)}[path]
    got, want = run(eng), run(want_eng)
    spans = 0
    for topic, g, w in zip(topics, got, want):
        full = normalize(port.subscribers(topic))
        assert normalize(as_set(g)) == normalize(as_set(w)) == full, topic
        if len(topic.split("/")) > 63:
            assert type(g) is trie.SubscriberSet     # served by the trie
            continue
        assert isinstance(g, ChainedIntents), topic
        if REF_NATIVE_SETS:
            assert type(w).__name__ == "ChainedIntents", topic
        assert len(g.parts) == eng.sp
        by_iter = dict(iter(g))
        assert set(by_iter) == set(g.to_set().subscriptions)
        assert g.n == len(by_iter) and len(g) == len(g.to_set())
        assert all(g.has_client(c) for c in by_iter)
        assert g.to_set() is g.to_set()
        spans += any(sum(key in p.shared for p in g.parts) > 1
                     for key in g.shared)
    assert spans, "no shared group spanned shards"
    assert eng.decoded["native-intents"] == len(topics)
    # the set path of the same engine gives the same answers
    eng.emit_intents = False
    for topic, g, s in zip(topics, got, run(eng)):
        assert normalize(as_set(g)) == normalize(s), topic


def test_sharded_prewarm_and_round_robin_keep_sets():
    ref, port, topics = cluster_corpus(32)
    _want, eng = sharded_pair(ref, port, shape=(1, 4))
    assert eng.prewarm_decode_bases() > 0
    eng.emit_intents = False
    assert eng.prewarm_decode_bases() == 0
    eng.emit_intents = True
    # round-robin shards (chain_ok False) never take the intents decode:
    # a client's entries may sit on several shards there
    eng._state = eng._state._replace(chain_ok=False)
    assert eng.prewarm_decode_bases() == 0
    for topic, g in zip(topics, eng.subscribers_batch(topics)):
        assert type(g) is trie.SubscriberSet
        assert normalize(g) == normalize(port.subscribers(topic)), topic
    assert eng.decoded["native-intents"] == 0


# --------------------------------------------------------- MAXMQ_NO_NATIVE


ANSWERS = textwrap.dedent("""
    import random, sys
    from maxmq_tpu_torch import native
    from maxmq_tpu_torch.matching import trie
    from maxmq_tpu_torch.matching.sig import SigEngine
    from maxmq_tpu_torch.matching.topics import valid_filter
    from maxmq_tpu_torch.matching.trie import TopicIndex
    from maxmq_tpu_torch.parallel.sharded import ShardedSigEngine, make_mesh
    from maxmq_tpu_torch.protocol import Subscription

    rng = random.Random(41)
    words = ["a", "b", "", "c"]
    idx = TopicIndex()
    for i in range(300):
        lv = [rng.choice(words + ["+"]) for _ in range(rng.randint(1, 4))]
        if rng.random() < 0.2:
            lv.append("#")
        f = "/".join(lv)
        if rng.random() < 0.2:
            f = "$share/g/" + f
        if valid_filter(f):
            idx.subscribe(f"c{i % 60}", Subscription(
                filter=f, qos=i % 3, identifier=i % 4))
    topics = ["/".join(rng.choice(words) for _ in range(rng.randint(1, 5)))
              for _ in range(200)] + ["$SYS/a"]

    def form(r):
        s = r.to_set() if hasattr(r, "to_set") else r
        return (sorted((c, x.qos, sorted(x.identifiers.items()))
                       for c, x in s.subscriptions.items()),
                sorted((k, sorted(m)) for k, m in s.shared.items()))

    eng = SigEngine(idx, device="cpu")
    eng.route_small = False
    eng.emit_intents = True
    mesh = make_mesh((2, 2), devices=["cpu"] * 4)
    sh = ShardedSigEngine(idx, mesh=mesh)
    sh.emit_intents = True
    res = (eng.subscribers_fixed_batch(topics)
           + eng.subscribers_host_batch(topics)
           + sh.subscribers_batch(topics))
    print(native.available(), trie.SubscriberSet is trie._PySubscriberSet,
          sorted({type(r).__name__ for r in res}), eng.decoded["python"],
          sh.decoded["python"])
    print(repr([form(r) for r in res]))
""")


def test_no_native_gives_python_results():
    """MAXMQ_NO_NATIVE selects the Python paths: the Python SubscriberSet,
    no native library, and the same answers as the native run."""
    def run(no_native):
        env = dict(os.environ)
        env.pop("MAXMQ_NO_NATIVE", None)
        if no_native:
            env["MAXMQ_NO_NATIVE"] = "1"
        proc = subprocess.run([sys.executable, "-c", ANSWERS], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout.splitlines()

    py_head, py_answers = run(True)
    c_head, c_answers = run(False)
    assert py_head == "False True ['SubscriberSet'] 402 201"
    # (topics past fixed_max_rows rows are served by the trie, as sets)
    assert c_head == ("True False ['ChainedIntents', 'DeliveryIntents', "
                      "'SubscriberSet'] 0 0")
    assert py_answers == c_answers
