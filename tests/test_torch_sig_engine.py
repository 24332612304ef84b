"""The port's SigEngine (device="cpu", so the kernel's plain version runs)
against the JAX package's SigEngine and the CPU trie, on the corpora the
JAX signature matcher is held to (tests/test_sig_parity.py). Results are
compared as normalized field tuples: the two packages' Subscription and
SubscriberSet classes differ."""

import random

import numpy as np
import pytest

from maxmq_tpu import faults as ref_faults
from maxmq_tpu.matching import TopicIndex as RefIndex
from maxmq_tpu.matching.sig import SigEngine as RefEngine
from maxmq_tpu.matching.topics import valid_filter
from maxmq_tpu.protocol import Subscription as RefSubscription
from maxmq_tpu_torch import faults
from maxmq_tpu_torch.matching import sig as sigmod
from maxmq_tpu_torch.matching.sig import SigEngine
from maxmq_tpu_torch.matching.trie import TopicIndex
from maxmq_tpu_torch.protocol import Subscription

from test_nfa_parity import normalize, rand_corpus

PATHS = ("batch", "fixed", "host")


@pytest.fixture(autouse=True)
def _always_device_path(monkeypatch):
    """Keep the small-corpus router from serving these tests from the
    trie (parity would pass vacuously) — in both packages."""
    monkeypatch.setattr(SigEngine, "ROUTE_SUBS_MAX", -1)
    monkeypatch.setattr(RefEngine, "ROUTE_SUBS_MAX", -1)


def twin(subs):
    """(reference index, port index) holding the same subscriptions."""
    ref, port = RefIndex(), TopicIndex()
    for cid, f, kw in subs:
        ref.subscribe(cid, RefSubscription(filter=f, **kw))
        port.subscribe(cid, Subscription(filter=f, **kw))
    return ref, port


def run_path(engine, path, topics):
    if path == "batch":
        return engine.subscribers_batch(topics)
    if path == "host":
        return engine.subscribers_host_batch(topics)
    return engine.subscribers_fixed_batch(topics)


def check_parity(subs, topics, **kw):
    ref, port = twin(subs)
    ref_engine = RefEngine(ref, **kw)
    engine = SigEngine(port, device="cpu", **kw)
    want_ref = ref_engine.subscribers_fixed_batch(topics)
    for path in PATHS:
        got = run_path(engine, path, topics)
        for topic, g, w in zip(topics, got, want_ref):
            assert normalize(g) == normalize(w), (path, topic)
            assert normalize(g) == normalize(port.subscribers(topic)), \
                (path, topic)
    return engine


CASES = {
    "basics": ([("c1", "a/b/c", {"qos": 1}), ("c2", "a/+/c", {"qos": 2}),
                ("c3", "a/#", {}), ("c4", "#", {}), ("c5", "+", {})],
               ["a/b/c", "a/x/c", "a", "a/b", "x", "x/y", "a/b/c/d",
                "$SYS/x", "$SYS"]),
    "hash_parent_dollar": (
        [("c1", "sport/tennis/#", {}), ("c2", "$SYS/#", {}),
         ("c3", "$SYS/+/x", {}), ("c4", "+/tennis/+", {})],
        ["sport/tennis", "sport/tennis/p1", "sport", "$SYS/broker/x",
         "$SYS/broker", "$SYS", "a/tennis/b"]),
    "empty_levels": ([("c1", "/", {}), ("c2", "//", {}), ("c3", "+/", {}),
                      ("c4", "a//b", {})],
                     ["/", "//", "a//b", "never-seen-token/x", "a/b",
                      "never/", "/"]),
    "shared": ([("w1", "$share/g1/t/+", {}), ("w2", "$share/g1/t/+", {}),
                ("w3", "$share/g2/t/a", {}), ("w4", "$share/g3/t/#", {}),
                ("n1", "t/a", {"qos": 1})],
               ["t/a", "t/b", "t", "x"]),
    "overlap_merge": ([("c1", "m/+", {"qos": 0, "identifier": 3}),
                       ("c1", "m/x", {"qos": 2, "identifier": 9}),
                       ("c1", "m/#", {"qos": 1, "identifier": 4})],
                      ["m/x", "m/y", "m"]),
    "too_deep": ([("c1", "a/#", {})],
                 ["a/" + "/".join(str(i) for i in range(80)), "a/b"]),
    "deep_filter": ([("c1", "/".join(str(i) for i in range(70)), {}),
                     ("c2", "a/b", {})],
                    ["/".join(str(i) for i in range(70)), "a/b"]),
    "row_overflow": ([(f"c{i}", f"x/+/s{i}/#", {}) for i in range(12)]
                     + [(f"e{i}", "x/y/+/#", {}) for i in range(12)],
                     ["x/y/s0/t", "x/y/s3", "x/q"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_parity(case):
    subs, topics = CASES[case]
    check_parity(subs, topics)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("kernel_width", ["auto", "32"])
def test_randomized_parity(seed, kernel_width):
    rng = random.Random(seed)
    filters, topics = rand_corpus(rng, n_filters=300, n_clients=30)
    subs = [(f"c{i % 30}", f, {"qos": rng.randint(0, 2),
                               "identifier": rng.randint(0, 5)})
            for i, f in enumerate(filters) if valid_filter(f)]
    check_parity(subs, topics, kernel_width=kernel_width,
                 fixed_max_rows=4)


def test_fallback_counters_and_bucket_ladder():
    rng = random.Random(11)
    filters, _ = rand_corpus(rng, 300, 40)
    subs = [(f"cl-{i % 40}", f, {"qos": i % 3})
            for i, f in enumerate(filters) if valid_filter(f)]
    ref, port = twin(subs)
    engine = SigEngine(port, device="cpu", auto_refresh=False)
    alphabet = [f"t{i}" for i in range(8)]
    for size in (1, 15, 16, 17, 63, 65, 257):
        topics = ["/".join(rng.choice(alphabet)
                           for _ in range(rng.randint(1, 5)))
                  for _ in range(size)]
        for t, g in zip(topics, engine.subscribers_fixed_batch(topics)):
            assert normalize(g) == normalize(port.subscribers(t)), t
    deep = "t0/" + "/".join(["t1"] * 90)
    before = engine.fallbacks
    engine.subscribers_fixed_batch([deep])
    assert engine.fallbacks == before + 1
    assert engine.matches > 0 and engine.host_matches == 0


def test_device_tables_from_either_package_agree():
    """device_tables gives identical state from the reference's compiled
    tables and from the port's own."""
    filters, _ = rand_corpus(random.Random(4), 300, 20)
    ref, port = twin([(f"c{i}", f, {}) for i, f in enumerate(filters)
                      if valid_filter(f)])
    a = sigmod.device_tables(sigmod.table_arrays(
        RefEngine(ref, auto_refresh=False).tables), "cpu")
    b = sigmod.device_tables(sigmod.table_arrays(
        SigEngine(port, device="cpu", auto_refresh=False).tables), "cpu")
    assert a.keys() == b.keys()
    for k in a:
        if hasattr(a[k], "shape"):
            assert a[k].dtype == b[k].dtype and (a[k] == b[k]).all(), k
        else:
            assert a[k] == b[k], k


def _frozen(idx):
    engine = SigEngine(idx, device="cpu")
    engine.refresh_soon = lambda: None
    return engine


def test_overlay_serves_mutations_then_refresh():
    ref, port = twin([("c1", "a/+", {"qos": 1}), ("c2", "a/b", {}),
                      ("c5", "a/#", {})])
    engine = _frozen(port)
    base = engine.tables.version
    for idx, sub in ((ref, RefSubscription), (port, Subscription)):
        idx.subscribe("c3", sub(filter="a/#", qos=2))          # add
        idx.unsubscribe("c2", "a/b")                           # remove
        idx.subscribe("c1", sub(filter="a/+", qos=0))          # replace
        idx.subscribe("s1", sub(filter="$share/g/a/+"))        # shared
    ref_engine = RefEngine(ref)
    topics = ["a/b", "a", "x"]
    for path in PATHS:
        for t, g, w in zip(topics, run_path(engine, path, topics),
                           ref_engine.subscribers_fixed_batch(topics)):
            assert normalize(g) == normalize(w) == \
                normalize(port.subscribers(t)), (path, t)
    assert engine.tables.version == base           # served by the overlay
    assert engine._overlay is not None and not engine._overlay.empty
    engine.refresh()
    assert engine.tables.version == port.sub_version
    got = engine.subscribers_fixed_batch(["a/b"])[0]
    assert normalize(got) == normalize(port.subscribers("a/b"))


def test_overlay_journal_gap_resyncs_via_trie():
    _, port = twin([("c1", "a/b", {}), ("c2", "a/#", {})])
    engine = _frozen(port)
    port._journal = type(port._journal)(maxlen=4)
    for i in range(50):
        port.subscribe(f"g{i}", Subscription(filter=f"q/{i}"))
    got = engine.subscribers_fixed_batch(["q/7", "a/b"])
    assert normalize(got[0]) == normalize(port.subscribers("q/7"))
    assert normalize(got[1]) == normalize(port.subscribers("a/b"))
    assert engine.fallbacks >= 2


def test_pathological_group_count_falls_back_to_trie(monkeypatch):
    monkeypatch.setattr(sigmod, "MAX_GROUPS", 2)
    _, port = twin([("c1", "a/+/#", {}), ("c2", "+/b/#", {}),
                    ("c3", "a/b/c/#", {}), ("c4", "x/#", {})])
    engine = SigEngine(port, device="cpu")
    for path in PATHS:
        got = run_path(engine, path, ["a/b/c", "x/y"])
        assert normalize(got[0]) == normalize(port.subscribers("a/b/c"))
        assert normalize(got[1]) == normalize(port.subscribers("x/y"))
    with pytest.raises(sigmod.DeviceMatchingDeclined):
        engine.dispatch_fixed(["a/b/c"])
    port.unsubscribe("c3", "a/b/c/#")
    port.unsubscribe("c4", "x/#")
    monkeypatch.setattr(sigmod, "MAX_GROUPS", 4096)
    engine.refresh()
    assert engine._state.program is not None


@pytest.mark.parametrize("site", ["DEVICE_MATCH", "DEVICE_RECOMPILE"])
def test_fault_sites_raise_like_reference(site):
    """Both packages fire the same sites with the same exception types."""
    subs = [("c1", "a/#", {}), ("c2", "a/+", {})]
    ref, port = twin(subs)
    ref_engine, engine = RefEngine(ref), SigEngine(port, device="cpu")
    raised = []
    for mod, eng, idx, sub in ((ref_faults, ref_engine, ref, RefSubscription),
                               (faults, engine, port, Subscription)):
        mod.clear()
        try:
            mod.arm(getattr(mod, site), "raise", 1)
            if site == "DEVICE_MATCH":
                call = lambda: eng.subscribers_fixed_batch(["a/b"])
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
    assert [type(e).__mro__[1].__name__ for e in raised] == \
        ["DeviceMatchError"] * 2
    assert all(isinstance(e, RuntimeError) for e in raised)


def test_env_spec_arms_sites():
    reg = faults.FaultRegistry()
    reg.arm_from_spec("device.match:raise:2,device.match:hang:1:0")
    with pytest.raises(faults.InjectedFault):
        reg.fire(faults.DEVICE_MATCH)
    with pytest.raises(faults.InjectedFault):
        reg.fire(faults.DEVICE_MATCH)
    assert reg.fire(faults.DEVICE_MATCH) is True       # hang, 0 s
    assert reg.fire(faults.DEVICE_MATCH) is False
    assert reg.fired[faults.DEVICE_MATCH] == 3


def test_dispatch_collect_pipelining_and_warm():
    filters, topics = rand_corpus(random.Random(8), 300, 30)
    _, port = twin([(f"c{i % 30}", f, {}) for i, f in enumerate(filters)
                    if valid_filter(f)])
    engine = SigEngine(port, device="cpu", auto_refresh=False)
    engine.warm_buckets(300, background=False)
    ctxs = [engine.dispatch_fixed(topics[i:i + 100])
            for i in range(0, 300, 100)]
    for i, ctx in zip(range(0, 300, 100), ctxs):
        got = engine.collect_fixed(topics[i:i + 100], ctx)
        for t, g in zip(topics[i:i + 100], got):
            assert normalize(g) == normalize(port.subscribers(t)), t
    assert engine.prewarm_decode_bases() == 0


def test_stream_prefetch_shortfall_fetches_rest(monkeypatch):
    monkeypatch.setattr(sigmod, "_STREAM_CHUNK", 8)
    subs = ([(f"c{i}", f"a/{i}/#", {}) for i in range(40)]
            + [(f"w{i}", "a/+/x", {}) for i in range(40)])
    _, port = twin(subs)
    engine = SigEngine(port, device="cpu", auto_refresh=False)
    engine._stream_rows_hint = 0        # prefetch just one tiny slice
    topics = [f"a/{i}/x" for i in range(40)]
    for t, s in zip(topics, engine.subscribers_fixed_batch(topics)):
        assert normalize(s) == normalize(port.subscribers(t)), t
    assert engine._stream_rows_hint > 0


def test_single_topic_surface_and_validation():
    _, port = twin([("c1", "a/b", {}), ("c2", "a/+", {})])
    engine = SigEngine(port, device="cpu")
    assert sorted(engine.subscribers("a/b").subscriptions) == ["c1", "c2"]
    with pytest.raises(ValueError):
        SigEngine(port, device="cpu", fixed_max_rows=15)
    with pytest.raises(ValueError):
        SigEngine(port, device="cpu", kernel_width="16")
    assert np.array_equal(engine.tables.row_sig, engine.tables.row_sig)


def test_decode_memoizes_per_row_fragment():
    """Single-row topics share the row's memoized fragment, within a batch
    and across calls; multi-row unions equal the plain sequential union
    field for field (overlapping clients, identifiers, '$share')."""
    from maxmq_tpu_torch.matching.sig_tables import _union_pairs

    subs = [(f"c{i}", f"m/{i % 3}/#", {"qos": i % 3}) for i in range(30)]
    subs += [("c0", "m/+/a", {"identifier": 2, "qos": 2}),
             ("c3", "m/+", {"identifier": 5}), ("y", "$share/g/q/#", {}),
             ("z", "$share/g/m/+/a", {})]
    _, port = twin(subs)
    engine = SigEngine(port, device="cpu", auto_refresh=False)
    topics = ["m/1/b", "m/1/c", "m/0/a", "m/1", "q/x", "q"]
    got = engine.subscribers_fixed_batch(topics)
    for t, g in zip(topics, got):
        assert normalize(g) == normalize(port.subscribers(t)), t
    assert got[0] is got[1]                       # one row: the fragment
    assert engine.subscribers_fixed_batch(["m/1/z"])[0] is got[0]
    tables = engine.tables
    rows = [r for r, lv in enumerate(tables.row_levels)
            if lv in (("m", "0", "#"), ("m", "+", "a"))]
    assert len(rows) == 2
    for order in (rows, rows[::-1]):
        pairs = np.array(order, dtype=np.int64)
        want = [sigmod.SubscriberSet()]
        _union_pairs(want, np.zeros(len(pairs), dtype=np.int64), pairs,
                     tables)
        (have,) = sigmod._union_rowsets(
            1, np.zeros(len(pairs), dtype=np.int64), pairs, tables,
            engine._state.fragments)
        assert have.subscriptions == want[0].subscriptions
        assert have.shared == want[0].shared


class _SickEvent:
    """Stands in for a CUDA event whose wait reports a kernel fault."""

    def synchronize(self):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")


@pytest.mark.parametrize("where", ["dispatch", "collect"])
def test_device_fault_at_fetch_raises_not_trie(monkeypatch, where):
    """A torch/CUDA RuntimeError while the results come back (the copy
    started at dispatch, or the wait at collect) surfaces as
    DeviceMatchError: the batch is not quietly served by the CPU trie."""
    _, port = twin([("c1", "a/+", {}), ("c2", "a/#", {})])
    engine = SigEngine(port, device="cpu", auto_refresh=False)
    before = (engine.matches, engine.fallbacks)
    if where == "dispatch":
        def sick(t, non_blocking=False):
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        monkeypatch.setattr(sigmod, "_to_host", sick)
        with pytest.raises(faults.DeviceMatchError):
            engine.subscribers_fixed_batch(["a/b"])
    else:
        ctx = engine.dispatch_fixed(["a/b"])
        ctx = ctx._replace(fetch=ctx.fetch._replace(event=_SickEvent()))
        with pytest.raises(faults.DeviceMatchError):
            engine.collect_fixed(["a/b"], ctx)
    assert (engine.matches, engine.fallbacks) == before


def test_host_runtime_error_in_dispatch_is_not_served_by_trie(monkeypatch):
    """Only a declined corpus is answered from the trie: any other
    RuntimeError raised while dispatching reaches the caller."""
    _, port = twin([("c1", "a/+", {}), ("c2", "a/#", {})])
    engine = SigEngine(port, device="cpu", auto_refresh=False)

    def broken(*_a, **_k):
        raise RuntimeError("host bug")
    monkeypatch.setattr(sigmod, "prepare_batch", broken)
    with pytest.raises(RuntimeError, match="host bug"):
        engine.subscribers_fixed_batch(["a/b"])
    assert engine.fallbacks == 0
