"""The port's publish tracer (``maxmq_tpu_torch.trace``, ADR 015/017)
against the JAX package's under one scripted clock: the same calls give
the same reports, histogram buckets, Chrome export and $SYS entries; the
port's matcher stack carries the tracer's dispatch/done marks through the
supervisor."""

import asyncio
import json
import random

import pytest

from maxmq_tpu import faults as ref_faults
from maxmq_tpu import trace as ref_trace
from maxmq_tpu_torch import faults, trace
from maxmq_tpu_torch.matching.batcher import MicroBatcher
from maxmq_tpu_torch.matching.sig import SigEngine
from maxmq_tpu_torch.matching.supervisor import SupervisedMatcher
from maxmq_tpu_torch.matching.trie import TopicIndex
from maxmq_tpu_torch.protocol import Subscription

import chip_smoke


class Clock:
    def __init__(self, start=1_000_000_000):
        self.now = start

    def __call__(self):
        return self.now

    def tick(self, ns):
        self.now += ns
        return self.now


def drive(mod, seed: int, sample_n: int, slow_ms: float, ring: int):
    """One scripted life of a tracer: sampled publishes with every stage,
    drains, errors, journal buckets, adopted traces, remote reports that
    land before and after their trace's finish, and orphans."""
    rng = random.Random(seed)
    clock = Clock()
    tr = mod.PipelineTracer(sample_n=sample_n, slow_ms=slow_ms, ring=ring,
                            clock_ns=clock)
    tr.node_id = "n1"
    finished = []
    for i in range(60):
        t = tr.sample(f"t/{i % 7}", i % 3, f"c{i % 5}")
        clock.tick(rng.randint(1_000, 90_000))
        if t is None:
            continue
        t0 = clock.now
        for stage in ("decode", "admission", "match_queue", "match_device",
                      "pipeline_wait", "filter", "fanout", "bridge",
                      "barrier", "ack"):
            if rng.random() < 0.8:
                t1 = clock.tick(rng.randint(500, 4_000_000))
                t.span(stage, t0, t1)
                t0 = t1
        if rng.random() < 0.2:
            t.degraded = "open"
        if rng.random() < 0.3:          # report that beats the finish
            tr.attach_remote({"i": t.id, "n": "n2", "h": 2,
                              "e2e_us": rng.randint(10, 9_000),
                              "spans": [("bridge_in", 5, 40)],
                              "deg": "", "k": "pub"})
        tr.finish(t, clock.tick(rng.randint(1_000, 50_000)))
        tr.finish(t)                    # idempotent
        finished.append(t)
        for c in range(rng.randint(0, 10)):
            a = clock.tick(1_000)
            tr.drain_span(t, f"sub{c}", a, clock.tick(rng.randint(0, 900_000)))
        if rng.random() < 0.3:
            tr.note_error(rng.choice(("drain", "fanout", "bridge")),
                          rng.choice(("queue_full", "budget", "")),
                          rng.randint(1, 3))
        tr.observe_journal(f"bucket{rng.randint(0, 20)}",
                           rng.uniform(0, 0.02))
        tr.observe("journal_commit", rng.uniform(0, 0.02))
    for t in finished[-4:]:             # reports after the finish
        tr.attach_remote({"i": t.id, "n": "n3", "h": 1, "e2e_us": 1234,
                          "spans": [("bridge_in", 1, 2), ("fanout", 3, 4)],
                          "deg": "closed"})
        tr.attach_remote({"i": t.id, "n": "n3", "h": 1, "e2e_us": 1})
    tr.attach_remote({"i": 10_000, "n": "n4", "h": 3, "e2e_us": 7,
                      "k": "sess_ship"})
    for k in range(3):
        a = tr.adopt("n9", 500 + k, f"a/{k}", 1, 2, clock.tick(10))
        a.span("bridge_in", clock.now, clock.tick(30_000))
        seen = []
        tr.on_adopted_finish = lambda trace_, entry, seen=seen: \
            seen.append((trace_.id, entry["id"]))
        tr.finish(a, clock.tick(5_000))
        assert seen == [(500 + k, 500 + k)]
    return tr


CASES = [(1, 1, 0.0, 64), (2, 3, 0.0, 8), (3, 1, 2.0, 16), (4, 2, 0.5, 4)]


@pytest.mark.parametrize("seed,sample_n,slow_ms,ring", CASES)
def test_tracer_reports_equal_under_one_clock(seed, sample_n, slow_ms, ring):
    got = drive(trace, seed, sample_n, slow_ms, ring)
    want = drive(ref_trace, seed, sample_n, slow_ms, ring)
    assert got.report() == want.report()
    assert json.dumps(got.chrome_events()) == \
        json.dumps(want.chrome_events())
    assert got.sys_entries() == want.sys_entries()
    assert got.cross_quantiles() == want.cross_quantiles()
    assert sorted(got.stage_error_items()) == \
        sorted(want.stage_error_items())
    for attr in ("sampled", "allocations", "slow_captured", "adopted",
                 "adopted_open", "remote_attached", "remote_orphans",
                 "ring_depth"):
        assert getattr(got, attr) == getattr(want, attr), attr
    hists = [(got.stage_hist, want.stage_hist),
             (got.e2e_hist, want.e2e_hist),
             (got.cross_hist, want.cross_hist),
             (got.journal_hist, want.journal_hist)]
    for g, w in hists:
        assert sorted(g) == sorted(w)
        for k in g:
            assert (g[k].buckets, g[k].counts, g[k].count) == \
                (w[k].buckets, w[k].counts, w[k].count)
            assert g[k].sum == pytest.approx(w[k].sum, rel=0, abs=0)
    # past the cap, attribution lumps into one more family, "other"
    assert len(got.journal_hist) <= trace.MAX_JOURNAL_BUCKETS + 1
    assert got.report()["entries"]


def test_stage_model_and_caps_equal():
    assert trace.STAGES == ref_trace.STAGES
    assert trace.CRITICAL_STAGES == ref_trace.CRITICAL_STAGES
    for cap in ("MAX_DRAIN_SPANS", "SLOWEST_KEEP", "MAX_REMOTE_REPORTS",
                "MAX_JOURNAL_BUCKETS"):
        assert getattr(trace, cap) == getattr(ref_trace, cap)


def test_zero_allocations_when_off():
    """sample_n == 0: every site is a branch and nothing is allocated."""
    for mod in (trace, ref_trace):
        tr = mod.PipelineTracer(sample_n=0)
        for i in range(1000):
            assert tr.sample(f"t/{i}", 0, "c") is None
        assert tr.allocations == 0 and tr.sampled == 0
        assert tr.report()["entries"] == []


@pytest.mark.parametrize("buckets", [None, (0.001, 0.01, 0.1),
                                     (5.0, 0.5, 0.05, 0.0005)])
def test_histogram_buckets_and_quantiles_equal(buckets):
    from maxmq_tpu import metrics as ref_metrics
    from maxmq_tpu_torch import metrics

    rng = random.Random(11)
    g, w = metrics.Histogram(buckets), ref_metrics.Histogram(buckets)
    assert g.buckets == w.buckets
    for _ in range(500):
        v = rng.choice((rng.uniform(0, 0.02), rng.uniform(0, 20), 0.001,
                        0.0))
        g.observe(v)
        w.observe(v)
    assert (g.counts, g.sum, g.count) == (w.counts, w.sum, w.count)
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert g.quantile(q) == w.quantile(q)
    assert metrics.Histogram().quantile(0.5) == 0.0


def test_registry_clock_drives_spans():
    """With no clock of its own the tracer reads the port's fault
    registry clock, so a test scripts every span through it."""
    clock = Clock(5_000)
    faults.REGISTRY.clock_ns = clock
    ref_faults.REGISTRY.clock_ns = clock
    try:
        reports = []
        for mod in (trace, ref_trace):
            clock.now = 5_000
            tr = mod.PipelineTracer(sample_n=1)
            t = tr.sample("a/b", 1, "c1")
            assert t.start_ns == 5_000
            t.span("match_queue", clock.now, clock.tick(2_000_000))
            t.span("match_device", clock.now, clock.tick(3_000_000))
            clock.tick(1_000_000)
            tr.finish(t)
            reports.append(tr.report())
        assert reports[0] == reports[1]
        assert reports[0]["entries"][0]["e2e_ms"] == 6.0
    finally:
        faults.REGISTRY.reset_clock()
        ref_faults.REGISTRY.reset_clock()


def _index(n=300):
    rng = random.Random(5)
    idx = TopicIndex()
    for i in range(n):
        levels = [rng.choice("abcd") for _ in range(rng.randint(1, 4))]
        if rng.random() < 0.3:
            levels[rng.randrange(len(levels))] = "+"
        idx.subscribe(f"c{i}", Subscription(filter="/".join(levels)))
    return idx


async def test_matcher_marks_split_queue_and_device():
    """A tracer on the port's batcher stamps every sampled future with
    dispatch/done marks; the supervisor forwards them; the spans the
    broker would build (``chip_smoke.trace_match_spans``, a copy of the
    JAX package's server.py:1281-1301) tile enqueue to settle."""
    idx = _index()
    engine = SigEngine(idx, device="cpu")
    engine.route_small = False
    batcher = MicroBatcher(engine, cpu_bypass=False, window_us=200,
                           max_batch=32, pipeline_depth=3)
    sup = SupervisedMatcher(batcher, index=idx, deadline_ms=5_000.0)
    tracer = trace.PipelineTracer(sample_n=1, ring=256)
    batcher.tracer = tracer
    assert sup.tracer is tracer
    topics = ["/".join(random.Random(i).choice("abcd")
                       for _ in range(3)) for i in range(100)]
    try:
        pending = []
        for i, t in enumerate(topics):
            tr = tracer.sample(t, 0, f"p{i}")
            tr.t_match = tracer.clock()
            pending.append((sup.enqueue(t), tr))
        for fut, tr in pending:
            await fut
            chip_smoke.trace_match_spans(tracer, sup, tr, fut)
            tracer.finish(tr)
    finally:
        await batcher.close()
    stages = tracer.stage_quantiles()
    assert stages["match_queue"]["count"] == len(topics)
    assert stages["match_device"]["count"] == len(topics)
    for fut, tr in pending:
        assert 0 < fut._t_dispatch <= fut._t_done
        spans = {s: (t0, d) for s, t0, d in tr.spans}
        assert spans["match_queue"][0] == tr.t_match
        assert spans["match_device"][0] == fut._t_dispatch
        assert not tr.degraded


async def test_no_marks_with_sampling_off():
    idx = _index(50)
    engine = SigEngine(idx, device="cpu")
    engine.route_small = False
    batcher = MicroBatcher(engine, cpu_bypass=False)
    tracer = trace.PipelineTracer(sample_n=0)
    batcher.tracer = tracer
    try:
        futs = [batcher.enqueue(f"a/{c}") for c in "abcd"]
        await asyncio.gather(*futs)
    finally:
        await batcher.close()
    assert all(not getattr(f, "_t_dispatch", 0) for f in futs)
    assert tracer.allocations == 0


SMOKE_SIZES = {"subs": {"mixed_100k": 1_500},
               "service_warm": 32,
               "pipeline": {"burst": 64,
                            "supervisor": {"deadline_ms": 5_000.0}},
               "content": {"shapes": ((64, 256), (300, 64)), "reps": 2},
               "tracing": {"bursts": 3, "service_topics": 150}}


def test_chip_smoke_phase_13_rehearses_on_cpu():
    """chip_smoke.py's phase 13 at a small size on the CPU: the content
    evaluator's checks, the traced and untraced pipeline runs, the scrape
    of /metrics and /traces/chrome over HTTP against the objects, and the
    service's socket/service split."""
    smoke = chip_smoke.Smoke("cpu", sizes=SMOKE_SIZES)
    content = smoke.content_evaluator()
    for rec in content["shapes"]:
        assert rec["torch"]["mismatches"] == rec["numpy"]["mismatches"] == 0
        assert rec["torch"]["device_fallbacks"] == 0
        assert rec["torch"]["result_device"] == "cpu"
    out = asyncio.run(smoke.matcher_tracing())
    n = 3 * 64
    assert [r["sampled"] for r in out["traced"]] == [n, n]
    assert [r["allocations"] for r in out["untraced"]] == [0, 0]
    for r in out["traced"]:
        assert r["stage_quantiles"]["match_device"]["count"] == n
    assert out["scrape"]["checked"] > 10 and out["scrape"]["chrome_events"]
    for mode, svc in out["service"].items():
        assert svc["topics"] == 150 and svc["mismatches"] == 0
        assert 0 < svc["service_share"] < 1
    assert out["service"]["device"]["bypassed"] == 0
