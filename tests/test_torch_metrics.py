"""The port's metrics (``maxmq_tpu_torch.metrics``: registry, Prometheus
exposition, the HTTP server and its routes, the tracer's and the
matcher-side registrations) against the JAX package's: the same
registrations and observations give the same text, byte for byte."""

import json
import random
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from maxmq_tpu import metrics as ref_metrics
from maxmq_tpu import trace as ref_trace
from maxmq_tpu_torch import metrics, trace
from maxmq_tpu_torch.matching.batcher import MicroBatcher
from maxmq_tpu_torch.matching.sig import SigEngine
from maxmq_tpu_torch.matching.supervisor import SupervisedMatcher
from maxmq_tpu_torch.matching.trie import TopicIndex
from maxmq_tpu_torch.protocol import Subscription

VALUES = [0, 1, -3, 2.5, 1e-7, 123456789012, 0.1 + 0.2, 7.0, -0.0, 1e21]


def registrations(mod, seed: int):
    """One registry of every metric kind, fed the same values."""
    rng = random.Random(seed)
    reg = mod.Registry()
    vals = {f"v{i}": rng.choice(VALUES) for i in range(6)}
    reg.gauge_func("maxmq_g", "a gauge", lambda: vals["v0"])
    reg.counter_func("maxmq_c_total", "a counter", lambda: vals["v1"])
    reg.counter_func("maxmq_c_total", "a counter", lambda: vals["v2"],
                     labels={"reason": 'say "hi"\\now\n'})
    reg.gauge_func("maxmq_broken", "raises at scrape",
                   lambda: 1 / 0)
    reg.multi_func("maxmq_multi", "counter", "a multi family",
                   lambda: [({"client": f"c{i}", "odd": "a\\b"}, v)
                            for i, v in enumerate(vals.values())])
    reg.multi_func("maxmq_multi_broken", "gauge", "raises", lambda: 1 / 0)
    h1, h2 = mod.Histogram(), mod.Histogram((0.5, 0.001, 2.0))
    for _ in range(200):
        h1.observe(rng.uniform(0, 3))
        h2.observe(rng.choice((0.0005, 1.0, 9.0, rng.uniform(0, 2))))
    reg.histogram_func("maxmq_h_seconds", "histograms",
                       lambda: [({"stage": "a"}, h1), ({}, h2)])
    reg.histogram_func("maxmq_h_broken", "raises", lambda: 1 / 0)
    return reg


@pytest.mark.parametrize("seed", range(4))
def test_exposition_text_equal(seed):
    got = registrations(metrics, seed).expose()
    want = registrations(ref_metrics, seed).expose()
    assert got == want
    assert '+Inf' in got and '\\"hi\\"' in got
    assert "\nmaxmq_broken " not in got


@pytest.mark.parametrize("v", VALUES + [1.5e300, 2 ** 53 + 1.0, 1 / 3])
def test_fmt_and_labels_equal(v):
    assert metrics._fmt(float(v)) == ref_metrics._fmt(float(v))
    labels = {"a": v, "b": 'x"y\\z\nw', "c": ""}
    assert metrics._lbl(labels) == ref_metrics._lbl(labels)


def fed_tracer(mod):
    clock = iter(range(1_000_000, 10_000_000_000, 1_700_000))
    tr = mod.PipelineTracer(sample_n=1, clock_ns=lambda: next(clock))
    for i in range(30):
        t = tr.sample(f"t/{i}", i % 3, "c")
        t.span("match_queue", t.start_ns, tr.clock())
        t.span("match_device", t.start_ns, tr.clock())
        tr.finish(t)
        tr.note_error("drain", f"r{i % 4}")
        tr.observe_journal(f"b{i % 3}", 0.001 * i)
        tr.attach_remote({"i": t.id, "n": "n2", "h": 1 + i % 2,
                          "e2e_us": 40 * i})
    return tr


def test_trace_registrations_equal():
    """``_register_trace_metrics`` reads only ``.tracer``."""
    got, want = metrics.Registry(), ref_metrics.Registry()
    metrics._register_trace_metrics(
        got, SimpleNamespace(tracer=fed_tracer(trace)))
    ref_metrics._register_trace_metrics(
        want, SimpleNamespace(tracer=fed_tracer(ref_trace)))
    assert got.expose() == want.expose()
    assert "maxmq_broker_publish_stage_seconds_count{stage=\"match_queue\"} 30" \
        in got.expose()
    for mod in (metrics, ref_metrics):
        reg = mod.Registry()
        mod._register_trace_metrics(reg, SimpleNamespace(tracer=None))
        assert reg.expose() == "\n"


class FakeMatcher:
    """The counters the matcher-side registrations read, as the port's
    supervisor and service client carry them."""

    def __init__(self, seed: int, by_reason: bool) -> None:
        rng = random.Random(seed)
        n = lambda: rng.randint(0, 10 ** 6)      # noqa: E731
        if by_reason:
            self.fallbacks_by_reason = {"overflow": n(), "error": n(),
                                        "deadline": n()}
        else:
            self.fallbacks = n()
        self.reconnects, self.reconnect_attempts, self.errors = n(), n(), n()
        self.breaker_state = rng.randint(0, 2)
        self.breaker_trips, self.breaker_recoveries = n(), n()
        self.degraded_seconds = rng.uniform(0, 100)
        self.refresh_failures = n()
        self.worker_restarts = n()
        self.kernel_plan = {"groups16": n(), "n_words16": n(),
                            "groups32": n(), "n_words32": n(),
                            "chunk16": n()}


def matcher_registrations(mod, matcher) -> str:
    reg = mod.Registry()
    mod._register_fallback_metrics(reg, matcher)
    mod._register_transport_metrics(reg, matcher)
    mod._register_breaker_metrics(reg, matcher)
    mod.register_pool_metrics(reg, matcher)
    mod._register_kernel_width_metrics(reg, matcher)
    return reg.expose()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("by_reason", [True, False])
def test_matcher_registrations_equal(seed, by_reason):
    m = FakeMatcher(seed, by_reason)
    text = matcher_registrations(metrics, m)
    assert text == matcher_registrations(ref_metrics, m)
    assert f"maxmq_matcher_breaker_trips_total {m.breaker_trips}\n" in text
    bare = SimpleNamespace(breaker_state=0, breaker_trips=0,
                           breaker_recoveries=0, degraded_seconds=0.0,
                           refresh_failures=0, fallbacks=0,
                           worker_restarts=0, kernel_plan=None)
    assert matcher_registrations(metrics, bare) == \
        matcher_registrations(ref_metrics, bare)


def scrape_counters(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
    return out


async def test_registrations_over_the_ports_supervised_matcher():
    """The registrations over the port's real SupervisedMatcher(
    MicroBatcher(SigEngine)): every counter in the text equals the
    object's attribute after traffic."""
    idx = TopicIndex()
    for i in range(40):
        idx.subscribe(f"c{i}", Subscription(filter=f"a/{i % 7}/#"))
    engine = SigEngine(idx, device="cpu")
    engine.route_small = False
    batcher = MicroBatcher(engine, cpu_bypass=False)
    sup = SupervisedMatcher(batcher, index=idx)
    try:
        for i in range(50):
            await sup.subscribers_async(f"a/{i % 9}/x")
    finally:
        await batcher.close()
    reg = metrics.Registry()
    metrics._register_fallback_metrics(reg, sup)
    metrics._register_transport_metrics(reg, sup)
    metrics._register_breaker_metrics(reg, sup)
    metrics._register_kernel_width_metrics(reg, engine)
    got = scrape_counters(reg.expose())
    for reason, n in sup.fallbacks_by_reason.items():
        assert got[f'maxmq_matcher_fallbacks_total{{reason="{reason}"}}'] \
            == n
    assert got["maxmq_matcher_batch_errors_total"] == batcher.errors
    assert got["maxmq_matcher_breaker_trips_total"] == sup.breaker_trips
    assert got["maxmq_matcher_breaker_state"] == sup.breaker_state
    assert got['maxmq_matcher_kernel_words{width="32"}'] == \
        engine.kernel_plan["n_words32"]


def get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, None, b""


def serve(mod, trace_mod, profiling: bool):
    reg = registrations(mod, 1)
    tracer = fed_tracer(trace_mod)
    mod._register_trace_metrics(reg, SimpleNamespace(tracer=tracer))
    srv = mod.MetricsServer("127.0.0.1:0", reg, profiling=profiling,
                            tracer=tracer,
                            cluster_metrics=lambda: "maxmq_x 1\n")
    srv.start()
    return srv


@pytest.mark.parametrize("profiling", [True, False])
def test_metrics_server_routes_over_http(profiling):
    """The port's and the JAX package's servers, each on an ephemeral
    port, answer every route with the same status, type and (for the
    deterministic routes) the same body."""
    servers = [serve(metrics, trace, profiling),
               serve(ref_metrics, ref_trace, profiling)]
    try:
        ports = [s.bound_port for s in servers]
        assert all(p > 0 for p in ports) and ports[0] != ports[1]
        for path in ("/metrics", "/metrics?x=1", "/traces",
                     "/traces/chrome", "/cluster/metrics", "/nope"):
            got, want = (get(p, path) for p in ports)
            assert got == want, path
        status, ctype, body = get(ports[0], "/metrics")
        assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
        assert body.decode() == servers[0].registry.expose()
        chrome = json.loads(get(ports[0], "/traces/chrome")[2])
        assert chrome["traceEvents"]
        for path in ("/debug/pprof", "/debug/pprof/threads",
                     "/debug/pprof/heap", "/debug/pprof/profile?seconds=0.05",
                     "/debug/pprof/other"):
            got, want = (get(p, path) for p in ports)
            assert got[:2] == want[:2], path
            assert (got[0] == 200) == profiling
        if profiling:
            assert b"Thread " in get(ports[0], "/debug/pprof/threads")[2]
            assert b"samples over" in \
                get(ports[0], "/debug/pprof/profile?seconds=0.05")[2]
    finally:
        for s in servers:
            s.stop()
    with pytest.raises(ValueError):
        metrics.MetricsServer("nohostport", metrics.Registry())


def test_metrics_server_logs_like_the_reference():
    import io

    from maxmq_tpu.utils.logger import Logger as RefLogger
    from maxmq_tpu_torch.utils.logger import Logger

    lines = []
    for mod, logger_cls in ((metrics, Logger), (ref_metrics, RefLogger)):
        out = io.StringIO()
        srv = mod.MetricsServer("127.0.0.1:0", mod.Registry(),
                                logger=logger_cls(out=out, fmt="json"))
        srv.start()
        srv.stop()
        srv.stop()
        lines.append([json.loads(x)["message"]
                      for x in out.getvalue().splitlines()])
    assert lines[0] == lines[1] == ["metrics server started",
                                    "metrics server stopped",
                                    "metrics server stopped"]
