"""Metrics HTTP server with Prometheus text exposition + profiling endpoints.

Parity surface: internal/metrics/server.go in the reference — an HTTP server
exposing Prometheus ``/metrics`` (server.go:49-50) and, when profiling is
enabled, live ``/debug/pprof/*`` endpoints (51-58), with graceful shutdown
(111-124). The reference leans on client_golang; here the exposition format
(text format 0.0.4) is emitted directly from a tiny function-backed registry —
the same shape as prometheus ``GaugeFunc``/``CounterFunc``, which is all the
reference uses (internal/mqtt/metrics.go:31-88).

Profiling endpoints are the Python equivalents of net/http/pprof:
``/debug/pprof/threads`` (all-thread stack dump), ``/debug/pprof/profile``
(cProfile for ?seconds=N, pstats text), ``/debug/pprof/heap`` (tracemalloc
snapshot when tracing is active).

Copy of the JAX package's ``metrics.py``: the registry, the exposition,
the HTTP server with its debug routes, the tracer's registrations (which
read only an object's ``.tracer``) and the matcher-side registrations
(the supervisor's fallbacks and breaker, the service client's
transport, the pool, the signature engine's kernel widths).
``register_broker_metrics`` and the registrations that read a broker, a
cluster manager or storage come with the broker engine.
"""

from __future__ import annotations

import bisect
import http.server
import threading
from typing import Callable

from .utils.logger import Logger


class Histogram:
    """Fixed-bucket latency histogram (ADR 015): ``observe`` is a
    bisect over a small tuple plus three int/float adds — cheap enough
    for the publish hot path, and tear-free to the scrape thread under
    the GIL (the SysInfo contract). Buckets are upper bounds in
    ascending order; values past the last bound land in the implicit
    ``+Inf`` overflow slot. Exposed by the Registry as the Prometheus
    ``_bucket``/``_sum``/``_count`` triplet (cumulative counts)."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets=None) -> None:
        b = tuple(sorted(float(x) for x in
                         (buckets or DEFAULT_LATENCY_BUCKETS)))
        if not b:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = b
        self.counts = [0] * (len(b) + 1)   # per-bucket, last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Estimated q-quantile by linear interpolation inside the
        owning bucket (the standard histogram_quantile estimate); the
        overflow bucket clamps to the last finite bound."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        acc = 0
        lo = 0.0
        for bound, n in zip(self.buckets, self.counts):
            if n and acc + n >= target:
                return lo + (bound - lo) * ((target - acc) / n)
            acc += n
            lo = bound
        return self.buckets[-1]


# 100us .. 10s: wide enough that both an in-process trie match (~20us
# rides the first bucket) and a wedged fsync (seconds) land on the
# resolved part of the curve
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0)


class Metric:
    """A function-backed metric: value is read at scrape time. With
    ``multi`` the fn returns an iterable of (labels_dict, value) pairs —
    one metric family whose series set is computed per scrape (used for
    the cardinality-bounded per-client overload offenders, ADR 012).
    Kind ``histogram`` is always multi-style: the fn returns
    (labels_dict, Histogram) pairs (ADR 015)."""

    __slots__ = ("name", "kind", "help", "fn", "labels", "multi")

    def __init__(self, name: str, kind: str, help_: str,
                 fn: Callable[[], float],
                 labels: dict[str, str] | None = None,
                 multi: bool = False) -> None:
        assert kind in ("counter", "gauge", "histogram")
        self.name = name
        self.kind = kind
        self.help = help_
        self.fn = fn
        self.labels = labels or {}
        self.multi = multi


class Registry:
    """Scrape-time metric registry emitting Prometheus text format 0.0.4."""

    def __init__(self) -> None:
        self._metrics: list[Metric] = []
        self._lock = threading.Lock()

    def gauge_func(self, name: str, help_: str, fn: Callable[[], float],
                   labels: dict[str, str] | None = None) -> None:
        with self._lock:
            self._metrics.append(Metric(name, "gauge", help_, fn, labels))

    def counter_func(self, name: str, help_: str, fn: Callable[[], float],
                     labels: dict[str, str] | None = None) -> None:
        with self._lock:
            self._metrics.append(Metric(name, "counter", help_, fn, labels))

    def multi_func(self, name: str, kind: str, help_: str, fn) -> None:
        """A family whose series are computed at scrape time: ``fn``
        returns an iterable of (labels_dict, value). The fn owns the
        cardinality bound (callers document it)."""
        with self._lock:
            self._metrics.append(Metric(name, kind, help_, fn, multi=True))

    def histogram_func(self, name: str, help_: str, fn) -> None:
        """A histogram family (ADR 015): ``fn`` returns an iterable of
        (labels_dict, Histogram); each pair becomes one
        ``_bucket``/``_sum``/``_count`` series set per scrape."""
        with self._lock:
            self._metrics.append(
                Metric(name, "histogram", help_, fn, multi=True))

    def expose(self) -> str:
        with self._lock:
            metrics = list(self._metrics)
        out: list[str] = []
        seen_header: set[str] = set()
        for m in metrics:
            if m.name not in seen_header:
                out.append(f"# HELP {m.name} {m.help}")
                out.append(f"# TYPE {m.name} {m.kind}")
                seen_header.add(m.name)
            if m.kind == "histogram":
                try:
                    series = list(m.fn())
                except Exception:
                    continue
                for labels, hist in series:
                    _expose_histogram(out, m.name, labels, hist)
                continue
            if m.multi:
                try:
                    series = list(m.fn())
                except Exception:
                    continue
                for labels, value in series:
                    out.append(f"{m.name}{{{_lbl(labels)}}} "
                               f"{_fmt(float(value))}")
                continue
            try:
                value = float(m.fn())
            except Exception:
                continue
            if m.labels:
                out.append(f"{m.name}{{{_lbl(m.labels)}}} {_fmt(value)}")
            else:
                out.append(f"{m.name} {_fmt(value)}")
        return "\n".join(out) + "\n"


def _fmt(v: float) -> str:
    return str(int(v)) if v == int(v) else repr(v)


def _expose_histogram(out: list[str], name: str, labels: dict,
                      hist: Histogram) -> None:
    """One series set of the Prometheus histogram triplet: cumulative
    ``_bucket{le=}`` counts ending at ``+Inf`` (== ``_count``), then
    ``_sum`` and ``_count``. A snapshot of counts is taken first so a
    concurrent observe() cannot make the cumulative run non-monotonic
    mid-scrape."""
    counts = list(hist.counts)
    total = sum(counts)
    lbl = dict(labels)
    acc = 0
    for bound, n in zip(hist.buckets, counts):
        acc += n
        lbl["le"] = _fmt(bound)
        out.append(f"{name}_bucket{{{_lbl(lbl)}}} {acc}")
    lbl["le"] = "+Inf"
    out.append(f"{name}_bucket{{{_lbl(lbl)}}} {total}")
    tail = f"{{{_lbl(labels)}}}" if labels else ""
    out.append(f"{name}_sum{tail} {_fmt(hist.sum)}")
    out.append(f"{name}_count{tail} {total}")


def _lbl(labels: dict) -> str:
    """Render a label set with Prometheus text-format escaping: label
    values here include CLIENT-CHOSEN ids (the per-client offender
    family), and one embedded quote/backslash/newline must corrupt one
    label value, not the whole exposition page."""
    def esc(v) -> str:
        return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))
    return ",".join(f'{k}="{esc(v)}"' for k, v in labels.items())


def _dump_threads() -> str:
    import sys
    import threading as _threading
    import traceback
    names = {t.ident: t.name for t in _threading.enumerate()}
    out: list[str] = []
    for ident, frame in sys._current_frames().items():
        out.append(f"Thread {names.get(ident, '?')} (id={ident}):")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


def _heap_snapshot() -> str:
    import tracemalloc
    if not tracemalloc.is_tracing():
        return ("tracemalloc not tracing; start the broker with "
                "MAXMQ_PROFILE=1 or call tracemalloc.start()\n")
    snap = tracemalloc.take_snapshot()
    lines = [str(s) for s in snap.statistics("lineno")[:64]]
    return "\n".join(lines) + "\n"


def _cpu_profile(seconds: float, interval: float = 0.005) -> str:
    """Statistical all-thread CPU profile: sample every thread's stack for
    ``seconds`` and report frame hit counts. (cProfile only instruments the
    calling thread, which here would just be this handler sleeping — a
    sampler is the faithful whole-process equivalent of pprof's profile.)"""
    import sys
    import time
    own = {__import__("threading").get_ident()}
    counts: dict[tuple[str, int, str], int] = {}
    samples = 0
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        for ident, top in sys._current_frames().items():
            if ident in own:
                continue
            frame = top
            while frame is not None:
                key = (frame.f_code.co_filename, frame.f_lineno,
                       frame.f_code.co_name)
                counts[key] = counts.get(key, 0) + 1
                frame = frame.f_back
        samples += 1
        time.sleep(interval)
    out = [f"# {samples} samples over {seconds:.1f}s, "
           f"{interval * 1000:.1f}ms interval", "# hits  location"]
    for (fname, lineno, func), n in sorted(counts.items(),
                                           key=lambda kv: -kv[1])[:128]:
        out.append(f"{n:7d}  {func} ({fname}:{lineno})")
    return "\n".join(out) + "\n"


def _route_get(handler, registry, tracer, path: str, profiling: bool,
               target: str, cluster_metrics=None):
    """Resolve one metrics-server GET target to (body, content-type),
    or None for a 404 — the endpoint table for MetricsServer.Handler."""
    import json
    if target == path:
        return (registry.expose().encode(),
                "text/plain; version=0.0.4; charset=utf-8")
    if tracer is not None and target == "/traces":
        return json.dumps(tracer.report()).encode(), "application/json"
    if tracer is not None and target == "/traces/chrome":
        return (json.dumps(tracer.chrome_events()).encode(),
                "application/json")
    if cluster_metrics is not None and target == "/cluster/metrics":
        # ADR 017: the federated view — every live peer's snapshot
        # counters with node= labels, served from ANY node
        return (cluster_metrics().encode(),
                "text/plain; version=0.0.4; charset=utf-8")
    if profiling and target.startswith("/debug/pprof"):
        return handler._pprof(target)
    return None


class MetricsServer:
    """Threaded HTTP server for /metrics, optional /debug/pprof/*, and
    (when a tracer is attached, ADR 015) the flight-recorder endpoints
    ``/traces`` (JSON) and ``/traces/chrome`` (Chrome trace_event)."""

    def __init__(self, address: str, registry: Registry,
                 path: str = "/metrics", profiling: bool = False,
                 logger: Logger | None = None, tracer=None,
                 cluster_metrics=None) -> None:
        if not address or ":" not in address:
            raise ValueError(f"invalid metrics address {address!r}")
        host, _, port_s = address.rpartition(":")
        self.host = host or "0.0.0.0"
        self.port = int(port_s)
        self.registry = registry
        self.path = path
        self.profiling = profiling
        self.logger = logger
        self.tracer = tracer
        # zero-arg callable -> Prometheus text (ADR 017: the cluster
        # telemetry plane's aggregated /cluster/metrics page)
        self.cluster_metrics = cluster_metrics
        self._httpd: http.server.ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def bound_port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self.port

    def start(self) -> None:
        registry, path, profiling = self.registry, self.path, self.profiling
        tracer = self.tracer
        cluster_metrics = self.cluster_metrics

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                target = self.path.split("?", 1)[0]
                hit = _route_get(self, registry, tracer, path, profiling,
                                 target, cluster_metrics)
                if hit is None:
                    self.send_error(404)
                    return
                body, ctype = hit
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _pprof(self, target: str) -> tuple[bytes, str]:
                if target.endswith("/threads") or target.rstrip("/").endswith("pprof"):
                    return _dump_threads().encode(), "text/plain"
                if target.endswith("/heap"):
                    return _heap_snapshot().encode(), "text/plain"
                if target.endswith("/profile"):
                    from urllib.parse import parse_qs, urlparse
                    q = parse_qs(urlparse(self.path).query)
                    seconds = float(q.get("seconds", ["1"])[0])
                    return _cpu_profile(min(seconds, 30.0)).encode(), "text/plain"
                return b"unknown pprof endpoint\n", "text/plain"

            def log_message(self, fmt: str, *args) -> None:
                pass  # quiet; scrape logging is noise

        self._httpd = http.server.ThreadingHTTPServer(
            (self.host, self.port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http",
            daemon=True)
        self._thread.start()
        if self.logger:
            self.logger.info("metrics server started",
                             address=f"{self.host}:{self.bound_port}")

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self.logger:
            self.logger.info("metrics server stopped")


# stage-error label cardinality bound: stages are a fixed set and
# reasons a small enum, but the exposition page stays bounded even if a
# future call site invents reasons dynamically
STAGE_ERROR_SERIES = 32


def _register_trace_metrics(registry: Registry, broker) -> None:
    """ADR-015 pipeline-tracer observability: per-stage latency
    histograms, per-QoS end-to-end histograms, the per-stage error
    counter that puts fan-out/write-path drops next to their latency,
    and the flight-recorder health gauges. Histogram families expose
    every pipeline stage even before the first observation, so a
    dashboard can template on the label set from boot."""
    tracer = getattr(broker, "tracer", None)
    if tracer is None:
        return
    registry.histogram_func(
        "maxmq_broker_publish_stage_seconds",
        "Per-stage latency of sampled publishes (ADR 015 span model; "
        "see docs/observability.md for the stage glossary)",
        lambda: [({"stage": s}, h)
                 for s, h in sorted(tracer.stage_hist.items())])
    registry.histogram_func(
        "maxmq_broker_publish_e2e_seconds",
        "End-to-end latency of sampled publishes (decode to terminal "
        "stage) by inbound QoS",
        lambda: [({"qos": str(q)}, h)
                 for q, h in sorted(tracer.e2e_hist.items())])
    registry.multi_func(
        "maxmq_broker_stage_errors_total", "counter",
        "Errors/drops attributed to a pipeline stage (write-path drops "
        "land under stage=drain with their drops_by_reason reason); "
        "cardinality bounded to STAGE_ERROR_SERIES series",
        lambda: [({"stage": s, "reason": r}, n) for (s, r), n in
                 sorted(tracer.stage_error_items())
                 [:STAGE_ERROR_SERIES]])
    registry.histogram_func(
        "maxmq_storage_journal_commit_seconds",
        "Group-commit duration attributed to each storage bucket the "
        "batch touched (ADR 017; a commit covering N buckets observes "
        "once per bucket, bounded to trace.MAX_JOURNAL_BUCKETS "
        "families)",
        lambda: [({"bucket": b}, h) for b, h in tracer.journal_items()])
    registry.histogram_func(
        "maxmq_cluster_publish_e2e_seconds",
        "Origin-measured cross-node end-to-end latency of sampled "
        "publishes by forwarding hop count (ADR 017; fed by returned "
        "span reports)",
        lambda: [({"hops": str(h)}, hist) for h, hist in
                 sorted(tracer.cross_hist.items())])
    registry.counter_func(
        "maxmq_broker_trace_adopted_total",
        "Remote-origin traces adopted on this node (ADR 017)",
        lambda: tracer.adopted)
    registry.counter_func(
        "maxmq_broker_trace_remote_attached_total",
        "Returned cross-node span reports attached to local entries",
        lambda: tracer.remote_attached)
    registry.counter_func(
        "maxmq_broker_trace_remote_orphans_total",
        "Returned span reports whose trace had left the recorder",
        lambda: tracer.remote_orphans)
    registry.counter_func(
        "maxmq_broker_trace_sampled_total",
        "Publishes sampled into the pipeline tracer",
        lambda: tracer.sampled)
    registry.counter_func(
        "maxmq_broker_trace_slow_total",
        "Sampled publishes whose end-to-end latency exceeded "
        "trace_slow_ms", lambda: tracer.slow_captured)
    registry.gauge_func(
        "maxmq_broker_trace_ring_depth",
        "Flight-recorder entries currently held",
        lambda: tracer.ring_depth)
    registry.gauge_func(
        "maxmq_broker_trace_sample_n",
        "Publish sampling stride (0 = tracing off)",
        lambda: tracer.sample_n)


def _register_fallback_metrics(registry: Registry, matcher) -> None:
    if hasattr(matcher, "fallbacks_by_reason"):
        # ADR 011: the pre-supervisor single counter is split by reason
        # (docs/migration.md); the unlabelled total is the sum over it
        for reason in ("overflow", "error", "deadline", "breaker_open"):
            registry.counter_func(
                "maxmq_matcher_fallbacks_total",
                "Topic matches degraded to the CPU trie, by reason",
                lambda r=reason: matcher.fallbacks_by_reason.get(r, 0),
                labels={"reason": reason})
    else:
        registry.counter_func(
            "maxmq_matcher_fallbacks_total",
            "Topic matches that overflowed to the CPU trie fallback",
            lambda: matcher.fallbacks)


def _register_transport_metrics(registry: Registry, matcher) -> None:
    if hasattr(matcher, "reconnects"):
        registry.counter_func(
            "maxmq_matcher_service_reconnects_total",
            "Matcher-service transport reconnects",
            lambda: matcher.reconnects)
    if hasattr(matcher, "reconnect_attempts"):
        registry.counter_func(
            "maxmq_matcher_service_reconnect_attempts_total",
            "Matcher-service reconnect attempts (incl. failed ones "
            "retried under the capped exponential backoff)",
            lambda: matcher.reconnect_attempts)
    if hasattr(matcher, "errors"):
        registry.counter_func(
            "maxmq_matcher_batch_errors_total",
            "Micro-batches whose engine call raised (each degraded "
            "upstream per ADR 011)",
            lambda: matcher.errors)


def _register_breaker_metrics(registry: Registry, matcher) -> None:
    """ADR-011 degradation-ladder observability: breaker state and the
    time/recovery counters that make degraded-mode tails explainable."""
    registry.gauge_func(
        "maxmq_matcher_breaker_state",
        "Matcher circuit breaker state (0=closed, 1=open, 2=half-open)",
        lambda: matcher.breaker_state)
    registry.counter_func(
        "maxmq_matcher_breaker_trips_total",
        "Times the matcher breaker opened (device path -> trie-only)",
        lambda: matcher.breaker_trips)
    registry.counter_func(
        "maxmq_matcher_breaker_recoveries_total",
        "Times a half-open reprobe restored the device path",
        lambda: matcher.breaker_recoveries)
    registry.counter_func(
        "maxmq_matcher_degraded_seconds_total",
        "Cumulative wall time with the breaker not closed",
        lambda: matcher.degraded_seconds)
    registry.counter_func(
        "maxmq_matcher_refresh_failures_total",
        "Table recompiles that failed (last-good tables kept serving)",
        lambda: matcher.refresh_failures)


def register_pool_metrics(registry: Registry, stats) -> None:
    """The pool parent's supervision counters (broker/workers.py's
    PoolStats) — served from the parent process, which owns the only
    view of worker lifecycles."""
    registry.counter_func(
        "maxmq_pool_worker_restarts_total",
        "Pool worker processes respawned after an unexpected exit",
        lambda: stats.worker_restarts)


def _register_kernel_width_metrics(registry: Registry, eng) -> None:
    """Dual-width plane compare (ADR 010): compiled shape of the live
    fused-kernel program, re-read at scrape time so a table rotation is
    reflected immediately."""
    def _plan(key, e=eng):
        return (e.kernel_plan or {}).get(key, 0)
    for width, gk, wk in (("16", "groups16", "n_words16"),
                          ("32", "groups32", "n_words32")):
        registry.gauge_func(
            "maxmq_matcher_kernel_groups",
            "Signature groups by compiled plane width",
            lambda k=gk: _plan(k), labels={"width": width})
        registry.gauge_func(
            "maxmq_matcher_kernel_words",
            "Device match words by compiled plane width",
            lambda k=wk: _plan(k), labels={"width": width})
    registry.gauge_func(
        "maxmq_matcher_kernel_plane_passes_saved_per_topic",
        "Bit-plane compare passes per topic saved by the packed "
        "16-bit planes vs a uniform 32-bit program",
        lambda: 16 * _plan("n_chunks16") * _plan("chunk16"))
