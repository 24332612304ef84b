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
the HTTP server with its debug routes, ``register_broker_metrics`` with
every registration that reads a broker (its storage pipeline, overload
ladder, fan-out ledger, content plane, matcher and tracer) and the
matcher-side registrations (the supervisor's fallbacks and breaker, the
service client's transport, the pool, the signature engine's kernel
widths), and the cluster manager's registrations (the federation's
routes, forwards, links and peers, its federated sessions and its
telemetry plane).
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


def register_broker_metrics(registry: Registry, broker) -> None:
    """Register the ``maxmq_mqtt_*`` metric family reading the broker's
    ``$SYS`` counters at scrape time (internal/mqtt/metrics.go:31-88: 15
    counter/gauge funcs over mochi's atomic system.Info)."""
    info = broker.info
    counters = [
        ("bytes_received", "Total number of bytes received"),
        ("bytes_sent", "Total number of bytes sent"),
        ("messages_received", "Total number of publish messages received"),
        ("messages_sent", "Total number of publish messages sent"),
        ("messages_dropped", "Total number of publish messages dropped"),
        ("packets_received", "Total number of packets received"),
        ("packets_sent", "Total number of packets sent"),
        ("clients_total", "Total number of clients known to the broker"),
        ("inflight_dropped", "Total number of inflight messages dropped"),
    ]
    gauges = [
        ("clients_connected", "Number of currently connected clients"),
        ("clients_disconnected", "Number of disconnected persistent sessions"),
        ("clients_maximum", "Maximum number of concurrently connected clients"),
        ("retained", "Number of retained messages"),
        ("inflight", "Number of inflight messages"),
        ("subscriptions", "Number of active subscriptions"),
        ("uptime", "Broker uptime in seconds"),
    ]
    for name, help_ in counters:
        registry.counter_func(f"maxmq_mqtt_{name}", help_,
                              lambda n=name: getattr(info, n))
    for name, help_ in gauges:
        registry.gauge_func(f"maxmq_mqtt_{name}", help_,
                            lambda n=name: getattr(info, n))
    # matcher-side metrics (device path; no reference equivalent)
    _register_matcher_metrics(registry, broker)
    # host-path overload ladder (ADR 012)
    _register_overload_metrics(registry, broker)
    # cluster federation (ADR 013)
    _register_cluster_metrics(registry, broker)
    # crash-consistent storage pipeline (ADR 014)
    _register_storage_metrics(registry, broker)
    # publish-path tracing (ADR 015)
    _register_trace_metrics(registry, broker)
    # zero-copy fan-out (ADR 019)
    _register_fanout_metrics(registry, broker)
    # MQTT+ content plane (ADR 023)
    _register_filter_metrics(registry, broker)



# stage-error label cardinality bound: stages are a fixed set and
# reasons a small enum, but the exposition page stays bounded even if a
# future call site invents reasons dynamically
STAGE_ERROR_SERIES = 32

# per-peer link-series cardinality bound, mirroring the ADR-012
# offender metric's discipline: the peer set is operator-supplied and
# small, but the exposition page must stay bounded regardless (the
# broker's $SYS cluster entries read it too)
CLUSTER_PEER_SERIES = 8


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


def _register_cluster_metrics(registry: Registry, broker) -> None:
    """ADR-013 federation observability: route-table size, delta/
    snapshot churn, forward/loop counters, and per-peer link health
    (bounded to CLUSTER_PEER_SERIES series, label values escaped by
    the shared exposition path — peer ids are operator config, but the
    page must survive a hostile one)."""
    mgr = getattr(broker, "cluster", None)
    if mgr is None:
        return
    registry.gauge_func(
        "maxmq_cluster_routes_held",
        "Remote topic filters currently held in the route table",
        lambda: mgr.routes.remote_route_count)
    registry.gauge_func(
        "maxmq_cluster_links_up",
        "Bridge links currently connected", lambda: mgr.links_up)
    for name, help_ in (
            ("snapshots_applied", "Route snapshots applied"),
            ("deltas_applied", "Route deltas applied"),
            ("route_desyncs",
             "Delta gaps/epoch mismatches that flushed a peer's routes "
             "and requested a fresh snapshot"),
            ("route_apply_failures",
             "Route payloads that failed to decode/apply"),
            ("forwards_sent", "Publishes forwarded to peers"),
            ("forwards_delivered",
             "Remote publishes fanned out to local subscribers"),
            ("forwards_refused",
             "Forwards refused by a link's byte budget/queue "
             "(QoS1 entries rolled back)"),
            ("forwards_skipped_down",
             "Forward targets skipped because the link was down "
             "(local-only degradation)"),
            ("loops_dropped",
             "Forwards dropped by the origin-echo/dedup loop guards"),
            ("hops_dropped", "Onward forwards dropped by the hop cap"),
            ("link_flaps", "Bridge link up->down transitions"),
            ("connect_attempts",
             "Bridge connect attempts (incl. backoff retries)"),
            ("forwards_parked",
             "QoS1 forwards parked for retry-after-heal (ADR 018: "
             "stranded by a down/partitioned link)"),
            ("fwd_parked_resent",
             "Parked forwards re-sent on link-up (receiver dedups "
             "any copy that landed before the partition)"),
            ("fwd_parked_dropped",
             "Parked forwards shed past the park bound (the bounded-"
             "staleness cap; counted loss)"),
            ("fwd_barrier_waits",
             "Publisher acks that waited on the ADR-018 cross-node "
             "forward-durability barrier"),
            ("fwd_barrier_timeouts",
             "Forward-durability barriers released by the timeout"),
            ("fwd_barrier_degraded",
             "Forward-durability barriers released without full peer "
             "coverage (timeout/parked/link down)"),
            ("fwd_restore_errors",
             "Parked-forward journal rows that failed to parse at "
             "restore"),
            ("partition_drops_in",
             "Inbound $cluster messages the cluster.partition fault "
             "dropped in flight (ADR 018 chaos harness)"),
            ("partition_drops_out",
             "Outbound bridge wire items the cluster.partition fault "
             "blackholed (ADR 018 chaos harness)"),
            ("relay_chain_waits",
             "Relayed forwards whose upstream PUBACK waited on the "
             "ADR-020 hop-chained downstream barrier"),
            ("relay_chain_timeouts",
             "Relay-chain waits released degraded by the bounded "
             "timeout"),
            ("blips_detected",
             "Sub-keepalive loss blips detected on inbound links "
             "(ADR 020 heartbeat seq gap / item deficit)"),
            ("blip_resyncs",
             "Debounced link resyncs triggered by a peer's blip "
             "notice (routes + sessions resync, parked-forward "
             "resend)"),
            ("route_sync_waits",
             "Inbound forwards held for this node's initial route "
             "convergence (ADR 020 restarted-relay gate)"),
            ("route_sync_timeouts",
             "Route-sync holds released degraded by the bounded "
             "timeout (a configured peer never advertised)"),
            ("shape_deferrals",
             "Outbound bridge items held by the ADR-022 WAN shape's "
             "deferral queue before release"),
            ("shape_drops_in",
             "Inbound $cluster messages the cluster.shape loss draw "
             "ate in flight (ADR 022 WAN chaos harness)"),
            ("rtt_adaptive_extended",
             "Liveness/barrier deadlines stretched past their floor "
             "by the ADR-022 k x measured-RTT term"),
            ("fwd_parked_rehomed",
             "Parked forwards re-routed off a dead owner's link after "
             "a takeover moved the subscription (ADR 022, closes the "
             "ADR-021 dead-owner blackhole)"),
            ("content_route_skips",
             "Forwards skipped because the peer's every matching "
             "route carried ADR-023 predicate annotations none of "
             "which passed the payload")):
        registry.counter_func(f"maxmq_cluster_{name}_total", help_,
                              lambda n=name: getattr(mgr, n))
    registry.gauge_func(
        "maxmq_cluster_fwd_parked",
        "QoS1 forwards currently parked awaiting retry-after-heal "
        "(ADR 018)", lambda: mgr.fwd_parked_now)

    def _peer_series(attr):
        links = sorted(mgr.links.items())[:CLUSTER_PEER_SERIES]
        return [({"peer": peer}, attr(link)) for peer, link in links]

    registry.multi_func(
        "maxmq_cluster_link_state", "gauge",
        "Per-peer bridge link state (1 connected, 0 down); cardinality "
        "bounded to the first CLUSTER_PEER_SERIES peers",
        lambda: _peer_series(lambda lk: 1.0 if lk.connected else 0.0))
    registry.multi_func(
        "maxmq_cluster_link_queued_bytes", "gauge",
        "Per-peer bridge outbound queued bytes (accounted on the "
        "ADR-012 ledger); same cardinality bound",
        lambda: _peer_series(lambda lk: lk.outbound.bytes))
    registry.multi_func(
        "maxmq_cluster_link_forwards_total", "counter",
        "Per-peer forwards enqueued; same cardinality bound",
        lambda: _peer_series(lambda lk: lk.forwards_sent))

    def _member_series(attr):
        peers = sorted(mgr.membership.peers.items())[:CLUSTER_PEER_SERIES]
        return [({"peer": peer}, attr(st)) for peer, st in peers]

    registry.multi_func(
        "maxmq_cluster_peer_clock_skew_ms", "gauge",
        "Per-peer monotonic-clock skew estimate from keepalive-driven "
        "probes (ADR 017: peer clock minus ours at the RTT midpoint, "
        "EWMA); same cardinality bound",
        lambda: _member_series(lambda st: st.skew_ns / 1e6))
    registry.multi_func(
        "maxmq_cluster_peer_rtt_ms", "gauge",
        "Per-peer clock-probe round-trip estimate (EWMA); same "
        "cardinality bound",
        lambda: _member_series(lambda st: st.rtt_ns / 1e6))
    _register_telemetry_metrics(registry, mgr)
    _register_session_metrics(registry, mgr)


def _register_session_metrics(registry: Registry, mgr) -> None:
    """ADR-016 federated-session observability: ledger size, takeover
    outcomes (incl. every degradation rung), replication-barrier
    health, and the cluster-wide $share group count."""
    sess = getattr(mgr, "sessions", None)
    if sess is None:
        return
    for name, attr, help_ in (
            ("ledger", "ledger_size",
             "Sessions tracked in the cluster ledger (local + remote)"),
            ("local", "local_sessions",
             "Sessions this node currently owns"),
            ("share_groups", "share_groups",
             "Cluster-wide $share (group, filter) pairs with live "
             "members")):
        registry.gauge_func(f"maxmq_cluster_session_{name}", help_,
                            lambda a=attr: getattr(sess, a))
    for name, help_ in (
            ("takeovers", "Remote sessions taken over locally at "
             "CONNECT (epoch-fenced)"),
            ("takeovers_degraded", "Takeovers degraded to fresh-"
             "session-with-counted-loss (fault/partition)"),
            ("takeovers_stale", "Takeovers that timed out pulling "
             "fresh state and installed the replicated ledger copy"),
            ("sessions_lost", "Local sessions claimed away by a "
             "higher fencing token (client got SessionTakenOver)"),
            ("state_transfers", "Full session-state handoffs received "
             "during takeover"),
            ("claims_rejected", "Stale claims fenced off by a higher "
             "local token"),
            ("purges", "Cluster-wide session purges applied"),
            ("relays", "Session messages relayed onward (transitive "
             "replication)"),
            ("sync_flushes", "Replication flushes put on the wire"),
            ("sync_ops", "Inflight-record replication ops sent"),
            ("sync_acks", "Replication messages acknowledged by peers"),
            ("sync_degraded", "Replication barriers released without "
             "full peer durability (lag/partition/timeout)"),
            ("sync_timeouts", "Replication barriers released by the "
             "sync timeout"),
            ("sync_faults", "Injected cluster.session_sync faults "
             "tripped"),
            ("sync_send_failures", "Session messages a link refused "
             "to enqueue"),
            ("sync_resyncs", "Per-link resyncs healing a refused "
             "replication send on a live link"),
            ("sync_barrier_waits", "Publisher acks that waited on a "
             "replication barrier"),
            ("digest_mismatches", "Takeovers whose installed inflight "
             "window disagreed with the owner's digest"),
            ("restore_errors", "Ledger journal rows that failed to "
             "parse at restore"),
            ("trace_ops_applied", "Replicated inflight ops applied "
             "that carried ADR-017 trace identity"),
            ("replica_expiries", "Dead-owner replicas purged by the "
             "replica-side expiry timer (ADR 018)"),
            ("wills_fired", "Transferred wills fired here for a dead "
             "owner's sessions (ADR 018)"),
            ("wills_cleared", "Replica wills cleared by a peer's "
             "willfire broadcast (the exactly-once stand-down)")):
        registry.counter_func(f"maxmq_cluster_session_{name}_total",
                              help_, lambda n=name: getattr(sess, n))


def _register_telemetry_metrics(registry: Registry, mgr) -> None:
    """ADR-017 observability-plane health: gossip and span-return
    traffic counters, and how many peers' snapshots this node holds."""
    tel = getattr(mgr, "telemetry", None)
    if tel is None:
        return
    registry.gauge_func(
        "maxmq_cluster_telemetry_peers_held",
        "Peer metric snapshots currently held (serves /cluster/metrics)",
        lambda: len(tel.peers))
    for name, help_ in (
            ("snapshots_sent", "Telemetry snapshots/deltas broadcast"),
            ("snapshots_applied", "Peer telemetry snapshots applied"),
            ("snapshots_stale", "Out-of-order snapshots ignored"),
            ("snapshot_relays", "Snapshots relayed onward (transitive "
             "gossip)"),
            ("probes_sent", "Clock-skew probes sent"),
            ("probe_replies", "Clock-skew probes answered for peers"),
            ("skew_updates", "Skew estimate updates applied"),
            ("trace_reports_sent", "Cross-node span reports sent "
             "toward an origin"),
            ("trace_reports_received", "Span reports received as the "
             "origin (post-dedup)"),
            ("trace_reports_relayed", "Span reports relayed toward "
             "their origin"),
            ("inbound_rejected", "Malformed observability-plane wire "
             "messages rejected")):
        registry.counter_func(f"maxmq_cluster_telemetry_{name}_total",
                              help_, lambda n=name: getattr(tel, n))


def _register_storage_metrics(registry: Registry, broker) -> None:
    """ADR-014 storage-pipeline observability: journal pressure (queue
    depth/bytes), group-commit health (latency, batch size, failures),
    the degradation breaker, and what restore had to quarantine. Duck-
    typed off the storage hook so custom Store implementations degrade
    to the subset they expose."""
    hook = next((h for h in broker.hooks
                 if hasattr(h, "bump_boot_epoch")), None)
    if hook is None:
        return
    registry.counter_func(
        "maxmq_storage_quarantined_records_total",
        "Torn/undecodable records set aside at restore instead of "
        "aborting boot", lambda: hook.quarantined)
    registry.counter_func(
        "maxmq_storage_journal_sheds_total",
        "QoS0-irrelevant journal rewrites shed while the broker was "
        "load-shedding past the journal watermark",
        lambda: hook.journal_sheds)
    registry.counter_func(
        "maxmq_storage_rewrites_skipped_total",
        "Redundant inflight resend rewrites elided (record already in "
        "the pipeline/store)", lambda: hook.rewrites_skipped)
    registry.gauge_func(
        "maxmq_storage_boot_epoch",
        "Persisted monotonic boot counter (strictly increases across "
        "restarts; adopted by the cluster layer)",
        lambda: broker.boot_epoch)
    registry.counter_func(
        "maxmq_storage_barrier_waits_total",
        "QoS acks released through the storage_sync=always durability "
        "barrier", lambda: broker.storage_barrier_waits)
    jr = getattr(hook, "journal", None)
    backing = jr.inner if jr is not None else hook.store
    if getattr(backing, "corruptions", None) is not None:
        registry.counter_func(
            "maxmq_storage_corruptions_total",
            "Storage files that failed the open-time integrity check "
            "and were moved aside + recreated",
            lambda: backing.corruptions)
    if getattr(backing, "aside_failures", None) is not None:
        registry.counter_func(
            "maxmq_storage_aside_failures_total",
            "Corrupt-file move-asides that failed (forensic copy lost; "
            "the damaged file was removed in place so the recreate "
            "still booted)", lambda: backing.aside_failures)
    if jr is None:
        return
    for name, help_, fn in (
            ("queue_depth", "Journal ops awaiting group commit",
             lambda: jr.queue_depth),
            ("queue_bytes", "Journal bytes awaiting group commit",
             lambda: jr.queued_bytes_now),
            ("breaker_state",
             "Storage breaker state (0=closed, 1=open, 2=half-open)",
             lambda: jr.breaker_state),
            ("last_commit_seconds", "Duration of the last group commit",
             lambda: jr.last_commit_s),
            ("last_batch_ops", "Ops in the last group commit",
             lambda: jr.last_batch_ops),
            ("largest_batch_ops", "Largest group commit since start",
             lambda: jr.largest_batch_ops),
            ("dirty",
             "1 when a write was lost or parked past its durability "
             "promise (degraded-mode writes, shed rewrites)",
             lambda: int(jr.dirty)),
            ("disk_full",
             "1 while the last commit failure was ENOSPC and no commit "
             "has succeeded since (the ADR-024 disk-full rung is up)",
             lambda: int(getattr(jr, "disk_full", False)))):
        registry.gauge_func(f"maxmq_storage_{name}", help_, fn)
    for name, help_, fn in (
            ("commits", "Group commits applied to the backend",
             lambda: jr.commits),
            ("commit_failures", "Group commits that failed (batch "
             "parked and retried)", lambda: jr.commit_failures),
            ("put_failures", "Writes dropped at the journal enqueue "
             "boundary", lambda: jr.put_failures),
            ("ops_written", "Individual ops committed to the backend",
             lambda: jr.ops_written),
            ("ops_coalesced", "Same-key writes merged in the journal "
             "before commit", lambda: jr.coalesced),
            ("queue_overflows", "Enqueues that landed past the journal "
             "byte watermark", lambda: jr.overflows),
            ("breaker_trips", "Times the storage breaker opened "
             "(memory-backed degraded writes)", lambda: jr.breaker_trips),
            ("breaker_recoveries", "Half-open reprobes that restored "
             "the backend and replayed the parked journal",
             lambda: jr.breaker_recoveries),
            ("barriers_released_degraded", "Durability barriers "
             "released undurable because the breaker opened",
             lambda: jr.barriers_released_degraded),
            ("commit_seconds", "Cumulative time in backend commits",
             lambda: jr.commit_seconds_total),
            ("degraded_seconds", "Cumulative wall time with the "
             "storage breaker not closed", lambda: jr.degraded_seconds),
            ("fsync_failures", "Group commits whose flush failed — "
             "each one poisons the backend connection (ADR 024)",
             lambda: getattr(jr, "fsync_failures", 0)),
            ("enospc_failures", "Group commits refused by a full disk "
             "(immediate breaker trip, ADR 024)",
             lambda: getattr(jr, "enospc_failures", 0)),
            ("backend_reopens", "Poisoned backend connections reopened "
             "before replaying the parked journal (ADR 024)",
             lambda: getattr(jr, "backend_reopens", 0))):
        registry.counter_func(f"maxmq_storage_{name}_total", help_, fn)


def _register_overload_metrics(registry: Registry, broker) -> None:
    """ADR-012 overload-ladder observability: the global byte ledger +
    watermark state, every ladder counter, and the cardinality-bounded
    per-client top-offender family (at most overload.TOP_OFFENDERS
    series per scrape; see docs/adr/012-overload-protection.md)."""
    over = getattr(broker, "overload", None)
    if over is None:
        return
    from .broker.overload import top_offenders
    registry.gauge_func(
        "maxmq_broker_overload_queued_bytes",
        "Wire bytes queued across all client outbound queues",
        lambda: over.queued_bytes)
    registry.gauge_func(
        "maxmq_broker_overload_shedding",
        "1 while above the high-water mark (QoS0 fan-out shed, "
        "retained delivery deferred)",
        lambda: int(over.shedding))
    for name, help_ in (
            ("sheds", "Entries into the load-shedding regime"),
            ("recoveries", "Exits back below the low-water mark"),
            ("shed_messages", "QoS0 deliveries dropped while shedding"),
            ("budget_drops",
             "Deliveries dropped by the per-client/global byte budgets "
             "(oldest-first QoS0 shed + refused new deliveries)"),
            ("qos_drops",
             "QoS>0 deliveries refused by a full queue and rolled back "
             "(quota returned, inflight entry removed)"),
            ("deferred_retained",
             "Retained deliveries deferred to recovery by shedding"),
            ("stalled_disconnects",
             "Clients disconnected by the writer stall deadline"),
            ("disk_full_sheds",
             "QoS0-irrelevant storage rewrites shed by the ENOSPC "
             "ladder rung while the backing disk was full (ADR 024)")):
        registry.counter_func(f"maxmq_broker_overload_{name}_total",
                              help_, lambda n=name: getattr(over, n))
    for reason, attr in (("rate", "connects_refused"),
                         ("half_open", "half_open_refused")):
        registry.counter_func(
            "maxmq_broker_overload_connects_refused_total",
            "Connections refused by admission control, by reason",
            lambda a=attr: getattr(over, a), labels={"reason": reason})
    registry.multi_func(
        "maxmq_broker_client_dropped_messages_total", "counter",
        "Deliveries dropped by a client's own backpressure (queue/byte "
        "budget, stalls; global watermark sheds excluded), top "
        "offenders only (cardinality bounded to overload.TOP_OFFENDERS "
        "series)",
        lambda: [({"client": row["client"]}, row["dropped"])
                 for row in top_offenders(broker.clients.all())])


def _register_fanout_metrics(registry: Registry, broker) -> None:
    """ADR-019 zero-copy fan-out ledger: template reuse vs the
    residual per-subscriber encodes, shared vs copied wire bytes,
    writev batch shape, and the per-loop-iteration writer-wake
    coalescing — the terms the fanout bench config divides by."""
    over = getattr(broker, "overload", None)
    if over is None:
        return
    for name, help_ in (
            ("template_builds",
             "Shared PUBLISH wire templates/frames built (one per "
             "publish x protocol major version)"),
            ("template_sends",
             "Deliveries enqueued as shared wire bytes or patched "
             "template buffer sequences"),
            ("slow_encodes",
             "Deliveries that took the per-subscriber copy+encode "
             "slow path (hook overrides, resends, retained sends)"),
            ("shared_bytes",
             "Wire bytes served from shared template segments, never "
             "copied per subscriber"),
            ("copied_bytes",
             "Wire bytes materialized per subscriber (patched frame "
             "heads + slow-path encodes)"),
            ("writev_batches",
             "Writer burst flushes handed to transport.writelines"),
            ("writev_buffers",
             "Wire buffers carried by those writelines batches")):
        registry.counter_func(f"maxmq_broker_fanout_{name}_total",
                              help_, lambda n=name: getattr(over, n))
    sched = getattr(broker, "flush_sched", None)
    if sched is not None:
        for name, help_ in (
                ("flushes", "Coalesced writer-wake flush passes run"),
                ("deferred", "Writer wakes parked for a flush pass"),
                ("coalesced",
                 "Duplicate same-iteration wakes absorbed by a park")):
            registry.counter_func(
                f"maxmq_broker_fanout_flush_{name}_total", help_,
                lambda n=name: getattr(sched, n))


def _register_filter_metrics(registry: Registry, broker) -> None:
    """ADR-023 content plane: predicate-subscription registry size,
    batch-evaluation throughput, the delivery mask's effect, windowed
    aggregation output/shedding, and the device-path fallback ladder
    — the terms the mqttplus bench config divides by."""
    cp = getattr(broker, "content", None)
    if cp is None:
        return
    registry.gauge_func(
        "maxmq_filter_subscriptions",
        "Content subscriptions currently registered (predicate "
        "and/or aggregate)", lambda: len(cp.subs))
    registry.gauge_func(
        "maxmq_filter_predicates",
        "Distinct compiled predicate programs in the registry",
        lambda: cp.n_predicates)
    registry.gauge_func(
        "maxmq_filter_windows",
        "Tumbling aggregation windows currently holding state",
        lambda: cp.n_windows)
    for name, help_ in (
            ("batches", "Pipeline flushes the content plane "
             "evaluated (one vectorized pass each)"),
            ("evals", "Predicate x message pairs evaluated "
             "vectorized (the per-message reference loop would "
             "run this many scalar programs)"),
            ("masked", "Deliveries suppressed because the "
             "subscriber's every matching content predicate "
             "evaluated false"),
            ("eval_errors", "Batch evaluations that failed and "
             "failed OPEN (unfiltered delivery preserved)"),
            ("agg_emitted", "Synthesized aggregate publishes "
             "emitted at window close"),
            ("agg_shed", "Window-close emissions shed under "
             "overload or the filter.window fault"),
            ("rejected_subscribes", "SUBSCRIBE filters rejected for "
             "malformed/over-quota content options"),
            ("device_fallbacks", "Vectorized batches that fell back "
             "from the device backend to NumPy (ADR-011-style "
             "breaker ladder)")):
        registry.counter_func(f"maxmq_filter_{name}_total", help_,
                              lambda n=name: getattr(cp, n))


def _register_matcher_metrics(registry: Registry, broker) -> None:
    matcher = getattr(broker, "matcher", None)
    if matcher is not None:
        register_matcher_stats(registry, matcher)
        # ANY attached matcher drives the ADR-006 pipeline; scrapes run
        # on the metrics thread while close() may null the queue on the
        # event loop, so bind the queue reference exactly once per read
        registry.gauge_func(
            "maxmq_broker_publish_pipeline_depth",
            "Publishes queued awaiting in-order fan-out (ADR 006)",
            lambda: (q.qsize()
                     if (q := broker._pub_queue) is not None else 0))
        registry.counter_func(
            "maxmq_broker_publish_trie_degraded_total",
            "Publishes served from the broker's own trie after a match "
            "future failed (the rung below the ADR-011 supervisor)",
            lambda: broker.matcher_degrades)


def register_matcher_stats(registry: Registry, matcher) -> None:
    """A matcher's own counts (matches, fallbacks, breaker, batches,
    cache hits, the bypass and its round trip, the engine's host routes,
    the service transport): a broker's attached matcher, or the worker
    pool's sidecar batcher on the pool parent's endpoint."""
    if hasattr(matcher, "matches"):
        registry.counter_func(
            "maxmq_matcher_matches_total",
            "Topic matches answered by the device matcher",
            lambda: matcher.matches)
        _register_fallback_metrics(registry, matcher)
        if hasattr(matcher, "breaker_state"):
            _register_breaker_metrics(registry, matcher)
        if hasattr(matcher, "batches"):
            registry.counter_func(
                "maxmq_matcher_batches_total",
                "Device micro-batches dispatched",
                lambda: matcher.batches)
            registry.gauge_func(
                "maxmq_matcher_largest_batch",
                "Largest micro-batch formed since start",
                lambda: matcher.largest_batch)
        if hasattr(matcher, "cache_hits"):
            registry.counter_func(
                "maxmq_matcher_cache_hits_total",
                "Matches served from the version-keyed topic cache",
                lambda: matcher.cache_hits)
        if hasattr(matcher, "bypasses"):
            registry.counter_func(
                "maxmq_matcher_bypassed_topics_total",
                "Topics served inline on the host by the adaptive "
                "bypass (ADR 008)",
                lambda: matcher.bypasses)
            registry.gauge_func(
                "maxmq_matcher_device_rtt_seconds",
                "Measured device round-trip EWMA driving the bypass",
                lambda: matcher.device_rtt)
        eng = getattr(matcher, "engine", matcher)
        if hasattr(eng, "host_matches"):
            registry.counter_func(
                "maxmq_matcher_host_matches_total",
                "Topics matched by the device-free host sig path "
                "(bypass + single-topic surface, ADR 008)",
                lambda: eng.host_matches)
        if hasattr(eng, "trie_routed"):
            registry.counter_func(
                "maxmq_matcher_trie_routed_total",
                "Topics served from the CPU trie by the small-corpus "
                "router (ADR 008)",
                lambda: eng.trie_routed)
        if hasattr(eng, "kernel_plan"):
            _register_kernel_width_metrics(registry, eng)
        _register_transport_metrics(registry, matcher)


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
