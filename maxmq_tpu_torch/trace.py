"""End-to-end publish-path tracing (ADR 015).

The broker's counters say *how much* work each subsystem did; nothing
before this module said *where a publish's time went*. The
:class:`PipelineTracer` stamps every Nth publish with a correlation id
and records monotonic per-stage spans across every boundary the
pipeline crosses — the asyncio loop, the matcher worker thread, the
storage writer thread, the per-client writer tasks, the cluster bridge
— then aggregates them into fixed-bucket :class:`~.metrics.Histogram`
families and keeps a bounded **flight recorder** of the slowest /
threshold-exceeding publishes with their full span breakdown.

Stage model (see docs/adr/015-publish-tracing.md for the contract):

``decode``         wire bytes -> Packet (timed in the client read loop)
``admission``      validate/ACL/overload/QoS checks in process_publish
``match_queue``    batcher coalescing wait (enqueue -> device dispatch)
``match_device``   device/trie match time (dispatch -> result ready)
``pipeline_wait``  in-order fan-out queueing behind earlier publishes
``fanout``         local subscriber selection + outbound enqueue/encode
``bridge``         cluster route consult + forward enqueue (ADR 013)
``journal_commit`` storage group-commit duration (writer thread,
                   histogram-only: not tied to one publish)
``barrier``        ack parked on the ADR-014 durability barrier
``ack``            PUBACK/PUBREC build + enqueue
``drain``          per-subscriber outbound enqueue -> writer flush
                   (completes after the publisher's e2e; capped at
                   MAX_DRAIN_SPANS subscribers per trace)
``takeover``       cross-node session takeover leg at CONNECT (ADR
                   016; histogram-only like journal_commit — it is a
                   connection-path span, not a publish-path one)
``bridge_in``      receiving-node inbound leg of a forwarded publish
                   (ADR 017: envelope parse + retain + fan-out handoff
                   on an ADOPTED trace — never stamped locally)
``release``        QoS2 release leg, PUBREC sent -> PUBREL received
                   (ADR 017; histogram-only like takeover — it waits
                   on the publisher's network round trip)
``filter``         content-plane batch evaluation: payload decode +
                   columnar predicate matrix + mask stamping (ADR
                   023; histogram-only, fed per pipeline flush — one
                   observation covers every publish in the batch)
``aggregate``      windowed-aggregate close + synthesized emission
                   (ADR 023; histogram-only like journal_commit — a
                   housekeeping-tick span, not a publish-path one)

Cross-node model (ADR 017): a node receiving a forwarded publish whose
envelope carries trace context **adopts** the origin's trace — same
correlation id, child span chain rooted at ``bridge_in``, start
backdated to the origin's t0 translated through the per-peer clock-skew
estimate — and, on finish, fire-and-forgets its span breakdown back to
the origin over ``$cluster/trace/<origin>`` (cluster/telemetry.py),
where it lands in the origin entry's ``remote`` list and the
per-hop-count ``cross_hist`` e2e histograms.

Cost contract: with ``sample_n == 0`` every instrumented site reduces
to one attribute check/branch and **zero allocations** (asserted by
``tests/test_trace.py`` via the ``allocations`` counter) — and with
sampling off at the origin no trace context crosses the wire, so the
propagation path adds zero allocations cluster-wide (asserted by
``tests/test_cluster_trace.py``). Sampling is deterministic — a stride
counter, not a PRNG — and every timestamp is read through the fault
registry's swappable ``clock_ns`` (faults.py), so tests drive spans
with a scripted clock.

Copy of the JAX package's ``trace.py``, over the port's fault registry
clock.
"""

from __future__ import annotations

import threading
from collections import deque

from . import faults
from .metrics import Histogram

# canonical pipeline stages; CRITICAL_STAGES are the contiguous
# publisher-path segments whose durations sum to ~e2e (drain happens
# after the publisher's terminal stage; journal_commit/takeover/release
# are not tied to one publish's critical path; bridge_in is critical
# only on ADOPTED traces, where it IS the path's first local segment)
STAGES = ("decode", "admission", "match_queue", "match_device",
          "pipeline_wait", "filter", "fanout", "bridge", "bridge_in",
          "journal_commit", "barrier", "ack", "drain", "takeover",
          "release", "aggregate")
CRITICAL_STAGES = frozenset(
    s for s in STAGES
    if s not in ("drain", "journal_commit", "takeover", "release",
                 "aggregate"))

MAX_DRAIN_SPANS = 8     # per-trace cap on recorded subscriber drains
SLOWEST_KEEP = 8        # slowest-ever publishes kept beside the ring
MAX_REMOTE_REPORTS = 8  # per-entry cap on attached remote span reports
MAX_JOURNAL_BUCKETS = 16  # journal-attribution histogram families kept


class PublishTrace:
    """One sampled publish: correlation id + completed spans. Span
    endpoints are raw ``clock_ns`` stamps; nothing here allocates past
    the object itself and its two lists."""

    __slots__ = ("id", "topic", "qos", "client", "start_ns", "spans",
                 "drains", "degraded", "done", "n_drain", "entry",
                 "t_admit", "t_match", "t_barrier", "origin", "hops")

    def __init__(self, trace_id: int, topic: str, qos: int,
                 client: str, start_ns: int) -> None:
        self.id = trace_id
        self.topic = topic
        self.qos = qos
        self.client = client
        self.start_ns = start_ns
        self.spans: list[tuple[str, int, int]] = []   # (stage, t0, dur)
        self.drains: list[tuple[str, int, int]] = []  # (client, t0, dur)
        self.degraded = ""      # ADR-011 rung label when not healthy
        self.done = False
        self.n_drain = 0
        self.entry = None       # live flight-recorder dict, post-finish
        # stage cursors the broker stamps between span() calls
        self.t_admit = 0
        self.t_match = 0
        self.t_barrier = 0
        # ADR 017: set only on ADOPTED traces — the node that sampled
        # the publish and how many cluster hops it took to reach here
        self.origin = ""
        self.hops = 0

    def span(self, stage: str, start_ns: int, end_ns: int) -> None:
        self.spans.append((stage, start_ns, max(end_ns - start_ns, 0)))


class PipelineTracer:
    """Per-broker publish tracer + flight recorder (ADR 015).

    ``sample_n`` is the stride (0 = off, 1 = every publish, N = every
    Nth); ``slow_ms`` > 0 restricts flight-recorder capture to
    publishes at or past that end-to-end latency (0 captures every
    sampled publish); ``ring`` bounds the recorder. Mutable at runtime
    — bench flips ``sample_n`` between phases.

    Thread model: spans/finish run on the event loop; ``observe`` and
    ``note_error`` may fire from the storage writer thread or client
    writer tasks. Histogram/counter updates are GIL-atomic int ops;
    the ring is guarded by a lock only where the HTTP endpoints
    snapshot it.
    """

    def __init__(self, sample_n: int = 0, slow_ms: float = 0.0,
                 ring: int = 64, clock_ns=None, buckets=None) -> None:
        self.sample_n = max(int(sample_n), 0)
        self.slow_ms = float(slow_ms)
        self._clock = clock_ns          # None = fault-registry clock
        self._count = 0                 # publishes seen (stride cursor)
        self._next_id = 0
        self.sampled = 0
        self.allocations = 0            # traces allocated (the
                                        # zero-alloc-when-off witness)
        self.slow_captured = 0
        self.stage_hist: dict[str, Histogram] = {
            s: Histogram(buckets) for s in STAGES}
        self.e2e_hist: dict[int, Histogram] = {
            q: Histogram(buckets) for q in (0, 1, 2)}
        self.stage_errors: dict[tuple[str, str], int] = {}
        self._ring: deque = deque(maxlen=max(int(ring), 1))
        self._slowest: list[dict] = []  # ascending by e2e, bounded
        self._lock = threading.Lock()
        self._buckets = buckets
        # -- cross-node plane (ADR 017) --------------------------------
        self.node_id = ""               # set by the cluster layer
        self.adopted = 0                # remote traces adopted here
        self.adopted_open = 0           # adopted traces not yet finished
                                        # (keeps the stamping gates open
                                        # on a node whose own sampling
                                        # is off)
        self.remote_attached = 0        # span reports attached at origin
        self.remote_orphans = 0         # reports whose trace had left
                                        # the recorder (still histogram-
                                        # fed; the ring is bounded)
        # reports that beat their trace's finish (the return leg races
        # the origin's own terminal stage): parked bounded, re-attached
        # when the trace lands in the recorder. Parking is restricted
        # to ids in _open_ids (locally sampled, not yet finished) so
        # reports for ring-evicted traces count as orphans instead of
        # rotting in (and crowding) the buffer.
        self._pending_remote: deque = deque(maxlen=64)
        self._open_ids: set[int] = set()
        # origin-measured cross-node e2e by hop count (fed by
        # attach_remote from the returned span reports)
        self.cross_hist: dict[int, Histogram] = {}
        # per-storage-bucket group-commit attribution (ADR 017 closing
        # the ADR-015 "per-op journal attribution" NOT-done item); fed
        # by the journal writer thread, bounded to MAX_JOURNAL_BUCKETS
        self.journal_hist: dict[str, Histogram] = {}
        # callback(trace, entry) fired when an ADOPTED trace finishes —
        # cluster/telemetry.py wires the span-return leg here
        self.on_adopted_finish = None

    # -- clock ----------------------------------------------------------

    def clock(self) -> int:
        """Monotonic nanoseconds via the fault registry's swappable
        clock, so a test can script every span deterministically."""
        c = self._clock
        return c() if c is not None else faults.REGISTRY.clock_ns()

    # -- hot-path entry points ------------------------------------------

    def sample(self, topic: str, qos: int, client: str,
               start_ns: int = 0) -> PublishTrace | None:
        """Admit one publish into the stride; returns a PublishTrace
        for every ``sample_n``-th call, else None. Callers gate on
        ``tracer.sample_n`` first, so an off tracer never reaches
        here."""
        n = self.sample_n
        if not n:
            return None
        self._count += 1
        if self._count % n:
            return None
        self.allocations += 1
        self.sampled += 1
        self._next_id += 1
        if len(self._open_ids) < 8192:      # rail: a site that never
            self._open_ids.add(self._next_id)   # finishes must not grow
        return PublishTrace(self._next_id, topic, qos, client,
                            start_ns or self.clock())

    def adopt(self, origin: str, trace_id: int, topic: str, qos: int,
              hops: int, start_ns: int) -> PublishTrace:
        """Open a child span chain for a trace SAMPLED ELSEWHERE (ADR
        017): a forwarded publish whose envelope carried trace context,
        or a pool-bus injection. Never stride-gated — the origin's
        sampling decision is authoritative cluster-wide. ``start_ns``
        is the origin's t0 translated into this node's clock frame (the
        caller applies the per-peer skew estimate), so the adopted
        trace's e2e reads as origin-publish -> local-terminal."""
        self.allocations += 1
        self.adopted += 1
        self.adopted_open += 1
        tr = PublishTrace(trace_id, topic, qos,
                          f"$cluster/{origin}", start_ns)
        tr.origin = origin
        tr.hops = hops
        return tr

    def observe(self, stage: str, seconds: float) -> None:
        """Feed one stage histogram without a per-publish trace (the
        journal's group commits, bench micro-measurements)."""
        self.stage_hist[stage].observe(seconds)

    def observe_journal(self, bucket: str, seconds: float) -> None:
        """Attribute one group commit to a storage bucket it touched
        (ADR 017). Runs on the journal WRITER THREAD: dict insertion is
        GIL-atomic and the scrape path snapshots items. Bounded: past
        MAX_JOURNAL_BUCKETS distinct buckets, attribution lumps into
        ``other`` (bucket names are code-defined, so this is a rail,
        not an expected path)."""
        h = self.journal_hist.get(bucket)
        if h is None:
            if len(self.journal_hist) >= MAX_JOURNAL_BUCKETS:
                bucket = "other"
                h = self.journal_hist.get(bucket)
            if h is None:
                h = self.journal_hist.setdefault(
                    bucket, Histogram(self._buckets))
        h.observe(seconds)

    def journal_items(self) -> list:
        """Snapshot of (bucket, Histogram) for the scrape thread."""
        return sorted(self.journal_hist.items())

    def note_error(self, stage: str, reason: str = "", n: int = 1) -> None:
        """Attribute an error/drop to a pipeline stage — the counter
        behind ``maxmq_broker_stage_errors_total{stage=,reason=}``.
        Locked: callers include the storage writer thread, and a bare
        dict read-modify-write racing the scrape thread's iteration
        could lose increments or blow up the whole exposition."""
        key = (stage, reason)
        with self._lock:
            self.stage_errors[key] = self.stage_errors.get(key, 0) + n

    def stage_error_items(self) -> list:
        """Snapshot of (stage, reason) -> count for the scrape thread
        (iterating the live dict could race a first-seen insert from
        another thread)."""
        with self._lock:
            return list(self.stage_errors.items())

    def drain_span(self, trace: PublishTrace, client: str,
                   start_ns: int, end_ns: int) -> None:
        """One subscriber's outbound enqueue->writer-flush span; lands
        after the publisher-path finish, so it feeds the histogram and
        is appended to the live flight-recorder entry when one holds
        this trace."""
        dur = max(end_ns - start_ns, 0)
        self.stage_hist["drain"].observe(dur / 1e9)
        trace.drains.append((client, start_ns, dur))
        entry = trace.entry
        if entry is not None:
            entry["drains"].append(
                {"client": client,
                 "off_us": (start_ns - trace.start_ns) // 1000,
                 "dur_us": dur // 1000})

    # -- completion -----------------------------------------------------

    def finish(self, trace: PublishTrace, end_ns: int = 0) -> None:
        """Terminal stage reached: feed the histograms and decide
        flight-recorder capture. Idempotent (the durable-ack and
        direct paths can both reach it on teardown races). An ADOPTED
        trace always records (the origin already paid the sampling
        decision and will correlate against it) and fires the
        span-return callback once recorded."""
        if trace.done:
            return
        trace.done = True
        adopted = bool(trace.origin)
        if adopted:
            self.adopted_open = max(self.adopted_open - 1, 0)
        end = end_ns or self.clock()
        e2e_ns = max(end - trace.start_ns, 0)
        hist = self.stage_hist
        for stage, _t0, dur in trace.spans:
            hist[stage].observe(dur / 1e9)
        if not adopted:
            # adopted e2e is origin-publish -> local-terminal across
            # network hops and a skew estimate: it belongs to the
            # cross-node family (fed at the origin from the returned
            # report), NOT to this node's local publisher-path e2e
            self.e2e_hist[min(trace.qos, 2)].observe(e2e_ns / 1e9)
            self._open_ids.discard(trace.id)
        slow = self.slow_ms > 0 and e2e_ns >= self.slow_ms * 1e6
        if slow:
            self.slow_captured += 1
        if not slow and self.slow_ms > 0 and not adopted:
            return                      # under threshold: not recorded
        entry = self._entry(trace, e2e_ns, slow)
        trace.entry = entry
        with self._lock:
            self._ring.append(entry)
            self._note_slowest(entry)
        self._post_record(trace, entry, adopted)

    def _post_record(self, trace: PublishTrace, entry: dict,
                     adopted: bool) -> None:
        """After an entry lands in the recorder: claim any remote span
        reports that beat the finish, and fire the ADR-017 span-return
        callback for adopted traces."""
        if not adopted and self._pending_remote:
            late = [r for r in self._pending_remote
                    if r.get("i") == trace.id]
            for r in late:
                self._pending_remote.remove(r)
                self._attach_to_entries(r)
        cb = self.on_adopted_finish
        if adopted and cb is not None:
            cb(trace, entry)

    @staticmethod
    def _entry(trace: PublishTrace, e2e_ns: int, slow: bool) -> dict:
        start = trace.start_ns
        spans = [{"stage": s, "off_us": (t0 - start) // 1000,
                  "dur_us": dur // 1000} for s, t0, dur in trace.spans]
        critical_ns = sum(dur for s, _t0, dur in trace.spans
                          if s in CRITICAL_STAGES)
        entry = {"id": trace.id, "topic": trace.topic, "qos": trace.qos,
                 "client": trace.client, "start_us": start // 1000,
                 "e2e_ms": round(e2e_ns / 1e6, 3),
                 "critical_sum_ms": round(critical_ns / 1e6, 3),
                 "slow": slow, "degraded": trace.degraded,
                 "spans": spans,
                 "drains": [{"client": c, "off_us": (t0 - start) // 1000,
                             "dur_us": d // 1000}
                            for c, t0, d in trace.drains]}
        if trace.origin:
            entry["origin"] = trace.origin
            entry["hops"] = trace.hops
        return entry

    # -- cross-node span returns (ADR 017) -----------------------------

    def attach_remote(self, report: dict) -> bool:
        """Land one returned span report on the origin's own entry:
        ``report`` is the telemetry-decoded ``$cluster/trace`` payload
        ({i: trace id, n: reporter node, h: hops, e2e_us, spans, deg,
        k}). Feeds the per-hop cross-node e2e histogram either way; a
        report that BEAT its trace's finish is parked (bounded) and
        re-attached from finish(); one whose trace already left the
        recorder is counted and dropped."""
        hops = max(int(report.get("h", 1)), 1)
        e2e_us = max(int(report.get("e2e_us", 0)), 0)
        if report.get("k", "pub") == "pub":
            # only publish-path reports feed the per-hop e2e histogram
            # (sess_ship legs would skew the publish tail)
            h = self.cross_hist.get(hops)
            if h is None:
                h = self.cross_hist.setdefault(
                    hops, Histogram(self._buckets))
            h.observe(e2e_us / 1e6)
        if self._attach_to_entries(report):
            return True
        tid = report.get("i")
        if tid in self._open_ids:
            # a locally-sampled trace that has not finished yet: park
            # for finish() to claim; bounded, eviction = orphan
            if len(self._pending_remote) == self._pending_remote.maxlen:
                self.remote_orphans += 1
            self._pending_remote.append(report)
        else:
            self.remote_orphans += 1    # evicted/unknown trace
        return False

    def _attach_to_entries(self, report: dict) -> bool:
        tid, node = report.get("i"), str(report.get("n", ""))
        hops = max(int(report.get("h", 1)), 1)
        e2e_us = max(int(report.get("e2e_us", 0)), 0)
        with self._lock:
            entry = next(
                (e for e in list(self._ring) + self._slowest
                 if e["id"] == tid and "origin" not in e), None)
            if entry is None:
                return False
            remote = entry.setdefault("remote", [])
            if (len(remote) >= MAX_REMOTE_REPORTS
                    or any(r["node"] == node for r in remote)):
                return True     # handled: duplicate/full, not orphaned
            remote.append({
                "node": node, "hops": hops,
                "e2e_ms": round(e2e_us / 1e3, 3),
                "degraded": str(report.get("deg", "")),
                "spans": [{"stage": str(s), "off_us": int(o),
                           "dur_us": int(d)}
                          for s, o, d in report.get("spans") or []]})
            self.remote_attached += 1
        return True

    def _note_slowest(self, entry: dict) -> None:
        """Keep the SLOWEST_KEEP slowest entries ever seen, ascending,
        beside the recency ring (a burst of slow publishes must not
        evict the all-time outlier). Under self._lock."""
        sl = self._slowest
        if len(sl) >= SLOWEST_KEEP and entry["e2e_ms"] <= sl[0]["e2e_ms"]:
            return
        sl.append(entry)
        sl.sort(key=lambda e: e["e2e_ms"])
        del sl[:-SLOWEST_KEEP]

    # -- reporting ------------------------------------------------------

    @property
    def ring_depth(self) -> int:
        return len(self._ring)

    def stage_quantiles(self, qs=(0.5, 0.95, 0.99)) -> dict:
        """{stage: {count, p50_ms, ...}} over stages with data — what
        bench.py embeds as the BENCH_*.json ``trace`` stanza."""
        out: dict = {}
        for stage, h in self.stage_hist.items():
            if not h.count:
                continue
            row = {"count": h.count}
            for q in qs:
                row[f"p{int(q * 100)}_ms"] = round(
                    h.quantile(q) * 1e3, 3)
            out[stage] = row
        return out

    def e2e_quantiles(self, qs=(0.5, 0.95, 0.99)) -> dict:
        out: dict = {}
        for qos, h in self.e2e_hist.items():
            if not h.count:
                continue
            row = {"count": h.count}
            for q in qs:
                row[f"p{int(q * 100)}_ms"] = round(
                    h.quantile(q) * 1e3, 3)
            out[f"qos{qos}"] = row
        return out

    def cross_quantiles(self, qs=(0.5, 0.95, 0.99)) -> dict:
        """Origin-measured cross-node e2e by hop count (ADR 017) —
        what the ``cluster``/``failover`` bench stanzas embed as the
        per-hop attribution row."""
        out: dict = {}
        for hops, h in sorted(self.cross_hist.items()):
            if not h.count:
                continue
            row = {"count": h.count}
            for q in qs:
                row[f"p{int(q * 100)}_ms"] = round(
                    h.quantile(q) * 1e3, 3)
            out[f"hops{hops}"] = row
        return out

    def report(self) -> dict:
        """The ``/traces`` endpoint body: config, aggregate quantiles,
        the recency ring (oldest first) and the slowest-ever list."""
        with self._lock:
            entries = list(self._ring)
            slowest = list(self._slowest)
        return {"sample_n": self.sample_n, "slow_ms": self.slow_ms,
                "node": self.node_id,
                "sampled": self.sampled,
                "slow_captured": self.slow_captured,
                "adopted": self.adopted,
                "remote_attached": self.remote_attached,
                "remote_orphans": self.remote_orphans,
                "stage_quantiles": self.stage_quantiles(),
                "e2e_quantiles": self.e2e_quantiles(),
                "cross_node": self.cross_quantiles(),
                "entries": entries, "slowest": slowest}

    def chrome_events(self) -> dict:
        """The ``/traces/chrome`` endpoint body: flight-recorder
        entries as Chrome trace_event JSON (load in chrome://tracing
        or Perfetto). One complete ('X') event per span, one PROCESS
        ROW PER NODE (ADR 017: attached remote span reports render on
        their reporter's own named track, offsets already translated
        into the origin's timeline), one thread row per publish."""
        with self._lock:
            entries = list(self._ring)
            for e in self._slowest:
                if all(e["id"] != r["id"] for r in entries):
                    entries.append(e)
        events = []
        node_pids = {self.node_id or "local": 1}

        def pid_for(node: str) -> int:
            pid = node_pids.get(node)
            if pid is None:
                pid = node_pids[node] = len(node_pids) + 1
            return pid

        for e in entries:
            args = {"topic": e["topic"], "qos": e["qos"],
                    "client": e["client"], "e2e_ms": e["e2e_ms"],
                    "degraded": e["degraded"]}
            if "origin" in e:
                args["origin"] = e["origin"]
                args["hops"] = e["hops"]
            events.append({"name": f"publish #{e['id']}",
                           "cat": "publish", "ph": "X",
                           "ts": e["start_us"],
                           "dur": int(e["e2e_ms"] * 1000),
                           "pid": 1, "tid": e["id"], "args": args})
            for sp in e["spans"] + e["drains"]:
                events.append({
                    "name": sp.get("stage",
                                   f"drain:{sp.get('client', '')}"),
                    "cat": "publish", "ph": "X",
                    "ts": e["start_us"] + sp["off_us"],
                    "dur": max(sp["dur_us"], 1),
                    "pid": 1, "tid": e["id"], "args": {}})
            self._remote_events(e, pid_for, events)
        meta = [{"name": "process_name", "ph": "M", "pid": pid,
                 "args": {"name": f"node {node}"}}
                for node, pid in node_pids.items()]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    @staticmethod
    def _remote_events(e: dict, pid_for, events: list) -> None:
        """Attached remote span reports as events on the reporter's
        own process track (ADR 017)."""
        for r in e.get("remote", ()):
            pid = pid_for(r["node"])
            events.append({
                "name": f"publish #{e['id']} @{r['node']}",
                "cat": "publish", "ph": "X", "ts": e["start_us"],
                "dur": max(int(r["e2e_ms"] * 1000), 1),
                "pid": pid, "tid": e["id"],
                "args": {"hops": r["hops"],
                         "degraded": r["degraded"]}})
            for sp in r["spans"]:
                events.append({
                    "name": sp["stage"], "cat": "publish", "ph": "X",
                    "ts": e["start_us"] + sp["off_us"],
                    "dur": max(sp["dur_us"], 1),
                    "pid": pid, "tid": e["id"], "args": {}})

    def sys_entries(self) -> dict:
        """The ``$SYS/broker/trace/*`` subtree (server.py publishes it
        while tracing is on)."""
        e2e = self.e2e_quantiles()
        entries = {
            "$SYS/broker/trace/sample_n": self.sample_n,
            "$SYS/broker/trace/slow_ms": self.slow_ms,
            "$SYS/broker/trace/sampled": self.sampled,
            "$SYS/broker/trace/slow": self.slow_captured,
            "$SYS/broker/trace/ring_depth": self.ring_depth,
            "$SYS/broker/trace/stage_errors":
                sum(n for _k, n in self.stage_error_items()),
            "$SYS/broker/trace/adopted": self.adopted,
            "$SYS/broker/trace/remote_attached": self.remote_attached,
        }
        for qos, row in e2e.items():
            entries[f"$SYS/broker/trace/e2e/{qos}_p99_ms"] = \
                row["p99_ms"]
        return entries
