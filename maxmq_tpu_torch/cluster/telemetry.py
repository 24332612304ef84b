"""Cluster observability plane (ADR 017): federated metric snapshots,
per-peer clock-skew estimation, and the cross-node trace span-return
leg.

Three concerns, one module, because they share the same wire rails
(budget-exempt ``send_control`` over the ADR-013 bridge links, relayed
transitively with the fwd hop cap) and the same consumer (the operator
staring at ONE node while the cluster misbehaves):

* **Telemetry gossip** — each node broadcasts a debounced,
  delta-encoded, cardinality-bounded snapshot of its headline metrics
  on ``$cluster/telemetry/<node>`` (full snapshot every
  ``full_every``-th send so a delta lost to a link flap heals itself).
  Any node can then serve ``/cluster/metrics``: every live peer's
  counters with ``node=`` labels, in Prometheus text format, validated
  by the same ``check_metrics_exposition.py`` conformance gate as the
  local page.
* **Clock skew** — bridge keepalives drive an NTP-style probe
  (``$cluster/clock/<node>`` -> ``.../reply``): the requester stamps
  t0, the peer echoes it with its own clock tp, and the requester
  estimates ``skew = tp - (t0 + rtt/2)`` at the RTT midpoint, EWMA'd.
  The estimate translates cross-node trace timestamps into one
  timeline (monotonic clocks have per-process epochs — raw stamps from
  two nodes are not comparable) and is exposed as
  ``maxmq_cluster_peer_clock_skew_ms``.
* **Span returns** — when an ADOPTED trace (trace.py) finishes on a
  receiving node, its span breakdown is fire-and-forgotten back to the
  origin on ``$cluster/trace/<origin>`` (relayed toward it through the
  mesh, deduped per reporter), where ``PipelineTracer.attach_remote``
  lands it on the origin's flight-recorder entry and the per-hop
  cross-node e2e histograms. Budget-exempt but strictly bounded: a
  report whose trace already left the recorder is counted and dropped.

Copy of the JAX package's ``cluster/telemetry.py``.
"""

from __future__ import annotations

import asyncio
import json
import time

from ..metrics import _fmt, _lbl    # the shared exposition formatters

# what this build can parse; announced on $cluster/hello at link-up.
# A peer that never announced "fwd-trace" receives pre-017 envelopes.
WIRE_CAPS = ("fwd-trace", "telemetry", "clock", "trace-return",
             "blip-hb")

TELEMETRY_MAX_KEYS = 48     # snapshot cardinality bound (per node)
TRACE_SPANS_MAX = 16        # spans carried per returned report
TRACE_DEDUP = 1024          # per-reporter trace-id dedup window
SKEW_EWMA_ALPHA = 0.3       # weight of the newest skew sample


class ClusterTelemetry:
    """The ADR-017 observability sidecar of one ClusterManager."""

    def __init__(self, manager, *, interval_s: float = 5.0,
                 full_every: int = 10, trace_return: bool = True,
                 max_keys: int = TELEMETRY_MAX_KEYS) -> None:
        self.manager = manager
        self.broker = manager.broker
        self.node_id = manager.node_id
        self.interval_s = max(float(interval_s), 0.0)
        self.full_every = max(int(full_every), 1)
        self.trace_return = trace_return
        self.max_keys = max(int(max_keys), 1)

        # node -> {"s": seq, "t": monotonic, "d": {name: [kind, value]}}
        self.peers: dict[str, dict] = {}
        self._last_sent: dict[str, list] = {}
        self._seq = 0
        self._sends = 0
        self._task: asyncio.Task | None = None
        # per-reporter dedup of returned span reports (redundant mesh
        # paths deliver copies; the cross-node histogram must observe
        # each report once)
        self._trace_seen: dict[str, object] = {}

        self.snapshots_sent = 0
        self.snapshots_applied = 0
        self.snapshots_stale = 0
        self.snapshot_relays = 0
        self.probes_sent = 0
        self.probe_replies = 0
        self.skew_updates = 0
        self.trace_reports_sent = 0
        self.trace_reports_relayed = 0
        self.trace_reports_received = 0
        self.inbound_rejected = 0

    # ------------------------------------------------------------------
    # Lifecycle (driven by ClusterManager.start/close)
    # ------------------------------------------------------------------

    def start(self) -> None:
        tracer = getattr(self.broker, "tracer", None)
        if tracer is not None:
            tracer.node_id = self.node_id
            if self.trace_return:
                tracer.on_adopted_finish = self._report_adopted
        if self.interval_s > 0:
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name=f"cluster-telemetry-{self.node_id}")

    def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        tracer = getattr(self.broker, "tracer", None)
        if tracer is not None and tracer.on_adopted_finish is not None:
            tracer.on_adopted_finish = None

    async def _run(self) -> None:
        try:
            while True:
                await asyncio.sleep(self.interval_s)
                self.gossip_tick()
        except asyncio.CancelledError:
            pass

    def on_link_up(self, link) -> None:
        """A fresh link: probe its clock and ship it a full snapshot so
        the peer's operator view converges without waiting a period."""
        self.probe_peer(link)
        self._send_snapshot(self._local_snapshot(), full=True,
                            only=link)

    def on_link_alive(self, link) -> None:
        """Keepalive round-trip completed: refresh the skew estimate
        (the probe rides the same cadence as the ping that proved the
        link, so a congested link's estimate decays with its RTT)."""
        self.probe_peer(link)

    # ------------------------------------------------------------------
    # Telemetry gossip
    # ------------------------------------------------------------------

    def _local_snapshot(self) -> dict[str, list]:
        """This node's headline counters as {family: [kind, value]} —
        a fixed, curated list (the cardinality bound is by
        construction; ``max_keys`` is the rail behind it)."""
        b = self.broker
        mgr = self.manager
        info = b.info
        d: dict[str, list] = {
            "maxmq_mqtt_messages_received":
                ["counter", info.messages_received],
            "maxmq_mqtt_messages_sent": ["counter", info.messages_sent],
            "maxmq_mqtt_messages_dropped":
                ["counter", info.messages_dropped],
            "maxmq_mqtt_clients_connected":
                ["gauge", info.clients_connected],
            "maxmq_mqtt_subscriptions":
                ["gauge", b.topics.subscription_count],
            "maxmq_mqtt_retained": ["gauge", b.topics.retained_count],
            "maxmq_mqtt_inflight": ["gauge", info.inflight],
            "maxmq_cluster_links_up": ["gauge", mgr.links_up],
            "maxmq_cluster_routes_held":
                ["gauge", mgr.routes.remote_route_count],
            "maxmq_cluster_forwards_sent_total":
                ["counter", mgr.forwards_sent],
            "maxmq_cluster_forwards_delivered_total":
                ["counter", mgr.forwards_delivered],
            "maxmq_cluster_loops_dropped_total":
                ["counter", mgr.loops_dropped],
        }
        over = getattr(b, "overload", None)
        if over is not None:
            d["maxmq_broker_overload_queued_bytes"] = \
                ["gauge", over.queued_bytes]
            d["maxmq_broker_overload_shedding"] = \
                ["gauge", int(over.shedding)]
        sess = getattr(mgr, "sessions", None)
        if sess is not None:
            d["maxmq_cluster_session_ledger"] = \
                ["gauge", sess.ledger_size]
            d["maxmq_cluster_session_local"] = \
                ["gauge", sess.local_sessions]
        jr = getattr(b, "_journal", None)
        if jr is not None:
            d["maxmq_storage_breaker_state"] = \
                ["gauge", jr.breaker_state]
            d["maxmq_storage_queue_depth"] = ["gauge", jr.queue_depth]
        if len(d) > self.max_keys:
            d = {k: d[k] for k in sorted(d)[:self.max_keys]}
        return d

    def gossip_tick(self) -> None:
        """One debounced pass: diff the live snapshot against what was
        last sent, broadcast the delta (or, every ``full_every``-th
        send, the whole snapshot so lost deltas self-heal)."""
        snap = self._local_snapshot()
        full = self._sends % self.full_every == 0
        if full:
            d = snap
        else:
            last = self._last_sent
            d = {k: v for k, v in snap.items() if last.get(k) != v}
        if not d:
            return                      # nothing changed: stay quiet
        self._sends += 1
        self._last_sent = snap
        self._send_snapshot(d, full=full)

    def _send_snapshot(self, d: dict, full: bool, only=None) -> None:
        self._seq += 1
        msg = {"v": 1, "o": self.node_id, "s": self._seq, "h": 1,
               "full": int(full), "d": d}
        payload = json.dumps(msg).encode()
        topic = f"$cluster/telemetry/{self.node_id}"
        links = ([only] if only is not None
                 else self.manager.links.values())
        for link in links:
            if link.connected and link.send_control(topic, payload):
                self.snapshots_sent += 1

    def handle_snapshot(self, sender: str, levels: list[str],
                        packet) -> None:
        try:
            msg = json.loads(packet.payload)
            origin = str(msg["o"])
            seq = int(msg["s"])
            hops = int(msg.get("h", 1))
            d = dict(msg.get("d") or {})
        except Exception:
            self.inbound_rejected += 1
            return
        if origin == self.node_id:
            return                      # our own gossip came back
        held = self.peers.get(origin)
        if held is not None and seq <= held["s"]:
            self.snapshots_stale += 1
            return
        if held is None or msg.get("full"):
            held = self.peers[origin] = {"s": seq, "t": 0.0, "d": {}}
            merged = d
        else:
            merged = held["d"]
            merged.update(d)
        if len(merged) > self.max_keys:     # hostile/buggy peer rail
            merged = {k: merged[k] for k in sorted(merged)
                      [:self.max_keys]}
        held["d"] = merged
        held["s"] = seq
        held["t"] = time.monotonic()
        self.snapshots_applied += 1
        if hops < self.manager.max_hops:
            self._relay_snapshot(msg, sender, origin, hops)

    def _relay_snapshot(self, msg: dict, sender: str, origin: str,
                        hops: int) -> None:
        out = dict(msg)
        out["h"] = hops + 1
        payload = json.dumps(out).encode()
        topic = f"$cluster/telemetry/{origin}"
        for peer, link in self.manager.links.items():
            if peer in (sender, origin) or not link.connected:
                continue
            if link.send_control(topic, payload):
                self.snapshot_relays += 1

    def cluster_exposition(self) -> str:
        """The ``/cluster/metrics`` page: every known family, one
        series per node (self from the live counters, peers from their
        latest applied snapshots), plus per-peer snapshot age. Emitted
        in Prometheus text format 0.0.4 — `check_metrics_exposition.py`
        conformant by construction."""
        now = time.monotonic()
        fams: dict[str, tuple[str, dict[str, float]]] = {}

        def fold(node: str, snap: dict) -> None:
            for name, kv in snap.items():
                try:
                    kind, value = str(kv[0]), float(kv[1])
                except (TypeError, ValueError, IndexError):
                    continue
                if kind not in ("counter", "gauge"):
                    kind = "gauge"
                fam = fams.get(name)
                if fam is None:
                    fam = fams[name] = (kind, {})
                fam[1][node] = value

        fold(self.node_id, self._local_snapshot())
        ages: dict[str, float] = {}
        for node, held in self.peers.items():
            fold(node, held["d"])
            ages[node] = max(now - held["t"], 0.0)
        out: list[str] = []
        for name in sorted(fams):
            kind, series = fams[name]
            out.append(f"# HELP {name} Cluster-aggregated from "
                       f"per-node telemetry snapshots (ADR 017)")
            out.append(f"# TYPE {name} {kind}")
            for node in sorted(series):
                out.append(f"{name}{{{_lbl({'node': node})}}} "
                           f"{_fmt(series[node])}")
        out.append("# HELP maxmq_cluster_telemetry_age_seconds Age of "
                   "the newest applied snapshot per peer")
        out.append("# TYPE maxmq_cluster_telemetry_age_seconds gauge")
        out.append(f"maxmq_cluster_telemetry_age_seconds"
                   f"{{{_lbl({'node': self.node_id})}}} 0")
        for node in sorted(ages):
            out.append(f"maxmq_cluster_telemetry_age_seconds"
                       f"{{{_lbl({'node': node})}}} "
                       f"{_fmt(round(ages[node], 3))}")
        return "\n".join(out) + "\n"

    # ------------------------------------------------------------------
    # Clock-skew probes
    # ------------------------------------------------------------------

    def _clock(self) -> int:
        tracer = getattr(self.broker, "tracer", None)
        if tracer is not None:
            return tracer.clock()
        from .. import faults
        return faults.REGISTRY.clock_ns()

    def probe_peer(self, link) -> None:
        if not link.connected:
            return
        if getattr(link, "local", False):
            # ADR 021: a loopback (unix-domain) worker link shares this
            # host's monotonic clock — skew is zero by construction.
            # Pin the estimate instead of probing so the correlated-
            # trace math and /cluster/metrics read the truth at zero
            # wire cost.
            st = self.manager.membership.get(link.peer)
            if st is not None:
                st.skew_ns, st.rtt_ns = 0.0, 0.0
                st.skew_samples += 1
            return
        payload = json.dumps({"t0": self._clock()}).encode()
        if link.send_control(f"$cluster/clock/{self.node_id}", payload):
            self.probes_sent += 1

    def handle_clock(self, sender: str, levels: list[str],
                     packet) -> None:
        """Both probe legs: a bare ``$cluster/clock/<peer>`` is a
        request (echo t0 + our clock back on OUR link to the peer); a
        ``.../reply`` closes the loop and updates the estimate."""
        try:
            msg = json.loads(packet.payload)
        except Exception:
            self.inbound_rejected += 1
            return
        if len(levels) >= 4 and levels[3] == "reply":
            self._apply_clock_reply(sender, msg)
            return
        link = self.manager.links.get(sender)
        if link is None or not link.connected:
            return                      # asymmetric wiring: no way back
        payload = json.dumps({"t0": msg.get("t0", 0),
                              "tp": self._clock()}).encode()
        link.send_control(f"$cluster/clock/{self.node_id}/reply",
                          payload)
        self.probe_replies += 1

    def _apply_clock_reply(self, sender: str, msg: dict) -> None:
        st = self.manager.membership.get(sender)
        if st is None:
            return
        try:
            t0, tp = int(msg["t0"]), int(msg["tp"])
        except (KeyError, TypeError, ValueError):
            self.inbound_rejected += 1
            return
        t1 = self._clock()
        rtt = t1 - t0
        if rtt < 0:
            self.inbound_rejected += 1  # echoed t0 from the future
            return
        skew = tp - (t0 + rtt / 2)      # peer clock at the midpoint
        if st.skew_samples == 0:
            st.skew_ns, st.rtt_ns = float(skew), float(rtt)
        else:
            a = SKEW_EWMA_ALPHA
            st.skew_ns += a * (skew - st.skew_ns)
            st.rtt_ns += a * (rtt - st.rtt_ns)
        st.skew_samples += 1
        self.skew_updates += 1

    def skew_ns(self, peer: str) -> int:
        st = self.manager.membership.get(peer)
        return int(st.skew_ns) if st is not None else 0

    # ------------------------------------------------------------------
    # Span-return leg
    # ------------------------------------------------------------------

    def _report_adopted(self, trace, entry: dict) -> None:
        """tracer.on_adopted_finish: ship this node's span breakdown
        of a remote-origin trace back toward the origin."""
        spans = [[s["stage"], s["off_us"], s["dur_us"]]
                 for s in entry["spans"][:TRACE_SPANS_MAX]]
        self.send_report(trace.origin, trace.id, spans,
                         e2e_us=int(entry["e2e_ms"] * 1000),
                         hops=trace.hops, degraded=entry["degraded"])

    def send_report(self, origin: str, trace_id: int, spans: list,
                    e2e_us: int, hops: int = 1, degraded: str = "",
                    kind: str = "pub") -> None:
        """Fire-and-forget one span report toward ``origin`` (used by
        the adopted-publish leg above and the ADR-016 session-state
        ship leg, kind="sess"). Floods this node's links; intermediates
        relay with the fwd hop cap and the origin dedups per
        reporter."""
        msg = {"v": 1, "o": origin, "i": trace_id, "n": self.node_id,
               "h": max(int(hops), 1), "rh": 1, "e2e_us": int(e2e_us),
               "deg": degraded, "k": kind, "spans": spans}
        self._flood_report(msg, exclude=set())
        self.trace_reports_sent += 1

    def _flood_report(self, msg: dict, exclude: set) -> None:
        payload = json.dumps(msg).encode()
        topic = f"$cluster/trace/{msg['o']}"
        # shortcut: a live direct link to the origin carries the report
        # alone — flooding is only for topologies where the origin is
        # hops away (a line's far end, a partitioned mesh corner)
        direct = self.manager.links.get(msg["o"])
        if direct is not None and direct.connected \
                and direct.send_control(topic, payload):
            return
        for peer, link in self.manager.links.items():
            if peer in exclude or not link.connected:
                continue
            link.send_control(topic, payload)

    def handle_trace(self, sender: str, levels: list[str],
                     packet) -> None:
        try:
            msg = json.loads(packet.payload)
            origin = str(msg["o"])
            reporter = str(msg["n"])
            trace_id = int(msg["i"])
            relay_hops = int(msg.get("rh", 1))
        except Exception:
            self.inbound_rejected += 1
            return
        if origin == self.node_id:
            from .manager import DedupWindow
            win = self._trace_seen.get(reporter)
            if win is None:
                win = self._trace_seen[reporter] = \
                    DedupWindow(cap=TRACE_DEDUP)
            if not win.admit(trace_id):
                return                  # redundant mesh path
            self.trace_reports_received += 1
            tracer = getattr(self.broker, "tracer", None)
            if tracer is not None:
                tracer.attach_remote(msg)
            return
        if relay_hops >= self.manager.max_hops:
            return
        out = dict(msg)
        out["rh"] = relay_hops + 1
        self.trace_reports_relayed += 1
        self._flood_report(out, exclude={sender, reporter})
