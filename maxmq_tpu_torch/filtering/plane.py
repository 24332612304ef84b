"""The content plane: registry, fan-out mask, aggregate emission
(ADR 023).

Runs *after* topic matching on the publish path. The broker hands it
one pipeline flush — a list of (packet, subscribers) pairs — and
:meth:`ContentPlane.apply` stamps every packet with a
``_content_skip`` frozenset of client ids whose only claims on the
topic are content-gated and failed: ``_publish_to_client`` consults
it before delivery, so the mask rides the existing fan-out instead of
a second matching pass. Aggregate ($agg) subscriptions never receive
the raw publish; their windows accumulate here and the housekeeping
tick emits synthesized aggregate publishes on window close.

Opt-in syntax (parsed at SUBSCRIBE, malformed -> SUBACK failure):

    sensors/+/temp?$expr=payload.value>30
    sensors/+/temp?$agg=avg&$win=5s
    sensors/+/temp?$agg=max&$win=2m&$field=payload.value&$expr=...

carried as a topic-suffix on every protocol version, or — for v5
clients that keep filters wire-clean — as a ``maxmq-filter`` user
property on the SUBSCRIBE whose value is ``<filter>?<options>``.

Fail-open contract: an evaluator error (including an armed
``filter.eval`` fault) delivers that flush **unfiltered** — the
content plane may only ever narrow delivery when it is healthy, never
drop traffic by breaking. Aggregate emission sheds under the ADR-012
overload ladder and the ``filter.window`` fault site, counted.

Copy of the JAX package's ``filtering/plane.py``. The evaluator's device
backend is ``torch`` (the reference's ``jnp``), on the device the broker
names (``BrokerOptions.device``; the card when it names none).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass

import numpy as np

from .. import faults
from ..matching.topics import filter_matches_topic, split_levels
from ..protocol.codec import FixedHeader, PacketType as PT
from ..protocol.packets import Packet
from .columnar import ColumnarEvaluator, build_columns
from .expr import CompiledPredicate, ExprError, compile_expr, decode_payload
from .window import AGG_OPS, WindowAgg

USER_PROP_KEY = "maxmq-filter"
OPTION_KEYS = ("$expr", "$agg", "$win", "$field")


class ContentQuota(Exception):
    """Registration refused by a bound (SUBACK 0x97 quota exceeded)."""


@dataclass(frozen=True)
class FilterSpec:
    """Parsed content options of one subscription."""

    pred: CompiledPredicate | None      # $expr, compiled
    agg: str | None                     # $agg op, or None
    win_s: float                        # $win seconds (0 when no agg)
    field: str                          # $field (default "payload")
    source: str                         # the raw option string


def _parse_win(text: str) -> float:
    """``5s`` / ``500ms`` / ``2m`` / bare seconds -> float seconds."""
    text = text.strip()
    scale = 1.0
    for suffix, mult in (("ms", 1e-3), ("s", 1.0), ("m", 60.0)):
        if text.endswith(suffix):
            text, scale = text[:-len(suffix)], mult
            break
    try:
        win = float(text) * scale
    except ValueError:
        raise ExprError(f"bad $win value {text!r}") from None
    if win <= 0:
        raise ExprError("$win must be positive")
    return win


def parse_spec(options: str, max_expr_len: int = 512,
               max_fields: int = 64, win_min_s: float = 0.0,
               win_max_s: float = float("inf")) -> FilterSpec:
    """Parse the ``$k=v&...`` option string after the ``?``. Raises
    :class:`ExprError` on anything malformed — unknown keys,
    duplicate keys, $agg/$win inconsistencies, bad expressions — so
    SUBSCRIBE rejects cleanly instead of guessing."""
    seen: dict[str, str] = {}
    for part in options.split("&"):
        key, eq, val = part.partition("=")
        if not eq or key not in OPTION_KEYS:
            raise ExprError(f"bad filter option {part!r}")
        if key in seen:
            raise ExprError(f"duplicate option {key}")
        seen[key] = val
    pred = None
    if "$expr" in seen:
        pred = compile_expr(seen["$expr"], max_len=max_expr_len,
                            max_fields=max_fields)
    agg = seen.get("$agg")
    win_s = 0.0
    field = seen.get("$field", "payload")
    if agg is not None:
        if agg not in AGG_OPS:
            raise ExprError(f"unknown $agg op {agg!r}")
        if "$win" not in seen:
            raise ExprError("$agg requires $win")
        win_s = _parse_win(seen["$win"])
        if not win_min_s <= win_s <= win_max_s:
            raise ExprError(f"$win out of range "
                            f"[{win_min_s}, {win_max_s}]")
        if field != "payload" and not field.startswith("payload."):
            raise ExprError(f"bad $field {field!r}")
    else:
        if "$win" in seen:
            raise ExprError("$win requires $agg")
        if "$field" in seen:
            raise ExprError("$field requires $agg")
        if pred is None:
            raise ExprError("empty filter options")
    return FilterSpec(pred=pred, agg=agg, win_s=win_s, field=field,
                      source=options)


class ContentSub:
    """One registered content subscription (client x base filter)."""

    __slots__ = ("client_id", "base_filter", "flevels", "spec",
                 "window")

    def __init__(self, client_id: str, base_filter: str,
                 spec: FilterSpec) -> None:
        self.client_id = client_id
        self.base_filter = base_filter
        self.flevels = split_levels(base_filter)
        self.spec = spec
        self.window = (WindowAgg(spec.agg, spec.field, spec.win_s)
                       if spec.agg is not None else None)

    @property
    def pred(self) -> CompiledPredicate | None:
        return self.spec.pred


class ContentPlane:
    """Per-broker content-plane state + batch evaluator driver."""

    def __init__(self, broker, device=None) -> None:
        self.broker = broker
        caps = broker.capabilities
        self.max_subs = caps.filter_max_subscriptions
        self.max_expr_len = caps.filter_max_expr_len
        self.max_fields = caps.filter_max_fields
        self.batch_max = max(int(caps.filter_batch_max), 1)
        self.win_min_s = caps.filter_window_min_s
        self.win_max_s = caps.filter_window_max_s
        self.evaluator = ColumnarEvaluator(backend=caps.filter_backend,
                                           device=device or "cuda")
        self.subs: dict[tuple[str, str], ContentSub] = {}
        self._by_client: dict[str, dict[str, ContentSub]] = {}
        self._fields: tuple[str, ...] = ()
        self._topic_cache: dict[str, list[ContentSub]] = {}
        # counters (exposed as maxmq_filter_* — metrics.py)
        self.batches = 0            # apply() flushes evaluated
        self.evals = 0              # (publish x predicate) pairs
        self.masked = 0             # deliveries suppressed by the mask
        self.eval_errors = 0        # fail-open batches
        self.agg_emitted = 0        # synthesized aggregate publishes
        self.agg_shed = 0           # emissions shed (overload/fault)
        self.rejected_subscribes = 0  # malformed/quota SUBSCRIBE opts

    # -- registry -------------------------------------------------------

    @property
    def active(self) -> bool:
        return bool(self.subs)

    @property
    def device_fallbacks(self) -> int:
        return self.evaluator.device_fallbacks

    @property
    def n_windows(self) -> int:
        return sum(1 for s in self.subs.values()
                   if s.window is not None)

    @property
    def n_predicates(self) -> int:
        return sum(1 for s in self.subs.values()
                   if s.pred is not None)

    def parse_spec(self, options: str) -> FilterSpec:
        return parse_spec(options, max_expr_len=self.max_expr_len,
                          max_fields=self.max_fields,
                          win_min_s=self.win_min_s,
                          win_max_s=self.win_max_s)

    def register(self, client_id: str, base_filter: str,
                 spec: FilterSpec) -> ContentSub:
        """Install (or replace) one content subscription. Raises
        :class:`ContentQuota` at the bounds — the caller answers with
        SUBACK quota-exceeded and never touches the topic index."""
        key = (client_id, base_filter)
        if key not in self.subs and len(self.subs) >= self.max_subs:
            raise ContentQuota("content subscription quota")
        sub = ContentSub(client_id, base_filter, spec)
        fields = set(self._fields)
        if sub.pred is not None:
            fields.update(sub.pred.fields)
        if sub.window is not None:
            fields.add(sub.window.field)
        if len(fields) > self.max_fields:
            raise ContentQuota("content field quota")
        self.subs[key] = sub
        self._by_client.setdefault(client_id, {})[base_filter] = sub
        self._rebuild()
        return sub

    def unregister(self, client_id: str, base_filter: str) -> None:
        if self.subs.pop((client_id, base_filter), None) is not None:
            per = self._by_client.get(client_id)
            if per is not None:
                per.pop(base_filter, None)
                if not per:
                    del self._by_client[client_id]
            self._rebuild()

    def drop_client(self, client_id: str) -> None:
        per = self._by_client.pop(client_id, None)
        if per:
            for base_filter in per:
                self.subs.pop((client_id, base_filter), None)
            self._rebuild()

    def get(self, client_id: str, base_filter: str) -> ContentSub | None:
        return self.subs.get((client_id, base_filter))

    def _rebuild(self) -> None:
        fields: list[str] = []
        for s in self.subs.values():
            if s.pred is not None:
                for f in s.pred.fields:
                    if f not in fields:
                        fields.append(f)
            if s.window is not None and s.window.field not in fields:
                fields.append(s.window.field)
        self._fields = tuple(fields)
        self._topic_cache.clear()
        # ADR 023 stretch: gating annotations ride route snapshots — a
        # registry change may alter which filters are fully gated
        note = getattr(getattr(self.broker, "cluster", None),
                       "note_content_change", None)
        if note is not None:
            note()

    def gated_filters(self) -> dict[str, list[str]]:
        """Filters whose local subscribers ALL require a predicate —
        the ADR-023 stretch annotation a bridge peer may use to skip
        forwards no local predicate can pass. A filter with any
        aggregate-only or plain subscriber is NOT gated (aggregates
        still consume every matching publish)."""
        by_filter: dict[str, list[ContentSub]] = {}
        for s in self.subs.values():
            by_filter.setdefault(s.base_filter, []).append(s)
        if not by_filter:
            return {}
        holders: dict[str, set[str]] = {}
        shared_block: set[str] = set()
        for filt, cid, _sub, group in \
                self.broker.topics.all_subscriptions():
            if filt not in by_filter:
                continue
            if group:
                # shared subscriptions never carry options, so a $share
                # holder of the same inner filter is a plain consumer
                shared_block.add(filt)
            else:
                holders.setdefault(filt, set()).add(cid)
        out: dict[str, list[str]] = {}
        for filt, subs in by_filter.items():
            if filt in shared_block:
                continue
            if any(s.pred is None for s in subs):
                continue
            # a plain subscriber on the same filter string unguards it
            if any(self.get(cid, filt) is None
                   for cid in holders.get(filt, ())):
                continue
            out[filt] = sorted({s.pred.expr for s in subs})
        return out

    # -- batch evaluation ----------------------------------------------

    def _subs_for(self, topic: str) -> list[ContentSub]:
        hit = self._topic_cache.get(topic)
        if hit is not None:
            return hit
        tl = split_levels(topic)
        dollar = topic.startswith("$")
        out = [s for s in self.subs.values()
               if filter_matches_topic(s.flevels, tl, dollar)]
        if len(self._topic_cache) > 4096:
            self._topic_cache.clear()
        self._topic_cache[topic] = out
        return out

    def apply(self, pairs) -> None:
        """Evaluate one flush and stamp every packet's
        ``_content_skip``. Fail-open: any error stamps empty masks
        (deliver unfiltered) and is counted + stage-attributed."""
        pairs = list(pairs)
        tracer = self.broker.tracer
        t0 = time.perf_counter()
        try:
            faults.fire(faults.FILTER_EVAL)
            self._apply_inner(pairs)
            self.batches += 1
        except Exception as exc:
            self.eval_errors += 1
            tracer.note_error("filter", type(exc).__name__)
            for packet, _subs in pairs:
                packet._content_skip = frozenset()
        finally:
            tracer.observe("filter", time.perf_counter() - t0)

    def _apply_inner(self, pairs) -> None:
        n = len(pairs)
        match_lists = [self._subs_for(p.topic) for p, _s in pairs]
        if not any(match_lists):
            for packet, _subs in pairs:
                packet._content_skip = frozenset()
            return
        objs = [decode_payload(p.payload) for p, _s in pairs]
        cols = build_columns(objs, self._fields)
        prog_rows: dict[str, int] = {}
        programs: list = []
        for subs in match_lists:
            for s in subs:
                if s.pred is not None and s.pred.expr not in prog_rows:
                    prog_rows[s.pred.expr] = len(programs)
                    programs.append(s.pred.program)
        matrix = (self.evaluator.eval_batch(programs, cols, n)
                  if programs else None)
        if programs:
            self.evals += len(programs) * n
        now = time.time()
        agg_rows: dict[int, list[int]] = {}   # id(sub) -> row indices
        agg_subs: dict[int, ContentSub] = {}
        for i, ((packet, _subs), subs) in enumerate(zip(pairs,
                                                        match_lists)):
            skip = self._mask_packet(i, packet, subs, matrix,
                                     prog_rows, agg_rows, agg_subs)
            packet._content_skip = skip
        for sid, idxs in agg_rows.items():
            self._accumulate(agg_subs[sid], cols, idxs, now)

    def _mask_packet(self, i: int, packet, subs, matrix, prog_rows,
                     agg_rows, agg_subs) -> frozenset:
        by_cid: dict[str, list[ContentSub]] = {}
        for s in subs:
            by_cid.setdefault(s.client_id, []).append(s)
        skip: set[str] = set()
        for cid, ss in by_cid.items():
            deliver = False
            for s in ss:
                ok = True
                if s.pred is not None:
                    ok = bool(matrix[prog_rows[s.pred.expr], i])
                if s.window is not None:
                    if ok:
                        sid = id(s)
                        agg_rows.setdefault(sid, []).append(i)
                        agg_subs[sid] = s
                elif ok:
                    deliver = True
            if not deliver and not self._has_plain(cid, packet.topic):
                skip.add(cid)
                self.masked += 1
        return frozenset(skip)

    def _has_plain(self, cid: str, topic: str) -> bool:
        """Does this client hold a NON-content filter matching the
        topic? (Then the merged fan-out delivery stands regardless of
        any failing predicates.)"""
        client = self.broker.clients.get(cid)
        if client is None:
            return False
        csubs = self._by_client.get(cid, ())
        tl = split_levels(topic)
        dollar = topic.startswith("$")
        for filt in client.subscriptions:
            if filt in csubs or filt.startswith("$share/"):
                continue
            if filter_matches_topic(split_levels(filt), tl, dollar):
                return True
        return False

    # -- windowed aggregation ------------------------------------------

    def _accumulate(self, sub: ContentSub, cols, idxs: list[int],
                    now: float) -> None:
        w = sub.window
        pair = cols.get(w.field)
        if pair is None:
            values = np.zeros(0)
        else:
            vals, valid = pair
            idx = np.asarray(idxs, dtype=np.intp)
            sel = valid[idx]
            values = vals[idx][sel]
        emission = w.accumulate(len(idxs), values, now)
        if emission is not None:
            self._emit(sub, emission)

    def tick(self, now: float) -> None:
        """Housekeeping cadence: close due windows, emit aggregates."""
        if not self.subs:
            return
        t0 = time.perf_counter()
        emitted = False
        for s in list(self.subs.values()):
            if s.window is None:
                continue
            emission = s.window.close_due(now)
            if emission is not None:
                emitted = True
                self._emit(s, emission)
        if emitted:
            self.broker.tracer.observe("aggregate",
                                       time.perf_counter() - t0)

    def emit_topic(self, sub: ContentSub) -> str:
        """Aggregate publishes arrive on the base filter when it is a
        literal topic; wildcard filters (illegal as topic names,
        [MQTT-4.7.1]) deliver under ``$aggregate/`` with the wildcard
        characters squashed — the payload carries the exact filter."""
        base = sub.base_filter
        if "+" not in base and "#" not in base:
            return base
        return ("$aggregate/"
                + base.replace("+", "_").replace("#", "_"))

    def _emit(self, sub: ContentSub, emission: dict) -> None:
        broker = self.broker
        try:
            faults.fire(faults.FILTER_WINDOW)
        except faults.InjectedFault:
            self.agg_shed += 1
            broker.tracer.note_error("aggregate", "injected")
            return
        if broker.overload.shedding:
            # ADR 012: synthesized QoS0 traffic sheds with the ladder
            self.agg_shed += 1
            return
        client = broker.clients.get(sub.client_id)
        if client is None:
            return
        s = client.subscriptions.get(sub.base_filter)
        if s is None:
            return
        emission = dict(emission, filter=sub.base_filter)
        payload = json.dumps(emission,
                             separators=(",", ":")).encode()
        packet = Packet(fixed=FixedHeader(type=PT.PUBLISH, qos=0),
                        topic=self.emit_topic(sub), payload=payload,
                        origin="$aggregate", created=time.time())
        packet._content_skip = frozenset()
        broker._publish_to_client(sub.client_id, s, packet,
                                  shared=False)
        self.agg_emitted += 1
