"""Matcher service: one card-owning process serving topic matches over a
local socket (ADR 005/006).

Copy of the JAX package's ``matching/service.py``: the server, the
client, and the broker half (``_ForwardHook``, ``attach_matcher_service``).
The wire protocol is byte-compatible, so a JAX-package broker attaches to
this service unchanged (``matcher = "service"``), and so does the port's
broker.

The service owns the index + SigEngine + MicroBatcher; any number of
broker processes connect as clients, forward their subscription ops, and
request matches. Requests from ALL clients coalesce into the same device
micro-batches.

Protocol (length-prefixed frames, ``>IB`` = len+type, same shape as the
ADR-005 fan-out bus):

  client -> server
    OP_SUB    {"c": cid, "v": encoded Subscription}
    OP_UNSUB  {"c": cid, "f": filter}     remove one subscription
    OP_DROP   {"c": cid}                  remove every filter of a client
    OP_MATCH  {"r": req_id, "t": [topics]}
  server -> client
    OP_RESULT {"r": req_id, "s": [encoded SubscriberSet per topic]}

Ordering: ops and matches on one connection are processed in arrival
order, so a client's own subscribe is always visible to its later
matches. Cross-client visibility is bounded by op interleaving (same
guarantee as the ADR-005 gossip).

Parity surface: the reference keeps matching in-process
(vendor/.../v2/server.go:766-793); the service is the accelerator
factoring — matching is stateless request/response over a compiled
corpus, so it moves to where the card is.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import random

from .. import faults
from ..hooks.base import Hook
from ..protocol.packets import Subscription
from ..utils.framing import frame as _frame, read_frame as _read_frame
from .trie import (SubscriberSet, TopicIndex,
                   VersionedTopicCache, subs_version)

OP_SUB = 1
OP_UNSUB = 2
OP_DROP = 3
OP_MATCH = 4
OP_RESULT = 5


def _encode_sub(sub: Subscription) -> list:
    return [sub.filter, sub.qos, int(sub.no_local),
            int(sub.retain_as_published), sub.retain_handling,
            sub.identifier, sub.identifiers]


def _decode_sub(v: list) -> Subscription:
    return Subscription(filter=v[0], qos=v[1], no_local=bool(v[2]),
                        retain_as_published=bool(v[3]), retain_handling=v[4],
                        identifier=v[5], identifiers=dict(v[6]))


def encode_result(s) -> dict:
    """SubscriberSet -> JSON-able dict (shared keys become 2-lists)."""
    return {"s": {cid: _encode_sub(sub)
                  for cid, sub in s.subscriptions.items()},
            "g": [[g, f, {cid: _encode_sub(sub)
                          for cid, sub in members.items()}]
                  for (g, f), members in s.shared.items()]}


def decode_result(d: dict) -> SubscriberSet:
    return SubscriberSet(
        subscriptions={cid: _decode_sub(v) for cid, v in d["s"].items()},
        shared={(g, f): {cid: _decode_sub(v) for cid, v in members.items()}
                for g, f, members in d["g"]})


class MatcherService:
    """The card-owning server: index + engine + micro-batcher behind a
    unix socket. ``engine_factory(index)`` builds the matcher — defaults
    to MicroBatcher(SigEngine(index, device=device)), which runs on the
    card unless ``device="cpu"`` is asked for."""

    def __init__(self, path: str, engine_factory=None, device=None) -> None:
        self.path = path
        self.index = TopicIndex()
        # (cid, filter) -> generation of the LATEST acquiring
        # connection, which owns the entry exclusively. In the pool
        # topology one worker serves a client at a time, so each new
        # connection's subscribe bumps the generation and takes sole
        # ownership; everything a STALE connection later does to the
        # pair — takeover-driven OP_DROP, its own death purge, a
        # buffered OP_UNSUB flushing minutes after the session moved —
        # is generation-mismatched and ignored, while the CURRENT
        # owner's ops (an explicit client UNSUBSCRIBE above all) take
        # effect immediately.
        self._owners: dict[tuple, int] = {}
        self._gen = 0
        if engine_factory is None:
            def engine_factory(index):
                from .batcher import MicroBatcher
                from .sig import SigEngine
                return MicroBatcher(SigEngine(index, device=device))
        self._factory = engine_factory
        self.matcher = None               # built lazily on first serve
        self._refresh_pending = False
        self._last_op = 0.0
        self._server: asyncio.Server | None = None
        self._conns: set = set()        # live client writers
        self.subs_applied = 0
        self.matches_served = 0
        # encode memo: match results are cached, immutable objects
        # shared across topics (row-set caches, topic caches), so the
        # JSON fragment for one result is computed once and spliced
        # into every reply that carries it — on fan-out-heavy corpora
        # a single result serializes hundreds of entries. Keyed by
        # object identity WITH a strong ref (keeps the id valid);
        # bounded by entry count, dropped wholesale when full.
        self._enc: dict[int, tuple] = {}
        self._enc_version = -1
        self.enc_hits = 0

    _ENC_CAP = 4096
    REFRESH_QUIET_S = 0.05

    def _result_frag(self, s) -> str:
        # a subscription change rotates every result object, so entries
        # from older versions can never hit again — drop them as a
        # group instead of letting them crowd live fragments to the cap
        ver = self.index.sub_version
        if ver != self._enc_version:
            self._enc.clear()
            self._enc_version = ver
        key = id(s)
        hit = self._enc.get(key)
        if hit is not None and hit[0] is s:
            self.enc_hits += 1
            return hit[1]
        full = s.to_set() if hasattr(s, "to_set") else s
        frag = json.dumps(encode_result(full), separators=(",", ":"))
        if len(self._enc) >= self._ENC_CAP:
            self._enc.clear()
        self._enc[key] = (s, frag)
        return frag

    async def start(self) -> None:
        self.matcher = self._factory(self.index)
        with contextlib.suppress(OSError):
            os.unlink(self.path)    # stale socket from an unclean exit
        self._server = await asyncio.start_unix_server(
            self._serve, path=self.path)

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
        # a connection accepted just before close may not have reached
        # _serve yet (the accept callback is scheduled, not run): yield
        # once so it registers in _conns — otherwise its socket outlives
        # close() as an orphan the client never sees EOF on
        await asyncio.sleep(0)
        for w in list(self._conns):     # established connections too —
            w.close()                   # close() means STOP serving
        if self._server is not None:
            # 3.12 wait_closed() waits for connections as well, so they
            # must be closed first or this deadlocks
            await self._server.wait_closed()
        with contextlib.suppress(OSError):
            os.unlink(self.path)
        close_fn = getattr(self.matcher, "close", None)
        if close_fn is not None:
            res = close_fn()
            if asyncio.iscoroutine(res):
                await res

    def _release(self, cid: str, filt: str, gen: int) -> None:
        """Drop an index entry IF the releasing connection still holds
        its current generation (a stale owner's late release must not
        tear down an entry a newer connection re-owns)."""
        key = (cid, filt)
        if self._owners.get(key) != gen:
            return              # re-owned by a newer connection
        del self._owners[key]
        self.index.unsubscribe(cid, filt)

    def _apply_op(self, ftype: int, msg: dict,
                  owned: dict[str, dict[str, int]]) -> None:
        """One subscription op from one connection. Subscription state
        is OWNED BY THE CONNECTION while it holds the entry's CURRENT
        generation (self._owners): each OP_SUB bumps the generation and
        transfers sole ownership, so a stale connection's later
        drop/unsub/death cannot touch an entry a newer connection
        re-owns, while the current owner's explicit OP_UNSUB stops
        matching immediately (no ghost deliveries until a wedged old
        worker dies). ``owned``: cid -> {filter: generation at acquire}."""
        if ftype == OP_SUB:
            sub = _decode_sub(msg["v"])
            if self.index.subscribe(msg["c"], sub):
                self.subs_applied += 1
            self._gen += 1
            self._owners[(msg["c"], sub.filter)] = self._gen
            owned.setdefault(msg["c"], {})[sub.filter] = self._gen
        elif ftype == OP_UNSUB:
            gen = owned.get(msg["c"], {}).pop(msg["f"], None)
            if gen is not None:
                self._release(msg["c"], msg["f"], gen)
        elif ftype == OP_DROP:
            for filt, gen in owned.pop(msg["c"], {}).items():
                self._release(msg["c"], filt, gen)

    async def _serve(self, reader, writer) -> None:
        """One client connection: ops applied in arrival order; match
        results may complete out of order (req ids pair them) while the
        batcher coalesces topics across ALL connections. A lost UNSUB op
        can never leave stale filters past the owning broker's
        reconnect+reseed: the connection purge releases everything this
        connection still owns."""
        if self._server is None or not self._server.is_serving():
            # the accept callback can fire AFTER close() swept _conns (a
            # connection established in the same loop tick close ran in):
            # serving it would orphan a live socket past shutdown — the
            # client must see EOF and run its reconnect/trie ladder
            writer.close()
            return
        tasks: set[asyncio.Task] = set()
        self._conns.add(writer)
        owned: dict[str, dict[str, int]] = {}
        try:
            while True:
                fr = await _read_frame(reader)
                if fr is None:
                    return
                if faults.fire(faults.SERVICE_SOCKET):
                    # injected socket drop (ADR 011 fault suite): the
                    # client sees EOF mid-stream — pending matches fail
                    # to its trie fallback and its reconnect loop kicks
                    return
                ftype, payload = fr
                msg = json.loads(payload)
                if ftype == OP_MATCH:
                    t = asyncio.ensure_future(
                        self._match(msg["r"], msg["t"], writer,
                                    stamps=bool(msg.get("c"))))
                    tasks.add(t)
                    t.add_done_callback(tasks.discard)
                else:
                    self._apply_op(ftype, msg, owned)
                    self._refresh_later()
        finally:
            self._conns.discard(writer)
            for cid, filters in owned.items():
                for filt, gen in filters.items():
                    self._release(cid, filt, gen)
            if owned:
                self._refresh_later()
            for t in tasks:
                t.cancel()
            writer.close()

    def _refresh_later(self) -> None:
        """Start the engine's background refresh once the subscription
        ops pause for ``REFRESH_QUIET_S``, so the tables catch up with
        the index off the match path: a reseed's stream of OP_SUB frames
        starts one compile, at its end. Without this, a service reseeded
        with a corpus compiles it at its first match, which then waits on
        the compile (F27)."""
        loop = asyncio.get_running_loop()
        self._last_op = loop.time()
        if not self._refresh_pending:
            self._refresh_pending = True
            loop.call_later(self.REFRESH_QUIET_S, self._refresh_now)

    def _refresh_now(self) -> None:
        """Kick the refresh once the ops are quiet; while one runs, look
        again every ``REFRESH_QUIET_S``: ops applied during a compile are
        in none of its tables, and ``refresh_soon`` starts no second one
        meanwhile. (The engines that refresh in the background have
        ``refresh_soon``; the NFA and dense engines refresh at a
        match.)"""
        if self._server is None or not self._server.is_serving():
            self._refresh_pending = False
            return
        loop = asyncio.get_running_loop()
        quiet = self._last_op + self.REFRESH_QUIET_S - loop.time()
        if quiet > 0:
            loop.call_later(quiet, self._refresh_now)
            return
        engine = getattr(self.matcher, "engine", self.matcher)
        kick = getattr(engine, "refresh_soon", None)
        if kick is None or not getattr(engine, "auto_refresh", True):
            self._refresh_pending = False
            return
        kick()
        bg = getattr(engine, "_bg_thread", None)
        if bg is not None and bg.is_alive():
            loop.call_later(self.REFRESH_QUIET_S, self._refresh_now)
        else:
            self._refresh_pending = False

    async def _match(self, req_id: int, topics: list[str], writer,
                     stamps: bool = False) -> None:
        try:
            # ADR 017: when the client is tracing ("c" on the request),
            # stamp dispatch/done around the engine call so the broker
            # can split its matcher leg into queue vs device time even
            # across the socket RPC. Durations only — monotonic clocks
            # have per-process epochs, so raw stamps never cross as-is
            # (the client rebases them onto its own timeline).
            td = faults.REGISTRY.clock_ns() if stamps else 0
            enq = getattr(self.matcher, "enqueue", None)
            if enq is not None:
                results = await asyncio.gather(*(enq(t) for t in topics))
            else:
                results = await asyncio.gather(
                    *(self.matcher.subscribers_async(t) for t in topics))
            tn = faults.REGISTRY.clock_ns() if stamps else 0
            self.matches_served += len(topics)
            # req_id round-trips through json.dumps so any JSON-legal
            # id a client sent (float, string) keys its reply correctly
            head = json.dumps(req_id)
            if stamps:
                head += ',"td":%d,"tn":%d' % (td, tn)
            payload = ('{"r":%s,"s":[%s]}' % (
                head,
                ",".join(self._result_frag(s) for s in results))
            ).encode()
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            # the client MUST get a reply — a silent drop leaves its
            # future (and that publish) pending forever; the broker
            # degrades an errored match to its CPU trie
            payload = json.dumps(
                {"r": req_id, "e": repr(exc)[:300]}).encode()
        writer.write(_frame(OP_RESULT, payload))
        try:
            await writer.drain()
        except (ConnectionError, OSError):
            pass


class ServiceMatcher:
    """Drop-in broker matcher backed by a MatcherService socket: exposes
    ``enqueue(topic) -> Future`` (the ADR-006 pipeline surface) plus
    ``subscribers_async``, and forwards subscription ops. Attach with
    ``attach_matcher_service(broker, path)`` so sub/unsub forwarding is
    wired automatically."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._reader = None
        self._writer = None
        self._reader_task: asyncio.Task | None = None
        self._reconnect_task: asyncio.Task | None = None
        self._pending: dict[int, asyncio.Future] = {}
        # frames sent in one loop iteration, written as ONE transport
        # write at its end: asyncio's write() sums the whole queued
        # buffer on every call, so a bulk of small writes (a reseed of a
        # large index, thousands of requests in flight) would be
        # quadratic in the frames queued
        self._out: list[bytes] = []
        self._next_req = 0
        self._connect_lock = asyncio.Lock()
        self._closed = False
        # callable(matcher) replaying current subscription state after a
        # reconnect (set by attach_matcher_service)
        self._reseed = None
        # version-keyed topic cache (same discipline as MicroBatcher):
        # requires ``self.index`` (set by attach_matcher_service) for
        # the subscription version; disabled when unset
        self._cache = VersionedTopicCache()
        self.index = None
        # ADR 017: the broker's PipelineTracer (set by
        # attach_matcher_service); while it samples, match requests ask
        # the service for dispatch/done stamps and the reply rebases
        # them onto this process's timeline as fut._t_dispatch/_t_done
        # (the ADR-015 queue/device split, now across the socket RPC)
        self.tracer = None
        # stats (scraped by the metrics bridge)
        self.matches = 0
        self.fallbacks = 0
        self.cache_hits = 0
        self.reconnects = 0
        self.reconnect_attempts = 0

    # our ``fallbacks`` are dead-transport fast-fails, not row
    # overflows; the ADR-011 supervisor counts those same events under
    # reason="error", so it must not re-count them as "overflow"
    overflow_fallbacks = 0

    async def connect(self) -> None:
        async with self._connect_lock:
            if self._writer is not None:
                return
            reader, writer = await asyncio.open_unix_connection(self.path)
            self._reader, self._writer = reader, writer
            self._reader_task = asyncio.ensure_future(
                self._read_loop(reader, writer))

    async def close(self) -> None:
        # flag first: a queued _reconnect must not resurrect the
        # connection (leaked fd + read-loop task + post-shutdown reseed)
        self._closed = True
        if self._reconnect_task is not None:
            self._reconnect_task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._reconnect_task
        if self._reader_task is not None:
            self._reader_task.cancel()
            try:
                await self._reader_task
            except (asyncio.CancelledError, Exception):
                pass
        if self._writer is not None:
            self._flush(self._writer)
            self._writer.close()
        for fut, _t, _v in self._pending.values():
            if not fut.done():
                fut.cancel()
        self._pending.clear()

    async def _read_loop(self, reader, writer) -> None:
        try:
            await self._read_loop_inner(reader, writer)
        except asyncio.CancelledError:
            raise
        except Exception:
            # a malformed frame must fail like EOF, not strand the
            # pending futures behind a live-looking writer; close the
            # transport (not just null it) or the fd leaks and the
            # server's eventual purge of the half-open connection would
            # race a later reconnect's reseed
            self._drop_transport(writer, "matcher service protocol error")

    def _drop_transport(self, writer=None,
                        msg: str = "matcher service lost") -> None:
        """Close a dead transport and fail its in-flight matches (the
        broker degrades them to its CPU trie). When ``writer`` is given
        and is NOT the current transport — a stale read-loop waking
        after a reconnect already replaced it — only that stale fd is
        closed; the live connection's state is untouched."""
        if writer is not None and writer is not self._writer:
            with contextlib.suppress(Exception):
                writer.close()
            return
        w, self._writer = self._writer, None
        self._reader = None
        self._out.clear()       # frames for the dead transport
        if w is not None:
            with contextlib.suppress(Exception):
                w.close()
        for fut, _t, _v in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError(msg))
        self._pending.clear()
        # a dropped transport opens a divergence window (ops queued
        # while down are not forwarded; the service may have restarted
        # empty): drop the result cache wholesale — the reconnect
        # reseed re-establishes ground truth, and refilling is cheap
        self._cache = VersionedTopicCache()

    async def _read_loop_inner(self, reader, writer) -> None:
        while True:
            fr = await _read_frame(reader)
            if fr is None:
                # connection lost: fail in-flight matches fast and
                # close the dead transport so enqueue() fails fast too
                self._drop_transport(writer)
                return
            _ftype, payload = fr
            msg = json.loads(payload)
            entry = self._pending.pop(msg["r"], None)
            if entry is None:
                continue
            fut, topic, ver = entry
            if fut.done():
                continue
            if "e" in msg:
                fut.set_exception(RuntimeError(
                    f"matcher service error: {msg['e']}"))
            else:
                if "td" in msg:
                    # rebase the service's dispatch->done duration onto
                    # our clock: device time is the frame-free duration,
                    # both socket directions land in match_queue
                    now = (self.tracer.clock() if self.tracer is not None
                           else faults.REGISTRY.clock_ns())
                    dur = max(int(msg.get("tn", 0)) - int(msg["td"]), 0)
                    fut._t_done = now
                    fut._t_dispatch = now - dur
                if topic is None:           # subscribers_batch_async
                    fut.set_result([decode_result(s) for s in msg["s"]])
                    continue
                result = decode_result(msg["s"][0])
                if ver is not None:
                    self._cache.put(topic, ver, result)
                fut.set_result(result)

    def _send(self, ftype: int, msg: dict) -> bool:
        """Write one op; False (dropped) when the transport is down —
        the reconnect reseed replays the full current state, and the
        service purges a lost connection's subscriptions itself, so a
        dropped op can never strand state. forward_* must never raise
        into hooks.notify (it does not catch)."""
        w = self._writer
        if w is None or w.is_closing():
            return False
        self._out.append(_frame(ftype, json.dumps(msg).encode()))
        if len(self._out) == 1:
            asyncio.get_running_loop().call_soon(self._flush, w)
        return True

    def _flush(self, w) -> None:
        """Write the frames queued by _send, in order, as one write (they
        are dropped when their transport was replaced meanwhile, like any
        op sent while the transport is down)."""
        out, self._out = self._out, []
        if out and w is self._writer and not w.is_closing():
            w.write(b"".join(out))

    # -- subscription forwarding (called by the attach hook) ----------
    def forward_subscribe(self, cid: str, sub: Subscription) -> None:
        self._send(OP_SUB, {"c": cid, "v": _encode_sub(sub)})

    def forward_unsubscribe(self, cid: str, filter_: str) -> None:
        self._send(OP_UNSUB, {"c": cid, "f": filter_})

    def forward_drop(self, cid: str) -> None:
        self._send(OP_DROP, {"c": cid})

    # -- matcher surface ----------------------------------------------
    def enqueue(self, topic: str) -> asyncio.Future:
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        if self._writer is None or self._writer.is_closing():
            # dead transport: fail fast (trie fallback upstream) and
            # kick one background reconnect; subscription state is
            # re-seeded by _reseed once the new connection is up
            fut.set_exception(ConnectionError("matcher service down"))
            self.fallbacks += 1
            if self._reconnect_task is None or self._reconnect_task.done():
                self._reconnect_task = loop.create_task(self._reconnect())
            return fut
        ver = None
        if self.index is not None:
            ver = subs_version(self.index)
            hit = self._cache.get(topic, ver)
            if hit is not None:
                self.cache_hits += 1
                fut.set_result(hit)
                return fut
        self.matches += 1       # real round trips only (cache hits are
        req = self._next_req    # counted separately, as in batcher mode)
        self._next_req += 1
        self._pending[req] = (fut, topic, ver)
        msg = {"r": req, "t": [topic]}
        tracer = self.tracer
        if tracer is not None and (tracer.sample_n
                                   or tracer.adopted_open):
            msg["c"] = 1        # ask the service for ADR-017 stamps
        self._send(OP_MATCH, msg)
        return fut

    # reconnect backoff: the loop keeps retrying while traffic is quiet
    # (the old behavior gave up after ONE OSError and waited for the
    # next enqueue to retry — a silent broker stayed disconnected for
    # as long as it stayed silent), with capped exponential backoff +
    # jitter so a pool of brokers doesn't stampede a restarting service
    RECONNECT_BACKOFF_INITIAL = 0.05
    RECONNECT_BACKOFF_MAX = 2.0
    RECONNECT_JITTER = 0.25     # fraction of the delay randomized

    async def _reconnect(self) -> None:
        delay = self.RECONNECT_BACKOFF_INITIAL
        while True:
            # under the connect lock: a concurrent connect() may already
            # have restored a live transport, which a queued reconnect
            # must not tear down
            async with self._connect_lock:
                if self._closed:
                    return
                if (self._writer is not None
                        and not self._writer.is_closing()):
                    return
                # close any lingering old transport FIRST so the server
                # purges that connection's subscription refs before (or
                # concurrently with) the reseed replaying them on the
                # new connection — the service-side refcounting makes
                # either ordering safe, but a half-open fd must not leak
                self._drop_transport()
                self.reconnect_attempts += 1
                try:
                    reader, writer = await asyncio.open_unix_connection(
                        self.path)
                except OSError:
                    pass                # retry after backoff below
                else:
                    self._reader, self._writer = reader, writer
                    self._reader_task = asyncio.ensure_future(
                        self._read_loop(reader, writer))
                    self.reconnects += 1
                    if self._reseed is not None:
                        self._reseed(self)  # replay current subscriptions
                    return
            await asyncio.sleep(
                delay * (1 + self.RECONNECT_JITTER * random.random()))
            delay = min(delay * 2, self.RECONNECT_BACKOFF_MAX)

    async def subscribers_async(self, topic: str) -> SubscriberSet:
        return await self.enqueue(topic)

    async def subscribers_batch_async(self, topics: list[str]
                                      ) -> list[SubscriberSet]:
        """Match many topics in ONE request (the protocol's ``t`` list):
        one frame each way instead of one per topic. Raises
        ConnectionError when the transport is down."""
        if self._writer is None or self._writer.is_closing():
            raise ConnectionError("matcher service down")
        fut = asyncio.get_running_loop().create_future()
        req = self._next_req
        self._next_req += 1
        self._pending[req] = (fut, None, None)
        self.matches += len(topics)
        self._send(OP_MATCH, {"r": req, "t": list(topics)})
        return await fut


class _ForwardHook(Hook):
    """Hook forwarding the broker's subscription lifecycle to the
    service."""

    id = "matcher-service-forward"

    def __init__(self, matcher: ServiceMatcher) -> None:
        self.matcher = matcher

    def on_started(self) -> None:
        # fires after _restore_from_storage (which installs persisted
        # subscriptions WITHOUT the subscribe hooks): replay the index
        if self.matcher._reseed is not None:
            self.matcher._reseed(self.matcher)

    def on_subscribed(self, client, packet, reason_codes, counts) -> None:
        for sub, rc in zip(packet.filters, reason_codes):
            if rc < 0x80:
                self.matcher.forward_subscribe(client.id, sub)

    def on_unsubscribed(self, client, packet) -> None:
        for sub in packet.filters:
            self.matcher.forward_unsubscribe(client.id, sub.filter)

    def on_client_expired(self, client) -> None:
        self.matcher.forward_drop(client.id)

    def on_disconnect(self, client, err, expire: bool) -> None:
        # expire-on-disconnect purges the local session immediately
        # (clean sessions); the service must drop those filters too
        if expire:
            self.matcher.forward_drop(client.id)

    def on_session_established(self, client, packet) -> None:
        # clean-start reconnect purged any previous session's filters
        if packet.clean_start and not client.inline:
            self.matcher.forward_drop(client.id)


async def attach_matcher_service(broker, path: str,
                                 supervisor: dict | None = None):
    """Connect to a MatcherService and wire a broker to it: matcher for
    the publish pipeline + hook forwarding subscription ops. The
    broker's CURRENT index contents (e.g. subscriptions restored from
    persistent storage, which bypass the subscribe hooks) are seeded to
    the service at attach time and re-seeded after any reconnect.

    ``supervisor`` (a dict of SupervisedMatcher kwargs, or None to
    attach bare) wraps the broker-facing surface in the ADR-011
    degradation ladder: a dead socket, a hung service, or an errored
    match answers from the broker's own CPU trie within the deadline.
    Returns the attached matcher (the supervisor when wrapped — its
    ServiceMatcher is reachable as ``.inner``, and attribute access
    delegates, so ``forward_*``/stats work on either)."""
    matcher = ServiceMatcher(path)
    matcher.index = broker.topics       # enables the topic cache
    matcher.tracer = broker.tracer      # ADR 017: RPC trace stamps
    await matcher.connect()

    def reseed(m: ServiceMatcher) -> None:
        for cid, sub in broker.topics.walk_subscriptions():
            m.forward_subscribe(cid, sub)

    matcher._reseed = reseed
    reseed(matcher)
    broker.add_hook(_ForwardHook(matcher))
    attach = matcher
    if supervisor is not None:
        from .supervisor import SupervisedMatcher
        attach = SupervisedMatcher(matcher, index=broker.topics,
                                   logger=getattr(broker, "log", None),
                                   **supervisor)
    broker.attach_matcher(attach)
    return attach
