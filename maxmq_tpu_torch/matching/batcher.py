"""Micro-batching front end for the device matchers.

Copy of the JAX package's ``matching/batcher.py``, unchanged in
behaviour (the adaptive low-occupancy bypass included).

The device matcher wants large batches (one kernel launch amortized over
many topics); a broker produces one match request per PUBLISH. The
MicroBatcher sits between them: concurrent ``subscribers_async`` calls
coalesce for up to ``window_us`` microseconds (or until ``max_batch``
requests are pending) and go to the device as ONE batch; each caller gets
its own SubscriberSet back. The device dispatch runs in a worker thread
so the asyncio loop keeps serving connections while the card works.

Under light load a request waits at most ``window_us`` (default 200µs);
single-request batches skip the window entirely when nothing else is queued,
keeping p99 latency competitive with the in-process trie (SURVEY §7 "Latency
vs batching").
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import TYPE_CHECKING

from .trie import VersionedTopicCache, subs_version

if TYPE_CHECKING:
    from .trie import SubscriberSet


class MicroBatcher:
    """Coalesces concurrent single-topic match requests into device batches.

    ``engine`` is any matcher exposing ``subscribers_batch(list[str]) ->
    list[SubscriberSet]`` (here: SigEngine).
    """

    # a trie-bypassed batch never exceeds this many topics: the bypass
    # runs inline on the event loop, and the cap bounds its stall even
    # when the measured estimates say bigger would still win
    BYPASS_CAP = 512
    # every Nth eligible batch goes to the device anyway, so the RTT
    # estimate cannot go stale while the bypass is winning
    BYPASS_PROBE_EVERY = 64

    def __init__(self, engine, window_us: int = 200,
                 max_batch: int = 256, pipeline_depth: int = 3,
                 cpu_bypass: bool = True) -> None:
        self.engine = engine
        self.window_us = window_us
        self.max_batch = max_batch
        # adaptive low-occupancy CPU bypass; requires engine.index to be
        # the engine's ground truth (true for every real engine — test
        # fakes that return sentinels must disable)
        self.cpu_bypass = cpu_bypass
        # batches allowed in flight at once. On a high-latency link a
        # single serialized batch makes every queued request wait out
        # the full round trip of the one before it; the sig engine's
        # dispatch/collect split lets batch N+1's upload ride the link
        # while batch N decodes (same depth the bench pipelines at).
        self.pipeline_depth = max(1, pipeline_depth)
        self._pending: list[tuple[str, asyncio.Future]] = []
        # the matcher-mode analog of the broker's trie-path match cache:
        # hot topics repeat, and a version-keyed hit skips tokenize +
        # device round trip entirely
        self._cache = VersionedTopicCache()
        self.cache_hits = 0
        self._wakeup: asyncio.Event | None = None
        self._dispatcher: asyncio.Task | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._inflight: asyncio.Semaphore | None = None
        self._collects: set[asyncio.Task] = set()
        self._lock = threading.Lock()
        # adaptive low-occupancy bypass (VERDICT r03 #2): measured
        # device round-trip EWMA vs measured CPU-trie per-topic cost —
        # a batch whose trie cost undercuts half a device round trip is
        # served inline from the trie, so light load sees trie-class
        # latency while bulk load keeps device-class throughput. None
        # until the first post-warm device sample (the compile-laden
        # first round trip must not poison the estimate).
        self._device_rtt: float | None = None
        self._rtt_samples = 0
        # two host-serving cost models, each updated only from its own
        # measured passes (one blended EWMA mispredicted both ways —
        # batch-size mix made it flap): the trie walk is pure
        # per-topic; the sig host path is fixed per-call (ctypes +
        # numpy glue) plus a small per-topic term. Seeds are the
        # 100K-sub measurements; both adapt.
        self._trie_cost = 100e-6          # seed: ~100us/topic
        self._host_fixed = 90e-6          # seed: ~90us/call
        self._host_per = 5e-6             # seed: ~5us/topic
        self._trie_stale = 0              # host-served passes since the
                                          # last trie cost sample
        self._since_probe = 0
        self._probe_task: asyncio.Task | None = None
        # stats (scraped by the metrics bridge)
        self.batches = 0
        self.batched_topics = 0
        self.largest_batch = 0
        self.bypasses = 0                 # topics served by the bypass
        self.shadow_probes = 0            # bypassed batches duplicated to
                                          # the device (answers dropped)
        self.errors = 0                   # batches whose engine call
                                          # raised (ADR 011 observability)
        # ADR 015: when the broker's PipelineTracer is attached (see
        # bootstrap.build_matcher) and sampling is on, match futures
        # are stamped with dispatch/done clock marks so the tracer can
        # split coalescing wait from device time; off = zero cost
        self.tracer = None

    @property
    def device_rtt(self) -> float:
        """Measured device round-trip EWMA (seconds; 0 until the first
        post-warm sample) — the public face of the bypass estimate,
        scraped by the metrics bridge."""
        return self._device_rtt or 0.0

    # Delegate the sync surface so the batcher is a drop-in matcher.
    def subscribers(self, topic: str) -> "SubscriberSet":
        return self.engine.subscribers(topic)

    def subscribers_batch(self, topics: list[str]) -> "list[SubscriberSet]":
        return self._batch_fn(topics)

    @property
    def _batch_fn(self):
        """Prefer the engine's fixed-slot path (fewest bytes/kernels per
        micro-batch) when it has one (SigEngine)."""
        return getattr(self.engine, "subscribers_fixed_batch",
                       self.engine.subscribers_batch)

    def refresh(self, force: bool = False):
        return self.engine.refresh(force=force)

    @property
    def matches(self):
        return getattr(self.engine, "matches", 0)

    @property
    def fallbacks(self):
        return getattr(self.engine, "fallbacks", 0)

    @property
    def index(self):
        return self.engine.index

    # ------------------------------------------------------------------

    def enqueue(self, topic: str) -> asyncio.Future:
        """Queue one match WITHOUT awaiting it: returns the future that
        resolves when its micro-batch comes back. The broker's publish
        pipeline uses this to keep hundreds of publishes in flight from
        one connection's read loop — in-flight count, not connection
        count, is what sizes the device batches."""
        loop = asyncio.get_running_loop()
        if self._dispatcher is None or self._loop is not loop:
            self._start(loop)
        fut: asyncio.Future = loop.create_future()
        hit = self._cache.get(topic, self._subs_version())
        if hit is not None:
            self.cache_hits += 1
            fut.set_result(hit)
            return fut
        self._pending.append((topic, fut))
        self._wakeup.set()
        return fut

    def _subs_version(self) -> int:
        return subs_version(self.engine.index)

    def _fill_cache(self, version: int, batch, results) -> None:
        for (topic, _), result in zip(batch, results):
            self._cache.put(topic, version, result)

    def _settle(self, version: int, batch, results) -> None:
        """Cache + resolve one batch's futures, stamping the ADR-015
        result-ready mark when tracing is on (the tracer's device span
        ends at result-ready, not at the consumer's in-order await)."""
        self._fill_cache(version, batch, results)
        tracer = self.tracer
        done_ns = (tracer.clock()
                   if tracer is not None and tracer.sample_n else 0)
        for (_, fut), result in zip(batch, results):
            if not fut.done():
                if done_ns:
                    fut._t_done = done_ns
                fut.set_result(result)

    async def subscribers_async(self, topic: str) -> "SubscriberSet":
        """Queue one match; resolves when its micro-batch returns."""
        return await self.enqueue(topic)

    def _start(self, loop: asyncio.AbstractEventLoop) -> None:
        self._loop = loop
        self._wakeup = asyncio.Event()
        self._inflight = asyncio.Semaphore(self.pipeline_depth)
        self._dispatcher = loop.create_task(self._run(), name="match-batcher")

    async def close(self) -> None:
        if self._probe_task is not None:
            self._probe_task.cancel()
            try:
                await self._probe_task
            except (asyncio.CancelledError, Exception):
                pass
            self._probe_task = None
        if self._dispatcher is not None:
            self._dispatcher.cancel()
            try:
                await self._dispatcher
            except (asyncio.CancelledError, Exception):
                pass
            self._dispatcher = None
        for task in list(self._collects):
            task.cancel()
        for task in list(self._collects):
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self._collects.clear()
        for _, fut in self._pending:
            if not fut.done():
                fut.cancel()
        self._pending.clear()
        # wait out any in-flight background table recompile: tearing the
        # process down mid-compile aborts inside the runtime library
        close_fn = getattr(self.engine, "close", None)
        if close_fn is not None:
            await asyncio.get_running_loop().run_in_executor(None, close_fn)

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        # pipelined mode needs the engine's dispatch/collect split
        # (SigEngine's fixed path); other engines run one batch at a
        # time through their whole-batch function
        split = (hasattr(self.engine, "dispatch_fixed")
                 and hasattr(self.engine, "collect_fixed")
                 and self.pipeline_depth > 1)
        while True:
            await self._wakeup.wait()
            self._wakeup.clear()
            if not self._pending:
                continue
            await self._maybe_window()
            batch, self._pending = (self._pending[:self.max_batch],
                                    self._pending[self.max_batch:])
            if self._pending:
                self._wakeup.set()  # leftovers form the next batch
            topics = [t for t, _ in batch]
            self._note_batch(batch)
            ver = self._subs_version()   # results valid as-of dispatch
            if self._should_bypass(len(batch)):
                self._run_bypass(batch, topics, ver)
            elif split and not self._engine_routes():
                await self._dispatch_pipelined(loop, batch, topics, ver)
            else:
                await self._run_whole_batch(loop, batch, topics, ver)

    def _note_batch(self, batch) -> None:
        """Batch-size counters + the ADR-015 dispatch marks (the
        coalescing-wait span ends for every future in the batch)."""
        self.batches += 1
        self.batched_topics += len(batch)
        self.largest_batch = max(self.largest_batch, len(batch))
        tracer = self.tracer
        if tracer is not None and tracer.sample_n:
            now = tracer.clock()
            for _, fut in batch:
                fut._t_dispatch = now

    async def _maybe_window(self) -> None:
        """Adaptive coalescing window: waiting only pays when the device
        is already busy (arrivals during a flight pile up anyway) AND
        the batch will actually go to the device — when the bypass will
        take it, or nothing is in flight, waiting just adds latency."""
        if (len(self._pending) < self.max_batch and self.window_us > 0
                and not self._should_bypass(len(self._pending))
                and self._inflight._value < self.pipeline_depth):
            await asyncio.sleep(self.window_us / 1e6)

    def _engine_routes(self) -> bool:
        """ADR-008 routed corpora serve via the engine's whole-batch
        surface (which answers from its trie); dispatch_fixed would
        force the device round trip the router rejected."""
        routes = getattr(self.engine, "_routes_to_trie", None)
        return routes is not None and routes()

    # -- adaptive CPU bypass -------------------------------------------

    def _host_est(self, n: int) -> float:
        """Predicted cost of serving ``n`` topics via the engine's
        device-free sig path (fixed per-call + per-topic)."""
        return self._host_fixed + n * self._host_per

    def _bypass_cost(self, n: int) -> float:
        """Cheapest host-serving cost for ``n`` topics — the same
        min() _run_bypass takes, so prediction and execution agree."""
        if getattr(self.engine, "subscribers_host_batch", None) is None:
            return n * self._trie_cost
        return min(n * self._trie_cost, self._host_est(n))

    def _should_bypass(self, n: int) -> bool:
        """True when serving ``n`` topics inline on the host (trie or
        sig host path, whichever is measured-cheaper) undercuts half a
        device round trip. RTT-estimate refresh rides SHADOW probes
        (background duplicates of bypassed batches), never the caller
        path — a p99 budget of 25ms cannot absorb a periodic full
        round trip."""
        if not self.cpu_bypass or n > self.BYPASS_CAP \
                or self._device_rtt is None:
            return False
        return self._bypass_cost(n) < 0.5 * self._device_rtt

    def _run_bypass(self, batch, topics, ver) -> None:
        """Serve one small batch on the host, inline on the loop
        (bounded by BYPASS_CAP x per-topic cost), updating whichever
        cost model served it. Engines exposing the device-free probe
        path (subscribers_host_batch: exact/'+'/'#' signature probes +
        the same C decode) serve from it when its fixed+per-topic
        estimate undercuts the trie's per-topic one (tiny batches over
        small corpora are the trie's remaining win); others always
        walk the CPU trie."""
        n = len(topics)
        host = self._pick_bypass_host(n)
        t0 = time.perf_counter()
        try:
            results = (host(topics) if host is not None else
                       [self.engine.index.subscribers(t) for t in topics])
        except Exception as exc:
            self.errors += 1
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(exc)
            return
        self._update_cost_model(host is not None, n,
                                time.perf_counter() - t0)
        self._since_probe += 1
        self.bypasses += len(topics)
        self._settle(ver, batch, results)
        if self._since_probe >= self.BYPASS_PROBE_EVERY:
            self._shadow_probe(topics)

    def _pick_bypass_host(self, n: int):
        """The engine's device-free probe path when its fixed+per-topic
        estimate undercuts the trie's, else None (trie serves). Tiny
        batches periodically re-sample the trie so a winning host path
        cannot let the trie estimate go stale."""
        host = getattr(self.engine, "subscribers_host_batch", None)
        if host is None:
            return None
        if n * self._trie_cost < self._host_est(n):
            return None
        if n <= 8 and self._trie_stale >= 64:
            self._trie_stale = 0
            return None
        return host

    def _update_cost_model(self, via_host: bool, n: int,
                           took: float) -> None:
        """Fold one bypass timing into whichever path served it. The
        host path keeps a two-parameter model: big batches pin the
        per-topic slope, small ones the per-call intercept."""
        if via_host:
            if n >= 16:
                self._host_per += 0.3 * (
                    (took - self._host_fixed) / n - self._host_per)
            else:
                self._host_fixed += 0.3 * (
                    max(took - n * self._host_per, 0.0)
                    - self._host_fixed)
            self._trie_stale += 1
        else:
            self._trie_cost += 0.3 * (took / max(1, n) - self._trie_cost)
            self._trie_stale = 0

    def _shadow_probe(self, topics) -> None:
        """Duplicate one bypassed batch to the device in the background
        purely to refresh the RTT estimate — no caller waits on it."""
        if self._probe_task is not None and not self._probe_task.done():
            return
        self._since_probe = 0
        self.shadow_probes += 1

        async def probe() -> None:
            loop = asyncio.get_running_loop()
            t0 = time.perf_counter()
            try:
                await loop.run_in_executor(None, self._batch_fn,
                                           list(topics))
            except Exception:
                return                     # estimate keeps its last value
            self._note_rtt(time.perf_counter() - t0)

        self._probe_task = self._loop.create_task(probe())

    def _note_rtt(self, sample: float) -> None:
        """Record one device round-trip sample (dispatch->collect).
        The first sample carries the XLA compile and is discarded."""
        self._rtt_samples += 1
        self._since_probe = 0
        if self._rtt_samples <= 1:
            return
        if self._device_rtt is None:
            self._device_rtt = sample
        else:
            self._device_rtt += 0.3 * (sample - self._device_rtt)

    async def _run_whole_batch(self, loop, batch, topics, ver) -> None:
        t0 = time.perf_counter()
        try:
            # worker thread: overlap device time with the event loop
            results = await loop.run_in_executor(
                None, self._batch_fn, topics)
        except Exception as exc:  # engine failure → fail the callers
            self.errors += 1      # (the ADR-011 supervisor above us
            for _, fut in batch:  # answers them from the CPU trie)
                if not fut.done():
                    fut.set_exception(exc)
            return
        self._note_rtt(time.perf_counter() - t0)
        self._settle(ver, batch, results)

    async def _dispatch_pipelined(self, loop, batch, topics, ver) -> None:
        """Dispatch now, collect in a bounded background task: up to
        ``pipeline_depth`` batches ride the device/link concurrently, so
        a queued request no longer waits out the FULL round trip of the
        batch ahead of it."""
        await self._inflight.acquire()
        # timestamp AFTER the semaphore: under saturation the wait for a
        # pipeline slot is queueing, not round-trip, and folding it into
        # the RTT EWMA would inflate the bypass threshold
        t0 = time.perf_counter()
        try:
            ctx = await loop.run_in_executor(
                None, self.engine.dispatch_fixed, topics)
        except asyncio.CancelledError:
            self._inflight.release()
            self._cancel_futures(batch)
            raise
        except Exception:
            # dispatch refused (device matching disabled for this
            # corpus, resync, table swap): the whole-batch path keeps
            # its CPU-trie fallback semantics — never fail the callers
            # for a condition the engine degrades through
            self._inflight.release()
            await self._run_whole_batch(loop, batch, topics, ver)
            return
        task = loop.create_task(
            self._collect(loop, batch, topics, ctx, ver, t0))
        self._collects.add(task)
        task.add_done_callback(self._collects.discard)

    async def _collect(self, loop, batch, topics, ctx, ver, t0) -> None:
        try:
            results = await loop.run_in_executor(
                None, self.engine.collect_fixed, topics, ctx)
        except asyncio.CancelledError:
            self._cancel_futures(batch)
            raise
        except Exception:
            # same degradation contract as dispatch failures
            self.errors += 1
            results = None
        finally:
            self._inflight.release()
        if results is None:
            await self._run_whole_batch(loop, batch, topics, ver)
            return
        self._note_rtt(time.perf_counter() - t0)
        self._settle(ver, batch, results)

    @staticmethod
    def _cancel_futures(batch) -> None:
        for _, fut in batch:
            if not fut.done():
                fut.cancel()
