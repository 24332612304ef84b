"""Matcher degradation ladder: deadline → trie hedge → breaker → reprobe.

The device matchers (NFA/sig engines, the MicroBatcher over them, the
ServiceMatcher socket client) degrade to the CPU trie on *row overflow*
— but a device error, a hung kernel, a failed recompile, or a dead
matcher-service socket used to surface as an exception (or a stall)
inside the publish path. The SupervisedMatcher (ADR 011) wraps any of
them so publishes always complete, with results bit-equal to the CPU
trie (the trie is the ground truth every device path already proves
itself against):

1. **Per-batch deadline** — every device/service call is raced against
   ``deadline_ms``; a call that hangs past it is abandoned and the
   batch is answered from the trie (reason="deadline").
2. **Trie hedge on error** — a call that raises is answered from the
   trie (reason="error"); the exception is recorded, never re-raised
   into the publish pipeline.
3. **Circuit breaker** — ``breaker_threshold`` failures within
   ``breaker_window_s`` trip the matcher to trie-only mode
   (reason="breaker_open"): no more device calls, no more hung threads,
   bounded tail latency while the device path is sick.
4. **Half-open reprobe** — after an exponential backoff
   (``backoff_initial_s`` doubling to ``backoff_max_s``) exactly one
   live request is routed to the device as a probe; success closes the
   breaker and restores the device path, failure re-opens it with a
   doubled backoff.

``refresh()`` is crash-safe: a failed recompile keeps serving the
last-good tables (and counts toward the breaker) instead of raising.

Observability: ``breaker_state`` (0 closed / 1 open / 2 half-open),
``fallbacks_by_reason`` (overflow / error / deadline / breaker_open),
``degraded_seconds``, ``breaker_trips``, ``refresh_failures`` — what
the JAX package's metrics.py exports as the ``maxmq_matcher_breaker_*``
family and the reason-labelled ``maxmq_matcher_fallbacks_total``.

Everything else (stats, ``engine``, ``index``, forwarding surfaces,
``close``) delegates to the wrapped matcher, so the supervisor is a
drop-in for ``broker.attach_matcher`` and the metrics bridge.

Copy of the JAX package's ``matching/supervisor.py`` (stdlib only); it
wraps the port's ``MicroBatcher``, engines and ``ServiceMatcher``, whose
device errors raise ``faults.DeviceMatchError`` at the same sites. One
difference: the pipeline deadline leaves out, once and for at most one
more deadline, the time the event loop was held (``SupervisedMatcher``),
which the reference counts against the matcher.
"""

from __future__ import annotations

import asyncio
import collections
import gc
import threading
import time

BREAKER_CLOSED = 0
BREAKER_OPEN = 1
BREAKER_HALF_OPEN = 2

_STATE_NAMES = {BREAKER_CLOSED: "closed", BREAKER_OPEN: "open",
                BREAKER_HALF_OPEN: "half_open"}


_gc_pause = [0.0, 0.0]     # seconds paused so far, start of the current


def _note_gc(phase: str, _info) -> None:
    if phase == "start":
        _gc_pause[1] = time.perf_counter()
    else:
        _gc_pause[0] += time.perf_counter() - _gc_pause[1]


def gc_paused_s() -> float:
    """Seconds the process spent in garbage collections since the first
    supervisor was built (a full collection over a broker holding
    100,000 sessions' inflight windows pauses it ~0.26-0.55 s)."""
    if _note_gc not in gc.callbacks:
        gc.callbacks.append(_note_gc)
    return _gc_pause[0]


class SupervisedMatcher:
    """Wrap ``inner`` (engine / MicroBatcher / ServiceMatcher) in the
    ADR-011 degradation ladder. ``index`` overrides the trie used for
    degraded answers; by default ``inner.index`` serves (exact by
    construction — every engine's ground truth).

    The pipeline deadline (``enqueue``) leaves out, once, the time the
    event loop was held: a deadline timer that fires more than
    ``STALL_GRACE_S`` late, or whose window held that much of
    garbage-collection pause (``gc_paused_s``), re-arms one time for that
    time, at most one further deadline, before it answers from the trie.
    A future therefore resolves within twice the deadline of loop time."""

    # a deadline timer firing later than this (s) found the loop held
    STALL_GRACE_S = 0.05

    def __init__(self, inner, deadline_ms: float = 250.0,
                 breaker_threshold: int = 5,
                 breaker_window_s: float = 10.0,
                 backoff_initial_s: float = 1.0,
                 backoff_max_s: float = 30.0,
                 index=None, logger=None) -> None:
        self.inner = inner
        self.deadline_ms = float(deadline_ms)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_window_s = float(breaker_window_s)
        self.backoff_initial_s = float(backoff_initial_s)
        self.backoff_max_s = float(backoff_max_s)
        self._index = index
        self._log = logger
        self._lock = threading.Lock()
        self._failures: collections.deque[float] = collections.deque()
        self._state = BREAKER_CLOSED
        self._open_until = 0.0
        self._backoff = self.backoff_initial_s
        self._probe_inflight = False
        self._degraded_since: float | None = None
        self._degraded_total = 0.0
        # counters (scraped by the metrics bridge; see fallbacks_by_reason)
        self.deadline_fallbacks = 0
        self.error_fallbacks = 0
        self.breaker_fallbacks = 0
        self.refresh_failures = 0
        self.breaker_trips = 0
        self.breaker_recoveries = 0

    # -- delegation ----------------------------------------------------

    def __getattr__(self, name):
        # only consulted for names NOT defined on this class: stats,
        # engine, forward_* surfaces, close, warm hooks, ... all pass
        # straight through to the wrapped matcher
        if name == "inner":           # unpickling / pre-__init__ access
            raise AttributeError(name)
        if name == "refresh":
            # crash-safe refresh, but ONLY when the inner matcher has
            # one: defining it unconditionally would make duck-typing
            # probes (getattr(matcher, "refresh", None) in the boot
            # compile) call into a refresh-less ServiceMatcher and
            # count a spurious breaker failure on a healthy boot
            inner_refresh = self.inner.refresh  # AttributeError if absent
            return lambda force=False: self._safe_refresh(inner_refresh,
                                                          force)
        return getattr(self.inner, name)

    @property
    def index(self):
        return self._index if self._index is not None \
            else getattr(self.inner, "index", None)

    def _inner_overflow(self) -> int:
        # ``overflow_fallbacks`` lets an inner matcher exclude fallback
        # events the SUPERVISOR already counts: a ServiceMatcher's
        # dead-transport fast-fails surface here as reason="error", so
        # counting its ``fallbacks`` under "overflow" too would both
        # double the total and invent an overflow problem mid-outage
        return int(getattr(self.inner, "overflow_fallbacks",
                           getattr(self.inner, "fallbacks", 0)))

    @property
    def fallbacks(self):
        """Total trie fallbacks, all reasons — the pre-ADR-011 counter
        (see docs/migration.md: split by reason under the hood)."""
        return (self._inner_overflow() + self.deadline_fallbacks
                + self.error_fallbacks + self.breaker_fallbacks)

    @property
    def fallbacks_by_reason(self) -> dict[str, int]:
        return {"overflow": self._inner_overflow(),
                "error": self.error_fallbacks,
                "deadline": self.deadline_fallbacks,
                "breaker_open": self.breaker_fallbacks}

    # -- breaker state machine -----------------------------------------

    @property
    def breaker_state(self) -> int:
        return self._state

    @property
    def breaker_state_name(self) -> str:
        return _STATE_NAMES[self._state]

    @property
    def degraded_seconds(self) -> float:
        """Cumulative wall time spent with the breaker not closed."""
        with self._lock:
            total = self._degraded_total
            if self._degraded_since is not None:
                total += time.monotonic() - self._degraded_since
            return total

    def _admit(self) -> str:
        """Route one call: 'device' (closed), 'probe' (the single
        half-open reprobe), or 'trie' (open / probe already in flight)."""
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return "device"
            now = time.monotonic()
            if self._state == BREAKER_OPEN and now >= self._open_until \
                    and not self._probe_inflight:
                self._state = BREAKER_HALF_OPEN
                self._probe_inflight = True
                return "probe"
            if self._state == BREAKER_HALF_OPEN \
                    and not self._probe_inflight:
                self._probe_inflight = True
                return "probe"
            return "trie"

    def _record_failure(self, probe: bool) -> None:
        with self._lock:
            now = time.monotonic()
            if probe:
                # failed reprobe: back off harder before the next one
                self._probe_inflight = False
                self._backoff = min(self._backoff * 2, self.backoff_max_s)
                self._state = BREAKER_OPEN
                self._open_until = now + self._backoff
                return
            self._failures.append(now)
            cutoff = now - self.breaker_window_s
            while self._failures and self._failures[0] < cutoff:
                self._failures.popleft()
            if self._state == BREAKER_CLOSED \
                    and len(self._failures) >= self.breaker_threshold:
                self._state = BREAKER_OPEN
                self._backoff = self.backoff_initial_s
                self._open_until = now + self._backoff
                self._degraded_since = now
                self.breaker_trips += 1
                self._warn("matcher breaker OPEN: trie-only mode",
                           failures=len(self._failures),
                           backoff_s=self._backoff)

    def _record_success(self, probe: bool) -> None:
        with self._lock:
            if not probe:
                return
            self._probe_inflight = False
            if self._state != BREAKER_CLOSED:
                self._state = BREAKER_CLOSED
                self._failures.clear()
                self._backoff = self.backoff_initial_s
                if self._degraded_since is not None:
                    self._degraded_total += (time.monotonic()
                                             - self._degraded_since)
                    self._degraded_since = None
                self.breaker_recoveries += 1
                self._warn("matcher breaker CLOSED: device path restored")

    def _probe_abort(self) -> None:
        """A probe that was cancelled (shutdown) neither succeeded nor
        failed: release the slot so the next call can reprobe."""
        with self._lock:
            self._probe_inflight = False
            if self._state == BREAKER_HALF_OPEN:
                self._state = BREAKER_OPEN

    def _warn(self, msg: str, **kw) -> None:
        if self._log is not None:
            self._log.warn(msg, **kw)

    # -- degraded answers ----------------------------------------------

    def _trie(self, topic: str):
        idx = self.index
        if idx is None:
            raise RuntimeError(
                "supervised matcher has no index for trie fallback")
        return idx.subscribers(topic)

    def _trie_batch(self, topics: list[str]) -> list:
        idx = self.index
        if idx is None:
            raise RuntimeError(
                "supervised matcher has no index for trie fallback")
        return [idx.subscribers(t) for t in topics]

    # -- crash-safe refresh --------------------------------------------

    def _safe_refresh(self, inner_refresh, force: bool = False):
        """Recompile via the inner engine (exposed as ``refresh`` when
        the inner matcher has one — see __getattr__); a failed
        recompile keeps the last-good tables serving (and counts toward
        the breaker — a device path that can't compile shouldn't keep
        being probed per publish) instead of raising into the caller."""
        try:
            return inner_refresh(force=force)
        except Exception as exc:
            self.refresh_failures += 1
            self._record_failure(probe=False)
            self._warn("matcher recompile failed; serving last-good "
                       "tables", error=repr(exc)[:200])
            return False

    # -- sync surface ---------------------------------------------------

    def subscribers(self, topic: str):
        return self.subscribers_batch([topic])[0]

    def _inner_batch(self, topics: list[str]) -> list:
        fn = getattr(self.inner, "subscribers_batch", None)
        if fn is not None:
            return fn(topics)
        return [self.inner.subscribers(t) for t in topics]

    def _race_deadline(self, topics: list[str]):
        """Run the inner batch in a DAEMON thread raced against the
        deadline: a call that never returns must not block interpreter
        exit (a pooled non-daemon worker would hang the atexit join —
        the exact wedge the deadline exists for), and each timed-out
        call counts as a failure, so the breaker stops spawning these
        long before hung threads accumulate. Returns ("ok", results) |
        ("err", exc) | ("timeout", None)."""
        box: list = []
        done = threading.Event()

        def runner() -> None:
            try:
                box.append(("ok", self._inner_batch(topics)))
            except BaseException as exc:
                box.append(("err", exc))
            finally:
                done.set()

        threading.Thread(target=runner, daemon=True,
                         name="matcher-supervisor").start()
        if not done.wait(self.deadline_ms / 1e3):
            return ("timeout", None)
        return box[0]

    def subscribers_batch(self, topics: list[str]) -> list:
        route = self._admit()
        if route == "trie":
            self.breaker_fallbacks += len(topics)
            return self._trie_batch(topics)
        probe = route == "probe"
        if self.deadline_ms <= 0:
            try:
                results = self._inner_batch(topics)
            except Exception:
                self._record_failure(probe)
                self.error_fallbacks += len(topics)
                return self._trie_batch(topics)
            self._record_success(probe)
            return results
        status, value = self._race_deadline(list(topics))
        if status == "timeout":
            self._record_failure(probe)
            self.deadline_fallbacks += len(topics)
            return self._trie_batch(topics)
        if status == "err":
            self._record_failure(probe)
            self.error_fallbacks += len(topics)
            return self._trie_batch(topics)
        self._record_success(probe)
        return value

    # -- async surface (the broker publish pipeline) --------------------

    def _inner_enqueue(self, topic: str) -> asyncio.Future:
        enq = getattr(self.inner, "enqueue", None)
        if enq is not None:
            return enq(topic)
        sub_async = getattr(self.inner, "subscribers_async", None)
        if sub_async is not None:
            return asyncio.ensure_future(sub_async(topic))
        loop = asyncio.get_running_loop()
        return loop.run_in_executor(None, self.inner.subscribers, topic)

    def enqueue(self, topic: str) -> asyncio.Future:
        """The ADR-006 pipeline surface: returns a future that ALWAYS
        resolves by the deadline, or by twice the deadline where the
        loop was held in its window — device result, or trie answer on
        error / deadline / open breaker."""
        loop = asyncio.get_running_loop()
        out: asyncio.Future = loop.create_future()
        route = self._admit()
        if route == "trie":
            self.breaker_fallbacks += 1
            self._settle_from_trie(out, topic, None)
            return out
        probe = route == "probe"
        try:
            inner = self._inner_enqueue(topic)
        except Exception as exc:
            self._record_failure(probe)
            self.error_fallbacks += 1
            self._settle_from_trie(out, topic, exc)
            return out
        timer = [None]

        def arm(delay: float, rearm: bool) -> None:
            timer[0] = loop.call_later(delay, on_deadline, rearm,
                                       loop.time() + delay, gc_paused_s())

        def on_deadline(rearm: bool, due: float, paused: float) -> None:
            held = loop.time() - due + gc_paused_s() - paused
            if rearm and held > self.STALL_GRACE_S and not out.done():
                # the loop was held (a collection in the window, a long
                # callback past the deadline): the answer may be queued
                # behind this timer, and the stall is not the matcher's.
                # One re-arm, capped at the deadline, so the future still
                # resolves within a fixed bound however often it is held
                arm(min(held, self.deadline_ms / 1e3), False)
                return
            self._on_deadline(out, topic, probe)

        if self.deadline_ms > 0:
            arm(self.deadline_ms / 1e3, True)

        def done(f: asyncio.Future) -> None:
            if timer[0] is not None:
                timer[0].cancel()
            if f.cancelled():
                # shutdown-path cancel, not a device failure
                if probe:
                    self._probe_abort()
                if not out.done():
                    out.cancel()
                return
            exc = f.exception()
            if out.done():
                # late completion after the deadline already answered
                # (or the caller went away): result/exception discarded,
                # failure (if any) was recorded when the deadline fired
                return
            if exc is not None:
                self._record_failure(probe)
                self.error_fallbacks += 1
                self._settle_from_trie(out, topic, exc)
            else:
                self._record_success(probe)
                # forward the ADR-015 dispatch/done clock marks the
                # batcher stamped on ITS future, so the tracer's
                # queue/device split survives the supervisor wrapper
                for attr in ("_t_dispatch", "_t_done"):
                    v = getattr(f, attr, 0)
                    if v:
                        setattr(out, attr, v)
                out.set_result(f.result())

        inner.add_done_callback(done)
        return out

    def _on_deadline(self, out: asyncio.Future, topic: str,
                     probe: bool) -> None:
        if out.done():
            return
        self._record_failure(probe)
        self.deadline_fallbacks += 1
        self._settle_from_trie(out, topic, None)

    def _settle_from_trie(self, out: asyncio.Future, topic: str,
                          cause: Exception | None) -> None:
        try:
            out.set_result(self._trie(topic))
        except Exception:
            out.set_exception(cause if cause is not None else
                              RuntimeError("matcher degraded and no "
                                           "trie index attached"))

    async def subscribers_async(self, topic: str):
        return await self.enqueue(topic)
