"""Write-behind journal for the persistence pipeline (ADR 014).

The seed storage hook fsynced SQLite on the broker's asyncio loop for
every QoS1 publish/ack/retain event — durability policy was "pay a
disk flush per message, on the event loop". :class:`WriteBehindStore`
puts a bounded, byte-accounted journal between the hook's writes and
the real store: the event loop only appends to an in-memory op queue
(O(dict insert)), and a dedicated writer thread drains it in *group
commits* — one backend transaction per batch of ops, one fsync per
transaction. Durability is a policy, not an accident:

* ``always``  — QoS acks are released through a *durability barrier*:
  the broker asks for a barrier future after a publish's writes are
  enqueued, and the ack goes out only once the writer thread has
  committed past them. Group commit still applies (everything that
  accumulated during the previous fsync rides the next one), so
  throughput scales with concurrent publishers instead of being
  serialized at one fsync per message.
* ``batched`` — writes commit every ``batch_ms``/``batch_ops``; acks
  release immediately. A crash can lose up to the configured window
  of ACKED traffic (documented in docs/adr/014).
* ``off``     — same write path, but the backend is opened without
  synchronous flushing (SQLite ``synchronous=OFF``); survives process
  crashes, not power loss.

Storage degradation ladder (the ADR 011/012 discipline for disks):
consecutive *commit* failures trip a circuit breaker — the journal
stops burning the writer thread on a dead backend and keeps accepting
writes in memory (the parked journal) with ``dirty`` set; after a
capped-exponential backoff a half-open reprobe commits one small
batch, and on success the parked journal replays in order. Barriers
never wedge the broker: opening the breaker releases every pending
barrier (availability over durability, loudly counted), and new
barriers while degraded resolve immediately.

Same-key writes *coalesce in place* (a retained topic republished at
1Hz costs one queued op, not one per publish), so the queue grows with
distinct keys touched since the last commit, not with write rate. The
byte budget (``queue_bytes``) is a watermark, not a hard drop line:
QoS1-relevant ops are never discarded here — above the watermark the
StorageHook sheds QoS0-irrelevant rewrites (hooks/storage.py) and
``overflows`` counts what still lands past it.

Disk-failure classes (ADR 024) get their own ladder rungs on top of
the generic breaker:

* **fsync failure poisons the connection** (fsyncgate): after a failed
  flush the backend's dirty-page state is unknown — retrying the
  commit on the same handle could "succeed" against pages the kernel
  already dropped. The journal marks the backend poisoned, trips the
  breaker immediately, and the half-open reprobe REOPENS the backend
  before replaying the parked journal (replay is idempotent same-key
  upserts, so anything that did reach the platter commits again,
  harmlessly).
* **ENOSPC is not transient**: a full volume won't heal by politely
  retrying the same batch, so the breaker trips on the FIRST ENOSPC
  (no threshold wait), ``disk_full`` raises the QoS0-irrelevant
  rewrite shed rung in hooks/storage.py regardless of broker load,
  and barriers release degraded (ADR-011 availability over
  durability) until a commit succeeds again.

Fault sites (faults.py): ``storage.put`` at the enqueue boundary,
``storage.commit`` in the writer thread (hang mode sleeps the WRITER,
never the loop — which is the point), ``storage.restore`` in the
hook's per-record restore parse, plus the backend-level ``disk.*``
family via hooks/faultstore.py. Crash points (ADR 024):
``crash.at#pre_fsync`` / ``crash.at#post_fsync_pre_ack`` bracket the
group commit — the two instants whose durability semantics differ.

Copy of the JAX package's ``hooks/journal.py``.
"""

from __future__ import annotations

import errno
import heapq
import itertools
import logging
import threading
import time
from collections import deque

from .. import faults
from .faultstore import FsyncFailed
from .storage import Store

_OP_PUT = "put"
_OP_DELETE = "delete"
_OP_DELETE_PREFIX = "delete_prefix"

# breaker states (numeric for the gauge, mirroring the ADR-011 matcher
# breaker's exposition: 0 closed, 1 open, 2 half-open)
BREAKER_CLOSED = 0
BREAKER_OPEN = 1
BREAKER_HALF_OPEN = 2

# map the storage_sync policy onto SQLite's synchronous pragma: the
# group commit supplies the batching; the pragma decides whether each
# commit reaches the platter before the transaction returns
SQLITE_SYNC_BY_POLICY = {"always": "FULL", "batched": "FULL", "off": "OFF"}

POLICIES = ("always", "batched", "off")


def classify_commit_failure(exc: Exception) -> str:
    """Sort a commit failure into its ladder rung (ADR 024):
    ``"fsync"`` (poison + reopen), ``"enospc"`` (immediate breaker +
    disk-full shed), or ``"other"`` (the generic consecutive-failure
    breaker). Recognizes both the injected ``disk.*`` shapes and what
    the real backends raise — sqlite3 reports a full volume as
    OperationalError("database or disk is full")."""
    if isinstance(exc, FsyncFailed):
        return "fsync"
    if isinstance(exc, OSError) and exc.errno == errno.ENOSPC:
        return "enospc"
    msg = str(exc).lower()
    if "disk is full" in msg or "no space left" in msg:
        return "enospc"
    if "fsync" in msg:
        return "fsync"
    return "other"


class _Op:
    __slots__ = ("seq", "kind", "bucket", "key", "value", "size")

    def __init__(self, seq: int, kind: str, bucket: str, key: str,
                 value: str | None, size: int) -> None:
        self.seq = seq
        self.kind = kind
        self.bucket = bucket
        self.key = key
        self.value = value
        self.size = size


def _op_size(bucket: str, key: str, value: str | None) -> int:
    # 64 covers the _Op object + dict/deque slots; precision doesn't
    # matter, monotonicity with payload size does
    return len(bucket) + len(key) + (len(value) if value else 0) + 64


class WriteBehindStore(Store):
    """A :class:`Store` that journals writes in memory and drains them
    to ``inner`` from a dedicated writer thread with group commit.

    Reads (``get``/``all``) overlay the pending journal on the inner
    store, so a restore that races an unflushed shutdown still sees
    every write. All counters are plain ints read tear-free by the
    metrics scrape thread (the SysInfo contract)."""

    def __init__(self, inner: Store, *, policy: str = "batched",
                 batch_ms: int = 20, batch_ops: int = 512,
                 queue_bytes: int = 4 << 20,
                 breaker_threshold: int = 5,
                 backoff_s: float = 1.0, backoff_max_s: float = 30.0,
                 logger=None) -> None:
        if policy not in POLICIES:
            raise ValueError(f"unknown storage_sync policy {policy!r} "
                             f"(want one of {POLICIES})")
        self.inner = inner
        self.policy = policy
        self.batch_ms = max(int(batch_ms), 0)
        self.batch_ops = max(int(batch_ops), 1)
        self.queue_bytes = max(int(queue_bytes), 0)
        self.breaker_threshold = max(int(breaker_threshold), 1)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.log = logger or logging.getLogger("maxmq.storage")

        self._lock = threading.Lock()
        self._work = threading.Event()
        self._order: deque[_Op] = deque()
        self._pending: dict[tuple[str, str], _Op] = {}
        # last seq at which each bucket saw a delete_prefix: a same-key
        # put AFTER a pending prefix delete must not coalesce into an
        # op that would apply BEFORE it
        self._prefix_seq: dict[str, int] = {}
        self._seq = 0
        self.committed_seq = 0
        self._barriers: list[tuple[int, int, object, object]] = []
        self._bar_count = itertools.count()

        # -- observability (maxmq_storage_* + $SYS/broker/storage/*) --
        self.queued_bytes_now = 0
        self.commits = 0
        self.commit_failures = 0
        self.put_failures = 0
        self.ops_written = 0
        self.coalesced = 0
        self.overflows = 0
        self.barrier_waits = 0
        self.barriers_released_degraded = 0
        self.last_batch_ops = 0
        self.largest_batch_ops = 0
        self.last_commit_s = 0.0
        self.commit_seconds_total = 0.0
        self.dirty = False              # a write was lost or parked past
                                        # its durability promise

        # -- disk-failure ladder rungs (ADR 024) -----------------------
        self.fsync_failures = 0         # commits whose flush failed
        self.enospc_failures = 0        # commits refused by a full disk
        self.backend_reopens = 0        # poisoned connections reopened
        self.disk_full = False          # last failure was ENOSPC and no
                                        # commit has succeeded since —
                                        # raises the storage hook's
                                        # rewrite-shed rung unconditionally
        self._poisoned = False          # fsync failed: the backend must
                                        # be reopened before any retry

        # -- breaker ---------------------------------------------------
        self.breaker_state = BREAKER_CLOSED
        self.breaker_trips = 0
        self.breaker_recoveries = 0
        self._consecutive_failures = 0
        self._cur_backoff = self.backoff_s
        self._reprobe_at = 0.0
        self._degraded_since = 0.0
        self._degraded_seconds = 0.0

        # ADR 015: broker.serve() attaches its PipelineTracer here so
        # the WRITER THREAD can feed the journal_commit stage histogram
        # and attribute commit/put failures to the journal stage
        self.tracer = None

        self._stopped = False
        self._final_probe_done = False
        self._thread = threading.Thread(
            target=self._writer_loop, name="storage-journal", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    # Store interface (event-loop side: never blocks on the backend)
    # ------------------------------------------------------------------

    def put(self, bucket: str, key: str, value: str) -> None:
        try:
            faults.fire(faults.STORAGE_PUT)
        except faults.InjectedFault:
            self.put_failures += 1
            self.dirty = True
            if self.tracer is not None:
                self.tracer.note_error("journal_commit", "put_failed")
            return
        self._enqueue(_OP_PUT, bucket, key, value)

    def delete(self, bucket: str, key: str) -> None:
        self._enqueue(_OP_DELETE, bucket, key, None)

    def delete_prefix(self, bucket: str, prefix: str) -> None:
        self._enqueue(_OP_DELETE_PREFIX, bucket, prefix, None)

    def get(self, bucket: str, key: str) -> str | None:
        with self._lock:
            ops = [op for op in self._order if op.bucket == bucket]
        value = self.inner.get(bucket, key)
        for op in ops:
            if op.kind == _OP_DELETE_PREFIX:
                if key.startswith(op.key):
                    value = None
            elif op.key == key:
                value = op.value if op.kind == _OP_PUT else None
        return value

    def all(self, bucket: str) -> dict[str, str]:
        # snapshot the overlay FIRST: an op the writer commits between
        # the two reads is then applied twice, which is idempotent —
        # the reverse order would lose it entirely
        with self._lock:
            ops = [op for op in self._order if op.bucket == bucket]
        data = self.inner.all(bucket)
        for op in ops:
            if op.kind == _OP_PUT:
                data[op.key] = op.value
            elif op.kind == _OP_DELETE:
                data.pop(op.key, None)
            else:
                for k in [k for k in data if k.startswith(op.key)]:
                    del data[k]
        return data

    def close(self) -> None:
        """Flush what the backend will take, stop the writer, close the
        backend. A breaker stuck open gets one forced final attempt; a
        still-dead backend loses the parked journal LOUDLY."""
        self._stopped = True
        self._work.set()
        self._thread.join(timeout=10.0)
        with self._lock:
            lost = len(self._order)
        if lost:
            self.dirty = True
            self.log.error(
                "storage journal closed with %d uncommitted ops "
                "(backend unavailable); parked writes lost", lost)
        self.inner.close()

    # ------------------------------------------------------------------
    # Journal plumbing
    # ------------------------------------------------------------------

    def _enqueue(self, kind: str, bucket: str, key: str,
                 value: str | None) -> None:
        size = _op_size(bucket, key, value)
        wake = False
        with self._lock:
            if kind == _OP_DELETE_PREFIX:
                self._seq += 1
                self._prefix_seq[bucket] = self._seq
                op = _Op(self._seq, kind, bucket, key, None, size)
                self._order.append(op)
                self.queued_bytes_now += size
            else:
                prev = self._pending.get((bucket, key))
                if (prev is not None
                        and prev.seq > self._prefix_seq.get(bucket, 0)):
                    # coalesce in place: the queued op keeps its seq
                    # (so barriers taken before this write still cover
                    # it — the newer value commits at the OLD position)
                    self.queued_bytes_now += size - prev.size
                    prev.kind, prev.value, prev.size = kind, value, size
                    self.coalesced += 1
                else:
                    self._seq += 1
                    op = _Op(self._seq, kind, bucket, key, value, size)
                    self._order.append(op)
                    self._pending[(bucket, key)] = op
                    self.queued_bytes_now += size
            if self.queue_bytes and self.queued_bytes_now > self.queue_bytes:
                self.overflows += 1
            wake = True
        if wake:
            self._work.set()

    @property
    def over_watermark(self) -> bool:
        """True when the journal sits past its byte budget — the signal
        hooks/storage.py uses to shed QoS0-irrelevant rewrites."""
        return bool(self.queue_bytes
                    and self.queued_bytes_now > self.queue_bytes)

    @property
    def queue_depth(self) -> int:
        return len(self._order)

    @property
    def degraded_seconds(self) -> float:
        extra = (time.monotonic() - self._degraded_since
                 if self.breaker_state != BREAKER_CLOSED else 0.0)
        return self._degraded_seconds + extra

    # -- durability barrier --------------------------------------------

    @property
    def barrier_needed(self) -> bool:
        """True when QoS acks must wait on a durability barrier
        (``storage_sync=always``). ``batched``/``off`` release acks
        immediately; what that can lose is ADR-014 documented."""
        return self.policy == "always"

    def barrier(self, loop):
        """An asyncio future resolved once everything enqueued so far is
        durable, or ``None`` when no wait is required (non-``always``
        policy, an idle journal, or a degraded breaker — a dead disk
        must not become a dead broker)."""
        if self.policy != "always":
            return None
        with self._lock:
            if self.breaker_state != BREAKER_CLOSED:
                self.dirty = True
                return None
            if not self._order and self.committed_seq >= self._seq:
                return None
            fut = loop.create_future()
            heapq.heappush(self._barriers,
                           (self._seq, next(self._bar_count), fut, loop))
            self.barrier_waits += 1
        self._work.set()
        return fut

    def flush(self, timeout: float = 5.0) -> bool:
        """Block (caller's thread) until the journal is fully committed;
        boot-time only (boot_epoch durability) — never on the loop while
        serving. False on timeout or a degraded backend."""
        self._work.set()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._order and self.committed_seq >= self._seq:
                    return True
                if self.breaker_state == BREAKER_OPEN:
                    return False
            time.sleep(0.002)
        return False

    def _resolve_barriers_locked(self, up_to_seq: int | None,
                                 degraded: bool = False) -> None:
        """Release barriers ≤ ``up_to_seq`` (None = all). Runs under
        the lock; resolution hops to each barrier's loop thread."""
        while self._barriers and (up_to_seq is None
                                  or self._barriers[0][0] <= up_to_seq):
            _seq, _n, fut, loop = heapq.heappop(self._barriers)
            if degraded:
                self.barriers_released_degraded += 1

            def _set(f=fut):
                if not f.done():
                    f.set_result(None)
            try:
                loop.call_soon_threadsafe(_set)
            except RuntimeError:
                pass    # loop already closed; nothing waits anymore

    # ------------------------------------------------------------------
    # Writer thread: group commit + breaker
    # ------------------------------------------------------------------

    def _writer_loop(self) -> None:
        while True:
            try:
                if not self._writer_turn():
                    return
            except Exception:       # the journal must outlive surprises
                self.log.exception("storage journal writer turn failed")
                time.sleep(0.05)

    def _writer_turn(self) -> bool:
        """One scheduling turn: wait for work, honor the breaker's
        backoff, drain one group commit. False = thread exits."""
        with self._lock:
            empty = not self._order
        if empty:
            if self._stopped:
                return False
            self._work.wait(timeout=0.2)
            self._work.clear()
            return True
        now = time.monotonic()
        if self.breaker_state == BREAKER_OPEN:
            if self._stopped:
                # close() grants ONE final reprobe; a still-dead
                # backend must not spin this thread forever
                if self._final_probe_done:
                    return False
                self._final_probe_done = True
            elif now < self._reprobe_at:
                self._work.wait(timeout=min(0.05, self._reprobe_at - now))
                self._work.clear()
                return True
            self.breaker_state = BREAKER_HALF_OPEN  # reprobe window
        elif (self.policy != "always" and self.batch_ms > 0
                and not self._stopped):
            # accumulate a batch window; `always` drains eagerly (group
            # commit forms naturally from whatever arrived mid-fsync)
            time.sleep(self.batch_ms / 1000.0)
        self._commit_batch()
        return True

    def _take_batch_locked(self, n: int) -> list[_Op]:
        batch: list[_Op] = []
        while self._order and len(batch) < n:
            op = self._order.popleft()
            batch.append(op)
            if (op.kind != _OP_DELETE_PREFIX
                    and self._pending.get((op.bucket, op.key)) is op):
                del self._pending[(op.bucket, op.key)]
        return batch

    def _commit_batch(self) -> None:
        # half-open probes with ONE op: a reprobe against a dead backend
        # should cost one failure, not re-fail the whole parked journal
        n = 1 if self.breaker_state == BREAKER_HALF_OPEN else self.batch_ops
        with self._lock:
            batch = self._take_batch_locked(n)
        if not batch:
            return
        t0 = time.perf_counter()
        try:
            faults.fire(faults.STORAGE_COMMIT)
            if self._poisoned:
                # fsyncgate discipline (ADR 024): never retry on the
                # handle whose flush failed — reopen first, then the
                # parked journal replays through the fresh connection
                self._reopen_poisoned()
            faults.crash_point("pre_fsync")
            self.inner.apply_batch(
                [(op.kind, op.bucket, op.key, op.value) for op in batch])
            faults.crash_point("post_fsync_pre_ack")
        except Exception as exc:
            self._commit_failed(batch, exc)
            return
        dt = time.perf_counter() - t0
        if self.tracer is not None:
            # ADR 015: group-commit duration, observed from the writer
            # thread (histogram-only: a commit covers many publishes)
            self.tracer.observe("journal_commit", dt)
            # ADR 017 (closing ADR-015's per-op attribution item): the
            # same commit attributed to each storage bucket it touched,
            # so "which writes own the fsync time" is answerable
            for bucket in {op.bucket for op in batch}:
                self.tracer.observe_journal(bucket, dt)
        with self._lock:
            self.committed_seq = max(self.committed_seq, batch[-1].seq)
            self.queued_bytes_now -= sum(op.size for op in batch)
            self._resolve_barriers_locked(self.committed_seq)
            self.commits += 1
            self.ops_written += len(batch)
            self.last_batch_ops = len(batch)
            self.largest_batch_ops = max(self.largest_batch_ops, len(batch))
            self.last_commit_s = dt
            self.commit_seconds_total += dt
            if self.breaker_state != BREAKER_CLOSED:
                # half-open reprobe succeeded: close, and the normal
                # drain (next turns) replays the parked journal in order
                self.breaker_state = BREAKER_CLOSED
                self.breaker_recoveries += 1
                self._degraded_seconds += time.monotonic() - self._degraded_since
                self._cur_backoff = self.backoff_s
            self._consecutive_failures = 0
            if self.disk_full:
                self.disk_full = False      # space came back; rung down
                self.log.warning("storage disk-full condition cleared "
                                 "(commit succeeded)")

    def _reopen_poisoned(self) -> None:
        """Swap the poisoned backend connection for a fresh one (ADR
        024). Raises on failure — the caller's commit then fails and
        the breaker/backoff machinery owns the retry cadence. A backend
        without ``reopen`` (bare MemoryStore in tests) just clears the
        poison: it has no kernel page cache to distrust."""
        reopen = getattr(self.inner, "reopen", None)
        if reopen is not None:
            reopen()
            self.backend_reopens += 1
        self._poisoned = False
        self.log.warning("storage backend reopened after fsync failure; "
                         "replaying %d parked ops", self.queue_depth)

    def _commit_failed(self, batch: list[_Op], exc: Exception) -> None:
        if self.tracer is not None:
            self.tracer.note_error("journal_commit", "commit_failed")
        failure_class = classify_commit_failure(exc)
        with self._lock:
            # park the batch back at the FRONT, preserving op order; a
            # same-key write enqueued while the commit ran owns
            # _pending already and must keep it (it is newer)
            self._order.extendleft(reversed(batch))
            for op in batch:
                key = (op.bucket, op.key)
                if op.kind != _OP_DELETE_PREFIX and key not in self._pending:
                    self._pending[key] = op
            self.commit_failures += 1
            self._consecutive_failures += 1
            self.dirty = True
            if failure_class == "fsync":
                # fsyncgate: the handle is now untrustworthy — poison
                # it and trip immediately; the reprobe reopens first
                self.fsync_failures += 1
                self._poisoned = True
            elif failure_class == "enospc":
                # a full disk is a state, not a blip: no point burning
                # threshold-many retries against it
                self.enospc_failures += 1
                self.disk_full = True
            tripped = (self.breaker_state == BREAKER_HALF_OPEN
                       or failure_class in ("fsync", "enospc")
                       or self._consecutive_failures >= self.breaker_threshold)
            if tripped:
                if self.breaker_state == BREAKER_CLOSED:
                    self._degraded_since = time.monotonic()
                self.breaker_state = BREAKER_OPEN
                self.breaker_trips += 1
                self._reprobe_at = time.monotonic() + self._cur_backoff
                self._cur_backoff = min(self._cur_backoff * 2,
                                        self.backoff_max_s)
                # a barrier must never outlive the durability it was
                # promised: release them all, loudly, and stay dirty
                self._resolve_barriers_locked(None, degraded=True)
        self.log.error("storage commit failed (%s, %d consecutive): %r",
                       failure_class, self._consecutive_failures, exc)
