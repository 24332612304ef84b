"""Disk-fault injection shim for the storage backend (ADR 024).

The ADR-014 fault sites (``storage.put``/``storage.commit``) raise
generic Python exceptions at the JOURNAL's boundaries — useful for
breaker drills, useless for answering "what does the pipeline do when
the DISK says EIO / ENOSPC / fsync-failed". :class:`FaultInjectingStore`
wraps the real backend (SQLite or memory) so the ``disk.*`` fault
family (faults.py) surfaces as the OS errors a dying disk produces,
from the exact layer that would produce them:

* ``disk.write``   — the write/commit raises ``OSError(EIO)``: a bad
  sector / failed block write. Retryable; the journal's breaker ladder
  handles it like any commit failure.
* ``disk.enospc``  — ``DiskFull`` (``OSError(ENOSPC)``): the volume is
  full. NOT retryable by waiting politely — the journal trips its
  breaker immediately and sheds QoS0-irrelevant rewrites (its own
  ladder rung, journal.py).
* ``disk.fsync``   — ``FsyncFailed`` raised AFTER the inner commit ran:
  the write(2)s landed but the flush failed, so dirty-page state is
  unknown (fsyncgate). The journal must treat the connection as
  POISONED — reopen the backend and replay the parked journal rather
  than assume anything survived. Replays are idempotent (same-key
  upserts), so a batch that DID reach the platter commits twice,
  harmlessly.
* ``disk.latency`` — arm with ``hang`` mode: the registry sleeps the
  writer thread for ``delay_s`` (commit latency, never loop latency).

All sites are consulted off the event loop (the journal's writer
thread, or boot-time restore); the unarmed fast path is one membership
test on an (almost always) empty dict, so the shim wraps the backend
unconditionally (bootstrap.build_storage).

:func:`torn_tail` is the power-loss half of the family: truncate the
last N bytes of the SQLite main/-wal file between a kill and a
restart, simulating a torn final write. It is a harness-side helper
(the victim process is already dead when it runs), kept here so the
disk-fault surface lives in one module.

Copy of the JAX package's ``hooks/faultstore.py``.
"""

from __future__ import annotations

import errno
import os

from .. import faults
from .storage import Store


class FsyncFailed(OSError):
    """fsync(2) failed after the writes landed: dirty-page fate unknown
    (fsyncgate semantics). The journal poisons the backend connection
    on seeing this — reopen + replay, never retry on the old handle."""

    def __init__(self, msg: str = "injected fsync failure") -> None:
        super().__init__(errno.EIO, msg)


class DiskFull(OSError):
    """ENOSPC from the backend: the volume is full."""

    def __init__(self, msg: str = "injected ENOSPC") -> None:
        super().__init__(errno.ENOSPC, msg)


def _fire_disk_faults() -> None:
    """One write/commit attempt's worth of disk faults, in severity
    order. ``disk.latency`` is consulted first (a slow disk still
    fails afterward if told to); the error sites raise."""
    faults.fire(faults.DISK_LATENCY)        # hang mode sleeps delay_s
    if faults.fire(faults.DISK_WRITE):
        raise OSError(errno.EIO, "injected disk write error")
    if faults.fire(faults.DISK_ENOSPC):
        raise DiskFull()


class FaultInjectingStore(Store):
    """A :class:`Store` that passes everything through to ``inner``,
    consulting the ``disk.*`` sites around each write/commit."""

    def __init__(self, inner: Store) -> None:
        self.inner = inner

    # -- reads / lifecycle: pure delegation ----------------------------

    def get(self, bucket, key):
        return self.inner.get(bucket, key)

    def all(self, bucket):
        return self.inner.all(bucket)

    def close(self):
        self.inner.close()

    def reopen(self):
        """Poisoned-connection recovery (journal.py): delegate to the
        backend when it supports reopening, else no-op (MemoryStore
        has no connection to poison)."""
        reopen = getattr(self.inner, "reopen", None)
        if reopen is not None:
            reopen()

    def __getattr__(self, name):
        # counters/paths the metrics layer duck-types off the backend
        # (corruptions, aside_failures, path, ...) stay reachable
        return getattr(self.inner, name)

    # -- writes: the disk.* consultation points ------------------------

    def put(self, bucket, key, value):
        _fire_disk_faults()
        self.inner.put(bucket, key, value)
        if faults.fire(faults.DISK_FSYNC):
            raise FsyncFailed()

    def delete(self, bucket, key):
        _fire_disk_faults()
        self.inner.delete(bucket, key)
        if faults.fire(faults.DISK_FSYNC):
            raise FsyncFailed()

    def delete_prefix(self, bucket, prefix):
        _fire_disk_faults()
        self.inner.delete_prefix(bucket, prefix)
        if faults.fire(faults.DISK_FSYNC):
            raise FsyncFailed()

    def apply_batch(self, ops):
        """The group-commit path (one journal commit = one call here):
        EIO/ENOSPC fire BEFORE the inner transaction (the write never
        happened), fsync fires AFTER it (the write may or may not have
        reached the platter — exactly the ambiguity the journal's
        poison-reopen-replay discipline exists for)."""
        _fire_disk_faults()
        self.inner.apply_batch(ops)
        if faults.fire(faults.DISK_FSYNC):
            raise FsyncFailed()


def torn_tail(path: str, nbytes: int = 512, target: str = "wal") -> int:
    """Truncate the last ``nbytes`` off a store file — the torn final
    write a power cut leaves. ``target`` picks the victim: ``"wal"``
    (the usual tear: SQLite recovers by dropping the torn frames and
    everything committed before them survives) or ``"db"`` (main-file
    damage: the open-time quick_check catches it and the move-aside
    path runs). Returns the bytes actually removed (0 when the file is
    missing or already smaller)."""
    victim = path + "-wal" if target == "wal" else path
    try:
        size = os.path.getsize(victim)
    except OSError:
        return 0
    cut = min(int(nbytes), size)
    if cut <= 0:
        return 0
    with open(victim, "rb+") as f:
        f.truncate(size - cut)
    return cut
