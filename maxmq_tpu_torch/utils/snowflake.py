"""Snowflake unique-ID generator.

64-bit IDs with the same bit layout as the reference's generator
(internal/snowflake/snowflake.go:23-62): 42-bit millisecond timestamp since
the 2020-01-01 UTC epoch, 10-bit machine ID, 12-bit per-millisecond sequence.
IDs are time-sortable and unique per (machine, ms, seq). The reference uses a
lock-free CAS loop with 3 retries; here a mutex is the idiomatic equivalent —
contention is the metrics/log path, not the match hot path.

Copy of the JAX package's ``utils/snowflake.py``.
"""

from __future__ import annotations

import threading
import time

# 2020-01-01T00:00:00Z in milliseconds
EPOCH_MS = 1_577_836_800_000

TIMESTAMP_BITS = 42
MACHINE_BITS = 10
SEQUENCE_BITS = 12

MAX_MACHINE_ID = (1 << MACHINE_BITS) - 1
MAX_SEQUENCE = (1 << SEQUENCE_BITS) - 1
MAX_TIMESTAMP = (1 << TIMESTAMP_BITS) - 1

TIMESTAMP_SHIFT = MACHINE_BITS + SEQUENCE_BITS
MACHINE_SHIFT = SEQUENCE_BITS


class Snowflake:
    """Generates unique, roughly time-ordered 64-bit IDs."""

    def __init__(self, machine_id: int = 0) -> None:
        if not 0 <= machine_id <= MAX_MACHINE_ID:
            raise ValueError(
                f"machine_id must be in [0, {MAX_MACHINE_ID}], got {machine_id}")
        self.machine_id = machine_id
        self._lock = threading.Lock()
        self._last_ms = -1
        self._seq = 0

    def next_id(self) -> int:
        with self._lock:
            now = self._now_ms()
            if now < self._last_ms:
                # clock went backwards: wait it out (reference retries CAS)
                while now < self._last_ms:
                    time.sleep(0.0001)
                    now = self._now_ms()
            if now == self._last_ms:
                self._seq = (self._seq + 1) & MAX_SEQUENCE
                if self._seq == 0:
                    # sequence exhausted within this millisecond
                    while now <= self._last_ms:
                        now = self._now_ms()
            else:
                self._seq = 0
            self._last_ms = now
            return ((now & MAX_TIMESTAMP) << TIMESTAMP_SHIFT
                    | self.machine_id << MACHINE_SHIFT
                    | self._seq)

    # Field extractors (snowflake.go:45-62)
    @staticmethod
    def timestamp_ms(id_: int) -> int:
        """Unix milliseconds the ID was generated at."""
        return (id_ >> TIMESTAMP_SHIFT) + EPOCH_MS

    @staticmethod
    def machine_of(id_: int) -> int:
        return (id_ >> MACHINE_SHIFT) & MAX_MACHINE_ID

    @staticmethod
    def sequence_of(id_: int) -> int:
        return id_ & MAX_SEQUENCE

    @staticmethod
    def _now_ms() -> int:
        return time.time_ns() // 1_000_000 - EPOCH_MS
