"""Tumbling-window aggregation state (ADR 023).

One :class:`WindowAgg` per ``$agg`` subscription: running scalars
(message count, sample count/sum/min/max — everything
$avg/$max/$min/$count/$sum emit is derivable from these),
accumulated **batch-wise** from the columnar scratch, over
wall-aligned tumbling windows (``window_start = floor(t / win) *
win``). State is O(1) per subscription regardless of message rate —
the bounded-state half of the acceptance contract; the subscription
count itself is bounded by the plane's registration quota.

Semantics: ``count`` counts messages that passed the predicate;
``avg``/``sum``/``min``/``max`` fold the **valid numeric samples** of
the aggregated field (a passing message without the field contributes
to ``count`` but not to the numeric ops — mirrored by the naive
reference the tests bit-compare against). Window close emits a dict
(the plane serializes it into the synthesized aggregate publish, ADR
023 wire format); a window with nothing to report emits nothing.

Copy of the JAX package's ``filtering/window.py``.
"""

from __future__ import annotations

import math

import numpy as np

AGG_OPS = ("avg", "max", "min", "count", "sum")


class WindowAgg:
    __slots__ = ("op", "field", "win_s", "window_start",
                 "count", "samples", "sum", "min", "max")

    def __init__(self, op: str, field: str, win_s: float) -> None:
        self.op = op
        self.field = field
        self.win_s = float(win_s)
        self.window_start: float | None = None
        self._reset()

    def _reset(self) -> None:
        self.count = 0
        self.samples = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _value(self) -> float | None:
        """The op's value over the current window, None when empty."""
        if self.op == "count":
            return float(self.count) if self.count else None
        if not self.samples:
            return None
        if self.op == "sum":
            return self.sum
        if self.op == "min":
            return self.min
        if self.op == "max":
            return self.max
        return self.sum / self.samples          # avg

    def _close(self) -> dict | None:
        ws = self.window_start
        value = self._value()
        count = self.count
        self.window_start = None
        self._reset()
        if ws is None or value is None:
            return None
        return {"op": self.op, "field": self.field,
                "window_start": ws, "window_end": ws + self.win_s,
                "count": count, "value": value}

    def accumulate(self, n_passed: int, values: np.ndarray,
                   now: float) -> dict | None:
        """Fold one batch's passing rows in: ``n_passed`` messages
        passed the predicate; ``values`` are their *valid* numeric
        field samples. Returns the previous window's emission when
        this batch lands past its boundary."""
        ws = math.floor(now / self.win_s) * self.win_s
        emission = None
        if self.window_start is not None and ws != self.window_start:
            emission = self._close()
        if self.window_start is None:
            self.window_start = ws
        self.count += int(n_passed)
        if values.size:
            self.samples += int(values.size)
            self.sum += float(values.sum())
            mn = float(values.min())
            mx = float(values.max())
            if mn < self.min:
                self.min = mn
            if mx > self.max:
                self.max = mx
        return emission

    def close_due(self, now: float) -> dict | None:
        """Housekeeping tick: close the window once ``now`` passes its
        boundary (None when there is nothing to emit)."""
        if (self.window_start is None
                or now < self.window_start + self.win_s):
            return None
        return self._close()
