"""Vectorized predicate evaluation over a publish batch (ADR 023).

One pipeline flush hands the plane N publishes; payloads are decoded
**once** into a columnar scratch — per loaded field, a float64 value
column plus a bool validity column over the batch — and every distinct
compiled predicate then runs its stack program against those columns,
producing a (predicates x publishes) boolean matrix in a handful of
array ops. That turns the per-(message, subscriber) Python loop a
naive broker would run into array arithmetic, the same shape the
device matcher exploits.

Backends: NumPy is the always-on baseline; ``torch`` runs the same
stack machine on torch tensors on a device (the card unless the caller
names another). The torch path sits behind a miniature ADR-011 breaker —
consecutive failures pin NumPy with a timed reprobe — because a wedged
accelerator must degrade the content plane to the host path, never
wedge delivery. Comparisons/boolean ops are bandwidth-bound elementwise
work, so the device path uses stock torch ops, one launch per op of a
program, as the JAX package lowers it to stock jax.numpy ops; no
bespoke kernel is written for it. Values stay float64 on the device:
float32 would flip comparisons near a threshold.

Copy of the JAX package's ``filtering/columnar.py`` with
``eval_batch_jnp`` ported to ``eval_batch_torch``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .expr import CompiledPredicate, extract_field

# (values, valid) column pair per field; a None valid means "scalar
# constant, always valid" inside the stack machine
Columns = dict


def build_columns(payload_objs: list, fields: tuple[str, ...]) -> Columns:
    """Decode-once scratch: one (float64 values, bool valid) pair per
    field over the whole batch."""
    n = len(payload_objs)
    cols: Columns = {f: (np.zeros(n, dtype=np.float64),
                         np.zeros(n, dtype=bool)) for f in fields}
    for i, obj in enumerate(payload_objs):
        if obj is None:
            continue
        for f in fields:
            v = extract_field(obj, f)
            if v is not None:
                vals, valid = cols[f]
                vals[i] = v
                valid[i] = True
    return cols


def _cmp(op: str, a, b):
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == "==":
        return a == b
    return a != b


def _run_program(program, cols: Columns, n: int, full) -> object:
    """Stack-machine pass over one program over NumPy arrays or torch
    tensors; ``full(n, value)`` makes a bool column of one value on the
    columns' side. Stack entries are (values, valid) numeric pairs or
    bare boolean arrays; the compiler's grammar guarantees
    well-typedness."""
    stack: list = []
    for op in program:
        kind = op[0]
        if kind == "load":
            stack.append(cols[op[1]])
        elif kind == "const":
            stack.append((op[1], None))
        elif kind == "cmp":
            bvals, bvalid = stack.pop()
            avals, avalid = stack.pop()
            mask = _cmp(op[1], avals, bvals)
            if avalid is not None:
                mask = mask & avalid
            if bvalid is not None:
                mask = mask & bvalid
            if not hasattr(mask, "shape") or getattr(mask, "shape", ()) == ():
                # const-vs-const comparison: broadcast to the batch
                mask = full(n, bool(mask))
            stack.append(mask)
        elif kind == "and":
            b, a = stack.pop(), stack.pop()
            stack.append(a & b)
        elif kind == "or":
            b, a = stack.pop(), stack.pop()
            stack.append(a | b)
        else:               # not
            stack.append(~stack.pop())
    return stack[0]


def _full_numpy(n: int, value: bool) -> np.ndarray:
    return np.full(n, value, dtype=bool)


def eval_batch_numpy(programs: list, cols: Columns, n: int) -> np.ndarray:
    """(len(programs), n) boolean matrix, NumPy baseline."""
    out = np.zeros((len(programs), n), dtype=bool)
    for row, program in enumerate(programs):
        out[row] = _run_program(program, cols, n, _full_numpy)
    return out


def device_matrix(programs: list, cols: Columns, n: int,
                  device="cuda") -> torch.Tensor:
    """The (len(programs), n) bool matrix as a tensor on ``device``: the
    columns cross to the device once (one float64 and one bool copy of
    every field) and are shared by every program's pass."""
    dev = torch.device(device)
    if not programs:
        return torch.zeros((0, n), dtype=torch.bool, device=dev)
    names = list(cols)
    dcols = {}
    if names:
        vals = torch.from_numpy(
            np.stack([cols[f][0] for f in names])).to(dev)
        valid = torch.from_numpy(
            np.stack([cols[f][1] for f in names])).to(dev)
        dcols = {f: (vals[i], valid[i]) for i, f in enumerate(names)}

    def full(m: int, value: bool) -> torch.Tensor:
        return torch.full((m,), value, dtype=torch.bool, device=dev)

    return torch.stack([_run_program(p, dcols, n, full) for p in programs])


def eval_batch_torch(programs: list, cols: Columns, n: int,
                     device="cuda") -> np.ndarray:
    """Same matrix as :func:`eval_batch_numpy`, computed on ``device``
    and copied back once."""
    return device_matrix(programs, cols, n, device).cpu().numpy()


def eval_reference_batch(predicates: list[CompiledPredicate],
                         payload_objs: list) -> np.ndarray:
    """The naive per-(message, predicate) Python loop — the bench
    baseline and the differential-test oracle."""
    out = np.zeros((len(predicates), len(payload_objs)), dtype=bool)
    for row, pred in enumerate(predicates):
        for i, obj in enumerate(payload_objs):
            out[row, i] = pred.eval_reference(obj)
    return out


class ColumnarEvaluator:
    """Backend selector + breaker for the vectorized evaluator.

    ``backend``: ``numpy`` pins the baseline; ``torch`` requests the
    torch path on ``device`` (the card by default); ``auto`` takes it
    when the device is there (for the card, ``torch.cuda.is_available()``).
    A torch batch that raises falls back to NumPy for that batch
    (counted in ``device_fallbacks``); after ``fail_limit`` consecutive
    failures NumPy is pinned for ``pin_s`` seconds before one reprobe —
    the content-plane rung of the ADR-011 ladder.
    """

    def __init__(self, backend: str = "numpy", fail_limit: int = 3,
                 pin_s: float = 30.0, device="cuda") -> None:
        self.backend = backend
        self.device = torch.device(device)
        self.fail_limit = max(int(fail_limit), 1)
        self.pin_s = float(pin_s)
        self.device_fallbacks = 0
        self._fails = 0
        self._pinned_until = 0.0
        self._torch_ok: bool | None = None   # lazy device probe

    def _want_torch(self) -> bool:
        if self.backend == "numpy":
            return False
        if self._torch_ok is None:
            self._torch_ok = (self.device.type != "cuda"
                              or torch.cuda.is_available())
            if not self._torch_ok and self.backend == "torch":
                # requested explicitly but unavailable: count the
                # degrade once so operators can see it
                self.device_fallbacks += 1
        if not self._torch_ok:
            return False
        return time.monotonic() >= self._pinned_until

    def eval_batch(self, programs: list, cols: Columns,
                   n: int) -> np.ndarray:
        if self._want_torch():
            try:
                out = eval_batch_torch(programs, cols, n, self.device)
                self._fails = 0
                return out
            except Exception:
                self.device_fallbacks += 1
                self._fails += 1
                if self._fails >= self.fail_limit:
                    self._pinned_until = time.monotonic() + self.pin_s
                    self._fails = 0
        return eval_batch_numpy(programs, cols, n)
