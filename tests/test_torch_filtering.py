"""The port's content plane pieces (``maxmq_tpu_torch.filtering``: the
predicate compiler, the columnar evaluator with its torch backend and
breaker, the window aggregates) against the JAX package's on the same
inputs. Matrices are compared for exact equality; window values to the
JAX package's own tolerance (1e-9, tests/test_filtering.py)."""

import math
import random

import numpy as np
import pytest
import torch

from maxmq_tpu.filtering import columnar as ref_columnar
from maxmq_tpu.filtering import expr as ref_expr
from maxmq_tpu.filtering import window as ref_window
from maxmq_tpu_torch.filtering import columnar, expr, window

import chip_smoke

FIELDS = ("payload.a", "payload.b", "payload.c.d")


def gen_expr(rng, depth=0) -> str:
    if depth >= 3 or rng.random() < 0.4:
        r = rng.random()
        lhs = rng.choice(FIELDS) if r < 0.85 else str(rng.randint(-3, 3))
        rhs = (f"{round(rng.uniform(-5, 5), 2)}" if r < 0.7
               else rng.choice(FIELDS + ("2", "-1.5", "0")))
        op = rng.choice((">", ">=", "<", "<=", "==", "!="))
        return f"{lhs}{op}{rhs}"
    r = rng.random()
    a, b = gen_expr(rng, depth + 1), gen_expr(rng, depth + 1)
    if r < 0.4:
        return f"({a})&&({b})"
    if r < 0.8:
        return f"({a})||({b})"
    return f"!({a})"


def gen_payload(rng):
    r = rng.random()
    if r < 0.08:
        return None                         # undecodable publish
    obj = {}
    if rng.random() < 0.85:
        obj["a"] = rng.choice([round(rng.uniform(-6, 6), 3),
                               rng.randint(-5, 5), 2.0])
    if rng.random() < 0.7:
        obj["b"] = rng.choice(
            [rng.randint(-5, 5), True, False, "a-string", None,
             float("inf")])
    if rng.random() < 0.6:
        obj["c"] = rng.choice([{"d": round(rng.uniform(-6, 6), 3)},
                               {"e": 1}, 7])
    return obj


def union_fields(preds) -> tuple:
    union = []
    for p in preds:
        for f in p.fields:
            if f not in union:
                union.append(f)
    return tuple(union)


MALFORMED = ("payload.>3", "temp>30", "payload.a>>3", "payload.a>",
             "(payload.a>1", "payload.a>1)", "payload.a > nan",
             "payload.a>1&&", "$agg", "", "   ", "payload.a>1 ~ 2",
             "payload.a 1", "!", "()", "payload.a>" + "1" * 600,
             "foo.bar<2", "payload.a>1||", "3", "payload.a==(1)")


@pytest.mark.parametrize("seed", range(4))
def test_compile_expr_programs_and_fields_equal(seed):
    rng = random.Random(seed)
    for _ in range(200):
        text = gen_expr(rng)
        got, want = expr.compile_expr(text), ref_expr.compile_expr(text)
        assert (got.expr, got.fields, got.program) == \
            (want.expr, want.fields, want.program)


@pytest.mark.parametrize("text", MALFORMED)
def test_compile_expr_errors_equal(text):
    with pytest.raises(ref_expr.ExprError) as want:
        ref_expr.compile_expr(text)
    with pytest.raises(expr.ExprError) as got:
        expr.compile_expr(text)
    assert str(got.value) == str(want.value)


def test_compile_expr_bounds_equal():
    wide = "&&".join(f"payload.f{i}>1" for i in range(5))
    for kw in ({"max_len": 10}, {"max_fields": 4}):
        with pytest.raises(ref_expr.ExprError) as want:
            ref_expr.compile_expr(wide, **kw)
        with pytest.raises(expr.ExprError) as got:
            expr.compile_expr(wide, **kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", range(3))
def test_decode_and_extract_equal(seed):
    rng = random.Random(seed)
    raw = [b"", b"\xff\xfe", b"not json", b"42", b"true", b"[1,2]",
           b'{"a": NaN}', b'{"a": 1e400}']
    for _ in range(200):
        obj = gen_payload(rng)
        raw.append(b"{bad" if obj is None else
                   repr(obj).replace("'", '"').replace("True", "true")
                   .replace("False", "false").replace("None", "null")
                   .replace("inf", "1e999").encode())
    for data in raw:
        got, want = expr.decode_payload(data), ref_expr.decode_payload(data)
        assert got == want or (got != got and want != want)
        for f in FIELDS + ("payload", "payload.c"):
            assert expr.extract_field(got, f) == \
                ref_expr.extract_field(want, f)


def matrices(preds_text, objs):
    """(port numpy, port torch on the CPU, reference numpy, reference jnp,
    reference per-message loop) matrices of one batch."""
    ppreds = [expr.compile_expr(t) for t in preds_text]
    rpreds = [ref_expr.compile_expr(t) for t in preds_text]
    fields = union_fields(ppreds)
    pcols = columnar.build_columns(objs, fields)
    rcols = ref_columnar.build_columns(objs, fields)
    for f in fields:
        np.testing.assert_array_equal(pcols[f][0], rcols[f][0])
        np.testing.assert_array_equal(pcols[f][1], rcols[f][1])
    n = len(objs)
    programs = [p.program for p in ppreds]
    return (columnar.eval_batch_numpy(programs, pcols, n),
            columnar.eval_batch_torch(programs, pcols, n, "cpu"),
            ref_columnar.eval_batch_numpy(programs, rcols, n),
            ref_columnar.eval_batch_jnp(programs, rcols, n),
            ref_columnar.eval_reference_batch(rpreds, objs))


@pytest.mark.parametrize("seed", range(5))
def test_matrices_equal_reference(seed):
    rng = random.Random(seed)
    preds = [gen_expr(rng) for _ in range(40)]
    objs = [gen_payload(rng) for _ in range(257)]
    mats = matrices(preds, objs)
    for m in mats:
        assert m.dtype == np.bool_ and m.shape == (40, 257)
        np.testing.assert_array_equal(m, mats[-1])


def test_matrices_on_the_benchmark_generator():
    """The reference benchmark's predicates and payloads (chip_smoke's
    copy of bench.py's ``bench_mqttplus`` generator) at a CPU size."""
    preds, objs = chip_smoke.mqttplus_inputs(64, 512)
    mats = matrices(preds, objs)
    for m in mats:
        np.testing.assert_array_equal(m, mats[-1])
    assert 0 < mats[0].sum() < mats[0].size


def test_const_and_edge_programs():
    """Const-vs-const compares broadcast (a Python bool, not a tensor, on
    the torch side), negation is logical, empty batches and empty program
    lists keep their shapes."""
    preds = ["1>0", "2<1", "!(3==3)", "payload.a>1||2<1",
             "!(payload.a>1)", "payload.a>=payload.b", "0==payload.b",
             "(1<2)&&(payload.zz!=0)"]
    objs = [{"a": 2, "b": 2}, {"a": 0.5}, None, {"b": True}, {}]
    mats = matrices(preds, objs)
    for m in mats:
        np.testing.assert_array_equal(m, mats[-1])
    assert mats[1][0].all() and not mats[1][1].any()
    for n in (0, 3):
        cols = columnar.build_columns([{}] * n, ("payload.a",))
        got = columnar.eval_batch_torch([], cols, n, "cpu")
        assert got.shape == (0, n) and got.dtype == np.bool_
        progs = [expr.compile_expr("payload.a>1").program,
                 expr.compile_expr("1>0").program]
        got = columnar.eval_batch_torch(progs, cols, n, "cpu")
        want = ref_columnar.eval_batch_numpy(
            progs, ref_columnar.build_columns([{}] * n, ("payload.a",)), n)
        np.testing.assert_array_equal(got, want)


def test_values_stay_float64_near_a_threshold():
    """A threshold a float32 would round onto: the torch path keeps
    float64 and agrees with both NumPy paths and the per-message loop.
    The JAX package's jnp path does not: without x64 (the JAX default)
    ``jnp.asarray`` makes the columns float32 and flips these compares,
    a fault of the reference that the port does not copy."""
    thr = 0.1 + 1e-12
    objs = [{"a": 0.1}, {"a": thr}, {"a": 0.1 + 2e-12}]
    pnp, ptorch, rnp, rjnp, rloop = matrices(
        [f"payload.a>{thr!r}", f"payload.a=={thr!r}"], objs)
    for m in (pnp, ptorch, rnp):
        np.testing.assert_array_equal(m, rloop)
    assert rloop.tolist() == [[False, False, True], [False, True, False]]
    assert rjnp.tolist() != rloop.tolist()
    pcols = columnar.build_columns(objs, ("payload.a",))
    dm = columnar.device_matrix(
        [expr.compile_expr(f"payload.a>{thr!r}").program], pcols, 3, "cpu")
    assert dm.dtype == torch.bool and dm.shape == (1, 3)


class _Clock:
    def __init__(self) -> None:
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now


def _breaker_script(mod, device_fn_name, monkeypatch, evaluator):
    """Drive an evaluator through failing and healthy batches under a
    scripted clock; returns what each step observed."""
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    state = {"fail": True, "calls": 0}
    real = getattr(mod, device_fn_name)

    def device(*args, **kw):
        state["calls"] += 1
        if state["fail"]:
            raise RuntimeError("device wedged")
        return real(*args, **kw)

    monkeypatch.setattr(mod, device_fn_name, device)
    rng = random.Random(3)
    preds = [gen_expr(rng) for _ in range(6)]
    objs = [gen_payload(rng) for _ in range(20)]
    compiled = [expr.compile_expr(t) for t in preds]
    cols = mod.build_columns(objs, union_fields(compiled))
    programs = [p.program for p in compiled]
    seen = []
    for step in range(12):
        if step == 7:
            clock.now += 31.0           # past the pin: one reprobe
        if step == 9:
            state["fail"] = False
        out = evaluator.eval_batch(programs, cols, len(objs))
        seen.append((state["calls"], evaluator.device_fallbacks,
                     out.tolist()))
        clock.now += 1.0
    return seen


def test_breaker_fallback_pin_and_reprobe_equal(monkeypatch):
    """The torch path raising falls back to NumPy per batch, pins NumPy
    after ``fail_limit`` failures, reprobes once past ``pin_s``, and
    serves from the device again once it recovers — step for step as the
    JAX package's breaker over its jnp path."""
    got = _breaker_script(columnar, "eval_batch_torch", monkeypatch,
                          columnar.ColumnarEvaluator(
                              backend="torch", device="cpu", fail_limit=3,
                              pin_s=30.0))
    want = _breaker_script(ref_columnar, "eval_batch_jnp", monkeypatch,
                           ref_columnar.ColumnarEvaluator(
                               backend="jnp", fail_limit=3, pin_s=30.0))
    assert got == want
    calls = [c for c, _f, _o in got]
    # 3 failures then pinned (no device call) until the reprobe at step 7
    assert calls[:7] == [1, 2, 3, 3, 3, 3, 3]
    assert calls[7:] == [4, 5, 6, 7, 8]
    assert [f for _c, f, _o in got][-3:] == [5, 5, 5]


def test_backend_selection_without_a_card(monkeypatch):
    """``numpy`` never probes; ``auto`` without the card serves NumPy and
    counts nothing; an explicit ``torch`` without the card counts the
    degrade once (the JAX package counts an unimportable jnp so); a CPU
    device runs the torch path."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    real = columnar.eval_batch_torch
    monkeypatch.setattr(columnar, "eval_batch_torch",
                        lambda *a, **k: called.append(a[-1]) or real(*a, **k))
    cols = columnar.build_columns([{"a": 1}], ("payload.a",))
    progs = [expr.compile_expr("payload.a>0").program]
    for backend, device, fallbacks, served in (
            ("numpy", "cuda", 0, False), ("auto", "cuda", 0, False),
            ("torch", "cuda", 1, False), ("auto", "cpu", 0, True),
            ("torch", "cpu", 0, True)):
        called.clear()
        ev = columnar.ColumnarEvaluator(backend=backend, device=device)
        for _ in range(3):
            assert ev.eval_batch(progs, cols, 1).tolist() == [[True]]
        assert ev.device_fallbacks == fallbacks, backend
        assert bool(called) == served, (backend, device)


def _window_script(mod, seed):
    rng = random.Random(seed)
    out = []
    for op in mod.AGG_OPS:
        w = mod.WindowAgg(op, "payload.x", rng.choice((0.5, 1.0, 5.0)))
        now = 1_000.0
        for _ in range(60):
            now += rng.uniform(0, 0.7)
            vals = np.array([rng.uniform(-50, 50)
                             for _ in range(rng.randint(0, 5))])
            out.append(w.accumulate(rng.randint(0, 6), vals, now))
            if rng.random() < 0.2:
                now += rng.uniform(0, 3)
                out.append(w.close_due(now))
        out.append(w.close_due(now + 10.0))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_window_aggregates_equal(seed):
    got = _window_script(window, seed)
    want = _window_script(ref_window, seed)
    assert window.AGG_OPS == ref_window.AGG_OPS
    assert len(got) == len(want)
    assert sum(e is not None for e in got) > 10
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert {k: v for k, v in g.items() if k != "value"} == \
            {k: v for k, v in w.items() if k != "value"}
        assert abs(g["value"] - w["value"]) < 1e-9
        assert math.isfinite(g["value"])
