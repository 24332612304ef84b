"""Predicate expression compiler (ADR 023).

The subscription option ``$expr=payload.temp>30 && payload.hum<80``
is parsed here into a small postfix **stack program** whose ops are
all columnar (operate on whole publish-batch columns at once), so one
compiled predicate evaluates against N payloads in a handful of
NumPy/jnp calls instead of N Python interpreter passes.

Grammar (numeric-only v1; strings/regex are in the ADR-023 NOT-done
list)::

    expr    := or
    or      := and ( "||" and )*
    and     := unary ( "&&" unary )*
    unary   := "!" unary | "(" expr ")" | comparison
    comparison := operand CMP operand        CMP in > >= < <= == !=
    operand := FIELD | NUMBER
    FIELD   := "payload" ( "." name )*

Missing-field semantics (the contract both evaluators implement): a
comparison touching a field the payload does not carry — or carries
as a non-number — is **False**; boolean ops then combine plain
booleans, so ``!(payload.temp>30)`` is True for a payload without
``temp``. The reference evaluator (:meth:`CompiledPredicate.
eval_reference`) is the per-message scalar twin the differential test
and the bench baseline run against.

Copy of the JAX package's ``filtering/expr.py``.
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass


class ExprError(ValueError):
    """Malformed predicate expression (rejected at SUBSCRIBE)."""


# program opcodes (postfix):
#   ("load", field)   push numeric column (values, valid-mask)
#   ("const", x)      push scalar constant (always valid)
#   ("cmp", op)       pop rhs, lhs numerics; push boolean column
#   ("and"/"or"/"not") boolean-column combinators
CMP_OPS = (">", ">=", "<", "<=", "==", "!=")

_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<num>-?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
    | (?P<field>[A-Za-z_][A-Za-z0-9_]*(?:\.[A-Za-z0-9_]+)*)
    | (?P<op>&&|\|\||>=|<=|==|!=|>|<|!|\(|\))
    )""", re.VERBOSE)


def _tokenize(text: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None or m.end() == m.start():
            rest = text[pos:].strip()
            if not rest:
                break
            raise ExprError(f"bad token at {pos}: {rest[:20]!r}")
        pos = m.end()
        for kind in ("num", "field", "op"):
            val = m.group(kind)
            if val is not None:
                out.append((kind, val))
                break
    return out


@dataclass(frozen=True)
class CompiledPredicate:
    """One compiled ``$expr``: source text, the fields it loads, and
    the postfix program the columnar evaluator runs."""

    expr: str
    fields: tuple[str, ...]
    program: tuple[tuple, ...]

    def eval_reference(self, payload_obj) -> bool:
        """Scalar per-message evaluation against one decoded payload —
        the semantics oracle for the vectorized path."""
        stack: list = []
        for op in self.program:
            kind = op[0]
            if kind == "load":
                stack.append(extract_field(payload_obj, op[1]))
            elif kind == "const":
                stack.append(op[1])
            elif kind == "cmp":
                b, a = stack.pop(), stack.pop()
                if a is None or b is None:
                    stack.append(False)
                else:
                    stack.append(_CMP_PY[op[1]](a, b))
            elif kind == "and":
                b, a = stack.pop(), stack.pop()
                stack.append(a and b)
            elif kind == "or":
                b, a = stack.pop(), stack.pop()
                stack.append(a or b)
            else:               # not
                stack.append(not stack.pop())
        return bool(stack[0])


_CMP_PY = {">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
           "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
           "==": lambda a, b: a == b, "!=": lambda a, b: a != b}


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]) -> None:
        self.toks = tokens
        self.i = 0
        self.program: list[tuple] = []
        self.fields: list[str] = []

    def peek(self) -> tuple[str, str] | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def take(self) -> tuple[str, str]:
        tok = self.peek()
        if tok is None:
            raise ExprError("unexpected end of expression")
        self.i += 1
        return tok

    def expect_op(self, val: str) -> None:
        tok = self.take()
        if tok != ("op", val):
            raise ExprError(f"expected {val!r}, got {tok[1]!r}")

    def parse(self) -> tuple[list[tuple], list[str]]:
        self.or_expr()
        if self.peek() is not None:
            raise ExprError(f"trailing input: {self.peek()[1]!r}")
        return self.program, self.fields

    def or_expr(self) -> None:
        self.and_expr()
        while self.peek() == ("op", "||"):
            self.take()
            self.and_expr()
            self.program.append(("or",))

    def and_expr(self) -> None:
        self.unary()
        while self.peek() == ("op", "&&"):
            self.take()
            self.unary()
            self.program.append(("and",))

    def unary(self) -> None:
        tok = self.peek()
        if tok == ("op", "!"):
            self.take()
            self.unary()
            self.program.append(("not",))
        elif tok == ("op", "("):
            self.take()
            self.or_expr()
            self.expect_op(")")
        else:
            self.comparison()

    def comparison(self) -> None:
        self.operand()
        tok = self.take()
        if tok[0] != "op" or tok[1] not in CMP_OPS:
            raise ExprError(f"expected comparison, got {tok[1]!r}")
        self.operand()
        self.program.append(("cmp", tok[1]))

    def operand(self) -> None:
        kind, val = self.take()
        if kind == "num":
            self.program.append(("const", float(val)))
        elif kind == "field":
            if val != "payload" and not val.startswith("payload."):
                raise ExprError(f"unknown field root {val!r} "
                                "(fields start with 'payload')")
            if val not in self.fields:
                self.fields.append(val)
            self.program.append(("load", val))
        else:
            raise ExprError(f"expected field or number, got {val!r}")


def compile_expr(text: str, max_len: int = 512,
                 max_fields: int = 64) -> CompiledPredicate:
    """Compile one ``$expr`` option; raises :class:`ExprError` on any
    malformed input so SUBSCRIBE can reject it cleanly."""
    if not text or not text.strip():
        raise ExprError("empty expression")
    if len(text) > max_len:
        raise ExprError(f"expression longer than {max_len} chars")
    program, fields = _Parser(_tokenize(text)).parse()
    if len(fields) > max_fields:
        raise ExprError(f"more than {max_fields} fields")
    return CompiledPredicate(expr=text, fields=tuple(fields),
                             program=tuple(program))


# ---------------------------------------------------------------------
# Payload decode + field access (shared by both evaluators)
# ---------------------------------------------------------------------


def decode_payload(data: bytes):
    """bytes -> decoded JSON value (dict / number), or None when the
    payload is not UTF-8 JSON — every predicate then reads False."""
    try:
        return json.loads(data.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None


def extract_field(obj, path: str) -> float | None:
    """Resolve ``payload``/``payload.a.b`` against a decoded payload.
    Returns a finite float, or None for missing/non-numeric (bools map
    to 0/1; strings and non-finite numbers are invalid in v1)."""
    cur = obj
    for part in path.split(".")[1:]:
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return None
    if isinstance(cur, bool):
        return 1.0 if cur else 0.0
    if isinstance(cur, (int, float)):
        f = float(cur)
        return f if math.isfinite(f) else None
    return None
