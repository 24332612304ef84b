"""MQTT+ content plane (ADR 023): the predicate compiler (``expr``), the
columnar evaluator over a publish batch (``columnar``: NumPy, or torch on
the card behind a breaker) and the tumbling-window aggregates
(``window``). The plane that owns the registry and the fan-out mask comes
with the broker engine."""

from .columnar import ColumnarEvaluator
from .expr import (CompiledPredicate, ExprError, compile_expr,
                   decode_payload, extract_field)
from .window import AGG_OPS, WindowAgg

__all__ = ["CompiledPredicate", "ExprError", "compile_expr",
           "decode_payload", "extract_field", "ColumnarEvaluator",
           "AGG_OPS", "WindowAgg"]
