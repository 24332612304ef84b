"""MQTT+ content plane (ADR 023): the predicate compiler (``expr``), the
columnar evaluator over a publish batch (``columnar``: NumPy, or torch on
the card behind a breaker) and the tumbling-window aggregates
(``window``), and the plane that owns the registry, the fan-out mask and
the aggregate emission (``plane``)."""

from .columnar import ColumnarEvaluator
from .expr import (CompiledPredicate, ExprError, compile_expr,
                   decode_payload, extract_field)
from .plane import ContentPlane, ContentQuota, FilterSpec, parse_spec
from .window import AGG_OPS, WindowAgg

__all__ = ["CompiledPredicate", "ExprError", "compile_expr",
           "decode_payload", "extract_field", "ColumnarEvaluator",
           "AGG_OPS", "WindowAgg", "ContentPlane", "ContentQuota",
           "FilterSpec", "parse_spec"]
