"""Structured leveled logger.

Parity surface: internal/logger/logger.go in the reference — two output
formats (``pretty`` colorized console, ``json`` one-object-per-line), a global
severity level, hierarchical prefixes (``bootstrap``, ``mqtt``, ``metrics``),
and a per-event ``LogId`` injected from a pluggable generator (the snowflake
generator in production, logger.go:166-170).

Self-contained rather than a stdlib-logging wrapper: every event is a flat
dict of fields, which keeps the json format trivially machine-parseable and
the pretty format deterministic for tests.

Copy of the JAX package's ``utils/logger.py``.
"""

from __future__ import annotations

import io
import json
import sys
import threading
import time
from typing import Any, Callable, TextIO

TRACE = 0
DEBUG = 1
INFO = 2
WARN = 3
ERROR = 4
FATAL = 5

_LEVEL_NAMES = {TRACE: "trace", DEBUG: "debug", INFO: "info",
                WARN: "warn", ERROR: "error", FATAL: "fatal"}
_NAME_LEVELS = {v: k for k, v in _LEVEL_NAMES.items()}

_COLORS = {TRACE: "\x1b[35m", DEBUG: "\x1b[33m", INFO: "\x1b[32m",
           WARN: "\x1b[31m", ERROR: "\x1b[31;1m", FATAL: "\x1b[41;97m"}
_RESET = "\x1b[0m"
_DIM = "\x1b[2m"

_global_level = INFO
_level_lock = threading.Lock()


def set_severity_level(level: int | str) -> None:
    """Set the process-wide minimum severity (logger.go:85-93)."""
    global _global_level
    if isinstance(level, str):
        if level not in _NAME_LEVELS:
            raise ValueError(f"unknown log level {level!r}")
        level = _NAME_LEVELS[level]
    with _level_lock:
        _global_level = level


def severity_level() -> int:
    return _global_level


class Logger:
    """Leveled structured logger with prefix chaining and LogId injection."""

    def __init__(self, out: TextIO | None = None, fmt: str = "pretty",
                 prefix: str = "", log_id_gen: Callable[[], int] | None = None,
                 color: bool | None = None) -> None:
        if fmt == "text":
            fmt = "pretty"      # config spelling: log_format = json|text
        if fmt not in ("pretty", "json"):
            raise ValueError(f"unknown log format {fmt!r}")
        self._out = out if out is not None else sys.stderr
        self._fmt = fmt
        self._prefix = prefix
        self._log_id_gen = log_id_gen
        if color is None:
            color = hasattr(self._out, "isatty") and self._out.isatty()
        self._color = color and fmt == "pretty"
        self._lock = threading.Lock()

    def with_prefix(self, prefix: str) -> "Logger":
        """Child logger with a hierarchical prefix (logger.go:148-158)."""
        full = f"{self._prefix}.{prefix}" if self._prefix else prefix
        return Logger(self._out, self._fmt, full, self._log_id_gen,
                      self._color)

    # -- event emitters -----------------------------------------------------

    def trace(self, msg: str, **fields: Any) -> None:
        self._emit(TRACE, msg, fields)

    def debug(self, msg: str, **fields: Any) -> None:
        self._emit(DEBUG, msg, fields)

    def info(self, msg: str, **fields: Any) -> None:
        self._emit(INFO, msg, fields)

    def warn(self, msg: str, **fields: Any) -> None:
        self._emit(WARN, msg, fields)

    def error(self, msg: str, **fields: Any) -> None:
        self._emit(ERROR, msg, fields)

    def fatal(self, msg: str, **fields: Any) -> None:
        self._emit(FATAL, msg, fields)

    def log(self, level: int, msg: str, **fields: Any) -> None:
        self._emit(level, msg, fields)

    # -----------------------------------------------------------------------

    def _emit(self, level: int, msg: str, fields: dict[str, Any]) -> None:
        if level < _global_level:
            return
        now = time.time()
        event: dict[str, Any] = {
            "time": int(now * 1000),
            "level": _LEVEL_NAMES[level],
        }
        if self._prefix:
            event["prefix"] = self._prefix
        event.update(fields)
        if self._log_id_gen is not None:
            event["log_id"] = self._log_id_gen()
        event["message"] = msg
        line = (self._format_json(event) if self._fmt == "json"
                else self._format_pretty(level, now, event, msg))
        with self._lock:
            self._out.write(line + "\n")

    @staticmethod
    def _format_json(event: dict[str, Any]) -> str:
        return json.dumps(event, default=str, separators=(",", ":"))

    def _format_pretty(self, level: int, now: float, event: dict[str, Any],
                       msg: str) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(now))
        name = _LEVEL_NAMES[level].upper()[:3]
        buf = io.StringIO()
        if self._color:
            buf.write(f"{_DIM}{ts}{_RESET} {_COLORS[level]}{name}{_RESET}")
        else:
            buf.write(f"{ts} {name}")
        if self._prefix:
            buf.write(f" [{self._prefix}]")
        buf.write(f" {msg}")
        for k, v in event.items():
            if k in ("time", "level", "prefix", "message"):
                continue
            if self._color:
                buf.write(f" {_DIM}{k}={_RESET}{v}")
            else:
                buf.write(f" {k}={v}")
        return buf.getvalue()


def new_logger(fmt: str = "pretty", level: int | str = INFO,
               out: TextIO | None = None,
               log_id_gen: Callable[[], int] | None = None) -> Logger:
    """Construct the root logger (logger.go:116-136)."""
    set_severity_level(level)
    return Logger(out=out, fmt=fmt, log_id_gen=log_id_gen)
