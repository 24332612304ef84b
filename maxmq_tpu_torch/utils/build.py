"""Build/version information.

Parity surface: internal/build/info.go — version, revision, build time, and
distribution, injected at build time (the reference uses ``-ldflags -X``,
Makefile:38-43; here the injection points are module globals overridable via
``MAXMQ_BUILD_*`` env at packaging time) with short/long formatting
(info.go:66-84).

Copy of the JAX package's ``utils/build.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

VERSION = os.environ.get("MAXMQ_BUILD_VERSION", "0.1.0-dev")
REVISION = os.environ.get("MAXMQ_BUILD_REVISION", "")
BUILD_TIME = os.environ.get("MAXMQ_BUILD_TIME", "")
DISTRIBUTION = os.environ.get("MAXMQ_BUILD_DISTRIBUTION", "maxmq-tpu")


@dataclass(frozen=True)
class BuildInfo:
    version: str
    revision: str
    build_time: str
    distribution: str

    def short_version(self) -> str:
        return self.version

    def long_version(self) -> str:
        parts = [f"{self.distribution} {self.version}"]
        if self.revision:
            parts.append(f"({self.revision})")
        if self.build_time:
            parts.append(f"built at {self.build_time}")
        return " ".join(parts)


def get_info() -> BuildInfo:
    return BuildInfo(VERSION, REVISION, BUILD_TIME, DISTRIBUTION)
