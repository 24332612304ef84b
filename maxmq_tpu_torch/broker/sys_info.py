"""$SYS broker statistics counters.

Parity surface: vendor/github.com/mochi-co/mqtt/v2/system/system.go (21 atomic
counters). Plain ints here: mutations happen on the asyncio loop thread and
reads from the metrics scrape thread are tear-free under the GIL.

Copy of the JAX package's ``broker/sys_info.py``.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field


@dataclass
class SysInfo:
    version: str = ""
    started: int = 0            # unix seconds
    time: int = 0               # last refresh, unix seconds
    uptime: int = 0
    bytes_received: int = 0
    bytes_sent: int = 0
    clients_connected: int = 0
    clients_disconnected: int = 0
    clients_maximum: int = 0
    clients_total: int = 0
    messages_received: int = 0
    messages_sent: int = 0
    messages_dropped: int = 0
    retained: int = 0
    inflight: int = 0
    inflight_dropped: int = 0
    subscriptions: int = 0
    packets_received: int = 0
    packets_sent: int = 0
    memory_alloc: int = 0
    threads: int = 0

    extra: dict = field(default_factory=dict)

    def clone(self) -> "SysInfo":
        d = asdict(self)
        d["extra"] = dict(self.extra)
        return SysInfo(**d)
