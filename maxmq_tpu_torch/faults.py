"""Deterministic fault injection for the matcher degradation ladder.

The registry core of the JAX package's ``faults.py``, for the sites the
matcher service, the publish pipeline and the broker's leaf modules run:
a device call that raises or hangs, a table recompile that fails, a
service socket that drops, a native frame-head encode that fails, a
client writer that stalls, a stored record that fails to restore, and
the named crash points. Sites cost one dict lookup on an (almost always)
empty dict when nothing is armed.

``arm(site, mode, count)`` fires the fault for exactly the next
``count`` hits of that site (``count=-1`` = until disarmed), then
self-disarms. Modes:

* ``raise`` — the site raises :class:`InjectedFault` (a
  :class:`DeviceMatchError`);
* ``hang``  — the site blocks for ``delay_s`` seconds;
* anything else (``drop``, ...) — ``fire`` returns True and the SITE
  acts (the matcher service closes the client connection);
  ``fire_detail`` hands (mode, delay_s) to loop-thread sites, which
  await the delay themselves.

Env arming (``MAXMQ_FAULTS``) reaches processes a test cannot touch by
reference::

    MAXMQ_FAULTS="device.match:raise:3,device.match:hang:1:0.5"

parses as ``site:mode[:count[:delay_s[:skip]]]``, comma-separated,
applied in order; ``skip`` lets a fault pass its first N hits.
"""

from __future__ import annotations

import os
import signal
import threading
import time


class DeviceMatchError(RuntimeError):
    """The device matcher path failed (kernel launch, runtime error, or
    injected fault). Sites that can classify their failures raise this
    so logs separate device faults from host bugs."""


class InjectedFault(DeviceMatchError):
    """Raised by an armed ``raise``-mode fault site."""


# canonical sites (the production code fires these; tests arm them)
DEVICE_MATCH = "device.match"          # engine device-batch entry points
DEVICE_RECOMPILE = "device.recompile"  # engine refresh()/table compile
SERVICE_SOCKET = "service.socket"      # matcher-service client connection
NATIVE_ENCODE = "native.encode"        # C publish-frame head assembly
                                       # (trips fall back to the
                                       # pure-Python encoder)
CLIENT_WRITE = "client.write"          # broker client writer loop
STORAGE_RESTORE = "storage.restore"    # per-record boot restore parse
CRASH_AT = "crash.at"                  # named kill points; keyed per
                                       # point: crash.at#<p>. Mode "kill"
                                       # SIGKILLs the PROCESS

# every named point a broker can be told to SIGKILL itself at: the
# commit-pipeline instants whose before/after durability semantics differ
CRASH_POINTS = (
    "pre_fsync",            # journal writer: batch taken, backend not
                            # yet committed
    "post_fsync_pre_ack",   # journal writer: backend committed, ack
                            # barriers not yet released
    "mid_wal_write",        # SQLite apply_batch: half the batch's ops
                            # executed, transaction open
    "restore_parse",        # boot restore: mid-bucket parse
    "replica_flush",        # cluster session replication: drain
                            # scheduled but not yet on the wire
)


class _Spec:
    __slots__ = ("mode", "remaining", "delay_s", "skip")

    def __init__(self, mode: str, remaining: int, delay_s: float,
                 skip: int = 0) -> None:
        self.mode = mode
        self.remaining = remaining
        self.delay_s = delay_s
        self.skip = skip


def _sigkill_self() -> None:
    os.kill(os.getpid(), signal.SIGKILL)


class FaultRegistry:
    """Thread-safe armed-fault table. One global instance (``REGISTRY``)
    serves the whole process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # site -> FIFO of specs (so "raise twice then hang once" scripts)
        self._specs: dict[str, list[_Spec]] = {}
        self.fired: dict[str, int] = {}
        # swappable monotonic-ns clock: the service's trace stamps read
        # through this indirection so a test can script time
        self.clock_ns = time.monotonic_ns
        # swappable kill action: crash_point() delivers the SIGKILL
        # through this indirection so an in-process test can observe the
        # trip without dying
        self.kill_fn = _sigkill_self

    def reset_clock(self) -> None:
        self.clock_ns = time.monotonic_ns

    # -- arming --------------------------------------------------------

    def arm(self, site: str, mode: str = "raise", count: int = 1,
            delay_s: float = 0.05, skip: int = 0) -> None:
        if count == 0:
            return
        with self._lock:
            self._specs.setdefault(site, []).append(
                _Spec(mode, count, delay_s, max(int(skip), 0)))

    def disarm(self, site: str) -> None:
        with self._lock:
            self._specs.pop(site, None)

    def clear(self) -> None:
        with self._lock:
            self._specs.clear()
            self.fired.clear()

    def armed(self, site: str) -> bool:
        return site in self._specs

    def any_armed(self) -> bool:
        """True when ANY site is armed: the cheap hot-path guard before
        a keyed fire (the wire head encoder, once per delivery)."""
        return bool(self._specs)

    def arm_from_spec(self, spec: str) -> None:
        """Parse a ``MAXMQ_FAULTS``-style csv and arm each entry."""
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            parts = entry.split(":")
            if len(parts) < 2:
                raise ValueError(f"bad fault spec {entry!r} (want "
                                 "site:mode[:count[:delay_s[:skip]]])")
            site, mode = parts[0], parts[1]
            count = int(parts[2]) if len(parts) > 2 else 1
            delay = float(parts[3]) if len(parts) > 3 else 0.05
            skip = int(parts[4]) if len(parts) > 4 else 0
            self.arm(site, mode, count, delay, skip)

    # -- firing (the production-code side) -----------------------------

    def _take(self, site: str) -> _Spec | None:
        """Pop (and count) the next armed spec for ``site``, or None."""
        if site not in self._specs:       # racy-but-safe fast path
            return None
        with self._lock:
            queue = self._specs.get(site)
            if not queue:
                return None
            spec = queue[0]
            if spec.skip > 0:
                # a pass-through hit: uncounted, one step closer to firing
                spec.skip -= 1
                return None
            if spec.remaining > 0:
                spec.remaining -= 1
                if spec.remaining == 0:
                    queue.pop(0)
                    if not queue:
                        del self._specs[site]
            self.fired[site] = self.fired.get(site, 0) + 1
        return spec

    def fire(self, site: str) -> bool:
        """Trip ``site`` if armed. ``raise`` mode raises InjectedFault,
        ``hang`` sleeps ``delay_s`` then returns True; any other mode
        returns True and the call site acts. Returns False when the site
        is not armed."""
        spec = self._take(site)
        if spec is None:
            return False
        if spec.mode == "raise":
            raise InjectedFault(f"injected fault at {site}")
        if spec.mode == "hang":
            time.sleep(spec.delay_s)
        return True

    def fire_detail(self, site: str,
                    key: str | None = None) -> tuple[str, float] | None:
        """Keyed, async-friendly firing for loop-thread sites: tries the
        instance-scoped arming ``site#key`` first (``client.write#<id>``
        stalls one client's writer), then the plain site. ``raise`` mode
        raises as :meth:`fire` does; every other mode returns (mode,
        delay_s) and the call site acts (an asyncio site awaits the delay
        rather than block the event loop)."""
        spec = self._take(f"{site}#{key}") if key else None
        if spec is None:
            spec = self._take(site)
        if spec is None:
            return None
        if spec.mode == "raise":
            raise InjectedFault(f"injected fault at {site}")
        return spec.mode, spec.delay_s


REGISTRY = FaultRegistry()


def crash_point(point: str) -> None:
    """Die here if the named crash point (``CRASH_POINTS``) is armed:
    ``crash.at#<point>`` fires the registry's ``kill_fn`` (SIGKILL to
    self, no atexit, no flush) whatever its mode. Arming rides
    MAXMQ_FAULTS, e.g. ``crash.at#pre_fsync:kill:1:0:6`` dies at the 7th
    hit; tests swap ``REGISTRY.kill_fn`` first."""
    site = f"{CRASH_AT}#{point}"
    if site not in REGISTRY._specs:     # racy-but-safe fast path
        return
    spec = REGISTRY._take(site)
    if spec is not None:
        REGISTRY.kill_fn()


# module-level conveniences bound to the process registry
arm = REGISTRY.arm
disarm = REGISTRY.disarm
clear = REGISTRY.clear
armed = REGISTRY.armed
fire = REGISTRY.fire
fire_detail = REGISTRY.fire_detail
arm_from_spec = REGISTRY.arm_from_spec
fired = REGISTRY.fired

# env arming: subprocess services inherit MAXMQ_FAULTS through their
# environment
_env_spec = os.environ.get("MAXMQ_FAULTS", "")
if _env_spec:
    REGISTRY.arm_from_spec(_env_spec)
