"""Deterministic fault injection for the matcher degradation ladder.

The registry core of the JAX package's ``faults.py``, for the sites the
matcher service, the publish pipeline, the broker engine, its leaf
modules and the worker pool run: a pool worker that dies, a device call
that raises or hangs, a table recompile that fails, a service socket
that drops, a native frame-head encode that fails, a client writer that
stalls, a connection accept that is refused, a content-plane evaluation
or window emission that fails, a stored record that fails to restore, a
journal write or group commit that fails, a disk that errors, fills,
fails its fsync or stalls under the journal (``hooks/faultstore.py``),
the named crash points, and the cluster federation's sites: a bridge
link that fails to connect, a route apply that fails, a session
replication send or apply and a takeover's state handoff that fail or
hang, and the directed network partitions (``partition``, ``heal``) and
WAN link shapes (``ShapeSpec``, ``shape``, ``unshape``) between nodes.
Sites cost one dict lookup on an (almost always) empty dict when nothing
is armed.

``arm(site, mode, count)`` fires the fault for exactly the next
``count`` hits of that site (``count=-1`` = until disarmed), then
self-disarms. Modes:

* ``raise`` — the site raises :class:`InjectedFault` (a
  :class:`DeviceMatchError`);
* ``hang``  — the site blocks for ``delay_s`` seconds;
* anything else (``drop``, ``exit``, ...) — ``fire`` returns True and
  the SITE acts (the matcher service closes the client connection, a
  pool worker stops itself); ``fire_detail`` hands (mode, delay_s) to
  loop-thread sites, which await the delay themselves.

Env arming (``MAXMQ_FAULTS``) reaches processes a test cannot touch by
reference::

    MAXMQ_FAULTS="device.match:raise:3,device.match:hang:1:0.5"

parses as ``site:mode[:count[:delay_s[:skip]]]``, comma-separated,
applied in order; ``skip`` lets a fault pass its first N hits. Because
each subprocess parses the env at import, the pool parent delivers
``pool.worker`` entries to exactly ONE initial worker spawn and strips
them everywhere else (``broker/workers.py``): a worker-kill drill means
one death, not a pool-wide crash loop.
"""

from __future__ import annotations

import os
import signal
import threading
import time
import zlib


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
POOL_WORKER = "pool.worker"            # delivery-pool worker process
NATIVE_ENCODE = "native.encode"        # C publish-frame head assembly
                                       # (trips fall back to the
                                       # pure-Python encoder)
CLIENT_WRITE = "client.write"          # broker client writer loop
LISTENER_ACCEPT = "listener.accept"    # broker connection accept
CLUSTER_PARTITION = "cluster.partition"  # directed inter-node network
                                       # partition (keyed per link
                                       # direction "src->dst")
CLUSTER_SHAPE = "cluster.shape"        # directed inter-node WAN link
                                       # shape (keyed "src->dst": delay/
                                       # jitter/rate/loss, not binary)
CLUSTER_LINK = "cluster.link"          # bridge link connect/pump
CLUSTER_SESSION_SYNC = "cluster.session_sync"  # session replication send/
                                       # apply (keyed per peer)
CLUSTER_TAKEOVER = "cluster.takeover"  # CONNECT takeover/state handoff
                                       # (keyed per prior owner)
CLUSTER_ROUTE_APPLY = "cluster.route_apply"  # route snapshot/delta apply
FILTER_EVAL = "filter.eval"            # content-plane batch evaluation
                                       # (trips fail OPEN: the flush
                                       # delivers unfiltered)
FILTER_WINDOW = "filter.window"        # aggregate window emission
                                       # (trips shed that emission,
                                       # counted in agg_shed)
STORAGE_PUT = "storage.put"            # journal enqueue boundary
STORAGE_COMMIT = "storage.commit"      # journal writer-thread group commit
STORAGE_RESTORE = "storage.restore"    # per-record boot restore parse
DISK_WRITE = "disk.write"              # backend write/commit path: an
                                       # armed trip surfaces as EIO from
                                       # the store
DISK_ENOSPC = "disk.enospc"            # backend commit: disk full
                                       # (ENOSPC) from the store
DISK_FSYNC = "disk.fsync"              # backend commit: write landed,
                                       # fsync FAILED — dirty-page state
                                       # unknown (fsyncgate; the journal
                                       # must poison + reopen + replay)
DISK_LATENCY = "disk.latency"          # backend commit latency (hang
                                       # mode sleeps the WRITER thread)
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


class ShapeSpec:
    """One directed link's WAN shape (ADR 022): fixed one-way delay,
    uniform jitter, a token-bucket rate limit, and probabilistic loss.

    Everything here is pure integer-ns arithmetic over clocks the CALL
    SITE reads (through ``REGISTRY.clock_ns``), and the only randomness
    is a private xorshift64* stream seeded from the link key — so a
    scripted-clock test replays the exact same jitter/loss sequence
    every run. The spec never sleeps; :meth:`depart_ns` answers "when
    may this item hit the far end", and the bridge's deferral queue
    does the (non-blocking) waiting.

    Reorder preservation: a jitter draw that would land an item before
    its predecessor is clamped to the predecessor's departure — a
    shaped link is a slow FIFO pipe, never a packet shuffler (the blip
    audit's FIFO claim, ADR 020, must keep holding on shaped links).
    """

    __slots__ = ("delay_ns", "jitter_ns", "rate_bps", "loss",
                 "burst_bytes", "deferrals", "losses", "_rng",
                 "_last_depart_ns", "_tokens", "_tb_stamp_ns")

    def __init__(self, delay_ms: float = 0.0, jitter_ms: float = 0.0,
                 rate_bps: int = 0, loss: float = 0.0,
                 burst_bytes: int = 16384, seed: int = 0) -> None:
        if delay_ms < 0 or jitter_ms < 0 or rate_bps < 0 \
                or not 0.0 <= loss <= 1.0:
            raise ValueError("bad shape (want delay_ms/jitter_ms/"
                             "rate_bps >= 0, 0 <= loss <= 1)")
        self.delay_ns = int(delay_ms * 1e6)
        self.jitter_ns = int(jitter_ms * 1e6)
        self.rate_bps = int(rate_bps)
        self.loss = float(loss)
        self.burst_bytes = max(int(burst_bytes), 1)
        self.deferrals = 0          # items that actually waited
        self.losses = 0             # items the loss draw ate
        self._rng = (seed & 0xFFFFFFFFFFFFFFFF) or 0x9E3779B97F4A7C15
        self._last_depart_ns = 0    # FIFO fence (reorder preservation)
        self._tokens: float | None = None   # bucket starts full
        self._tb_stamp_ns = 0

    # -- deterministic randomness --------------------------------------

    def rand(self) -> float:
        """Next [0, 1) draw from the spec's private xorshift64* stream
        (no ``random`` module state: two shaped links never perturb
        each other's sequences, and a fixed seed replays exactly)."""
        x = self._rng
        x ^= (x << 13) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 7
        x ^= (x << 17) & 0xFFFFFFFFFFFFFFFF
        self._rng = x
        return ((x * 0x2545F4914F6CDD1D) & 0xFFFFFFFFFFFFFFFF) \
            / float(1 << 64)

    def lose(self) -> bool:
        """One loss draw; counted."""
        if self.loss <= 0.0:
            return False
        if self.rand() >= self.loss:
            return False
        self.losses += 1
        return True

    # -- timing math (all ns, caller supplies now) ---------------------

    def _rate_wait_ns(self, now_ns: int, nbytes: int) -> int:
        """Token bucket: ``burst_bytes`` of credit refilled at
        ``rate_bps``; a send overdraws the bucket and the debt converts
        to wait time — burst passes at line rate, sustained traffic
        paces to the configured bandwidth."""
        if not self.rate_bps:
            return 0
        per_ns = self.rate_bps / 8 / 1e9        # bytes per ns
        if self._tokens is None:
            self._tokens = float(self.burst_bytes)
        else:
            self._tokens = min(
                float(self.burst_bytes),
                self._tokens + (now_ns - self._tb_stamp_ns) * per_ns)
        self._tb_stamp_ns = now_ns
        self._tokens -= nbytes
        if self._tokens >= 0:
            return 0
        return int(-self._tokens / per_ns)

    def depart_ns(self, now_ns: int, nbytes: int) -> int:
        """The instant this item may be released to the wire: now +
        delay + jitter draw + token-bucket wait, clamped to never
        precede the previous item's departure (FIFO)."""
        t = now_ns + self.delay_ns
        if self.jitter_ns:
            t += int(self.rand() * self.jitter_ns)
        t += self._rate_wait_ns(now_ns, nbytes)
        if t < self._last_depart_ns:
            t = self._last_depart_ns
        self._last_depart_ns = t
        if t > now_ns:
            self.deferrals += 1
        return t

    @property
    def oneway_s(self) -> float:
        """Expected one-way propagation (delay + mean jitter), seconds
        — the liveness sites' sleep when emulating a ping round trip."""
        return (self.delay_ns + self.jitter_ns / 2) / 1e9


def _sigkill_self() -> None:
    os.kill(os.getpid(), signal.SIGKILL)


class FaultRegistry:
    """Thread-safe armed-fault table. One global instance (``REGISTRY``)
    serves the whole process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # site -> FIFO of specs (so "raise twice then hang once" scripts)
        self._specs: dict[str, list[_Spec]] = {}
        # directed link key "src->dst" -> ShapeSpec; separate from _specs
        # because a shape is continuous state (bucket fill, FIFO fence,
        # PRNG stream), not a countdown of discrete trips
        self._shapes: dict[str, ShapeSpec] = {}
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
            self._shapes.clear()
            self.fired.clear()

    def armed(self, site: str) -> bool:
        return site in self._specs

    # -- directed link shapes -------------------------------------------

    def set_shape(self, key: str, spec: ShapeSpec) -> None:
        with self._lock:
            self._shapes[key] = spec

    def get_shape(self, key: str) -> ShapeSpec | None:
        """Racy-but-safe hot-path lookup (one dict get on an almost
        always empty dict), mirroring the ``fire`` fast path."""
        if not self._shapes:
            return None
        return self._shapes.get(key)

    def del_shape(self, key: str) -> None:
        with self._lock:
            self._shapes.pop(key, None)

    def any_shaped(self) -> bool:
        return bool(self._shapes)

    def count_fired(self, site_key: str) -> None:
        """Count one shape action under ``fired``."""
        self.fired[site_key] = self.fired.get(site_key, 0) + 1

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


def partition_key(src: str, dst: str) -> str:
    """The key of the directed link ``src -> dst`` under the
    ``cluster.partition`` and ``cluster.shape`` sites."""
    return f"{src}->{dst}"


def partition(a: str, b: str, mode: str = "drop",
              delay_s: float = 0.05) -> None:
    """Arm a network partition between nodes ``a`` and ``b``: the
    ``cluster.partition`` site keyed per direction, fired wherever bytes
    cross a node boundary (bridge connect, keepalive ping, the bridge
    writer, the receiving broker's ``$cluster`` inbound). ``drop`` makes
    the bytes vanish, ``hang`` delays them ``delay_s``; both arm both
    directions, ``mode="asym"`` arms a->b only (drop). Stays armed until
    :func:`heal`."""
    if mode == "asym":
        dirs, armed_mode = [(a, b)], "drop"
    elif mode in ("drop", "hang"):
        dirs, armed_mode = [(a, b), (b, a)], mode
    else:
        raise ValueError(f"unknown partition mode {mode!r} "
                         "(want drop/hang/asym)")
    for src, dst in dirs:
        REGISTRY.arm(f"{CLUSTER_PARTITION}#{partition_key(src, dst)}",
                     armed_mode, -1, delay_s)


def heal(a: str, b: str) -> None:
    """Disarm a partition between ``a`` and ``b`` (both directions)."""
    for src, dst in ((a, b), (b, a)):
        REGISTRY.disarm(f"{CLUSTER_PARTITION}#{partition_key(src, dst)}")


# ----------------------------------------------------------------------
# WAN link shaping (ADR 022): the ``cluster.shape`` site family
# ----------------------------------------------------------------------
#
# Like ``cluster.partition`` the site is keyed per DIRECTED link
# (``cluster.shape#A->B``), but a shape is continuous degradation, not
# a binary fault: one-way delay, jitter, a token-bucket rate limit,
# and probabilistic loss. The production code consults it at the same
# three boundaries the partition plumbing hooks, with the aspects
# split so the in-process harness (one registry serving both ends of
# every link) never double-applies a direction:
#
# * bridge connect / keepalive (liveness, sender side) — the emulated
#   ping round trip sleeps both directions' one-way delay and a loss
#   draw fails the probe, so liveness sees the WAN the data sees;
# * the bridge writer (data, sender side) — delay + jitter + rate,
#   via a non-blocking reorder-preserving deferral queue;
# * the receiving broker's ``$cluster`` inbound (data, receiver side)
#   — the loss draw: a dropped message is in-flight loss (no ack, no
#   apply), which is what arms the ADR-020 blip audit + parked-retry
#   machinery rather than a link flap.
#
# ``shape(a, b, ...)`` arms ONE direction (asymmetric bandwidth is the
# point of per-direction arming); ``unshape(a, b)`` clears both.


def shape(a: str, b: str, *, delay_ms: float = 0.0,
          jitter_ms: float = 0.0, rate_bps: int = 0, loss: float = 0.0,
          burst_bytes: int = 16384, seed: int | None = None) -> ShapeSpec:
    """Arm the directed WAN shape ``a -> b`` (ADR 022) and return its
    spec. The PRNG seed defaults to a CRC of the link key — stable
    across runs, distinct per direction."""
    key = partition_key(a, b)
    if seed is None:
        seed = zlib.crc32(key.encode())
    spec = ShapeSpec(delay_ms=delay_ms, jitter_ms=jitter_ms,
                     rate_bps=rate_bps, loss=loss,
                     burst_bytes=burst_bytes, seed=seed)
    REGISTRY.set_shape(key, spec)
    return spec


def unshape(a: str, b: str) -> None:
    """Disarm the WAN shape between ``a`` and ``b`` (both directions)."""
    for src, dst in ((a, b), (b, a)):
        REGISTRY.del_shape(partition_key(src, dst))


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
any_armed = REGISTRY.any_armed
fire_detail = REGISTRY.fire_detail
get_shape = REGISTRY.get_shape
any_shaped = REGISTRY.any_shaped
arm_from_spec = REGISTRY.arm_from_spec
fired = REGISTRY.fired

# env arming: subprocess services and pool workers inherit MAXMQ_FAULTS
# through their environment
_env_spec = os.environ.get("MAXMQ_FAULTS", "")
if _env_spec:
    REGISTRY.arm_from_spec(_env_spec)
