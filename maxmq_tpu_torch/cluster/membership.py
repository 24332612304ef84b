"""Cluster membership: static seed list + liveness from bridge
keepalives (ADR 013).

Membership here is deliberately NOT a consensus protocol: the peer set
is the operator-supplied seed list (``cluster_peers``), and the only
dynamic fact tracked per peer is link liveness — last successful
keepalive/connect, connection state, and the flap count. A peer whose
link is down keeps its routes in the table (delivery degrades to
local-only while forwards to it are skipped); a peer that RESTARTED is
detected by the higher epoch in its first snapshot, which flushes the
old incarnation's routes (routes.py).

Copy of the JAX package's ``cluster/membership.py``.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

# node ids ride inside ``$cluster/...`` topic levels: one level, no
# wildcards, no separators
_NODE_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")


class PeerSpecError(ValueError):
    pass


def valid_node_id(node_id: str) -> bool:
    return bool(_NODE_ID_RE.match(node_id))


@dataclass(frozen=True)
class PeerSpec:
    node_id: str
    host: str
    port: int
    # ADR 021 local link flavor: a non-empty unix-socket path replaces
    # host:port — the bridge connects over the loopback filesystem
    # (no TCP handshake, budget-exempt, clock skew pinned to zero)
    path: str = ""

    @property
    def local(self) -> bool:
        return bool(self.path)


def parse_peers(spec: str) -> list[PeerSpec]:
    """Parse ``cluster_peers``: comma-separated ``node@host:port``
    entries (``nodeB@10.0.0.2:1883,nodeC@10.0.0.3:1883``). An
    ``node@unix:/path.sock`` entry is an ADR-021 local (unix-domain)
    peer — the in-box worker mesh rides these."""
    peers: list[PeerSpec] = []
    seen: set[str] = set()
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        node_id, at, addr = entry.partition("@")
        if not at:
            raise PeerSpecError(
                f"bad peer {entry!r} (want node@host:port)")
        if not valid_node_id(node_id):
            raise PeerSpecError(f"bad peer node id {node_id!r}")
        if node_id in seen:
            raise PeerSpecError(f"duplicate peer node id {node_id!r}")
        seen.add(node_id)
        if addr.startswith("unix:"):
            path = addr[len("unix:"):]
            if not path:
                raise PeerSpecError(f"bad peer {entry!r} "
                                    f"(want node@unix:/path.sock)")
            peers.append(PeerSpec(node_id, "", 0, path=path))
            continue
        host, colon, port_s = addr.rpartition(":")
        if not colon or not host:
            raise PeerSpecError(
                f"bad peer {entry!r} (want node@host:port)")
        try:
            port = int(port_s)
        except ValueError:
            raise PeerSpecError(f"bad peer port {port_s!r}") from None
        peers.append(PeerSpec(node_id, host, port))
    return peers


@dataclass
class PeerState:
    spec: PeerSpec
    connected: bool = False
    last_seen: float = 0.0          # monotonic; last keepalive/connect
    epoch: int = 0                  # last snapshot epoch seen
    flaps: int = 0                  # up->down transitions
    connect_attempts: int = 0
    last_error: str = ""
    # ADR 017: wire capabilities the peer announced on $cluster/hello
    # (version negotiation — a peer that never said "fwd-trace" gets
    # pre-017 envelopes, so an old binary never sees the new segment)
    caps: frozenset = frozenset()
    # ADR 017: EWMA clock-skew estimate from the keepalive-driven
    # clock probes — peer_monotonic_ns minus ours at the RTT midpoint
    skew_ns: float = 0.0
    rtt_ns: float = 0.0
    skew_samples: int = 0
    extras: dict = field(default_factory=dict)


class Membership:
    """Peer liveness ledger, updated by the bridge links."""

    def __init__(self, peers: list[PeerSpec]) -> None:
        self.peers: dict[str, PeerState] = {
            p.node_id: PeerState(spec=p) for p in peers}

    def get(self, node_id: str) -> PeerState | None:
        return self.peers.get(node_id)

    def note_up(self, node_id: str) -> None:
        st = self.peers.get(node_id)
        if st is not None:
            st.connected = True
            st.last_seen = time.monotonic()

    def note_alive(self, node_id: str) -> None:
        st = self.peers.get(node_id)
        if st is not None:
            st.last_seen = time.monotonic()

    def note_down(self, node_id: str, error: str = "") -> None:
        st = self.peers.get(node_id)
        if st is None:
            return
        if st.connected:
            st.flaps += 1
        st.connected = False
        if error:
            st.last_error = error

    def live_nodes(self) -> list[str]:
        return [n for n, st in self.peers.items() if st.connected]
