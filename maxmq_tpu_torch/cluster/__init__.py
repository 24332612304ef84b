"""Cluster federation layer (ADR 013 + 016 + 017): bridge links,
aggregated route propagation, cross-node publish forwarding, federated
sessions (epoch-safe takeover, replicated inflight, cluster-wide
``$share``), and the cluster observability plane (cross-node trace
propagation, telemetry gossip, clock-skew estimation) over N broker
processes.

Copy of the JAX package's ``cluster`` package."""

from .bridge import BRIDGE_ID_PREFIX, BridgeLink
from .manager import ClusterManager, DedupWindow
from .membership import (Membership, PeerSpec, PeerSpecError,
                         parse_peers, valid_node_id)
from .routes import (IncrementalCover, RouteTable, RouteWireError,
                     ShareLedger, decode_delta, decode_snapshot,
                     decode_snapshot_preds, encode_delta,
                     encode_snapshot, filter_subsumes, minimal_cover)
from .sessions import SessionEntry, SessionFederation
from .telemetry import WIRE_CAPS, ClusterTelemetry

__all__ = [
    "BRIDGE_ID_PREFIX", "BridgeLink", "ClusterManager", "DedupWindow",
    "Membership", "PeerSpec", "PeerSpecError", "parse_peers",
    "valid_node_id", "IncrementalCover", "RouteTable", "RouteWireError",
    "ShareLedger", "decode_delta", "decode_snapshot",
    "decode_snapshot_preds", "encode_delta", "encode_snapshot",
    "filter_subsumes", "minimal_cover",
    "SessionEntry", "SessionFederation", "ClusterTelemetry",
    "WIRE_CAPS",
]
