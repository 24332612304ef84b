"""MQTT wire protocol: codec primitives, properties, reason codes, packets."""

from . import codes
from .codec import FixedHeader, MalformedPacketError, PacketType
from .packets import Packet, ProtocolError, Subscription, Will, parse_stream
from .properties import Properties

__all__ = [
    "codes", "FixedHeader", "MalformedPacketError", "PacketType",
    "Packet", "ProtocolError", "Subscription", "Will", "parse_stream",
    "Properties",
]
