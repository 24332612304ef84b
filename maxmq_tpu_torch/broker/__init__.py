"""Host-side broker runtime: server engine, sessions, listeners, QoS flows,
the overload ladder's state and the $SYS counters."""

from .client import Client, ClientRegistry, OutboundQueue, PacketIDExhausted
from .inflight import Inflight
from .listeners import (Listener, Listeners, MockListener, SocketListener,
                        TCPListener, UnixListener, WSListener)
from .overload import OverloadState, TokenBucket, top_offenders
from .server import Broker, BrokerOptions, Capabilities
from .sys_info import SysInfo

__all__ = [
    "Client", "ClientRegistry", "OutboundQueue", "PacketIDExhausted",
    "Inflight", "Listener", "Listeners", "MockListener", "SocketListener",
    "TCPListener", "UnixListener", "WSListener", "OverloadState",
    "TokenBucket", "top_offenders", "Broker", "BrokerOptions",
    "Capabilities", "SysInfo",
]
