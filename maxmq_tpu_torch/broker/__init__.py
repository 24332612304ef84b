"""Host-side broker runtime: clients and their transport loops, the
listeners, inflight tracking, the overload ladder's state and the $SYS
counters. The server engine (``Broker``) comes with the broker engine."""

from .client import Client, ClientRegistry, OutboundQueue, PacketIDExhausted
from .inflight import Inflight
from .listeners import (Listener, Listeners, MockListener, SocketListener,
                        TCPListener, UnixListener, WSListener)
from .overload import OverloadState, TokenBucket, top_offenders
from .sys_info import SysInfo

__all__ = [
    "Client", "ClientRegistry", "OutboundQueue", "PacketIDExhausted",
    "Inflight", "Listener", "Listeners", "MockListener", "SocketListener",
    "TCPListener", "UnixListener", "WSListener", "OverloadState",
    "TokenBucket", "top_offenders", "SysInfo",
]
