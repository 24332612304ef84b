"""Host-side broker runtime: inflight tracking, the overload ladder's
state and the $SYS counters. The server engine, clients and listeners
come with the broker engine."""

from .inflight import Inflight
from .overload import OverloadState, TokenBucket, top_offenders
from .sys_info import SysInfo

__all__ = ["Inflight", "OverloadState", "TokenBucket", "top_offenders",
           "SysInfo"]
