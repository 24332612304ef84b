"""Hook/plugin layer: the event boundary, the auth hooks and the logging
hooks. The storage and journal hooks come with the broker engine."""

from .auth import ACLRule, AllowHook, AuthRule, Ledger, LedgerHook
from .base import Hook, Hooks, RejectPacket
from .logging import LoggingHook, PacketTxLogHook

__all__ = [
    "ACLRule", "AllowHook", "AuthRule", "Ledger", "LedgerHook",
    "Hook", "Hooks", "RejectPacket", "LoggingHook", "PacketTxLogHook",
]
