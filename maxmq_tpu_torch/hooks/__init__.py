"""Hook/plugin layer: the event boundary, the auth hooks, the logging
hooks and persistence (the storage hook and its stores). The write-behind
journal comes with the broker engine."""

from .auth import ACLRule, AllowHook, AuthRule, Ledger, LedgerHook
from .base import Hook, Hooks, RejectPacket
from .logging import LoggingHook, PacketTxLogHook
from .storage import (ClientRecord, MemoryStore, MessageRecord, SQLiteStore,
                      StorageHook, Store, SubscriptionRecord)

__all__ = [
    "ACLRule", "AllowHook", "AuthRule", "Ledger", "LedgerHook",
    "Hook", "Hooks", "RejectPacket", "LoggingHook", "PacketTxLogHook",
    "ClientRecord", "MemoryStore", "MessageRecord", "SQLiteStore",
    "StorageHook", "Store", "SubscriptionRecord",
]
