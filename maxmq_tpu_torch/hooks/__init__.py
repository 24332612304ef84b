"""Hook/plugin layer: the event boundary, the auth hooks, the logging
hooks and persistence (the storage hook, its stores, and the write-behind
journal with its disk-fault shim)."""

from .auth import ACLRule, AllowHook, AuthRule, Ledger, LedgerHook
from .base import Hook, Hooks, RejectPacket
from .journal import WriteBehindStore
from .logging import LoggingHook, PacketTxLogHook
from .storage import (ClientRecord, MemoryStore, MessageRecord, SQLiteStore,
                      StorageHook, Store, SubscriptionRecord)

__all__ = [
    "ACLRule", "AllowHook", "AuthRule", "Ledger", "LedgerHook",
    "Hook", "Hooks", "RejectPacket", "LoggingHook", "PacketTxLogHook",
    "ClientRecord", "MemoryStore", "MessageRecord", "SQLiteStore",
    "StorageHook", "Store", "SubscriptionRecord", "WriteBehindStore",
]
