"""Subscriber-entry records shared by the compiled tables.

Copy of ``Entry`` and ``EntryBuilder`` from the JAX package's
``matching/nfa.py`` (the NFA engine itself is not ported yet). Each
*entry* is one subscription — a (client, filter) pair for ordinary
subscriptions, or one `$share` (group, filter) pair — so the host can
reconstruct exact merge semantics (max QoS + id union) after matching.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..protocol.packets import Subscription


@dataclass
class Entry:
    """One subscriber bit: an ordinary (client, sub) or a shared pair."""

    client_id: str = ""
    subscription: Subscription | None = None
    group: str = ""          # non-empty => shared pair
    filter: str = ""
    # shared pairs carry the full candidate map
    candidates: dict[str, Subscription] = field(default_factory=dict)

    @property
    def shared(self) -> bool:
        return bool(self.group)


class EntryBuilder:
    """Accumulates Entry records with `$share` (group, filter) dedup."""

    def __init__(self) -> None:
        self.entries: list[Entry] = []
        self._shared: dict[tuple[str, str], int] = {}

    def add(self, filt: str, client_id: str, sub: Subscription,
            group: str) -> int | None:
        """Record one subscription. Returns the bit index to place on the
        row, or None when this shared (group, filter) pair already has
        its bit placed (the new member only joins the candidate map)."""
        if group:
            key = (group, sub.filter)
            bit = self._shared.get(key)
            if bit is not None:
                self.entries[bit].candidates[client_id] = sub
                return None
            bit = len(self.entries)
            self._shared[key] = bit
            entry = Entry(group=group, filter=sub.filter)
            entry.candidates[client_id] = sub
            self.entries.append(entry)
            return bit
        bit = len(self.entries)
        self.entries.append(Entry(client_id=client_id, subscription=sub,
                                  filter=filt))
        return bit
