"""Per-client inflight (unacknowledged QoS 1/2) message tracking and MQTT v5
send/receive quota counters.

Parity surface: vendor/github.com/mochi-co/mqtt/v2/inflight.go.

Copy of the JAX package's ``broker/inflight.py``.
"""

from __future__ import annotations

from ..protocol.packets import Packet


class Inflight:
    """Unacked packets keyed by packet id, plus v5 flow-control quotas.

    ``receive_quota``: how many more QoS>0 publishes we accept from the
    client; ``send_quota``: how many more we may have outstanding to it.
    """

    def __init__(self, receive_maximum: int = 0, send_maximum: int = 0) -> None:
        self._messages: dict[int, Packet] = {}
        # packet ids whose record is known to be in the persistence
        # pipeline/store (written by the storage hook, or restored from
        # it at boot) — lets resend-on-resume skip byte-identical
        # journal rewrites (ADR 014)
        self._stored: set[int] = set()
        self.maximum_receive = receive_maximum
        self.receive_quota = receive_maximum
        self.maximum_send = send_maximum
        self.send_quota = send_maximum

    def __len__(self) -> int:
        return len(self._messages)

    def set(self, packet: Packet) -> bool:
        """Store/replace; True when the packet id was not present before.
        A (re)set invalidates the stored marker: the persisted form no
        longer matches until the storage hook rewrites it."""
        is_new = packet.packet_id not in self._messages
        self._messages[packet.packet_id] = packet
        self._stored.discard(packet.packet_id)
        return is_new

    def get(self, packet_id: int) -> Packet | None:
        return self._messages.get(packet_id)

    def delete(self, packet_id: int) -> bool:
        self._stored.discard(packet_id)
        return self._messages.pop(packet_id, None) is not None

    # -- persistence markers (ADR 014) --------------------------------------

    def note_stored(self, packet_id: int) -> None:
        if packet_id in self._messages:
            self._stored.add(packet_id)

    def stored(self, packet_id: int) -> bool:
        return packet_id in self._stored

    def all(self) -> list[Packet]:
        """Inflight packets ordered by creation time (for resend-on-resume)."""
        return sorted(self._messages.values(), key=lambda p: (p.created, p.packet_id))

    def digest(self) -> tuple[int, int]:
        """(count, xor-of-packet-ids): the order-free inflight-window
        digest replicated with session updates (ADR 016). A takeover
        compares the installed window against the owner's digest —
        cheap enough to ride every update, strong enough to catch a
        dropped or duplicated replication op."""
        x = 0
        for pid in self._messages:
            x ^= pid
        return len(self._messages), x

    def clone(self) -> "Inflight":
        other = Inflight(self.maximum_receive, self.maximum_send)
        other._messages = {k: v.copy() for k, v in self._messages.items()}
        other._stored = set(self._stored)
        return other

    # -- quotas (clamped to maxima) -----------------------------------------

    def take_receive_quota(self) -> bool:
        if self.maximum_receive == 0:
            return True
        if self.receive_quota <= 0:
            return False
        self.receive_quota -= 1
        return True

    def return_receive_quota(self) -> None:
        if self.maximum_receive and self.receive_quota < self.maximum_receive:
            self.receive_quota += 1

    def take_send_quota(self) -> bool:
        if self.maximum_send == 0:
            return True
        if self.send_quota <= 0:
            return False
        self.send_quota -= 1
        return True

    def return_send_quota(self) -> None:
        if self.maximum_send and self.send_quota < self.maximum_send:
            self.send_quota += 1
