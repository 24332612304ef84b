"""The subscription record carried by SUBSCRIBE packets and match results.

Copy of ``Subscription`` from the JAX package's ``protocol/packets.py``
(the packet codecs stay with the broker, which this package does not
carry yet). Field names, order and defaults are the wire contract of the
matcher service's JSON encoding (``matching/service.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Subscription:
    """One topic filter within SUBSCRIBE, plus v5 subscription options."""

    filter: str
    qos: int = 0
    no_local: bool = False
    retain_as_published: bool = False
    retain_handling: int = 0
    identifier: int = 0  # v5 subscription identifier attached at subscribe time
    # Merged view when one client holds several overlapping matching filters.
    identifiers: dict[str, int] = field(default_factory=dict)
