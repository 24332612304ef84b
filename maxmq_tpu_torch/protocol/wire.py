"""Shared PUBLISH wire templates for zero-copy fan-out (ADR 019).

A publish delivered to N subscribers used to cost N ``Packet.copy()`` +
N full encodes. The wire differences between those N frames are tiny
and structural: the fixed-header flags byte (QoS / retain-as-published),
the 2-byte packet id, and — v5 only — a spliced subscription-id /
topic-alias property segment. Everything else (topic, the shared
property prefix/suffix, the payload) is byte-identical.

This module splits the frame accordingly:

* :func:`publish_template` builds ONE immutable :class:`PublishTemplate`
  per (packet, protocol major version) — cached on the packet like the
  QoS0 ``_wire0`` cache — holding the shared segments.
* :meth:`PublishTemplate.patch` assembles one subscriber's frame as a
  buffer sequence ``(head, [props_a], [mid], [props_u], payload)``:
  only the small head (fixed header + remaining-length varint + topic +
  packet id + property-length varint) and the per-subscriber property
  segment are fresh bytes; the property prefix/suffix and the payload
  are the template's shared objects, never copied per subscriber.

Byte-identity with the slow path (``Packet.encode``) is structural, not
coincidental: the shared property prefix/suffix are produced by
``Properties.encode`` itself (with the per-subscriber properties
cleared), and the spliced segment sits exactly where that encoder puts
subscription ids and the topic alias — contiguously, between the
correlation-data prefix and the user-property suffix. The differential
test matrix in tests/test_wire_templates.py holds this invariant.

The head assembly has a native sibling (``encode_publish_template`` in
``csrc/host/maxmq_torch_decode.cpp``, the port's decode extension); like
the decode fast path it is optional, fault-site wrapped
(``faults.NATIVE_ENCODE``), and falls back to the pure-Python encoder on
any error. ``heads`` counts the heads each encoder made ("native",
"python"), so a run can tell how many deliveries took the fallback.

Copy of the JAX package's ``protocol/wire.py``, with the head counters.
"""

from __future__ import annotations

from .. import faults
from .codec import varint_len, write_uint16, write_varint
from .packets import Packet
from .properties import SUBSCRIPTION_ID, TOPIC_ALIAS

__all__ = ["PublishTemplate", "publish_template", "sid_alias_seg",
           "encode_head", "native_head_encoder", "heads"]

_EMPTY_TOPIC = b"\x00\x00"


# ----------------------------------------------------------------------
# Per-subscriber head assembly: native entry point + Python fallback
# ----------------------------------------------------------------------

_native_head = False        # False = unresolved, None = unavailable
# frame heads made by each encoder since import (or the last reset)
heads = {"native": 0, "python": 0}


def native_head_encoder():
    """The C ``encode_publish_template`` entry point, resolved once
    from the port's decode extension (``native.decode_module``) — or
    None. Resolution failures are permanent for the process (same policy
    as the decode fast path)."""
    global _native_head
    if _native_head is False:
        _native_head = None
        try:
            from .. import native as _native
            mod = _native.decode_module()
            if mod is not None:
                _native_head = getattr(mod, "encode_publish_template",
                                       None)
        except Exception:
            _native_head = None
    return _native_head


def _encode_head_py(flags: int, topic_seg: bytes, packet_id: int,
                    props_len: int, tail_len: int) -> bytes:
    """Pure-Python head encoder: fixed-header byte, remaining-length
    varint, topic segment, optional packet id, optional property-length
    varint. ``props_len < 0`` means a v3 frame (no properties block);
    ``tail_len`` is the byte count that FOLLOWS the head on the wire
    beyond the properties (i.e. the payload)."""
    pid_len = 2 if packet_id else 0
    remaining = len(topic_seg) + pid_len + tail_len
    if props_len >= 0:
        remaining += varint_len(props_len) + props_len
    head = bytearray([flags])
    write_varint(head, remaining)
    head += topic_seg
    if packet_id:
        write_uint16(head, packet_id)
    if props_len >= 0:
        write_varint(head, props_len)
    return bytes(head)


def encode_head(flags: int, topic_seg: bytes, packet_id: int,
                props_len: int, tail_len: int,
                native: bool = True) -> bytes:
    """Frame-head assembly, via the C encoder when available + enabled.
    Any native error — including an armed ``faults.NATIVE_ENCODE``
    site — degrades to the Python encoder for THIS call; the outputs
    are byte-identical by the differential tests."""
    if native:
        enc = _native_head if _native_head is not False \
            else native_head_encoder()
        if enc is not None:
            try:
                if faults.REGISTRY.any_armed():
                    faults.fire(faults.NATIVE_ENCODE)
                head = enc(flags, topic_seg, packet_id, props_len,
                           tail_len)
                heads["native"] += 1
                return head
            except Exception:
                pass
    heads["python"] += 1
    return _encode_head_py(flags, topic_seg, packet_id, props_len,
                           tail_len)


def sid_alias_seg(subscription_ids, topic_alias) -> bytes:
    """The per-subscriber v5 property segment: one 0x0B+varint per
    subscription id, then 0x23+uint16 for an assigned outbound topic
    alias. Spliced between the template's shared property prefix and
    suffix — exactly where ``Properties.encode`` emits them."""
    if not subscription_ids and topic_alias is None:
        return b""
    seg = bytearray()
    for sid in subscription_ids:
        seg.append(SUBSCRIPTION_ID)
        write_varint(seg, sid)
    if topic_alias is not None:
        seg.append(TOPIC_ALIAS)
        write_uint16(seg, topic_alias)
    return bytes(seg)


# ----------------------------------------------------------------------
# The shared template
# ----------------------------------------------------------------------


class PublishTemplate:
    """Immutable shared segments of one publish's outbound frames for
    one protocol major version. ``shared_len`` is the byte count a
    patched delivery reuses without copying (property prefix/suffix +
    payload) — the fan-out ledger's "bytes not copied" term."""

    __slots__ = ("v5", "topic_seg", "props_a", "props_u", "payload",
                 "shared_len")

    def __init__(self, v5: bool, topic_seg: bytes, props_a: bytes,
                 props_u: bytes, payload: bytes) -> None:
        self.v5 = v5
        self.topic_seg = topic_seg
        self.props_a = props_a
        self.props_u = props_u
        self.payload = payload
        self.shared_len = len(props_a) + len(props_u) + len(payload)

    def frame_size(self, mid_len: int, pid: bool,
                   alias_topic: bool = False) -> int:
        """Exact frame size for a delivery with a ``mid_len``-byte
        spliced segment — cheap enough to run per subscriber for the
        maximum-packet-size admission check before any bytes move."""
        topic_len = 2 if alias_topic else len(self.topic_seg)
        body = topic_len + (2 if pid else 0) + len(self.payload)
        if self.v5:
            props_len = len(self.props_a) + mid_len + len(self.props_u)
            body += varint_len(props_len) + props_len
        return 1 + varint_len(body) + body

    def patch(self, qos: int, retain: bool, packet_id: int,
              mid: bytes = b"", alias_topic: bool = False,
              native: bool = True) -> tuple[tuple, int]:
        """One subscriber's frame as ``(buffers, exact_size)``. Only
        the head and ``mid`` are fresh allocations; every other buffer
        is a shared template segment. ``alias_topic`` sends the empty
        topic of an established v5 outbound alias."""
        topic_seg = _EMPTY_TOPIC if alias_topic else self.topic_seg
        flags = 0x30 | ((qos & 0x3) << 1) | (1 if retain else 0)
        payload = self.payload
        if not self.v5:
            head = encode_head(flags, topic_seg, packet_id, -1,
                               len(payload), native)
            if payload:
                return (head, payload), len(head) + len(payload)
            return (head,), len(head)
        props_len = len(self.props_a) + len(mid) + len(self.props_u)
        head = encode_head(flags, topic_seg, packet_id, props_len,
                           len(payload), native)
        bufs = [head]
        if self.props_a:
            bufs.append(self.props_a)
        if mid:
            bufs.append(mid)
        if self.props_u:
            bufs.append(self.props_u)
        if payload:
            bufs.append(payload)
        return tuple(bufs), len(head) + props_len + len(payload)


def _strip_props_varint(buf: bytearray) -> bytes:
    """Drop the leading property-length varint ``Properties.encode``
    writes; the template re-derives it per subscriber."""
    i = 1
    while buf[i - 1] & 0x80:
        i += 1
    return bytes(buf[i:])


def _build_template(packet: Packet, version: int) -> PublishTemplate:
    from .codec import PacketType as PT
    topic = packet.topic.encode("utf-8")
    topic_seg = len(topic).to_bytes(2, "big") + topic
    payload = bytes(packet.payload or b"")
    if version < 5:
        return PublishTemplate(False, topic_seg, b"", b"", payload)
    # Split the shared v5 property bytes around the per-subscriber
    # splice point by running the REAL property encoder twice: once
    # without the suffix (user properties) for the prefix length, once
    # with it for prefix+suffix. The per-subscriber properties
    # (subscription ids, topic alias) are cleared for both passes —
    # inbound alias ids must not leak into deliveries, matching
    # _build_outbound.
    pr = packet.properties
    saved = (pr.subscription_ids, pr.topic_alias, pr.user_properties)
    try:
        pr.subscription_ids, pr.topic_alias = [], None
        pr.user_properties = []
        buf = bytearray()
        pr.encode(buf, PT.PUBLISH)
        props_a = _strip_props_varint(buf)
        pr.user_properties = saved[2]
        buf = bytearray()
        pr.encode(buf, PT.PUBLISH)
        both = _strip_props_varint(buf)
    finally:
        pr.subscription_ids, pr.topic_alias, pr.user_properties = saved
    return PublishTemplate(True, topic_seg, props_a,
                           both[len(props_a):], payload)


def publish_template(packet: Packet, version: int) -> PublishTemplate:
    """The (packet, version) shared template, built once and cached on
    the packet instance (same lifetime discipline as the QoS0 ``_wire0``
    wire cache: dies with the publish)."""
    key = 5 if version >= 5 else 4
    cache = packet.__dict__.get("_tmpl")
    if cache is None:
        cache = {}
        packet.__dict__["_tmpl"] = cache
    tmpl = cache.get(key)
    if tmpl is None:
        tmpl = _build_template(packet, key)
        cache[key] = tmpl
    return tmpl
