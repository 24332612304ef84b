"""Wire-level primitives for the MQTT codec.

Big-endian integers, length-prefixed UTF-8 strings / binary blobs, and the
variable-byte integer used by the fixed header and v5 properties.

Parity surface: vendor/github.com/mochi-co/mqtt/v2/packets/codec.go and
fixedheader.go in the reference. Re-implemented from the MQTT spec.

Copy of the JAX package's ``protocol/codec.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "MalformedPacketError",
    "read_uint16",
    "read_uint32",
    "read_string",
    "read_binary",
    "read_varint",
    "write_uint16",
    "write_uint32",
    "write_string",
    "write_binary",
    "write_varint",
    "varint_len",
    "valid_utf8_string",
    "FixedHeader",
    "PacketType",
]


class MalformedPacketError(ValueError):
    """Raised when wire bytes violate the MQTT encoding rules."""


class PacketType:
    RESERVED = 0
    CONNECT = 1
    CONNACK = 2
    PUBLISH = 3
    PUBACK = 4
    PUBREC = 5
    PUBREL = 6
    PUBCOMP = 7
    SUBSCRIBE = 8
    SUBACK = 9
    UNSUBSCRIBE = 10
    UNSUBACK = 11
    PINGREQ = 12
    PINGRESP = 13
    DISCONNECT = 14
    AUTH = 15

    NAMES = {
        1: "CONNECT", 2: "CONNACK", 3: "PUBLISH", 4: "PUBACK", 5: "PUBREC",
        6: "PUBREL", 7: "PUBCOMP", 8: "SUBSCRIBE", 9: "SUBACK",
        10: "UNSUBSCRIBE", 11: "UNSUBACK", 12: "PINGREQ", 13: "PINGRESP",
        14: "DISCONNECT", 15: "AUTH",
    }


# ---------------------------------------------------------------------------
# Readers: each takes (buf, offset) and returns (value, new_offset).
# ---------------------------------------------------------------------------

def read_uint16(buf: bytes, off: int) -> tuple[int, int]:
    if off + 2 > len(buf):
        raise MalformedPacketError("truncated uint16")
    return (buf[off] << 8) | buf[off + 1], off + 2


def read_uint32(buf: bytes, off: int) -> tuple[int, int]:
    if off + 4 > len(buf):
        raise MalformedPacketError("truncated uint32")
    return int.from_bytes(buf[off:off + 4], "big"), off + 4


def read_binary(buf: bytes, off: int) -> tuple[bytes, int]:
    n, off = read_uint16(buf, off)
    if off + n > len(buf):
        raise MalformedPacketError("truncated binary data")
    return bytes(buf[off:off + n]), off + n


def valid_utf8_string(data: bytes) -> bool:
    """MQTT-1.5.3: well-formed UTF-8 with no U+0000 and no UTF-16 surrogates."""
    try:
        s = data.decode("utf-8", errors="strict")
    except UnicodeDecodeError:
        return False
    return "\x00" not in s


def read_string(buf: bytes, off: int) -> tuple[str, int]:
    data, off = read_binary(buf, off)
    if not valid_utf8_string(data):
        raise MalformedPacketError("invalid utf-8 string")
    return data.decode("utf-8"), off


def read_varint(buf: bytes, off: int) -> tuple[int, int]:
    """Variable byte integer, at most 4 bytes (max 268,435,455)."""
    value = 0
    shift = 0
    for i in range(4):
        if off + i >= len(buf):
            raise MalformedPacketError("truncated variable byte integer")
        b = buf[off + i]
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, off + i + 1
        shift += 7
    raise MalformedPacketError("variable byte integer too long")


# ---------------------------------------------------------------------------
# Writers: append to a bytearray.
# ---------------------------------------------------------------------------

def write_uint16(out: bytearray, value: int) -> None:
    out.append((value >> 8) & 0xFF)
    out.append(value & 0xFF)


def write_uint32(out: bytearray, value: int) -> None:
    out.extend(value.to_bytes(4, "big"))


def write_binary(out: bytearray, data: bytes) -> None:
    if len(data) > 0xFFFF:
        raise MalformedPacketError("binary data exceeds 65535 bytes")
    write_uint16(out, len(data))
    out.extend(data)


def write_string(out: bytearray, s: str) -> None:
    write_binary(out, s.encode("utf-8"))


def write_varint(out: bytearray, value: int) -> None:
    if value < 0 or value > 268_435_455:
        raise MalformedPacketError("variable byte integer out of range")
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def varint_len(value: int) -> int:
    if value < 128:
        return 1
    if value < 16_384:
        return 2
    if value < 2_097_152:
        return 3
    return 4


# ---------------------------------------------------------------------------
# Fixed header
# ---------------------------------------------------------------------------

_FLAGS_REQUIRED = {  # packet type -> required flag nibble (None = variable)
    PacketType.CONNECT: 0, PacketType.CONNACK: 0, PacketType.PUBACK: 0,
    PacketType.PUBREC: 0, PacketType.PUBREL: 2, PacketType.PUBCOMP: 0,
    PacketType.SUBSCRIBE: 2, PacketType.SUBACK: 0, PacketType.UNSUBSCRIBE: 2,
    PacketType.UNSUBACK: 0, PacketType.PINGREQ: 0, PacketType.PINGRESP: 0,
    PacketType.DISCONNECT: 0, PacketType.AUTH: 0,
}


@dataclass
class FixedHeader:
    """First byte (type + flags) and remaining length of every MQTT packet."""

    type: int = 0
    dup: bool = False
    qos: int = 0
    retain: bool = False
    remaining: int = 0

    def encode(self, out: bytearray) -> None:
        b = (self.type << 4)
        if self.type == PacketType.PUBLISH:
            b |= (0x8 if self.dup else 0) | ((self.qos & 0x3) << 1) | (1 if self.retain else 0)
        else:
            b |= _FLAGS_REQUIRED.get(self.type, 0)
        out.append(b)
        write_varint(out, self.remaining)

    @classmethod
    def decode(cls, first_byte: int, remaining: int) -> "FixedHeader":
        ptype = (first_byte >> 4) & 0xF
        flags = first_byte & 0xF
        fh = cls(type=ptype, remaining=remaining)
        if ptype == PacketType.PUBLISH:
            fh.dup = bool(flags & 0x8)
            fh.qos = (flags >> 1) & 0x3
            fh.retain = bool(flags & 0x1)
            if fh.qos == 3:
                raise MalformedPacketError("publish qos 3 is malformed")
            # dup with qos 0 violates the SENDER requirement [MQTT-3.3.1-2]
            # but the receive side tolerates it, as the reference does
            # (tpackets.go TPublishDup is a pass case); the broker clears
            # dup on forward regardless
        else:
            required = _FLAGS_REQUIRED.get(ptype)
            if required is None:
                raise MalformedPacketError(f"reserved packet type {ptype}")
            if flags != required:
                raise MalformedPacketError(
                    f"bad fixed-header flags {flags:#x} for type {ptype}")
        return fh
