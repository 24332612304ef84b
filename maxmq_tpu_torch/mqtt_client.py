"""A minimal asyncio MQTT client (v3.1.1 / v5).

Fills the role the Eclipse Paho client plays in the reference's system tests
(tests/system/mqtt_test.go) and doubles as the benchmark load generator.

Copy of the JAX package's ``mqtt_client.py``.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

from .protocol.codec import FixedHeader, PacketType as PT
from .protocol.packets import Packet, Subscription, Will, parse_stream
from .protocol.properties import Properties


@dataclass
class Message:
    topic: str
    payload: bytes
    qos: int = 0
    retain: bool = False
    properties: Properties = field(default_factory=Properties)
    # ADR 017: cross-node trace identity ("<origin>:<id>") carried on
    # the delivery's ``mq-trace`` v5 user property when the publish
    # rode a sampled trace — one grep key across every node's logs,
    # /traces pages, and the bench subscribers
    trace: str = ""


class MQTTError(Exception):
    pass


class MQTTClient:
    """One client connection. Usage::

        c = MQTTClient("cl1", version=5)
        await c.connect("127.0.0.1", 1883)
        await c.subscribe("a/#", qos=1)
        await c.publish("a/b", b"hi", qos=1)
        msg = await c.next_message(timeout=1)
        await c.disconnect()
    """

    def __init__(self, client_id: str = "", version: int = 4,
                 clean_start: bool = True, keepalive: int = 60,
                 username: str = "", password: str = "",
                 will: Will | None = None,
                 session_expiry: int | None = None) -> None:
        self.client_id = client_id
        self.version = version
        self.clean_start = clean_start
        self.keepalive = keepalive
        self.username = username
        self.password = password
        self.will = will
        self.session_expiry = session_expiry
        self.reader: asyncio.StreamReader | None = None
        self.writer = None
        self.connack: Packet | None = None
        # CONNACK outcome surfaced to callers even when connect()
        # raises (bridge links log the broker's refusal reason instead
        # of a bare MQTTError, ADR 013)
        self.connack_reason: int | None = None
        self.session_present: bool | None = None
        # first fatal transport error; the read loop used to swallow
        # these silently (mirrors broker Client.write_error, ADR 012)
        self.transport_error: str | None = None
        self.messages: asyncio.Queue[Message] = asyncio.Queue()
        self.disconnect_packet: Packet | None = None
        self._acks: dict[tuple[int, int], asyncio.Future] = {}
        self._next_id = 0
        self._read_task: asyncio.Task | None = None
        self._closed = asyncio.Event()
        self._inbound_pubrel_pending: set[int] = set()

    # ------------------------------------------------------------------

    async def connect(self, host: str = "127.0.0.1", port: int = 1883,
                      timeout: float = 5.0, reader=None, writer=None,
                      path: str | None = None) -> Packet:
        """Open the transport (or adopt a provided stream pair) and perform
        the CONNECT/CONNACK handshake. ``path`` connects over a unix
        domain socket instead of TCP (the ADR-021 local bridge flavor)."""
        if reader is None:
            if path is not None:
                self.reader, self.writer = await asyncio.wait_for(
                    asyncio.open_unix_connection(path), timeout)
            else:
                self.reader, self.writer = await asyncio.wait_for(
                    asyncio.open_connection(host, port), timeout)
        else:
            self.reader, self.writer = reader, writer
        self.writer.write(self._connect_packet().encode())
        await self.writer.drain()

        buf = bytearray()
        while True:
            chunk = await asyncio.wait_for(self.reader.read(65536), timeout)
            if not chunk:
                raise MQTTError("connection closed before CONNACK")
            buf.extend(chunk)
            for fh, body in parse_stream(buf):
                if fh.type != PT.CONNACK:
                    raise MQTTError(f"expected CONNACK, got {fh.type}")
                self.connack = Packet.decode(fh, body, self.version)
                self.connack_reason = self.connack.reason_code
                self.session_present = self.connack.session_present
                if self.connack.reason_code >= 0x80 or (
                        self.version < 5 and self.connack.reason_code != 0):
                    raise MQTTError(
                        f"connect refused: {self.connack.reason_code:#x}")
                if self.connack.properties.assigned_client_id:
                    self.client_id = self.connack.properties.assigned_client_id
                self._read_task = asyncio.get_running_loop().create_task(
                    self._read_loop(bytes(buf)))
                return self.connack

    def _connect_packet(self) -> Packet:
        packet = Packet(fixed=FixedHeader(type=PT.CONNECT),
                        protocol_version=self.version,
                        clean_start=self.clean_start,
                        keepalive=self.keepalive,
                        client_id=self.client_id,
                        will=self.will)
        if self.username:
            packet.username = self.username.encode()
            packet.username_flag = True
        if self.password:
            packet.password = self.password.encode()
            packet.password_flag = True
        if self.version >= 5 and self.session_expiry is not None:
            packet.properties.session_expiry = self.session_expiry
        return packet

    async def _read_loop(self, initial: bytes = b"") -> None:
        buf = self._read_buf = bytearray(initial)
        try:
            while True:
                for fh, body in parse_stream(buf):
                    await self._handle(Packet.decode(fh, body, self.version))
                chunk = await self.reader.read(65536)
                if not chunk:
                    break
                buf.extend(chunk)
        except asyncio.CancelledError:
            pass
        except (ConnectionError, OSError) as exc:
            # swallowed (the loop must end either way), but recorded:
            # a bridge supervisor reports WHY its link died, and tests
            # can assert on it instead of guessing (ADR 013)
            self.transport_error = self.transport_error or repr(exc)
        finally:
            self._closed.set()
            for fut in self._acks.values():
                if not fut.done():
                    fut.set_exception(MQTTError("connection closed"))

    async def pause_reading(self) -> bytes:
        """Stop the internal read task and return any unconsumed buffered
        bytes; the caller then owns ``self.reader`` (raw-socket
        harnesses that count frames without per-message decode)."""
        if self._read_task is not None:
            self._read_task.cancel()
            try:
                await self._read_task
            except asyncio.CancelledError:
                pass
            self._read_task = None
        return bytes(getattr(self, "_read_buf", b""))

    async def _handle(self, packet: Packet) -> None:
        t = packet.type
        if t == PT.PUBLISH:
            await self._handle_publish(packet)
        elif t in (PT.PUBACK, PT.PUBCOMP, PT.SUBACK, PT.UNSUBACK):
            fut = self._acks.pop((t, packet.packet_id), None)
            if fut is not None and not fut.done():
                fut.set_result(packet)
        elif t == PT.PUBREC:
            rel = Packet(fixed=FixedHeader(type=PT.PUBREL),
                         protocol_version=self.version,
                         packet_id=packet.packet_id)
            self.writer.write(rel.encode())
            await self.writer.drain()
        elif t == PT.PUBREL:
            self._inbound_pubrel_pending.discard(packet.packet_id)
            comp = Packet(fixed=FixedHeader(type=PT.PUBCOMP),
                          protocol_version=self.version,
                          packet_id=packet.packet_id)
            self.writer.write(comp.encode())
            await self.writer.drain()
        elif t == PT.PINGRESP:
            fut = self._acks.pop((t, 0), None)
            if fut is not None and not fut.done():
                fut.set_result(packet)
        elif t == PT.DISCONNECT:
            self.disconnect_packet = packet

    async def _handle_publish(self, packet: Packet) -> None:
        msg = Message(topic=packet.topic, payload=packet.payload,
                      qos=packet.fixed.qos, retain=packet.fixed.retain,
                      properties=packet.properties,
                      trace=next((v for k, v in
                                  packet.properties.user_properties
                                  if k == "mq-trace"), ""))
        if packet.fixed.qos == 1:
            ack = Packet(fixed=FixedHeader(type=PT.PUBACK),
                         protocol_version=self.version,
                         packet_id=packet.packet_id)
            self.writer.write(ack.encode())
            await self.writer.drain()
        elif packet.fixed.qos == 2:
            dup = packet.packet_id in self._inbound_pubrel_pending
            self._inbound_pubrel_pending.add(packet.packet_id)
            rec = Packet(fixed=FixedHeader(type=PT.PUBREC),
                         protocol_version=self.version,
                         packet_id=packet.packet_id)
            self.writer.write(rec.encode())
            await self.writer.drain()
            if dup:
                return  # exactly-once: don't surface the duplicate
        await self.messages.put(msg)

    # ------------------------------------------------------------------

    def _alloc_id(self) -> int:
        self._next_id = (self._next_id % 65535) + 1
        return self._next_id

    def _await_ack(self, ptype: int, packet_id: int) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        self._acks[(ptype, packet_id)] = fut
        return fut

    async def subscribe(self, *filters: str | tuple[str, int], qos: int = 0,
                        timeout: float = 5.0, **opts) -> list[int]:
        subs = []
        for f in filters:
            if isinstance(f, tuple):
                subs.append(Subscription(filter=f[0], qos=f[1], **opts))
            else:
                subs.append(Subscription(filter=f, qos=qos, **opts))
        pid = self._alloc_id()
        packet = Packet(fixed=FixedHeader(type=PT.SUBSCRIBE),
                        protocol_version=self.version, packet_id=pid,
                        filters=subs)
        fut = self._await_ack(PT.SUBACK, pid)
        self.writer.write(packet.encode())
        await self.writer.drain()
        ack = await asyncio.wait_for(fut, timeout)
        return ack.reason_codes

    async def unsubscribe(self, *filters: str, timeout: float = 5.0) -> list[int]:
        pid = self._alloc_id()
        packet = Packet(fixed=FixedHeader(type=PT.UNSUBSCRIBE),
                        protocol_version=self.version, packet_id=pid,
                        filters=[Subscription(filter=f) for f in filters])
        fut = self._await_ack(PT.UNSUBACK, pid)
        self.writer.write(packet.encode())
        await self.writer.drain()
        ack = await asyncio.wait_for(fut, timeout)
        return ack.reason_codes

    async def publish(self, topic: str, payload: bytes = b"", qos: int = 0,
                      retain: bool = False, timeout: float = 5.0,
                      properties: Properties | None = None) -> None:
        packet = Packet(fixed=FixedHeader(type=PT.PUBLISH, qos=qos,
                                          retain=retain),
                        protocol_version=self.version, topic=topic,
                        payload=payload)
        if properties is not None:
            packet.properties = properties
        if qos == 0:
            self.writer.write(packet.encode())
            await self.writer.drain()
            return
        pid = self._alloc_id()
        packet.packet_id = pid
        fut = self._await_ack(PT.PUBACK if qos == 1 else PT.PUBCOMP, pid)
        self.writer.write(packet.encode())
        await self.writer.drain()
        await asyncio.wait_for(fut, timeout)

    async def ping(self, timeout: float = 5.0) -> None:
        fut = self._await_ack(PT.PINGRESP, 0)
        self.writer.write(Packet(fixed=FixedHeader(type=PT.PINGREQ),
                                 protocol_version=self.version).encode())
        await self.writer.drain()
        await asyncio.wait_for(fut, timeout)

    async def next_message(self, timeout: float = 5.0) -> Message:
        return await asyncio.wait_for(self.messages.get(), timeout)

    async def disconnect(self, reason_code: int = 0) -> None:
        if self.writer is None:
            return
        try:
            self.writer.write(Packet(fixed=FixedHeader(type=PT.DISCONNECT),
                                     protocol_version=self.version,
                                     reason_code=reason_code).encode())
            await self.writer.drain()
        except (ConnectionError, OSError) as exc:
            # shutdown path: swallowed but recorded (write_error
            # pattern, ADR 012/013)
            self.transport_error = self.transport_error or repr(exc)
        await self.close()

    async def close(self) -> None:
        if self._read_task is not None:
            self._read_task.cancel()
        if self.writer is not None:
            try:
                self.writer.close()
            except Exception:
                pass
        self._closed.set()

    async def wait_closed(self, timeout: float = 5.0) -> None:
        await asyncio.wait_for(self._closed.wait(), timeout)
