"""The port's ``mqtt_client.py`` against the JAX package's: both clients
run the same script against one scripted MQTT server on loopback, which
records every byte a client sends and answers from a fixed table. The
recorded streams, the messages the clients surface and the acknowledgement
results must be equal, for v3.1.1 and v5 (with a will, credentials and a
session expiry), through CONNECT, SUBSCRIBE, QoS 0/1/2 PUBLISH both ways,
PING, UNSUBSCRIBE and DISCONNECT."""

import asyncio

import pytest

import maxmq_tpu.mqtt_client as ref_mc
import maxmq_tpu.protocol.packets as ref_packets
import maxmq_tpu.protocol.properties as ref_props
import maxmq_tpu_torch.mqtt_client as port_mc
import maxmq_tpu_torch.protocol.packets as port_packets
import maxmq_tpu_torch.protocol.properties as port_props

KITS = {"ref": (ref_mc, ref_packets, ref_props),
        "port": (port_mc, port_packets, port_props)}


def frames(buf: bytearray):
    """Split complete MQTT frames off ``buf``: (first byte, body)."""
    out = []
    while len(buf) >= 2:
        n, mult, i = 0, 1, 1
        while True:
            if i >= len(buf):
                return out
            b = buf[i]
            n += (b & 0x7F) * mult
            mult *= 128
            i += 1
            if not b & 0x80:
                break
        if len(buf) < i + n:
            return out
        out.append((buf[0], bytes(buf[i:i + n])))
        del buf[:i + n]
    return out


def publish_frame(topic: bytes, payload: bytes, qos: int, pid: int,
                  version: int) -> bytes:
    body = len(topic).to_bytes(2, "big") + topic
    if qos:
        body += pid.to_bytes(2, "big")
    if version >= 5:
        body += b"\x00"
    body += payload
    return bytes([0x30 | qos << 1, len(body)]) + body


class ScriptedServer:
    """One connection at a time: records the client's bytes and answers
    CONNECT, SUBSCRIBE, UNSUBSCRIBE, QoS 1/2 PUBLISH, PUBREL and PINGREQ;
    after the SUBACK it sends one PUBLISH of each QoS."""

    def __init__(self, version: int):
        self.version = version
        self.recorded = bytearray()
        self.server = None

    async def start(self):
        self.server = await asyncio.start_server(self.handle, "127.0.0.1", 0)
        return self.server.sockets[0].getsockname()[1]

    async def handle(self, reader, writer):
        v5 = self.version >= 5
        buf = bytearray()
        while True:
            chunk = await reader.read(65536)
            if not chunk:
                break
            self.recorded.extend(chunk)
            buf.extend(chunk)
            for first, body in frames(buf):
                kind = first >> 4
                if kind == 1:                                   # CONNECT
                    writer.write(b"\x20\x03\x01\x00\x00" if v5
                                 else b"\x20\x02\x01\x00")
                elif kind == 8:                                 # SUBSCRIBE
                    pid = body[:2]
                    rest = body[3:] if v5 else body[2:]
                    codes = []
                    while rest:
                        n = int.from_bytes(rest[:2], "big")
                        codes.append(rest[2 + n] & 3)
                        rest = rest[3 + n:]
                    ack = pid + (b"\x00" if v5 else b"") + bytes(codes)
                    writer.write(bytes([0x90, len(ack)]) + ack)
                    for qos, pid_out in ((0, 0), (1, 31), (2, 32)):
                        writer.write(publish_frame(
                            b"srv/t", f"q{qos}".encode(), qos, pid_out,
                            self.version))
                elif kind == 10:                                # UNSUBSCRIBE
                    ack = body[:2] + (b"\x00\x00" if v5 else b"")
                    writer.write(bytes([0xB0, len(ack)]) + ack)
                elif kind == 3 and first & 0x06:                # QoS>0 PUB
                    n = int.from_bytes(body[:2], "big")
                    pid = body[2 + n:4 + n]
                    qos = (first >> 1) & 3
                    writer.write((b"\x40\x02" if qos == 1 else b"\x50\x02")
                                 + pid)
                elif kind == 6:                                 # PUBREL
                    writer.write(b"\x70\x02" + body[:2])
                elif kind == 5:                                 # PUBREC
                    writer.write(b"\x62\x02" + body[:2])
                elif kind == 12:                                # PINGREQ
                    writer.write(b"\xd0\x00")
                elif kind == 14:                                # DISCONNECT
                    writer.close()
                    return
            await writer.drain()

    async def close(self):
        self.server.close()
        await self.server.wait_closed()


async def script(kit, version: int, port: int) -> dict:
    mc, packets, props = kit
    will = None
    if version >= 5:
        will = packets.Will(topic="will/t", payload=b"gone", qos=1,
                            retain=True)
        will.properties.will_delay = 5
    c = mc.MQTTClient("cl-7", version=version, clean_start=False,
                      keepalive=42, username="user", password="pw",
                      will=will, session_expiry=300 if version >= 5 else None)
    connack = await c.connect("127.0.0.1", port)
    rec = {"connack": (connack.reason_code, connack.session_present),
           "session_present": c.session_present}
    rec["suback"] = await c.subscribe(("a/+", 1), ("b/#", 2), "c")
    msgs = [await c.next_message(timeout=5) for _ in range(3)]
    rec["messages"] = [(m.topic, m.payload, m.qos, m.retain, m.trace)
                       for m in msgs]
    await c.publish("p/0", b"zero")
    await c.publish("p/1", b"one", qos=1)
    await c.publish("p/2", b"two", qos=2, retain=True)
    if version >= 5:
        pr = props.Properties()
        pr.user_properties = [("k", "v")]
        pr.content_type = "text"
        await c.publish("p/v5", b"props", qos=1, properties=pr)
    await c.ping()
    rec["unsuback"] = await c.unsubscribe("a/+")
    await c.disconnect()
    rec["error"] = c.transport_error
    return rec


@pytest.mark.parametrize("version", [4, 5])
async def test_client_bytes_and_flows_equal(version):
    out = {}
    for name, kit in KITS.items():
        server = ScriptedServer(version)
        port = await server.start()
        try:
            rec = await asyncio.wait_for(script(kit, version, port), 20)
            await asyncio.sleep(0.05)
        finally:
            await server.close()
        rec["bytes"] = bytes(server.recorded)
        out[name] = rec
    assert out["port"] == out["ref"]
    rec = out["port"]
    assert rec["connack"] == (0, True) and rec["suback"] == [1, 2, 0]
    assert [m[:3] for m in rec["messages"]] == [
        ("srv/t", b"q0", 0), ("srv/t", b"q1", 1), ("srv/t", b"q2", 2)]
    assert rec["bytes"][0] == 0x10 and rec["bytes"].endswith(b"\xe0\x00")


async def test_connect_refused_and_closed_before_connack():
    async def refuse(reader, writer):
        await reader.read(1024)
        writer.write(b"\x20\x02\x00\x05")              # not authorized
        await writer.drain()
        writer.close()

    async def hang_up(reader, writer):
        await reader.read(1024)
        writer.close()

    out = {}
    for name, (mc, _p, _pr) in KITS.items():
        rec = []
        for handler in (refuse, hang_up):
            srv = await asyncio.start_server(handler, "127.0.0.1", 0)
            port = srv.sockets[0].getsockname()[1]
            c = mc.MQTTClient("x")
            try:
                with pytest.raises(mc.MQTTError) as exc:
                    await c.connect("127.0.0.1", port)
                rec.append((str(exc.value), c.connack_reason))
            finally:
                await c.close()
                srv.close()
                await srv.wait_closed()
        out[name] = rec
    assert out["port"] == out["ref"]
    assert out["port"][0] == ("connect refused: 0x5", 5)


def test_message_defaults_equal():
    assert [f for f in port_mc.Message.__dataclass_fields__] == \
        [f for f in ref_mc.Message.__dataclass_fields__]
    m = port_mc.Message("t", b"p")
    assert (m.qos, m.retain, m.trace) == (0, False, "")
