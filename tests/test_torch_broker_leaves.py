"""The port's broker leaf modules (``broker/client.py``,
``broker/listeners.py`` and the crash-point part of ``faults.py``)
against the JAX package's, in-process and with exact equality: the same
script runs over each package's classes and the records must be equal.

``Client`` reads attributes of its server; both packages' clients are
driven with the same minimal stand-in server (``StandIn``) and fake
writer, and a scripted clock replaces ``time`` in both modules."""

import asyncio
import base64
import hashlib
import json
import os
import struct
import tempfile
import types

import pytest

import maxmq_tpu.broker.client as ref_client
import maxmq_tpu.broker.listeners as ref_listeners
import maxmq_tpu.broker.sys_info as ref_sys_info
import maxmq_tpu.faults as ref_faults
import maxmq_tpu.protocol.codec as ref_codec
import maxmq_tpu.protocol.packets as ref_packets
import maxmq_tpu.protocol.properties as ref_props
import maxmq_tpu_torch.broker.client as port_client
import maxmq_tpu_torch.broker.listeners as port_listeners
import maxmq_tpu_torch.broker.sys_info as port_sys_info
import maxmq_tpu_torch.faults as port_faults
import maxmq_tpu_torch.protocol.codec as port_codec
import maxmq_tpu_torch.protocol.packets as port_packets
import maxmq_tpu_torch.protocol.properties as port_props

KITS = {
    "ref": types.SimpleNamespace(
        client=ref_client, listeners=ref_listeners, faults=ref_faults,
        codec=ref_codec, packets=ref_packets, props=ref_props,
        sys_info=ref_sys_info),
    "port": types.SimpleNamespace(
        client=port_client, listeners=port_listeners, faults=port_faults,
        codec=port_codec, packets=port_packets, props=port_props,
        sys_info=port_sys_info),
}


def both(fn):
    """Run ``fn(kit)`` over each package; assert the records are equal
    and return the port's."""
    out = {name: fn(kit) for name, kit in KITS.items()}
    assert out["port"] == out["ref"]
    return out["port"]


async def both_async(fn):
    out = {name: await fn(kit) for name, kit in KITS.items()}
    assert out["port"] == out["ref"]
    return out["port"]


def publish(kit, topic, payload, qos=0, pid=0, version=4, props=None):
    p = kit.packets.Packet(
        fixed=kit.codec.FixedHeader(type=kit.codec.PacketType.PUBLISH,
                                    qos=qos),
        protocol_version=version, topic=topic, payload=payload,
        packet_id=pid)
    if props:
        for k, v in props.items():
            setattr(p.properties, k, v)
    return p


def wire(item):
    """A queued item in comparable form."""
    if item is None or isinstance(item, (bytes, tuple)):
        return item
    return ("packet", item.encode())


# -- the stand-in server ---------------------------------------------------

class Clock:
    """Scripted ``time`` for both client modules."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return self.t + 1e9


class Overload:
    def __init__(self):
        self.queued_bytes = 0
        self.budget_drops = self.writev_batches = self.writev_buffers = 0
        self.slow_encodes = self.copied_bytes = 0
        self.shedding = False

    def note_put(self, n):
        self.queued_bytes += n

    def note_get(self, n):
        self.queued_bytes -= n


class Hooks:
    def __init__(self):
        self.events = []

    def modify(self, name, packet, client):
        return packet

    def notify(self, name, *args):
        self.events.append(name)

    def overrides(self, name):
        return False


class Tracer:
    sample_n = 0

    def __init__(self):
        self.errors = []

    def clock(self):
        return 0

    def note_error(self, stage, reason, n):
        self.errors.append((stage, reason, n))


class StandIn:
    """The server attributes ``Client`` reads."""

    def __init__(self, kit, **caps):
        base = dict(maximum_client_writes_pending=0, maximum_keepalive=30,
                    receive_maximum=8, topic_alias_maximum=4,
                    client_byte_budget=0, broker_byte_budget=0,
                    maximum_packet_size=0, buffer_size=65536)
        base.update(caps)
        self.capabilities = types.SimpleNamespace(**base)
        self.overload = Overload()
        self.flush_sched = kit.client.FlushScheduler()
        self.info = kit.sys_info.SysInfo()
        self.hooks = Hooks()
        self.tracer = Tracer()


class FakeWriter:
    def __init__(self):
        self.chunks = []
        self.closed = False

    def write(self, data):
        self.chunks.append(bytes(data))

    def writelines(self, bufs):
        self.chunks.append(b"".join(bytes(b) for b in bufs))

    async def drain(self):
        pass

    def close(self):
        self.closed = True

    def get_extra_info(self, name, default=None):
        return ("10.0.0.7", 4242) if name == "peername" else default


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    for kit in KITS.values():
        monkeypatch.setattr(kit.client, "time", c)
    return c


# -- OutboundQueue and FlushScheduler ----------------------------------------

def queue_items(kit):
    pub0 = publish(kit, "a/b", b"x" * 10).encode()
    pub1 = publish(kit, "a/b", b"y" * 10, qos=1, pid=3).encode()
    return [
        (pub0, len(pub0)),
        (pub1, len(pub1)),
        ((pub0[:2], pub0[2:]), len(pub0)),
        (publish(kit, "q/0", b"z" * 40), 72),
        (publish(kit, "q/1", b"w", qos=1, pid=9), 33),
        (b"\x40\x02\x00\x03", 4),                        # PUBACK
        (pub0, len(pub0)),
    ]


@pytest.mark.parametrize("need", [0, 1, 20, 60, 1000])
def test_outbound_queue_accounting_and_drop_oldest_qos0(need):
    def run(kit):
        over = Overload()
        q = kit.client.OutboundQueue(0, overload=over)
        for item, size in queue_items(kit):
            q.put_nowait(item, size)
        rec = [q.qsize(), q.bytes, q.enqueued, over.queued_bytes]
        dropped, freed = q.drop_oldest_qos0(need)
        rec += [[wire(d) for d in dropped], freed, q.qsize(), q.bytes,
                q.removed, over.queued_bytes]
        rec.append(wire(q.get_nowait()))
        q.release_all()
        rec += [q.qsize(), q.bytes, over.queued_bytes, q.removed]
        with pytest.raises(asyncio.QueueEmpty):
            q.get_nowait()
        bounded = kit.client.OutboundQueue(2)
        bounded.put_nowait(b"\xd0\x00", 2)
        bounded.put_nowait(b"\xd0\x00", 2)
        with pytest.raises(asyncio.QueueFull):
            bounded.put_nowait(b"\xd0\x00", 2)
        return rec

    rec = both(run)
    assert rec[0] == 7


async def test_flush_scheduler_wakes_each_writer_once_per_iteration():
    async def run(kit):
        sched = kit.client.FlushScheduler()
        queues = [kit.client.OutboundQueue(0, scheduler=sched)
                  for _ in range(3)]
        getters = [asyncio.get_running_loop().create_task(q.get())
                   for q in queues]
        await asyncio.sleep(0)
        for i in range(4):
            for q in queues[:2 if i else 3]:
                q.put_nowait(bytes([0x30, 0, i]), 3)
        rec = [sched.deferred, sched.coalesced, sched.flushes]
        got = await asyncio.gather(*getters)
        rec += [sched.deferred, sched.coalesced, sched.flushes, got,
                [q.qsize() for q in queues]]
        # no running loop needed when nothing waits: a direct put
        q = kit.client.OutboundQueue(0, scheduler=sched)
        q.put_nowait(b"\xc0\x00", 2)
        rec.append(sched.deferred)
        return rec

    rec = await both_async(run)
    assert rec[:3] == [3, 6, 0] and rec[5] == 1


# -- Client ------------------------------------------------------------------

def connect_packet(kit, version=5):
    w = kit.packets.Will(topic="will/t", payload=b"bye", qos=1)
    w.properties.will_delay = 7
    p = kit.packets.Packet(
        fixed=kit.codec.FixedHeader(type=kit.codec.PacketType.CONNECT),
        protocol_version=version, clean_start=False, keepalive=0,
        client_id="cl-1", will=w)
    p.username = b"user"
    if version >= 5:
        p.properties.session_expiry = 60
        p.properties.receive_maximum = 3
        p.properties.topic_alias_max = 5
        p.properties.maximum_packet_size = 4096
        p.properties.request_problem_info = 0
    return p


@pytest.mark.parametrize("version", [4, 5])
def test_client_connect_properties_packet_ids_and_expiry(clock, version):
    def run(kit):
        server = StandIn(kit)
        c = kit.client.Client(server, None, FakeWriter(), "l1")
        c.parse_connect(connect_packet(kit, version))
        p = c.properties
        rec = [c.id, c.remote, c.keepalive, c.requested_keepalive,
               p.protocol_version, p.clean_start, p.username,
               p.session_expiry, p.session_expiry_set, p.receive_maximum,
               p.topic_alias_maximum, p.maximum_packet_size,
               p.request_problem_info, p.will_delay, p.will.topic,
               c.inflight.maximum_send, c.inflight.maximum_receive]
        ids = [c.next_packet_id() for _ in range(3)]
        c.inflight.set(publish(kit, "a", b"", qos=1, pid=5))
        c.inflight.set(publish(kit, "a", b"", qos=1, pid=4))
        ids += [c.next_packet_id() for _ in range(3)]
        c._packet_id_cursor = 65534
        ids += [c.next_packet_id() for _ in range(3)]
        rec.append(ids)
        c.inflight.get = lambda pid: object()            # every id taken
        with pytest.raises(kit.client.PacketIDExhausted):
            c.next_packet_id()
        rec.append(c.expired(clock.time(), 100))
        c.disconnected_at = clock.time()
        rec += [c.expired(clock.time() + s, m)
                for s in (0, 59, 61, 101) for m in (0, 100)]
        return rec

    rec = both(run)
    assert rec[2] == 30          # keepalive 0 clamped to the server's 30


async def test_client_send_paths_bytes_and_drop_reasons(clock):
    async def run(kit):
        clock.t = 1000.0
        server = StandIn(kit, client_byte_budget=160,
                         maximum_client_writes_pending=8)
        writer = FakeWriter()
        c = kit.client.Client(server, None, writer, "l1")
        c.id = "cl"
        c.properties.protocol_version = 5
        q0 = publish(kit, "d/x", b"p" * 30, version=5).encode()
        rec = []
        rec.append(c.send_wire(q0))
        rec.append(c.send_buffers((q0[:2], q0[2:]), len(q0)))
        rec.append(c.send(publish(kit, "d/y", b"q" * 20, qos=1, pid=1,
                                  version=5,
                                  props={"user_properties": [("k", "v")]})))
        rec.append(c.send(kit.packets.Packet(
            fixed=kit.codec.FixedHeader(type=kit.codec.PacketType.PUBACK),
            protocol_version=5, packet_id=1)))
        rec.append(c.send_wire(q0))              # sheds the oldest QoS0
        rec.append(c.send_wire(publish(kit, "big", b"b" * 300).encode()))
        server.capabilities.broker_byte_budget = 10
        rec.append(c.send_wire(q0))              # broker-wide pressure
        server.capabilities.broker_byte_budget = 0
        server.capabilities.client_byte_budget = 0
        for _ in range(9):
            rec.append(c.send_wire(b"\xd0\x00"))  # PINGRESP: queue fills
        rec += [c.outbound.qsize(), c.outbound.bytes, c.dropped_msgs,
                c.dropped_bytes, dict(c.drops_by_reason),
                server.overload.budget_drops, server.overload.queued_bytes,
                server.info.messages_dropped, list(server.tracer.errors)]
        c.start()
        clock.t += 5
        await c.stop()
        rec += [writer.chunks, writer.closed, server.info.bytes_sent,
                server.info.packets_sent, server.info.messages_sent,
                server.overload.writev_batches,
                server.overload.writev_buffers,
                server.overload.slow_encodes, server.overload.queued_bytes,
                c.write_error, c.closed, c.send_wire(q0),
                server.hooks.events, c.disconnected_at]
        return rec

    rec = await both_async(run)
    assert rec[6] is False and rec[4] is True
    drops = next(x for x in rec if isinstance(x, dict))
    assert {"byte_budget", "global_budget", "queue_full"} <= set(drops)


async def test_client_write_fault_stalls_one_writer(clock):
    """A keyed ``client.write#<id>`` hang stalls that client's writer by
    its delay; a raise kills the writer and is recorded."""
    async def run(kit):
        f = kit.faults
        f.clear()
        rec = []
        try:
            for mode in ("hang", "raise"):
                server = StandIn(kit)
                writer = FakeWriter()
                c = kit.client.Client(server, None, writer, "l1")
                c.id = "slow"
                f.arm(f"{f.CLIENT_WRITE}#slow", mode, 1, 0.01)
                c.send_wire(b"\xd0\x00")
                c.start()
                await asyncio.sleep(0.05)
                rec += [writer.chunks, c.write_error is not None,
                        f.fired.get(f"{f.CLIENT_WRITE}#slow")]
                await c.stop()
        finally:
            f.clear()
        return rec

    rec = await both_async(run)
    assert rec[0] == [b"\xd0\x00"] and rec[4] is True


def test_client_registry():
    def run(kit):
        reg = kit.client.ClientRegistry()
        cs = []
        for cid in ("a", "b", "c"):
            c = kit.client.Client(StandIn(kit), None, FakeWriter())
            c.id = cid
            reg.add(c)
            cs.append(c)
        cs[1]._stopped.set()
        reg.delete("c")
        reg.delete("zz")
        return [len(reg), [c.id for c in reg.all()],
                [c.id for c in reg.connected()], reg.get("b") is cs[1],
                reg.get("c")]

    assert both(run) == [2, ["a", "b"], ["a"], True, None]


# -- listeners ---------------------------------------------------------------

def _port_of(listener):
    return listener._server.sockets[0].getsockname()[1]


async def test_tcp_unix_and_mock_listeners_accept():
    async def run(kit):
        L = kit.listeners
        got = []

        async def establish(lid, reader, writer):
            data = await reader.readexactly(5)
            got.append((lid, data))
            writer.write(data.upper())
            await writer.drain()
            writer.close()

        reg = L.Listeners()
        tcp = reg.add(L.TCPListener("t1", "127.0.0.1:0"))
        path = os.path.join(tempfile.mkdtemp(), "l.sock")
        unix = reg.add(L.UnixListener("u1", path))
        mock = reg.add(L.MockListener())
        with pytest.raises(ValueError):
            reg.add(L.TCPListener("t1", "127.0.0.1:0"))
        await reg.serve_all(establish)
        replies = []
        for opener in (lambda: asyncio.open_connection("127.0.0.1",
                                                       _port_of(tcp)),
                       lambda: asyncio.open_unix_connection(path),
                       mock.connect):
            r, w = await opener()
            w.write(b"hello")
            await w.drain()
            replies.append(await asyncio.wait_for(r.read(100), 5))
            w.close()
        rec = [[x.protocol for x in reg.all()], len(reg), sorted(got),
               replies, reg.get("u1") is unix]
        reg.stop_accepting_all()
        await reg.close_all()
        rec.append(len(reg))
        return rec

    rec = await both_async(run)
    assert rec[0] == ["tcp", "unix", "mock"] and rec[3] == [b"HELLO"] * 3


WS_KEY = "dGhlIHNhbXBsZSBub25jZQ=="


def ws_frame(opcode, payload, mask=b"\x11\x22\x33\x44"):
    n = len(payload)
    head = bytes([0x80 | opcode])
    if n < 126:
        head += bytes([0x80 | n])
    elif n < 65536:
        head += bytes([0x80 | 126]) + struct.pack(">H", n)
    else:
        head += bytes([0x80 | 127]) + struct.pack(">Q", n)
    return head + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(payload))


async def test_websocket_handshake_and_frames():
    async def run(kit):
        L = kit.listeners
        inbound = []

        async def establish(lid, reader, writer):
            for n in (4, 200, 70_000):
                inbound.append(await reader.readexactly(n))
            writer.write(b"\x20\x02\x00\x00")
            writer.write(b"r" * 300)
            await writer.drain()
            inbound.append(await reader.read(10))        # EOF after close

        ws = L.WSListener("w1", "127.0.0.1:0")
        await ws.serve(establish)
        r, w = await asyncio.open_connection("127.0.0.1", _port_of(ws))
        w.write(("GET /mqtt HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                 "Connection: Upgrade\r\nSec-WebSocket-Key: " + WS_KEY +
                 "\r\nSec-WebSocket-Protocol: mqtt\r\n"
                 "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        response = await r.readuntil(b"\r\n\r\n")
        w.write(ws_frame(0x2, b"\x10\x02ab"))
        w.write(ws_frame(0x2, bytes(range(200))))
        w.write(ws_frame(0x0, b"c" * 70_000))
        frames = [await r.readexactly(6), await r.readexactly(4 + 300)]
        w.write(ws_frame(0x9, b"hi"))                     # ping
        frames.append(await r.readexactly(4))
        w.write(ws_frame(0x8, b""))                       # close
        frames.append(await r.readexactly(2))
        w.close()
        await asyncio.sleep(0.05)
        # a request without the upgrade is closed without a response
        r2, w2 = await asyncio.open_connection("127.0.0.1", _port_of(ws))
        w2.write(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
        refused = await asyncio.wait_for(r2.read(100), 5)
        w2.close()
        await ws.close()
        sizes = [L._WSWriter._frame(2, b"x" * n)[:10]
                 for n in (0, 125, 126, 65535, 65536)]
        return [response, frames, inbound, refused, sizes, ws.protocol]

    rec = await both_async(run)
    accept = base64.b64encode(hashlib.sha1(
        (WS_KEY + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()
    ).digest()).decode()
    assert accept == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="        # RFC 6455 1.3
    assert f"Sec-WebSocket-Accept: {accept}".encode() in rec[0]
    assert rec[1][0] == b"\x82\x04\x20\x02\x00\x00"
    assert rec[1][2] == b"\x8a\x02hi" and rec[1][3] == b"\x88\x00"
    assert rec[2][0] == b"\x10\x02ab" and rec[3] == b""


async def test_http_stats_listener_serves_sys_info():
    async def run(kit):
        info = kit.sys_info.SysInfo(version="v", clients_connected=3,
                                    messages_sent=9)
        info.extra["x"] = 1
        lst = kit.listeners.HTTPStatsListener("h1", "127.0.0.1:0",
                                              lambda: info)
        await lst.serve(None)
        r, w = await asyncio.open_connection("127.0.0.1", _port_of(lst))
        w.write(b"GET /anything HTTP/1.1\r\nHost: x\r\n\r\n")
        raw = await asyncio.wait_for(r.read(), 5)
        w.close()
        await lst.close()
        head, _, body = raw.partition(b"\r\n\r\n")
        return [head, json.loads(body), lst.protocol]

    rec = await both_async(run)
    assert rec[1]["clients_connected"] == 3 and "extra" not in rec[1]


# -- faults: the crash points and keyed firing --------------------------------

@pytest.mark.parametrize("point", ["pre_fsync", "restore_parse",
                                   "mid_wal_write"])
def test_crash_point_with_kill_fn_swapped(point):
    def run(kit):
        f = kit.faults
        killed = []
        saved = f.REGISTRY.kill_fn
        f.REGISTRY.kill_fn = lambda: killed.append(point)
        f.clear()
        try:
            f.crash_point(point)                       # unarmed: no-op
            rec = [list(killed)]
            f.arm_from_spec(f"{f.CRASH_AT}#{point}:kill:1:0:2")
            for _ in range(4):
                f.crash_point(point)
                f.crash_point("other")
                rec.append(len(killed))
            rec += [dict(f.fired), f.armed(f"{f.CRASH_AT}#{point}")]
            return rec
        finally:
            f.REGISTRY.kill_fn = saved
            f.clear()

    rec = both(run)
    assert rec[1:5] == [0, 0, 1, 1]
    assert point in KITS["port"].faults.CRASH_POINTS


def test_fire_detail_keyed_then_plain():
    def run(kit):
        f = kit.faults
        reg = f.FaultRegistry()
        reg.arm(f"{f.CLIENT_WRITE}#a", "hang", 1, 0.25)
        reg.arm(f.CLIENT_WRITE, "drop", 2)
        rec = [reg.fire_detail(f.CLIENT_WRITE, key="a"),
               reg.fire_detail(f.CLIENT_WRITE, key="b"),
               reg.fire_detail(f.CLIENT_WRITE),
               reg.fire_detail(f.CLIENT_WRITE, key="a"),
               reg.any_armed(), dict(reg.fired)]
        reg.arm(f.STORAGE_RESTORE, "raise", 1)
        with pytest.raises(f.InjectedFault):
            reg.fire_detail(f.STORAGE_RESTORE)
        rec.append(reg.fired[f.STORAGE_RESTORE])
        return rec

    rec = both(run)
    assert rec[0] == ("hang", 0.25) and rec[3] is None
    assert rec[4] is False
