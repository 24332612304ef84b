"""Network listeners: TCP (optionally TLS), Unix socket, in-memory mock, and
a WebSocket adapter (RFC 6455 server handshake + binary frames).

Parity surface: vendor/github.com/mochi-co/mqtt/v2/listeners/ in the
reference (Listener interface + registry, tcp/unix/ws/mock).

Copy of the JAX package's ``broker/listeners.py``.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import ssl as ssl_module
import struct


class Listener:
    """A bound endpoint that accepts connections and hands (reader, writer)
    pairs to the broker's establish callback."""

    def __init__(self, id_: str, address: str) -> None:
        self.id = id_
        self.address = address
        self._server: asyncio.AbstractServer | None = None
        self._establish = None
        # per-listener CONNECT admission gate (ADR 012): the broker
        # installs a TokenBucket here when connect_rate is configured;
        # an exhausted bucket refuses the socket before handshake work
        self.gate = None

    @property
    def protocol(self) -> str:
        raise NotImplementedError

    async def serve(self, establish) -> None:
        """Bind and start accepting; ``establish(listener_id, reader, writer)``
        is awaited per connection."""
        raise NotImplementedError

    def stop_accepting(self) -> None:
        """Stop accepting new connections (non-blocking)."""
        if self._server is not None:
            self._server.close()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            # wait_closed() blocks until every handler coroutine finishes;
            # the broker disconnects clients first, so bound the wait.
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=2.0)
            except asyncio.TimeoutError:
                pass
            self._server = None


class TCPListener(Listener):
    def __init__(self, id_: str, address: str,
                 tls: ssl_module.SSLContext | None = None,
                 reuse_port: bool = False) -> None:
        super().__init__(id_, address)
        self.tls = tls
        # SO_REUSEPORT: the delivery-worker pool binds N processes to
        # one port and lets the kernel shard accepts (ADR 005)
        self.reuse_port = reuse_port

    @property
    def protocol(self) -> str:
        return "tls" if self.tls else "tcp"

    async def serve(self, establish) -> None:
        host, _, port = self.address.rpartition(":")
        self._establish = establish

        async def handler(reader, writer):
            await establish(self.id, reader, writer)

        self._server = await asyncio.start_server(
            handler, host or "0.0.0.0", int(port), ssl=self.tls,
            reuse_port=self.reuse_port or None)


class UnixListener(Listener):
    @property
    def protocol(self) -> str:
        return "unix"

    async def serve(self, establish) -> None:
        async def handler(reader, writer):
            await establish(self.id, reader, writer)

        self._server = await asyncio.start_unix_server(handler, path=self.address)


class SocketListener(Listener):
    """Serve an externally created, already-bound socket — the analog
    of the reference's bring-your-own net.Listener (listeners/net.go):
    callers doing their own bind dance (fd passing, systemd socket
    activation, exotic socket options) hand the socket over and the
    broker just accepts on it."""

    def __init__(self, id_: str, sock) -> None:
        try:
            addr = sock.getsockname()
            address = (addr if isinstance(addr, str)
                       else f"{addr[0]}:{addr[1]}")
        except OSError:
            address = "?"
        super().__init__(id_, address)
        self.sock = sock

    @property
    def protocol(self) -> str:
        return "sock"

    async def serve(self, establish) -> None:
        async def handler(reader, writer):
            await establish(self.id, reader, writer)

        self._server = await asyncio.start_server(handler, sock=self.sock)


class MockListener(Listener):
    """In-process listener for tests: ``connect()`` returns the client-side
    (reader, writer) of a paired in-memory stream."""

    def __init__(self, id_: str = "mock", address: str = "mock://") -> None:
        super().__init__(id_, address)
        self.serving = asyncio.Event()

    @property
    def protocol(self) -> str:
        return "mock"

    async def serve(self, establish) -> None:
        self._establish = establish
        self.serving.set()

    async def connect(self):
        assert self._establish is not None, "listener not serving"
        c2s_r = asyncio.StreamReader()
        s2c_r = asyncio.StreamReader()
        server_writer = _QueueWriter(s2c_r)
        client_writer = _QueueWriter(c2s_r)
        asyncio.get_running_loop().create_task(
            self._establish(self.id, c2s_r, server_writer))
        return s2c_r, client_writer

    async def close(self) -> None:
        self.serving.clear()


class _QueueWriter:
    """Duck-typed StreamWriter feeding a paired StreamReader directly."""

    def __init__(self, peer_reader: asyncio.StreamReader) -> None:
        self._peer = peer_reader
        self._closed = False

    def write(self, data: bytes) -> None:
        if not self._closed:
            self._peer.feed_data(data)

    async def drain(self) -> None:
        pass

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._peer.feed_eof()

    async def wait_closed(self) -> None:
        pass

    def is_closing(self) -> bool:
        return self._closed

    def get_extra_info(self, name, default=None):
        return default


# ---------------------------------------------------------------------------
# WebSocket (MQTT-over-WS, binary frames, subprotocol "mqtt")
# ---------------------------------------------------------------------------

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


class WSListener(Listener):
    """MQTT over WebSocket: performs the RFC 6455 server handshake, then
    bridges binary frames to the broker as a plain byte stream."""

    def __init__(self, id_: str, address: str,
                 tls: ssl_module.SSLContext | None = None,
                 reuse_port: bool = False) -> None:
        super().__init__(id_, address)
        self.tls = tls
        self.reuse_port = reuse_port   # worker-pool accept sharding

    @property
    def protocol(self) -> str:
        return "ws"

    async def serve(self, establish) -> None:
        host, _, port = self.address.rpartition(":")

        async def handler(reader, writer):
            try:
                key = await self._handshake(reader, writer)
            except (ValueError, ConnectionError, asyncio.IncompleteReadError):
                writer.close()
                return
            if key is None:
                writer.close()
                return
            bridged_reader = asyncio.StreamReader()
            ws_writer = _WSWriter(writer)
            pump = asyncio.get_running_loop().create_task(
                self._pump_frames(reader, bridged_reader, ws_writer))
            try:
                await establish(self.id, bridged_reader, ws_writer)
            finally:
                pump.cancel()

        self._server = await asyncio.start_server(
            handler, host or "0.0.0.0", int(port), ssl=self.tls,
            reuse_port=self.reuse_port or None)

    async def _handshake(self, reader, writer) -> str | None:
        request = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 10)
        headers: dict[str, str] = {}
        lines = request.decode("latin-1").split("\r\n")
        for line in lines[1:]:
            name, sep, value = line.partition(":")
            if sep:
                headers[name.strip().lower()] = value.strip()
        key = headers.get("sec-websocket-key")
        if not key or "websocket" not in headers.get("upgrade", "").lower():
            return None
        accept = base64.b64encode(
            hashlib.sha1((key + _WS_MAGIC).encode()).digest()).decode()
        resp = ("HTTP/1.1 101 Switching Protocols\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Accept: {accept}\r\n")
        if "mqtt" in headers.get("sec-websocket-protocol", ""):
            resp += "Sec-WebSocket-Protocol: mqtt\r\n"
        writer.write((resp + "\r\n").encode())
        await writer.drain()
        return key

    async def _pump_frames(self, reader, bridged: asyncio.StreamReader,
                           ws_writer: "_WSWriter") -> None:
        """Decode masked client frames into the bridged byte stream."""
        try:
            while True:
                hdr = await reader.readexactly(2)
                opcode = hdr[0] & 0x0F
                masked = bool(hdr[1] & 0x80)
                length = hdr[1] & 0x7F
                if length == 126:
                    length = struct.unpack(">H", await reader.readexactly(2))[0]
                elif length == 127:
                    length = struct.unpack(">Q", await reader.readexactly(8))[0]
                mask = await reader.readexactly(4) if masked else b"\x00" * 4
                payload = bytearray(await reader.readexactly(length))
                if masked:
                    for i in range(length):
                        payload[i] ^= mask[i % 4]
                if opcode == 0x8:  # close
                    ws_writer.send_close()
                    bridged.feed_eof()
                    return
                if opcode == 0x9:  # ping -> pong
                    ws_writer.send_pong(bytes(payload))
                    continue
                if opcode in (0x0, 0x1, 0x2):
                    bridged.feed_data(bytes(payload))
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError):
            bridged.feed_eof()


class _WSWriter:
    """StreamWriter facade that wraps outbound bytes in binary WS frames."""

    def __init__(self, raw: asyncio.StreamWriter) -> None:
        self._raw = raw

    @staticmethod
    def _frame(opcode: int, payload: bytes) -> bytes:
        head = bytearray([0x80 | opcode])
        n = len(payload)
        if n < 126:
            head.append(n)
        elif n < 65536:
            head.append(126)
            head.extend(struct.pack(">H", n))
        else:
            head.append(127)
            head.extend(struct.pack(">Q", n))
        return bytes(head) + payload

    def write(self, data: bytes) -> None:
        self._raw.write(self._frame(0x2, data))

    def send_pong(self, payload: bytes) -> None:
        try:
            self._raw.write(self._frame(0xA, payload))
        except Exception:
            pass

    def send_close(self) -> None:
        try:
            self._raw.write(self._frame(0x8, b""))
        except Exception:
            pass

    async def drain(self) -> None:
        await self._raw.drain()

    def close(self) -> None:
        try:
            self._raw.write(self._frame(0x8, b""))
        except Exception:
            pass
        self._raw.close()

    async def wait_closed(self) -> None:
        try:
            await self._raw.wait_closed()
        except Exception:
            pass

    def is_closing(self) -> bool:
        return self._raw.is_closing()

    def get_extra_info(self, name, default=None):
        return self._raw.get_extra_info(name, default)


class HTTPStatsListener(Listener):
    """HTTP endpoint serving the broker's ``$SYS`` counters as JSON.

    Parity surface: vendor/.../v2/listeners/http_sysinfo.go:22-120 in the
    reference. ``info_fn`` returns the live SysInfo; every GET returns one
    JSON object snapshot.
    """

    def __init__(self, id_: str, address: str, info_fn) -> None:
        super().__init__(id_, address)
        self.info_fn = info_fn

    @property
    def protocol(self) -> str:
        return "http"

    async def serve(self, establish) -> None:
        host, _, port = self.address.rpartition(":")

        async def handler(reader, writer):
            import dataclasses
            import json
            try:
                # consume the request head; the response is the same for
                # every path, like the reference's single-route mux
                await asyncio.wait_for(
                    reader.readuntil(b"\r\n\r\n"), timeout=5.0)
            except Exception:
                writer.close()
                return
            info = self.info_fn()
            d = dataclasses.asdict(info)
            d.pop("extra", None)
            body = json.dumps(d).encode()
            writer.write(b"HTTP/1.1 200 OK\r\n"
                         b"Content-Type: application/json\r\n"
                         b"Content-Length: " + str(len(body)).encode() +
                         b"\r\nConnection: close\r\n\r\n" + body)
            try:
                await writer.drain()
            except Exception:
                pass
            writer.close()

        self._server = await asyncio.start_server(
            handler, host or "0.0.0.0", int(port))


class Listeners:
    """Registry of listeners; serve-all / close-all.

    Parity: listeners.go:40-133 in the reference.
    """

    def __init__(self) -> None:
        self._listeners: dict[str, Listener] = {}

    def add(self, listener: Listener) -> Listener:
        if listener.id in self._listeners:
            raise ValueError(f"listener id {listener.id!r} already exists")
        self._listeners[listener.id] = listener
        return listener

    def get(self, id_: str) -> Listener | None:
        return self._listeners.get(id_)

    def all(self) -> list[Listener]:
        return list(self._listeners.values())

    def __len__(self) -> int:
        return len(self._listeners)

    async def serve_all(self, establish) -> None:
        for listener in self._listeners.values():
            await listener.serve(establish)

    def stop_accepting_all(self) -> None:
        for listener in self._listeners.values():
            listener.stop_accepting()

    async def close_all(self) -> None:
        for listener in self._listeners.values():
            await listener.close()
        self._listeners.clear()
