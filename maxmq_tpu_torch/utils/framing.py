"""Length-prefixed frame helpers of the matcher service protocol: ``>IB``
= payload length + type, byte-compatible with the JAX package's
``utils/framing.py``."""

from __future__ import annotations

import asyncio
import struct


def frame(ftype: int, payload: bytes) -> bytes:
    return struct.pack(">IB", len(payload) + 1, ftype) + payload


async def read_frame(reader) -> tuple[int, bytes] | None:
    """One frame, or None on EOF/connection loss."""
    try:
        head = await reader.readexactly(5)
        length, ftype = struct.unpack(">IB", head)
        return ftype, await reader.readexactly(length - 1)
    except (asyncio.IncompleteReadError, ConnectionError, OSError):
        return None
