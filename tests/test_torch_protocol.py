"""The port's MQTT codec (``maxmq_tpu_torch/protocol/``) against the JAX
package's, and against the port's copy of the spec-derived reference
decoder (``csrc/host/maxmq_torch_refdecode.cpp``).

Inputs come from numpy seeds. Tolerance: exact bytes, equal decoded
fields, the same exception class and reason code on malformed input.
"""

import ctypes
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from maxmq_tpu.protocol import codec as j_codec
from maxmq_tpu.protocol import packets as j_packets
from maxmq_tpu.protocol import properties as j_props
from maxmq_tpu_torch import native
from maxmq_tpu_torch.protocol import codec as t_codec
from maxmq_tpu_torch.protocol import packets as t_packets
from maxmq_tpu_torch.protocol import properties as t_props

PKGS = {"jax": (j_codec, j_packets, j_props),
        "torch": (t_codec, t_packets, t_props)}
ALPHABET = list("abcdefgh/+#$ ") + ["é", "中"]


# -- seeded packet specs, built in either package -----------------------

def _text(rng, lo=0, hi=16) -> str:
    n = int(rng.integers(lo, hi + 1))
    return "".join(ALPHABET[int(k)] for k in rng.integers(0, len(ALPHABET),
                                                          n))


def _blob(rng, lo=0, hi=16) -> bytes:
    return rng.bytes(int(rng.integers(lo, hi + 1)))


def _props(rng, v5: bool) -> dict:
    """Random v5 properties (the encoder emits those valid for the packet
    type): user properties, correlation data, identifiers, aliases, ..."""
    if not v5:
        return {}
    p = {}
    coin = lambda q=0.3: rng.random() < q  # noqa: E731
    if coin():
        p["payload_format"] = int(rng.integers(0, 2))
    if coin():
        p["message_expiry"] = int(rng.integers(0, 2**32))
    if coin():
        p["content_type"] = _text(rng, 1)
    if coin():
        p["response_topic"] = _text(rng, 1)
    if coin():
        p["correlation_data"] = _blob(rng, 1)
    if coin():
        p["subscription_ids"] = [int(rng.integers(1, 268_435_456))
                                 for _ in range(int(rng.integers(1, 3)))]
    if coin():
        p["session_expiry"] = int(rng.integers(0, 2**32))
    if coin(0.2):
        p["assigned_client_id"] = _text(rng, 1)
    if coin(0.2):
        p["server_keep_alive"] = int(rng.integers(0, 2**16))
    if coin(0.2):
        p["auth_method"] = _text(rng, 1)
        if coin(0.5):
            p["auth_data"] = _blob(rng, 1)
    if coin(0.2):
        p["request_problem_info"] = int(rng.integers(0, 2))
    if coin(0.2):
        p["will_delay"] = int(rng.integers(0, 2**32))
    if coin(0.2):
        p["request_response_info"] = int(rng.integers(0, 2))
    if coin(0.2):
        p["response_info"] = _text(rng, 1)
    if coin(0.2):
        p["server_reference"] = _text(rng, 1)
    if coin():
        p["reason_string"] = _text(rng, 1)
    if coin(0.2):
        p["receive_maximum"] = int(rng.integers(1, 2**16))
    if coin(0.2):
        p["topic_alias_max"] = int(rng.integers(0, 2**16))
    if coin():
        p["topic_alias"] = int(rng.integers(1, 2**16))
    if coin(0.2):
        p["maximum_qos"] = int(rng.integers(0, 2))
    if coin(0.2):
        p["retain_available"] = int(rng.integers(0, 2))
    if coin(0.5):
        p["user_properties"] = [(_text(rng), _text(rng))
                                for _ in range(int(rng.integers(1, 4)))]
    if coin(0.2):
        p["maximum_packet_size"] = int(rng.integers(1, 2**32))
    for k in ("wildcard_sub_available", "sub_id_available",
              "shared_sub_available"):
        if coin(0.1):
            p[k] = int(rng.integers(0, 2))
    return p


def _spec(rng, ptype: int, ver: int) -> dict:  # qa: complex
    """One packet of type ``ptype`` at protocol version ``ver`` as plain
    data (so both packages build the same packet)."""
    v5 = ver == 5
    s = {"type": ptype, "ver": ver, "fixed": {}, "fields": {},
         "props": _props(rng, v5), "will": None, "filters": []}
    f = s["fields"]
    if ptype == 1:
        f["protocol_name"] = {3: "MQIsdp", 4: "MQTT", 5: "MQTT"}[ver]
        f["clean_start"] = bool(rng.random() < 0.5)
        f["keepalive"] = int(rng.integers(0, 2**16))
        f["client_id"] = _text(rng)
        if rng.random() < 0.5:
            s["will"] = {"topic": _text(rng, 1),
                         "payload": _blob(rng, 0, 32),
                         "qos": int(rng.integers(0, 3)),
                         "retain": bool(rng.random() < 0.5),
                         "props": _props(rng, v5)}
        f["username_flag"] = bool(rng.random() < 0.6)
        if f["username_flag"]:
            f["username"] = _blob(rng)
        f["password_flag"] = bool(rng.random() < 0.5)
        if f["password_flag"]:
            f["password"] = _blob(rng)
    elif ptype == 2:
        f["session_present"] = bool(rng.random() < 0.5)
        f["reason_code"] = int(rng.choice([0, 1, 2, 5, 128, 135]))
    elif ptype == 3:
        qos = int(rng.integers(0, 3))
        s["fixed"] = {"qos": qos, "dup": bool(qos and rng.random() < 0.3),
                      "retain": bool(rng.random() < 0.3)}
        f["topic"] = _text(rng, 1)
        if qos:
            f["packet_id"] = int(rng.integers(1, 2**16))
        f["payload"] = _blob(rng, 0, 64)
    elif ptype in (4, 5, 6, 7):
        f["packet_id"] = int(rng.integers(1, 2**16))
        if v5 and rng.random() < 0.6:
            f["reason_code"] = int(rng.choice([0, 16, 128, 131, 146]))
    elif ptype in (8, 10):
        f["packet_id"] = int(rng.integers(1, 2**16))
        for _ in range(int(rng.integers(1, 5))):
            sub = {"filter": _text(rng, 1)}
            if ptype == 8:
                sub["qos"] = int(rng.integers(0, 3))
                if v5:
                    sub["no_local"] = bool(rng.random() < 0.3)
                    sub["retain_as_published"] = bool(rng.random() < 0.3)
                    sub["retain_handling"] = int(rng.integers(0, 3))
            s["filters"].append(sub)
    elif ptype in (9, 11):
        f["packet_id"] = int(rng.integers(1, 2**16))
        f["reason_codes"] = [int(rng.choice([0, 1, 2, 17, 128, 135]))
                             for _ in range(int(rng.integers(1, 5)))]
    elif ptype in (14, 15):
        f["reason_code"] = int(rng.choice([0, 4, 24, 25, 129, 142]))
    return s


def build(pkg: str, spec: dict):
    codec, packets, props = PKGS[pkg]
    pk = packets.Packet(fixed=codec.FixedHeader(type=spec["type"],
                                                **spec["fixed"]),
                        protocol_version=spec["ver"])
    for k, v in spec["fields"].items():
        setattr(pk, k, v)
    pk.properties = props.Properties(**spec["props"])
    if spec["will"] is not None:
        w = dict(spec["will"])
        pk.will = packets.Will(properties=props.Properties(**w.pop("props")),
                               **w)
    pk.filters = [packets.Subscription(**sub) for sub in spec["filters"]]
    return pk


def outcome(fn):
    """What a codec call did: ("ok", value) or ("raise", class name,
    message, reason code)."""
    try:
        return ("ok", fn())
    except (j_codec.MalformedPacketError, t_codec.MalformedPacketError,
            j_packets.ProtocolError, t_packets.ProtocolError) as exc:
        code = getattr(exc, "code", None)
        return ("raise", type(exc).__name__, str(exc),
                None if code is None else (code.value, code.reason))


def fields(pk) -> dict:
    """A decoded packet's fields as plain data."""
    return dataclasses.asdict(pk)


def decode(pkg: str, raw: bytes, ver: int):
    """Frame ``raw`` with the package's ``parse_stream`` and decode its
    one packet."""
    codec, packets, _ = PKGS[pkg]
    buf = bytearray(raw)
    frames = list(packets.parse_stream(buf))
    if len(frames) != 1 or buf:
        return ("frames", len(frames), bytes(buf))
    fh, body = frames[0]
    return fields(packets.Packet.decode(fh, body, ver))


@pytest.mark.parametrize("ver", [3, 4, 5])
@pytest.mark.parametrize("ptype", range(1, 16))
def test_packet_encode_decode_parity(ptype, ver):
    """Every packet type x protocol version, 24 seeded packets each with
    random v5 properties: the encoded bytes are equal, and so are the
    fields both packages decode from them."""
    rng = np.random.default_rng(1000 * ptype + ver)
    encoded = 0
    for _ in range(24):
        spec = _spec(rng, ptype, ver)
        got = {pkg: outcome(lambda: build(pkg, spec).encode())
               for pkg in PKGS}
        assert got["torch"] == got["jax"], spec
        if got["torch"][0] != "ok":
            continue
        encoded += 1
        raw = got["torch"][1]
        dec = {pkg: outcome(lambda: decode(pkg, raw, ver)) for pkg in PKGS}
        assert dec["torch"] == dec["jax"], raw.hex()
    assert encoded, "no packet of this type encoded"


@pytest.mark.parametrize("seed", range(4))
def test_parse_stream_over_random_splits(seed):
    """Frames of every type concatenated, fed to ``parse_stream`` in
    chunks cut at random offsets: both packages yield the same (fixed
    header, body) pairs, the frames as sent, and decode them alike; a
    frame over ``max_packet_size`` raises the same error."""
    rng = np.random.default_rng(seed)
    ver = (3, 4, 5, 5)[seed]
    raws = []
    while len(raws) < 40:
        ptype = int(rng.integers(1, 16 if ver == 5 else 15))
        o = outcome(lambda: build("torch", _spec(rng, ptype, ver)).encode())
        if o[0] == "ok":
            raws.append(o[1])
    stream = b"".join(raws)
    cuts = sorted(set(int(c) for c in rng.integers(0, len(stream), 30)))
    chunks = [stream[a:b] for a, b in zip([0] + cuts, cuts + [len(stream)])]
    seen = {}
    for pkg in PKGS:
        codec, packets, _ = PKGS[pkg]
        buf, out = bytearray(), []
        for chunk in chunks:
            buf += chunk
            for fh, body in packets.parse_stream(buf):
                out.append((dataclasses.asdict(fh), body, outcome(
                    lambda: fields(packets.Packet.decode(fh, body, ver)))))
        assert not buf
        seen[pkg] = out
    assert seen["torch"] == seen["jax"]
    assert len(seen["torch"]) == len(raws)
    for raw, (fh, body, _) in zip(raws, seen["torch"]):
        assert raw.endswith(body) and fh["type"] == raw[0] >> 4
    big = max(raws, key=len)
    errs = {pkg: outcome(lambda: list(PKGS[pkg][1].parse_stream(
        bytearray(big), max_packet_size=len(big) - 1))) for pkg in PKGS}
    assert errs["torch"] == errs["jax"] and errs["torch"][0] == "raise"


MALFORMED = [
    # (label, frame hex, protocol version): each a frame that must fail
    ("varint-5-bytes", "30ffffffff7f", 4),
    ("utf8-overlong-nul", "3005 0002c080 00", 4),
    ("utf8-surrogate", "3006 0003eda080 00", 4),
    ("utf8-nul", "3004 000100 41", 4),
    ("utf8-bad-continuation", "3006 0002c328 0000", 4),
    ("publish-qos3", "3605 000161 0000", 4),
    ("pubrel-flags-0", "6002 0001", 4),
    ("subscribe-flags-0", "8006 0001 000161 00", 4),
    ("unsubscribe-flags-0", "a005 0001 000161", 4),
    ("pingreq-flags", "c100", 4),
    ("reserved-type-0", "0000", 4),
    ("auth-pre-v5", "f000", 4),
    ("truncated-publish", "300a 000161", 4),
    ("truncated-connect", "1010 00044d515454", 4),
    ("connect-bad-protocol-name", "100c 00044d515458 04 02 003c 0000", 4),
    ("connect-reserved-flag", "100c 00044d515454 04 03 003c 0000", 4),
    ("subscribe-qos3", "8206 0001 000161 03", 4),
    ("subscribe-retain-handling-3", "8207 0001 00 000161 30", 5),
    ("props-past-body", "3007 000161 09 230001", 5),
    ("props-duplicate-alias", "300b 000161 06 230001 230002 ff", 5),
    ("props-invalid-for-type", "3008 000161 03 120001 61", 5),
    ("sub-id-zero", "8209 0001 02 0b00 000161 00", 5),
    ("receive-maximum-zero", "1010 00044d515454 05 02 0000 03 210000 0000",
     5),
    ("connack-max-qos-2", "2005 0000 02 2402", 5),
    ("v4-password-without-username", "100e 00044d515454 04 42 0000 0000 "
     "0000", 4),
]


def decode_direct(pkg: str, raw: bytes, ver: int):
    """Decode one frame as the transport hands it over (the body cut at
    its remaining length, possibly short): ``FixedHeader.decode`` then
    ``Packet.decode``; a fixed header that does not parse goes through
    ``parse_stream``, which raises for it."""
    codec, packets, _ = PKGS[pkg]
    framed = frame(raw)
    if framed is None:
        return decode(pkg, raw, ver)
    fb, remaining, body = framed
    fh = codec.FixedHeader.decode(fb, remaining)
    return fields(packets.Packet.decode(fh, body, ver))


@pytest.mark.parametrize("hx,ver", [(h, v) for _, h, v in MALFORMED],
                         ids=[m[0] for m in MALFORMED])
def test_malformed_inputs_fail_alike(hx, ver):
    """Bad varints, bad UTF-8, reserved flags, truncated frames, bad
    properties: both packages raise, with the same exception class,
    message and reason code."""
    raw = bytes.fromhex(hx.replace(" ", ""))
    got = {pkg: outcome(lambda: decode_direct(pkg, raw, ver))
           for pkg in PKGS}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "raise", got["torch"]


def test_mutation_fuzz_parity():
    """3,000 near-valid frames (a bit flipped, truncated, garbage
    appended) decode to the same fields or fail alike in both."""
    rng = np.random.default_rng(77)
    seeds = []
    while len(seeds) < 150:
        ver = int(rng.choice([3, 4, 5]))
        ptype = int(rng.integers(1, 16 if ver == 5 else 15))
        o = outcome(lambda: build("torch", _spec(rng, ptype, ver)).encode())
        if o[0] == "ok":
            seeds.append((o[1], ver))
    raised = 0
    for _ in range(3000):
        raw, ver = seeds[int(rng.integers(0, len(seeds)))]
        m = bytearray(raw)
        op = rng.random()
        if op < 0.5:
            m[int(rng.integers(0, len(m)))] ^= 1 << int(rng.integers(0, 8))
        elif op < 0.75 and len(m) > 1:
            m = m[:int(rng.integers(1, len(m)))]
        else:
            m += rng.bytes(int(rng.integers(1, 5)))
        got = {pkg: outcome(lambda: decode_direct(pkg, bytes(m), ver))
               for pkg in PKGS}
        assert got["torch"] == got["jax"], (bytes(m).hex(), ver)
        raised += got["torch"][0] == "raise"
    assert raised > 300


# -- the port's codec against its reference decoder ----------------------
#
# The matrix of tests/test_refdecode.py (the conformance corpus, seeded
# encodes of the port's encoder, hand-built edge vectors, mutations), held
# through the canonical form that maxmq_torch_refdecode.cpp's header
# defines. The canonicalizer below mirrors that contract.

_REF_OUT = ctypes.create_string_buffer(1 << 20)


@pytest.fixture(scope="module")
def refdecode():
    fn = native.refdecode()
    assert fn is not None, native.build_errors
    return fn


def ref_decode(fn, first_byte, remaining, body, ver):
    n = fn(first_byte, remaining, body, len(body), ver, _REF_OUT,
           len(_REF_OUT))
    assert n != -2, "reference decoder output buffer too small"
    return None if n < 0 else _REF_OUT.raw[:n].decode()


def _hx(data) -> str:
    return (data.encode() if isinstance(data, str) else bytes(data)).hex()


_CANON_PROPS = [  # (id, field, hex-encoded)
    (1, "payload_format", False), (2, "message_expiry", False),
    (3, "content_type", True), (8, "response_topic", True),
    (9, "correlation_data", True), (11, "subscription_ids", False),
    (17, "session_expiry", False), (18, "assigned_client_id", True),
    (19, "server_keep_alive", False), (21, "auth_method", True),
    (22, "auth_data", True), (23, "request_problem_info", False),
    (24, "will_delay", False), (25, "request_response_info", False),
    (26, "response_info", True), (28, "server_reference", True),
    (31, "reason_string", True), (33, "receive_maximum", False),
    (34, "topic_alias_max", False), (35, "topic_alias", False),
    (36, "maximum_qos", False), (37, "retain_available", False),
    (38, "user_properties", True), (39, "maximum_packet_size", False),
    (40, "wildcard_sub_available", False), (41, "sub_id_available", False),
    (42, "shared_sub_available", False)]


def _canon_props(p, prefix: str = "") -> str:
    """Ascending property id; empty strings/bytes are absent."""
    out = []
    for pid, name, hexed in _CANON_PROPS:
        v = getattr(p, name)
        if name == "subscription_ids":
            out += [f"{prefix}p.{pid}={sid}\n" for sid in v]
        elif name == "user_properties":
            out += [f"{prefix}p.{pid}={_hx(k)},{_hx(w)}\n" for k, w in v]
        elif hexed and v:
            out.append(f"{prefix}p.{pid}={_hx(v)}\n")
        elif not hexed and v is not None:
            out.append(f"{prefix}p.{pid}={v}\n")
    return "".join(out)


def canon_packet(pk) -> str:  # qa: complex
    t = pk.fixed.type
    out = [f"t={t}\n"]
    if t == 3:
        out.append(f"dup={int(pk.fixed.dup)}\nqos={pk.fixed.qos}\n"
                   f"retain={int(pk.fixed.retain)}\n")
    if t == 1:
        out.append(f"v={pk.protocol_version}\nclean={int(pk.clean_start)}\n"
                   f"ka={pk.keepalive}\n")
        out.append(_canon_props(pk.properties))
        out.append(f"cid={_hx(pk.client_id)}\n")
        if pk.will is not None:
            out.append(f"w=1\nw.qos={pk.will.qos}\n"
                       f"w.retain={int(pk.will.retain)}\n")
            out.append(_canon_props(pk.will.properties, "w."))
            out.append(f"w.topic={_hx(pk.will.topic)}\n"
                       f"w.payload={_hx(pk.will.payload)}\n")
        out.append(f"uf={int(pk.username_flag)}\n")
        if pk.username_flag:
            out.append(f"un={_hx(pk.username)}\n")
        out.append(f"pf={int(pk.password_flag)}\n")
        if pk.password_flag:
            out.append(f"pw={_hx(pk.password)}\n")
    elif t == 2:
        out.append(f"sp={int(pk.session_present)}\nrc={pk.reason_code}\n")
        out.append(_canon_props(pk.properties))
    elif t == 3:
        out.append(f"topic={_hx(pk.topic)}\npid={pk.packet_id}\n")
        out.append(_canon_props(pk.properties))
        out.append(f"pl={_hx(pk.payload)}\n")
    elif t in (4, 5, 6, 7):
        out.append(f"pid={pk.packet_id}\nrc={pk.reason_code}\n")
        out.append(_canon_props(pk.properties))
    elif t in (8, 10):
        out.append(f"pid={pk.packet_id}\n")
        out.append(_canon_props(pk.properties))
        for s in pk.filters:
            out.append(f"f={_hx(s.filter)},{s.qos},{int(s.no_local)},"
                       f"{int(s.retain_as_published)},{s.retain_handling}\n"
                       if t == 8 else f"f={_hx(s.filter)}\n")
    elif t == 9:
        out.append(f"pid={pk.packet_id}\n")
        out.append(_canon_props(pk.properties))
        out.append(f"rcs={_hx(bytes(pk.reason_codes))}\n")
    elif t == 11:
        out.append(f"pid={pk.packet_id}\n")
        if pk.v5:
            out.append(_canon_props(pk.properties))
            out.append(f"rcs={_hx(bytes(pk.reason_codes))}\n")
    elif t in (14, 15):
        out.append(f"rc={pk.reason_code}\n")
        out.append(_canon_props(pk.properties))
    return "".join(out)


def frame(raw: bytes):
    """(first byte, remaining, body), the body cut at ``remaining``; None
    when the fixed header itself does not parse."""
    remaining, shift, i = 0, 0, 1
    while True:
        if i >= len(raw) or i > 4:
            return None
        b = raw[i]
        remaining |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            break
        shift += 7
    return raw[0], remaining, raw[i:i + remaining]


def port_canon(fb, remaining, body, ver):
    try:
        fh = t_codec.FixedHeader.decode(fb, remaining)
        return canon_packet(t_packets.Packet.decode(fh, body, ver))
    except (t_codec.MalformedPacketError, t_packets.ProtocolError):
        return None


def compare_ref(fn, raw: bytes, ver: int) -> str | None:
    """The port's codec and the reference decoder agree: both reject, or
    both accept with the same canonical text (returned)."""
    framed = frame(raw)
    if framed is None:
        return None
    ours = port_canon(*framed, ver)
    ref = ref_decode(fn, *framed, ver)
    assert ours == ref, (raw.hex(), ver, ours, ref)
    return ours


CORPUS = [c for c in json.loads(
    (Path(__file__).parent / "fixtures" / "tpackets.json").read_text())
    if c["ptype"] != 0]


def corpus_version(case: dict) -> int:
    if case["protocol_version"]:
        return case["protocol_version"]
    name = case["case"] + case.get("desc", "")
    if "Mqtt5" in name or "mqtt v5" in name or "mqtt 5" in name:
        return 5
    if "Mqtt31" in name and "Mqtt311" not in name:
        return 3
    return 4


@pytest.mark.parametrize("case", CORPUS, ids=[c["case"] for c in CORPUS])
def test_refdecode_conformance_corpus(refdecode, case):
    compare_ref(refdecode, bytes.fromhex(case["raw"]), corpus_version(case))


@pytest.mark.parametrize("hx,ver", [(h, v) for _, h, v in MALFORMED],
                         ids=[m[0] for m in MALFORMED])
def test_refdecode_edge_vectors(refdecode, hx, ver):
    compare_ref(refdecode, bytes.fromhex(hx.replace(" ", "")), ver)


def test_refdecode_accepts_every_port_encode(refdecode):
    """2,000 seeded packets of every type through the port's encoder:
    the reference decoder reads each as the port's codec does (most are
    accepted; random combinations the spec forbids are rejected by
    both)."""
    rng = np.random.default_rng(20260731)
    checked = accepted = 0
    for _ in range(2000):
        ver = int(rng.choice([3, 4, 5]))
        ptype = int(rng.integers(1, 16 if ver == 5 else 15))
        o = outcome(lambda: build("torch", _spec(rng, ptype, ver)).encode())
        if o[0] != "ok":
            continue
        checked += 1
        if compare_ref(refdecode, o[1], ver) is not None:
            accepted += 1
    assert checked > 1500 and accepted > 0.8 * checked, (checked, accepted)


def test_refdecode_mutation_fuzz(refdecode):
    rng = np.random.default_rng(424242)
    seeds = [(bytes.fromhex(c["raw"]), corpus_version(c)) for c in CORPUS]
    while len(seeds) < len(CORPUS) + 120:
        ver = int(rng.choice([3, 4, 5]))
        ptype = int(rng.integers(1, 16 if ver == 5 else 15))
        o = outcome(lambda: build("torch", _spec(rng, ptype, ver)).encode())
        if o[0] == "ok":
            seeds.append((o[1], ver))
    for _ in range(3000):
        raw, ver = seeds[int(rng.integers(0, len(seeds)))]
        m = bytearray(raw)
        op = rng.random()
        if op < 0.5 and m:
            m[int(rng.integers(0, len(m)))] ^= 1 << int(rng.integers(0, 8))
        elif op < 0.75 and len(m) > 1:
            m = m[:int(rng.integers(1, len(m)))]
        else:
            m += rng.bytes(int(rng.integers(1, 5)))
        compare_ref(refdecode, bytes(m), ver)
