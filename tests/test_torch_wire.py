"""The port's shared PUBLISH wire templates (``protocol/wire.py``) against
the port's codec (``Packet.encode`` of the delivery the broker's slow
path shapes) and against the JAX package's templates, over the matrix of
tests/test_wire_templates.py: v3.1.1 / v5 x QoS 0/1/2 x retain-as-
published x subscription identifiers x outbound topic alias, with rich
and empty property blocks and an empty payload; the native head against
the Python head; an armed NATIVE_ENCODE site. Tolerance: exact bytes."""

import numpy as np
import pytest

from maxmq_tpu.protocol import codec as j_codec
from maxmq_tpu.protocol import packets as j_packets
from maxmq_tpu.protocol import properties as j_props
from maxmq_tpu.protocol import wire as j_wire
from maxmq_tpu_torch import faults
from maxmq_tpu_torch.protocol import codec as t_codec
from maxmq_tpu_torch.protocol import packets as t_packets
from maxmq_tpu_torch.protocol import properties as t_props
from maxmq_tpu_torch.protocol import wire as t_wire

PKGS = {"jax": (j_codec, j_packets, j_props, j_wire),
        "torch": (t_codec, t_packets, t_props, t_wire)}
TOPIC = "sensor/kitchen/temp"


@pytest.fixture(autouse=True)
def clean_faults():
    faults.clear()
    yield
    faults.clear()


def publish(pkg, qos, retain, props: str, payload=b"x" * 48):
    """The inbound publish: ``props`` "rich" has content on both sides of
    the template's splice point, "empty" none."""
    codec, packets, properties, _ = PKGS[pkg]
    p = packets.Packet(fixed=codec.FixedHeader(type=codec.PacketType.PUBLISH,
                                               qos=qos, retain=retain),
                       protocol_version=5, topic=TOPIC, payload=payload,
                       packet_id=9 if qos else 0)
    if props == "rich":
        p.properties = properties.Properties(
            payload_format=1, content_type="application/json",
            correlation_data=b"corr-1234", topic_alias=3,
            user_properties=[("origin", "matrix"), ("pad", "v" * 40)])
    return p


def slow_path(pkg, packet, version, qos, retain, pid, ids, alias,
              alias_topic) -> bytes:
    """The delivery as the broker's ``_build_outbound`` shapes it,
    encoded by the codec."""
    out = packet.copy()
    out.protocol_version = version
    out.fixed.qos, out.fixed.dup, out.fixed.retain = qos, False, retain
    out.packet_id = pid
    if version < 5:
        out.properties = PKGS[pkg][2].Properties()
    else:
        out.properties.subscription_ids = list(ids)
        out.properties.topic_alias = alias
        if alias_topic:
            out.topic = ""
    return out.encode()


SUBS = {"plain": [], "sid": [7], "merged": [3, 9], "big-sid": [268_435_455]}
ALIASES = {"none": (None, False), "first": (5, False), "repeat": (5, True)}


def cases(version):
    for payload in (b"x" * 48, b""):
        for props in ("rich", "empty"):
            for retain in (False, True):
                for sub in SUBS:
                    for alias in ALIASES:
                        if version < 5 and (sub != "plain" or alias != "none"):
                            continue
                        yield payload, props, retain, sub, alias


@pytest.mark.parametrize("native", [True, False], ids=["c-head", "py-head"])
@pytest.mark.parametrize("qos", [0, 1, 2])
@pytest.mark.parametrize("version", [4, 5])
def test_template_matches_codec_and_reference(version, qos, native):
    """``publish_template(...).patch(...)`` equals the codec's encode of
    the same delivery and the JAX package's template, frame for frame;
    ``frame_size`` predicts the frame's length before any byte moves."""
    n = 0
    for payload, props, retain, sub, alias in cases(version):
        ids = SUBS[sub]
        a, alias_topic = ALIASES[alias]
        pid = 4242 if qos else 0
        frames = {}
        for pkg in PKGS:
            wire = PKGS[pkg][3]
            pk = publish(pkg, qos, retain, props, payload)
            tmpl = wire.publish_template(pk, version)
            mid = wire.sid_alias_seg(ids, a) if version >= 5 else b""
            bufs, size = tmpl.patch(qos, retain, pid, mid, alias_topic,
                                    native=native)
            frame = b"".join(bufs)
            assert size == len(frame)
            assert tmpl.frame_size(len(mid), bool(pid), alias_topic) == size
            assert wire.publish_template(pk, version) is tmpl   # cached
            assert frame == slow_path(pkg, pk, version, qos, retain, pid,
                                      ids, a, alias_topic), (pkg, sub, alias)
            frames[pkg] = frame
        assert frames["torch"] == frames["jax"]
        n += 1
    assert n == (16 * 3 * 2 if version == 5 else 8)


def test_native_head_matches_python_head():
    """5,000 seeded head shapes: the port's C encoder, its Python
    encoder and the JAX package's Python encoder give the same bytes
    (flags, topic segments, every packet-id form, property lengths at
    each varint width boundary and -1 for v3 frames, payload tails)."""
    enc = t_wire.native_head_encoder()
    assert enc is not None, "the port's decode extension is not built"
    rng = np.random.default_rng(0x019)
    boundary = [0, 1, 127, 128, 16383, 16384, 2097151, 2097152]
    for _ in range(5000):
        flags = 0x30 | int(rng.integers(0, 16))
        tlen = int(rng.choice([0, 1, 7, 64, 300]))
        topic_seg = tlen.to_bytes(2, "big") + rng.bytes(tlen)
        pid = int(rng.choice([0, 1, 255, 256, 65535,
                              int(rng.integers(1, 65536))]))
        props_len = int(rng.choice([-1] + boundary
                                   + [int(rng.integers(0, 1 << 21))]))
        tail = int(rng.choice(boundary[:-2] + [300000]))
        want = j_wire._encode_head_py(flags, topic_seg, pid, props_len, tail)
        assert enc(flags, topic_seg, pid, props_len, tail) == want
        assert t_wire._encode_head_py(flags, topic_seg, pid, props_len,
                                      tail) == want


def test_heads_are_counted_by_encoder():
    """Each frame head counts under the encoder that made it."""
    pk = publish("torch", 1, False, "rich")
    tmpl = t_wire.publish_template(pk, 5)
    before = dict(t_wire.heads)
    tmpl.patch(1, False, 1, b"", False, native=True)
    tmpl.patch(1, False, 2, b"", False, native=False)
    tmpl.patch(0, False, 0, b"", False, native=True)
    assert t_wire.heads["native"] - before["native"] == 2
    assert t_wire.heads["python"] - before["python"] == 1


@pytest.mark.parametrize("version", [4, 5])
def test_armed_native_encode_falls_back_to_python_head(version):
    """An armed NATIVE_ENCODE site sends the heads to the Python encoder:
    the frames stay byte-identical, and the Python counter rises by
    exactly the armed count."""
    pk = publish("torch", 1, True, "rich")
    tmpl = t_wire.publish_template(pk, version)
    mid = t_wire.sid_alias_seg([7], 5) if version >= 5 else b""
    clean = [b"".join(tmpl.patch(1, True, pid, mid, False)[0])
             for pid in range(1, 6)]
    before = dict(t_wire.heads)
    faults.arm(faults.NATIVE_ENCODE, "raise", count=3)
    armed = [b"".join(tmpl.patch(1, True, pid, mid, False)[0])
             for pid in range(1, 6)]
    assert armed == clean
    assert faults.fired[faults.NATIVE_ENCODE] == 3
    assert t_wire.heads["python"] - before["python"] == 3
    assert t_wire.heads["native"] - before["native"] == 2
