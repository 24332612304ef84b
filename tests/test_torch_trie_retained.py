"""The retained/alias half of the port's topic index (``matching/trie.py``)
against the JAX package's: seeded sequences of ``retain`` (store,
replace, clear), ``retained_get``, ``retained_for`` (with '$' topics under
'#' and '+', [MQTT-4.7.2-1]), ``select_shared`` with an ``alive``
predicate across shared subscribe/unsubscribe, ``TopicAliases`` inbound
and outbound, and ``SubscriberSet.select_copy`` on both the Python class
and the C type. The port runs with its native ``SubscriberSet`` bound and
again in a ``MAXMQ_NO_NATIVE=1`` subprocess. Tolerance: equal results."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from maxmq_tpu.matching import trie as j_trie
from maxmq_tpu.protocol import codec as j_codec
from maxmq_tpu.protocol import packets as j_packets
from maxmq_tpu_torch import native
from maxmq_tpu_torch.matching import trie as t_trie
from maxmq_tpu_torch.protocol import codec as t_codec
from maxmq_tpu_torch.protocol import packets as t_packets

ROOT = Path(__file__).resolve().parent.parent
SEEDS = range(6)
LEVELS = ["a", "b", "c", "d"]


def _topic(rng) -> str:
    levels = [LEVELS[int(k)] for k in rng.integers(0, 4,
                                                   int(rng.integers(1, 5)))]
    r = rng.random()
    if r < 0.15:
        levels[0] = "$SYS"
    elif r < 0.25:
        levels[0] = "$x"
    return "/".join(levels)


def _filter(rng) -> str:
    levels = [(LEVELS + ["+"])[int(k)]
              for k in rng.integers(0, 5, int(rng.integers(1, 4)))]
    r = rng.random()
    if r < 0.3:
        levels.append("#")
    elif r < 0.4:
        levels = ["#"]
    if rng.random() < 0.15 and levels != ["#"]:
        levels[0] = "$SYS"
    return "/".join(levels)


def run_sequence(trie, codec, packets, seed: int, n_ops: int = 400):
    """One seeded sequence against ``trie``'s TopicIndex and
    TopicAliases; every answer as plain data."""
    rng = np.random.default_rng(seed)
    idx = trie.TopicIndex()
    aliases = trie.TopicAliases(int(rng.integers(2, 6)))
    clients = [f"c{i}" for i in range(6)]
    share_filters = [f"$share/g{g}/{f}" for g in range(2)
                     for f in ("a/+", "b/#")]
    held = {f: set() for f in share_filters}
    out = []
    for i in range(n_ops):
        op = rng.random()
        if op < 0.3:
            topic = _topic(rng)
            payload = b"" if rng.random() < 0.2 else rng.bytes(4)
            pk = packets.Packet(
                fixed=codec.FixedHeader(type=codec.PacketType.PUBLISH,
                                        retain=True),
                topic=topic, payload=payload, created=float(i))
            out.append(("retain", topic, idx.retain(pk),
                        idx.retained_count))
        elif op < 0.45:
            topic = _topic(rng)
            got = idx.retained_get(topic)
            out.append(("get", topic, None if got is None
                        else [got.topic, got.payload.hex()]))
        elif op < 0.6:
            filt = _filter(rng)
            out.append(("for", filt, [[p.topic, p.payload.hex()]
                                      for p in idx.retained_for(filt)]))
        elif op < 0.72:
            f = share_filters[int(rng.integers(0, len(share_filters)))]
            cid = clients[int(rng.integers(0, len(clients)))]
            if cid in held[f] and rng.random() < 0.5:
                held[f].discard(cid)
                out.append(("unsub", f, cid, idx.unsubscribe(cid, f)))
            else:
                held[f].add(cid)
                out.append(("sub", f, cid, idx.subscribe(
                    cid, packets.Subscription(filter=f, qos=i % 3))))
        elif op < 0.88:
            f = share_filters[int(rng.integers(0, len(share_filters)))]
            group = f.split("/")[1]
            got = idx.subscribers(f.split("/", 2)[2].replace(
                "+", "x").replace("#", "y/z"))
            candidates = got.shared.get((group, f), {})
            dead = {c for c in clients if rng.random() < 0.3}
            pick = idx.select_shared(group, f, candidates,
                                     alive=lambda c: c not in dead)
            out.append(("select", f, sorted(candidates), sorted(dead),
                        None if pick is None else [pick[0], pick[1].qos]))
        elif op < 0.94:
            alias = int(rng.integers(0, 7))
            topic = "" if rng.random() < 0.4 else _topic(rng)
            out.append(("inbound", topic, alias,
                        aliases.resolve_inbound(topic, alias or None)))
        else:
            topic = _topic(rng)
            out.append(("outbound", topic,
                        list(aliases.assign_outbound(topic))))
    out.append(("end", idx.retained_count, idx.subscription_count))
    return json.loads(json.dumps(out))


@pytest.mark.parametrize("seed", SEEDS)
def test_retained_alias_sequence_parity(seed):
    want = run_sequence(j_trie, j_codec, j_packets, seed)
    got = run_sequence(t_trie, t_codec, t_packets, seed)
    assert got == want
    kinds = {step[0] for step in want}
    assert kinds >= {"retain", "get", "for", "sub", "select", "inbound",
                     "outbound"}


def test_retained_dollar_topics_stay_out_of_root_wildcards():
    """[MQTT-4.7.2-1]: '#' and '+' at the first level skip '$' topics;
    a filter naming '$SYS' reaches them."""
    results = {}
    for name, (trie, codec, packets) in {
            "jax": (j_trie, j_codec, j_packets),
            "torch": (t_trie, t_codec, t_packets)}.items():
        idx = trie.TopicIndex()
        for i, t in enumerate(("$SYS/up", "$SYS/a/b", "a", "a/b", "$x")):
            idx.retain(packets.Packet(
                fixed=codec.FixedHeader(type=codec.PacketType.PUBLISH,
                                        retain=True),
                topic=t, payload=b"p", created=float(i)))
        results[name] = {f: [p.topic for p in idx.retained_for(f)]
                         for f in ("#", "+", "+/b", "$SYS/#", "$SYS/+",
                                   "a/#", "+/+")}
    assert results["torch"] == results["jax"]
    assert results["torch"]["#"] == ["a", "a/b"]
    assert results["torch"]["$SYS/#"] == ["$SYS/up", "$SYS/a/b"]


def test_retained_sequences_without_native():
    """The same sequences in a ``MAXMQ_NO_NATIVE=1`` interpreter, where
    the port's ``SubscriberSet`` stays the Python class."""
    script = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / "tests")!r}]
        from maxmq_tpu_torch.matching import trie
        from maxmq_tpu_torch.protocol import codec, packets
        assert trie.SubscriberSet is trie._PySubscriberSet
        from test_torch_trie_retained import run_sequence
        print(json.dumps([run_sequence(trie, codec, packets, s)
                          for s in {list(SEEDS)!r}]))
    """)
    env = dict(os.environ, MAXMQ_NO_NATIVE="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == [run_sequence(j_trie, j_codec, j_packets, s)
                   for s in SEEDS]


SET_CLASSES = {"python": t_trie._PySubscriberSet}
if native.decode_module() is not None:
    SET_CLASSES["native"] = native.decode_module().SubscriberSet


@pytest.mark.parametrize("kind", ["python", "native"])
def test_select_copy_fresh_dicts_aliased_records(kind):
    """``select_copy``: fresh outer dicts (a hook may add, drop or
    replace entries) over the SAME records, as the JAX package's."""
    assert kind in SET_CLASSES, native.build_errors
    if kind == "native":
        assert t_trie.SubscriberSet is SET_CLASSES["native"]
    made = {}
    for name, (cls, sub_cls) in {
            "jax": (j_trie._PySubscriberSet, j_packets.Subscription),
            "torch": (SET_CLASSES[kind], t_packets.Subscription)}.items():
        a, b, s = (sub_cls(filter="a/#", qos=1, identifier=4),
                   sub_cls(filter="a/+", qos=2),
                   sub_cls(filter="$share/g/a/#", qos=0))
        ss = cls()
        ss.add("c1", a, "a/#")
        ss.add("c2", b, "a/+")
        ss.add_shared("g", "$share/g/a/#", "c3", s)
        cp = ss.select_copy()
        assert cp.subscriptions is not ss.subscriptions
        assert cp.shared is not ss.shared
        assert cp.shared[("g", "$share/g/a/#")] is not \
            ss.shared[("g", "$share/g/a/#")]
        assert cp.subscriptions["c2"] is ss.subscriptions["c2"]
        assert cp.shared[("g", "$share/g/a/#")]["c3"] is s
        assert cp == ss
        del cp.subscriptions["c1"]
        cp.shared[("g", "$share/g/a/#")]["c9"] = b
        assert "c1" in ss.subscriptions
        assert "c9" not in ss.shared[("g", "$share/g/a/#")]
        made[name] = (sorted(cp.subscriptions), sorted(
            (k, sorted(m)) for k, m in cp.shared.items()), len(ss))
    assert made["torch"] == made["jax"]
