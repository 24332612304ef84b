"""The port's hooks (``maxmq_tpu_torch.hooks``: the dispatcher, the auth
hooks and the logging hooks) against the JAX package's: the same hook
sets give the same dispatch results, the same ledgers the same auth and
ACL decisions, the same events the same log lines."""

import io
import itertools
import random
import time
from types import SimpleNamespace

import pytest

from maxmq_tpu import hooks as ref_hooks
from maxmq_tpu.hooks import logging as ref_loghooks
from maxmq_tpu.protocol import codec as ref_codec
from maxmq_tpu.protocol import packets as ref_packets
from maxmq_tpu.utils import logger as ref_logger
from maxmq_tpu_torch import hooks
from maxmq_tpu_torch.hooks import logging as loghooks
from maxmq_tpu_torch.protocol import codec, packets
from maxmq_tpu_torch.utils import logger


def hook_classes(mod):
    """A family of hooks over one package's ``Hook``: modify-chain hooks
    that rewrite, return None or keep; any-allow hooks that allow or
    refuse; first-non-empty getters that answer empty or not; notify
    hooks that record their order."""
    base = mod.Hook
    calls = []

    class Append(base):
        id = "append"

        def __init__(self, tag):
            self.tag = tag

        def on_publish(self, packet, client):
            return packet + [self.tag]

        def on_subscribe(self, packet, client):
            return None

        def on_started(self):
            calls.append(("started", self.tag))

        def on_connect(self, client, packet):
            calls.append(("connect", self.tag, client))

    class Allow(base):
        id = "allow"

        def __init__(self, verdict):
            self.verdict = verdict

        def on_connect_authenticate(self, client, packet):
            calls.append(("auth", self.verdict))
            return self.verdict

        def on_acl_check(self, client, topic, write):
            return self.verdict and (write or topic.startswith("r/"))

    class Store(base):
        id = "store"

        def __init__(self, items):
            self.items = items

        def stored_clients(self):
            return self.items

        def stored_sys_info(self):
            return self.items or None

    class Failing(base):
        def stop(self):
            raise RuntimeError("stop fails")

    return {"append": Append, "allow": Allow, "store": Store,
            "failing": Failing, "plain": base}, calls


RECIPES = [
    [],
    [("append", "a")],
    [("append", "a"), ("plain",), ("append", "b")],
    [("allow", False), ("allow", True)],
    [("allow", False), ("allow", False), ("failing",)],
    [("store", []), ("store", ["c1", "c2"]), ("store", ["c3"])],
    [("store", []), ("append", "x"), ("allow", True), ("failing",)],
]


def run_recipe(mod, recipe):
    classes, calls = hook_classes(mod)
    hs = mod.Hooks()
    for name, *args in recipe:
        h = classes[name](*args)
        assert hs.add(h, config={"k": 1}) is h
    out = {"len": len(hs), "ids": [h.id for h in hs]}
    out["overrides"] = {e: hs.overrides(e) for e in (
        "on_publish", "on_subscribe", "on_acl_check", "stored_clients",
        "on_packet_sent", "on_select_subscribers", "stored_sys_info")}
    out["provides"] = hs.provides("on_connect_authenticate")
    out["publish"] = hs.modify("on_publish", ["p"], "cl")
    out["subscribe"] = hs.modify("on_subscribe", "sub", "cl")
    out["select"] = hs.modify("on_select_subscribers", {"s": 1}, "pkt")
    out["auth"] = hs.any_allow("on_connect_authenticate", "cl", "pkt")
    out["acl"] = [hs.any_allow("on_acl_check", "cl", t, w)
                  for t in ("r/x", "w/x") for w in (False, True)]
    out["clients"] = hs.first_non_empty("stored_clients")
    out["subs"] = hs.first_non_empty("stored_subscriptions")
    out["sys"] = hs.first_non_empty("stored_sys_info")
    hs.notify("on_started")
    hs.notify("on_connect", "cl", "pkt")
    hs.stop_all()
    for event, fn in (("on_publish", hs.any_allow),
                      ("on_acl_check", lambda e: hs.modify(e, 1)),
                      ("on_publish", hs.first_non_empty)):
        with pytest.raises(AssertionError):
            fn(event)
    out["calls"] = list(calls)
    return out


@pytest.mark.parametrize("recipe", RECIPES, ids=range(len(RECIPES)))
def test_hooks_dispatch_equal(recipe):
    assert run_recipe(hooks, recipe) == run_recipe(ref_hooks, recipe)


def test_hook_base_surface_equal():
    names = sorted(n for n in vars(ref_hooks.Hook) if not n.startswith("__"))
    assert sorted(n for n in vars(hooks.Hook)
                  if not n.startswith("__")) == names
    from maxmq_tpu.hooks import base as ref_base
    from maxmq_tpu_torch.hooks import base
    assert (base._MODIFY, base._ANY_ALLOW, base._FIRST_NON_EMPTY) == \
        (ref_base._MODIFY, ref_base._ANY_ALLOW, ref_base._FIRST_NON_EMPTY)
    err = hooks.RejectPacket(ack_success=False)
    assert str(err) == str(ref_hooks.RejectPacket()) and not err.ack_success


LEDGER = {
    "auth": [
        {"username": "admin", "password": "pw", "allow": True},
        {"username": "banned*", "allow": False},
        {"remote": "10.0.*", "client_id": "dev-*"},
        {"client_id": "open", "password": ""},
        {"username": "u*", "password": "x", "remote": "1.2.3.4:*"},
    ],
    "acl": [
        {"username": "admin", "filters": {"#": "readwrite"}},
        {"client_id": "dev-*", "filters": {"devices/+/state": "write",
                                           "devices/#": "read",
                                           "secret/#": "deny"}},
        {"remote": "10.*", "filters": {"a/+/c": "read", "a/b": "write"}},
        {"username": "u1", "filters": {"x/#": "deny", "x": "readwrite"}},
    ],
}

USERS = ["", "admin", "banned1", "u1", "guest"]
PASSWORDS = ["", "pw", "x"]
REMOTES = ["10.0.0.1:5", "1.2.3.4:99", "127.0.0.1:1"]
CLIENT_IDS = ["dev-1", "open", "other"]
TOPICS = ["devices/a/state", "devices/a/b", "devices", "secret/k",
          "a/b/c", "a/b", "a/b/c/d", "x", "x/y", "zz"]


def decisions(mod, pkt_mod, ledger):
    hook = mod.LedgerHook(ledger)
    out = []
    for user, pw, remote, cid in itertools.product(USERS, PASSWORDS,
                                                   REMOTES, CLIENT_IDS):
        client = SimpleNamespace(
            id=cid, remote=remote,
            properties=SimpleNamespace(username=user.encode()))
        pkt = pkt_mod.Packet(username=user.encode(), password=pw.encode())
        out.append(hook.on_connect_authenticate(client, pkt))
        if pw == "":
            out.append([hook.on_acl_check(client, t, w)
                        for t in TOPICS for w in (False, True)])
    allow = mod.AllowHook()
    out.append((allow.on_connect_authenticate(None, None),
                allow.on_acl_check(None, "t", True), allow.id, hook.id))
    return out


@pytest.mark.parametrize("source", ["dict", "json", "yaml", "file"])
def test_ledger_decisions_equal(source, tmp_path):
    import json

    loaded = []
    for mod in (hooks, ref_hooks):
        if source == "dict":
            loaded.append(mod.Ledger.from_dict(LEDGER))
        elif source == "json":
            loaded.append(mod.Ledger.from_json(json.dumps(LEDGER)))
        elif source == "yaml":
            yaml = pytest.importorskip("yaml")
            loaded.append(mod.Ledger.from_yaml(yaml.safe_dump(LEDGER)))
        else:
            path = tmp_path / "ledger.json"
            path.write_text(json.dumps(LEDGER))
            loaded.append(mod.Ledger.from_file(str(path)))
    assert loaded[0] == loaded[1] or repr(loaded[0]) == repr(loaded[1])
    got = decisions(hooks, packets, loaded[0])
    want = decisions(ref_hooks, ref_packets, loaded[1])
    assert got == want
    flat = [d for d in got if isinstance(d, bool)]
    assert any(flat) and not all(flat)


@pytest.mark.parametrize("seed", range(3))
def test_acl_filter_cover_equal(seed):
    from maxmq_tpu.hooks import auth as ref_auth
    from maxmq_tpu_torch.hooks import auth

    rng = random.Random(seed)
    segs = ["a", "b", "+", "#", ""]
    for _ in range(500):
        f = "/".join(rng.choice(segs) for _ in range(rng.randint(1, 4)))
        t = "/".join(rng.choice("ab") for _ in range(rng.randint(1, 4)))
        assert auth._filter_covers(f, t) == ref_auth._filter_covers(f, t)
        v = rng.choice(["", "a*", "ab", "*", "b"])
        assert auth._match_rule_value(v, t) == \
            ref_auth._match_rule_value(v, t)


def log_events(hook_mod, log_mod, codec_mod, pkt_mod, fmt):
    out = io.StringIO()
    log_mod.set_severity_level("trace")
    log = log_mod.Logger(out=out, fmt=fmt, prefix="mqtt", color=False)
    h, tx = hook_mod.LoggingHook(log), hook_mod.PacketTxLogHook(log)
    client = SimpleNamespace(id="c1", listener="t1", remote="1.2.3.4:5",
                             keepalive=30, inflight=[1, 2])
    anon = SimpleNamespace(id="", listener="t1", remote="r", keepalive=0,
                           inflight=[])
    pub = pkt_mod.Packet(
        fixed=codec_mod.FixedHeader(type=codec_mod.PacketType.PUBLISH,
                                    qos=1, retain=True, remaining=12),
        topic="a/b", payload=b"hello", packet_id=7)
    pub2 = pkt_mod.Packet(
        fixed=codec_mod.FixedHeader(type=codec_mod.PacketType.PUBLISH),
        topic="t/2")
    pub2._trace = SimpleNamespace(origin="n2", id=9)
    pub3 = pkt_mod.Packet(
        fixed=codec_mod.FixedHeader(type=codec_mod.PacketType.PUBLISH),
        topic="t/3")
    pub3._trace = SimpleNamespace(origin="", id=4)
    pub4 = pkt_mod.Packet(
        fixed=codec_mod.FixedHeader(type=codec_mod.PacketType.PUBLISH),
        topic="t/4")
    pub4._trace_ref = ("n5", 11)
    sub = pkt_mod.Packet(
        fixed=codec_mod.FixedHeader(type=codec_mod.PacketType.SUBSCRIBE),
        filters=[pkt_mod.Subscription(filter="a/#"),
                 pkt_mod.Subscription(filter="b/+")])
    conn = pkt_mod.Packet(
        fixed=codec_mod.FixedHeader(type=codec_mod.PacketType.CONNECT),
        protocol_version=5, clean_start=True)
    odd = pkt_mod.Packet(fixed=codec_mod.FixedHeader(type=0))
    clean = SimpleNamespace(code=SimpleNamespace(value=0))
    bad = ValueError("broken pipe")
    h.on_started()
    h.on_connect(client, conn)
    h.on_session_established(client, conn)
    for p in (pub, pub2, pub3, pub4):
        assert h.on_publish(p, client) is p
        h.on_published(client, p)
        h.on_publish_dropped(anon, p)
    assert h.on_packet_read(pub, client) is pub
    assert h.on_packet_read(odd, anon) is odd
    h.on_packet_id_exhausted(client, pub)
    h.on_subscribed(client, sub, [0, 1], [1, 1])
    h.on_unsubscribed(client, sub)
    h.on_retain_message(client, pub, 1)
    h.on_retained_expired("a/b")
    h.on_qos_publish(client, pub, 1.5, 2)
    h.on_qos_complete(client, pub)
    h.on_qos_dropped(client, pub)
    h.on_will_sent(client, pub)
    h.on_client_expired(client)
    h.on_disconnect(client, None, False)
    h.on_disconnect(client, clean, True)
    h.on_disconnect(anon, bad, False)
    h.on_stopped()
    tx.on_packet_sent(client, pub, 14)
    tx.on_packet_sent(anon, odd, 2)
    log_mod.set_severity_level("info")
    return out.getvalue(), (h.id, tx.id)


@pytest.mark.parametrize("fmt", ["json", "pretty"])
def test_logging_hooks_lines_equal(monkeypatch, fmt):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_123.5)
    got = log_events(loghooks, logger, codec, packets, fmt)
    want = log_events(ref_loghooks, ref_logger, ref_codec, ref_packets, fmt)
    assert got == want
    assert got[0].count("\n") == 33
    assert loghooks._TYPE_NAMES == ref_loghooks._TYPE_NAMES


def test_logging_hook_overrides_keep_fan_out_templates():
    """LoggingHook overrides no encode/sent event (the zero-copy fan-out
    gate); PacketTxLogHook is the one that does, as in the JAX package."""
    for mod in (loghooks, ref_loghooks):
        base = mod.Hook
        for event in ("on_packet_encode", "on_packet_sent"):
            assert getattr(mod.LoggingHook, event) is getattr(base, event)
        assert mod.PacketTxLogHook.on_packet_sent is not \
            base.on_packet_sent
