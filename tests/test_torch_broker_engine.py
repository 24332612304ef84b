"""The port's broker engine (``maxmq_tpu_torch.broker.server``) and its
matcher boot (``maxmq_tpu_torch.bootstrap``) held against the JAX
package's, on the CPU, with exact equality:

- every golden transcript session of ``tests/test_golden_transcripts.py``
  (hand-assembled request and response bytes) against the port's broker;
- the scenarios of ``tests/test_broker_system.py`` and
  ``tests/test_broker_fixes.py``, each with the reference test's own
  assertions, against the port's broker (``port_module`` loads the
  reference test file with the port's package in place of the JAX
  package's, engines on the CPU);
- the boot warm-up: a broker holding a corpus before ``serve()`` has its
  engine's tables compiled and its decode bases prewarmed before its
  listener accepts;
- ``capabilities_from_config`` field for field, and ``build_matcher``'s
  stack of classes for every branch, against the JAX package's; without a
  device and without CUDA it raises;
- differential sessions over TCP: a numpy-seeded script of 36 raw clients
  (v3.1, v3.1.1 and v5; wildcards, ``$share``, no_local,
  retain-as-published, identifiers; QoS 0/1/2 with DUP re-sends, inbound
  aliases, retained set and clear; a delayed will, a session resumed
  with its offline queue and unacknowledged deliveries, unsubscribe,
  takeover) through the JAX package's broker and the port's, the port's
  with its trie, the ``sig`` matcher and the ``nfa`` matcher on the CPU:
  each client receives the same frames.
"""

import asyncio
import dataclasses
import re
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import test_golden_transcripts as gold
from maxmq_tpu import bootstrap as j_boot
from maxmq_tpu.broker import Broker as JBroker
from maxmq_tpu.broker import BrokerOptions as JBrokerOptions
from maxmq_tpu.broker import TCPListener as JTCPListener
from maxmq_tpu.hooks import AllowHook as JAllowHook
from maxmq_tpu.utils import config as j_config
from maxmq_tpu_torch import bootstrap as t_boot
from maxmq_tpu_torch import faults as t_faults
from maxmq_tpu_torch.broker import (Broker, BrokerOptions, Capabilities,
                                    TCPListener)
from maxmq_tpu_torch.hooks import AllowHook
from maxmq_tpu_torch.matching.supervisor import SupervisedMatcher
from maxmq_tpu_torch.protocol import Subscription
from maxmq_tpu_torch.protocol.packets import Will
from maxmq_tpu_torch.utils import config as t_config

TESTS = Path(__file__).resolve().parent


def port_module(filename: str, name: str, replace=()):
    """The reference test file ``filename`` loaded as module ``name`` with
    the port's package in place of the JAX package's (``maxmq_tpu`` ->
    ``maxmq_tpu_torch``), its signature and NFA engines on the CPU (the
    port's entry points take the card unless told otherwise) and the
    further literal ``replace`` pairs. Line numbers stay the file's, so a
    failure points at the reference test's own assertion."""
    src = (TESTS / filename).read_text()
    src = re.sub(r"\bmaxmq_tpu\b", "maxmq_tpu_torch", src)
    src = re.sub(r"\b(SigEngine|NFAEngine)\(([^()]*)\)",
                 r'\1(\2, device="cpu")', src)
    for a, b in replace:
        assert a in src and a.count("\n") == b.count("\n"), a
        src = src.replace(a, b)
    mod = types.ModuleType(name)
    mod.__file__ = str(TESTS / filename)
    sys.modules[name] = mod
    exec(compile(src, str(TESTS / filename), "exec"), mod.__dict__)
    return mod


def scenario_cases(mod, first: int, last: int, skip=()) -> list:
    """(test name, kwargs) for every test function of ``mod`` defined on
    lines ``first``..``last`` of its file, one case per parameter set of a
    ``pytest.mark.parametrize``d test."""
    cases = []
    for name, fn in vars(mod).items():
        if not name.startswith("test_") or name in skip \
                or not isinstance(fn, types.FunctionType):
            continue
        line = fn.__code__.co_firstlineno
        if not first <= line <= last:
            continue
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            cases.append((name, {}))
        for m in marks:
            argname, values = m.args
            cases.extend((name, {argname: v}) for v in values)
    return sorted(cases, key=lambda c: (
        vars(mod)[c[0]].__code__.co_firstlineno, repr(c[1])))


async def run_scenario(fn, kwargs: dict, tmp_path) -> None:
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        kwargs = dict(kwargs, tmp_path=tmp_path)
    out = fn(**kwargs)
    if asyncio.iscoroutine(out):
        await out


# -- golden transcripts ------------------------------------------------------

GOLDEN = sorted((n for n, f in vars(gold).items()
                 if n.startswith("test_") and callable(f)),
                key=lambda n: vars(gold)[n].__code__.co_firstlineno)


def test_every_golden_session_is_ported():
    assert len(GOLDEN) == 10


@pytest.mark.parametrize("name", GOLDEN)
async def test_golden_transcript_on_the_port(name, monkeypatch):
    """The reference's hand-assembled request bytes into the port's
    broker, its hand-derived response bytes out, byte for byte."""
    for attr, cls in (("Broker", Broker), ("BrokerOptions", BrokerOptions),
                      ("Capabilities", Capabilities),
                      ("TCPListener", TCPListener), ("AllowHook", AllowHook)):
        monkeypatch.setattr(gold, attr, cls)
    await getattr(gold, name)()


# -- the reference's broker scenarios ----------------------------------------

SYSTEM = port_module("test_broker_system.py", "torch_port_broker_system")
FIXES = port_module(
    "test_broker_fixes.py", "torch_port_broker_fixes",
    replace=(("from test_broker_system import running_broker",
              "from torch_port_broker_system import running_broker"),))
SYSTEM_CASES = scenario_cases(SYSTEM, 39, 394)
FIXES_CASES = scenario_cases(FIXES, 27, 365)


def test_every_scenario_is_ported():
    assert len(SYSTEM_CASES) == 27 and len(FIXES_CASES) == 13


@pytest.mark.parametrize("name,kwargs", SYSTEM_CASES,
                         ids=[n + "".join(f"[{v}]" for v in k.values())
                              for n, k in SYSTEM_CASES])
async def test_broker_system_scenario_on_the_port(name, kwargs, tmp_path):
    await run_scenario(getattr(SYSTEM, name), kwargs, tmp_path)


@pytest.mark.parametrize("name,kwargs", FIXES_CASES,
                         ids=[n for n, _k in FIXES_CASES])
async def test_broker_fixes_scenario_on_the_port(name, kwargs, tmp_path):
    await run_scenario(getattr(FIXES, name), kwargs, tmp_path)


# -- the boot warm-up ---------------------------------------------------------

async def test_boot_compiles_and_prewarms_before_the_listener_accepts():
    """A broker holding 10,000 subscriptions (one fat '#' row) before
    ``serve()``, its matcher from ``build_matcher``: when the listener
    starts accepting, the engine's tables are at the index's version and
    ``serve()``'s boot compile has run the decode prewarm, whose anchors
    hold the fat row's entries — before any publish."""
    from maxmq_tpu_torch import native

    conf = t_config.Config()
    conf.mqtt_sys_topic_interval = 0
    b = Broker(BrokerOptions(
        capabilities=t_boot.capabilities_from_config(conf)))
    b.add_hook(AllowHook())
    for i in range(200):
        b.topics.subscribe(f"fat{i}", Subscription(filter="pw/dev/#", qos=1))
    for i in range(9800):
        b.topics.subscribe(f"c{i}", Subscription(filter=f"pw/{i}/x"))
    t_boot.build_matcher(conf, b, device="cpu")
    engine = b.matcher.engine
    calls, at_accept = [], {}
    prewarm = engine.prewarm_decode_bases

    def counted(*a, **k):
        calls.append(prewarm(*a, **k))
        return calls[-1]

    engine.prewarm_decode_bases = counted
    serve_all = b.listeners.serve_all

    async def accept(handler):
        at_accept.update(version=engine.tables.version,
                         sub_version=b.topics.sub_version,
                         prewarms=len(calls), dispatched=engine.matches)
        await serve_all(handler)

    b.listeners.serve_all = accept
    b.add_listener(TCPListener("t", "127.0.0.1:0"))
    await b.serve()
    try:
        assert at_accept["version"] == at_accept["sub_version"]
        assert at_accept["prewarms"] == 1 and calls[0] > 0
        assert at_accept["dispatched"] == 0
        mod = native.decode_module()
        if mod is not None and hasattr(mod, "_slot_map_stats"):
            nd = engine.tables.__dict__.get("_native_decode")
            assert nd, "native decode never engaged for the prewarm"
            rows_mapped, entries = mod._slot_map_stats(nd[1])
            assert rows_mapped >= 1 and entries >= 200
    finally:
        await b.close()
        await b.matcher.close()


async def test_boot_compile_failure_warns_and_serves_from_the_trie():
    """The reference's warn-and-continue: a failing boot compile logs a
    warning, the broker still serves, and the publish is answered."""
    import io

    from maxmq_tpu_torch.mqtt_client import MQTTClient
    from maxmq_tpu_torch.utils.logger import Logger

    buf = io.StringIO()
    conf = t_config.Config()
    conf.mqtt_sys_topic_interval = 0
    b = Broker(BrokerOptions(
        capabilities=t_boot.capabilities_from_config(conf),
        logger=Logger(out=buf, fmt="json")))
    b.add_hook(AllowHook())
    t_boot.build_matcher(conf, b, device="cpu")
    b.matcher.engine.close()       # its bucket warm-up has finished
    for i in range(300):
        b.topics.subscribe(f"c{i}", Subscription(filter=f"w/{i}"))
    t_faults.clear()
    t_faults.arm(t_faults.DEVICE_RECOMPILE, "raise", count=1)
    lst = b.add_listener(TCPListener("t", "127.0.0.1:0"))
    try:
        await b.serve()
        assert "boot-time matcher compile failed" in buf.getvalue()
        port = lst._server.sockets[0].getsockname()[1]
        c = MQTTClient(client_id="x")
        await c.connect("127.0.0.1", port)
        await c.subscribe("w/7")
        await c.publish("w/7", b"hi")
        assert (await c.next_message(timeout=10)).payload == b"hi"
        await c.disconnect()
    finally:
        t_faults.clear()
        await b.close()
        await b.matcher.close()


# -- capabilities_from_config and build_matcher -------------------------------

def _full_conf(mod):
    """A config of package ``mod`` that sets every key the mapping reads
    to a value other than its default."""
    conf = mod.Config()
    for f in dataclasses.fields(conf):
        v = getattr(conf, f.name)
        if isinstance(v, bool):
            setattr(conf, f.name, not v)
        elif isinstance(v, int):
            setattr(conf, f.name, v + 7)
        elif isinstance(v, float):
            setattr(conf, f.name, v + 0.25)
    conf.filter_backend = "auto"
    return conf


@pytest.mark.parametrize("which", ["default", "every key set"])
def test_capabilities_from_config_equal_field_for_field(which):
    confs = ((j_config.Config(), t_config.Config()) if which == "default"
             else (_full_conf(j_config), _full_conf(t_config)))
    want = dataclasses.asdict(j_boot.capabilities_from_config(confs[0]))
    got = dataclasses.asdict(t_boot.capabilities_from_config(confs[1]))
    assert got == want
    assert got != dataclasses.asdict(Capabilities())


def test_capabilities_map_the_reference_jnp_backend_to_torch(tmp_path):
    path = tmp_path / "m.toml"
    path.write_text('filter_backend = "jnp"\n')
    conf = t_config.load_config(str(path), env={})
    assert t_boot.capabilities_from_config(conf).filter_backend == "torch"


def _stack(matcher) -> list[str]:
    """Class names from the attached matcher down to the engine."""
    names = []
    while matcher is not None:
        names.append(type(matcher).__name__)
        matcher = (matcher.__dict__.get("inner")
                   or matcher.__dict__.get("engine"))
    return names


def _both(conf_edit, device="cpu"):
    out = []
    for boot, cfg, broker_cls, opts, kw in (
            (j_boot, j_config, JBroker, JBrokerOptions, {}),
            (t_boot, t_config, Broker, BrokerOptions,
             {} if device is None else {"device": device})):
        conf = cfg.Config()
        conf_edit(conf)
        b = broker_cls(opts())
        for i in range(20):
            b.topics.subscribe(f"c{i}", _sub(boot, i))
        out.append((boot.build_matcher(conf, b, **kw), b, conf))
    return out


def _sub(boot, i):
    if boot is j_boot:
        from maxmq_tpu.protocol import Subscription as JSub
        return JSub(filter=f"a/{i}/+")
    return Subscription(filter=f"a/{i}/+")


@pytest.mark.parametrize("matcher,mesh,supervised", [
    ("sig", "", True), ("nfa", "", True), ("dense", "", True),
    ("sig", "", False), ("sig", "1x2", True), ("nfa", "2x1", True)])
def test_build_matcher_stacks_the_reference_classes(matcher, mesh,
                                                    supervised):
    """Each branch builds the reference's stack (supervisor, batcher,
    engine) with the same settings; the supervisor gets
    ``supervisor_kwargs(conf)``; the batcher carries the broker's
    tracer; the engine holds the broker's index."""
    def edit(conf):
        conf.matcher, conf.matcher_mesh = matcher, mesh
        conf.matcher_supervised = supervised
        conf.matcher_deadline_ms = 321
        conf.matcher_max_batch = 128
        conf.matcher_batch_window_us = 150

    (j_att, j_b, j_conf), (t_att, t_b, t_conf) = _both(edit)
    try:
        assert _stack(t_att) == _stack(j_att)
        assert t_b.matcher is t_att and j_b.matcher is j_att
        assert t_boot.supervisor_kwargs(t_conf) == \
            j_boot.supervisor_kwargs(j_conf)
        batcher = t_att.inner if supervised else t_att
        assert (batcher.window_us, batcher.max_batch) == (150, 128)
        assert batcher.tracer is t_b.tracer
        assert batcher.engine.index is t_b.topics
        if supervised:
            assert isinstance(t_att, SupervisedMatcher)
            assert t_att.deadline_ms == j_att.deadline_ms == 321.0
            for k, v in t_boot.supervisor_kwargs(t_conf).items():
                assert getattr(t_att, k) == v, k
        got = batcher.engine.subscribers("a/3/z")
        if hasattr(got, "to_set"):
            got = got.to_set()
        assert got.subscriptions.keys() == {"c3"}
    finally:
        for att in (j_att, t_att):
            eng = att.engine
            close = getattr(eng, "close", None)
            if close is not None:
                close()


def test_build_matcher_trie_and_service_attach_nothing():
    for matcher in ("", "trie", "service"):
        conf = t_config.Config()
        conf.matcher = matcher
        b = Broker()
        assert t_boot.build_matcher(conf, b) is None and b.matcher is None
    conf = t_config.Config()
    conf.matcher = "bogus"
    with pytest.raises(ValueError, match="unknown matcher"):
        t_boot.build_matcher(conf, Broker(), device="cpu")


def test_build_matcher_without_cuda_raises(monkeypatch):
    """No device and no CUDA: the engine's ``resolve_device`` error, never
    a quiet CPU engine."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for matcher, mesh in (("sig", ""), ("nfa", ""), ("dense", ""),
                          ("sig", "1x2")):
        conf = t_config.Config()
        conf.matcher, conf.matcher_mesh = matcher, mesh
        b = Broker()
        with pytest.raises(RuntimeError, match="CUDA"):
            t_boot.build_matcher(conf, b)
        assert b.matcher is None


def test_content_plane_device_follows_the_broker_options():
    conf = t_config.Config()
    conf.filter_backend = "torch"
    caps = t_boot.capabilities_from_config(conf)
    cpu = Broker(BrokerOptions(capabilities=caps, device="cpu"))
    assert cpu.content.evaluator.device == torch.device("cpu")
    card = Broker(BrokerOptions(capabilities=caps))
    assert card.content.evaluator.device.type == "cuda"


# -- differential sessions over TCP ------------------------------------------

def raw_client(cid, version, **opts):
    """A raw connection of a scripted session (``chip_smoke.WireClient``
    over the port's codec), waiting at most 20 s for any reply."""
    return chip_smoke.WireClient(chip_smoke.port_kit(), cid, version,
                                 timeout=20, **opts)


LEVELS = ("a", "b", "c")


def session_script(seed: int) -> dict:
    """The clients and steps of one session, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def topic():
        return "/".join(rng.choice(LEVELS)
                        for _ in range(int(rng.integers(1, 4))))

    def filt():
        levels = topic().split("/")
        for i in range(len(levels)):
            if rng.random() < 0.3:
                levels[i] = "+"
        if rng.random() < 0.25:
            levels = levels[:int(rng.integers(0, len(levels)))] + ["#"]
        return "/".join(levels)

    clients = []
    for k in range(36):
        version = int(rng.choice([3, 4, 5], p=[0.15, 0.35, 0.5]))
        opts = {}
        if version == 5:
            # one retain-as-published flag a client: a record merged from
            # several filters keeps one filter's flag, and the decodes
            # union in orders of their own (F7)
            opts = {"retain_as_published": bool(rng.random() < 0.3)}
        subs = []
        for _ in range(int(rng.integers(1, 4))):
            s = dict(filter=filt(), qos=int(rng.integers(0, 3)), **opts)
            if version == 5:
                s["no_local"] = bool(rng.random() < 0.2)
                if rng.random() < 0.5:
                    s["identifier"] = int(rng.integers(1, 1000))
            subs.append(s)
        if k >= 30:
            subs.append(dict(filter=f"$share/g{k % 2}/{filt()}",
                             qos=int(rng.integers(0, 3))))
        clients.append(dict(cid=f"d{k:02d}", version=version, subs=subs,
                            alias_max=8 if version == 5 and k % 4 == 0
                            else 0))
    steps = []
    for i in range(70):
        k = int(rng.integers(0, 36))
        r = rng.random()
        if r < 0.06:
            steps.append(("subscribe", k, dict(filter=filt(),
                                               qos=int(rng.integers(0, 3)))))
        elif r < 0.1:
            steps.append(("unsubscribe", k))
        else:
            qos = int(rng.choice(3, p=[0.5, 0.3, 0.2]))
            retain = bool(rng.random() < 0.06)
            payload = (b"" if retain and rng.random() < 0.3
                       else rng.bytes(int(rng.integers(1, 40))))
            steps.append(("publish", k, topic(), payload, qos, retain,
                          bool(rng.random() < 0.3),
                          bool(qos and rng.random() < 0.2)))
    return {"clients": clients, "steps": steps}


async def run_session(kind: str, mode: str, seed: int) -> dict:
    """One scripted session through a broker of ``kind`` ("jax" or
    "torch") with matcher ``mode``; returns each connection's lanes."""
    if kind == "jax":
        conf = j_config.Config()
        b_cls, opts_cls, lst_cls, allow, boot = (
            JBroker, JBrokerOptions, JTCPListener, JAllowHook, j_boot)
        kw = {}
    else:
        conf = t_config.Config()
        b_cls, opts_cls, lst_cls, allow, boot = (
            Broker, BrokerOptions, TCPListener, AllowHook, t_boot)
        kw = {"device": "cpu"}
    conf.mqtt_sys_topic_interval = 0
    conf.matcher = mode
    conf.matcher_deadline_ms = 5_000   # the CPU is shared with other tests
    b = b_cls(opts_cls(capabilities=boot.capabilities_from_config(conf)))
    b.add_hook(allow())
    boot.build_matcher(conf, b, **kw)
    if b.matcher is not None:
        b.matcher.inner.cpu_bypass = False    # every batch to the engine
        b.matcher.engine.route_small = False
    lst = b.add_listener(lst_cls("d", "127.0.0.1:0"))
    await b.serve()
    port = lst._server.sockets[0].getsockname()[1]
    script = session_script(seed)
    conns: dict = {}
    live: dict = {}
    fence = [0]

    async def connect(name, cid, version, **opts):
        c = conns[name] = raw_client(cid, version, **opts)
        await c.open(port)
        live[cid] = c
        await c.subscribe(Subscription(filter="sync"))
        return c

    sync = await connect("sync", "zz-sync", 4)

    async def settle():
        """A fence through the sync client after the step's own packets
        were read: every live connection holds it before the next step."""
        fence[0] += 1
        body = b"fence-%d" % fence[0]
        await sync.publish("sync", body)
        for c in list(live.values()):
            await c.until(lambda c=c: any(f.endswith(body)
                                          for f in c.frames[-3:]))

    async def gone(cid):
        """The broker has detached ``cid``'s connection."""
        for _ in range(400):
            cl = b.clients.get(cid)
            if cl is None or cl.closed:
                return
            await asyncio.sleep(0.01)
        raise AssertionError(f"{cid} still attached")

    for spec in script["clients"]:
        c = await connect(spec["cid"], spec["cid"], spec["version"],
                          alias_max=spec["alias_max"])
        for s in spec["subs"]:
            await c.subscribe(Subscription(**s))
    recv = await connect("recv", "zz-recv", 5)
    for f in ("will/#", "m/#", "ret/#"):
        await recv.subscribe(Subscription(filter=f, qos=1))
    # sessions: M (v5) goes mute and drops with unacknowledged QoS 1/2
    # deliveries; Q (v3.1.1) leaves cleanly with its session kept
    m = await connect("m#1", "zz-m", 5, clean=False, expiry=3600)
    await m.subscribe(Subscription(filter="m/#", qos=1, identifier=7))
    await m.subscribe(Subscription(filter="m/q2", qos=2))
    q = await connect("q#1", "zz-q", 4, clean=False)
    await q.subscribe(Subscription(filter="a/#", qos=2))
    await q.subscribe(Subscription(filter="m/#", qos=1))
    t1 = await connect("t#1", "zz-t", 5, clean=False, expiry=3600)
    await t1.subscribe(Subscription(filter="b/+", qos=1))
    await settle()
    clients = [spec["cid"] for spec in script["clients"]]
    for i, step in enumerate(script["steps"]):
        if i == 12:
            m.mute = True
            await recv.publish("m/x", b"one", qos=1)
            await recv.publish("m/q2", b"two", qos=2)
            await settle()
            del live["zz-m"]
            await m.close()
            await gone("zz-m")
            await recv.publish("m/y", b"three", qos=1)
            await recv.publish("m/q2", b"four", qos=2)
        elif i == 20:
            del live["zz-q"]
            await q.until(lambda: not q.awaiting_rel)
            await q.close(disconnect=True)
            await gone("zz-q")
        elif i == 28:
            will = Will(topic="will/w5", payload=b"gone5", qos=1)
            will.properties.will_delay = 1
            w = await connect("w5", "zz-w5", 5, will=will, expiry=30)
            w4 = await connect("w4", "zz-w4", 4, will=Will(
                topic="will/w4", payload=b"gone4", qos=2, retain=True))
            await settle()
            for cid, c in (("zz-w4", w4), ("zz-w5", w)):
                del live[cid]
                await c.close()
                await gone(cid)
                await recv.until(lambda cid=cid: any(
                    f.endswith(b"gone" + cid[-1:].encode())
                    for f in recv.frames))
        elif i == 36:
            for topic, payload in (("ret/a", b"ra"), ("ret/b", b"rb"),
                                   ("ret/b", b"")):
                await recv.publish(topic, payload, qos=1, retain=True)
            await settle()
            n = await connect("n", "zz-n", 5)
            await n.subscribe(Subscription(filter="ret/#", qos=2,
                                           retain_as_published=True,
                                           identifier=3))
        elif i == 44:
            t2 = await connect("t#2", "zz-t", 5, clean=False, expiry=3600)
            await t1.closed.wait()
            await recv.publish("b/c", b"after-takeover", qos=1)
            del t2
        elif i == 56:
            m2 = await connect("m#2", "zz-m", 5, clean=False, expiry=3600)
            q2 = await connect("q#2", "zz-q", 4, clean=False)
            for c in (m2, q2):
                await c.ping()
        kind_ = step[0]
        c = live.get(clients[step[1]])
        if c is None:
            continue
        if kind_ == "subscribe":
            await c.subscribe(Subscription(**step[2]))
        elif kind_ == "unsubscribe":
            spec = script["clients"][step[1]]
            await c.unsubscribe(spec["subs"][0]["filter"])
        else:
            _k, _c, topic, payload, qos, retain, alias, dup = step
            await c.publish(topic, payload, qos, retain, alias, dup)
        await settle()
    for c in live.values():                 # the last QoS 2 flows close
        await c.until(lambda c=c: not c.awaiting_rel)
    out = {name: (c.frames, c.rel, c.ctl) for name, c in conns.items()}
    out["_engine_matches"] = (b.matcher.engine.matches
                              if b.matcher is not None else None)
    if b.matcher is not None:
        out["_hedges"] = {k: v for k, v in
                          b.matcher.fallbacks_by_reason.items()
                          if k != "overflow" and v}
    for c in list(live.values()):
        await c.close(disconnect=True)
    await b.close()
    if b.matcher is not None:
        await b.matcher.close()
    return out


_JAX_SESSIONS: dict = {}

SEEDS = (11, 12, 13)


@pytest.mark.parametrize("mode", ["trie", "sig", "nfa"])
@pytest.mark.parametrize("seed", SEEDS)
async def test_differential_session_over_tcp(seed, mode):
    """The same scripted session through the JAX package's broker (its
    trie: the reference) and the port's broker with ``mode``: every
    connection receives the same frames, in order, per lane."""
    if seed not in _JAX_SESSIONS:
        _JAX_SESSIONS[seed] = await run_session("jax", "trie", seed)
    want = _JAX_SESSIONS[seed]
    got = await run_session("torch", mode, seed)
    if mode != "trie":
        assert got.pop("_engine_matches") > 50
        assert got.pop("_hedges") == {}
    else:
        got.pop("_engine_matches")
    want = {k: v for k, v in want.items() if not k.startswith("_")}
    assert len(want) >= 32 + 8
    assert sum(len(lanes[0]) for lanes in want.values()) > 500
    for name in sorted(want):
        assert got[name] == want[name], name
    assert got.keys() == want.keys()


test_differential_session_over_tcp._async_timeout = 120


def test_engine_fault_sites_equal_the_reference():
    """The sites the engine and the plane fire, and the directed-link
    keys and shape table its cluster inbound path reads, as the JAX
    package names and keeps them."""
    from maxmq_tpu import faults as j_faults

    for site in ("LISTENER_ACCEPT", "CLUSTER_PARTITION", "CLUSTER_SHAPE",
                 "FILTER_EVAL", "FILTER_WINDOW"):
        assert getattr(t_faults, site) == getattr(j_faults, site), site
    assert t_faults.partition_key("a", "b") == j_faults.partition_key(
        "a", "b")
    reg = t_faults.FaultRegistry()
    assert reg.get_shape("a->b") is None
    marker = object()
    reg.set_shape("a->b", marker)
    assert reg.get_shape("a->b") is marker and reg.get_shape("b->a") is None
    reg.count_fired("cluster.shape#a->b")
    assert reg.fired == {"cluster.shape#a->b": 1}
    reg.clear()
    assert reg.get_shape("a->b") is None and not reg.fired


async def test_listener_accept_fault_refuses_the_connection():
    """An armed ``listener.accept`` raise refuses one socket before any
    handshake (counted in ``connects_refused``); the next connects."""
    from maxmq_tpu_torch.mqtt_client import MQTTClient

    b = Broker(BrokerOptions(capabilities=Capabilities(
        sys_topic_interval=0)))
    b.add_hook(AllowHook())
    lst = b.add_listener(TCPListener("t", "127.0.0.1:0"))
    await b.serve()
    t_faults.clear()
    try:
        port = lst._server.sockets[0].getsockname()[1]
        t_faults.arm(t_faults.LISTENER_ACCEPT, "raise", count=1)
        c = raw_client("r", 4)
        with pytest.raises((ConnectionError, asyncio.TimeoutError)):
            await c.open(port)
        assert b.overload.connects_refused == 1
        ok = MQTTClient(client_id="ok")
        await ok.connect("127.0.0.1", port)
        await ok.disconnect()
    finally:
        t_faults.clear()
        await b.close()


# -- repairs found on the card: the stall clock and the consumer's yield -----

def _sink_session(bk, kit, broker, cid):
    side = chip_smoke.BrokerSide(broker, 0)
    chip_smoke.connect_fleet(bk, kit, side, [(cid, [])])
    return side.fleet[cid]


async def test_stall_clock_starts_at_the_writers_wake_up():
    """A writer idle past the stall deadline whose first queued item was
    put while the loop was held (the writer not yet run) is waiting for the
    loop, not stalled: the port keeps it. The JAX package's broker measures
    from the last flush and reaps it (F13). A writer that makes no progress
    past the deadline after its wake-up is reaped by both."""
    from maxmq_tpu.broker import Client as JClient
    from maxmq_tpu.protocol import codec as j_codec
    from maxmq_tpu.protocol import packets as j_packets

    j_bk = types.SimpleNamespace(Client=JClient)
    j_kit = types.SimpleNamespace(Packet=j_packets.Packet,
                                  FixedHeader=j_codec.FixedHeader,
                                  PT=j_codec.PacketType)
    kits = {"torch": (chip_smoke.broker_kit(), chip_smoke.port_kit(),
                      Broker, BrokerOptions, Capabilities),
            "jax": (j_bk, j_kit, JBroker, JBrokerOptions,
                    type(JBroker().capabilities))}
    reaped = {}
    for name, (bk, kit, b_cls, o_cls, c_cls) in kits.items():
        b = b_cls(o_cls(capabilities=c_cls(sys_topic_interval=0,
                                           stall_deadline_ms=100)))
        await b.serve()
        client, sink = _sink_session(bk, kit, b, "idle")
        await asyncio.sleep(0)                  # the writer parks in get()
        mono = time.monotonic()
        client.write_progress = mono - 1.0      # idle for a second
        client.outbound.put_nowait(b"\x30\x03\x00\x01a", 5)
        b._check_stalled_writers(time.monotonic())
        reaped[name] = b.overload.stalled_disconnects
        if name == "torch":
            await asyncio.sleep(0.01)           # the writer serves it
            assert bytes(sink.data) == b"\x30\x03\x00\x01a"
            client.outbound.put_nowait(b"\x30\x03\x00\x01b", 5)
            client.outbound.woken = client.write_progress = mono - 1.0
            b._check_stalled_writers(time.monotonic())
            assert b.overload.stalled_disconnects == 1
        await b.close()
    assert reaped == {"torch": 0, "jax": 1}


@pytest.mark.parametrize("content", [False, True])
@pytest.mark.parametrize("yield_s", [0.0, float("inf")])
async def test_pipeline_consumer_yields_to_the_loop(yield_s, content):
    """Publishes whose matches settled together fan out without an await
    between them; past ``PUB_YIELD_S`` on the loop the consumer yields
    between two of them (0: after each; inf: never, as the JAX package's
    consumer), and arrival order holds either way: on the single-item
    path and in a content-plane flush (a predicate subscription)."""
    conf = chip_smoke.broker_config(chip_smoke.broker_kit(), "sig")
    conf.matcher_deadline_ms = 5_000   # the CPU is shared with other tests
    b = Broker(BrokerOptions(
        capabilities=t_boot.capabilities_from_config(conf)))
    b.PUB_YIELD_S = yield_s
    b.add_hook(AllowHook())
    t_boot.build_matcher(conf, b, device="cpu")
    b.matcher.inner.cpu_bypass = False
    lst = b.add_listener(TCPListener("y", "127.0.0.1:0"))
    await b.serve()
    port = lst._server.sockets[0].getsockname()[1]
    ticks, seen = [0], []
    deliver = b._pub_deliver

    def noted(subscribers, client, packet, durable_ack):
        seen.append((packet.topic, ticks[0]))
        return deliver(subscribers, client, packet, durable_ack)

    async def tick():
        while True:
            ticks[0] += 1
            await asyncio.sleep(0)

    b._pub_deliver = noted
    ticker = asyncio.get_running_loop().create_task(tick())
    sub, pub = raw_client("s", 4), raw_client("p", 4)
    try:
        await sub.open(port)
        await sub.subscribe(Subscription(
            filter="y/#?$expr=payload.v>0" if content else "y/#"))
        await pub.open(port)
        kit = chip_smoke.port_kit()
        topics = [f"y/{i}" for i in range(64)]
        pub.send([pub.packet(kit.PT.PUBLISH, topic=t,
                             payload=b'{"v": 1}').encode() for t in topics])
        await sub.until(lambda: len(sub.frames) == len(topics))
        active = b.content.active
    finally:
        ticker.cancel()
        for c in (sub, pub):
            await c.close(disconnect=True)
        await b.close()
        await b.matcher.close()
    assert [t for t, _ in seen] == topics
    assert active == content
    runs = len({k for _, k in seen})
    if yield_s == 0:
        assert runs == len(topics)
    else:
        assert runs < len(topics) // 4
