"""The port's content plane (``maxmq_tpu_torch.filtering.plane``) in the
port's broker, held against the JAX package's on the CPU:

- the broker scenarios of ``tests/test_filtering.py`` (predicate
  subscriptions rejected or admitted at SUBSCRIBE, the quota, delivery
  masking, the v5 user-property carriage, retained delivery gated by the
  predicate, window emission, a failing evaluation failing open, cleanup,
  the disabled plane, gated filters), each with the reference test's own
  assertions, on the port's broker with the NumPy evaluator and with the
  torch evaluator on the CPU;
- a differential predicate session: the JAX package's broker (NumPy
  evaluator) and the port's (NumPy, and torch on the CPU) over TCP, the
  same predicate, aggregate-free, plain and ``$share`` subscribers and
  the same JSON publishes: every subscriber receives the same frames.
"""

import json

import numpy as np
import pytest

from test_torch_broker_engine import port_module, raw_client, scenario_cases

from maxmq_tpu import bootstrap as j_boot
from maxmq_tpu.broker import Broker as JBroker
from maxmq_tpu.broker import BrokerOptions as JBrokerOptions
from maxmq_tpu.broker import TCPListener as JTCPListener
from maxmq_tpu.hooks import AllowHook as JAllowHook
from maxmq_tpu.utils import config as j_config
from maxmq_tpu_torch import bootstrap as t_boot
from maxmq_tpu_torch.broker import Broker, BrokerOptions, TCPListener
from maxmq_tpu_torch.filtering.plane import (ContentPlane, FilterSpec,
                                             USER_PROP_KEY, parse_spec)
from maxmq_tpu_torch.hooks import AllowHook
from maxmq_tpu_torch.protocol import Subscription
from maxmq_tpu_torch.utils import config as t_config

FILTERING = port_module(
    "test_filtering.py", "torch_port_filtering",
    replace=(("b = Broker(BrokerOptions(capabilities=Capabilities(**caps)))",
              "caps.setdefault('filter_backend', FILTER_BACKEND); "
              "b = Broker(BrokerOptions(capabilities=Capabilities(**caps), "
              "device='cpu'))"),))
# the bootstrap's event-loop knob and the cluster route annotations come
# with the start path and cluster mode
CASES = scenario_cases(
    FILTERING, 185, 429,
    skip=("test_install_event_loop_policies",
          "test_route_table_pred_annotations",
          "test_manager_content_gate_skips_fully_masked_peer"))


def test_every_broker_scenario_is_ported():
    assert len(CASES) == 10


def test_plane_surface_matches_the_reference():
    from maxmq_tpu.filtering import plane as j_plane

    assert USER_PROP_KEY == j_plane.USER_PROP_KEY
    for opts in ("$expr=payload.a>1", "$agg=avg&$win=2s&$field=payload.t",
                 "$agg=max&$win=1m&$field=payload.v&$expr=payload.v<9"):
        got, want = parse_spec(opts), j_plane.parse_spec(opts)
        assert isinstance(got, FilterSpec)
        assert (got.agg, got.win_s, got.field, got.source) == (
            want.agg, want.win_s, want.field, want.source)
        assert (got.pred is None) == (want.pred is None)
        if got.pred is not None:
            assert got.pred.program == want.pred.program


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("name,kwargs", CASES, ids=[n for n, _k in CASES])
async def test_filtering_scenario_on_the_port(name, kwargs, backend):
    FILTERING.FILTER_BACKEND = backend
    FILTERING.faults.clear()
    try:
        await getattr(FILTERING, name)(**kwargs)
    finally:
        FILTERING.faults.clear()


async def test_torch_backend_evaluates_in_the_broker():
    """With the torch backend on the CPU the broker's flushes run on the
    torch evaluator, with no fallback to NumPy."""
    caps = t_boot.capabilities_from_config(t_config.Config())
    caps.filter_backend, caps.sys_topic_interval = "torch", 0
    b = Broker(BrokerOptions(capabilities=caps, device="cpu"))
    assert isinstance(b.content, ContentPlane)
    ev = b.content.evaluator
    calls = []
    run = FILTERING.ColumnarEvaluator.eval_batch

    def counted(self, *a):
        calls.append(self._want_torch())
        return run(self, *a)

    ev.eval_batch = counted.__get__(ev)
    b.add_hook(AllowHook())
    lst = b.add_listener(TCPListener("t", "127.0.0.1:0"))
    await b.serve()
    try:
        port = lst._server.sockets[0].getsockname()[1]
        c = raw_client("c", 4)
        await c.open(port)
        await c.subscribe(Subscription(filter="s/t?$expr=payload.v>1"))
        p = raw_client("p", 4)
        await p.open(port)
        for v in (0, 2, 3):
            await p.publish("s/t", json.dumps({"v": v}).encode(), qos=1)
        await c.until(lambda: len(c.frames) == 2)
        assert calls and all(calls) and ev.device_fallbacks == 0
        assert b.content.masked == 1
        for x in (c, p):
            await x.close(disconnect=True)
    finally:
        await b.close()


def _script(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    subs = []
    for k in range(24):
        base = f"p/{'+' if rng.random() < 0.4 else rng.integers(0, 3)}/v"
        r = rng.random()
        if r < 0.5:
            op = rng.choice([">", "<", ">=", "<=", "==", "!="])
            expr = f"payload.t{op}{int(rng.integers(0, 100))}"
            if rng.random() < 0.3:
                expr += f"&&payload.h<{int(rng.integers(0, 100))}"
            filt = f"{base}?$expr={expr}"
        elif r < 0.75:
            filt = base
        else:
            filt = f"$share/g{k % 2}/{base}"
        subs.append((f"s{k:02d}", 5 if k % 3 == 0 else 4, filt,
                     int(rng.integers(0, 3))))
    pubs = []
    for _ in range(200):
        body = {"t": float(rng.integers(0, 100))}
        if rng.random() < 0.7:
            body["h"] = float(rng.integers(0, 100))
        if rng.random() < 0.05:
            body = "not-json"
        payload = (json.dumps(body) if body != "not-json"
                   else "{not json").encode()
        pubs.append((f"p/{rng.integers(0, 3)}/v", payload,
                     int(rng.integers(0, 3))))
    return {"subs": subs, "pubs": pubs}


async def _predicate_session(kind: str, backend: str, seed: int,
                             matcher: str = "trie") -> dict:
    if kind == "jax":
        conf, boot = j_config.Config(), j_boot
        b_cls, o_cls, l_cls, allow, kw = (JBroker, JBrokerOptions,
                                          JTCPListener, JAllowHook, {})
    else:
        conf, boot = t_config.Config(), t_boot
        b_cls, o_cls, l_cls, allow, kw = (Broker, BrokerOptions,
                                          TCPListener, AllowHook,
                                          {"device": "cpu"})
    conf.mqtt_sys_topic_interval = 0
    conf.filter_backend = backend
    conf.matcher = matcher
    conf.matcher_deadline_ms = 5_000   # the CPU is shared with other tests
    b = b_cls(o_cls(capabilities=boot.capabilities_from_config(conf), **kw))
    b.add_hook(allow())
    boot.build_matcher(conf, b, **kw)
    if b.matcher is not None:
        # every publish through the pipeline's content flushes and the
        # engine
        b.matcher.inner.cpu_bypass = False
        b.matcher.engine.route_small = False
    lst = b.add_listener(l_cls("f", "127.0.0.1:0"))
    await b.serve()
    port = lst._server.sockets[0].getsockname()[1]
    script = _script(seed)
    conns = []
    try:
        for cid, version, filt, qos in script["subs"]:
            c = raw_client(cid, version)
            await c.open(port)
            await c.subscribe(Subscription(filter=filt, qos=qos))
            await c.subscribe(Subscription(filter="fence"))
            conns.append(c)
        pub = raw_client("pub", 5)
        await pub.open(port)
        for topic, payload, qos in script["pubs"]:
            await pub.publish(topic, payload, qos)
        await pub.publish("fence", b"end")
        for c in conns:
            await c.until(lambda c=c: c.frames and c.frames[-1].endswith(b"end")
                          and not c.awaiting_rel)
        out = {c.cid: (c.frames, c.rel, c.ctl) for c in conns}
        out["_masked"] = b.content.masked
        out["_fallbacks"] = b.content.device_fallbacks
        for c in (*conns, pub):
            await c.close(disconnect=True)
        return out
    finally:
        await b.close()
        if b.matcher is not None:
            await b.matcher.close()


@pytest.mark.parametrize("matcher", ["trie", "sig"])
@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("seed", [1, 2])
async def test_differential_predicate_session(seed, backend, matcher):
    """Predicate, plain and ``$share`` subscribers (v3.1.1 and v5, QoS
    0-2) and 200 JSON publishes (some fields missing, some payloads not
    JSON): the port's broker with the NumPy or the torch evaluator, on
    its trie or with the ``sig`` matcher on the CPU (content flushes in
    the publish pipeline), delivers exactly the JAX package's broker's
    frames (NumPy evaluator, trie), and masks as many deliveries."""
    want = await _predicate_session("jax", "numpy", seed)
    got = await _predicate_session("torch", backend, seed, matcher)
    assert got.pop("_fallbacks") == 0
    want.pop("_fallbacks")
    assert want["_masked"] > 50
    assert got == want
