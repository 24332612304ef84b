"""The port's start path (``bootstrap.py``'s ``build_storage``,
``build_broker``, ``build_metrics``, ``run_server``; CLI ``start``), its
metrics registrations over a broker, and the matcher service's broker half,
held against the JAX package's on the CPU:

- ``build_broker``'s wiring (hooks by class, the storage chain and its
  settings, listeners, capabilities, the matcher stack) equal to the JAX
  package's for the same ``Config``, including ``log_level = "trace"``, an
  ``auth_ledger`` and each storage backend and policy;
- ``run_server`` in process, as ``tests/test_bootstrap.py`` runs the JAX
  package's (its two start-path sessions loaded with the port's package);
- durable acknowledgements: one raw-TCP transcript with ``storage_sync =
  "always"`` through both packages' brokers: every client's frames equal,
  and the two SQLite stores equal record for record after a graceful stop;
- the ``/metrics`` exposition of both brokers after that traffic: the same
  series, labels and deterministic values;
- ``matcher = "service"``: a port broker on the port's matcher service
  against a JAX broker on the JAX service, frames equal;
- ``python -m maxmq_tpu_torch start`` as a child process: a CPU broker
  that answers and exits 0 on SIGTERM, the refusal without CUDA and
  without ``--device cpu``, a cluster node, and a worker pool
  (``workers = 2``: two worker processes on one port, a publish across
  the worker mesh, a worker killed by a ``pool.worker`` fault respawned);
- the reference's SIGKILL drills (``tests/test_storage_recovery.py``) on a
  child process of the port;
- the port's repairs of faults found in the reference on the card (each
  shown against the reference): a restored inflight message resent at the
  session's protocol version, the dispatch buckets warmed again at a boot
  that restores its corpus, the housekeeping sweeps skipped while nothing
  can be due and sliced past ``SWEEP_CHUNK`` sessions, and a pipeline
  deadline that does not count a held loop against the matcher.
"""

import asyncio
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

import chip_smoke
from maxmq_tpu import bootstrap as j_boot
from maxmq_tpu import metrics as j_metrics
from maxmq_tpu.matching import service as j_service
from maxmq_tpu.matching.supervisor import SupervisedMatcher as JSupervised
from maxmq_tpu.utils import config as j_config
from maxmq_tpu.utils.logger import Logger as JLogger
from maxmq_tpu_torch import bootstrap as t_boot
from maxmq_tpu_torch import cli
from maxmq_tpu_torch import metrics as t_metrics
from maxmq_tpu_torch.matching import service as t_service
from maxmq_tpu_torch.matching.supervisor import SupervisedMatcher
from maxmq_tpu_torch.utils import config as t_config
from maxmq_tpu_torch.utils.logger import Logger
from test_torch_broker_engine import port_module, run_scenario, scenario_cases

ROOT = Path(__file__).resolve().parent.parent
KIT = chip_smoke.port_kit()


def quiet(pkg: str):
    import io
    return (JLogger if pkg == "ref" else Logger)(out=io.StringIO(),
                                                 fmt="json")


PKGS = {"ref": types.SimpleNamespace(boot=j_boot, config=j_config,
                                     metrics=j_metrics, service=j_service),
        "port": types.SimpleNamespace(boot=t_boot, config=t_config,
                                      metrics=t_metrics, service=t_service)}


def conf_of(pkg: str, **kw):
    return PKGS[pkg].config.Config(**{"mqtt_sys_topic_interval": 0,
                                      "metrics_enabled": False, **kw})


def build(pkg: str, conf):
    if pkg == "ref":
        return j_boot.build_broker(conf, quiet(pkg))
    return t_boot.build_broker(conf, quiet(pkg), device="cpu")


# -- build_broker's wiring ----------------------------------------------------

def chain(m) -> list:
    """The matcher stack, outermost first, with each layer's settings."""
    out = []
    while m is not None:
        d = vars(m)
        settings = {k: d[k] for k in (
            "deadline_ms", "breaker_threshold", "breaker_window_s",
            "backoff_initial_s", "backoff_max_s", "window_us", "max_batch",
            "emit_intents", "max_levels", "fixed_max_rows") if k in d}
        out.append((type(m).__name__, settings))
        m = d.get("inner") or d.get("engine")
    return out


def store_chain(st) -> list:
    out = []
    while st is not None:
        d = vars(st)
        out.append((type(st).__name__, {k: d[k] for k in (
            "policy", "batch_ms", "batch_ops", "queue_bytes",
            "breaker_threshold", "backoff_s", "backoff_max_s",
            "_synchronous") if k in d}))
        st = d.get("inner")
    return out


def wiring(b) -> dict:
    caps = dataclasses.asdict(b.capabilities)
    caps.pop("filter_backend")      # "jnp" in the reference, "torch" here
    return {
        "hooks": [type(h).__name__ for h in b.hooks],
        "storage": [store_chain(h.store) for h in b.hooks
                    if hasattr(h, "bump_boot_epoch")],
        "listeners": [(lst.id, type(lst).__name__, lst.address,
                       getattr(lst, "reuse_port", None))
                      for lst in b.listeners.all()],
        "capabilities": caps,
        "matcher": chain(b.matcher)}


async def close_built(b) -> None:
    for h in b.hooks:
        if hasattr(h, "bump_boot_epoch"):
            h.stop()
    if b.matcher is not None:
        await b.matcher.close()
        engine_close = getattr(getattr(b.matcher, "engine", None), "close",
                               None)
        if engine_close is not None:
            engine_close()


WIRING_CONFIGS = {
    "default": {},
    "trace": {"log_level": "trace"},
    "ledger": {"auth_ledger": "LEDGER"},
    "memory": {"storage_backend": "memory"},
    "sqlite_always": {"storage_backend": "sqlite", "storage_sync": "always",
                      "storage_path": "DB"},
    "sqlite_off": {"storage_backend": "sqlite", "storage_sync": "off",
                   "storage_path": "DB", "storage_batch_ms": 7,
                   "storage_batch_ops": 9, "storage_queue_bytes": 1234,
                   "storage_breaker_threshold": 2,
                   "storage_breaker_backoff_s": 0.5,
                   "storage_breaker_backoff_max_s": 4},
    "listeners": {"mqtt_tcp_address": "127.0.0.1:0",
                  "mqtt_ws_address": "127.0.0.1:0",
                  "mqtt_unix_socket": "SOCK",
                  "mqtt_sys_http_address": "127.0.0.1:0"},
    "sig": {"matcher": "sig", "matcher_max_batch": 64},
    "nfa": {"matcher": "nfa", "matcher_max_levels": 8},
    "dense": {"matcher": "dense", "matcher_max_levels": 8,
              "matcher_supervised": False},
    "sig_plain": {"matcher": "sig", "matcher_intents": False,
                  "matcher_deadline_ms": 90, "matcher_batch_window_us": 0},
}


@pytest.mark.parametrize("name", sorted(WIRING_CONFIGS))
async def test_build_broker_wiring_equals_the_reference(name, tmp_path):
    ledger = tmp_path / "ledger.json"
    ledger.write_text(json.dumps({"auth": [{"username": "a",
                                            "password": "p"}]}))
    got = {}
    for pkg in PKGS:
        kw = {k: {"LEDGER": str(ledger), "DB": str(tmp_path / f"{pkg}.db"),
                  "SOCK": str(tmp_path / f"{pkg}.sock")}.get(v, v)
              for k, v in WIRING_CONFIGS[name].items()}
        b = build(pkg, conf_of(pkg, **{"mqtt_tcp_address": "", **kw}))
        try:
            got[pkg] = wiring(b)
        finally:
            await close_built(b)
    for w in got.values():      # the unix sockets' paths differ by name
        w["listeners"] = [(i, t, a if t != "UnixListener" else "unix", r)
                          for i, t, a, r in w["listeners"]]
    assert got["port"] == got["ref"]
    if "storage_backend" in WIRING_CONFIGS[name]:
        assert got["port"]["storage"][0][0][0] == "WriteBehindStore"
        assert got["port"]["storage"][0][1][0] == "FaultInjectingStore"


async def test_build_broker_refuses_cluster_and_the_engine_device():
    """Cluster mode at the default config builds the manager with its
    session federation, as the reference's does; a device engine with no
    device named and no CUDA raises instead of taking the CPU."""
    import torch

    got = {}
    for pkg in PKGS:
        b = build(pkg, conf_of(pkg, mqtt_tcp_address="", matcher="trie",
                               cluster_node_id="n1",
                               cluster_peers="n2@127.0.0.1:1"))
        sess = b.cluster.sessions
        assert sess is not None and sess in b.hooks
        got[pkg] = (type(sess).__name__, sess.sync, sess.sync_timeout,
                    sess.takeover_timeout, sess.replica_expiry,
                    b.cluster.fwd_coupled)
    assert got["port"] == got["ref"]
    assert got["port"][1] == "batched"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_boot.build_broker(conf_of("port", mqtt_tcp_address="",
                                        matcher="sig"), quiet("port"))


def test_build_storage_equals_the_reference(tmp_path):
    assert t_boot.build_storage(conf_of("port")) is None
    for policy in ("always", "batched", "off"):
        hooks = []
        for pkg in PKGS:
            conf = conf_of(pkg, storage_backend="sqlite", storage_sync=policy,
                           storage_path=str(tmp_path / f"{pkg}-{policy}.db"))
            hooks.append(PKGS[pkg].boot.build_storage(conf))
        try:
            assert (store_chain(hooks[0].store)
                    == store_chain(hooks[1].store))
            conn = hooks[1].store.inner.inner._conn
            level = conn.execute("PRAGMA synchronous").fetchone()[0]
            assert level == (0 if policy == "off" else 2)
        finally:
            for h in hooks:
                h.stop()
    with pytest.raises(ValueError, match="storage_sync"):
        t_boot.build_storage(conf_of("port", storage_backend="memory",
                                     storage_sync="sometimes"))


def test_install_event_loop_equals_the_reference():
    try:
        for policy in ("auto", "asyncio", "uvloop", " AUTO "):
            assert (t_boot.install_event_loop(policy)
                    == j_boot.install_event_loop(policy))
        with pytest.raises(ValueError):
            t_boot.install_event_loop("trio")
    finally:
        asyncio.set_event_loop_policy(asyncio.DefaultEventLoopPolicy())


def test_cli_start_flags_and_help(capsys):
    args = cli.make_parser().parse_args(
        ["start", "-c", "/tmp/x.conf", "--profile", "--no-banner",
         "--device", "cpu"])
    assert (args.command, args.config, args.profile, args.no_banner,
            args.device) == ("start", "/tmp/x.conf", True, True, "cpu")
    assert cli.make_parser().parse_args(["start"]).device is None
    assert cli.main([]) == 0
    assert "start" in capsys.readouterr().out


# -- run_server in process: the reference's start-path sessions ---------------

BOOT = port_module(
    "test_bootstrap.py", "torch_port_bootstrap",
    replace=(("18831", "18871"), ("18832", "18872"), ("18833", "18873"),
             ("broker_out=(captured := [])))",
              "broker_out=(captured := []), device=\"cpu\"))")))
BOOT_CASES = scenario_cases(BOOT, 83, 153)


def test_every_start_session_is_ported():
    assert [n for n, _k in BOOT_CASES] == [
        "test_run_server_end_to_end", "test_run_server_cluster_mesh_matcher"]


@pytest.mark.parametrize("name,kwargs", BOOT_CASES,
                         ids=[n for n, _k in BOOT_CASES])
async def test_start_session_on_the_port(name, kwargs, tmp_path,
                                         monkeypatch):
    monkeypatch.chdir(tmp_path)
    fn = getattr(BOOT, name)
    if "monkeypatch" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        kwargs = dict(kwargs, monkeypatch=monkeypatch)
    await run_scenario(fn, kwargs, tmp_path)


test_start_session_on_the_port._async_timeout = 150


async def test_server_started_line_names_the_device(tmp_path):
    """The start line names where matching runs and the boot's restore and
    compile seconds; a broker built for the CPU registers the kernel
    launch counters, the batcher's batched topics and shadow probes, the
    engine's tables lag (0 after the boot compile), its refresh flag and
    the process's collection pauses beside the reference's families."""
    import io

    buf = io.StringIO()
    conf = conf_of("port", mqtt_tcp_address="127.0.0.1:0", matcher="sig",
                   metrics_enabled=True, metrics_address="127.0.0.1:0")
    ready, stop, out = asyncio.Event(), asyncio.Event(), []
    task = asyncio.create_task(t_boot.run_server(
        conf, Logger(out=buf, fmt="json"), ready=ready, stop=stop,
        broker_out=out, device="cpu"))
    await asyncio.wait_for(ready.wait(), 60)
    stop.set()
    await asyncio.wait_for(task, 60)
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    started = next(x for x in lines if x["message"] == "server started")
    assert started["device"] == "cpu" and started["matcher"] == "sig"
    assert started["restore_s"] >= 0 and started["compile_s"] >= 0
    reg = t_metrics.Registry()
    t_metrics.register_broker_metrics(reg, out[0])
    base = {n for n, _l in chip_smoke.metric_series(reg.expose())}
    full = t_boot.build_metrics(conf, out[0], Logger(out=io.StringIO()))
    names = {n for n, _l in chip_smoke.metric_series(full.registry.expose())}
    assert names - base == {"maxmq_matcher_kernel_launches_total",
                            "maxmq_matcher_batched_topics_total",
                            "maxmq_matcher_shadow_probes_total",
                            "maxmq_matcher_tables_behind",
                            "maxmq_matcher_refreshing",
                            "maxmq_matcher_gc_paused_seconds_total",
                            "maxmq_matcher_gc_full_collections_total"}
    page = chip_smoke.metric_series(full.registry.expose())
    assert chip_smoke.metric(page, "maxmq_matcher_tables_behind") == 0
    assert t_boot.matcher_device(out[0]) == "cpu"


# -- durable acknowledgements and the exposition ------------------------------

async def serve_built(pkg: str, conf):
    b = build(pkg, conf)
    await b.serve()
    return b, b.listeners.get("tcp")._server.sockets[0].getsockname()[1]


async def durable_session(port: int) -> dict:
    """One transcript: persistent v5 and v3.1.1 subscribers, a '#' probe,
    QoS 0/1/2 and retained publishes from v5 and v3.1.1 publishers (each
    settled before the next), an offline queue resumed, a retained clear."""
    def client(cid, version, **kw):
        return chip_smoke.WireClient(KIT, cid, version, timeout=20, **kw)

    sub5 = client("s5", 5, clean=False, expiry=300)
    sub4 = client("s4", 4, clean=False)
    probe = client("probe", 4)
    pub5, pub4 = client("p5", 5), client("p4", 4)
    for c in (sub5, sub4, probe, pub5, pub4):
        await c.open(port)
    await sub5.subscribe(KIT.Subscription(filter="d/+/t", qos=2,
                                          identifier=7))
    await sub5.subscribe(KIT.Subscription(filter="d/#", qos=1))
    await sub4.subscribe(KIT.Subscription(filter="d/a/#", qos=1))
    await probe.subscribe(KIT.Subscription(filter="#"))
    await sub4.close(disconnect=True)
    for i, (pub, topic, qos, retain) in enumerate((
            (pub5, "d/a/t", 1, False), (pub5, "d/b/t", 2, False),
            (pub4, "d/a/r", 1, True), (pub4, "d/c/t", 0, False),
            (pub5, "d/a/x", 2, True), (pub4, "d/a/t", 2, False),
            (pub5, "e/f", 1, False))):
        await pub.publish(topic, b"m%d" % i, qos=qos, retain=retain)
    await sub5.close()
    await pub5.publish("d/a/t", b"late", qos=1)
    await pub4.publish("d/a/r", b"", qos=1, retain=True)
    await sub4.open(port)
    await sub4.ping()
    await sub5.open(port)
    await sub5.ping()
    for c in (sub5, sub4, probe):
        await c.until(lambda c=c: not c.awaiting_rel)
        await c.ping()
    frames = {c.cid: {"pub": c.frames, "rel": c.rel, "ctl": c.ctl}
              for c in (sub5, sub4, probe, pub5, pub4)}
    for c in (sub5, sub4, probe, pub5, pub4):
        await c.close(disconnect=True)
    return frames


# series whose values depend on the clock, on the journal writer's timing
# (how its group commits fell) or on the loop's iterations (how writer
# wakes coalesced), not on the traffic; and the kernel plan's shape gauges
# (the port's kernel walks its words in one pass: no 16-bit chunks)
TIMED = ("uptime", "seconds", "rtt", "maxmq_storage_commits",
         "maxmq_storage_ops", "maxmq_storage_queue", "maxmq_storage_last",
         "maxmq_storage_largest", "maxmq_storage_barrier",
         "maxmq_storage_boot_epoch", "maxmq_storage_dirty",
         "maxmq_broker_fanout_flush", "maxmq_matcher_kernel")


async def test_durable_acks_stores_and_exposition_equal(tmp_path):
    frames, series, waits = {}, {}, {}
    for pkg in PKGS:
        db = str(tmp_path / f"{pkg}.db")
        conf = conf_of(pkg, mqtt_tcp_address="127.0.0.1:0", matcher="trie",
                       storage_backend="sqlite", storage_sync="always",
                       storage_path=db)
        b, port = await serve_built(pkg, conf)
        try:
            frames[pkg] = await durable_session(port)
            reg = PKGS[pkg].metrics.Registry()
            PKGS[pkg].metrics.register_broker_metrics(reg, b)
            series[pkg] = chip_smoke.metric_series(reg.expose())
            waits[pkg] = b.storage_barrier_waits
        finally:
            await b.close()             # stops the storage hook too
    assert frames["port"] == frames["ref"]
    assert sum(len(v["pub"]) for v in frames["port"].values()) >= 15
    assert waits["port"] > 0 and waits["ref"] > 0
    counts = chip_smoke.stores_equal(str(tmp_path / "port.db"),
                                     str(tmp_path / "ref.db"))
    assert counts["inflight"] == 0 and counts["subscriptions"] == 3
    assert counts["retained"] == 1 and counts["clients"] == 2
    assert set(series["port"]) == set(series["ref"])
    values = {p: {k: v for k, v in s.items()
                  if not any(t in k[0] for t in TIMED)}
              for p, s in series.items()}
    assert values["port"] == values["ref"]
    assert values["port"][("maxmq_mqtt_messages_received", "")] == 9


@pytest.mark.parametrize("matcher", ["sig", "nfa", "dense"])
async def test_exposition_with_a_matcher_equals_the_reference(matcher):
    """Both packages' brokers with a device matcher and a small corpus
    and a journal, booted: the same series and labels (the matcher's
    registrations included), and the same values but for the clock, the
    journal's timing and the kernel plan's shape."""
    series = {}
    for pkg in PKGS:
        conf = conf_of(pkg, matcher=matcher, matcher_max_levels=8,
                       storage_backend="memory")
        b = build(pkg, conf)
        for i in range(300):
            b.topics.subscribe(f"c{i}", KIT.Subscription(
                filter=f"x/{i % 40}/+", qos=1))
        await b.serve()
        try:
            reg = PKGS[pkg].metrics.Registry()
            PKGS[pkg].metrics.register_broker_metrics(reg, b)
            series[pkg] = chip_smoke.metric_series(reg.expose())
        finally:
            await b.close()             # stops the storage hook too
            await b.matcher.close()
            getattr(b.matcher.engine, "close", lambda: None)()
    assert set(series["port"]) == set(series["ref"])
    assert any(n.startswith("maxmq_matcher_") for n, _l in series["port"])
    values = {p: {k: v for k, v in s.items()
                  if not any(t in k[0] for t in TIMED)}
              for p, s in series.items()}
    assert values["port"] == values["ref"]


async def test_restored_inflight_resends_at_the_sessions_version(tmp_path):
    """A message restored from the store is resent to a resumed v5 session
    as a v5 frame by the port; the reference resends the record's packet
    as it was rebuilt, with no version: a v3.1.1 frame (no property
    length) that a v5 client cannot parse."""
    import maxmq_tpu.broker as j_broker
    import maxmq_tpu.hooks as j_hooks
    import maxmq_tpu.hooks.storage as j_storage
    import maxmq_tpu_torch.broker as t_broker
    import maxmq_tpu_torch.hooks as t_hooks
    import maxmq_tpu_torch.hooks.storage as t_storage

    got = {}
    for pkg, broker, hooks, st in (("ref", j_broker, j_hooks, j_storage),
                                   ("port", t_broker, t_hooks, t_storage)):
        db = str(tmp_path / f"{pkg}.db")
        s = st.SQLiteStore(db)
        s.put("clients", "v5c", st.ClientRecord(
            client_id="v5c", listener="t", protocol_version=5,
            session_expiry=300, session_expiry_set=True).to_json())
        s.put("subscriptions", "v5c|a/b", st.SubscriptionRecord(
            client_id="v5c", filter="a/b", qos=1).to_json())
        s.put("inflight", "v5c|1", st.MessageRecord(
            client_id="v5c", topic="a/b", payload=b"hi", qos=1,
            packet_id=1, created=1.0).to_json())
        s.close()
        b = broker.Broker(broker.BrokerOptions(
            capabilities=broker.Capabilities(sys_topic_interval=0)))
        b.add_hook(hooks.AllowHook())
        b.add_hook(st.StorageHook(st.SQLiteStore(db)))
        lst = b.add_listener(broker.TCPListener("t", "127.0.0.1:0"))
        await b.serve()
        c = chip_smoke.WireClient(KIT, "v5c", 5, clean=False, expiry=300,
                                  timeout=10)
        try:
            await c.open(lst._server.sockets[0].getsockname()[1])
            await c.until(lambda: c.frames)
            got[pkg] = c.frames[0]
            await c.close(disconnect=True)
        finally:
            await b.close()
    assert got["ref"] == b"\x3a\x09\x00\x03a/b\x00\x01hi"
    assert got["port"] == b"\x3a\x0a\x00\x03a/b\x00\x01\x00hi"
    fh, body = next(KIT.parse_stream(bytearray(got["port"])))
    assert KIT.Packet.decode(fh, body, 5).payload == b"hi"


async def test_boot_rewarms_the_buckets_of_a_restored_corpus(tmp_path):
    """A broker whose subscriptions come from its store: ``build_matcher``
    warms the dispatch buckets before ``serve()`` restores them (on tables
    of nothing); the boot compile warms them again on the compiled tables
    before the listener accepts (the reference does not)."""
    import maxmq_tpu_torch.hooks.storage as st

    db = str(tmp_path / "w.db")
    s = st.SQLiteStore(db)
    for i in range(400):
        s.put("subscriptions", f"c{i}|w/{i}/#", st.SubscriptionRecord(
            client_id=f"c{i}", filter=f"w/{i}/#", qos=1).to_json())
    s.close()
    warmed = {}
    for pkg in PKGS:
        conf = conf_of(pkg, mqtt_tcp_address="127.0.0.1:0", matcher="sig",
                       storage_backend="sqlite", storage_path=db,
                       storage_sync="off")
        b = build(pkg, conf)
        engine = b.matcher.engine
        engine.close()                   # the build's warm-up is over
        calls = []
        warm = engine.warm_buckets

        def counted(*a, warm=warm, engine=engine, calls=calls, **k):
            calls.append((engine.tables.version, k.get("background")))
            return warm(*a, **k)

        engine.warm_buckets = counted
        await b.serve()
        warmed[pkg] = (calls, b.topics.sub_version)
        await b.close()
        await b.matcher.close()
        engine.close()
    calls, version = warmed["port"]
    assert calls == [(version, False)]
    assert warmed["ref"][0] == []


def supervised_pair():
    """Each package's supervisor over an inner matcher whose answer comes
    10 ms after it is asked."""
    class Inner:
        index = None

        def enqueue(self, topic):
            loop = asyncio.get_running_loop()
            fut = loop.create_future()
            loop.call_later(0.01, fut.set_result, ("answer", topic))
            return fut

    return {"ref": JSupervised(Inner(), deadline_ms=100,
                               index=types.SimpleNamespace(
                                   subscribers=lambda t: ("trie", t))),
            "port": SupervisedMatcher(Inner(), deadline_ms=100,
                                      index=types.SimpleNamespace(
                                          subscribers=lambda t: ("trie", t)))}


async def test_deadline_does_not_count_a_held_loop():
    """The loop held 300 ms right after a match is asked (a full
    collection): the reference answers from the trie on its deadline and
    counts a failure against a matcher that had answered in 10 ms; the
    port's deadline re-arms for the time the loop was held and takes the
    matcher's answer. A matcher that never answers still hedges."""
    got = {}
    for pkg, sup in supervised_pair().items():
        fut = sup.enqueue("a/b")
        asyncio.get_running_loop().call_soon(time.sleep, 0.3)
        got[pkg] = (await asyncio.wait_for(fut, 5), sup.deadline_fallbacks)
    assert got["ref"] == (("trie", "a/b"), 1)
    assert got["port"] == (("answer", "a/b"), 0)

    # a collection inside the window that ends before the deadline (the
    # timer then fires on time), with a matcher answering in 150 ms
    # against a 100 ms deadline: the port leaves the pause out and takes
    # the answer; the same hold not reported as a collection hedges
    import maxmq_tpu_torch.matching.supervisor as t_supervisor

    class Slow:
        index = None

        def enqueue(self, topic):
            loop = asyncio.get_running_loop()
            fut = loop.create_future()
            loop.call_later(0.15, fut.set_result, ("answer", topic))
            return fut

    real = t_supervisor.gc_paused_s
    for counted, want in ((True, ("answer", "c")), (False, ("trie", "c"))):
        paused = [0.0]
        t_supervisor.gc_paused_s = lambda: real() + paused[0]
        try:
            sup = SupervisedMatcher(Slow(), deadline_ms=100,
                                    index=types.SimpleNamespace(
                                        subscribers=lambda t: ("trie", t)))
            fut = sup.enqueue("c")

            def collection(counted=counted, paused=paused):
                time.sleep(0.08)
                paused[0] += 0.08 if counted else 0.0
            asyncio.get_running_loop().call_soon(collection)
            assert await asyncio.wait_for(fut, 5) == want
        finally:
            t_supervisor.gc_paused_s = real

    class Hung:
        index = None

        def enqueue(self, topic):
            return asyncio.get_running_loop().create_future()

    sup = SupervisedMatcher(Hung(), deadline_ms=50, index=types.SimpleNamespace(
        subscribers=lambda t: ("trie", t)))
    t0 = time.perf_counter()
    assert await asyncio.wait_for(sup.enqueue("x"), 5) == ("trie", "x")
    assert sup.deadline_fallbacks == 1 and time.perf_counter() - t0 < 1.0


@pytest.mark.parametrize("hold_s", [0.08, 0.3])
async def test_deadline_under_a_periodically_held_loop_is_bounded(hold_s):
    """A matcher that never answers, on a loop held ``hold_s`` every 20 ms
    for 3 s (each deadline timer fires late): the port's deadline re-arms
    once, for at most one more deadline, then answers from the trie, well
    before the holds end; the breaker records the failure."""
    class Hung:
        index = None

        def enqueue(self, topic):
            return asyncio.get_running_loop().create_future()

    loop = asyncio.get_running_loop()
    sup = SupervisedMatcher(Hung(), deadline_ms=100,
                            index=types.SimpleNamespace(
                                subscribers=lambda t: ("trie", t)))
    stop = time.perf_counter() + 3.0

    def hold():
        time.sleep(hold_s)
        if time.perf_counter() < stop:
            loop.call_later(0.02, hold)

    t0 = time.perf_counter()
    fut = sup.enqueue("h/1")
    loop.call_soon(hold)
    assert await asyncio.wait_for(fut, 5) == ("trie", "h/1")
    took = time.perf_counter() - t0
    # due at 0.1 s, the re-arm at most 0.1 s more; each firing may come
    # one hold (plus the 20 ms gap) late
    assert took < 0.2 + 2 * (hold_s + 0.02) + 0.1, took
    assert sup.deadline_fallbacks == 1 and len(sup._failures) == 1
    while time.perf_counter() < stop:       # let the holds run out
        await asyncio.sleep(0.05)


async def test_housekeeping_sweeps_skip_and_slice_like_the_reference():
    """Sessions of both packages' brokers with expiries, a live client and
    inflight messages: the port's ticks (sliced at a small
    ``SWEEP_CHUNK``, expiry and inflight sweeps skipped while nothing can
    be due) expire exactly what the reference's checks expire, at each of
    a series of clocks; the bounds move on a disconnect."""
    import maxmq_tpu.broker as j_broker
    import maxmq_tpu_torch.broker as t_broker
    from maxmq_tpu.broker.client import Client as JClient
    from maxmq_tpu_torch.broker.client import Client as TClient

    brokers = {}
    for pkg, broker, client_cls in (("ref", j_broker, JClient),
                                    ("port", t_broker, TClient)):
        b = broker.Broker(broker.BrokerOptions(
            capabilities=broker.Capabilities(
                sys_topic_interval=0, maximum_message_expiry_interval=50)))
        b.loop = asyncio.get_running_loop()
        for i in range(12):
            c = client_cls(b, None, None, "t")
            c.id = f"c{i}"
            c.properties.protocol_version = 5 if i % 3 else 4
            c.properties.clean_start = i % 4 == 0
            c.properties.session_expiry = 10 * (i + 1)
            c.properties.session_expiry_set = bool(i % 3)
            c.disconnected_at = 1000.0 + i
            c._stopped.set()
            if i % 5 == 0:
                p = KIT.Packet(fixed=KIT.FixedHeader(type=KIT.PT.PUBLISH,
                                                     qos=1),
                               topic="t", payload=b"x", packet_id=1)
                p.created = 990.0 + 3 * i
                c.inflight.set(p)
            b.clients.add(c)
        brokers[pkg] = b
    port = brokers["port"]
    port.SWEEP_CHUNK = 5
    for now in (1000.5, 1005.0, 1011.0, 1031.0, 1045.0, 1060.0, 1080.0,
                1130.0):
        ref = brokers["ref"]
        ref._check_client_expiry(now)
        ref._check_expired_inflight(now)
        await port._housekeeping_tick(now, time.monotonic())
        assert ([c.id for c in port.clients.all()]
                == [c.id for c in ref.clients.all()]), now
        assert ({c.id: len(c.inflight) for c in port.clients.all()}
                == {c.id: len(c.inflight) for c in ref.clients.all()}), now
    survivors = port.clients.all()
    assert survivors and port._expiry_due < float("inf")
    late = TClient(port, None, None, "t")
    late.id, late.properties.clean_start = "late", True
    port.clients.add(late)
    await late.stop()
    assert port._expiry_due <= late.disconnected_at


# -- matcher = "service" ------------------------------------------------------

async def test_service_attach_frames_equal_the_reference(tmp_path):
    """Each package's broker started with ``matcher = "service"`` on its
    package's matcher service: the broker half forwards subscriptions
    (and the stored ones at attach), the publishes match through the
    service, every client receives the same frames."""
    frames = {}
    for pkg in PKGS:
        sock = str(tmp_path / f"{pkg}.sock")
        svc = (j_service.MatcherService(sock) if pkg == "ref" else
               t_service.MatcherService(sock, device="cpu"))
        await svc.start()
        conf = conf_of(pkg, mqtt_tcp_address="127.0.0.1:0",
                       matcher="service", matcher_socket=sock)
        ready, stop, out = asyncio.Event(), asyncio.Event(), []
        kw = {} if pkg == "ref" else {"device": "cpu"}
        task = asyncio.create_task(PKGS[pkg].boot.run_server(
            conf, quiet(pkg), ready=ready, stop=stop, broker_out=out, **kw))
        try:
            await asyncio.wait_for(ready.wait(), 60)
            b = out[0]
            assert type(b.matcher).__name__ == "SupervisedMatcher"
            assert type(b.matcher.inner).__name__ == "ServiceMatcher"
            assert any(type(h).__name__ == "_ForwardHook" for h in b.hooks)
            port = b.listeners.get("tcp")._server.sockets[0].getsockname()[1]
            subs = [chip_smoke.WireClient(KIT, f"s{k}", 4 + k % 2,
                                          timeout=20) for k in range(3)]
            pub = chip_smoke.WireClient(KIT, "p", 5, timeout=20)
            for c in (*subs, pub):
                await c.open(port)
            await subs[0].subscribe(KIT.Subscription(filter="s/+/x", qos=1))
            await subs[1].subscribe(KIT.Subscription(filter="s/#", qos=2))
            await subs[2].subscribe(KIT.Subscription(filter="$share/g/s/#"))
            await subs[2].subscribe(KIT.Subscription(filter="#"))
            probe = subs[2]         # '#': every publish reaches it

            async def publish(topic, payload, qos):
                n = len(probe.frames)
                await pub.publish(topic, payload, qos=qos)
                await probe.until(lambda: len(probe.frames) > n)

            for i, t in enumerate(("s/a/x", "s/b", "s/c/x", "t/u", "s/a/x")):
                await publish(t, b"v%d" % i, i % 3)
            for c in subs:
                await c.ping()
                await c.until(lambda c=c: not c.awaiting_rel)
            await subs[1].unsubscribe("s/#")
            await publish("s/z/x", b"after", 1)
            for c in subs:
                await c.ping()
            frames[pkg] = {c.cid: (c.frames, c.rel) for c in subs}
            assert b.matcher.matches > 0
            for c in (*subs, pub):
                await c.close(disconnect=True)
        finally:
            stop.set()
            await asyncio.wait_for(task, 60)
            await svc.close()
    assert frames["port"] == frames["ref"]
    assert sum(len(f) for f, _r in frames["port"].values()) >= 8


# -- python -m maxmq_tpu_torch start, as a child process ----------------------

def start_child(tmp_path, extra: str = "", args=("--device", "cpu"),
                env=None, port: int | None = None):
    port, mport = port or chip_smoke.free_port(), chip_smoke.free_port()
    conf = tmp_path / "c.toml"
    conf.write_text(f'mqtt_tcp_address = "127.0.0.1:{port}"\n'
                    f'metrics_address = "127.0.0.1:{mport}"\n'
                    'mqtt_sys_topic_interval = 0\nlog_format = "json"\n'
                    'storage_backend = "sqlite"\nstorage_sync = "always"\n'
                    f'storage_path = "{tmp_path / "s.db"}"\n' + extra)
    full_env = {k: v for k, v in os.environ.items()
                if not k.startswith("MAXMQ_")}
    full_env.update(PYTHONPATH=str(ROOT), **(env or {}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "maxmq_tpu_torch", "start", "-c", str(conf),
         "--no-banner", *args], cwd=ROOT, env=full_env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    proc.metrics_port = mport
    return proc, port


async def test_start_child_answers_and_stops_on_sigterm(tmp_path):
    from maxmq_tpu_torch.mqtt_client import MQTTClient

    proc, port = start_child(tmp_path, 'matcher = "sig"\n')
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, proc.communicate(timeout=10)
            try:
                _r, w = await asyncio.open_connection("127.0.0.1", port)
                w.close()
                break
            except OSError:
                assert time.monotonic() < deadline, "never accepted"
                await asyncio.sleep(0.1)
        c = MQTTClient(client_id="child")
        await c.connect("127.0.0.1", port)
        await c.subscribe(("ch/#", 1))
        await c.publish("ch/x", b"hello", qos=1)
        assert (await c.next_message(timeout=10)).payload == b"hello"
        await c.disconnect()
        proc.send_signal(signal.SIGTERM)
        _out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err[-2000:]
        lines = [json.loads(x) for x in err.splitlines() if x.startswith("{")]
        started = next(x for x in lines if x["message"] == "server started")
        assert started["device"] == "cpu" and started["matcher"] == "sig"
        assert any(x["message"] == "server stopped" for x in lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


test_start_child_answers_and_stops_on_sigterm._async_timeout = 150


async def wait_until(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        await asyncio.sleep(0.05)


async def test_start_children_run_a_federation(tmp_path):
    """Two ``start --device cpu`` children peered over TCP at the default
    ``cluster_session_replication = true``: each builds its manager (the
    reference's ``test_bootstrap_builds_cluster_from_config``, as a
    process), a publish on A reaches a subscriber on B, each serves
    ``/cluster/metrics`` with both nodes' series after a telemetry
    interval, the subscriber's session is taken over at A with
    session-present = 1 and its subscription serving there, and both exit
    0 on SIGTERM."""
    import urllib.request

    from maxmq_tpu_torch.mqtt_client import MQTTClient

    ports = {n: chip_smoke.free_port() for n in "AB"}
    procs, mports = {}, {}
    try:
        for node, peer in (("A", "B"), ("B", "A")):
            d = tmp_path / node
            d.mkdir()
            procs[node], _p = start_child(
                d, f'cluster_node_id = "{node}"\n'
                   f'cluster_peers = "{peer}@127.0.0.1:{ports[peer]}"\n'
                   "cluster_telemetry_interval_s = 0.5\n"
                   "cluster_link_keepalive = 0.5\n",
                port=ports[node])
            mports[node] = procs[node].metrics_port

        def page(node: str, path: str) -> str:
            url = f"http://127.0.0.1:{mports[node]}{path}"
            try:
                with urllib.request.urlopen(url, timeout=10) as r:
                    return r.read().decode()
            except OSError:
                return ""

        for node in "AB":
            await wait_until(lambda n=node: "maxmq_cluster_links_up 1"
                             in page(n, "/metrics"), 90, f"{node} links")
        sub = MQTTClient(client_id="fed-sub", clean_start=False)
        await sub.connect("127.0.0.1", ports["B"])
        await sub.subscribe(("fed/#", 1))
        await wait_until(lambda: "maxmq_cluster_routes_held 1"
                         in page("A", "/metrics"), 30, "A's routes")
        pub = MQTTClient(client_id="fed-pub")
        await pub.connect("127.0.0.1", ports["A"])
        await pub.publish("fed/x", b"across", qos=1)
        assert (await sub.next_message(timeout=10)).payload == b"across"
        for node in "AB":
            await wait_until(
                lambda n=node: all(f'node="{m}"' in page(n, "/cluster/metrics")
                                   for m in "AB"), 30, f"{node} telemetry")
        assert "maxmq_cluster_forwards_sent_total 1" in page("A", "/metrics")
        await sub.disconnect()
        await wait_until(lambda: "maxmq_cluster_session_ledger 2"
                         in page("A", "/metrics"), 30, "A's ledger")
        again = MQTTClient(client_id="fed-sub", clean_start=False)
        await again.connect("127.0.0.1", ports["A"])
        assert again.connack.session_present is True
        await pub.publish("fed/y", b"taken over", qos=1)
        assert (await again.next_message(timeout=10)).payload == \
            b"taken over"
        metrics_a = page("A", "/metrics")
        assert "maxmq_cluster_session_takeovers_total 1" in metrics_a
        assert "maxmq_cluster_session_takeovers_degraded_total 0" in metrics_a
        await pub.disconnect()
        await again.disconnect()
        for node in "AB":
            procs[node].send_signal(signal.SIGTERM)
        for node in "AB":
            _out, err = procs[node].communicate(timeout=60)
            assert procs[node].returncode == 0, err[-2000:]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)


test_start_children_run_a_federation._async_timeout = 200

# the cluster series whose values do not depend on timing (connect
# attempts, snapshot/delta splits, telemetry and clock probes do)
CLUSTER_DETERMINISTIC = (
    "maxmq_cluster_routes_held", "maxmq_cluster_links_up",
    "maxmq_cluster_forwards_sent_total",
    "maxmq_cluster_forwards_delivered_total",
    "maxmq_cluster_forwards_refused_total",
    "maxmq_cluster_forwards_skipped_down_total",
    "maxmq_cluster_loops_dropped_total", "maxmq_cluster_hops_dropped_total",
    "maxmq_cluster_forwards_parked_total", "maxmq_cluster_fwd_parked",
    "maxmq_cluster_route_apply_failures_total",
    "maxmq_cluster_fwd_barrier_waits_total",
    "maxmq_cluster_fwd_barrier_degraded_total",
    "maxmq_cluster_partition_drops_in_total",
    "maxmq_cluster_content_route_skips_total", "maxmq_cluster_link_state",
    "maxmq_cluster_link_forwards_total")


async def test_federated_exposition_equals_the_reference():
    """A pair built from a cluster config by each package (``build_broker``
    runs ``build_cluster``), the same traffic through both: every node's
    ``register_broker_metrics`` page has the reference's series (the
    ``maxmq_cluster_*`` families and their labels), and the counters that
    do not depend on timing hold the reference's values."""
    from maxmq_tpu.mqtt_client import MQTTClient as JClient

    series = {}
    for pkg in PKGS:
        ports = {n: chip_smoke.free_port() for n in "AB"}
        nodes = {}
        try:
            for node, peer in (("A", "B"), ("B", "A")):
                conf = conf_of(
                    pkg, mqtt_tcp_address=f"127.0.0.1:{ports[node]}",
                    matcher="trie", cluster_node_id=node,
                    cluster_peers=f"{peer}@127.0.0.1:{ports[peer]}",
                    cluster_link_keepalive=0.5)
                nodes[node] = build(pkg, conf)
                assert nodes[node].cluster.node_id == node
                await nodes[node].serve()
            mgr_a = nodes["A"].cluster
            await wait_until(lambda: all(b.cluster.links_up == 1
                                         for b in nodes.values()), 30, "links")
            sub = JClient(client_id="sub")
            await sub.connect("127.0.0.1", ports["B"])
            await sub.subscribe(("m/#", 1))
            await wait_until(lambda: mgr_a.routes.nodes_for("m/x"), 30,
                             "routes")
            pub = JClient(client_id="pub")
            await pub.connect("127.0.0.1", ports["A"])
            for i in range(6):
                await pub.publish(f"m/{i}", b"p%d" % i, qos=i % 2)
            for i in range(6):
                assert (await sub.next_message(timeout=10)).payload == \
                    b"p%d" % i
            await pub.disconnect()
            await sub.disconnect()
            for node, b in nodes.items():
                reg = PKGS[pkg].metrics.Registry()
                PKGS[pkg].metrics.register_broker_metrics(reg, b)
                series[pkg, node] = chip_smoke.metric_series(reg.expose())
        finally:
            for b in nodes.values():
                await b.close()
    for node in "AB":
        port, ref = series["port", node], series["ref", node]
        assert set(port) == set(ref)
        assert sum(n.startswith("maxmq_cluster_") for n, _l in port) > 40
        det = {k: v for k, v in port.items()
               if k[0] in CLUSTER_DETERMINISTIC}
        assert det == {k: v for k, v in ref.items()
                       if k[0] in CLUSTER_DETERMINISTIC}
    assert series["port", "A"][("maxmq_cluster_forwards_sent_total", "")] == 6


test_federated_exposition_equals_the_reference._async_timeout = 120


async def serves_as_a_federated_node(proc, port: int) -> None:
    """A ``start`` child at the default ``cluster_session_replication =
    true`` with its one peer down: it accepts, a persistent session enters
    its ledger (``/metrics``), and it exits 0 on SIGTERM."""
    import urllib.request

    from maxmq_tpu_torch.mqtt_client import MQTTClient

    def page() -> str:
        url = f"http://127.0.0.1:{proc.metrics_port}/metrics"
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                return r.read().decode()
        except OSError:
            return ""

    await wait_until(lambda: proc.poll() is not None
                     or "maxmq_cluster_session_ledger 0" in page(), 90,
                     "the node's /metrics")
    assert proc.poll() is None, proc.communicate(timeout=10)
    deadline = time.monotonic() + 60
    while True:
        try:
            _r, w = await asyncio.open_connection("127.0.0.1", port)
            w.close()
            break
        except OSError:
            assert time.monotonic() < deadline, "never accepted"
            await asyncio.sleep(0.1)
    c = MQTTClient(client_id="fed-one", clean_start=False)
    await c.connect("127.0.0.1", port)
    await c.subscribe(("one/#", 1))
    await wait_until(lambda: "maxmq_cluster_session_local 1" in page(), 30,
                     "the session in the ledger")
    await c.disconnect()
    proc.send_signal(signal.SIGTERM)


@pytest.mark.parametrize("case", ["no_device", "cluster", "workers"])
async def test_start_child_refuses(case, tmp_path):
    """Without CUDA and without ``--device`` start exits 2; a cluster node
    at the default config (federated sessions on) and a worker pool
    (``workers = 2``) now serve, each exiting 0 on SIGTERM."""
    import torch

    want_rc = 0
    if case == "no_device":
        if torch.cuda.is_available():
            pytest.skip("a card is present: start would run on it")
        proc, _p = start_child(tmp_path, args=())
        want_rc, want = 2, "no CUDA device is available"
    elif case == "cluster":
        proc, port = start_child(
            tmp_path, 'cluster_node_id = "n1"\n'
                      f'cluster_peers = "n2@127.0.0.1:'
                      f'{chip_smoke.free_port()}"\n')
        want = "server stopped"
    else:
        proc, port = start_pool(tmp_path)
        want = "pool worker stopped"
    try:
        if case == "cluster":
            await serves_as_a_federated_node(proc, port)
        elif case == "workers":
            await serves_as_a_pool(proc, port, tmp_path)
        _out, err = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == want_rc and want in err, err[-2000:]
    if case == "workers":
        assert_pool_stopped(err, tmp_path / "mesh", 2)


test_start_child_refuses._async_timeout = 200


# -- python -m maxmq_tpu_torch start with workers = 2 --------------------------

def start_pool(tmp_path, env=None):
    """A ``start --device cpu`` child with ``workers = 2`` (its mesh
    sockets under ``tmp_path/mesh``, its pool endpoint on a free port)."""
    pool_port = chip_smoke.free_port()
    proc, port = start_child(
        tmp_path, f'workers = 2\nworker_link_dir = "{tmp_path / "mesh"}"\n'
                  f'pool_metrics_address = "127.0.0.1:{pool_port}"\n',
        env=env)
    proc.pool_port = pool_port
    return proc, port


def pool_page(proc) -> str:
    import urllib.request

    url = f"http://127.0.0.1:{proc.pool_port}/metrics"
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.read().decode()
    except OSError:
        return ""


async def pool_workers(proc, port: int, n: int = 2) -> list:
    """The pool's worker pids once each holds a listening socket on the
    one TCP port."""
    def owners():
        pids = chip_smoke.child_pids(proc.pid)
        return sorted({chip_smoke.socket_owner(i, pids)
                       for i in chip_smoke.tcp_inodes(port)} - {None})

    await wait_until(lambda: proc.poll() is not None or len(owners()) == n,
                     90, "every worker listening on the port")
    assert proc.poll() is None, proc.communicate(timeout=10)
    return owners()


async def placed(port: int, cid: str, pid: int, pids: list):
    """A client connected to ``port`` and placed (by SO_REUSEPORT) on
    worker ``pid``: reconnects until the kernel picks that worker."""
    from maxmq_tpu_torch.mqtt_client import MQTTClient

    for _ in range(64):
        c = MQTTClient(client_id=cid)
        await c.connect("127.0.0.1", port)
        if chip_smoke.connection_owner(port, c.writer, pids) == pid:
            return c
        await c.disconnect()
    raise AssertionError(f"no connection of 64 reached worker {pid}")


async def crosses_the_mesh(port: int, pids: list, tag: str) -> None:
    """A subscriber on one worker receives a publish from a client on the
    other (publishes repeat until the route is up at the publisher's)."""
    sub = await placed(port, f"{tag}-sub", pids[0], pids)
    await sub.subscribe(("pool/#", 1))
    pub = await placed(port, f"{tag}-pub", pids[1], pids)
    deadline = time.monotonic() + 30
    while True:
        await pub.publish("pool/x", tag.encode(), qos=1)
        try:
            msg = await sub.next_message(timeout=0.5)
            break
        except asyncio.TimeoutError:
            assert time.monotonic() < deadline, "no publish crossed"
    assert msg.payload == tag.encode()
    for c in (sub, pub):
        await c.disconnect()


async def serves_as_a_pool(proc, port: int, tmp_path) -> None:
    """Two worker processes accept on the one port, a publish crosses the
    worker mesh, and the parent stops them on SIGTERM."""
    pids = await pool_workers(proc, port)
    assert len(pids) == 2 and proc.pid not in pids
    for i in range(2):
        assert (tmp_path / "mesh" / f"w{i}.sock").exists()
    await crosses_the_mesh(port, pids, "crossed")
    proc.send_signal(signal.SIGTERM)


def assert_pool_stopped(err: str, mesh, workers: int) -> list:
    """The parent's log: the pool started, each worker (its own JSON
    lines: it logs as the box's config says) started and stopped with rc
    0; and no mesh socket left."""
    lines = [json.loads(x) for x in err.splitlines() if x.startswith("{")]
    msgs = [x["message"] for x in lines]
    assert msgs.count("worker pool started") == 1
    started = sorted(x["worker"] for x in lines
                     if x["message"] == "pool worker started")
    assert sorted(set(started)) == list(range(workers)), started
    stopped = {x["worker"]: x["rc"] for x in lines
               if x["message"] == "pool worker stopped"}
    assert stopped == dict.fromkeys(range(workers), 0), stopped
    assert not mesh.exists() or not list(mesh.glob("*.sock"))
    return started


async def test_started_pool_respawns_a_worker_killed_by_a_fault(tmp_path):
    """``MAXMQ_FAULTS=pool.worker:exit:1``: the first worker stops itself
    once at start, the parent respawns it (the fault reaches that one
    spawn only), ``maxmq_pool_worker_restarts_total 1`` is on the pool's
    endpoint, and a later publish crosses the mesh."""
    proc, port = start_pool(tmp_path,
                            env={"MAXMQ_FAULTS": "pool.worker:exit:1"})
    try:
        await wait_until(
            lambda: proc.poll() is not None
            or "maxmq_pool_worker_restarts_total 1" in pool_page(proc),
            90, "the respawn on the pool endpoint")
        pids = await pool_workers(proc, port)
        await crosses_the_mesh(port, pids, "after-respawn")
        assert "maxmq_pool_worker_restarts_total 1" in pool_page(proc)
        proc.send_signal(signal.SIGTERM)
        _out, err = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err[-2000:]
    assert assert_pool_stopped(err, tmp_path / "mesh", 2) == [0, 0, 1]
    exits = [json.loads(x) for x in err.splitlines()
             if '"pool worker exited; restarting"' in x]
    assert [(x["worker"], x["rc"]) for x in exits] == [(0, 0)]


test_started_pool_respawns_a_worker_killed_by_a_fault._async_timeout = 200


# -- the reference's SIGKILL drills on the port --------------------------------

RECOVERY = port_module("test_storage_recovery.py",
                       "torch_port_storage_recovery")
RECOVERY_CASES = scenario_cases(RECOVERY, 1, 202)


def test_every_recovery_drill_is_ported():
    assert [n for n, _k in RECOVERY_CASES] == [
        "test_sigkill_loses_no_pubacked_qos1",
        "test_torn_record_quarantines_and_boot_epoch_increases"]


@pytest.mark.parametrize("name,kwargs", RECOVERY_CASES,
                         ids=[n for n, _k in RECOVERY_CASES])
async def test_recovery_drill_on_the_port(name, kwargs, tmp_path):
    await run_scenario(getattr(RECOVERY, name), kwargs, tmp_path)


test_recovery_drill_on_the_port._async_timeout = 150
