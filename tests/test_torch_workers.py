"""The port's worker pool (``maxmq_tpu_torch/broker/workers.py``) held
against the JAX package's on the CPU:

- the reference's pool tests on the port (``port_module``: the reference
  test file loaded with the port's package in place of the JAX package's,
  engines on the CPU), with their own assertions: all 8 of
  ``tests/test_workers.py``; from ``tests/test_worker_shard.py`` the mixed
  pool + cluster ``$share`` composition, the shared singletons at
  ``workers = 4`` (one sidecar compile, one journal writer) and the
  cross-worker trace; ``tests/test_faults.py``'s supervised respawn;
- in place of the reference's subprocess SIGKILL drill (flaky on the
  reference's own tree), its in-process counterpart: a worker closed
  mid-QoS 1 stream and rebuilt under its node id, the subscriber resumed
  on the sibling with its session present and every PUBACKed payload
  delivered;
- ``worker_conf`` of both packages equal field for field over a grid;
- both packages' ``inprocess_pool(2)`` driven by the same seeded raw
  clients: every client's frames equal, ``$share`` picks, retained
  convergence and a cross-worker takeover included;
- the sidecar's engine (``_engine_factory`` on the CPU) answering OP_MATCH
  requests from two workers' clients equal to the CPU trie on
  ``mixed_100k``-shaped subscriptions sent as OP_SUB frames;
- the spawned command (the port's CLI, with ``--device``) and the scoping
  of ``pool.worker`` faults to one spawn.
"""

import asyncio
import contextlib
import dataclasses
import itertools
import json
import os
import sys
import time

import pytest

import chip_smoke
from maxmq_tpu.broker import workers as j_workers
from maxmq_tpu.utils import config as j_config
from maxmq_tpu_torch import faults as t_faults
from maxmq_tpu_torch.broker import workers as t_workers
from maxmq_tpu_torch.utils import config as t_config
from test_torch_broker_engine import port_module, run_scenario, scenario_cases

WORKERS = port_module(
    "test_workers.py", "torch_port_workers",
    replace=(("svc = MatcherService(path)",
              'svc = MatcherService(path, device="cpu")'),))
SHARD = port_module("test_worker_shard.py", "torch_port_worker_shard")
FAULTS = port_module(
    "test_faults.py", "torch_port_faults",
    replace=(("from test_broker_system import connect, running_broker",
              "from torch_port_broker_system import connect, "
              "running_broker"),))

WORKER_CASES = scenario_cases(WORKERS, 1, 10_000)
SHARD_CASES = [c for c in scenario_cases(SHARD, 1, 10_000) if c[0] in (
    "test_mixed_pool_cluster_share_composition",
    "test_pool_singletons_one_compile_one_journal",
    "test_cross_worker_trace_chrome")]


def test_every_pool_scenario_is_ported():
    assert len(WORKER_CASES) == 8
    assert len(SHARD_CASES) == 3


@pytest.fixture(autouse=True)
def keep_log_levels():
    """``inprocess_pool`` (both packages') and a worker's ``start`` set
    their logger's process-wide level; the tests that follow in this
    process get theirs back."""
    from maxmq_tpu.utils import logger as j_logger
    from maxmq_tpu_torch.utils import logger as t_logger

    levels = [(m, m.severity_level()) for m in (j_logger, t_logger)]
    yield
    for m, level in levels:
        m.set_severity_level(level)


@pytest.fixture
def clean_port_faults():
    t_faults.clear()
    yield
    t_faults.clear()


@pytest.mark.parametrize("name,kwargs", WORKER_CASES,
                         ids=[n for n, _k in WORKER_CASES])
async def test_pool_scenario_on_the_port(name, kwargs, tmp_path,
                                         clean_port_faults):
    await run_scenario(getattr(WORKERS, name), kwargs, tmp_path)


test_pool_scenario_on_the_port._async_timeout = 60


@pytest.mark.parametrize("name,kwargs", SHARD_CASES,
                         ids=[n for n, _k in SHARD_CASES])
async def test_worker_shard_scenario_on_the_port(name, kwargs, tmp_path,
                                                 clean_port_faults):
    await run_scenario(getattr(SHARD, name), kwargs, tmp_path)


test_worker_shard_scenario_on_the_port._async_timeout = 120


async def test_pool_worker_restart_on_the_port(clean_port_faults):
    await FAULTS.test_pool_worker_restart_counted_and_exported()


test_pool_worker_restart_on_the_port._async_timeout = 30


# -- the worker's config, both packages ----------------------------------------

MATCHERS = ("sig", "nfa", "dense", "trie", "service")


@pytest.mark.parametrize("workers", [2, 4])
@pytest.mark.parametrize("matcher", MATCHERS)
def test_worker_conf_equals_the_reference(matcher, workers):
    """Every worker's derived config, field for field, over the journal
    owner, the box's cluster identity and peers and a matcher mesh."""
    grid = itertools.product((0, 1), ("", "box"), ("", "ext@10.0.0.9:1883"),
                             ("", "2x4"))
    n = 0
    for owner, node, peers, mesh in grid:
        kw = dict(workers=workers, worker_journal_owner=owner,
                  matcher=matcher, cluster_node_id=node, cluster_peers=peers,
                  matcher_mesh=mesh, storage_backend="sqlite",
                  mqtt_unix_socket="/tmp/box.sock",
                  mqtt_sys_http_address="127.0.0.1:8080")
        for i in range(workers):
            got = dataclasses.asdict(t_workers.worker_conf(
                t_config.Config(**kw), i, "/run/pool"))
            want = dataclasses.asdict(j_workers.worker_conf(
                j_config.Config(**kw), i, "/run/pool"))
            assert got == want, (kw, i)
            assert got["cluster_node_id"] == (f"{node}.w{i}" if node
                                              else f"w{i}")
            n += 1
    assert n == 16 * workers


# -- the spawned command -------------------------------------------------------

class FakeProc:
    """A worker process that runs until terminated."""
    pids = itertools.count(40_000)

    def __init__(self, argv, env):
        self.argv, self.env = argv, env
        self.pid = next(self.pids)
        self.returncode = None

    def poll(self):
        return self.returncode

    def terminate(self):
        self.returncode = 0

    def kill(self):
        self.returncode = -9

    def wait(self, timeout=None):
        return self.returncode


@pytest.mark.parametrize("device", [None, "cpu", "cuda"])
async def test_run_pool_spawns_the_port_with_its_device(device, tmp_path,
                                                        monkeypatch):
    """``run_pool`` spawns each worker as the port's CLI (never the JAX
    package's), with the parent's ``--device``, its id and the box's
    config as JSON; a trie pool runs no sidecar."""
    from maxmq_tpu_torch.utils.logger import Logger

    spawned = []

    def popen(argv, env):
        spawned.append(FakeProc(argv, env))
        return spawned[-1]

    monkeypatch.setattr(t_workers.subprocess, "Popen", popen)
    conf = t_config.Config(workers=3, matcher="trie",
                           worker_link_dir=str(tmp_path / "mesh"))
    ready, stop = asyncio.Event(), asyncio.Event()
    task = asyncio.ensure_future(t_workers.run_pool(
        conf, Logger(out=open(os.devnull, "w"), fmt="json"), ready=ready,
        stop=stop, device=device))
    await asyncio.wait_for(ready.wait(), 10)
    stop.set()
    await asyncio.wait_for(task, 10)
    want = [sys.executable, "-m", "maxmq_tpu_torch", "start", "--no-banner"]
    if device is not None:
        want += ["--device", device]
    assert [p.argv for p in spawned] == [want] * 3
    assert "maxmq_tpu" not in [a for p in spawned for a in p.argv]
    assert [p.env["MAXMQ_WORKER_ID"] for p in spawned] == ["0", "1", "2"]
    for p in spawned:
        assert p.env[t_workers.POOL_DIR_ENV] == str(tmp_path / "mesh")
        assert t_config.Config(**json.loads(
            p.env["MAXMQ_POOL_CONF"])) == conf
    assert not (tmp_path / "mesh").exists()     # removed at the stop


def test_pool_worker_faults_reach_one_spawn_as_in_the_reference(monkeypatch):
    """``pool.worker`` entries go to the first spawn only (other entries
    to every spawn), in both packages; the commands differ only in the
    package each names."""
    for spec in ("pool.worker:exit:1", "pool.worker:exit:1,device.match:"
                 "raise:2", "device.match:raise:2", ""):
        env = {"MAXMQ_FAULTS": spec} if spec else {}
        got = {}
        for name, mod in (("port", t_workers), ("ref", j_workers)):
            calls = []
            monkeypatch.setattr(mod.subprocess, "Popen",
                                lambda argv, env, calls=calls:
                                calls.append((argv, env)))
            spawn = mod._worker_spawner(dict(env))
            for i in (0, 1, 0):
                spawn(i)
            got[name] = calls
        assert ([e.get("MAXMQ_FAULTS") for _a, e in got["port"]]
                == [e.get("MAXMQ_FAULTS") for _a, e in got["ref"]]), spec
        assert [a[2] for a, _e in got["port"]] == ["maxmq_tpu_torch"] * 3
        assert [a[2] for a, _e in got["ref"]] == ["maxmq_tpu"] * 3


# -- a worker lost mid-stream, in process ---------------------------------------

def pool_base(conf, n: int = 2):
    """The box config ``inprocess_pool`` derives its workers from."""
    return dataclasses.replace(
        conf, workers=n, mqtt_tcp_address="127.0.0.1:0", mqtt_unix_socket="",
        mqtt_sys_http_address="", mqtt_sys_topic_interval=0,
        metrics_enabled=False)


async def test_worker_closed_mid_stream_resumes_on_the_sibling(tmp_path):
    """The in-process counterpart of the reference's subprocess SIGKILL
    drill (``test_worker_sigkill_takeover_e2e``): the worker holding a
    persistent QoS 1 subscriber is closed while the stream runs and
    rebuilt under its node id. The subscriber resumes on the sibling with
    its session present, and every PUBACKed payload is delivered, those
    published while it was away and those after the rebuild included."""
    from maxmq_tpu_torch.mqtt_client import MQTTClient
    from maxmq_tpu_torch.utils.logger import new_logger

    link_dir = str(tmp_path / "mesh")
    conf = t_config.Config(storage_backend="sqlite",
                           storage_path=str(tmp_path / "pool.db"))
    acked, got = set(), set()

    async def drain(client, idle: float = 0.3) -> None:
        with contextlib.suppress(asyncio.TimeoutError):
            while True:
                got.add(bytes((await client.next_message(timeout=idle))
                              .payload))

    async def stream(pub, tag: str, n: int) -> None:
        for i in range(n):
            payload = f"{tag}-{i}".encode()
            await pub.publish("kill/q1", payload, qos=1, timeout=5.0)
            acked.add(payload)

    async with t_workers.inprocess_pool(2, link_dir=link_dir, conf=conf,
                                        device="cpu") as (brokers, ports):
        sub = MQTTClient("kill-sub", version=5, clean_start=False,
                         session_expiry=600)
        await sub.connect("127.0.0.1", ports[1])
        await sub.subscribe(("kill/q1", 1))
        pub = MQTTClient("kill-pub")
        await pub.connect("127.0.0.1", ports[0])
        await t_workers.await_routes(brokers[0], "kill/q1")
        await WORKERS.poll_until(
            lambda: "kill-sub" in brokers[0].cluster.sessions.ledger,
            what="the session's replica on the sibling")
        await stream(pub, "pre", 10)
        # w1 goes while the second half of the stream is on the wire
        closing = asyncio.ensure_future(brokers[1].close())
        await stream(pub, "mid", 10)
        await closing
        await drain(sub)
        with contextlib.suppress(Exception):
            await sub.close()
        sub2 = MQTTClient("kill-sub", version=5, clean_start=False,
                          session_expiry=600)
        await sub2.connect("127.0.0.1", ports[0])
        assert sub2.session_present, "the takeover lost the session"
        await stream(pub, "post", 10)
        await drain(sub2, idle=1.0)
        assert acked <= got, sorted(acked - got)[:10]
        # the worker rebuilt under its node id rejoins the mesh and
        # forwards its publishes to the session's new owner
        wconf = t_workers.worker_conf(pool_base(conf), 1, link_dir)
        brokers[1] = t_workers.build_worker_broker(
            wconf, new_logger(fmt="json", level="error"), 1, link_dir,
            device="cpu")
        await brokers[1].serve()
        await t_workers.await_mesh(brokers, timeout=20)
        port1 = brokers[1].listeners.get("tcp")._server.sockets[0] \
            .getsockname()[1]
        pub2 = MQTTClient("kill-pub2")
        await pub2.connect("127.0.0.1", port1)
        await t_workers.await_routes(brokers[1], "kill/q1", timeout=20)
        await stream(pub2, "rebuilt", 10)
        await drain(sub2, idle=1.0)
        assert acked <= got, sorted(acked - got)[:10]
        assert len(acked) == 40
        for c in (sub2, pub, pub2):
            await c.disconnect()


test_worker_closed_mid_stream_resumes_on_the_sibling._async_timeout = 90


# -- both packages' pools, frame for frame --------------------------------------

POOL_NODES = ("w0", "w1")
POOL_LINE = {"w0": ("w1",), "w1": ("w0",)}


def share_ledgers_agree(brokers) -> bool:
    a, b = (br.cluster.routes.shares._members for br in brokers)
    return a == b


async def pool_run(workers_mod, config_mod, seed: int, link_dir: str,
                   device=None, n_subs: int = 600, publishes: int = 384,
                   burst: int = 64, clients: int = 12,
                   moved_n: int = 4) -> dict:
    """One package's ``inprocess_pool(2)`` driven by ``seed``: the
    compared raw subscribers of ``subscriber_plan`` (``$share`` members
    on both workers) round robin over w0 and w1, the routes and the share
    ledgers converged, ``publish_frames`` from a publisher on each worker
    in fenced bursts (retained publishes among them); then ``moved_n`` of
    w0's persistent subscribers leave, half of ``publishes // 2`` more
    park for them at w0, they take their sessions over at w1 (session
    present, the parked window resent), and the other half follows.
    Returns every subscriber's frames (a moved one's at w0 under
    ``<cid>@w0``), each worker's retained pairs and forward counters."""
    kit = chip_smoke.port_kit()
    slices, gen = chip_smoke.fed_corpus_slices(POOL_NODES, n_subs, seed)
    topics = gen(publishes, seed2=seed + 1)
    index = kit.TopicIndex()
    for pairs in slices.values():
        for cid, sub in pairs:
            index.subscribe(cid, sub)
    plan = chip_smoke.fed_plan(kit, chip_smoke.subscriber_plan(
        kit, clients, topics, index.subscribers, seed=seed), POOL_NODES,
        probes=False)
    moved = [e for e in plan if e[0] == "w0" and not e[4]][:moved_n]
    kw = {} if device is None else {"device": device}

    def expected(plan) -> dict:
        local = {n: chip_smoke.fed_local_filters(
            [(cid, v, [*subs, kit.Subscription(
                filter=chip_smoke.FENCE_TOPIC)])
             for node, cid, v, _a, _o, subs in plan if node == n])
            for n in POOL_NODES}
        return chip_smoke.fed_routes(local, POOL_LINE)

    async with workers_mod.inprocess_pool(
            2, link_dir=link_dir, conf=config_mod.Config(),
            **kw) as (brokers, ports):
        mgrs = dict(zip(POOL_NODES, (b.cluster for b in brokers)))

        async def converge(plan) -> None:
            want = expected(plan)
            await WORKERS.poll_until(
                lambda: chip_smoke.fed_converged(
                    {n: [m.routes.remote_route_count, m.links_up]
                     for n, m in mgrs.items()}, want, POOL_LINE)
                and share_ledgers_agree(brokers),
                timeout=30, what="routes and share ledgers")

        fed = chip_smoke.Federation(dict(zip(POOL_NODES, ports)),
                                    publishers=POOL_NODES)
        await fed.connect(kit, plan, persistent={e[1] for e in moved})
        await converge(plan)
        await fed.bursts(kit, chip_smoke.publish_frames(
            kit, topics, seed + 2, publishers=2), burst)
        frames, owners = chip_smoke.publish_frames(
            kit, gen(publishes // 2, seed2=seed + 3), seed + 4, publishers=2)
        half = len(frames) // 2
        await fed.leave(moved)
        await fed.bursts(kit, (frames[:half], owners[:half]), burst)
        old = await fed.arrive(kit, moved, "w1", 3600)
        plan = [("w1" if e in moved else e[0], *e[1:]) for e in plan]
        await converge(plan)
        await fed.bursts(kit, (frames[half:], owners[half:]), burst)
        out = {"frames": fed.streams({}),
               "retained": {n: sorted((p.topic, p.payload) for p in
                                      b.topics.retained_for("#"))
                            for n, b in zip(POOL_NODES, brokers)},
               "forwards": {n: {f: getattr(m, f)
                                for f in chip_smoke.FED_FORWARDS}
                            for n, m in mgrs.items()},
               "takeovers": {n: m.sessions.takeovers
                             for n, m in mgrs.items()}}
        out["frames"].update({f"{cid}@w0": f for cid, f in old.items()})
        await fed.close()
        return out


@pytest.mark.parametrize("seed", [41, 42])
async def test_inprocess_pools_of_both_packages_deliver_the_same_frames(
        seed, tmp_path):
    want = await pool_run(j_workers, j_config, seed, str(tmp_path / "ref"))
    got = await pool_run(t_workers, t_config, seed, str(tmp_path / "port"),
                         device="cpu")
    n = chip_smoke.streams_equal("port pool vs JAX pool", got["frames"],
                                 want["frames"])
    assert n > 100, n
    assert got["forwards"] == want["forwards"]
    assert got["takeovers"] == want["takeovers"] == {"w0": 0, "w1": 4}
    # the retained publishes converged on both workers
    assert got["retained"] == want["retained"]
    assert got["retained"]["w0"] == got["retained"]["w1"] != []
    assert sum(1 for c in got["frames"] if c.endswith("@w0")) == 4
    assert all(got["forwards"][n]["forwards_sent"] > 0 for n in POOL_NODES)


test_inprocess_pools_of_both_packages_deliver_the_same_frames._async_timeout \
    = 150


# -- the sidecar's answers -------------------------------------------------------

@pytest.mark.parametrize("matcher,mesh,bypass", [
    ("sig", "", True), ("sig", "", False), ("sig", "2x2", False),
    ("nfa", "", False), ("dense", "", False)])
async def test_sidecar_answers_two_workers_equal_to_the_trie(
        matcher, mesh, bypass, tmp_path):
    """The pool's sidecar (``_maybe_pool_matcher_service`` over
    ``_engine_factory`` on the CPU) fed ``mixed_100k``-shaped
    subscriptions as OP_SUB frames by two workers' service clients, each
    its own half: every OP_MATCH answer, to either worker, equals the CPU
    trie over both halves."""
    from maxmq_tpu_torch.matching.service import ServiceMatcher

    conf = t_config.Config(matcher=matcher, matcher_mesh=mesh,
                           matcher_max_batch=512)
    svc = await t_workers._maybe_pool_matcher_service(
        conf, str(tmp_path), device="cpu")
    assert svc.path == t_workers.matcher_sock(str(tmp_path))
    svc.matcher.cpu_bypass = bypass
    kit = chip_smoke.port_kit()
    slices, gen = chip_smoke.fed_corpus_slices(POOL_NODES, 3_000, 51)
    index = kit.TopicIndex()
    clients = []
    try:
        for node in POOL_NODES:
            c = ServiceMatcher(svc.path)
            await c.connect()
            for cid, sub in slices[node]:
                index.subscribe(cid, sub)
                c.forward_subscribe(cid, sub)
            clients.append(c)
        await asyncio.sleep(0)
        topics = gen(1_024, seed2=52)
        answers = await asyncio.gather(*(
            c.subscribers_batch_async(topics[i::2])
            for i, c in enumerate(clients)))
        served = [(t, a) for i, batch in enumerate(answers)
                  for t, a in zip(topics[i::2], batch)]
        assert len(served) == len(topics)
        assert svc.subs_applied == sum(map(len, slices.values()))
        matched = 0
        for topic, got in served:
            want = index.subscribers(topic)
            assert chip_smoke.same_answer(got, want), topic
            matched += bool(want.subscriptions or want.shared)
        assert matched > len(topics) // 4
        engine = svc.matcher.engine
        assert engine.index is svc.index
        if not bypass:
            assert svc.matcher.batches > 0 and not svc.matcher.bypasses
    finally:
        for c in clients:
            await c.close()
        await svc.close()


test_sidecar_answers_two_workers_equal_to_the_trie._async_timeout = 120


# -- F26: a worker's logger and event loop from the box's config ----------------

def test_worker_logs_as_the_box_config_says(monkeypatch, tmp_path):
    """A pool worker is spawned with no ``-c``: its config comes from
    ``MAXMQ_POOL_CONF``. The reference's ``start`` builds the worker's
    logger and event loop from the config it searches for instead, so its
    workers log at the default format and level whatever the box's config
    says (F26); the port's ``start`` takes both from the box's config."""
    from maxmq_tpu import cli as j_cli
    from maxmq_tpu_torch import bootstrap as t_boot
    from maxmq_tpu_torch import cli as t_cli

    box = dict(dataclasses.asdict(t_config.Config()), log_format="json",
               log_level="error", broker_event_loop="asyncio")
    monkeypatch.setenv("MAXMQ_WORKER_ID", "1")
    monkeypatch.setenv("MAXMQ_POOL_CONF", json.dumps(box))
    monkeypatch.chdir(tmp_path)         # no maxmq.conf to find
    got = {}

    def runner(name):
        async def run_server(conf, logger, **_kw):
            got[name] = (logger._fmt, conf.log_format)
        return run_server

    monkeypatch.setattr(j_cli, "run_server", runner("ref"))
    monkeypatch.setattr(t_boot, "run_server", runner("port"))
    # the reference's ``start`` ends the process at once (``os._exit``)
    # where a JAX backend was initialised, as other tests of this process
    # may have done
    xla_bridge = sys.modules.get("jax._src.xla_bridge")
    if xla_bridge is not None:
        monkeypatch.setattr(xla_bridge, "_backends", {}, raising=False)
    try:
        assert j_cli.main(["start", "--no-banner"]) == 0
        assert t_cli.main(["start", "--no-banner", "--device", "cpu"]) == 0
    finally:
        asyncio.set_event_loop_policy(None)
    assert got["ref"] == ("pretty", "pretty")
    assert got["port"] == ("json", "json")


# -- F27: the sidecar's tables catch up off the match path ----------------------

async def test_sidecar_tables_catch_up_without_a_match(tmp_path,
                                                      monkeypatch):
    """A worker's reseed (OP_SUB frames at its ``on_started``) fills the
    sidecar's index. The reference's sidecar compiles it only at the
    first match after that, and that match waits on the compile (its
    engine's tables still hold none of the subscriptions after the port's
    have caught up); the port's service starts the refresh as the ops
    arrive, again for the ops that arrive while one compiles, and its
    engine warms its buckets again after the rotation (F27). No match was made; the answers after it are the trie's in
    both."""
    from maxmq_tpu.matching.service import ServiceMatcher as JServiceMatcher
    from maxmq_tpu_torch.matching.service import ServiceMatcher

    slices, gen = chip_smoke.fed_corpus_slices(POOL_NODES, 2_000, 61)
    subs = slices["w0"] + slices["w1"]
    index = chip_smoke.port_kit().TopicIndex()
    for cid, sub in subs:
        index.subscribe(cid, sub)
    topics = gen(256, seed2=62)
    pkgs = {"port": (t_workers, t_config, ServiceMatcher, {"device": "cpu"}),
            "ref": (j_workers, j_config, JServiceMatcher, {})}
    svcs, clients, waited = {}, {}, 0.0
    try:
        for name, (mod, cmod, client_cls, kw) in pkgs.items():
            conf = cmod.Config(matcher="sig", matcher_max_batch=256)
            os.makedirs(tmp_path / name)
            svcs[name] = svc = await mod._maybe_pool_matcher_service(
                conf, str(tmp_path / name), **kw)
            clients[name] = c = client_cls(svc.path)
            await c.connect()
        port_engine = svcs["port"].matcher.engine
        assert port_engine._warm_max == 256
        # the second half arrives while the refresh the first half
        # started is under way (its compile held 0.5 s after it read the
        # index): the second half must follow with no match
        from maxmq_tpu_torch.matching import sig as t_sig
        compile_sig = t_sig.compile_sig

        def slow_compile(*a, **kw):
            tables = compile_sig(*a, **kw)
            time.sleep(0.5)
            return tables

        monkeypatch.setattr(t_sig, "compile_sig", slow_compile)
        half = len(subs) // 2
        for part in (subs[:half], subs[half:]):
            for c in clients.values():
                for cid, sub in part:
                    c.forward_subscribe(cid, sub)
            await asyncio.sleep(0.2)
        assert port_engine._bg_thread.is_alive()

        def caught_up(engine, svc) -> bool:
            return (svc.subs_applied == len(subs)
                    and engine.tables.version == svc.index.sub_version)

        t0 = asyncio.get_running_loop().time()
        await WORKERS.poll_until(
            lambda: caught_up(port_engine, svcs["port"])
            and not any(t is not None and t.is_alive() for t in (
                port_engine._bg_thread, port_engine._warm_thread)),
            timeout=60, what="the port's sidecar tables")
        waited = asyncio.get_running_loop().time() - t0
        await asyncio.sleep(max(1.0, waited))
        ref_engine = svcs["ref"].matcher.engine
        assert svcs["ref"].subs_applied == len(subs)
        assert ref_engine.tables.version != svcs["ref"].index.sub_version
        for name, svc in svcs.items():
            assert svc.matcher.engine.matches == 0, name
            assert svc.matcher.batches == 0, name
        for name, c in clients.items():
            got = await asyncio.gather(*(c.subscribers_async(t)
                                         for t in topics))
            assert all(chip_smoke.same_answer(g, index.subscribers(t))
                       for t, g in zip(topics, got)), name
        assert ref_engine.tables.version == svcs["ref"].index.sub_version \
            or ref_engine._bg_thread is not None
    finally:
        for c in clients.values():
            await c.close()
        for svc in svcs.values():
            await svc.close()
            svc.matcher.engine.close()


test_sidecar_tables_catch_up_without_a_match._async_timeout = 150


# -- F28, F29: what a pool's answers depend on (the reference's too) -------------

PKGS = {"port": (t_workers, t_config, {"device": "cpu"}),
        "ref": (j_workers, j_config, {})}


async def session_present_at_w1(pkg: str, db: str, link_dir: str) -> bool:
    """A pool over store ``db`` (w0 restores it); client ``p1`` resumes
    through w1 once the links are up and w0's resync had time to land."""
    from maxmq_tpu_torch.mqtt_client import MQTTClient

    mod, cmod, kw = PKGS[pkg]
    conf = cmod.Config(storage_backend="sqlite", storage_path=db)
    async with mod.inprocess_pool(2, link_dir=link_dir, conf=conf,
                                  **kw) as (brokers, ports):
        with contextlib.suppress(TimeoutError):
            await WORKERS.poll_until(
                lambda: "p1" in brokers[1].cluster.sessions.ledger,
                timeout=2.0, what="p1 in w1's ledger")
        c = MQTTClient("p1", version=5, clean_start=False,
                       session_expiry=600)
        await c.connect("127.0.0.1", ports[1])
        present = c.session_present
        await c.disconnect()
        return present


@pytest.mark.parametrize("ledger_rows", [False, True])
async def test_restored_session_without_a_ledger_row_is_not_federated(
        ledger_rows, tmp_path):
    """F28: a store written without the cluster session ledger's rows (a
    single broker's, before ``workers = 2``) restores its sessions at w0,
    but w0 neither enters them in its ledger nor resyncs them to w1, so a
    client that SO_REUSEPORT hands to w1 gets a fresh session (the one at
    w0, with its queued messages, stays). With each session's ledger row
    in the store, the session resumes at w1. The same in both packages."""
    kit = chip_smoke.port_kit()
    base = str(tmp_path / "base.db")
    chip_smoke.write_corpus_store(
        base, [("p1", 5, [kit.Subscription(filter="f28/#", qos=1)])],
        owner="w0" if ledger_rows else "")
    got = {}
    for pkg in PKGS:
        db = str(tmp_path / f"{pkg}.db")
        with open(base, "rb") as f, open(db, "wb") as g:
            g.write(f.read())
        got[pkg] = await session_present_at_w1(pkg, db,
                                               str(tmp_path / pkg))
    assert got == {"port": ledger_rows, "ref": ledger_rows}


test_restored_session_without_a_ledger_row_is_not_federated._async_timeout \
    = 60


async def share_counts(pkg: str, link_dir: str, members: dict) -> dict:
    """Six publishes through w0 to ``$share/g/f29/t``, whose members are
    each on its worker of ``members`` (client id -> worker index):
    deliveries per member."""
    from maxmq_tpu_torch.mqtt_client import MQTTClient

    mod, cmod, kw = PKGS[pkg]
    async with mod.inprocess_pool(2, link_dir=link_dir, conf=cmod.Config(),
                                  **kw) as (brokers, ports):
        clients = {}
        for cid, w in members.items():
            c = clients[cid] = MQTTClient(cid)
            await c.connect("127.0.0.1", ports[w])
            await c.subscribe("$share/g/f29/t", qos=0)
        await WORKERS.poll_until(lambda: share_ledgers_agree(brokers)
                                 and len(brokers[0].cluster.routes.shares
                                         ._members) == 1
                                 and len(next(iter(
                                     brokers[0].cluster.routes.shares
                                     ._members.values()))) == 2,
                                 what="the share ledgers")
        await mod.await_routes(brokers[0], "f29/t")
        pub = MQTTClient("f29-pub")
        await pub.connect("127.0.0.1", ports[0])
        for i in range(6):
            await pub.publish("f29/t", b"%d" % i)
        await asyncio.sleep(0.5)
        out = {cid: c.messages.qsize() for cid, c in clients.items()}
        for c in (*clients.values(), pub):
            await c.disconnect()
        return out


async def test_share_picks_follow_the_members_workers(tmp_path):
    """F29: which member of a ``$share`` group receives a publish depends
    on the workers the members sit on: the share ledger splits the picks
    between the workers holding members (``cluster_share_balance``, the
    default ``weighted``), and each worker picks among its own members.
    So the frames of a pool's ``$share`` members depend on SO_REUSEPORT
    placement: the same two members swap their counts when they swap
    workers. In both packages alike."""
    got = {}
    for pkg in PKGS:
        for k, members in enumerate(({"m0": 0, "m1": 1},
                                     {"m0": 1, "m1": 0})):
            got[pkg, k] = await share_counts(pkg, str(tmp_path / f"{pkg}{k}"),
                                             members)
    assert got["port", 0] == got["ref", 0]
    assert got["port", 1] == got["ref", 1]
    a, b = got["port", 0], got["port", 1]
    assert a != b and (a["m0"], a["m1"]) == (b["m1"], b["m0"])
    assert sum(a.values()) == 6


test_share_picks_follow_the_members_workers._async_timeout = 60


def test_worker_start_leaves_the_card_alone(monkeypatch, tmp_path):
    """A pool worker's ``start`` takes its ``--device`` from the parent
    and never asks CUDA (which opens the card in the process): the
    parent's sidecar is the one process of the box on the card. Without
    ``MAXMQ_WORKER_ID`` the same command probes as before."""
    import torch

    from maxmq_tpu_torch import bootstrap as t_boot
    from maxmq_tpu_torch import cli as t_cli

    probes = []
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: probes.append(1) or False)
    got = []

    async def run_server(conf, logger, device=None, **_kw):
        got.append(device)

    monkeypatch.setattr(t_boot, "run_server", run_server)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MAXMQ_WORKER_ID", "1")
    monkeypatch.setenv("MAXMQ_POOL_CONF", json.dumps(
        dataclasses.asdict(t_config.Config())))
    try:
        assert t_cli.main(["start", "--no-banner", "--device", "cuda"]) == 0
        assert (got, probes) == (["cuda"], [])
        monkeypatch.delenv("MAXMQ_WORKER_ID")
        assert t_cli.main(["start", "--no-banner", "--device", "cuda"]) == 2
        assert probes
    finally:
        asyncio.set_event_loop_policy(None)
