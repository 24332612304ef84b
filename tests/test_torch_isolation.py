"""The port stands alone: maxmq_tpu_torch and chip_smoke.py import neither
JAX nor anything of the JAX package (maxmq_tpu), and its entry points run
on the CPU only when asked to."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from maxmq_tpu_torch import cli
from maxmq_tpu_torch.matching.dense import DenseEngine
from maxmq_tpu_torch.matching.engine import NFAEngine
from maxmq_tpu_torch.matching.sig import SigEngine, resolve_device
from maxmq_tpu_torch.matching.trie import TopicIndex

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "maxmq_tpu_torch"


def _forbidden(module: str) -> bool:
    """jax, jaxlib & co, and the JAX package — matched exactly: the port's
    own name starts with 'maxmq_tpu' too."""
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or module == "maxmq_tpu" \
        or module.startswith("maxmq_tpu.")


def test_forbidden_matches_exact_names():
    assert _forbidden("maxmq_tpu") and _forbidden("maxmq_tpu.native")
    assert _forbidden("jax.numpy") and _forbidden("jax")
    assert not _forbidden("maxmq_tpu_torch.matching.sig")
    assert not _forbidden("jaxtyping_like")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_ast_scan_finds_no_forbidden_import():
    files = sorted(PACKAGE.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_cluster_cards.py",
        ROOT / "scripts" / "torch_broker_fleet.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imports(f) if _forbidden(m)]
    assert not bad, bad


def test_subprocess_import_leaves_jax_out():
    """Import every module of the package in a fresh interpreter, build a
    SigEngine, a DenseEngine (kernel route), an NFAEngine, both sharded
    engines (on a mesh of CPU devices) and a MatcherService on the CPU,
    match once, and check sys.modules and the mapped native libraries
    (the port's own, built from its sources; none of ``native/``)."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PACKAGE.rglob("*.py") if p.name != "__main__.py")
    script = textwrap.dedent(f"""
        import asyncio, importlib, os, sys, tempfile
        for m in {modules!r}:
            importlib.import_module(m)
        from maxmq_tpu_torch.matching.dense import DenseEngine
        from maxmq_tpu_torch.matching.engine import NFAEngine
        from maxmq_tpu_torch.matching.service import MatcherService
        from maxmq_tpu_torch.matching.sig import SigEngine
        from maxmq_tpu_torch.matching.trie import TopicIndex
        from maxmq_tpu_torch.parallel.sharded import (
            ShardedNFAEngine, ShardedSigEngine, make_mesh)
        from maxmq_tpu_torch.protocol import Subscription

        idx = TopicIndex()
        idx.subscribe("c1", Subscription(filter="a/#"))
        engine = SigEngine(idx, device="cpu")
        engine.route_small = False
        assert list(engine.subscribers_fixed_batch(["a/b"])[0]
                    .subscriptions) == ["c1"]
        dense = DenseEngine(idx, device="cpu")
        assert list(dense.subscribers("a/b").subscriptions) == ["c1"]
        nfa = NFAEngine(idx, device="cpu")
        assert list(nfa.subscribers("a/b").subscriptions) == ["c1"]
        mesh = make_mesh((2, 2), devices=["cpu"] * 4)
        for cls in (ShardedSigEngine, ShardedNFAEngine):
            assert list(cls(idx, mesh=mesh).subscribers("a/b")
                        .subscriptions) == ["c1"]

        async def serve():
            path = os.path.join(tempfile.mkdtemp(), "m.sock")
            svc = MatcherService(path, device="cpu")
            await svc.start()
            await svc.close()
        asyncio.run(serve())
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib")
                     or m == "maxmq_tpu" or m.startswith("maxmq_tpu."))
        print("FORBIDDEN", bad)
        # native libraries: the port's own, never the JAX package's
        from maxmq_tpu_torch import native
        with open("/proc/self/maps") as f:
            maps = f.read()
        ref_dir = os.path.join({str(ROOT)!r}, "native") + os.sep
        print("REF_NATIVE", sorted(set(line.split()[-1] for line in
                                       maps.splitlines()
                                       if ref_dir in line)))
        print("PORT_NATIVE", all(str(native.library_path(s)) in maps
                                 for s in native.SOURCES))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout
    assert "REF_NATIVE []" in proc.stdout, proc.stdout
    assert "PORT_NATIVE True" in proc.stdout, proc.stdout


def test_entry_points_refuse_without_cuda(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idx = TopicIndex()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SigEngine(idx)
    with pytest.raises(RuntimeError):
        SigEngine(idx, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DenseEngine(idx)
    with pytest.raises(RuntimeError):
        DenseEngine(idx, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NFAEngine(idx)
    with pytest.raises(RuntimeError):
        NFAEngine(idx, device="cuda")
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    rc = cli.main(["matcher-service", "--socket", str(tmp_path / "m.sock")])
    assert rc == 2
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "m.sock").exists()


def test_cli_version(capsys):
    assert cli.main(["version"]) == 0
    assert "maxmq-tpu-torch" in capsys.readouterr().out


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card (or alone, without the package) the smoke script
    exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run in full")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


LEAF_MODULES = (
    "utils.logger", "utils.snowflake", "utils.build", "utils.config",
    "filtering.expr", "filtering.columnar", "filtering.window", "metrics",
    "trace", "hooks.base", "hooks.auth", "hooks.logging", "broker.inflight",
    "broker.overload", "broker.sys_info")


def test_leaf_modules_stand_alone():
    """The broker engine's leaf modules exist in the port, are in the AST
    scan's reach, and run in a fresh interpreter (the torch content
    evaluator on the CPU, a tracer, a metrics server, hooks, the config
    loader) without JAX or the JAX package being imported."""
    for m in LEAF_MODULES:
        assert (PACKAGE / (m.replace(".", "/") + ".py")).is_file(), m
    script = textwrap.dedent(f"""
        import importlib, sys, urllib.request
        for m in {LEAF_MODULES!r}:
            importlib.import_module("maxmq_tpu_torch." + m)
        from maxmq_tpu_torch.filtering import ColumnarEvaluator, compile_expr
        from maxmq_tpu_torch.filtering.columnar import build_columns
        from maxmq_tpu_torch.hooks import AllowHook, Hooks
        from maxmq_tpu_torch.metrics import (MetricsServer, Registry,
                                             _register_trace_metrics)
        from maxmq_tpu_torch.trace import PipelineTracer
        from maxmq_tpu_torch.utils.config import load_config

        p = compile_expr("payload.t>1")
        ev = ColumnarEvaluator(backend="torch", device="cpu")
        cols = build_columns([{{"t": 2}}, {{"t": 0}}], p.fields)
        assert ev.eval_batch([p.program], cols, 2).tolist() == [[True, False]]
        assert ev.device_fallbacks == 0
        tracer = PipelineTracer(sample_n=1)
        tr = tracer.sample("a", 0, "c")
        tracer.finish(tr)
        reg = Registry()
        _register_trace_metrics(reg, type("O", (), {{"tracer": tracer}}))
        srv = MetricsServer("127.0.0.1:0", reg, tracer=tracer)
        srv.start()
        url = f"http://127.0.0.1:{{srv.bound_port}}/traces"
        assert b'"sampled": 1' in urllib.request.urlopen(url).read()
        srv.stop()
        hs = Hooks()
        hs.add(AllowHook())
        assert hs.any_allow("on_acl_check", None, "t", True)
        assert load_config(env={{}}).filter_backend == "numpy"
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib")
                     or m == "maxmq_tpu" or m.startswith("maxmq_tpu."))
        print("FORBIDDEN", bad)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


BROKER_LEAVES = ("mqtt_client", "broker.listeners", "broker.client",
                 "hooks.storage", "faults")


def test_broker_leaves_and_sig_surfaces_stand_alone(tmp_path):
    """The broker's last leaves and the signature engine's word and
    compact surfaces run in a fresh interpreter (a MockListener session
    through an MQTTClient, a SQLite storage hook, a crash point with its
    kill action swapped, the word and compact batches on the CPU) without
    JAX or the JAX package being imported."""
    for m in BROKER_LEAVES:
        assert (PACKAGE / (m.replace(".", "/") + ".py")).is_file(), m
    db = str(tmp_path / "s.db")
    script = textwrap.dedent(f"""
        import asyncio, importlib, sys
        for m in {BROKER_LEAVES!r}:
            importlib.import_module("maxmq_tpu_torch." + m)
        from maxmq_tpu_torch import faults
        from maxmq_tpu_torch.broker import MockListener
        from maxmq_tpu_torch.hooks import SQLiteStore, StorageHook
        from maxmq_tpu_torch.hooks.storage import SubscriptionRecord
        from maxmq_tpu_torch.matching.sig import SigEngine
        from maxmq_tpu_torch.matching.trie import TopicIndex
        from maxmq_tpu_torch.mqtt_client import MQTTClient
        from maxmq_tpu_torch.protocol import Subscription

        async def session():
            lst = MockListener()

            async def establish(lid, reader, writer):
                await reader.read(100)
                writer.write(b"\\x20\\x02\\x00\\x00")
            await lst.serve(establish)
            r, w = await lst.connect()
            c = MQTTClient("x")
            ack = await c.connect(reader=r, writer=w)
            await c.close()
            return ack.reason_code
        assert asyncio.run(session()) == 0
        hook = StorageHook(SQLiteStore({db!r}))
        hook.store.put("subscriptions", "c|a",
                       SubscriptionRecord("c", "a").to_json())
        assert [s.filter for s in hook.stored_subscriptions()] == ["a"]
        hook.stop()
        killed = []
        faults.REGISTRY.kill_fn = lambda: killed.append(1)
        faults.arm(faults.CRASH_AT + "#pre_fsync", "kill", 1)
        faults.crash_point("pre_fsync")
        assert killed == [1]
        idx = TopicIndex()
        idx.subscribe("c1", Subscription(filter="a/#"))
        engine = SigEngine(idx, device="cpu")
        engine.route_small = False
        for fn in (engine.subscribers_batch,
                   engine.subscribers_compact_batch):
            assert list(fn(["a/b"])[0].subscriptions) == ["c1"]
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib")
                     or m == "maxmq_tpu" or m.startswith("maxmq_tpu."))
        print("FORBIDDEN", bad)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


ENGINE_MODULES = ("broker.server", "filtering.plane", "bootstrap")


def test_broker_engine_stands_alone():
    """The broker engine, its content plane and the matcher boot exist in
    the port, are in the AST scan's reach, and run in a fresh interpreter
    (a broker with ``build_matcher``'s supervised signature stack on the
    CPU, a predicate subscription, a publish round trip over TCP) without
    JAX or the JAX package being imported."""
    for m in ENGINE_MODULES:
        assert (PACKAGE / (m.replace(".", "/") + ".py")).is_file(), m
    script = textwrap.dedent(f"""
        import asyncio, importlib, sys
        for m in {ENGINE_MODULES!r}:
            importlib.import_module("maxmq_tpu_torch." + m)
        from maxmq_tpu_torch.bootstrap import (build_matcher,
                                               capabilities_from_config)
        from maxmq_tpu_torch.broker import Broker, BrokerOptions, TCPListener
        from maxmq_tpu_torch.hooks import AllowHook
        from maxmq_tpu_torch.mqtt_client import MQTTClient
        from maxmq_tpu_torch.utils.config import Config

        async def main():
            conf = Config()
            conf.mqtt_sys_topic_interval = 0
            conf.filter_backend = "torch"
            b = Broker(BrokerOptions(
                capabilities=capabilities_from_config(conf), device="cpu"))
            b.add_hook(AllowHook())
            build_matcher(conf, b, device="cpu")
            lst = b.add_listener(TCPListener("t", "127.0.0.1:0"))
            await b.serve()
            port = lst._server.sockets[0].getsockname()[1]
            c = MQTTClient(client_id="c")
            await c.connect("127.0.0.1", port)
            await c.subscribe("a/+?$expr=payload.t>1")
            await c.subscribe("b/#")
            await c.publish("a/x", b'{{"t": 0}}')
            await c.publish("a/y", b'{{"t": 2}}')
            await c.publish("b/z", b"plain")
            got = [(await c.next_message(timeout=10)).topic
                   for _ in range(2)]
            assert got == ["a/y", "b/z"], got
            assert b.content.evaluator.device_fallbacks == 0
            await c.disconnect()
            await b.close()
            await b.matcher.close()
        asyncio.run(main())
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib")
                     or m == "maxmq_tpu" or m.startswith("maxmq_tpu."))
        print("FORBIDDEN", bad)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


START_MODULES = ("hooks.journal", "hooks.faultstore", "bootstrap", "cli",
                 "metrics", "matching.service")


def test_start_path_stands_alone(tmp_path):
    """The start path's modules exist in the port, are in the AST scan's
    reach, and ``python -m maxmq_tpu_torch start --device cpu`` (a SQLite
    journal under ``storage_sync = "always"``, the signature matcher, the
    metrics server) serves a client and stops on SIGTERM without JAX or
    the JAX package in its interpreter."""
    import signal
    import socket
    import time

    for m in START_MODULES:
        assert (PACKAGE / (m.replace(".", "/") + ".py")).is_file(), m
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    conf = tmp_path / "c.toml"
    conf.write_text(f'mqtt_tcp_address = "127.0.0.1:{ports[0]}"\n'
                    f'metrics_address = "127.0.0.1:{ports[1]}"\n'
                    'matcher = "sig"\nmqtt_sys_topic_interval = 0\n'
                    'storage_backend = "sqlite"\nstorage_sync = "always"\n'
                    f'storage_path = "{tmp_path / "s.db"}"\n')
    script = textwrap.dedent(f"""
        import atexit, runpy, sys

        def forbidden():
            bad = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib")
                         or m == "maxmq_tpu" or m.startswith("maxmq_tpu."))
            print("FORBIDDEN", bad, flush=True)
        atexit.register(forbidden)
        sys.argv = ["maxmq_tpu_torch", "start", "-c", {str(conf)!r},
                    "--no-banner", "--device", "cpu"]
        runpy.run_module("maxmq_tpu_torch", run_name="__main__")
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith("MAXMQ_")}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen([sys.executable, "-c", script], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 90
        while True:
            assert proc.poll() is None, proc.communicate(timeout=10)
            try:
                with socket.create_connection(("127.0.0.1", ports[0]), 1):
                    break
            except OSError:
                assert time.monotonic() < deadline, "never accepted"
                time.sleep(0.1)
        with socket.create_connection(("127.0.0.1", ports[0]), 5) as s:
            s.sendall(bytes.fromhex("100e00044d5154540402003c000269"
                                    "73"))          # CONNECT, id "is"
            assert s.recv(4) == b"\x20\x02\x00\x00"   # CONNACK accepted
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err[-2000:]
    assert "FORBIDDEN []" in out, (out, err[-2000:])


CLUSTER_MODULES = ("__init__", "membership", "routes", "bridge", "telemetry",
                   "manager", "sessions")


def test_cluster_package_stands_alone():
    """The cluster federation's modules exist in the port, are in the AST
    scan's reach, and two port brokers federate in a fresh interpreter
    with their federated sessions on (a publish crosses the bridge link,
    and the subscriber's session is taken over at the other node) without
    JAX or the JAX package being imported."""
    for m in CLUSTER_MODULES:
        path = PACKAGE / "cluster" / f"{m}.py"
        assert path.is_file(), m
        assert not [i for i in _imports(path) if _forbidden(i)], m
    script = textwrap.dedent("""
        import asyncio, sys
        from maxmq_tpu_torch.broker import (Broker, BrokerOptions,
                                            Capabilities, TCPListener)
        from maxmq_tpu_torch.cluster import ClusterManager, PeerSpec
        from maxmq_tpu_torch.hooks import AllowHook
        from maxmq_tpu_torch.mqtt_client import MQTTClient

        async def main():
            brokers, ports = {}, {}
            for n in "AB":
                b = Broker(BrokerOptions(
                    capabilities=Capabilities(sys_topic_interval=0),
                    device="cpu"))
                b.add_hook(AllowHook())
                lst = b.add_listener(TCPListener("t", "127.0.0.1:0"))
                await b.serve()
                brokers[n] = b
                ports[n] = lst._server.sockets[0].getsockname()[1]
            for n, p in (("A", "B"), ("B", "A")):
                mgr = ClusterManager(
                    brokers[n], n, [PeerSpec(p, "127.0.0.1", ports[p])],
                    backoff_initial_s=0.05)
                brokers[n].attach_cluster(mgr)
                await mgr.start()
            sub = MQTTClient(client_id="s", clean_start=False)
            await sub.connect("127.0.0.1", ports["B"])
            await sub.subscribe("iso/#")
            for _ in range(400):
                if brokers["A"].cluster.routes.nodes_for("iso/x"):
                    break
                await asyncio.sleep(0.025)
            pub = MQTTClient(client_id="p")
            await pub.connect("127.0.0.1", ports["A"])
            await pub.publish("iso/x", b"ok")
            print("GOT", (await sub.next_message(timeout=10)).payload)
            await sub.disconnect()
            for _ in range(400):
                if "s" in brokers["B"].cluster.sessions.ledger:
                    break
                await asyncio.sleep(0.025)
            again = MQTTClient(client_id="s", clean_start=False)
            await again.connect("127.0.0.1", ports["A"])
            print("PRESENT", again.connack.session_present,
                  brokers["A"].cluster.sessions.takeovers)
            await again.disconnect()
            for b in brokers.values():
                await b.close()

        asyncio.run(main())
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib")
                     or m == "maxmq_tpu" or m.startswith("maxmq_tpu."))
        print("FORBIDDEN", bad)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "GOT b'ok'" in proc.stdout, proc.stdout
    assert "PRESENT True 1" in proc.stdout, proc.stdout
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


def test_started_pool_stands_alone(tmp_path):
    """``broker/workers.py`` in a started pool: ``python -m
    maxmq_tpu_torch start --device cpu`` with ``workers = 2`` and the
    ``sig`` sidecar. The parent and each worker write their ``sys.modules``
    at exit (a ``sitecustomize`` on their path): neither JAX nor the JAX
    package in any of the three, and the pool module in each."""
    import asyncio
    import json
    import signal
    import time

    import chip_smoke
    from maxmq_tpu_torch.mqtt_client import MQTTClient

    site, dumps = tmp_path / "site", tmp_path / "dumps"
    site.mkdir()
    dumps.mkdir()
    (site / "sitecustomize.py").write_text(textwrap.dedent(f"""
        import atexit, json, os, sys

        def _dump():
            if "maxmq_tpu_torch" not in sys.modules:
                return
            bad = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib")
                         or m == "maxmq_tpu" or m.startswith("maxmq_tpu."))
            with open(os.path.join({str(dumps)!r}, f"{{os.getpid()}}.json"),
                      "w") as f:
                json.dump({{"forbidden": bad,
                           "worker": os.environ.get("MAXMQ_WORKER_ID"),
                           "pool": "maxmq_tpu_torch.broker.workers"
                                   in sys.modules}}, f)

        atexit.register(_dump)
    """))
    port = chip_smoke.free_port()
    conf = tmp_path / "c.toml"
    conf.write_text(f'mqtt_tcp_address = "127.0.0.1:{port}"\n'
                    f'metrics_address = "127.0.0.1:{chip_smoke.free_port()}"\n'
                    'mqtt_sys_topic_interval = 0\nlog_format = "json"\n'
                    'workers = 2\nmatcher = "sig"\n'
                    f'worker_link_dir = "{tmp_path / "mesh"}"\n')
    env = {k: v for k, v in os.environ.items() if not k.startswith("MAXMQ_")}
    env["PYTHONPATH"] = os.pathsep.join((str(site), str(ROOT)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "maxmq_tpu_torch", "start", "-c", str(conf),
         "--no-banner", "--device", "cpu"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    async def drive() -> None:
        deadline = time.monotonic() + 90
        while len(chip_smoke.tcp_inodes(port)) < 2:
            assert proc.poll() is None and time.monotonic() < deadline
            await asyncio.sleep(0.1)
        sub = MQTTClient(client_id="iso-sub")
        await sub.connect("127.0.0.1", port)
        await sub.subscribe("iso/#")
        pub = MQTTClient(client_id="iso-pub")
        await pub.connect("127.0.0.1", port)
        while True:
            await pub.publish("iso/x", b"ok")
            try:
                assert (await sub.next_message(timeout=0.5)).payload == b"ok"
                break
            except asyncio.TimeoutError:
                assert time.monotonic() < deadline, "no delivery"
        for c in (sub, pub):
            await c.disconnect()

    try:
        asyncio.run(drive())
        proc.send_signal(signal.SIGTERM)
        _out, err = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err[-2000:]
    got = sorted((json.loads(p.read_text()) for p in dumps.glob("*.json")),
                 key=lambda d: d["worker"] or "")
    assert [d["worker"] for d in got] == [None, "0", "1"], got
    assert all(d["forbidden"] == [] and d["pool"] for d in got), got
