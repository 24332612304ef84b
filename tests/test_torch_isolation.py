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
        ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_cluster_cards.py"]
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
