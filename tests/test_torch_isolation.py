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
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imports(f) if _forbidden(m)]
    assert not bad, bad


def test_subprocess_import_leaves_jax_out():
    """Import every module of the package in a fresh interpreter, build a
    SigEngine and a MatcherService on the CPU, match once, and check
    sys.modules."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PACKAGE.rglob("*.py") if p.name != "__main__.py")
    script = textwrap.dedent(f"""
        import asyncio, importlib, os, sys, tempfile
        for m in {modules!r}:
            importlib.import_module(m)
        from maxmq_tpu_torch.matching.service import MatcherService
        from maxmq_tpu_torch.matching.sig import SigEngine
        from maxmq_tpu_torch.matching.trie import TopicIndex
        from maxmq_tpu_torch.protocol import Subscription

        idx = TopicIndex()
        idx.subscribe("c1", Subscription(filter="a/#"))
        engine = SigEngine(idx, device="cpu")
        engine.route_small = False
        assert list(engine.subscribers_fixed_batch(["a/b"])[0]
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
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


def test_entry_points_refuse_without_cuda(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idx = TopicIndex()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SigEngine(idx)
    with pytest.raises(RuntimeError):
        SigEngine(idx, device="cuda")
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
