"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library
with a plain C interface, loaded with ``ctypes``; no PyTorch headers are
involved, so a build takes seconds. Sources compile in parallel, one
``nvcc`` each. Libraries go to ``build/maxmq_tpu_torch/`` at the root of
the checkout at first use, named by a hash of source and flags, so an
edited source rebuilds and an unchanged one loads as is.

Nothing here runs at import: the CPU tests import every module of the
package on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "maxmq_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of each library's exported functions: name -> (restype,
# argtypes). Pointers and the stream are c_void_p (a bare Python int
# would be passed as a 32-bit int and cut the pointer).
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "sig_match": {
        "sig_match_fixed_launch": (
            _I, [_P, _I, _P, _P, _P, _LL, _I, _P, _LL, _I, _I, _I, _P, _P,
                 _P]),
        "sig_match_error_string": (ctypes.c_char_p, [_I]),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per-source build record of the last build in this process: seconds and
# the ptxas resource summary (registers, shared memory, spills)
build_log: dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only where the CUDA toolkit "
                       "is installed")


def _target(name: str) -> Path:
    src = (SOURCE_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _compile(name: str) -> Path:
    out = _target(name)
    if out.exists():
        build_log[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cu")],
        capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    ptxas = "\n".join(line for line in proc.stderr.splitlines()
                      if "ptxas" in line or "spill" in line)
    build_log[name] = {"seconds": seconds, "cached": False, "ptxas": ptxas}
    return out


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile (in parallel, one nvcc per source) and load every kernel
    library not loaded yet; returns name -> library."""
    with _lock:
        todo = [n for n in SIGNATURES if n not in _libs]
        if todo:
            with ThreadPoolExecutor(max_workers=len(todo)) as pool:
                paths = list(pool.map(_compile, todo))
            for name, path in zip(todo, paths):
                _libs[name] = _load(name, path)
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib
