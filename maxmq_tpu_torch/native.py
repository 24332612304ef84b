"""The native host runtime: ctypes bindings for the C++ tokenizer, probes
and frame scanner (``csrc/host/maxmq_torch_native.cpp``) and the loader of
the C verify + union decode extension (``csrc/host/maxmq_torch_decode.cpp``).

Copy of the JAX package's ``native.py`` over the port's own copies of its
sources. Each source is built with ``g++`` at first use into
``build/maxmq_tpu_torch/`` at the root of the checkout, named by a hash of
source, flags and interpreter, so an edited source rebuilds and an
unchanged one loads as is; a build writes a temp file and renames it, so
processes building at once never load a half-written library. The decode
extension needs ``Python.h``; the tokenizer library does not.

Exposes:

* ``NativeVocab`` / ``tokenize`` — the batch topic tokenizer; exact
  drop-in for ``matching/topics.py:tokenize_topics``.
* ``ExactSigTable`` / ``tokenize_sig``, ``NativeProbe`` /
  ``tokenize_probe`` — the compact tokenizer with the host-exact
  signature, and the exact / '+' / '#' host probes, fused or apart.
* ``scan_frames`` — the MQTT fixed-header frame scanner.
* ``decode_module`` — the ``maxmq_torch_decode`` CPython extension.
* ``refdecode`` — the spec-derived reference MQTT decoder
  (``csrc/host/maxmq_torch_refdecode.cpp``, a C ABI): a test oracle for
  the codec, loaded by nothing on the publish path.

Everything degrades gracefully: ``available()`` is False when the library
cannot be built or loaded (or ``MAXMQ_NO_NATIVE`` is set) and callers
take the Python paths; ``build_errors`` says why a build failed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
import time

import numpy as np

from .kernels import BUILD_DIR, PACKAGE_DIR

SOURCE_DIR = PACKAGE_DIR / "csrc" / "host"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-pthread",
            "-shared")
# source stem -> (library stem, needs Python.h)
SOURCES = {"maxmq_torch_native": ("libmaxmq_torch_native", False),
           "maxmq_torch_decode": ("maxmq_torch_decode", True)}
# the codec's test oracle: built the same way, on demand (``refdecode``),
# never by ``build_all`` (it is no part of the runtime)
ORACLE_SOURCES = {"maxmq_torch_refdecode": ("libmaxmq_torch_refdecode",
                                            False)}
_ALL_SOURCES = {**SOURCES, **ORACLE_SOURCES}

_lib = None
_load_lock = threading.Lock()
_load_attempted = False
# per-source record of the last build in this process (seconds, cached)
build_log: dict[str, dict] = {}
# per-source reason the last build or load failed
build_errors: dict[str, str] = {}


def disabled() -> bool:
    """``MAXMQ_NO_NATIVE`` selects the Python paths."""
    return bool(os.environ.get("MAXMQ_NO_NATIVE"))


def compiler() -> str | None:
    """The ``g++`` the runtime builds with, or None."""
    return shutil.which("g++")


def python_include() -> str | None:
    """The directory holding this interpreter's ``Python.h``, or None."""
    inc = sysconfig.get_paths().get("include")
    if inc and os.path.exists(os.path.join(inc, "Python.h")):
        return inc
    return None


def _flags(source: str) -> list[str]:
    flags = list(CXXFLAGS)
    if _ALL_SOURCES[source][1]:
        inc = python_include()
        if inc is None:
            raise RuntimeError("Python.h not found: the decode extension "
                               "builds only where the Python headers are "
                               "installed")
        flags.append(f"-I{inc}")
    return flags


def library_path(source: str):
    """The shared library that ``csrc/host/<source>.cpp`` builds to
    (built or not)."""
    stem, is_ext = _ALL_SOURCES[source]
    src = (SOURCE_DIR / f"{source}.cpp").read_bytes()
    key = src + " ".join(_flags(source)).encode()
    if is_ext:                 # the extension's ABI is the interpreter's
        key += sys.implementation.cache_tag.encode()
    digest = hashlib.sha256(key).hexdigest()
    suffix = sysconfig.get_config_var("EXT_SUFFIX") if is_ext else ".so"
    return BUILD_DIR / f"{stem}-{digest[:16]}{suffix}"


def build(source: str):
    """Compile ``csrc/host/<source>.cpp`` unless its library exists;
    returns the library's path. Raises when the toolchain is missing or
    the compile fails."""
    out = library_path(source)
    if out.exists():
        build_log.setdefault(source, {"seconds": 0.0, "cached": True})
        return out
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [cxx, *_flags(source), "-o", str(tmp),
         str(SOURCE_DIR / f"{source}.cpp")],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {source}.cpp:\n{proc.stderr}")
    os.replace(tmp, out)
    build_log[source] = {"seconds": time.perf_counter() - t0,
                         "cached": False}
    return out


def _built(source: str):
    """``build(source)``, or None with the reason in ``build_errors``."""
    try:
        return build(source)
    except Exception as exc:
        build_errors[source] = str(exc)
        return None


def build_all() -> None:
    """Build every host source not built yet, one g++ each, in
    parallel; a failure lands in ``build_errors``."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        list(pool.map(_built, SOURCES))


def _try_load():
    global _lib, _load_attempted
    with _load_lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        if disabled():
            return None
        path = _built("maxmq_torch_native")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            build_errors["maxmq_torch_native"] = str(exc)
            return None
        lib.mq_vocab_new.restype = ctypes.c_void_p
        lib.mq_vocab_free.argtypes = [ctypes.c_void_p]
        lib.mq_vocab_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int64, ctypes.c_int32]
        lib.mq_vocab_size.argtypes = [ctypes.c_void_p]
        lib.mq_vocab_size.restype = ctypes.c_int64
        lib.mq_tokenize.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.uint8)]
        lib.mq_tokenize_joined.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.uint8)]
        lib.mq_scan_frames.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
        lib.mq_scan_frames.restype = ctypes.c_int64
        lib.mq_tokenize_sig.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.uint32),
            np.ctypeslib.ndpointer(np.uint32),
            np.ctypeslib.ndpointer(np.uint8), ctypes.c_int64,
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.int8),
            np.ctypeslib.ndpointer(np.uint32)]
        lib.mq_probe_new.restype = ctypes.c_void_p
        lib.mq_probe_free.argtypes = [ctypes.c_void_p]
        lib.mq_probe_add_group.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_uint8,
            ctypes.c_uint32,
            np.ctypeslib.ndpointer(np.uint32),
            np.ctypeslib.ndpointer(np.uint32),
            np.ctypeslib.ndpointer(np.int32), ctypes.c_int64]
        lib.mq_probe_run.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int8), ctypes.c_int64,
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int32), ctypes.c_int64,
            ctypes.c_int32]
        lib.mq_probe_run.restype = ctypes.c_int64
        lib.mq_probe_set_ge.argtypes = [ctypes.c_void_p]
        lib.mq_tokenize_probe.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.int8),
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int32), ctypes.c_int64]
        lib.mq_tokenize_probe.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return _try_load() is not None


_decode_mod = None
_decode_attempted = False


def chain_params_in_effect(mod) -> tuple:
    """The decode extension's live (min_base, tail_num, tail_den) — the
    value A/B harnesses and test finally blocks must restore VERBATIM
    (restoring hardcoded defaults silently changes global decode
    behavior if the native defaults drift)."""
    return mod._get_chain_params()


def decode_module():
    """The ``maxmq_torch_decode`` CPython extension (candidate verify +
    subscriber union in C), built at first use, or None (no toolchain or
    ``Python.h``, a failed build, or ``MAXMQ_NO_NATIVE``). A separate
    library from the ctypes runtime because its hot loop builds Python
    objects — that needs the C API, not a C ABI."""
    global _decode_mod, _decode_attempted
    with _load_lock:
        if _decode_attempted:
            return _decode_mod
        _decode_attempted = True
        if disabled():
            return None
        path = _built("maxmq_torch_decode")
        if path is None:
            return None
        try:
            import importlib.util
            spec = importlib.util.spec_from_file_location(
                "maxmq_torch_decode", str(path))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _decode_mod = mod
        except Exception as exc:
            build_errors["maxmq_torch_decode"] = str(exc)
            _decode_mod = None
        return _decode_mod


_refdecode = None


def refdecode():
    """The reference decoder's ``mq_ref_decode(first_byte, remaining,
    body, body_len, protocol_version, out, out_cap)`` (canonical text
    into ``out``; -1 on reject, -2 when ``out`` is too small), built at
    first use, or None with the reason in ``build_errors``. It ignores
    ``MAXMQ_NO_NATIVE``: an oracle, not a fast path."""
    global _refdecode
    with _load_lock:
        if _refdecode is None:
            path = _built("maxmq_torch_refdecode")
            if path is None:
                return None
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                build_errors["maxmq_torch_refdecode"] = str(exc)
                return None
            fn = lib.mq_ref_decode
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_uint8, ctypes.c_int64, ctypes.c_char_p,
                           ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p,
                           ctypes.c_int64]
            _refdecode = fn
        return _refdecode


class NativeVocab:
    """C++ mirror of a matcher vocabulary dict (level string -> token id).
    Built once per table refresh; reads are lock-free in C++."""

    def __init__(self, vocab: dict[str, int]) -> None:
        lib = _try_load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._handle = ctypes.c_void_p(lib.mq_vocab_new())
        for level, tok in vocab.items():
            raw = level.encode("utf-8")
            lib.mq_vocab_add(self._handle, raw, len(raw), tok)

    def __len__(self) -> int:
        return int(self._lib.mq_vocab_size(self._handle))

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle and getattr(self, "_lib", None) is not None:
            self._lib.mq_vocab_free(handle)

    def tokenize(self, topics: list[str], max_levels: int):
        """Same contract as matching/topics.py:tokenize_topics. Topics are
        shipped as ONE NUL-joined utf-8 buffer (U+0000 can't appear in an
        MQTT topic name [MQTT-1.5.4-2]) and split in C."""
        n = len(topics)
        buf = "\x00".join(topics).encode("utf-8")
        toks = np.empty((n, max_levels), dtype=np.int32)
        lengths = np.empty(n, dtype=np.int32)
        dollar = np.empty(n, dtype=np.uint8)
        self._lib.mq_tokenize_joined(self._handle, buf, len(buf), n,
                                     max_levels, toks, lengths, dollar)
        return toks, lengths, dollar.astype(bool)


class ExactSigTable:
    """Host-exact coefficient tables marshalled once per compiled-table
    snapshot for mq_tokenize_sig (depth -> per-position multipliers)."""

    def __init__(self, host_exact: dict) -> None:
        max_d = max(host_exact.keys(), default=0)
        self.max_d = max_d
        self.coef = np.zeros((max_d + 1, max(max_d, 1)), dtype=np.uint32)
        self.dc = np.zeros(max_d + 1, dtype=np.uint32)
        self.present = np.zeros(max_d + 1, dtype=np.uint8)
        for d, g in host_exact.items():
            spec = g.spec
            for c, pos in zip(spec.coef, spec.kept):
                self.coef[d, pos] = c
            self.dc[d] = spec.depth_coef
            self.present[d] = 1


def tokenize_sig(vocab: "NativeVocab", topics: list[str], window: int,
                 tok_dtype, exact: ExactSigTable):
    """One-pass compact tokenizer + host-exact signature (C++). Returns
    (toks [n, window] of tok_dtype, lens_enc int8[n], esig uint32[n]) per
    matching/sig_tables.py:tokenize_compact's encoding contract."""
    lib = vocab._lib
    n = len(topics)
    buf = "\x00".join(topics).encode("utf-8")
    toks = np.empty((n, window), dtype=tok_dtype)
    lens = np.empty(n, dtype=np.int8)
    esig = np.empty(n, dtype=np.uint32)
    mode = {np.uint8: 1, np.uint16: 2, np.int32: 4}[tok_dtype]
    lib.mq_tokenize_sig(vocab._handle, buf, len(buf), n, window, mode,
                        exact.coef, exact.dc, exact.present,
                        exact.coef.shape[1] if exact.max_d else 0,
                        toks.ctypes.data_as(ctypes.c_void_p), lens, esig)
    return toks, lens, esig


class NativeProbe:
    """C++ host probe over every exact-shape group (full-literal +
    '+'-shape): one hashed signature + binary search per (topic, group
    of the topic's depth), threaded over topic ranges. Built once per
    compiled-table snapshot from tables.host_exact / tables.host_plus."""

    def __init__(self, host_exact: dict, host_plus: dict,
                 ge_depth: bool = False) -> None:
        lib = _try_load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._handle = ctypes.c_void_p(lib.mq_probe_new())
        for d, g in (host_exact or {}).items():
            coef = np.zeros(max(d, 1), dtype=np.uint32)
            for c, pos in zip(g.spec.coef, g.spec.kept):
                coef[pos] = c
            with np.errstate(over="ignore"):
                dc = int(np.uint32(g.spec.depth_coef) * np.uint32(d))
            lib.mq_probe_add_group(
                self._handle, d, 0, dc, coef,
                np.ascontiguousarray(g.sigs, dtype=np.uint32),
                np.ascontiguousarray(g.rows, dtype=np.int32), len(g.sigs))
        for d, p in (host_plus or {}).items():
            for k in range(len(p.sigs)):
                lib.mq_probe_add_group(
                    self._handle, d, int(bool(p.wildf[k])), int(p.dc[k]),
                    np.ascontiguousarray(p.coef[k], dtype=np.uint32),
                    np.ascontiguousarray(p.sigs[k], dtype=np.uint32),
                    np.ascontiguousarray(p.rows[k], dtype=np.int32),
                    len(p.sigs[k]))
        if ge_depth:
            # '#'-prefix semantics: groups apply to topics of depth >=
            # their prefix depth (pass tables.host_hash as host_plus —
            # same probe layout, dc=0). Must follow every add_group.
            lib.mq_probe_set_ge(self._handle)

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle and getattr(self, "_lib", None) is not None:
            self._lib.mq_probe_free(handle)

    def run(self, toks: np.ndarray, lens_enc: np.ndarray
            ) -> tuple[np.ndarray, np.ndarray]:
        """(topic ids int64[M], row ids int32[M]) hit pairs, topic-sorted.
        ``toks`` is the narrow [n, window] token matrix of any of the
        compact dtypes."""
        n, window = toks.shape
        mode = {1: 1, 2: 2, 4: 4}[toks.dtype.itemsize]
        cap = max(4 * n, 1024)
        while True:
            ti = np.empty(cap, dtype=np.int64)
            rw = np.empty(cap, dtype=np.int32)
            total = self._lib.mq_probe_run(
                self._handle, toks.ctypes.data_as(ctypes.c_void_p), mode,
                lens_enc, n, window, ti, rw, cap, 0)
            if total <= cap:
                return ti[:total], rw[:total]
            cap = int(total)


def tokenize_probe(vocab: "NativeVocab", probe: "NativeProbe",
                   topics: list[str], window: int, tok_dtype):
    """Fused single-pass tokenize + host probe (C++): returns
    (toks [n, window] of tok_dtype, lens_enc int8[n], ti int64[M],
    rows int32[M]) — hit pairs topic-sorted. One pass over the topic
    bytes with the level tokens still in registers at probe time."""
    lib = vocab._lib
    n = len(topics)
    buf = "\x00".join(topics).encode("utf-8")
    toks = np.empty((n, window), dtype=tok_dtype)
    lens = np.empty(n, dtype=np.int8)
    mode = {np.uint8: 1, np.uint16: 2, np.int32: 4}[tok_dtype]
    cap = max(4 * n, 1024)
    while True:
        ti = np.empty(cap, dtype=np.int64)
        rw = np.empty(cap, dtype=np.int32)
        total = lib.mq_tokenize_probe(
            vocab._handle, probe._handle, buf, len(buf), n, window, mode,
            toks.ctypes.data_as(ctypes.c_void_p), lens, ti, rw, cap)
        if total <= cap:
            return toks, lens, ti[:total], rw[:total]
        cap = int(total)


class MalformedFrame(ValueError):
    """The buffer contains an invalid fixed header (reserved type 0 or a
    variable-byte integer longer than 4 bytes, MQTT-1.5.5)."""


def scan_frames(data: bytes, max_frames: int = 4096
                ) -> tuple[list[tuple[int, int]], int]:
    """Scan ``data`` for complete MQTT frames.

    Returns ``(frames, consumed)`` where frames is a list of (start, end)
    byte ranges and consumed is the offset scanning stopped at (start of the
    first incomplete frame — the caller keeps ``data[consumed:]`` for the
    next read). Raises MalformedFrame on an invalid header.
    """
    lib = _try_load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    starts = np.empty(max_frames, dtype=np.int64)
    totals = np.empty(max_frames, dtype=np.int64)
    consumed = ctypes.c_int64(0)
    n = lib.mq_scan_frames(data, len(data), starts, totals, max_frames,
                           ctypes.byref(consumed))
    if n < 0:
        raise MalformedFrame(f"invalid fixed header at offset {consumed.value}")
    return ([(int(starts[i]), int(starts[i] + totals[i])) for i in range(n)],
            int(consumed.value))


def scan_frames_py(data: bytes, max_frames: int = 4096
                   ) -> tuple[list[tuple[int, int]], int]:
    """Pure-Python reference for scan_frames (also the fallback)."""
    frames: list[tuple[int, int]] = []
    pos = 0
    while pos < len(data) and len(frames) < max_frames:
        if (data[pos] >> 4) == 0:
            raise MalformedFrame(f"invalid fixed header at offset {pos}")
        rem = 0
        shift = 0
        vpos = pos + 1
        complete = False
        while vpos < len(data):
            b = data[vpos]
            vpos += 1
            rem |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                complete = True
                break
            if shift > 21:
                raise MalformedFrame(
                    f"invalid fixed header at offset {pos}")
        if not complete:
            break
        total = (vpos - pos) + rem
        if pos + total > len(data):
            break
        frames.append((pos, pos + total))
        pos += total
    return frames, pos
