"""The fixed-path device program: prologue, the ``sig_match_fixed`` kernel
(``csrc/sig_match.cu``), and the stream-compaction epilogue.

Counterpart of the JAX package's ``matching/sig_pallas.py``. One CUDA
kernel replaces both of its Pallas chunk kernels (``_chunk_kernel_select``
and ``_chunk_kernel_mxu``) and their merge: on this card both expansions
are the same gather, and one walk over all of a topic's words needs no
merge (the source states the argument). The kernel has no VMEM budget,
so ``plan`` never declines a table; ``sig.MAX_GROUPS`` still routes
pathological corpora to the CPU trie.

``sig_match_fixed`` is the wrapper: for CUDA tensors it launches the
kernel (or raises), for CPU tensors it runs ``sig_match_fixed_plain``,
the same function in torch ops. ``sig_match_fixed.launches`` counts the
kernel's launches, each once where it is made: the wrapper counts an
eager launch; a launch recorded into a CUDA graph (``FixedGraph``, which
checks that its capture recorded exactly one) is counted by each replay
of the graph, never by the capture. The wire format is the JAX package's
"stream": ``counts_u8[B]`` (0xFF = overflow, else the topic's matched
rows) and ``stream``, the matched rows of all topics concatenated in
topic order; only its front ``sum(counts)`` entries are defined.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .. import faults, kernels
from .sig_torch import (MASK32, adjusted_signatures, fold16_replicated,
                        host_tokens, to_int32_bits, token_tensor,
                        widen_tokens)

PLAIN_SLICE = 8192   # topics per slice of the plain version: bounds its
                     # [slice, words] int64 intermediates (~200 MB each at
                     # 1M subscriptions)
MAX_WARPS = 8        # warps per block of the kernel (csrc MAX_WARPS)


def width16_mask(group_words, group_w16,
                 force_width32: bool = False) -> np.ndarray:
    """Per-group 16-bit eligibility: the compiled ``group_w16`` when it
    aligns with ``group_words``, all-False when forced to 32 bits."""
    n = len(group_words)
    if force_width32 or group_w16 is None or len(group_w16) != n:
        return np.zeros(n, dtype=bool)
    return np.asarray(group_w16, dtype=bool)


def plan(group_words, group_w16, force_width32: bool = False) -> dict:
    """Region layout of the kernel for one compiled table set: the 32-bit
    word region first, then the packed 16-bit region, each walked in one
    pass (so a region's chunk is the region itself). ``force_width32``
    plans the SAME tables as uniform 32-bit planes (the A/B arm)."""
    gw = np.asarray(group_words, dtype=np.int64)
    w16 = width16_mask(gw, group_w16, force_width32)
    n_words32 = int(gw[~w16].sum())
    n_words16 = int(gw[w16].sum())
    return {"n_words": n_words32 + n_words16,
            "n_words32": n_words32, "n_words16": n_words16,
            "chunk32": n_words32, "chunk16": n_words16,
            "groups32": int((~w16).sum()), "groups16": int(w16.sum()),
            "force_width32": force_width32,
            # the compare-bound side of the roofline: plane passes per
            # topic (the packed compare halves the 16-bit regions' count)
            "plane_passes_per_topic": 32 * n_words32 + 16 * n_words16}


def launch_shape(batch: int, sms: int) -> tuple[int, int, int]:
    """(topics per thread, lanes per topic, warps per block) of the kernel
    for a batch on a card with ``sms`` SMs: two topics a thread with the
    most warps (up to ``MAX_WARPS``) that still give every SM a block;
    for batches too small for that, eight lanes a topic, with as many
    warps a block as keeps every SM busy (one at the least). A block's
    threads share each staged plane tile, so the plane table is read
    once per block."""
    for tpt, lpt in ((2, 1), (1, 8)):
        warps = MAX_WARPS
        while warps >= 1:
            if -(-batch * lpt // (32 * tpt * warps)) >= sms:
                return tpt, lpt, warps
            warps //= 2
    return 1, 8, 1


def plane_bytes(batch: int, kplan: dict, sms: int) -> int:
    """The most bytes of plane table and word groups that one launch can
    read from L2, worked out from the launch shape: every block staging
    the whole table once. A block stops at the first tile where all its
    topics have overflowed, so a launch reads this much or less."""
    tpt, lpt, warps = launch_shape(batch, sms)
    blocks = -(-batch * lpt // (32 * tpt * warps))
    return blocks * 4 * (kplan["plane_passes_per_topic"] + kplan["n_words"])


def _highest_bit(x: torch.Tensor) -> torch.Tensor:
    """31 - clz(x) for int64 tensors holding nonzero uint32 values (exact:
    frexp's exponent of a float64 that holds x exactly)."""
    return torch.frexp(x.to(torch.float64)).exponent.to(torch.int64) - 1


def _match_words(sig: torch.Tensor, grp: torch.Tensor, planes: torch.Tensor,
                 width16: bool) -> torch.Tensor:
    """[n, W] match words of one region (int64 holding uint32 bits)."""
    e = sig[:, grp.to(torch.int64)]                     # the expansion
    p = planes.to(torch.int64) & MASK32
    acc = torch.zeros_like(e)
    if not width16:
        for j in range(32):
            acc |= (e == p[j]).to(torch.int64) << j
        return acc
    for j in range(16):
        x = e ^ p[j]
        zero = ((x - 0x00010001) & MASK32) & ~x & 0x80008000
        acc |= zero >> (15 - j)
    return acc


def sig_match_fixed_plain(sig, too_deep, grp_of_word, planes32, planes16,
                          max_rows: int):
    """The kernel's function in torch ops, in int64 masked to 32 bits:
    same regions, planes and SWAR detect. Returns (counts uint8[B],
    rows int32[B, max_rows]) as the kernel does. Works on slices of
    ``PLAIN_SLICE`` topics."""
    batch = sig.shape[0]
    n32, n16 = planes32.shape[1], planes16.shape[1]
    n_words = n32 + n16
    dev = sig.device
    counts = torch.empty(batch, dtype=torch.uint8, device=dev)
    rows = torch.full((batch, max_rows), -1, dtype=torch.int32, device=dev)
    word = torch.arange(n_words, dtype=torch.int64, device=dev)
    k = min(max_rows, n_words)
    big = 1 << 40
    for a in range(0, batch, PLAIN_SLICE):
        b = min(a + PLAIN_SLICE, batch)
        s = sig[a:b].to(torch.int64) & MASK32
        parts = []
        if n32:
            parts.append(_match_words(s, grp_of_word[:n32], planes32, False))
        if n16:
            parts.append(_match_words(s, grp_of_word[n32:n_words], planes16,
                                      True))
        acc = (torch.cat(parts, dim=1) if parts else
               torch.zeros((b - a, 0), dtype=torch.int64, device=dev))
        nz = acc != 0
        count = nz.sum(dim=1)
        multi = ((acc & (acc - 1)) != 0).any(dim=1)
        over = (too_deep[a:b] != 0) | multi | (count > max_rows)
        counts[a:b] = torch.where(over, 255, count).to(torch.uint8)
        if k:
            enc = torch.where(nz, (word << 5) | _highest_bit(acc), big)
            first = torch.topk(enc, k, dim=1, largest=False,
                               sorted=True).values
            first = torch.where((first == big) | over[:, None], -1, first)
            rows[a:b, :k] = first.to(torch.int32)
    return counts, rows


def _check_operands(sig, too_deep, grp_of_word, planes32, planes16,
                    max_rows: int) -> None:
    dev = sig.device
    for name, t, dtype in (("sig", sig, torch.int32),
                           ("too_deep", too_deep, torch.uint8),
                           ("grp_of_word", grp_of_word, torch.int32),
                           ("planes32", planes32, torch.int32),
                           ("planes16", planes16, torch.int32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, sig on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if sig.dim() != 2 or not sig.is_contiguous():
        raise ValueError("sig must be a contiguous [batch, groups] tensor")
    if too_deep.shape != (sig.shape[0],) or not too_deep.is_contiguous():
        raise ValueError("too_deep must be a contiguous [batch] tensor")
    if planes32.dim() != 2 or planes32.shape[0] != 32:
        raise ValueError("planes32 must be [32, n_words32]")
    if planes16.dim() != 2 or planes16.shape[0] != 16:
        raise ValueError("planes16 must be [16, n_words16]")
    for name, p in (("planes32", planes32), ("planes16", planes16)):
        if p.shape[1] > 1 and p.stride(1) != 1:
            raise ValueError(f"{name} rows must be contiguous")
    n_words = planes32.shape[1] + planes16.shape[1]
    if (grp_of_word.dim() != 1 or grp_of_word.shape[0] < n_words
            or not grp_of_word.is_contiguous()):
        raise ValueError("grp_of_word must be a contiguous [n_words] tensor")
    if n_words and sig.shape[1] == 0:
        raise ValueError("device words need at least one group")
    if not 1 <= max_rows <= 254:
        raise ValueError("max_rows must be in [1, 254]")


def sig_match_fixed(sig, too_deep, grp_of_word, planes32, planes16,
                    max_rows: int):
    """Fused signature match of one batch: (counts uint8[B], rows
    int32[B, max_rows]).

    ``sig`` int32[B, G] carries each topic's adjusted group signatures
    (16-bit groups folded and lane-replicated); ``too_deep`` uint8[B];
    ``grp_of_word`` int32[n_words] maps each global word to its group;
    ``planes32`` int32[32, n_words32] and ``planes16`` int32[16,
    n_words16] are the plane tables of the two word regions (rows may be
    strided, elements contiguous). All int32 tensors carry uint32 bits.

    A CUDA tensor launches the kernel on the current stream (and raises
    ``faults.DeviceMatchError`` when the launch fails); a CPU tensor runs
    the plain version."""
    _check_operands(sig, too_deep, grp_of_word, planes32, planes16,
                    max_rows)
    if sig.device.type == "cpu":
        return sig_match_fixed_plain(sig, too_deep, grp_of_word, planes32,
                                     planes16, max_rows)
    if sig.device.type != "cuda":
        raise ValueError(f"unsupported device {sig.device}")
    batch, n_groups = sig.shape
    counts = torch.empty(batch, dtype=torch.uint8, device=sig.device)
    rows = torch.empty((batch, max_rows), dtype=torch.int32,
                       device=sig.device)
    lib = kernels.library("sig_match")
    _tpt, lpt, warps = launch_shape(batch, kernels.sm_count(sig.device))
    with torch.cuda.device(sig.device):
        stream = torch.cuda.current_stream(sig.device).cuda_stream
        rc = lib.sig_match_fixed_launch(
            sig.data_ptr(), n_groups, too_deep.data_ptr(),
            grp_of_word.data_ptr(), planes32.data_ptr(),
            planes32.stride(0), planes32.shape[1], planes16.data_ptr(),
            planes16.stride(0), planes16.shape[1], batch, max_rows, lpt,
            warps, counts.data_ptr(), rows.data_ptr(), stream)
    if rc != 0:
        msg = lib.sig_match_error_string(rc).decode()
        raise faults.DeviceMatchError(
            f"sig_match_fixed launch failed: {msg} ({rc})")
    if torch.cuda.is_current_stream_capturing():
        # recorded into a CUDA graph, not launched: each replay launches
        # it and ``FixedGraph.run`` counts that
        _capture.recorded = getattr(_capture, "recorded", 0) + 1
    else:
        sig_match_fixed.launches += 1
    return counts, rows


_capture = threading.local()    # kernel launches recorded by this
                                # thread's capture in progress


sig_match_fixed.launches = 0   # kernel launches (not plain-version calls)


def compact_stream(counts: torch.Tensor, rows: torch.Tensor,
                   max_rows: int) -> torch.Tensor:
    """Epilogue: the matched rows of every non-overflow topic, concatenated
    in topic order, at the front of a ``B * max_rows`` stream (exclusive
    cumsum of the counts, then a scatter). The rest of the stream is 0.
    No host synchronisation: the host fetches the counts, sums them, and
    fetches only the front."""
    real = torch.where(counts == 0xFF, 0, counts.to(torch.int64))
    offs = torch.cumsum(real, 0) - real
    cap = rows.shape[0] * max_rows
    kidx = torch.arange(max_rows, dtype=torch.int64, device=rows.device)
    valid = kidx[None, :] < real[:, None]
    pos = torch.where(valid, offs[:, None] + kidx[None, :], cap)
    stream = torch.zeros(cap + 1, dtype=torch.int32, device=rows.device)
    stream.scatter_(0, pos.reshape(-1), rows.reshape(-1))
    return stream[:cap]


def prologue(dev: dict, kplan: dict, toks8: np.ndarray,
             lens_enc: np.ndarray):
    """Host token matrix + length encoding -> the kernel's (sig, too_deep)
    on the tables' device: adjusted signatures, and for the packed
    region the 16-bit fold replicated into both lanes."""
    device = dev["device"]
    return device_prologue(dev, kplan, token_tensor(toks8, device),
                           torch.from_numpy(np.ascontiguousarray(
                               lens_enc, dtype=np.int8)).to(device))


def device_prologue(dev: dict, kplan: dict, toks: torch.Tensor,
                    le8: torch.Tensor):
    """``prologue`` from the tokens (int64 uint32 values) and the int8
    length encoding already on the device: device work only, no host
    synchronisation (so a CUDA graph can capture it)."""
    le = le8.to(torch.int64)
    lengths = le.abs()
    sig = adjusted_signatures(dev, toks, lengths, le < 0)
    if kplan["n_words16"]:
        sig = fold16_replicated(sig, dev["fold_mult"], dev["w16"])
    return (to_int32_bits(sig).contiguous(),
            (lengths >= 127).to(torch.uint8))


def region_planes(dev: dict, kplan: dict):
    """(planes32, planes16) operands of the kernel for a plan: the 32-bit
    region's columns of the full 32-bit plane table, and the packed
    16-bit table when the plan has a 16-bit region."""
    planes16 = dev["planes16"]
    if not kplan["n_words16"]:
        planes16 = planes16[:, :0]
    return dev["planes32"][:, :kplan["n_words32"]], planes16


# Batches up to this many topics run the fixed program as a CUDA graph on
# CUDA (one per batch shape, captured when the engine warms its dispatch
# buckets, then one replay a batch): the eager program is ~170 torch ops,
# and each op gives the interpreter lock up and waits for it back, so on
# a broker whose loop is busy (fan-out, storage) a batch waited ~5 ms an
# op, past the matcher's 250 ms deadline. Larger batches (the headline's
# 262,144) and shapes that were not warmed run eagerly: a graph keeps its
# intermediates allocated for its lifetime.
GRAPH_MAX_BATCH = 4096


class FixedGraph:
    """The fixed program for one batch shape captured as a CUDA graph:
    static device inputs (the token matrix in its host dtype, the int8
    length encoding), one replay, outputs copied out of the graph's
    static buffers. ``run`` is thread-safe; each replay launches
    ``sig_match_fixed`` once and counts it."""

    def __init__(self, dev: dict, body, toks8: np.ndarray,
                 lens_enc: np.ndarray) -> None:
        device = dev["device"]
        self.lock = threading.Lock()
        self.toks_in = torch.from_numpy(host_tokens(toks8)).to(device)
        self.le_in = torch.from_numpy(np.ascontiguousarray(
            lens_enc, dtype=np.int8)).to(device)
        # one eager run on the capture's side stream first (lazy CUDA
        # initialisation must not happen under capture), then the capture
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            body(self.toks_in, self.le_in)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        _capture.recorded = 0
        with torch.cuda.graph(self.graph, stream=side,
                              capture_error_mode="thread_local"):
            self.counts, self.stream = body(self.toks_in, self.le_in)
        if _capture.recorded != 1:
            raise RuntimeError(f"the fixed program's capture recorded "
                               f"{_capture.recorded} sig_match_fixed "
                               "launches, not 1")

    def run(self, toks8: np.ndarray, lens_enc: np.ndarray):
        with self.lock:
            self.toks_in.copy_(torch.from_numpy(host_tokens(toks8)))
            self.le_in.copy_(torch.from_numpy(np.ascontiguousarray(
                lens_enc, dtype=np.int8)))
            self.graph.replay()
            sig_match_fixed.launches += 1
            return self.counts.clone(), self.stream.clone()


class FixedProgram:
    """``program(toks8, lens_enc) -> (counts_u8, stream)``: prologue, one
    kernel launch, epilogue, all enqueued on the device without a host
    synchronisation. A batch shape that ``capture`` captured replays its
    ``FixedGraph``; every other batch (and every batch on the CPU) runs
    the program eagerly. Nothing is captured on the dispatch path."""

    def __init__(self, dev: dict, kplan: dict, max_rows: int) -> None:
        self.dev, self.kplan, self.max_rows = dev, kplan, max_rows
        self.planes = region_planes(dev, kplan)
        self.graphs: dict = {}
        self.graphs_lock = threading.Lock()

    def _body(self, toks_raw, le8):
        sig, too_deep = device_prologue(self.dev, self.kplan,
                                        widen_tokens(toks_raw), le8)
        return self._match(sig, too_deep)

    def _match(self, sig, too_deep):
        counts, rows = sig_match_fixed(sig, too_deep, self.dev["grp_of_word"],
                                       *self.planes, self.max_rows)
        return counts, compact_stream(counts, rows, self.max_rows)

    @staticmethod
    def _key(toks8: np.ndarray):
        return toks8.shape, toks8.dtype.str

    def capture(self, toks8: np.ndarray, lens_enc: np.ndarray) -> bool:
        """Capture this batch shape's CUDA graph (on CUDA, up to
        ``GRAPH_MAX_BATCH`` topics, once per shape): the engine's bucket
        warm-up calls it for each dispatch bucket. True when the shape
        replays a graph from now on."""
        if (self.dev["device"].type != "cuda"
                or toks8.shape[0] > GRAPH_MAX_BATCH):
            return False
        key = self._key(toks8)
        with self.graphs_lock:
            if key not in self.graphs:
                with _device_errors():
                    self.graphs[key] = FixedGraph(self.dev, self._body,
                                                  toks8, lens_enc)
        return True

    def __call__(self, toks8: np.ndarray, lens_enc: np.ndarray):
        with _device_errors():
            graph = self.graphs.get(self._key(toks8))
            if graph is not None:
                return graph.run(toks8, lens_enc)
            return self._match(*prologue(self.dev, self.kplan, toks8,
                                         lens_enc))


@contextlib.contextmanager
def _device_errors():
    """Runtime failures (launch, out of memory) come back untyped: they
    are re-raised as ``faults.DeviceMatchError`` so a supervisor's logs
    separate a sick device from a host bug."""
    try:
        yield
    except faults.DeviceMatchError:
        raise
    except RuntimeError as exc:
        raise faults.DeviceMatchError(
            f"fused sig kernel dispatch failed: {exc!r:.300}") from exc


def build_fixed_fn(dev: dict, kplan: dict, max_rows: int) -> FixedProgram:
    """The fixed program of one snapshot (``FixedProgram``)."""
    return FixedProgram(dev, kplan, max_rows)
