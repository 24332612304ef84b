"""K4 on Hopper: the dense trie walk as one hand-written CUDA kernel
(``csrc/dense_walk.cu``), its plain version, and the matcher around it.

Counterpart of the JAX package's ``matching/pallas_kernel.py``. The
Pallas kernel kept the whole L-level walk in VMEM and read each slot's
parent state through a one-hot expansion matmul ``s @ E_l`` on the MXU,
the TPU's way around a gather; its [B, R] matched-row output was packed
to words by an XLA step after it. On this card the parent read is what
it is, a gather: the staged tables carry ``parent_idx int32[L, S]``
instead of ``expand [L, S, S]``, and the kernel writes the packed words
itself (bit r of word w = row 32w + r), so only the sparse extract
(``dense.extract_nonzero_words``) follows it.

``fits()`` and its limits are the reference's, unchanged: the capacity
gate decides which route a ``DenseEngine`` serves.

``dense_walk_words`` is the wrapper: for CUDA tensors it launches the
kernel (or raises ``faults.DeviceMatchError``), for CPU tensors it runs
``dense_walk_words_plain``, the same function in torch ops.

Parity surface: vendor/github.com/mochi-co/mqtt/v2/topics.go:484-555 in
the reference (Subscribers/scanSubscribers), via dense.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import faults, kernels
from .dense import (DenseTables, dense_arrays, extract_nonzero_words,
                    pack_words, walk_step)
from .sig import resolve_device

NEVER = -5            # child_tok value for padding slots: matches nothing

# Capacity limits of the reference (its VMEM budget); kept as they are so
# the capacity gate routes exactly as the reference's does.
MAX_SLOTS = 512       # S: slots per level
MAX_LEVELS = 8        # L: trie depth
MAX_ROWS = 2048       # R: subscriber-carrying rows (output width)
SLOT_ALIGN = 32       # slots pad to whole warps (one bit per lane)
PLAIN_SLICE = 8192    # topics per slice of the plain version


@dataclass
class StagedTables:
    """Host-side staging of DenseTables in the kernel's layout."""

    child_tok: np.ndarray   # int32[L, S], NEVER in padding slots
    parent_idx: np.ndarray  # int32[L, S] parent slot in level l-1 (0 pad)
    emit_exact: np.ndarray  # uint8[L, S] 1 = at_end-gated emitter slot
    width: list[int]        # real slots per level
    n_emit: list[int]       # emitting slots per level (prefix of the level)
    emit_base: list[int]    # global row offset of each level's emitters
    n_rows: int
    n_levels: int
    slots: int


def fits(tables: DenseTables, max_slots: int = MAX_SLOTS,
         max_levels: int = MAX_LEVELS, max_rows: int = MAX_ROWS) -> bool:
    """Whether the compiled dense tables qualify for the kernel."""
    if tables.n_rows > max_rows or len(tables.levels) > max_levels:
        return False
    return all(len(lv.child_tok) <= max_slots for lv in tables.levels)


def stage(arrays: dict, slots: int | None = None,
          max_levels: int | None = None) -> StagedTables:
    """Pad/stack the ragged per-level arrays (``dense.dense_arrays`` of
    either package's tables) into the kernel's layout; ``slots`` defaults
    to the widest level rounded up to a multiple of 32.

    ``max_levels`` trims trie levels deeper than the tokenizer window, the
    same cut dense_match_body makes (deeper filters only match topics that
    overflow to the CPU trie anyway)."""
    cts, pars, exacts = (arrays["child_tok"], arrays["parent_idx"],
                         arrays["emit_exact"])
    if max_levels is not None:
        cts, pars, exacts = (cts[:max_levels + 1], pars[:max_levels + 1],
                             exacts[:max_levels + 1])
    n_levels = max(len(cts), 1)
    if slots is None:
        width = max([1] + [len(ct) for ct in cts])
        slots = -(-width // SLOT_ALIGN) * SLOT_ALIGN

    child_tok = np.full((n_levels, slots), NEVER, dtype=np.int32)
    parent_idx = np.zeros((n_levels, slots), dtype=np.int32)
    emit_exact = np.zeros((n_levels, slots), dtype=np.uint8)
    widths: list[int] = []
    n_emit: list[int] = []
    emit_base: list[int] = []
    base = 0
    for l, (ct, par, exact) in enumerate(zip(cts, pars, exacts)):
        s_l = len(ct)
        child_tok[l, :s_l] = ct
        # level 0's parent is the root (parent_idx all 0): the kernel
        # treats every level-0 slot's parent as active
        parent_idx[l, :s_l] = par
        t = len(exact)
        emit_exact[l, :t] = np.asarray(exact, dtype=np.uint8)
        widths.append(s_l)
        n_emit.append(t)
        emit_base.append(base)
        base += t
    while len(widths) < n_levels:           # no levels: one empty level
        widths.append(0)
        n_emit.append(0)
        emit_base.append(base)
    return StagedTables(child_tok=child_tok, parent_idx=parent_idx,
                        emit_exact=emit_exact, width=widths, n_emit=n_emit,
                        emit_base=emit_base, n_rows=arrays["n_rows"],
                        n_levels=n_levels, slots=slots)


def device_stage(pt: StagedTables, device) -> dict:
    """The kernel's table operands on ``device``: ``child_tok`` and
    ``parent_idx`` int32[L, S], ``emit_exact`` uint8[L, S], ``meta``
    int32[3, L] (width, n_emit, emit_base per level), and the same
    per-level lists and sizes as Python values for the plain version."""
    dev = torch.device(device)
    meta = np.asarray([pt.width, pt.n_emit, pt.emit_base], dtype=np.int32)
    return {
        "child_tok": torch.from_numpy(pt.child_tok).to(dev),
        "parent_idx": torch.from_numpy(pt.parent_idx).to(dev),
        "emit_exact": torch.from_numpy(pt.emit_exact).to(dev),
        "meta": torch.from_numpy(meta).to(dev),
        "width": list(pt.width), "n_emit": list(pt.n_emit),
        "emit_base": list(pt.emit_base),
        "n_levels": pt.n_levels, "slots": pt.slots, "n_rows": pt.n_rows,
    }


def dense_walk_words_plain(toks, lengths, dollar, kt: dict,
                           n_words: int) -> torch.Tensor:
    """The kernel's function in torch ops: the walk over the staged
    tables, emitted rows packed to int32[B, n_words] words (uint32 bits).
    Works on slices of ``PLAIN_SLICE`` topics."""
    batch, n_cols = toks.shape
    dev = toks.device
    out = torch.empty((batch, n_words), dtype=torch.int32, device=dev)
    child_tok = kt["child_tok"]
    parent_idx = kt["parent_idx"].to(torch.int64)
    exact = kt["emit_exact"] != 0
    for a in range(0, batch, PLAIN_SLICE):
        b = min(a + PLAIN_SLICE, batch)
        t, ln, dol = toks[a:b], lengths[a:b], dollar[a:b]
        matched = torch.zeros((b - a, n_words * 32), dtype=torch.bool,
                              device=dev)
        # the root: every level-0 slot's parent reads as active
        s = torch.ones((b - a, kt["slots"]), dtype=torch.bool, device=dev)
        for l in range(kt["n_levels"]):
            # the trailing pad column: tokens past the window read -1
            tok = (t[:, l] if l < n_cols else
                   torch.full((b - a,), -1, dtype=torch.int32, device=dev))
            s = walk_step(s, parent_idx[l], tok[:, None], child_tok[l],
                          dol if l == 0 else None)
            t_l, base = kt["n_emit"][l], kt["emit_base"][l]
            if t_l:
                gate = (ln == l + 1)[:, None] | ~exact[l, :t_l][None, :]
                matched[:, base:base + t_l] = s[:, :t_l] & gate
        out[a:b] = pack_words(matched, n_words)
    return out


def _check_operands(toks, lengths, dollar, kt: dict, n_words: int) -> None:
    dev = toks.device
    for name, t, dtype in (("toks", toks, torch.int32),
                           ("lengths", lengths, torch.int32),
                           ("dollar", dollar, torch.bool),
                           ("child_tok", kt["child_tok"], torch.int32),
                           ("parent_idx", kt["parent_idx"], torch.int32),
                           ("emit_exact", kt["emit_exact"], torch.uint8),
                           ("meta", kt["meta"], torch.int32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, toks on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    batch = toks.shape[0]
    if toks.dim() != 2 or (toks.shape[1] > 1 and toks.stride(1) != 1):
        raise ValueError("toks must be a [batch, levels] tensor with "
                         "contiguous rows")
    for name, t in (("lengths", lengths), ("dollar", dollar)):
        if t.shape != (batch,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [batch] tensor")
    n_levels, slots = kt["n_levels"], kt["slots"]
    for name in ("child_tok", "parent_idx", "emit_exact"):
        t = kt[name]
        if t.shape != (n_levels, slots) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous "
                             f"[{n_levels}, {slots}] tensor")
    if kt["meta"].shape != (3, n_levels) or not kt["meta"].is_contiguous():
        raise ValueError(f"meta must be a contiguous [3, {n_levels}] tensor")
    if slots % SLOT_ALIGN or not 0 < slots <= MAX_SLOTS:
        raise ValueError(f"slots must be a multiple of {SLOT_ALIGN} in "
                         f"(0, {MAX_SLOTS}]")
    if not 0 <= kt["n_rows"] <= MAX_ROWS:
        raise ValueError(f"n_rows must be in [0, {MAX_ROWS}]")
    if n_words * 32 < kt["n_rows"]:
        raise ValueError("n_words must hold every row")


def dense_walk_words(toks, lengths, dollar, kt: dict,
                     n_words: int) -> torch.Tensor:
    """Dense walk of one batch to packed words: int32[B, n_words]
    carrying uint32 words, bit r of word w = row 32w + r.

    ``toks`` int32[B, Lt] (-1 padded; level l >= Lt reads -1, the
    trailing pad column that gives '#' its parent match at the last
    level), ``lengths`` int32[B] (-1 = too deep), ``dollar`` bool[B];
    ``kt`` is ``device_stage`` output on the same device.

    A CUDA tensor launches the kernel on the current stream (and raises
    ``faults.DeviceMatchError`` when the launch fails); a CPU tensor runs
    the plain version."""
    _check_operands(toks, lengths, dollar, kt, n_words)
    if toks.device.type == "cpu":
        return dense_walk_words_plain(toks, lengths, dollar, kt, n_words)
    if toks.device.type != "cuda":
        raise ValueError(f"unsupported device {toks.device}")
    batch = toks.shape[0]
    out = torch.empty((batch, n_words), dtype=torch.int32,
                      device=toks.device)
    lib = kernels.library("dense_walk")
    with torch.cuda.device(toks.device):
        stream = torch.cuda.current_stream(toks.device).cuda_stream
        rc = lib.dense_walk_launch(
            toks.data_ptr(), toks.stride(0), toks.shape[1],
            lengths.data_ptr(), dollar.data_ptr(),
            kt["child_tok"].data_ptr(), kt["parent_idx"].data_ptr(),
            kt["emit_exact"].data_ptr(), kt["meta"].data_ptr(),
            kt["n_levels"], kt["slots"], batch, n_words,
            (kt["n_rows"] + 31) // 32, out.data_ptr(), stream)
    if rc != 0:
        msg = lib.dense_walk_error_string(rc).decode()
        raise faults.DeviceMatchError(
            f"dense_walk_words launch failed: {msg} ({rc})")
    dense_walk_words.launches += 1
    return out


dense_walk_words.launches = 0   # kernel launches (not plain-version calls)


class KernelMatcher:
    """The kernel route over one DenseTables snapshot.

    ``__call__(toks, lengths, dollar)`` has the same contract as
    ``dense.dense_match_body``: (word_idx, word_val, overflow) tensors on
    the matcher's device."""

    def __init__(self, tables: DenseTables, max_levels: int,
                 max_words: int = 32, device=None) -> None:
        if not fits(tables):
            raise ValueError("tables exceed the kernel capacity; "
                             "use the dense walk")
        self.tables = tables
        self.max_levels = max_levels
        self.max_words = max_words
        self.device = resolve_device(device)
        self.pt = stage(dense_arrays(tables), max_levels=max_levels)
        self.kt = device_stage(self.pt, self.device)
        self.n_words = max((self.pt.n_rows + 31) // 32, max_words)

    def __call__(self, toks, lengths, dollar):
        dev = self.device
        toks = torch.as_tensor(toks).to(dev, torch.int32).contiguous()
        lengths = torch.as_tensor(lengths).to(dev, torch.int32).contiguous()
        dollar = torch.as_tensor(dollar).to(dev, torch.bool).contiguous()
        words = dense_walk_words(toks, lengths, dollar, self.kt,
                                 self.n_words)
        return extract_nonzero_words(words, lengths, self.max_words)
