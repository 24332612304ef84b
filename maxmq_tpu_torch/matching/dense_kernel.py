"""K4 on Hopper: the dense trie walk, the pack of its matched rows into
words and the sparse extract of the nonzero words, as one hand-written
CUDA kernel (``csrc/dense_walk.cu``), its plain version, and the matcher
around it.

Counterpart of the JAX package's ``matching/pallas_kernel.py``. The
Pallas kernel kept the whole L-level walk in VMEM and read each slot's
parent state through a one-hot expansion matmul ``s @ E_l`` on the MXU,
the TPU's way around a gather; its [B, R] matched-row output was packed
to words and its nonzero words extracted (``top_k``) by XLA steps after
it. On this card the parent read is what it is, a gather: the staged
tables carry ``parent_idx int32[L, S]`` instead of ``expand [L, S, S]``
(and for the kernel each slot's parent pre-split into a word offset and a
bit mask), and the kernel streams each topic's nonzero words straight to
the (word_idx, word_val, overflow) result: the [B, n_words] word matrix
is never written.

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
from .dense import (HASH, PLUS, DenseTables, dense_arrays,
                    extract_nonzero_words, pack_words, walk_step)
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


def slot_entries(pt: StagedTables) -> np.ndarray:
    """int32[L, S, 4]: the kernel's per-slot entry {child_tok, byte offset
    of the parent's state word, parent bit mask (uint32 bits), 0}. A
    topic's state word w sits at [w][lane] of its warp's state buffer,
    128 bytes a word."""
    par = pt.parent_idx.astype(np.int64)
    out = np.zeros((pt.n_levels, pt.slots, 4), dtype=np.int32)
    out[..., 0] = pt.child_tok
    out[..., 1] = (par >> 5) * 128
    out[..., 2] = (np.uint32(1) << (par & 31).astype(np.uint32)).view(
        np.int32)
    return out


def chunk_masks(pt: StagedTables) -> np.ndarray:
    """int32[L, S // 32, 4] (uint32 bits): per 32-slot chunk the bits of
    its '+' slots, its '#' slots and its at_end-gated emitter slots, then
    0 (bit i = slot 32c + i)."""
    n_chunks = -(-pt.slots // 32)
    ex = np.zeros((pt.n_levels, n_chunks * 32), dtype=bool)
    for l, t in enumerate(pt.n_emit):
        ex[l, :t] = pt.emit_exact[l, :t] != 0
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)

    def pack(bits):
        return (bits.reshape(pt.n_levels, n_chunks, 32).astype(np.uint64)
                * weights).sum(axis=2).astype(np.uint32)

    ct = np.full((pt.n_levels, n_chunks * 32), NEVER, dtype=np.int32)
    ct[:, :pt.slots] = pt.child_tok
    out = np.zeros((pt.n_levels, n_chunks, 4), dtype=np.uint32)
    out[..., 0] = pack(ct == PLUS)
    out[..., 1] = pack(ct == HASH)
    out[..., 2] = pack(ex)
    return out.view(np.int32)


def device_stage(pt: StagedTables, device) -> dict:
    """The kernel's table operands on ``device``: ``slot_tab`` int32[L, S,
    4] (``slot_entries``), ``chunk_masks`` int32[L, S // 32, 4]
    (``chunk_masks``), ``meta`` int32[3, L] (width, n_emit, emit_base per
    level); the plain version's ``child_tok`` and ``parent_idx`` int32[L,
    S] and ``emit_exact`` uint8[L, S]; and the per-level lists and sizes
    as Python values."""
    dev = torch.device(device)
    meta = np.asarray([pt.width, pt.n_emit, pt.emit_base], dtype=np.int32)
    return {
        "slot_tab": torch.from_numpy(slot_entries(pt)).to(dev),
        "chunk_masks": torch.from_numpy(chunk_masks(pt)).to(dev),
        "child_tok": torch.from_numpy(pt.child_tok).to(dev),
        "parent_idx": torch.from_numpy(pt.parent_idx).to(dev),
        "emit_exact": torch.from_numpy(pt.emit_exact).to(dev),
        "meta": torch.from_numpy(meta).to(dev),
        "width": list(pt.width), "n_emit": list(pt.n_emit),
        "emit_base": list(pt.emit_base),
        "n_levels": pt.n_levels, "slots": pt.slots, "n_rows": pt.n_rows,
    }


def walk_packed_plain(toks, lengths, dollar, kt: dict,
                      n_words: int) -> torch.Tensor:
    """The walk over the staged tables in torch ops, emitted rows packed
    to int32[B, n_words] words (uint32 bits; bit r of word w = row 32w +
    r). Works on slices of ``PLAIN_SLICE`` topics."""
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


def dense_walk_words_plain(toks, lengths, dollar, kt: dict,
                           max_words: int):
    """The kernel's function in torch ops: the packed walk, then the
    sparse extract (``dense.extract_nonzero_words``). Returns (word_idx
    int32[B, max_words], word_val int32[B, max_words], overflow
    bool[B])."""
    n_words = max((kt["n_rows"] + 31) // 32, 1)
    words = walk_packed_plain(toks, lengths, dollar, kt, n_words)
    return extract_nonzero_words(words, lengths, max_words)


def _check_operands(toks, lengths, dollar, kt: dict, max_words: int) -> None:
    dev = toks.device
    for name, t, dtype in (("toks", toks, torch.int32),
                           ("lengths", lengths, torch.int32),
                           ("dollar", dollar, torch.bool),
                           ("slot_tab", kt["slot_tab"], torch.int32),
                           ("chunk_masks", kt["chunk_masks"], torch.int32),
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
    for name, shape in (("child_tok", (n_levels, slots)),
                        ("parent_idx", (n_levels, slots)),
                        ("emit_exact", (n_levels, slots)),
                        ("slot_tab", (n_levels, slots, 4)),
                        ("chunk_masks", (n_levels, slots // SLOT_ALIGN, 4)),
                        ("meta", (3, n_levels))):
        t = kt[name]
        if t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {list(shape)} "
                             "tensor")
    if slots % SLOT_ALIGN or not 0 < slots <= MAX_SLOTS:
        raise ValueError(f"slots must be a multiple of {SLOT_ALIGN} in "
                         f"(0, {MAX_SLOTS}]")
    if not 0 <= kt["n_rows"] <= MAX_ROWS:
        raise ValueError(f"n_rows must be in [0, {MAX_ROWS}]")
    if max_words < 1:
        raise ValueError("max_words must be at least 1")


def dense_walk_words(toks, lengths, dollar, kt: dict, max_words: int):
    """Dense match of one batch to its sparse words: (word_idx int32[B,
    max_words], word_val int32[B, max_words] carrying uint32 bits,
    overflow bool[B]) — the first ``max_words`` nonzero words of each
    topic in ascending index (bit r of word w = row 32w + r; -1 / 0
    past them) and ``lengths < 0 | more than max_words nonzero words``.

    ``toks`` int32[B, Lt] (-1 padded; level l >= Lt reads -1, the
    trailing pad column that gives '#' its parent match at the last
    level), ``lengths`` int32[B] (-1 = too deep), ``dollar`` bool[B];
    ``kt`` is ``device_stage`` output on the same device.

    A CUDA tensor launches the kernel on the current stream (and raises
    ``faults.DeviceMatchError`` when the launch fails); a CPU tensor runs
    the plain version."""
    _check_operands(toks, lengths, dollar, kt, max_words)
    if toks.device.type == "cpu":
        return dense_walk_words_plain(toks, lengths, dollar, kt, max_words)
    if toks.device.type != "cuda":
        raise ValueError(f"unsupported device {toks.device}")
    batch = toks.shape[0]
    word_idx = torch.empty((batch, max_words), dtype=torch.int32,
                           device=toks.device)
    word_val = torch.empty_like(word_idx)
    overflow = torch.empty(batch, dtype=torch.bool, device=toks.device)
    lib = kernels.library("dense_walk")
    with torch.cuda.device(toks.device):
        stream = torch.cuda.current_stream(toks.device).cuda_stream
        rc = lib.dense_walk_launch(
            toks.data_ptr(), toks.stride(0), toks.shape[1],
            lengths.data_ptr(), dollar.data_ptr(),
            kt["slot_tab"].data_ptr(), kt["chunk_masks"].data_ptr(),
            kt["meta"].data_ptr(), kt["n_levels"], kt["slots"], batch,
            max_words, word_idx.data_ptr(), word_val.data_ptr(),
            overflow.data_ptr(), stream)
    if rc != 0:
        msg = lib.dense_walk_error_string(rc).decode()
        raise faults.DeviceMatchError(
            f"dense_walk_words launch failed: {msg} ({rc})")
    dense_walk_words.launches += 1
    return word_idx, word_val, overflow


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

    def __call__(self, toks, lengths, dollar):
        dev = self.device
        toks = torch.as_tensor(toks).to(dev, torch.int32).contiguous()
        lengths = torch.as_tensor(lengths).to(dev, torch.int32).contiguous()
        dollar = torch.as_tensor(dollar).to(dev, torch.bool).contiguous()
        return dense_walk_words(toks, lengths, dollar, self.kt,
                                self.max_words)
