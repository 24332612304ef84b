"""The signature matcher's device code in plain PyTorch: the prologue —
per-topic, per-group signatures (``topic_signatures``), validity
poisoning (``adjusted_signatures``) and the 16-bit fold with lane
replication that feeds the packed plane compare — the sharded engine's
word matrix and slots tail, and the torch bodies of ``SigEngine``'s word
and compact paths.

Counterparts: the same names in the JAX package's ``matching/sig.py``,
and the fold in ``sig_pallas.build_fixed_fn``.

uint32 arithmetic: torch's ``uint32`` lacks ``>>`` and reductions on the
CPU, so every value here is an ``int64`` tensor holding the uint32 bits
(0 <= v < 2**32) and every product goes through ``mul32``, which keeps
the partial products below 2**49 — no signed overflow, and the result
is the uint32 wraparound product exactly. ``to_int32_bits`` reinterprets
such a tensor as ``int32`` for the kernel, which reads it as ``uint32``.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
POISON = 0x9E3779B9   # xor'd into invalid-group signatures


def mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 tensors holding uint32 values."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 tensor with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def token_tensor(toks: np.ndarray, device) -> torch.Tensor:
    """Compact host token matrix (uint8 / uint16 / int32, see
    ``sig_tables._compact_dtype``) -> int64 tensor of the uint32 values the
    JAX program sees after ``astype(int32).astype(uint32)`` (the int32 pad
    -1 becomes 0xFFFFFFFF). The narrow dtype crosses to the device; the
    widening runs there."""
    toks = np.ascontiguousarray(toks)
    if toks.dtype == np.uint8:
        return torch.from_numpy(toks).to(device).to(torch.int64)
    if toks.dtype == np.uint16:
        t = torch.from_numpy(toks.view(np.int16)).to(device)
        return t.to(torch.int64) & 0xFFFF
    if toks.dtype == np.int32:
        t = torch.from_numpy(toks).to(device)
        return t.to(torch.int64) & MASK32
    raise TypeError(f"unsupported token dtype {toks.dtype}")


def topic_signatures(consts: dict, toks: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """[B, G] uint32 topic signatures (as int64). ``consts`` holds the
    device tables (``sig.device_tables``); ``toks`` is [B, W] uint32 token
    values, ``lengths`` [B] true depths. The level loop is short
    (max_depth is small)."""
    topo_coef = consts["topo_coef"]          # [G, D]
    depth_coef = consts["depth_coef"]        # [G]
    depth = topo_coef.shape[1]
    sig = mul32(lengths[:, None], depth_coef[None, :])   # exact depth term
    for lvl in range(min(depth, toks.shape[1])):
        t = toks[:, lvl][:, None]                        # [B, 1]
        sig = (sig + mul32(t, topo_coef[None, :, lvl])) & MASK32
    return sig


def adjusted_signatures(consts: dict, toks: torch.Tensor,
                        lengths: torch.Tensor,
                        dollar: torch.Tensor) -> torch.Tensor:
    """[B, G] topic signatures with invalid groups poisoned: '#'-groups
    need depth >= prefix, '$'-topics exclude wildcard-first groups
    [MQTT-4.7.2-1]. A poisoned signature can still collide with a row at
    the 2**-32 baseline rate; host verification drops such candidates."""
    sig = topic_signatures(consts, toks, lengths)
    ok = (~consts["is_hash"][None, :]
          | (lengths[:, None] >= consts["min_depth"][None, :]))
    ok = ok & ~(dollar[:, None] & consts["wild_first"][None, :])
    return torch.where(ok, sig, sig ^ POISON)


def fold16_replicated(sig_adj: torch.Tensor, fold_mult: torch.Tensor,
                      w16: torch.Tensor) -> torch.Tensor:
    """16-bit groups' signatures folded, ``(sig * mult) >> 16``, and
    replicated into both 16-bit lanes for the packed compare; 32-bit
    groups keep the raw signature."""
    folded = mul32(sig_adj, fold_mult[None, :]) >> 16
    return torch.where(w16[None, :], folded | (folded << 16), sig_adj)


# -- the word path: [B, W] match words, then fixed slots -----------------
#
# Counterparts of ``sig_match_words_gather``, ``fixed_slots_from_words``,
# ``_ctz32`` and ``_popc32`` in the JAX package's ``matching/sig.py``: the
# program its sharded signature engine runs, and the word matrix of the
# single-device bodies below. Values are uint32 held in int64, as above.


def _popc32(v: torch.Tensor) -> torch.Tensor:
    """Population count of uint32 values (int64 in, int64 out)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    return ((((v + (v >> 4)) & 0x0F0F0F0F) * 0x01010101) & MASK32) >> 24


def _ctz32(v: torch.Tensor) -> torch.Tensor:
    """Count trailing zeros of nonzero uint32 values (branch-free)."""
    lsb = v & ((~v + 1) & MASK32)
    return _popc32((lsb - 1) & MASK32)


def sig_match_words_gather(consts: dict, planes: torch.Tensor,
                           grp_of_word: torch.Tensor, toks: torch.Tensor,
                           lengths: torch.Tensor,
                           dollar: torch.Tensor) -> torch.Tensor:
    """[B, W] match words (uint32 as int64) with a gather-based group
    expansion: word w's bit j is set where the topic's adjusted signature
    for group ``grp_of_word[w]`` equals ``planes[j, w]``. ``planes`` is
    [32, W] uint32 as int64; the word -> group map is a device array, so
    one program serves every shard's tables. The whole [B, W] matrix is
    materialised (8 bytes a word), as in the reference."""
    sig_adj = adjusted_signatures(consts, toks, lengths, dollar)
    sig_exp = sig_adj[:, grp_of_word.to(torch.int64)]      # [B, W]
    acc = torch.zeros_like(sig_exp)
    for j in range(32):
        acc |= (sig_exp == planes[j][None, :]).to(torch.int64) << j
    return acc


def fixed_slots_from_words(words: torch.Tensor, too_deep: torch.Tensor,
                           sel_blocks: int, max_rows: int,
                           fmt16: bool) -> torch.Tensor:
    """[B, W] match words -> the packed fixed-slot output (uint32 as
    int64): column 0 the count (0xF = overflow), then ``max_rows`` row ids
    in ascending order (0xFFFFFFFF past the count); with ``fmt16`` rows
    travel as 16 bits, count<<28 | row0 then two rows a word.

    Only the ``sel_blocks`` lowest nonzero 32-word blocks are read; a
    topic with more nonzero blocks, more than ``max_rows`` set bits, or
    ``too_deep`` overflows."""
    batch, n_words = words.shape
    dev = words.device
    ws = (n_words + 31) // 32
    pad = ws * 32 - n_words

    # summary bitmap: bit t of summary word s == (word 32s+t nonzero)
    nz = words != 0
    if pad:
        nz = torch.nn.functional.pad(nz, (0, pad))
        words = torch.nn.functional.pad(words, (0, pad))
    lanes = torch.arange(32, dtype=torch.int64, device=dev)
    summary = (nz.view(batch, ws, 32).to(torch.int64)
               << lanes[None, None, :]).sum(dim=2)          # [B, WS]

    snz = summary != 0
    n_blocks = snz.sum(dim=1)
    key = torch.where(snz, (1 << 30) - torch.arange(
        ws, dtype=torch.int32, device=dev)[None, :], -1).to(torch.int32)
    sel_blocks = min(sel_blocks, ws)
    # nonzero blocks have distinct keys (ascending block order); the -1
    # keys tie, and their selections are zeroed below
    topv, sel = torch.topk(key, sel_blocks, dim=1)         # [B, SB]
    live = topv > 0
    sel = torch.where(live, sel, 0)

    blocks = words.view(batch, ws, 32)
    g = torch.gather(blocks, 1, sel[:, :, None].expand(-1, -1, 32))
    g = torch.where(live[:, :, None], g, 0)
    wordidx = (sel[:, :, None] << 5) | lanes[None, None, :]
    g = g.reshape(batch, -1)                               # [B, SB*32]
    wordidx = wordidx.reshape(batch, -1)

    counts = _popc32(g).sum(dim=1)
    overflow = too_deep | (n_blocks > sel_blocks) | (counts > max_rows)

    rows = []
    for _ in range(max_rows):
        enc = torch.where(g != 0, ((wordidx << 5) | _ctz32(g)) & MASK32,
                          MASK32)
        m = enc.min(dim=1).values                          # [B]
        rows.append(m)
        hit = enc == m[:, None]
        g = torch.where(hit, g & (g - 1), g)               # clear lowest bit

    cnt = torch.where(overflow, 0xF, counts.clamp(max=max_rows))
    if fmt16:
        # pack: word0 = count<<28 | row0; then rows 2-at-a-time per word
        row16 = [torch.where(r == MASK32, 0xFFFF, r & 0xFFFF) for r in rows]
        out = [(cnt << 28) | row16[0]]
        for i in range(1, max_rows, 2):
            hi = (row16[i + 1] if i + 1 < max_rows
                  else torch.full_like(cnt, 0xFFFF))
            out.append(((hi << 16) | row16[i]) & MASK32)
        return torch.stack(out, dim=1) & MASK32
    return torch.stack([cnt] + rows, dim=1)


# -- the engine's device bodies: word and compact forms -------------------
#
# Counterparts of ``sig_match_body`` and ``sig_match_compact_body`` in the
# JAX package's ``matching/sig.py``, which computes them in XLA, outside
# its Pallas kernels; here they are plain torch on the tables' device.
# ``consts`` is ``sig.device_tables``' output; ``planes`` its ``planes``
# entry (uint32[32, W] as int64). Tokens are the int64 uint32 values of
# ``token_tensor``; ``lens_enc`` the int8 length encoding (sign =
# '$'-flag, |value| = depth, 127 = too deep).


def sig_words(consts: dict, planes: torch.Tensor, toks: torch.Tensor,
              lengths: torch.Tensor, dollar: torch.Tensor) -> torch.Tensor:
    """[B, W] match words (uint32 as int64). The reference's
    concat-of-broadcasts expansion (``match_words``) is the same function
    as the gather form; a table with no device words gives one zero word
    per topic, as the reference's does."""
    if planes.shape[1] == 0:
        return torch.zeros((toks.shape[0], 1), dtype=torch.int64,
                           device=toks.device)
    return sig_match_words_gather(consts, planes, consts["grp_of_word"],
                                  toks, lengths, dollar)


def sig_match_body(consts: dict, planes: torch.Tensor, toks: torch.Tensor,
                   lengths: torch.Tensor, dollar: torch.Tensor,
                   max_words: int):
    """Word-form match of one batch tokenized at the engine's window
    (-1 pads, length -1 = too deep): (word_idx int32[B, K], word_val
    int32[B, K] carrying uint32 bits, overflow bool[B])."""
    from .dense import extract_nonzero_words

    words = sig_words(consts, planes, toks, lengths, dollar)
    return extract_nonzero_words(to_int32_bits(words), lengths, max_words)


def _split_lens(lens_enc: torch.Tensor):
    """(lengths int64, dollar, too_deep) of an int8 length encoding."""
    le = lens_enc.to(torch.int64)
    lengths = le.abs()
    return lengths, le < 0, lengths >= 127


def sig_match_compact_body(consts: dict, planes: torch.Tensor,
                           toks: torch.Tensor, lens_enc: torch.Tensor,
                           max_word_slots: int, max_rows: int, cap: int):
    """Transfer-minimal match: (counts uint8[B] with 255 = overflow,
    stream int32[cap] of row ids, total int32 scalar).

    Per topic the ``max_word_slots`` lowest nonzero words are expanded to
    candidate rows and the ``max_rows`` lowest kept; a topic too deep,
    with more nonzero words or with more rows overflows. The kept rows of
    the non-overflow topics are compacted, in (topic, slot) order, to the
    front of the stream; ``total`` counts them (> cap: the batch
    overflowed the stream). The compaction is an exclusive cumsum and a
    scatter, with no host synchronisation.

    Only ``stream[:min(total, cap)]`` is defined. The reference fills the
    tail with the rows of invalid slots, which depend on how ``top_k``
    orders its tied -1 keys (``torch.topk`` on CUDA promises no order
    among equal keys either); here the tail is 0. No consumer reads past
    ``total``."""
    lengths, dollar, too_deep = _split_lens(lens_enc)
    words = sig_words(consts, planes, toks, lengths, dollar)
    batch, n_words = words.shape
    dev = words.device

    nz = words != 0
    n_nz = nz.sum(dim=1)
    key = torch.where(nz, (1 << 30) - torch.arange(
        n_words, dtype=torch.int32, device=dev)[None, :], -1).to(torch.int32)
    slots = min(max_word_slots, n_words)
    # valid keys are distinct, so the picked nonzero words come out in
    # ascending word order; the -1 picks are zeroed
    topv, topi = torch.topk(key, slots, dim=1)
    wvals = torch.where(topv > 0, torch.gather(words, 1, topi), 0)

    bit = torch.arange(32, dtype=torch.int64, device=dev)[None, None, :]
    valid = ((wvals[:, :, None] >> bit) & 1) == 1            # [B, S, 32]
    rowid = (topi[:, :, None].to(torch.int64) << 5) | bit
    valid = valid.reshape(batch, -1)
    rowid = rowid.reshape(batch, -1)

    counts = valid.sum(dim=1)
    overflow = too_deep | (n_nz > slots) | (counts > max_rows)

    key2 = torch.where(valid, (1 << 30) - torch.arange(
        rowid.shape[1], dtype=torch.int32, device=dev)[None, :],
        -1).to(torch.int32)
    v2, i2 = torch.topk(key2, max_rows, dim=1)               # [B, R]
    rows_k = torch.gather(rowid, 1, i2)
    valid_k = ((v2 > 0) & ~overflow[:, None]).reshape(-1)

    pos = torch.cumsum(valid_k.to(torch.int64), 0) - 1
    pos = torch.where(valid_k & (pos < cap), pos, cap)
    stream = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    stream.scatter_(0, pos, rows_k.reshape(-1).to(torch.int32))

    counts_u8 = torch.where(overflow, 255,
                            counts.clamp(max=254)).to(torch.uint8)
    total = torch.where(overflow, 0, counts).sum().to(torch.int32)
    return counts_u8, stream[:cap], total

