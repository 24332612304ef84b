"""Device prologue of the signature matcher in plain PyTorch: per-topic,
per-group signatures (``topic_signatures``), validity poisoning
(``adjusted_signatures``) and the 16-bit fold with lane replication that
feeds the packed plane compare.

Counterparts: ``topic_signatures`` / ``adjusted_signatures`` in the JAX
package's ``matching/sig.py`` and the fold in ``sig_pallas.build_fixed_fn``.

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
