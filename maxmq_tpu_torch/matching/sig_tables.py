"""Host half of the signature matcher: table compiler, host probes,
candidate verification and the staleness overlay.

Copy of the JAX-free host code of the JAX package's ``matching/sig.py``
(its device half lives in ``sig_torch.py`` and ``sig_kernel.py`` here).
The tokenizer, probes and decode run in the port's native runtime
(``native.py``: the fused C++ tokenize + probe, the C '#' probe, the C
verify + union decode) when it is built, and as the numpy paths, their
exact twins, otherwise.

Wildcard matching as grouped hash-equality: filters are grouped by
*shape* — (has-'#', depth-or-prefix-len, set of literal positions) — and
within a group, matching is equality of one uint32 signature, a
random-odd-multiplier linear hash of the literal-level token ids (+ the
depth for exact groups). Exact and '+' shapes are host equality probes
(one searchsorted per group); the device keeps only the '#'-prefix
groups, whose candidate count per topic is combinatorial. Collisions
cannot corrupt results: every candidate row is re-verified against the
topic before its entries are unioned.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from .nfa import Entry, EntryBuilder
from .topics import (intern_level, split_levels, tokenize_cached,
                     tokenize_topics)
from .trie import SubscriberSet, TopicIndex, merge_subscription

MAX_GROUPS = 4096   # compile guard: pathological corpora fall back (engine)
DEPTH_CAP = 63      # deepest literal level any compiled group may inspect
                    # (the compact tokenizer's int8 length encoding bound)


def _group_constants(key: tuple[bool, int, tuple[int, ...]],
                     size: int) -> np.ndarray:
    """Deterministic (process-independent) random odd uint32 multipliers for
    one group shape: the first len(kept) are per-level coefficients, the
    last is the exact-group depth coefficient."""
    rng = np.random.default_rng((0x5EED, int(key[0]), key[1], *key[2]))
    c = rng.integers(0, 1 << 32, size=size, dtype=np.uint32)
    return c | np.uint32(1)


W16_MAX_GROUP_ROWS = 512  # beyond this a collision-free 16-bit image is
                          # birthday-improbable (p_fail/try ~ 1-e^(-n^2/2^17))
_W16_FOLD_TRIES = 8
_W16_PAD = np.uint16(0xFFFF)    # pad-row poison in the 16-bit planes


def _fold16(sig: np.ndarray, mult) -> np.ndarray:
    """Multiply-shift fold of uint32 signatures to 16 bits. The topic
    side computes the same (sig * mult) >> 16 on device, so fold
    equality is exactly plane equality."""
    with np.errstate(over="ignore"):
        return ((sig * np.uint32(mult)) >> np.uint32(16)).astype(np.uint16)


def _pick_fold16(g: "GroupSpec", sigs: np.ndarray):
    """(mult, sig16) for a group whose signatures fit 16 bits: an odd
    multiply-shift fold that is injective on the group's row signatures
    (one word then still holds at most one true match) and avoids the
    0xFFFF pad poison — or None (the group keeps 32-bit planes)."""
    if not 0 < len(sigs) <= W16_MAX_GROUP_ROWS:
        return None
    rng = np.random.default_rng((0x16B1, int(g.is_hash), g.depth,
                                 *g.kept))
    for m in rng.integers(0, 1 << 32, size=_W16_FOLD_TRIES,
                          dtype=np.uint32):
        m = int(m) | 1
        f = _fold16(sigs, m)
        if (f != _W16_PAD).all() and len(np.unique(f)) == len(f):
            return m, f
    return None


@dataclass
class GroupSpec:
    """One wildcard shape: every filter in it matches by signature equality."""

    is_hash: bool            # trailing '#'
    depth: int               # exact depth, or '#'-prefix length
    kept: tuple[int, ...]    # literal (non-'+') level positions
    coef: np.ndarray         # uint32[len(kept)] per-position multipliers
    depth_coef: int          # uint32 multiplier on depth (0 for '#' groups)
    wild_first: bool         # level 0 is a wildcard => '$'-topic exclusion
    rows: list[int] = None   # row ids (padded layout), filled by compiler

    def signature(self, toks: np.ndarray) -> np.ndarray:
        """Host-side signature of token rows [N, >=depth] (uint32 wrap)."""
        sig = np.zeros(toks.shape[0], dtype=np.uint32)
        with np.errstate(over="ignore"):
            for c, pos in zip(self.coef, self.kept):
                sig += c * toks[:, pos].astype(np.uint32)
            if not self.is_hash:
                sig += np.uint32(self.depth_coef) * np.uint32(self.depth)
        return sig


@dataclass
class HostExactGroup:
    """Full-exact filters of one depth (no wildcards): one vectorized
    searchsorted on host."""

    depth: int
    spec: GroupSpec
    sigs: np.ndarray       # uint32[n] SORTED signatures
    rows: np.ndarray       # int32[n] row ids aligned with sigs


@dataclass
class HostPlusProbe:
    """All '+'-shape groups of one exact depth (or, in ``host_hash``, all
    '#'-groups of one prefix length), vectorized for the host probe."""

    depth: int
    coef: np.ndarray       # uint32[K, depth] multipliers (0 at '+' slots)
    dc: np.ndarray         # uint32[K] depth-term addends (dc * depth)
    wildf: np.ndarray      # bool[K] level-0 is '+': '$'-topic exclusion
    sigs: list             # K SORTED uint32 signature arrays
    rows: list             # K int32 row-id arrays aligned with sigs


@dataclass
class SigTables:
    """Compiled signature matcher + host-side decode tables."""

    groups: list[GroupSpec]
    # device-ready constants (host numpy; device_tables uploads them)
    topo_coef: np.ndarray     # uint32[G, Lmax] per-level multipliers (0=off)
    depth_coef: np.ndarray    # uint32[G] depth multipliers (0 for '#')
    min_depth: np.ndarray     # int32[G] required depth ('#': >=, exact: ==)
    is_hash: np.ndarray       # bool[G]
    wild_first: np.ndarray    # bool[G]
    row_sig: np.ndarray       # uint32[R_padded] per-row signatures
    group_words: np.ndarray   # int32[G] word count per group (R_g/32)
    row_entries: list[tuple[int, ...]]    # row id -> entry indices
    row_levels: list[tuple[str, ...] | None]  # row id -> filter levels
    entries: list[Entry]
    vocab: dict[str, int]
    n_rows: int               # padded DEVICE row count (== 32 * words);
                              # host-probed rows use ids >= n_rows
    max_depth: int            # deepest literal position device groups read
    host_exact: dict[int, HostExactGroup] = None   # depth -> group
    version: int = -1
    host_plus: dict = None    # depth -> HostPlusProbe ('+'-shape groups)
    host_hash: dict = None    # depth -> HostPlusProbe over the DEVICE
                              # '#'-groups (the device-free probe path)
    probe_depth: int = 0      # deepest literal position ANY group reads
                              # (device or host_plus) = tokenizer window
    # dual-width planes: groups whose signatures admit an injective
    # 16-bit fold get packed 16-bit plane tables (two rows per uint32
    # word); groups are laid out 32-bit-first so each width is
    # contiguous in word space
    group_w16: np.ndarray = None   # bool[G] 16-bit-plane-eligible
    fold_mult: np.ndarray = None   # uint32[G] odd fold mults (0 = 32-bit)
    row_sig16: np.ndarray = None   # uint16[R_padded] folded row sigs
                                   # (0xFFFF pad poison; 0 for 32-bit
                                   # groups' rows — never compared)
    # host decode arrays derived from the fields above, built at first
    # use (``_verify_arrays``, ``_decode_cache``)
    verify_arrays: tuple = None
    decode_arrays: tuple = None

    def tokenize(self, topics: list[str], max_levels: int):
        """The word path's tokens: int32[B, max_levels] with -1 pads,
        lengths (-1 = deeper than ``max_levels``) and '$'-flags."""
        return tokenize_cached(self, topics, max_levels)


def compile_sig(index, version: int | None = None,
                vocab: dict[str, int] | None = None,
                max_levels: int = 16) -> SigTables:
    if version is None:
        from .trie import subs_version
        version = subs_version(index)
    return compile_sig_subscriptions(index.all_subscriptions(), version,
                                     vocab=vocab, max_levels=max_levels)


def compile_sig_subscriptions(subs, version: int = 0,  # qa: complex
                              vocab: dict[str, int] | None = None,
                              max_levels: int = 16) -> SigTables:
    """Build signature tables from a subscription snapshot of
    (filter, client_id, subscription, group) entries."""
    builder = EntryBuilder()
    if vocab is None:
        vocab = {}

    # one row per unique filter path; group rows by wildcard shape
    filt_row: dict[str, int] = {}
    row_bits: list[list[int]] = []
    row_filt: list[tuple[str, ...]] = []
    for filt, client_id, sub, group in subs:
        # `filt` is the trie path: already '$share'-stripped for shared subs
        bit = builder.add(filt, client_id, sub, group)
        r = filt_row.get(filt)
        if r is None:
            r = filt_row[filt] = len(row_bits)
            row_bits.append([])
            row_filt.append(tuple(split_levels(filt)))
        if bit is not None:
            row_bits[r].append(bit)

    group_map: dict[tuple, GroupSpec] = {}
    group_rows: dict[tuple, list[int]] = {}
    deep_rows: list[int] = []    # filters beyond the depth cap: CPU-only
    for r, levels in enumerate(row_filt):
        is_hash = bool(levels) and levels[-1] == "#"
        lits = levels[:-1] if is_hash else levels
        depth = len(lits)
        if depth > DEPTH_CAP:
            # such filters only match topics deeper than DEPTH_CAP, which
            # every tokenizer flags as overflow -> CPU fallback covers them
            deep_rows.append(r)
            continue
        kept = tuple(i for i, lv in enumerate(lits) if lv != "+")
        for i in kept:
            intern_level(vocab, lits[i])
        key = (is_hash, depth, kept)
        spec = group_map.get(key)
        if spec is None:
            coef = _group_constants(key, len(kept) + 1)
            spec = GroupSpec(
                is_hash=is_hash, depth=depth, kept=kept,
                coef=coef[:-1], depth_coef=0 if is_hash else int(coef[-1]),
                wild_first=(depth == 0 and is_hash) or
                           (depth > 0 and 0 not in kept))
            group_map[key] = spec
            group_rows[key] = []
        group_rows[key].append(r)

    # exact-shape groups (no trailing '#') leave the device: full-literal
    # groups via the per-depth searchsorted (HostExactGroup), '+' groups
    # via the per-(depth, shape) probe (HostPlusProbe). The device keeps
    # only '#'-prefix groups, the combinatorial wildcard dimension.
    exact_keys = [k for k, g in group_map.items()
                  if not g.is_hash and len(g.kept) == g.depth]
    host_specs = {k: group_map.pop(k) for k in exact_keys}
    host_rows = {k: group_rows.pop(k) for k in exact_keys}
    plus_keys = [k for k, g in group_map.items() if not g.is_hash]
    plus_specs = {k: group_map.pop(k) for k in plus_keys}
    plus_rows = {k: group_rows.pop(k) for k in plus_keys}

    # per-group signatures first: 16-bit plane eligibility needs them
    # BEFORE the padded layout is fixed, because eligible groups are
    # laid out after the 32-bit ones (contiguous word regions per width)
    staged = []
    for key, g in group_map.items():
        rows = group_rows[key]
        toks = np.zeros((len(rows), max(g.depth, 1)), dtype=np.int32)
        for j, r in enumerate(rows):
            levels = row_filt[r]
            lits = levels[:-1] if g.is_hash else levels
            for pos in g.kept:
                toks[j, pos] = vocab[lits[pos]]
        s = g.signature(toks)
        staged.append((g, rows, s, _pick_fold16(g, s)))
    # stable sort: 32-bit groups first, then the 16-bit-eligible ones
    staged.sort(key=lambda t: t[3] is not None)
    groups = [t[0] for t in staged]

    # padded row layout: groups contiguous, each padded to a multiple of 32
    max_depth = max((g.depth for g in groups), default=0)
    topo_coef = np.zeros((len(groups), max(max_depth, 1)), dtype=np.uint32)
    depth_coef = np.zeros(len(groups), dtype=np.uint32)
    min_depth = np.zeros(len(groups), dtype=np.int32)
    is_hash_a = np.zeros(len(groups), dtype=bool)
    wild_first = np.zeros(len(groups), dtype=bool)
    group_words = np.zeros(len(groups), dtype=np.int32)
    group_w16 = np.zeros(len(groups), dtype=bool)
    fold_mult = np.zeros(len(groups), dtype=np.uint32)

    row_entries: list[tuple[int, ...]] = []
    row_levels: list[tuple[str, ...] | None] = []
    sigs: list[np.ndarray] = []
    sigs16: list[np.ndarray] = []
    hash_sig_list: list[tuple[GroupSpec, np.ndarray]] = []
    for gi, (g, rows, s, fold) in enumerate(staged):
        for c, pos in zip(g.coef, g.kept):
            topo_coef[gi, pos] = c
        depth_coef[gi] = g.depth_coef
        min_depth[gi] = g.depth
        is_hash_a[gi] = g.is_hash
        wild_first[gi] = g.wild_first
        n_pad = (-len(rows)) % 32
        group_words[gi] = (len(rows) + n_pad) // 32
        for r in rows:
            row_entries.append(tuple(row_bits[r]))
            row_levels.append(row_filt[r])
        g.rows = list(range(len(row_entries) - len(rows),
                            len(row_entries)))
        hash_sig_list.append((g, s))
        # padding rows get a poison signature: an all-zero pad sig would
        # match any topic whose (adjusted) signature is 0 and flood the
        # match stream; 0xFFFFFFFF collides only at the 2^-32 baseline rate
        sigs.append(np.concatenate(
            [s, np.full(n_pad, 0xFFFFFFFF, dtype=np.uint32)]))
        if fold is not None:
            group_w16[gi] = True
            fold_mult[gi] = fold[0]
            s16 = fold[1]
        else:
            s16 = np.zeros(len(rows), dtype=np.uint16)
        sigs16.append(np.concatenate(
            [s16, np.full(n_pad, _W16_PAD, dtype=np.uint16)]))
        row_entries.extend(() for _ in range(n_pad))
        row_levels.extend(None for _ in range(n_pad))

    row_sig = (np.concatenate(sigs) if sigs
               else np.zeros(0, dtype=np.uint32))
    row_sig16 = (np.concatenate(sigs16) if sigs16
                 else np.zeros(0, dtype=np.uint16))
    n_device_rows = len(row_entries)

    host_exact: dict[int, HostExactGroup] = {}
    for key, spec in host_specs.items():
        rows = host_rows[key]
        d = spec.depth
        toks = np.zeros((len(rows), max(d, 1)), dtype=np.int32)
        ids = np.empty(len(rows), dtype=np.int32)
        for j, r in enumerate(rows):
            levels = row_filt[r]
            for pos in range(d):
                toks[j, pos] = vocab[levels[pos]]
            ids[j] = len(row_entries)
            row_entries.append(tuple(row_bits[r]))
            row_levels.append(levels)
        s = spec.signature(toks)
        order = np.argsort(s, kind="stable")
        host_exact[d] = HostExactGroup(depth=d, spec=spec,
                                       sigs=s[order], rows=ids[order])

    by_depth: dict[int, list] = {}
    for key, spec in plus_specs.items():
        by_depth.setdefault(spec.depth, []).append((spec, plus_rows[key]))
    host_plus: dict[int, HostPlusProbe] = {}
    for d, entries_d in by_depth.items():
        k_n = len(entries_d)
        coef = np.zeros((k_n, max(d, 1)), dtype=np.uint32)
        dc = np.zeros(k_n, dtype=np.uint32)
        wildf = np.zeros(k_n, dtype=bool)
        sig_arrs, row_arrs = [], []
        for k, (spec, rows) in enumerate(entries_d):
            for c, pos in zip(spec.coef, spec.kept):
                coef[k, pos] = c
            with np.errstate(over="ignore"):
                dc[k] = np.uint32(spec.depth_coef) * np.uint32(d)
            wildf[k] = spec.wild_first
            toks = np.zeros((len(rows), max(d, 1)), dtype=np.int32)
            ids = np.empty(len(rows), dtype=np.int32)
            for j, r in enumerate(rows):
                levels = row_filt[r]
                for pos in spec.kept:
                    toks[j, pos] = vocab[levels[pos]]
                ids[j] = len(row_entries)
                row_entries.append(tuple(row_bits[r]))
                row_levels.append(levels)
            s = spec.signature(toks)
            order = np.argsort(s, kind="stable")
            sig_arrs.append(s[order])
            row_arrs.append(ids[order])
        host_plus[d] = HostPlusProbe(depth=d, coef=coef, dc=dc, wildf=wildf,
                                     sigs=sig_arrs, rows=row_arrs)

    # Sorted host views of the device '#'-groups (same rows, same
    # signatures — just argsorted): the device-free probe path
    # (host_hash_rows) used by the batcher's low-occupancy bypass.
    # dc=0 (hash groups carry no depth term); applicability is depth >= d.
    hash_by_depth: dict[int, list] = {}
    for g, s in hash_sig_list:
        hash_by_depth.setdefault(g.depth, []).append((g, s))
    host_hash: dict[int, HostPlusProbe] = {}
    for d, entries_d in hash_by_depth.items():
        k_n = len(entries_d)
        coef = np.zeros((k_n, max(d, 1)), dtype=np.uint32)
        dc = np.zeros(k_n, dtype=np.uint32)
        wildf = np.zeros(k_n, dtype=bool)
        sig_arrs, row_arrs = [], []
        for k, (g, s) in enumerate(entries_d):
            for c, pos in zip(g.coef, g.kept):
                coef[k, pos] = c
            wildf[k] = g.wild_first
            ids = np.asarray(g.rows, dtype=np.int32)
            order = np.argsort(s, kind="stable")
            sig_arrs.append(s[order])
            row_arrs.append(ids[order])
        host_hash[d] = HostPlusProbe(depth=d, coef=coef, dc=dc,
                                     wildf=wildf, sigs=sig_arrs,
                                     rows=row_arrs)

    # deep filters (beyond DEPTH_CAP) only match topics the tokenizer
    # flags as overflow; they live in rows past the device region too so
    # decode can still resolve them after a CPU fallback
    tables = SigTables(
        groups=groups, topo_coef=topo_coef, depth_coef=depth_coef,
        min_depth=min_depth, is_hash=is_hash_a, wild_first=wild_first,
        row_sig=row_sig, group_words=group_words,
        group_w16=group_w16, fold_mult=fold_mult, row_sig16=row_sig16,
        row_entries=row_entries, row_levels=row_levels,
        entries=builder.entries, vocab=vocab, n_rows=n_device_rows,
        max_depth=max_depth, host_exact=host_exact, version=version,
        host_plus=host_plus, host_hash=host_hash,
        # the tokenizer window must cover every literal position any
        # probe reads: device '#' prefixes, '+' shapes AND full-exact
        # depths
        probe_depth=max([max_depth] + [d for d in host_plus]
                        + [d for d in host_exact]))
    tables.deep_rows = deep_rows
    return tables


def exact_sigs(host_exact: dict, toks32: np.ndarray,
               lengths: np.ndarray) -> np.ndarray:
    """uint32[B] exact-group signature per topic (0 where the topic's
    depth has no full-exact group — callers mask by depth, not by 0)."""
    sigs = np.zeros(len(lengths), dtype=np.uint32)
    for d, g in (host_exact or {}).items():
        sel = np.nonzero(lengths == d)[0]
        if sel.size:
            sigs[sel] = g.spec.signature(toks32[sel])
    return sigs


def host_exact_rows(tables: SigTables, toks32: np.ndarray,
                    lengths: np.ndarray) -> list[np.ndarray]:
    """For each topic, the candidate rows among full-exact filters, from
    the word path's tokens (one searchsorted per exact-depth group;
    collisions are verified in the decode like every other candidate)."""
    sigs = exact_sigs(tables.host_exact, toks32, lengths)
    return host_exact_rows_from_sig(tables, sigs, lengths)


def _scatter_hits(out: list, ti_parts: list, row_parts: list) -> list:
    """Distribute (topic-id, row-id) hit pairs into the per-topic list
    with O(#hit-topics) python work (one argsort + np.split views)."""
    if not ti_parts:
        return out
    ti = np.concatenate(ti_parts)
    rw = np.concatenate(row_parts)
    order = np.argsort(ti, kind="stable")
    ti = ti[order]
    rw = rw[order]
    cuts = np.flatnonzero(ti[1:] != ti[:-1]) + 1
    pieces = np.split(rw, cuts)
    for t, piece in zip(ti[np.concatenate([[0], cuts])], pieces):
        prev = out[t]
        out[t] = piece if not len(prev) else np.concatenate([prev, piece])
    return out


def host_exact_rows_from_sig(tables: SigTables, esig: np.ndarray,
                             lengths: np.ndarray) -> list[np.ndarray]:
    """For each topic, the candidate rows among full-exact filters (one
    searchsorted per exact-depth group over the topics' exact-group
    signatures ``esig``)."""
    out: list[np.ndarray] = [_EMPTY_ROWS] * len(lengths)
    ti_parts: list[np.ndarray] = []
    row_parts: list[np.ndarray] = []
    for d, g in (tables.host_exact or {}).items():
        sel = np.nonzero(lengths == d)[0]
        if not sel.size:
            continue
        _probe_sorted_sigs(g.sigs, g.rows, esig[sel], sel, ti_parts,
                           row_parts)
    return _scatter_hits(out, ti_parts, row_parts)


_EMPTY_ROWS = np.zeros(0, dtype=np.int32)


def host_plus_rows(tables: SigTables, toks: np.ndarray, lengths: np.ndarray,
                   dollar: np.ndarray, into: list | None = None,
                   ge: bool = False) -> list:
    """Vectorized shape probe: for each topic, candidate rows by hashed
    signature equality (per group: one uint32 signature + one
    searchsorted). ``toks`` may be any integer dtype. Appends into
    ``into`` (per-topic arrays) when given.

    ``ge=False`` probes the host-resident '+'-shape groups (applicability
    depth == d). ``ge=True`` probes the '#'-groups (tables.host_hash):
    applicability becomes depth >= d — the trailing-'#' rule incl. the
    depth-d parent match [MQTT-4.7.1.2]."""
    out: list = [_EMPTY_ROWS] * len(lengths) if into is None else into
    width = toks.shape[1]
    ti_parts: list[np.ndarray] = []
    row_parts: list[np.ndarray] = []
    probes = tables.host_hash if ge else tables.host_plus
    for d, p in (probes or {}).items():
        if d > width:
            # deeper shapes only match topics the tokenizer flagged
            # as overflow -> served by the CPU fallback
            continue
        sel = np.nonzero(lengths >= d if ge else lengths == d)[0]
        if not sel.size:
            continue
        t = toks[sel, :max(d, 1)].astype(np.uint32)
        with np.errstate(over="ignore"):
            sig_all = t @ p.coef.T + p.dc[None, :]       # [n, K] wrapping
        dol = dollar[sel]
        for k in range(len(p.sigs)):
            _probe_sorted_sigs(p.sigs[k], p.rows[k], sig_all[:, k], sel,
                               ti_parts, row_parts,
                               dol if p.wildf[k] else None)
    return _scatter_hits(out, ti_parts, row_parts)


def _probe_sorted_sigs(sigs_k: np.ndarray, rows_k: np.ndarray,
                       sig: np.ndarray, sel: np.ndarray, ti_parts: list,
                       row_parts: list,
                       dol: np.ndarray | None = None) -> None:
    """Binary-search a sorted signature array, appending (topic, row)
    hit arrays; signature collisions expand to every colliding row.
    ``dol`` masks '$'-prefixed topics out when given [MQTT-4.7.1-1]."""
    lo = np.searchsorted(sigs_k, sig, side="left")
    ok = (lo < len(sigs_k)) & (sigs_k[
        np.minimum(lo, len(sigs_k) - 1)] == sig)
    if dol is not None:
        ok &= ~dol
    hits = np.nonzero(ok)[0]
    if not hits.size:
        return
    hi = np.searchsorted(sigs_k, sig[hits], side="right")
    lo = lo[hits]
    single = hi - lo == 1                 # collided filters are rare
    ti_parts.append(sel[hits[single]])
    row_parts.append(rows_k[lo[single]])
    for j, l0, h in zip(hits[~single], lo[~single], hi[~single]):
        ti_parts.append(np.full(h - l0, sel[j], dtype=np.int64))
        row_parts.append(rows_k[l0:h])


def host_hash_rows(tables: SigTables, toks: np.ndarray,
                   lengths: np.ndarray, dollar: np.ndarray,
                   into: list | None = None) -> list:
    """Host probe of the DEVICE '#'-groups: host_plus_rows in ge mode.
    Exact + '+' + '#' probes together cover every group, so a batch too
    small to amortize a device round trip never has to leave the host."""
    return host_plus_rows(tables, toks, lengths, dollar, into=into,
                          ge=True)


def _compact_dtype(tables) -> tuple[type, int]:
    """(token dtype, pad value) of the compact token matrix: the dtype
    adapts to the vocab (uint8 < 250 ids, uint16 < 65000, else int32)."""
    nv = len(tables.vocab)
    if nv < 250:
        return np.uint8, 255
    if nv < 65000:
        return np.uint16, 65535
    return np.int32, -1


def tokenize_compact(tables, topics: list[str], window: int | None = None):
    """Host-side compact topic prep: (toks, lens_enc, toks32, lengths).

    toks: [B, window] level tokens, pad = the dtype's max (``_compact_dtype``);
    lens_enc: int8[B] — the sign carries the '$'-flag, |value| is the TRUE
    topic depth (up to 63; 127 = deeper, overflow). toks32/lengths are the
    wide form that also feeds the host-exact probe."""
    if window is None:
        window = max(tables.probe_depth, 1)
    toks32, lengths, dollar = tokenize_topics(tables.vocab, topics,
                                              DEPTH_CAP)
    dtype, pad = _compact_dtype(tables)
    w = toks32[:, :window]
    toks = np.where(w < 0, pad, w).astype(dtype)
    true_len = np.where(lengths < 0, 127, lengths).astype(np.int8)
    lens_enc = np.where(dollar, -true_len, true_len).astype(np.int8)
    return toks, lens_enc, toks32, lengths


# topics prepared by ``prepare_batch`` / ``prepare_batch_sig``, per route:
# "native" where the C++ pass served the whole host half, "numpy" else
prepared = {"native": 0, "numpy": 0}


def prepare_batch_sig(tables, topics: list[str], window: int | None = None,
                      host_exact: dict | None = None):
    """Host half of the word path, signature form: (toks, lens_enc, esig,
    lengths), with ``esig`` the topics' exact-group signatures. One C++
    pass (tokens + exact-group signatures) when the native runtime is
    built; numpy otherwise. ``prepared`` counts the topics of each route.

    ``window``/``host_exact`` override the tables' own (the sharded engine
    passes the mesh-wide maxima/union — exact-group coefficients are
    deterministic functions of the group shape, so one signature per depth
    serves every shard). Too-deep topics report ``lengths`` -1."""
    if window is None:
        window = max(tables.probe_depth, 1)
    if host_exact is None:
        host_exact = tables.host_exact or {}
    ns = tables.__dict__.get("_native_sig", False)
    if ns is False:
        ns = None
        try:
            from ..native import ExactSigTable, NativeVocab, available
            if available():
                # share the C++ vocab mirror with the word path
                # (tokenize_cached caches it under _native_vocab) instead
                # of marshalling the whole vocab into C++ twice
                nv = tables.__dict__.get("_native_vocab") or \
                    NativeVocab(tables.vocab)
                tables.__dict__.setdefault("_native_vocab", nv)
                ns = (nv, ExactSigTable(host_exact))
        except Exception:
            ns = None
        tables.__dict__["_native_sig"] = ns
    if ns is None:
        prepared["numpy"] += len(topics)
        return _prepare_sig_numpy(tables, topics, window, host_exact)
    prepared["native"] += len(topics)
    from ..native import tokenize_sig
    dtype, _pad = _compact_dtype(tables)
    toks, lens_enc, esig = tokenize_sig(ns[0], topics, window, dtype, ns[1])
    lengths = np.abs(lens_enc.astype(np.int32))
    lengths[lengths >= 127] = -1
    return toks, lens_enc, esig, lengths


def _prepare_sig_numpy(tables, topics: list[str], window: int,
                       host_exact: dict):
    """The numpy form of ``prepare_batch_sig``."""
    toks, lens_enc, toks32, lengths = tokenize_compact(tables, topics, window)
    return toks, lens_enc, exact_sigs(host_exact, toks32, lengths), lengths


class HostRows:
    """CSR view of the host probe's per-topic candidate rows: O(1) python
    work per batch instead of one list entry per topic. Indexes and
    iterates like the list of per-topic arrays the numpy probes give."""

    __slots__ = ("offsets", "rows")

    def __init__(self, offsets: np.ndarray, rows: np.ndarray) -> None:
        self.offsets = offsets        # int64[n + 1]
        self.rows = rows              # int32[total hits]

    @classmethod
    def from_hits(cls, n: int, ti: np.ndarray, rows: np.ndarray
                  ) -> "HostRows":
        counts = np.bincount(ti, minlength=n)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return cls(offsets, rows)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i: int) -> np.ndarray:
        return self.rows[self.offsets[i]:self.offsets[i + 1]]

    def __iter__(self):
        for i in range(len(self)):
            yield self.rows[self.offsets[i]:self.offsets[i + 1]]


def _native_fused(tables):
    """(NativeVocab, NativeProbe) pair for the fused single-pass host
    half, or None. Cached per compiled-table snapshot."""
    fused = tables.__dict__.get("_native_fused", False)
    if fused is not False:
        return fused
    fused = None
    try:
        from ..native import NativeProbe, NativeVocab, available
        if available():
            nv = tables.__dict__.get("_native_vocab") or \
                NativeVocab(tables.vocab)
            tables.__dict__.setdefault("_native_vocab", nv)
            fused = (nv, NativeProbe(tables.host_exact or {},
                                     tables.host_plus or {}))
    except Exception:
        fused = None
    tables.__dict__["_native_fused"] = fused
    return fused


def _native_hash_probe(tables):
    """NativeProbe over the '#'-groups in depth->= mode (the C twin of
    host_hash_rows), or None. Cached per compiled-table snapshot. Only
    the device-free path runs it — the device still owns '#'-matching
    for batched dispatches."""
    probe = tables.__dict__.get("_native_hash_probe", False)
    if probe is not False:
        return probe
    probe = None
    try:
        from ..native import NativeProbe, available
        if available() and tables.host_hash is not None:
            probe = NativeProbe({}, tables.host_hash, ge_depth=True)
    except Exception:
        probe = None
    tables.__dict__["_native_hash_probe"] = probe
    return probe


def prepare_batch(tables, topics: list[str]):
    """Full host half of the fixed path: (toks, lens_enc, hostrows).
    hostrows unions the full-exact probe and the '+'-shape probe —
    everything the device does not carry. One fused C++ pass (tokenize +
    probe with the level tokens in registers, hits as ``HostRows``) when
    the native runtime is built; numpy otherwise. ``prepared`` counts the
    topics of each route."""
    fused = _native_fused(tables)
    if fused is not None:
        prepared["native"] += len(topics)
        from ..native import tokenize_probe
        dtype, _pad = _compact_dtype(tables)
        window = max(tables.probe_depth, 1)
        toks, lens_enc, ti, rw = tokenize_probe(fused[0], fused[1], topics,
                                                window, dtype)
        return toks, lens_enc, HostRows.from_hits(len(topics), ti, rw)
    prepared["numpy"] += len(topics)
    toks, lens_enc, esig, lengths = _prepare_sig_numpy(
        tables, topics, max(tables.probe_depth, 1), tables.host_exact or {})
    hostrows = host_exact_rows_from_sig(tables, esig, lengths)
    host_plus_rows(tables, toks, lengths, lens_enc < 0, into=hostrows)
    return toks, lens_enc, hostrows


_VER_PLUS = -1    # '+' level in the verify tables: matches any token
_VER_ANY = -2     # position past the filter (or past the probe window)


def _verify_arrays(tables):
    """Row-side tables for the vectorized candidate verifier, built once
    per compiled snapshot (cached): per row, the literal token at each
    probe-window position (or PLUS/ANY), the required depth, exactness,
    and the '$'-exclusion flag. Together these reproduce
    ``topics.filter_matches_topic`` as pure array comparisons."""
    vt = tables.verify_arrays
    if vt is not None:
        return vt
    n_rows = len(tables.row_levels)
    window = max(tables.probe_depth, 1)
    tok = np.full((n_rows, window), _VER_ANY, dtype=np.int32)
    min_depth = np.zeros(n_rows, dtype=np.int32)
    exact = np.zeros(n_rows, dtype=bool)
    wild_first = np.zeros(n_rows, dtype=bool)
    valid = np.zeros(n_rows, dtype=bool)
    vocab = tables.vocab
    for r, levels in enumerate(tables.row_levels):
        if not levels:
            continue
        valid[r] = True
        is_hash = levels[-1] == "#"
        depth = len(levels) - 1 if is_hash else len(levels)
        min_depth[r] = depth
        exact[r] = not is_hash
        wild_first[r] = levels[0] in ("+", "#")
        for i in range(min(depth, window)):
            lv = levels[i]
            # a literal never in the vocab cannot exist post-compile; -3
            # (matches nothing) keeps even that case safe
            tok[r, i] = _VER_PLUS if lv == "+" else vocab.get(lv, -3)
    vt = (tok, min_depth, exact, wild_first, valid)
    tables.verify_arrays = vt
    return vt


def _decode_cache(tables):
    """Per-row fast-path decode arrays (cached per snapshot): for rows
    whose single entry is a plain (client, sub) with no v5 subscription
    identifier, the union is two dict ops."""
    dc = tables.decode_arrays
    if dc is not None:
        return dc
    entries = tables.entries
    cids: list[str | None] = []
    subs: list = []
    for ents in tables.row_entries:
        if len(ents) == 1:
            e = entries[ents[0]]
            if not e.group and e.subscription is not None \
                    and not e.subscription.identifier \
                    and not e.subscription.identifiers:
                cids.append(e.client_id)
                subs.append(e.subscription)
                continue
        cids.append(None)
        subs.append(None)
    dc = (cids, subs)
    tables.decode_arrays = dc
    return dc


def prewarm_tables(tables, chunk: int = 2048) -> int:
    """Chunked chained-decode anchor population for ONE compiled table
    (the shared engine-independent half of prewarm_decode_bases):
    yields the GIL between chunks so an event loop sharing the
    interpreter only stalls ~ms at a time. Returns chunk calls made."""
    import time as _time

    nd = _native_decode(tables)
    if nd is None:
        return 0
    mod, cap = nd
    n_rows = len(tables.row_entries)
    r = 0
    calls = 0
    while r < n_rows:
        r2 = mod.prewarm_bases(cap, r, chunk)
        calls += 1
        if r2 <= r:
            break                  # defensive: no forward progress
        r = r2
        _time.sleep(0)
    return calls


def _native_decode(tables):
    """(maxmq_torch_decode module, table capsule) for the C verify+union
    fast path, built once per compiled snapshot — or None when the
    extension is unavailable. Flattens every row's entry walk (the exact
    loop of ``_union_pairs``) into an action stream the C pass replays:
    PLAIN inserts, identifier MERGEs, SHARED-group inserts. The capsule's
    Py_buffer views keep the arrays alive."""
    nd = tables.__dict__.get("_native_decode", False)
    if nd is not False:
        return nd
    nd = None
    try:
        from ..native import decode_module
        mod = decode_module()
        # engage only when trie.py's import-time rebind took: decode
        # returns instances of mod.SubscriberSet, and mixing C results
        # with the python fallback class would split the result type
        if mod is not None and mod.SubscriberSet is SubscriberSet:
            tok, min_depth, exact, wild_first, valid = \
                _verify_arrays(tables)
            flags = (exact.astype(np.uint8)
                     | (wild_first.astype(np.uint8) << 1)
                     | (valid.astype(np.uint8) << 2))
            entries = tables.entries
            offsets = np.zeros(len(tables.row_entries) + 1,
                               dtype=np.int64)
            kinds: list[int] = []
            keys: list = []
            cids: list = []
            subs: list = []
            for r, ents in enumerate(tables.row_entries):
                for b in ents:
                    e = entries[b]
                    if e.group:
                        for cid, sub in e.candidates.items():
                            kinds.append(2)
                            keys.append((e.group, sub.filter))
                            cids.append(cid)
                            subs.append(sub)
                    else:
                        sub = e.subscription
                        kinds.append(1 if (sub.identifier
                                           or sub.identifiers) else 0)
                        keys.append(sub.filter)
                        cids.append(e.client_id)
                        subs.append(sub)
                offsets[r + 1] = len(kinds)
            cap = mod.table_new(
                np.ascontiguousarray(tok),
                np.ascontiguousarray(min_depth), flags, offsets,
                np.array(kinds, dtype=np.uint8), keys, cids, subs)
            # cached DeliveryIntents hold the capsule alive and the
            # capsule's caches hold them — an uncollectible cycle
            # (capsules aren't GC-tracked). Break it when the snapshot
            # is dropped; handed-out results stay valid.
            import weakref
            weakref.finalize(tables, mod.table_release, cap)
            nd = (mod, cap)
    except Exception:
        nd = None
    tables.__dict__["_native_decode"] = nd
    return nd


def _pairs_with_host(batch: int, ti_dev, rw_dev, hostrows, fall, tables):
    """Concatenate device pairs with the host-probe hits and drop
    fallback topics / out-of-table row ids (group-padded layouts emit
    padding row ids past the real table). ``hostrows`` is a ``HostRows``
    (the fused native probe) or a list of per-topic arrays."""
    if isinstance(hostrows, HostRows):
        offs = hostrows.offsets[:batch + 1]
        ti_h = np.repeat(np.arange(batch), np.diff(offs))
        rw_h = hostrows.rows[:offs[-1]].astype(np.int64)
    else:
        ti_h = np.repeat(np.arange(batch),
                         [len(h) for h in hostrows[:batch]])
        rw_h = (np.concatenate([np.asarray(h) for h in
                                hostrows[:batch]]).astype(np.int64)
                if len(ti_h) else np.empty(0, dtype=np.int64))
    ti = np.concatenate([ti_dev, ti_h])
    rw = np.concatenate([rw_dev, rw_h])
    keep = ~fall[ti] & (rw < len(tables.row_levels))
    return ti[keep], rw[keep]


def _candidate_pairs(batch: int, cnt, rows, hostrows, fall, tables):
    """Flatten the row-matrix form's device slots + the host-probe hits
    into (topic_idx, row_id) pair arrays, dropping fallback topics and
    out-of-table row ids."""
    kr = rows.shape[1]
    real = np.where(fall, 0, cnt).astype(np.int64)
    dmask = np.arange(kr, dtype=np.int64)[None, :] < real[:, None]
    ti_dev = np.repeat(np.arange(batch), real)
    rw_dev = rows[dmask].astype(np.int64)
    return _pairs_with_host(batch, ti_dev, rw_dev, hostrows, fall, tables)


def verify_pairs(tables, toks32, lengths, dollar, ti, rw) -> np.ndarray:
    """Vectorized ``filter_matches_topic`` over candidate (topic, row)
    pairs: ok[n] == the exact CPU check for topic ``ti[n]`` vs row
    ``rw[n]``."""
    tok, min_depth, exact, wild_first, valid = _verify_arrays(tables)
    rt = tok[rw]                                  # [N, W]
    tt = toks32[ti][:, :rt.shape[1]]              # [N, W]
    ok = ((rt == _VER_ANY) | (rt == _VER_PLUS) | (rt == tt)).all(axis=1)
    md = min_depth[rw]
    ln = lengths[ti]
    ok &= np.where(exact[rw], ln == md, ln >= md)
    ok &= ~(dollar[ti] & wild_first[rw])
    ok &= valid[rw]
    return ok


def _union_pairs(out, ti, rw, tables, removed=None) -> None:
    """Union verified candidate pairs into the per-topic SubscriberSets.
    Fast-path rows (single plain subscription) are two dict ops;
    ``removed`` drops (client, filter) pairs the overlay has removed."""
    entries = tables.entries
    row_entries = tables.row_entries
    fast_cid, fast_sub = _decode_cache(tables)
    dicts = [s.subscriptions for s in out]
    merge = merge_subscription
    for t, r in zip(ti.tolist(), rw.tolist()):
        cid = fast_cid[r] if removed is None else None
        if cid is not None:
            d = dicts[t]
            sub = fast_sub[r]
            cur = d.get(cid)
            d[cid] = sub if cur is None else merge(cur, sub, sub.filter)
            continue
        result = out[t]
        for b in row_entries[r]:
            entry = entries[b]
            if entry.group:
                for cid, sub in entry.candidates.items():
                    if removed and (cid, sub.filter) in removed:
                        continue
                    result.add_shared(entry.group, sub.filter, cid, sub)
            else:
                sub = entry.subscription
                if removed and (entry.client_id, sub.filter) in removed:
                    continue
                result.add(entry.client_id, sub, sub.filter)


class Overlay:
    """Host-side view of subscription mutations newer than the compiled
    tables, replayed from the TopicIndex journal: adds live in a small
    delta TopicIndex, removes/replaces in a (client_id, filter) set
    consulted during decode. A recompile runs in the background; once it
    swaps in, the overlay for the old tables is dropped."""

    def __init__(self, base_version: int) -> None:
        self.base = base_version        # construction base (tables version)
        self.version = base_version     # last applied sub_version
        self.delta = TopicIndex()
        self.removed: set[tuple[str, str]] = set()

    def apply(self, entries) -> None:
        for ver, op, client_id, filt, sub, _group, _path in entries:
            if ver <= self.version:
                continue
            self.version = ver
            # '+' doubles as replace: the stale tables may hold an older
            # subscription (different QoS/options) for the same pair
            self.removed.add((client_id, filt))
            if op == "+":
                self.delta.subscribe(client_id, sub)
            else:
                self.delta.unsubscribe(client_id, filt)

    @property
    def empty(self) -> bool:
        return not self.removed


class OverlayedEngine:
    """Staleness machinery: background recompile + journal overlay.
    Subclasses provide ``index``, ``refresh()``, ``_state``,
    ``_state_version`` and ``prewarm_decode_bases()``."""

    def _init_overlay(self) -> None:
        self._overlay: Overlay | None = None
        self._overlay_lock = threading.Lock()
        self._bg_thread: threading.Thread | None = None
        self.bg_refresh_errors = 0

    def refresh_soon(self) -> None:
        """Kick a background recompile if the tables are stale and none is
        already running. Never blocks the caller."""
        if not self._stale():
            return
        with self._overlay_lock:
            if self._bg_thread is not None and self._bg_thread.is_alive():
                return
            t = threading.Thread(target=self._bg_refresh, daemon=True,
                                 name="sig-refresh")
            self._bg_thread = t
            t.start()

    def _stale(self) -> bool:
        state = self._state
        return state is None or self._state_version(state) != \
            self.index.sub_version

    def close(self, timeout: float = 30.0) -> None:
        """Wait for in-flight background work (refresh AND bucket warm)."""
        for t in (self._bg_thread, getattr(self, "_warm_thread", None)):
            if t is not None and t.is_alive():
                t.join(timeout)

    def _bg_refresh(self) -> None:
        try:
            self.refresh()
            # a rotation swaps in fresh device tables: re-warm the
            # bucket ladder (still on this background thread)
            warm_max = getattr(self, "_warm_max", None)
            if warm_max:
                self.warm_buckets(warm_max, background=False)
            # repopulate the chained-decode anchors for the fresh table
            # off the hot path (chunked; yields the GIL)
            self.prewarm_decode_bases()
        except Exception:
            self.bg_refresh_errors += 1
        finally:
            with self._overlay_lock:
                ov = self._overlay
                if ov is not None and ov.version <= self._state_version(
                        self._state):
                    self._overlay = None

    def overlay_for(self, tables_version: int):
        """The overlay bringing ``tables_version`` up to the live index,
        or None when up to date, or the string "resync" when the journal
        no longer reaches back (serve the batch via the CPU trie)."""
        if self.index.sub_version == tables_version:
            return None
        if getattr(self, "auto_refresh", True):
            self.refresh_soon()
        with self._overlay_lock:
            ov = self._overlay
            # Key reuse on the construction base, not the applied-through
            # version: an overlay rebuilt against NEWER tables must not
            # serve a batch still holding OLD tables (the entries between
            # them would be in neither). Reusing an older-based overlay
            # is safe (replay is idempotent).
            if ov is None or ov.base > tables_version:
                ov = Overlay(tables_version)
            entries = self.index.journal_since(ov.version)
            if entries is None:
                return "resync"
            ov.apply(entries)
            self._overlay = ov
            return None if ov.empty else ov

    @staticmethod
    def _state_version(state) -> int:
        raise NotImplementedError
