"""Signature matcher engine: device-resident grouped hash-equality matching
bound to a TopicIndex, with the CPU trie as its exact fallback.

Counterpart of ``SigEngine`` in the JAX package's ``matching/sig.py``,
fixed-slot "stream" path only (the production path the MicroBatcher and
the matcher service drive). Per batch: host tokenize + exact/'+' probes
(``sig_tables.prepare_batch``), one device program (prologue, the
``sig_match_fixed`` CUDA kernel, stream compaction; ``sig_kernel``),
asynchronous fetch of the counts and the used front of the row stream,
then the host batch verify + entry union. Overflow topics, declined
corpora and journal gaps are served exactly by the CPU trie.

``device_tables`` turns a compiled table set's numpy arrays into the
device state — the "weights" of this system. It accepts the arrays of
either package's ``SigTables``, so both compute on identical state.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import numpy as np
import torch

from .. import faults
from . import sig_kernel
from .sig_tables import (MAX_GROUPS, OverlayedEngine, Overlay,
                         SigTables, _compact_dtype, _pairs_with_host,
                         _union_pairs, compile_sig, host_hash_rows,
                         prepare_batch, verify_pairs)
from .topics import batch_bucket as _batch_bucket
from .trie import SubscriberSet, TopicIndex, merge_subscription

_STREAM_CHUNK = 1 << 19    # rows per stream-slice fetch (2 MB of uint32)

TABLE_ARRAYS = ("topo_coef", "depth_coef", "min_depth", "is_hash",
                "wild_first", "row_sig", "row_sig16", "group_words",
                "group_w16", "fold_mult")


def _to_host(t: torch.Tensor, non_blocking: bool = False) -> torch.Tensor:
    """A device tensor's copy on the host (a CPU tensor as it is)."""
    if t.device.type == "cpu":
        return t
    return t.to("cpu", non_blocking=non_blocking)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises when CUDA is requested (explicitly or by
    default) and absent — entry points never fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA "
                           "device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def table_arrays(tables) -> dict[str, np.ndarray]:
    """The numpy arrays of a compiled ``SigTables`` (either package's)
    that ``device_tables`` reads."""
    return {name: getattr(tables, name) for name in TABLE_ARRAYS}


def device_tables(arrays: dict[str, np.ndarray], device) -> dict:
    """Device state of one compiled table set.

    Input: ``topo_coef``, ``depth_coef``, ``min_depth``, ``is_hash``,
    ``wild_first``, ``row_sig``, ``row_sig16``, ``group_words``,
    ``group_w16`` and ``fold_mult`` as compiled. Output: the prologue
    constants (uint32 values as int64), ``grp_of_word`` int32[n_words],
    the 32-bit plane table ``planes32`` int32[32, n_words] (plane j,
    column w = signature of row 32w+j; every word, so one table serves
    both kernel widths), and the packed 16-bit table ``planes16``
    int32[16, n_words16] of the trailing 16-bit region (plane j, column w
    = row 32w+j in the low half, row 32w+16+j in the high half)."""
    dev = torch.device(device)

    def u32(name):
        a = np.asarray(arrays[name], dtype=np.uint32).astype(np.int64)
        return torch.from_numpy(a).to(dev)

    def flag(name):
        return torch.from_numpy(np.asarray(arrays[name], dtype=bool)).to(dev)

    def bits32(a):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(a, dtype=np.uint32)).view(np.int32)).to(dev)

    gw = np.asarray(arrays["group_words"], dtype=np.int64)
    n_words = int(gw.sum())
    w16 = sig_kernel.width16_mask(gw, arrays.get("group_w16"))
    n_words16 = int(gw[w16].sum())
    n_words32 = n_words - n_words16
    row_sig = np.asarray(arrays["row_sig"], dtype=np.uint32)
    planes32 = row_sig[:32 * n_words].reshape(n_words, 32).T
    s16 = np.asarray(arrays["row_sig16"], dtype=np.uint32)[
        32 * n_words32:32 * n_words].reshape(n_words16, 32)
    planes16 = (s16[:, :16] | (s16[:, 16:] << np.uint32(16))).T
    grp_of_word = np.repeat(np.arange(len(gw), dtype=np.int32), gw)
    return {
        "device": dev,
        "topo_coef": u32("topo_coef"),
        "depth_coef": u32("depth_coef"),
        "min_depth": torch.from_numpy(np.asarray(
            arrays["min_depth"], dtype=np.int64)).to(dev),
        "is_hash": flag("is_hash"),
        "wild_first": flag("wild_first"),
        "fold_mult": u32("fold_mult"),
        "w16": torch.from_numpy(w16).to(dev),
        "grp_of_word": torch.from_numpy(grp_of_word).to(dev),
        "planes32": bits32(planes32),
        "planes16": bits32(planes16),
        "group_words": tuple(int(w) for w in gw),
    }


def pad_to_bucket(tables, toks8: np.ndarray, lens_enc: np.ndarray):
    """Pad a prepared batch to its bucket (the JAX package's ladder, so
    both pad alike). Pad rows are depth-1 '$'-topics of all-pad tokens:
    '$' excludes every wildcard-first group [MQTT-4.7.1-1/2] and no
    literal level can equal the reserved pad token, so pads match
    nothing and add nothing to the row stream."""
    b = len(lens_enc)
    bucket = _batch_bucket(b)
    if bucket == b:
        return toks8, lens_enc
    _dt, padval = _compact_dtype(tables)
    tp = np.full((bucket, *toks8.shape[1:]), padval, dtype=toks8.dtype)
    tp[:b] = toks8
    lp = np.full(bucket, -1, dtype=lens_enc.dtype)
    lp[:b] = lens_enc
    return tp, lp


def _row_fragment(tables, fragments: dict, row: int) -> SubscriberSet:
    """One row's entries unioned into a SubscriberSet, built at first use
    and kept in ``fragments`` (the snapshot's memo, ``_State.fragments``)."""
    frag = fragments.get(row)
    if frag is None:
        frag = SubscriberSet()
        _union_pairs([frag], np.zeros(1, dtype=np.int64),
                     np.array([row], dtype=np.int64), tables)
        fragments[row] = frag
    return frag


def _union_rowsets(batch: int, ti: np.ndarray, rw: np.ndarray, tables,
                   fragments: dict) -> list[SubscriberSet]:
    """Per-topic SubscriberSets of verified (topic, row) pairs, from
    memoized per-row fragments: a single-row topic gets the row's
    fragment itself; a multi-row topic merges its rows' fragments in pair
    order with ``merge_subscription``. The values equal the sequential
    union's: within a row each client appears once,
    ``merge_subscription(base, merge_subscription(None, s))`` equals
    ``merge_subscription(base, s)``, and '$share' (group, filter) keys
    never repeat across rows."""
    order = np.argsort(ti, kind="stable")        # pair order within a topic
    rows = rw[order].tolist()
    offs = np.zeros(batch + 1, dtype=np.int64)
    np.cumsum(np.bincount(ti, minlength=batch), out=offs[1:])
    offs = offs.tolist()
    out = []
    for t in range(batch):
        a, b = offs[t], offs[t + 1]
        if a == b:
            out.append(SubscriberSet())
            continue
        if b - a == 1:
            out.append(_row_fragment(tables, fragments, rows[a]))
            continue
        subs, shared = {}, {}
        for r in rows[a:b]:
            frag = _row_fragment(tables, fragments, r)
            for cid, sub in frag.subscriptions.items():
                cur = subs.get(cid)
                subs[cid] = sub if cur is None else merge_subscription(
                    cur, sub, sub.filter)
            shared.update(frag.shared)
        out.append(SubscriberSet(subs, shared))
    return out


class _State(NamedTuple):
    """One compiled snapshot. ``program`` is None when the corpus was
    declined (> MAX_GROUPS groups): the CPU trie serves it.
    ``fragments`` memoizes each row's entries unioned into a
    SubscriberSet (row -> set), filled at first use by the decode and
    dropped with the snapshot."""

    tables: SigTables
    program: object
    dev: dict | None            # device_tables output of the snapshot
    fragments: dict


class _Fetch(NamedTuple):
    """A batch's device->host copies in flight: the counts (host tensor),
    the device stream, the prefetched stream slices, and the event that
    marks their completion (None on the CPU)."""

    counts: torch.Tensor
    stream: torch.Tensor
    slices: list
    event: object


class _Dispatch(NamedTuple):
    """A dispatched batch, as ``collect_fixed`` needs it: the pending
    fetch, the host-probe rows, the snapshot it ran on (its tables and
    row-fragment memo), and the padded token matrix and length encoding
    (for the host verify)."""

    fetch: _Fetch
    hostrows: list
    tables: SigTables
    fragments: dict
    toks8: np.ndarray
    lens_enc: np.ndarray


class DeviceMatchingDeclined(RuntimeError):
    """``dispatch_fixed`` on a snapshot whose corpus was declined (more
    than MAX_GROUPS signature groups): the CPU trie serves it. The one
    condition the ``subscribers_*`` surface answers from the trie."""


@contextlib.contextmanager
def _device_errors(what: str):
    """A RuntimeError raised by torch/CUDA inside the block (a kernel
    fault surfacing at a copy, an event or a synchronise) is re-raised as
    ``faults.DeviceMatchError``, so no caller mistakes a sick device for a
    condition the trie may serve."""
    try:
        yield
    except faults.DeviceMatchError:
        raise
    except RuntimeError as exc:
        raise faults.DeviceMatchError(
            f"{what} failed: {exc!r:.300}") from exc


class SigEngine(OverlayedEngine):
    """Device-resident signature matcher bound to a TopicIndex.

    ``device`` is where the tables live and the kernel runs: the card by
    default; ``"cpu"`` runs the kernel's plain version (and must be asked
    for). ``fixed_max_rows`` (1..14) bounds the device rows per topic;
    topics with more overflow to the CPU trie. ``kernel_width`` "auto"
    compares 16-bit-eligible groups against packed planes, "32" forces
    uniform 32-bit planes."""

    def __init__(self, index: TopicIndex, device=None,
                 auto_refresh: bool = True, fixed_max_rows: int = 7,
                 kernel_width: str = "auto") -> None:
        self.index = index
        self.device = resolve_device(device)
        self.auto_refresh = auto_refresh
        if not 1 <= fixed_max_rows <= 14:
            # the chunk kernels' 4-bit count reserves 0xF for overflow;
            # the same bound keeps this port's output identical to theirs
            raise ValueError("fixed_max_rows must be in [1, 14]")
        self.fixed_max_rows = fixed_max_rows
        if kernel_width not in ("auto", "32"):
            raise ValueError("kernel_width must be 'auto' or '32'")
        self.kernel_width = kernel_width
        self.kernel_plan = None    # sig_kernel.plan of the live program
        # auto-route TINY corpora to the CPU trie: a few hundred
        # subscriptions never amortize table compiles and device batches
        self.route_small = True
        self.trie_routed = 0
        self._state: _State | None = None
        self._refresh_lock = threading.Lock()
        self.fallbacks = 0
        self.matches = 0
        self.host_matches = 0     # topics served by the device-free path
        # rows-count hint for the stream prefetch (see dispatch_fixed)
        self._stream_rows_hint = _STREAM_CHUNK
        self._init_overlay()
        self.refresh(force=True)

    @staticmethod
    def _state_version(state) -> int:
        return state.tables.version

    # ------------------------------------------------------------------

    def refresh(self, force: bool = False) -> bool:
        """Recompile + upload if the index changed (atomic state swap: a
        batch in flight keeps the snapshot it was dispatched with)."""
        with self._refresh_lock:
            state = self._state
            if (not force and state is not None
                    and state.tables.version == self.index.sub_version):
                return False
            faults.fire(faults.DEVICE_RECOMPILE)
            tables = compile_sig(self.index)
            if len(tables.groups) > MAX_GROUPS:
                # pathological corpus (thousands of distinct wildcard
                # shapes): keep serving EXACTLY via the CPU trie rather
                # than raising on the publish hot path
                self._state = _State(tables, None, None, {})
                return True
            kplan = sig_kernel.plan(tables.group_words, tables.group_w16,
                                    force_width32=self.kernel_width == "32")
            dev = device_tables(table_arrays(tables), self.device)
            program = sig_kernel.build_fixed_fn(dev, kplan,
                                                self.fixed_max_rows)
            self.kernel_plan = kplan
            self._state = _State(tables, program, dev, {})
            self._freeze_heap_if_large()
            return True

    # generational-GC hygiene for huge corpora: a compiled million-sub
    # table is several MILLION long-lived acyclic objects. Left in the
    # normal generations, every full collection walks them all (a
    # recurring whole-batch decode stall). gc.freeze() moves the
    # survivors to the permanent generation; frozen once per PROCESS
    # growth step (re-freezing on every rotation would progressively pin
    # transient state), so only when the live table is at least twice as
    # large as at the last freeze.
    GC_FREEZE_MIN_SUBS = 100_000
    _frozen_subs = 0

    def _freeze_heap_if_large(self) -> None:
        n = int(self.index.subscription_count)
        cls = SigEngine
        if n >= self.GC_FREEZE_MIN_SUBS and n >= 2 * cls._frozen_subs:
            import gc
            # unfreeze first so cycles formed through frozen objects since
            # the last freeze become collectable for one collection, and
            # collect before freezing so a rotated-out snapshot's cycles
            # are not pinned for the life of the process
            if cls._frozen_subs:
                gc.unfreeze()
            gc.collect()
            gc.freeze()
            cls._frozen_subs = n

    @property
    def tables(self) -> SigTables:
        return self._state.tables

    @property
    def device_state(self) -> dict | None:
        """The live snapshot's device tables (``device_tables`` output);
        with ``kernel_plan`` these are the kernel's operands."""
        return self._state.dev

    # ------------------------------------------------------------------

    def dispatch_fixed(self, topics: list[str]):
        """Tokenize + enqueue the fixed-slot match without waiting for the
        device: the counts and the hint-predicted front of the row stream
        start copying to the host now, and ``collect_fixed`` finishes the
        batch (pipelines overlap this batch's device work with the
        previous batch's decode)."""
        if self.auto_refresh:
            self.refresh_soon()
        state = self._state
        if state.program is None:
            raise DeviceMatchingDeclined(
                "device matching disabled for this corpus "
                f"(> {MAX_GROUPS} signature groups); use the subscribers_* "
                "APIs, which fall back to the CPU trie")
        faults.fire(faults.DEVICE_MATCH)
        tables = state.tables
        toks8, lens_enc, hostrows = prepare_batch(tables, topics)
        toks8, lens_enc = pad_to_bucket(tables, toks8, lens_enc)
        counts_dev, stream_dev = state.program(toks8, lens_enc)
        with _device_errors("stream fetch"):
            out = self._start_fetch(counts_dev, stream_dev)
        return _Dispatch(out, hostrows, tables, state.fragments, toks8,
                         lens_enc)

    def _start_fetch(self, counts_dev, stream_dev):
        """Start the device->host copies of the counts and of the stream
        slices the rows-count hint (an EMA of recent batches) predicts;
        an event marks their completion. A short hint costs one
        synchronous slice fetch at collect time."""
        cuda = counts_dev.device.type == "cuda"
        cap = stream_dev.shape[0]
        hint = min(self._stream_rows_hint, cap)
        slices = []
        c0 = 0
        while c0 < hint or not slices:
            n = min(_STREAM_CHUNK, cap - c0)
            if n <= 0:
                break
            slices.append(_to_host(stream_dev[c0:c0 + n], non_blocking=True))
            c0 += n
        event = None
        counts_host = _to_host(counts_dev, non_blocking=True)
        if cuda:
            event = torch.cuda.Event()
            event.record()
        return _Fetch(counts_host, stream_dev, slices, event)

    def _fetch_stream(self, out):
        """Finish the fetch: (cnt int32[B] with 15 = overflow, real
        int64[B] true per-topic counts, flat uint32[total] topic-sorted
        row stream or None when empty). 255 = overflow sentinel -> 15."""
        with _device_errors("stream fetch"):
            return self._finish_fetch(*out)

    def _finish_fetch(self, counts_host, stream_dev, slices, event):
        if event is not None:
            event.synchronize()
        cnt_u8 = counts_host.numpy()
        cnt = np.where(cnt_u8 == 0xFF, 15, cnt_u8).astype(np.int32)
        real = np.where(cnt_u8 == 0xFF, 0, cnt_u8).astype(np.int64)
        total = int(real.sum())
        # EMA hint for the next dispatch's prefetch (~1.25x headroom)
        self._stream_rows_hint = (self._stream_rows_hint
                                  + total + total // 4) // 2
        if not total:
            return cnt, real, None
        parts = [s.numpy() for s in slices]
        c0 = sum(len(p) for p in parts)
        cap = stream_dev.shape[0]
        while c0 < total:
            n = min(_STREAM_CHUNK, cap - c0)
            parts.append(_to_host(stream_dev[c0:c0 + n]).numpy())
            c0 += n
        flat = parts[0] if len(parts) == 1 else np.concatenate(parts)
        return cnt, real, flat[:total].view(np.uint32)

    # Auto-route: serve TINY corpora from the CPU trie — a few hundred
    # subscriptions never amortize table compiles and device batches.
    ROUTE_SUBS_MAX = 256

    def _routes_to_trie(self) -> bool:
        return (self.route_small
                and self.index.subscription_count <= self.ROUTE_SUBS_MAX)

    def _trie_batch(self, topics: list[str]) -> list[SubscriberSet] | None:
        """CPU-trie service for declined corpora (> MAX_GROUPS shapes) or
        router-claimed ones; None when the device path should run."""
        if self.auto_refresh:
            self.refresh_soon()
        declined = self._state.program is None
        if not declined and not self._routes_to_trie():
            return None
        self.matches += len(topics)
        if declined:
            self.fallbacks += len(topics)
        else:
            self.trie_routed += len(topics)
        return [self.index.subscribers(t) for t in topics]

    def subscribers_fixed_batch(self, topics: list[str]
                                ) -> list[SubscriberSet]:
        """Batch match over the fixed-slot device path: dispatch, then
        fetch + batch verify + entry union."""
        cpu = self._trie_batch(topics)
        if cpu is not None:
            return cpu
        try:
            ctx = self.dispatch_fixed(topics)
        except DeviceMatchingDeclined:   # swapped to trie-only mid-call
            return self._resync_batch(topics)
        # any other failure (faults.DeviceMatchError above all) surfaces:
        # a supervisor counts it and answers the caller from its trie
        return self.collect_fixed(topics, ctx)

    # The device program is the fixed-slot path; the batch surface is the
    # same call (the JAX package's separate word-form program is not
    # ported: its answers are the same).
    subscribers_batch = subscribers_fixed_batch

    def subscribers_host_batch(self, topics: list[str]
                               ) -> list[SubscriberSet]:
        """Device-free full match: tokenize + exact/'+' probes, the
        '#'-group host probe (host_hash_rows), then the same batch verify
        + union decode — no dispatch. The three probes cover every
        compiled group, so the result is exactly subscribers_fixed_batch's
        (the batcher's low-occupancy bypass serves from here)."""
        cpu = self._trie_batch(topics)
        if cpu is not None:
            return cpu
        state = self._state
        tables = state.tables
        batch = len(topics)
        toks, lens_enc, hostrows = prepare_batch(tables, topics)
        lengths = np.abs(lens_enc.astype(np.int32))
        fall = lengths >= 127
        # overflow topics are served by the trie fallback pass and
        # counted under fallbacks — not host matches
        self.host_matches += batch - int(fall.sum())
        hh = host_hash_rows(tables, toks, lengths, lens_enc < 0)
        ti_h = np.repeat(np.arange(batch), [len(h) for h in hh])
        rw_h = (np.concatenate([np.asarray(h) for h in hh])
                .astype(np.int64) if len(ti_h)
                else np.empty(0, dtype=np.int64))
        ti, rw = _pairs_with_host(batch, ti_h, rw_h, hostrows, fall, tables)
        return self.decode_pairs(topics, fall, ti, rw, tables,
                                 state.fragments, toks, lens_enc)

    def collect_fixed(self, topics: list[str], ctx) -> list[SubscriberSet]:
        """Decode half of the fixed-slot path: fetch + batch-verify +
        entry union for a previously dispatched batch."""
        if self.overlay_for(ctx.tables.version) == "resync":
            return self._resync_batch(topics)   # skip the flatten
        fetched = self._fetch_stream(ctx.fetch)
        return self._decode_stream(topics, ctx, *fetched)

    def _decode_stream(self, topics: list[str], ctx, cnt, real, flat):
        """Host half of the stream wire format after the fetch: pair
        assembly + batch verify + entry union (split from collect_fixed
        so harnesses can time fetch and decode separately)."""
        batch = len(topics)
        if len(cnt) > batch:            # bucket-padded dispatch: pads
            cnt, real = cnt[:batch], real[:batch]   # carry no rows
        fall = cnt == 15
        ti_dev = np.repeat(np.arange(batch), real)
        rw_dev = (flat[:len(ti_dev)].astype(np.int64) if flat is not None
                  else np.empty(0, dtype=np.int64))
        ti, rw = _pairs_with_host(batch, ti_dev, rw_dev, ctx.hostrows,
                                  fall, ctx.tables)
        return self.decode_pairs(topics, fall, ti, rw, ctx.tables,
                                 ctx.fragments, ctx.toks8, ctx.lens_enc)

    def decode_pairs(self, topics: list[str], fall, ti, rw, tables,
                     fragments, toks8, lens_enc) -> list[SubscriberSet]:
        """Host decode of flattened candidate pairs: numpy batch verify +
        entry union (through ``fragments``, the snapshot's row memo), then
        the overlay and fallback pass.

        Result contract (the JAX package's native decode has the same):
        returned SubscriberSets may be SHARED across topics and calls —
        the union is built from memoized per-row fragments — so treat
        them as immutable and ``deep_copy()`` before mutating."""
        overlay = self.overlay_for(tables.version)
        if overlay == "resync":
            return self._resync_batch(topics)
        removed = overlay.removed if overlay else None
        batch = len(topics)
        self.matches += batch
        toks8, lens_enc = toks8[:batch], lens_enc[:batch]
        lengths = np.abs(lens_enc.astype(np.int32))
        dollar = lens_enc < 0
        dtype, pad = _compact_dtype(tables)
        toks32 = toks8.astype(np.int32)
        if dtype is not np.int32:
            toks32[toks32 == pad] = -1
        ok = verify_pairs(tables, toks32, lengths, dollar, ti, rw)
        if removed is None:
            out = _union_rowsets(batch, ti[ok], rw[ok], tables, fragments)
        else:
            # overlay window: the union filters removed pairs and
            # merge_delta then mutates the results, so nothing is shared
            out = [SubscriberSet() for _ in range(batch)]
            _union_pairs(out, ti[ok], rw[ok], tables, removed)
        return self._overlay_fallback_pass(topics, out, fall, overlay)

    def _overlay_fallback_pass(self, topics, out, fall, overlay):
        """Overlay/fallback post-pass; the common case (fresh tables, no
        overflow) returns the union output as-is."""
        any_fall = bool(fall.any())
        if overlay is not None:
            fl = fall.tolist() if any_fall else None
            for i, topic in enumerate(topics):
                if fl is None or not fl[i]:   # fall slots get replaced
                    out[i] = self.merge_delta(topic, out[i], overlay)
        if any_fall:
            for i in np.nonzero(fall)[0].tolist():
                self.fallbacks += 1
                out[i] = self.index.subscribers(topics[i])
        return out

    def _resync_batch(self, topics: list[str]) -> list[SubscriberSet]:
        """The journal no longer reaches the compiled tables: serve this
        batch exactly from the CPU trie while the background recompile
        catches up."""
        self.matches += len(topics)
        self.fallbacks += len(topics)
        return [self.index.subscribers(t) for t in topics]

    # Below this corpus size a SINGLE topic's trie walk undercuts the
    # host path's fixed per-call cost; past it the host path wins.
    HOST_SINGLE_SUBS_MIN = 250_000

    def subscribers(self, topic: str) -> SubscriberSet:
        # single-topic surface: never the device (one topic cannot
        # amortize a round trip) — trie or host path by corpus size
        if self.index.subscription_count < self.HOST_SINGLE_SUBS_MIN:
            self.matches += 1
            return self.index.subscribers(topic)
        return self.subscribers_host_batch([topic])[0]

    async def subscribers_async(self, topic: str) -> SubscriberSet:
        import asyncio

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self.subscribers, topic)

    def warm_buckets(self, max_batch: int = 4096,
                     background: bool = True) -> None:
        """Run the fixed program once at each bucket shape of the
        dispatch ladder up to ``max_batch``: loads the kernel library and
        fills the caching allocator with the shapes real batches use. The
        warm topic is a '$'-prefixed dummy that matches nothing."""
        self._warm_max = max_batch      # re-warmed after each rotation
        sizes, b = [], 16
        while b < max_batch:
            sizes.append(b)
            b = _batch_bucket(b + 1)    # the exact dispatch ladder
        sizes.append(_batch_bucket(max_batch))

        def _warm():
            for size in sizes:
                try:
                    fetch = self.dispatch_fixed(["$maxmq/warm"] * size).fetch
                    # wait on the raw output directly — _fetch_stream
                    # would fold this zero-match batch into the EMA hint
                    if fetch.event is not None:
                        fetch.event.synchronize()
                except Exception:
                    return              # trie-only corpus / shutdown race
        if background:
            t = threading.Thread(target=_warm, daemon=True,
                                 name="sig-warm")
            self._warm_thread = t
            t.start()
        else:
            _warm()

    def prewarm_decode_bases(self, chunk: int = 2048) -> int:
        """No-op: the chained-decode anchors belong to the native decode,
        which this package does not load. Returns 0 chunk calls."""
        return 0

    @staticmethod
    def merge_delta(topic: str, result: SubscriberSet,
                    overlay: Overlay | None) -> SubscriberSet:
        """Union the overlay's delta-trie matches for ``topic``."""
        if overlay is not None:
            extra = overlay.delta.subscribers(topic)
            for cid, sub in extra.subscriptions.items():
                result.add(cid, sub, sub.filter)
            for (g, f), members in extra.shared.items():
                for cid, sub in members.items():
                    result.add_shared(g, f, cid, sub)
        return result


__all__ = ["SigEngine", "DeviceMatchingDeclined", "device_tables", "table_arrays", "resolve_device",
           "pad_to_bucket", "MAX_GROUPS"]
