"""Signature matcher engine: device-resident grouped hash-equality matching
bound to a TopicIndex, with the CPU trie as its exact fallback.

Counterpart of ``SigEngine`` in the JAX package's ``matching/sig.py``.
The production path, which the MicroBatcher and the matcher service drive,
is the fixed-slot "stream" path. Per batch: host tokenize + exact/'+'
probes (``sig_tables.prepare_batch``), one device program (prologue, the
``sig_match_fixed`` CUDA kernel, stream compaction; ``sig_kernel``),
asynchronous fetch of the counts and the used front of the row stream,
then the host batch verify + entry union: one C pass of the port's
native decode (merged ``SubscriberSet``s, or ``DeliveryIntents`` with
``emit_intents``), or the memoized Python union where the extension is
absent. Overflow topics, declined corpora and journal gaps are served
exactly by the CPU trie.

The rest of the reference's device surface runs in plain torch on the
engine's device (``sig_torch``; the reference computes it in XLA): the
word path (``match_raw``, ``subscribers_batch``, the word-form
``decode``) and the compact path (``match_compact``,
``subscribers_compact_batch``). The fixed path's row-matrix surface
(``match_fixed``, ``counts_fixed``, ``decode_fixed``) unpacks the
kernel's stream.

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
                         SigTables, _candidate_pairs, _compact_dtype,
                         _native_decode, _native_hash_probe,
                         _pairs_with_host, _union_pairs, compile_sig,
                         host_exact_rows, host_hash_rows, host_plus_rows,
                         prepare_batch, prewarm_tables, verify_pairs)
from .sig_torch import (MASK32, sig_match_body, sig_match_compact_body,
                        token_tensor)
from .topics import batch_bucket as _batch_bucket
from .topics import filter_matches_topic, split_levels
from .trie import SubscriberSet, TopicIndex, merge_subscription

_STREAM_CHUNK = 1 << 19    # rows per stream-slice fetch (2 MB of uint32)

# the word and compact paths' bounds: the JAX package's constructor
# defaults (no caller sets them). Nonzero words per topic on the word
# path; words expanded, rows kept (<= 254: 255 is the overflow count) and
# stream entries per topic on the compact path.
MAX_WORDS = 32
COMPACT_WORD_SLOTS = 8
COMPACT_MAX_ROWS = 16
COMPACT_CAP_PER_TOPIC = 3

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
    both kernel widths), the same table as uint32 values in int64,
    ``planes`` (the torch bodies' operand), and the packed 16-bit table
    ``planes16`` int32[16, n_words16] of the trailing 16-bit region
    (plane j, column w = row 32w+j in the low half, row 32w+16+j in the
    high half)."""
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
    planes32_t = bits32(planes32)
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
        "planes32": planes32_t,
        "planes": planes32_t.to(torch.int64) & MASK32,
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


def _window_tensor(toks: np.ndarray, device) -> torch.Tensor:
    """The word path's int32 tokens (-1 pads) -> uint32 values in int64
    on ``device``, as the reference's ``astype(uint32)``."""
    t = torch.from_numpy(np.ascontiguousarray(toks, dtype=np.int32))
    return t.to(device).to(torch.int64) & MASK32


def word_program(dev: dict, toks: np.ndarray, lengths: np.ndarray,
                 dollar: np.ndarray):
    """The word path's device program on one batch tokenized at the
    engine's window (``SigTables.tokenize``), on the tables' device:
    (word_idx, word_val int32 bits, overflow) tensors."""
    device = dev["device"]
    return sig_match_body(
        dev, dev["planes"], _window_tensor(toks, device),
        torch.from_numpy(np.ascontiguousarray(lengths)).to(device)
        .to(torch.int64),
        torch.from_numpy(np.ascontiguousarray(dollar)).to(device),
        MAX_WORDS)


def compact_program(dev: dict, toks8: np.ndarray, lens_enc: np.ndarray):
    """The compact path's device program on one prepared batch
    (``prepare_batch``): (counts, stream, total) tensors, with a stream
    of ``COMPACT_CAP_PER_TOPIC`` entries a topic."""
    device = dev["device"]
    return sig_match_compact_body(
        dev, dev["planes"], token_tensor(toks8, device),
        torch.from_numpy(np.ascontiguousarray(lens_enc, dtype=np.int8))
        .to(device), max_word_slots=COMPACT_WORD_SLOTS,
        max_rows=COMPACT_MAX_ROWS,
        cap=COMPACT_CAP_PER_TOPIC * len(lens_enc))


def _host_arrays(tensors) -> list[np.ndarray]:
    """Device outputs -> numpy arrays (one synchronising copy each)."""
    return [_to_host(t).numpy() for t in tensors]


class _State(NamedTuple):
    """One compiled snapshot. ``program`` (the fixed-slot program) is
    None when the corpus was declined (> MAX_GROUPS groups): the CPU trie
    serves it. ``fragments`` memoizes each row's entries unioned into a
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
    (for the host verify). Indices 0-2 and 4-5 mean what the JAX
    package's dispatch tuple's do (its index 3 is the wire format)."""

    fetch: _Fetch
    hostrows: list
    tables: SigTables
    fragments: dict
    toks8: np.ndarray
    lens_enc: np.ndarray


class DeviceMatchingDeclined(RuntimeError):
    """A device entry point (``dispatch_fixed``, ``match_raw``,
    ``match_compact``) on a snapshot whose corpus was declined (more than
    MAX_GROUPS signature groups): the CPU trie serves it. The one
    condition the ``subscribers_*`` surface answers from the trie."""

    def __init__(self, msg: str | None = None) -> None:
        super().__init__(msg or (
            "device matching disabled for this corpus "
            f"(> {MAX_GROUPS} signature groups); use the subscribers_* "
            "APIs, which fall back to the CPU trie"))


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

    ``device`` is where the tables live and the programs run: the card
    by default; ``"cpu"`` runs the kernel's plain version (and must be
    asked for). ``max_levels`` is the word path's tokenizer window and
    the compile's literal-depth limit. ``fixed_max_rows`` (1..14) bounds
    the device rows per topic of the fixed path; the word and compact
    paths' bounds are the module's ``MAX_WORDS`` and ``COMPACT_*``.
    Topics past any bound overflow to the CPU trie. The fixed path runs
    the ``sig_match_fixed`` kernel. ``kernel_width`` "auto" compares
    16-bit-eligible groups against packed planes, "32" forces uniform
    32-bit planes."""

    def __init__(self, index: TopicIndex, max_levels: int = 16,
                 device=None, auto_refresh: bool = True,
                 fixed_max_rows: int = 7,
                 kernel_width: str = "auto") -> None:
        self.index = index
        self.max_levels = max_levels
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
        # emit DeliveryIntents (flat fan-out-ready entries) instead of
        # merged SubscriberSet dicts from the native decode; falls back
        # to sets for overlay windows, CPU-trie fallbacks, and when the C
        # extension is absent (consumers handle both shapes)
        self.emit_intents = False
        # topics decoded, by the decode that served them
        self.decoded = {"native-sets": 0, "native-intents": 0, "python": 0}
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
            tables = compile_sig(self.index, max_levels=self.max_levels)
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

    @property
    def fixed_program(self):
        """(fixed-path program, wire-format descriptor) of the live
        snapshot: ``program(toks8, lens_enc)`` -> (counts_u8, stream) on
        a bucket-padded prepared batch, for harnesses that dispatch the
        device half directly. The format is always the kernel's stream."""
        return self._state.program, {"kind": "stream",
                                     "max_rows": self.fixed_max_rows}

    # -- the word and compact paths ---------------------------------------

    def _device_state(self) -> _State:
        """The live snapshot for a device entry point (refreshed first
        under ``auto_refresh``); raises DeviceMatchingDeclined for a
        declined corpus."""
        if self.auto_refresh:
            self.refresh_soon()
        state = self._state
        if state.program is None:
            raise DeviceMatchingDeclined()
        return state

    @staticmethod
    def _host_rows(tables, toks, lengths, dollar) -> list:
        """The word path's host probes: full-exact and '+'-shape rows."""
        hostrows = host_exact_rows(tables, toks, lengths)
        return host_plus_rows(tables, toks, lengths, np.asarray(dollar),
                              into=hostrows)

    def match_raw(self, topics: list[str]):
        """Device match of the wildcard rows + host probe of the exact
        rows. Returns (word_idx int32[B, K], word_val uint32[B, K],
        overflow bool[B], hostrows list[np.ndarray], tables)."""
        state = self._device_state()
        faults.fire(faults.DEVICE_MATCH)
        tables = state.tables
        toks, lengths, dollar = tables.tokenize(topics, self.max_levels)
        with _device_errors("word match"):
            out = _host_arrays(word_program(state.dev, toks, lengths,
                                            dollar))
        hostrows = self._host_rows(tables, toks, lengths, dollar)
        return (out[0], out[1].view(np.uint32), out[2], hostrows, tables)

    def match_compact(self, topics: list[str]):
        """Transfer-minimal device match of one batch. Returns
        (counts uint8[B], stream uint32[cap], total int, hostrows,
        tables); only ``stream[:min(total, cap)]`` is defined."""
        state = self._device_state()
        tables = state.tables
        toks8, lens_enc, hostrows = prepare_batch(tables, topics)
        with _device_errors("compact match"):
            counts, stream, total = _host_arrays(
                compact_program(state.dev, toks8, lens_enc))
        return counts, stream.view(np.uint32), int(total), hostrows, tables

    # -- the fixed path's row-matrix surface --------------------------------

    def match_fixed(self, topics: list[str], out=None):
        """Fixed-slot device match. Returns (counts int32[B], rows
        uint32[B, max_rows] (0xFFFFFFFF filled), hostrows, tables); count
        15 = overflow; arrays are bucket-long. The rows are the kernel's
        stream scattered back to one row per topic.

        ``out=ctx`` skips the dispatch and unpacks a previous
        ``dispatch_fixed``'s result, on the snapshot it was dispatched
        with."""
        if out is None:
            out = self.dispatch_fixed(topics)
        cnt, real, flat = self._fetch_stream(out.fetch)
        kr = self.fixed_max_rows
        rows = np.full((len(cnt), kr), 0xFFFFFFFF, dtype=np.uint32)
        if flat is not None:
            rows[np.arange(kr, dtype=np.int64)[None, :] < real[:, None]] = \
                flat
        return cnt, rows, out.hostrows, out.tables

    def counts_fixed(self, out):
        """Counts + host rows of a dispatched fixed batch without the
        [B, max_rows] row matrix: (cnt int32[B], hostrows, tables). The
        fetch still copies the used front of the row stream."""
        cnt, _real, _flat = self._fetch_stream(out.fetch)
        return cnt, out.hostrows, out.tables

    # ------------------------------------------------------------------

    def dispatch_fixed(self, topics: list[str]):
        """Tokenize + enqueue the fixed-slot match without waiting for the
        device: the counts and the hint-predicted front of the row stream
        start copying to the host now, and ``collect_fixed`` finishes the
        batch (pipelines overlap this batch's device work with the
        previous batch's decode)."""
        state = self._device_state()
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

    def subscribers_batch(self, topics: list[str]) -> list[SubscriberSet]:
        """Batch match over the word path: ``match_raw``, then the
        word-form ``decode`` per topic. Deep filters (> max_levels literal
        levels) only match topics deeper than max_levels, which the
        tokenizer flags as overflow, so the trie fallback covers them."""
        cpu = self._trie_batch(topics)
        if cpu is not None:
            return cpu
        try:
            word_idx, word_val, overflow, hostrows, tables = \
                self.match_raw(topics)
        except DeviceMatchingDeclined:   # swapped to trie-only mid-call
            return self._resync_batch(topics)
        overlay = self.overlay_for(tables.version)
        if overlay == "resync":
            return self._resync_batch(topics)
        removed = overlay.removed if overlay else None
        out = []
        for i, topic in enumerate(topics):
            self.matches += 1
            if overflow[i]:
                self.fallbacks += 1
                out.append(self.index.subscribers(topic))
            else:
                result = self.decode(topic, word_idx[i], word_val[i],
                                     tables, removed=removed)
                self.decode_rows(topic, hostrows[i], tables, into=result,
                                 removed=removed)
                out.append(self.merge_delta(topic, result, overlay))
        return out

    def subscribers_compact_batch(self, topics: list[str]
                                  ) -> list[SubscriberSet]:
        """Batch match over the compact path: ``match_compact``, then the
        row decode per topic. A stream overflow (total > cap) sends the
        whole batch to the trie."""
        cpu = self._trie_batch(topics)
        if cpu is not None:
            return cpu
        try:
            counts, stream, total, hostrows, tables = \
                self.match_compact(topics)
        except DeviceMatchingDeclined:   # swapped to trie-only mid-call
            return self._resync_batch(topics)
        overlay = self.overlay_for(tables.version)
        if overlay == "resync":
            return self._resync_batch(topics)
        removed = overlay.removed if overlay else None
        if total > stream.shape[0]:      # stream overflow: whole batch back
            self.matches += len(topics)
            self.fallbacks += len(topics)
            return [self.index.subscribers(t) for t in topics]
        out = []
        off = 0
        for i, (topic, c) in enumerate(zip(topics, counts.tolist())):
            self.matches += 1
            if c == 255:
                self.fallbacks += 1
                out.append(self.index.subscribers(topic))
                continue
            result = self.decode_rows(topic, stream[off:off + c], tables,
                                      removed=removed)
            self.decode_rows(topic, hostrows[i], tables, into=result,
                             removed=removed)
            out.append(self.merge_delta(topic, result, overlay))
            off += c
        return out

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
        # the '#' hits ride _pairs_with_host's device-pair slot: the
        # cached C ge-depth probe when built, host_hash_rows otherwise
        hp = _native_hash_probe(tables)
        if hp is not None:
            ti_h, rw_h = hp.run(np.ascontiguousarray(toks), lens_enc)
            rw_h = rw_h.astype(np.int64)
        else:
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

    def decode_fixed(self, topics: list[str], cnt, rows, hostrows, tables,
                     toks8, lens_enc) -> list[SubscriberSet]:
        """Host decode of fetched results in the row-matrix form
        (``match_fixed``'s): batch verify + entry union. Results of the
        live snapshot use its row memo; an older snapshot's a fresh one."""
        state = self._state
        fragments = state.fragments if state.tables is tables else {}
        if self.overlay_for(tables.version) == "resync":
            return self._resync_batch(topics)       # skip the flatten
        if len(cnt) > len(topics):      # bucket-padded dispatch
            cnt, rows = cnt[:len(topics)], rows[:len(topics)]
        fall = cnt == 15
        ti, rw = _candidate_pairs(len(topics), cnt, rows, hostrows, fall,
                                  tables)
        return self.decode_pairs(topics, fall, ti, rw, tables, fragments,
                                 toks8, lens_enc)

    def stream_pairs(self, batch: int, ctx, cnt, real, flat):
        """(fall, ti, rw) of a fetched stream: the overflow flags and the
        device pairs joined with the host-probe hits (the pair assembly of
        ``_decode_stream``)."""
        if len(cnt) > batch:            # bucket-padded dispatch: pads
            cnt, real = cnt[:batch], real[:batch]   # carry no rows
        fall = cnt == 15
        ti_dev = np.repeat(np.arange(batch), real)
        rw_dev = (flat[:len(ti_dev)].astype(np.int64) if flat is not None
                  else np.empty(0, dtype=np.int64))
        ti, rw = _pairs_with_host(batch, ti_dev, rw_dev, ctx.hostrows,
                                  fall, ctx.tables)
        return fall, ti, rw

    def _decode_stream(self, topics: list[str], ctx, cnt, real, flat):
        """Host half of the stream wire format after the fetch: pair
        assembly + batch verify + entry union (split from collect_fixed
        so harnesses can time fetch and decode separately)."""
        fall, ti, rw = self.stream_pairs(len(topics), ctx, cnt, real, flat)
        return self.decode_pairs(topics, fall, ti, rw, ctx.tables,
                                 ctx.fragments, ctx.toks8, ctx.lens_enc)

    def decode_pairs(self, topics: list[str], fall, ti, rw, tables,
                     fragments, toks8, lens_enc) -> list[SubscriberSet]:
        """Host decode of flattened candidate pairs: batch verify + entry
        union (one C pass when the native decode extension is built; the
        numpy verify and the union through ``fragments``, the snapshot's
        row memo, otherwise), then the overlay and fallback pass.

        Result contract: returned results may be SHARED across topics and
        calls (the C pass memoizes per verified row set, the Python union
        per row) — treat them as immutable and ``deep_copy()`` before
        mutating."""
        overlay = self.overlay_for(tables.version)
        if overlay == "resync":
            return self._resync_batch(topics)
        removed = overlay.removed if overlay else None
        batch = len(topics)
        self.matches += batch
        # bucket-padded dispatch: the C decode pass derives the token
        # matrix width from len/batch, so hand it exactly [batch, W]
        # (leading-axis slices of C-contiguous arrays stay contiguous)
        toks8, lens_enc = toks8[:batch], lens_enc[:batch]
        nd = _native_decode(tables) if removed is None else None
        if nd is not None:
            out = self._decode_native(nd, tables, toks8, lens_enc, batch,
                                      ti, rw, overlay)
        else:
            self.decoded["python"] += batch
            out = self._decode_python(tables, fragments, toks8, lens_enc,
                                      batch, ti, rw, removed)
        return self._overlay_fallback_pass(topics, out, fall, overlay)

    def _decode_native(self, nd, tables, toks8, lens_enc, batch, ti, rw,
                       overlay):
        """One C pass: verify + the whole entry union (plain inserts,
        identifier merges via the merge_subscription callback,
        shared-group maps) + the result construction. Intents mode skips
        the merged-dict materialization: flat borrowed-pointer entries a
        broker fans out directly. Overlay windows need merge_delta's set
        mutation, so they keep the set form until the background
        recompile lands."""
        mod, capsule = nd
        _dt, pad = _compact_dtype(tables)
        intents = self.emit_intents and overlay is None
        self.decoded["native-intents" if intents else "native-sets"] += batch
        decode_fn = mod.decode_batch_intents if intents else mod.decode_batch
        return decode_fn(
            capsule, toks8, toks8.dtype.itemsize, int(pad), lens_enc,
            batch, np.ascontiguousarray(ti), np.ascontiguousarray(rw))

    @staticmethod
    def _decode_python(tables, fragments, toks8, lens_enc, batch, ti, rw,
                       removed):
        """Python decode: numpy batch verify, then the memoized row union
        (``_union_rowsets``), or the plain union filtering ``removed``
        pairs in an overlay window (merge_delta then mutates the results,
        so nothing is shared there)."""
        lengths = np.abs(lens_enc.astype(np.int32))
        dollar = lens_enc < 0
        dtype, pad = _compact_dtype(tables)
        toks32 = toks8.astype(np.int32)
        if dtype is not np.int32:
            toks32[toks32 == pad] = -1
        ok = verify_pairs(tables, toks32, lengths, dollar, ti, rw)
        if removed is None:
            return _union_rowsets(batch, ti[ok], rw[ok], tables, fragments)
        out = [SubscriberSet() for _ in range(batch)]
        _union_pairs(out, ti[ok], rw[ok], tables, removed)
        return out

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
        dispatch ladder up to ``max_batch``: loads the kernel library,
        captures each shape's CUDA graph on the card
        (``sig_kernel.FixedProgram.capture``) and fills the caching
        allocator with the shapes real batches use. The warm topic is a
        '$'-prefixed dummy that matches nothing."""
        self._warm_max = max_batch      # re-warmed after each rotation
        sizes, b = [], 16
        while b < max_batch:
            sizes.append(b)
            b = _batch_bucket(b + 1)    # the exact dispatch ladder
        sizes.append(_batch_bucket(max_batch))

        def _warm():
            for size in sizes:
                try:
                    warm = ["$maxmq/warm"] * size
                    state = self._device_state()
                    state.program.capture(*pad_to_bucket(
                        state.tables, *prepare_batch(state.tables, warm)[:2]))
                    fetch = self.dispatch_fixed(warm).fetch
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
        """Build the chained-decode anchors (per-row slot maps + pinned
        single-row intents) of the native intents decode for the live
        table NOW, in GIL-bounded chunks, instead of paying the
        population ramp across the first cold topics. The background
        refresh calls it after each rotation. Returns the number of
        chunk calls made (0 with intents off or the extension absent)."""
        if not self.emit_intents:
            return 0
        state = self._state
        if state is None or state.program is None:
            return 0
        return prewarm_tables(state.tables, chunk)

    @staticmethod
    def _add_row(result: SubscriberSet, row: int, tables: SigTables,
                 tlevels, dollar: bool, removed=None) -> None:
        """Verify one candidate row against the topic and union its
        entries (padding bits and hash collisions are dropped here;
        ``removed`` drops pairs the overlay has unsubscribed/replaced)."""
        if row >= len(tables.row_levels):
            return                      # padding-word artifact, not a row
        flevels = tables.row_levels[row]
        if flevels is None or not filter_matches_topic(flevels, tlevels,
                                                       dollar):
            return
        entries = tables.entries
        for b in tables.row_entries[row]:
            entry = entries[b]
            if entry.shared:
                for cid, sub in entry.candidates.items():
                    if removed and (cid, sub.filter) in removed:
                        continue
                    result.add_shared(entry.group, sub.filter, cid, sub)
            else:
                sub = entry.subscription
                if removed and (entry.client_id, sub.filter) in removed:
                    continue
                result.add(entry.client_id, sub, sub.filter)

    @staticmethod
    def decode(topic: str, word_idx: np.ndarray, word_val: np.ndarray,
               tables: SigTables, into: SubscriberSet | None = None,
               removed=None) -> SubscriberSet:
        """Union matched words' rows into a SubscriberSet, re-verifying
        each row's filter against the topic (collision guard)."""
        result = SubscriberSet() if into is None else into
        tlevels = split_levels(topic)
        dollar = topic.startswith("$")
        for w, bits in zip(word_idx.tolist(), word_val.tolist()):
            if w < 0:
                break
            base = w << 5
            while bits:
                low = bits & -bits
                SigEngine._add_row(result, base + low.bit_length() - 1,
                                   tables, tlevels, dollar, removed)
                bits ^= low
        return result

    @staticmethod
    def decode_rows(topic: str, rows: np.ndarray, tables: SigTables,
                    into: SubscriberSet | None = None,
                    removed=None) -> SubscriberSet:
        """Union a compact row-id slice into a SubscriberSet (verified);
        the compact path's and the sharded engine's per-topic decode."""
        result = SubscriberSet() if into is None else into
        tlevels = split_levels(topic)
        dollar = topic.startswith("$")
        for row in rows:
            SigEngine._add_row(result, int(row), tables, tlevels, dollar,
                               removed)
        return result

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


__all__ = ["SigEngine", "DeviceMatchingDeclined", "device_tables",
           "table_arrays", "resolve_device", "pad_to_bucket", "word_program",
           "compact_program", "MAX_GROUPS", "MAX_WORDS",
           "COMPACT_WORD_SLOTS", "COMPACT_MAX_ROWS", "COMPACT_CAP_PER_TOPIC"]
