"""Mesh-sharded matchers: the cluster mode of the framework.

Counterpart of the JAX package's ``parallel/sharded.py``. Partition the
*subscriptions* across a grid of devices, compile one (small) table set
per shard, let every device match its shard against its slice of the
publish batch, and reassemble the per-shard matched row ids on the host.

Mesh axes:
  * ``data`` — data parallelism over the publish batch (each cell matches
    a slice of the topics).
  * ``subs`` — the scale axis: subscriptions are partitioned into one
    table set per mesh column, so 1M+ subscriptions never need one
    device's memory. Per-shard tables are padded to identical shapes and
    stacked on a leading axis.
  * ``slice`` (``make_multislice_mesh`` only) — subscriptions partition
    over ('slice', 'subs') jointly for the signature engine.

``Mesh`` replaces ``jax.sharding.Mesh`` (an object array of
``torch.device`` with named axes; one device may fill several cells,
which is how one card or the CPU holds a 2 x 4 mesh), and
``MeshProgram`` replaces ``jit(shard_map(...))``: a loop over the mesh's
cells, each running the plain torch program on its own device. Outputs
come back to the host stacked [sp, B, ...], the reference's
``out_specs=P('subs', 'data', ...)`` layout. Row ids are local to their
shard; the host decodes each through its shard's tables (SubscriberSet
union is shard-order independent), or, with ``emit_intents``, runs one
native intents decode a shard and chains the results per topic
(``ChainedIntents``).
"""

from __future__ import annotations

import dataclasses
import threading
import warnings
import zlib
from typing import NamedTuple

import numpy as np
import torch

from ..matching import sig_tables
from ..matching.engine import NFAEngine, match_batch_body, nfa_device_tables
from ..matching.nfa import NFATables, TableFull, compile_subscriptions
from ..matching.sig import (DeviceMatchingDeclined, SigEngine,
                            _device_errors, resolve_device)
from ..matching.sig_tables import (OverlayedEngine, _compact_dtype,
                                   _native_decode, _native_hash_probe,
                                   _scatter_hits, compile_sig_subscriptions,
                                   host_exact_rows_from_sig, host_hash_rows,
                                   host_plus_rows, prepare_batch_sig,
                                   prewarm_tables)
from ..matching.sig_torch import (fixed_slots_from_words,
                                  sig_match_words_gather, token_tensor)
from ..matching.trie import SubscriberSet, TopicIndex, subs_version


class Mesh:
    """A grid of devices with named axes: ``devices`` is an object array
    of ``torch.device`` whose axes are ``axis_names``; ``shape`` maps each
    name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: tuple) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))


def _device_grid(devices, shape) -> np.ndarray:
    """Object array of shape ``shape`` holding ``devices`` in order."""
    flat = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        flat[i] = d
    return flat.reshape(shape)


def _default_devices() -> list[torch.device]:
    """Every CUDA device; raises without CUDA (the caller must name CPU
    devices to run there)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: tuple[int, int] | None = None, devices=None) -> Mesh:
    """Build a ('data', 'subs') mesh over ``devices`` (default: every
    CUDA device). A device may be named more than once.

    Default shape: put everything on 'subs' (the scale axis) until there
    are >= 8 devices, then split 2 x N/2.
    """
    devices = _default_devices() if devices is None else \
        [resolve_device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (2, n // 2) if n >= 8 and n % 2 == 0 else (1, n)
    if shape[0] * shape[1] > n:
        raise ValueError(f"mesh shape {shape} needs {shape[0] * shape[1]} "
                         f"devices, have {n}")
    return Mesh(_device_grid(devices[: shape[0] * shape[1]], shape),
                ("data", "subs"))


def _group_by_slice(devices, n_slices) -> list[list]:
    """Devices grouped into slices. torch devices report no hardware
    slice, so the devices form one slice unless ``n_slices`` > 1 forces
    an even split."""
    if not n_slices or n_slices == 1:
        return [list(devices)]
    per = len(devices) // n_slices
    if per == 0:
        raise ValueError(f"need >= {n_slices} devices for "
                         f"{n_slices} slices, have {len(devices)}")
    return [devices[i * per:(i + 1) * per] for i in range(n_slices)]


def make_multislice_mesh(n_slices: int | None = None,
                         shape: tuple[int, int] | None = None,
                         devices=None) -> Mesh:
    """('slice', 'data', 'subs') mesh for multi-slice deployments: the
    'data'/'subs' axes sit inside a slice, and the sharded signature
    engine partitions subscriptions over ('slice', 'subs') jointly;
    nothing in the match program communicates across 'slice'.

    ``n_slices`` forces an even split of ``devices`` (default: every CUDA
    device) into that many slices."""
    devices = _default_devices() if devices is None else \
        [resolve_device(d) for d in devices]
    slices = _group_by_slice(devices, n_slices)
    per = min(len(s) for s in slices)
    if shape is None:
        shape = (1, per)
    dp, sp = shape
    if dp * sp > per:
        raise ValueError(f"per-slice shape {shape} needs {dp * sp} "
                         f"devices; smallest slice has {per}")
    idle = sum(len(s) - dp * sp for s in slices)
    if idle:
        warnings.warn(f"make_multislice_mesh leaves {idle} device(s) "
                      f"idle (unequal slices, or shape {shape} smaller "
                      "than a slice)", stacklevel=2)
    grid = np.stack([_device_grid(s[: dp * sp], (dp, sp)) for s in slices])
    return Mesh(grid, ("slice", "data", "subs"))


class MeshProgram:
    """The counterpart of ``jit(shard_map(body))``: ``body`` runs once per
    mesh cell, on the cell's device, against the cell's subscription
    shard and the cell's data row of the batch (an even slice of the
    padded batch axis).

    ``shard_tables[s]`` is shard s's host table set; ``upload_tables`` and
    ``upload_inputs`` move a table set and a batch slice (a tuple of numpy
    arrays) to a device. A shard's tables live on every device of its
    column, once per distinct device. Shards number the ``subs_axes``
    jointly, outer axis first; mesh axes outside 'data' and ``subs_axes``
    hold replicas, and their first index runs."""

    def __init__(self, mesh: Mesh, subs_axes: tuple, shard_tables: list,
                 upload_tables, upload_inputs, body) -> None:
        names = mesh.axis_names
        grid = mesh.devices
        keep = ("data",) + tuple(subs_axes)
        for axis in reversed(range(len(names))):
            if names[axis] not in keep:
                grid = np.take(grid, 0, axis=axis)
        kept = [a for a in names if a in keep]
        grid = np.transpose(grid, [kept.index(a) for a in keep])
        self.dp = grid.shape[0]
        grid = grid.reshape(self.dp, -1)
        self.sp = grid.shape[1]
        if len(shard_tables) != self.sp:
            raise ValueError(f"{len(shard_tables)} shards for {self.sp} "
                             "mesh columns")
        self.cells = [(s, d, torch.device(grid[d, s]))
                      for d in range(self.dp) for s in range(self.sp)]
        self.tables: dict = {}
        for s, _d, dev in self.cells:
            if (s, dev) not in self.tables:
                self.tables[s, dev] = upload_tables(shard_tables[s], dev)
        self._upload_inputs = upload_inputs
        self._body = body

    def upload(self, *arrays) -> dict:
        """Each data row's slice of the batch on each of its devices."""
        b = arrays[0].shape[0]
        if b % self.dp:
            raise ValueError(f"batch {b} is no multiple of the data axis "
                             f"{self.dp}")
        per = b // self.dp
        inputs = {}
        for _s, d, dev in self.cells:
            if (d, dev) not in inputs:
                inputs[d, dev] = self._upload_inputs(
                    tuple(a[d * per:(d + 1) * per] for a in arrays), dev)
        return inputs

    def run(self, inputs: dict) -> dict:
        """Enqueue every cell's program; (shard, data row) -> outputs, on
        the cells' devices."""
        return {(s, d): self._body(self.tables[s, dev], *inputs[d, dev])
                for s, d, dev in self.cells}

    def fetch(self, outs: dict) -> tuple[np.ndarray, ...]:
        """The cells' outputs on the host, each stacked [sp, B, ...]."""
        host = {k: [t.cpu().numpy() for t in v] for k, v in outs.items()}
        n_out = len(next(iter(host.values())))
        return tuple(
            np.stack([np.concatenate([host[s, d][k] for d in range(self.dp)])
                      for s in range(self.sp)])
            for k in range(n_out))

    def __call__(self, *arrays) -> tuple[np.ndarray, ...]:
        with _device_errors("sharded match"):
            return self.fetch(self.run(self.upload(*arrays)))


def _pad_and_stack_shards(shards, sp: int) -> tuple:
    """Pad per-shard sig tables to common shapes and stack on 'subs'.

    +1 group column: padding word slots must NOT alias a real group — a
    real group's adjusted signature can (adversarially, the hash seed is
    deterministic) equal the 0xFFFFFFFF poison plane, emitting row ids
    past the shard's row tables. The extra all-zero-coefficient group
    has signature 0 for every topic (never the poison), so padding
    words can never fire."""
    g_real = max(max(len(t.groups), 1) for t in shards)
    g_max = g_real + 1
    g_pad = g_real
    d_max = max(max(t.probe_depth, 1) for t in shards)
    w_max = max(max(int(t.group_words.sum()), 1) for t in shards)

    topo = np.zeros((sp, g_max, d_max), dtype=np.uint32)
    dc = np.zeros((sp, g_max), dtype=np.uint32)
    mind = np.zeros((sp, g_max), dtype=np.int32)
    ish = np.zeros((sp, g_max), dtype=bool)
    wild = np.zeros((sp, g_max), dtype=bool)
    planes = np.full((sp, 32, w_max), 0xFFFFFFFF, dtype=np.uint32)
    grp = np.full((sp, w_max), g_pad, dtype=np.int32)
    for s, t in enumerate(shards):
        g = len(t.groups)
        if g:
            topo[s, :g, :t.topo_coef.shape[1]] = t.topo_coef
            dc[s, :g] = t.depth_coef
            mind[s, :g] = t.min_depth
            ish[s, :g] = t.is_hash
            wild[s, :g] = t.wild_first
        w = int(t.group_words.sum())
        if w:
            planes[s, :, :w] = t.row_sig.reshape(w, 32).T
            grp[s, :w] = np.repeat(
                np.arange(g, dtype=np.int32), t.group_words)
    return (topo, dc, mind, ish, wild, planes, grp), d_max


def compile_shards(subs, n_shards: int, version: int) -> list[NFATables]:
    """Partition a subscription list round-robin and compile one NFA per
    shard, all with a common edge-table size (grown together until every
    shard's edges fit the probe bound)."""
    buckets = [subs[i::n_shards] for i in range(n_shards)]
    vocab: dict[str, int] = {}   # one intern pool => shard-uniform token ids
    probe = [compile_subscriptions(b, version, vocab=vocab) for b in buckets]
    size = max([8] + [t.table_size for t in probe])
    if size == probe[0].table_size and all(
            t.table_size == size for t in probe):
        return probe
    while True:
        try:
            return [compile_subscriptions(b, version, table_size=size,
                                          vocab=vocab) for b in buckets]
        except TableFull:
            size *= 2


def compile_sig_shards(subs, n_shards: int, version: int,
                       by_client: bool = True):
    """Partition subscriptions BY CLIENT (stable crc32 hash of client id)
    and compile one signature table per shard with a shared token-intern
    pool (uniform token ids across the mesh, so topics are tokenized once
    for every shard). Every entry of one client lives on exactly one
    shard. ``by_client=False`` restores round-robin (the refresh fallback
    when one heavy client's wildcard shapes overflow a bucket's
    MAX_GROUPS)."""
    vocab: dict[str, int] = {}
    if by_client:
        buckets: list[list] = [[] for _ in range(n_shards)]
        for entry in subs:
            cid = entry[1]              # (filter, client_id, sub, group)
            buckets[zlib.crc32(cid.encode()) % n_shards].append(entry)
    else:
        buckets = [subs[i::n_shards] for i in range(n_shards)]
    return [compile_sig_subscriptions(b, version, vocab=vocab)
            for b in buckets]


def _upload_sig_tables(arrays: tuple, dev: torch.device) -> dict:
    """One shard's stacked signature arrays (topo, dc, mind, ish, wild,
    planes, grp) as the word path's device operands (uint32 as int64)."""
    topo, dc, mind, ish, wild, planes, grp = arrays

    def t(a, dtype=np.int64):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(dev)

    return {"topo_coef": t(topo), "depth_coef": t(dc), "min_depth": t(mind),
            "is_hash": t(ish, bool), "wild_first": t(wild, bool),
            "planes": t(planes), "grp_of_word": t(grp)}


def _upload_sig_inputs(arrays: tuple, dev: torch.device) -> tuple:
    toks, lens_enc = arrays
    return (token_tensor(toks, dev),
            torch.from_numpy(np.ascontiguousarray(lens_enc)).to(dev))


def sharded_sig_body(tables: dict, toks: torch.Tensor,
                     lens_enc: torch.Tensor, *, sel_blocks: int,
                     max_rows: int) -> tuple[torch.Tensor]:
    """One mesh cell of the sharded signature match: the shard's tables
    against the cell's batch slice; the packed fixed slots [b, 1+max_rows]
    (uint32 as int64)."""
    dollar = lens_enc < 0
    lengths = lens_enc.to(torch.int64).abs()
    too_deep = lengths >= 127
    words = sig_match_words_gather(tables, tables["planes"],
                                   tables["grp_of_word"], toks, lengths,
                                   dollar)
    return (fixed_slots_from_words(words, too_deep, sel_blocks, max_rows,
                                   fmt16=False),)


def _shard_pairs(out_s, hr, batch, col, fall):
    """One shard's UNVERIFIED candidate (topic, row) pairs: device slots
    + host-probe rows (``hr``, per-topic arrays), with overflowed
    (trie-served) topics' pairs dropped before the C verify."""
    cnt = out_s[:, 0].astype(np.int64)
    cnt = np.where(cnt == 0xF, 0, cnt)          # fall slots replaced later
    mask = col[None, :] < cnt[:, None]
    ti_dev = np.repeat(np.arange(batch), cnt)
    rw_dev = out_s[:, 1:][mask].astype(np.int64)
    ti_h = np.repeat(np.arange(batch), [len(h) for h in hr])
    rw_h = (np.concatenate([np.asarray(h) for h in hr]).astype(np.int64)
            if len(ti_h) else np.empty(0, dtype=np.int64))
    ti = np.concatenate([ti_dev, ti_h])
    rw = np.concatenate([rw_dev, rw_h])
    if fall.any():                  # overflowed topics are served by the
        keep = ~fall[ti]            # trie; don't union their pairs
        ti, rw = ti[keep], rw[keep]
    return np.ascontiguousarray(ti), np.ascontiguousarray(rw)


class ChainedIntents:
    """Per-topic cluster-mode delivery result: the per-shard
    DeliveryIntents chained, NOT merged. Valid because subscriptions
    partition by client hash (compile_sig_shards) — one client's entries
    live on exactly one shard, so the chained iteration can never name a
    client twice and no cross-shard per-client merge exists to do.
    Duck-types the DeliveryIntents consumer surface (__iter__/n/__len__/
    shared/has_client/to_set); shared-group candidate maps MAY span
    shards (a group's members hash apart), so ``shared`` is a lazy
    outer-merged view. Immutable, like every cached match result."""

    __slots__ = ("parts", "_shared", "_set")

    def __init__(self, parts: list) -> None:
        self.parts = parts
        self._shared = None
        self._set = None

    def __iter__(self):
        for p in self.parts:
            yield from p

    @property
    def n(self) -> int:
        return sum(p.n for p in self.parts)

    def __len__(self) -> int:
        return sum(len(p) for p in self.parts)

    @property
    def shared(self) -> dict:
        if self._shared is None:
            merged: dict = {}
            for p in self.parts:
                if len(p) == p.n:        # no shared members on this shard
                    continue
                for key, members in p.shared.items():
                    cur = merged.get(key)
                    if cur is None:
                        merged[key] = members
                    else:                # group spans shards: union view
                        cur = dict(cur)
                        cur.update(members)
                        merged[key] = cur
            self._shared = merged
        return self._shared

    def has_client(self, cid: str) -> bool:
        return any(p.has_client(cid) for p in self.parts)

    def to_set(self) -> SubscriberSet:
        if self._set is None:
            subs: dict = {}
            for cid, sub in self:
                subs[cid] = sub          # disjoint by construction
            self._set = SubscriberSet(subs, dict(self.shared))
        return self._set


class _SigState(NamedTuple):
    """One compiled snapshot of the sharded signature engine, swapped as
    one attribute: ``program`` is None when the corpus was declined (the
    CPU trie serves); ``chain_ok`` says whether the shards partition by
    client hash (True) or round-robin (False)."""

    version: int
    shards: list
    stacked: tuple | None       # _pad_and_stack_shards arrays (host)
    program: MeshProgram | None
    d_max: int
    union_exact: dict
    chain_ok: bool | None


class ShardedSigEngine(OverlayedEngine):
    """Signature matcher sharded over a ('data', 'subs') mesh — cluster
    mode of the production `sig` path.

    Subscriptions partition by CLIENT HASH over 'subs'
    (``compile_sig_shards``; refresh falls back to round-robin if a heavy
    client overflows a bucket): each cell holds one shard's group
    constants + row-signature planes and matches its batch slice against
    them with the word path (``sig_match_words_gather`` +
    ``fixed_slots_from_words``); the host unions shard-local decodes.
    The mesh defaults to every CUDA device (``make_mesh``).
    """

    def __init__(self, index: TopicIndex, mesh: Mesh | None = None,
                 sel_blocks: int = 8, max_rows: int = 7) -> None:
        if not 1 <= max_rows <= 14:
            # the 4-bit count packing reserves 0xF for overflow
            raise ValueError("max_rows must be in [1, 14]")
        self.index = index
        self.mesh = mesh if mesh is not None else make_mesh()
        self.sel_blocks = sel_blocks
        self.max_rows = max_rows
        self._bind_mesh_axes()
        self._state: _SigState | None = None
        self._refresh_lock = threading.Lock()
        self.matches = 0
        self.fallbacks = 0
        self.host_matches = 0     # topics served by the device-free path
        # per-shard native DeliveryIntents chained per topic (client-hash
        # sharding makes chaining merge-free)
        self.emit_intents = False
        # topics decoded, by the decode that served them
        self.decoded = {"native-intents": 0, "python": 0}
        self._init_overlay()
        self.refresh(force=True)

    @staticmethod
    def _state_version(state) -> int:
        return state.version

    def _bind_mesh_axes(self) -> None:
        """Subscriptions partition over ('slice', 'subs') jointly on a
        multi-slice mesh and over 'subs' on the plain 2-axis mesh."""
        names = self.mesh.axis_names
        self._subs_axes = tuple(a for a in ("slice", "subs") if a in names)
        self.sp = 1
        for a in self._subs_axes:
            self.sp *= self.mesh.shape[a]
        self.dp = self.mesh.shape["data"]

    # ------------------------------------------------------------------

    def refresh(self, force: bool = False) -> bool:
        """Re-partition + recompile + re-upload if the index changed."""
        with self._refresh_lock:
            state = self._state
            if (not force and state is not None
                    and state.version == subs_version(self.index)):
                return False
            version = subs_version(self.index)
            shards, chain_ok = self._compile_shards(version)
            if shards is None:
                # pathological corpus under EITHER partitioning: serve
                # exactly via the CPU trie (as SigEngine.refresh)
                self._state = _SigState(version, [], None, None, 0, {},
                                        None)
                return True
            stacked, d_max = _pad_and_stack_shards(shards, self.sp)
            program = self.build_program(stacked)
            # exact-group coefficients are deterministic by shape, so the
            # union over shards gives ONE esig per topic valid everywhere
            union_exact = {}
            for t in shards:
                union_exact.update(t.host_exact or {})
            self._state = _SigState(version, shards, stacked, program,
                                    d_max, union_exact, chain_ok)
            return True

    def build_program(self, stacked: tuple,
                      mesh: Mesh | None = None) -> MeshProgram:
        """The word-path program for stacked shard arrays
        (``_pad_and_stack_shards``) over ``mesh`` (default: the engine's;
        another mesh of the same shard count gives a twin elsewhere)."""
        mesh = self.mesh if mesh is None else mesh
        subs_axes = tuple(a for a in ("slice", "subs")
                          if a in mesh.axis_names)
        return MeshProgram(
            mesh, subs_axes,
            [tuple(a[s] for a in stacked) for s in range(len(stacked[0]))],
            _upload_sig_tables, _upload_sig_inputs,
            lambda tables, toks, lens: sharded_sig_body(
                tables, toks, lens, sel_blocks=self.sel_blocks,
                max_rows=self.max_rows))

    def _compile_shards(self, version: int):
        """Compile per-shard tables: client-hash first (chain_ok True);
        round-robin fallback when a heavy client overflows a bucket's
        MAX_GROUPS (chain_ok False); (None, None) when even round-robin
        overflows."""
        subs = self.index.all_subscriptions()
        for by_client in (True, False):
            shards = compile_sig_shards(subs, self.sp, version,
                                        by_client=by_client)
            if all(len(t.groups) <= sig_tables.MAX_GROUPS for t in shards):
                return shards, by_client
        return None, None

    # ------------------------------------------------------------------

    def prewarm_decode_bases(self, chunk: int = 2048) -> int:
        """Cluster form of SigEngine.prewarm_decode_bases: populate the
        chained-decode anchors for every SHARD's table at a quiescent
        point (the background refresh calls it). Skipped when the shards
        compiled via the round-robin fallback (``chain_ok`` False) — the
        intents decode never runs there, so anchors would be pinned dead
        weight. Returns total chunk calls made."""
        state = self._state
        if not self.emit_intents or state is None or not state.chain_ok:
            return 0
        return sum(prewarm_tables(t, chunk) for t in state.shards)

    def match_raw(self, topics: list[str]):
        """Sharded device match. Returns (out uint32[sp, B, 1+max_rows],
        hostrows list[sp][B], shards, toks[B, W], lens_enc[B]),
        batch-trimmed; toks/lens_enc feed the per-shard native decode."""
        self.refresh_soon()
        state = self._state
        if state.program is None:
            raise DeviceMatchingDeclined(
                "device matching disabled for this corpus (> MAX_GROUPS "
                "wildcard shapes in a shard); use subscribers_*, which "
                "fall back to the CPU trie")
        shards = state.shards
        batch = len(topics)
        dp = state.program.dp     # the data axis the program was built for
        padded = -(-batch // dp) * dp
        padded_topics = topics + ["\x01pad"] * (padded - batch)
        # shared intern pool => identical tokens for every shard; one host
        # tokenize pass serves every shard's exact + '+'-shape probes
        toks, lens_enc, esig, lengths = prepare_batch_sig(
            shards[0], padded_topics, window=max(state.d_max, 1),
            host_exact=state.union_exact)
        (out,) = state.program(toks, lens_enc)
        dollar = lens_enc < 0
        hostrows = []
        for t in shards:
            hr = host_exact_rows_from_sig(t, esig, lengths)
            host_plus_rows(t, toks, lengths, dollar, into=hr)
            hostrows.append(hr)
        return (out[:, :batch].astype(np.uint32),
                [h[:batch] for h in hostrows], shards,
                toks[:batch], lens_enc[:batch])

    def _trie_all(self, topics: list[str]) -> list[SubscriberSet]:
        self.matches += len(topics)
        self.fallbacks += len(topics)
        return [self.index.subscribers(t) for t in topics]

    def subscribers_batch(self, topics: list[str]) -> list[SubscriberSet]:
        self.refresh_soon()
        state = self._state
        if state.program is None:           # pathological corpus: CPU trie
            return self._trie_all(topics)
        try:
            out, hostrows, shards, toks, lens_enc = self.match_raw(topics)
        except DeviceMatchingDeclined:      # swapped to disabled mid-call
            return self._trie_all(topics)
        overlay = self.overlay_for(shards[0].version)
        if overlay == "resync":
            return self._trie_all(topics)
        if self.emit_intents and overlay is None and state.chain_ok:
            chained = self._decode_intents(topics, out, hostrows, shards,
                                           toks, lens_enc)
            if chained is not None:
                return chained
        return self._decode_sets(topics, out, hostrows, shards, overlay)

    def _decode_sets(self, topics, out, hostrows, shards, overlay):
        """Per-topic python union across shards (the set form; also the
        overlay-window path, which needs merge_delta's mutation)."""
        removed = overlay.removed if overlay else None
        self.decoded["python"] += len(topics)
        results = []
        for i, topic in enumerate(topics):
            self.matches += 1
            cnt = out[:, i, 0]
            if (cnt == 0xF).any():
                self.fallbacks += 1
                results.append(self.index.subscribers(topic))
                continue
            result = SubscriberSet()
            for s, tables in enumerate(shards):
                SigEngine.decode_rows(topic, out[s, i, 1:1 + int(cnt[s])],
                                      tables, into=result, removed=removed)
                SigEngine.decode_rows(topic, hostrows[s][i], tables,
                                      into=result, removed=removed)
            results.append(SigEngine.merge_delta(topic, result, overlay))
        return results

    def _decode_intents(self, topics, out, hostrows, shards, toks,
                        lens_enc):
        """One native decode_batch_intents pass PER SHARD (verify + union
        + row-set caching in C against that shard's table), then the
        per-shard results chained per topic — client-hash sharding
        guarantees disjointness. None when any shard lacks the native
        extension (the python set path serves)."""
        nds = [_native_decode(t) for t in shards]
        if any(nd is None for nd in nds):
            return None
        batch = len(topics)
        self.matches += batch
        self.decoded["native-intents"] += batch
        fall = (out[:, :, 0] == 0xF).any(axis=0)
        max_rows = out.shape[2] - 1
        col = np.arange(max_rows)
        per_shard: list = []
        toks = np.ascontiguousarray(toks)
        lens_enc = np.ascontiguousarray(lens_enc)
        for s, (tables, nd) in enumerate(zip(shards, nds)):
            mod, cap = nd
            ti, rw = _shard_pairs(out[s], hostrows[s], batch, col, fall)
            _dt, pad = _compact_dtype(tables)
            per_shard.append(mod.decode_batch_intents(
                cap, toks, toks.dtype.itemsize, int(pad), lens_enc,
                batch, ti, rw))
        results: list = []
        fall_list = fall.tolist()
        for i, topic in enumerate(topics):
            if fall_list[i]:
                self.fallbacks += 1
                results.append(self.index.subscribers(topic))
            else:
                results.append(ChainedIntents([ps[i] for ps in per_shard]))
        return results

    def subscribers_host_batch(self, topics: list[str]
                               ) -> list[SubscriberSet]:
        """Cluster-mode device-free match: one tokenize pass (shared
        intern pool), per-shard exact/'+'/'#' host probes, then the same
        per-shard decode (or native intents decode and chaining) the
        device path uses — no mesh dispatch at all (the batcher's
        low-occupancy bypass)."""
        self.refresh_soon()
        state = self._state
        if state.program is None:           # pathological corpus: CPU trie
            return self._trie_all(topics)
        shards = state.shards
        batch = len(topics)
        toks, lens_enc, esig, lengths = prepare_batch_sig(
            shards[0], topics, window=max(state.d_max, 1),
            host_exact=state.union_exact)
        dollar = lens_enc < 0
        over = lengths < 0    # prepare_batch_sig reports overflow as -1
        toks_c = np.ascontiguousarray(toks)
        hostrows = []
        for t in shards:
            hr = host_exact_rows_from_sig(t, esig, lengths)
            host_plus_rows(t, toks, lengths, dollar, into=hr)
            # '#'-probe: the cached C ge-depth probe when built (small
            # batches are this path's whole point), numpy twin otherwise
            hp = _native_hash_probe(t)
            if hp is not None:
                ti_h, rw_h = hp.run(toks_c, lens_enc)
                if len(ti_h):
                    _scatter_hits(hr, [ti_h], [rw_h.astype(np.int64)])
            else:
                host_hash_rows(t, toks, lengths, dollar, into=hr)
            hostrows.append(hr)
        # synthesized zero-count device matrix: every candidate rides
        # the host-rows slot; overflow topics get the 0xF marker so the
        # shared decode serves them from the trie
        out = np.zeros((len(shards), batch, 1 + self.max_rows),
                       dtype=np.uint32)
        out[:, over, 0] = 0xF
        overlay = self.overlay_for(shards[0].version)
        if overlay == "resync":
            return self._trie_all(topics)
        # fallback-served topics are counted under matches/fallbacks
        self.host_matches += batch - int(over.sum())
        if self.emit_intents and overlay is None and state.chain_ok:
            chained = self._decode_intents(topics, out, hostrows, shards,
                                           toks, lens_enc)
            if chained is not None:
                return chained
        return self._decode_sets(topics, out, hostrows, shards, overlay)

    def subscribers(self, topic: str) -> SubscriberSet:
        return self.subscribers_batch([topic])[0]

    async def subscribers_async(self, topic: str) -> SubscriberSet:
        """Event-loop-friendly match (worker thread, like NFAEngine's)."""
        import asyncio

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self.subscribers, topic)

    def reshard(self, mesh: Mesh) -> None:
        """Elastic recovery: re-partition + recompile over a NEW mesh
        (e.g. after losing devices). Matching stays exact throughout —
        callers racing the swap use whichever complete state they hold,
        and the state pairs shards with their program atomically."""
        with self._refresh_lock:
            self.mesh = mesh
            self._bind_mesh_axes()
        self.refresh(force=True)


def _upload_nfa_inputs(arrays: tuple, dev: torch.device) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


class ShardedNFAEngine:
    """NFA matcher sharded over a ('data', 'subs') mesh.

    Equivalent single-device engine: matching.engine.NFAEngine. This class
    trades per-shard decode for a device footprint of subscriptions/``subs``
    per device, and batch-throughput scaling of ``data``. The mesh
    defaults to every CUDA device (``make_mesh``).
    """

    def __init__(self, index: TopicIndex, mesh: Mesh | None = None,
                 width: int = 32, max_levels: int = 16,
                 max_rows: int = 128) -> None:
        self.index = index
        self.mesh = mesh if mesh is not None else make_mesh()
        self.width = width
        self.max_levels = max_levels
        self.max_rows = max_rows
        self.dp = self.mesh.shape["data"]
        self.sp = self.mesh.shape["subs"]
        # (version, shards, program): swapped as ONE attribute so a
        # concurrent match_raw always pairs vocab, tables and program
        self._state = None
        self._refresh_lock = threading.Lock()
        self.matches = 0
        self.fallbacks = 0
        self.refresh(force=True)

    # ------------------------------------------------------------------

    def refresh(self, force: bool = False) -> bool:
        """Re-partition + recompile + re-upload if the index changed."""
        with self._refresh_lock:
            state = self._state
            if (not force and state is not None
                    and state[0] == subs_version(self.index)):
                return False
            version = subs_version(self.index)
            shards = compile_shards(self.index.all_subscriptions(), self.sp,
                                    version)
            self._state = (version, shards, self.build_program(shards))
            return True

    def build_program(self, shards: list,
                      mesh: Mesh | None = None) -> MeshProgram:
        """The NFA program for compiled shards (``compile_shards``) over
        ``mesh`` (default: the engine's; another mesh of the same shard
        count gives a twin elsewhere). Node-indexed arrays are padded with
        -1 to a common node count."""
        n_nodes = max(t.n_nodes for t in shards)

        def padded(t):
            return dataclasses.replace(t, **{
                name: np.pad(getattr(t, name), (0, n_nodes - t.n_nodes),
                             constant_values=-1)
                for name in ("plus_child", "node_mask", "hash_mask")})

        table_mask = shards[0].table_size - 1
        return MeshProgram(
            self.mesh if mesh is None else mesh, ("subs",),
            [padded(t) for t in shards], nfa_device_tables,
            _upload_nfa_inputs,
            lambda tables, toks, lengths, dollar: match_batch_body(
                *tables, toks, lengths, dollar, width=self.width,
                table_mask=table_mask, max_rows=self.max_rows))

    # ------------------------------------------------------------------

    def match_raw(self, topics: list[str]):
        """Sharded device match. Pads the batch to a multiple of the data
        axis. Returns (rows int32[sp, B, max_rows], overflow bool[sp, B],
        shards) as numpy, batch-trimmed."""
        self.refresh()
        _version, shards, program = self._state
        batch = len(topics)
        padded = -(-batch // self.dp) * self.dp
        # shards[0].tokenize: identical token ids across shards —
        # guaranteed by compile_shards assigning ids from one intern pool
        toks, lengths, dollar = shards[0].tokenize(
            topics + [""] * (padded - batch), self.max_levels)
        rows, overflow = program(toks, lengths, dollar)
        return rows[:, :batch], overflow[:, :batch], shards

    def subscribers_batch(self, topics: list[str]) -> list[SubscriberSet]:
        rows, overflow, shards = self.match_raw(topics)
        out = []
        for i, topic in enumerate(topics):
            self.matches += 1
            if overflow[:, i].any():
                self.fallbacks += 1
                out.append(self.index.subscribers(topic))
                continue
            result = SubscriberSet()
            for s, tables in enumerate(shards):
                NFAEngine.decode(rows[s, i], tables, into=result)
            out.append(result)
        return out

    def subscribers(self, topic: str) -> SubscriberSet:
        return self.subscribers_batch([topic])[0]

    async def subscribers_async(self, topic: str) -> SubscriberSet:
        """Event-loop-friendly match (worker thread, like NFAEngine's)."""
        import asyncio

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self.subscribers, topic)
