#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``maxmq_tpu_torch``).

    python3 chip_smoke.py

Needs one NVIDIA card and the CUDA toolkit (nvcc); exits non-zero with no
result line when CUDA is absent or the package is not beside this file.
Phases, each of which raises on failure:

0. card: name, power limit, device count;
1. build: nvcc compiles every ``maxmq_tpu_torch/csrc/*.cu`` (seconds and
   the ptxas register / shared-memory / spill summary are printed) while
   g++ compiles the native host runtime, ``csrc/host/*.cpp`` (seconds
   printed); then the host runtime: whether g++ and ``Python.h`` are
   there (with both, a failed build or load fails the run; without
   ``Python.h`` the tokenizer and probes run native and the decode its
   Python path, and a line says so), and ``scan_frames`` against
   ``scan_frames_py`` on a few thousand frames;
2. ``sig_match_fixed`` against its plain version on the card, bit for
   bit, on three corpora and both plane widths: ``mixed_100k`` (<= 40
   device groups, the TPU's select-expansion regime), ``hash_plus_100k``
   (> 40 groups, the TPU's MXU-expansion regime) and ``iot_1m_share`` (1M
   subscriptions), with '$' topics, too-deep topics and bucket-pad rows in
   every batch; then on synthetic operands that hit the design's edges
   (``synthetic_sig``): every topic overflowing in the first word tile,
   batch sizes that are no multiple of a block's topics, a table without
   16-bit words and one without 32-bit words;
3. the signature service path: the port's MatcherService on a unix
   socket, driven through its ServiceMatcher client with the 100K
   ``mixed_100k`` subscriptions (one OP_SUB frame each) and five OP_MATCH
   requests of 4 x 4,096 + 1 x 8,192 topics, twice: with the batcher's
   adaptive host bypass (the default), then with the bypass off, where the
   kernel must serve most topics; every answer is held against the CPU
   trie, and the decode that served is printed (the native set decode
   where the extension is built: no batch may take the Python one);
4. signature headline: an in-process SigEngine at batch 262,144 on
   ``iot_1m_share`` (fixed_max_rows 14) and ``mixed_100k``, pipelined
   dispatch/collect, every topic through the kernel and the native set
   decode, and the kernel held against its plain version on one headline
   batch; the kernel is also timed on the service's 256-topic batch, and
   the plane bytes a launch reads are printed. On one more batch, of
   65,536 topics, the decode runs three ways: the native sets, the
   native intents after ``prewarm_decode_bases``, and the Python decode
   on a 16,384-topic sample (cold, then with its row memo warm); the
   intents equal the sets on every topic, the Python decode the native
   one on the sample;
5. ``dense_walk_words`` (K4 with the pack and the sparse extract fused)
   against its plain version on the card, bit for bit on (word_idx,
   word_val, overflow), on ``dense_2k`` (the dense kernel's full
   capacity) and on a narrow table whose slots are not a multiple of 128,
   with '$' topics, a too-deep topic and bucket-pad rows, at max_words
   32, 1 (topics with more nonzero words than that) and 100 (more than
   the table's words);
6. the dense service path: the MatcherService with the dense engine
   factory (``DenseEngine`` behind the MicroBatcher, host bypass off; the
   tables fit the kernel, so it serves), the 100,000 ``dense_2k``
   subscriptions as OP_SUB frames and the five OP_MATCH requests; every
   answer is held against the CPU trie;
7. dense headline: ``DenseEngine`` at batch 262,144 on ``dense_2k``,
   pipelined, with the kernel (and on 256 topics), its plain version
   (held bit for bit against it) and the torch walk timed on one batch;
8. NFA check: ``NFAEngine`` on the card against ``match_batch_body`` on
   the CPU, bit for bit on (rows, overflow), on the check batch of
   ``mixed_100k`` and ``iot_1m_share`` and on a narrow configuration
   (width 4, max_rows 4) where both overflow causes appear; every
   device-served answer against the CPU trie;
9. NFA service: the MatcherService with ``MicroBatcher(NFAEngine)`` (host
   bypass off), the ``mixed_100k`` subscriptions as OP_SUB frames and the
   five OP_MATCH requests, every answer against the CPU trie;
10. NFA headline: ``NFAEngine`` at ``iot_1m_share``, one 262,144-topic
   batch: host tokenize, the device program (CUDA events; launches and
   busy time by ``torch.profiler``), the overflow share, the peak memory,
   and the decode on a 4,096-topic sample against the CPU trie;
11. cluster (bench config 5's shape): ``ShardedSigEngine`` and
   ``ShardedNFAEngine`` on ``cluster_100k`` (100,000 subscriptions, 10 %
   '$share') over a 2 x 4 mesh of eight cells on the one card, batches of
   8,192 answered and held against the CPU trie, ``match_raw`` against the
   same mesh on the CPU, the signature engine resharded to 1 x 4 and
   checked again, each device program timed at 262,144 topics; the
   signature engine then runs with ``emit_intents`` (the native intents
   decode a shard, chained per topic) on the same batches, its
   ``ChainedIntents`` held against the set path and the trie, and both
   decodes timed on the same device output;
12. the publish pipeline below the broker engine (run right after phase
   4, on its engines): PUBLISH frames (60 % v5, 40 % v3.1.1, QoS 0/1/2
   at 50/35/15 %, inbound topic aliases, 1 % retained; from seed 42)
   framed and decoded by the port's codec, aliases resolved, matched by
   ``SupervisedMatcher(MicroBatcher(SigEngine))`` at the reference's
   production settings (window 200 us, batch 256, depth 3; deadline 250
   ms, breaker 5 in 10 s, backoff 1 s to 30 s; intents on, buckets
   warmed, decode bases prewarmed), fanned out with ``select_shared``
   and each delivery built through the wire templates
   (``Deliveries``), on ``mixed_100k`` (its own index: the clients' v5
   identifiers and retain-as-published; bursts of 1,024 and a 512-publish
   trickle) and ``iot_1m_share`` (the earlier phases' index and engine;
   4,096 publishes). With the bypass off, then on: the match latency,
   batch sizes, loop lag, full collections, decode routes, the bursts'
   deliveries/s (the trickle's deliveries apart), the frame heads by
   encoder and the bypass share are printed; every
   answer is held against the CPU trie, every delivery frame (the first
   256 publishes' at ``iot_1m_share``) against the same pipeline over
   the trie, and the first 2,000 patched frames of a run against the
   codec's ``encode()``; an answer from a supervisor hedge or a breaker
   trip fails the run, and with the bypass off ``sig_match_fixed`` must
   launch once per batch. On ``mixed_100k`` the faulted rungs follow
   (``pipeline_faults``: error hedges tripping the breaker, a probe
   closing it, a hang past the deadline, the Python frame heads);
13. what the broker engine imports, on the card: (a) the content
   evaluator (``filtering.columnar``; the reference benchmark's predicates
   and payloads, ``mqttplus_inputs``) at 64 x 4,096 and 10,000 x 256, the
   torch backend on the card held equal to NumPy and to the per-message
   loop, with no breaker fallback, each backend's column build, eval
   (host clock and CUDA events), evals/s and launches a flush; (b) a
   ``PipelineTracer`` on ``SupervisedMatcher(MicroBatcher(SigEngine))``
   at phase 12's settings and ``mixed_100k`` corpus, bursts of phase 12's
   frames (after one untimed warm pass) with every publish sampled and
   with sampling off in turns (on, off, off, on), the spans split as the
   broker splits them (``trace_match_spans``); the tracer and matcher
   registrations served by ``MetricsServer`` and scraped over HTTP (every
   matcher counter equal to its attribute, the stage counts equal to the
   sampled publishes, the Chrome export JSON); then the matcher service
   (its adaptive bypass, then the bypass off) with a tracer on its
   client, each request split into service time and socket time by the
   service's stamps;
14. the rest of the signature engine's device surface (run right after
   phase 12, on phase 4's engines, ``iot_1m_share`` and ``mixed_100k``):
   on the check batch, the word path (``match_raw`` bit-equal on
   (word_idx, word_val, overflow) to the same snapshot's word body on
   the CPU, ``subscribers_batch`` equal to the CPU trie), the compact
   path (``match_compact`` equal to the CPU on counts, total and the
   stream up to total, ``subscribers_compact_batch`` equal to the trie)
   and the fixed path's row-matrix surface (``match_fixed`` counts and
   rows bit-equal to the kernel's plain version on the CPU twin of the
   snapshot, on the same padded batch; ``counts_fixed``;
   ``decode_fixed`` equal to ``collect_fixed`` and the trie;
   ``sig_match_fixed`` once a dispatch); on ``mixed_100k``
   ``DEVICE_MATCH`` armed: ``subscribers_batch`` raises
   ``DeviceMatchError`` with no trie answer, ``match_compact`` leaves the
   fault armed; then the word program and the compact program timed on
   65,536 topics (CUDA events; launches and busy ms by the profiler;
   peak memory) and ``subscribers_batch`` (the Python word-form decode)
   on 4,096 topics;
15. each kernel's SASS opcode counts (``cuobjdump -sass``, where the
   toolkit has it), the kernels line (JSON), the card line, and the
   result line.

Every phase also prints the routes its host prep took (the topics
prepared by the C++ pass or numpy, tokenized by the C++ tokenizer or the
Python loop); where the native runtime is loaded, a topic on the numpy
or Python route fails the phase.

Phases 8-11 run no hand-written kernel (the reference computes them in
XLA, outside Pallas); each reads both kernels' launch counts, set to 0
before it. Phase 12 sets them to 0 before each of its runs and reads
them after; its launches ride the kernels line under
``publish_pipeline_launches``, phase 13's tracing runs' under
``tracing_launches`` and phase 14's (counts set to 0 before it) under
``surfaces_launches``. The dense and NFA decodes are Python, as the
reference's.
The corpora are made here from seed 42 (a copy of the benchmark's corpus
generator, and the ``dense_2k`` generator); the script imports nothing
of the JAX package.
"""

from __future__ import annotations

import asyncio
import contextlib
import faulthandler
import gc
import json
import os
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time
from array import array

import numpy as np

# H100 SXM peaks for the roofline bound (NVIDIA data sheet and Hopper
# white paper): HBM3 at 3.35 TB/s; INT32 at 64 lanes per SM x 132 SMs x
# 1.98 GHz boost = 16.7e12 operations/s (the data sheet lists no INT32
# figure; this is the lane count times the clock).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# Past this many seconds the run prints every thread's stack to stderr
# and exits 1, so a run that would outlast its 1,200 s limit says where
# it was instead of being stopped from outside.
WATCHDOG_S = 1_100

# The run's sizes: subscriptions per corpus, the kernel-check batch (not a
# bucket size, so pad rows ride along), the largest synthetic edge batch of
# the signature kernel (a full block shape, no multiple of it), the service
# requests, the
# warm-up topics sent before them, the headline batch, the signature
# headline's batch count and how many of them warm up (the pipeline and
# the decode's row memo) untimed, the dense_2k generator's arguments, the
# NFA headline's decode sample, the cluster phase's batch and batch
# count (bench config 5: batches of 8,192 on a 2 x 4 mesh), the signature
# headline's batch decoded three ways and its Python decode sample, the
# frames of the scanner check, and the
# publish pipeline's burst and, per corpus, its burst and trickle
# publishes and how many burst publishes have every delivery frame
# compared with the CPU-trie pipeline's, the content evaluator's shapes
# (predicates x payloads: the reference benchmark's 64 x 4,096, and its
# configured bounds, ``filter_max_subscriptions`` x ``filter_batch_max``)
# and timed flushes, and the tracing phase's bursts (of the pipeline's
# burst size) and service topics. The service requests and the decode
# batch are the depth that was cut to keep the whole run near half of its
# 1,200 s limit (the host side of the service phases, and full collections
# of the heap there, grow with the topics sent).
SIZES = {"subs": {"mixed_100k": 100_000, "hash_plus_100k": 100_000,
                  "iot_1m_share": 1_000_000, "cluster_100k": 100_000},
         "check_batch": 4_096 + 100,
         "service_rounds": (4_096,) * 4 + (8_192,),
         "service_warm": 1_024,
         "headline_batch": 262_144,
         "headline_batches": 2,
         "headline_warm": 1,
         "edge_batch": 70_001,
         "dense_corpus": {"n_filters": 2_000, "n_subs": 100_000,
                          "width": 440},
         "nfa_sample": 4_096,
         "cluster_batch": 8_192,
         "cluster_batches": 2,
         "decode_batch": 65_536,
         "decode_sample": 16_384,
         "frames": 4_000,
         "pipeline": {"burst": 1_024,
                      "mixed_100k": {"burst": 16_384, "trickle": 512,
                                     "compare": 16_384},
                      "iot_1m_share": {"burst": 4_096, "trickle": 0,
                                       "compare": 256}},
         "content": {"shapes": ((64, 4_096), (10_000, 256)), "reps": 3},
         "tracing": {"bursts": 4, "service_topics": 4_096}}
# engine counters of topics NOT served by the device path, per engine
SIG_COUNTERS = ("host_matches", "fallbacks", "trie_routed")
DENSE_COUNTERS = ("fallbacks",)
NFA_COUNTERS = ("fallbacks",)
# the NFA engine's narrow configuration (width, max_rows): both overflow
# causes (active set past the width, matched rows past max_rows) appear.
# A mixed_100k topic matches at most 7 rows (the check's "rows_max"), so
# max_rows must be lower than that for the second cause.
NFA_NARROW = (4, 4)
# the cluster phase's meshes on the one card: bench config 5's 2 x 4, then
# the 1 x 4 it reshards to
CLUSTER_MESH = (2, 4)
CLUSTER_RESHARD = (1, 4)
# the tokenizer window of the dense engine (its default max_levels)
DENSE_MAX_LEVELS = 16
# INT32 operations the dense walk must do, as counted for its bound, per
# unit of work that this run's data needs (``Smoke.dense_walk_work``):
# - a real slot of a level a topic walks: the token compare, the OR with
#   the slot's wildcard bit (staged per slot; which staged mask applies,
#   '+' on or off, is a per-level choice), the parent bit's extract and
#   the AND;
# - an emitter slot of such a level: the end-of-topic gate (one AND with
#   a staged exact mask, the at-end test being per level);
# - a level a topic walks: the token's sign test ('+' on), the '$' guard
#   and the at-end test.
# - a nonzero row word of a topic: its rank in the extract (the words
#   themselves are written as bytes).
DENSE_OPS = {"slot": 4, "emit_slot": 1, "level": 3, "nz_word": 1}
# the service's micro-batch (MicroBatcher's largest batch): each kernel is
# also timed at this size
SERVICE_BATCH = 256
KERNELS = {
    "sig_match_fixed": {
        "name": "sig_match_fixed", "route": "cuda",
        "source": "maxmq_tpu_torch/csrc/sig_match.cu",
        "replaces": ("maxmq_tpu/matching/sig_pallas.py:300 "
                     "_chunk_kernel_select; maxmq_tpu/matching/"
                     "sig_pallas.py:288 _chunk_kernel_mxu")},
    "dense_walk_words": {
        "name": "dense_walk_words", "route": "cuda",
        "source": "maxmq_tpu_torch/csrc/dense_walk.cu",
        "replaces": ("maxmq_tpu/matching/pallas_kernel.py:119 _make_kernel "
                     "(and the pack and top_k extract after it, "
                     "maxmq_tpu/matching/dense.py:216-246)")},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def build_corpus(n_subs: int, seed: int = 42, share_frac: float = 0.0,
                 hash_plus: bool = False):
    """Filter corpus + publish-topic generator (the benchmark's
    ``build_corpus`` mixed generator). ``hash_plus`` also turns 1-2 levels
    of every '#' filter's prefix into '+', which multiplies the '#'-prefix
    shapes past the 40 groups of the TPU's select expansion."""
    rng = random.Random(seed)
    alphabet = [f"{c}{i}" for c in "abcdefgh" for i in range(12)]
    filters = []
    for _ in range(n_subs):
        depth = rng.randint(3, 8)
        levels = [rng.choice(alphabet) for _ in range(depth)]
        r = rng.random()
        if r < 0.3:                   # single-level wildcard(s)
            for _ in range(rng.randint(1, 2)):
                levels[rng.randrange(depth)] = "+"
        elif r < 0.45:                # multi-level terminal wildcard
            levels = levels[: rng.randint(1, depth)]
            if hash_plus:
                for _ in range(rng.randint(1, 2)):
                    levels[rng.randrange(len(levels))] = "+"
            levels = levels + ["#"]
        f = "/".join(levels)
        if share_frac and rng.random() < share_frac:
            f = f"$share/g{rng.randint(0, 7)}/{f}"
        filters.append(f)

    def topics(batch: int, seed2: int):
        r2 = random.Random(seed2)
        return ["/".join(r2.choice(alphabet)
                         for _ in range(r2.randint(3, 8)))
                for _ in range(batch)]

    return filters, topics


def build_dense_corpus(n_filters=2000, n_subs=100_000, width=440, seed=42,
                       share_frac=0.1, plus_frac=0.15, hash_frac=0.2):
    """The ``dense_2k`` fan-out deployment: about two thousand distinct
    filters of one site / area / line / device / metric tree (8 levels,
    15 % '+' levels, 20 % '#'-terminated), each held by many clients,
    10 % of them through '$share'. At the defaults it fills the dense
    kernel's capacity (2,000 of 2,048 rows, 8 levels, <= 512 slots a
    level). Returns ((client, filter, qos) subscriptions, topic
    generator); topics are concrete tree paths, 30 % with one extra
    level."""
    rng = random.Random(seed)
    levels = [[f"l0t{i}" for i in range(8)]]
    for lvl, w in enumerate([64] + [width] * 6, start=1):
        seen, out = set(), []
        while len(out) < w:
            tok = ("+" if rng.random() < plus_frac
                   else f"l{lvl}t{rng.randrange(24)}")
            path = f"{rng.choice(levels[-1])}/{tok}"
            if path not in seen:
                seen.add(path)
                out.append(path)
        levels.append(out)
    nodes = [p for lv in levels[1:] for p in lv]
    filters = set()
    while len(filters) < n_filters:
        p = rng.choice(nodes)
        filters.add(p + "/#" if p.count("/") < 7 and rng.random() < hash_frac
                    else p)
    filters = sorted(filters)
    rng.shuffle(filters)
    subs = []
    for i in range(n_subs):
        f = filters[i] if i < len(filters) else rng.choice(filters)
        if rng.random() < share_frac:
            f = f"$share/g{rng.randint(0, 7)}/{f}"
        subs.append((f"cl-{i}", f, i % 3))
    concrete = [p for lv in levels for p in lv if "+" not in p]

    def topics(batch: int, seed2: int):
        r2 = random.Random(seed2)
        return [r2.choice(concrete)
                + (f"/x{r2.randrange(4)}" if r2.random() < 0.3 else "")
                for _ in range(batch)]

    return subs, topics


def synthetic_sig(seed: int, batch: int, n32: int, n16: int,
                  mode: str = "mixed", max_rows: int = 6):
    """``sig_match_fixed`` operands as numpy arrays (int32 carrying
    uint32 bits): (sig [batch, G], too_deep [batch], grp_of_word, planes32
    [32, n32 + n16] of which the kernel gets the first n32 columns — a
    strided view, as the engine's — and planes16 [16, n16]). Groups are
    runs of 1-40 words, the 32-bit region's groups first. Signatures and
    in-alphabet plane values come from a 16-value alphabet (16-bit groups
    lane-replicated), so words hit with multi-bit words and the packed
    compare's fake high-lane bit among them; a topic expects about
    max_rows nonzero words, and 5 % of the topics are too deep. ``mode``
    "overflow" makes every topic's first 32 words nonzero: every topic
    overflows in the first word tile."""
    rng = np.random.default_rng(seed)
    alpha = 16

    def runs(n):
        sizes = []
        while sum(sizes) < n:
            sizes.append(int(rng.integers(1, 41)))
        if sizes:
            sizes[-1] -= sum(sizes) - n
        return [z for z in sizes if z > 0]

    g32, g16 = runs(n32), runs(n16)
    if mode == "overflow":           # one leading group over the first tile
        first = g32 if n32 else g16
        while len(first) > 1 and first[0] < 32:
            first[0] += first.pop(1)
    n_words = n32 + n16
    grp = np.repeat(np.arange(len(g32) + len(g16), dtype=np.int32),
                    g32 + g16)
    rep = rng.integers(0, alpha, (batch, len(g32) + len(g16)),
                       dtype=np.uint32)
    sig = rep.copy()
    sig[:, len(g32):] |= rep[:, len(g32):] << np.uint32(16)
    q = max_rows / max(32 * n_words, 1) * alpha * 0.7

    def values(shape):
        inside = rng.random(shape) < q
        return np.where(inside, rng.integers(0, alpha, shape),
                        rng.integers(alpha, 1 << 16, shape)).astype(np.uint32)

    planes32 = values((32, n_words))
    planes16 = values((16, n16)) | (values((16, n16)) << np.uint32(16))
    if mode == "overflow":
        sig[:, 0] = rep[:, 0] = 7 if n32 else 7 | (7 << 16)
        if n32:
            planes32[0, :32] = 7
        else:
            planes16[0, :32] = (planes16[0, :32] & 0xFFFF0000) | 7
    too_deep = (rng.random(batch) < 0.05).astype(np.uint8)
    return (sig.view(np.int32), too_deep, grp,
            planes32.view(np.int32), planes16.view(np.int32))


def normalize(ss):
    """Comparable form of a SubscriberSet (or of a DeliveryIntents or
    ChainedIntents, through its ``to_set()``)."""
    if hasattr(ss, "to_set"):
        ss = ss.to_set()
    subs = {cid: (s.qos, tuple(sorted(s.identifiers.items())))
            for cid, s in ss.subscriptions.items()}
    shared = {k: tuple(sorted(v)) for k, v in ss.shared.items()}
    return subs, shared


def same_answer(a, b) -> bool:
    """Order-free equality of two match results (SubscriberSets, or
    intents through ``to_set()``): the same clients, each with the same
    QoS, no_local and identifiers (a record merged from several filters
    keeps the newest one's other fields, and the decodes union in orders
    of their own), and the same shared groups. Records aliased in both
    are equal without a look (the common case, at C speed)."""
    if hasattr(a, "to_set"):
        a = a.to_set()
    if hasattr(b, "to_set"):
        b = b.to_set()
    sa, sb = a.subscriptions, b.subscriptions
    if a.shared != b.shared or sa.keys() != sb.keys():
        return False
    if sa == sb:                 # C-level compare, aliased records first
        return True
    for cid, x in sa.items():
        y = sb[cid]
        if x is not y and (x.qos, x.no_local, x.identifiers) != (
                y.qos, y.no_local, y.identifiers):
            return False
    return True


def mqttplus_inputs(preds: int, msgs: int):
    """(predicate texts, decoded payloads) of the content plane's
    benchmark: a copy of the JAX package's generator, ``bench.py:2612-2632``
    (``bench_mqttplus``): ``random.Random(7)``, three fields, every fifth
    predicate compound, every seventh negated, ``rpm`` missing on every
    seventh payload."""
    rng = random.Random(7)
    fields = ("payload.temp", "payload.hum", "payload.rpm")
    exprs = []
    for i in range(preds):
        f = fields[i % len(fields)]
        op = rng.choice((">", "<", ">=", "<="))
        e = f"{f}{op}{round(rng.uniform(0, 100), 1)}"
        if i % 5 == 0:
            g = fields[(i + 1) % len(fields)]
            e = f"({e})&&{g}!={round(rng.uniform(0, 100), 1)}"
        elif i % 7 == 0:
            e = f"!({e})||payload.hum>90"
        exprs.append(e)
    objs = []
    for i in range(msgs):
        o = {"temp": round(rng.uniform(-10, 110), 2),
             "hum": round(rng.uniform(0, 100), 2)}
        if i % 7:
            o["rpm"] = rng.randint(0, 10_000)
        objs.append(o)
    return exprs, objs


def mqtt_frames(n: int, seed: int) -> bytes:
    """``n`` MQTT frames from a seed: a type/flags byte (types 1..15), the
    remaining length as a variable-byte integer, and that many bytes."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    for _ in range(n):
        out.append(int(rng.integers(1, 16)) << 4 | int(rng.integers(0, 16)))
        v = rem = int(rng.integers(0, 128) if rng.random() < 0.7
                      else rng.integers(128, 20_000))
        while True:
            b, v = v & 0x7F, v >> 7
            out.append(b | (0x80 if v else 0))
            if not v:
                break
        out += rng.integers(0, 256, rem, dtype=np.uint8).tobytes()
    return bytes(out)


# -- phase 12: the publish pipeline below the broker engine -------------

# The reference's production matcher settings (the JAX package's
# utils/config.py:201-219): the batcher's window, batch and pipeline
# depth, and the supervisor's deadline, breaker and backoff.
PIPELINE_BATCHER = {"window_us": 200, "max_batch": 256, "pipeline_depth": 3}
PIPELINE_SUPERVISOR = {"deadline_ms": 250.0, "breaker_threshold": 5,
                       "breaker_window_s": 10.0, "backoff_initial_s": 1.0,
                       "backoff_max_s": 30.0}
# the publishes: the v5 share (the rest v3.1.1), QoS 0/1/2, the share of v5
# publishes carrying an inbound topic alias, the retained share, and the
# publisher connections of each version. The v5, QoS, alias and retained
# shares are the phase's specification; the publisher count, and the
# payload sizes and v5 property shares in ``publish_frames``, are coverage
# choices with no fleet measurement behind them.
PUB_MIX = {"v5": 0.6, "qos": (0.5, 0.35, 0.15), "alias": 0.1,
           "retain": 0.01, "publishers": 32}
# the subscribing clients ``cl-<i>``: the v5 share, the share of v5 clients
# with an outbound topic-alias maximum (and its value), the share of v5
# subscriptions with an identifier or retain-as-published (phase 12's own
# ``mixed_100k`` index only), and the clients offline. Coverage choices, so
# that every per-subscriber wire path carries traffic, not a fleet's mix:
# the deliveries a second that phase 12 prints read this mix only.
CLIENT_MIX = {"v5": 0.6, "alias": 0.3, "alias_max": 16, "identifier": 0.5,
              "rap": 0.2, "offline": 0.05}
# deliveries of a run also built by the codec's slow path (the outbound
# Packet's ``encode()``) and held against the template frame
SLOW_PATH_CHECKS = 2_000


def port_kit():
    """The protocol and trie classes the publish pipeline runs on, from
    the port (``tests/test_torch_supervisor.py`` builds the same kit from
    the JAX package and runs the same pipeline)."""
    from types import SimpleNamespace

    from maxmq_tpu_torch.matching import trie
    from maxmq_tpu_torch.protocol import codec, packets, wire

    return SimpleNamespace(
        Packet=packets.Packet, FixedHeader=codec.FixedHeader,
        PT=codec.PacketType, Subscription=packets.Subscription,
        parse_stream=packets.parse_stream, write_varint=codec.write_varint,
        wire=wire, TopicAliases=trie.TopicAliases, TopicIndex=trie.TopicIndex)


class ClientTable:
    """The subscribing clients ``cl-<i>`` of a corpus, from a seed: the
    protocol version of each connection, its outbound topic-alias maximum
    (0: none), whether it is offline, and the v5 subscription options that
    ``subscription`` gives its filter (identifier, retain-as-published),
    drawn by ``CLIENT_MIX`` from seed 42."""

    def __init__(self, n: int):
        rng = np.random.default_rng(42)
        mix = CLIENT_MIX
        self.v5 = rng.random(n) < mix["v5"]
        self.alias_max = np.where(self.v5 & (rng.random(n) < mix["alias"]),
                                  mix["alias_max"], 0)
        self.offline = rng.random(n) < mix["offline"]
        self.identifier = np.where(
            self.v5 & (rng.random(n) < mix["identifier"]),
            rng.integers(1, 268_435_456, n), 0)
        self.rap = self.v5 & (rng.random(n) < mix["rap"])

    def subscription(self, kit, i: int, filter_: str):
        """Client ``i``'s subscription to ``filter_``: the corpus's QoS
        (i % 3) with the client's v5 options."""
        return kit.Subscription(filter=filter_, qos=i % 3,
                                identifier=int(self.identifier[i]),
                                retain_as_published=bool(self.rap[i]))


def publish_frames(kit, topics: list[str], seed: int):
    """One encoded PUBLISH frame per topic, in order, with the publisher
    connection that sends it (``pub5-<k>`` speaks v5, ``pub4-<k>``
    v3.1.1): QoS, retain, payload (16-256 random bytes), v5 properties
    (user properties, correlation data, content type, message expiry,
    payload format, response topic) and inbound topic aliases from a numpy
    seed. An aliased publish carries topic and alias the first time its
    publisher sends that topic, the alias alone (an empty topic) after."""
    rng = np.random.default_rng(seed)
    mix = PUB_MIX
    n = len(topics)
    v5 = rng.random(n) < mix["v5"]
    qos = rng.choice(3, n, p=mix["qos"])
    alias = v5 & (rng.random(n) < mix["alias"])
    retain = rng.random(n) < mix["retain"]
    pub = rng.integers(0, mix["publishers"], n)
    plen = rng.integers(16, 257, n)
    draws = rng.random((n, 6))
    frames, owners, state = [], [], {}
    for i, topic in enumerate(topics):
        owner = f"pub{5 if v5[i] else 4}-{pub[i]}"
        st = state.setdefault(owner, [0, {}])      # packet id, aliases
        pk = kit.Packet(fixed=kit.FixedHeader(type=kit.PT.PUBLISH,
                                              qos=int(qos[i]),
                                              retain=bool(retain[i])),
                        protocol_version=5 if v5[i] else 4, topic=topic,
                        payload=rng.bytes(int(plen[i])))
        if qos[i]:
            st[0] = st[0] % 65535 + 1
            pk.packet_id = st[0]
        if v5[i]:
            pr, d = pk.properties, draws[i]
            if d[0] < 0.3:
                pr.user_properties = [(f"k{j}", f"v{i}-{j}")
                                      for j in range(1 + i % 3)]
            if d[1] < 0.2:
                pr.correlation_data = rng.bytes(8)
            if d[2] < 0.2:
                pr.content_type = "application/json"
            if d[3] < 0.1:
                pr.message_expiry = 3600
            if d[4] < 0.1:
                pr.payload_format = 0
            if d[5] < 0.1:
                pr.response_topic = f"reply/{owner}"
            if alias[i]:
                a = st[1].get(topic)
                if a is None:
                    a = st[1][topic] = len(st[1]) + 1
                else:
                    pk.topic = ""
                pr.topic_alias = a
        frames.append(pk.encode())
        owners.append(owner)
    return frames, owners


class PubDecoder:
    """The listener's half of a publish below the broker engine: framing
    (``parse_stream``), ``Packet.decode`` at the publisher's protocol
    version, the inbound topic alias resolved on the publisher's
    connection (``TopicAliases``, the broker's maximum of 65,535) and the
    origin set."""

    ALIAS_MAX = 65_535

    def __init__(self, kit) -> None:
        self.kit = kit
        self.aliases: dict = {}

    def decode(self, frames: list[bytes], owners: list[str]) -> list:
        kit = self.kit
        buf = bytearray(b"".join(frames))
        out = []
        for (fh, body), owner in zip(kit.parse_stream(buf), owners):
            v5 = owner.startswith("pub5")
            pk = kit.Packet.decode(fh, body, 5 if v5 else 4)
            if v5:
                al = self.aliases.get(owner)
                if al is None:
                    al = self.aliases[owner] = kit.TopicAliases(
                        self.ALIAS_MAX)
                topic = al.resolve_inbound(pk.topic,
                                           pk.properties.topic_alias)
                if not topic:
                    raise AssertionError(f"{owner}: unresolvable topic "
                                         "alias")
                pk.topic = topic
            pk.origin = owner
            out.append(pk)
        if buf or len(out) != len(owners):
            raise AssertionError("frames and publishers disagree")
        return out


class Deliveries:
    """The broker's fan-out below its engine, for one pipeline: the
    intents fast path or the set path with ``$share`` picks through
    ``select_shared`` (the JAX package's broker/server.py:1381-1449), and
    each delivery's frame as the broker's writers build it (:1465-1655):
    the shared QoS-0 wire, or the publish template patched with the
    effective QoS (the minimum of the publish's and the subscription's),
    retain only with retain-as-published, the v5 identifiers and outbound
    alias through ``sid_alias_seg``, and the packet id from a per-client
    counter. Offline clients get no frame (QoS > 0 takes a packet id, as
    the broker's inflight queue does). Results are read, never mutated
    (F7). While ``keep`` is set each frame is kept with its client
    (``frames`` groups them per client, in order); the first
    ``SLOW_PATH_CHECKS`` patched frames are held against the outbound
    Packet's ``encode()``. The bookkeeping adds few objects the garbage
    collector tracks (immutable tuples, one flat list, an array of packet
    ids), so a full collection during a run walks the pipeline's own
    objects, not the measurement's."""

    MAX_QOS = 2

    def __init__(self, kit, clients: ClientTable) -> None:
        self.kit = kit
        self.clients = clients
        self.selector = kit.TopicIndex()    # its own round-robin cursors
        self.conn: dict = {}      # cid -> (version, aliases, online, index)
        self.pids = array("l", [0]) * len(clients.v5)
        self.sent: list = []      # (cid, frame) while ``keep``
        self.keep = True
        self.delivered = self.nbytes = self.queued = self.slow_checked = 0

    @property
    def frames(self) -> dict:
        out: dict = {}
        for cid, frame in self.sent:
            out.setdefault(cid, []).append(frame)
        return out

    def _conn(self, cid: str):
        c = self.conn.get(cid)
        if c is None:
            ct, i = self.clients, int(cid[3:])
            am = int(ct.alias_max[i])
            c = self.conn[cid] = (5 if ct.v5[i] else 4,
                                  self.kit.TopicAliases(am) if am else None,
                                  not ct.offline[i], i)
        return c

    def alive(self, cid: str) -> bool:
        return self._conn(cid)[2]

    def _next_pid(self, i: int) -> int:
        pid = self.pids[i] % 65535 + 1
        self.pids[i] = pid
        return pid

    def fan_out(self, result, packet) -> None:
        if getattr(result, "to_set", None) is None:
            shared = result.shared
            if shared:
                self._shared(shared, result.subscriptions.__contains__,
                             packet)
            for cid, sub in result.subscriptions.items():
                self.publish(cid, sub, packet)
            return
        if len(result) != result.n:         # any shared candidates?
            self._shared(result.shared, result.has_client, packet)
        for cid, sub in result:
            self.publish(cid, sub, packet)

    def _shared(self, shared, has_plain, packet) -> None:
        selected = {}
        for (group, filt), candidates in shared.items():
            pick = self.selector.select_shared(group, filt, candidates,
                                               alive=self.alive)
            if pick is not None:
                cid, sub = pick
                prev = selected.get(cid)
                if prev is None or sub.qos > prev.qos:
                    selected[cid] = sub
        for cid, sub in selected.items():
            if not has_plain(cid):
                self.publish(cid, sub, packet)

    def publish(self, cid: str, sub, packet) -> None:
        if sub.no_local and packet.origin == cid:
            return
        version, aliases, online, i = self._conn(cid)
        qos = min(packet.fixed.qos, sub.qos, self.MAX_QOS)
        if not online:
            if qos:
                self._next_pid(i)
                self.queued += 1
            return
        retain = bool(sub.retain_as_published and packet.fixed.retain)
        v5 = version >= 5
        if qos == 0 and not retain and not (
                v5 and (sub.identifiers or sub.identifier or aliases)):
            frame = self._wire0(packet, version)
        else:
            wire = self.kit.wire
            ids, alias, alias_topic, pid = [], None, False, 0
            if v5:
                ids = sorted(set(sub.identifiers.values())
                             or ({sub.identifier} if sub.identifier
                                 else set()))
                if aliases is not None:
                    a, first = aliases.assign_outbound(packet.topic)
                    if a:
                        alias, alias_topic = a, not first
            if qos:
                pid = self._next_pid(i)
            bufs, size = wire.publish_template(packet, version).patch(
                qos, retain, pid, wire.sid_alias_seg(ids, alias) if v5
                else b"", alias_topic)
            frame = b"".join(bufs)
            if len(frame) != size:
                raise AssertionError("template size disagrees with frame")
            if self.slow_checked < SLOW_PATH_CHECKS:
                self._slow_check(frame, packet, version, qos, retain, pid,
                                 ids, alias, alias_topic)
        self.delivered += 1
        self.nbytes += len(frame)
        if self.keep:
            self.sent.append((cid, frame))

    def _wire0(self, packet, version: int) -> bytes:
        """The QoS-0 frame shared by every subscriber of one version
        that needs no per-subscriber field, built once per publish."""
        cache = packet.__dict__.setdefault("_wire0", {})
        wire = cache.get(version)
        if wire is None:
            if version < 5 or packet.properties.is_empty():
                tb = packet.topic.encode()
                body = bytearray(len(tb).to_bytes(2, "big"))
                body += tb
                if version >= 5:
                    body.append(0)
                body += packet.payload
                head = bytearray([0x30])
                self.kit.write_varint(head, len(body))
                wire = bytes(head + body)
            else:
                wire = self._outbound(packet, version, 0, False, 0, [],
                                      None, False).encode()
            if self.slow_checked < SLOW_PATH_CHECKS:
                self._slow_check(wire, packet, version, 0, False, 0, [],
                                 None, False)
            cache[version] = wire
        return wire

    @staticmethod
    def _outbound(packet, version, qos, retain, pid, ids, alias,
                  alias_topic):
        """The delivery as the broker's slow path shapes it
        (``_build_outbound``), a real Packet."""
        out = packet.copy()
        out.protocol_version = version
        out.fixed.qos, out.fixed.dup, out.fixed.retain = qos, False, retain
        out.packet_id = pid
        if version < 5:
            out.properties = type(out.properties)()
        else:
            out.properties.subscription_ids = list(ids)
            out.properties.topic_alias = alias
            if alias_topic:
                out.topic = ""
        return out

    def _slow_check(self, frame, *args) -> None:
        self.slow_checked += 1
        want = self._outbound(*args).encode()
        if frame != want:
            raise AssertionError(f"delivery frame {frame.hex()} differs "
                                 f"from the codec's encode {want.hex()}")


class LoopLag:
    """Event-loop lag while it runs: a task sleeping 1 ms at a time
    records how late each wake-up came (ms)."""

    def __init__(self) -> None:
        self.samples: list[float] = []
        self._task = None

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        while True:
            t0 = time.perf_counter()
            await asyncio.sleep(0.001)
            self.samples.append((time.perf_counter() - t0) * 1e3 - 1.0)

    async def stop(self) -> None:
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass


def spread(values) -> list:
    """[p50, p99, max] of ``values`` (None when empty)."""
    if not len(values):
        return [None, None, None]
    a = np.asarray(values, dtype=np.float64)
    return [float(np.percentile(a, 50)), float(np.percentile(a, 99)),
            float(a.max())]


@contextlib.contextmanager
def full_collections():
    """The durations (ms) of the garbage collector's full (generation-2)
    passes while the block runs."""
    pauses: list[float] = []
    t0 = [0.0]

    def note(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                t0[0] = time.perf_counter()
            else:
                pauses.append((time.perf_counter() - t0[0]) * 1e3)

    gc.callbacks.append(note)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(note)


@contextlib.contextmanager
def collector_paused():
    """The cyclic garbage collector off while the block runs, on again
    after: for the set-up builds of a corpus and of an engine's tables,
    whose objects live on after the build, so every pass over them while
    they pile up finds nothing. The services compile their tables with
    the collector on, as a broker would."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


async def timed_match(matcher, topic: str):
    """One match through ``subscribers_async`` and its latency (s) from
    enqueue to result."""
    t0 = time.perf_counter()
    result = await matcher.subscribers_async(topic)
    return result, time.perf_counter() - t0


def trace_match_spans(tracer, matcher, tr, fut) -> None:
    """The matcher leg of one sampled publish as the broker splits it (a
    copy of the JAX package's ``server.py:1281-1301``): enqueue to the
    batcher's dispatch mark is ``match_queue``, dispatch to its done mark
    ``match_device``, done to now ``pipeline_wait``; the supervisor's rung
    when it is not closed marks the trace degraded."""
    if tr is None or not tr.t_match:
        return
    now = tracer.clock()
    td = getattr(fut, "_t_dispatch", 0)
    tdone = getattr(fut, "_t_done", 0)
    if td:
        tr.span("match_queue", tr.t_match, td)
        tr.span("match_device", td, tdone or now)
    else:
        tr.span("match_device", tr.t_match, tdone or now)
    if tdone and now > tdone:
        tr.span("pipeline_wait", tdone, now)
    rung = getattr(matcher, "breaker_state_name", None)
    if rung and rung != "closed":
        tr.degraded = rung


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip()


SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)([^;]*);")
SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
SASS_TARGET = re.compile(r"(\.L_x_\d+)|(0x[0-9a-f]+)")


def sass_loops(text: str) -> dict:
    """Per kernel function of a ``cuobjdump -sass`` listing: its
    instruction count and its innermost loops (a backward branch whose
    range holds no other backward branch), each with its instruction
    count and opcode counts (opcode = the mnemonic before its first
    dot)."""
    funcs, name, instrs, labels = {}, None, [], {}

    def finish():
        if name is None:
            return
        branches = []
        for i, (addr, op, rest) in enumerate(instrs):
            if op.split(".")[0] != "BRA":
                continue
            m = SASS_TARGET.search(rest)
            if not m:
                continue
            target = labels.get(m.group(1)) if m.group(1) else int(m.group(2),
                                                                  16)
            if target is not None and target < addr:
                branches.append((target, addr))
        inner = [b for b in branches
                 if not any(o != b and b[0] <= o[0] and o[1] <= b[1]
                            for o in branches)]
        loops = []
        for lo, hi in sorted(set(inner)):
            ops = {}
            body = [op for addr, op, _r in instrs if lo <= addr <= hi]
            for op in body:
                base = op.split(".")[0]
                ops[base] = ops.get(base, 0) + 1
            loops.append({"start": hex(lo), "end": hex(hi), "n": len(body),
                          "ops": dict(sorted(ops.items(),
                                             key=lambda kv: -kv[1]))})
        funcs[name] = {"instructions": len(instrs), "inner_loops": loops}

    pending = []
    for line in text.splitlines():
        if "Function :" in line:
            finish()
            name, instrs, labels, pending = line.split(":", 1)[1].strip(), \
                [], {}, []
            continue
        lab = SASS_LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = SASS_LINE.search(line)
        if m and name is not None:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending = []
            instrs.append((addr, m.group(2), m.group(3)))
    finish()
    return funcs


def kernel_sass(name: str) -> dict:
    """``sass_loops`` of one built kernel library, or {} where the
    toolkit has no ``cuobjdump``."""
    from maxmq_tpu_torch import kernels

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    proc = subprocess.run([tool, "-sass", str(kernels.library_path(name))],
                          capture_output=True, text=True, timeout=120)
    return sass_loops(proc.stdout) if proc.returncode == 0 else {}


class Smoke:
    """The phases, parameterized by device and size table (``SIZES`` on
    the card) so the same code can be rehearsed on the CPU at small sizes,
    where the kernel wrapper runs its plain version."""

    def __init__(self, device: str = "cuda", sizes: dict = SIZES) -> None:
        import torch

        from maxmq_tpu_torch.matching import dense_kernel, sig_kernel

        self.torch = torch
        self.sig_kernel = sig_kernel
        self.dense_kernel = dense_kernel
        self.device = torch.device(device)
        self.sizes = sizes
        self.corpora = {}
        self.engines = {}
        self.dense = None          # (subscriptions, generator, TopicIndex)
        self.dense_eng = None
        self.nfa_engines = {}      # corpus -> NFAEngine, default widths
        self.record = {"max_abs_err": 0, "bit_equal": True}
        self.dense_record = {"max_abs_err": 0, "bit_equal": True}

    def sm_count(self) -> int:
        """SMs of the card (the launch shapes' input); 132 when rehearsing
        on the CPU, the H100's count."""
        if self.device.type != "cuda":
            return 132
        from maxmq_tpu_torch import kernels

        return kernels.sm_count(self.device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def time_ms(self, fn, reps: int) -> float:
        """Mean ms per call over ``reps`` calls after one warm call:
        CUDA events on the card, the host clock on the CPU."""
        fn()
        self.sync()
        if self.device.type == "cuda":
            start = self.torch.cuda.Event(enable_timing=True)
            stop = self.torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            stop.record()
            stop.synchronize()
            return start.elapsed_time(stop) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    # -- corpora -------------------------------------------------------

    def corpus(self, name: str):
        """(filters, topic generator, port TopicIndex) of one corpus."""
        if name in self.corpora:
            return self.corpora[name]
        from maxmq_tpu_torch.matching.trie import TopicIndex
        from maxmq_tpu_torch.protocol import Subscription

        t0 = time.perf_counter()
        with collector_paused():
            filters, gen = build_corpus(
                self.sizes["subs"][name], seed=42,
                share_frac=0.1 if name in ("iot_1m_share", "cluster_100k")
                else 0.0,
                hash_plus=name == "hash_plus_100k")
            index = TopicIndex()
            for i, f in enumerate(filters):
                index.subscribe(f"cl-{i}", Subscription(filter=f,
                                                        qos=i % 3))
        log(f"[corpus] {name}: {len(filters)} subscriptions indexed in "
            f"{time.perf_counter() - t0:.1f} s (collector paused)")
        self.corpora[name] = (filters, gen, index)
        return self.corpora[name]

    def engine(self, name: str):
        if name not in self.engines:
            from maxmq_tpu_torch.matching.sig import SigEngine

            _f, _g, index = self.corpus(name)
            t0 = time.perf_counter()
            with collector_paused():
                self.engines[name] = SigEngine(
                    index, device=self.device, auto_refresh=False,
                    fixed_max_rows=14 if name == "iot_1m_share" else 7)
            log(f"[corpus] {name}: tables compiled and uploaded in "
                f"{time.perf_counter() - t0:.1f} s (collector paused)")
        return self.engines[name]

    def check_decoded(self, what: str, decoded: dict) -> None:
        """Where the decode extension is built, no topic of a measured
        signature path may take the Python decode."""
        from maxmq_tpu_torch import native

        log(f"[decode] {what}: served by {json.dumps(decoded)}")
        if native.decode_module() is not None and decoded.get("python"):
            raise AssertionError(f"{what}: {decoded['python']} topics took "
                                 "the Python decode")

    # -- phase 1: the host runtime ---------------------------------------

    def host_runtime(self) -> dict:
        """The native host runtime as this machine builds it: g++ and
        ``Python.h`` present or not, the build seconds, the libraries
        loaded (with both tools, a failed build or load fails the run),
        and ``scan_frames`` against ``scan_frames_py``."""
        from maxmq_tpu_torch import native
        from maxmq_tpu_torch.matching import trie

        rec = {"gxx": native.compiler(), "python_h": native.python_include(),
               "build": dict(native.build_log),
               "tokenizer": native.available(),
               "decode": native.decode_module() is not None}
        if rec["gxx"] is None:
            raise AssertionError("g++ not found: the native host runtime "
                                 "cannot be built")
        if not rec["tokenizer"] or (rec["python_h"] and not rec["decode"]):
            raise AssertionError(f"the native host runtime failed to build "
                                 f"or load: {native.build_errors}")
        if rec["decode"] and (trie.SubscriberSet
                              is not native.decode_module().SubscriberSet):
            raise AssertionError("SubscriberSet is not the decode "
                                 "extension's type")
        if not rec["python_h"]:
            log("[host] Python.h not found: the decode extension is not "
                "built; the tokenizer and probes run native, every decode "
                "its Python path")
        data = mqtt_frames(self.sizes["frames"], seed=7)
        cuts = [len(data), len(data) - 3, len(data) // 2 + 1]
        for cut in cuts:
            if native.scan_frames(data[:cut], 1 << 16) != \
                    native.scan_frames_py(data[:cut], 1 << 16):
                raise AssertionError(f"scan_frames disagrees with "
                                     f"scan_frames_py (cut {cut})")
        frames, used = native.scan_frames(data, 1 << 16)
        half = frames[len(frames) // 2][1]        # a frame boundary
        for bad in (data[:half] + b"\x00\x01\x02",
                    b"\x30\xff\xff\xff\xff\x01"):
            msgs = []
            for fn in (native.scan_frames, native.scan_frames_py):
                try:
                    fn(bad, 1 << 16)
                    msgs.append(None)
                except native.MalformedFrame as exc:
                    msgs.append(str(exc))
            if msgs[0] is None or msgs[0] != msgs[1]:
                raise AssertionError(f"malformed frame: {msgs}")
        rec.update(frames=len(frames), frame_bytes=used)
        log(f"[host] {json.dumps(rec)}")
        return rec

    # -- phase 2 -------------------------------------------------------

    def check_batch(self, name: str) -> list[str]:
        _f, gen, _i = self.corpus(name)
        topics = gen(self.sizes["check_batch"], seed2=7)
        return topics + ["$SYS/a0/b1", "$" + topics[0],
                         "a0/" + "/".join(["b1"] * 130),
                         "/".join(["c2"] * 63) + "/d3", ""]

    def sig_compare(self, got, want, b: int, mr: int):
        """``sig_match_fixed``'s (counts, rows) against its plain
        version's for a batch of ``b`` real topics: the counts, the
        compacted match stream and the raw rows, bit for bit. Folds the
        result into ``self.record``; returns (bit_equal, max_abs_err,
        stream rows)."""
        sk, torch = self.sig_kernel, self.torch
        self.sync()
        err = int((got[1].to(torch.int64) - want[1].to(torch.int64))
                  .abs().max().item())
        err = max(err, int((got[0].to(torch.int64)
                            - want[0].to(torch.int64)).abs().max()))
        real = torch.where(want[0] == 0xFF, 0, want[0].to(torch.int64))
        total = int(real.sum())
        s_got = sk.compact_stream(got[0], got[1], mr)[:total]
        s_want = sk.compact_stream(want[0], want[1], mr)[:total]
        equal = (torch.equal(got[0][:b], want[0][:b])
                 and torch.equal(s_got, s_want)
                 and torch.equal(got[1], want[1]))
        self.record["max_abs_err"] = max(self.record["max_abs_err"], err)
        self.record["bit_equal"] &= equal
        return equal, err, total

    def kernel_vs_plain(self, name: str) -> dict:
        from maxmq_tpu_torch.matching.sig import (device_tables,
                                                  pad_to_bucket,
                                                  table_arrays)
        from maxmq_tpu_torch.matching.sig_tables import prepare_batch

        sk = self.sig_kernel
        engine = self.engine(name)
        tables = engine.tables
        arrays = table_arrays(tables)
        dev = device_tables(arrays, self.device)
        topics = self.check_batch(name)
        toks8, lens_enc, _ = prepare_batch(tables, topics)
        toks8, lens_enc = pad_to_bucket(tables, toks8, lens_enc)
        out = {"groups": len(tables.groups), "batch": len(topics),
               "bucket": len(lens_enc)}
        launches0 = sk.sig_match_fixed.launches
        for width in ("auto", "32"):
            kplan = sk.plan(arrays["group_words"], arrays["group_w16"],
                            force_width32=width == "32")
            sig, deep = sk.prologue(dev, kplan, toks8, lens_enc)
            p32, p16 = sk.region_planes(dev, kplan)
            mr = engine.fixed_max_rows
            got = sk.sig_match_fixed(sig, deep, dev["grp_of_word"], p32,
                                     p16, mr)
            want = sk.sig_match_fixed_plain(sig, deep, dev["grp_of_word"],
                                            p32, p16, mr)
            b = len(topics)
            equal, err, total = self.sig_compare(got, want, b, mr)
            out[width] = {"n_words32": kplan["n_words32"],
                          "n_words16": kplan["n_words16"],
                          "stream_rows": total,
                          "overflow_topics": int((want[0][:b] == 0xFF)
                                                 .sum()),
                          "bit_equal": equal, "max_abs_err": err}
            if not equal:
                raise AssertionError(f"{name}/{width}: kernel disagrees "
                                     f"with its plain version: {out}")
        out["launches"] = sk.sig_match_fixed.launches - launches0
        if self.device.type == "cuda" and out["launches"] != 2:
            raise AssertionError(f"{name}: {out['launches']} launches for "
                                 "two widths")
        log(f"[kernel] {name}: {json.dumps(out)}")
        return out

    def sig_edges(self) -> dict:
        """The kernel against its plain version on synthetic operands at
        the design's edges (``synthetic_sig``); batch sizes that are no
        multiple of a block's topics, one large enough for the full
        block shape."""
        sk, torch = self.sig_kernel, self.torch
        cases = (("overflow_first_tile", 1037, 200, 100, "overflow", 6),
                 ("overflow_first_tile_16", 1037, 0, 300, "overflow", 6),
                 ("no_16bit_words", 1037, 400, 0, "mixed", 14),
                 ("no_32bit_words", 1037, 0, 500, "mixed", 6),
                 ("mixed", self.sizes["edge_batch"], 300, 200, "mixed", 7))
        out = {}
        launches0 = sk.sig_match_fixed.launches
        for i, (name, batch, n32, n16, mode, mr) in enumerate(cases):
            sig, deep, grp, p32, p16 = (
                torch.from_numpy(a).to(self.device)
                for a in synthetic_sig(100 + i, batch, n32, n16, mode, mr))
            p32 = p32[:, :n32]
            got = sk.sig_match_fixed(sig, deep, grp, p32, p16, mr)
            want = sk.sig_match_fixed_plain(sig, deep, grp, p32, p16, mr)
            equal, err, total = self.sig_compare(got, want, batch, mr)
            over = int((want[0] == 0xFF).sum())
            out[name] = {"batch": batch, "n_words32": n32, "n_words16": n16,
                         "max_rows": mr, "stream_rows": total,
                         "overflow_topics": over, "bit_equal": equal,
                         "max_abs_err": err}
            if not equal:
                raise AssertionError(f"sig edge {name}: kernel disagrees "
                                     f"with its plain version: {out[name]}")
            if mode == "overflow" and over != batch:
                raise AssertionError(f"sig edge {name}: {over} of {batch} "
                                     "topics overflowed")
            if mode == "mixed" and not (0 < over < batch and total):
                raise AssertionError(f"sig edge {name}: no mix of matches "
                                     f"and overflows: {out[name]}")
        out["launches"] = sk.sig_match_fixed.launches - launches0
        if self.device.type == "cuda" and out["launches"] != len(cases):
            raise AssertionError(f"sig edges: {out['launches']} launches "
                                 f"for {len(cases)} cases")
        log(f"[kernel] edges: {json.dumps(out)}")
        return out

    # -- phase 3 -------------------------------------------------------

    async def service_path(self) -> dict:
        from maxmq_tpu_torch.matching.service import (MatcherService,
                                                      ServiceMatcher)
        from maxmq_tpu_torch.protocol import Subscription

        sk = self.sig_kernel
        filters, gen, mirror = self.corpus("mixed_100k")
        path = os.path.join(tempfile.mkdtemp(prefix="maxmq-smoke-"),
                            "m.sock")
        svc = MatcherService(path, device=self.device)
        await svc.start()
        client = ServiceMatcher(path)
        try:
            await client.connect()
            t0 = time.perf_counter()
            for i, f in enumerate(filters):
                client.forward_subscribe(
                    f"cl-{i}", Subscription(filter=f, qos=i % 3))
            await client.subscribers_async("smoke/barrier")  # ops applied
            engine = svc.matcher.engine
            while engine.tables.version != svc.index.sub_version:
                engine.refresh_soon()       # 100K ops outrun the journal
                await asyncio.sleep(0.05)
                if time.perf_counter() - t0 > 600:
                    raise TimeoutError("service tables never caught up")
            log(f"[service] {len(filters)} OP_SUB applied and compiled in "
                f"{time.perf_counter() - t0:.1f} s "
                f"(index {svc.index.subscription_count})")
            warm = gen(self.sizes["service_warm"], seed2=99)
            await asyncio.gather(*(client.enqueue(t) for t in warm))

            sk.sig_match_fixed.launches = 0
            modes = {}
            for mode, bypass, seed in (("adaptive", True, 1000),
                                       ("device", False, 3000)):
                modes[mode] = await self.service_rounds(
                    client, svc, gen, mirror, bypass, seed,
                    sk.sig_match_fixed, SIG_COUNTERS)
            launches = sk.sig_match_fixed.launches
        finally:
            await client.close()
            await svc.close()

        out = {"launches": launches, **modes}
        log(f"[service] {json.dumps(out)}")
        for mode, m in modes.items():
            if m["mismatches"]:
                raise AssertionError(f"{m['mismatches']} service answers "
                                     f"({mode}) differ from the CPU trie")
            self.check_decoded(f"sig service ({mode})", m["decoded"])
        dev = modes["device"]
        if dev["device_topics"] * 2 <= dev["topics"]:
            raise AssertionError(
                f"with the bypass off the device path served only "
                f"{dev['device_topics']} of {dev['topics']} topics")
        if self.device.type == "cuda" and (launches <= 0
                                           or dev["launches"] <= 0):
            raise AssertionError("the service path launched no kernel")
        return out

    async def service_rounds(self, client, svc, gen, mirror, bypass: bool,
                             seed: int, kernel, counters) -> dict:
        """The service requests once, with the batcher's host bypass on
        or off; each answer is held against the CPU trie. Device-served
        topics are the engine's matches less its ``counters`` (topics it
        served on the host or from its trie); ``kernel`` is the wrapper
        whose launches are counted (None: the engine has no kernel)."""
        batcher = svc.matcher
        engine = batcher.engine
        batcher.cpu_bypass = bypass
        names = ("matches",) + tuple(counters)
        base = {k: getattr(engine, k) for k in names}
        decoded0 = dict(getattr(engine, "decoded", {}))
        bypass0 = batcher.bypasses
        launches0 = kernel.launches if kernel is not None else 0
        hits0 = batcher.cache_hits
        rounds, bad, checked = [], 0, 0
        wanted = {}      # the index is fixed here: one trie walk a topic

        def expected(topic: str):
            want = wanted.get(topic)
            if want is None:
                want = wanted[topic] = normalize(mirror.subscribers(topic))
            return want

        for r, size in enumerate(self.sizes["service_rounds"]):
            topics = gen(size, seed2=seed + r)
            t_req = time.perf_counter()
            results = await client.subscribers_batch_async(topics)
            took = time.perf_counter() - t_req
            rounds.append({"topics": len(topics), "ms": took * 1e3,
                           "topics_per_s": len(topics) / took})
            for t, got in zip(topics, results):
                checked += 1
                if normalize(got) != expected(t):
                    bad += 1
        d = {k: getattr(engine, k) - v for k, v in base.items()}
        lat = [r["ms"] for r in rounds[:-1]] or [rounds[0]["ms"]]
        distinct = len(wanted)
        return {"request_ms_p50": statistics.median(lat),
                "request_ms_max": max(lat),
                "topics": sum(r["topics"] for r in rounds),
                "topics_per_s": (sum(r["topics"] for r in rounds)
                                 / sum(r["ms"] for r in rounds) * 1e3),
                "rounds": rounds,
                "launches": (kernel.launches - launches0
                             if kernel is not None else None),
                "bypasses": batcher.bypasses - bypass0,
                "cache_hits": batcher.cache_hits - hits0,
                "distinct_topics": distinct,
                "device_topics": d["matches"] - sum(d[k] for k in counters),
                "decoded": ({k: v - decoded0[k]
                             for k, v in engine.decoded.items()}
                            if decoded0 else "python"),
                "checked": checked, "mismatches": bad, **d}

    # -- phase 4 -------------------------------------------------------

    def headline(self, name: str) -> dict:
        from maxmq_tpu_torch.matching.sig import pad_to_bucket
        from maxmq_tpu_torch.matching.sig_tables import (_native_decode,
                                                         prepare_batch)

        sk, torch = self.sig_kernel, self.torch
        engine = self.engine(name)
        _f, gen, index = self.corpus(name)
        batch = self.sizes["headline_batch"]
        batches = [gen(batch, seed2=2000 + i)
                   for i in range(self.sizes["headline_batches"])]
        base = {k: getattr(engine, k)
                for k in ("matches",) + SIG_COUNTERS}
        decoded0 = dict(engine.decoded)
        # the native decode's table of this snapshot, built once at its
        # first decode: set-up, so built here, before the timed batches
        t0 = time.perf_counter()
        _native_decode(engine.tables)
        decode_table_s = time.perf_counter() - t0
        sk.sig_match_fixed.launches = 0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        warm = self.sizes["headline_warm"]    # untimed: pipeline, row memo
        times = {"dispatch": [], "fetch": [], "decode": []}
        decode_s = []                    # every batch's decode, warm ones too
        pending = None
        first_results = None
        t_first = t_last = 0.0
        # the pipelined window opens at the first timed dispatch, and
        # counts every batch collected in it: the warm batch's decode
        # falls inside it too
        window_topics = 0
        for i in range(len(batches) + 1):
            topics = batches[i] if i < len(batches) else None
            t0 = time.perf_counter()
            ctx = engine.dispatch_fixed(topics) if topics else None
            t1 = time.perf_counter()
            if i == warm:
                t_first = t0
            if topics and i >= warm:
                times["dispatch"].append(t1 - t0)
            if pending is not None:      # collect the batch before this one
                j, p_topics, p_ctx = pending
                fetched = engine._fetch_stream(p_ctx.fetch)
                t2 = time.perf_counter()
                res = engine._decode_stream(p_topics, p_ctx, *fetched)
                t_last = time.perf_counter()
                decode_s.append(t_last - t2)
                if i >= warm:
                    window_topics += len(p_topics)
                if j >= warm:
                    times["fetch"].append(t2 - t1)
                    times["decode"].append(t_last - t2)
                if j == warm:
                    first_results = (p_topics, res)
            pending = (i, topics, ctx) if topics else None
        launches = sk.sig_match_fixed.launches
        d = {k: getattr(engine, k) - v for k, v in base.items()}
        if d["host_matches"] or d["trie_routed"]:
            raise AssertionError(f"{name}: topics left the kernel path {d}")
        decoded = {k: v - decoded0[k] for k, v in engine.decoded.items()}
        self.check_decoded(f"sig headline {name}", decoded)
        if self.device.type == "cuda" and launches < len(batches):
            raise AssertionError(f"{name}: {launches} launches for "
                                 f"{len(batches)} batches")
        # correctness on a sample of a timed batch, against the CPU trie
        topics, res = first_results
        per_topic = statistics.mean(len(r) for r in res)
        rng = random.Random(5)
        for j in rng.sample(range(len(topics)), min(2000, len(topics))):
            if normalize(res[j]) != normalize(index.subscribers(topics[j])):
                raise AssertionError(f"{name}: wrong answer for "
                                     f"{topics[j]!r}")

        # kernel alone, its plain version, and the bound, on batch 0
        tables = engine.tables
        toks8, lens_enc, _ = prepare_batch(tables, batches[0])
        toks8, lens_enc = pad_to_bucket(tables, toks8, lens_enc)
        dev, kplan = engine.device_state, engine.kernel_plan
        sig, deep = sk.prologue(dev, kplan, toks8, lens_enc)
        p32, p16 = sk.region_planes(dev, kplan)
        mr = engine.fixed_max_rows
        call = lambda: sk.sig_match_fixed(sig, deep, dev["grp_of_word"],
                                          p32, p16, mr)
        kernel_ms = self.time_ms(call, 20)
        got = call()
        counts = got[0]
        plain = []
        plain_ms = self.time_ms(lambda: plain.append(
            sk.sig_match_fixed_plain(sig, deep, dev["grp_of_word"], p32, p16,
                                     mr)), 1)
        equal, err, _total = self.sig_compare(got, plain[-1], batch, mr)
        del plain
        if not equal:
            raise AssertionError(f"{name} headline batch: kernel disagrees "
                                 f"with its plain version (max_abs_err "
                                 f"{err})")
        small = self.time_ms(lambda: sk.sig_match_fixed(
            sig[:SERVICE_BATCH], deep[:SERVICE_BATCH], dev["grp_of_word"],
            p32, p16, mr), 20)
        b = sig.shape[0]
        n32, n16 = kplan["n_words32"], kplan["n_words16"]
        sms = self.sm_count()
        ops = b * (32 * n32 + 16 * n16)
        nbytes = (sig.numel() * 4 + deep.numel() + (n32 + n16) * 4
                  + (32 * n32 + 16 * n16) * 4 + b + b * mr * 4)
        t_ops = ops / INT32_OPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out = {
            "subs": index.subscription_count, "batch": batch,
            "bucket": b, "groups": len(tables.groups),
            "n_words32": n32, "n_words16": n16,
            "launches": launches,
            "host_prep_topics_per_s": batch / statistics.mean(
                times["dispatch"]),
            "fetch_topics_per_s": batch / statistics.mean(times["fetch"]),
            "decode_topics_per_s": batch / statistics.mean(
                times["decode"]),
            "decode_topics_per_s_by_batch": [batch / t for t in decode_s],
            "warm_batches": warm,
            "pipelined_topics_per_s": window_topics / (t_last - t_first),
            "kernel_ms": kernel_ms,
            "kernel_topics_per_s": b / (kernel_ms / 1e3),
            "kernel_ms_256": small,
            "launch_shape": sk.launch_shape(b, sms),
            "launch_shape_256": sk.launch_shape(SERVICE_BATCH, sms),
            "plane_bytes_at_most": sk.plane_bytes(b, kplan, sms),
            "plain_ms": plain_ms, "bit_equal": equal, "max_abs_err": err,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ops_ms": t_ops, "bound_bytes_ms": t_bytes,
            "int32_ops": ops, "bytes": nbytes,
            "overflow_topics": int((counts[:batch] == 0xFF).sum()),
            "subscribers_per_topic": per_topic,
            "library_ms": None,    # no single PyTorch call computes this
            "decoded": decoded, "decode_table_s": decode_table_s,
            **{k: v for k, v in d.items()},
        }
        if self.device.type == "cuda":
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        out["decode_forms"] = self.decode_forms(name, engine, gen(
            self.sizes["decode_batch"], seed2=2100))
        log(f"[headline] {name}: {json.dumps(out)}")
        log(f"[headline] {name}: library yardstick: none — no single "
            "PyTorch call computes this function")
        return out

    def decode_forms(self, name: str, engine, topics: list[str]) -> dict:
        """One dispatched batch decoded three ways: the native set decode,
        the native intents decode after ``prewarm_decode_bases``, and the
        Python decode (numpy verify + memoized row union) on the first
        ``decode_sample`` topics, cold and then with its row memo warm.
        The intents must equal the sets on every topic, the Python decode
        the native one on the sample. Rates exclude the trie's fallback
        pass (overflow topics), which every form shares."""
        from maxmq_tpu_torch.matching.sig_tables import _native_decode

        batch = len(topics)
        ctx = engine.dispatch_fixed(topics)
        fall, ti, rw = engine.stream_pairs(batch, ctx,
                                           *engine._fetch_stream(ctx.fetch))
        tables = ctx.tables
        toks8, lens_enc = ctx.toks8[:batch], ctx.lens_enc[:batch]
        nd = _native_decode(tables)
        rec = {"batch": batch, "pairs": len(ti),
               "overflow_topics": int(fall.sum())}
        forms = {}
        if nd is not None:
            engine.emit_intents = False
            t0 = time.perf_counter()
            forms["native-sets"] = engine._decode_native(
                nd, tables, toks8, lens_enc, batch, ti, rw, None)
            rec["native_sets_topics_per_s"] = batch / (
                time.perf_counter() - t0)
            engine.emit_intents = True
            t0 = time.perf_counter()
            rec["prewarm_chunks"] = engine.prewarm_decode_bases()
            rec["prewarm_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            forms["native-intents"] = engine._decode_native(
                nd, tables, toks8, lens_enc, batch, ti, rw, None)
            rec["native_intents_topics_per_s"] = batch / (
                time.perf_counter() - t0)
            engine.emit_intents = False
            sets, intents = forms["native-sets"], forms["native-intents"]
            t0 = time.perf_counter()
            bad = sum(not same_answer(intents[i], sets[i])
                      for i in range(batch) if not fall[i])
            rec["intents_vs_sets_checked"] = int(batch - fall.sum())
            rec["intents_vs_sets_check_s"] = time.perf_counter() - t0
            if bad:
                raise AssertionError(f"{name}: {bad} intents differ from "
                                     "the native sets")
        n = min(self.sizes["decode_sample"], batch)
        sel = ti < n
        memo = {}
        for label in ("cold", "warm"):
            t0 = time.perf_counter()
            py = engine._decode_python(tables, memo, toks8[:n], lens_enc[:n],
                                       n, ti[sel], rw[sel], None)
            rec[f"python_{label}_topics_per_s"] = n / (
                time.perf_counter() - t0)
        rec["python_sample"] = n
        if nd is not None:
            bad = sum(not same_answer(py[i], forms["native-sets"][i])
                      for i in range(n) if not fall[i])
            if bad:
                raise AssertionError(f"{name}: {bad} Python decodes differ "
                                     "from the native sets")
        log(f"[decode] {name}: {json.dumps(rec)}")
        return rec

    # -- phase 12: the publish pipeline -------------------------------

    def pipeline_supervisor(self) -> dict:
        """The supervisor's settings: the production ones, unless the size
        table overrides some (the CPU rehearsal, whose plain kernel shares
        the host with other work, widens the deadline)."""
        return {**PIPELINE_SUPERVISOR,
                **self.sizes["pipeline"].get("supervisor", {})}

    def pipeline_corpus(self, name: str):
        """(index, engine, clients) of the publish pipeline on corpus
        ``name``. ``iot_1m_share`` reuses the index and SigEngine of the
        earlier phases (the benchmark corpus: QoS, no identifiers), so no
        1M compile is repeated. ``mixed_100k`` gets an index of its own:
        the same filters, clients and QoS with the clients' v5 options
        (identifiers, retain-as-published), which the earlier phases'
        corpus lacks, and a SigEngine with the production defaults."""
        filters, _gen, index = self.corpus(name)
        clients = ClientTable(len(filters))
        if name != "mixed_100k":
            return index, self.engine(name), clients
        from maxmq_tpu_torch.matching.sig import SigEngine
        from maxmq_tpu_torch.matching.trie import TopicIndex

        kit = port_kit()
        t0 = time.perf_counter()
        idx = TopicIndex()
        for i, f in enumerate(filters):
            idx.subscribe(f"cl-{i}", clients.subscription(kit, i, f))
        engine = SigEngine(idx, device=self.device)
        log(f"[pipeline] {name}: {len(filters)} subscriptions with the "
            f"clients' v5 options indexed and compiled in "
            f"{time.perf_counter() - t0:.1f} s")
        return idx, engine, clients

    @staticmethod
    def trie_frames(kit, clients, answer, traffic: dict, burst: int,
                    limit: int):
        """The CPU-trie pipeline: the same decode and delivery helper over
        ``TopicIndex.subscribers`` (``answer``), for the first ``limit``
        burst publishes and every trickle publish."""
        dlv = Deliveries(kit, clients)
        dec = PubDecoder(kit)
        frames, owners = traffic["burst"]
        for a in range(0, limit, burst):
            b = min(a + burst, limit)
            for p in dec.decode(frames[a:b], owners[a:b]):
                dlv.fan_out(answer(p.topic), p)
        for p in dec.decode(*traffic["trickle"]):
            dlv.fan_out(answer(p.topic), p)
        return dlv

    async def pipeline_run(self, kit, engine, index, clients, traffic: dict,
                           bypass: bool, answer, limit: int) -> dict:
        """One unfaulted run of the pipeline: bursts of ``burst`` frames
        decoded and enqueued at once through ``subscribers_async`` of a
        ``SupervisedMatcher(MicroBatcher(engine))`` at the production
        settings (the next burst starts when the last settles, and its
        deliveries are built after that), then the trickle publishes one
        at a time. Any answer not from the engine (the supervisor's error,
        deadline or breaker_open hedge, a breaker trip), an answer unequal
        to the trie's, or a topic on the Python decode fails it."""
        from maxmq_tpu_torch import native
        from maxmq_tpu_torch.matching.batcher import MicroBatcher
        from maxmq_tpu_torch.matching.supervisor import SupervisedMatcher

        wire = kit.wire
        batcher = MicroBatcher(engine, cpu_bypass=bypass, **PIPELINE_BATCHER)
        sup = SupervisedMatcher(batcher, index=index,
                                **self.pipeline_supervisor())
        sizes = []
        note = batcher._note_batch

        def note_batch(batch, note=note):
            sizes.append(len(batch))
            note(batch)

        batcher._note_batch = note_batch
        bypass_ms = []
        run_bypass = batcher._run_bypass

        def timed_bypass(batch, topics, ver, run_bypass=run_bypass):
            t0 = time.perf_counter()
            run_bypass(batch, topics, ver)
            bypass_ms.append((time.perf_counter() - t0) * 1e3)

        batcher._run_bypass = timed_bypass
        burst = self.sizes["pipeline"]["burst"]
        dec, dlv = PubDecoder(kit), Deliveries(kit, clients)
        base = {k: getattr(engine, k) for k in ("matches",) + SIG_COUNTERS}
        decoded0 = dict(engine.decoded)
        heads0 = dict(wire.heads)
        lag = LoopLag()
        lat, answers = [], []
        match_s = fan_s = 0.0
        frames, owners = traffic["burst"]
        # the heap frozen at this quiescent point, as the benchmark does
        # after its warm-up (bench.py:622-634): what the earlier runs left
        # joins the permanent generation, so a full collection during the
        # run walks only what the run allocates (``publish_pipelines``
        # thaws it all after the phase)
        gc.collect()
        gc.freeze()
        try:
            self.zero_kernel_counts()
            with full_collections() as gc_ms:
                t_run = time.perf_counter()
                for a in range(0, len(frames), burst):
                    pkts = dec.decode(frames[a:a + burst], owners[a:a + burst])
                    t0 = time.perf_counter()
                    lag.start()
                    res = await asyncio.gather(*(timed_match(sup, p.topic)
                                                 for p in pkts))
                    await lag.stop()
                    t1 = time.perf_counter()
                    for j, (p, (r, dt)) in enumerate(zip(pkts, res)):
                        lat.append(dt * 1e3)
                        answers.append((p.topic, r))
                        if p.fixed.retain:
                            index.retain(p)
                        dlv.keep = a + j < limit
                        dlv.fan_out(r, p)
                    match_s += t1 - t0
                    fan_s += time.perf_counter() - t1
                wall = time.perf_counter() - t_run
                burst_delivered = dlv.delivered
                burst_launches = self.kernel_counts()["sig_match_fixed"]
                burst_batches = len(sizes)
                dlv.keep = True
                trickle = []
                for p in dec.decode(*traffic["trickle"]):
                    r, dt = await timed_match(sup, p.topic)
                    trickle.append(dt * 1e3)
                    answers.append((p.topic, r))
                    dlv.fan_out(r, p)
                launches = self.kernel_counts()["sig_match_fixed"]
        finally:
            await batcher.close()
        bad = [t for t, r in answers if not same_answer(r, answer(t))]
        d = {k: getattr(engine, k) - v for k, v in base.items()}
        out = {
            "bypass": bypass, "publishes": len(frames),
            "trickle_publishes": len(trickle),
            "deliveries": dlv.delivered, "delivery_bytes": dlv.nbytes,
            "burst_deliveries": burst_delivered,
            "trickle_deliveries": dlv.delivered - burst_delivered,
            "queued_offline": dlv.queued,
            "deliveries_per_s": burst_delivered / wall,
            "burst_wall_s": wall, "match_s": match_s, "fan_out_s": fan_s,
            "fan_out_deliveries_per_s": burst_delivered / max(fan_s, 1e-9),
            "match_ms_p50_p99_max": spread(lat),
            "trickle_ms_p50_p99_max": spread(trickle),
            "loop_lag_ms_p50_p99_max": spread(lag.samples),
            "gc_full_collections": len(gc_ms),
            "gc_full_ms_max": max(gc_ms, default=0.0),
            "batch_sizes": {str(k): sizes.count(k)
                            for k in sorted(set(sizes))},
            "batches": len(sizes), "burst_batches": burst_batches,
            "launches": launches, "burst_launches": burst_launches,
            "bypassed": batcher.bypasses, "cache_hits": batcher.cache_hits,
            "bypass_batch_ms_p50_p99_max": spread(bypass_ms),
            "first_bypass_batch_ms": bypass_ms[0] if bypass_ms else None,
            "device_rtt_ms": batcher.device_rtt * 1e3,
            "batch_errors": batcher.errors,
            "fallbacks_by_reason": sup.fallbacks_by_reason,
            "breaker_trips": sup.breaker_trips,
            "decoded": {k: v - decoded0[k]
                        for k, v in engine.decoded.items()},
            "heads": {k: v - heads0[k] for k, v in wire.heads.items()},
            "slow_path_checked": dlv.slow_checked,
            "mismatches": len(bad), **d}
        topics = out["publishes"] + out["trickle_publishes"]
        out["kernel_share"] = 1 - (out["bypassed"] + out["cache_hits"]) \
            / topics
        out["bypass_share"] = out["bypassed"] / topics
        out["frames"] = dlv
        hedged = {k: v for k, v in out["fallbacks_by_reason"].items()
                  if k != "overflow" and v}
        if hedged or out["breaker_trips"]:
            raise AssertionError(f"answers not from the engine: {hedged}, "
                                 f"{out['breaker_trips']} breaker trips")
        if bad:
            raise AssertionError(f"{len(bad)} answers differ from the CPU "
                                 f"trie, first {bad[0]!r}")
        if native.decode_module() is not None and out["heads"]["python"]:
            raise AssertionError(f"{out['heads']['python']} frame heads "
                                 "took the Python encoder unfaulted")
        if not bypass and (out["bypassed"] or out["batch_errors"]):
            raise AssertionError("with the bypass off every batch must "
                                 "reach the engine")
        if (not bypass and self.device.type == "cuda"
                and launches != len(sizes)):
            raise AssertionError(f"{launches} sig_match_fixed launches for "
                                 f"{len(sizes)} dispatched batches")
        return out

    @staticmethod
    def frames_equal(what: str, dev, trie) -> int:
        """Every client's frames, in order, equal between the two
        pipelines; returns the frames compared."""
        got, want = dev.frames, trie.frames
        if got != want:
            bad = sorted(c for c in set(got) | set(want)
                         if got.get(c) != want.get(c))
            raise AssertionError(f"{what}: the delivery frames of "
                                 f"{len(bad)} clients differ from the "
                                 f"CPU-trie pipeline's, first {bad[0]}")
        return len(dev.sent)

    async def pipeline_faults(self, kit, engine, index, clients,
                              traffic: dict, answer) -> dict:
        """The ladder's rungs on the card's pipeline, each answer held
        against the trie: (1) DEVICE_MATCH raising until disarmed gives
        five error hedges, one at a time, and the breaker trips; the next
        publishes are answered ``breaker_open`` with no device call; after
        the 1 s backoff one probe reaches the card and closes it. (2) One
        hang of twice the deadline (0.5 s) gives exactly one deadline
        hedge. (3) With NATIVE_ENCODE
        armed the Python heads build every delivery frame, byte-equal to
        the unarmed CPU-trie pipeline's."""
        from maxmq_tpu_torch import faults
        from maxmq_tpu_torch.matching.batcher import MicroBatcher
        from maxmq_tpu_torch.matching.supervisor import SupervisedMatcher

        batcher = MicroBatcher(engine, cpu_bypass=False, **PIPELINE_BATCHER)
        kw = self.pipeline_supervisor()
        sup = SupervisedMatcher(batcher, index=index, **kw)
        hang_s = 2 * kw["deadline_ms"] / 1e3
        dec = PubDecoder(kit)
        pkts = dec.decode(*traffic["faults"])
        bad = 0

        def check(p, r):
            nonlocal bad
            bad += not same_answer(r, answer(p.topic))

        faults.clear()
        rec = {}
        try:
            faults.arm(faults.DEVICE_MATCH, "raise", count=-1)
            for p in pkts[:5]:
                check(p, await sup.subscribers_async(p.topic))
            rec["tripped"] = {"state": sup.breaker_state_name,
                              "trips": sup.breaker_trips,
                              **sup.fallbacks_by_reason}
            fired = faults.fired.get(faults.DEVICE_MATCH, 0)
            res = await asyncio.gather(*(sup.subscribers_async(p.topic)
                                         for p in pkts[5:21]))
            for p, r in zip(pkts[5:21], res):
                check(p, r)
            rec["open"] = {"fired_while_open": faults.fired.get(
                faults.DEVICE_MATCH, 0) - fired, **sup.fallbacks_by_reason}
            rec["raises_fired"] = faults.fired.get(faults.DEVICE_MATCH, 0)
            faults.disarm(faults.DEVICE_MATCH)
            await asyncio.sleep(kw["backoff_initial_s"]
                                + 0.05)
            self.zero_kernel_counts()
            check(pkts[21], await sup.subscribers_async(pkts[21].topic))
            rec["probe"] = {"state": sup.breaker_state_name,
                            "recoveries": sup.breaker_recoveries,
                            "launches": self.kernel_counts()[
                                "sig_match_fixed"],
                            "degraded_s": sup.degraded_seconds}

            faults.arm(faults.DEVICE_MATCH, "hang", count=1, delay_s=hang_s)
            r, dt = await timed_match(sup, pkts[22].topic)
            check(pkts[22], r)
            await asyncio.sleep(hang_s + 0.1)    # the hung call finishes
            rec["hang"] = {"ms": dt * 1e3, "state": sup.breaker_state_name,
                           **sup.fallbacks_by_reason}

            step3 = pkts[23:]
            want = Deliveries(kit, clients)
            for p in PubDecoder(kit).decode(*traffic["faults"])[23:]:
                want.fan_out(answer(p.topic), p)
            heads0 = dict(kit.wire.heads)
            faults.arm(faults.NATIVE_ENCODE, "raise", count=-1)
            res = await asyncio.gather(*(sup.subscribers_async(p.topic)
                                         for p in step3))
            got = Deliveries(kit, clients)
            for p, r in zip(step3, res):
                check(p, r)
                got.fan_out(r, p)
            faults.disarm(faults.NATIVE_ENCODE)
            rec["encode"] = {
                "heads": {k: v - heads0[k]
                          for k, v in kit.wire.heads.items()},
                "frames": self.frames_equal("faulted encode", got, want),
                "deliveries": got.delivered}
        finally:
            faults.clear()
            await batcher.close()
        rec.update(fallbacks_by_reason=sup.fallbacks_by_reason,
                   breaker_trips=sup.breaker_trips,
                   breaker_recoveries=sup.breaker_recoveries,
                   breaker_state=sup.breaker_state_name, mismatches=bad)
        log(f"[pipeline] faults: {json.dumps(rec)}")
        t, o, pr, h = rec["tripped"], rec["open"], rec["probe"], rec["hang"]
        ok = (bad == 0
              and t["error"] == 5 and t["trips"] == 1
              and t["state"] == "open" and sup.breaker_trips == 1
              and o["fired_while_open"] == 0 and o["breaker_open"] == 16
              and pr["state"] == "closed" and pr["recoveries"] == 1
              and h["deadline"] == 1 and h["state"] == "closed"
              and rec["fallbacks_by_reason"]["error"] == 5
              and rec["fallbacks_by_reason"]["breaker_open"] == 16
              and rec["encode"]["heads"]["native"] == 0
              and rec["encode"]["heads"]["python"] > 0)
        if self.device.type == "cuda" and pr["launches"] < 1:
            ok = False
        if not ok:
            raise AssertionError(f"the faulted rungs did not trip, hedge and "
                                 f"close as specified: {rec}")
        return rec

    async def publish_pipeline(self, name: str) -> dict:
        """Phase 12 on corpus ``name``: the production boot of the
        matcher (intents on, the bucket ladder warmed, the decode bases
        prewarmed), the traffic encoded, the CPU-trie pipeline's frames,
        then the run with the bypass off and the run with it on (the
        reference's default), and on ``mixed_100k`` the faulted rungs."""
        kit = port_kit()
        sz = self.sizes["pipeline"][name]
        burst = self.sizes["pipeline"]["burst"]
        if sz["trickle"] and sz["compare"] != sz["burst"]:
            raise ValueError("the trickle frames compare only after every "
                             "burst publish was compared")
        index, engine, clients = self.pipeline_corpus(name)
        _f, gen, _i = self.corpus(name)
        t0 = time.perf_counter()
        burst_topics = gen(sz["burst"], seed2=4000)
        traffic = {
            "burst": publish_frames(kit, burst_topics, 42),
            "trickle": publish_frames(kit, gen(sz["trickle"], seed2=4100),
                                      43),
            "faults": publish_frames(kit, gen(279, seed2=4200), 44)}
        emit0 = engine.emit_intents
        engine.emit_intents = True
        engine.warm_buckets(PIPELINE_BATCHER["max_batch"], background=False)
        prewarm = engine.prewarm_decode_bases()
        answers = {}

        def answer(topic):
            r = answers.get(topic)
            if r is None:
                r = answers[topic] = index.subscribers(topic)
            return r

        want = self.trie_frames(kit, clients, answer, traffic, burst,
                                sz["compare"])
        for t in burst_topics:      # every burst answer is checked
            answer(t)
        setup_s = time.perf_counter() - t0
        out = {"corpus": name, "subs": index.subscription_count,
               "burst": burst, "setup_s": setup_s, "prewarm_chunks": prewarm,
               "compared_publishes": sz["compare"]}
        try:
            for label, bypass in (("bypass_off", False), ("bypass_on", True)):
                run = await self.pipeline_run(kit, engine, index, clients,
                                              traffic, bypass, answer,
                                              sz["compare"])
                run["frames_compared"] = self.frames_equal(
                    f"{name} {label}", run.pop("frames"), want)
                out[label] = run
                log(f"[pipeline] {name} {label}: {json.dumps(run)}")
                self.check_decoded(f"pipeline {name} {label}",
                                   run["decoded"])
            if name == "mixed_100k":
                out["faults"] = await self.pipeline_faults(
                    kit, engine, index, clients, traffic, answer)
            retained = {p.topic: p.payload
                        for p in PubDecoder(kit).decode(*traffic["burst"])
                        if p.fixed.retain}
            if any(index.retained_get(t).payload != v
                   for t, v in retained.items()):
                raise AssertionError("a retained publish was not stored")
            out["retained"] = len(retained)
        finally:
            engine.emit_intents = emit0
            if name == "mixed_100k":
                engine.close()
        return out

    async def publish_pipelines(self) -> dict:
        """Phase 12 on both corpora, with the heap frozen from its start
        (each run freezes what it finds anew) and thawed and collected at
        its end, as bench.py:622-646 does around a config's timed passes:
        the phases after it run on the heap they would have without it."""
        out = {}
        t0 = time.perf_counter()
        gc.collect()
        gc.freeze()
        out["freeze_s"] = time.perf_counter() - t0
        try:
            for name in ("mixed_100k", "iot_1m_share"):
                out[name] = await self.publish_pipeline(name)
        finally:
            t0 = time.perf_counter()
            gc.unfreeze()
            gc.collect()
            out["thaw_s"] = time.perf_counter() - t0
            log(f"[pipeline] heap frozen in {out['freeze_s']:.1f} s, thawed "
                f"and collected in {out['thaw_s']:.1f} s")
        out["launches"] = {f"{n} {label}": out[n][label]["launches"]
                           for n in ("mixed_100k", "iot_1m_share")
                           for label in ("bypass_off", "bypass_on")}
        log(f"[pipeline] heads: {json.dumps(dict(port_kit().wire.heads))}")
        return out

    # -- phase 14: the rest of the signature engine's device surface -----

    def surfaces_cpu(self, engine):
        """The CPU twin of an engine's live snapshot: the same compiled
        tables' device state on the CPU, for the torch bodies' checks."""
        from maxmq_tpu_torch.matching.sig import device_tables, table_arrays

        return device_tables(table_arrays(engine.tables), "cpu")

    def check_answers(self, what: str, index, topics, answers) -> None:
        bad = [t for t, a in zip(topics, answers)
               if normalize(a) != normalize(index.subscribers(t))]
        if bad:
            raise AssertionError(f"{what}: {len(bad)} answers differ from "
                                 f"the CPU trie (first {bad[0]!r})")

    def surfaces_check(self, name: str) -> dict:
        """On the check batch: the word path (``match_raw``,
        ``subscribers_batch``), the compact path (``match_compact``,
        ``subscribers_compact_batch``) and the fixed path's row-matrix
        surface (``match_fixed``, ``counts_fixed``, ``decode_fixed``) on
        the card, each device output bit-equal to the same snapshot's
        program on the CPU (the torch bodies; for the fixed path the
        kernel's plain version), every answer equal to the CPU trie's."""
        from maxmq_tpu_torch.matching import sig as sigmod
        from maxmq_tpu_torch.matching.sig_tables import prepare_batch

        sk = self.sig_kernel
        engine = self.engine(name)
        _f, _g, index = self.corpus(name)
        tables = engine.tables
        cpu = self.surfaces_cpu(engine)
        topics = self.check_batch(name)
        out = {"batch": len(topics), "words": int(tables.group_words.sum())}

        got = engine.match_raw(topics)
        toks, lengths, dollar = tables.tokenize(topics, engine.max_levels)
        want = [t.numpy() for t in sigmod.word_program(
            cpu, toks, lengths, dollar)]
        want[1] = want[1].view(np.uint32)
        if not all(np.array_equal(g, w) for g, w in zip(got[:3], want)):
            raise AssertionError(f"{name}: match_raw on the card differs "
                                 "from the word body on the CPU")
        out["word_overflow_topics"] = int(got[2].sum())
        out["nonzero_words_max"] = int((got[0] >= 0).sum(axis=1).max())
        self.check_answers(f"{name} subscribers_batch", index, topics,
                           engine.subscribers_batch(topics))

        counts, stream, total, _hr, _t = engine.match_compact(topics)
        toks8, lens_enc, _hr = prepare_batch(tables, topics)
        cap = sigmod.COMPACT_CAP_PER_TOPIC * len(topics)
        w_counts, w_stream, w_total = (
            t.numpy() for t in sigmod.compact_program(cpu, toks8, lens_enc))
        n = min(total, cap)
        if not (np.array_equal(counts, w_counts) and total == int(w_total)
                and np.array_equal(stream[:n], w_stream[:n].view(np.uint32))):
            raise AssertionError(f"{name}: match_compact on the card differs "
                                 "from the compact body on the CPU")
        out.update(compact_total=total, compact_cap=cap,
                   compact_overflow_topics=int((counts == 255).sum()),
                   compact_stream_overflow=total > cap)
        self.check_answers(f"{name} subscribers_compact_batch", index,
                           topics, engine.subscribers_compact_batch(topics))

        launches0 = sk.sig_match_fixed.launches
        ctx = engine.dispatch_fixed(topics)
        cnt, rows, hostrows, tb = engine.match_fixed([], out=ctx)
        # the kernel's plain version on the CPU twin, same padded batch,
        # its stream scattered back to one row per topic here
        kr = engine.fixed_max_rows
        c_counts, c_stream = (t.numpy() for t in sk.build_fixed_fn(
            cpu, engine.kernel_plan, kr)(ctx.toks8, ctx.lens_enc))
        real = np.where(c_counts == 255, 0, c_counts).astype(np.int64)
        w_cnt = np.where(c_counts == 255, 15, c_counts).astype(np.int32)
        w_rows = np.full((len(w_cnt), kr), 0xFFFFFFFF, dtype=np.uint32)
        w_rows[np.arange(kr)[None, :] < real[:, None]] = \
            c_stream[:int(real.sum())].view(np.uint32)
        if not (np.array_equal(cnt, w_cnt) and np.array_equal(rows, w_rows)):
            raise AssertionError(f"{name}: match_fixed on the card differs "
                                 "from the kernel's plain version on the "
                                 "CPU")
        if not np.array_equal(engine.counts_fixed(
                engine.dispatch_fixed(topics))[0], cnt):
            raise AssertionError(f"{name}: counts_fixed differs")
        ctx = engine.dispatch_fixed(topics)
        decoded = engine.decode_fixed(topics, *engine.match_fixed(
            [], out=ctx), ctx[4], ctx[5])
        collected = engine.collect_fixed(topics, engine.dispatch_fixed(topics))
        if any(normalize(a) != normalize(b)
               for a, b in zip(decoded, collected)):
            raise AssertionError(f"{name}: decode_fixed differs from "
                                 "collect_fixed")
        self.check_answers(f"{name} decode_fixed", index, topics, decoded)
        out["fixed_dispatches"] = 4
        out["fixed_launches"] = sk.sig_match_fixed.launches - launches0
        out["fixed_overflow_topics"] = int((cnt[:len(topics)] == 15).sum())
        out["fixed_rows"] = int(real.sum())
        if self.device.type == "cuda" and out["fixed_launches"] != 4:
            raise AssertionError(f"{name}: {out['fixed_launches']} kernel "
                                 "launches for 4 dispatches")
        return out

    def surfaces_faults(self, name: str) -> dict:
        """An armed ``DEVICE_MATCH`` fails ``subscribers_batch`` with
        ``DeviceMatchError`` and no trie answer; ``match_compact`` passes
        it by unconsumed."""
        from maxmq_tpu_torch import faults

        engine = self.engine(name)
        topics = self.check_batch(name)[:64]
        fallbacks = engine.fallbacks
        faults.clear()
        try:
            faults.arm(faults.DEVICE_MATCH, "raise", 1)
            engine.match_compact(topics)
            if faults.fired.get(faults.DEVICE_MATCH, 0) or \
                    not faults.armed(faults.DEVICE_MATCH):
                raise AssertionError("match_compact consumed DEVICE_MATCH")
            try:
                engine.subscribers_batch(topics)
            except faults.DeviceMatchError as exc:
                raised = type(exc).__name__
            else:
                raise AssertionError("subscribers_batch served an armed "
                                     "DEVICE_MATCH")
            if engine.fallbacks != fallbacks:
                raise AssertionError("subscribers_batch answered from the "
                                     "trie under a device fault")
            return {"raised": raised,
                    "fired": faults.fired[faults.DEVICE_MATCH]}
        finally:
            faults.clear()

    def surfaces_timing(self, name: str) -> dict:
        """The word program and the compact program on one
        ``decode_batch``-topic batch (CUDA events; launches and busy ms by
        the profiler; the peak memory of each), and the topics/s of
        ``subscribers_batch`` (the Python word-form decode) on a
        sample."""
        from maxmq_tpu_torch.matching import sig as sigmod
        from maxmq_tpu_torch.matching.sig_tables import prepare_batch

        torch = self.torch
        engine = self.engine(name)
        _f, gen, index = self.corpus(name)
        tables = engine.tables
        dev = engine.device_state
        batch = self.sizes["decode_batch"]
        topics = gen(batch, seed2=14_000)
        toks, lengths, dollar = tables.tokenize(topics, engine.max_levels)
        toks8, lens_enc, _hr = prepare_batch(tables, topics)
        programs = {
            "word": lambda: sigmod.word_program(dev, toks, lengths, dollar),
            "compact": lambda: sigmod.compact_program(dev, toks8, lens_enc)}
        out = {"batch": batch, "words": int(tables.group_words.sum()),
               "word_matrix_bytes": batch * max(
                   int(tables.group_words.sum()), 1) * 8}
        for label, fn in programs.items():
            if self.device.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            ms = self.time_ms(fn, 2)
            rec = {"ms": ms, "topics_per_s": batch / (ms / 1e3)}
            if self.device.type == "cuda":
                rec["peak_bytes"] = torch.cuda.max_memory_allocated() - base
            rec["profile"] = self.profile(fn)
            out[label] = rec
        sample = topics[:self.sizes["nfa_sample"]]
        engine.subscribers_batch(sample[:16])
        t0 = time.perf_counter()
        answers = engine.subscribers_batch(sample)
        dt = time.perf_counter() - t0
        self.check_answers(f"{name} timed subscribers_batch", index, sample,
                           answers)
        out["subscribers_batch"] = {"topics": len(sample), "s": dt,
                                    "topics_per_s": len(sample) / dt}
        return out

    def sig_surfaces(self) -> dict:
        """Phase 14 on phase 4's engines: the checks on each corpus, the
        fault sites on ``mixed_100k`` and the timings."""
        out = {}
        self.zero_kernel_counts()
        for name in ("iot_1m_share", "mixed_100k"):
            rec = {"check": self.surfaces_check(name)}
            if name == "mixed_100k":
                rec["faults"] = self.surfaces_faults(name)
            rec["timing"] = self.surfaces_timing(name)
            log(f"[surfaces] {name}: {json.dumps(rec)}")
            out[name] = rec
        counts = self.kernel_counts()
        log(f"[surfaces] kernel launches: {json.dumps(counts)}")
        if self.device.type == "cuda" and (not counts["sig_match_fixed"]
                                           or counts["dense_walk_words"]):
            raise AssertionError(f"sig surfaces: launches {counts}")
        out["launches"] = counts["sig_match_fixed"]
        return out

    # -- dense phases (5-7) ---------------------------------------------

    def dense_corpus(self):
        """(subscriptions, topic generator, port TopicIndex) of
        ``dense_2k``."""
        if self.dense is None:
            from maxmq_tpu_torch.matching.trie import TopicIndex
            from maxmq_tpu_torch.protocol import Subscription

            t0 = time.perf_counter()
            subs, gen = build_dense_corpus(**self.sizes["dense_corpus"])
            index = TopicIndex()
            for cid, f, qos in subs:
                index.subscribe(cid, Subscription(filter=f, qos=qos))
            log(f"[corpus] dense_2k: {len(subs)} subscriptions indexed in "
                f"{time.perf_counter() - t0:.1f} s")
            self.dense = (subs, gen, index)
        return self.dense

    def dense_engine(self):
        """The in-process DenseEngine on ``dense_2k``, kernel route."""
        if self.dense_eng is None:
            from maxmq_tpu_torch.matching.dense import DenseEngine

            _s, _g, index = self.dense_corpus()
            t0 = time.perf_counter()
            engine = DenseEngine(index, device=self.device,
                                 max_levels=DENSE_MAX_LEVELS,
                                 auto_refresh=False)
            if not engine.kernel_active:
                raise AssertionError("dense_2k must fit the dense kernel")
            tables = engine.tables
            log(f"[corpus] dense_2k: tables compiled and uploaded in "
                f"{time.perf_counter() - t0:.1f} s: {tables.n_rows} rows, "
                f"{len(tables.entries)} entries, level widths "
                f"{[len(lv.child_tok) for lv in tables.levels]}")
            self.dense_eng = engine
        return self.dense_eng

    def dense_inputs(self, tables, topics: list[str]):
        """Tokenized, bucket-padded (toks, lengths, dollar) on the device,
        as the engine hands them to its program."""
        from maxmq_tpu_torch.matching.topics import pad_topic_batch

        arrays = pad_topic_batch(*tables.tokenize(topics, DENSE_MAX_LEVELS))
        return [self.torch.from_numpy(a).to(self.device) for a in arrays]

    def dense_kernel_vs_plain(self) -> dict:
        from maxmq_tpu_torch.matching.dense import compile_dense
        from maxmq_tpu_torch.matching.trie import TopicIndex
        from maxmq_tpu_torch.protocol import Subscription

        dk, torch = self.dense_kernel, self.torch
        _s, gen, _i = self.dense_corpus()
        topics = gen(self.sizes["check_batch"], seed2=7)
        extra = ["$SYS/l0t1", "$" + topics[0], topics[1] + "/a" * 20, ""]
        narrow_subs, narrow_gen = build_dense_corpus(
            n_filters=40, n_subs=400, width=20, seed=43)
        narrow = TopicIndex()
        for cid, f, qos in narrow_subs:
            narrow.subscribe(cid, Subscription(filter=f, qos=qos))
        cases = (("dense_2k", self.dense_engine().tables, topics + extra),
                 ("narrow", compile_dense(narrow),
                  narrow_gen(1000, seed2=8) + extra))
        out = {}
        launches0 = dk.dense_walk_words.launches
        for name, tables, batch in cases:
            matcher = dk.KernelMatcher(tables, DENSE_MAX_LEVELS,
                                       device=self.device)
            args = self.dense_inputs(tables, batch)
            row_words = (matcher.pt.n_rows + 31) // 32
            out[name] = {"batch": len(batch), "bucket": args[0].shape[0],
                         "slots": matcher.pt.slots,
                         "n_levels": matcher.pt.n_levels,
                         "n_rows": matcher.pt.n_rows, "row_words": row_words}
            for mw in (32, 1, 100):
                got = dk.dense_walk_words(*args, matcher.kt, mw)
                want = dk.dense_walk_words_plain(*args, matcher.kt, mw)
                equal, err = self.dense_compare(got, want)
                n_over = int(want[2].sum())
                out[name][f"max_words_{mw}"] = {
                    "matching_topics": int((want[0][:, 0] >= 0).sum()),
                    "overflow_topics": n_over,
                    "bit_equal": equal, "max_abs_err": err}
                if not equal:
                    raise AssertionError(
                        f"dense {name} max_words {mw}: kernel disagrees "
                        f"with its plain version: {out[name]}")
            # on dense_2k, max_words 1 must overflow topics that have
            # nonzero words beyond the first (not only the too-deep one)
            if name == "dense_2k" and (
                    out[name]["max_words_1"]["overflow_topics"]
                    <= out[name]["max_words_32"]["overflow_topics"]):
                raise AssertionError(f"dense {name}: max_words 1 overflowed "
                                     "no topic with several words")
        if out["narrow"]["slots"] % 128 == 0:
            raise AssertionError("the narrow table must have slots that are "
                                 "not a multiple of 128")
        if min(out[n]["row_words"] for n in out) < 2:
            # max_words 1 falls below every table's words, 100 above
            raise AssertionError("each table needs more than one row word")
        out["launches"] = dk.dense_walk_words.launches - launches0
        if self.device.type == "cuda" and out["launches"] != 6:
            raise AssertionError(f"dense: {out['launches']} launches for "
                                 "six checks")
        log(f"[dense-kernel] {json.dumps(out)}")
        return out

    def dense_compare(self, got, want):
        """``dense_walk_words``' (word_idx, word_val, overflow) against its
        plain version's, bit for bit. Folds the result into
        ``self.dense_record``; returns (bit_equal, max_abs_err)."""
        torch = self.torch
        self.sync()
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  if g.numel() else 0 for g, w in zip(got, want))
        equal = all(g.shape == w.shape and torch.equal(g, w)
                    for g, w in zip(got, want))
        rec = self.dense_record
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["bit_equal"] &= equal
        return equal, err

    async def dense_service_path(self) -> dict:
        from maxmq_tpu_torch.matching.batcher import MicroBatcher
        from maxmq_tpu_torch.matching.dense import DenseEngine
        from maxmq_tpu_torch.matching.service import (MatcherService,
                                                      ServiceMatcher)
        from maxmq_tpu_torch.protocol import Subscription

        dk = self.dense_kernel
        subs, gen, mirror = self.dense_corpus()
        path = os.path.join(tempfile.mkdtemp(prefix="maxmq-smoke-"),
                            "m.sock")
        device = self.device
        svc = MatcherService(path, engine_factory=lambda index: MicroBatcher(
            DenseEngine(index, device=device, max_levels=DENSE_MAX_LEVELS),
            cpu_bypass=False))
        await svc.start()
        client = ServiceMatcher(path)
        try:
            await client.connect()
            t0 = time.perf_counter()
            for cid, f, qos in subs:
                client.forward_subscribe(cid, Subscription(filter=f, qos=qos))
            await client.subscribers_async("smoke/barrier")  # ops applied
            engine = svc.matcher.engine
            engine.refresh()
            log(f"[dense-service] {len(subs)} OP_SUB applied and compiled in "
                f"{time.perf_counter() - t0:.1f} s "
                f"(index {svc.index.subscription_count}, kernel_active "
                f"{engine.kernel_active})")
            warm = gen(self.sizes["service_warm"], seed2=98)
            await asyncio.gather(*(client.enqueue(t) for t in warm))
            dk.dense_walk_words.launches = 0
            rounds = await self.service_rounds(
                client, svc, gen, mirror, False, 5000, dk.dense_walk_words,
                DENSE_COUNTERS)
            launches = dk.dense_walk_words.launches
            kernel_active = engine.kernel_active
        finally:
            await client.close()
            await svc.close()
        out = {"launches": launches, "kernel_active": kernel_active,
               **rounds}
        log(f"[dense-service] {json.dumps(out)}")
        if rounds["mismatches"]:
            raise AssertionError(f"{rounds['mismatches']} dense service "
                                 "answers differ from the CPU trie")
        if not kernel_active:
            raise AssertionError("the dense service engine left the kernel")
        # dense_2k publishes to ~12K distinct topics, so the batcher's
        # result cache answers repeats; with the bypass off it holds only
        # answers of the device path
        served = rounds["device_topics"] + rounds["cache_hits"]
        if served * 2 <= rounds["topics"] or rounds["bypasses"]:
            raise AssertionError(
                f"the dense device path served only {served} of "
                f"{rounds['topics']} topics ({rounds['device_topics']} "
                f"matched, {rounds['cache_hits']} repeats from its cache)")
        if self.device.type == "cuda" and launches <= 0:
            raise AssertionError("the dense service path launched no kernel")
        return out

    def dense_walk_work(self, kt: dict, toks, lengths, dollar) -> dict:
        """The work the walk and its extract must do on this batch,
        counted in the units of ``DENSE_OPS``: the levels each topic walks
        (every topic walks level 0, and a deeper level while its state
        after the level before is not empty: nothing deeper can match),
        those levels' real slots and emitter slots, and the topics'
        nonzero row words."""
        from maxmq_tpu_torch.matching.dense import walk_step

        torch = self.torch
        parent_idx = kt["parent_idx"].to(torch.int64)
        work = dict.fromkeys(DENSE_OPS, 0)
        # not work the function needs: the slot visits of the kernel's
        # lanes (a warp walks a level while any of its 32 topics is active)
        work["warp_slot_lanes"] = 0
        for a in range(0, toks.shape[0], 16384):
            t, dol = toks[a:a + 16384], dollar[a:a + 16384]
            n = t.shape[0]
            s = torch.ones((n, kt["slots"]), dtype=torch.bool,
                           device=t.device)
            active = torch.ones(n, dtype=torch.bool, device=t.device)
            warps = -(-n // 32)
            for lvl in range(kt["n_levels"]):
                walking = int(active.sum())
                lanes = torch.zeros(warps * 32, dtype=torch.bool,
                                    device=t.device)
                lanes[:n] = active
                work["warp_slot_lanes"] += (int(lanes.view(warps, 32).any(
                    dim=1).sum()) * 32 * kt["width"][lvl])
                work["level"] += walking
                work["slot"] += walking * kt["width"][lvl]
                work["emit_slot"] += walking * kt["n_emit"][lvl]
                tok = (t[:, lvl] if lvl < t.shape[1] else
                       torch.full((n,), -1, dtype=torch.int32,
                                  device=t.device))[:, None]
                s = walk_step(s, parent_idx[lvl], tok, kt["child_tok"][lvl],
                              dol if lvl == 0 else None)
                active = active & s.any(dim=1)
        words = self.dense_kernel.walk_packed_plain(
            toks, lengths, dollar, kt, max((kt["n_rows"] + 31) // 32, 1))
        work["nz_word"] = int((words != 0).sum())
        return work

    def dense_blocks(self, kt: dict, batch: int):
        """Blocks of one kernel launch on the card (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        from maxmq_tpu_torch import kernels

        return kernels.library("dense_walk").dense_walk_blocks(
            kt["n_levels"], kt["slots"], batch)

    def dense_headline(self) -> dict:
        from maxmq_tpu_torch.matching.dense import (dense_arrays,
                                                    dense_device_tables,
                                                    dense_match_body)
        from maxmq_tpu_torch.matching.topics import pad_topic_batch

        dk, torch = self.dense_kernel, self.torch
        engine = self.dense_engine()
        tables, program = engine._state
        _s, gen, index = self.dense_corpus()
        batch = self.sizes["headline_batch"]
        batches = [gen(batch, seed2=4000 + i) for i in range(2)]
        warm = 1                         # batch 0 warms the pipeline
        base = {k: getattr(engine, k) for k in ("matches", "fallbacks")}
        dk.dense_walk_words.launches = 0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        times = {"prep": [], "fetch": [], "decode": []}
        pending = None
        first_results = None
        t_first = t_last = 0.0
        for i in range(len(batches) + 1):
            topics = batches[i] if i < len(batches) else None
            t0 = t1 = time.perf_counter()
            out = None
            if topics:
                arrays = pad_topic_batch(*tables.tokenize(
                    topics, engine.max_levels))
                t1 = time.perf_counter()
                out = engine._run(program, *arrays)    # enqueued, no wait
            if i == warm:
                t_first = t0
            if topics and i >= warm:
                times["prep"].append(t1 - t0)
            if pending is not None:      # collect the batch before this one
                j, p_topics, p_out = pending
                t2 = time.perf_counter()
                word_idx, word_val, overflow = engine._fetch(p_out)
                t3 = time.perf_counter()
                if j >= warm:            # the warm batch is not decoded
                    b = len(p_topics)
                    res = engine.decode_batch(
                        p_topics, word_idx[:b], word_val[:b], overflow[:b],
                        tables)
                    t_last = time.perf_counter()
                    times["fetch"].append(t3 - t2)
                    times["decode"].append(t_last - t3)
                    if j == warm:
                        first_results = (p_topics, res)
            pending = (i, topics, out) if topics else None
        launches = dk.dense_walk_words.launches
        d = {k: getattr(engine, k) - v for k, v in base.items()}
        if self.device.type == "cuda" and launches < len(batches):
            raise AssertionError(f"dense_2k: {launches} launches for "
                                 f"{len(batches)} batches")
        topics, res = first_results
        per_topic = statistics.mean(len(r) for r in res)
        rng = random.Random(5)
        for j in rng.sample(range(len(topics)), min(2000, len(topics))):
            if normalize(res[j]) != normalize(index.subscribers(topics[j])):
                raise AssertionError(f"dense_2k: wrong answer for "
                                     f"{topics[j]!r}")

        # the kernel (on the batch and on the service's 256 topics), its
        # plain version, the walk and the bound, on batch 0
        args = self.dense_inputs(tables, batches[0])
        kt, mw = program.kt, program.max_words
        kernel_ms = self.time_ms(
            lambda: dk.dense_walk_words(*args, kt, mw), 20)
        small = [a[:SERVICE_BATCH] for a in args]
        kernel_ms_256 = self.time_ms(
            lambda: dk.dense_walk_words(*small, kt, mw), 20)
        got = dk.dense_walk_words(*args, kt, mw)
        plain = []
        plain_ms = self.time_ms(lambda: plain.append(
            dk.dense_walk_words_plain(*args, kt, mw)), 1)
        equal, err = self.dense_compare(got, plain[-1])
        del plain
        if not equal:
            raise AssertionError(f"dense_2k headline batch: kernel disagrees "
                                 f"with its plain version (max_abs_err "
                                 f"{err})")
        walk_dev = dense_device_tables(dense_arrays(tables), self.device)
        walk_ms = self.time_ms(lambda: dense_match_body(
            walk_dev["levels"], *args, n_rows=tables.n_rows,
            max_words=engine.max_words), 3)
        bucket, n_cols = args[0].shape
        work = self.dense_walk_work(kt, *args)
        ops = sum(DENSE_OPS[k] * work[k] for k in DENSE_OPS)
        # the tables as the function needs them: 9 bytes a slot (token,
        # parent, exact flag) and the per-level sizes
        table_bytes = kt["n_levels"] * kt["slots"] * 9 + kt["meta"].numel() * 4
        nbytes = (bucket * min(kt["n_levels"], n_cols) * 4 + bucket * 5
                  + table_bytes + bucket * (mw * 8 + 1))
        # what the kernel stages: each block copies the slot entries and
        # chunk masks into shared memory once
        staged = (kt["slot_tab"].numel() + kt["chunk_masks"].numel()
                  + kt["meta"].numel()) * 4
        blocks = self.dense_blocks(kt, bucket)
        t_ops = ops / INT32_OPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        timed_topics = batch * len(times["decode"])
        out = {
            "subs": index.subscription_count, "batch": batch,
            "bucket": bucket, "n_rows": tables.n_rows,
            "slots": kt["slots"], "level_widths": kt["width"],
            "max_words": mw, "launches": launches,
            "host_prep_topics_per_s": batch / statistics.mean(times["prep"]),
            "extract_fetch_topics_per_s": batch / statistics.mean(
                times["fetch"]),
            "decode_topics_per_s": batch / statistics.mean(times["decode"]),
            "pipelined_topics_per_s": timed_topics / (t_last - t_first),
            "kernel_ms": kernel_ms,
            "kernel_topics_per_s": bucket / (kernel_ms / 1e3),
            "kernel_ms_256": kernel_ms_256,
            "table_bytes_staged_per_block": staged, "blocks": blocks,
            "table_bytes": staged * blocks if blocks else None,
            "plain_ms": plain_ms, "walk_ms": walk_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ops_ms": t_ops, "bound_bytes_ms": t_bytes,
            "walk_work": work, "int32_ops": ops, "bytes": nbytes,
            "bit_equal": equal, "max_abs_err": err,
            "matching_topics": int((got[0][:batch, 0] >= 0).sum()),
            "overflow_topics": int(got[2][:batch].sum()),
            "subscribers_per_topic": per_topic,
            "library_ms": None,    # no single PyTorch call computes this
            "decoded": "python",   # the dense decode is the reference's
            **d,
        }
        if self.device.type == "cuda":
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"[dense-headline] dense_2k: {json.dumps(out)}")
        log("[dense-headline] dense_2k: library yardstick: none — no single "
            "PyTorch call computes this function; the walk (the route past "
            "the kernel's capacity, the reference's default) is timed "
            "beside it")
        return out

    # -- NFA phases (9-11) and the cluster phase (12) --------------------

    def phase(self, name: str, fn, *args):
        """Run one phase and log its wall time, the garbage collector's
        full passes in it (count, total and longest ms) and the routes
        its host prep took. Where the native runtime is loaded, a topic
        prepared by numpy or tokenized by the Python loop fails the
        phase."""
        from maxmq_tpu_torch import native
        from maxmq_tpu_torch.matching import sig_tables, topics

        counters = {"prepared": sig_tables.prepared,
                    "tokenized": topics.tokenized}
        before = {k: dict(c) for k, c in counters.items()}
        t0 = time.perf_counter()
        with full_collections() as pauses:
            out = fn(*args)
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
        log(f"[phase] {name}: full collections {len(pauses)}, "
            f"{sum(pauses):.1f} ms, longest {max(pauses, default=0.0):.1f} "
            "ms")
        routes = {k: {r: n - before[k][r] for r, n in c.items()}
                  for k, c in counters.items()}
        log(f"[phase] {name}: host prep {json.dumps(routes)}")
        slow = routes["prepared"]["numpy"] + routes["tokenized"]["python"]
        if native.available() and slow:
            raise AssertionError(f"{name}: {slow} topics took the numpy or "
                                 "Python host prep while the native runtime "
                                 "is loaded")
        return out

    def kernel_counts(self) -> dict:
        """The hand-written kernels' launch counts."""
        return {"sig_match_fixed": self.sig_kernel.sig_match_fixed.launches,
                "dense_walk_words":
                    self.dense_kernel.dense_walk_words.launches}

    def zero_kernel_counts(self) -> None:
        self.sig_kernel.sig_match_fixed.launches = 0
        self.dense_kernel.dense_walk_words.launches = 0

    def profile(self, fn) -> dict | None:
        """Kernel launches and device busy time of one call of ``fn``, by
        ``torch.profiler`` (CUDA activity): launches, busy ms, and the
        kernels with the most device time. None on the CPU; the error
        where the profiler cannot trace the card."""
        if self.device.type != "cuda":
            return None
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        fn()
        self.sync()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                self.sync()
            by_name = {}
            for evt in prof.events():
                if evt.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                rec = by_name.setdefault(evt.name, [0, 0.0])
                rec[0] += 1
                rec[1] += evt.time_range.elapsed_us() / 1e3
        except RuntimeError as exc:
            return {"error": repr(exc)[:300]}
        kernels = {k: v for k, v in by_name.items()
                   if not k.startswith(("Memcpy", "Memset"))}
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
        return {"launches": sum(v[0] for v in kernels.values()),
                "busy_ms": sum(v[1] for v in kernels.values()),
                "copies": sum(v[0] for k, v in by_name.items()
                              if k not in kernels),
                "top": [{"name": k[:120], "n": v[0], "ms": v[1]}
                        for k, v in top]}

    def nfa_engine(self, name: str, width: int = 32, max_rows: int = 128):
        """An NFAEngine on corpus ``name`` on the device; the default
        configuration's is kept for the later phases."""
        if (width, max_rows) == (32, 128) and name in self.nfa_engines:
            return self.nfa_engines[name]
        from maxmq_tpu_torch.matching.engine import NFAEngine

        _f, _g, index = self.corpus(name)
        t0 = time.perf_counter()
        with collector_paused():
            engine = NFAEngine(index, width=width, max_rows=max_rows,
                               device=self.device, auto_refresh=False)
        t = engine.tables
        log(f"[nfa] {name} width {width} max_rows {max_rows}: tables "
            f"compiled and uploaded in {time.perf_counter() - t0:.1f} s "
            "(collector paused): "
            f"{t.n_nodes} nodes, {t.table_size} edge slots, "
            f"{len(t.row_entries)} rows, {len(t.vocab)} tokens")
        if (width, max_rows) == (32, 128):
            self.nfa_engines[name] = engine
        return engine

    def nfa_check(self, name: str) -> dict:
        """``NFAEngine.match_raw`` on the device against ``match_batch_body``
        on the CPU, bit for bit, on corpus ``name``'s check batch (and on
        ``mixed_100k`` in the narrow configuration too); every
        device-served answer against the CPU trie."""
        from maxmq_tpu_torch.matching.engine import (NFAEngine,
                                                     match_batch_body,
                                                     nfa_device_tables)
        from maxmq_tpu_torch.matching.topics import pad_topic_batch

        torch = self.torch
        out = {}
        self.zero_kernel_counts()
        configs = [(32, 128)] + ([NFA_NARROW] if name == "mixed_100k"
                                 else [])
        for width, max_rows in configs:
            engine = self.nfa_engine(name, width, max_rows)
            _f, _g, index = self.corpus(name)
            topics = self.check_batch(name)
            b = len(topics)
            tables = engine.tables
            rows, overflow, _t = engine.match_raw(topics)
            arrays = pad_topic_batch(*tables.tokenize(topics,
                                                      engine.max_levels))
            cpu_args = [torch.from_numpy(a) for a in arrays]
            cpu_tables = nfa_device_tables(tables, "cpu")
            mask = tables.table_size - 1
            want = match_batch_body(*cpu_tables, *cpu_args, width=width,
                                    table_mask=mask, max_rows=max_rows)
            equal = (np.array_equal(rows, want[0].numpy()[:b])
                     and np.array_equal(overflow, want[1].numpy()[:b]))
            too_deep = arrays[1][:b] < 0
            n_rows = (rows[~overflow] >= 0).sum(axis=1)
            rec = {"corpus": name, "batch": b, "bucket": len(arrays[1]),
                   "width": width, "max_rows": max_rows,
                   "overflow_topics": int(overflow.sum()),
                   "too_deep": int(too_deep.sum()),
                   "rows_max": int(n_rows.max()) if len(n_rows) else 0,
                   "rows_mean": float(n_rows.mean()) if len(n_rows) else 0.0,
                   "bit_equal": equal}
            if (width, max_rows) == NFA_NARROW:
                # the causes apart: the same walk with room for every row
                # overflows for width (or depth) only
                free = match_batch_body(
                    *cpu_tables, *cpu_args, width=width, table_mask=mask,
                    max_rows=(engine.max_levels + 1) * 2 * width)[1]
                free = free.numpy()[:b]
                rec["overflow_width"] = int((free & ~too_deep).sum())
                rec["overflow_rows"] = int((overflow & ~free).sum())
            bad = 0
            for i in np.flatnonzero(~overflow).tolist():
                got = NFAEngine.decode(rows[i], tables)
                if normalize(got) != normalize(index.subscribers(topics[i])):
                    bad += 1
            rec["checked"], rec["mismatches"] = int((~overflow).sum()), bad
            log(f"[nfa-check] {json.dumps(rec)}")
            if not equal:
                raise AssertionError(f"NFA {name} {width}/{max_rows}: the "
                                     "device disagrees with the CPU")
            if bad:
                raise AssertionError(f"NFA {name}: {bad} answers differ "
                                     "from the CPU trie")
            if not rec["too_deep"] or not rec["checked"]:
                raise AssertionError(f"NFA {name}: the check batch needs "
                                     "too-deep and device-served topics")
            if (width, max_rows) == NFA_NARROW and self.device.type == \
                    "cuda" and not (rec["overflow_width"]
                                    and rec["overflow_rows"]):
                raise AssertionError("the narrow NFA configuration must "
                                     f"overflow for both causes: {rec}")
            out[f"{name}/{width}/{max_rows}"] = rec
        out["kernel_launches"] = self.kernel_counts()
        return out

    async def nfa_service_path(self) -> dict:
        """The MatcherService with the NFA engine factory
        (``MicroBatcher(NFAEngine)``, host bypass off), the ``mixed_100k``
        subscriptions as OP_SUB frames and the five OP_MATCH requests;
        every answer is held against the CPU trie."""
        from maxmq_tpu_torch.matching.batcher import MicroBatcher
        from maxmq_tpu_torch.matching.engine import NFAEngine
        from maxmq_tpu_torch.matching.service import (MatcherService,
                                                      ServiceMatcher)
        from maxmq_tpu_torch.protocol import Subscription

        filters, gen, mirror = self.corpus("mixed_100k")
        path = os.path.join(tempfile.mkdtemp(prefix="maxmq-smoke-"),
                            "m.sock")
        device = self.device
        svc = MatcherService(path, engine_factory=lambda index: MicroBatcher(
            NFAEngine(index, device=device), cpu_bypass=False))
        await svc.start()
        client = ServiceMatcher(path)
        try:
            await client.connect()
            t0 = time.perf_counter()
            for i, f in enumerate(filters):
                client.forward_subscribe(
                    f"cl-{i}", Subscription(filter=f, qos=i % 3))
            await client.subscribers_async("smoke/barrier")  # ops applied
            engine = svc.matcher.engine
            engine.refresh()
            log(f"[nfa-service] {len(filters)} OP_SUB applied and compiled "
                f"in {time.perf_counter() - t0:.1f} s "
                f"(index {svc.index.subscription_count})")
            warm = gen(self.sizes["service_warm"], seed2=97)
            await asyncio.gather(*(client.enqueue(t) for t in warm))
            self.zero_kernel_counts()
            rounds = await self.service_rounds(
                client, svc, gen, mirror, False, 6000, None, NFA_COUNTERS)
            kernels = self.kernel_counts()
        finally:
            await client.close()
            await svc.close()
        out = {"kernel_launches": kernels, **rounds}
        log(f"[nfa-service] {json.dumps(out)}")
        if rounds["mismatches"]:
            raise AssertionError(f"{rounds['mismatches']} NFA service "
                                 "answers differ from the CPU trie")
        served = rounds["device_topics"] + rounds["cache_hits"]
        if served * 2 <= rounds["topics"] or rounds["bypasses"]:
            raise AssertionError(
                f"the NFA device path served only {served} of "
                f"{rounds['topics']} topics")
        return out

    def nfa_headline(self) -> dict:
        """``NFAEngine`` at ``iot_1m_share``, one 262,144-topic batch: host
        tokenize, the device program (CUDA events; launches and busy time
        by the profiler), fetch, overflow share, and the decode on a
        sample held against the CPU trie."""
        from maxmq_tpu_torch.matching.engine import NFAEngine
        from maxmq_tpu_torch.matching.topics import pad_topic_batch

        torch = self.torch
        engine = self.nfa_engine("iot_1m_share")
        _f, gen, index = self.corpus("iot_1m_share")
        batch = self.sizes["headline_batch"]
        topics = gen(batch, seed2=6000)
        tables = engine.tables
        self.zero_kernel_counts()
        t0 = time.perf_counter()
        arrays = pad_topic_batch(*tables.tokenize(topics, engine.max_levels))
        t_tok = time.perf_counter() - t0
        args = [torch.from_numpy(a).to(self.device) for a in arrays]
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        mask = tables.table_size - 1
        run = lambda: engine.program(engine.device_tables, *args,
                                     table_mask=mask)
        ms = self.time_ms(run, 5)
        prof = self.profile(run)
        t0 = time.perf_counter()
        rows_d, over_d = run()
        rows, overflow = rows_d.cpu().numpy()[:batch], \
            over_d.cpu().numpy()[:batch]
        t_fetch = time.perf_counter() - t0
        del rows_d, over_d
        sample = random.Random(6).sample(range(batch),
                                         min(self.sizes["nfa_sample"], batch))
        served = [j for j in sample if not overflow[j]]
        t0 = time.perf_counter()
        decoded = [NFAEngine.decode(rows[j], tables) for j in served]
        t_dec = time.perf_counter() - t0
        bad = sum(normalize(r) != normalize(index.subscribers(topics[j]))
                  for j, r in zip(served, decoded))
        if bad:
            raise AssertionError(f"NFA headline: {bad} answers differ from "
                                 "the CPU trie")
        n_rows = (rows >= 0).sum(axis=1)
        width, levels = engine.width, engine.max_levels
        out = {"subs": index.subscription_count, "batch": batch,
               "bucket": len(arrays[1]), "width": width,
               "max_rows": engine.max_rows, "max_levels": levels,
               "nodes": tables.n_nodes, "edge_slots": tables.table_size,
               "host_tokenize_topics_per_s": batch / t_tok,
               "program_ms": ms, "program_topics_per_s": batch / (ms / 1e3),
               "profile": prof, "fetch_ms": t_fetch * 1e3,
               "overflow_topics": int(overflow.sum()),
               "overflow_share": float(overflow.mean()),
               "rows_per_topic": float(n_rows[~overflow].mean())
               if (~overflow).any() else 0.0,
               "sample": len(sample), "sample_device_served": len(served),
               "decode_topics_per_s": len(served) / t_dec if t_dec else None,
               "decoded": "python",    # the NFA decode is the reference's
               "subscribers_per_topic": statistics.mean(
                   len(r) for r in decoded) if decoded else 0.0,
               "emission_buffer_bytes": len(arrays[1]) * (levels + 1) * 2
               * width * 4,
               "kernel_launches": self.kernel_counts()}
        if self.device.type == "cuda":
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"[nfa-headline] iot_1m_share: {json.dumps(out)}")
        return out

    def cluster_check(self, engine, cpu_mesh) -> dict:
        """``match_raw`` of a sharded engine on the device against the same
        program over ``cpu_mesh`` on the CPU (the engine's compiled shards,
        ``build_program``), bit for bit, on the check batch; then the
        engine's answers against the CPU trie."""
        from maxmq_tpu_torch.matching.sig_tables import prepare_batch_sig
        from maxmq_tpu_torch.parallel.sharded import ShardedSigEngine

        _f, _g, index = self.corpus("cluster_100k")
        topics = self.check_batch("cluster_100k")
        b = len(topics)
        if isinstance(engine, ShardedSigEngine):
            got, _hr, _shards, _t, _l = engine.match_raw(topics)
            state = engine._state
            twin = engine.build_program(state.stacked, mesh=cpu_mesh)
            padded = topics + ["\x01pad"] * (-b % twin.dp)
            toks, lens, _e, _len = prepare_batch_sig(
                state.shards[0], padded, window=max(state.d_max, 1),
                host_exact=state.union_exact)
            (want,) = twin(toks, lens)
            equal = np.array_equal(got, want[:, :b].astype(np.uint32))
            overflow = (got[:, :, 0] == 0xF).any(axis=0)
        else:
            rows, over, shards = engine.match_raw(topics)
            twin = engine.build_program(shards, mesh=cpu_mesh)
            padded = topics + [""] * (-b % twin.dp)
            want = twin(*shards[0].tokenize(padded, engine.max_levels))
            equal = (np.array_equal(rows, want[0][:, :b])
                     and np.array_equal(over, want[1][:, :b]))
            overflow = over.any(axis=0)
        results = engine.subscribers_batch(topics)
        bad = sum(normalize(r) != normalize(index.subscribers(t))
                  for t, r in zip(topics, results))
        rec = {"mesh": engine.mesh.shape, "batch": b, "bit_equal": equal,
               "overflow_topics": int(overflow.sum()), "mismatches": bad}
        if not equal:
            raise AssertionError(f"cluster {type(engine).__name__} on "
                                 f"{engine.mesh.shape}: the device "
                                 "disagrees with the CPU mesh")
        if bad:
            raise AssertionError(f"cluster {type(engine).__name__}: {bad} "
                                 "answers differ from the CPU trie")
        return rec

    def cluster_time(self, engine) -> dict:
        """The sharded engine's device program (every mesh cell) on one
        262,144-topic batch: CUDA events, launches and busy time, the
        bytes of its per-cell [b, W] matrix, and the peak memory."""
        from maxmq_tpu_torch.matching.sig_tables import prepare_batch_sig
        from maxmq_tpu_torch.parallel.sharded import ShardedSigEngine

        torch = self.torch
        _f, gen, _index = self.corpus("cluster_100k")
        batch = self.sizes["headline_batch"]
        topics = gen(batch, seed2=7100)
        t0 = time.perf_counter()
        if isinstance(engine, ShardedSigEngine):
            state = engine._state
            program = state.program
            arrays = prepare_batch_sig(state.shards[0], topics,
                                       window=max(state.d_max, 1),
                                       host_exact=state.union_exact)[:2]
            n_words = state.stacked[5].shape[2]
            # the [b, W] match words and the [b, W] expanded signatures,
            # uint32 held in int64
            matrix = {"what": "sig words [b, W] int64", "W": n_words,
                      "bytes_per_cell": batch // program.dp * n_words * 8}
        else:
            _v, shards, program = engine._state
            arrays = shards[0].tokenize(topics, engine.max_levels)
            cols = (engine.max_levels + 1) * 2 * engine.width
            matrix = {"what": "NFA emission buffer [b, (L+1)*2W] int32",
                      "W": cols, "bytes_per_cell": batch // program.dp
                      * cols * 4}
        t_prep = time.perf_counter() - t0
        matrix["cells"] = len(program.cells)
        inputs = program.upload(*arrays)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        run = lambda: program.run(inputs)
        ms = self.time_ms(run, 3)
        prof = self.profile(run)
        outs = program.fetch(run())
        if isinstance(engine, ShardedSigEngine):
            overflow = (outs[0][:, :, 0] == 0xF).any(axis=0)
        else:
            overflow = outs[1].any(axis=0)
        rec = {"batch": batch, "mesh": engine.mesh.shape,
               "host_prep_topics_per_s": batch / t_prep,
               "program_ms": ms, "program_topics_per_s": batch / (ms / 1e3),
               "profile": prof, "overflow_share": float(overflow.mean()),
               "matrix": matrix}
        if self.device.type == "cuda":
            rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        return rec

    def cluster(self) -> dict:
        """Bench config 5's shape: ``ShardedSigEngine`` and
        ``ShardedNFAEngine`` on 100,000 subscriptions (10 % '$share') over
        a 2 x 4 mesh of eight cells on the one device, batches of 8,192,
        every answer held against the CPU trie; each engine's match_raw
        against the same mesh on the CPU; the signature engine resharded
        to 1 x 4 and checked again; each device program timed at 262,144
        topics."""
        from maxmq_tpu_torch.parallel.sharded import (ShardedNFAEngine,
                                                      ShardedSigEngine,
                                                      make_mesh)

        _f, gen, index = self.corpus("cluster_100k")
        dev = self.device

        def mesh(shape, device):
            return make_mesh(shape, devices=[device] * (shape[0] * shape[1]))

        wanted = {}

        def expected(topic: str):
            want = wanted.get(topic)
            if want is None:
                want = wanted[topic] = normalize(index.subscribers(topic))
            return want

        out = {}
        self.zero_kernel_counts()
        for label, cls in (("sig", ShardedSigEngine),
                           ("nfa", ShardedNFAEngine)):
            t0 = time.perf_counter()
            with collector_paused():
                engine = cls(index, mesh=mesh(CLUSTER_MESH, dev))
            rec = {"compile_s": time.perf_counter() - t0}
            n = bad = 0
            t_match = 0.0
            for k in range(self.sizes["cluster_batches"]):
                topics = gen(self.sizes["cluster_batch"], seed2=7000 + k)
                t1 = time.perf_counter()
                res = engine.subscribers_batch(topics)
                t_match += time.perf_counter() - t1
                for t, r in zip(topics, res):
                    n += 1
                    bad += normalize(r) != expected(t)
            rec.update(topics=n, mismatches=bad, topics_per_s=n / t_match,
                       fallbacks=engine.fallbacks)
            if bad:
                raise AssertionError(f"cluster {label}: {bad} of {n} answers "
                                     "differ from the CPU trie")
            rec["check"] = self.cluster_check(engine,
                                              mesh(CLUSTER_MESH, "cpu"))
            rec["headline"] = self.cluster_time(engine)
            if label == "sig":
                rec["intents"] = self.cluster_intents(engine, gen, expected)
                t0 = time.perf_counter()
                engine.reshard(mesh(CLUSTER_RESHARD, dev))
                rec["reshard_s"] = time.perf_counter() - t0
                rec["reshard_check"] = self.cluster_check(
                    engine, mesh(CLUSTER_RESHARD, "cpu"))
            log(f"[cluster] {label}: {json.dumps(rec)}")
            out[label] = rec
            del engine
        out["kernel_launches"] = self.kernel_counts()
        log(f"[cluster] hand-written kernel launches: "
            f"{json.dumps(out['kernel_launches'])}")
        return out

    def cluster_intents(self, engine, gen, expected) -> dict:
        """``ShardedSigEngine`` with ``emit_intents`` on the cluster's
        batches: the native intents decode a shard, chained per topic
        (``ChainedIntents``), against the set path and the trie on every
        topic; each decode timed on the same device output."""
        from maxmq_tpu_torch import native
        from maxmq_tpu_torch.parallel.sharded import ChainedIntents

        engine.emit_intents = True
        t0 = time.perf_counter()
        rec = {"prewarm_chunks": engine.prewarm_decode_bases(),
               "prewarm_s": time.perf_counter() - t0}
        served = dict.fromkeys(engine.decoded, 0)
        n = bad = chained = 0
        t_sets = t_intents = t_batch = 0.0
        for k in range(self.sizes["cluster_batches"]):
            topics = gen(self.sizes["cluster_batch"], seed2=7000 + k)
            decoded0 = dict(engine.decoded)
            t0 = time.perf_counter()
            res = engine.subscribers_batch(topics)
            t_batch += time.perf_counter() - t0
            for key, v in engine.decoded.items():
                served[key] += v - decoded0[key]
            out, hostrows, shards, toks, lens = engine.match_raw(topics)
            t0 = time.perf_counter()
            sets = engine._decode_sets(topics, out, hostrows, shards, None)
            t1 = time.perf_counter()
            again = engine._decode_intents(topics, out, hostrows, shards,
                                           toks, lens)
            t_intents += time.perf_counter() - t1
            t_sets += t1 - t0
            for i, t in enumerate(topics):
                n += 1
                chained += isinstance(res[i], ChainedIntents)
                bad += (normalize(res[i]) != expected(t)
                        or not same_answer(res[i], sets[i])
                        or (again is not None
                            and not same_answer(again[i], sets[i])))
        engine.emit_intents = False
        rec.update(topics=n, mismatches=bad, chained=chained,
                   topics_per_s=n / t_batch,
                   decode_sets_topics_per_s=n / t_sets,
                   decode_intents_topics_per_s=(n / t_intents
                                                if again is not None
                                                else None),
                   decoded=served)
        self.check_decoded("cluster sig intents", served)
        if bad:
            raise AssertionError(f"cluster intents: {bad} of {n} answers "
                                 "differ from the set path or the trie")
        if native.decode_module() is not None and chained * 2 < n:
            raise AssertionError(f"cluster intents: only {chained} of {n} "
                                 "results were chained intents")
        log(f"[cluster] sig intents: {json.dumps(rec)}")
        return rec

    # -- phase 13: what the broker engine imports ----------------------

    def content_evaluator(self) -> dict:
        """Phase 13 (a): the content evaluator at each shape of the size
        table (predicates x payloads from ``mqttplus_inputs``). Each
        backend's matrix is held equal to the per-message loop's (and the
        torch one to NumPy's); the torch backend must serve every flush
        from the device (no breaker fallback) and its matrix come off a
        tensor on the device. Printed: the column build, each backend's
        eval on the host clock (copies included) and, for torch, in CUDA
        events, evals/s, and the launches of one flush (``torch.profiler``)."""
        from maxmq_tpu_torch.filtering.columnar import (
            ColumnarEvaluator, build_columns, device_matrix,
            eval_reference_batch)
        from maxmq_tpu_torch.filtering.expr import compile_expr

        reps = self.sizes["content"]["reps"]
        out = []
        for n_preds, n_msgs in self.sizes["content"]["shapes"]:
            exprs, objs = mqttplus_inputs(n_preds, n_msgs)
            preds = [compile_expr(e) for e in exprs]
            fields = tuple(dict.fromkeys(f for p in preds for f in p.fields))
            programs = [p.program for p in preds]
            t0 = time.perf_counter()
            for _ in range(reps):
                cols = build_columns(objs, fields)
            build_ms = (time.perf_counter() - t0) * 1e3 / reps
            t0 = time.perf_counter()
            loop = eval_reference_batch(preds, objs)
            loop_ms = (time.perf_counter() - t0) * 1e3
            pairs = n_preds * n_msgs
            rec = {"shape": f"{n_preds} x {n_msgs}",
                   "program_ops": sum(len(p) for p in programs),
                   "build_columns_ms": build_ms,
                   "passing_share": float(loop.mean()),
                   "reference_loop_ms": loop_ms,
                   "reference_loop_evals_per_s": pairs / loop_ms * 1e3}
            mats = {}
            for backend in ("numpy", "torch"):
                ev = ColumnarEvaluator(backend=backend, device=self.device)

                def flush(ev=ev):
                    return ev.eval_batch(programs, cols, n_msgs)

                flush()
                t0 = time.perf_counter()
                for _ in range(reps):
                    mats[backend] = flush()
                host_ms = (time.perf_counter() - t0) * 1e3 / reps
                r = {"eval_ms_host": host_ms,
                     "evals_per_s": pairs / host_ms * 1e3,
                     "device_fallbacks": ev.device_fallbacks,
                     "mismatches": int((mats[backend] != loop).sum())}
                if backend == "torch":
                    if self.device.type == "cuda":
                        r["eval_ms_events"] = self.time_ms(flush, reps)
                    prof = self.profile(flush)
                    r["launches_per_flush"] = (prof or {}).get("launches")
                    r["device_busy_ms"] = (prof or {}).get("busy_ms")
                    r["copies_per_flush"] = (prof or {}).get("copies")
                    r["top_kernels"] = (prof or {}).get("top", [])[:3]
                    dm = device_matrix(programs, cols, n_msgs, self.device)
                    r["result_device"] = str(dm.device)
                    if dm.device.type != self.device.type:
                        raise AssertionError(f"content {rec['shape']}: the "
                                             f"matrix came off {dm.device}")
                rec[backend] = r
            rec["torch_vs_numpy_mismatches"] = int(
                (mats["torch"] != mats["numpy"]).sum())
            log(f"[content] {json.dumps(rec)}")
            if (rec["torch_vs_numpy_mismatches"]
                    or any(rec[b]["mismatches"] for b in mats)):
                raise AssertionError(f"content {rec['shape']}: the "
                                     "matrices differ")
            if rec["torch"]["device_fallbacks"]:
                raise AssertionError(f"content {rec['shape']}: "
                                     f"{rec['torch']['device_fallbacks']} "
                                     "flushes fell back to NumPy unfaulted")
            out.append(rec)
        return {"shapes": out}

    async def traced_run(self, kit, engine, index, traffic, sample_n: int,
                         answer) -> tuple:
        """One run of phase 12's frames in bursts through a fresh
        ``SupervisedMatcher(MicroBatcher(engine))`` at the production
        settings, bypass off, with a ``PipelineTracer`` of stride
        ``sample_n`` on the batcher. Each sampled publish gets the
        broker's matcher spans when its future is awaited in order;
        latency runs from enqueue to the future's result. Returns the
        run's record, the tracer and the supervisor."""
        from maxmq_tpu_torch.matching.batcher import MicroBatcher
        from maxmq_tpu_torch.matching.supervisor import SupervisedMatcher
        from maxmq_tpu_torch.trace import PipelineTracer

        burst = self.sizes["pipeline"]["burst"]
        batcher = MicroBatcher(engine, cpu_bypass=False, **PIPELINE_BATCHER)
        sup = SupervisedMatcher(batcher, index=index,
                                **self.pipeline_supervisor())
        tracer = PipelineTracer(sample_n=sample_n)
        batcher.tracer = tracer
        frames, owners = traffic
        dec = PubDecoder(kit)
        lat, bad, marked = [], 0, 0
        spans = {s: [] for s in ("match_queue", "match_device",
                                 "pipeline_wait")}
        self.zero_kernel_counts()
        try:
            with full_collections() as gc_ms:
                t_run = time.perf_counter()
                for a in range(0, len(frames), burst):
                    pending = []
                    for p in dec.decode(frames[a:a + burst],
                                        owners[a:a + burst]):
                        tr = (tracer.sample(p.topic, p.fixed.qos, p.origin)
                              if tracer.sample_n else None)
                        t0 = time.perf_counter()
                        if tr is not None:
                            tr.t_match = tracer.clock()
                        fut = sup.enqueue(p.topic)
                        done = [0.0]
                        fut.add_done_callback(
                            lambda _f, d=done: d.__setitem__(
                                0, time.perf_counter()))
                        pending.append((p.topic, tr, fut, t0, done))
                    for topic, tr, fut, t0, done in pending:
                        r = await fut
                        marked += bool(getattr(fut, "_t_dispatch", 0))
                        if not same_answer(r, answer(topic)):
                            bad += 1
                        if tr is not None:
                            trace_match_spans(tracer, sup, tr, fut)
                            tracer.finish(tr)
                            for stage, _t, dur in tr.spans:
                                spans[stage].append(dur / 1e6)
                    await asyncio.sleep(0)  # the last done stamps run
                    lat.extend((done[0] - t0) * 1e3
                               for _t, _tr, _f, t0, done in pending)
                wall = time.perf_counter() - t_run
                launches = self.kernel_counts()["sig_match_fixed"]
        finally:
            await batcher.close()
        out = {"sample_n": sample_n, "publishes": len(frames),
               "wall_s": wall, "match_ms_p50_p99_max": spread(lat),
               "sampled": tracer.sampled, "allocations": tracer.allocations,
               "marked_futures": marked,
               "stage_ms_p50_p99_max": {k: spread(v)
                                        for k, v in spans.items() if v},
               "stage_quantiles": tracer.stage_quantiles(),
               "batches": batcher.batches, "launches": launches,
               "cache_hits": batcher.cache_hits, "batch_errors": batcher.errors,
               "fallbacks_by_reason": sup.fallbacks_by_reason,
               "breaker_trips": sup.breaker_trips,
               "gc_full_collections": len(gc_ms),
               "gc_full_ms_max": max(gc_ms, default=0.0),
               "mismatches": bad}
        hedged = {k: v for k, v in sup.fallbacks_by_reason.items()
                  if k != "overflow" and v}
        if hedged or sup.breaker_trips or bad or batcher.errors:
            raise AssertionError(f"traced run (sample_n {sample_n}): "
                                 f"hedges {hedged}, trips "
                                 f"{sup.breaker_trips}, {bad} answers unequal "
                                 f"to the trie, {batcher.errors} errors")
        n = len(frames)
        dispatched = n - batcher.cache_hits
        if sample_n:
            if tracer.sampled != n or marked != dispatched:
                raise AssertionError(f"{tracer.sampled} sampled and {marked} "
                                     f"marked of {n} publishes")
        elif tracer.allocations or marked:
            raise AssertionError(f"tracing off: {tracer.allocations} traces "
                                 f"allocated, {marked} futures marked")
        if self.device.type == "cuda" and launches != batcher.batches:
            raise AssertionError(f"{launches} sig_match_fixed launches for "
                                 f"{batcher.batches} batches")
        return out, tracer, sup

    def scrape(self, tracer, sup, engine, sampled: int, dispatched: int):
        """The tracer's and the matcher-side registrations served by
        ``MetricsServer`` on a free local port and scraped over HTTP:
        every matcher counter equals its attribute, the stage histograms
        count the sampled publishes (``match_queue`` the dispatched ones:
        a cache hit has no queue), the Chrome export parses."""
        import urllib.request
        from types import SimpleNamespace

        from maxmq_tpu_torch import metrics

        reg = metrics.Registry()
        metrics._register_trace_metrics(reg, SimpleNamespace(tracer=tracer))
        metrics._register_fallback_metrics(reg, sup)
        metrics._register_transport_metrics(reg, sup)
        metrics._register_breaker_metrics(reg, sup)
        metrics._register_kernel_width_metrics(reg, engine)
        srv = metrics.MetricsServer("127.0.0.1:0", reg, tracer=tracer)
        srv.start()
        try:
            base = f"http://127.0.0.1:{srv.bound_port}"
            with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
                text = r.read().decode()
            with urllib.request.urlopen(base + "/traces/chrome",
                                        timeout=30) as r:
                chrome = json.loads(r.read())
        finally:
            srv.stop()
        got = {}
        for line in text.splitlines():
            if line and not line.startswith("#"):
                name, _, value = line.rpartition(" ")
                got[name] = float(value)
        want = {f'maxmq_matcher_fallbacks_total{{reason="{k}"}}': v
                for k, v in sup.fallbacks_by_reason.items()}
        want.update({
            "maxmq_matcher_batch_errors_total": sup.errors,
            "maxmq_matcher_breaker_state": sup.breaker_state,
            "maxmq_matcher_breaker_trips_total": sup.breaker_trips,
            "maxmq_matcher_breaker_recoveries_total": sup.breaker_recoveries,
            "maxmq_matcher_degraded_seconds_total": sup.degraded_seconds,
            "maxmq_matcher_refresh_failures_total": sup.refresh_failures,
            "maxmq_broker_trace_sampled_total": tracer.sampled,
            'maxmq_broker_publish_stage_seconds_count{stage="match_device"}':
                sampled,
            'maxmq_broker_publish_stage_seconds_count{stage="match_queue"}':
                dispatched})
        for width in ("16", "32"):
            want[f'maxmq_matcher_kernel_words{{width="{width}"}}'] = \
                engine.kernel_plan[f"n_words{width}"]
            want[f'maxmq_matcher_kernel_groups{{width="{width}"}}'] = \
                engine.kernel_plan[f"groups{width}"]
        e2e = sum(v for k, v in got.items()
                  if k.startswith("maxmq_broker_publish_e2e_seconds_count"))
        diff = {k: (got.get(k), v) for k, v in want.items()
                if got.get(k) != float(v)}
        if diff or e2e != sampled:
            raise AssertionError(f"scraped /metrics disagrees with the "
                                 f"objects: {diff}, e2e count {e2e}")
        events = chrome["traceEvents"]
        if not events:
            raise AssertionError("the Chrome export has no events")
        return {"series": len(got), "checked": len(want) + 1,
                "metrics_bytes": len(text), "chrome_events": len(events)}

    async def service_tracing(self, burst: int, bypass: bool) -> dict:
        """The matcher service with a tracer on its client: the
        ``mixed_100k`` subscriptions as OP_SUB frames, then the size
        table's topics in bursts, one request a topic, each answer held
        against the CPU trie, with the service batcher's host bypass on
        (its default) or off. The service stamps its dispatch and done
        marks on every reply (ADR 017); the client rebases them, so each
        request splits into service time (``match_device``: the service's
        batcher, engine and decode) and the rest (``match_queue``: both
        socket directions, JSON and the client's own loop)."""
        from maxmq_tpu_torch.matching.service import (MatcherService,
                                                      ServiceMatcher)
        from maxmq_tpu_torch.protocol import Subscription
        from maxmq_tpu_torch.trace import PipelineTracer

        filters, gen, mirror = self.corpus("mixed_100k")
        topics = gen(self.sizes["tracing"]["service_topics"], seed2=5000)
        path = os.path.join(tempfile.mkdtemp(prefix="maxmq-smoke-"),
                            "m.sock")
        svc = MatcherService(path, device=self.device)
        await svc.start()
        client = ServiceMatcher(path)
        tracer = PipelineTracer(sample_n=1)
        total, service, socket_, bad = [], [], [], 0
        try:
            await client.connect()
            t0 = time.perf_counter()
            for i, f in enumerate(filters):
                client.forward_subscribe(
                    f"cl-{i}", Subscription(filter=f, qos=i % 3))
            await client.subscribers_async("smoke/barrier")
            engine = svc.matcher.engine
            while engine.tables.version != svc.index.sub_version:
                engine.refresh_soon()
                await asyncio.sleep(0.05)
                if time.perf_counter() - t0 > 600:
                    raise TimeoutError("service tables never caught up")
            engine.close()      # waits for the rotation's background warm
            setup_s = time.perf_counter() - t0
            svc.matcher.cpu_bypass = bypass
            warm = gen(self.sizes["service_warm"], seed2=99)
            await asyncio.gather(*(client.enqueue(t) for t in warm))
            client.tracer = tracer
            bypass0, launches0 = svc.matcher.bypasses, \
                self.kernel_counts()["sig_match_fixed"]
            for a in range(0, len(topics), burst):
                pending = []
                for t in topics[a:a + burst]:
                    tr = tracer.sample(t, 0, "svc")
                    t0 = time.perf_counter()
                    tr.t_match = tracer.clock()
                    fut = client.enqueue(t)
                    done = [0.0]
                    fut.add_done_callback(
                        lambda _f, d=done: d.__setitem__(
                            0, time.perf_counter()))
                    pending.append((t, tr, fut, t0, done))
                for t, tr, fut, t0, done in pending:
                    r = await fut
                    trace_match_spans(tracer, client, tr, fut)
                    tracer.finish(tr)
                    if normalize(r) != normalize(mirror.subscribers(t)):
                        bad += 1
                await asyncio.sleep(0)      # the last done stamps run
                for t, tr, fut, t0, done in pending:
                    ms = (done[0] - t0) * 1e3
                    svc_ms = (fut._t_done - fut._t_dispatch) / 1e6
                    total.append(ms)
                    service.append(svc_ms)
                    socket_.append(ms - svc_ms)
            bypassed = svc.matcher.bypasses - bypass0
            launches = self.kernel_counts()["sig_match_fixed"] - launches0
        finally:
            await client.close()
            await svc.close()
        out = {"bypass": bypass, "topics": len(topics), "burst": burst,
               "setup_s": setup_s,
               "request_ms_p50_p99_max": spread(total),
               "service_ms_p50_p99_max": spread(service),
               "socket_ms_p50_p99_max": spread(socket_),
               "service_share": sum(service) / max(sum(total), 1e-9),
               "bypassed": bypassed, "launches": launches,
               "stage_quantiles": tracer.stage_quantiles(),
               "mismatches": bad}
        if bad:
            raise AssertionError(f"{bad} service answers differ from the "
                                 "CPU trie")
        if tracer.stage_hist["match_device"].count != len(topics):
            raise AssertionError("a service reply carried no stamps")
        if not bypass and (bypassed or (self.device.type == "cuda"
                                        and launches <= 0)):
            raise AssertionError(f"with the bypass off {bypassed} topics "
                                 f"were bypassed, {launches} launches")
        return out

    async def matcher_tracing(self) -> dict:
        """Phase 13 (b): the tracer and metrics on the port's matcher
        stack. Phase 12's ``mixed_100k`` corpus and production boot
        (intents on, buckets warmed, decode bases prewarmed) and the first
        bursts of its frames: one untimed pass warms the engine and its
        decode caches on those topics, then the runs alternate traced
        (every publish sampled) and untraced (traced, untraced, untraced,
        traced), then the last traced run's registrations are scraped over
        HTTP, then the service runs with its adaptive bypass and with the
        bypass off. The heap is frozen for the phase, as phase 12 does."""
        from maxmq_tpu_torch.matching.batcher import MicroBatcher

        kit = port_kit()
        cfg = self.sizes["tracing"]
        burst = self.sizes["pipeline"]["burst"]
        _f, gen, _i = self.corpus("mixed_100k")
        index, engine, _clients = self.pipeline_corpus("mixed_100k")
        n = cfg["bursts"] * burst
        topics = gen(n, seed2=4000)
        traffic = publish_frames(kit, topics, 42)
        engine.emit_intents = True
        engine.warm_buckets(PIPELINE_BATCHER["max_batch"], background=False)
        engine.prewarm_decode_bases()
        answers = {}

        def answer(topic):
            r = answers.get(topic)
            if r is None:
                r = answers[topic] = index.subscribers(topic)
            return r

        out = {"publishes": n, "burst": burst, "traced": [],
               "untraced": []}
        t0 = time.perf_counter()
        warm = MicroBatcher(engine, cpu_bypass=False, **PIPELINE_BATCHER)
        try:
            for a in range(0, n, burst):
                await asyncio.gather(*(warm.enqueue(t)
                                       for t in topics[a:a + burst]))
        finally:
            await warm.close()
        out["warm_s"] = time.perf_counter() - t0
        gc.freeze()
        try:
            for sample_n in (1, 0, 0, 1):
                rec, tracer, sup = await self.traced_run(
                    kit, engine, index, traffic, sample_n, answer)
                label = "traced" if sample_n else "untraced"
                out[label].append(rec)
                log(f"[tracing] {label}: {json.dumps(rec)}")
            out["scrape"] = self.scrape(tracer, sup, engine, n,
                                        n - rec["cache_hits"])
            log(f"[tracing] scrape: {json.dumps(out['scrape'])}")
            out["service"] = {}
            for mode, bypass in (("adaptive", True), ("device", False)):
                out["service"][mode] = await self.service_tracing(burst,
                                                                  bypass)
                log(f"[tracing] service {mode}: "
                    f"{json.dumps(out['service'][mode])}")
        finally:
            gc.unfreeze()
            engine.close()
        out["launches"] = {
            "traced": [r["launches"] for r in out["traced"]],
            "untraced": [r["launches"] for r in out["untraced"]],
            **{f"service_{m}": r["launches"]
               for m, r in out["service"].items()}}
        return out

    # -- all phases ----------------------------------------------------

    def run(self) -> dict:
        self.phase("host runtime", self.host_runtime)
        checks = {name: self.phase(f"sig check {name}",
                                   self.kernel_vs_plain, name)
                  for name in ("mixed_100k", "hash_plus_100k",
                               "iot_1m_share")}
        if checks["hash_plus_100k"]["groups"] <= 40:
            raise AssertionError("hash_plus_100k must exceed 40 groups")
        log(f"[kernel] hash_plus_100k device groups: "
            f"{checks['hash_plus_100k']['groups']} (> 40: the TPU's MXU "
            "expansion regime)")
        self.phase("sig edges", self.sig_edges)
        service = self.phase("sig service",
                             lambda: asyncio.run(self.service_path()))
        heads = {name: self.phase(f"sig headline {name}", self.headline,
                                  name)
                 for name in ("iot_1m_share", "mixed_100k")}
        pipeline = self.phase("publish pipeline", lambda: asyncio.run(
            self.publish_pipelines()))
        surfaces = self.phase("sig surfaces", self.sig_surfaces)
        for engine in self.engines.values():
            engine.close()
        self.engines.clear()
        self.phase("dense check", self.dense_kernel_vs_plain)
        dense_service = self.phase(
            "dense service", lambda: asyncio.run(self.dense_service_path()))
        dh = self.phase("dense headline", self.dense_headline)
        # what the later phases no longer need goes, so the Python heap
        # the NFA phases allocate into stays small
        self.dense = self.dense_eng = None
        self.corpora.pop("hash_plus_100k", None)
        self.phase("nfa check mixed_100k", self.nfa_check, "mixed_100k")
        self.phase("nfa service", lambda: asyncio.run(
            self.nfa_service_path()))
        self.phase("nfa check iot_1m_share", self.nfa_check, "iot_1m_share")
        self.phase("nfa headline", self.nfa_headline)
        self.nfa_engines.clear()
        self.corpora.pop("iot_1m_share", None)
        self.phase("cluster", self.cluster)
        content = self.phase("content evaluator", self.content_evaluator)
        tracing = self.phase("matcher tracing", lambda: asyncio.run(
            self.matcher_tracing()))
        h = heads["iot_1m_share"]
        sig = dict(KERNELS["sig_match_fixed"], launches=service["launches"],
                   max_abs_err=self.record["max_abs_err"],
                   ms=h["kernel_ms"], plain_ms=h["plain_ms"],
                   bound_ms=h["bound_ms"], bound_by=h["bound_by"],
                   library_ms=None, bit_equal=self.record["bit_equal"],
                   shape=f"iot_1m_share batch {h['bucket']}",
                   ms_256=h["kernel_ms_256"],
                   publish_pipeline_launches=pipeline["launches"],
                   tracing_launches=tracing["launches"],
                   surfaces_launches=surfaces["launches"],
                   headline={k: {f: v[f] for f in
                                 ("kernel_ms", "kernel_ms_256", "plain_ms",
                                  "bound_ms", "bound_by", "launches")}
                             for k, v in heads.items()})
        dense = dict(KERNELS["dense_walk_words"],
                     launches=dense_service["launches"],
                     max_abs_err=self.dense_record["max_abs_err"],
                     ms=dh["kernel_ms"], plain_ms=dh["plain_ms"],
                     bound_ms=dh["bound_ms"], bound_by=dh["bound_by"],
                     library_ms=None,
                     bit_equal=self.dense_record["bit_equal"],
                     shape=f"dense_2k batch {dh['bucket']}",
                     walk_ms=dh["walk_ms"], ms_256=dh["kernel_ms_256"],
                     headline_launches=dh["launches"])
        return {"kernels": [sig, dense], "content": content,
                "tracing": tracing, "surfaces": surfaces}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    try:
        from maxmq_tpu_torch import kernels
    except ImportError as exc:
        print(f"chip_smoke: the maxmq_tpu_torch package is not beside this "
              f"script ({exc})", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    from maxmq_tpu_torch import native

    t0 = time.perf_counter()
    kernels.build_all()
    native.build_all()
    log(f"[build] all kernels and the host runtime in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rec in kernels.build_log.items():
        log(f"[build] {name}.cu: {rec['seconds']:.1f} s "
            f"(cached={rec['cached']})")
        for line in rec["ptxas"].splitlines():
            log(f"[build]   {line.strip()}")
    for name, rec in native.build_log.items():
        log(f"[build] host/{name}.cpp: {rec['seconds']:.1f} s "
            f"(cached={rec['cached']})")
    for name, err in native.build_errors.items():
        log(f"[build] host/{name}.cpp failed: {err}")

    for name in kernels.SIGNATURES:
        for fn, rec in kernel_sass(name).items():
            log(f"[sass] {name}.cu {fn}: {rec['instructions']} instructions")
            for loop in rec["inner_loops"]:
                log(f"[sass]   inner loop {loop['start']}-{loop['end']}: "
                    f"{loop['n']} instructions {json.dumps(loop['ops'])}")

    result = Smoke("cuda").run()
    faulthandler.cancel_dump_traceback_later()
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": result["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
