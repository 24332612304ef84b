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
   ``mixed_100k`` subscriptions (one OP_SUB frame each) and the OP_MATCH
   requests of ``service_rounds`` (one of 4,096 topics), twice: with the batcher's
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
   ``decode_batch`` topics, the decode runs three ways: the native sets,
   the native intents after ``prewarm_decode_bases``, and the Python
   decode on a ``decode_sample`` sample (cold, then with its row memo
   warm); the
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
   subscriptions as OP_SUB frames and the OP_MATCH request; every
   answer is held against the CPU trie;
7. dense headline: ``DenseEngine`` at batch 262,144 on ``dense_2k``,
   pipelined, the Python decode on the front ``decode_batch`` topics of
   the timed batch, with the kernel (and on 256 topics), its plain version
   (held bit for bit against it) and the torch walk timed on one batch;
8. NFA check: ``NFAEngine`` on the card against ``match_batch_body`` on
   the CPU, bit for bit on (rows, overflow), on the check batch of
   ``mixed_100k`` (and ``iot_1m_share`` where the size table's
   ``nfa_1m`` asks) and on a narrow configuration
   (width 4, max_rows 4) where both overflow causes appear; every
   device-served answer against the CPU trie;
9. NFA service: the MatcherService with ``MicroBatcher(NFAEngine)`` (host
   bypass off), the ``mixed_100k`` subscriptions as OP_SUB frames and the
   OP_MATCH request, every answer against the CPU trie;
10. NFA headline (where ``nfa_1m`` asks): ``NFAEngine`` at
   ``iot_1m_share``, one 262,144-topic
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
12. the broker engine (run last, after phase 16): on each corpus two of
   the port's ``Broker``s in this process, each with a ``TCPListener``
   on a free local port, ``AllowHook``, capabilities from
   ``capabilities_from_config`` over the default ``Config`` and $SYS
   off: the card broker, whose matcher ``build_matcher`` stacks as
   production does (``SupervisedMatcher(MicroBatcher(SigEngine))`` on
   the card: window 200 us, batch 256, depth 3; deadline 250 ms,
   breaker 5 in 10 s, backoff 1 s to 30 s; intents on, buckets warmed,
   decode bases prewarmed), and the trie broker (no matcher: the
   broker's own CPU trie). Both hold the corpus (``mixed_100k`` with
   the clients' v5 identifiers and retain-as-published;
   ``iot_1m_share``) before they serve, so the boot compile and prewarm
   run on it inside ``serve()``, before the listener accepts; the card
   broker must boot compiled and prewarmed with no warning. The
   compared subscribers are raw TCP clients (``subscriber_plan``:
   v3.1.1 and v5, outbound alias maxima, identifiers,
   retain-as-published, ``$share`` members, persistent sessions that
   leave before the traffic and resume after it, and a '#' probe)
   connected to both brokers with the same ids and subscriptions; they
   acknowledge QoS 1/2 as a client does. The card engine's background
   refresh over their subscriptions is awaited, then PUBLISH frames
   (60 % v5, 40 % v3.1.1, QoS 0/1/2 at 50/35/15 %, inbound topic
   aliases, 1 % retained; from a seed) go out as raw bytes, each
   publisher's frames as one burst through its own connection, ended
   by a fence publish that every subscriber awaits before the next
   burst: first through the trie broker, then through the card broker,
   measured. With the bypass off, then (``mixed_100k`` only) on, fresh
   topics each: the
   match latency, loop lag, full collections, batch sizes, bypass
   share, deliveries/s at the subscribers over the bursts' wall, hedges
   by reason, breaker trips, ``matcher_degrades``, decode routes, frame
   heads by encoder and K1 launches are printed. Every subscriber's
   PUBLISH frames from the card broker must equal its frames from the
   trie broker, in order, packet ids included; an answer from a
   supervisor hedge, a breaker trip or a pipeline degrade fails the
   run, and with the bypass off ``sig_match_fixed`` must launch once
   per batch. On ``mixed_100k`` the faulted rungs follow, one publish
   at a time on the card broker (error hedges tripping the breaker, the
   open breaker, a probe closing it, a hang past the deadline, the
   Python frame heads), their streams again equal to the trie broker's;
   then the persistent sessions resume on both brokers, equal again;
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
   phase 4, on its engines, ``iot_1m_share`` and ``mixed_100k``):
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
15. the broker as production starts it (run after phase 13, before
   phase 12): phase 12's ``mixed_100k`` corpus as one SQLite store of
   persistent v5 sessions (QoS ``k % 2 + 1``) with the compared
   subscribers' sessions, written by the port's ``SQLiteStore``, copied
   twice; two child processes ``python -m maxmq_tpu_torch start -c
   <conf> --no-banner`` on free ports, SQLite storage under
   ``storage_sync = "always"``, $SYS off, JSON logs, ``matcher_max_batch``
   4,096 (the default 256 is under the batcher's bypass cap of 512, so
   the host bypass could take every batch), the default ``Config``
   otherwise: the card broker (``matcher = "sig"``, no
   ``--device``: the card) and the trie broker (``--device cpu``), each
   restoring its copy. Their boots (restore, compile + prewarm, the
   rest), no warning, the card broker's matcher on a CUDA device; the
   compared subscribers resume their stored sessions on both; phase
   12's PUBLISH frames (two publisher connections, v5 and v3.1.1) in
   fenced bursts, trie broker first: every subscriber's frames equal;
   both ``/metrics`` pages with the same series apart from the matcher's,
   the card broker's batches, bypass share, K1 launches and storage
   series, no hedge, trip or degrade, and at least half of its topics
   answered by the card; SIGTERM, exit 0, and the two stores
   equal record for record (clients, subscriptions, retained, every
   inflight record: each QoS 1/2 match over the whole corpus; the
   wall-clock fields ``WALL_CLOCK_FIELDS`` left out). Then the crash
   rung: the card broker restarted with ``crash.at#post_fsync_pre_ack``
   armed, PUBACK-paced QoS 1 publishes until the SIGKILL, a restart,
   every PUBACKed publish in the inflight records of every corpus
   session the CPU trie names for its topic, and a corpus session and a
   compared subscriber resumed, each given its queued messages in the
   store's order;
16. the cluster federation (run right after phase 15) at the default
   cluster configuration, federated sessions on: ``mixed_100k``'s
   persistent v5 sessions split by index mod 3 into three SQLite stores,
   each with a third of the compared subscribers (phase 12's plan round
   robin over the nodes, a '#' probe on each) and each session's row in
   its node's session ledger journal, copied for two federations of
   three ``start`` children on a line A - B - C (symmetric
   ``cluster_peers``, phase 15's other settings): the card federation
   (``sig``, no ``--device``) and the trie federation (``--device
   cpu``), booted in parallel; each node's routes and session ledger
   awaited on its ``/metrics`` (the routes its peers advertise, computed
   from the stores, every link up, every session of the line in the
   ledger, the peers' acks of its resync); the subscribers resume;
   phase 12's PUBLISH frames from publishers on A and C (so C's reach A
   over two hops through B) in fenced bursts of 512, trie federation
   first, every subscriber's frames equal. Then the live takeover: 16 of
   B's compared subscribers leave, 128 publishes park for them at B, they
   reconnect at C with their session present and their parked window
   resent (the frames equal), the routes follow, 128 more publishes; and
   the restart rung: once A's and C's replicas of 16 of B's corpus
   sessions match B's window in the stores, B stops, those sessions
   reconnect at A from the dead owner, B restarts on its store (the stale
   epoch flushed, the routes and ledgers converged again, the sessions
   taken over evicted from B) and 512 publishes in fenced bursts of 8,
   equal again. Before each takeover rung's traffic the card engines
   refresh over the moved subscriptions with no traffic. The tracer
   samples every 32nd inbound publish in both federations, so frames and
   stores are compared without the ``mq-trace`` property it stamps. Each
   node's forward and takeover counters equal its twin's, 32 takeovers in
   all, none degraded, no digest mismatch, restore error or sync fault;
   on every card node no hedge, trip or degrade and ``sig_match_fixed``
   launched during the first traffic and after B's restart (B, which
   relays and serves forwarded publishes, included); every card node's
   ``/cluster/metrics`` holds every node's series; after SIGTERM every
   node's store equals its twin's, the session ledger's and the
   replicas' rows included. Printed beside them: each node's boot split
   (restore, compile + prewarm, replica restore, the rest), the ledgers'
   convergence after the boots and after B's restart, sync ops, flushes
   and acks, the ``takeover`` stage's p50 and max, each card node's
   launches that served publishes (shadow probes left out), the share of
   its topics the card answered (the host bypass serves the rest: a
   forward reaches a node's batcher one or two at a time), and each
   node's match and cross-node latencies. Then the same line in this
   process with the batchers' host bypass off, card against tries, so
   K1 answers every forwarded publish the frames hold, and 8 of B's
   subscribers taken over live at C: frames (the taken-over sessions'
   at C included), forward counters and retained sets equal, every card
   node at least half its topics on the device and K1 launched once a
   batch or more, before the takeover and after it;
17. the worker pool (run after phase 16, before phase 12): phase 15's
   store, each session with its ledger row as the pool's journal owner w0
   writes it (F28), copied for two pools started as ``python -m
   maxmq_tpu_torch start`` with ``workers = 2`` (phase 15's settings,
   each pool its own ``worker_link_dir`` and ``pool_metrics_address``,
   the tracer sampling every 32nd inbound publish, every other pool
   setting the default), booted at once: the card pool (``matcher =
   "sig"``, no ``--device``: the parent's matcher sidecar on the card,
   the workers its ``matcher = "service"`` clients) and the trie pool
   (``--device cpu``). w0 restores the store; the phase awaits w1's
   ledger (w0's resync acked), resumes the compared subscribers through
   the pool's one port, each on worker ``k % 2`` in both pools (a
   connection that SO_REUSEPORT hands the other worker is closed before
   its CONNECT: ``$share`` picks depend on the members' workers, F29),
   awaits the routes and the sidecar's tables (it refreshes as the
   reseed arrives, F27), places the v5 publisher on w0 and the v3.1.1 one
   on w1, and sends phase 15's 1,024 publishes in fenced bursts of 768,
   trie pool first. Every subscriber's frames equal (without the
   ``mq-trace`` property, F20); the sidecar's answers to the traffic's
   topics (one OP_MATCH request on its socket, after the traffic) equal
   to the CPU trie's; both workers nodes on ``/cluster/metrics`` and only
   w0 with the journal's series; ``nvidia-smi`` lists no worker and not
   the trie pool's parent among the card's holders; no hedge, trip or
   degrade at w0 (its ``/metrics``) or at any worker over its life (its
   ``pool worker stopping`` line), no K1 launch in a worker; on the card
   K1 launches that served publishes (the sidecar's, less its shadow
   probes, from the pool endpoint); SIGTERM stops each pool, every
   worker with rc 0 and no socket left; the two w0 stores equal record
   for record, the ledger and replica buckets included (w1's boot epoch
   left out: it keeps no store). Printed: the boot split, the ledger's,
   the routes' and the sidecar's convergence, the sidecar's launches
   (served, shadow), batches and bypassed topics and the card's share,
   w0's match p50 / p99 and commits, deliveries/s, stop seconds;
18. each kernel's SASS opcode counts (``cuobjdump -sass``, where the
   toolkit has it), the kernels line (JSON), the card line, and the
   result line.

Every phase also prints the routes its host prep took (the topics
prepared by the C++ pass or numpy, tokenized by the C++ tokenizer or the
Python loop); where the native runtime is loaded, a topic on the numpy
or Python route fails the phase.

Phases 8-11 run no hand-written kernel (the reference computes them in
XLA, outside Pallas); each reads both kernels' launch counts, set to 0
before it. Phase 12 sets them to 0 before each run of its card broker
and reads them after; its launches ride the kernels line under
``broker_launches``, phase 13's tracing runs' under
``tracing_launches``, phase 14's (counts set to 0 before it) under
``surfaces_launches`` and phase 15's card broker's (its child process's
count over the traffic, from its ``/metrics``) under ``started_launches``,
and phase 16's card nodes' (each child's count over its four traffic
runs) under ``federation_launches``, with the takeover rungs' served
launches and the in-process takeover's under ``takeover_launches``, and
phase 17's card pool's sidecar's (its parent's count over the traffic,
from the pool endpoint) under ``pool_launches`` (served, and shadow
probes). The dense and NFA decodes are Python, as the reference's.
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
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

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
# NFA headline's decode sample, whether the NFA check and headline run
# at ``iot_1m_share``, the cluster phase's batch and batch
# count (bench config 5: batches of 8,192 on a 2 x 4 mesh), the signature
# headline's batch decoded three ways (also the dense headline's decoded
# share of its timed batch) and its Python decode sample, the
# frames of the scanner check, the tracing phase's burst (and a
# supervisor override for the CPU rehearsal), the broker phase's compared
# subscribers, its publishes a run per corpus, the corpora that also run
# with the bypass on, and its faulted publishes,
# the fleet rung's publishes per corpus (none here: at ``iot_1m_share`` its
# two runs took 12.3 min on an H100 host, so ``scripts/torch_broker_fleet.py``
# runs it alone), the content evaluator's shapes
# (predicates x payloads: the reference benchmark's 64 x 4,096, and its
# configured bounds, ``filter_max_subscriptions`` x ``filter_batch_max``)
# and timed flushes, the tracing phase's bursts (of the pipeline's
# burst size) and service topics, and phase 15's corpus, compared
# subscribers, publishes, burst, the brokers' ``matcher_max_batch`` (above
# the batcher's bypass cap of 512, so that a burst's batches may go to the
# card), the least share of the card broker's topics its card must answer
# (checked on the card), crash publishes, the group commits past the
# boot's at which the crash point kills, and its waits for a boot and for
# a stop; phase 16's corpus, compared subscribers, publishes before the
# takeovers, around the live takeover and after B's restart, sessions
# taken over in each takeover rung, burst (below the '#' probes' 1,024-item
# queue) and the burst after B's restart (64 fenced bursts: each card
# node forms 64 batches at least, so its shadow probe launches K1), the
# nodes' ``matcher_max_batch`` (phase 15's), and its waits for
# a boot, a stop, the routes' and ledgers' convergence and the telemetry;
# phase 17's corpus, compared subscribers, publishes and burst (phase
# 15's), the pools' ``matcher_max_batch`` and its waits for a boot, a stop
# and a convergence.
# The service requests, the headline batches, the decode batch, the
# cluster batches, the broker phase's publishes, phase 15's publishes and
# phase 16's (its first run's and its in-process line's) are the depth
# that was cut to keep the whole run under 900 s (the host side of
# the service phases, and full collections of the heap there, grow with
# the topics sent; the signature and dense headlines' host decodes ran
# ~10,000 and ~6,000 topics/s on an H100 host).
SIZES = {"subs": {"mixed_100k": 100_000, "hash_plus_100k": 100_000,
                  "iot_1m_share": 1_000_000, "cluster_100k": 100_000},
         "check_batch": 4_096 + 100,
         "service_rounds": (4_096,),
         "service_warm": 1_024,
         "headline_batch": 262_144,
         "headline_batches": 1,
         "headline_warm": 0,
         "edge_batch": 70_001,
         "dense_corpus": {"n_filters": 2_000, "n_subs": 100_000,
                          "width": 440},
         "nfa_sample": 4_096,
         "nfa_1m": True,
         "cluster_batch": 8_192,
         "cluster_batches": 1,
         "decode_batch": 8_192,
         "decode_sample": 4_096,
         "frames": 4_000,
         "pipeline": {"burst": 1_024},
         "broker": {"corpora": ("mixed_100k", "iot_1m_share"),
                    "clients": 64, "mixed_100k": 512,
                    "iot_1m_share": 512,
                    "faults": 279, "bypass_on": ("mixed_100k",),
                    "fleet": {}},
         "content": {"shapes": ((64, 4_096), (10_000, 256)), "reps": 3},
         "tracing": {"bursts": 4, "service_topics": 4_096},
         "started": {"corpus": "mixed_100k", "clients": 64,
                     "publishes": 1_024, "burst": 768, "max_batch": 4_096,
                     "device_share": 0.5,
                     "crash_publishes": 512, "crash_after": 64,
                     "boot_s": 600.0, "stop_s": 30.0},
         "federation": {"corpus": "mixed_100k", "clients": 64,
                        "publishes": 512, "takeover_publishes": 256,
                        "rung_publishes": 512, "rung_burst": 8,
                        "takeovers": 16,
                        "burst": 512, "max_batch": 4_096, "boot_s": 600.0,
                        "stop_s": 30.0, "converge_s": 120.0,
                        "telemetry_s": 15.0,
                        "in_process": {"subs": 100_000, "clients": 64,
                                       "publishes": 128, "burst": 512,
                                       "takeovers": 8},
                        "device_share": 0.5},
         "pool": {"corpus": "mixed_100k", "clients": 64, "publishes": 1_024,
                  "burst": 768, "max_batch": 4_096, "boot_s": 600.0,
                  "stop_s": 30.0, "converge_s": 120.0}}
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


# -- phase 12: the broker engine -----------------------------------------

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
# the card broker's tracer samples every TRACE_STRIDE-th publish in phase
# 12 (a production knob, ``trace_sample_n``): the sampled spans split the
# match from the in-order wait and the fan-out at a small cost
TRACE_STRIDE = 32
# the subscribing clients (the compared TCP subscribers, and the preloaded
# ``mixed_100k`` corpus's ``cl-<i>``): the v5 share, the share of v5
# clients with an outbound topic-alias maximum (and its value), the share
# of v5 subscriptions with an identifier or retain-as-published, and the
# clients offline. Coverage choices, so that every per-subscriber wire
# path carries traffic, not a fleet's mix: the deliveries a second that
# phase 12 prints read this mix only.
CLIENT_MIX = {"v5": 0.6, "alias": 0.3, "alias_max": 16, "identifier": 0.5,
              "rap": 0.2, "offline": 0.05}


def port_kit():
    """The protocol and trie classes of the port that phases 12 and 13
    build and read frames with."""
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


def publish_frames(kit, topics: list[str], seed: int,
                   publishers: int = PUB_MIX["publishers"]):
    """One encoded PUBLISH frame per topic, in order, with the publisher
    connection that sends it (``pub5-<k>`` speaks v5, ``pub4-<k>``
    v3.1.1, ``k`` below ``publishers`` a version): QoS, retain, payload
    (16-256 random bytes), v5 properties (user properties, correlation
    data, content type, message expiry, payload format, response topic)
    and inbound topic aliases from a numpy seed. An aliased publish
    carries topic and alias the first time its publisher sends that
    topic, the alias alone (an empty topic) after."""
    rng = np.random.default_rng(seed)
    mix = PUB_MIX
    n = len(topics)
    v5 = rng.random(n) < mix["v5"]
    qos = rng.choice(3, n, p=mix["qos"])
    alias = v5 & (rng.random(n) < mix["alias"])
    retain = rng.random(n) < mix["retain"]
    pub = rng.integers(0, publishers, n)
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


# -- phase 12 over TCP: raw MQTT connections to the brokers -------------

# every compared subscriber also subscribes to this topic; a publisher
# ends each burst with a QoS-0 publish to it whose payload ends with
# ``FENCE_MARK`` and the burst's number: per-client order then says that
# a client holding the fence holds every delivery of the burst
FENCE_TOPIC = "smoke/fence"
FENCE_MARK = b"~fence~"


def split_frames(buf: bytearray) -> list[bytes]:
    """The complete MQTT frames at the head of ``buf`` (fixed header,
    remaining length, body), each as its bytes; they leave ``buf``."""
    out, pos, n = [], 0, len(buf)
    while pos < n:
        rem, shift, i = 0, 0, pos + 1
        while i < n:
            b = buf[i]
            rem |= (b & 0x7F) << shift
            shift += 7
            i += 1
            if not b & 0x80:
                break
        else:
            break                       # the length is not all here yet
        if i + rem > n:
            break
        out.append(bytes(buf[pos:i + rem]))
        pos = i + rem
    del buf[:pos]
    return out


def publish_pid(frame: bytes) -> int:
    """The packet id of a QoS 1/2 PUBLISH frame (after its topic)."""
    i = 1
    while frame[i] & 0x80:
        i += 1
    j = i + 3 + (frame[i + 1] << 8 | frame[i + 2])
    return frame[j] << 8 | frame[j + 1]


class WireClient:
    """One raw MQTT connection to one broker, a subscriber or a publisher
    (phase 12's, and the port's broker tests'): CONNECT, SUBSCRIBE,
    UNSUBSCRIBE and PUBLISH frames built by the port's codec (``kit``),
    or PUBLISH frames taken as bytes (``send``). Every frame received is
    kept in order in one of three lanes: ``frames`` (PUBLISH), ``rel``
    (the broker's PUBREL of a QoS 2 delivery: it comes at the speed of
    the client's own PUBREC, so it interleaves with the other lanes by
    timing) and ``ctl`` (the replies to the client's own packets).
    Deliveries are acknowledged as a client does (PUBACK, or PUBREC and
    then PUBCOMP on the broker's PUBREL) unless ``mute`` is set;
    ``awaiting_rel`` holds the QoS 2 deliveries PUBREC'd and not yet
    released. ``publish`` sends one publish and settles it; the QoS 1/2
    publishes of ``send`` the client settles as their acknowledgements
    come (PUBREL on PUBREC; ``outstanding`` holds the unsettled packet
    ids). A delivery whose payload ends with the fence mark advances
    ``fence`` to its number; ``closed`` is set when the connection ends."""

    def __init__(self, kit, cid: str, version: int, alias_max: int = 0,
                 clean: bool = True, will=None, expiry: int | None = None,
                 timeout: float = 120.0) -> None:
        self.kit, self.cid, self.version = kit, cid, version
        self.alias_max, self.clean = alias_max, clean
        self.will, self.expiry, self.timeout = will, expiry, timeout
        self.frames: list[bytes] = []
        self.rel: list[bytes] = []
        self.ctl: list[bytes] = []
        self.awaiting_rel: set = set()
        self.outstanding: set = set()
        self.mute = False
        self.fence = -1
        self.connack = b""
        self.closed = asyncio.Event()
        self._pid = 0
        self._aliases: dict = {}
        self._waiters: dict = {}        # (packet type, packet id) -> future
        self._changed = asyncio.Event()
        self.reader = self.writer = self._task = None

    def packet(self, ptype, **kw):
        kit = self.kit
        return kit.Packet(fixed=kit.FixedHeader(type=ptype),
                          protocol_version=self.version, **kw)

    def _next_pid(self) -> int:
        self._pid = self._pid % 65535 + 1
        return self._pid

    async def _request(self, key, frame: bytes) -> bytes:
        fut = asyncio.get_running_loop().create_future()
        self._waiters[key] = fut
        self.writer.write(frame)
        return await asyncio.wait_for(fut, self.timeout)

    async def open(self, port: int, accept=None) -> bytes:
        """Connect and CONNECT (a v5 session expiry and outbound alias
        maximum where given); returns the CONNACK frame. ``await
        accept(writer)`` where given judges each TCP connection before the
        CONNECT: one it refuses is closed and another opened (phase 17
        places a client on a chosen worker of a pool so)."""
        for _ in range(256):
            self.reader, self.writer = await asyncio.open_connection(
                "127.0.0.1", port)
            if accept is None or await accept(self.writer):
                break
            self.writer.close()
            await self.writer.wait_closed()
        else:
            raise AssertionError(f"{self.cid}: 256 connections refused")
        self.closed.clear()
        self._task = asyncio.get_running_loop().create_task(self._read())
        pk = self.packet(self.kit.PT.CONNECT, clean_start=self.clean,
                         keepalive=0, client_id=self.cid, will=self.will)
        if self.version >= 5:
            if self.expiry is not None:
                pk.properties.session_expiry = self.expiry
            if self.alias_max:
                pk.properties.topic_alias_max = self.alias_max
        self.connack = await self._request((2, 0), pk.encode())
        return self.connack

    async def subscribe(self, sub) -> bytes:
        """One SUBSCRIBE of ``sub`` (its v5 identifier as the packet's
        subscription identifier); returns the SUBACK frame."""
        pid = self._next_pid()
        pk = self.packet(self.kit.PT.SUBSCRIBE, packet_id=pid,
                         filters=[sub])
        if self.version >= 5 and sub.identifier:
            pk.properties.subscription_ids = [sub.identifier]
        return await self._request((9, pid), pk.encode())

    async def unsubscribe(self, filter_: str) -> bytes:
        pid = self._next_pid()
        pk = self.packet(self.kit.PT.UNSUBSCRIBE, packet_id=pid,
                         filters=[self.kit.Subscription(filter=filter_)])
        return await self._request((11, pid), pk.encode())

    async def ping(self) -> None:
        await self._request((13, 0), b"\xc0\x00")

    async def publish(self, topic: str, payload: bytes, qos: int = 0,
                      retain: bool = False, alias: bool = False,
                      dup_resend: bool = False) -> None:
        """One publish (the v5 ``alias`` form: topic and alias the first
        time, the alias alone after), settled; a QoS 0 one is followed by
        a ping, so the broker has read it on return. ``dup_resend`` sends
        it again with DUP set before settling (QoS 2: between PUBREC and
        PUBREL)."""
        pk = self.packet(self.kit.PT.PUBLISH, topic=topic, payload=payload)
        pk.fixed.qos, pk.fixed.retain = qos, retain
        if alias and self.version >= 5:
            a = self._aliases.get(topic)
            if a is None:
                a = self._aliases[topic] = len(self._aliases) + 1
            else:
                pk.topic = ""
            pk.properties.topic_alias = a
        if qos == 0:
            self.writer.write(pk.encode())
            await self.ping()
            return
        pk.packet_id = pid = self._next_pid()
        ack = 4 if qos == 1 else 5
        await self._request((ack, pid), pk.encode())
        if dup_resend:
            pk.fixed.dup = True
            await self._request((ack, pid), pk.encode())
        if qos == 2:
            await self._request((7, pid), bytes((0x62, 2, pid >> 8,
                                                 pid & 0xFF)))

    def send(self, frames: list[bytes]) -> None:
        for f in frames:
            if f[0] & 0x06:
                self.outstanding.add(publish_pid(f))
        self.writer.write(b"".join(frames))

    def fence_frame(self, tag: int) -> bytes:
        return self.packet(self.kit.PT.PUBLISH, topic=FENCE_TOPIC,
                           payload=FENCE_MARK + str(tag).encode()).encode()

    async def until(self, pred) -> None:
        deadline = time.monotonic() + self.timeout
        while not pred():
            self._changed.clear()
            await asyncio.wait_for(self._changed.wait(),
                                   deadline - time.monotonic())

    async def _read(self) -> None:
        buf = bytearray()
        try:
            while True:
                chunk = await self.reader.read(1 << 16)
                if not chunk:
                    break
                buf += chunk
                for f in split_frames(buf):
                    self._frame(f)
                self._changed.set()
        finally:
            self.closed.set()
            self._changed.set()
            for fut in self._waiters.values():
                if not fut.done():
                    fut.set_exception(ConnectionError(f"{self.cid}: closed"))

    def _frame(self, f: bytes) -> None:
        t = f[0] >> 4
        if t == 3:                                  # PUBLISH
            self.frames.append(f)
            qos = (f[0] >> 1) & 3
            if qos and not self.mute:
                pid = publish_pid(f)
                self.writer.write(bytes((0x40 if qos == 1 else 0x50, 2,
                                         pid >> 8, pid & 0xFF)))
                if qos == 2:
                    self.awaiting_rel.add(pid)
            k = f.rfind(FENCE_MARK, -24)
            if k > 0:
                self.fence = int(f[k + len(FENCE_MARK):])
            return
        if t == 6:                                  # PUBREL -> PUBCOMP
            self.rel.append(f)
            self.awaiting_rel.discard(f[2] << 8 | f[3])
            if not self.mute:
                self.writer.write(bytes((0x70, 2, f[2], f[3])))
            return
        self.ctl.append(f)
        pid = f[2] << 8 | f[3] if t in (4, 5, 7, 9, 11) else 0
        if pid in self.outstanding and t in (4, 5, 7):   # of ``send``
            if t == 5:                              # PUBREC -> PUBREL
                self.writer.write(bytes((0x62, 2, f[2], f[3])))
            else:                                   # PUBACK, PUBCOMP
                self.outstanding.discard(pid)
            return
        fut = self._waiters.pop((t, pid), None)
        if fut is not None and not fut.done():
            fut.set_result(f)

    async def close(self, disconnect: bool = False) -> None:
        """End the connection (with a DISCONNECT first where
        ``disconnect``) and wait until its reader has seen the end."""
        if self.writer is None:
            return
        if disconnect:
            self.writer.write(b"\xe0\x00")
            with contextlib.suppress(ConnectionError, OSError):
                await self.writer.drain()
        self.writer.close()
        with contextlib.suppress(Exception):
            await self.writer.wait_closed()
        try:
            await asyncio.wait_for(asyncio.shield(self._task), self.timeout)
        except (asyncio.TimeoutError, ConnectionError, OSError):
            self._task.cancel()
            with contextlib.suppress(BaseException):
                await self._task
        self.writer = None


def broker_kit():
    """The port's broker engine and boot helpers, as phase 12 uses them
    (``tests/test_torch_supervisor.py`` builds the same kit from the JAX
    package and runs the same phase over its broker)."""
    from types import SimpleNamespace

    from maxmq_tpu_torch import bootstrap
    from maxmq_tpu_torch.broker import (Broker, BrokerOptions, Client,
                                        TCPListener)
    from maxmq_tpu_torch.hooks import AllowHook
    from maxmq_tpu_torch.utils.config import Config

    return SimpleNamespace(
        Broker=Broker, BrokerOptions=BrokerOptions, TCPListener=TCPListener,
        Client=Client, AllowHook=AllowHook, Config=Config,
        capabilities_from_config=bootstrap.capabilities_from_config,
        build_matcher=bootstrap.build_matcher)


def broker_config(bk, matcher: str):
    """The package's default config with ``matcher`` and $SYS off: the
    production matcher settings (window 200 us, batch 256, depth 3;
    deadline 250 ms, breaker 5 in 10 s, backoff 1 s to 30 s; intents
    on)."""
    conf = bk.Config()
    conf.matcher = matcher
    conf.mqtt_sys_topic_interval = 0
    return conf


class BrokerSide:
    """One broker of phase 12 in this process with its connections:
    ``subs`` (the compared subscribers, by client id), ``pubs`` (one
    connection per publisher of the traffic), ``fleet`` (corpus clients
    served in process, by client id: (session, SinkWriter)) and the
    fences sent."""

    def __init__(self, broker, port: int) -> None:
        self.broker, self.port = broker, port
        self.subs: dict = {}
        self.pubs: dict = {}
        self.fleet: dict = {}
        self.readers: list = []
        self.ack_s = 0.0
        self.tag = 0

    def fleet_marks(self) -> dict:
        return {cid: len(w.data) for cid, (_c, w) in self.fleet.items()}

    def fleet_streams(self, start: dict) -> dict:
        """Each fleet session's bytes written since ``start``'s marks."""
        return {cid: bytes(w.data[start.get(cid, 0):])
                for cid, (_c, w) in self.fleet.items()}

    @property
    def online(self) -> list:
        return [c for c in self.subs.values() if c.writer is not None]

    async def publisher(self, kit, owner: str):
        pub = self.pubs.get(owner)
        if pub is None:
            pub = self.pubs[owner] = WireClient(
                kit, owner, 5 if owner.startswith("pub5") else 4)
            await pub.open(self.port)
        return pub

    async def fence(self, pub, subs=None) -> None:
        """End a burst: the fence through ``pub``, then every subscriber
        of ``subs`` (this side's online ones by default) holding it and
        ``pub``'s publishes settled."""
        self.tag += 1
        tag = self.tag
        pub.send([pub.fence_frame(tag)])
        await asyncio.gather(*(c.until(lambda c=c: c.fence >= tag)
                               for c in (self.online if subs is None
                                         else subs)))
        await pub.until(lambda: not pub.outstanding)
        # the fence's fan-out came after every delivery of the burst:
        # the fleet's writers hold them all once their queues are empty
        while any(c.outbound.qsize() for c, _w in self.fleet.values()):
            await asyncio.sleep(0.001)
        if self.fleet:
            await self.settle_fleet()

    async def settle_fleet(self, timeout: float = 120.0) -> None:
        """The fleet's clients acknowledge what they hold (``SinkWriter.
        acks`` fed to each session's read loop, the broker's own receive
        path), PUBREL rounds included, until no fleet session has a
        message in flight; the seconds add to ``ack_s``."""
        t0 = time.perf_counter()
        while True:
            fed = False
            for c, w in self.fleet.values():
                acks = w.acks()
                if acks:
                    c.reader.feed_data(acks)
                    fed = True
            if not fed and not any(len(c.inflight)
                                   for c, _w in self.fleet.values()):
                break
            if time.perf_counter() - t0 > timeout:
                raise AssertionError("the fleet's deliveries stayed in "
                                     f"flight past {timeout} s")
            await asyncio.sleep(0.001)
        self.ack_s += time.perf_counter() - t0

    async def bursts(self, kit, traffic, between=None,
                     chunk: int | None = None, side_of=None,
                     subs=None) -> float:
        """Each publisher's frames of ``traffic`` as bursts through its
        connection (one burst, or ``chunk`` frames each), each ended by a
        fence that ``subs`` wait on (``fence``), publishers in order of
        first appearance; a publisher connects to ``side_of(owner)`` (this
        side by default); ``between()`` runs after each fence. Returns the
        seconds ``between`` took."""
        frames, owners = traffic
        by_owner: dict = {}
        for f, o in zip(frames, owners):
            by_owner.setdefault(o, []).append(f)
        spent = 0.0
        for owner, fs in by_owner.items():
            side = self if side_of is None else side_of(owner)
            pub = await side.publisher(kit, owner)
            step = chunk or len(fs)
            for i in range(0, len(fs), step):
                pub.send(fs[i:i + step])
                await self.fence(pub, subs)
                if between is not None:
                    t0 = time.perf_counter()
                    between()
                    spent += time.perf_counter() - t0
        return spent

    def streams(self, start: dict | None = None,
                untraced: bool = False) -> dict:
        """Each subscriber's PUBLISH frames (from ``start``'s counts);
        ``untraced``: each v5 frame ``without_trace``."""
        start = start or {}
        return {cid: ([without_trace(f) for f in c.frames[start.get(cid, 0):]]
                      if untraced and c.version == 5
                      else c.frames[start.get(cid, 0):])
                for cid, c in self.subs.items()}

    async def close(self) -> None:
        """The connections, the broker, then its matcher and engine (as
        the reference's start path stops them, bootstrap.py:384-389)."""
        for c in (*self.subs.values(), *self.pubs.values()):
            await c.close()
        for c, _w in self.fleet.values():
            c.reader.feed_eof()
        await asyncio.gather(*self.readers)
        await self.broker.close()
        matcher = self.broker.matcher
        if matcher is not None:
            await matcher.close()
            matcher.engine.close()


async def start_broker(bk, conf, preload, matcher: bool, device=None,
                       logger=None, before_serve=None) -> BrokerSide:
    """A broker of the package ``bk`` as a user boots one in process: the
    capabilities from ``conf``, ``AllowHook``, the (client id,
    Subscription) pairs of ``preload`` in its index before ``serve()``
    (as benchmarks/e2e_broker.py:268-276 does: the boot compile runs on
    them), ``build_matcher`` when ``matcher`` (``device`` passed where
    given), a TCP listener on a free local port; ``logger`` the broker's,
    ``before_serve(broker)`` called right before ``serve()``."""
    b = bk.Broker(bk.BrokerOptions(
        capabilities=bk.capabilities_from_config(conf), logger=logger))
    b.add_hook(bk.AllowHook())
    with collector_paused():
        for cid, sub in preload:
            b.topics.subscribe(cid, sub)
        if matcher:
            if device is None:
                bk.build_matcher(conf, b)
            else:
                bk.build_matcher(conf, b, device=device)
        lst = b.add_listener(bk.TCPListener("smoke", "127.0.0.1:0"))
        if before_serve is not None:
            before_serve(b)
        await b.serve()
    return BrokerSide(b, lst._server.sockets[0].getsockname()[1])


class SinkWriter:
    """The transport of a session served in process: every byte the
    broker writes to it, kept in order (``data``); ``acks`` answers what
    came since its last call as the session's client would."""

    __slots__ = ("data", "mark")

    def __init__(self) -> None:
        self.data = bytearray()
        self.mark = 0

    def acks(self) -> bytes:
        """The client's acknowledgements of the frames written since the
        last call: PUBACK for a QoS 1 delivery, PUBREC for a QoS 2 one,
        PUBCOMP for a PUBREL."""
        buf = self.data[self.mark:]
        n = len(buf)
        out = []
        for f in split_frames(buf):
            t = f[0] >> 4
            if t == 3 and f[0] & 0x06:
                pid = publish_pid(f)
                out.append(bytes((0x40 if f[0] & 0x06 == 2 else 0x50, 2,
                                  pid >> 8, pid & 0xFF)))
            elif t == 6:
                out.append(bytes((0x70, 2, f[2], f[3])))
        self.mark += n - len(buf)
        return b"".join(out)

    def write(self, b) -> None:
        self.data += b

    def writelines(self, bufs) -> None:
        for b in bufs:
            self.data += b

    async def drain(self) -> None:
        pass

    def close(self) -> None:
        pass

    async def wait_closed(self) -> None:
        pass

    def is_closing(self) -> bool:
        return False

    def get_extra_info(self, name, default=None):
        return default


def fleet_sessions(topics: list[str], answer, pairs) -> list:
    """The corpus clients that publishes to ``topics`` reach (each
    client in ``answer(topic)``'s plain subscriptions, and every member
    of each ``$share`` group it names), as [(cid, [Subscription])] from
    the corpus's (client id, Subscription) ``pairs``: served live, they
    take every delivery of those publishes, as a connected fleet would."""
    reached = set()
    for t in topics:
        got = answer(t)
        if hasattr(got, "to_set"):
            got = got.to_set()
        reached.update(got.subscriptions)
        for members in got.shared.values():
            reached.update(members)
    out: dict = {}
    for cid, sub in pairs:
        if cid in reached:
            out.setdefault(cid, []).append(sub)
    return list(out.items())


def connect_fleet(bk, kit, side: BrokerSide, sessions, versions=None):
    """The clients of ``sessions`` [(cid, [Subscription])] made live
    sessions of ``side``'s broker without a socket, each writing to a
    SinkWriter and reading what ``BrokerSide.settle_fleet`` feeds it: a
    CONNECT (v3.1.1, or ``versions[cid]`` = (version, outbound alias
    maximum)) parsed as the broker parses one, the subscriptions the
    broker already holds recorded on the session, the session registered
    as connected, its writer started and its read loop on the broker's
    receive path."""
    b = side.broker
    loop = asyncio.get_running_loop()
    for cid, subs in sessions:
        version, alias_max = (versions or {}).get(cid, (4, 0))
        sink = SinkWriter()
        c = bk.Client(b, asyncio.StreamReader(), sink)
        pk = kit.Packet(fixed=kit.FixedHeader(type=kit.PT.CONNECT),
                        protocol_version=version, clean_start=True,
                        keepalive=0, client_id=cid)
        if alias_max:
            pk.properties.topic_alias_max = alias_max
        c.parse_connect(pk)
        for sub in subs:
            c.subscriptions[sub.filter] = sub
        b.clients.add(c)
        c.connected_at = time.time()
        b.info.clients_connected += 1
        c.start()
        side.readers.append(loop.create_task(c.read_loop(
            b._receive_packet)))
        side.fleet[cid] = (c, sink)


def fleet_equal(what: str, got: dict, want: dict) -> int:
    """Each fleet session's bytes equal between the brokers; returns the
    bytes compared."""
    if got != want:
        bad = sorted(c for c in set(got) | set(want)
                     if got.get(c) != want.get(c))
        c = bad[0]
        streams_equal(f"{what}: fleet ({len(bad)} sessions differ)",
                      {c: split_frames(bytearray(got.get(c, b"")))},
                      {c: split_frames(bytearray(want.get(c, b"")))})
        raise AssertionError(f"{what}: the bytes of {len(bad)} fleet "
                             f"sessions differ, first {c}")
    return sum(len(v) for v in got.values())


def check_matches(what: str, answers, answer) -> int:
    """Every match result ``answers`` [(topic, future)] holds equal to the
    trie's ``answer(topic)``; returns how many were held."""
    bad = [t for t, f in answers
           if not f.done() or f.cancelled() or f.exception() is not None
           or not same_answer(f.result(), answer(t))]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} of {len(answers)} match "
                             f"answers differ from the trie's, first "
                             f"{bad[0]!r}")
    return len(answers)


def catch_up(engine, attempts: int = 4) -> None:
    """The engine's own background refresh (with its bucket re-warm and
    decode prewarm) run until its tables hold every subscription of its
    index: a refresh already under way when a client subscribed compiles
    an older version, so one join is not always enough. Fails after
    ``attempts`` refreshes that left the tables behind the index."""
    for _ in range(attempts):
        if engine.tables.version == engine.index.sub_version:
            return
        engine.refresh_soon()
        engine.close(timeout=600)
    if engine.tables.version != engine.index.sub_version:
        raise AssertionError(
            f"the engine's tables stayed at version {engine.tables.version} "
            f"after {attempts} refreshes; its index is at "
            f"{engine.index.sub_version}")


def subscriber_plan(kit, n: int, topics: list[str], answer, seed: int = 7):
    """The compared subscribers ``tcp-<k>`` of a corpus: ``ClientTable``'s
    mix (v3.1.1 and v5 connections, v5 outbound alias maxima, identifiers
    and retain-as-published, 5 % offline: persistent sessions that
    subscribe, leave, and resume after the traffic), each subscribing to
    three corpus filters that match publish topics (one from ``answer``
    of each of three topics drawn from ``topics``, at QoS k % 3), every
    third one also a member of one of four ``$share`` groups over a
    corpus filter, and ``tcp-probe``: a v3.1.1 client on '#' (every
    publish reaches it; the faulted rungs pace on it). Returns
    [(cid, version, alias_max, offline, [Subscription, ...])]."""
    rng = np.random.default_rng(seed)
    ct = ClientTable(n)

    def corpus_filter() -> str:
        t = topics[int(rng.integers(len(topics)))]
        got = answer(t)
        if hasattr(got, "to_set"):
            got = got.to_set()
        filters = sorted({s.filter for s in got.subscriptions.values()})
        return filters[int(rng.integers(len(filters)))] if filters else t

    shares = [corpus_filter() for _ in range(4)]
    plan = []
    for k in range(n):
        v5 = bool(ct.v5[k])
        opts = dict(qos=k % 3, identifier=int(ct.identifier[k]),
                    retain_as_published=bool(ct.rap[k]))
        subs = [kit.Subscription(filter=corpus_filter(), **opts)
                for _ in range(3)]
        if k % 3 == 0:
            g = (k // 3) % 4
            subs.append(kit.Subscription(
                filter=f"$share/sg{g}/{shares[g]}", **opts))
        plan.append((f"tcp-{k}", 5 if v5 else 4,
                     int(ct.alias_max[k]), bool(ct.offline[k]), subs))
    plan.append(("tcp-probe", 4, 0, False, [kit.Subscription(filter="#")]))
    return plan


async def connect_subscribers(kit, side: BrokerSide, plan,
                              persistent=()) -> None:
    """The plan's clients connected and subscribed (plus the fence topic);
    the offline ones leave with their sessions kept. The clients of
    ``persistent`` (client ids) stay online on a kept session too (clean
    start off, a v5 one with a session expiry of an hour)."""
    for cid, version, alias_max, offline, subs in plan:
        keep = offline or cid in persistent
        c = side.subs[cid] = WireClient(
            kit, cid, version, alias_max, clean=not keep,
            expiry=3600 if keep else None)
        await c.open(side.port)
        for sub in (*subs, kit.Subscription(filter=FENCE_TOPIC)):
            await c.subscribe(sub)
        if offline:
            await c.close(disconnect=True)


async def resume_offline(side: BrokerSide, plan) -> dict:
    """The offline clients back on their sessions: each reconnects (the
    broker resends its queued QoS 1/2 deliveries) and pings; returns each
    one's CONNACK and resent frames."""
    out = {}
    for cid, _v, _a, offline, _s in plan:
        if offline:
            c = side.subs[cid]
            n0 = len(c.frames)
            connack = await c.open(side.port)
            await c.ping()
            out[cid] = [connack, *c.frames[n0:]]
    return out


def streams_equal(what: str, got: dict, want: dict) -> int:
    """Each subscriber's frames, in order, equal between the brokers;
    returns the frames compared."""
    if got != want:
        bad = sorted(c for c in set(got) | set(want)
                     if got.get(c) != want.get(c))
        c = bad[0]
        g, w = got.get(c, []), want.get(c, [])
        i = next((i for i, (x, y) in enumerate(zip(g, w)) if x != y),
                 min(len(g), len(w)))
        raise AssertionError(
            f"{what}: the streams of {len(bad)} subscribers differ, first "
            f"{c} at frame {i} of {len(g)} / {len(w)}: "
            f"{g[i].hex() if i < len(g) else None} vs "
            f"{w[i].hex() if i < len(w) else None}")
    return sum(len(v) for v in got.values())


# the v5 property identifiers by the size of their value (MQTT 5.0 2.2.2.2)
_PROP_FIXED = {**dict.fromkeys((0x01, 0x17, 0x19, 0x24, 0x25, 0x28, 0x29,
                                0x2A), 1),
               **dict.fromkeys((0x13, 0x21, 0x22, 0x23), 2),
               **dict.fromkeys((0x02, 0x11, 0x18, 0x27), 4)}
_PROP_VARINT = 0x0B
_PROP_USER = 0x26
TRACE_PROPERTY = b"mq-trace"


def without_trace(frame: bytes) -> bytes:
    """A v5 PUBLISH frame without its ``mq-trace`` user properties (the
    cross-node trace key a node stamps on the deliveries of an adopted
    trace), the lengths re-encoded; every other byte as it came."""
    from maxmq_tpu_torch.protocol.codec import read_varint, write_varint

    _rem, i = read_varint(frame, 1)
    head = i
    i += 2 + int.from_bytes(frame[i:i + 2], "big")         # topic
    if (frame[0] >> 1) & 3:
        i += 2                                              # packet id
    plen, j = read_varint(frame, i)
    end = j + plen
    kept, k = bytearray(), j
    while k < end:
        pid, start = frame[k], k
        k += 1
        if pid in _PROP_FIXED:
            k += _PROP_FIXED[pid]
        elif pid == _PROP_VARINT:
            _v, k = read_varint(frame, k)
        elif pid == _PROP_USER:
            n = int.from_bytes(frame[k:k + 2], "big")
            key = frame[k + 2:k + 2 + n]
            k += 2 + n
            k += 2 + int.from_bytes(frame[k:k + 2], "big")
            if key == TRACE_PROPERTY:
                continue
        else:                       # a string or binary value
            k += 2 + int.from_bytes(frame[k:k + 2], "big")
        kept += frame[start:k]
    if len(kept) == plen:
        return frame
    body = bytearray(frame[head:i])
    write_varint(body, len(kept))
    body += kept + frame[end:]
    out = bytearray(frame[:1])
    write_varint(out, len(body))
    return bytes(out + body)


def drop_trace(rec: dict) -> dict:
    """A stored record with the ``mq-trace`` pairs left out of its
    properties (``properties_json``), as ``without_trace`` for frames."""
    props = rec.get("properties_json")
    if props:
        p = json.loads(props)
        user = [u for u in p.get("user_properties", ())
                if u[0] != TRACE_PROPERTY.decode()]
        p.pop("user_properties", None)
        if user:
            p["user_properties"] = user
        rec["properties_json"] = p
    return rec


# -- phase 15: the broker as production starts it ------------------------

# the root of the checkout: the started brokers run from it
ROOT = os.path.dirname(os.path.abspath(__file__))
# the corpus sessions' v5 session expiry in phase 15's store (s)
STARTED_EXPIRY = 3600
# the metric families that only a broker with a matcher registers (the
# JAX package's ``_register_matcher_metrics``, metrics.py:993-1058, and
# the start path's kernel launches): the trie broker lacks them
MATCHER_ONLY = ("maxmq_broker_publish_pipeline_depth",
                "maxmq_broker_publish_trie_degraded_total")
# the wall-clock fields of the stored records, left out when two stores
# are compared: a client's disconnect time, a message's receipt time
WALL_CLOCK_FIELDS = {"clients": ("disconnected_at",),
                     "retained": ("created",), "inflight": ("created",),
                     "cluster_inflight": ("created",)}
STORE_BUCKETS = ("clients", "subscriptions", "retained", "inflight")
# the federated sessions' journal buckets (the ledger's rows, the replicas'
# inflight and PUBREC-pending rows), compared as well in phase 16
SESSION_BUCKETS = ("cluster_sessions", "cluster_inflight")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def listen_port() -> int:
    """A free TCP port below the kernel's ephemeral range, for a broker
    that its peers dial before it listens: a connect to a closed port in
    that range can take the very port as its source and connect to
    itself (a TCP self-connect), and then hold the port."""
    low = 32768
    with contextlib.suppress(OSError, ValueError):
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    rng = random.Random()
    while True:
        port = rng.randrange(10_000, low)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port


def started_subscription(kit, k: int, sub):
    """Corpus subscription ``k`` as phase 15 stores it: the corpus's
    filter and v5 options at QoS ``k % 2 + 1`` (every match of a QoS 1/2
    publish then leaves an inflight record)."""
    return kit.Subscription(filter=sub.filter, qos=k % 2 + 1,
                            identifier=sub.identifier,
                            retain_as_published=sub.retain_as_published)


def started_sessions(kit, corpus, plan) -> list:
    """Phase 15's stored sessions [(client id, protocol version,
    [Subscription, ...])]: every corpus client ``(client id,
    Subscription)`` of ``corpus`` a v5 session with its one subscription,
    and every compared subscriber of ``plan`` with its subscriptions and
    the fence topic. Restored at boot, they need no SUBSCRIBE after it:
    the engine's boot compile covers them all, and no background
    recompile runs under the traffic."""
    return ([(cid, 5, [sub]) for cid, sub in corpus]
            + [(cid, version, [*subs, kit.Subscription(filter=FENCE_TOPIC)])
               for cid, version, _a, _o, subs in plan])


def write_corpus_store(path: str, sessions, owner: str = "") -> None:
    """``sessions`` [(client id, protocol version, [Subscription, ...])]
    as one SQLite file, written with the port's ``SQLiteStore`` and
    record classes as its ``StorageHook`` writes them (one transaction):
    every client a persistent session of the ``tcp`` listener,
    disconnected (a v5 one with a session expiry of ``STARTED_EXPIRY``),
    each subscription with its options. Where ``owner`` (a cluster node
    id) is given, each session also has its row in the cluster session
    ledger's journal (``cluster_sessions``) as that node's federation
    writes it for a session it owns (``SessionEntry``, first epoch,
    disconnected, no inflight): the store of a node whose sessions its
    peers replicate, with its boot epoch (``FED_BOOT_EPOCH``) persisted
    as that node's store holds it, so the epochs its boots take, and the
    session tokens its ledger rows carry, are the same in every copy of
    the store."""
    from maxmq_tpu_torch.cluster.sessions import SESS_BUCKET, SessionEntry
    from maxmq_tpu_torch.hooks.storage import (ClientRecord, SQLiteStore,
                                               SubscriptionRecord)
    from maxmq_tpu_torch.matching.topics import parse_share

    ops = []
    for cid, version, subs in sessions:
        ops.append(("put", "clients", cid, ClientRecord(
            client_id=cid, listener="tcp", protocol_version=version,
            session_expiry=STARTED_EXPIRY if version >= 5 else 0,
            session_expiry_set=version >= 5).to_json()))
        if owner:
            rows = [[sub.filter, sub.qos, int(sub.no_local),
                     int(sub.retain_as_published), sub.retain_handling,
                     sub.identifier or 0] for sub in subs]
            shares = [[parse_share(sub.filter)[0], sub.filter]
                      for sub in subs if parse_share(sub.filter)[0]]
            ops.append(("put", SESS_BUCKET, cid, SessionEntry(
                cid, owner, 1, 0, STARTED_EXPIRY if version >= 5 else 0,
                version >= 5, version, False, rows, shares).meta_json()))
        for sub in subs:
            ops.append(("put", "subscriptions", f"{cid}|{sub.filter}",
                        SubscriptionRecord(
                            client_id=cid, filter=sub.filter, qos=sub.qos,
                            no_local=sub.no_local,
                            retain_as_published=sub.retain_as_published,
                            retain_handling=sub.retain_handling,
                            identifier=sub.identifier).to_json()))
    if owner:
        ops.append(("put", "meta", "boot_epoch", str(FED_BOOT_EPOCH)))
    store = SQLiteStore(path, synchronous="OFF")
    store.apply_batch(ops)
    store.close()
    for suffix in ("-wal", "-shm"):
        if os.path.exists(path + suffix):
            raise AssertionError(f"{path}{suffix} left after close")


async def resume_subscribers(kit, side: BrokerSide, plan,
                             place=None) -> None:
    """The plan's online clients back on their stored sessions (clean
    start off; the broker must report the session present); the offline
    ones stay away. ``place(cid)`` where given is the ``accept`` of each
    client's connection (``WireClient.open``)."""
    for cid, version, alias_max, offline, _subs in plan:
        if offline:
            continue
        c = side.subs[cid] = WireClient(
            kit, cid, version, alias_max, clean=False,
            expiry=STARTED_EXPIRY if version >= 5 else None)
        connack = await c.open(side.port,
                               None if place is None else place(cid))
        if not connack[2] & 1:
            raise AssertionError(f"{cid}: its stored session is not "
                                 "present")


def read_store(path: str, bucket: str, raw: bool = False) -> dict:
    """A store file's records of one bucket, key -> parsed JSON (with
    ``raw``, the stored text) (the file may belong to a running broker:
    SQLite's WAL lets this read beside its writer)."""
    import sqlite3

    conn = sqlite3.connect(path, timeout=30)
    try:
        rows = conn.execute("SELECT key, value FROM kv WHERE bucket=?",
                            (bucket,)).fetchall()
    finally:
        conn.close()
    return dict(rows) if raw else {k: json.loads(v) for k, v in rows}


# the client id prefix of a cluster bridge link's session (the port's
# ``cluster.bridge.BRIDGE_ID_PREFIX``)
LINK_CLIENT_PREFIX = "$maxmq-cluster/"


def link_record(key: str) -> bool:
    """Whether a store key (``<client id>`` or ``<client id>|...``)
    belongs to a bridge link's own session: a node that stops while a
    peer's link is still up keeps that link's clean session record, since
    the link's teardown runs after its journal stopped, and one whose peer
    closed the link first does not (F30), so which of two twins' stores
    holds it depends on the order their processes stopped in."""
    return key.startswith(LINK_CLIENT_PREFIX)


def stores_equal(a: str, b: str, normal=None,
                 buckets=STORE_BUCKETS, links: bool = True) -> dict:
    """Two store files equal bucket by bucket (``buckets``), record for
    record, each record's wall-clock fields (``WALL_CLOCK_FIELDS``) left
    out and each record passed through ``normal`` where given (records
    that are no JSON object, as a PUBREC-pending row's ``1``, as they
    are); returns each bucket's records compared. With ``links`` False
    the bridge links' own session records (``link_record``) are left out
    of the comparison and counted under ``links_left`` (each store's).
    Records whose stored text is the same in both are equal as they are
    (both parse and normalize alike): only the others are parsed."""
    out = {}
    left = [0, 0]

    def parsed(text):
        rec = json.loads(text)
        if not isinstance(rec, dict):
            return rec
        for field in WALL_CLOCK_FIELDS.get(bucket, ()):
            rec.pop(field, None)
        return rec if normal is None else normal(rec)

    for bucket in buckets:
        raws = []
        for i, path in enumerate((a, b)):
            rows = read_store(path, bucket, raw=True)
            if not links:
                for key in [k for k in rows if link_record(k)]:
                    del rows[key]
                    left[i] += 1
            raws.append(rows)
        recs = [{k: parsed(v) for k, v in rows.items()
                 if raws[1 - i].get(k) != v}
                for i, rows in enumerate(raws)]
        if set(raws[0]) != set(raws[1]) or recs[0] != recs[1]:
            bad = sorted(k for k in set(raws[0]) | set(raws[1])
                         if k not in raws[0] or k not in raws[1]
                         or recs[0].get(k) != recs[1].get(k))
            k = bad[0]
            raise AssertionError(
                f"stores {os.path.basename(a)} and {os.path.basename(b)} "
                f"differ in {bucket}: {len(bad)} records, first "
                f"{k!r}: {recs[0].get(k)} vs {recs[1].get(k)}")
        out[bucket] = len(raws[0])
    if not links:
        out["links_left"] = left
    return out


def metric_series(text: str) -> dict:
    """An exposition page's series, (name, labels) -> value."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, value = line.rsplit(" ", 1)
        name, _, labels = key.partition("{")
        out[(name, labels.rstrip("}"))] = float(value)
    return out


def metric(series: dict, name: str, **labels) -> float:
    """The sum of a family's series whose labels hold ``labels``."""
    want = [f'{k}="{v}"' for k, v in labels.items()]
    return sum(v for (n, lab), v in series.items()
               if n == name and all(w in lab for w in want))


def hist_quantiles(after: dict, before: dict, name: str,
                   qs=(0.5, 0.99), **labels) -> list:
    """The quantiles ``qs`` (ms) of what the histogram family ``name``
    counted between two pages: its series holding ``labels``, summed
    bucket by bucket, each quantile interpolated in its bucket as
    Prometheus's ``histogram_quantile`` does (None where it counted
    nothing)."""
    want = [f'{k}="{v}"' for k, v in labels.items()]
    cum: dict = {}
    for page, sign in ((after, 1), (before, -1)):
        for (n, lab), v in page.items():
            if n == f"{name}_bucket" and all(w in lab for w in want):
                le = float(re.search(r'le="([^"]+)"', lab).group(1))
                cum[le] = cum.get(le, 0.0) + sign * v
    bounds = sorted(cum)
    if not bounds or cum[bounds[-1]] <= 0:
        return [None] * len(qs)
    out = []
    for q in qs:
        rank = q * cum[bounds[-1]]
        lo, below = 0.0, 0.0
        for b in bounds:
            if cum[b] >= rank:
                out.append(1e3 * (lo if b == float("inf") else
                                  lo + (b - lo) * (rank - below)
                                  / max(cum[b] - below, 1e-12)))
                break
            lo, below = b, cum[b]
    return out


def fed_latency(after: dict, before: dict) -> dict:
    """A node's sampled latencies between two ``/metrics`` pages (ms,
    [p50, p99]): the match's queue and device (or trie) stages, the
    publish end to end (every QoS), and the cross-node end to end that
    this node's publishes took by hop count."""
    hops = sorted({re.search(r'hops="(\d+)"', lab).group(1)
                   for (n, lab) in after
                   if n == "maxmq_cluster_publish_e2e_seconds_bucket"})
    stage = "maxmq_broker_publish_stage_seconds"
    return {"match_queue": hist_quantiles(after, before, stage,
                                          stage="match_queue"),
            "match_device": hist_quantiles(after, before, stage,
                                           stage="match_device"),
            "e2e": hist_quantiles(after, before,
                                  "maxmq_broker_publish_e2e_seconds"),
            "cluster_e2e": {h: hist_quantiles(
                after, before, "maxmq_cluster_publish_e2e_seconds", hops=h)
                for h in hops}}


def matcher_only(name: str) -> bool:
    return name.startswith("maxmq_matcher_") or name in MATCHER_ONLY


class StartedBroker:
    """One broker as production starts it: ``python -m maxmq_tpu_torch
    start -c <conf> --no-banner`` (``--device`` where given) in a child
    process run from the checkout's root, on a free TCP port and a free
    metrics port, with SQLite storage at ``db`` under ``storage_sync =
    "always"``, $SYS off, JSON logs, ``matcher_max_batch`` where given and
    the default ``Config`` otherwise.
    Each start writes its log (the JSON lines of stdout and stderr) to a
    file of its own in ``workdir``."""

    def __init__(self, name: str, workdir: str, db: str, matcher: str,
                 device: str | None = None,
                 max_batch: int | None = None) -> None:
        self.name, self.workdir, self.db = name, workdir, db
        self.device = device
        self.port, self.metrics_port = listen_port(), free_port()
        self.conf = os.path.join(workdir, f"{name}.toml")
        with open(self.conf, "w") as f:
            f.write(f'mqtt_tcp_address = "127.0.0.1:{self.port}"\n'
                    f'metrics_address = "127.0.0.1:{self.metrics_port}"\n'
                    f'matcher = "{matcher}"\n'
                    'storage_backend = "sqlite"\n'
                    f'storage_path = "{db}"\n'
                    'storage_sync = "always"\n'
                    'mqtt_sys_topic_interval = 0\n'
                    'log_format = "json"\n')
            if max_batch is not None:
                f.write(f"matcher_max_batch = {max_batch}\n")
        self.starts = 0
        self.proc = None
        self.log_path = ""

    def add_config(self, text: str) -> None:
        """Append config lines (phase 16's cluster identity, once every
        node's port is known)."""
        with open(self.conf, "a") as f:
            f.write(text)

    def start(self, faults: str = "") -> None:
        """Start the process (``faults`` as its ``MAXMQ_FAULTS``)."""
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("MAXMQ_")}
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (ROOT, env.get("PYTHONPATH")) if p)
        if faults:
            env["MAXMQ_FAULTS"] = faults
        cmd = [sys.executable, "-m", "maxmq_tpu_torch", "start", "-c",
               self.conf, "--no-banner"]
        if self.device is not None:
            cmd += ["--device", self.device]
        self.starts += 1
        self.log_path = os.path.join(self.workdir,
                                     f"{self.name}-{self.starts}.log")
        self.t_start = time.perf_counter()
        with open(self.log_path, "w") as log_file:
            self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                         stdout=log_file,
                                         stderr=subprocess.STDOUT)

    def lines(self) -> list[dict]:
        """The JSON log lines of the current start (others left out)."""
        out = []
        with open(self.log_path) as f:
            for line in f:
                with contextlib.suppress(ValueError):
                    rec = json.loads(line)
                    if isinstance(rec, dict):
                        out.append(rec)
        return out

    def tail(self, n: int = 4000) -> str:
        with open(self.log_path) as f:
            return f.read()[-n:]

    async def ready(self, timeout: float) -> dict:
        """Wait for the ``server started`` line and the listener; returns
        the boot: seconds from the start to that line, split into the
        restore, the matcher's compile + prewarm (``serve()``'s own
        clock), a cluster node's rebuild of its session ledger from the
        journal (the replica restore) and the rest (interpreter, imports,
        CUDA, config, engine build), the matcher's device, the event
        loop, and every warning or error logged meanwhile."""
        deadline = time.monotonic() + timeout
        while True:
            if self.proc.poll() is not None:
                raise AssertionError(
                    f"{self.name} broker exited {self.proc.returncode} at "
                    f"boot:\n{self.tail()}")
            lines = self.lines()
            started = next((x for x in lines
                            if x.get("message") == "server started"), None)
            if started is not None:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"{self.name} broker not started in "
                                     f"{timeout} s:\n{self.tail()}")
            await asyncio.sleep(0.05)
        boot_s = time.perf_counter() - self.t_start
        _r, w = await asyncio.wait_for(
            asyncio.open_connection("127.0.0.1", self.port), 30)
        w.close()
        loop = next((x.get("loop") for x in lines
                     if x.get("message") == "event loop installed"), None)
        replica_s = started.get("replica_restore_s", 0.0)
        return {"boot_s": boot_s, "restore_s": started["restore_s"],
                "compile_prewarm_s": started["compile_s"],
                "replica_restore_s": replica_s,
                "rest_s": boot_s - started["restore_s"]
                - started["compile_s"] - replica_s,
                "device": started["device"], "event_loop": loop,
                "warnings": [x for x in lines if x.get("level")
                             in ("warn", "error", "fatal")]}

    async def wait(self, timeout: float) -> int:
        """The process's exit code; fails (killing it) past ``timeout``."""
        deadline = time.monotonic() + timeout
        while self.proc.poll() is None:
            if time.monotonic() > deadline:
                self.kill()
                raise AssertionError(f"{self.name} broker still running "
                                     f"after {timeout} s:\n{self.tail()}")
            await asyncio.sleep(0.05)
        return self.proc.returncode

    async def stop(self, timeout: float) -> float:
        """SIGTERM, then exit 0 within ``timeout`` with no error logged
        while stopping (a journal closed with uncommitted ops logs one);
        returns the seconds the stop took."""
        t0 = time.perf_counter()
        n0 = len(self.lines())
        self.proc.send_signal(signal.SIGTERM)
        rc = await self.wait(timeout)
        if rc != 0:
            raise AssertionError(f"{self.name} broker exited {rc} on "
                                 f"SIGTERM:\n{self.tail()}")
        errors = [x for x in self.lines()[n0:]
                  if x.get("level") in ("error", "fatal")]
        if errors:
            raise AssertionError(f"{self.name} broker logged errors while "
                                 f"stopping: {errors}")
        return time.perf_counter() - t0

    async def drained(self, timeout: float, keep: int = 0) -> None:
        """Wait until the broker holds no connection but ``keep`` (a
        federation node's peers' bridge links) (its /metrics): the
        clients' DISCONNECTs processed, so a clean session's records are
        gone before a stop, as on the other broker."""
        deadline = time.monotonic() + timeout
        while metric(self.scrape(),
                     "maxmq_mqtt_clients_connected") > keep:
            if time.monotonic() > deadline:
                raise AssertionError(f"{self.name} broker still holds "
                                     f"connections after {timeout} s")
            await asyncio.sleep(0.05)

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)

    def scrape(self, path: str = "/metrics") -> dict:
        import urllib.request

        url = f"http://127.0.0.1:{self.metrics_port}{path}"
        with urllib.request.urlopen(url, timeout=30) as r:
            return metric_series(r.read().decode())


async def close_clients(side: BrokerSide) -> None:
    for c in (*side.subs.values(), *side.pubs.values()):
        if c.writer is not None:
            await c.close(disconnect=True)


async def resume_in_store_order(kit, port: int, cid: str, version: int,
                                alias_max: int, records: list,
                                timeout: float) -> int:
    """Session ``cid`` resumed (clean start off): the broker must resend
    its queued deliveries, ``records`` (its inflight records in the
    store), in the store's order (receipt time, then packet id: the
    order ``Inflight.all`` resends), each with its packet id and payload.
    Returns the deliveries held."""
    want = [(r["packet_id"], r["payload"]) for r in
            sorted(records, key=lambda r: (r["created"], r["packet_id"]))
            if r["packet_type"] == 3]
    c = WireClient(kit, cid, version, alias_max, clean=False,
                   expiry=STARTED_EXPIRY if version >= 5 else None,
                   timeout=timeout)
    connack = await c.open(port)
    if not connack[2] & 1:
        raise AssertionError(f"{cid}: no session present on resume")
    await c.until(lambda: len(c.frames) >= len(want))
    await c.ping()
    got = []
    for f in c.frames:
        pk = next(kit.parse_stream(bytearray(f)))
        got.append((publish_pid(f),
                    kit.Packet.decode(*pk, version).payload.hex()))
    await c.close(disconnect=True)
    if got != want:
        raise AssertionError(f"{cid}: {len(got)} deliveries on resume, "
                             f"{len(want)} in the store, or another order")
    return len(got)


# -- phase 17: the worker pool's processes ------------------------------

def child_pids(parent: int, name: bytes = b"maxmq_tpu_torch") -> list:
    """The live processes whose parent is ``parent`` and whose command
    line holds ``name`` (a pool parent's workers), by pid."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
        except (OSError, IndexError):
            continue
        if int(stat[1]) == parent and stat[0] != "Z" and name in cmd:
            out.append(int(d))
    return sorted(out)


def tcp_inodes(local_port: int, remote_port: int | None = None) -> list:
    """The socket inodes of ``/proc/net/tcp`` bound to ``local_port``:
    its listening sockets (state LISTEN), or with ``remote_port`` the
    connection from that peer port."""
    out = []
    with open("/proc/net/tcp") as f:
        for line in f.readlines()[1:]:
            parts = line.split()
            local = int(parts[1].split(":")[1], 16)
            remote = int(parts[2].split(":")[1], 16)
            if local != local_port:
                continue
            if (remote_port is None and parts[3] == "0A") or \
                    remote == remote_port:
                out.append(parts[9])
    return out


def socket_owner(inode: str, pids) -> int | None:
    """Which of ``pids`` holds the socket ``inode``."""
    target = f"socket:[{inode}]"
    for pid in pids:
        with contextlib.suppress(OSError):
            for fd in os.listdir(f"/proc/{pid}/fd"):
                with contextlib.suppress(OSError):
                    if os.readlink(f"/proc/{pid}/fd/{fd}") == target:
                        return pid
    return None


def connection_owner(port: int, writer, pids) -> int | None:
    """Which worker of ``pids`` holds the broker side of the client
    connection ``writer`` to ``port`` (the kernel's SO_REUSEPORT pick;
    None until the worker has accepted it)."""
    local = writer.get_extra_info("sockname")[1]
    inodes = tcp_inodes(port, remote_port=local)
    return socket_owner(inodes[0], pids) if inodes else None


async def accepted_by(port: int, writer, pids, timeout: float = 10.0):
    """``connection_owner`` once a worker has accepted the connection."""
    deadline = time.monotonic() + timeout
    while True:
        owner = connection_owner(port, writer, pids)
        if owner is not None:
            return owner
        if time.monotonic() > deadline:
            raise AssertionError(f"no worker of {pids} accepted the "
                                 f"connection to {port}")
        await asyncio.sleep(0.005)


# phase 17's pool: its workers and their mesh, as ``worker_conf`` names them
POOL_WORKERS = 2
POOL_NODES = tuple(f"w{i}" for i in range(POOL_WORKERS))
POOL_LINE = {n: tuple(p for p in POOL_NODES if p != n) for n in POOL_NODES}


def pool_routes(sessions, placement: dict) -> dict:
    """The routes each worker of phase 17's pool holds once it converges,
    from where its sessions are (``placement``: client id -> worker of
    the online compared subscribers; every other session stays at w0,
    which restored it): each worker holds the cover of the other's
    filters."""
    local = {n: fed_local_filters([s for s in sessions
                                   if placement.get(s[0], "w0") == n])
             for n in POOL_NODES}
    return fed_routes(local, POOL_LINE)


def pool_record(rec: dict) -> dict:
    """A stored record of a pool's journal as ``stores_equal`` compares
    two pools': without the ``mq-trace`` pairs (``drop_trace``: F20), and
    a ledger row of a session that w1 owns without its boot epoch (w1
    keeps no store, so its epoch is its start time)."""
    if rec.get("owner") not in (None, POOL_NODES[0]):
        rec.pop("be", None)
    return drop_trace(rec)


class StartedPool(StartedBroker):
    """One worker pool as production starts it: ``python -m
    maxmq_tpu_torch start`` with ``workers = 2`` and phase 15's other
    settings, its own ``worker_link_dir`` and ``pool_metrics_address``;
    every other pool setting the default. The parent's log file holds its
    workers' lines too (they inherit its output); ``port`` is the pool's
    one TCP port, ``metrics_port`` worker 0's ``/metrics`` and
    ``pool_port`` the parent's."""

    def __init__(self, name: str, workdir: str, db: str, matcher: str,
                 device: str | None = None,
                 max_batch: int | None = None) -> None:
        super().__init__(name, workdir, db, matcher, device, max_batch)
        self.pool_port = free_port()
        self.mesh = os.path.join(workdir, f"{name}-mesh")
        # the tracer samples every FED_TRACE_STRIDE-th inbound publish
        # (w0's match latency), so frames and stores are compared without
        # the property it stamps (F20)
        self.add_config(f"workers = {POOL_WORKERS}\n"
                        f'worker_link_dir = "{self.mesh}"\n'
                        f'pool_metrics_address = "127.0.0.1:'
                        f'{self.pool_port}"\n'
                        f"trace_sample_n = {FED_TRACE_STRIDE}\n")

    def start(self, faults: str = "") -> None:
        self.t_wall = time.time()
        super().start(faults)

    def workers(self) -> list:
        """The live worker processes' pids."""
        return child_pids(self.proc.pid)

    def kill(self) -> None:
        """SIGKILL the workers, then the parent (a parent killed first
        would leave its workers running)."""
        if self.proc is not None and self.proc.poll() is None:
            for pid in self.workers():
                with contextlib.suppress(OSError):
                    os.kill(pid, signal.SIGKILL)
        super().kill()

    async def ready(self, timeout: float) -> dict:
        """Wait for the pool's start line, each worker's, and every worker
        listening on the one port; returns the boot: seconds from the
        start to the pool's line and to each worker's, worker 0's restore
        (``serve()``'s clock), the sidecar's device, the workers' pids and
        every warning or error logged meanwhile."""
        deadline = time.monotonic() + timeout
        while True:
            if self.proc.poll() is not None:
                raise AssertionError(
                    f"{self.name} pool exited {self.proc.returncode} at "
                    f"boot:\n{self.tail()}")
            lines = self.lines()
            pool = next((x for x in lines
                         if x.get("message") == "worker pool started"), None)
            workers = {x["worker"]: x for x in lines
                       if x.get("message") == "pool worker started"}
            if (pool is not None and len(workers) == POOL_WORKERS
                    and len(tcp_inodes(self.port)) >= POOL_WORKERS):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"{self.name} pool not started in "
                                     f"{timeout} s:\n{self.tail()}")
            await asyncio.sleep(0.05)
        pids = self.workers()
        owners = {socket_owner(i, pids) for i in tcp_inodes(self.port)}
        if owners != set(pids) or len(pids) != POOL_WORKERS:
            raise AssertionError(f"{self.name} pool: workers {pids}, "
                                 f"listening {owners}")
        return {"boot_s": time.perf_counter() - self.t_start,
                "pool_started_s": pool["time"] / 1e3 - self.t_wall,
                "worker_started_s": {f"w{i}": x["time"] / 1e3 - self.t_wall
                                     for i, x in sorted(workers.items())},
                "w0_restore_s": workers[0]["restore_s"],
                "device": pool["device"] or "cuda",
                "sidecar": pool["matcher_sidecar"], "pids": pids,
                "warnings": [x for x in lines if x.get("level")
                             in ("warn", "error", "fatal")]}

    async def stop(self, timeout: float) -> float:
        """SIGTERM to the parent: it exits 0 within ``timeout``, each
        worker stopped with rc 0 (the parent's ``pool worker stopped``
        lines), no error logged while stopping, and no mesh socket
        (``w<i>.sock``, ``matcher.sock``) left; returns the seconds."""
        n0 = len(self.lines())
        took = await super().stop(timeout)
        stopped = {x["worker"]: x["rc"] for x in self.lines()[n0:]
                   if x.get("message") == "pool worker stopped"}
        if stopped != dict.fromkeys(range(POOL_WORKERS), 0):
            raise AssertionError(f"{self.name} pool's workers stopped "
                                 f"with {stopped}:\n{self.tail()}")
        left = (sorted(f for f in os.listdir(self.mesh)
                       if f.endswith(".sock"))
                if os.path.isdir(self.mesh) else [])
        if left:
            raise AssertionError(f"{self.name} pool left {left}")
        return took

    def worker_counts(self) -> dict:
        """Each worker's matcher counts over its life, from its last
        ``pool worker stopping`` line."""
        return {f"w{x['worker']}": {k: x[k] for k in (
            "fallbacks", "breaker_trips", "degrades", "launches")}
            for x in self.lines()
            if x.get("message") == "pool worker stopping"}

    def scrape_pool(self) -> dict:
        import urllib.request

        url = f"http://127.0.0.1:{self.pool_port}/metrics"
        with urllib.request.urlopen(url, timeout=30) as r:
            return metric_series(r.read().decode())


# -- phase 16: the cluster federation ------------------------------------

# phase 16's topology: a line A - B - C with symmetric ``cluster_peers``.
# The publishers sit on A and C, so C's publishes reach A's subscribers
# over two hops through B, which relays and serves forwarded publishes.
FED_LINE = {"A": ("B",), "B": ("A", "C"), "C": ("B",)}
FED_PUBLISHER_NODES = ("A", "C")
# a node's forward counters (``maxmq_cluster_<name>_total``), held
# against its twin in the other federation: sent, delivered, refused,
# parked and the dedup / origin-echo drops
FED_FORWARDS = ("forwards_sent", "forwards_delivered", "forwards_refused",
                "forwards_parked", "loops_dropped")
# phase 16's tracer stride (phase 12's)
FED_TRACE_STRIDE = 32
# the boot epoch each phase 16 store holds when written (a fresh store
# seeds its first epoch from the wall clock, which would differ between
# the two federations' copies and so between their session tokens)
FED_BOOT_EPOCH = 1_000
# a node's session federation counters (``maxmq_cluster_session_<name>``
# and ``fed_session_counts``): the takeovers, the takeovers that degraded
# to a fresh session or went stale on a pull, replicated windows that
# disagreed with their digest, journal rows that failed to parse,
# injected sync faults, refused sends and their resyncs
FED_SESSION_COUNTERS = ("takeovers", "takeovers_degraded", "takeovers_stale",
                        "digest_mismatches", "restore_errors", "sync_faults",
                        "sync_send_failures", "sync_resyncs")


def fed_config(node: str, ports: dict) -> str:
    """The config lines that make a started broker node ``node`` of
    phase 16's line (``ports``: each node's MQTT port): its id and its
    peers (every other cluster setting the default: federated sessions
    on, ``cluster_session_sync = "batched"``), and the tracer on,
    sampling every ``FED_TRACE_STRIDE``-th inbound publish, for the
    match and cross-node latency histograms. Its stride counts the
    federation's timed control traffic (heartbeats, telemetry, clock
    probes) too, so which publishes it samples, and so which v5
    deliveries carry an adopted trace's ``mq-trace`` property, differ
    between the federations: frames and stores are compared without
    that property (``without_trace``, ``drop_trace``)."""
    peers = ",".join(f"{p}@127.0.0.1:{ports[p]}" for p in FED_LINE[node])
    return (f'cluster_node_id = "{node}"\n'
            f'cluster_peers = "{peers}"\n'
            f"trace_sample_n = {FED_TRACE_STRIDE}\n")


def fed_converged(held: dict, expected: dict, line=FED_LINE) -> bool:
    """Every node of ``held`` (node -> [routes held, links up]) holds the
    routes its peers advertise (``expected``, from ``fed_routes``) with
    each of its links up."""
    return all(v == [expected[n], len(line[n])] for n, v in held.items())


def fed_plan(kit, plan, nodes=tuple(FED_LINE), probes: bool = True) -> list:
    """``plan``'s compared subscribers over ``nodes``, round robin in their
    order (A, B, C, A, ...), its '#' probe replaced by one '#' probe a
    node (``tcp-probe-<node>``; none where ``probes`` is off, so the
    routes are not one '#'): [(node, cid, version, alias_max, offline,
    [Subscription, ...])]."""
    out = [(nodes[k % len(nodes)], *entry) for k, entry in
           enumerate(e for e in plan if e[0] != "tcp-probe")]
    if probes:
        out += [(n, f"tcp-probe-{n}", 4, 0, False,
                 [kit.Subscription(filter="#")]) for n in nodes]
    return out


def fed_local_filters(sessions) -> set:
    """The filters a node's manager aggregates from its restored
    subscriptions (``ClusterManager._note_filter``): a ``$share``
    filter's inner filter, no '$' filter."""
    from maxmq_tpu_torch.matching.topics import parse_share

    out = set()
    for _cid, _v, subs in sessions:
        for sub in subs:
            group, inner = parse_share(sub.filter)
            f = inner if group else sub.filter
            if f and not f.startswith("$"):
                out.add(f)
    return out


def fed_routes(local: dict, line=FED_LINE) -> dict:
    """The routes each node of the tree ``line`` holds once it has
    converged, from each node's local filters: a peer advertises the
    minimal cover of its own filters and of what its other peers
    advertise to it (split horizon), so node X holds, summed over its
    peers P, the cover P advertises to X."""
    from maxmq_tpu_torch.cluster.routes import IncrementalCover

    memo: dict = {}

    def advertised(p: str, x: str) -> set:
        if (p, x) not in memo:
            fs = set(local[p])
            for q in line[p]:
                if q != x:
                    fs |= advertised(q, p)
            memo[p, x] = IncrementalCover(fs).cover
        return memo[p, x]

    return {x: sum(len(advertised(p, x)) for p in line[x]) for x in line}


def fed_runs(federation: dict) -> list:
    """Phase 16's traffic runs (``Smoke.fed_traffic``'s records): before
    the takeovers, while B's subscribers are away, after the live
    takeover, and after B's restart."""
    return [federation["traffic"], federation["takeover"]["parked"],
            federation["takeover"]["traffic"], federation["rung"]["traffic"]]


def fed_local_routes(kit, corpus: dict, plan) -> dict:
    """``fed_routes`` of the sessions each node of ``FED_LINE`` holds: its
    corpus sessions (``corpus``: node -> [(client id, Subscription)]) and
    the compared subscribers ``plan`` puts on it (``started_sessions``)."""
    return fed_routes({node: fed_local_filters(started_sessions(
        kit, corpus[node], [e for n, *e in plan if n == node]))
        for node in FED_LINE})


class Federation:
    """One federation of phase 16 as its clients see it: each node's
    ``BrokerSide`` (its compared subscribers and publishers, by node) and
    the fences sent. A publisher ``pub<v>-<k>`` sits on node
    ``publishers[k % len(publishers)]``; a fence ends a burst once every
    online subscriber of every node holds it."""

    def __init__(self, ports: dict,
                 publishers=FED_PUBLISHER_NODES) -> None:
        self.sides = {n: BrokerSide(None, p) for n, p in ports.items()}
        self.publishers = publishers

    @property
    def online(self) -> list:
        return [c for side in self.sides.values() for c in side.online]

    async def resume(self, kit, plan, nodes=None) -> None:
        """The plan's online subscribers of ``nodes`` (all) back on their
        stored sessions, each on its node."""
        for node, *entry in plan:
            if nodes is None or node in nodes:
                await resume_subscribers(kit, self.sides[node], [entry])

    async def connect(self, kit, plan, persistent=()) -> None:
        """The plan's subscribers connected fresh and subscribed, each on
        its node (the offline ones leave with their sessions kept; those
        of ``persistent`` stay on kept sessions)."""
        for node, *entry in plan:
            await connect_subscribers(kit, self.sides[node], [entry],
                                      persistent)

    def side_of(self, owner: str) -> BrokerSide:
        return self.sides[self.publishers[int(owner.rsplit("-", 1)[1])
                                          % len(self.publishers)]]

    async def leave(self, entries) -> None:
        """The clients of the plan ``entries`` off their nodes, each with
        a DISCONNECT (its session kept)."""
        for node, cid, *_rest in entries:
            c = self.sides[node].subs.get(cid)
            if c is not None:
                await c.close(disconnect=True)

    async def arrive(self, kit, entries, dst: str, expiry: int,
                     subscribe=()) -> dict:
        """A session takeover: the clients of the plan ``entries`` (their
        nodes' sessions) connect at node ``dst`` at once, clean start off
        (a v5 one with ``expiry``), each then subscribing ``subscribe``;
        fails unless every CONNACK says the session is present. Each
        client moves to ``dst``'s side; returns each one's frames on its
        old node."""
        old = {}

        async def one(node, cid, version, alias_max, _offline, _subs):
            gone = self.sides[node].subs.pop(cid, None)
            old[cid] = gone.frames if gone is not None else []
            c = self.sides[dst].subs[cid] = WireClient(
                kit, cid, version, alias_max, clean=False,
                expiry=expiry if version >= 5 else None)
            connack = await c.open(self.sides[dst].port)
            if not connack[2] & 1:
                raise AssertionError(f"{cid}: no session present at {dst} "
                                     f"after the takeover from {node}")
            for sub in subscribe:
                await c.subscribe(sub)

        await asyncio.gather(*(one(*e) for e in entries))
        return old

    async def bursts(self, kit, traffic, chunk: int) -> None:
        """``BrokerSide.bursts`` of ``traffic`` in bursts of ``chunk``,
        each publisher on its node, every fence (counted on the first
        side) awaited by every node's online subscribers."""
        first = next(iter(self.sides.values()))
        await first.bursts(kit, traffic, chunk=chunk, side_of=self.side_of,
                           subs=self.online)

    def marks(self) -> dict:
        return {cid: len(c.frames) for side in self.sides.values()
                for cid, c in side.subs.items()}

    def streams(self, start: dict, untraced: bool = False) -> dict:
        """Every node's subscribers' frames since ``start``; ``untraced``:
        each v5 frame ``without_trace``."""
        out = {}
        for side in self.sides.values():
            out.update(side.streams(start, untraced))
        return out

    async def close(self, nodes=None) -> None:
        for node, side in self.sides.items():
            if nodes is None or node in nodes:
                await close_clients(side)
                side.subs.clear()
                side.pubs.clear()


def fed_corpus_slices(nodes, n_subs: int, seed: int):
    """Each node's corpus slice [(client id, Subscription)] and the
    corpus's topic generator: ``build_corpus``'s filters split by index
    over ``nodes``, QoS ``i % 3``."""
    kit = port_kit()
    filters, gen = build_corpus(n_subs, seed=seed)
    slices = {n: [] for n in nodes}
    for i, f in enumerate(filters):
        slices[nodes[i % len(nodes)]].append(
            (f"cl-{i}", kit.Subscription(filter=f, qos=i % 3)))
    return slices, gen


def fed_matcher_counts(broker) -> dict:
    """A broker's supervised batcher's counts ({} without a matcher):
    batches and the topics in them, the topics of those the bypass served
    on the host and its shadow probes, cache hits, the topics its engine
    served off the device (``SIG_COUNTERS``), the supervisor's hedges
    by reason (``hedges_<reason>``, every reason but ``overflow``) and
    breaker trips."""
    sup = broker.matcher
    if sup is None:
        return {}
    b = sup.inner
    return {"batches": b.batches, "batched_topics": b.batched_topics,
            "bypassed_topics": b.bypasses, "shadow_probes": b.shadow_probes,
            "cache_hits": b.cache_hits,
            "engine_host_topics": sum(getattr(b.engine, c, 0)
                                      for c in SIG_COUNTERS),
            **{f"hedges_{k}": v for k, v in sup.fallbacks_by_reason.items()
               if k != "overflow"},
            "breaker_trips": sup.breaker_trips}


def fed_session_counts(mgr) -> dict:
    """A node's session federation's takeover and replication health
    counters."""
    sess = mgr.sessions
    return {k: getattr(sess, k) for k in FED_SESSION_COUNTERS}


async def fed_in_process(line, specs: dict, seed: int, publishers,
                         n_subs: int = 600, publishes: int = 384,
                         burst: int = 64, clients: int = 12,
                         takeover=None) -> dict:
    """One federation over the tree ``line`` in this process (the port's
    CPU tests and card test run it): node ``n`` a broker of
    ``specs[n]`` = (broker kit, cluster package, matcher or None, device)
    holding its corpus slice (``fed_corpus_slices``), a
    ``ClusterManager`` with its federated sessions at the default
    configuration (the default keepalive too: a shorter one declares a
    link dead while a full-size node holds the loop; a fast reconnect
    backoff), the compared subscribers (``fed_plan`` without probes, so
    the routes are real covers) connected and subscribed, the routes
    converged (``fed_routes``), each engine caught up with its index
    (``catch_up``), then ``publish_frames`` in fenced bursts from
    ``publishers``. Every node with a matcher has its batcher's host
    bypass off (as phase 12's), so its engine answers every topic it
    matches, forwarded ones included.

    ``takeover`` = (source node, new owner, n): the source's first ``n``
    compared subscribers are on kept sessions throughout; after the
    traffic they leave, half of ``publishes // 2`` more publishes parks
    their deliveries at the source, they reconnect at the new owner (a
    live owner's session takeover: session present, the parked window
    resent), the routes converge again and the other half follows.

    Returns the subscribers' frames (a taken-over client's frames at its
    old node under ``<cid>@<node>``), each node's forward counters and
    retained (topic, payload) pairs, the routes expected,
    ``sig_match_fixed``'s launches during the traffic, each matcher
    node's counts over it (``fed_matcher_counts``), and for a takeover
    each node's session counters (``fed_session_counts``), with the
    launches and matcher counts of the traffic after it."""
    from maxmq_tpu_torch.matching import sig_kernel

    kit = port_kit()
    nodes = tuple(line)
    slices, gen = fed_corpus_slices(nodes, n_subs, seed)
    topics = gen(publishes, seed2=seed + 1)
    index = kit.TopicIndex()
    for pairs in slices.values():
        for cid, sub in pairs:
            index.subscribe(cid, sub)
    plan = fed_plan(kit, subscriber_plan(kit, clients, topics,
                                         index.subscribers, seed=seed),
                    nodes, probes=False)
    moved = ([e for e in plan if e[0] == takeover[0]][:takeover[2]]
             if takeover else [])
    sides, mgrs = {}, {}

    def routes_expected(plan) -> dict:
        local = {}
        for node in nodes:
            sessions = [(cid, 0, [sub]) for cid, sub in slices[node]]
            sessions += [(cid, v, [*subs, kit.Subscription(
                filter=FENCE_TOPIC)]) for n, cid, v, _a, _o, subs in plan
                if n == node]
            local[node] = fed_local_filters(sessions)
        return fed_routes(local, line)

    async def converge(expected) -> None:
        deadline = time.monotonic() + 30
        while not fed_converged(
                {n: [m.routes.remote_route_count, m.links_up]
                 for n, m in mgrs.items()}, expected, line):
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"routes held {[m.routes.remote_route_count for m in mgrs.values()]}"
                    f", expected {expected}")
            await asyncio.sleep(0.02)
        for node in nodes:
            engine = getattr(sides[node].broker.matcher, "engine", None)
            if engine is not None:
                # the engine's background refresh over the compared
                # subscribers' subscriptions, awaited before the traffic
                # (as phase 12's): a refresh under way holds the matches
                await asyncio.get_running_loop().run_in_executor(
                    None, catch_up, engine)

    async def traffic(frames_owners) -> tuple:
        counts0 = {n: fed_matcher_counts(sides[n].broker) for n in nodes}
        launches = sig_kernel.sig_match_fixed.launches
        await fed.bursts(kit, frames_owners, burst)
        return (sig_kernel.sig_match_fixed.launches - launches,
                {n: {k: v - counts0[n][k] for k, v in
                     fed_matcher_counts(sides[n].broker).items()}
                 for n in nodes if counts0[n]})

    try:
        for node in nodes:
            bk, _cl, matcher, device = specs[node]
            sides[node] = await start_broker(
                bk, broker_config(bk, matcher or ""), slices[node],
                matcher is not None, device=device)
            if matcher is not None:
                sides[node].broker.matcher.inner.cpu_bypass = False
        for node, peers in line.items():
            cl = specs[node][1]
            mgr = cl.ClusterManager(
                sides[node].broker, node,
                [cl.PeerSpec(p, "127.0.0.1", sides[p].port) for p in peers],
                backoff_initial_s=0.05, backoff_max_s=0.5)
            sides[node].broker.attach_cluster(mgr)
            await mgr.start()
            mgrs[node] = mgr
        fed = Federation({n: sides[n].port for n in nodes}, publishers)
        await fed.connect(kit, plan, persistent={e[1] for e in moved})
        expected = routes_expected(plan)
        await converge(expected)
        k1, matchers = await traffic(publish_frames(
            kit, topics, seed + 2, publishers=len(publishers)))
        out = {"expected_routes": expected, "k1_launches": k1,
               "matchers": matchers}
        if takeover:
            src, dst, _n = takeover
            frames, owners = publish_frames(
                kit, gen(publishes // 2, seed2=seed + 3), seed + 4,
                publishers=len(publishers))
            half = len(frames) // 2
            await fed.leave(moved)
            await fed.bursts(kit, (frames[:half], owners[:half]), burst)
            old = await fed.arrive(kit, moved, dst, 3600)
            plan = [(dst if e in moved else e[0], *e[1:]) for e in plan]
            await converge(routes_expected(plan))
            k1_after, matchers_after = await traffic(
                (frames[half:], owners[half:]))
            out["takeover"] = {
                "moved": len(moved), "to": dst,
                "sessions": {n: fed_session_counts(m)
                             for n, m in mgrs.items()},
                "k1_launches": k1_after, "matchers": matchers_after}
        out.update(
            frames=fed.streams({}),
            forwards={n: {f: getattr(m, f) for f in FED_FORWARDS}
                      for n, m in mgrs.items()},
            retained={n: sorted((p.topic, p.payload) for p in
                                sides[n].broker.topics.retained_for("#"))
                      for n in nodes})
        if takeover:
            out["frames"].update({f"{cid}@{takeover[0]}": f
                                  for cid, f in old.items()})
        await fed.close()
        return out
    finally:
        for side in sides.values():
            await side.close()


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


def rss_gib() -> float:
    """This process's resident memory in GiB (``/proc/self/status``), or
    0.0 where the file is missing."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 2**20
    except OSError:
        pass
    return 0.0


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


def boot_beside(boot, st) -> tuple:
    """``boot(st)`` (a coroutine function: start a phase's children and
    wait for their boots) in a thread of its own with its own event loop,
    so it runs beside what the caller does next: its waits read the
    children's logs and pages with blocking calls, which would hold the
    caller's loop. Returns (thread, box); the box gets its result under
    "boot" or its exception under "error"."""
    box: dict = {}

    def run() -> None:
        try:
            box["boot"] = asyncio.run(boot(st))
        except BaseException as exc:    # re-raised by the phase
            box["error"] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, box


def abort_early(pending, children) -> None:
    """Kill the ``children`` (``StartedBroker``s) of a phase's early start
    ``pending`` = (state, thread, box) that the phase never took over,
    wait for its thread (it sees them die) and remove their directory."""
    st, thread, _box = pending
    for child in children:
        child.kill()
    thread.join(timeout=60)
    shutil.rmtree(st["work"], ignore_errors=True)


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
        self.preloads = {}
        self.engines = {}
        self.dense = None          # (subscriptions, generator, TopicIndex)
        self.dense_eng = None
        self.nfa_engines = {}      # corpus -> NFAEngine, default widths
        # phase 16's nodes started in phase 15's crash rung
        # (``fed_start_early``) and phase 17's pools at the end of phase
        # 16 (``pool_start_early``): (state, boot thread, its result)
        self.fed_pending = self.pool_pending = None
        self.record = {"max_abs_err": 0, "bit_equal": True}
        self.dense_record = {"max_abs_err": 0, "bit_equal": True}
        # the card's name and power limit, printed beside phase 16's
        # numbers (the host's CPU in a CPU rehearsal)
        self.card = (card_line() if self.device.type == "cuda"
                     else "cpu rehearsal")

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

    def corpus_filters(self, name: str):
        """(filters, topic generator) of one corpus, without an index."""
        if name in self.corpora:
            return self.corpora[name][:2]
        with collector_paused():
            return build_corpus(
                self.sizes["subs"][name], seed=42,
                share_frac=0.1 if name in ("iot_1m_share", "cluster_100k")
                else 0.0,
                hash_plus=name == "hash_plus_100k")

    def corpus(self, name: str):
        """(filters, topic generator, port TopicIndex) of one corpus."""
        if name in self.corpora:
            return self.corpora[name]
        from maxmq_tpu_torch.matching.trie import TopicIndex
        from maxmq_tpu_torch.protocol import Subscription

        t0 = time.perf_counter()
        filters, gen = self.corpus_filters(name)
        with collector_paused():
            index = TopicIndex()
            for i, f in enumerate(filters):
                index.subscribe(f"cl-{i}", Subscription(filter=f,
                                                        qos=i % 3))
        log(f"[corpus] {name}: {len(filters)} subscriptions indexed in "
            f"{time.perf_counter() - t0:.1f} s (collector paused)")
        # the index lives as long as the corpus: out of the collector's
        # generations, so the engine's compile-time collection
        # (``SigEngine._freeze_heap_if_large``) does not walk it again
        gc.freeze()
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

    # -- phase 12: the broker engine ----------------------------------

    def pipeline_supervisor(self) -> dict:
        """The supervisor's settings: the production ones, unless the size
        table overrides some (the CPU rehearsal, whose plain kernel shares
        the host with other work, widens the deadline)."""
        return {**PIPELINE_SUPERVISOR,
                **self.sizes["pipeline"].get("supervisor", {})}

    def corpus_preload(self, name: str) -> list:
        """The (client id, Subscription) pairs of corpus ``name`` that the
        brokers hold before they serve: ``mixed_100k`` with ``ClientTable``'s
        v5 options (identifiers, retain-as-published) on each filter,
        ``iot_1m_share`` as the benchmark holds it (QoS i % 3). Built once
        and shared: records are immutable (F7)."""
        from maxmq_tpu_torch.protocol import Subscription

        if name not in self.preloads:
            filters, _gen = self.corpus_filters(name)
            with collector_paused():
                if name == "mixed_100k":
                    kit, ct = port_kit(), ClientTable(len(filters))
                    pairs = [(f"cl-{i}", ct.subscription(kit, i, f))
                             for i, f in enumerate(filters)]
                else:
                    pairs = [(f"cl-{i}", Subscription(filter=f, qos=i % 3))
                             for i, f in enumerate(filters)]
            self.preloads[name] = pairs
        return self.preloads[name]

    def pipeline_corpus(self, name: str):
        """(index, SigEngine) over the preloaded subscriptions of ``name``
        (phase 13's tracing runs on phase 12's ``mixed_100k`` corpus)."""
        from maxmq_tpu_torch.matching.sig import SigEngine
        from maxmq_tpu_torch.matching.trie import TopicIndex

        t0 = time.perf_counter()
        idx = TopicIndex()
        with collector_paused():
            for cid, sub in self.corpus_preload(name):
                idx.subscribe(cid, sub)
            engine = SigEngine(idx, device=self.device)
        # frozen as a broker process's boot compile freezes its corpus
        # and tables (``SigEngine._freeze_heap_if_large``, once per
        # process growth step, which phase 4's 1M engine took here): full
        # collections in the runs walk what the runs allocate (~1 s
        # pauses over this corpus otherwise, past the 250 ms deadline)
        gc.freeze()
        log(f"[tracing] {name}: {idx.subscription_count} subscriptions "
            f"indexed and compiled in {time.perf_counter() - t0:.1f} s")
        return idx, engine

    @staticmethod
    def count_boot_prewarms(broker) -> list:
        """Count the engine's ``prewarm_decode_bases`` calls from now on
        (``serve()``'s boot compile makes one, off the loop)."""
        engine = broker.matcher.engine
        calls, prewarm = [], engine.prewarm_decode_bases

        def counted(*a, **k):
            calls.append(prewarm(*a, **k))
            return calls[-1]

        engine.prewarm_decode_bases = counted
        broker.__dict__["_boot_prewarms"] = calls
        return calls

    def boot_state(self, side, log_buf) -> dict:
        """What the card broker's boot left, read right after ``serve()``
        returned and before any client connected: the engine's tables at
        the index's version (compiled at boot, not at the first batch),
        the decode bases prewarmed inside ``serve()`` (its calls and the
        chunks they made; the native anchors' slot maps where the corpus
        has rows fat enough to chain), and no warning from the boot
        compile or prewarm."""
        from maxmq_tpu_torch import native

        b = side.broker
        engine = b.matcher.engine
        del engine.prewarm_decode_bases
        tables = engine.tables
        calls = b.__dict__.pop("_boot_prewarms")
        out = {"compiled": tables.version == b.topics.sub_version,
               "subscriptions": b.topics.subscription_count,
               "prewarm_calls": len(calls), "prewarm_chunks": sum(calls)}
        mod = native.decode_module()
        if mod is not None and hasattr(mod, "_slot_map_stats"):
            nd = tables.__dict__.get("_native_decode")
            out["rows_mapped"], out["anchor_entries"] = (
                mod._slot_map_stats(nd[1]) if nd else (0, 0))
        warned = [json.loads(line) for line in
                  log_buf.getvalue().splitlines() if line.strip()]
        out["boot_warnings"] = [w for w in warned
                                if w.get("level") in ("warn", "error")]
        if (not out["compiled"] or out["boot_warnings"]
                or not out["prewarm_calls"]):
            raise AssertionError(f"the card broker did not boot warm: {out}")
        return out

    async def broker_run(self, label: str, card, trie, kit, traffic,
                         bypass: bool) -> dict:
        """One run of the traffic through both brokers: first the trie
        broker (the reference streams), then the card broker, measured,
        with its batcher's bypass ``bypass``. Every compared subscriber's
        frames (and every fleet session's bytes) from the card broker must
        equal its frames from the trie broker, and every match answer the
        card broker dispatched must equal the trie's for its topic (the
        corpus's rows too, which no TCP subscriber holds); any answer not
        from the engine (an ``error``, ``deadline``
        or ``breaker_open`` hedge, a breaker trip, a pipeline degrade)
        fails the run, and with the bypass off ``sig_match_fixed`` must
        launch once per batch."""
        from maxmq_tpu_torch import native
        from maxmq_tpu_torch.protocol import wire

        b = card.broker
        sup = b.matcher
        batcher = sup.inner
        engine = sup.engine
        batcher.cpu_bypass = bypass
        start = {c: len(s.frames) for c, s in trie.subs.items()}
        trie_fleet0 = trie.fleet_marks()
        t0 = time.perf_counter()
        await trie.bursts(kit, traffic)
        trie_s = time.perf_counter() - t0
        want = trie.streams(start)

        sizes, lat, bypass_ms, spans, answers = [], [], [], {}, []
        note, run_bypass = batcher._note_batch, batcher._run_bypass
        dispatch, finish = b._dispatch_match, b.tracer.finish

        def note_batch(batch):
            sizes.append(len(batch))
            note(batch)

        def timed_bypass(batch, topics, ver):
            t = time.perf_counter()
            run_bypass(batch, topics, ver)
            bypass_ms.append((time.perf_counter() - t) * 1e3)

        def timed_dispatch(topic):
            t = time.perf_counter()
            fut = dispatch(topic)
            fut.add_done_callback(lambda _f: lat.append(
                (time.perf_counter() - t) * 1e3))
            answers.append((topic, fut))
            return fut

        checked = 0

        def check_so_far():
            # each burst's answers held against the trie after its fence,
            # then let go: kept to the end, the results would stay on the
            # heap that every full collection of the run walks
            nonlocal checked
            checked += check_matches(label, answers,
                                     trie.broker.topics.subscribers)
            answers.clear()

        def span_finish(tr, end_ns=0):
            # a sampled publish's spans, as the broker stamped them
            for stage, _t0, dur in tr.spans:
                spans.setdefault(stage, []).append(dur / 1e6)
            return finish(tr, end_ns)

        batcher._note_batch, batcher._run_bypass = note_batch, timed_bypass
        b._dispatch_match, b.tracer.finish = timed_dispatch, span_finish
        start = {c: len(s.frames) for c, s in card.subs.items()}
        fleet0 = card.fleet_marks()
        sent0, ack0 = b.info.messages_sent, card.ack_s
        tag0 = card.tag
        hedges0 = dict(sup.fallbacks_by_reason)
        trips0, degrades0 = sup.breaker_trips, b.matcher_degrades
        base = {k: getattr(engine, k) for k in ("matches",) + SIG_COUNTERS}
        bat0 = {k: getattr(batcher, k)
                for k in ("bypasses", "cache_hits", "errors")}
        decoded0, heads0 = dict(engine.decoded), dict(wire.heads)
        # the heap frozen at this quiescent point, as the benchmark does
        # after its warm-up (bench.py:622-646): a full collection during
        # the run walks only what the run allocates
        gc.collect()
        gc.freeze()
        lag = LoopLag()
        try:
            self.zero_kernel_counts()
            with full_collections() as gc_ms:
                lag.start()
                t0 = time.perf_counter()
                check_s = await card.bursts(kit, traffic, check_so_far)
                wall = time.perf_counter() - t0 - check_s
                await lag.stop()
            launches = self.kernel_counts()["sig_match_fixed"]
        finally:
            del batcher._note_batch, batcher._run_bypass, b._dispatch_match
            del b.tracer.finish
        got = card.streams(start)
        frames = streams_equal(f"{label}", got, want)
        fleet_bytes = fleet_equal(label, card.fleet_streams(fleet0),
                                  trie.fleet_streams(trie_fleet0))
        check_so_far()
        fences = sum(1 for s in got.values() for f in s
                     if f.rfind(FENCE_MARK, -24) > 0)
        hedges = {k: v - hedges0.get(k, 0)
                  for k, v in sup.fallbacks_by_reason.items()}
        bat = {k: getattr(batcher, k) - v for k, v in bat0.items()}
        publishes = len(traffic[0])
        out = {
            "publishes": publishes, "bursts": card.tag - tag0,
            "bypass": bypass,
            "deliveries": frames - fences, "fences": fences,
            "deliveries_per_s": (frames - fences) / wall,
            "answers_checked": checked, "answer_check_s": check_s,
            "fleet_sessions": len(card.fleet),
            "fleet_deliveries": b.info.messages_sent - sent0 - frames,
            "fleet_bytes": fleet_bytes,
            "fleet_ack_s": card.ack_s - ack0,
            "all_deliveries_per_s": (b.info.messages_sent - sent0
                                     - fences) / wall,
            "publishes_per_s": publishes / wall, "burst_wall_s": wall,
            "trie_broker_wall_s": trie_s,
            "match_ms_p50_p99_max": spread(lat),
            "sampled_spans_ms_p50_p99_max": {k: spread(v)
                                             for k, v in spans.items()},
            "loop_lag_ms_p50_p99_max": spread(lag.samples),
            "gc_full_collections": len(gc_ms),
            "gc_full_ms_max": max(gc_ms, default=0.0),
            "batch_sizes": {str(k): sizes.count(k)
                            for k in sorted(set(sizes))},
            "batches": len(sizes), "launches": launches,
            "bypass_batch_ms_p50_p99_max": spread(bypass_ms),
            "device_rtt_ms": (batcher.device_rtt or 0.0) * 1e3,
            "fallbacks_by_reason": hedges,
            "breaker_trips": sup.breaker_trips - trips0,
            "matcher_degrades": b.matcher_degrades - degrades0,
            "decoded": {k: v - decoded0[k]
                        for k, v in engine.decoded.items()},
            "heads": {k: v - heads0[k] for k, v in wire.heads.items()},
            **bat, **{k: getattr(engine, k) - v for k, v in base.items()}}
        dispatched = publishes + out["bursts"] - bat["cache_hits"]
        out["bypass_share"] = bat["bypasses"] / max(dispatched, 1)
        log(f"[broker] {label}: {json.dumps(out)}")
        hedged = {k: v for k, v in hedges.items() if k != "overflow" and v}
        if hedged or out["breaker_trips"] or out["matcher_degrades"]:
            raise AssertionError(f"{label}: answers not from the engine: "
                                 f"{hedged}, {out['breaker_trips']} breaker "
                                 f"trips, {out['matcher_degrades']} pipeline "
                                 "degrades")
        if native.decode_module() is not None and out["heads"]["python"]:
            raise AssertionError(f"{label}: {out['heads']['python']} frame "
                                 "heads took the Python encoder unfaulted")
        if not bypass and (bat["bypasses"] or bat["errors"]):
            raise AssertionError(f"{label}: with the bypass off every batch "
                                 "must reach the engine")
        if (not bypass and self.device.type == "cuda"
                and launches != len(sizes)):
            raise AssertionError(f"{label}: {launches} sig_match_fixed "
                                 f"launches for {len(sizes)} batches")
        return out

    async def broker_faults(self, card, trie, kit, traffic) -> dict:
        """The ladder's rungs on the card broker, one publish at a time
        (each paced on the probe subscriber, which every publish reaches),
        the same publishes through the trie broker unfaulted first: (1)
        DEVICE_MATCH raising until disarmed gives five error hedges and the
        breaker trips; (2) the next 16 publishes are answered
        ``breaker_open`` with no device call; (3) after the 1 s backoff one
        probe reaches the card and closes it; (4) one hang of twice the
        deadline gives one deadline hedge; (5) with NATIVE_ENCODE armed
        the Python heads build the rest of the frames. Every compared
        subscriber's frames equal the trie broker's, and every match
        answer the card broker dispatched equals the trie's."""
        from maxmq_tpu_torch import faults
        from maxmq_tpu_torch.protocol import wire

        sup = card.broker.matcher
        sup.inner.cpu_bypass = False
        kw = self.pipeline_supervisor()
        hang_s = 2 * kw["deadline_ms"] / 1e3
        frames, owners = traffic

        async def one(side, i: int) -> None:
            pub = await side.publisher(kit, owners[i])
            probe = side.subs["tcp-probe"]
            n = len(probe.frames)
            pub.send([frames[i]])
            await probe.until(lambda: len(probe.frames) > n)

        async def fence(side) -> None:
            await side.fence(await side.publisher(kit, owners[-1]))

        start = {c: len(s.frames) for c, s in trie.subs.items()}
        for i in range(len(frames)):
            await one(trie, i)
        await fence(trie)
        want = trie.streams(start)
        start = {c: len(s.frames) for c, s in card.subs.items()}
        faults.clear()
        rec, answers = {}, []
        dispatch = card.broker._dispatch_match

        def recorded(topic):
            answers.append((topic, dispatch(topic)))
            return answers[-1][1]

        card.broker._dispatch_match = recorded
        try:
            faults.arm(faults.DEVICE_MATCH, "raise", count=-1)
            for i in range(5):
                await one(card, i)
            rec["tripped"] = {"state": sup.breaker_state_name,
                              "trips": sup.breaker_trips,
                              **sup.fallbacks_by_reason}
            fired = faults.fired.get(faults.DEVICE_MATCH, 0)
            for i in range(5, 21):
                await one(card, i)
            rec["open"] = {"fired_while_open": faults.fired.get(
                faults.DEVICE_MATCH, 0) - fired, **sup.fallbacks_by_reason}
            rec["raises_fired"] = faults.fired.get(faults.DEVICE_MATCH, 0)
            faults.disarm(faults.DEVICE_MATCH)
            await asyncio.sleep(kw["backoff_initial_s"] + 0.05)
            self.zero_kernel_counts()
            await one(card, 21)
            rec["probe"] = {"state": sup.breaker_state_name,
                            "recoveries": sup.breaker_recoveries,
                            "launches": self.kernel_counts()[
                                "sig_match_fixed"],
                            "degraded_s": sup.degraded_seconds}
            faults.arm(faults.DEVICE_MATCH, "hang", count=1, delay_s=hang_s)
            t0 = time.perf_counter()
            await one(card, 22)
            dt = time.perf_counter() - t0
            await asyncio.sleep(hang_s + 0.1)    # the hung call finishes
            rec["hang"] = {"ms": dt * 1e3, "state": sup.breaker_state_name,
                           **sup.fallbacks_by_reason}
            heads0 = dict(wire.heads)
            faults.arm(faults.NATIVE_ENCODE, "raise", count=-1)
            for i in range(23, len(frames)):
                await one(card, i)
            faults.disarm(faults.NATIVE_ENCODE)
            rec["encode"] = {"heads": {k: v - heads0[k]
                                       for k, v in wire.heads.items()}}
            await fence(card)
        finally:
            faults.clear()
            del card.broker._dispatch_match
        rec["frames"] = streams_equal("faulted rungs", card.streams(start),
                                      want)
        rec["answers_checked"] = check_matches(
            "faulted rungs", answers, trie.broker.topics.subscribers)
        rec.update(fallbacks_by_reason=sup.fallbacks_by_reason,
                   breaker_trips=sup.breaker_trips,
                   breaker_recoveries=sup.breaker_recoveries,
                   breaker_state=sup.breaker_state_name,
                   matcher_degrades=card.broker.matcher_degrades)
        log(f"[broker] faults: {json.dumps(rec)}")
        t, o, pr, h = rec["tripped"], rec["open"], rec["probe"], rec["hang"]
        ok = (t["error"] == 5 and t["trips"] == 1 and t["state"] == "open"
              and sup.breaker_trips == 1
              and o["fired_while_open"] == 0 and o["breaker_open"] == 16
              and pr["state"] == "closed" and pr["recoveries"] == 1
              and h["deadline"] == 1 and h["state"] == "closed"
              and rec["fallbacks_by_reason"]["error"] == 5
              and rec["fallbacks_by_reason"]["breaker_open"] == 16
              and rec["encode"]["heads"]["native"] == 0
              and rec["encode"]["heads"]["python"] > 0
              and rec["matcher_degrades"] == 0)
        if self.device.type == "cuda" and pr["launches"] < 1:
            ok = False
        if not ok:
            raise AssertionError(f"the faulted rungs did not trip, hedge and "
                                 f"close as specified: {rec}")
        return rec

    async def broker_fleet(self, name, card, trie, kit, bk, topics,
                           preload) -> dict:
        """The fleet rung on corpus ``name``: every corpus client that
        the rung's publishes reach made a live session of both brokers
        (served in process, ``connect_fleet``), then the publishes through
        both, bypass off, as ``broker_run`` runs them: the fan-out builds
        and writes every matched subscriber's frame on the loop that also
        settles the later batches, and each session's bytes from the card
        broker must equal its bytes from the trie broker."""
        sessions = fleet_sessions(topics, trie.broker.topics.subscribers,
                                  preload)
        t0 = time.perf_counter()
        with collector_paused():
            for side in (card, trie):
                connect_fleet(bk, kit, side, sessions)
        gc.freeze()      # as after the boots: the sessions are long-lived
        log(f"[broker] {name} fleet: {len(sessions)} sessions live on both "
            f"brokers in {time.perf_counter() - t0:.1f} s")
        return await self.broker_run(f"{name} fleet", card, trie, kit,
                                     publish_frames(kit, topics, 45), False)

    async def broker_phase(self, name: str) -> dict:
        """Phase 12 on corpus ``name``: the card broker (``build_matcher``,
        matcher "sig") and the trie broker, both holding the corpus before
        they serve; the compared subscribers connected to both; the card
        engine caught up with their subscriptions; the run with the
        bypass off and the run with it on (fresh topics each: the
        batcher's result cache would answer repeats); where the size table
        names the corpus, the fleet rung; on ``mixed_100k`` the faulted
        rungs; the offline sessions resumed; every stream compared, and
        every match answer of the card broker held against the trie."""
        import io

        from maxmq_tpu_torch.utils.logger import Logger

        kit, bk = port_kit(), broker_kit()
        sz = self.sizes["broker"]
        _f, gen = self.corpus_filters(name)
        n = sz[name]
        topics = {k: gen(n, seed2=4000 + k) for k in (0, 1)}
        traffic = {k: publish_frames(kit, t, 42 + k)
                   for k, t in topics.items()}
        preload = self.corpus_preload(name)
        device = None if self.device.type == "cuda" else "cpu"
        logs = {"card": io.StringIO(), "trie": io.StringIO()}
        out = {"corpus": name, "subscriptions": len(preload)}
        conf = broker_config(bk, "sig")
        # the production deadline, unless the size table widens it (the
        # CPU rehearsal); the tracer samples every TRACE_STRIDE-th publish
        # (its spans split the match from the in-order wait and fan-out)
        conf.matcher_deadline_ms = self.pipeline_supervisor()["deadline_ms"]
        conf.trace_sample_n = TRACE_STRIDE
        t0 = time.perf_counter()
        card = await start_broker(
            bk, conf, preload, True, device,
            Logger(out=logs["card"], fmt="json"), self.count_boot_prewarms)
        out["card_boot_s"] = time.perf_counter() - t0
        sides = [card]
        try:
            out["boot"] = self.boot_state(card, logs["card"])
            t0 = time.perf_counter()
            trie = await start_broker(
                bk, broker_config(bk, "trie"), preload, False, None,
                Logger(out=logs["trie"], fmt="json"))
            sides.append(trie)
            out["trie_boot_s"] = time.perf_counter() - t0
            # the booted brokers' heap frozen, as a broker process's boot
            # compile freezes it (SigEngine._freeze_heap_if_large, once
            # per process growth step: in this process phase 4's engine
            # took that step): full collections from here on walk what
            # the clients and the traffic allocate
            gc.freeze()
            plan = subscriber_plan(kit, sz["clients"], topics[0],
                                   trie.broker.topics.subscribers)
            t0 = time.perf_counter()
            for side in sides:
                await connect_subscribers(kit, side, plan)
            out["subscribe_s"] = time.perf_counter() - t0
            engine = card.broker.matcher.engine
            t0 = time.perf_counter()
            with collector_paused():
                # the engine's background refresh over the clients'
                # subscriptions, awaited before the runs
                await asyncio.get_running_loop().run_in_executor(
                    None, catch_up, engine)
            out["catch_up_s"] = time.perf_counter() - t0
            out["compared_subscribers"] = len(plan)
            out["offline"] = sum(1 for p in plan if p[3])
            log(f"[broker] {name}: {json.dumps(out)}")
            rungs = [("bypass_off", False)]
            if name in sz["bypass_on"]:
                rungs.append(("bypass_on", True))
            for k, (label, bypass) in enumerate(rungs):
                run = await self.broker_run(f"{name} {label}", card, trie,
                                            kit, traffic[k], bypass)
                out[label] = run
                self.check_decoded(f"broker {name} {label}", run["decoded"])
            if name in sz["fleet"]:
                out["fleet"] = await self.broker_fleet(
                    name, card, trie, kit, bk, gen(sz["fleet"][name],
                                                   seed2=4300), preload)
            if name == "mixed_100k":
                out["faults"] = await self.broker_faults(
                    card, trie, kit, publish_frames(
                        kit, gen(sz["faults"], seed2=4200), 44))
            resumed = {}
            for side in sides:
                resumed[side is card] = await resume_offline(side, plan)
            out["resumed_frames"] = streams_equal(
                f"{name} resumed sessions", resumed[True], resumed[False])
            retained = [s.broker.info.retained for s in sides]
            if retained[0] != retained[1] or not retained[0]:
                raise AssertionError(f"retained messages held: {retained}")
            out["retained"] = retained[0]
        except BaseException:
            # what the brokers logged at warn and above, and their
            # overload counters, say why
            for side, buf in logs.items():
                for line in buf.getvalue().splitlines():
                    if '"level": "info"' not in line:
                        log(f"[broker] {name} {side} broker: {line[:400]}")
            for side in sides:
                counts = {k: v for k, v in vars(side.broker.overload).items()
                          if type(v) in (int, float)}
                log(f"[broker] {name} overload: {counts}")
            raise
        finally:
            for side in sides:
                await side.close()
        return out

    async def broker_phases(self) -> dict:
        """Phase 12 on the corpora of the size table (``mixed_100k``, then
        ``iot_1m_share`` with the bypass off only;
        ``scripts/torch_broker_fleet.py`` adds the fleet rung there). It
        runs last:
        each corpus freezes the heap after its brokers boot and no thaw
        follows (a thaw would walk and free the corpus's brokers, 70 s at
        ``iot_1m_share``, for no phase after it)."""
        out = {"threads_at_start": sorted(t.name
                                          for t in threading.enumerate())}
        log(f"[broker] threads at the start: {out['threads_at_start']}")
        corpora = self.sizes["broker"]["corpora"]
        for name in corpora:
            out[name] = await self.broker_phase(name)
        out["launches"] = {f"{n} {label}": out[n][label]["launches"]
                           for n in corpora
                           for label in ("bypass_off", "bypass_on", "fleet")
                           if label in out[n]}
        return out

    # -- phase 15: the broker as production starts it --------------------

    async def started_brokers(self) -> dict:
        """Phase 15: the ``mixed_100k`` corpus as a SQLite store of
        persistent v5 sessions (QoS ``k % 2 + 1``), copied twice; two
        brokers started as production starts them (``python -m
        maxmq_tpu_torch start``): the card broker (``matcher = "sig"``, no
        ``--device``: the card) and the trie broker (``--device cpu``),
        each restoring its copy. The compared subscribers on both, the
        traffic through both (trie broker first) in fenced bursts, every
        subscriber's frames equal; both ``/metrics`` pages with the same
        series apart from the matcher's; SIGTERM, exit 0, and the two
        stores equal record for record (every ``inflight`` record: each
        QoS 1/2 match over the whole corpus). Then the crash rung: the
        card broker restarted with ``crash.at#post_fsync_pre_ack`` armed
        to SIGKILL it mid-stream under PUBACK-paced QoS 1 publishes,
        started once more, every PUBACKed publish found in the inflight
        records of every corpus session the CPU trie names for its topic,
        and a corpus session and a compared subscriber resumed, each
        receiving its queued messages in the store's order."""
        from maxmq_tpu_torch.matching.trie import TopicIndex

        if self.device.type == "cuda":
            import torch

            torch.cuda.empty_cache()    # the child takes the card's memory
        sz = self.sizes["started"]
        name = sz["corpus"]
        kit = port_kit()
        _f, gen = self.corpus_filters(name)
        out = {"corpus": name}
        # the brokers are child processes: what this process allocates here
        # (the corpus's sessions, the stores read back) is bookkeeping, and
        # a full collection over the heap the earlier phases left took 20 s
        with (collector_paused(),
              tempfile.TemporaryDirectory(prefix="maxmq-started-") as work):
            t0 = time.perf_counter()
            subs = [(cid, started_subscription(kit, k, sub))
                    for k, (cid, sub) in enumerate(self.corpus_preload(name))]
            index = TopicIndex()
            for cid, sub in subs:
                index.subscribe(cid, sub)
            topics = gen(sz["publishes"], seed2=4500)
            plan = subscriber_plan(kit, sz["clients"], topics,
                                   index.subscribers)
            sessions = started_sessions(kit, subs, plan)
            base = os.path.join(work, "corpus.db")
            write_corpus_store(base, sessions)
            dbs = {}
            for side in ("card", "trie"):
                dbs[side] = os.path.join(work, f"{side}.db")
                shutil.copyfile(base, dbs[side])
            out["store_write_s"] = time.perf_counter() - t0
            out["subscriptions"] = len({(cid, sub.filter)
                                        for cid, _v, ss in sessions
                                        for sub in ss})
            device = None if self.device.type == "cuda" else "cpu"
            card = StartedBroker("card", work, dbs["card"], "sig", device,
                                 sz["max_batch"])
            trie = StartedBroker("trie", work, dbs["trie"], "trie", "cpu",
                                 sz["max_batch"])
            sides = {"card": BrokerSide(None, card.port),
                     "trie": BrokerSide(None, trie.port)}
            try:
                out.update(await self.started_run(
                    kit, topics, plan, card, trie, sides,
                    out["subscriptions"]))
                for side in sides.values():
                    await close_clients(side)
                await asyncio.gather(*(b.drained(sz["stop_s"])
                                       for b in (card, trie)))
                stops = await asyncio.gather(*(b.stop(sz["stop_s"])
                                               for b in (card, trie)))
                out["stop_s"] = {"card": stops[0], "trie": stops[1]}
                out["stores"] = stores_equal(dbs["card"], dbs["trie"])
                if not out["stores"]["inflight"]:
                    raise AssertionError("no inflight record to compare")
                log(f"[started] stores equal: {json.dumps(out['stores'])} "
                    "records (clients, subscriptions, retained, inflight)")
                if "federation" in self.sizes:
                    # phase 16's nodes boot and converge beside the crash
                    # rung (one card broker's kill and two boots), a
                    # fixed ~40 s of waiting phase 16 would spend alone
                    self.fed_start_early()
                out["crash"] = await self.started_crash(
                    kit, gen, index, card, out["boot_commits"], plan)
            except BaseException:
                for b in (card, trie):
                    if b.log_path:
                        log(f"[started] {b.name} broker log:\n{b.tail()}")
                raise
            finally:
                for side in sides.values():
                    with contextlib.suppress(Exception):
                        await close_clients(side)
                for b in (card, trie):
                    b.kill()
        log(f"[started] {json.dumps(out)}")
        return out

    async def started_run(self, kit, topics, plan, card, trie, sides,
                          n_subs: int) -> dict:
        """Phase 15's two started brokers: boots, traffic, metrics."""
        sz = self.sizes["started"]
        out = {}
        for b in (card, trie):
            b.start()
        boots = {b.name: await b.ready(sz["boot_s"]) for b in (card, trie)}
        for b in (card, trie):
            boot = boots[b.name]
            log(f"[started] {b.name} broker boot: {json.dumps(boot)}")
            if boot["warnings"]:
                raise AssertionError(f"{b.name} broker warned at boot: "
                                     f"{boot['warnings']}")
        if (self.device.type == "cuda"
                and not boots["card"]["device"].startswith("cuda")):
            raise AssertionError(f"the card broker's matcher runs on "
                                 f"{boots['card']['device']}")
        out["boot"] = boots
        first = {b.name: b.scrape() for b in (card, trie)}
        for b in (card, trie):
            held = metric(first[b.name], "maxmq_mqtt_subscriptions")
            if held != n_subs:
                raise AssertionError(f"{b.name} broker restored {held} "
                                     f"subscriptions of {n_subs}")
        out["boot_commits"] = int(metric(first["card"],
                                         "maxmq_storage_commits_total"))
        traffic = publish_frames(kit, topics, 46, publishers=1)
        for b in (trie, card):
            await resume_subscribers(kit, sides[b.name], plan)
        before = card.scrape()
        walls, starts = {}, {}
        for b in (trie, card):
            side = sides[b.name]
            starts[b.name] = {c: len(s.frames) for c, s in side.subs.items()}
            t0 = time.perf_counter()
            await side.bursts(kit, traffic, chunk=sz["burst"])
            walls[b.name] = time.perf_counter() - t0
        frames = streams_equal(
            "started brokers", sides["card"].streams(starts["card"]),
            sides["trie"].streams(starts["trie"]))
        after = {b.name: b.scrape() for b in (card, trie)}
        out.update(self.started_metrics(before, after, frames, walls,
                                        len(topics)))
        out["compared_subscribers"] = len(plan)
        log(f"[started] traffic: {json.dumps(out)}")
        return out

    def started_metrics(self, before: dict, after: dict, frames: int,
                        walls: dict, publishes: int) -> dict:
        """Both ``/metrics`` pages: the same series (names and label
        sets) apart from the matcher's, which only the card broker has;
        the card broker's matcher answered from its engine (batches
        dispatched, no hedge but ``overflow``, no breaker trip, no
        pipeline degrade) and, on the card, launched K1 during the
        traffic and answered at least the size table's ``device_share``
        of the topics; the storage series of both."""
        card, trie = after["card"], after["trie"]
        only_card = {n for n, _l in set(card) - set(trie)}
        stray = sorted({n for n in only_card if not matcher_only(n)}
                       | {n for n, _l in set(trie) - set(card)})
        if stray:
            raise AssertionError(f"the /metrics pages differ beyond the "
                                 f"matcher's series: {stray}")

        def delta(name, **labels):
            return metric(card, name, **labels) - metric(before, name,
                                                         **labels)

        hedges = {lab: v for (n, lab), v in card.items()
                  if n == "maxmq_matcher_fallbacks_total" and v
                  and 'reason="overflow"' not in lab}
        out = {
            "metrics_series": {"card": len(card), "trie": len(trie),
                               "matcher_only": len(set(card) - set(trie))},
            "batches": delta("maxmq_matcher_batches_total"),
            "bypassed_topics": delta("maxmq_matcher_bypassed_topics_total"),
            "received": delta("maxmq_mqtt_messages_received"),
            "k1_launches": delta("maxmq_matcher_kernel_launches_total",
                                 kernel="sig_match_fixed"),
            "device_rtt_ms": metric(card,
                                    "maxmq_matcher_device_rtt_seconds") * 1e3,
            "hedges": hedges,
            "breaker_trips": metric(card, "maxmq_matcher_breaker_trips_total"),
            "degrades": metric(card,
                               "maxmq_broker_publish_trie_degraded_total"),
            "deliveries_compared": frames,
            "wall_s": walls,
            "publishes_per_s": {k: publishes / v for k, v in walls.items()}}
        out["bypass_share"] = out["bypassed_topics"] / max(out["received"],
                                                           1)
        # the topics the card answered: those the batcher neither served
        # from its result cache nor bypassed to the host
        out["cache_hits"] = delta("maxmq_matcher_cache_hits_total")
        out["device_topics"] = (out["received"] - out["bypassed_topics"]
                                - out["cache_hits"])
        out["device_share"] = out["device_topics"] / max(out["received"], 1)
        for side, page in after.items():
            commits = metric(page, "maxmq_storage_commits_total")
            out[f"{side}_storage"] = {
                "commits": commits,
                "barrier_waits": metric(
                    page, "maxmq_storage_barrier_waits_total"),
                "commit_ms_mean": metric(
                    page, "maxmq_storage_commit_seconds_total") * 1e3
                / max(commits, 1),
                "last_commit_ms": metric(
                    page, "maxmq_storage_last_commit_seconds") * 1e3,
                "largest_batch_ops": metric(
                    page, "maxmq_storage_largest_batch_ops"),
                "commit_failures": metric(
                    page, "maxmq_storage_commit_failures_total")}
            if not out[f"{side}_storage"]["barrier_waits"]:
                raise AssertionError(f"{side} broker: no ack waited on the "
                                     "durability barrier")
        if (out["batches"] < 1 or hedges or out["breaker_trips"]
                or out["degrades"]):
            raise AssertionError(f"the card broker's matcher: {out}")
        if self.device.type == "cuda" and (out["k1_launches"] < 1
                                           or not out["device_rtt_ms"]):
            raise AssertionError("the card broker launched no "
                                 f"sig_match_fixed on a publish batch: {out}")
        share = self.sizes["started"]["device_share"]
        if self.device.type == "cuda" and out["device_share"] < share:
            raise AssertionError(f"the card answered {out['device_share']:.1%}"
                                 f" of the card broker's topics (< {share:.0%})"
                                 f": {out}")
        return out

    async def started_crash(self, kit, gen, index, card, boot_commits: int,
                            plan) -> dict:
        """The crash rung of phase 15 on the card broker's store."""
        sz = self.sizes["started"]
        n = sz["crash_publishes"]
        # topics that reach at least one corpus session, so each
        # PUBACK-paced publish costs at least one group commit: the kill
        # lands after ``crash_after`` of them (the boot's own commits and
        # the publisher's session record come first)
        topics = [t for t in gen(8 * n, seed2=4600)
                  if index.subscribers(t).subscriptions][:n]
        skip = boot_commits + 1 + sz["crash_after"]
        t0 = time.perf_counter()
        card.start(f"crash.at#post_fsync_pre_ack:kill:1:0:{skip}")
        out = {"boot": await card.ready(sz["boot_s"]), "skip": skip}
        pub = WireClient(kit, "crash-pub", 4, timeout=30)
        await pub.open(card.port)
        acked = []
        for i, topic in enumerate(topics):
            try:
                await pub.publish(topic, b"crash-%d" % i, qos=1)
            except (ConnectionError, OSError, asyncio.TimeoutError):
                break
            acked.append(i)
        rc = await card.wait(sz["stop_s"])
        with contextlib.suppress(Exception):
            await pub.close()
        out.update(killed_rc=rc, pubacked=len(acked),
                   run_s=time.perf_counter() - t0)
        if rc != -signal.SIGKILL or not 0 < len(acked) < len(topics):
            raise AssertionError(f"the crash point did not kill the card "
                                 f"broker mid-stream: {out}")
        card.start()
        out["restart_boot"] = await card.ready(sz["boot_s"])
        inflight = read_store(card.db, "inflight")
        held = {(r["client_id"], r["payload"]) for r in inflight.values()}
        checked = 0
        for i in acked:
            payload = (b"crash-%d" % i).hex()
            for cid in index.subscribers(topics[i]).subscriptions:
                if (cid, payload) not in held:
                    raise AssertionError(
                        f"PUBACKed publish {i} ({topics[i]}) is not in "
                        f"{cid}'s inflight records")
                checked += 1
        out["records_checked"] = checked
        by_client: dict = {}
        for r in inflight.values():
            by_client.setdefault(r["client_id"], []).append(r)
        corpus_cid = max((c for c in by_client if c.startswith("cl-")),
                         key=lambda c: (len(by_client[c]), c))
        offline = [p for p in plan if p[3] and by_client.get(p[0])]
        if not offline:
            raise AssertionError("no offline compared subscriber has "
                                 "queued messages")
        cid, version, alias_max = offline[0][:3]
        out["resumed"] = {
            corpus_cid: await resume_in_store_order(
                kit, card.port, corpus_cid, 5, 0, by_client[corpus_cid],
                sz["stop_s"]),
            cid: await resume_in_store_order(
                kit, card.port, cid, version, alias_max, by_client[cid],
                sz["stop_s"])}
        out["stop_s"] = await card.stop(sz["stop_s"])
        log(f"[started] crash rung: {json.dumps(out)}")
        return out

    # -- phase 16: the cluster federation ----------------------------------

    async def federation(self) -> dict:
        """Phase 16: two federations of three started brokers on a line
        A - B - C (``FED_LINE``) at the default cluster configuration,
        federated sessions on: the card federation (``matcher = "sig"``,
        no ``--device``) and the trie federation (``--device cpu``).
        ``mixed_100k``'s persistent v5 sessions (QoS ``k % 2 + 1``) split
        by index mod 3 into three SQLite stores with the compared
        subscribers of each node (``fed_plan``: phase 12's plan round
        robin over the nodes, a '#' probe on each), each session with
        its row in its node's session ledger journal, each store copied
        for both federations; ``fed_config`` the only settings off phase
        15's. The six children boot in parallel; the routes and the
        session ledgers' convergence is awaited on each node's
        ``/metrics`` (``fed_converge``); the compared subscribers resume;
        the PUBLISH frames in fenced bursts from A and C, trie federation
        first, every subscriber's frames equal. Then the live takeover
        (``fed_live_takeover``: ``takeovers`` of B's compared subscribers
        to C while B is up) and the restart rung (``federation_run``: B
        stopped, ``takeovers`` of B's corpus sessions taken over at A
        from the dead owner, B restarted on its store, the stale epoch
        flushed, the routes and the ledgers converged again, more
        bursts). On every card node: no hedge, trip or degrade,
        ``sig_match_fixed`` launched during the traffic (B included),
        ``/cluster/metrics`` with every node's series; each node's
        forward and takeover counters equal to its twin's, no takeover
        degraded; after SIGTERM every node's store equal to its twin's
        (its retained and inflight records and its session ledger's
        journal included). In the whole run the nodes were started in
        phase 15's crash rung (``fed_start_early``) and booted and
        converged beside it; alone, the phase starts them itself."""
        pending, self.fed_pending = self.fed_pending, None
        if pending is None:
            st, box = self.fed_prepare(), None
        else:
            st, thread, box = pending
            # the boots' thread ends at the ledgers' convergence or at a
            # failure (the nodes are killed below either way)
            await asyncio.get_running_loop().run_in_executor(
                None, thread.join)
        kit, brokers, feds = st["kit"], st["brokers"], st["feds"]
        out = st["out"]
        out["boot_overlapped"] = box is not None
        try:
            with collector_paused():
                try:
                    if box is None:
                        out.update(await self.fed_boot_converge(st))
                    elif "error" in box:
                        raise box["error"]
                    else:
                        out.update(box["boot"])
                    out.update(await self.federation_run(
                        kit, st["topics"], st["plan"], st["corpus"],
                        brokers, feds, st["dbs"], st["n_sessions"],
                        st["live"], st["dead"]))
                    if "pool" in self.sizes:
                        # the nodes have stopped: phase 17's pools boot
                        # and converge meanwhile, beside the store
                        # comparison and the line in this process (a fixed
                        # ~60 s of waiting phase 17 would spend alone)
                        self.pool_start_early()
                    out["stores"] = {node: stores_equal(
                        st["dbs"]["card", node], st["dbs"]["trie", node],
                        drop_trace, STORE_BUCKETS + SESSION_BUCKETS,
                        links=False)
                        for node in FED_LINE}
                    log(f"[federation] stores equal: "
                        f"{json.dumps(out['stores'])} (clients, "
                        "subscriptions, retained, inflight, the session "
                        "ledger's and the replicas' rows)")
                except BaseException:
                    for b in brokers.values():
                        if b.log_path:
                            log(f"[federation] {b.name} broker log:\n"
                                f"{b.tail()}")
                    raise
                finally:
                    for f in feds.values():
                        with contextlib.suppress(Exception):
                            await f.close()
                    for b in brokers.values():
                        b.kill()
                # in this process, as phase 12 runs: the collector paused
                out["in_process"] = await self.fed_forwarded()
        finally:
            shutil.rmtree(st["work"], ignore_errors=True)
        log(f"[federation] {self.card} {json.dumps(out)}")
        return out

    def fed_prepare(self) -> dict:
        """Phase 16's set-up: the stores (each session with its ledger
        row), the takeovers' sessions, the six nodes (not started yet) in
        a directory of their own, the two ``Federation`` clients. Returns
        the phase's state."""
        from maxmq_tpu_torch.matching.trie import TopicIndex

        if self.device.type == "cuda":
            import torch

            torch.cuda.empty_cache()    # the children take the card
        sz = self.sizes["federation"]
        name = sz["corpus"]
        kit = port_kit()
        _f, gen = self.corpus_filters(name)
        nodes = list(FED_LINE)
        out = {"corpus": name}
        work = tempfile.mkdtemp(prefix="maxmq-fed-")
        try:
            with collector_paused():
                t0 = time.perf_counter()
                subs = [(cid, started_subscription(kit, k, sub))
                        for k, (cid, sub)
                        in enumerate(self.corpus_preload(name))]
                index = TopicIndex()
                for cid, sub in subs:
                    index.subscribe(cid, sub)
                n, tk = sz["publishes"], sz["takeover_publishes"]
                topics = gen(n + tk + sz["rung_publishes"], seed2=4700)
                plan = fed_plan(kit, subscriber_plan(
                    kit, sz["clients"], topics, index.subscribers))
                corpus = {node: subs[i::len(nodes)]
                          for i, node in enumerate(nodes)}
                dbs, n_sessions = {}, 0
                for node in nodes:
                    sessions = started_sessions(
                        kit, corpus[node],
                        [entry for n_, *entry in plan if n_ == node])
                    n_sessions += len(sessions)
                    base = os.path.join(work, f"{node}.db")
                    write_corpus_store(base, sessions, owner=node)
                    for fed in ("trie", "card"):
                        dbs[fed, node] = os.path.join(work,
                                                      f"{fed}-{node}.db")
                        shutil.copyfile(base, dbs[fed, node])
                out["routes_expected"] = fed_local_routes(kit, corpus, plan)
                out["ledger_sessions"] = n_sessions
                out["store_write_s"] = time.perf_counter() - t0
                # the takeovers' sessions: B's first compared subscribers
                # (live, to C), and B's corpus sessions that the traffic
                # before the rung and the rung's both reach (from the dead
                # owner, to A)
                live = [e for e in plan if e[0] == "B"
                        and not e[1].startswith("tcp-probe")
                        ][:sz["takeovers"]]
                before, after = set(), set()
                for t in topics[:n + tk]:
                    before.update(index.subscribers(t).subscriptions)
                for t in topics[n + tk:]:
                    after.update(index.subscribers(t).subscriptions)
                dead = [("B", cid, 5, 0, False, [sub])
                        for cid, sub in corpus["B"]
                        if cid in before and cid in after][:sz["takeovers"]]
                if len(live) < sz["takeovers"] or len(dead) < sz["takeovers"]:
                    raise AssertionError(f"{len(live)} and {len(dead)} "
                                         "sessions to take over from B")
                device = None if self.device.type == "cuda" else "cpu"
                brokers = {}
                for fed in ("trie", "card"):
                    for node in nodes:
                        brokers[fed, node] = StartedBroker(
                            f"{fed}-{node}", work, dbs[fed, node],
                            "sig" if fed == "card" else "trie",
                            device if fed == "card" else "cpu",
                            sz["max_batch"])
                    ports = {n_: brokers[fed, n_].port for n_ in nodes}
                    for node in nodes:
                        brokers[fed, node].add_config(fed_config(node,
                                                                 ports))
                feds = {fed: Federation({n_: brokers[fed, n_].port
                                         for n_ in nodes})
                        for fed in ("trie", "card")}
        except BaseException:
            shutil.rmtree(work, ignore_errors=True)
            raise
        return {"kit": kit, "work": work, "out": out, "topics": topics,
                "plan": plan, "corpus": corpus, "dbs": dbs,
                "n_sessions": n_sessions, "live": live, "dead": dead,
                "brokers": brokers, "feds": feds}

    async def fed_boot_converge(self, st) -> dict:
        """The six nodes of ``st`` started at once, their boots, and the
        routes' and the session ledgers' convergence."""
        brokers = st["brokers"]
        out = {"boot": await self.fed_boot(brokers, list(brokers))}
        log(f"[federation] boots: {self.card} {json.dumps(out['boot'])}")
        out["converge"] = await self.fed_converge(
            brokers, fed_local_routes(st["kit"], st["corpus"], st["plan"]),
            dict.fromkeys(st["feds"], st["n_sessions"]))
        log(f"[federation] converged after the boots: {self.card} "
            f"routes {out['converge']['converge_s']:.2f} s, ledgers "
            f"{out['converge']['ledger_s']:.2f} s")
        return out

    def fed_start_early(self) -> None:
        """Phase 16's set-up, and its nodes' boots and convergence beside
        what the caller does next (``boot_beside``); ``federation`` takes
        them over."""
        st = self.fed_prepare()
        self.fed_pending = (st, *boot_beside(self.fed_boot_converge, st))

    def fed_abort(self) -> None:
        """Kill the nodes ``fed_start_early`` started where phase 16 never
        took them over (an earlier failure)."""
        pending, self.fed_pending = self.fed_pending, None
        if pending is not None:
            abort_early(pending, pending[0]["brokers"].values())

    async def fed_forwarded(self) -> dict:
        """The line in this process (``fed_in_process``, sized by the size
        table's ``in_process``: a ``build_corpus`` of ``subs`` split in
        three, ``clients`` compared subscribers, ``publishes`` in bursts
        of ``burst``): every node a port broker with its ``build_matcher``
        sig stack on the card, against the same line on its tries, the
        batchers' host bypass off, so the card answers every topic a card
        node matches, the publishes forwarded to it included. Every
        subscriber's frames, each node's forward counters and retained
        set equal; on each card node batches formed, no topic bypassed
        and no shadow probe, no hedge or trip, and at least
        ``device_share`` of its matched topics answered on the device
        (less cache hits and the engine's host paths); on the card, K1
        launched at least once for each batch."""
        from maxmq_tpu_torch import cluster

        sz = self.sizes["federation"]
        ip = sz["in_process"]
        bk = broker_kit()
        device = None if self.device.type == "cuda" else "cpu"
        runs, walls = {}, {}
        for fed, spec in (("trie", (bk, cluster, None, None)),
                          ("card", (bk, cluster, "sig", device))):
            t0 = time.perf_counter()
            runs[fed] = await fed_in_process(
                FED_LINE, dict.fromkeys(FED_LINE, spec), 42,
                FED_PUBLISHER_NODES, n_subs=ip["subs"],
                publishes=ip["publishes"], burst=ip["burst"],
                clients=ip["clients"], takeover=("B", "C", ip["takeovers"]))
            walls[fed] = time.perf_counter() - t0
        card, trie = runs["card"], runs["trie"]
        tk = card["takeover"]
        out = {"deliveries_compared": streams_equal(
                   "federation in process", card["frames"], trie["frames"]),
               "taken_over_frames": sum(
                   len(card["frames"][c.split("@")[0]])
                   for c in card["frames"] if "@" in c),
               "wall_s": walls, "k1_launches": card["k1_launches"],
               "nodes": card["matchers"], "takeover": tk}
        for key in ("forwards", "retained", "expected_routes"):
            if card[key] != trie[key]:
                raise AssertionError(f"federation in process: {key} "
                                     f"{card[key]} vs {trie[key]}")
        for run in (card["matchers"], tk["matchers"]):
            for c in run.values():
                c["device_share"] = ((c["batched_topics"]
                                      - c["bypassed_topics"]
                                      - c["engine_host_topics"])
                                     / max(c["batched_topics"]
                                           + c["cache_hits"], 1))
        log(f"[federation] in process, bypass off: {self.card} "
            f"{json.dumps(out)}")
        sessions = {f: {n: {k: v for k, v in c.items()
                            if k in ("takeovers", "takeovers_degraded",
                                     "digest_mismatches", "restore_errors",
                                     "sync_faults")}
                        for n, c in runs[f]["takeover"]["sessions"].items()}
                    for f in runs}
        if (sessions["card"] != sessions["trie"]
                or sum(c["takeovers"] for c in sessions["card"].values())
                != ip["takeovers"]
                or any(c["takeovers_degraded"] or c["digest_mismatches"]
                       or c["restore_errors"] or c["sync_faults"]
                       for c in sessions["card"].values())):
            raise AssertionError(f"federation in process: the takeovers' "
                                 f"session counters {sessions}")
        for what, run in (("", card["matchers"]),
                          (" after the takeover", tk["matchers"])):
            for node, c in run.items():
                hedges = sum(v for k, v in c.items()
                             if k.startswith("hedges_"))
                if (c["batches"] < 1 or c["bypassed_topics"]
                        or c["shadow_probes"] or hedges or c["breaker_trips"]
                        or c["device_share"] < sz["device_share"]):
                    raise AssertionError(f"federation in process{what}: "
                                         f"card node {node}'s matcher: {c}")
        # the new owner's served batches after the takeover came from
        # K1, as every batch of the run: one launch per batch at least
        for what, k1, run in (("", card["k1_launches"], card["matchers"]),
                              (" after the takeover", tk["k1_launches"],
                               tk["matchers"])):
            batches = sum(c["batches"] for c in run.values())
            if self.device.type == "cuda" and k1 < batches:
                raise AssertionError(
                    f"federation in process{what}: {k1} K1 launches for "
                    f"{batches} batches: {out}")
        return out

    async def fed_boot(self, brokers: dict, which) -> dict:
        """Start the brokers ``which`` at once; their boots (as
        ``StartedBroker.ready``), none warning, every card node's matcher
        on a CUDA device on the card."""
        sz = self.sizes["federation"]
        for k in which:
            brokers[k].start()
        boots = await asyncio.gather(*(brokers[k].ready(sz["boot_s"])
                                       for k in which))
        out = {}
        for k, boot in zip(which, boots):
            if boot["warnings"]:
                raise AssertionError(f"{brokers[k].name} warned at boot: "
                                     f"{boot['warnings']}")
            if (self.device.type == "cuda" and k[0] == "card"
                    and not boot["device"].startswith("cuda")):
                raise AssertionError(f"{brokers[k].name}'s matcher runs on "
                                     f"{boot['device']}")
            out[brokers[k].name] = boot
        return out

    async def fed_converge(self, brokers: dict, expected: dict,
                           ledgers: dict | None = None,
                           acks0: dict | None = None) -> dict:
        """Wait until every node of both federations has each link up and
        holds the routes its peers advertise (``expected``, from
        ``fed_routes``), read from its ``/metrics``; with ``ledgers``
        (federation -> sessions), also until every node's session ledger
        holds that federation's sessions and every node's peers have
        acknowledged its resync (its replication acks since ``acks0``,
        node -> acks at the mark, at least its owned sessions times its
        links). Returns the seconds until the routes and until the
        ledgers converged, and the routes held."""
        sz = self.sizes["federation"]
        t0 = time.perf_counter()
        deadline = time.monotonic() + sz["converge_s"]
        routes_s = ledger_s = None
        shown = time.monotonic()
        while True:
            held = {fed: {} for fed, _n in brokers}
            ledger = {fed: {} for fed, _n in brokers}
            for (fed, node), b in brokers.items():
                page = b.scrape()
                held[fed][node] = [metric(page, "maxmq_cluster_routes_held"),
                                   metric(page, "maxmq_cluster_links_up")]
                acks = (metric(page, "maxmq_cluster_session_sync_acks_total")
                        - (acks0 or {}).get((fed, node), 0))
                ledger[fed][node] = [
                    metric(page, "maxmq_cluster_session_ledger"),
                    acks >= metric(page, "maxmq_cluster_session_local")
                    * len(FED_LINE[node])]
            if routes_s is None and all(fed_converged(h, expected)
                                        for h in held.values()):
                routes_s = time.perf_counter() - t0
            if ledger_s is None and (ledgers is None or all(
                    v == [ledgers[fed], True]
                    for fed, nodes in ledger.items()
                    for v in nodes.values())):
                ledger_s = time.perf_counter() - t0
            if routes_s is not None and ledger_s is not None:
                return {"converge_s": routes_s, "ledger_s": ledger_s,
                        "routes_held": held}
            if time.monotonic() - shown > 10:
                shown = time.monotonic()
                log(f"[federation] converging, {time.perf_counter() - t0:.1f}"
                    f" s: [ledger, resync acked] {json.dumps(ledger)}")
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"the federations did not converge in "
                    f"{sz['converge_s']} s: [routes held, links up] "
                    f"{held}, routes expected {expected}; [ledger, resync "
                    f"acked] {ledger}, sessions expected {ledgers}")
            await asyncio.sleep(0.1)

    async def fed_traffic(self, kit, feds: dict, brokers: dict, traffic,
                          what: str, launched: bool = True,
                          burst: int | None = None) -> dict:
        """``traffic`` through the trie federation, then the card one;
        every subscriber's frames equal (without the ``mq-trace``
        property); each node's forward counters equal its twin's; on each
        card node no hedge, trip or degrade and, where ``launched``, K1
        launched (the takeover rung's two short runs of 128 publishes may
        leave a node's every batch to the host bypass; ``burst``, the
        frames a fence ends, by default the size table's). Recorded, not
        held: each card node's launches that served publishes (less the
        shadow probes), the share of its matched topics the card answered
        (the host bypass serves the rest), and both federations' sampled
        latencies (``fed_latency``)."""
        sz = self.sizes["federation"]
        before = {k: b.scrape() for k, b in brokers.items()}
        walls, starts = {}, {}
        for fed in ("trie", "card"):
            starts[fed] = feds[fed].marks()
            t0 = time.perf_counter()
            await feds[fed].bursts(kit, traffic, burst or sz["burst"])
            walls[fed] = time.perf_counter() - t0
        frames = streams_equal(
            f"federation {what}",
            feds["card"].streams(starts["card"], untraced=True),
            feds["trie"].streams(starts["trie"], untraced=True))
        after = {k: b.scrape() for k, b in brokers.items()}
        out = {"deliveries_compared": frames, "wall_s": walls,
               "deliveries_per_s": {f: frames / w for f, w in walls.items()},
               "nodes": {}}
        for node in FED_LINE:
            card, trie = after["card", node], after["trie", node]
            fwd = {f: [metric(p, f"maxmq_cluster_{f}_total")
                       - metric(before[k, node], f"maxmq_cluster_{f}_total")
                       for k, p in (("card", card), ("trie", trie))]
                   for f in FED_FORWARDS}
            if any(c != t for c, t in fwd.values()):
                raise AssertionError(f"federation {what}: node {node}'s "
                                     f"forward counters [card, trie]: {fwd}")
            hedges = {lab: v for (n, lab), v in card.items()
                      if n == "maxmq_matcher_fallbacks_total" and v
                      and 'reason="overflow"' not in lab}

            def delta(name, **labels):
                return (metric(card, name, **labels)
                        - metric(before["card", node], name, **labels))

            rec = {
                "forwards": {f: v[0] for f, v in fwd.items()},
                "k1_launches": delta("maxmq_matcher_kernel_launches_total",
                                     kernel="sig_match_fixed"),
                "shadow_probes": delta("maxmq_matcher_shadow_probes_total"),
                "batches": delta("maxmq_matcher_batches_total"),
                "batched_topics": delta("maxmq_matcher_batched_topics_total"),
                "bypassed_topics": delta(
                    "maxmq_matcher_bypassed_topics_total"),
                "cache_hits": delta("maxmq_matcher_cache_hits_total"),
                "hedges": hedges,
                "breaker_trips": metric(card,
                                        "maxmq_matcher_breaker_trips_total"),
                "degrades": metric(card,
                                   "maxmq_broker_publish_trie_degraded_total"),
                # the node's garbage collections over the run: seconds
                # paused and full collections; its journal's largest
                # group commit; the hedges it had before the run
                "gc_paused_s": delta("maxmq_matcher_gc_paused_seconds_total"),
                "gc_full": delta("maxmq_matcher_gc_full_collections_total"),
                "journal_largest_batch": metric(
                    card, "maxmq_storage_largest_batch_ops"),
                "hedges_before": {lab: v for (n, lab), v
                                  in before["card", node].items()
                                  if n == "maxmq_matcher_fallbacks_total"
                                  and v and 'reason="overflow"' not in lab},
                # the batcher's device round trip (its EWMA), which the
                # bypass holds the host's cost against
                "device_rtt_ms": metric(
                    card, "maxmq_matcher_device_rtt_seconds") * 1e3,
                "link_rtt_ms": {lab: v for (n, lab), v in card.items()
                                if n == "maxmq_cluster_peer_rtt_ms"},
                "latency_ms": {fed: fed_latency(after[fed, node],
                                                before[fed, node])
                               for fed in ("card", "trie")}}
            # K1's launches less the shadow probes (one launch each at
            # most, answers dropped): the launches that served publishes;
            # the share of the topics matched that the card answered
            rec["served_launches"] = rec["k1_launches"] - rec["shadow_probes"]
            rec["device_share"] = ((rec["batched_topics"]
                                    - rec["bypassed_topics"])
                                   / max(rec["batched_topics"]
                                         + rec["cache_hits"], 1))
            if rec["hedges"] or rec["breaker_trips"] or rec["degrades"]:
                raise AssertionError(f"federation {what}: card node {node}'s "
                                     f"matcher: {rec}")
            if (launched and self.device.type == "cuda"
                    and rec["k1_launches"] < 1):
                raise AssertionError(f"federation {what}: card node {node} "
                                     f"launched no sig_match_fixed: {rec}")
            out["nodes"][node] = rec
        log(f"[federation] {what}: {self.card} {json.dumps(out)}")
        return out

    async def fed_telemetry(self, brokers: dict) -> dict:
        """Every card node's ``/cluster/metrics`` holds every node's
        series (its own and its peers' gossiped snapshots), waited for
        up to two telemetry intervals."""
        sz = self.sizes["federation"]
        deadline = time.monotonic() + sz["telemetry_s"]
        while True:
            nodes = {}
            for node in FED_LINE:
                page = brokers["card", node].scrape("/cluster/metrics")
                nodes[node] = sorted({lab for (n, lab) in page
                                      if n == "maxmq_mqtt_messages_received"})
            want = sorted(f'node="{n}"' for n in FED_LINE)
            if all(v == want for v in nodes.values()):
                return nodes
            if time.monotonic() > deadline:
                raise AssertionError(f"/cluster/metrics of the card nodes: "
                                     f"{nodes}")
            await asyncio.sleep(0.2)

    def fed_sessions(self, pages: dict, what: str) -> dict:
        """Each node's session counters (``FED_SESSION_COUNTERS`` and the
        replication's ops, flushes and acks) on ``pages`` ((federation,
        node) -> ``/metrics``): the takeovers equal between the twins;
        none degraded, no digest mismatch, restore error or sync fault.
        Returns the card nodes' counters."""
        out = {}
        for node in FED_LINE:
            got = {fed: {k: metric(pages[fed, node],
                                   f"maxmq_cluster_session_{k}_total")
                         for k in (*FED_SESSION_COUNTERS, "sync_ops",
                                   "sync_flushes", "sync_acks")}
                   for fed in ("card", "trie")}
            card, trie = got["card"], got["trie"]
            if (card["takeovers"] != trie["takeovers"]
                    or any(c[k] for c in (card, trie)
                           for k in ("takeovers_degraded",
                                     "digest_mismatches", "restore_errors",
                                     "sync_faults"))):
                raise AssertionError(f"federation {what}: node {node}'s "
                                     f"session counters {got}")
            out[node] = card
        return out

    async def fed_replicas(self, dbs: dict, cids) -> float:
        """Wait until, in both federations, A's and C's replicas of B's
        sessions ``cids`` agree with B's own window, read from the three
        stores: each replica's digest (``cluster_sessions``) and inflight
        rows (``cluster_inflight``) those of B's ``inflight`` rows (the
        predicate the reference's split-brain scenario awaits, on the
        journals); returns the seconds it took."""
        sz = self.sizes["federation"]
        t0 = time.perf_counter()
        deadline = time.monotonic() + sz["converge_s"]
        while True:
            bad = []
            for fed in ("trie", "card"):
                live: dict = {cid: set() for cid in cids}
                for key in read_store(dbs[fed, "B"], "inflight"):
                    cid, _, pid = key.rpartition("|")
                    if cid in live:
                        live[cid].add(int(pid))
                for node in ("A", "C"):
                    ledger = read_store(dbs[fed, node], "cluster_sessions")
                    rows: dict = {cid: set() for cid in cids}
                    for key in read_store(dbs[fed, node],
                                          "cluster_inflight"):
                        cid, _, pid = key.rpartition("|")
                        if cid in rows and not pid.startswith("r"):
                            rows[cid].add(int(pid))
                    for cid, pids in live.items():
                        x = 0
                        for pid in pids:
                            x ^= pid
                        if (ledger.get(cid, {}).get("dig") != [len(pids), x]
                                or rows[cid] != pids):
                            bad.append((fed, node, cid))
            if not bad:
                return time.perf_counter() - t0
            if time.monotonic() > deadline:
                raise AssertionError(f"replicas of B's sessions not "
                                     f"converged: {bad[:8]}")
            await asyncio.sleep(0.1)

    def settle_topic(self) -> str:
        """A topic not published before in this run (no cached answer)."""
        self.settles = getattr(self, "settles", 0) + 1
        return f"settle/{self.settles}"

    async def fed_publish_once(self, kit, feds: dict) -> None:
        """One QoS 0 publish to a ``settle_topic`` in each federation from
        its first publisher, awaited at every '#' probe (every node
        matched it)."""
        topic = self.settle_topic()
        for f in feds.values():
            probes = [c for side in f.sides.values()
                      for cid, c in side.subs.items()
                      if cid.startswith("tcp-probe-")]
            marks = [len(c.frames) for c in probes]
            pub = next(p for side in f.sides.values()
                       for p in side.pubs.values())
            pub.send([pub.packet(kit.PT.PUBLISH, topic=topic,
                                 payload=b"settle").encode()])
            await asyncio.gather(*(c.until(lambda c=c, n=n:
                                           len(c.frames) > n)
                                   for c, n in zip(probes, marks)))

    async def fed_seed(self, kit, feds: dict, brokers: dict,
                       node: str) -> None:
        """A restarted node's first match at once, before its peers' links
        come back: a QoS 1 publish to a ``settle_topic`` from a publisher
        on ``node`` (``settle-<node>``) in each federation, one at a time,
        until the card node's batcher holds a device round-trip estimate
        (``/metrics`` ``maxmq_matcher_device_rtt_seconds`` above 0: its
        second batch; the first sample is discarded). A fresh batcher
        sends its batches to the card until then; one sent while the
        engine's refresh runs (after a resync moved sessions away)
        hedges (F25)."""
        for _ in range(8):
            if metric(brokers["card", node].scrape(),
                      "maxmq_matcher_device_rtt_seconds"):
                return
            topic = self.settle_topic()
            for f in feds.values():
                pub = await f.sides[node].publisher(kit, f"settle-{node}")
                await pub.publish(topic, b"seed", qos=1)
        raise AssertionError(f"card node {node}'s batcher holds no device "
                             "round trip after 8 publishes")

    async def fed_settle(self, kit, feds: dict, brokers: dict) -> dict:
        """After a takeover or a restart, before the traffic: let every
        card node's engine catch up with the subscriptions that the
        takeovers installed or evicted while no traffic runs. An engine
        refreshes at its next match (``OverlayedEngine.overlay_for``), in
        the background, and a node matched while its refresh and re-warm
        run answers late (deadline hedges). So, in rounds: while a card
        node is behind its index (``/metrics``
        ``maxmq_matcher_tables_behind``) and none is refreshing
        (``maxmq_matcher_refreshing``), one QoS 0 publish to a topic not
        sent before (``settle/<n>``: no cached answer) from each
        federation's first publisher, which the '#' probes route to
        every node, awaited at every probe (no fence: a second publish
        would be matched while the first one's refresh runs; a node's
        batcher may answer one topic from the trie, and its shadow
        probe, every 64 bypassed batches, reaches the engine); while one
        is refreshing, nothing. Last, every node's journal drained
        (``maxmq_storage_queue_depth`` 0: the resync's replica rows
        committed). Returns the seconds and the rounds."""
        sz = self.sizes["federation"]
        t0 = time.perf_counter()
        deadline = time.monotonic() + sz["converge_s"]
        rounds = 0
        while True:
            behind, refreshing, journal, hedged = {}, {}, {}, {}
            for (fed, node), b in brokers.items():
                page = b.scrape()
                journal[fed, node] = metric(page, "maxmq_storage_queue_depth")
                if fed == "card":
                    behind[node] = metric(page, "maxmq_matcher_tables_behind")
                    refreshing[node] = metric(page,
                                              "maxmq_matcher_refreshing")
                    hedged[node] = metric(page,
                                          "maxmq_matcher_fallbacks_total",
                                          reason="deadline")
            if not any(behind.values()) and not any(refreshing.values()):
                if not any(journal.values()):
                    return {"s": time.perf_counter() - t0, "rounds": rounds}
            if time.monotonic() > deadline:
                raise AssertionError(f"card nodes' engines behind "
                                     f"{behind}, refreshing {refreshing}, "
                                     f"deadline hedges {hedged}; journal "
                                     f"ops queued {journal}")
            if any(refreshing.values()) or not any(behind.values()):
                await asyncio.sleep(0.1)
                continue
            rounds += 1
            await self.fed_publish_once(kit, feds)

    async def fed_arrivals(self, kit, feds: dict, entries, dst: str,
                           subscribe=()) -> dict:
        """``Federation.arrive`` of ``entries`` at ``dst`` in the trie
        federation, then the card one; each client then pings, so its
        resent window has arrived. The frames each taken-over client
        got at its new owner (the resent inflight, packet ids and DUP
        flags as sent; a v5 frame without its ``mq-trace`` property, F20)
        equal between the federations; returns how many and the seconds
        each federation's arrivals took."""
        got, walls = {}, {}
        for fed in ("trie", "card"):
            t0 = time.perf_counter()
            await feds[fed].arrive(kit, entries, dst, STARTED_EXPIRY,
                                   subscribe)
            side = feds[fed].sides[dst]
            await asyncio.gather(*(side.subs[e[1]].ping() for e in entries))
            walls[fed] = time.perf_counter() - t0
            got[fed] = {e[1]: [without_trace(fr) if e[2] == 5 else fr
                               for fr in side.subs[e[1]].frames]
                        for e in entries}
        return {"resent_compared": streams_equal(
                    f"federation takeovers at {dst}", got["card"],
                    got["trie"]),
                "arrive_s": walls}

    async def federation_run(self, kit, topics, plan, corpus, brokers,
                             feds, dbs, n_sessions: int, live,
                             dead) -> dict:
        """Phase 16's two federations once booted and converged
        (``fed_boot_converge``): traffic, the live takeover, the restart
        of B with the dead-owner takeover, stops."""
        sz = self.sizes["federation"]
        n, tk = sz["publishes"], sz["takeover_publishes"]
        out = {}
        t0 = time.perf_counter()
        for f in feds.values():
            await f.resume(kit, plan)
        out["traffic"] = await self.fed_traffic(
            kit, feds, brokers, publish_frames(kit, topics[:n], 47,
                                               publishers=2), "traffic")
        out["telemetry"] = await self.fed_telemetry(brokers)
        # the live takeover: B's subscribers leave it, half the rung's
        # publishes park at B for them, they reconnect at C (B pulled
        # for their fresh state), the routes follow, the other half
        t1 = time.perf_counter()
        frames, owners = publish_frames(kit, topics[n:n + tk], 49,
                                        publishers=2)
        half = len(frames) // 2
        for f in feds.values():
            await f.leave(live)
        out["takeover"] = {"parked": await self.fed_traffic(
            kit, feds, brokers, (frames[:half], owners[:half]),
            "while B's subscribers are away", launched=False)}
        out["takeover"].update(await self.fed_arrivals(kit, feds, live, "C"))
        plan = [("C" if e in live else e[0], *e[1:]) for e in plan]
        out["takeover"]["converge"] = await self.fed_converge(
            brokers, fed_local_routes(kit, corpus, plan))
        out["takeover"]["settle"] = await self.fed_settle(
            kit, feds, brokers)
        out["takeover"]["traffic"] = await self.fed_traffic(
            kit, feds, brokers, (frames[half:], owners[half:]),
            "after the live takeover", launched=False)
        pages = {k: b.scrape() for k, b in brokers.items()}
        out["takeover"]["sessions"] = self.fed_sessions(
            pages, "after the live takeover")
        out["takeover"]["s"] = time.perf_counter() - t1
        # the rung: B stopped in both federations once its corpus
        # sessions' replicas converged; those sessions taken over at A
        # from the dead owner; B restarted
        t1 = time.perf_counter()
        for fed, f in feds.items():
            await f.close(nodes=("B",))
        await asyncio.gather(*(brokers[fed, "B"].drained(
            sz["stop_s"], keep=len(FED_LINE["B"])) for fed in feds))
        replicas_s = await self.fed_replicas(dbs, [e[1] for e in dead])
        marks = {k: b.scrape() for k, b in brokers.items()}
        stops = await asyncio.gather(*(brokers[fed, "B"].stop(sz["stop_s"])
                                       for fed in feds))
        out["rung"] = {"replicas_s": replicas_s,
                       "stop_s": dict(zip(feds, stops))}
        out["rung"]["takeover"] = await self.fed_arrivals(
            kit, feds, dead, "A", [kit.Subscription(filter=FENCE_TOPIC)])
        corpus = dict(corpus, A=corpus["A"] + [(e[1], e[5][0]) for e in dead],
                      B=[c for c in corpus["B"]
                         if c[0] not in {e[1] for e in dead}])
        out["rung"]["boot"] = await self.fed_boot(
            brokers, [(fed, "B") for fed in feds])
        # B's first match before A's link (in its reconnect backoff)
        # brings the resync that evicts the sessions taken over at A
        await self.fed_seed(kit, feds, brokers, "B")
        acks0 = {(fed, node): metric(marks[fed, node],
                                     "maxmq_cluster_session_sync_acks_total")
                 for fed in feds for node in ("A", "C")}
        out["rung"]["converge"] = await self.fed_converge(
            brokers, fed_local_routes(kit, corpus, plan),
            {fed: n_sessions + sum(len(side.pubs)
                                   for side in f.sides.values())
             for fed, f in feds.items()}, acks0)
        log(f"[federation] converged after B's restart: {self.card} "
            f"routes {out['rung']['converge']['converge_s']:.2f} s, ledgers "
            f"{out['rung']['converge']['ledger_s']:.2f} s")
        # B came back as a new incarnation (its boot epoch bumped), and
        # its peers replaced the old one's routes with its fresh snapshot
        for (fed, node), b in brokers.items():
            page = b.scrape()
            name, why = (("maxmq_storage_boot_epoch", "boot epoch")
                          if node == "B" else
                          ("maxmq_cluster_snapshots_applied_total",
                           "snapshots applied"))
            if not metric(page, name) > metric(marks[fed, node], name):
                raise AssertionError(f"{b.name}'s {why} did not grow over "
                                     "B's restart")
        for f in feds.values():
            await f.resume(kit, plan, nodes=("B",))
        out["rung"]["settle"] = await self.fed_settle(kit, feds, brokers)
        out["rung"]["restart_s"] = time.perf_counter() - t1
        # in fenced bursts of ``rung_burst``: every publish reaches every
        # node (the '#' probes), so each node forms a batch a burst at
        # least; with the bypass on, K1 launches on a node's shadow probe,
        # one every 64 bypassed batches, and 512 publishes in bursts of 512
        # can leave a node fewer than 64 batches (replication's work per
        # delivery coalesces more of them)
        out["rung"]["traffic"] = await self.fed_traffic(
            kit, feds, brokers, publish_frames(kit, topics[n + tk:], 48,
                                               publishers=2),
            "after B's restart", burst=sz["rung_burst"])
        for f in feds.values():
            await f.close()
        await asyncio.gather(*(b.drained(sz["stop_s"], keep=len(FED_LINE[k[1]]))
                               for k, b in brokers.items()))
        pages = {k: b.scrape() for k, b in brokers.items()}
        out["sessions"] = self.fed_sessions(pages, "at the end")
        out["takeovers"] = {
            "live": out["takeover"]["sessions"]["C"]["takeovers"],
            "dead_owner": out["sessions"]["A"]["takeovers"]}
        if sum(c["takeovers"] for c in out["sessions"].values()) \
                != 2 * sz["takeovers"]:
            raise AssertionError(f"federation: takeovers "
                                 f"{out['sessions']}, want "
                                 f"{2 * sz['takeovers']}")
        out["takeover_ms"] = {
            node: hist_quantiles(pages["card", node], {},
                                 "maxmq_broker_publish_stage_seconds",
                                 qs=(0.5, 1.0), stage="takeover")
            for node in ("A", "C")}
        log(f"[federation] sessions: {self.card} takeovers "
            f"{json.dumps(out['takeovers'])}, takeover p50/max ms "
            f"{json.dumps(out['takeover_ms'])}, per node "
            f"{json.dumps(out['sessions'])}")
        stops = await asyncio.gather(*(b.stop(sz["stop_s"])
                                       for b in brokers.values()))
        out["stop_s"] = {b.name: s for b, s in zip(brokers.values(), stops)}
        out["phase_s"] = time.perf_counter() - t0
        return out

    # -- phase 14: the rest of the signature engine's device surface -----

    # -- phase 17: the worker pool -----------------------------------------

    async def worker_pool(self) -> dict:
        """Phase 17: phase 15's store (``mixed_100k`` as persistent v5
        sessions and the compared subscribers'), copied twice; two pools
        started as production starts them (``python -m maxmq_tpu_torch
        start`` with ``workers = 2``, booted at once): the card pool
        (``matcher = "sig"``, no ``--device``: its parent's sidecar on the
        card) and the trie pool (``--device cpu``), each restoring its
        copy at w0. The ledgers' and routes' convergence, the compared
        subscribers resumed through the one port (wherever SO_REUSEPORT
        places them), the sidecar's tables caught up, phase 15's traffic
        from a publisher on each worker in fenced bursts, trie pool first:
        every subscriber's frames equal; the sidecar's answers on the
        traffic's topics equal to the CPU trie's; the singletons, the
        card's holders, the counts; SIGTERM and the stores equal. In the
        whole run the pools were started at the end of phase 16
        (``pool_start_early``) and their boots and w1's ledger ran beside
        its store comparison and its line in this process; alone, the
        phase starts them itself."""
        pending, self.pool_pending = self.pool_pending, None
        t0 = time.perf_counter()
        if pending is None:
            st, box = self.pool_prepare(), None
        else:
            st, thread, box = pending
            # the boot's thread ends at the ledger's convergence or at a
            # failure (the pools are killed below either way)
            await asyncio.get_running_loop().run_in_executor(
                None, thread.join)
        sz = self.sizes["pool"]
        kit = st["kit"]
        out = st["out"]
        out["boot_overlapped"] = box is not None
        card, trie = pools = st["pools"]
        sides = {p.name: BrokerSide(None, p.port) for p in pools}
        try:
            with collector_paused():
                if box is None:
                    out.update(await self.pool_boot(st))
                elif "error" in box:
                    raise box["error"]
                else:
                    out.update(box["boot"])
                out["boot_wait_s"] = time.perf_counter() - t0
                out.update(await self.pool_run(
                    kit, st["topics"], st["plan"], st["sessions"],
                    st["index"], card, trie, sides))
                for side in sides.values():
                    await close_clients(side)
                # w0's connections but the sibling's bridge link
                await asyncio.gather(*(p.drained(sz["stop_s"],
                                                 keep=POOL_WORKERS - 1)
                                       for p in pools))
                stops = await asyncio.gather(*(p.stop(sz["stop_s"])
                                               for p in pools))
                out["stop_s"] = {p.name: t for p, t in zip(pools, stops)}
                out["worker_counts"] = {p.name: p.worker_counts()
                                        for p in pools}
                for p in pools:
                    for node, c in out["worker_counts"][p.name].items():
                        if (c["breaker_trips"] or c["degrades"]
                                or c["launches"] or any(
                                    c["fallbacks"].get(r) for r in (
                                        "error", "deadline",
                                        "breaker_open"))):
                            raise AssertionError(
                                f"{p.name} pool's {node}: {c}")
                out["stores"] = stores_equal(
                    st["dbs"]["card"], st["dbs"]["trie"], normal=pool_record,
                    buckets=STORE_BUCKETS + SESSION_BUCKETS, links=False)
                if not out["stores"]["inflight"]:
                    raise AssertionError("no inflight record to compare")
                log(f"[pool] stores equal: {json.dumps(out['stores'])} "
                    "records (clients, subscriptions, retained, inflight, "
                    "ledger, replica inflight)")
        except BaseException:
            for p in pools:
                if p.log_path:
                    log(f"[pool] {p.name} pool log:\n{p.tail(8000)}")
            raise
        finally:
            for side in sides.values():
                with contextlib.suppress(Exception):
                    await close_clients(side)
            for p in pools:
                p.kill()
            shutil.rmtree(st["work"], ignore_errors=True)
        log(f"[pool] {json.dumps(out)}")
        return out

    def pool_prepare(self) -> dict:
        """Phase 17's set-up: phase 15's topics, compared subscribers and
        store, each session with its ledger row as w0, the journal owner,
        writes it (a store without them: F28), copied for the two pools
        (not started yet) in a directory of their own. Returns the
        phase's state."""
        from maxmq_tpu_torch.matching.trie import TopicIndex

        if self.device.type == "cuda":
            import torch

            torch.cuda.empty_cache()    # the sidecar takes the card's memory
        sz = self.sizes["pool"]
        name = sz["corpus"]
        kit = port_kit()
        _f, gen = self.corpus_filters(name)
        work = tempfile.mkdtemp(prefix="maxmq-pool-")
        st = {"kit": kit, "work": work, "out": {"corpus": name}}
        try:
            with collector_paused():
                t0 = time.perf_counter()
                subs = [(cid, started_subscription(kit, k, sub))
                        for k, (cid, sub)
                        in enumerate(self.corpus_preload(name))]
                index = TopicIndex()
                for cid, sub in subs:
                    index.subscribe(cid, sub)
                topics = gen(sz["publishes"], seed2=4500)
                plan = subscriber_plan(kit, sz["clients"], topics,
                                       index.subscribers)
                sessions = started_sessions(kit, subs, plan)
                for cid, _v, ss in sessions[len(subs):]:
                    for sub in ss:
                        index.subscribe(cid, sub)
                base = os.path.join(work, "corpus.db")
                write_corpus_store(base, sessions, owner=POOL_NODES[0])
                dbs = {}
                for side in ("card", "trie"):
                    dbs[side] = os.path.join(work, f"{side}.db")
                    shutil.copyfile(base, dbs[side])
                st["out"]["store_write_s"] = time.perf_counter() - t0
                st["out"]["sessions"] = len(sessions)
                device = None if self.device.type == "cuda" else "cpu"
                st.update(topics=topics, plan=plan, sessions=sessions,
                          index=index, dbs=dbs, pools=(
                              StartedPool("card", work, dbs["card"], "sig",
                                          device, sz["max_batch"]),
                              StartedPool("trie", work, dbs["trie"], "trie",
                                          "cpu", sz["max_batch"])))
        except BaseException:
            shutil.rmtree(work, ignore_errors=True)
            raise
        return st

    async def pool_boot(self, st) -> dict:
        """Both pools of ``st`` started at once; their boots (no warning,
        the sidecar in the card pool alone, on the card) and w1's ledger
        holding the sessions w0 restored (w1 acks w0's resync), so a
        subscriber's takeover at w1 finds its session."""
        sz = self.sizes["pool"]
        card, trie = pools = st["pools"]
        for p in pools:
            p.start()
        boots = dict(zip((p.name for p in pools), await asyncio.gather(
            *(p.ready(sz["boot_s"]) for p in pools))))
        for p in pools:
            log(f"[pool] {p.name} pool boot: {json.dumps(boots[p.name])}")
            if boots[p.name]["warnings"]:
                raise AssertionError(f"{p.name} pool warned at boot: "
                                     f"{boots[p.name]['warnings']}")
        if not boots["card"]["sidecar"] or boots["trie"]["sidecar"]:
            raise AssertionError("the card pool runs a sidecar, the trie "
                                 f"pool none: {boots}")
        if (self.device.type == "cuda"
                and not boots["card"]["device"].startswith("cuda")):
            raise AssertionError(f"the card pool's sidecar runs on "
                                 f"{boots['card']['device']}")
        out = {"boot": boots}
        n = len(st["sessions"])
        out["ledger_s"] = await self.pool_converge(pools, ledger=n)
        log(f"[pool] w1's ledger holds the {n} sessions "
            f"{out['ledger_s']:.2f} s after the boots")
        return out

    def pool_start_early(self) -> None:
        """Phase 17's set-up, and its pools' boots and w1's ledger
        convergence beside what the caller does next (``boot_beside``);
        ``worker_pool`` takes them over."""
        st = self.pool_prepare()
        self.pool_pending = (st, *boot_beside(self.pool_boot, st))

    def pool_abort(self) -> None:
        """Kill the pools ``pool_start_early`` started where phase 17
        never took them over (an earlier failure)."""
        pending, self.pool_pending = self.pool_pending, None
        if pending is not None:
            abort_early(pending, pending[0]["pools"])

    async def pool_run(self, kit, topics, plan, sessions, index, card, trie,
                       sides) -> dict:
        """Phase 17's two booted pools: resumes, route convergence,
        settle, traffic, checks."""
        sz = self.sizes["pool"]
        pools = (card, trie)
        out = {}
        # each online subscriber on worker k % 2 in both pools, k its
        # rank in the plan: a $share pick depends on where the group's
        # members are (F29), so both pools get the same placement
        online = [e[0] for e in plan if not e[3]]
        nodes = {cid: POOL_NODES[k % POOL_WORKERS]
                 for k, cid in enumerate(online)}
        for p in (trie, card):
            await resume_subscribers(kit, sides[p.name], plan,
                                     self.pool_place(p, nodes))
        out["placement"] = {p.name: self.pool_placement(p, sides[p.name])
                            for p in pools}
        if out["placement"]["card"] != nodes:
            raise AssertionError(f"the subscribers sit elsewhere: "
                                 f"{out['placement']}")
        log(f"[pool] placement: {json.dumps(out['placement'])}")
        routes = {p.name: pool_routes(sessions, out["placement"][p.name])
                  for p in pools}
        if out["placement"]["card"] != out["placement"]["trie"]:
            raise AssertionError("the pools placed the subscribers apart")
        out["routes_s"] = await self.pool_converge(pools, routes=routes)
        out["settle_s"] = await self.pool_settle(card)
        log(f"[pool] routes {json.dumps(routes)} in {out['routes_s']:.2f} "
            f"s; the sidecar's tables caught up {out['settle_s']:.2f} s "
            "after that")
        traffic = publish_frames(kit, topics, 46, publishers=1)
        for p in (trie, card):
            await self.pool_publishers(kit, p, sides[p.name], traffic[1])
        before = {p.name: p.scrape() for p in pools}
        pool0 = card.scrape_pool()
        walls, starts = {}, {}
        for p in (trie, card):
            side = sides[p.name]
            starts[p.name] = {c: len(s.frames) for c, s in side.subs.items()}
            t0 = time.perf_counter()
            await side.bursts(kit, traffic, chunk=sz["burst"])
            walls[p.name] = time.perf_counter() - t0
        frames = streams_equal(
            "worker pools", sides["card"].streams(starts["card"], True),
            sides["trie"].streams(starts["trie"], True))
        after = {p.name: p.scrape() for p in pools}
        pool1 = card.scrape_pool()
        out.update(self.pool_metrics(before, after, pool0, pool1, frames,
                                     walls, len(topics)))
        out["cluster"] = self.pool_cluster_pages(pools)
        out["card_holders"] = self.pool_card_holders(card, trie)
        out["sidecar_answers"] = await self.pool_sidecar_answers(
            card, topics, index)
        out["compared_subscribers"] = len(plan)
        log(f"[pool] traffic: {json.dumps(out)}")
        return out

    async def pool_converge(self, pools, ledger: int | None = None,
                            routes: dict | None = None) -> float:
        """Wait until, in every pool, each worker's link to the other is
        up and, with ``ledger``, w0's resync of its sessions is acked by
        w1 and w1's ledger (its telemetry on w0's ``/cluster/metrics``)
        holds them all; with ``routes`` (pool -> node -> routes), until
        each worker holds those routes (w1's from its telemetry). Returns
        the seconds it took."""
        sz = self.sizes["pool"]
        t0 = time.perf_counter()
        deadline = time.monotonic() + sz["converge_s"]
        while True:
            state = {}
            for p in pools:
                page, fed = p.scrape(), p.scrape("/cluster/metrics")
                st = state[p.name] = {
                    "links_up": metric(page, "maxmq_cluster_links_up"),
                    "w1_links_up": metric(fed, "maxmq_cluster_links_up",
                                          node="w1")}
                if ledger is not None:
                    st["acked"] = metric(
                        page, "maxmq_cluster_session_sync_acks_total") \
                        >= metric(page, "maxmq_cluster_session_local")
                    st["ledgers"] = [
                        metric(page, "maxmq_cluster_session_ledger"),
                        metric(fed, "maxmq_cluster_session_ledger",
                               node="w1")]
                if routes is not None:
                    st["routes"] = {
                        "w0": metric(page, "maxmq_cluster_routes_held"),
                        "w1": metric(fed, "maxmq_cluster_routes_held",
                                     node="w1")}
            done = all(
                st["links_up"] == st["w1_links_up"] == POOL_WORKERS - 1
                and (ledger is None or (st["acked"] and st["ledgers"]
                                        == [ledger, ledger]))
                and (routes is None or st["routes"] == routes[name])
                for name, st in state.items())
            if done:
                return time.perf_counter() - t0
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"the pools did not converge in {sz['converge_s']} s: "
                    f"{state}; sessions {ledger}, routes {routes}")
            await asyncio.sleep(0.1)

    def pool_placement(self, pool, side) -> dict:
        """Which worker SO_REUSEPORT placed each online subscriber on."""
        pids = pool.workers()
        worker0 = self.pool_worker0(pool, pids)
        node = {worker0: "w0", **{p: "w1" for p in pids if p != worker0}}
        out = {cid: node.get(connection_owner(pool.port, c.writer, pids))
               for cid, c in sorted(side.subs.items())}
        if None in out.values():
            raise AssertionError(f"{pool.name} pool: subscribers on no "
                                 f"worker: {out}")
        return out

    @staticmethod
    def pool_worker0(pool, pids) -> int:
        """Worker 0's pid: the worker that serves ``/metrics``."""
        for inode in tcp_inodes(pool.metrics_port):
            owner = socket_owner(inode, pids)
            if owner is not None:
                return owner
        raise AssertionError(f"{pool.name} pool: no worker serves /metrics")

    def pool_place(self, pool, nodes: dict):
        """``place`` for ``resume_subscribers``: each client id's
        connection accepted only on its worker of ``nodes`` (a
        connection SO_REUSEPORT hands another worker is closed before its
        CONNECT, and another opened)."""
        pids = pool.workers()
        w0 = self.pool_worker0(pool, pids)
        pid_of = {"w0": w0, "w1": next(p for p in pids if p != w0)}

        def place(cid):
            async def accept(writer) -> bool:
                return (await accepted_by(pool.port, writer, pids)
                        == pid_of[nodes[cid]])
            return accept
        return place

    async def pool_publishers(self, kit, pool, side, owners) -> None:
        """The traffic's publishers connected, the first on w0 and the
        next on w1 and so on (``pool_place``), so the publishes cross the
        mesh both ways."""
        order = list(dict.fromkeys(owners))
        place = self.pool_place(pool, {
            owner: POOL_NODES[k % POOL_WORKERS]
            for k, owner in enumerate(order)})
        for owner in order:
            pub = side.pubs[owner] = WireClient(
                kit, owner, 5 if owner.startswith("pub5") else 4)
            await pub.open(pool.port, place(owner))

    async def pool_settle(self, card) -> float:
        """Wait until the card pool's sidecar holds every subscription in
        its tables, with no refresh or bucket warm-up under way (its
        service refreshes as the subscriptions arrive: no traffic
        needed). Returns the seconds it took."""
        sz = self.sizes["pool"]
        t0 = time.perf_counter()
        deadline = time.monotonic() + sz["converge_s"]
        while True:
            page = card.scrape_pool()
            if not (metric(page, "maxmq_matcher_tables_behind")
                    or metric(page, "maxmq_matcher_refreshing")):
                return time.perf_counter() - t0
            if time.monotonic() > deadline:
                raise AssertionError(
                    "the card pool's sidecar did not catch up with its "
                    "index: " + json.dumps({
                        f"{n}{{{lab}}}": v for (n, lab), v in page.items()
                        if n.startswith("maxmq_matcher_")}))
            await asyncio.sleep(0.1)

    def pool_metrics(self, before: dict, after: dict, pool0: dict,
                     pool1: dict, frames: int, walls: dict,
                     publishes: int) -> dict:
        """The card pool's sidecar over the traffic (its endpoint: K1
        launches, shadow probes, batches, bypassed topics; the launches
        that served publishes and the card's share of the batched topics)
        and both pools' w0 pages (match latency, hedges, commits)."""
        def delta(page0, page1, name, **labels):
            return metric(page1, name, **labels) - metric(page0, name,
                                                          **labels)

        k1 = delta(pool0, pool1, "maxmq_matcher_kernel_launches_total",
                   kernel="sig_match_fixed")
        shadow = delta(pool0, pool1, "maxmq_matcher_shadow_probes_total")
        batched = delta(pool0, pool1, "maxmq_matcher_batched_topics_total")
        bypassed = delta(pool0, pool1, "maxmq_matcher_bypassed_topics_total")
        out = {"sidecar": {
            "k1_launches": k1, "shadow_probes": shadow,
            "served_launches": k1 - shadow,
            "batches": delta(pool0, pool1, "maxmq_matcher_batches_total"),
            "batched_topics": batched, "bypassed_topics": bypassed,
            "device_share": (batched - bypassed) / max(batched, 1),
            "device_rtt_ms": metric(pool1,
                                    "maxmq_matcher_device_rtt_seconds") * 1e3,
            "errors": delta(pool0, pool1, "maxmq_matcher_batch_errors_total")},
            "deliveries_compared": frames, "wall_s": walls,
            "deliveries_per_s": {k: frames / v for k, v in walls.items()},
            "publishes_per_s": {k: publishes / v for k, v in walls.items()}}
        stage = "maxmq_broker_publish_stage_seconds"
        for name, page in after.items():
            commits = metric(page, "maxmq_storage_commits_total")
            out[name] = {
                "w0_received": delta(before[name], page,
                                     "maxmq_mqtt_messages_received"),
                "w0_match_ms": hist_quantiles(page, before[name], stage,
                                              stage="match_device"),
                "w0_hedges": {lab: v for (n, lab), v in page.items()
                              if n == "maxmq_matcher_fallbacks_total" and v
                              and 'reason="overflow"' not in lab},
                "w0_k1_launches": metric(
                    page, "maxmq_matcher_kernel_launches_total",
                    kernel="sig_match_fixed"),
                "commits": commits,
                "commit_ms_mean": metric(
                    page, "maxmq_storage_commit_seconds_total") * 1e3
                / max(commits, 1)}
        card = out["card"]
        if card["w0_hedges"] or card["w0_k1_launches"] or out["sidecar"][
                "errors"] or out["sidecar"]["batches"] < 1:
            raise AssertionError(f"the card pool's matching: {out}")
        if self.device.type == "cuda" and out["sidecar"][
                "served_launches"] < 1:
            raise AssertionError("the card pool's sidecar served no publish "
                                 f"batch from the card: {out}")
        return out

    def pool_cluster_pages(self, pools) -> dict:
        """Each pool's ``/cluster/metrics`` (at w0): both workers are
        nodes there, and only w0 (the journal owner) has the journal's
        series; w0's ``/metrics`` has ``maxmq_storage_*``."""
        out = {}
        for p in pools:
            fed = p.scrape("/cluster/metrics")
            nodes = sorted({m.group(1) for (_n, lab) in fed
                            for m in [re.search(r'node="([^"]+)"', lab)]
                            if m})
            journal = sorted({m.group(1) for (n, lab) in fed
                              if n == "maxmq_storage_queue_depth"
                              for m in [re.search(r'node="([^"]+)"', lab)]
                              if m})
            storage = any(n.startswith("maxmq_storage_")
                          for n, _l in p.scrape())
            if nodes != list(POOL_NODES) or journal != ["w0"] or not storage:
                raise AssertionError(f"{p.name} pool: nodes {nodes}, "
                                     f"journal at {journal}, w0 storage "
                                     f"series {storage}")
            out[p.name] = {"nodes": nodes, "journal": journal}
        return out

    def pool_card_holders(self, card, trie) -> dict:
        """The processes on the card: no worker of either pool and not
        the trie pool's parent has a ``/dev/nvidia*`` file open (a CUDA
        probe opens them, a context keeps them), and among the holders of
        a CUDA context (``nvidia-smi --query-compute-apps``) are at most
        this process and the card pool's parent (where the tool shows
        pids of this namespace, those two)."""
        workers = {p.name: p.workers() for p in (card, trie)}
        dev = {}
        for pid in [os.getpid(), card.proc.pid, trie.proc.pid,
                    *workers["card"], *workers["trie"]]:
            with contextlib.suppress(OSError):
                dev[pid] = sorted({os.readlink(f"/proc/{pid}/fd/{fd}")
                                   for fd in os.listdir(f"/proc/{pid}/fd")
                                   if os.readlink(f"/proc/{pid}/fd/{fd}")
                                   .startswith("/dev/nvidia")})
        out = {"workers": workers, "parents": {"card": card.proc.pid,
                                               "trie": trie.proc.pid},
               "self": os.getpid(), "dev_files": dev}
        opened = {pid: dev.get(pid) for pid in [trie.proc.pid,
                                                *workers["card"],
                                                *workers["trie"]]
                  if dev.get(pid)}
        if opened:
            raise AssertionError(f"processes besides the card pool's parent "
                                 f"opened the card: {opened}")
        if self.device.type != "cuda":
            return out
        res = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        apps = [line.split(",")[0].strip() for line in
                res.stdout.splitlines() if line.strip()]
        holders = [int(a) for a in apps if a.isdigit()]
        out["compute_apps"] = res.stdout.strip().splitlines()
        stray = {pid for w in workers.values() for pid in w} | {trie.proc.pid}
        allowed = {os.getpid(), card.proc.pid}
        if (res.returncode or stray & set(holders) or len(holders) > 2
                or (os.getpid() in holders
                    and not set(holders) <= allowed)):
            raise AssertionError(f"the card's holders: {out}")
        return out

    async def pool_sidecar_answers(self, card, topics, index) -> dict:
        """The card pool's sidecar asked for the traffic's topics over its
        socket (one OP_MATCH request, past the bypass cap: a batch on the
        card): every answer equal to the CPU trie over every session the
        pool holds."""
        from maxmq_tpu_torch.broker.workers import matcher_sock
        from maxmq_tpu_torch.matching.service import ServiceMatcher

        client = ServiceMatcher(matcher_sock(card.mesh))
        await client.connect()
        try:
            uniq = list(dict.fromkeys(topics))
            answers = await client.subscribers_batch_async(uniq)
        finally:
            await client.close()
        bad = [t for t, a in zip(uniq, answers)
               if not same_answer(a, index.subscribers(t))]
        if bad:
            raise AssertionError(f"the sidecar's answers differ from the "
                                 f"trie's on {len(bad)} topics: {bad[:4]}")
        return {"topics": len(uniq),
                "matched": sum(bool(a.subscriptions or a.shared)
                               for a in answers)}

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
        t_last = 0.0
        for i in range(len(batches) + 1):
            topics = batches[i] if i < len(batches) else None
            t0 = t1 = time.perf_counter()
            out = None
            if topics:
                arrays = pad_topic_batch(*tables.tokenize(
                    topics, engine.max_levels))
                t1 = time.perf_counter()
                out = engine._run(program, *arrays)    # enqueued, no wait
            if topics and i >= warm:
                times["prep"].append(t1 - t0)
            if pending is not None:      # collect the batch before this one
                j, p_topics, p_out = pending
                t2 = time.perf_counter()
                word_idx, word_val, overflow = engine._fetch(p_out)
                t3 = time.perf_counter()
                if j >= warm:            # the warm batch is not decoded
                    # the Python decode (~6,000 topics/s) on the front
                    # ``decode_batch`` topics of the timed batch
                    b = min(len(p_topics), self.sizes["decode_batch"])
                    p_topics = p_topics[:b]
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
        decoded_topics = len(first_results[0])
        out = {
            "subs": index.subscription_count, "batch": batch,
            "bucket": bucket, "n_rows": tables.n_rows,
            "slots": kt["slots"], "level_widths": kt["width"],
            "max_words": mw, "launches": launches,
            "host_prep_topics_per_s": batch / statistics.mean(times["prep"]),
            "extract_fetch_topics_per_s": batch / statistics.mean(
                times["fetch"]),
            "decoded_topics": decoded_topics,
            "decode_topics_per_s": decoded_topics / statistics.mean(
                times["decode"]),
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
        # what the earlier phases left (1M-subscription corpora, indexes,
        # engines) moves to the collector's permanent generation: a full
        # collection in this phase walks what this phase allocates, not
        # them (they took ~110 s of full collections in a run). Garbage
        # cycles among them are never collected: memory, not answers.
        gc.freeze()
        t0 = time.perf_counter()
        with full_collections() as pauses:
            out = fn(*args)
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s, "
            f"{rss_gib():.1f} GiB resident")
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
        subscriptions as OP_SUB frames and the OP_MATCH requests;
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
        index, engine = self.pipeline_corpus("mixed_100k")
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

    def started_phases(self) -> tuple:
        """Phases 15, 16 and 17, each booting the next one's children
        beside its own last part (``fed_start_early``,
        ``pool_start_early``); a phase the size table leaves out (as the
        CPU rehearsal of the whole run does) is None. Whatever was started
        early and not taken over is killed on the way out."""
        try:
            # phase 15; it starts phase 16's nodes
            started = self.phase("started broker", lambda: asyncio.run(
                self.started_brokers()))
            # phase 16; it starts phase 17's pools
            federation = (self.phase("federation", lambda: asyncio.run(
                self.federation())) if "federation" in self.sizes else None)
            # phase 17
            pool = (self.phase("worker pool", lambda: asyncio.run(
                self.worker_pool())) if "pool" in self.sizes else None)
        finally:
            self.fed_abort()
            self.pool_abort()
        return started, federation, pool

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
        surfaces = self.phase("sig surfaces", self.sig_surfaces)
        for engine in self.engines.values():
            engine.close()
        self.engines.clear()
        self.phase("dense check", self.dense_kernel_vs_plain)
        dense_service = self.phase(
            "dense service", lambda: asyncio.run(self.dense_service_path()))
        dh = self.phase("dense headline", self.dense_headline)
        # what the later phases no longer need goes (what sits in garbage
        # cycles stays: the heap is frozen, and a thaw and collection of
        # it took 15.7-16.5 s a time for 0.3-1.6 GiB)
        self.dense = self.dense_eng = None
        self.corpora.pop("hash_plus_100k", None)
        self.phase("nfa check mixed_100k", self.nfa_check, "mixed_100k")
        self.phase("nfa service", lambda: asyncio.run(
            self.nfa_service_path()))
        if self.sizes["nfa_1m"]:
            self.phase("nfa check iot_1m_share", self.nfa_check,
                       "iot_1m_share")
            self.phase("nfa headline", self.nfa_headline)
        self.nfa_engines.clear()
        self.corpora.pop("iot_1m_share", None)
        self.phase("cluster", self.cluster)
        content = self.phase("content evaluator", self.content_evaluator)
        tracing = self.phase("matcher tracing", lambda: asyncio.run(
            self.matcher_tracing()))
        started, federation, pool = self.started_phases()
        broker = self.phase("broker", lambda: asyncio.run(
            self.broker_phases()))
        h = heads["iot_1m_share"]
        sig = dict(KERNELS["sig_match_fixed"], launches=service["launches"],
                   max_abs_err=self.record["max_abs_err"],
                   ms=h["kernel_ms"], plain_ms=h["plain_ms"],
                   bound_ms=h["bound_ms"], bound_by=h["bound_by"],
                   library_ms=None, bit_equal=self.record["bit_equal"],
                   shape=f"iot_1m_share batch {h['bucket']}",
                   ms_256=h["kernel_ms_256"],
                   broker_launches=broker["launches"],
                   tracing_launches=tracing["launches"],
                   surfaces_launches=surfaces["launches"],
                   started_launches=started["k1_launches"],
                   federation_launches=None if federation is None else {
                       node: sum(run["nodes"][node]["k1_launches"]
                                 for run in fed_runs(federation))
                       for node in FED_LINE},
                   takeover_launches=None if federation is None else {
                       "live": {node: federation["takeover"]["traffic"][
                           "nodes"][node]["served_launches"]
                           for node in FED_LINE},
                       "dead_owner": {node: federation["rung"]["traffic"][
                           "nodes"][node]["served_launches"]
                           for node in FED_LINE},
                       "in_process": federation["in_process"]["takeover"][
                           "k1_launches"]},
                   pool_launches=None if pool is None else {
                       "served": pool["sidecar"]["served_launches"],
                       "shadow": pool["sidecar"]["shadow_probes"]},
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
                "tracing": tracing, "surfaces": surfaces,
                "started": started, "federation": federation, "pool": pool}


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
