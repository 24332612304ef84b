#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``maxmq_tpu_torch``).

    python3 chip_smoke.py

Needs one NVIDIA card and the CUDA toolkit (nvcc); exits non-zero with no
result line when CUDA is absent or the package is not beside this file.
Phases, each of which raises on failure:

0. card: name, power limit, device count;
1. build: nvcc compiles every ``maxmq_tpu_torch/csrc/*.cu`` (seconds and
   the ptxas register / shared-memory / spill summary are printed);
2. kernel against its plain version on the card, bit for bit, on three
   corpora and both plane widths: ``mixed_100k`` (<= 40 device groups, the
   TPU's select-expansion regime), ``hash_plus_100k`` (> 40 groups, the
   TPU's MXU-expansion regime) and ``iot_1m_share`` (1M subscriptions),
   with '$' topics, too-deep topics and bucket-pad rows in every batch;
3. the service path: the port's MatcherService on a unix socket, driven
   through its ServiceMatcher client with the 100K ``mixed_100k``
   subscriptions (one OP_SUB frame each) and nine OP_MATCH requests of
   8 x 4,096 + 1 x 65,536 topics, twice: with the batcher's adaptive host
   bypass (the default), then with the bypass off, where the kernel must
   serve most topics; every answer is held against the CPU trie;
4. headline shape: an in-process SigEngine at batch 262,144 on
   ``iot_1m_share`` (fixed_max_rows 14) and ``mixed_100k``, pipelined
   dispatch/collect, every topic through the kernel;
5. the kernels line (JSON), the card line, and the result line.

The corpora are made here from seed 42 (a copy of the benchmark's corpus
generator); the script imports nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks for the roofline bound (NVIDIA data sheet and Hopper
# white paper): HBM3 at 3.35 TB/s; INT32 at 64 lanes per SM x 132 SMs x
# 1.98 GHz boost = 16.7e12 operations/s (the data sheet lists no INT32
# figure; this is the lane count times the clock).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

# The run's sizes: subscriptions per corpus, the kernel-check batch (not a
# bucket size, so pad rows ride along), the service requests, the
# warm-up topics sent before them, and the headline batch.
SIZES = {"subs": {"mixed_100k": 100_000, "hash_plus_100k": 100_000,
                  "iot_1m_share": 1_000_000},
         "check_batch": 4_096 + 100,
         "service_rounds": (4_096,) * 8 + (65_536,),
         "service_warm": 1_024,
         "headline_batch": 262_144}
ENGINE_COUNTERS = ("matches", "host_matches", "fallbacks", "trie_routed")
KERNEL = {"name": "sig_match_fixed", "route": "cuda",
          "source": "maxmq_tpu_torch/csrc/sig_match.cu",
          "replaces": ("maxmq_tpu/matching/sig_pallas.py:300 "
                       "_chunk_kernel_select; maxmq_tpu/matching/"
                       "sig_pallas.py:288 _chunk_kernel_mxu")}


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


def normalize(ss):
    """Comparable form of a SubscriberSet."""
    subs = {cid: (s.qos, tuple(sorted(s.identifiers.items())))
            for cid, s in ss.subscriptions.items()}
    shared = {k: tuple(sorted(v)) for k, v in ss.shared.items()}
    return subs, shared


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip()


class Smoke:
    """The phases, parameterized by device and size table (``SIZES`` on
    the card) so the same code can be rehearsed on the CPU at small sizes,
    where the kernel wrapper runs its plain version."""

    def __init__(self, device: str = "cuda", sizes: dict = SIZES) -> None:
        import torch

        from maxmq_tpu_torch.matching import sig_kernel

        self.torch = torch
        self.sig_kernel = sig_kernel
        self.device = torch.device(device)
        self.sizes = sizes
        self.corpora = {}
        self.engines = {}
        self.record = {"max_abs_err": 0, "bit_equal": True}

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
        filters, gen = build_corpus(
            self.sizes["subs"][name], seed=42,
            share_frac=0.1 if name == "iot_1m_share" else 0.0,
            hash_plus=name == "hash_plus_100k")
        index = TopicIndex()
        for i, f in enumerate(filters):
            index.subscribe(f"cl-{i}", Subscription(filter=f, qos=i % 3))
        log(f"[corpus] {name}: {len(filters)} subscriptions indexed in "
            f"{time.perf_counter() - t0:.1f} s")
        self.corpora[name] = (filters, gen, index)
        return self.corpora[name]

    def engine(self, name: str):
        if name not in self.engines:
            from maxmq_tpu_torch.matching.sig import SigEngine

            _f, _g, index = self.corpus(name)
            t0 = time.perf_counter()
            self.engines[name] = SigEngine(
                index, device=self.device, auto_refresh=False,
                fixed_max_rows=14 if name == "iot_1m_share" else 7)
            log(f"[corpus] {name}: tables compiled and uploaded in "
                f"{time.perf_counter() - t0:.1f} s")
        return self.engines[name]

    # -- phase 2 -------------------------------------------------------

    def check_batch(self, name: str) -> list[str]:
        _f, gen, _i = self.corpus(name)
        topics = gen(self.sizes["check_batch"], seed2=7)
        return topics + ["$SYS/a0/b1", "$" + topics[0],
                         "a0/" + "/".join(["b1"] * 130),
                         "/".join(["c2"] * 63) + "/d3", ""]

    def kernel_vs_plain(self, name: str) -> dict:
        from maxmq_tpu_torch.matching.sig import (device_tables,
                                                  pad_to_bucket,
                                                  table_arrays)
        from maxmq_tpu_torch.matching.sig_tables import prepare_batch

        sk, torch = self.sig_kernel, self.torch
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
            self.sync()
            err = int((got[1].to(torch.int64) - want[1].to(torch.int64))
                      .abs().max().item())
            err = max(err, int((got[0].to(torch.int64)
                                - want[0].to(torch.int64)).abs().max()))
            b = len(topics)
            real = torch.where(want[0] == 0xFF, 0, want[0].to(torch.int64))
            total = int(real.sum())
            s_got = sk.compact_stream(got[0], got[1], mr)[:total]
            s_want = sk.compact_stream(want[0], want[1], mr)[:total]
            equal = (torch.equal(got[0][:b], want[0][:b])
                     and torch.equal(s_got, s_want)
                     and torch.equal(got[1], want[1]))
            self.record["max_abs_err"] = max(self.record["max_abs_err"], err)
            self.record["bit_equal"] &= equal
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
                    client, svc, engine, gen, mirror, bypass, seed)
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
        dev = modes["device"]
        if dev["device_topics"] * 2 <= dev["topics"]:
            raise AssertionError(
                f"with the bypass off the device path served only "
                f"{dev['device_topics']} of {dev['topics']} topics")
        if self.device.type == "cuda" and (launches <= 0
                                           or dev["launches"] <= 0):
            raise AssertionError("the service path launched no kernel")
        return out

    async def service_rounds(self, client, svc, engine, gen, mirror,
                             bypass: bool, seed: int) -> dict:
        """The service requests once, with the batcher's host bypass on
        or off; each answer is held against the CPU trie. Device-served
        topics are those the engine matched neither on the host nor from
        its trie."""
        sk = self.sig_kernel
        batcher = svc.matcher
        batcher.cpu_bypass = bypass
        base = {k: getattr(engine, k) for k in ENGINE_COUNTERS}
        bypass0, launches0 = batcher.bypasses, sk.sig_match_fixed.launches
        rounds, bad, checked = [], 0, 0
        for r, size in enumerate(self.sizes["service_rounds"]):
            topics = gen(size, seed2=seed + r)
            t_req = time.perf_counter()
            results = await client.subscribers_batch_async(topics)
            took = time.perf_counter() - t_req
            rounds.append({"topics": len(topics), "ms": took * 1e3,
                           "topics_per_s": len(topics) / took})
            for t, got in zip(topics, results):
                checked += 1
                if normalize(got) != normalize(mirror.subscribers(t)):
                    bad += 1
        d = {k: getattr(engine, k) - v for k, v in base.items()}
        lat = [r["ms"] for r in rounds[:-1]] or [rounds[0]["ms"]]
        return {"request_ms_p50": statistics.median(lat),
                "request_ms_max": max(lat),
                "topics": sum(r["topics"] for r in rounds),
                "topics_per_s": (sum(r["topics"] for r in rounds)
                                 / sum(r["ms"] for r in rounds) * 1e3),
                "rounds": rounds,
                "launches": sk.sig_match_fixed.launches - launches0,
                "bypasses": batcher.bypasses - bypass0,
                "device_topics": (d["matches"] - d["host_matches"]
                                  - d["fallbacks"] - d["trie_routed"]),
                "checked": checked, "mismatches": bad, **d}

    # -- phase 4 -------------------------------------------------------

    def headline(self, name: str) -> dict:
        from maxmq_tpu_torch.matching.sig import pad_to_bucket
        from maxmq_tpu_torch.matching.sig_tables import prepare_batch

        sk, torch = self.sig_kernel, self.torch
        engine = self.engine(name)
        _f, gen, index = self.corpus(name)
        batch = self.sizes["headline_batch"]
        batches = [gen(batch, seed2=2000 + i) for i in range(7)]
        base = {k: getattr(engine, k) for k in ENGINE_COUNTERS}
        sk.sig_match_fixed.launches = 0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        warm = 2                         # batches 0, 1 warm the pipeline
        times = {"dispatch": [], "fetch": [], "decode": []}
        pending = None
        first_results = None
        t_first = t_last = 0.0
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
        if self.device.type == "cuda" and launches < len(batches):
            raise AssertionError(f"{name}: {launches} launches for "
                                 f"{len(batches)} batches")
        # correctness on a sample of a timed batch, against the CPU trie
        topics, res = first_results
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
        counts, _rows = call()
        plain_ms = self.time_ms(
            lambda: sk.sig_match_fixed_plain(sig, deep, dev["grp_of_word"],
                                             p32, p16, mr), 1)
        b = sig.shape[0]
        n32, n16 = kplan["n_words32"], kplan["n_words16"]
        ops = b * (32 * n32 + 16 * n16)
        nbytes = (sig.numel() * 4 + deep.numel() + (n32 + n16) * 4
                  + (32 * n32 + 16 * n16) * 4 + b + b * mr * 4)
        t_ops = ops / INT32_OPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        timed_topics = batch * len(times["decode"])
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
            "pipelined_topics_per_s": timed_topics / (t_last - t_first),
            "kernel_ms": kernel_ms,
            "kernel_topics_per_s": b / (kernel_ms / 1e3),
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ops_ms": t_ops, "bound_bytes_ms": t_bytes,
            "int32_ops": ops, "bytes": nbytes,
            "overflow_topics": int((counts[:batch] == 0xFF).sum()),
            "library_ms": None,    # no single PyTorch call computes this
            **{k: v for k, v in d.items()},
        }
        if self.device.type == "cuda":
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"[headline] {name}: {json.dumps(out)}")
        log(f"[headline] {name}: library yardstick: none — no single "
            "PyTorch call computes this function")
        return out

    # -- all phases ----------------------------------------------------

    def run(self) -> dict:
        checks = {name: self.kernel_vs_plain(name)
                  for name in ("mixed_100k", "hash_plus_100k",
                               "iot_1m_share")}
        if checks["hash_plus_100k"]["groups"] <= 40:
            raise AssertionError("hash_plus_100k must exceed 40 groups")
        log(f"[kernel] hash_plus_100k device groups: "
            f"{checks['hash_plus_100k']['groups']} (> 40: the TPU's MXU "
            "expansion regime)")
        service = asyncio.run(self.service_path())
        heads = {name: self.headline(name)
                 for name in ("iot_1m_share", "mixed_100k")}
        for engine in self.engines.values():
            engine.close()
        h = heads["iot_1m_share"]
        kernel = dict(KERNEL, launches=service["launches"],
                      max_abs_err=self.record["max_abs_err"],
                      ms=h["kernel_ms"], plain_ms=h["plain_ms"],
                      bound_ms=h["bound_ms"], bound_by=h["bound_by"],
                      library_ms=None, bit_equal=self.record["bit_equal"],
                      shape=f"iot_1m_share batch {h['bucket']}",
                      headline={k: {f: v[f] for f in
                                    ("kernel_ms", "plain_ms", "bound_ms",
                                     "bound_by", "launches")}
                                for k, v in heads.items()})
        return {"kernels": [kernel]}


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
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    kernels.build_all()
    log(f"[build] all kernels in {time.perf_counter() - t0:.1f} s")
    for name, rec in kernels.build_log.items():
        log(f"[build] {name}.cu: {rec['seconds']:.1f} s "
            f"(cached={rec['cached']})")
        for line in rec["ptxas"].splitlines():
            log(f"[build]   {line.strip()}")

    result = Smoke("cuda").run()
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps(result), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
