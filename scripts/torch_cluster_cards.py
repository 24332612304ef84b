#!/usr/bin/env python3
"""Cluster mode of the PyTorch/CUDA port over every card, against the same
mesh shape on one card.

    python3 scripts/torch_cluster_cards.py

Needs two NVIDIA cards or more. Builds ``ShardedSigEngine`` and
``ShardedNFAEngine`` on ``chip_smoke``'s ``cluster_100k`` corpus (100,000
subscriptions, 10 % '$share', seed 42) over ``make_mesh()`` (every card)
and over a mesh of the same shape whose cells all sit on card 0, holds
each engine's ``match_raw`` on the check batch against the same mesh on
the CPU, and times each device program on one 262,144-topic batch with
the host clock after synchronising every card (CUDA events time one
card's stream only). Prints the card line and one JSON line a run.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

REPS = 5


def synchronize() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def program_ms(program, arrays) -> float:
    """Mean host-clock ms of ``program.run`` over REPS runs after one."""
    inputs = program.upload(*arrays)
    program.run(inputs)
    synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        program.run(inputs)
    synchronize()
    return (time.perf_counter() - t0) * 1e3 / REPS


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("torch_cluster_cards: needs two CUDA cards or more",
              file=sys.stderr)
        return 1
    from maxmq_tpu_torch.matching.sig_tables import prepare_batch_sig
    from maxmq_tpu_torch.parallel.sharded import (ShardedNFAEngine,
                                                  ShardedSigEngine,
                                                  make_mesh)

    print(chip_smoke.card_line(), flush=True)
    smoke = chip_smoke.Smoke("cuda")
    _f, gen, index = smoke.corpus("cluster_100k")
    topics = gen(chip_smoke.SIZES["headline_batch"], seed2=7100)
    check = smoke.check_batch("cluster_100k")
    every = make_mesh()
    n = every.devices.size
    meshes = (("every card", every),
              ("card 0", make_mesh(every.devices.shape,
                                   devices=["cuda:0"] * n)))
    cpu = make_mesh(every.devices.shape, devices=["cpu"] * n)
    for label, mesh in meshes:
        for cls in (ShardedSigEngine, ShardedNFAEngine):
            engine = cls(index, mesh=mesh)
            twin = cls(index, mesh=cpu)
            outs = 1 if cls is ShardedSigEngine else 2
            equal = all(np.array_equal(g, w) for g, w in zip(
                engine.match_raw(check)[:outs], twin.match_raw(check)[:outs]))
            if not equal:
                raise AssertionError(f"{cls.__name__} on {label}: the cards "
                                     "disagree with the CPU mesh")
            if cls is ShardedSigEngine:
                state = engine._state
                program = state.program
                arrays = prepare_batch_sig(state.shards[0], topics,
                                           window=max(state.d_max, 1),
                                           host_exact=state.union_exact)[:2]
            else:
                _v, shards, program = engine._state
                arrays = shards[0].tokenize(topics, engine.max_levels)
            ms = program_ms(program, arrays)
            print(json.dumps({
                "engine": cls.__name__, "mesh": label,
                "shape": mesh.shape, "cards": len({str(d) for d in
                                                   mesh.devices.flat}),
                "batch": len(topics), "bit_equal_to_cpu": equal,
                "program_ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
