"""The CUDA kernel on the card, held against its plain version.

This file imports only the port (no JAX), so it runs on a machine that
has a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Elsewhere its tests skip; whether there is a card is decided when a test
runs (the ``cuda_card`` fixture), never at import."""

import random

import pytest
import torch

from maxmq_tpu_torch.matching import sig_kernel
from maxmq_tpu_torch.matching.sig import (SigEngine, device_tables,
                                          pad_to_bucket, table_arrays)
from maxmq_tpu_torch.matching.sig_tables import compile_sig, prepare_batch
from maxmq_tpu_torch.matching.trie import TopicIndex
from maxmq_tpu_torch.protocol import Subscription

SEGS = [f"s{i}" for i in range(12)]


@pytest.fixture
def cuda_card():
    """The card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc)")
    return torch.device("cuda")


def corpus(seed: int, plus_in_prefix: bool):
    """'#'-heavy corpus with one wide (32-bit plane) group; with
    ``plus_in_prefix`` it has more than 40 device groups."""
    rng = random.Random(seed)
    filters = [f"big/{i}/#" for i in range(1100)]
    while len(filters) < 3000:
        depth = rng.randint(1, 6)
        levels = [rng.choice(SEGS) for _ in range(depth)]
        levels = levels[:rng.randint(1, depth)]
        if plus_in_prefix:
            for _ in range(rng.randint(1, 2)):
                levels[rng.randrange(len(levels))] = "+"
        filters.append("/".join(levels + ["#"]))
    idx = TopicIndex()
    for i, f in enumerate(filters):
        idx.subscribe(f"c{i}", Subscription(filter=f, qos=i % 3))
    topics = ["/".join(rng.choice(SEGS) for _ in range(rng.randint(1, 7)))
              for _ in range(1000)]
    topics += [f"big/{i}/x" for i in range(0, 1100, 7)]
    topics += ["$SYS/s1", "$" + topics[0], "s1/" + "/".join(["s2"] * 130)]
    return idx, topics


@pytest.mark.gpu
@pytest.mark.parametrize("plus_in_prefix", [False, True],
                         ids=["le40_groups", "gt40_groups"])
@pytest.mark.parametrize("kernel_width", ["auto", "32"])
def test_cuda_kernel_matches_plain(cuda_card, plus_in_prefix, kernel_width):
    idx, topics = corpus(5, plus_in_prefix)
    tables = compile_sig(idx)
    assert (len(tables.groups) > 40) == plus_in_prefix
    arrays = table_arrays(tables)
    kplan = sig_kernel.plan(arrays["group_words"], arrays["group_w16"],
                            force_width32=kernel_width == "32")
    dev = device_tables(arrays, cuda_card)
    toks8, lens_enc, _ = prepare_batch(tables, topics)
    toks8, lens_enc = pad_to_bucket(tables, toks8, lens_enc)
    sig, deep = sig_kernel.prologue(dev, kplan, toks8, lens_enc)
    p32, p16 = sig_kernel.region_planes(dev, kplan)
    before = sig_kernel.sig_match_fixed.launches
    got = sig_kernel.sig_match_fixed(sig, deep, dev["grp_of_word"], p32, p16,
                                     6)
    want = sig_kernel.sig_match_fixed_plain(sig, deep, dev["grp_of_word"],
                                            p32, p16, 6)
    torch.cuda.synchronize()
    assert sig_kernel.sig_match_fixed.launches == before + 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert (want[0] == 0xFF).any() and (want[0] != 0xFF).sum() > 100


@pytest.mark.gpu
def test_engine_on_card_matches_trie(cuda_card):
    idx, topics = corpus(6, False)
    engine = SigEngine(idx, device=cuda_card, auto_refresh=False)
    before = sig_kernel.sig_match_fixed.launches
    got = engine.subscribers_fixed_batch(topics)
    assert sig_kernel.sig_match_fixed.launches == before + 1
    for t, g in zip(topics, got):
        want = idx.subscribers(t)
        assert set(g.subscriptions) == set(want.subscriptions), t
        assert set(g.shared) == set(want.shared), t
