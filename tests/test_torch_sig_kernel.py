"""The port's fixed-path device program (prologue, sig_match_fixed, stream
compaction) against the JAX package's fused Pallas program.

Both sides compute on identical state: the JAX engine's compiled tables
go through ``maxmq_tpu_torch.matching.sig.device_tables``. The JAX side
runs its Pallas chunk kernels in interpret mode on the CPU
(``use_pallas=True``); the port side runs the kernel's plain version,
which the wrapper selects for CPU tensors. The wire format must agree
exactly: ``counts_u8[:batch]`` and ``stream[:total]``.

Coverage: a table with <= 40 device groups (K1, ``_chunk_kernel_select``)
and one with more (K2, ``_chunk_kernel_mxu``), both kernel widths, more
than one word chunk on the JAX side, '$' topics, too-deep topics and
bucket-pad rows. tests/test_torch_gpu.py holds the CUDA kernel against
the plain version on the card."""

import random

import numpy as np
import pytest
import torch

from maxmq_tpu.matching import TopicIndex as RefIndex
from maxmq_tpu.matching import sig_pallas
from maxmq_tpu.matching.sig import SigEngine as RefEngine
from maxmq_tpu.protocol import Subscription as RefSubscription
from maxmq_tpu_torch.matching import sig_kernel
from maxmq_tpu_torch.matching.sig import device_tables, table_arrays

SEGS = [f"s{i}" for i in range(12)]


def corpus(n_subs: int, seed: int, plus_in_prefix: bool):
    """'#'-heavy corpus. One wide group ("big/<i>/#", > 512 rows) keeps
    32-bit planes; the rest fold to 16 bits. ``plus_in_prefix`` turns 1-2
    prefix levels of the '#' filters into '+', which multiplies the
    group shapes past the 40 of the select expansion."""
    rng = random.Random(seed)
    filters = [f"big/{i}/#" for i in range(1100)]
    while len(filters) < n_subs:
        depth = rng.randint(1, 6)
        levels = [rng.choice(SEGS) for _ in range(depth)]
        r = rng.random()
        if r < 0.2:
            levels[rng.randrange(depth)] = "+"
        elif r < 0.9:
            levels = levels[:rng.randint(1, depth)]
            if plus_in_prefix:
                for _ in range(rng.randint(1, 2)):
                    levels[rng.randrange(len(levels))] = "+"
            levels = levels + ["#"]
        f = "/".join(levels)
        if rng.random() < 0.1:
            f = f"$share/g{rng.randint(0, 2)}/{f}"
        filters.append(f)
    idx = RefIndex()
    for i, f in enumerate(filters):
        idx.subscribe(f"c{i % 97}", RefSubscription(filter=f, qos=i % 3))
    topics = ["/".join(rng.choice(SEGS) for _ in range(rng.randint(1, 7)))
              for _ in range(170)]
    topics += [f"big/{i}/x" for i in range(0, 1100, 37)]
    topics += ["$SYS/s1/s2", "$" + topics[0], "s1/" + "/".join(["s2"] * 130),
               "/".join(["s3"] * 63) + "/x", "", "s1//s2"]
    return idx, topics


def jax_wire(engine, topics):
    """(counts_u8 [bucket], stream[:total], toks8, lens_enc) from the JAX
    engine's own dispatch (its bucket padding included)."""
    (counts_dev, stream_dev, _slices), _h, _t, _f, toks8, lens_enc = \
        engine.dispatch_fixed(topics)[:6]
    counts = np.asarray(counts_dev)
    total = int(np.where(counts == 0xFF, 0, counts).astype(np.int64).sum())
    return counts, np.asarray(stream_dev)[:total], toks8, lens_enc


def port_wire(engine, toks8, lens_enc, kernel_width):
    arrays = table_arrays(engine.tables)
    dev = device_tables(arrays, "cpu")
    kplan = sig_kernel.plan(arrays["group_words"], arrays["group_w16"],
                            force_width32=kernel_width == "32")
    fn = sig_kernel.build_fixed_fn(dev, kplan, engine.fixed_max_rows)
    counts, stream = fn(toks8, lens_enc)
    counts = counts.numpy()
    total = int(np.where(counts == 0xFF, 0, counts).astype(np.int64).sum())
    return counts, stream[:total].numpy().view(np.uint32), kplan


@pytest.mark.parametrize("kernel_width", ["auto", "32"])
@pytest.mark.parametrize("plus_in_prefix", [False, True],
                         ids=["select_K1", "mxu_K2"])
def test_plain_matches_pallas_program(monkeypatch, plus_in_prefix,
                                      kernel_width):
    # more than one chunk per word region on the JAX side: the port's
    # single walk must equal the Pallas kernels after their merge
    monkeypatch.setattr(sig_pallas, "CHUNK_WORDS", 32)
    idx, topics = corpus(1900, seed=3 if plus_in_prefix else 4,
                         plus_in_prefix=plus_in_prefix)
    engine = RefEngine(idx, use_pallas=True, kernel_width=kernel_width,
                       fixed_max_rows=6, auto_refresh=False)
    n_groups = len(engine.tables.groups)
    assert (n_groups > sig_pallas.SELECT_EXPAND_MAX) == plus_in_prefix
    kp = engine.kernel_plan
    assert kp["n_chunks32"] > 1
    if kernel_width == "auto":
        assert kp["n_chunks16"] > 1
    counts, stream, toks8, lens_enc = jax_wire(engine, topics)
    assert len(counts) > len(topics)          # bucket-pad rows present
    got_counts, got_stream, kplan = port_wire(engine, toks8, lens_enc,
                                              kernel_width)
    assert (kplan["n_words32"], kplan["n_words16"]) == \
        (kp["n_words32"], kp["n_words16"])
    assert np.array_equal(got_counts, counts)
    assert np.array_equal(got_stream, stream)
    # the batch really exercises matches, overflows and the too-deep rule
    assert len(stream) > len(topics) // 2
    assert (counts == 0xFF).any()


def test_wrapper_checks_operands():
    sig = torch.zeros((4, 2), dtype=torch.int32)
    deep = torch.zeros(4, dtype=torch.uint8)
    grp = torch.zeros(3, dtype=torch.int32)
    p32 = torch.zeros((32, 3), dtype=torch.int32)
    p16 = torch.zeros((16, 0), dtype=torch.int32)
    counts, rows = sig_kernel.sig_match_fixed(sig, deep, grp, p32, p16, 4)
    assert counts.dtype == torch.uint8 and rows.shape == (4, 4)
    with pytest.raises(TypeError):
        sig_kernel.sig_match_fixed(sig.long(), deep, grp, p32, p16, 4)
    with pytest.raises(ValueError):
        sig_kernel.sig_match_fixed(sig, deep[:3], grp, p32, p16, 4)
    with pytest.raises(ValueError):
        sig_kernel.sig_match_fixed(sig, deep, grp, p32[:16], p16, 4)
    with pytest.raises(ValueError):
        sig_kernel.sig_match_fixed(sig, deep, grp, p32, p16, 0)


def test_swar_fake_high_lane_overflows():
    """The packed compare's borrow fakes a high-lane bit next to a real
    low-lane match when hi ^ rep == 1; the word turns multi-bit and the
    topic overflows — exactly as the TPU kernel does."""
    rep = 0x1234
    sig = torch.tensor([[rep | (rep << 16)]], dtype=torch.int32)
    planes16 = torch.full((16, 1), -1, dtype=torch.int32)
    planes16[0, 0] = rep | ((rep ^ 1) << 16)   # low lane real, high fake
    deep = torch.zeros(1, dtype=torch.uint8)
    grp = torch.zeros(1, dtype=torch.int32)
    counts, _ = sig_kernel.sig_match_fixed(
        sig, deep, grp, torch.zeros((32, 0), dtype=torch.int32), planes16, 4)
    assert counts.tolist() == [0xFF]
    planes16[0, 0] = rep | (0x7777 << 16)        # exact low-lane hit only
    counts, rows = sig_kernel.sig_match_fixed(
        sig, deep, grp, torch.zeros((32, 0), dtype=torch.int32), planes16, 4)
    assert counts.tolist() == [1] and rows[0, 0].item() == 0
