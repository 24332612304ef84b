"""The port's K4 (``maxmq_tpu_torch.matching.dense_kernel``) against the
JAX package's Pallas dense-walk kernel (``matching/pallas_kernel.py``).

Both sides compute on identical state: the JAX package's compiled
``DenseTables`` go through the port's ``dense_arrays``/``stage``. The JAX
side runs its Pallas kernel in interpret mode on the CPU, as its own
tests do; the port side runs the kernel's plain version, which the
wrapper selects for CPU tensors. Every output is compared exactly: the
staged layout, and the raw (word_idx, word_val, overflow) of every row of
a bucket-padded batch. tests/test_torch_gpu.py holds the CUDA kernel
against the plain version on the card."""

import random

import numpy as np
import pytest
import torch

from maxmq_tpu.matching import TopicIndex as RefIndex
from maxmq_tpu.matching import pallas_kernel as ref_pk
from maxmq_tpu.matching.dense import compile_dense as ref_compile
from maxmq_tpu.matching.topics import pad_topic_batch as ref_pad
from maxmq_tpu.matching.topics import valid_filter
from maxmq_tpu.protocol import Subscription as RefSubscription
from maxmq_tpu_torch.matching import dense_kernel as dk
from maxmq_tpu_torch.matching.dense import dense_arrays

from test_nfa_parity import rand_corpus


def rand_index(seed: int, n_filters: int = 120):
    rng = random.Random(seed)
    filters, topics = rand_corpus(rng, n_filters=n_filters, n_clients=25)
    idx = RefIndex()
    for i, f in enumerate(filters):
        if valid_filter(f):
            idx.subscribe(f"c{i % 25}", RefSubscription(filter=f, qos=i % 3))
    topics += ["$SYS/t1/t2", "t0/" + "/".join(["t1"] * 40), "", "t1//t2"]
    return idx, topics


def boundary_index():
    """'#' at the tokenizer window's last level: its parent match needs
    the trailing pad column."""
    idx = RefIndex()
    idx.subscribe("c1", RefSubscription(filter="l0/l1/l2/l3/#"))
    idx.subscribe("c2", RefSubscription(filter="l0/l1/l2/l3/l4"))
    idx.subscribe("c3", RefSubscription(filter="+/l1/#", qos=1))
    idx.subscribe("c4", RefSubscription(filter="#"))
    return idx, ["l0/l1/l2/l3", "l0/l1/l2/l3/l4", "l0/l1", "$l0/l1",
                 "l0/l1/l2/l3/l4/l5"]


# name -> (index builder, max_levels, max_words)
CASES = {
    "rand_ml8": (lambda: rand_index(31), 8, 32),
    "rand_ml3": (lambda: rand_index(32), 3, 32),
    "rand_overflow": (lambda: rand_index(33, n_filters=300), 6, 1),
    "hash_boundary": (boundary_index, 4, 32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stage_matches_reference(case):
    build, max_levels, _ = CASES[case]
    idx, _ = build()
    tables = ref_compile(idx)
    ref = ref_pk.stage(tables, max_levels=max_levels)
    pt = dk.stage(dense_arrays(tables), slots=ref.slots,
                  max_levels=max_levels)
    assert (pt.slots, pt.n_levels, pt.n_rows) == (ref.slots, ref.n_levels,
                                                  ref.n_rows)
    assert np.array_equal(pt.child_tok, ref.child_tok)
    assert np.array_equal(pt.emit_exact.astype(np.int32), ref.emit_exact)
    assert (pt.n_emit, pt.emit_base) == (ref.n_emit, ref.emit_base)
    # parent_idx is the row of the one 1 in each expansion column;
    # padding columns are all zero and their slots never match
    expand = np.asarray(ref.expand, dtype=np.float32)
    real = expand.sum(axis=1) == 1.0                     # [L, S]
    assert np.array_equal(real, pt.child_tok != dk.NEVER)
    assert np.array_equal(pt.parent_idx[real],
                          expand.argmax(axis=1)[real])
    assert pt.width == [int(r.sum()) for r in real]
    # the default width is the widest level in whole warps
    own = dk.stage(dense_arrays(tables), max_levels=max_levels)
    assert own.slots % dk.SLOT_ALIGN == 0
    assert own.slots - dk.SLOT_ALIGN < max(pt.width) <= own.slots
    assert np.array_equal(own.child_tok, pt.child_tok[:, :own.slots])


def test_stage_trims_levels_past_the_window():
    idx = RefIndex()
    idx.subscribe("c1", RefSubscription(filter="a/b/c/d/e/f"))
    arrays = dense_arrays(ref_compile(idx))
    assert dk.stage(arrays).n_levels == 6
    pt = dk.stage(arrays, max_levels=2)
    assert pt.n_levels == 3 == ref_pk.stage(ref_compile(idx),
                                            max_levels=2).n_levels
    assert pt.n_rows == 1 and pt.n_emit == [0, 0, 0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_matcher(case):
    """Raw outputs of every row of a bucket-padded batch (pad rows
    included: both sides trim them after the kernel), with '$' topics,
    too-deep topics and the '#' boundary."""
    build, max_levels, max_words = CASES[case]
    idx, topics = build()
    tables = ref_compile(idx)
    toks, lengths, dollar = ref_pad(*tables.tokenize(topics, max_levels))
    assert len(lengths) > len(topics)
    ref = ref_pk.PallasMatcher(tables, max_levels, max_words)
    want = [np.asarray(x) for x in ref(toks, lengths, dollar)]
    port = dk.KernelMatcher(tables, max_levels, max_words, device="cpu")
    before = dk.dense_walk_words.launches
    got = [t.numpy() for t in port(toks, lengths, dollar)]
    assert dk.dense_walk_words.launches == before    # plain version: no launch
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1].view(np.uint32), want[1])
    assert np.array_equal(got[2], want[2])
    assert (want[0] >= 0).any()                      # real matches
    if max_words == 1:
        assert want[2][:len(topics)].sum() > (lengths < 0).sum()


def test_fits_equals_reference():
    wide, deep, rows = RefIndex(), RefIndex(), RefIndex()
    for i in range(600):
        wide.subscribe(f"c{i}", RefSubscription(filter=f"w{i}"))
    deep.subscribe("c", RefSubscription(filter="/".join("abcdefghij")))
    for i in range(2100):
        rows.subscribe(f"c{i}", RefSubscription(filter=f"r/{i % 400}/{i}"))
    small, _ = rand_index(34)
    for idx, fit in ((wide, False), (deep, False), (rows, False),
                     (small, True)):
        tables = ref_compile(idx)
        assert dk.fits(tables) == ref_pk.fits(tables) == fit


def test_kernel_matcher_refuses_tables_beyond_capacity():
    idx = RefIndex()
    for i in range(600):
        idx.subscribe(f"c{i}", RefSubscription(filter=f"w{i}"))
    with pytest.raises(ValueError):
        dk.KernelMatcher(ref_compile(idx), 8, device="cpu")


def _operands(batch=4, n_levels=2, slots=32):
    toks = torch.full((batch, 3), -1, dtype=torch.int32)
    lengths = torch.zeros(batch, dtype=torch.int32)
    dollar = torch.zeros(batch, dtype=torch.bool)
    pt = dk.StagedTables(
        child_tok=np.full((n_levels, slots), dk.NEVER, dtype=np.int32),
        parent_idx=np.zeros((n_levels, slots), dtype=np.int32),
        emit_exact=np.zeros((n_levels, slots), dtype=np.uint8),
        width=[0] * n_levels, n_emit=[0] * n_levels,
        emit_base=[0] * n_levels, n_rows=0, n_levels=n_levels, slots=slots)
    return toks, lengths, dollar, dk.device_stage(pt, "cpu")


def test_wrapper_checks_operands():
    toks, lengths, dollar, kt = _operands()
    idx, val, over = dk.dense_walk_words(toks, lengths, dollar, kt, 2)
    assert idx.dtype == val.dtype == torch.int32 and over.dtype == torch.bool
    assert idx.shape == val.shape == (4, 2) and over.shape == (4,)
    assert (idx == -1).all() and not val.any() and not over.any()
    with pytest.raises(TypeError):
        dk.dense_walk_words(toks.long(), lengths, dollar, kt, 2)
    with pytest.raises(TypeError):
        dk.dense_walk_words(toks, lengths, dollar.to(torch.uint8), kt, 2)
    with pytest.raises(ValueError):
        dk.dense_walk_words(toks, lengths[:3], dollar, kt, 2)
    with pytest.raises(ValueError):
        dk.dense_walk_words(toks.t(), lengths, dollar, kt, 2)
    _t, _l, _d, bad = _operands(slots=40)
    with pytest.raises(ValueError):
        dk.dense_walk_words(toks, lengths, dollar, bad, 2)
    with pytest.raises(ValueError):
        dk.dense_walk_words(toks, lengths, dollar, kt, 0)
    with pytest.raises(ValueError):
        dk.dense_walk_words(toks, lengths, dollar,
                            dict(kt, n_rows=dk.MAX_ROWS + 1), 2)
    with pytest.raises(ValueError):
        dk.dense_walk_words(toks, lengths, dollar,
                            dict(kt, chunk_masks=kt["chunk_masks"][:1]), 2)


def test_plain_pads_tokens_past_the_window():
    """Levels at or past the token matrix's width read -1: a '#' child of
    a last-window-level node matches its parent (4.7.1.2), a '+' does
    not."""
    idx = RefIndex()
    idx.subscribe("h", RefSubscription(filter="a/b/#"))
    idx.subscribe("p", RefSubscription(filter="a/b/+"))
    tables = ref_compile(idx)
    kt = dk.device_stage(dk.stage(dense_arrays(tables)), "cpu")
    vocab = tables.vocab
    toks = torch.tensor([[vocab["a"], vocab["b"]]], dtype=torch.int32)
    idx, val, over = dk.dense_walk_words(
        toks, torch.tensor([2], dtype=torch.int32),
        torch.zeros(1, dtype=torch.bool), kt, 1)
    (hash_row,) = [r for r, es in enumerate(tables.row_entries)
                   if tables.entries[es[0]].client_id == "h"]
    assert (idx[0, 0].item(), val[0, 0].item()) == (0, 1 << hash_row)
    assert not over[0]
