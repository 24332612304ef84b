"""The signature kernel's two-phase design, held here without the card.

``nonzero_words`` is the kernel's first phase in torch ops (an OR of
compares for 32-bit planes, the OR-accumulated zero-lane detect for packed
16-bit planes); it must be nonzero exactly where the exact match word
(``sig_kernel._match_words``) is, the SWAR detect's fake high-lane bit
included.
``two_phase`` repeats the kernel's order of work — phase one over the words
in ascending order, the first max_rows nonzero words kept, phase two's
exact words and multi-bit test only for those — and must equal the plain
version, whose single pass is the function's definition. The operands come
from ``chip_smoke.synthetic_sig``, the generator of the card's edge checks.
tests/test_torch_gpu.py holds the CUDA kernel against the plain version on
the card."""

import numpy as np
import pytest
import torch

import chip_smoke
from maxmq_tpu_torch.matching import sig_kernel as sk
from maxmq_tpu_torch.matching.sig_torch import MASK32

WORDS = 512          # words per seeded draw, one plane column each
KINDS = ("free", "lo", "hi", "fake", "both")


def nonzero_words(sig: torch.Tensor, grp: torch.Tensor, planes: torch.Tensor,
                  width16: bool) -> torch.Tensor:
    """bool[n, W]: whether each word's match word is nonzero, computed
    as the kernel's first phase does, without building it: an OR of
    ``sig_exp == plane`` over the 32 planes, or for packed 16-bit planes
    the OR of ``(x - 0x00010001) & ~x`` over the 16 planes masked with
    0x80008000 once."""
    e = sig[:, grp.to(torch.int64)]
    p = planes.to(torch.int64) & MASK32
    if not width16:
        hit = torch.zeros(e.shape, dtype=torch.bool, device=e.device)
        for j in range(32):
            hit |= e == p[j]
        return hit
    acc = torch.zeros_like(e)
    for j in range(16):
        x = e ^ p[j]
        acc |= ((x - 0x00010001) & MASK32) & ~x
    return (acc & 0x80008000) != 0


def _bits32(values, shape):
    return torch.from_numpy(np.asarray(values, dtype=np.uint32)
                            .reshape(shape).view(np.int32))


def _signatures(values) -> torch.Tensor:
    """int64[n, 1]: one group signature per topic (uint32 bits)."""
    return torch.from_numpy(np.asarray(values, dtype=np.int64))[:, None]


@pytest.mark.parametrize("seed", range(4))
def test_nonzero_words_32_equals_exact(seed):
    """Random 32-bit planes; in half of the words one plane, in a quarter
    two planes, equal the signature of a random topic."""
    rng = np.random.default_rng(seed)
    sigs = rng.integers(0, 1 << 32, size=4, dtype=np.uint64)
    planes = rng.integers(0, 1 << 32, size=(32, WORDS), dtype=np.uint64)
    for w in range(WORDS):
        hits = rng.choice(32, size=2, replace=False)
        topic = int(rng.integers(0, len(sigs)))
        for j in hits[:int(rng.choice(3, p=(0.25, 0.5, 0.25)))]:
            planes[j, w] = sigs[topic]
    sig = _signatures(sigs)
    grp = torch.zeros(WORDS, dtype=torch.int32)
    p = _bits32(planes, (32, WORDS))
    exact = sk._match_words(sig, grp, p, False)
    assert 0 < int((exact != 0).sum()) < exact.numel()
    assert torch.equal(nonzero_words(sig, grp, p, False), exact != 0)


@pytest.mark.parametrize("kind", KINDS + ("mixed",))
def test_nonzero_words_16_equals_exact(kind):
    """Packed planes whose lanes are free (random, or the first topic's
    value with a low bit, the sign bit or all bits flipped), equal to the
    first topic's value in the low or high lane, both, or the fake-bit
    pattern (low lane equal, hi ^ rep == 1). Each plane takes ``kind``
    with probability 1/4 (``mixed``: any kind), else it is free."""
    rng = np.random.default_rng(KINDS.index(kind) if kind in KINDS else 9)
    reps = rng.integers(0, 1 << 16, size=4)
    rep = int(reps[0])

    def free() -> int:
        if rng.random() < 0.5:
            return int(rng.integers(0, 1 << 16))
        return rep ^ int(rng.choice([1, 2, 0x8000, 0xFFFF]))

    planes = np.empty((16, WORDS), dtype=np.uint64)
    for j in range(16):
        for w in range(WORDS):
            k = (str(rng.choice(KINDS)) if kind == "mixed" else kind)
            k = k if rng.random() < 0.25 else "free"
            lo, hi = free(), free()
            if k in ("lo", "both", "fake"):
                lo = rep
            if k in ("hi", "both"):
                hi = rep
            if k == "fake":
                hi = rep ^ 1
            planes[j, w] = lo | (hi << 16)
    sig = _signatures([int(r) | (int(r) << 16) for r in reps])
    grp = torch.zeros(WORDS, dtype=torch.int32)
    p = _bits32(planes, (16, WORDS))
    exact = sk._match_words(sig, grp, p, True)
    if kind != "free":
        assert 0 < int((exact[0] != 0).sum()) < WORDS
    assert torch.equal(nonzero_words(sig, grp, p, True), exact != 0)


def test_nonzero_words_fake_bit_alone():
    """The fake high-lane bit never stands alone: it rides a real low-lane
    zero, so the first phase sees the word, and the exact word is
    multi-bit."""
    rep = 0x1234
    sig = torch.tensor([[rep | (rep << 16)]], dtype=torch.int64)
    p = torch.full((16, 1), -1, dtype=torch.int32)
    p[3, 0] = rep | ((rep ^ 1) << 16)
    grp = torch.zeros(1, dtype=torch.int32)
    exact = int(sk._match_words(sig, grp, p, True)[0, 0])
    assert bin(exact).count("1") == 2
    assert bool(nonzero_words(sig, grp, p, True)[0, 0])


def two_phase(sig, too_deep, grp, planes32, planes16, max_rows):
    """The kernel's order of work in torch ops."""
    n32, n16 = planes32.shape[1], planes16.shape[1]
    s = sig.to(torch.int64) & MASK32
    parts = []
    if n32:
        parts.append(nonzero_words(s, grp[:n32], planes32, False))
    if n16:
        parts.append(nonzero_words(s, grp[n32:n32 + n16], planes16, True))
    nz = (torch.cat(parts, dim=1) if parts else
          torch.zeros((sig.shape[0], 0), dtype=torch.bool))
    counts = torch.empty(sig.shape[0], dtype=torch.uint8)
    rows = torch.full((sig.shape[0], max_rows), -1, dtype=torch.int32)
    for b in range(sig.shape[0]):
        words = torch.nonzero(nz[b]).flatten().tolist()
        over = bool(too_deep[b]) or len(words) > max_rows
        enc = []
        for w in ([] if over else words):                # phase two
            if w < n32:
                acc = sk._match_words(s[b:b + 1], grp[w:w + 1],
                                      planes32[:, w:w + 1], False)
            else:
                acc = sk._match_words(s[b:b + 1], grp[w:w + 1],
                                      planes16[:, w - n32:w - n32 + 1], True)
            acc = int(acc[0, 0])
            if acc & (acc - 1):
                over = True
                break
            enc.append((w << 5) | (acc.bit_length() - 1))
        counts[b] = 0xFF if over else len(words)
        if not over:
            rows[b, :len(enc)] = torch.tensor(enc, dtype=torch.int32)
    return counts, rows


CASES = {"overflow_first_tile": (1037, 200, 100, "overflow", 6),
         "overflow_first_tile_16": (1037, 0, 300, "overflow", 6),
         "no_16bit_words": (700, 400, 0, "mixed", 14),
         "no_32bit_words": (700, 0, 500, "mixed", 6),
         "mixed": (600, 300, 200, "mixed", 7)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_phase_equals_plain(case):
    batch, n32, n16, mode, mr = CASES[case]
    sig, deep, grp, p32, p16 = (torch.from_numpy(a) for a in
                                chip_smoke.synthetic_sig(3, batch, n32, n16,
                                                         mode, mr))
    p32 = p32[:, :n32]
    assert p32.stride(0) == n32 + n16                # strided, as the engine's
    want = sk.sig_match_fixed(sig, deep, grp, p32, p16, mr)   # plain on CPU
    got = two_phase(sig, deep, grp, p32, p16, mr)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    over = int((want[0] == 0xFF).sum())
    if mode == "overflow":
        assert over == batch
    else:
        # matches, overflows by count, by multi-bit words and too deep
        assert 0 < over < batch and (want[0] != 0xFF).sum() > batch // 4
        assert (want[1] >= 0).sum() > batch


@pytest.mark.parametrize("batch,shape", [
    (262_144, (2, 1, 8)), (70_001, (2, 1, 8)), (40_000, (2, 1, 4)),
    (20_000, (2, 1, 2)), (10_000, (2, 1, 1)), (8_192, (1, 8, 8)),
    (4_096, (1, 8, 4)), (256, (1, 8, 1)), (1, (1, 8, 1))])
def test_launch_shape(batch, shape):
    """Two topics a thread and the most warps that still give each of the
    H100's 132 SMs a block, else eight lanes a topic; the smallest batches
    get one warp a block."""
    assert sk.launch_shape(batch, 132) == shape
    tpt, lpt, warps = shape
    blocks = -(-batch * lpt // (32 * tpt * warps))
    assert blocks >= 132 or shape == (1, 8, 1)
    kplan = sk.plan([40, 60], [False, True])
    table = 4 * (32 * 40 + 16 * 60 + 100)
    assert sk.plane_bytes(batch, kplan, 132) == blocks * table
