"""The count walk kernel's run bookkeeping, modelled on the CPU.

csrc/diag_runs.cu packs each diagonal's match bits 32 rows to a word and
counts runs from the words (an all-ones word extends the carry; otherwise
the low-order ones close it, the runs inside the word are counted with a
shift-and ladder, the high-order ones open the next carry).
`diag_runs.runs_from_words` does the same word operations in torch on
int64, and `diag_runs.match_words` builds the kernel's words (rows aligned
to the mask blocks, validity and mask flushes applied) from the operands.
Both are held exactly against `batch_counts_reference`, `_diag_end_counts`
and the Pallas TPU kernel in interpret mode. The kernel itself runs only
on a card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from needle_tpu.search import pallas_impl as P
from needle_tpu_torch.search import diag_runs as D

INT32_MAX = np.iinfo(np.int32).max
L_GRID = [1, 2, 30, 31, 32, 33, 64, 81, 200]
THR_GRID = [0, 10, 16, 32]


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _model(nv, mv, lm, thr, src, dst, n_pad, bm=None):
    args = [_t(a) for a in (nv, mv, lm, thr, src, dst)]
    words = D.match_words(args[0], args[1], args[3], args[4], args[5], n_pad,
                          None if bm is None else _t(bm))
    return D.runs_from_words(words, args[2]).numpy()


def _reference(nv, mv, lm, thr, src, dst, n_pad, bm=None):
    args = [_t(a) for a in (nv, mv, lm, thr, src, dst)]
    return D.batch_counts_reference(*args, n_pad,
                                    None if bm is None else _t(bm)).numpy()


def _near_copy(rng, src, dst, s0, d0, n, flips):
    """dst[d0:d0+n] = src[s0:s0+n] with `flips` random bits flipped per
    hash, so the cells of that stretch have popcount exactly `flips`."""
    for k in range(n):
        h = src[s0 + k]
        for b in rng.choice(32, size=flips, replace=False):
            h ^= np.uint32(1 << int(b))
        dst[d0 + k] = h


@settings(max_examples=150, deadline=None, database=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    n=st.sampled_from([1, 31, 32, 33, 63, 64, 65, 96, 130, 200]),
    density=st.sampled_from([0.0, 0.03, 0.3, 0.7, 0.97, 1.0]),
    l_min=st.lists(st.sampled_from(L_GRID), min_size=3, max_size=3),
    planted=st.lists(st.tuples(st.integers(0, 199), st.integers(1, 120)),
                     max_size=3),
)
def test_words_equal_diag_end_counts(seed, n, density, l_min, planted):
    """Random match bits of any density, with planted runs across word
    boundaries: runs_from_words == _diag_end_counts (the XLA tiles
    formulation) for every l_min of the grid."""
    rng = np.random.default_rng(seed)
    S = rng.random((3, n, 24)) < density
    for at, length in planted:
        S[:, at : at + length, ::2] = True  # runs on the even diagonals
        S[:, at + length : at + length + 1, ::2] = False
    S = torch.from_numpy(S)
    L = torch.tensor(l_min)
    words = D.pack_words(S)
    assert words.shape == (3, 24, -(-n // 32))
    assert torch.equal(D.runs_from_words(words, L), D._diag_end_counts(S, L))


@settings(max_examples=25, deadline=None, database=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    n_pad=st.sampled_from([512, 1024]),
    thr=st.lists(st.sampled_from(THR_GRID), min_size=3, max_size=3),
    l_min=st.lists(st.sampled_from(L_GRID), min_size=3, max_size=3),
    short=st.sampled_from([0, 1, 2, None]),
    gaps=st.booleans(),
)
def test_words_equal_reference(seed, n_pad, thr, l_min, short, gaps):
    """Operands through match_words and runs_from_words == the count walk's
    plain version: thr 0/10/16/32 (16 and up match a zero vector, so only
    the validity predicate keeps invalid cells out), l_min across word and
    tile boundaries, nv or mv of 0, 1 or 2 on one lane, masks with gaps,
    runs planted to start and end at tile edges."""
    rng = np.random.default_rng(seed)
    chunk = 3
    src = rng.integers(0, 2**32, size=(chunk, n_pad), dtype=np.uint32)
    dst = rng.integers(0, 2**32, size=(chunk, n_pad), dtype=np.uint32)
    for p in range(chunk):
        for _ in range(2):
            n = int(rng.choice([31, 32, 33, 64, 65, 200, 260]))
            s0 = int(rng.choice([63, 64, 127, 1, int(rng.integers(1, n_pad - n))]))
            s0 = min(s0, n_pad - n)
            d0 = int(rng.integers(1, n_pad - n))
            _near_copy(rng, src[p], dst[p], s0, d0, n, int(rng.integers(0, 12)))
    nv = rng.integers(n_pad // 2, n_pad + 1, size=chunk).astype(np.int32)
    mv = rng.integers(n_pad // 2, n_pad + 1, size=chunk).astype(np.int32)
    if short is not None:
        nv[1] = short
        mv[2] = short
    bm = np.full((chunk, D.n_groups_for(n_pad)), D.full_block_mask(n_pad), np.int32)
    if gaps:
        bm &= rng.integers(0, 2**31, size=bm.shape).astype(np.int32)
    args = (nv, mv, np.array(l_min, np.int32), np.array(thr, np.int32), src, dst,
            n_pad, bm)
    np.testing.assert_array_equal(_model(*args), _reference(*args))


@pytest.mark.parametrize("thr", [16, 32])
def test_words_equal_pallas_at_high_thresholds(rng, thr):
    """At thr 16 and 32 the model, the plain version and the TPU kernel
    agree, with nv and mv below n_pad and of 0, 1 and 2."""
    n_pad = 512
    src = rng.integers(0, 2**32, size=(6, n_pad), dtype=np.uint32)
    dst = rng.integers(0, 2**32, size=(6, n_pad), dtype=np.uint32)
    _near_copy(rng, src[0], dst[0], 40, 90, 100, 3)
    nv = np.array([300, 0, 1, 2, 512, 450], np.int32)
    mv = np.array([400, 512, 512, 512, 2, 1], np.int32)
    lm = np.array([31, 1, 1, 1, 1, 64], np.int32)
    thr_a = np.full(6, thr, np.int32)
    want = np.asarray(P.batch_counts_pallas(nv, mv, lm, thr_a, src, dst, n_pad,
                                            interpret=True))
    args = (nv, mv, lm, thr_a, src, dst, n_pad)
    np.testing.assert_array_equal(_reference(*args), want)
    np.testing.assert_array_equal(_model(*args), want)
    assert want[0].sum() > 0 and want[1:3].sum() == 0


@pytest.mark.parametrize("l_min", [1, 2, 30, 31, 32, 33, 64, 81, 200, 201])
def test_run_across_four_tiles(rng, l_min):
    """One run of 200 cells from row 60 (tile rows 63, 127, 191 and 255 are
    the kernel's tile edges): counted once iff l_min <= 200, and equal to
    the plain version, next to a run split by one mismatch."""
    n_pad = 512
    src = rng.integers(0, 2**32, size=(2, n_pad), dtype=np.uint32)
    dst = rng.integers(0, 2**32, size=(2, n_pad), dtype=np.uint32)
    dst[:, 70:270] = src[:, 60:260]  # diagonal o = 10, rows 60..259
    dst[1, 70 + 96] ^= np.uint32(0xFF)  # lane 1: runs of 96 and 103
    nv = np.full(2, n_pad, np.int32)
    lm = np.full(2, l_min, np.int32)
    thr = np.zeros(2, np.int32)
    got = _model(nv, nv, lm, thr, src, dst, n_pad)
    np.testing.assert_array_equal(got, _reference(nv, nv, lm, thr, src, dst, n_pad))
    d = 10 + n_pad - 1
    assert got[0, d] == int(l_min <= 200)
    assert got[1, d] == int(l_min <= 96) + int(l_min <= 103)


def test_run_across_masked_gap(rng):
    """A run through a masked-off block is flushed at the gap: its part
    before the gap counts if long enough, the part after starts anew."""
    n_pad = 2048
    src = rng.integers(0, 2**32, size=(3, n_pad), dtype=np.uint32)
    dst = src.copy()  # the main diagonal matches everywhere
    nv = np.full(3, n_pad, np.int32)
    lm = np.array([100, 600, 1], np.int32)
    thr = np.zeros(3, np.int32)
    bm = np.full((3, D.n_groups_for(n_pad)), D.full_block_mask(n_pad), np.int32)
    bm[:, 0] &= ~np.int32(1 << 2)  # block 2 (rows 1023..1534) masked
    got = _model(nv, nv, lm, thr, src, dst, n_pad, bm)
    np.testing.assert_array_equal(got, _reference(nv, nv, lm, thr, src, dst, n_pad, bm))
    d = n_pad - 1
    # rows 1..1022 (1022 long) and 1535..2047 (513 long)
    assert got[:, d].tolist() == [2, 1, 2]


def test_padding_lanes_and_empty_lanes_count_nothing(rng):
    """lm = INT32_MAX with bm = 0 (padding lanes), and lanes with nv or mv
    of 0 or 1, give zeros even at thr 32, where every valid cell matches."""
    n_pad = 512
    src = rng.integers(0, 2**32, size=(5, n_pad), dtype=np.uint32)
    dst = rng.integers(0, 2**32, size=(5, n_pad), dtype=np.uint32)
    nv = np.array([512, 0, 1, 512, 512], np.int32)
    mv = np.array([512, 512, 512, 0, 1], np.int32)
    lm = np.array([INT32_MAX, 1, 1, 1, 1], np.int32)
    thr = np.full(5, 32, np.int32)
    bm = np.full((5, D.n_groups_for(n_pad)), D.full_block_mask(n_pad), np.int32)
    bm[0] = 0
    got = _model(nv, mv, lm, thr, src, dst, n_pad, bm)
    np.testing.assert_array_equal(got, _reference(nv, mv, lm, thr, src, dst, n_pad, bm))
    assert not got.any()


@pytest.mark.parametrize(
    "words,l_min,want",
    [
        ([0xFFFFFFFF] * 3 + [0], 96, 1),
        ([0xFFFFFFFF] * 3 + [0], 97, 0),
        ([0x80000000, 0xFFFFFFFF, 0x00000001], 34, 1),  # carry over a full word
        ([0x80000000, 0xFFFFFFFF, 0x00000001], 35, 0),
        ([0b0111_0110_1111], 1, 3),  # runs of 4, 2 and 3 inside one word
        ([0b0111_0110_1111], 3, 2),
        ([0x7FFFFFFE], 30, 1),  # the longest run wholly inside a word
        ([0x7FFFFFFE], 31, 0),
        ([0xAAAAAAAA, 0x55555555], 1, 31),  # alternating; rows 31-32 join
        ([0xAAAAAAAA, 0x55555555], 2, 1),
    ],
)
def test_word_operations(words, l_min, want):
    """Hand-made words: all-ones words, carries, the inside-word ladder and
    its 30-row limit, a run made of one bit on each side of a word edge."""
    w = torch.tensor(words, dtype=torch.int64)[None, None, :]
    got = D.runs_from_words(w, torch.tensor([l_min]))
    assert int(got) == want
    bits = [(x >> r) & 1 for x in words for r in range(32)]
    S = torch.tensor(bits, dtype=torch.bool)[None, :, None]
    assert int(D._diag_end_counts(S, torch.tensor([l_min]))) == want


def test_pack_words_bit_order():
    S = torch.zeros((1, 70, 2), dtype=torch.bool)
    S[0, [0, 31, 32, 69], 0] = True
    S[0, 5, 1] = True
    words = D.pack_words(S)
    assert words.tolist() == [[[1 | (1 << 31), 1, 1 << 5], [1 << 5, 0, 0]]]
