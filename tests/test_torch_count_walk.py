"""The port's count walk (needle_tpu_torch/search/diag_runs.py) against the
Pallas TPU kernel it replaces, run in interpret mode as
tests/test_search_pallas.py runs it. On the CPU `batch_counts` takes the
plain PyTorch version, `batch_counts_reference`, which the CUDA kernel is
held against on the card (tests/test_torch_cuda.py, chip_smoke.py). All
comparisons are exact: the counts are integers."""

import numpy as np
import pytest
import torch

from needle_tpu.search import pallas_impl as P
from needle_tpu.search.jax_impl import _diag_candidates
from needle_tpu_torch.search import diag_runs as D

INT32_MAX = np.iinfo(np.int32).max


def _t(a):
    """numpy -> torch, uint32 hashes as int32 bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _port(nv, mv, lm, thr, src, dst, n_pad, bm=None):
    out = D.batch_counts(
        _t(nv), _t(mv), _t(lm), _t(thr), _t(src), _t(dst), n_pad,
        None if bm is None else _t(bm),
    )
    return out.numpy()


def _pallas(nv, mv, lm, thr, src, dst, n_pad, bm=None):
    return np.asarray(
        P.batch_counts_pallas(
            nv, mv, lm, thr, src, dst, n_pad, bm_b=bm, interpret=True
        )
    )


def _planted(rng, chunk, n_pad, runs):
    """Random hash rows with shared runs planted at (src_at, dst_at, len)."""
    src = rng.integers(0, 2**32, size=(chunk, n_pad), dtype=np.uint32)
    dst = rng.integers(0, 2**32, size=(chunk, n_pad), dtype=np.uint32)
    for s0, d0, n in runs:
        shared = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        src[:, s0 : s0 + n] = shared
        dst[:, d0 : d0 + n] = shared
    return src, dst


def test_reference_matches_pallas_n512(rng):
    """Four pairs covering nv/mv < n_pad, thr=0 and l_min=1 (the cases the
    Pallas tests pin), exact against the TPU kernel and the host rescan."""
    n_pad, chunk = 512, 4
    src, dst = _planted(rng, chunk, n_pad, [(30, 50, 40)])
    # near-matches: one flipped bit inside the run separates thr=0 from >0
    dst[:, 60] ^= np.uint32(1)
    nv = np.array([200, 512, 150, 90], np.int32)
    mv = np.array([220, 512, 100, 250], np.int32)
    lm = np.array([10, 40, 1, 1], np.int32)
    thr = np.array([10, 10, 0, 0], np.int32)
    got = _port(nv, mv, lm, thr, src, dst, n_pad)
    np.testing.assert_array_equal(got, _pallas(nv, mv, lm, thr, src, dst, n_pad))
    assert got.sum() > 0
    for r in range(chunk):
        for d in np.flatnonzero(got[r]).tolist() + [0, 511, 700]:
            o = d - (n_pad - 1)
            cands = _diag_candidates(src[r][: nv[r]], dst[r][: mv[r]], o, int(thr[r]))
            assert got[r, d] == sum(1 for *_, L in cands if L >= max(lm[r], 1))


def test_reference_matches_pallas_n2560_band_masks(rng):
    """n_pad 2560 (several mask groups) with row-block masks that have
    gaps: runs crossing a cleared block are flushed at the gap."""
    n_pad, chunk = 2560, 3
    src, dst = _planted(
        rng, chunk, n_pad, [(100, 2000, 60), (2200, 30, 60), (490, 700, 80)]
    )
    nv = np.array([2400, 2560, 2560], np.int32)
    mv = np.array([2300, 2560, 2000], np.int32)
    lm = np.array([30, 3, 20], np.int32)
    thr = np.array([8, 8, 10], np.int32)
    n_groups = D.n_groups_for(n_pad)
    full = int(D.full_block_mask(n_pad))
    bm = np.full((chunk, n_groups), full, np.int32)
    # pair 0: a gap at block 1 (rows 511..1022) cuts the run at row 490
    # to 21 rows, below l_min: dropped at the flush
    bm[0, :] = full & ~(1 << 1)
    bm[1, 0] = full & ~0b100  # gap at block 2 in group 0 only
    # pair 2: blocks 0, 1 and 3 only: the run at row 2200 (block 4) goes
    bm[2, :] = 0b1011
    got = _port(nv, mv, lm, thr, src, dst, n_pad, bm)
    assert got.shape == (chunk, 5120)
    np.testing.assert_array_equal(
        got, _pallas(nv, mv, lm, thr, src, dst, n_pad, bm)
    )
    # the gaps changed the counts: they are not all-ones masks in disguise
    assert not np.array_equal(got, _port(nv, mv, lm, thr, src, dst, n_pad))


def test_padding_lanes_count_nothing(rng):
    """Padding lanes (lm = INT32_MAX, bm = 0) give all zeros, even on
    identical rows; a real lane beside them is unaffected."""
    n_pad, chunk = 512, 3
    src, dst = _planted(rng, chunk, n_pad, [(0, 0, 512)])
    nv = np.full(chunk, 512, np.int32)
    lm = np.array([INT32_MAX, INT32_MAX, 4], np.int32)
    thr = np.zeros(chunk, np.int32)
    bm = np.zeros((chunk, D.n_groups_for(n_pad)), np.int32)
    bm[2] = D.full_block_mask(n_pad)
    got = _port(nv, nv, lm, thr, src, dst, n_pad, bm)
    np.testing.assert_array_equal(got, _pallas(nv, nv, lm, thr, src, dst, n_pad, bm))
    assert not got[:2].any()
    assert got[2, n_pad - 1] == 1  # the main diagonal: one run of 511


@pytest.mark.parametrize("n_pad", [512, 1536, 2560, 15872, 16384, 32768])
def test_geometry_matches_pallas(n_pad):
    """Mask geometry identical to the TPU kernel's, including the -1 mask
    of buckets with more than 31 row blocks."""
    assert D.n_groups_for(n_pad) == P.n_groups_for(n_pad, 8)
    assert D.full_block_mask(n_pad) == P.full_block_mask(n_pad)
    assert (D.D_TILE, D.G_TILES) == (P.D_TILE, P.G_TILES)


def test_minus_one_mask_reads_every_block(rng):
    """bm = -1 walks every block, exactly like the explicit full mask."""
    n_pad, chunk = 1024, 2
    src, dst = _planted(rng, chunk, n_pad, [(400, 600, 300)])
    nv = np.full(chunk, n_pad, np.int32)
    lm = np.array([7, 1], np.int32)
    thr = np.array([6, 9], np.int32)
    bm = np.full((chunk, D.n_groups_for(n_pad)), -1, np.int32)
    np.testing.assert_array_equal(
        _port(nv, nv, lm, thr, src, dst, n_pad, bm),
        _port(nv, nv, lm, thr, src, dst, n_pad),
    )


def test_popcount32_matches_numpy(rng):
    from needle_tpu.search.oracle import popcount_u32

    x = np.concatenate(
        [
            rng.integers(0, 2**32, size=4096, dtype=np.uint32),
            np.array([0, 1, 0x80000000, 0x80000001, 0xFFFFFFFF, 0x7FFFFFFF],
                     np.uint32),
        ]
    )
    got = D.popcount32(_t(x)).numpy()
    np.testing.assert_array_equal(got, popcount_u32(x).astype(np.int64))


def test_batch_counts_refuses_other_devices():
    x = torch.zeros((1, 512), dtype=torch.int32, device="meta")
    s = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        D.batch_counts(s, s, s, s, x, x, 512)
