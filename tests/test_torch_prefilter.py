"""The port's prefilter (needle_tpu_torch/search/prefilter.py, on the CPU)
against needle_tpu's: plan gating, the +/-1 expansion, the blocked
correlation, per-pair and dense band masks, the pair prefilter, direct
diagonal items and the tile plan, all compared exactly (integer and bool
outputs equal, item arrays equal in order); and TorchSearchEngine on each
of its four routes (direct, band, pair, walk-all) against JaxSearchEngine
and NumpySearchEngine: RunEntry lists in heap order and SearchResults,
each package searching its own FrameHashes built from the same arrays and
the outputs compared field by field (`_canon`).

The cases are those of tests/test_search_prefilter.py and
tests/test_search_direct.py. `test_direct_overflow_redispatch` and
`test_initial_cap_derivation` have no counterpart: the port takes flags
from `torch.nonzero` on the flag tensor and has no flag-word cap to
overflow or size."""

import numpy as np
import pytest
import torch

import needle_tpu.data as jax_data
import needle_tpu.duration as jax_duration
from needle_tpu.search import jax_impl as S
from needle_tpu.search import prefilter as JP
from needle_tpu.search.pallas_impl import batch_counts_pallas
from needle_tpu_torch.data import FrameHashes
from needle_tpu_torch.duration import Duration
from needle_tpu_torch.search import diag_runs as D
from needle_tpu_torch.search import prefilter as TP
from needle_tpu_torch.search import torch_impl as T
from needle_tpu_torch.tracing import metrics

STEP = 247619033  # ~0.248 s per hash, in ns


def _tt(table, vtab):
    """numpy (uint32 table, bool vtab) -> the port's torch operands."""
    table = np.ascontiguousarray(table, dtype=np.uint32)
    return torch.from_numpy(table.view(np.int32)), torch.from_numpy(vtab)


def _vtab(n_eps, n_pad, nvs):
    vtab = np.zeros((n_eps, n_pad), bool)
    for e, nv in enumerate(nvs):
        vtab[e, 1:nv] = True
    return vtab


def _all_pairs(n_eps):
    return [(p, a, b) for p, (a, b) in enumerate(
        (a, b) for a in range(n_eps) for b in range(a + 1, n_eps)
    )]


# -- plan, expansion, correlation ----------------------------------------------


def test_plan_gating(monkeypatch):
    monkeypatch.delenv("NEEDLE_TPU_SEARCH_PREFILTER", raising=False)
    cases = [
        ((100, 200, 10, 2560), None),  # auto: small work lists never
        ((5000, 81, 10, 2560), 32),
        ((5000, 200, 10, 2560), 64),
        ((5000, 2000, 10, 2560), 64),  # capped
        ((5000, 200, 10, 2560 + 4), None),  # W must divide n_pad
        ((5000, 9, 10, 2560), None),  # lm too small for the weakest width
        ((5000, 200, 16, 2560), None),  # bound non-positive
        ((2048, 81, 10, 32768), 32),
    ]
    for args, want in cases:
        assert TP.prefilter_plan(*args) == JP.prefilter_plan(*args) == want, args
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "off")
    assert TP.prefilter_plan(5000, 200, 10, 2560) is None
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    assert TP.prefilter_plan(4, 81, 10, 2560) == JP.prefilter_plan(4, 81, 10, 2560) == 32
    for w, thr in ((8, 0), (32, 10), (64, 15)):
        assert TP.keep_bound(w, thr) == JP.keep_bound(w, thr)


def test_expand_pm1_equals_jax(rng):
    n_pad = 256
    table = rng.integers(0, 2**32, size=(5, n_pad), dtype=np.uint32)
    table[0, :4] = [0, 0xFFFFFFFF, 0x80000000, 1]  # sign-bit patterns
    vtab = _vtab(5, n_pad, [256, 200, 1, 0, 37])
    got = TP.expand_pm1(*_tt(table, vtab), n_pad)
    assert got.dtype == torch.float16
    want = np.asarray(JP.expand_pm1(table, vtab, n_pad)).astype(np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)


def _max_blocked_corr_np(src, dst, nv, mv, w):
    """O(n^2) oracle for max_{b,t} C[b,t] on +/-1 expansions."""
    n = len(src)

    def pm(h, k):
        bits = (h[:, None] >> np.arange(32)) & 1
        out = (bits * 2 - 1).astype(np.int64)
        out[0] = 0
        out[k:] = 0
        return out

    S_, T_ = pm(src, nv), pm(dst, mv)
    best = -(10**9)
    for b in range(n // w):
        blk = S_[b * w : (b + 1) * w]
        for t in range(n):
            win = T_[t : t + w]
            if len(win) < w:
                win = np.pad(win, ((0, w - len(win)), (0, 0)))
            best = max(best, int((blk * win).sum()))
    return best


def test_chunk_max_corr_exact(rng):
    n_pad, w = 128, 8
    table = rng.integers(0, 2**32, size=(4, n_pad), dtype=np.uint32)
    table[1, 30:90] = table[0, 10:70]  # one correlated pair, large C
    nv = [100, 128, 37, 9]
    vtab = _vtab(4, n_pad, nv)
    ia = np.array([0, 1, 2, 3], np.int32)
    ib = np.array([1, 0, 3, 2], np.int32)
    exp = TP.expand_pm1(*_tt(table, vtab), n_pad)
    got = TP._chunk_max_corr(exp, ia, ib, w, 10, n_pad).numpy()
    jexp = JP.expand_pm1(table, vtab, n_pad)
    want = np.asarray(JP._chunk_max_corr(jexp, ia, ib, w, 10, n_pad))
    np.testing.assert_array_equal(got, want)
    for r in range(4):
        assert got[r] == _max_blocked_corr_np(
            table[ia[r]], table[ib[r]], nv[ia[r]], nv[ib[r]], w
        )
    assert got.max() > 8 * 32 * 0.9  # the correlated pair


def test_pair_prefilter_and_adaptive_probe(rng, monkeypatch):
    """prefilter_pairs equals needle_tpu's: auto mode with >2048 pairs
    passes a dense library's tail through unfiltered and keeps filtering
    a sparse one."""
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "auto")
    n_pad, n_eps = 128, 70
    work = _all_pairs(n_eps)
    assert len(work) > 2048
    slot = {e: e for e in range(n_eps)}
    vtab = _vtab(n_eps, n_pad, [120] * n_eps)
    base = rng.integers(0, 2**32, size=n_pad, dtype=np.uint32)
    related = np.broadcast_to(base, (n_eps, n_pad)).copy()
    unrelated = rng.integers(0, 2**32, size=(n_eps, n_pad), dtype=np.uint32)
    for table, dense in ((related, True), (unrelated, False)):
        got = TP.prefilter_pairs(*_tt(table, vtab), work, slot, lambda _: 15,
                                 10, n_pad)
        want = JP.prefilter_pairs(table, vtab, work, slot, lambda _: 15, 10,
                                  n_pad)
        assert got == want
        kept, n_skip, w = got
        assert w == 8
        if dense:
            assert n_skip == 0 and kept == work
        else:
            assert n_skip > len(work) * 0.9


# -- band masks ------------------------------------------------------------------


def _planted_pair(rng, n_pad, run_at, run_len):
    shared = rng.integers(0, 2**32, size=run_len, dtype=np.uint32)
    table = rng.integers(0, 2**32, size=(2, n_pad), dtype=np.uint32)
    (i0, j0) = run_at
    table[0, i0 : i0 + run_len] = shared
    table[1, j0 : j0 + run_len] = shared
    return table


def _band_masks_both(table, vtab, work, slot, lm, thr, n_pad):
    got = TP.prefilter_band_masks(*_tt(table, vtab), work, slot, lambda p: lm,
                                  thr, n_pad)
    want = JP.prefilter_band_masks(table, vtab, work, slot, lambda p: lm, thr,
                                   n_pad, 8)
    assert got[0] == want[0] and got[2:] == want[2:]
    if want[1] is None:
        assert got[1] is None
    else:
        assert got[1].dtype == np.int32
        np.testing.assert_array_equal(got[1], want[1])
    return got


@pytest.mark.parametrize("run_at", [(100, 1400), (1400, 100), (700, 730)])
def test_band_masks_equal_jax_and_keep_counts(rng, monkeypatch, run_at):
    """Per-pair band masks are bit-identical to needle_tpu's, prune row
    blocks, and leave the count walk's counts exactly as the full walk's
    (the port's plain walk and the Pallas kernel in interpret mode)."""
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    n_pad, lm, thr = 2560, 40, 8
    table = _planted_pair(rng, n_pad, run_at, 60)
    vtab = _vtab(2, n_pad, [n_pad, n_pad])
    kept, masks, n_skipped, w = _band_masks_both(
        table, vtab, [(0, 0, 1)], {0: 0, 1: 1}, lm, thr, n_pad
    )
    assert kept == [(0, 0, 1)] and n_skipped == 0 and w == 16
    full = int(D.full_block_mask(n_pad))
    assert masks.shape == (1, D.n_groups_for(n_pad))
    assert sum(bin(int(m) & full).count("1") for m in masks[0]) < 2 * bin(
        full
    ).count("1")

    one = lambda v: torch.tensor([v], dtype=torch.int32)  # noqa: E731
    tab = _tt(table, vtab)[0]
    args = (one(n_pad), one(n_pad), one(lm), one(thr), tab[:1].clone(),
            tab[1:].clone(), n_pad)
    masked = D.batch_counts(*args, bm=torch.from_numpy(masks))
    np.testing.assert_array_equal(masked.numpy(), D.batch_counts(*args).numpy())
    pallas = batch_counts_pallas(
        np.array([n_pad], np.int32), np.array([n_pad], np.int32),
        np.array([lm], np.int32), np.array([thr], np.int32), table[:1],
        table[1:], n_pad, bm_b=masks, interpret=True,
    )
    np.testing.assert_array_equal(masked.numpy(), np.asarray(pallas))
    assert int(masked.sum()) >= 1


def test_band_mask_zero_pair_is_dropped(rng, monkeypatch):
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    n_pad = 2560
    table = rng.integers(0, 2**32, size=(2, n_pad), dtype=np.uint32)
    kept, masks, n_skipped, w = _band_masks_both(
        table, _vtab(2, n_pad, [n_pad, n_pad]), [(0, 0, 1)], {0: 0, 1: 1},
        40, 8, n_pad,
    )
    assert kept == [] and n_skipped == 1 and len(masks) == 0


@pytest.mark.parametrize("dense_mode", ["off", "on"])
def test_dense_band_masks_equal_per_pair_and_jax(rng, monkeypatch, dense_mode):
    """The episode-tile path and the per-pair path give bit-identical
    masks, equal to needle_tpu's, with TA=TB=4 tiles overlapping at the
    tail (9 episodes)."""
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    monkeypatch.setenv("NEEDLE_TPU_PREFILTER_TA", "4")
    monkeypatch.setenv("NEEDLE_TPU_PREFILTER_TB", "4")
    monkeypatch.setenv("NEEDLE_TPU_PREFILTER_DENSE", dense_mode)
    n_pad, n_eps = 1024, 9
    shared = rng.integers(0, 2**32, size=60, dtype=np.uint32)
    table = rng.integers(0, 2**32, size=(n_eps, n_pad), dtype=np.uint32)
    for e in range(0, n_eps, 2):
        table[e, 100 + 7 * e : 160 + 7 * e] = shared
    vtab = _vtab(n_eps, n_pad, [900 + 10 * e for e in range(n_eps)])
    work = _all_pairs(n_eps)
    slot = {e: e for e in range(n_eps)}
    kept, masks, skipped, w = _band_masks_both(table, vtab, work, slot, 40, 8,
                                               n_pad)
    monkeypatch.setenv("NEEDLE_TPU_PREFILTER_DENSE",
                       "on" if dense_mode == "off" else "off")
    other = TP.prefilter_band_masks(*_tt(table, vtab), work, slot,
                                    lambda p: 40, 8, n_pad)
    assert other[0] == kept and other[2:] == (skipped, w)
    np.testing.assert_array_equal(other[1], masks)
    assert skipped > 0 and len(kept) > 0


def test_dense_gate_sparse_work_uses_per_pair(rng, monkeypatch):
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    monkeypatch.delenv("NEEDLE_TPU_PREFILTER_DENSE", raising=False)
    calls = []
    real = TP._tile_band_masks
    monkeypatch.setattr(
        TP, "_tile_band_masks", lambda *a, **k: calls.append(1) or real(*a, **k)
    )
    n_pad, n_eps = 512, 64
    table = rng.integers(0, 2**32, size=(n_eps, n_pad), dtype=np.uint32)
    vtab = _vtab(n_eps, n_pad, [n_pad] * n_eps)
    slot = {e: e for e in range(n_eps)}
    _band_masks_both(table, vtab, [(0, 0, 63)], slot, 81, 10, n_pad)
    assert not calls, "tile path ran on a sparse work list"
    _band_masks_both(table, vtab, _all_pairs(n_eps), slot, 81, 10, n_pad)
    assert calls, "tile path did not run on a dense work list"


def test_band_masks_long_bucket_returns_none(rng, monkeypatch):
    """n_blocks > 31 cannot be covered by an int32 bitmask: no masks, the
    work list untouched."""
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    n_pad = 32 * D.D_TILE
    table = rng.integers(0, 2**32, size=(2, n_pad), dtype=np.uint32)
    got = _band_masks_both(table, _vtab(2, n_pad, [n_pad, n_pad]),
                           [(0, 0, 1)], {0: 0, 1: 1}, 81, 10, n_pad)
    assert got == ([(0, 0, 1)], None, 0, None)


# -- direct items --------------------------------------------------------------


def _direct_both(table, vtab, work, slot, lm, thr, n_pad):
    got = TP.direct_diag_items(*_tt(table, vtab), work, slot, lambda p: lm,
                               thr, n_pad)
    want = JP.direct_diag_items(table, vtab, work, slot, lambda p: lm, thr,
                                n_pad)
    if want is None:
        assert got is None
        return None
    rows, offs = (g.numpy() for g in got)
    # the same items in the same order (per tile, pair, ascending diagonal)
    np.testing.assert_array_equal(rows, want[0])
    np.testing.assert_array_equal(offs, want[1])
    return rows, offs


def test_direct_items_cover_planted_diagonals(rng, monkeypatch):
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_DIRECT", "on")
    n_pad = 1024
    plants = [(100, 900), (900, 100), (700, 716), (1, 500)]
    table = rng.integers(0, 2**32, size=(8, n_pad), dtype=np.uint32)
    work = []
    for p, (i0, j0) in enumerate(plants):
        shared = rng.integers(0, 2**32, size=60, dtype=np.uint32)
        table[2 * p, i0 : i0 + 60] = shared
        table[2 * p + 1, j0 : j0 + 60] = shared
        work.append((p, 2 * p, 2 * p + 1))
    rows, offs = _direct_both(table, _vtab(8, n_pad, [1000] * 8), work,
                              {e: e for e in range(8)}, 40, 8, n_pad)
    for p, (i0, j0) in enumerate(plants):
        assert j0 - i0 in offs[rows == p], p


def test_direct_items_none_for_runless_pairs(rng, monkeypatch):
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_DIRECT", "on")
    n_pad = 1024
    table = rng.integers(0, 2**32, size=(2, n_pad), dtype=np.uint32)
    rows, offs = _direct_both(table, _vtab(2, n_pad, [1000, 1000]),
                              [(0, 0, 1)], {0: 0, 1: 1}, 40, 8, n_pad)
    assert len(rows) == 0 and len(offs) == 0


def test_direct_items_dense_tiles_equal_jax(rng, monkeypatch):
    """A dense all-pairs work list over overlapping TA=TB=4 tiles: the
    same items as needle_tpu, and a superset of the walk's flags."""
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_DIRECT", "on")
    monkeypatch.setenv("NEEDLE_TPU_PREFILTER_TA", "4")
    monkeypatch.setenv("NEEDLE_TPU_PREFILTER_TB", "4")
    n_pad, n_eps, lm, thr = 512, 7, 40, 8
    shared = rng.integers(0, 2**32, size=70, dtype=np.uint32)
    table = rng.integers(0, 2**32, size=(n_eps, n_pad), dtype=np.uint32)
    for e in range(n_eps - 2):
        table[e, 20 + 9 * e : 90 + 9 * e] = shared
    nvs = [480 - 11 * e for e in range(n_eps)]
    work = _all_pairs(n_eps)
    rows, offs = _direct_both(table, _vtab(n_eps, n_pad, nvs), work,
                              {e: e for e in range(n_eps)}, lm, thr, n_pad)
    items = set(zip(rows.tolist(), offs.tolist()))
    P = len(work)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)  # noqa: E731
    tab = _tt(table, _vtab(n_eps, n_pad, nvs))[0]
    sa = torch.tensor([a for _, a, _ in work])
    sb = torch.tensor([b for _, _, b in work])
    counts = D.batch_counts(
        i32(nvs)[sa], i32(nvs)[sb], i32([lm] * P), i32([thr] * P), tab[sa],
        tab[sb], n_pad,
    )
    walk = {(int(r), int(d) - (n_pad - 1)) for r, d in torch.nonzero(counts > 0)}
    assert walk and walk <= items


def test_direct_auto_gate(rng, monkeypatch):
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    monkeypatch.delenv("NEEDLE_TPU_SEARCH_DIRECT", raising=False)
    n_pad, n_eps = 512, 256
    table = rng.integers(0, 2**32, size=(n_eps, n_pad), dtype=np.uint32)
    vtab = _vtab(n_eps, n_pad, [n_pad] * n_eps)
    slot = {e: e for e in range(n_eps)}
    # sparse work in auto mode: no direct flagging
    assert _direct_both(table, vtab, [(0, 0, 255)], slot, 81, 10, n_pad) is None
    # threshold >= 16: plan inapplicable even when forced
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_DIRECT", "on")
    assert _direct_both(table, vtab, [(0, 0, 255)], slot, 81, 16, n_pad) is None
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_DIRECT", "off")
    assert _direct_both(table, vtab, _all_pairs(8), slot, 81, 10, n_pad) is None


def test_dense_tile_plan_contract(rng, monkeypatch):
    """The copy equals needle_tpu's plan, and the plan is a partition:
    every work row lands in one tile segment, inside its clamped origin
    window (tail tiles overlap at e_pad = 100)."""
    e_pad, n = 100, 5000
    sa = rng.integers(0, e_pad, n).astype(np.int32)
    sb = rng.integers(0, e_pad, n).astype(np.int32)
    for ta, tb in (("16", "128"), ("7", "30")):
        monkeypatch.setenv("NEEDLE_TPU_PREFILTER_TA", ta)
        monkeypatch.setenv("NEEDLE_TPU_PREFILTER_TB", tb)
        plan = TP._dense_tile_plan(sa, sb, e_pad)
        want = JP._dense_tile_plan(sa, sb, e_pad)
        for a, b in zip(plan, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        ta_sz, tb_sz, uniq, order, bounds, origins = plan
        assert len(bounds) == len(uniq) + 1 == len(origins) + 1
        assert bounds[0] == 0 and bounds[-1] == n
        seen = np.concatenate(
            [order[bounds[t] : bounds[t + 1]] for t in range(len(uniq))]
        )
        assert sorted(seen.tolist()) == list(range(n))
        for t, (a0, b0) in enumerate(origins):
            idx = order[bounds[t] : bounds[t + 1]]
            assert 0 <= a0 and a0 + ta_sz <= e_pad
            assert 0 <= b0 and b0 + tb_sz <= e_pad
            assert np.all((sa[idx] >= a0) & (sa[idx] < a0 + ta_sz))
            assert np.all((sb[idx] >= b0) & (sb[idx] < b0 + tb_sz))


def test_member_matrix_copy():
    for w, n_pad in ((8, 512), (16, 2560), (64, 14848)):
        n_blocks = n_pad // D.D_TILE + 1
        np.testing.assert_array_equal(
            TP._member_matrix(w, n_pad, n_blocks),
            JP._member_matrix(w, n_pad, n_blocks),
        )


# -- the engine on every route -------------------------------------------------


def _canon(x):
    """Package-neutral form of search outputs: a RunEntry as its Ord key
    (every field, Durations in nanoseconds), a Duration in nanoseconds,
    containers element by element."""
    if hasattr(x, "ord_key"):
        return ("RunEntry",) + x.ord_key()
    if hasattr(x, "total_nanos"):
        return x.total_nanos()
    if isinstance(x, (list, tuple)):
        return type(x)(_canon(v) for v in x)
    return x


def _fh(h, ending=None):
    """The arrays of one episode's FrameHashes; `_search` builds them in
    the searching comparator's package."""
    h = np.asarray(h, dtype=np.uint32)
    ts = (2600090703 + np.arange(len(h)) * STEP).astype(np.int64)
    if ending is None:
        ending, ets = np.zeros(0, np.uint32), np.zeros(0, np.int64)
    else:
        ets = (900_000_000_000 + np.arange(len(ending)) * STEP).astype(np.int64)
    return (h, ts, ending, ets)


def _mixed_library(seed, with_endings=False):
    """Two shows of three episodes: within-show pairs share a run with bit
    flips, cross-show pairs share nothing."""
    r = np.random.default_rng(seed)
    fhs = []
    for show in range(2):
        shared = r.integers(0, 2**32, size=120 - 30 * show, dtype=np.uint32)
        shared_end = r.integers(0, 2**32, size=100, dtype=np.uint32)
        for e in range(3):
            h = r.integers(0, 2**32, size=300 + 40 * e, dtype=np.uint32)
            at = 25 + 30 * e
            h[at : at + len(shared)] = shared
            flips = r.integers(0, len(shared), size=6)
            h[at + flips] ^= np.uint32(1) << r.integers(0, 32, size=6).astype(
                np.uint32
            )
            end = None
            if with_endings:
                end = r.integers(0, 2**32, size=260 + 5 * e, dtype=np.uint32)
                end[40 + 7 * e : 140 + 7 * e] = shared_end
            fhs.append(_fh(h, end))
    return fhs


def _weakest_library():
    """A run of exactly l_min = 81 cells, every cell at exactly the
    Hamming threshold 10: no slack against the block bound or the run
    filter."""
    rng = np.random.default_rng(7)
    run = rng.integers(0, 2**32, size=81, dtype=np.uint32)
    h1 = rng.integers(0, 2**32, size=400, dtype=np.uint32)
    h2 = rng.integers(0, 2**32, size=400, dtype=np.uint32)
    h1[37 : 37 + 81] = run
    noisy = run.copy()
    for k in range(81):
        for b in rng.choice(32, size=10, replace=False):
            noisy[k] ^= np.uint32(1) << np.uint32(b)
    h2[160 : 160 + 81] = noisy
    return [_fh(h1), _fh(h2)]


def _search(make, specs, include_endings):
    cmp = make([f"v{k}.mkv" for k in range(len(specs))])
    fh, dur = ((FrameHashes, Duration) if cmp.__module__.startswith(
        "needle_tpu_torch") else (jax_data.FrameHashes, jax_duration.Duration))
    fhs = [fh(*arrays, dur.from_millis(300), "f" * 32) for arrays in specs]
    cmp = (
        cmp.with_hash_match_threshold(10)
        .with_include_endings(include_endings)
        .with_min_opening_duration(dur.from_secs(20))
        .with_min_ending_duration(dur.from_secs(20))
    )
    infos = cmp.search_pair_infos(fhs, cmp.pair_order(len(fhs)))
    entries = [
        [list(x) for x in (i.src_openings, i.dst_openings, i.src_endings,
                           i.dst_endings)]
        for i in infos
    ]
    res = cmp.run_with_frame_hashes(fhs, False, False, False)
    return _canon((entries, [(r.opening, r.ending) for r in res]))


ROUTES = {
    # route: (NEEDLE_TPU_SEARCH_PREFILTER, NEEDLE_TPU_SEARCH_DIRECT, JAX kernel)
    "direct": ("on", "on", "tiles"),
    "band": ("on", "off", "pallas"),
    "pair": ("on", "off", "tiles"),
    "walk-all": ("off", "auto", "tiles"),
}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("fixture", ["mixed", "mixed-endings", "weakest"])
def test_engine_routes_equal_jax_and_numpy(monkeypatch, route, fixture):
    from needle_tpu import Comparator as JaxComparator
    from needle_tpu_torch import Comparator

    prefilter, direct, kernel = ROUTES[route]
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", prefilter)
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_DIRECT", direct)
    monkeypatch.setattr(S, "_KERNEL", kernel)
    if route == "pair":
        # band masks inapplicable (as on a bucket over 31 row blocks): the
        # pair-level prefilter runs instead
        monkeypatch.setattr(T, "prefilter_band_masks",
                            lambda t, v, work, *a: (work, None, 0, None))
    walks = []
    real_walk = T.TorchSearchEngine._walk
    monkeypatch.setattr(T.TorchSearchEngine, "_walk",
                        lambda self, *a: walks.append(a[3]) or real_walk(self, *a))
    include_endings = fixture == "mixed-endings"
    fhs = _weakest_library() if fixture == "weakest" else _mixed_library(
        3, include_endings
    )
    before = metrics.snapshot()
    got = _search(lambda p: Comparator(p, device="cpu"), fhs, include_endings)
    after = metrics.snapshot()

    def delta(name):
        return after.get(name, (0.0, 0))[0] - before.get(name, (0.0, 0))[0]

    assert got == _search(lambda p: JaxComparator(p, engine="jax"), fhs,
                          include_endings)
    assert got == _search(lambda p: JaxComparator(p, engine="numpy"), fhs,
                          include_endings)
    assert any(op is not None for op, _ in got[1])
    if include_endings:
        assert any(en is not None for _, en in got[1])
    # the route really ran
    if route == "direct":
        assert not walks and delta("search.direct_items") > 0
    else:
        assert walks and delta("search.direct_items") == 0
    assert (delta("search.prefilter_skipped") > 0) == (
        fixture != "weakest" and route in ("band", "pair")
    )
    if route == "band":
        assert all(m is not None for m in walks)
    else:
        assert all(m is None for m in walks)
