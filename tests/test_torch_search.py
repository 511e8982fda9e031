"""The port's search engine (needle_tpu_torch TorchSearchEngine, on the CPU)
against needle_tpu's engines, and the port's host-helper copies
(needle_tpu_torch/search/host.py) against their originals. Everything is
compared exactly: RunEntry lists including their BinaryHeap backing order,
and SearchResults."""

import pickle

import numpy as np
import pytest

from needle_tpu import Comparator as JaxComparator
from needle_tpu.data import FrameHashes
from needle_tpu.duration import Duration
from needle_tpu.errors import FrameHashDataNoEnding
from needle_tpu.search import jax_impl as S
from needle_tpu_torch import Comparator
from needle_tpu_torch.search import host as H
from needle_tpu_torch.search import torch_impl as T

STEP = 247619033  # ~0.248 s per hash, in ns


def _fh(opening, ending=None, md5="b" * 32):
    def ts(h, base):
        return (base + np.arange(len(h)) * STEP).astype(np.int64)

    ending = np.zeros(0, np.uint32) if ending is None else ending
    return FrameHashes(
        opening, ts(opening, 2600090703), ending, ts(ending, 900_000_000_000),
        Duration.from_millis(300), md5,
    )


def _shared_run_library(rng, with_endings=False):
    """tests/test_search_pallas.py's 4-episode library: one shared
    70-hash run at a different offset per episode (+ a shared ending)."""
    shared = rng.integers(0, 2**32, size=70, dtype=np.uint32)
    shared_end = rng.integers(0, 2**32, size=90, dtype=np.uint32)
    fhs = []
    for e in range(4):
        h = rng.integers(0, 2**32, size=300 + 40 * e, dtype=np.uint32)
        h[15 + 11 * e : 15 + 11 * e + 70] = shared
        end = None
        if with_endings:
            end = rng.integers(0, 2**32, size=200 + 7 * e, dtype=np.uint32)
            end[60 - 5 * e : 150 - 5 * e] = shared_end
            end[170] ^= np.uint32(0x0F)  # a near-match inside the threshold
        fhs.append(_fh(h, end))
    return fhs


def _overflow_library(rng):
    """tests/test_search_pallas.py's K_CANDS overflow fixture: sparse
    periodic corruption gives more than K_CANDS run ends on the main
    diagonal of every pair."""
    base = rng.integers(0, 2**32, size=600, dtype=np.uint32)
    fhs = []
    for e in range(3):
        h = base.copy()
        h[e + 3 :: 37] ^= np.uint32(0xFFFFFFFF)
        fhs.append(_fh(h, md5=f"{e:032x}"))
    return fhs


def _run(cmp, fhs, include_endings, min_secs):
    cmp = (
        cmp.with_include_endings(include_endings)
        .with_min_opening_duration(Duration.from_secs(min_secs))
        .with_min_ending_duration(Duration.from_secs(min_secs))
    )
    pairs = cmp.pair_order(len(fhs))
    infos = cmp.search_pair_infos(fhs, pairs)
    entries = [
        [list(x) for x in (i.src_openings, i.dst_openings, i.src_endings,
                           i.dst_endings)]
        for i in infos
    ]
    res = cmp.run_with_frame_hashes(
        fhs, display=False, use_skip_files=False, write_skip_files=False
    )
    return entries, [(r.opening, r.ending) for r in res]


def _engines(monkeypatch, n, with_jax=True):
    paths = [f"p{k}.mkv" for k in range(n)]
    yield "torch", lambda: Comparator(paths, device="cpu")
    yield "numpy", lambda: JaxComparator(paths, engine="numpy")
    if with_jax:
        for kernel in ("pallas", "tiles"):
            def make(kernel=kernel):
                monkeypatch.setattr(S, "_KERNEL", kernel)
                return JaxComparator(paths, engine="jax")
            yield f"jax-{kernel}", make


@pytest.mark.parametrize(
    "fixture,include_endings,min_secs",
    [("shared", False, 12), ("shared", True, 12), ("overflow", False, 2)],
)
def test_engine_matches_jax_and_numpy(rng, monkeypatch, fixture,
                                      include_endings, min_secs):
    fhs = (
        _shared_run_library(rng, include_endings)
        if fixture == "shared"
        else _overflow_library(rng)
    )
    got = {}
    for name, make in _engines(monkeypatch, len(fhs)):
        got[name] = _run(make(), fhs, include_endings, min_secs)
    for name in got:
        assert got[name] == got["numpy"], name
    entries, results = got["torch"]
    assert any(op is not None for op, _ in results)
    if include_endings:
        assert any(en is not None for _, en in results)
    if fixture == "overflow":
        # the fixture really overflows the device extraction
        assert max(len(e[0]) for e in entries) > T.K_CANDS


def test_engine_raises_without_ending_data(rng):
    fhs = _shared_run_library(rng, with_endings=False)
    cmp = Comparator([f"p{k}.mkv" for k in range(4)], device="cpu")
    with pytest.raises(FrameHashDataNoEnding):
        cmp.with_include_endings(True).search_pair_infos(fhs, [(0, 1)])


def test_extract_batch_matches_jax(rng):
    """The torch extraction (top-K run ends per flagged diagonal) equals
    _batch_extract_candidates on the same items."""
    import jax.numpy as jnp
    import torch

    n_pad, e_pad = 512, 4
    table = rng.integers(0, 2**32, size=(e_pad, n_pad), dtype=np.uint32)
    table[1, 100:180] = table[0, 40:120]
    table[2, 10::23] = table[0, 10::23]
    nvs = np.array([500, 480, 512, 300], np.int32)
    vtab = np.zeros((e_pad, n_pad), bool)
    for s, nv in enumerate(nvs):
        vtab[s, 1:nv] = True
    ia = np.array([0, 0, 0, 3, 1], np.int32)
    ib = np.array([1, 2, 2, 0, 1], np.int32)
    off = np.array([60, 0, 23, -200, 0], np.int32)
    lm = np.array([5, 1, 1, 2, np.iinfo(np.int32).max], np.int32)
    want = S._batch_extract_candidates(
        jnp.asarray(table), jnp.asarray(vtab),
        S._pad_tables(jnp.asarray(table), n_pad), jnp.asarray(ia),
        jnp.asarray(ib), jnp.asarray(off), jnp.asarray(lm), 10, n_pad,
    )
    tab_t = torch.from_numpy(table.view(np.int32))
    got = T._extract_batch(
        tab_t, torch.from_numpy(nvs),
        torch.nn.functional.pad(tab_t, (n_pad, n_pad)),
        *(torch.from_numpy(a).long() for a in (ia, ib, off)),
        torch.from_numpy(lm), 10, n_pad,
    )
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert np.asarray(want[2])[1] > T.K_CANDS  # one item overflows


# -- host.py copies against their originals -----------------------------------


def test_diag_candidates_copy(rng):
    hs = rng.integers(0, 2**32, size=300, dtype=np.uint32)
    hd = rng.integers(0, 2**32, size=260, dtype=np.uint32)
    hd[50:120] = hs[20:90]
    hd[51:119:9] ^= np.uint32(0x3)
    for off in (-299, -40, 0, 30, 259, 400):
        for thr in (0, 1, 10):
            assert H._diag_candidates(hs, hd, off, thr) == S._diag_candidates(
                hs, hd, off, thr
            )


def test_heap_perm_segments_copy(rng):
    sizes = [1] * 20 + [2] * 300 + [3] * 250 + [7] * 100 + [19] * 40 + [63, 128]
    rng.shuffle(sizes)
    gb = np.concatenate([[0], np.cumsum(sizes)])
    rank = rng.integers(0, 9, size=int(gb[-1])).astype(np.int64)
    np.testing.assert_array_equal(
        H._heap_perm_segments(rank, gb[:-1], gb),
        S._heap_perm_segments(rank, gb[:-1], gb),
    )


def test_episode_side_copy(rng):
    h = rng.integers(0, 2**32, size=50, dtype=np.uint32)
    ts = np.cumsum(rng.integers(0, 3, size=50)).astype(np.int64)
    a, b = H._EpisodeSide(h, ts), S._EpisodeSide(h, ts)
    assert a.max_spacing == b.max_spacing
    np.testing.assert_array_equal(a.simhash_prefix, b.simhash_prefix)


def test_entries_batch_and_lazy_entries_copy(rng):
    """_entries_batch on the same candidates gives the same _LazyEntries
    windows as the original (materialized, vote columns, winner lookup,
    pickling)."""
    n_eps, n_pad = 6, 256
    sides_h, sides_s = [], []
    for _ in range(n_eps):
        n = int(rng.integers(150, 250))
        hashes = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        ts = np.cumsum(rng.integers(80, 160, size=n)).astype(np.int64) * 10**6
        sides_h.append(H._EpisodeSide(hashes, ts))
        sides_s.append(S._EpisodeSide(hashes, ts))
    hds = [Duration.from_nanos(123800000)] * n_eps
    work = [(a, b) for a in range(n_eps) for b in range(a + 1, n_eps)]
    w_a = np.array([a for a, _ in work], np.int64)
    w_b = np.array([b for _, b in work], np.int64)
    cands = []
    for row, (a, b) in enumerate(work):
        if row in (0, 7):
            continue
        for _ in range(int(rng.integers(1, 6))):
            L = int(rng.integers(2, 80))
            cands.append((row, int(rng.integers(L, len(sides_h[a].hashes))),
                          int(rng.integers(L, len(sides_h[b].hashes))), L))
    c = np.array(cands, np.int64)
    args = (
        c[:, 0], c[:, 1], c[:, 2], c[:, 3], np.arange(len(work)),
        w_a.astype(np.int32), w_b.astype(np.int32), w_a, w_b,
        list(range(n_eps)),
    )
    got = {p: [] for p in range(len(work))}
    want = {p: [] for p in range(len(work))}
    H._entries_batch(got, *args, sides_h, hds, True, int(3e9), n_pad, n_eps)
    eng = S.JaxSearchEngine.__new__(S.JaxSearchEngine)
    eng._entries_batch(want, *args, sides_s, hds, True, int(3e9), n_pad, n_eps)
    assert sum(len(v) for v in got.values()) > 0
    for p in want:
        g, w = got[p], want[p]
        assert list(g) == list(w), p
        if not len(w):
            continue
        assert isinstance(g, H._LazyEntries)
        for src in (True, False):
            for x, y in zip(g.vote_cols(src), w.vote_cols(src)):
                np.testing.assert_array_equal(x, y)
            assert g.entry_run_hd(len(g) - 1, src) == w.entry_run_hd(
                len(w) - 1, src
            )
        assert pickle.loads(pickle.dumps(g)) == list(w)


def test_engine_chunk_boundaries(rng, monkeypatch):
    """Several count-walk chunks (with a partial, padded tail) and several
    extraction chunks give the same entries as one of each."""
    shared = rng.integers(0, 2**32, size=80, dtype=np.uint32)
    fhs = []
    for e in range(7):  # 21 pairs
        h = rng.integers(0, 2**32, size=200 + 9 * e, dtype=np.uint32)
        h[5 + 3 * e : 85 + 3 * e] = shared
        fhs.append(_fh(h, md5=f"{e:032x}"))
    paths = [f"c{k}.mkv" for k in range(7)]
    whole = _run(Comparator(paths, device="cpu"), fhs, False, 5)
    monkeypatch.setattr(T, "CHUNK", 4)
    monkeypatch.setattr(T, "EXTRACT_CHUNK", 3)
    chunked = _run(Comparator(paths, device="cpu"), fhs, False, 5)
    assert chunked == whole
    assert whole == _run(JaxComparator(paths, engine="numpy"), fhs, False, 5)
    assert sum(len(e[0]) for e in whole[0]) >= 21
