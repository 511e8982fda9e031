"""Host-side halves of the all-pairs search, shared by every engine of the
port.

Copies of the numpy helpers of needle_tpu/search/jax_impl.py, which that
module keeps under a top-level `import jax`: the per-episode side cache,
the BinaryHeap permutation, the array-backed entry lists, the exact
per-diagonal rescan and the library-wide entry assembly. They are kept
identical to the originals (tests/test_torch_search.py holds each against
its original on the same inputs).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from needle_tpu.duration import Duration
from needle_tpu.search.oracle import RunEntry


def _diag_candidates(
    hs: np.ndarray, hd: np.ndarray, off: int, threshold: int
) -> List[Tuple[int, int, int]]:
    """All run-end candidates (i, j, run_len) along one diagonal j = i + off.

    O(n) host rescan with semantics identical to the device kernel and the
    reference DP: indices start at 1 (the reference zeroes row/col 0 of its
    table, comparator.rs:179), a run ends where the next cell mismatches or
    either sequence ends. Min-duration filtering happens later against real
    timestamps (_entries_from_candidates), exactly as the reference does.
    """
    from needle_tpu.search.oracle import popcount_u32

    n, m = len(hs), len(hd)
    lo, hi = max(1, 1 - off), min(n, m - off)
    if hi <= lo:
        return []
    i = np.arange(lo, hi)
    match = popcount_u32(hs[i] ^ hd[i + off]) <= threshold
    if not match.any():
        return []
    c = np.cumsum(match)
    z = np.where(match, 0, c)
    run = c - np.maximum.accumulate(z)
    ends = match & np.append(~match[1:], True)
    pos = np.flatnonzero(ends)
    return [
        (int(i[p]), int(i[p] + off), int(run[p])) for p in pos
    ]


class _EpisodeSide:
    """Cached per-episode arrays for one segment type (opening/ending)."""

    __slots__ = ("hashes", "ts", "max_spacing", "_simhash_prefix")

    def __init__(self, hashes: np.ndarray, ts: np.ndarray):
        self.hashes = np.asarray(hashes, dtype=np.uint32)
        self.ts = np.asarray(ts, dtype=np.int64)
        self._simhash_prefix = None
        if len(ts) >= 2:
            # Clamp to >= 1: identical timestamps (corrupt or externally
            # produced .dat files) would otherwise divide-by-zero in the
            # min-run-length bound. A smaller-than-true spacing only
            # over-flags diagonals; the exact host filter stays correct.
            self.max_spacing = max(1, int(np.max(np.diff(self.ts))))
        else:
            self.max_spacing = 1

    @property
    def simhash_prefix(self) -> np.ndarray:
        """Per-bit prefix sums, computed once per episode (reused by every
        pair this episode participates in — at N episodes that is N-1
        pairs, so per-pair recompute dominated host time at scale)."""
        if self._simhash_prefix is None:
            from needle_tpu.search.oracle import simhash_prefix

            self._simhash_prefix = simhash_prefix(self.hashes)
        return self._simhash_prefix


def _heap_perm_segments(rank: np.ndarray, g0: np.ndarray, gb: np.ndarray) -> np.ndarray:
    """BinaryHeap backing-order permutation for every segment
    [g0[k], gb[k+1]) of `rank`, vectorized across same-size segments.

    `rank` must order identically to the entries' Ord keys (a dense rank —
    EQUAL keys must map to EQUAL ranks, since sift-up stops on <=). For
    each segment size the BinaryHeap push sequence is simulated across all
    segments of that size at once: the heap slot layout is identical, only
    the data-dependent sift swaps differ, and those vectorize as masked
    row updates. Segments of a rare size fall back to the scalar
    `binary_heap_perm`. Equivalence with the scalar spec is pinned by
    tests across sizes and tie patterns."""
    from needle_tpu.search.oracle import binary_heap_perm

    n_tot = len(rank)
    out = np.empty(n_tot, np.int64)
    sizes = (gb[1:] - g0).astype(np.int64)
    starts = g0.astype(np.int64)
    rank_l = None
    for n in np.unique(sizes):
        seg = np.flatnonzero(sizes == n)
        st = starts[seg]
        if n == 1:
            out[st] = st
            continue
        if n * len(seg) < 512:
            # scalar fallback: cheaper than numpy dispatch overhead for a
            # handful of tiny segments
            if rank_l is None:
                rank_l = rank.tolist()
            for s0 in st.tolist():
                s1 = s0 + int(n)
                p = binary_heap_perm(rank_l[s0:s1])
                out[s0:s1] = [s0 + q for q in p]
            continue
        m = len(seg)
        gather = st[:, None] + np.arange(n)[None, :]
        karr = rank[gather]  # (m, n) keys in push order
        data = np.zeros((m, n), np.int64)  # local index per heap slot
        kk = np.empty((m, n), np.int64)
        kk[:, 0] = karr[:, 0]
        rows_all = np.arange(m)
        for j in range(1, int(n)):
            pos = np.full(m, j, np.int64)
            key = karr[:, j]
            active = np.ones(m, bool)
            while True:
                parent = (pos - 1) >> 1
                pk = kk[rows_all, parent]
                swap = active & (key > pk)
                r = np.flatnonzero(swap)
                if len(r):
                    data[r, pos[r]] = data[r, parent[r]]
                    kk[r, pos[r]] = pk[r]
                pos = np.where(swap, parent, pos)
                active = swap & (pos > 0)
                if not active.any():
                    break
            data[rows_all, pos] = j
            kk[rows_all, pos] = key
        out[gather] = st[:, None] + data
    return out


class _LazyEntries:
    """Array-backed `List[RunEntry]` for one pair, in BinaryHeap backing
    order.

    A dense whole-library scan produces millions of entries, and
    materializing RunEntry + 4 Duration objects for each is costly — yet
    the only production consumer is `Comparator.find_best_match`, which needs just
    the simhash / run-duration COLUMNS for voting and the (run, hash
    duration) of the single winning candidate. This class keeps the
    columns as shared permuted arrays (`cols` is one tuple shared by every
    pair of a scan; this object holds only a [s0, s1) window) and
    materializes RunEntry objects lazily on first sequence-style access,
    so equivalence tests and any list-consuming caller see exactly the
    objects the per-pair assembly would have built.

    cols layout: (L, ss, se, ds, de, ssim, dsim, sdur, ddur) — int64
    nanos / uint64 simhashes, already in heap order globally.
    """

    __slots__ = ("cols", "s0", "s1", "src_hd", "dst_hd", "is_opening", "_mat")

    def __init__(self, cols, s0, s1, src_hd, dst_hd, is_opening):
        self.cols = cols
        self.s0 = int(s0)
        self.s1 = int(s1)
        self.src_hd = src_hd
        self.dst_hd = dst_hd
        self.is_opening = is_opening
        self._mat = None

    # -- cheap protocol (no materialization) --------------------------------
    def __len__(self):
        return self.s1 - self.s0

    def vote_cols(self, is_source: bool):
        """(simhash, run-duration-nanos) column views for find_best_match's
        vote, for this pair viewed from the src or dst episode."""
        L, ss, se, ds, de, ssim, dsim, sdur, ddur = self.cols
        if is_source:
            return ssim[self.s0 : self.s1], sdur[self.s0 : self.s1]
        return dsim[self.s0 : self.s1], ddur[self.s0 : self.s1]

    def entry_run_hd(self, k: int, is_source: bool):
        """((run_start, run_end), hash_duration) of entry k — Durations
        constructed for this one entry only (the vote winner)."""
        L, ss, se, ds, de, ssim, dsim, sdur, ddur = self.cols
        g = self.s0 + k
        if is_source:
            a, b, hd = int(ss[g]), int(se[g]), self.src_hd
        else:
            a, b, hd = int(ds[g]), int(de[g]), self.dst_hd
        da = Duration.__new__(Duration)
        da._nanos = a
        db = Duration.__new__(Duration)
        db._nanos = b
        return (da, db), hd

    # -- list-compatible access (materializes) ------------------------------
    def materialize(self):
        if self._mat is None:
            L, ss, se, ds, de, ssim, dsim, _, _ = self.cols
            s0, s1 = self.s0, self.s1
            is_opening = self.is_opening
            not_opening = not is_opening
            src_hd, dst_hd = self.src_hd, self.dst_hd
            D_new = Duration.__new__
            out = []
            for k in range(s0, s1):
                d_ss = D_new(Duration)
                d_ss._nanos = int(ss[k])
                d_se = D_new(Duration)
                d_se._nanos = int(se[k])
                d_ds = D_new(Duration)
                d_ds._nanos = int(ds[k])
                d_de = D_new(Duration)
                d_de._nanos = int(de[k])
                out.append(
                    RunEntry(
                        int(L[k]),
                        (d_ss, d_se),
                        (d_ds, d_de),
                        int(ssim[k]),
                        int(dsim[k]),
                        is_opening,
                        not_opening,
                        is_opening,
                        not_opening,
                        src_hd,
                        dst_hd,
                    )
                )
            self._mat = out
        return self._mat

    def __getitem__(self, k):
        return self.materialize()[k]

    def __iter__(self):
        return iter(self.materialize())

    def __eq__(self, other):
        if isinstance(other, _LazyEntries):
            other = other.materialize()
        if isinstance(other, list):
            return self.materialize() == other
        return NotImplemented

    def __repr__(self):
        return f"_LazyEntries({self.materialize()!r})"

    def __reduce__(self):
        # Cross-process transport (parallel.distributed pickles infos):
        # arrive as the canonical plain list of RunEntry.
        return (list, (self.materialize(),))


def _entries_batch(
    results, cand_row, cand_i, cand_j, cand_L,
    w_pidx, w_sa, w_sb, w_a, w_b, ep_ids, sides,
    hash_durations, is_opening, min_dur_ns, n_pad, e_pad,
) -> None:
    """Candidates (parallel arrays; cand_row indexes the work rows
    w_*) -> `results[pair] = _LazyEntries` in reference order.

    Library-wide vectorization of the per-pair scalar spec
    (needle_tpu's JaxSearchEngine._entries_from_candidates). One lexsort
    establishes every pair's reference walk order, timestamp gathers and
    the min-duration filter run over a (e_pad, n_pad) ts table, simhashes
    batch per episode (prefix sums are per-episode anyway), and heap keys
    come from the arrays instead of per-entry ord_key() calls."""
    from needle_tpu.search.oracle import simhash32_from_prefix

    if len(cand_row) == 0:
        return
    # reference walk order within each pair: sorted by (-i, -j)
    order = np.lexsort((-cand_j, -cand_i, cand_row))
    row = cand_row[order]
    i = cand_i[order]
    j = cand_j[order]
    L = cand_L[order]
    ssi, dsi = i - L, j - L

    ts_tab = np.zeros((e_pad, n_pad), np.int64)
    for s, e in enumerate(ep_ids):
        t = sides[e].ts
        ts_tab[s, : len(t)] = t
    sa, sb = w_sa[row], w_sb[row]
    src_start, src_end = ts_tab[sa, ssi], ts_tab[sa, i]
    dst_start, dst_end = ts_tab[sb, dsi], ts_tab[sb, j]
    sel = np.flatnonzero(
        ((src_end - src_start) >= min_dur_ns)
        & ((dst_end - dst_start) >= min_dur_ns)
    )
    if len(sel) == 0:
        return
    row, i, j, L, ssi, dsi = (
        row[sel], i[sel], j[sel], L[sel], ssi[sel], dsi[sel]
    )
    src_start, src_end = src_start[sel], src_end[sel]
    dst_start, dst_end = dst_start[sel], dst_end[sel]
    sa, sb = sa[sel], sb[sel]

    # simhash per episode (not per pair): group the surviving
    # candidates by src/dst slot and evaluate each episode's prefix
    # sums once over all its ranges
    def sim_by_slot(slots, starts, ends):
        out = np.empty(len(slots), np.uint64)
        o2 = np.argsort(slots, kind="stable")
        sl = slots[o2]
        g0 = np.flatnonzero(np.r_[True, sl[1:] != sl[:-1]])
        gb = np.r_[g0, len(sl)]
        for g in range(len(g0)):
            idx = o2[gb[g] : gb[g + 1]]
            prefix = sides[ep_ids[int(sl[gb[g]])]].simhash_prefix
            out[idx] = simhash32_from_prefix(prefix, starts[idx], ends[idx])
        return out

    src_sim = sim_by_slot(sa, ssi, i)
    dst_sim = sim_by_slot(sb, dsi, j)

    # RunEntry objects are NOT constructed here (costly per entry even
    # with inlined constructors). The BinaryHeap backing order is a
    # pure function of the Ord keys, so compute the per-pair heap
    # PERMUTATION on key tuples, apply it to the columns once
    # library-wide, and hand each pair a _LazyEntries window that
    # materializes objects only if something list-walks it (the
    # production consumer, find_best_match, reads the columns).
    # per-pair groups (row is sorted ascending)
    g0 = np.flatnonzero(np.r_[True, row[1:] != row[:-1]])
    gb = np.r_[g0, len(row)]
    # Dense rank replacing the Ord-key tuples: one lexsort orders the
    # 7-column key prefix (the dropped suffix — flags, hash durations —
    # is constant within one pair's heap, so it can never change a
    # comparison), adjacent-distinct cumsum assigns EQUAL keys EQUAL
    # ranks (sift-up stops on <=, so ties are semantic), and the heap
    # simulation then compares single ints instead of 7-tuples.
    key_cols = (L, src_start, src_end, dst_start, dst_end, src_sim, dst_sim)
    o = np.lexsort(key_cols[::-1])
    neq = np.zeros(len(o), bool)
    for c in key_cols:
        cs = c[o]
        neq[1:] |= cs[1:] != cs[:-1]
    rank = np.empty(len(o), np.int64)
    rank[o] = np.cumsum(neq)
    pa = _heap_perm_segments(rank, g0, gb)
    src_start, src_end = src_start[pa], src_end[pa]
    dst_start, dst_end = dst_start[pa], dst_end[pa]
    cols = (
        L[pa],
        src_start,
        src_end,
        dst_start,
        dst_end,
        src_sim[pa],
        dst_sim[pa],
        src_end - src_start,
        dst_end - dst_start,
    )
    rows_first = row[g0]
    pidx_l = w_pidx[rows_first].tolist()
    ha_l = w_a[rows_first].tolist()
    hb_l = w_b[rows_first].tolist()
    s0_l = gb[:-1].tolist()
    s1_l = gb[1:].tolist()
    for pidx, ai, bi, s0, s1 in zip(pidx_l, ha_l, hb_l, s0_l, s1_l):
        results[pidx] = _LazyEntries(
            cols, s0, s1, hash_durations[ai], hash_durations[bi], is_opening
        )
