"""The search's per-pair RunEntry lists and its votes, in plain NumPy.

Runs: a frozen copy of the port's needle_tpu_torch/bench/reference.py
(written from needle's comparator.rs:149-250), with the settings taken
from the configuration. For one side (openings or endings) of one pair,
hashes src[i] and dst[j] match when popcount(src[i] ^ dst[j]) <=
threshold; row 0 and column 0 never match. A run is a maximal stretch of
matching cells along a diagonal (i+k, j+k). For each run, in the order of
its end cell (row descending, then column descending), an entry is kept
when both sides span at least the minimum duration, from the index one
before the run's first cell to its last: (length, src start and end, dst
start and end in ns, the simhash32 of each side's hashes over that span,
the four side flags, the two hash durations). The kept entries go into a
Rust BinaryHeap; the list is its backing array.

Votes: comparator.rs:405-515. Each episode's candidates are its side of
every entry of every pair it is in (pairs in search order, a pair's
opening entries before its ending entries). A candidate's votes are the
candidates of that episode, of either kind, whose simhash lies less than
threshold + threshold // 2 bits from its own; its score is
-(votes x 0.3 + run seconds x 0.7) in float32; the opening (ending) is the
lowest (score, index) among opening (ending) candidates with a vote,
(start, end - hash duration). Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np

NS = 1_000_000_000


def popcount(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.uint32)
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x)
    table = np.array([bin(v).count("1") for v in range(1 << 16)], np.uint8)
    return table[x & 0xFFFF] + table[x >> 16]


def _simhash(hashes: np.ndarray, start: int, end: int) -> int:
    bits = (hashes[start:end + 1, None] >> np.arange(32, dtype=np.uint32)) & 1
    ones = bits.sum(axis=0)
    return sum(1 << b for b in range(32) if 2 * int(ones[b]) > end - start + 1)


def _heap_array(keys):
    heap = []
    for key in keys:
        heap.append(key)
        pos = len(heap) - 1
        while pos and heap[(pos - 1) // 2] < key:
            heap[pos] = heap[(pos - 1) // 2]
            pos = (pos - 1) // 2
        heap[pos] = key
    return heap


def side_entries(src, src_ts, dst, dst_ts, threshold, min_ns, tail):
    """The entries of one side of one pair, as tuples in the heap's
    backing order; `tail` is what every entry of the side ends with."""
    src = np.asarray(src, np.uint32)
    dst = np.asarray(dst, np.uint32)
    if len(src) == 0 or len(dst) == 0:
        return []
    match = popcount(src[:, None] ^ dst[None, :]) <= threshold
    match[0, :] = False
    match[:, 0] = False
    end = match.copy()
    end[:-1, :-1] &= ~match[1:, 1:]
    ei, ej = np.nonzero(end)
    ei, ej = ei[::-1], ej[::-1]
    length = np.ones(len(ei), np.int64)
    live = np.arange(len(ei))
    while len(live):
        live = live[match[ei[live] - length[live], ej[live] - length[live]]]
        length[live] += 1
    s0, d0 = ei - length, ej - length
    keep = ((src_ts[ei] - src_ts[s0] >= min_ns) & (dst_ts[ej] - dst_ts[d0] >= min_ns))
    return _heap_array([
        (int(length[k]), int(src_ts[s0[k]]), int(src_ts[ei[k]]),
         int(dst_ts[d0[k]]), int(dst_ts[ej[k]]),
         _simhash(src, s0[k], ei[k]), _simhash(dst, d0[k], ej[k])) + tail
        for k in np.flatnonzero(keep)])


def pair_entries(src: dict, dst: dict, cfg: dict, threshold: int):
    """(opening entries, ending entries) of one pair of episode_hashes()
    results under the configuration's settings, at `threshold`."""
    hd = (src["hash_duration_ns"], dst["hash_duration_ns"])
    out = []
    for side, is_op, min_s in (("opening", True, cfg["min_opening_s"]),
                               ("ending", False, cfg["min_ending_s"])):
        out.append(side_entries(src[side], src[f"{side}_ts"], dst[side],
                                dst[f"{side}_ts"], threshold, min_s * NS,
                                (is_op, not is_op, is_op, not is_op) + hd))
    return tuple(out)


def pair_order(n: int):
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


def _secs_f32(ns: int) -> np.float32:
    return np.float32(ns // NS) + np.float32(ns % NS) / np.float32(NS)


def votes(n: int, pairs, entries, threshold: int):
    """Per episode, the skip file's {"opening": (start, end) or None,
    "ending": ...} in float32 seconds, or None where nothing is written.
    `entries[k]` is pair_entries() of pairs[k]."""
    cands = [[] for _ in range(n)]  # (simhash, start ns, end ns, hd ns, is opening)
    for (i, j), (op, en) in zip(pairs, entries):
        if not op and not en:
            continue
        for ep, sim, s, e, hd in ((i, 5, 1, 2, 11), (j, 6, 3, 4, 12)):
            for group, is_op in ((op, True), (en, False)):
                cands[ep] += [(t[sim], t[s], t[e], t[hd], is_op) for t in group]
    bias = threshold + threshold // 2
    out = []
    for cs in cands:
        sims = np.array([c[0] for c in cs], np.uint32)
        picked = {}
        best = {}
        for k, (sim, s, e, hd, is_op) in enumerate(cs):
            v = int((popcount(sims ^ np.uint32(sim)) < bias).sum())
            if v == 0:
                continue
            score = -(np.float32(v) * np.float32(0.3) + _secs_f32(e - s) * np.float32(0.7))
            key = (score, k)
            if is_op not in best or key < best[is_op]:
                best[is_op] = key
                picked[is_op] = (s, e - hd)
        result = {side: (None if is_op not in picked else
                         tuple(_secs_f32(t) for t in picked[is_op]))
                  for side, is_op in (("opening", True), ("ending", False))}
        out.append(None if result["opening"] is None and result["ending"] is None
                   else result)
    return out
