"""Reference-exact NumPy implementation of the pairwise hash search (the
port's own copy of needle_tpu/search/oracle.py): the per-pair engine that
TorchSearchEngine is held against, and the heap-order and simhash helpers
its host assembly shares.

Replicates needle/src/audio/comparator.rs precisely:

  * the LCS dynamic program over two hash sequences, where hashes match when
    popcount(src ^ dst) <= hash_match_threshold (comparator.rs:174-187) —
    including the quirk that row 0 / column 0 are forced to zero, so runs can
    never include index 0 of either sequence;
  * run-end detection during the reverse table walk (comparator.rs:191-199),
    with boundary cells (last row/column) always treated as run ends;
  * start indices one *before* the first matched index
    (src_start_idx = i - table[i][j], comparator.rs:206-209);
  * validity: both src and dst run durations must be >= the min duration for
    the segment type (comparator.rs:212-218);
  * per-run simhash32 over hashes[start..=end] (comparator.rs:149-153, 226-229);
  * the entries' final ordering, which in the reference is the backing array
    of a rust std BinaryHeap after N pushes (`heap.into()`, comparator.rs:249)
    — we emulate BinaryHeap::push (sift-up with <=) and the derived
    lexicographic Ord of ComparatorHeapEntry so downstream tie-breaking
    behaves identically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from ..duration import Duration


def popcount_u32(x: np.ndarray) -> np.ndarray:
    """Popcount of uint32 array elements."""
    x = np.asarray(x, dtype=np.uint32)
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x).astype(np.int32)
    v = x.copy()
    v = v - ((v >> np.uint32(1)) & np.uint32(0x55555555))
    v = (v & np.uint32(0x33333333)) + ((v >> np.uint32(2)) & np.uint32(0x33333333))
    v = (v + (v >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((v * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int32)


def simhash_prefix(hashes: np.ndarray) -> np.ndarray:
    """Per-bit prefix sums for O(1) range simhashes; compute once per
    episode and reuse across all of its pairs."""
    hashes = np.asarray(hashes, dtype=np.uint32)
    bits = (hashes[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & np.uint32(1)
    csum = np.zeros((len(hashes) + 1, 32), dtype=np.int64)
    np.cumsum(bits, axis=0, out=csum[1:])
    return csum


def simhash32_from_prefix(
    csum: np.ndarray, starts: np.ndarray, ends: np.ndarray
) -> np.ndarray:
    """simhash32 over [s..=e] ranges from precomputed prefix sums."""
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    counts = csum[ends + 1] - csum[starts]  # (k, 32)
    n = (ends - starts + 1)[:, None]
    out_bits = (2 * counts > n).astype(np.uint64)
    return (out_bits << np.arange(32, dtype=np.uint64)[None, :]).sum(axis=1).astype(np.uint64)


def simhash32_batch(hashes: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """simhash32 over hashes[s..=e] for many (s, e) ranges."""
    return simhash32_from_prefix(simhash_prefix(hashes), starts, ends)


@dataclass(slots=True)
class RunEntry:
    """Mirror of ComparatorHeapEntry (comparator.rs:22-35).

    slots=True: a dense whole-library scan can construct millions of
    these (one per valid candidate)."""

    score: int
    src_longest_run: Tuple[Duration, Duration]
    dst_longest_run: Tuple[Duration, Duration]
    src_match_hash: int
    dst_match_hash: int
    is_src_opening: bool
    is_src_ending: bool
    is_dst_opening: bool
    is_dst_ending: bool
    src_hash_duration: Duration = field(default_factory=Duration)
    dst_hash_duration: Duration = field(default_factory=Duration)

    def ord_key(self):
        """Rust derived Ord: lexicographic over fields in declaration order
        (Duration orders as (secs, nanos); bool as false < true)."""
        return (
            self.score,
            self.src_longest_run[0].total_nanos(),
            self.src_longest_run[1].total_nanos(),
            self.dst_longest_run[0].total_nanos(),
            self.dst_longest_run[1].total_nanos(),
            self.src_match_hash,
            self.dst_match_hash,
            self.is_src_opening,
            self.is_src_ending,
            self.is_dst_opening,
            self.is_dst_ending,
            self.src_hash_duration.total_nanos(),
            self.dst_hash_duration.total_nanos(),
        )


def binary_heap_order(entries: List[RunEntry]) -> List[RunEntry]:
    """Emulate `BinaryHeap::push` for each entry in order, then `heap.into()`
    (which exposes the heap's backing array, NOT sorted order)."""
    return binary_heap_order_keyed(entries, [e.ord_key() for e in entries])


def binary_heap_order_keyed(entries: List[RunEntry], ord_keys) -> List[RunEntry]:
    """`binary_heap_order` with caller-supplied Ord keys.

    `ord_keys[k]` must order identically to `entries[k].ord_key()`; any
    constant suffix of the full Ord tuple may be dropped (a shared suffix
    never changes lexicographic comparisons within one call). Lets batched
    engines build keys from arrays instead of per-entry ord_key() calls."""
    data: List[RunEntry] = []
    keys = []
    for e, k in zip(entries, ord_keys):
        data.append(e)
        keys.append(k)
        # sift_up(start=0, pos=len-1)
        pos = len(data) - 1
        item, key = data[pos], keys[pos]
        while pos > 0:
            parent = (pos - 1) // 2
            if key <= keys[parent]:
                break
            data[pos], keys[pos] = data[parent], keys[parent]
            pos = parent
        data[pos], keys[pos] = item, key
    return data


def binary_heap_perm(keys) -> List[int]:
    """`binary_heap_order` as a permutation: the index order the BinaryHeap
    backing array would hold after pushing items with these Ord keys in
    sequence. Lets batched engines order column ARRAYS into heap order
    without constructing the entry objects first."""
    data: List[int] = []
    kk: list = []
    for idx, key in enumerate(keys):
        data.append(idx)
        kk.append(key)
        pos = len(data) - 1
        while pos > 0:
            parent = (pos - 1) // 2
            if key <= kk[parent]:
                break
            data[pos], kk[pos] = data[parent], kk[parent]
            pos = parent
        data[pos], kk[pos] = idx, key
    return data


def compute_run_table(
    src_hashes: np.ndarray, dst_hashes: np.ndarray, threshold: int
) -> np.ndarray:
    """The LCS DP table (run length ending at (i, j)), with the reference's
    row-0/column-0 zeroing quirk. Returns an (n, m) int32 array."""
    src = np.asarray(src_hashes, dtype=np.uint32)
    dst = np.asarray(dst_hashes, dtype=np.uint32)
    n, m = len(src), len(dst)
    match = popcount_u32(src[:, None] ^ dst[None, :]) <= threshold
    match[0, :] = False
    match[:, 0] = False
    table = np.zeros((n, m), dtype=np.int32)
    for i in range(1, n):
        table[i, 1:] = (table[i - 1, :-1] + 1) * match[i, 1:]
    return table


def find_run_ends(table: np.ndarray) -> np.ndarray:
    """Cells the reference's reverse walk treats as run ends, returned in the
    reference's iteration order (i desc, then j desc). (comparator.rs:191-199)

    Returns an array of (i, j, length) rows.
    """
    n, m = table.shape
    nonzero = table > 0
    interior = np.zeros_like(nonzero)
    # interior iff i < n-1 and j < m-1 and table[i+1][j+1] != 0
    interior[: n - 1, : m - 1] = nonzero[1:, 1:]
    ends = nonzero & ~interior
    # The reference's walk covers i in (1..n).rev(), j in (1..m).rev() only;
    # row/col 0 are zero anyway but slice defensively.
    ends[0, :] = False
    ends[:, 0] = False
    idx = np.argwhere(ends)
    if len(idx) == 0:
        return np.zeros((0, 3), dtype=np.int64)
    order = np.lexsort((-idx[:, 1], -idx[:, 0]))
    idx = idx[order]
    lengths = table[idx[:, 0], idx[:, 1]]
    return np.column_stack([idx, lengths]).astype(np.int64)


def longest_common_hash_match(
    src_hashes: np.ndarray,
    src_ts_nanos: np.ndarray,
    dst_hashes: np.ndarray,
    dst_ts_nanos: np.ndarray,
    src_hash_duration: Duration,
    dst_hash_duration: Duration,
    is_opening: bool,
    hash_match_threshold: int,
    min_opening_duration: Duration,
    min_ending_duration: Duration,
) -> List[RunEntry]:
    """Reference-exact LCS search between two hash sequences
    (comparator.rs:156-250), returning entries in BinaryHeap backing order."""
    n, m = len(src_hashes), len(dst_hashes)
    if n == 0 or m == 0:
        return []

    is_ending = not is_opening
    min_dur = (min_opening_duration if is_opening else min_ending_duration).total_nanos()

    table = compute_run_table(src_hashes, dst_hashes, hash_match_threshold)
    run_ends = find_run_ends(table)
    if len(run_ends) == 0:
        return []

    i, j, length = run_ends[:, 0], run_ends[:, 1], run_ends[:, 2]
    src_start_idx, src_end_idx = i - length, i
    dst_start_idx, dst_end_idx = j - length, j

    src_ts = np.asarray(src_ts_nanos, dtype=np.int64)
    dst_ts = np.asarray(dst_ts_nanos, dtype=np.int64)
    src_start, src_end = src_ts[src_start_idx], src_ts[src_end_idx]
    dst_start, dst_end = dst_ts[dst_start_idx], dst_ts[dst_end_idx]

    valid = ((src_end - src_start) >= min_dur) & ((dst_end - dst_start) >= min_dur)
    if not valid.any():
        return []

    sel = np.flatnonzero(valid)
    src_sim = simhash32_batch(src_hashes, src_start_idx[sel], src_end_idx[sel])
    dst_sim = simhash32_batch(dst_hashes, dst_start_idx[sel], dst_end_idx[sel])

    entries = [
        RunEntry(
            score=int(length[k]),
            src_longest_run=(
                Duration.from_nanos(int(src_start[k])),
                Duration.from_nanos(int(src_end[k])),
            ),
            dst_longest_run=(
                Duration.from_nanos(int(dst_start[k])),
                Duration.from_nanos(int(dst_end[k])),
            ),
            src_match_hash=int(src_sim[q]),
            dst_match_hash=int(dst_sim[q]),
            is_src_opening=is_opening,
            is_src_ending=is_ending,
            is_dst_opening=is_opening,
            is_dst_ending=is_ending,
            src_hash_duration=src_hash_duration,
            dst_hash_duration=dst_hash_duration,
        )
        for q, k in enumerate(sel)
    ]
    return binary_heap_order(entries)
