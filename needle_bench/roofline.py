"""The count walk's work and the least time an H100 could take for it.

The count walk visits, for one side (openings or endings) of one pair of
episodes with n and m hashes, the cells (i, j) with 1 <= i < n and
1 <= j < m (comparator.rs's table leaves row 0 and column 0 at zero). On
the walk-all route, which every pair of a season under the prefilter's
2048-pair floor takes, it visits all of them. Each cell is a 32-bit
Hamming distance, counted as 64 int8 operations (a 32-deep +/-1 dot
product on the tensor cores). Each side of a pair must read both hash rows
(4 bytes a hash) and write one 4-byte count per diagonal (n + m - 1 of
them). The work is counted from the pairs' lengths, never from a kernel's
tiles, so every design of the walk is read against the same work.

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W limit.
"""

from __future__ import annotations

OPS_PER_CELL = 64
PEAK_INT8_OPS = 1.979e15
PEAK_BYTES = 3.35e12


def walk_all_work(sides) -> tuple:
    """(cells, bytes) of walking every cell of the (n, m) sides."""
    cells = sum(max(0, n - 1) * max(0, m - 1) for n, m in sides)
    moved = sum(4 * (n + m) + 4 * max(0, n + m - 1) for n, m in sides)
    return cells, moved


def bound_s(cells: int, moved: int) -> tuple:
    """(seconds, "operations" or "bytes"): the larger of the cells' int8
    operations at the peak rate and the bytes at the memory rate."""
    ops_s = OPS_PER_CELL * cells / PEAK_INT8_OPS
    bytes_s = moved / PEAK_BYTES
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
