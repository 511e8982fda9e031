"""The count walk's launch timer and its bound on the card.

The bound of a count walk run is the least time the card could take for
its work: the larger of 64 int8 operations per walked cell (a 32-deep
+/-1 dot product) at the card's int8 rate and the bytes the launches must
move (both hash rows of every lane in, the int32 counts out) at its memory
rate, with the H100 SXM's published peaks. Cells and bytes count what the
inputs and band masks ask for, not what a kernel happens to do, so every
design of the kernel is read against the same work. A design that
computed cells as 1-bit products (`xor` and `popc` on whole words) would
do fewer operations per cell, and its operation count would need to be
worked out anew.
"""

from __future__ import annotations

import numpy as np

from ..search.diag_runs import D_TILE, G_TILES, full_block_mask, n_groups_for

OPS_PER_CELL = 64
PEAK_INT8_OPS = 1.979e15
PEAK_BYTES = 3.35e12


def walked_cells(nv, mv, bm, n_pad: int, n_pairs: int = None) -> int:
    """Cells the count walk visits for the first n_pairs lanes (default:
    all): valid (i, j) cells (1 <= i < nv, 1 <= j < mv) on the row blocks
    their mask group allows (bit min((i + 1) // 512, 31) of bm[p, group],
    group = (j - i + n_pad - 1) // (G_TILES * D_TILE)). Padding lanes have
    mask 0 and count nothing."""
    nv, mv, bm = (np.asarray(a, np.int64)[:n_pairs] for a in (nv, mv, bm))
    span = G_TILES * D_TILE  # diagonals per mask group
    i = np.arange(n_pad, dtype=np.int64)
    shift = np.minimum((i + 1) // D_TILE, 31)
    rows = (i[None, :] >= 1) & (i[None, :] < nv[:, None])
    total = 0
    for g in range(bm.shape[1]):
        o_lo = g * span - (n_pad - 1)
        lo = np.maximum(1, i + o_lo)[None, :]
        hi = np.minimum(mv[:, None] - 1, (i + o_lo + span - 1)[None, :])
        allowed = rows & (((bm[:, g : g + 1] >> shift[None, :]) & 1) == 1)
        total += int(np.where(allowed, np.maximum(0, hi - lo + 1), 0).sum())
    return total


def walk_bytes(chunk: int, n_pad: int, n_out: int) -> int:
    """Bytes one count walk launch must move: both hash rows of every lane
    in, the int32 counts out."""
    return chunk * n_pad * 8 + chunk * n_out * 4


def walk_bound(cells: int, moved: int):
    """(bound ms, "operations" or "bytes"): the larger of the cells' int8
    operations at the card's peak and the moved bytes at its memory rate."""
    ops_ms = OPS_PER_CELL * cells / PEAK_INT8_OPS * 1e3
    bytes_ms = moved / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


class WalkTimer:
    """Times every count walk launch of the search engine with CUDA events
    around it (no synchronisation inside the run), adds up the bytes each
    launch moves and keeps each launch's lengths and masks for
    `cells()`. Use as a context manager around a search on the card; it
    rebinds `search.torch_impl.batch_counts`."""

    def __init__(self):
        self.events = []
        self.moved = 0
        self.launched = []  # (nv, mv, bm, n_pad) of each launch

    def __enter__(self):
        import torch

        from ..search import torch_impl as T

        self.real = T.batch_counts

        def counts(nv, mv, lm, thr, src, dst, n_pad, bm=None):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.real(nv, mv, lm, thr, src, dst, n_pad, bm=bm)
            end.record()
            self.events.append((start, end))
            self.moved += walk_bytes(src.shape[0], n_pad, out.shape[1])
            self.launched.append((nv, mv, bm, n_pad))
            return out

        T.batch_counts = counts
        return self

    def __exit__(self, *exc):
        from ..search import torch_impl as T

        T.batch_counts = self.real

    def ms(self) -> float:
        """Kernel milliseconds of the timed launches, in all."""
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)

    def cells(self) -> int:
        """Cells walked by the timed launches, from their lengths and
        masks (`walked_cells`)."""
        total = 0
        for nv, mv, bm, n_pad in self.launched:
            if bm is None:
                bm = np.full((len(nv), n_groups_for(n_pad)),
                             full_block_mask(n_pad), np.int32)
            else:
                bm = bm.cpu().numpy()
            total += walked_cells(nv.cpu().numpy(), mv.cpu().numpy(), bm, n_pad)
        return total
