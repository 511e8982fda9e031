"""Diagonal-run count walk: the CUDA kernel's wrapper and its plain version.

Port of needle_tpu/search/pallas_impl.py. `batch_counts` launches the
hand-written kernel csrc/diag_runs.cu (Hamming distances on the int8
tensor cores, match bits packed 32 rows a word along each diagonal, runs
counted per word) for CUDA tensors; for CPU tensors it runs
`batch_counts_reference`, the plain PyTorch formulation, which is also what
the kernel is held against on the card. `batch_counts_popc` launches the
previous design (one thread per diagonal, a popcount per cell), kept only
to time the two in one process. `match_words` and `runs_from_words` are a
CPU model of the kernel's run bookkeeping, for the tests.

Hashes travel as int32 bit patterns (torch has no usable uint32 shifts on
the CPU); `popcount32` widens to int64 before shifting, since `>>` on int32
is arithmetic.

The tile geometry (D_TILE, G_TILES, n_groups_for, full_block_mask and the
31-block shift clamp) is identical to the TPU kernel's, because row-block
masks are built against it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

D_TILE = 512
G_TILES = 8  # diagonal tiles per mask group

# Kernel launches in this process; a run reads it to show that the count
# walk went through the CUDA kernel.
LAUNCHES = 0
# Launches of the previous design (batch_counts_popc), counted apart.
LAUNCHES_POPC = 0

# Cells (pairs x rows x diagonals) per slab of the plain version: bounds
# its intermediates to a few hundred MB.
_REFERENCE_CELLS = 1 << 24


def n_tiles_for(n_pad: int) -> int:
    """Diagonal tiles covering the 2*n_pad - 1 offsets of a bucket."""
    return -(-(2 * n_pad - 1) // D_TILE)


def n_groups_for(n_pad: int, g_tiles: int = G_TILES) -> int:
    """Mask groups per pair for this bucket: the width of the per-pair
    row-block bitmask array."""
    return -(-n_tiles_for(n_pad) // g_tiles)


def full_block_mask(n_pad: int) -> np.int32:
    """Bitmask walking every row block. For buckets too long for a 31-bit
    mask, -1 keeps every block (an arithmetic shift preserves the sign bit,
    so (bm >> min(b, 31)) & 1 == 1 for all b)."""
    n_blocks = n_pad // D_TILE + 1
    if n_blocks > 31:
        return np.int32(-1)
    return np.int32((np.int64(1) << n_blocks) - 1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit pattern in an int32 tensor, as int64."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _diag_end_counts(S: torch.Tensor, l_min: torch.Tensor) -> torch.Tensor:
    """(P, n, d) bool matches, (P,) run bound -> (P, d) count of run ends
    with run >= l_min. A run is >= L long at row i iff the L cells ending at
    i all match: c[i] - c[i - L] == L with c the cumulative sum along i
    (needle_tpu/search/jax_impl.py::_diag_end_counts, per-pair L)."""
    P, n, d = S.shape
    c = torch.cumsum(S, dim=1, dtype=torch.int32)
    back = torch.arange(n, device=S.device)[None, :] - l_min[:, None]
    shifted = torch.gather(c, 1, back.clamp(min=0)[:, :, None].expand(P, n, d))
    shifted = torch.where((back >= 0)[:, :, None], shifted, 0)
    window_full = (c - shifted) == l_min[:, None, None]
    S_next = torch.cat([S[:, 1:], torch.zeros_like(S[:, :1])], dim=1)
    return (S & ~S_next & window_full).sum(dim=1, dtype=torch.int32)


def batch_counts_reference(nv, mv, lm, thr, src, dst, n_pad, bm=None):
    """Plain PyTorch version of the count walk: the tiles formulation of
    needle_tpu/search/jax_impl.py (_tile_runs, _diag_end_counts,
    _pair_all_tiles), with every row of a masked-out block set to a
    mismatch — exactly the kernel's flush at the gap. Same arguments and
    result as `batch_counts`, on any device."""
    chunk = src.shape[0]
    dev = src.device
    n_tiles = n_tiles_for(n_pad)
    if bm is None:
        bm = torch.full(
            (chunk, n_groups_for(n_pad)), int(full_block_mask(n_pad)),
            dtype=torch.int32, device=dev,
        )
    out = torch.zeros((chunk, n_tiles * D_TILE), dtype=torch.int32, device=dev)
    i = torch.arange(n_pad, device=dev)
    shift = torch.clamp((i + 1) // D_TILE, max=31).to(torch.int32)
    l_min = lm.clamp(1, n_pad).to(torch.int64)
    step = max(1, _REFERENCE_CELLS // (n_pad * D_TILE))
    for p0 in range(0, chunk, step):
        sl = slice(p0, p0 + step)
        s_src, s_dst = src[sl], dst[sl]
        row_ok = (i[None, :] >= 1) & (i[None, :] < nv[sl, None])  # (P, n)
        for t in range(n_tiles):
            o = t * D_TILE - (n_pad - 1) + torch.arange(D_TILE, device=dev)
            j = i[:, None] + o[None, :]  # (n, D_TILE)
            col_ok = (j >= 1)[None] & (j[None] < mv[sl, None, None])
            dstg = s_dst[:, j.clamp(0, n_pad - 1)]  # (P, n, D_TILE)
            allowed = ((bm[sl, t // G_TILES, None] >> shift[None, :]) & 1) == 1
            S = (
                (popcount32(s_src[:, :, None] ^ dstg) <= thr[sl, None, None])
                & col_ok
                & (row_ok & allowed)[:, :, None]
            )
            out[sl, t * D_TILE : (t + 1) * D_TILE] = _diag_end_counts(
                S, l_min[sl]
            )
    return out


def _check_operands(nv, mv, lm, thr, src, dst, n_pad, bm):
    chunk = src.shape[0] if src.dim() == 2 else -1
    if n_pad <= 0 or n_pad % D_TILE:
        raise ValueError(f"n_pad must be a positive multiple of {D_TILE}")
    for name, t, shape in (
        ("nv", nv, (chunk,)), ("mv", mv, (chunk,)), ("lm", lm, (chunk,)),
        ("thr", thr, (chunk,)), ("src", src, (chunk, n_pad)),
        ("dst", dst, (chunk, n_pad)), ("bm", bm, (chunk, n_groups_for(n_pad))),
    ):
        if t.device != src.device:
            raise ValueError(f"{name} is on {t.device}, src on {src.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(entry, nv, mv, lm, thr, src, dst, n_pad, bm):
    """Run C entry point `entry` of the kernel library on CUDA operands;
    returns the (chunk, n_tiles*512) int32 counts."""
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    chunk = src.shape[0]
    if bm is None:
        bm = torch.full(
            (chunk, n_groups_for(n_pad)), int(full_block_mask(n_pad)),
            dtype=torch.int32, device=src.device,
        )
    _check_operands(nv, mv, lm, thr, src, dst, n_pad, bm)
    n_out = n_tiles_for(n_pad) * D_TILE
    counts = torch.empty((chunk, n_out), dtype=torch.int32, device=src.device)
    if chunk == 0:
        return counts
    err = getattr(_build.load(), entry)(
        nv.data_ptr(), mv.data_ptr(), lm.data_ptr(), thr.data_ptr(),
        bm.data_ptr(), bm.shape[1], src.data_ptr(), dst.data_ptr(),
        counts.data_ptr(), chunk, n_pad, n_out,
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    _build.check(err, entry)
    return counts


def batch_counts(nv, mv, lm, thr, src, dst, n_pad, bm=None):
    """Per-diagonal candidate counts of a chunk of pairs.

    nv, mv, lm, thr: (chunk,) int32 valid lengths, run bound and Hamming
    threshold per pair; src, dst: (chunk, n_pad) int32 hash bit patterns,
    n_pad a multiple of 512; bm: optional (chunk, n_groups) int32 row-block
    masks (default: every block). Returns (chunk, n_tiles*512) int32;
    diagonal index d is offset d - (n_pad - 1).

    CUDA tensors launch the tensor-core kernel (csrc/diag_runs.cu,
    needle_diag_runs), one kernel for every n_pad; CPU tensors run
    `batch_counts_reference`."""
    global LAUNCHES
    if src.device.type == "cpu":
        return batch_counts_reference(nv, mv, lm, thr, src, dst, n_pad, bm)
    counts = _launch("needle_diag_runs", nv, mv, lm, thr, src, dst, n_pad, bm)
    if src.shape[0]:
        LAUNCHES += 1
    return counts


def batch_counts_popc(nv, mv, lm, thr, src, dst, n_pad, bm=None):
    """`batch_counts` by the previous design (needle_diag_runs_popc: one
    thread per diagonal, a popcount per cell), on CUDA tensors only. Kept
    as a yardstick for the kernel; the search never calls it."""
    global LAUNCHES_POPC
    counts = _launch("needle_diag_runs_popc", nv, mv, lm, thr, src, dst, n_pad, bm)
    if src.shape[0]:
        LAUNCHES_POPC += 1
    return counts


def pack_words(S: torch.Tensor) -> torch.Tensor:
    """(P, n, d) bool match bits along rows -> (P, d, ceil(n / 32)) int64
    words, bit r of word w = row 32 * w + r (rows past n read 0)."""
    P, n, d = S.shape
    n_words = -(-n // 32)
    S = torch.cat([S, S.new_zeros((P, n_words * 32 - n, d))], dim=1)
    weights = torch.tensor([1 << r for r in range(32)], dtype=torch.int64)
    S = S.reshape(P, n_words, 32, d).to(torch.int64)
    return (S * weights.to(S.device)[None, None, :, None]).sum(dim=2).transpose(1, 2)


def match_words(nv, mv, thr, src, dst, n_pad, bm=None):
    """The kernel's match bits as words: (chunk, n_tiles*512, n_pad/32 + 1)
    int64, bit r of word w of diagonal d = cell (i, i + d - (n_pad - 1)) at
    row i = 32 * w + r - 1 (words aligned to the mask blocks, which start at
    row -1). A bit is set iff the cell matches (popcount <= thr), 1 <= i <
    nv, 1 <= j < mv and its row block is allowed: validity and the masks'
    flushes are already in the bits. Plain torch, small sizes only."""
    chunk = src.shape[0]
    n_out = n_tiles_for(n_pad) * D_TILE
    if bm is None:
        bm = torch.full((chunk, n_groups_for(n_pad)), int(full_block_mask(n_pad)),
                        dtype=torch.int32)
    i = torch.arange(-1, n_pad, dtype=torch.int64)  # rows -1 .. n_pad - 1
    d = torch.arange(n_out, dtype=torch.int64)
    j = i[:, None] + d[None, :] - (n_pad - 1)
    shift = torch.clamp((i + 1) // D_TILE, max=31)
    group = d // (G_TILES * D_TILE)
    out = []
    for p in range(chunk):
        row_ok = (i >= 1) & (i < nv[p].item())
        col_ok = (j >= 1) & (j < mv[p].item())
        hit = popcount32(src[p, i.clamp(min=0)][:, None] ^ dst[p, j.clamp(0, n_pad - 1)])
        allowed = ((bm[p, group][None, :].to(torch.int64) >> shift[:, None]) & 1) == 1
        S = (hit <= thr[p].item()) & row_ok[:, None] & col_ok & allowed
        out.append(pack_words(S[None])[0])
    return torch.stack(out)


def _leading_ones32(x: torch.Tensor) -> torch.Tensor:
    """__clz(~x) of 32-bit words in int64: the high-order ones of x."""
    v = ~x & 0xFFFFFFFF
    for s in (1, 2, 4, 8, 16):
        v = v | (v >> s)
    return 32 - popcount32(v)


def runs_from_words(words: torch.Tensor, l_min: torch.Tensor) -> torch.Tensor:
    """Per-diagonal run counts from match words, by the kernel's word
    operations (csrc/diag_runs.cu, runs_word), on int64.

    words: (P, D, n_words) int64 in [0, 2**32), bit r of word w = row
    32 * w + r of the diagonal's walk, with validity and mask flushes
    applied (mismatches); l_min: (P,) run bound. Returns (P, D) int32: the
    maximal runs of set bits at least max(l_min, 1) long."""
    M = 0xFFFFFFFF
    P, D, n_words = words.shape
    L = l_min.to(torch.int64).clamp(min=1)[:, None].expand(P, D)
    inside = L <= 30  # a run wholly inside a word is at most 30 long
    Lw = torch.where(inside, L, 1)
    run = torch.zeros((P, D), dtype=torch.int64, device=words.device)
    cand = torch.zeros_like(run)
    for w in range(n_words):
        x = words[:, :, w]
        full = x == M
        inv = ~x & M
        lo = popcount32(((inv & -inv) - 1) & M)  # __ffs(~x) - 1
        hi = _leading_ones32(x)  # __clz(~x)
        closed = (run + lo >= L).to(torch.int64)
        z = x & ((M << lo) & M) & (M >> hi)
        length = torch.ones_like(L)
        for _ in range(5):  # the shift-and ladder, while 2 * len <= l_min
            step = 2 * length <= Lw
            z = torch.where(step, z & (z >> length), z)
            length = torch.where(step, 2 * length, length)
        z = z & (z >> (Lw - length))
        inner = torch.where(inside, popcount32(z & ~(z << 1) & M), 0)
        cand = cand + torch.where(full, 0, closed + inner)
        run = torch.where(full, run + 32, hi)
    cand = cand + (run >= L).to(torch.int64)
    return cand.to(torch.int32)
