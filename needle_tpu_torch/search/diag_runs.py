"""Diagonal-run count walk: the CUDA kernel's wrapper and its plain version.

Port of needle_tpu/search/pallas_impl.py. `batch_counts` launches the
hand-written kernel csrc/diag_runs.cu for CUDA tensors; for CPU tensors it
runs `batch_counts_reference`, the plain PyTorch formulation, which is also
what the kernel is held against on the card.

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
    if 2 * n_pad * 4 > 232448:
        raise ValueError(f"n_pad {n_pad} needs more than 227 KB of shared memory")
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


def batch_counts(nv, mv, lm, thr, src, dst, n_pad, bm=None):
    """Per-diagonal candidate counts of a chunk of pairs.

    nv, mv, lm, thr: (chunk,) int32 valid lengths, run bound and Hamming
    threshold per pair; src, dst: (chunk, n_pad) int32 hash bit patterns,
    n_pad a multiple of 512; bm: optional (chunk, n_groups) int32 row-block
    masks (default: every block). Returns (chunk, n_tiles*512) int32;
    diagonal index d is offset d - (n_pad - 1).

    CUDA tensors launch the hand-written kernel (csrc/diag_runs.cu); CPU
    tensors run `batch_counts_reference`."""
    global LAUNCHES
    if src.device.type == "cpu":
        return batch_counts_reference(nv, mv, lm, thr, src, dst, n_pad, bm)
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
    lib = _build.load()
    err = lib.needle_diag_runs(
        nv.data_ptr(), mv.data_ptr(), lm.data_ptr(), thr.data_ptr(),
        bm.data_ptr(), bm.shape[1], src.data_ptr(), dst.data_ptr(),
        counts.data_ptr(), chunk, n_pad, n_out,
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    _build.check(err, "needle_diag_runs")
    LAUNCHES += 1
    return counts
