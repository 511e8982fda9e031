"""Static plan of the fused ingest: numpy-only tables and shapes.

Copies of the pure-numpy values needle_tpu/fingerprint/jax_impl.py builds
for its fused ingest program and that its canonical host oracle reads back
(needle_tpu/fingerprint/ingest_oracle.py imports them from jax_impl, which
imports jax). Keeping them here lets the port and its oracle run without
jax; tests/test_torch_fingerprint.py holds every array equal to the
original.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Tuple

import numpy as np

from .._shapes import size_bucket as bucket_frames
from .constants import (
    FRAME_SIZE,
    HOP_SIZE,
    NUM_BANDS,
    QUANTIZER_THRESHOLDS,
    SAMPLE_RATE,
    WINDOW_SCALE,
    chroma_bin_ranges,
    classifier_window_matrix,
    hamming_window,
)

__all__ = ["bucket_frames"]

# Fixed lane (segment) count per ingest dispatch.
LANES = 8

# 4096 = 3 * 1365 + 1: a frame is three hop rows plus one sample
_ROWS_PER_FRAME = FRAME_SIZE // HOP_SIZE  # 3
_FRAME_REMAINDER = FRAME_SIZE - _ROWS_PER_FRAME * HOP_SIZE  # 1

_RS_HALF_TAPS = 32  # half-width H of the windowed-sinc filter (input samples)


@functools.lru_cache(maxsize=1)
def _dft_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(windowed cos table, windowed sin table, chroma fold matrix)."""
    min_idx, max_idx, notes = chroma_bin_ranges()
    window = hamming_window(FRAME_SIZE, WINDOW_SCALE)  # float64
    n = np.arange(FRAME_SIZE, dtype=np.float64)[:, None]
    k = np.arange(min_idx, max_idx, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / FRAME_SIZE
    wc = (window[:, None] * np.cos(ang)).astype(np.float32)
    ws = (window[:, None] * -np.sin(ang)).astype(np.float32)
    fold = np.zeros((max_idx - min_idx, NUM_BANDS), dtype=np.float32)
    fold[np.arange(max_idx - min_idx), notes] = 1.0
    return wc, ws, fold


@functools.lru_cache(maxsize=1)
def _classifier_tables() -> Tuple[np.ndarray, np.ndarray]:
    W, _ = classifier_window_matrix()
    return W.astype(np.float32), QUANTIZER_THRESHOLDS.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _resample_plan(in_rate: int) -> Tuple[int, int, int, np.ndarray]:
    """Polyphase windowed-sinc resample in_rate -> 11025 Hz as a matmul:
    a block of k*M input samples gives exactly k*L outputs (L/M =
    11025/in_rate reduced). Returns (L, M, k, matrix) with matrix shape
    (k*M + 2H, k*L)."""
    g = math.gcd(SAMPLE_RATE, in_rate)
    L, M = SAMPLE_RATE // g, in_rate // g
    k = max(1, -(-128 // L))  # k*L >= 128 keeps the matmul N-dim efficient
    H = _RS_HALF_TAPS
    fc = 0.5 * min(1.0, L / M) * 0.945  # normalized cutoff (input rate)
    n_rows, n_cols = k * M + 2 * H, k * L
    j = np.arange(n_rows, dtype=np.float64)[:, None]
    p = np.arange(n_cols, dtype=np.float64)[None, :]
    t = p * M / L  # exact output centers in input samples
    x = (j - H) - t
    taps = 2.0 * fc * np.sinc(2.0 * fc * x)
    taps *= np.kaiser(2 * 4096 + 1, 9.0)[
        np.clip((x / H * 4096 + 4096).round().astype(np.int64), 0, 2 * 4096)
    ]
    taps[np.abs(x) > H] = 0.0
    # unit DC gain per phase
    taps /= taps.sum(axis=0, keepdims=True)
    return L, M, k, taps.astype(np.float32)


def _ingest_dims(in_rate: int, n_frames: int) -> Tuple[int, int, int]:
    """(n_blocks, in_len, out_len) for a given frame bucket: enough resampled
    samples for n_frames frames, derived statically from the bucket."""
    L, M, k, _ = _resample_plan(in_rate)
    out_needed = (n_frames + _ROWS_PER_FRAME + 1) * HOP_SIZE
    n_blocks = -(-out_needed // (k * L))
    in_len = (n_blocks + 1) * (k * M)  # +1 block so every window has margin
    return n_blocks, in_len, out_needed


def resampled_length(n_in: int, in_rate: int, channels: int = 1) -> int:
    """Output sample count at 11025 Hz for n_in interleaved input samples."""
    L, M, _, _ = _resample_plan(in_rate)
    return (n_in // channels) * L // M


def _exact_eps() -> float:
    """Borderline margin of the exact rescan: a classifier value (or chroma
    norm) computed on the device within this distance of a quantizer (or
    zeroing) threshold is flagged and its hash recomputed by the canonical
    host oracle. NEEDLE_TPU_EXACT_EPS overrides the default 1e-5."""
    v = os.environ.get("NEEDLE_TPU_EXACT_EPS")
    return 1e-5 if v is None else float(v)
