"""Canonical host oracle of the fused ingest, without jax.

The fused ingest's hash basis is defined by needle_tpu's canonical host
oracle (needle_tpu/fingerprint/ingest_oracle.py): bit-exact integer
decimation and downmix, then the device program's resample and fingerprint
structure evaluated in float64. That module imports its resample plan from
the jax package inside the functions copied below; these copies read the
same numpy plan from `plan.py`, so the borderline rescan runs where jax is
not installed. Every other helper is needle_tpu's own.
"""

from __future__ import annotations

import functools as _functools
from typing import Tuple

import numpy as np

from needle_tpu.fingerprint.constants import FRAME_SIZE, HOP_SIZE, SAMPLE_RATE
from needle_tpu.fingerprint.ingest_oracle import (
    _RESCAN_EXTRA,
    _fingerprint_window_f32,
    _ingest_prepare_mid,
    _prepare_mid_window,
)
from needle_tpu.fingerprint.numpy_impl import (
    _classifier_values,
    chroma_features,
    chroma_filter,
    chroma_normalize,
    num_frames,
    spectral_energy,
)

from .plan import _ROWS_PER_FRAME, _RS_HALF_TAPS, _ingest_dims, _resample_plan


@_functools.lru_cache(maxsize=None)
def _resample_matd(mid_rate: int):
    """(L, M, k, float64 filter operator) of the device resample plan —
    cached so repeated window recomputes don't rebuild it. The operator is
    scipy CSC when available: the filter matrix is banded (only 2H+1 of
    kM+2H rows are nonzero per output column — 65/384 at mid_rate 8000),
    so the dense f64 GEMM wastes most of its FLOPs on structural zeros; the
    sparse product skips them and its accumulation (sequential over
    nonzeros in ascending tap order, scipy's csr_matvecs kernel) is the
    canonical f64 accumulation order. Dense fallback keeps the oracle
    working without scipy (f64-ulp accumulation differences vs the sparse
    path essentially never survive the f32 cast — 0 of 5.7M samples in a
    randomized check)."""
    L, M, k, mat = _resample_plan(mid_rate)
    matd = mat.astype(np.float64)
    try:
        import scipy.sparse as _sp

        matd = _sp.csc_matrix(matd)
    except ImportError:  # pragma: no cover - scipy is a baked-in dep here
        pass
    return L, M, k, matd


def _resample_spans(xpad_int: np.ndarray, mid_rate: int, spans) -> list:
    """Canonical 11025 Hz samples for several [t_lo, t_hi) output spans of
    the device's block polyphase resample (torch_impl._resample):
    each output is the float64 dot of its block's input window with its
    filter column, cast to f32 — sample-deterministic regardless of
    backend. All blocks needed by all spans are gathered (deduplicated)
    into ONE row-batched product, so the filter operator streams from
    memory once instead of once per block. `xpad_int` is the
    half-taps-zero-padded mid-rate INTEGER mono signal, prepared ONCE by
    the caller; only the gathered block windows are cast to f64 (exact —
    the samples are integers), so whole-lane float copies never happen."""
    L, M, k, matd = _resample_matd(mid_rate)
    H = _RS_HALF_TAPS
    kM, kL = k * M, k * L
    blocks = sorted(
        {
            b
            for t_lo, t_hi in spans
            for b in range(t_lo // kL, (t_hi - 1) // kL + 1)
        }
    )
    b_arr = np.asarray(blocks, dtype=np.int64)
    b_max = int(b_arr[-1])
    need = b_max * kM + kM + 2 * H
    if len(xpad_int) < need:  # tail block margin past the padded signal
        xpad_int = np.pad(xpad_int, (0, need - len(xpad_int)))
    it = xpad_int.strides[0]
    W = np.lib.stride_tricks.as_strided(
        xpad_int,
        shape=(b_max + 1, kM + 2 * H),
        strides=(it * kM, it),
    )[b_arr].astype(np.float64)
    Y = np.asarray(W @ matd)  # (n_blocks, kL) float64
    pos = {b: i for i, b in enumerate(blocks)}
    out_spans = []
    for t_lo, t_hi in spans:
        b_lo, b_hi = t_lo // kL, (t_hi - 1) // kL + 1
        out = np.concatenate(
            [Y[pos[b]] for b in range(b_lo, b_hi)]
        )[t_lo - b_lo * kL : t_hi - b_lo * kL]
        out_spans.append(out.astype(np.float32))
    return out_spans


def resample_window_canonical(
    mono_mid_int: np.ndarray, mid_rate: int, t_lo: int, t_hi: int
) -> np.ndarray:
    """Single-span convenience wrapper over _resample_spans."""
    xpad = np.concatenate(
        [np.zeros(_RS_HALF_TAPS, mono_mid_int.dtype), mono_mid_int]
    )
    return _resample_spans(xpad, mid_rate, [(t_lo, t_hi)])[0]


def ingest_hashes_ranges_oracle(
    segment_i16: np.ndarray,
    n_valid: int,
    in_rate: int,
    channels: int,
    dec_factor: int,
    nf_bucket: int,
    ranges,
) -> list:
    """Canonical subfingerprints for several [lo, hi) ranges of one
    fused-ingest lane, each recomputed from only the raw samples it depends
    on. Subfingerprint i depends on resampled samples
    [i*HOP_SIZE, (i+19)*HOP_SIZE + FRAME_SIZE) and the dependency window
    starts on a hop boundary, so the pipeline run on that slice reproduces
    the global values exactly (the integer and resample stages are
    global-index-deterministic FIRs). Each span's mid-rate mono is computed
    from ONLY the raw rows it depends on (_prepare_mid_window), so the
    cost is O(flagged width), independent of lane length.
    The f64 filter matrix stays cached across ranges (_resample_matd)."""
    mid_rate = in_rate // dec_factor
    _, in_len_mid, out_needed = _ingest_dims(mid_rate, nf_bucket)
    pad_len = (nf_bucket + _ROWS_PER_FRAME + 1) * HOP_SIZE
    spans = []
    for lo, hi in ranges:
        t_lo = lo * HOP_SIZE
        t_hi = min(pad_len, (hi - 1 + _RESCAN_EXTRA) * HOP_SIZE + FRAME_SIZE)
        spans.append((t_lo, t_hi))
    if mid_rate != SAMPLE_RATE:
        # the device program truncates the resample output to out_needed
        # (== pad_len) and zero-extends; t_hi <= pad_len so nothing to do
        L, M, k, matd = _resample_matd(mid_rate)
        H = _RS_HALF_TAPS
        kM, kL = k * M, k * L
        windows = []
        for t_lo, t_hi in spans:
            b_lo, b_hi = t_lo // kL, (t_hi - 1) // kL + 1
            # block b reads xpad[b*kM : b*kM + kM + 2H]; xpad is the
            # H-zero-prefixed mono, so mono global rows
            # [b_lo*kM - H, (b_hi-1)*kM + kM + H) cover every block
            w = _prepare_mid_window(
                segment_i16, n_valid, channels, dec_factor, in_len_mid,
                b_lo * kM - H, (b_hi - 1) * kM + kM + H,
            ).astype(np.float64)
            it = w.strides[0]
            W = np.ascontiguousarray(
                np.lib.stride_tricks.as_strided(
                    w,
                    shape=(b_hi - b_lo, kM + 2 * H),
                    strides=(it * kM, it),
                )
            )
            Y = np.asarray(W @ matd).reshape(-1)  # (n_blocks * kL,) f64
            windows.append(
                Y[t_lo - b_lo * kL : t_hi - b_lo * kL].astype(np.float32)
            )
    else:
        # no resample stage: the span reads mono_mid[t_lo:t_hi] directly
        # (positions past the lane are zeros via the valid-count mask)
        windows = [
            _prepare_mid_window(
                segment_i16, n_valid, channels, dec_factor, in_len_mid,
                t_lo, t_hi,
            ).astype(np.float32)
            for t_lo, t_hi in spans
        ]
    return [
        _fingerprint_window_f32(w, hi - lo)
        for w, (lo, hi) in zip(windows, ranges)
    ]


def ingest_values_oracle(
    segment_i16: np.ndarray,
    n_valid: int,
    in_rate: int,
    channels: int,
    dec_factor: int,
    nf_bucket: int,
    n_sub: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical pre-quantization classifier values (n_sub, 16) and
    per-frame chroma norms of one fused-ingest lane — the float64 oracle
    counterpart of torch_impl.ingest_classifier_values, used to measure
    the fused path's device-vs-canonical error on the card."""

    mid_rate = in_rate // dec_factor
    _, in_len_mid, _ = _ingest_dims(mid_rate, nf_bucket)
    pad_len = (nf_bucket + _ROWS_PER_FRAME + 1) * HOP_SIZE
    mono_mid = _ingest_prepare_mid(
        segment_i16, n_valid, channels, dec_factor, in_len_mid
    )
    if mid_rate != SAMPLE_RATE:
        mono = resample_window_canonical(mono_mid, mid_rate, 0, pad_len)
    else:
        mono = np.zeros(pad_len, np.float32)
        take = min(len(mono_mid), pad_len)
        mono[:take] = mono_mid[:take].astype(np.float32)
    nf = num_frames(len(mono))
    x = np.ascontiguousarray(mono, dtype=np.float32)
    frames = np.lib.stride_tricks.as_strided(
        x,
        shape=(nf, FRAME_SIZE),
        strides=(x.strides[0] * HOP_SIZE, x.strides[0]),
        writeable=False,
    )
    filtered = chroma_filter(chroma_features(spectral_energy(frames)))
    norm = np.sqrt(np.sum(filtered * filtered, axis=1))
    return (
        _classifier_values(chroma_normalize(filtered))[:n_sub],
        norm,
    )


def ingest_hashes_full_oracle(
    segment_i16: np.ndarray,
    n_valid: int,
    in_rate: int,
    channels: int,
    dec_factor: int,
    nf_bucket: int,
    n_sub: int,
) -> np.ndarray:
    """Whole-lane canonical hashes, evaluated WITHOUT the dependency-window
    machinery (whole-lane integer prepare + full-range resample) so it
    stays an independent check of the windowed recompute: the window
    oracle must agree with this for any [lo, hi) split."""
    mid_rate = in_rate // dec_factor
    _, in_len_mid, _ = _ingest_dims(mid_rate, nf_bucket)
    pad_len = (nf_bucket + _ROWS_PER_FRAME + 1) * HOP_SIZE
    mono_mid = _ingest_prepare_mid(
        segment_i16, n_valid, channels, dec_factor, in_len_mid
    )
    if mid_rate != SAMPLE_RATE:
        mono = resample_window_canonical(mono_mid, mid_rate, 0, pad_len)
    else:
        mono = np.zeros(pad_len, np.float32)
        take = min(len(mono_mid), pad_len)
        mono[:take] = mono_mid[:take].astype(np.float32)
    return _fingerprint_window_f32(mono, n_sub)
