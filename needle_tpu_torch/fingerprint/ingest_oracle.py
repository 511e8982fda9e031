"""Canonical host oracle of the fused ingest (the port's own copy of
needle_tpu/fingerprint/ingest_oracle.py).

The fused ingest (torch_impl.ingest_fingerprint_batched) computes [integer
half-band decimate ->] integer downmix -> windowed-sinc polyphase resample
-> chromaprint TEST2 fingerprint. The integer stages are bit-exactly
replicated here; the resample and fingerprint stages run the device's exact
program STRUCTURE in float64 and cast each resampled sample to f32 —
defining a deterministic, backend-independent canonical basis for the
fused path's hashes. The device's f32 arithmetic approximates this basis
within a measured error bound; hashes whose quantization lands within
NEEDLE_TPU_EXACT_EPS of a classifier or norm-zeroing threshold are flagged
on the device and recomputed here (torch_impl.IngestDispatcher, from the
device's own mid-rate samples: ingest_hashes_mid_oracle), making the
fused path's output EXACTLY this oracle's output on every device. The
arithmetic and its order of operations are needle_tpu's, so both packages
rescan to the same hashes.

The reference instead resamples on host with libswresample and hashes with
C++ chromaprint (needle/src/audio/analyzer.rs:176-311); its hash basis
differs from this one by the resampler choice, which the search engine's
Hamming threshold absorbs (both bases are internally consistent, which is
what opening/ending detection needs).
"""

from __future__ import annotations

import functools as _functools
from typing import Tuple

import numpy as np

from .constants import (
    CHROMA_FILTER_COEFFS,
    FRAME_SIZE,
    HOP_SIZE,
    MAX_FILTER_WIDTH,
    SAMPLE_RATE,
)
from .decimate import _HB_MAIN, _HB_RELAXED, _halfband_q14
from .numpy_impl import (
    _classifier_values,
    chroma_features,
    chroma_filter,
    chroma_normalize,
    classify,
    num_frames,
    spectral_energy,
)
from .plan import _ROWS_PER_FRAME, _RS_HALF_TAPS, _ingest_dims, _resample_plan

_RESCAN_EXTRA = (len(CHROMA_FILTER_COEFFS) - 1) + (MAX_FILTER_WIDTH - 1)  # 19


def decimate2_hb_np(x_2d: np.ndarray, odd_q, c0: int) -> np.ndarray:
    """Pure-NumPy replica of the half-band decimator's exact integer
    semantics — the single source of truth implemented three ways (native
    ni_decimate2_hb, device torch_impl._decimate2_hb_i32, and this): zero-padded
    edges, Q14 taps, (acc + 8192) >> 14 arithmetic shift, clip to i16 range.
    Input/output are (frames, channels) int32 arrays; output has frames//2
    rows (output row k reads input rows 2k + offset)."""
    x = np.asarray(x_2d, dtype=np.int64)
    n, C = x.shape
    n_odd = len(odd_q)
    H = 2 * n_odd - 1
    out_n = n // 2
    pad_top = H + 1
    pad_bot = H + 1 + ((pad_top + n + H + 1) % 2)
    xp = np.concatenate(
        [np.zeros((pad_top, C), np.int64), x, np.zeros((pad_bot, C), np.int64)]
    )

    def sl(offset: int) -> np.ndarray:
        o = offset + pad_top
        return xp[o : o + 2 * out_n : 2]

    acc = np.int64(c0) * sl(0)
    for m, q in enumerate(np.asarray(odd_q)):
        d = 2 * m + 1
        acc = acc + np.int64(q) * (sl(-d) + sl(d))
    y = (acc + 8192) >> 14
    return np.clip(y, -32768, 32767).astype(np.int32)


def _hb_stage_window(
    x: np.ndarray, in_lo: int, out_lo: int, out_hi: int, odd_q, c0: int
) -> np.ndarray:
    """Outputs [out_lo, out_hi) of the half-band decimator given a local
    input slice `x` covering global input rows [in_lo, in_lo + len(x)).
    Output row k reads input rows 2k-H .. 2k+H (decimate2_hb_np's exact
    integer semantics); the caller materializes zeros for out-of-domain
    global rows, so the slice must cover [2*out_lo - H, 2*(out_hi-1)+H].

    Each channel runs as one contiguous row (a (rows, 2) slice would make
    NumPy's inner loop two elements long), in int32 as on the card: inputs
    are in the i16 range, so |acc| <= 32768 * (c0 + 2 * sum|q|) + 8192,
    under 2**31 for both designs (9.9e8 main, 6.2e8 relaxed)."""
    xc = np.ascontiguousarray(x.T, dtype=np.int32)
    n_out = out_hi - out_lo

    def sl(off: int) -> np.ndarray:
        o = 2 * out_lo + off - in_lo
        return xc[:, o : o + 2 * n_out : 2]

    acc = np.int32(c0) * sl(0)
    for m, q in enumerate(np.asarray(odd_q)):
        d = 2 * m + 1
        acc += np.int32(q) * (sl(-d) + sl(d))
    y = (acc + 8192) >> 14
    return np.ascontiguousarray(np.clip(y, -32768, 32767).T)


def _prepare_mid_window(
    segment_i16: np.ndarray,
    n_valid: int,
    channels: int,
    dec_factor: int,
    in_len_mid: int,
    g_lo: int,
    g_hi: int,
) -> np.ndarray:
    """mono_mid[g_lo:g_hi] of _ingest_prepare_mid (int32), computed from
    only the raw rows this window depends on — O(window), not O(lane).
    Every stage is a global-index-deterministic FIR, so evaluating it on a
    slice with enough context (H rows per half-band stage) reproduces the
    whole-lane values exactly; out-of-domain global indices (g < 0, past
    the lane, or >= the stage's valid count) are materialized as zeros,
    matching the whole-lane zero-extension and inter-stage masking.
    Indices may extend past the lane (the caller clips nothing): those
    positions are zeros, exactly like the whole-lane path's padding."""
    stages = []
    if dec_factor == 4:
        stages = [_halfband_q14(*_HB_RELAXED), _halfband_q14(*_HB_MAIN)]
    elif dec_factor == 2:
        stages = [_halfband_q14(*_HB_MAIN)]
    raw_len = in_len_mid * channels * dec_factor
    nv = min(int(n_valid), raw_len) // channels
    # valid-count mask per stage output (the whole-lane path's x[nv:] = 0)
    nvs = [nv]
    for _ in stages:
        nvs.append(nvs[-1] // 2)
    # dependency intervals, innermost (raw rows) first
    need = [(g_lo, g_hi)]
    for odd_q, _c0 in reversed(stages):
        H = 2 * len(odd_q) - 1
        lo, hi = need[-1]
        need.append((2 * lo - H, 2 * (hi - 1) + H + 1))
    need.reverse()

    r_lo, r_hi = need[0]
    buf = np.zeros((r_hi - r_lo) * channels, np.int16)
    a = max(0, r_lo)
    s_lo = a * channels
    s_hi = min(r_hi * channels, raw_len, len(segment_i16))
    if s_hi > s_lo:
        o = (a - r_lo) * channels
        buf[o : o + (s_hi - s_lo)] = segment_i16[s_lo:s_hi]
    x = buf.reshape(-1, channels).astype(np.int32)
    gidx = np.arange(r_lo, r_hi)
    x[(gidx < 0) | (gidx >= nv)] = 0
    for s, (odd_q, c0) in enumerate(stages):
        out_lo, out_hi = need[s + 1]
        x = _hb_stage_window(x, need[s][0], out_lo, out_hi, odd_q, c0)
        gidx = np.arange(out_lo, out_hi)
        x[(gidx < 0) | (gidx >= nvs[s + 1])] = 0
    if channels == 2:
        ssum = x[:, 0] + x[:, 1]
        return np.where(ssum < 0, -((-ssum) >> 1), ssum >> 1)
    return np.ascontiguousarray(x[:, 0])


def _ingest_prepare_mid(
    segment_i16: np.ndarray,
    n_valid: int,
    channels: int,
    dec_factor: int,
    in_len_mid: int,
) -> np.ndarray:
    """Raw interleaved segment -> INTEGER mono at the mid rate, replicating
    the device lane preparation exactly: zero-extend to the bucket's raw
    length, zero frames >= the valid count, integer half-band decimation
    with the same inter-stage masking, integer downmix. Returns an integer
    dtype (i16 for the pass-through mono case, i32 otherwise) — every
    sample is an exact integer, so downstream float conversion can happen
    per-block instead of whole-lane (the whole-lane f64 cast + pad copies
    were ~250 MB of memcpy per lane and dominated rescan cost once the
    1e-5 margin made flags rare)."""
    raw_len = in_len_mid * channels * dec_factor
    seg = np.zeros(raw_len, np.int16)
    take = min(len(segment_i16), raw_len)
    seg[:take] = segment_i16[:take]
    nv = min(int(n_valid), raw_len) // channels
    if channels == 1 and dec_factor == 1:
        seg[nv:] = 0
        return seg  # int16 view of the exact device lane input
    x = seg.reshape(-1, channels).astype(np.int32)
    x[nv:] = 0
    if dec_factor > 1:
        nv1 = nv
        if dec_factor == 4:
            x = decimate2_hb_np(x, *_halfband_q14(*_HB_RELAXED))
            nv1 //= 2
            x[nv1:] = 0
        x = decimate2_hb_np(x, *_halfband_q14(*_HB_MAIN))
        nv1 //= 2
        x[nv1:] = 0
    if channels == 2:
        s = x[:, 0] + x[:, 1]
        mono = np.where(s < 0, -((-s) >> 1), s >> 1)
    else:
        mono = x[:, 0]
    return np.ascontiguousarray(mono)


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


def _fingerprint_window_f32(mono_f32: np.ndarray, n_sub: int) -> np.ndarray:
    """Float-sample variant of numpy_impl's pipeline tail: (T,) f32 samples
    at 11025 Hz -> first n_sub u32 subfingerprints. Framing matches
    frame_signal; the window multiply matches spectral_energy's
    (f64 window * f64 sample) -> f32 cast for float input."""
    nf = num_frames(len(mono_f32))
    if nf <= 0 or n_sub <= 0:
        return np.zeros(0, np.uint32)
    x = np.ascontiguousarray(mono_f32, dtype=np.float32)
    frames = np.lib.stride_tricks.as_strided(
        x,
        shape=(nf, FRAME_SIZE),
        strides=(x.strides[0] * HOP_SIZE, x.strides[0]),
        writeable=False,
    )
    energy = spectral_energy(frames)
    normalized = chroma_normalize(chroma_filter(chroma_features(energy)))
    return classify(normalized)[:n_sub]


def _rescan_spans(nf_bucket: int, ranges) -> list:
    """The [t_lo, t_hi) 11025 Hz samples that each [lo, hi) range's
    subfingerprints read: subfingerprint i depends on resampled samples
    [i*HOP_SIZE, (i+19)*HOP_SIZE + FRAME_SIZE), cut at the lane's pad
    length (the device program zero-extends there)."""
    pad_len = (nf_bucket + _ROWS_PER_FRAME + 1) * HOP_SIZE
    return [
        (lo * HOP_SIZE,
         min(pad_len, (hi - 1 + _RESCAN_EXTRA) * HOP_SIZE + FRAME_SIZE))
        for lo, hi in ranges
    ]


def rescan_mid_rows(mid_rate: int, nf_bucket: int, ranges) -> list:
    """The global mid-rate mono rows [g_lo, g_hi) that each [lo, hi) range
    of a lane reads. With a resample stage, block b reads xpad[b*kM : b*kM
    + kM + 2H] of the H-zero-prefixed mono, so rows [b_lo*kM - H, (b_hi-1)
    *kM + kM + H) cover every block of the span; without one, the span's
    own rows. Rows before 0 or past the lane's valid count are zeros."""
    spans = _rescan_spans(nf_bucket, ranges)
    if mid_rate == SAMPLE_RATE:
        return spans
    L, M, k, _ = _resample_matd(mid_rate)
    H = _RS_HALF_TAPS
    kM, kL = k * M, k * L
    return [
        ((t_lo // kL) * kM - H, ((t_hi - 1) // kL) * kM + kM + H)
        for t_lo, t_hi in spans
    ]


def ingest_hashes_mid_oracle(
    windows, mid_rate: int, nf_bucket: int, ranges
) -> list:
    """Canonical subfingerprints for several [lo, hi) ranges of one
    fused-ingest lane, given each range's INTEGER mid-rate mono window:
    rows rescan_mid_rows(mid_rate, nf_bucket, ranges) of the lane's source
    stage output, as the device's source stage or _prepare_mid_window
    computes them. The dependency window starts on a hop boundary and the
    resample stage is a global-index-deterministic FIR, so the pipeline run
    on that slice reproduces the global values exactly. The f64 filter
    matrix stays cached across ranges (_resample_matd)."""
    spans = _rescan_spans(nf_bucket, ranges)
    if mid_rate != SAMPLE_RATE:
        # the device program truncates the resample output to out_needed
        # (== pad_len) and zero-extends; t_hi <= pad_len so nothing to do
        L, M, k, matd = _resample_matd(mid_rate)
        H = _RS_HALF_TAPS
        kM, kL = k * M, k * L
        out = []
        for w, (t_lo, t_hi) in zip(windows, spans):
            b_lo, b_hi = t_lo // kL, (t_hi - 1) // kL + 1
            w = w.astype(np.float64)
            it = w.strides[0]
            W = np.ascontiguousarray(
                np.lib.stride_tricks.as_strided(
                    w,
                    shape=(b_hi - b_lo, kM + 2 * H),
                    strides=(it * kM, it),
                )
            )
            Y = np.asarray(W @ matd).reshape(-1)  # (n_blocks * kL,) f64
            out.append(
                Y[t_lo - b_lo * kL : t_hi - b_lo * kL].astype(np.float32)
            )
    else:
        # no resample stage: the span reads mono_mid[t_lo:t_hi] directly
        out = [w.astype(np.float32) for w in windows]
    return [
        _fingerprint_window_f32(w, hi - lo)
        for w, (lo, hi) in zip(out, ranges)
    ]


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
    on: each range's mid-rate mono window (rescan_mid_rows) is computed
    from ONLY the raw rows it depends on (_prepare_mid_window), so the
    cost is O(flagged width), independent of lane length, and fed to
    ingest_hashes_mid_oracle."""
    mid_rate = in_rate // dec_factor
    _, in_len_mid, _ = _ingest_dims(mid_rate, nf_bucket)
    windows = [
        _prepare_mid_window(
            segment_i16, n_valid, channels, dec_factor, in_len_mid, g_lo, g_hi
        )
        for g_lo, g_hi in rescan_mid_rows(mid_rate, nf_bucket, ranges)
    ]
    return ingest_hashes_mid_oracle(windows, mid_rate, nf_bucket, ranges)


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
