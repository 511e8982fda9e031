"""NumPy implementation of the chromaprint TEST2 fingerprint pipeline.

The port's own copy of needle_tpu/fingerprint/numpy_impl.py: the oracle
that the pre-decoded mono route's borderline hashes are rescanned with, and
that its hashes are held against. It reproduces chromaprint v1.5.x (the library used by the reference
at needle/src/audio/analyzer.rs:176-311) stage by stage:

  framing -> Hamming window -> rFFT energy -> chroma fold -> temporal chroma
  filter -> Euclidean normalize -> 16 area-difference classifiers ->
  quantize -> gray code -> u32 subfingerprints.

FFT note: chromaprint builds differ in FFT backend (FFTW, vDSP, avfft); their
outputs differ in the last float bits, which can flip a quantized classifier
level for values that land within ~1e-6 of a trained threshold. Hashes here
therefore match any given chromaprint build on ~99.9% of frames exactly and
to within 1 bit otherwise; the search engine's Hamming threshold (default 10)
absorbs this. (The same caveat applies between two builds of the reference.)
"""

from __future__ import annotations

import numpy as np

from .constants import (
    CHROMA_FILTER_COEFFS,
    CHROMA_NORM_THRESHOLD,
    FRAME_SIZE,
    GRAY_CODE,
    HOP_SIZE,
    MAX_FILTER_WIDTH,
    NUM_BANDS,
    QUANTIZER_THRESHOLDS,
    SAMPLE_RATE,
    WINDOW_SCALE,
    chroma_bin_ranges,
    classifier_window_matrix,
    hamming_window,
)

_WINDOW = hamming_window(FRAME_SIZE, WINDOW_SCALE)
_MIN_INDEX, _MAX_INDEX, _NOTES = chroma_bin_ranges()
_W_CLS, _ = classifier_window_matrix()  # (192, 32)

# Chroma fold as a sparse 0/1 matrix (n_used_bins, 12).
_FOLD = np.zeros((_MAX_INDEX - _MIN_INDEX, NUM_BANDS), dtype=np.float64)
_FOLD[np.arange(_MAX_INDEX - _MIN_INDEX), _NOTES] = 1.0


def downmix_stereo_i16(interleaved: np.ndarray) -> np.ndarray:
    """Stereo -> mono like chromaprint's AudioProcessor: (l + r) / 2 with C
    integer division (truncation toward zero)."""
    x = np.asarray(interleaved, dtype=np.int16).reshape(-1, 2).astype(np.int32)
    s = x[:, 0] + x[:, 1]
    return np.where(s < 0, -((-s) >> 1), s >> 1).astype(np.int16)


def num_frames(n_samples: int) -> int:
    """Number of full FFT frames chromaprint consumes from n_samples."""
    if n_samples < FRAME_SIZE:
        return 0
    return 1 + (n_samples - FRAME_SIZE) // HOP_SIZE


def num_subfingerprints(n_samples: int) -> int:
    """Number of u32 subfingerprints produced from n_samples of mono PCM."""
    nf = num_frames(n_samples)
    n_filtered = nf - (len(CHROMA_FILTER_COEFFS) - 1)
    return max(0, n_filtered - (MAX_FILTER_WIDTH - 1))


def frame_signal(mono_i16: np.ndarray) -> np.ndarray:
    """Overlapping (n_frames, FRAME_SIZE) view of the signal."""
    x = np.ascontiguousarray(mono_i16, dtype=np.int16)
    nf = num_frames(len(x))
    if nf == 0:
        return np.zeros((0, FRAME_SIZE), dtype=np.int16)
    return np.lib.stride_tricks.as_strided(
        x,
        shape=(nf, FRAME_SIZE),
        strides=(x.strides[0] * HOP_SIZE, x.strides[0]),
        writeable=False,
    )


def spectral_energy(frames_i16: np.ndarray) -> np.ndarray:
    """Windowed rFFT energy per frame, float32 FFT like the avfft/FFTW-single
    backends: returns (n_frames, FRAME_SIZE//2 + 1) float64."""
    # chromaprint: m_input[i] = (float)(window_double[i] * (double)sample)
    windowed = (frames_i16.astype(np.float64) * _WINDOW).astype(np.float32)
    spec = np.fft.rfft(windowed, axis=-1)  # complex64 for float32 input
    re = spec.real.astype(np.float32)
    im = spec.imag.astype(np.float32)
    # energy computed in f32 (float*float + float*float), then widened
    return (re * re + im * im).astype(np.float64)


def chroma_features(energy: np.ndarray) -> np.ndarray:
    """Fold spectral energy into 12 chroma bands (chromaprint Chroma,
    interpolate=False for TEST2)."""
    used = energy[:, _MIN_INDEX:_MAX_INDEX]
    return used @ _FOLD


def chroma_filter(chroma: np.ndarray) -> np.ndarray:
    """5-tap temporal filter, 'valid' convolution over time
    (chromaprint ChromaFilter, coefficients [0.25,0.75,1.0,0.75,0.25])."""
    n = chroma.shape[0] - (len(CHROMA_FILTER_COEFFS) - 1)
    if n <= 0:
        return np.zeros((0, NUM_BANDS), dtype=np.float64)
    out = np.zeros((n, NUM_BANDS), dtype=np.float64)
    for k, c in enumerate(CHROMA_FILTER_COEFFS):
        out += c * chroma[k : k + n]
    return out


def chroma_normalize(filtered: np.ndarray) -> np.ndarray:
    """Per-frame Euclidean normalization with zeroing threshold
    (chromaprint ChromaNormalizer, threshold 0.01)."""
    norm = np.sqrt(np.sum(filtered * filtered, axis=1, keepdims=True))
    safe = np.where(norm < CHROMA_NORM_THRESHOLD, 1.0, norm)
    out = filtered / safe
    out[norm[:, 0] < CHROMA_NORM_THRESHOLD] = 0.0
    return out


def _classifier_values(normalized: np.ndarray) -> np.ndarray:
    """(n_sub, 16) pre-quantization classifier values: 16-frame sliding
    windows over normalized chroma -> classifier matmul -> SubtractLog.
    Shared by classify() and the ingest oracle's values (one source of
    truth for the derivation)."""
    n = normalized.shape[0] - (MAX_FILTER_WIDTH - 1)
    if n <= 0:
        return np.zeros((0, 16))
    # (n, 16*12) unfolded windows
    windows = np.lib.stride_tricks.sliding_window_view(
        normalized, (MAX_FILTER_WIDTH, NUM_BANDS)
    )[:, 0].reshape(n, MAX_FILTER_WIDTH * NUM_BANDS)
    ab = windows @ _W_CLS  # (n, 32): a at even cols, b at odd cols
    a, b = ab[:, 0::2], ab[:, 1::2]
    return np.log((1.0 + a) / (1.0 + b))  # SubtractLog


def classify(normalized: np.ndarray) -> np.ndarray:
    """Slide the 16-frame classifier window over normalized chroma and emit
    one u32 subfingerprint per position (chromaprint FingerprintCalculator)."""
    values = _classifier_values(normalized)
    if values.shape[0] == 0:
        return np.zeros(0, dtype=np.uint32)
    # quantize against per-classifier thresholds
    t0, t1, t2 = (QUANTIZER_THRESHOLDS[:, k] for k in range(3))
    q = (values >= t0).astype(np.uint32) + (values >= t1) + (values >= t2)
    g = GRAY_CODE[q]  # (n, 16)
    shifts = (2 * (15 - np.arange(16))).astype(np.uint32)
    return np.bitwise_or.reduce(g << shifts, axis=1).astype(np.uint32)


def classifier_values_oracle(mono_i16: np.ndarray):
    """Float64-oracle pre-quantization intermediates: the classifier value
    matrix (n_sub, 16) and per-frame chroma norms (n_filt,). The
    validation counterpart of torch_impl.classifier_values, which the
    parity harness (needle_tpu_torch.parity) holds against half the
    borderline margin."""
    frames = frame_signal(np.asarray(mono_i16, dtype=np.int16))
    if frames.shape[0] == 0:
        return np.zeros((0, 16)), np.zeros((0,))
    filtered = chroma_filter(chroma_features(spectral_energy(frames)))
    norm = np.sqrt(np.sum(filtered * filtered, axis=1))
    return _classifier_values(chroma_normalize(filtered)), norm


def fingerprint_numpy(mono_i16: np.ndarray) -> np.ndarray:
    """Full pipeline: mono i16 PCM @ 11025 Hz -> u32 subfingerprints."""
    frames = frame_signal(np.asarray(mono_i16, dtype=np.int16))
    if frames.shape[0] == 0:
        return np.zeros(0, dtype=np.uint32)
    energy = spectral_energy(frames)
    chroma = chroma_features(energy)
    filtered = chroma_filter(chroma)
    normalized = chroma_normalize(filtered)
    return classify(normalized)


def fingerprint_numpy_window(
    mono_i16: np.ndarray, lo: int, hi: int
) -> np.ndarray:
    """Recompute subfingerprints [lo, hi) of fingerprint_numpy(mono_i16)
    from only the samples they depend on.

    Subfingerprint i depends on FFT frames i .. i+19 (16-frame classifier
    window over 5-tap-filtered chroma), i.e. samples
    [i*HOP_SIZE, (i+19)*HOP_SIZE + FRAME_SIZE). Because the dependency
    window starts on a hop boundary, running the full pipeline on that
    slice reproduces the global subfingerprints exactly. Used by the mono
    route's bit-exact rescan of borderline-quantized hashes."""
    extra = (len(CHROMA_FILTER_COEFFS) - 1) + (MAX_FILTER_WIDTH - 1)  # 19
    s_lo = lo * HOP_SIZE
    s_hi = min(len(mono_i16), (hi - 1 + extra) * HOP_SIZE + FRAME_SIZE)
    out = fingerprint_numpy(np.asarray(mono_i16[s_lo:s_hi], dtype=np.int16))
    return out[: hi - lo]


def merge_flag_ranges(flagged: np.ndarray, gap: int = 19):
    """Group sorted flagged indices into [lo, hi) ranges, merging ranges
    closer than `gap` (each range costs ~gap frames of fixed overhead to
    recompute, so nearer ranges are cheaper merged)."""
    ranges = []
    for i in np.asarray(flagged, dtype=np.int64):
        i = int(i)
        if ranges and i - ranges[-1][1] <= gap:
            ranges[-1][1] = i + 1
        else:
            ranges.append([i, i + 1])
    return [(lo, hi) for lo, hi in ranges]


def fingerprint_numpy_stereo(interleaved_i16: np.ndarray) -> np.ndarray:
    """Stereo interleaved i16 @ 11025 Hz -> subfingerprints (downmix first),
    matching how the reference feeds chromaprint (analyzer.rs:218, 263-275).
    The `numpy` analyze backend."""
    return fingerprint_numpy(downmix_stereo_i16(interleaved_i16))
