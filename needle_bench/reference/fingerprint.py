"""The canonical hashes of one analyzer lane, in plain NumPy.

A frozen copy of the port's canonical host oracle of its fused ingest
(`ingest_hashes_full_oracle` in needle_tpu_torch/fingerprint/ingest_oracle.py
with what it reads of constants.py, numpy_impl.py, plan.py and
decimate.py), which is needle_tpu's: integer half-band decimation to the
mid rate, integer downmix, a windowed-sinc polyphase resample to 11025 Hz
in float64 cast to float32 per sample, then chromaprint TEST2 (Hamming
window, rFFT energy in float32, chroma fold, 5-tap filter, normalisation,
16 classifiers quantised against libchromaprint 1.5.1's thresholds, gray
code). The port's analyzer promises these hashes bit for bit: it computes
them in float32 on the card and recomputes the borderline ones with that
oracle. Imports nothing but numpy and scipy.
"""

from __future__ import annotations

import functools
import math

import numpy as np

SAMPLE_RATE = 11025
FRAME_SIZE = 4096
HOP_SIZE = 1365
NUM_BANDS = 12
MIN_FREQ, MAX_FREQ = 28.0, 3520.0
CHROMA_FILTER_COEFFS = np.array([0.25, 0.75, 1.0, 0.75, 0.25])
CHROMA_NORM_THRESHOLD = 0.01
MAX_FILTER_WIDTH = 16
WINDOW_SCALE = 1.0 / 32768.0
GRAY_CODE = np.array([0, 1, 3, 2], dtype=np.uint32)
ROWS_PER_FRAME = FRAME_SIZE // HOP_SIZE  # 3
RS_HALF_TAPS = 32
DELAY_SAMPLES = (len(CHROMA_FILTER_COEFFS) - 1 + MAX_FILTER_WIDTH - 1) * HOP_SIZE + (
    FRAME_SIZE - HOP_SIZE)  # 28666

# (filter type, y, height, width, t0, t1, t2) of TEST2's 16 classifiers
CLASSIFIERS = (
    (0, 4, 3, 15, 1.98215, 2.35817, 2.63523),
    (4, 4, 6, 15, -1.03809, -0.651211, -0.282167),
    (1, 0, 4, 16, -0.298702, 0.119262, 0.558497),
    (3, 8, 2, 12, -0.105439, 0.0153946, 0.135898),
    (3, 4, 4, 8, -0.142891, 0.0258736, 0.200632),
    (4, 0, 3, 5, -0.826319, -0.590612, -0.368214),
    (1, 2, 2, 9, -0.557409, -0.233035, 0.0534525),
    (2, 7, 3, 4, -0.0646826, 0.00620476, 0.0784847),
    (2, 6, 2, 16, -0.192387, -0.029699, 0.215855),
    (2, 1, 3, 2, -0.0397818, -0.00568076, 0.0292026),
    (5, 10, 1, 15, -0.53823, -0.369934, -0.190235),
    (3, 6, 2, 10, -0.124877, 0.0296483, 0.139239),
    (2, 1, 1, 14, -0.101475, 0.0225617, 0.231971),
    (3, 5, 6, 4, -0.0799915, -0.00729616, 0.063262),
    (1, 9, 2, 12, -0.272556, 0.019424, 0.302559),
    (3, 4, 2, 14, -0.164292, -0.0321188, 0.0846339),
)
THRESHOLDS = np.array([c[4:] for c in CLASSIFIERS], dtype=np.float64)


def _classifier_matrix() -> np.ndarray:
    """(192, 32): columns 2c and 2c+1 sum the "a" and "b" areas of
    classifier c over a (16 frames x 12 bands) window."""
    W = np.zeros((MAX_FILTER_WIDTH * NUM_BANDS, 2 * len(CLASSIFIERS)))

    def add(col, ts, bs):
        for t in ts:
            for b in bs:
                W[t * NUM_BANDS + b, col] += 1.0

    for c, (ft, y, h, w, *_) in enumerate(CLASSIFIERS):
        a, b = 2 * c, 2 * c + 1
        if ft == 0:
            add(a, range(w), range(y, y + h))
        elif ft == 1:
            add(a, range(w), range(y + h // 2, y + h))
            add(b, range(w), range(y, y + h // 2))
        elif ft == 2:
            add(a, range(w // 2, w), range(y, y + h))
            add(b, range(w // 2), range(y, y + h))
        elif ft == 3:
            w2, h2 = w // 2, h // 2
            add(a, range(w2), range(y + h2, y + h))
            add(b, range(w2), range(y, y + h2))
            add(a, range(w2, w), range(y, y + h2))
            add(b, range(w2, w), range(y + h2, y + h))
        elif ft == 4:
            h3 = h // 3
            add(a, range(w), range(y + h3, y + 2 * h3))
            add(b, range(w), range(y, y + h3))
            add(b, range(w), range(y + 2 * h3, y + h))
        else:
            w3 = w // 3
            add(a, range(w3, 2 * w3), range(y, y + h))
            add(b, range(w3), range(y, y + h))
            add(b, range(2 * w3, w), range(y, y + h))
    return W


@functools.lru_cache(maxsize=1)
def _tables():
    i = np.arange(FRAME_SIZE, dtype=np.float64)
    window = WINDOW_SCALE * (0.54 - 0.46 * np.cos(i * 2.0 * np.pi / (FRAME_SIZE - 1)))
    lo = max(1, int(round(FRAME_SIZE * MIN_FREQ / SAMPLE_RATE)))
    hi = min(FRAME_SIZE // 2, int(round(FRAME_SIZE * MAX_FREQ / SAMPLE_RATE)))
    freq = np.arange(lo, hi, dtype=np.float64) * SAMPLE_RATE / FRAME_SIZE
    octave = np.log2(freq / (440.0 / 16.0))
    notes = (NUM_BANDS * (octave - np.floor(octave))).astype(np.int64)
    fold = np.zeros((hi - lo, NUM_BANDS))
    fold[np.arange(hi - lo), notes] = 1.0
    return window, lo, hi, fold, _classifier_matrix()


def num_frames(n_samples: int) -> int:
    return 0 if n_samples < FRAME_SIZE else 1 + (n_samples - FRAME_SIZE) // HOP_SIZE


def num_subfingerprints(n_samples: int) -> int:
    n_filtered = num_frames(n_samples) - (len(CHROMA_FILTER_COEFFS) - 1)
    return max(0, n_filtered - (MAX_FILTER_WIDTH - 1))


def size_bucket(x: int, minimum: int = 256) -> int:
    """Quarter steps between powers of two (the lane's frame bucket)."""
    b = minimum
    while b < x:
        b *= 2
    for q in (b // 2 + b // 8, b // 2 + b // 4, b // 2 + 3 * b // 8, b):
        if x <= q:
            return q
    return b


def decimation_factor(in_rate: int) -> int:
    """2 or 4 where that keeps the mid rate at 8 kHz or more, else 1."""
    for f in (4, 3, 2):
        if in_rate % f == 0 and in_rate // f >= 8000:
            return f if f in (2, 4) else 1
    return 1


@functools.lru_cache(maxsize=8)
def _halfband_q14(n_odd: int, beta: float):
    H = 2 * n_odd - 1
    d = np.arange(1, H + 1, 2, dtype=np.float64)
    w = np.kaiser(2 * H + 1, beta)[H + 1:][d.astype(np.int64) - 1]
    taps = 0.5 * np.sinc(d / 2.0) * w
    scale = 1.0 / (0.5 + 2.0 * taps.sum())
    return (np.round(taps * scale * 16384.0).astype(np.int32),
            int(round(0.5 * scale * 16384.0)))


HB_MAIN, HB_RELAXED = (28, 9.0), (3, 5.65)


@functools.lru_cache(maxsize=8)
def _resample_plan(in_rate: int):
    """(L, M, k, float64 (k*M + 2H, k*L) filter of the polyphase resample
    in_rate -> 11025 Hz), the taps rounded to float32 as the card uses."""
    g = math.gcd(SAMPLE_RATE, in_rate)
    L, M = SAMPLE_RATE // g, in_rate // g
    k = max(1, -(-128 // L))
    H = RS_HALF_TAPS
    fc = 0.5 * min(1.0, L / M) * 0.945
    j = np.arange(k * M + 2 * H, dtype=np.float64)[:, None]
    p = np.arange(k * L, dtype=np.float64)[None, :]
    x = (j - H) - p * M / L
    taps = 2.0 * fc * np.sinc(2.0 * fc * x)
    taps *= np.kaiser(2 * 4096 + 1, 9.0)[
        np.clip((x / H * 4096 + 4096).round().astype(np.int64), 0, 2 * 4096)]
    taps[np.abs(x) > H] = 0.0
    taps /= taps.sum(axis=0, keepdims=True)
    mat = taps.astype(np.float32).astype(np.float64)
    try:
        import scipy.sparse

        mat = scipy.sparse.csc_matrix(mat)
    except ImportError:
        pass
    return L, M, k, mat


def lane_geometry(n_valid: int, in_rate: int, channels: int):
    """(n_sub, frame bucket, decimation factor) of a lane of n_valid
    interleaved samples."""
    dec = decimation_factor(in_rate)
    mid = in_rate // dec
    L, M, _, _ = _resample_plan(mid)
    n_res = ((n_valid // channels) // dec) * L // M
    return num_subfingerprints(n_res), size_bucket(num_frames(n_res)), dec


def _decimate2(x: np.ndarray, odd_q, c0: int) -> np.ndarray:
    """Half-band decimation by 2 of (frames, channels) integers: Q14 taps,
    (acc + 8192) >> 14, clipped to i16, zero-padded edges."""
    x = np.asarray(x, dtype=np.int64)
    n, C = x.shape
    H = 2 * len(odd_q) - 1
    out_n = n // 2
    pad_top = H + 1
    pad_bot = H + 1 + ((pad_top + n + H + 1) % 2)
    xp = np.concatenate([np.zeros((pad_top, C), np.int64), x,
                         np.zeros((pad_bot, C), np.int64)])

    def sl(offset):
        o = offset + pad_top
        return xp[o:o + 2 * out_n:2]

    acc = np.int64(c0) * sl(0)
    for m, q in enumerate(np.asarray(odd_q)):
        d = 2 * m + 1
        acc = acc + np.int64(q) * (sl(-d) + sl(d))
    return np.clip((acc + 8192) >> 14, -32768, 32767).astype(np.int32)


def _mid_rate_mono(segment, n_valid, channels, dec, in_len_mid):
    """The lane as integer mono at the mid rate: zero-extended to the
    bucket, zero past n_valid, decimated with the same masking between
    stages, downmixed with C integer division."""
    raw_len = in_len_mid * channels * dec
    seg = np.zeros(raw_len, np.int16)
    take = min(len(segment), raw_len)
    seg[:take] = segment[:take]
    nv = min(int(n_valid), raw_len) // channels
    if channels == 1 and dec == 1:
        seg[nv:] = 0
        return seg
    x = seg.reshape(-1, channels).astype(np.int32)
    x[nv:] = 0
    if dec == 4:
        x = _decimate2(x, *_halfband_q14(*HB_RELAXED))
        nv //= 2
        x[nv:] = 0
    if dec > 1:
        x = _decimate2(x, *_halfband_q14(*HB_MAIN))
        nv //= 2
        x[nv:] = 0
    if channels == 2:
        s = x[:, 0] + x[:, 1]
        return np.where(s < 0, -((-s) >> 1), s >> 1)
    return np.ascontiguousarray(x[:, 0])


def _resample(mono_mid: np.ndarray, mid_rate: int, n_out: int) -> np.ndarray:
    """The first n_out samples at 11025 Hz: each the float64 dot of its
    block's input window with its filter column, cast to float32."""
    L, M, k, mat = _resample_plan(mid_rate)
    H, kM, kL = RS_HALF_TAPS, k * M, k * L
    xpad = np.concatenate([np.zeros(H, mono_mid.dtype), mono_mid])
    n_blocks = -(-n_out // kL)
    need = (n_blocks - 1) * kM + kM + 2 * H
    if len(xpad) < need:
        xpad = np.pad(xpad, (0, need - len(xpad)))
    it = xpad.strides[0]
    W = np.lib.stride_tricks.as_strided(
        xpad, shape=(n_blocks, kM + 2 * H), strides=(it * kM, it)).astype(np.float64)
    return np.asarray(W @ mat).reshape(-1)[:n_out].astype(np.float32)


def _fingerprint(mono: np.ndarray, n_sub: int) -> np.ndarray:
    """float32 samples at 11025 Hz -> the first n_sub subfingerprints."""
    window, lo, hi, fold, W_cls = _tables()
    nf = num_frames(len(mono))
    if nf <= 0 or n_sub <= 0:
        return np.zeros(0, np.uint32)
    x = np.ascontiguousarray(mono, dtype=np.float32)
    frames = np.lib.stride_tricks.as_strided(
        x, shape=(nf, FRAME_SIZE), strides=(x.strides[0] * HOP_SIZE, x.strides[0]),
        writeable=False)
    windowed = (frames.astype(np.float64) * window).astype(np.float32)
    spec = np.fft.rfft(windowed, axis=-1)
    re, im = spec.real.astype(np.float32), spec.imag.astype(np.float32)
    energy = (re * re + im * im).astype(np.float64)
    chroma = energy[:, lo:hi] @ fold
    n = chroma.shape[0] - (len(CHROMA_FILTER_COEFFS) - 1)
    filtered = np.zeros((n, NUM_BANDS))
    for k, c in enumerate(CHROMA_FILTER_COEFFS):
        filtered += c * chroma[k:k + n]
    norm = np.sqrt(np.sum(filtered * filtered, axis=1, keepdims=True))
    normalized = filtered / np.where(norm < CHROMA_NORM_THRESHOLD, 1.0, norm)
    normalized[norm[:, 0] < CHROMA_NORM_THRESHOLD] = 0.0
    m = normalized.shape[0] - (MAX_FILTER_WIDTH - 1)
    if m <= 0:
        return np.zeros(0, np.uint32)
    windows = np.lib.stride_tricks.sliding_window_view(
        normalized, (MAX_FILTER_WIDTH, NUM_BANDS))[:, 0].reshape(
            m, MAX_FILTER_WIDTH * NUM_BANDS)
    ab = windows @ W_cls
    values = np.log((1.0 + ab[:, 0::2]) / (1.0 + ab[:, 1::2]))
    q = sum((values >= THRESHOLDS[:, k]).astype(np.uint32) for k in range(3))
    shifts = (2 * (15 - np.arange(16))).astype(np.uint32)
    hashes = np.bitwise_or.reduce(GRAY_CODE[q] << shifts, axis=1).astype(np.uint32)
    return hashes[:n_sub]


def lane_hashes(segment: np.ndarray, n_valid: int, in_rate: int,
                channels: int) -> np.ndarray:
    """Every subfingerprint of the lane: `segment` (interleaved i16, may
    run past the window) with n_valid interleaved samples of it valid."""
    n_sub, nf_bucket, dec = lane_geometry(n_valid, in_rate, channels)
    if n_sub <= 0:
        return np.zeros(0, np.uint32)
    mid = in_rate // dec
    L, M, k, _ = _resample_plan(mid)
    out_needed = (nf_bucket + ROWS_PER_FRAME + 1) * HOP_SIZE
    in_len_mid = (-(-out_needed // (k * L)) + 1) * (k * M)
    mono_mid = _mid_rate_mono(segment, n_valid, channels, dec, in_len_mid)
    if mid != SAMPLE_RATE:
        mono = _resample(mono_mid, mid, out_needed)
    else:
        mono = np.zeros(out_needed, np.float32)
        take = min(len(mono_mid), out_needed)
        mono[:take] = mono_mid[:take].astype(np.float32)
    return _fingerprint(mono, n_sub)
