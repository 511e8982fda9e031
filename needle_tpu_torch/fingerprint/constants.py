"""Constants of the chromaprint TEST2 fingerprint algorithm (v1.5.x).

The reference consumes these via the chromaprint C++ library
(chromaprint-sys-next 1.5.3; see needle/Cargo.lock and
needle/src/audio/analyzer.rs:176). The algorithm:

  PCM i16 @ 11025 Hz, mono (stereo downmixed by integer averaging)
  -> overlapping frames (4096 samples, hop 1365)
  -> Hamming window (scaled for i16 normalization)
  -> real DFT -> per-bin energy (re^2 + im^2)
  -> 12-bin chroma fold over bins covering 28..3520 Hz
  -> 5-tap temporal chroma filter [0.25, 0.75, 1.0, 0.75, 0.25]
  -> per-frame Euclidean normalization (threshold 0.01)
  -> 16 trained classifiers, each an area-difference filter over a
     (time x band) window compared via log((1+a)/(1+b)) and quantized
     against 3 trained thresholds
  -> 2-bit gray code per classifier, packed MSB-first into one u32
     subfingerprint per hop.

The quantizer threshold tables below were verified double-for-double against
the compiled libchromaprint 1.5.1 binary (.rodata at 0x104c8-0x10640, stored
as reversed (t2, t1, t0) triples in classifier order). The delay/item-duration
values were verified against the live library:
  chromaprint_get_delay = 28666 samples, chromaprint_get_item_duration = 1365.

The port's own copy of needle_tpu/fingerprint/constants.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

SAMPLE_RATE = 11025
FRAME_SIZE = 4096
FRAME_OVERLAP = 2731
HOP_SIZE = FRAME_SIZE - FRAME_OVERLAP  # 1365

NUM_BANDS = 12
MIN_FREQ = 28.0
MAX_FREQ = 3520.0

# Temporal chroma filter (length 5).
CHROMA_FILTER_COEFFS = np.array([0.25, 0.75, 1.0, 0.75, 0.25], dtype=np.float64)
CHROMA_FILTER_SIZE = len(CHROMA_FILTER_COEFFS)

# Frame norm below this threshold -> zero vector.
CHROMA_NORM_THRESHOLD = 0.01

# Classifier geometry limit (largest filter width, in filtered-chroma frames).
MAX_FILTER_WIDTH = 16

# Latency bookkeeping, matching chromaprint's FingerprinterConfiguration:
#   item_duration = frame_size - frame_overlap                       (= 1365)
#   delay = ((chroma_filter_len - 1) + (max_filter_width - 1)) * item + overlap
#         = (4 + 15) * 1365 + 2731 = 28666 samples
ITEM_DURATION_SAMPLES = HOP_SIZE
DELAY_SAMPLES = (CHROMA_FILTER_SIZE - 1 + MAX_FILTER_WIDTH - 1) * HOP_SIZE + FRAME_OVERLAP

# Hamming window scale: chromaprint folds the i16 normalization into the
# window table. The *effective* input scale of the canonical pipeline is
# 1/32768 (calibrated empirically against libchromaprint with amplitude-ramp
# audio sweeping the chroma-normalizer threshold; 0.5/32768 and 2/32768 both
# produce wrong norm-zeroing decisions).
WINDOW_SCALE = 1.0 / 32768.0

# Gray code applied to each 2-bit quantized classifier output.
GRAY_CODE = np.array([0, 1, 3, 2], dtype=np.uint32)


class Classifier(NamedTuple):
    """One trained classifier: an area filter plus a 3-threshold quantizer.

    filter_type selects the area-difference pattern (0..5); (y, height) span
    chroma bands; width spans time (filtered-chroma frames). The filter value
    is compared via subtract-log: log((1 + a) / (1 + b)).
    """

    filter_type: int
    y: int
    height: int
    width: int
    t0: float
    t1: float
    t2: float


# CHROMAPRINT_ALGORITHM_TEST2 (the library default) classifier set.
# Quantizer thresholds verified against libchromaprint 1.5.1 .rodata.
CLASSIFIERS_TEST2 = (
    Classifier(0, 4, 3, 15, 1.98215, 2.35817, 2.63523),
    Classifier(4, 4, 6, 15, -1.03809, -0.651211, -0.282167),
    Classifier(1, 0, 4, 16, -0.298702, 0.119262, 0.558497),
    Classifier(3, 8, 2, 12, -0.105439, 0.0153946, 0.135898),
    Classifier(3, 4, 4, 8, -0.142891, 0.0258736, 0.200632),
    Classifier(4, 0, 3, 5, -0.826319, -0.590612, -0.368214),
    Classifier(1, 2, 2, 9, -0.557409, -0.233035, 0.0534525),
    Classifier(2, 7, 3, 4, -0.0646826, 0.00620476, 0.0784847),
    Classifier(2, 6, 2, 16, -0.192387, -0.029699, 0.215855),
    Classifier(2, 1, 3, 2, -0.0397818, -0.00568076, 0.0292026),
    Classifier(5, 10, 1, 15, -0.53823, -0.369934, -0.190235),
    Classifier(3, 6, 2, 10, -0.124877, 0.0296483, 0.139239),
    Classifier(2, 1, 1, 14, -0.101475, 0.0225617, 0.231971),
    Classifier(3, 5, 6, 4, -0.0799915, -0.00729616, 0.063262),
    Classifier(1, 9, 2, 12, -0.272556, 0.019424, 0.302559),
    Classifier(3, 4, 2, 14, -0.164292, -0.0321188, 0.0846339),
)


def hamming_window(n: int = FRAME_SIZE, scale: float = WINDOW_SCALE) -> np.ndarray:
    """Chromaprint's PrepareHammingWindow: scale*(0.54 - 0.46*cos(2*pi*i/(n-1)))."""
    i = np.arange(n, dtype=np.float64)
    return scale * (0.54 - 0.46 * np.cos(i * 2.0 * np.pi / (n - 1)))


def chroma_bin_ranges(
    frame_size: int = FRAME_SIZE, sample_rate: int = SAMPLE_RATE
) -> tuple[int, int, np.ndarray]:
    """Spectral-bin -> chroma-band mapping (chromaprint Chroma::PrepareNotes).

    Returns (min_index, max_index, notes) where notes[i] is the band of bin i
    for i in [min_index, max_index).
    """
    min_index = max(1, int(round(frame_size * MIN_FREQ / sample_rate)))
    max_index = min(frame_size // 2, int(round(frame_size * MAX_FREQ / sample_rate)))
    base = 440.0 / 16.0  # 27.5 Hz
    i = np.arange(min_index, max_index, dtype=np.float64)
    freq = i * sample_rate / frame_size
    octave = np.log2(freq / base)
    note = NUM_BANDS * (octave - np.floor(octave))
    notes = note.astype(np.int64)  # truncation, like (char)note
    return min_index, max_index, notes


def classifier_window_matrix() -> tuple[np.ndarray, np.ndarray]:
    """Express all 16 classifiers as one linear map over a flattened
    (MAX_FILTER_WIDTH x NUM_BANDS) window of filtered chroma values.

    Each classifier's filter value is (sum over area A) - like comparisons of
    two area sums a and b; since both areas are sums of window cells with
    coefficients in {0, +1, -1}, we can compute a and b for all classifiers
    with a single (192 x 32) matmul: columns 2*c and 2*c+1 hold the "a" and
    "b" cell masks of classifier c. This is the MXU-friendly formulation used
    by the TPU kernel (replacing chromaprint's CPU integral image).
    """
    W = np.zeros((MAX_FILTER_WIDTH * NUM_BANDS, 2 * len(CLASSIFIERS_TEST2)), np.float64)

    def cell(t, b):
        return t * NUM_BANDS + b

    for c, cl in enumerate(CLASSIFIERS_TEST2):
        a_col, b_col = 2 * c, 2 * c + 1
        x, y, w, h = 0, cl.y, cl.width, cl.height
        ft = cl.filter_type
        if ft == 0:
            # a = whole block, b = 0
            for t in range(x, x + w):
                for b in range(y, y + h):
                    W[cell(t, b), a_col] += 1.0
        elif ft == 1:
            # a = upper band half, b = lower band half
            h2 = h // 2
            for t in range(x, x + w):
                for b in range(y + h2, y + h):
                    W[cell(t, b), a_col] += 1.0
                for b in range(y, y + h2):
                    W[cell(t, b), b_col] += 1.0
        elif ft == 2:
            # a = right time half, b = left time half
            w2 = w // 2
            for t in range(x + w2, x + w):
                for b in range(y, y + h):
                    W[cell(t, b), a_col] += 1.0
            for t in range(x, x + w2):
                for b in range(y, y + h):
                    W[cell(t, b), b_col] += 1.0
        elif ft == 3:
            # checkerboard: a = (left,upper)+(right,lower), b = other diagonal
            w2, h2 = w // 2, h // 2
            for t in range(x, x + w2):
                for b in range(y + h2, y + h):
                    W[cell(t, b), a_col] += 1.0
                for b in range(y, y + h2):
                    W[cell(t, b), b_col] += 1.0
            for t in range(x + w2, x + w):
                for b in range(y, y + h2):
                    W[cell(t, b), a_col] += 1.0
                for b in range(y + h2, y + h):
                    W[cell(t, b), b_col] += 1.0
        elif ft == 4:
            # a = middle band third, b = outer band thirds
            h3 = h // 3
            for t in range(x, x + w):
                for b in range(y + h3, y + 2 * h3):
                    W[cell(t, b), a_col] += 1.0
                for b in range(y, y + h3):
                    W[cell(t, b), b_col] += 1.0
                for b in range(y + 2 * h3, y + h):
                    W[cell(t, b), b_col] += 1.0
        elif ft == 5:
            # a = middle time third, b = outer time thirds
            w3 = w // 3
            for t in range(x + w3, x + 2 * w3):
                for b in range(y, y + h):
                    W[cell(t, b), a_col] += 1.0
            for t in range(x, x + w3):
                for b in range(y, y + h):
                    W[cell(t, b), b_col] += 1.0
            for t in range(x + 2 * w3, x + w):
                for b in range(y, y + h):
                    W[cell(t, b), b_col] += 1.0
        else:
            raise ValueError(f"unknown filter type {ft}")

    widths = np.array([cl.width for cl in CLASSIFIERS_TEST2], dtype=np.int64)
    return W, widths


QUANTIZER_THRESHOLDS = np.array(
    [[c.t0, c.t1, c.t2] for c in CLASSIFIERS_TEST2], dtype=np.float64
)
