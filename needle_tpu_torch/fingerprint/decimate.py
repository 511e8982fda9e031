"""Half-band decimation design of the fused ingest (copy of what the port
uses of needle_tpu/fingerprint/decimate.py).

Chromaprint's chroma fold only consumes spectral bins up to ~3520 Hz
(constants.chroma_bin_ranges), so any representation with >= ~8 kHz sample
rate carries every bit of information the fingerprint uses. Sources at
16 kHz or more are decimated by 2 or 4 on the device before the resample
to 11025 Hz, with integer half-band FIRs whose Q14 taps come from here and
whose exact arithmetic the device program, the canonical host oracle and
the native layer share.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

# Highest chroma band edge (constants.chroma_bin_ranges: bins up to
# ~3520 Hz) plus transition headroom.
_MIN_RATE = 8000


def decimation_factor(in_rate: int) -> int:
    """Largest small integer factor keeping the decimated rate >= 8 kHz."""
    for f in (4, 3, 2):
        if in_rate % f == 0 and in_rate // f >= _MIN_RATE:
            return f
    return 1


@functools.lru_cache(maxsize=8)
def _halfband_q14(n_odd: int, beta: float) -> Tuple[np.ndarray, int]:
    """Half-band lowpass for factor-2 decimation: h[d] = 0.5 sinc(d/2) w[d]
    — every even-offset tap vanishes and the odd taps are symmetric, so the
    native kernel needs n_odd+1 multiplies per output instead of 4*n_odd+1.
    Returns (odd-offset taps 1,3,..,2*n_odd-1 as Q14 int32, center tap Q14),
    DC gain normalized to 1 before quantization.

    Design points: the final stage to ~8-11 kHz uses n_odd=28, beta=9
    (transition ~0.219-0.281 of the input rate: flat through chroma's
    3520 Hz top band at 16 kHz in, stopband before the first alias that
    could fold below it). The relaxed first stage of a factor-4 cascade
    uses n_odd=3, beta=5.65 (only content above ~18 kHz can alias into the
    chroma band after the second stage, so the transition can be huge)."""
    H = 2 * n_odd - 1
    d = np.arange(1, H + 1, 2, dtype=np.float64)
    w = np.kaiser(2 * H + 1, beta)[H + 1 :][d.astype(np.int64) - 1]
    taps = 0.5 * np.sinc(d / 2.0) * w
    center = 0.5
    scale = 1.0 / (center + 2.0 * taps.sum())
    return (
        np.round(taps * scale * 16384.0).astype(np.int32),
        int(round(center * scale * 16384.0)),
    )


_HB_MAIN = (28, 9.0)  # final stage (flat to 3520 Hz at 16 kHz input)
_HB_RELAXED = (3, 5.65)  # first stage of a /4 cascade
