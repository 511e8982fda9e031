"""Season format `wav_stereo`: 16-bit PCM RIFF/WAVE, two channels at the
configuration's rate (`channels` must be 2), as a lossless `pcm_s16le`
extraction of an episode's audio track gives it, which the analyzer reads
whole at its source rate (the raw route): at 48 kHz the /4 half-band
cascade and the downmix on the card.

The left channel is the season's seeded mono samples. The right channel is
the same samples delayed by DELAY samples (zeros first) and scaled by 4/5
with integer floor division: the channels differ, (l + r) is odd about half
the time, so the downmix's rounding toward zero does real work, and nothing
is drawn from the season's generator, so the seed's audio, offsets and
truth are those of a mono season at the same rate."""

from __future__ import annotations

import numpy as np

from needle_bench.formats.wav import read_samples, write_wav_i16
from needle_bench.reference.files import raw_windows

EXT = "wav"
SPEC_KEYS = ("channels",)
DELAY = 12  # 0.25 ms at 48 kHz


def right_channel(left: np.ndarray) -> np.ndarray:
    """The right channel made from the left's int16 samples."""
    delayed = np.zeros(len(left), np.int32)
    delayed[DELAY:] = left[: max(0, len(left) - DELAY)]
    return (delayed * 4 // 5).astype(np.int16)


def write(path, pcm: np.ndarray, spec: dict) -> None:
    if spec["channels"] != 2:
        raise ValueError(f"wav_stereo writes 2 channels, not {spec['channels']}")
    frames = np.stack([pcm, right_channel(pcm)], axis=1)
    write_wav_i16(path, frames.reshape(-1), spec["rate"], 2)


def windows(path, cfg: dict):
    return raw_windows(*read_samples(path), cfg)
