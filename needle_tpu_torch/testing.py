"""Synthetic media generation for tests and benchmarks.

Builds "seasons" of episodes that share a synthetic opening (and optionally
ending) audio segment at slightly different offsets — the ground truth the
search engine must recover. Mirrors the role of the reference's bundled
sample videos (needle/resources/sample-5s.mp4 & sample-shifted-4s.mp4: same
content, one shifted by 4 s). The port's own copy of needle_tpu/testing.py:
the same seed gives the same WAV bytes and truth.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np


def write_wav_i16(path, samples: np.ndarray, rate: int, channels: int = 1) -> None:
    """Minimal RIFF/WAVE PCM16 writer."""
    samples = np.ascontiguousarray(samples, dtype="<i2")
    data = samples.tobytes()
    with open(path, "wb") as f:
        byte_rate = rate * channels * 2
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, channels, rate, byte_rate, channels * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def _music_like(rng: np.random.Generator, n: int, rate: int) -> np.ndarray:
    """Pseudo-music: random chromatic chord progression + noise, in [-1,1].

    Notes are drawn from the full 12-semitone chromatic scale with random
    octaves and detuning so independent streams occupy DIFFERENT chroma
    bins — two unrelated segments must not look alike to a chroma-based
    fingerprint (with only a few base notes, cross-episode Hamming
    distances sit near the default match threshold and any matcher — the
    reference's included — over-extends matched runs into the background)."""
    t = np.arange(n) / rate
    out = np.zeros(n)
    # chord changes every ~2 s
    seg = 2 * rate
    for s in range(0, n, seg):
        e = min(n, s + seg)
        semis = rng.choice(12, size=3, replace=False)
        octaves = rng.choice([0.5, 1.0, 1.0, 2.0], size=3)
        detune = rng.uniform(0.99, 1.01, size=3)
        freqs = 220.0 * (2.0 ** (semis / 12.0)) * octaves * detune
        amps = rng.uniform(0.1, 0.3, size=3)
        for fq, a in zip(freqs, amps):
            out[s:e] += a * np.sin(2 * np.pi * fq * t[s:e] + rng.uniform(0, 2 * np.pi))
    out += 0.02 * rng.standard_normal(n)
    return out


def make_synthetic_season(
    out_dir,
    num_episodes: int = 3,
    episode_secs: float = 120.0,
    opening_secs: float = 25.0,
    opening_offset_range: Tuple[float, float] = (5.0, 15.0),
    ending_secs: float = 0.0,
    rate: int = 16000,
    seed: int = 1234,
    amplitude: int = 9000,
    file_prefix: str = "ep",
) -> Tuple[List[Path], List[Tuple[float, float]], List[Optional[Tuple[float, float]]]]:
    """Write WAV episodes sharing an opening (and optionally ending) segment.

    Returns (paths, opening_truth, ending_truth) where truths are
    (start_secs, end_secs) per episode.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    n_ep = int(episode_secs * rate)
    opening = _music_like(rng, int(opening_secs * rate), rate)
    ending = _music_like(rng, int(ending_secs * rate), rate) if ending_secs > 0 else None

    paths: List[Path] = []
    opening_truth: List[Tuple[float, float]] = []
    ending_truth: List[Optional[Tuple[float, float]]] = []
    for e in range(num_episodes):
        body = _music_like(rng, n_ep, rate) * 0.5
        off = rng.uniform(*opening_offset_range)
        start = int(off * rate)
        body[start : start + len(opening)] = opening
        opening_truth.append((start / rate, (start + len(opening)) / rate))
        if ending is not None:
            end_off = n_ep - len(ending) - int(rng.uniform(1.0, 4.0) * rate)
            body[end_off : end_off + len(ending)] = ending
            ending_truth.append((end_off / rate, (end_off + len(ending)) / rate))
        else:
            ending_truth.append(None)
        pcm = np.clip(body * amplitude, -32768, 32767).astype(np.int16)
        p = out_dir / f"{file_prefix}{e + 1:02d}.wav"
        write_wav_i16(p, pcm, rate, 1)
        paths.append(p)
    return paths, opening_truth, ending_truth
