"""Season format `wav`: 16-bit PCM RIFF/WAVE, mono at the configuration's
rate, which the analyzer reads whole at its source rate (the raw route)."""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from needle_bench.reference.files import raw_windows

EXT = "wav"
SPEC_KEYS = ()


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


def write(path, pcm: np.ndarray, spec: dict) -> None:
    write_wav_i16(path, pcm, spec["rate"], 1)


def read_samples(path):
    """(interleaved i16 samples, rate, channels) of a WAV file."""
    path = Path(path)
    raw = path.read_bytes()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"not a WAV file: {path}")
    pos, fmt_chunk, data = 12, None, None
    while pos + 8 <= len(raw):
        cid, size = raw[pos:pos + 4], struct.unpack("<I", raw[pos + 4:pos + 8])[0]
        if cid == b"fmt ":
            fmt_chunk = struct.unpack("<HHIIHH", raw[pos + 8:pos + 24])
        elif cid == b"data":
            data = raw[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)
    audio_fmt, channels, rate, _, _, bits = fmt_chunk
    if audio_fmt != 1 or bits != 16:
        raise ValueError(f"not 16-bit PCM: {path}")
    return np.frombuffer(data, dtype="<i2"), rate, channels


def windows(path, cfg: dict):
    return raw_windows(*read_samples(path), cfg)
