"""Season format `pcm`: the samples headerless, 16-bit little-endian mono at
the configuration's rate (the pre-decoded input of bench.py's small3),
which the analyzer reads whole at its source rate (the raw route)."""

from __future__ import annotations

import numpy as np

from needle_bench.reference.files import raw_windows

EXT = "pcm"
SPEC_KEYS = ()


def write(path, pcm: np.ndarray, spec: dict) -> None:
    pcm.astype("<i2").tofile(path)


def windows(path, cfg: dict):
    return raw_windows(np.fromfile(path, dtype="<i2"), cfg["rate"], 1, cfg)
