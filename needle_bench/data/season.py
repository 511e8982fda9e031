"""A season of synthetic episodes, written from a seed.

A frozen copy of the port's season writer (`make_synthetic_season` in
needle_tpu_torch/testing.py, the same as needle_tpu/testing.py): episodes
of pseudo-music that share an opening at a random offset and, optionally,
an ending a few seconds before their end. The same seed gives the same
samples as that writer, and in the formats `wav` and `pcm` the same bytes.
How an episode's samples become its file is the season format's
(formats/<format>.py, whose module is handed over by path).

A run's season is written from the run's seed (`ensure_season`): every
seed gives episodes of the same sizes, offsets drawn from the same ranges,
and other audio. A directory holds one seed's season; a run with another
seed writes its own over it.

The random stream is one generator for the whole season, so episode e
depends on every draw before it. `write_season` replays the draws alone
(cheap) to find the generator's state at the start of each episode, and
computes the episodes (the sines, most of the time) in worker processes:
a season of 28 x 1200 s takes about a minute on one core. Each file is
flushed to the disk before the call returns, so that no write-back of the
season runs on into a run's window.
Imports nothing but numpy and the format's module.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import shutil
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from .. import formats

MARKER = "SEASON.json"
# files of the reference's cache, which live beside the season they are of
REFERENCE_PREFIX = "reference"
AMPLITUDE = 9000


def _music_like(rng: np.random.Generator, n: int, rate: int) -> np.ndarray:
    """Pseudo-music: random chromatic chord progression + noise, in [-1,1]
    (chord changes every ~2 s)."""
    t = np.arange(n) / rate
    out = np.zeros(n)
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


def _skip_music_like(rng: np.random.Generator, n: int, rate: int) -> None:
    """The draws of `_music_like(rng, n, rate)`, in its order, without the
    sines: leaves rng where `_music_like` would."""
    seg = 2 * rate
    for _ in range(0, n, seg):
        rng.choice(12, size=3, replace=False)
        rng.choice([0.5, 1.0, 1.0, 2.0], size=3)
        rng.uniform(0.99, 1.01, size=3)
        rng.uniform(0.1, 0.3, size=3)
        for _ in range(3):
            rng.uniform(0, 2 * np.pi)
    rng.standard_normal(n)


def _shared_segments(seed: int, spec: dict):
    """(rng after the shared opening and ending, opening, ending or None)."""
    rate = spec["rate"]
    rng = np.random.default_rng(seed)
    opening = _music_like(rng, int(spec["opening_secs"] * rate), rate)
    ending = (_music_like(rng, int(spec["ending_secs"] * rate), rate)
              if spec["ending_secs"] > 0 else None)
    return rng, opening, ending


_WORKER = {}


def _worker_init(seed: int, spec: dict, fmt) -> None:
    _, opening, ending = _shared_segments(seed, spec)
    _WORKER.update(spec=spec, opening=opening, ending=ending,
                   write=formats.load(fmt).write)


def _write_episode(job) -> None:
    state, start, end_off, path = job
    spec, opening, ending = _WORKER["spec"], _WORKER["opening"], _WORKER["ending"]
    rate = spec["rate"]
    rng = np.random.Generator(np.random.PCG64())
    rng.bit_generator.state = state
    body = _music_like(rng, int(spec["episode_secs"] * rate), rate) * 0.5
    body[start : start + len(opening)] = opening
    if ending is not None:
        body[end_off : end_off + len(ending)] = ending
    pcm = np.clip(body * AMPLITUDE, -32768, 32767).astype(np.int16)
    _WORKER["write"](path, pcm, spec)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def episode_name(e: int, ext: str) -> str:
    return f"ep{e + 1:02d}.{ext}"


def write_season(out_dir, spec: dict, seed: int, fmt, workers: int = None):
    """Write the season `spec` (episodes, episode_secs, opening_secs,
    opening_offsets [lo, hi], ending_secs, rate, format, and the format's
    SPEC_KEYS) from `seed` into out_dir, in the format whose module is at
    the path `fmt` (formats/). Returns (paths, opening truth, ending
    truth), each truth a (start s, end s) per episode (None where there is
    no ending)."""
    ext = formats.load(fmt).EXT
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rate = spec["rate"]
    n_ep = int(spec["episode_secs"] * rate)
    rng, opening, ending = _shared_segments(seed, spec)
    jobs, opening_truth, ending_truth = [], [], []
    for e in range(spec["episodes"]):
        state = rng.bit_generator.state
        _skip_music_like(rng, n_ep, rate)
        start = int(rng.uniform(*spec["opening_offsets"]) * rate)
        opening_truth.append((start / rate, (start + len(opening)) / rate))
        end_off = None
        if ending is not None:
            end_off = n_ep - len(ending) - int(rng.uniform(1.0, 4.0) * rate)
            ending_truth.append((end_off / rate, (end_off + len(ending)) / rate))
        else:
            ending_truth.append(None)
        jobs.append((state, start, end_off,
                     str(out_dir / episode_name(e, ext))))
    workers = max(1, min(workers or os.cpu_count() or 1, len(jobs)))
    with ProcessPoolExecutor(workers, multiprocessing.get_context("spawn"),
                             _worker_init, (seed, spec, fmt)) as pool:
        for _ in pool.map(_write_episode, jobs):
            pass
    return [Path(j[3]) for j in jobs], opening_truth, ending_truth


def ensure_season(season_dir, spec: dict, seed: int, fmt):
    """(paths, opening truth, ending truth, seconds spent writing) of the
    season of `spec` written from `seed` in season_dir, in the format whose
    module is at `fmt` (as write_season). Kept while its marker names that
    seed and spec, with only the episodes and the reference's cache left in
    the directory (what earlier runs wrote beside the episodes is removed);
    else written anew, after everything in the directory is removed, so a
    directory holds one seed's season."""
    season_dir = Path(season_dir)
    marker = season_dir / MARKER
    if marker.exists():
        held = json.loads(marker.read_text())
        paths = [season_dir / n for n in held["files"]]
        if (held["seed"] == seed and held["spec"] == spec
                and all(p.exists() for p in paths)):
            keep = {MARKER, *held["files"]}
            for p in season_dir.iterdir():
                if p.name not in keep and not p.name.startswith(REFERENCE_PREFIX):
                    p.unlink()
            return paths, held["opening"], held["ending"], 0.0
    t = time.perf_counter()
    if season_dir.exists():
        shutil.rmtree(season_dir)
    paths, op_truth, en_truth = write_season(season_dir, spec, seed, fmt)
    held = json.loads(json.dumps({  # as a later run reads it back
        "seed": seed, "spec": spec, "files": [p.name for p in paths],
        "opening": op_truth, "ending": en_truth}))
    marker.write_text(json.dumps(held))
    return paths, held["opening"], held["ending"], time.perf_counter() - t
