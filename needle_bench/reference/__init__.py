"""The plain reference of a season: what the analyzer should write for each
episode (`files`, `fingerprint`), and each pair's RunEntry lists and each
episode's skip file (`search`), worked out again from the season's audio.
Imports nothing of the port.

`season_reference` computes it in worker processes and keeps what it
worked out in a cache file beside the season, for later runs of the same
season: the episodes' hashes, and each match threshold's entries. The
cache holds only under the configuration, the reference's own sources and
the season format's module (formats/) that made it.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
import pickle
from concurrent.futures import ProcessPoolExecutor
from multiprocessing.pool import ThreadPool
from pathlib import Path

from .. import formats
from .files import episode_hashes
from .search import pair_entries, pair_order, votes

HERE = Path(__file__).resolve().parent

_WORKER = {}


def _worker_init(fmt) -> None:
    _WORKER["format"] = formats.load(fmt)


def _episode(args):
    path, cfg = args
    return episode_hashes(path, _WORKER["format"], cfg)


def code_digest(fmt) -> str:
    """sha256 of the reference's sources and of the season format's module
    at `fmt`, which reads the episodes for it."""
    h = hashlib.sha256()
    for p in [*sorted(HERE.glob("*.py")), Path(fmt)]:
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return h.hexdigest()


def season_reference(paths, cfg: dict, threshold: int, fmt, cache=None,
                     workers: int = None) -> dict:
    """{"episodes": episode_hashes() per episode, "pairs": pair_order(n),
    "entries": pair_entries() per pair, "skip": votes()} of the season
    `paths` under the configuration `cfg` at the match `threshold`, kept in
    the file `cache` (if given) for later calls on the same season. `fmt`
    is the path of the season format's module (formats/), which reads the
    episodes."""
    paths = [Path(p) for p in paths]
    key = {"cfg": {k: cfg[k] for k in sorted(cfg)}, "code": code_digest(fmt),
           "files": [p.name for p in paths]}
    held = {"key": key, "episodes": None, "entries": {}}
    if cache is not None and Path(cache).exists():
        with open(cache, "rb") as f:
            loaded = pickle.load(f)
        if loaded["key"] == key:
            held = loaded
    workers = max(1, min(workers or os.cpu_count() or 1, len(paths)))
    fresh = held["episodes"] is None or threshold not in held["entries"]
    if held["episodes"] is None:
        jobs = [(p, cfg) for p in paths]
        with ProcessPoolExecutor(workers, multiprocessing.get_context("spawn"),
                                 _worker_init, (fmt,)) as pool:
            held["episodes"] = list(pool.map(_episode, jobs))
    episodes = held["episodes"]
    pairs = pair_order(len(paths))
    if threshold not in held["entries"]:
        with ThreadPool(workers) as pool:
            held["entries"][threshold] = pool.map(
                lambda ij: pair_entries(episodes[ij[0]], episodes[ij[1]], cfg, threshold),
                pairs)
    if cache is not None and fresh:
        with open(cache, "wb") as f:
            pickle.dump(held, f)
    entries = held["entries"][threshold]
    return {"episodes": episodes, "pairs": pairs, "entries": entries,
            "skip": votes(len(paths), pairs, entries, threshold)}
