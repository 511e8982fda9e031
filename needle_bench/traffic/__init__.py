"""The one traffic generator: one closed-loop user who drives the port's
CLI calls (cli.py:269-312) on a season, as a mix's data file says.

A mix is `traffic/<mix>.json`: {"setup": [steps], "pass": [steps]}. The
steps are `analyze` (analyze with endings and force over every episode,
writing the `.needle.dat` files) and `search` (search with endings over
every pair, writing the skip files). Set-up runs once; the window repeats
the pass, each pass after the one before has ended.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
STEPS = ("analyze", "search")
# what each step writes beside an episode
OUTPUT_SUFFIX = {"analyze": ".needle.dat", "search": ".needle.skip.json"}


def output_path(episode: Path, step: str) -> Path:
    return episode.with_name(episode.stem + OUTPUT_SUFFIX[step])


def load(mix: str, folder=HERE) -> dict:
    spec = json.loads((Path(folder) / f"{mix}.json").read_text())
    for key in ("setup", "pass"):
        bad = [s for s in spec.get(key, ()) if s not in STEPS]
        if key not in spec or bad:
            raise ValueError(f"traffic {mix}: {key!r} must list steps of {STEPS}")
    if not spec["pass"]:
        raise ValueError(f"traffic {mix}: a pass needs a step")
    return spec


class Session:
    """The port on one season, called as its CLI calls it. `threshold` is
    the search's match threshold (the configuration's, unless a control
    asks for another). `last` holds the last search's frame hashes, pairs
    and per-pair infos."""

    def __init__(self, paths, cfg: dict, device: str, threshold: int = None):
        self.paths = [Path(p) for p in paths]
        self.cfg = cfg
        self.device = device
        self.threshold = cfg["threshold"] if threshold is None else threshold
        self.last = {}

    def _sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def analyze(self):
        import numpy as np
        from needle_tpu_torch.analyzer import Analyzer
        from needle_tpu_torch.duration import Duration

        cfg = self.cfg
        return (
            Analyzer.from_files(self.paths, False, True, device=self.device)
            .with_opening_search_percentage(cfg["opening_window"])
            .with_ending_search_percentage(cfg["ending_window"])
            .with_include_endings(True)
            .run(Duration.from_secs_f32(np.float32(cfg["hash_duration_s"])), True)
        )

    def search(self):
        from needle_tpu_torch.comparator import Comparator
        from needle_tpu_torch.duration import Duration

        cfg = self.cfg
        cmp = (
            Comparator.from_files(self.paths, device=self.device)
            .with_include_endings(True)
            .with_hash_match_threshold(self.threshold)
            .with_min_opening_duration(Duration.from_secs(cfg["min_opening_s"]))
            .with_min_ending_duration(Duration.from_secs(cfg["min_ending_s"]))
            .with_time_padding(Duration.from_nanos(0))
        )
        search_pair_infos = cmp.search_pair_infos

        def keep(frame_hashes, pairs, threading=True):
            infos = search_pair_infos(frame_hashes, pairs, threading)
            self.last = {"fhs": frame_hashes, "pairs": pairs, "infos": infos}
            return infos

        cmp.search_pair_infos = keep
        return cmp.run(analyze=False, display=False, use_skip_files=False,
                       write_skip_files=True)

    def outputs(self, steps):
        """The files the steps write, which a pass removes first so that
        what is there after it is its own."""
        return [output_path(p, s) for s in steps for p in self.paths]

    def run(self, steps) -> dict:
        """Run the steps in order; {"<step>_s": wall} of each, each wall
        ending with the card synchronised."""
        for p in self.outputs(steps):
            p.unlink(missing_ok=True)
        walls = {}
        for step in steps:
            t = time.perf_counter()
            getattr(self, step)()
            self._sync()
            walls[f"{step}_s"] = time.perf_counter() - t
        return walls
