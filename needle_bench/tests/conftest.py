"""A catalog of tiny cells for the benchmark's CPU tests: the real traffic
mixes, season formats and metric readers, the real configurations cut to
3 x 150 s."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
TINY = {"episodes": 3, "episode_secs": 150.0, "opening_secs": 25.0, "ending_secs": 30.0}
SEED = 2**31 + 1234
# the `search` mix, which no cell of BENCHMARK.json runs yet, in a cell of
# the tests' own, with the per-layer metrics that read a search
SEARCH_CELL = {"name": "season28-search", "config": "season28-20min", "traffic": "search",
               "chips": 1, "why": "the search mix"}
SEARCH_METRICS = ("search_s", "search_entries_s", "count_walk_roofline",
                  "count_walk_launches", "device_idle_pct")


@pytest.fixture(scope="session")
def catalog(tmp_path_factory) -> Path:
    """A copy of needle_bench's folders with the configurations cut to
    TINY, and a BENCHMARK.json of the real cells and SEARCH_CELL."""
    folder = tmp_path_factory.mktemp("catalog")
    for sub in ("traffic", "formats", "metrics"):
        shutil.copytree(HERE / sub, folder / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (folder / "configs").mkdir()
    for cfg in (HERE / "configs").glob("*.json"):
        spec = json.loads(cfg.read_text())
        spec.update(TINY)
        (folder / "configs" / cfg.name).write_text(json.dumps(spec))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(SEARCH_CELL)
    for m in bench["per_layer"]:
        if m["name"] in SEARCH_METRICS:
            m["workloads"].append(SEARCH_CELL["name"])
    (folder / "BENCHMARK.json").write_text(json.dumps(bench))
    return folder


@pytest.fixture(scope="session")
def cache(tmp_path_factory) -> Path:
    return tmp_path_factory.mktemp("cache")
