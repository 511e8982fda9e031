"""The readers of the port's spans and counters of the analyzer's reads,
the fused ingest, the rescan, the search's load and finalize and the
collector, on hand-made window records: each one's value per pass, and
nothing where its name is absent."""

from __future__ import annotations

import importlib.util
import json

import pytest

from .conftest import HERE

PASSES = 4
# metric -> the port's span or counter it reads, per pass over the window
PER_PASS = {
    "analyze_read_wait_s": "analyze.read_wait",
    "ingest_lane_copy_s": "ingest.lane_copy",
    "ingest_lane_copy_faults": "ingest.lane_copy_faults",
    "ingest_kernels_card_s": "ingest.kernels_card_s",
    "rescan_hashes": "ingest.rescan_hashes",
    "search_load_s": "search.load",
    "search_finalize_s": "search.finalize",
    "gc_pause_s": "gc.pause_s",
}


def reader(metric: str):
    spec = importlib.util.spec_from_file_location(
        f"needle_bench.metrics.{metric}", HERE / "metrics" / f"{metric}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def rec(spans: dict) -> dict:
    """A window of PASSES passes whose spans and counters total `spans`."""
    return {"passes": [{"wall_s": 1.0, "analyze_s": 0.9, "search_s": 0.1}] * PASSES,
            "window_s": 4.0, "spans": spans, "launches": 0, "walk": None,
            "profile": None}


# other names a window holds, none of which these readers read
OTHERS = {"analyze.decode": 3.0, "ingest.upload": 0.8, "ingest.batch_assemble": 1.6,
          "search.pairs": 0.2}


@pytest.mark.parametrize("metric,name", sorted(PER_PASS.items()))
def test_reader_gives_its_total_per_pass(metric, name):
    assert reader(metric)(rec({**OTHERS, name: 6.0})) == pytest.approx(6.0 / PASSES)
    assert reader(metric)(rec({**OTHERS, name: 0.0})) == 0.0


@pytest.mark.parametrize("metric", sorted(PER_PASS) + ["ingest_lane_fill"])
def test_reader_gives_nothing_where_its_name_is_absent(metric):
    assert reader(metric)(rec(dict(OTHERS))) is None


def test_lane_fill_is_the_lanes_share_of_the_upload():
    read = reader("ingest_lane_fill")
    spans = {**OTHERS, "ingest.lane_bytes": 806.4e6 * PASSES,
             "ingest.upload_bytes": 974.8e6 * PASSES}
    assert read(rec(spans)) == pytest.approx(100.0 * 806.4 / 974.8)
    assert read(rec({**OTHERS, "ingest.lane_bytes": 1.0})) is None
    assert read(rec({**OTHERS, "ingest.upload_bytes": 1.0})) is None
    assert read(rec({**OTHERS, "ingest.lane_bytes": 0.0, "ingest.upload_bytes": 0.0})) is None


def test_every_reader_has_its_entry():
    """Each reader here is a per-layer metric of both cells that moves
    pass_s, in the layer PERF.md names."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    layers = {"analyze_read_wait_s": "analyzer reads", "ingest_lane_copy_s": "analyzer reads",
              "ingest_lane_copy_faults": "analyzer reads", "ingest_lane_fill": "fused ingest",
              "ingest_kernels_card_s": "fused ingest", "rescan_hashes": "exact rescan",
              "search_load_s": "search engine", "search_finalize_s": "search engine",
              "gc_pause_s": "host"}
    for metric, layer in layers.items():
        m = entries[metric]
        assert (m["layer"], m["moves"], m["workloads"]) == (
            layer, "pass_s", ["season28", "small3"]), metric
        assert (HERE / "metrics" / f"{metric}.py").exists()
