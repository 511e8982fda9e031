"""The readers of the exact rescan's fetch of the card's mid-rate windows
(span `ingest.rescan_fetch`, counter `ingest.rescan_window_bytes`) on
hand-made window records: each one's total per pass, and nothing where its
name is absent, as in a run of a port whose rescan prepares its windows on
the host."""

from __future__ import annotations

import json

import pytest

from .conftest import HERE
from .test_needle_bench_tracing_metrics import OTHERS, PASSES, reader, rec

NAMES = {"rescan_fetch_s": "ingest.rescan_fetch",
         "rescan_window_bytes": "ingest.rescan_window_bytes"}


@pytest.mark.parametrize("metric,name", sorted(NAMES.items()))
def test_reader_gives_its_total_per_pass(metric, name):
    read = reader(metric)
    assert read(rec({**OTHERS, name: 6.0e6})) == pytest.approx(6.0e6 / PASSES)
    assert read(rec({**OTHERS, name: 0.0})) == 0.0


@pytest.mark.parametrize("metric", sorted(NAMES))
def test_nothing_without_the_fetch(metric):
    spans = {**OTHERS, "ingest.rescan": 2.0, "ingest.rescan_hashes": 800.0}
    assert reader(metric)(rec(spans)) is None


@pytest.mark.parametrize("metric", sorted(NAMES))
def test_entry(metric):
    """A per-layer metric of the exact rescan in all three cells, moving
    pass_s."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    m = {e["name"]: e for e in bench["per_layer"]}[metric]
    assert (m["layer"], m["moves"], m["workloads"], m["source"]) == (
        "exact rescan", "pass_s", ["season28", "small3", "season28-48k"],
        "program_span" if metric.endswith("_s") else "program_counter")
    assert (HERE / "metrics" / f"{metric}.py").exists()
