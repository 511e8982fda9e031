"""The reader of the port's split lane copy (counter
`ingest.lane_copy_pool_bytes` over `ingest.lane_bytes`) on hand-made window
records: the split chunks' share of the lanes' valid bytes, and nothing
where the pool's counter is absent, as in a run of a port that copies
every chunk on one thread."""

from __future__ import annotations

import json

import pytest

from .conftest import HERE
from .test_needle_bench_tracing_metrics import OTHERS, PASSES, reader, rec

METRIC = "ingest_lane_copy_pool_pct"


@pytest.mark.parametrize("pooled,lanes,want", [
    (806.4e6 * PASSES, 806.4e6 * PASSES, 100.0),
    (3.0e6, 4.0e6, 75.0),
    (0.0, 4.0e6, 0.0),
    (0.0, 0.0, None),
    (None, 4.0e6, None),
    (None, None, None),
])
def test_pool_pct_is_the_split_chunks_share(pooled, lanes, want):
    spans = dict(OTHERS)
    if pooled is not None:
        spans["ingest.lane_copy_pool_bytes"] = pooled
    if lanes is not None:
        spans["ingest.lane_bytes"] = lanes
    got = reader(METRIC)(rec(spans))
    assert got == (None if want is None else pytest.approx(want))


def test_entry():
    """A per-layer metric of the analyzer's reads in all three cells,
    moving pass_s."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    m = {e["name"]: e for e in bench["per_layer"]}[METRIC]
    assert (m["layer"], m["moves"], m["workloads"], m["source"], m["unit"]) == (
        "analyzer reads", "pass_s", ["season28", "small3", "season28-48k"],
        "program_counter", "%")
    assert m["better"] == "higher"
