"""The readers of the port's staging ring (`ingest.staging_hits`,
`ingest.staging_misses`, span `ingest.staging_wait`) on hand-made window
records: the hits' share and the wait per pass, and nothing where the
names are absent, as in a run of a port without the ring."""

from __future__ import annotations

import json

import pytest

from .conftest import HERE
from .test_needle_bench_tracing_metrics import OTHERS, PASSES, reader, rec


@pytest.mark.parametrize("hits,misses,want", [
    (8.0 * PASSES, None, 100.0),
    (6.0, 2.0, 75.0),
    (None, 3.0, 0.0),
    (0.0, 0.0, None),
])
def test_hit_pct_is_the_hits_share(hits, misses, want):
    spans = dict(OTHERS)
    if hits is not None:
        spans["ingest.staging_hits"] = hits
    if misses is not None:
        spans["ingest.staging_misses"] = misses
    got = reader("ingest_staging_hit_pct")(rec(spans))
    assert got == (None if want is None else pytest.approx(want))


def test_wait_is_its_total_per_pass():
    read = reader("ingest_staging_wait_s")
    assert read(rec({**OTHERS, "ingest.staging_wait": 0.02})) == pytest.approx(
        0.02 / PASSES)
    assert read(rec({**OTHERS, "ingest.staging_wait": 0.0})) == 0.0


@pytest.mark.parametrize("metric", ["ingest_staging_hit_pct", "ingest_staging_wait_s"])
def test_nothing_without_the_ring(metric):
    assert reader(metric)(rec(dict(OTHERS))) is None


@pytest.mark.parametrize("metric", ["ingest_staging_hit_pct", "ingest_staging_wait_s"])
def test_entry(metric):
    """A per-layer metric of both cells, in the fused ingest, moving pass_s."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    m = {e["name"]: e for e in bench["per_layer"]}[metric]
    assert (m["layer"], m["moves"], m["workloads"], m["source"]) == (
        "fused ingest", "pass_s", ["season28", "small3"],
        "program_counter" if metric.endswith("pct") else "program_span")
