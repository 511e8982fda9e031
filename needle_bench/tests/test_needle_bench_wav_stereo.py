"""The 48 kHz stereo season and the source stage's metrics: the format
`wav_stereo` writes the season's samples as its left channel and a delayed,
scaled copy as its right, drawing nothing from the season's generator; a
tiny cell of it runs `correct` on the CPU; the readers of the port's
counters `ingest.decimate_card_s`, `ingest.source_frames`,
`ingest.lane_bytes` and `ingest.mid_samples` give their numbers, and nothing
where a counter is missing; the entries are where PERF.md says."""

from __future__ import annotations

import importlib.util
import io
import json

import numpy as np
import pytest

from needle_bench import formats
from needle_bench.data.season import ensure_season
from needle_bench.formats.wav import read_samples
from needle_bench.run import Cell, run_cell

from .conftest import HERE, ROOT, SEED
from .test_needle_bench_tracing_metrics import OTHERS, PASSES, reader, rec

CELL = "season28-48k"
CONFIG = "season28-20min-48k-stereo"


@pytest.fixture(scope="module")
def stereo_and_mono(catalog, tmp_path_factory):
    """The catalog's tiny 48 kHz stereo season, and the `wav` format's mono
    season of the same spec and seed."""
    cell = Cell(CELL, catalog / "BENCHMARK.json", catalog)
    root = tmp_path_factory.mktemp("stereo")
    stereo = ensure_season(root / "stereo", cell.season_spec, SEED, cell.format)
    mono_spec = {**cell.season_spec, "format": "wav"}
    del mono_spec["channels"]
    mono = ensure_season(root / "mono", mono_spec, SEED, formats.find("wav"))
    return cell, stereo, mono


def test_left_is_the_seasons_samples_and_right_their_delayed_four_fifths(
        stereo_and_mono):
    cell, (paths, op_truth, en_truth, _), (mono_paths, mono_op, mono_en, _) = \
        stereo_and_mono
    assert cell.season_spec["rate"] == 48000 and cell.season_spec["channels"] == 2
    assert (op_truth, en_truth) == (mono_op, mono_en)
    for p, m in zip(paths, mono_paths):
        samples, rate, channels = read_samples(p)
        want, mono_rate, _ = read_samples(m)
        assert (rate, channels, mono_rate) == (48000, 2, 48000)
        left, right = samples.reshape(-1, 2).T.astype(np.int64)
        np.testing.assert_array_equal(left, want)
        delayed = np.concatenate([np.zeros(12, np.int64), left[:-12]])
        np.testing.assert_array_equal(right, np.floor(delayed * 4 / 5).astype(np.int64))
        assert ((left + right) % 2 != 0).mean() > 0.3


def test_writer_refuses_another_channel_count(tmp_path):
    fmt = formats.load(formats.find("wav_stereo"))
    with pytest.raises(ValueError, match="2 channels"):
        fmt.write(tmp_path / "x.wav", np.zeros(10, np.int16), {"rate": 48000, "channels": 1})


def test_a_48k_stereo_cell_runs_correct_on_the_cpu(catalog, tmp_path):
    cell = Cell(CELL, catalog / "BENCHMARK.json", catalog)
    assert cell.format == catalog / "formats" / "wav_stereo.py"
    result = run_cell(cell, SEED, 0.2, True, device="cpu", cache=tmp_path,
                      log=io.StringIO())
    assert result["correct"], result["checks"]
    assert all(v["value"] == 0 for v in result["checks"].values())
    assert result["planted_misses"] == 0
    # the card's counter is not recorded on the CPU, so neither metric reads
    assert "ingest_decimate_card_s" not in result["metrics"]
    assert "ingest_decimate_roofline" not in result["metrics"]


# per pass: season28's valid lengths (its ingest.lane_bytes) and this
# configuration's, 6x the bytes and 1.5x the mid-rate samples
SEASON28 = {"ingest.source_frames": 403.2e6, "ingest.lane_bytes": 806.4e6,
            "ingest.mid_samples": 201.6e6}
STEREO48 = {"ingest.source_frames": 1209.6e6, "ingest.lane_bytes": 4838.4e6,
            "ingest.mid_samples": 302.4e6}


def _window(per_pass, card_s=None):
    spans = {**OTHERS, **{k: v * PASSES for k, v in per_pass.items()}}
    if card_s is not None:
        spans["ingest.decimate_card_s"] = card_s * PASSES
    return rec(spans)


def test_decimate_card_s_is_its_total_per_pass():
    read = reader("ingest_decimate_card_s")
    assert read(_window(SEASON28, 0.05)) == pytest.approx(0.05)
    assert read(_window(SEASON28)) is None


@pytest.mark.parametrize("per_pass,ops,moved", [
    # /2 mono: 53 taps a mid sample, 2 operations a multiply-add
    (SEASON28, 2 * 53 * 201.6e6, 806.4e6 + 2 * 201.6e6),
    # /4 stereo: 7 taps on twice the mid samples, then 53, both channels,
    # and one add a downmixed frame
    (STEREO48, 2 * 2 * (7 * 2 + 53) * 302.4e6 + 302.4e6, 4838.4e6 + 2 * 302.4e6),
])
def test_roofline_counts_the_stages_work(per_pass, ops, moved):
    read = reader("ingest_decimate_roofline")
    card_s = 0.05
    bound = max(ops / 33.5e12, moved / 3.35e12)
    assert read(_window(per_pass, card_s)) == pytest.approx(100.0 * bound / card_s)


@pytest.mark.parametrize("drop", ["ingest.decimate_card_s", "ingest.source_frames",
                                  "ingest.lane_bytes", "ingest.mid_samples"])
def test_roofline_reads_nothing_without_a_counter(drop):
    spans = dict(_window(STEREO48, 0.05)["spans"])
    del spans[drop]
    assert reader("ingest_decimate_roofline")(rec(spans)) is None


def test_the_frozen_taps_are_the_ports_designs():
    from needle_tpu_torch.fingerprint.decimate import _HB_MAIN, _HB_RELAXED, _halfband_q14

    spec = importlib.util.spec_from_file_location(
        "roofline_of_the_stage", HERE / "metrics" / "ingest_decimate_roofline.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)

    def taps(design):
        odd, centre = _halfband_q14(*design)
        return 2 * int(np.count_nonzero(odd)) + int(centre != 0)

    assert module.STAGE_TAPS == {1: (), 2: (taps(_HB_MAIN),),
                                 4: (taps(_HB_RELAXED), taps(_HB_MAIN))}


@pytest.mark.parametrize("metric", ["ingest_decimate_card_s", "ingest_decimate_roofline"])
def test_entry(metric):
    """A per-layer metric of all three cells, in the fused ingest, moving
    pass_s; the configuration and the cell beside it."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {e["name"]: e for e in bench["per_layer"]}[metric]
    assert (m["layer"], m["moves"], m["workloads"]) == (
        "fused ingest", "pass_s", ["season28", "small3", CELL])
    assert (m["source"], m["unit"]) == (
        ("device_trace", "%") if metric.endswith("roofline") else ("program_counter", "s"))
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "full", 1)
    cfg = {c["name"]: c for c in bench["configs"]}[CONFIG]
    assert cfg["reduced"] == [] and cfg["file"] == f"needle_bench/configs/{CONFIG}.json"


def test_the_configuration_is_season28_as_48k_stereo():
    base = json.loads((HERE / "configs" / "season28-20min.json").read_text())
    cfg = json.loads((HERE / "configs" / f"{CONFIG}.json").read_text())
    changed = {k for k in cfg if base.get(k) != cfg[k]}
    assert set(base) <= set(cfg)
    assert changed == {"rate", "format", "channels", "source", "assumed"}
    assert (cfg["rate"], cfg["format"], cfg["channels"]) == (48000, "wav_stereo", 2)
    assert (cfg["episodes"], cfg["episode_secs"], cfg["reduced"]) == (28, 1200.0, [])
