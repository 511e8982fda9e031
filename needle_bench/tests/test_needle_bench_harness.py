"""The harness on the CPU at a tiny season: each mix's passes and the
checks, the checks against broken programs, the CLI without a card, the
season writer against the port's, and files found by name."""

from __future__ import annotations

import dataclasses
import filecmp
import io
import json
import subprocess
import sys
import types

import numpy as np
import pytest

from needle_bench import formats
from needle_bench import run as bench_run
from needle_bench.data.season import MARKER, ensure_season, write_season
from needle_bench.run import Cell, run_cell

from .conftest import ROOT, SEED, TINY

CELLS = ("season28", "small3", "season28-search")


def _run(catalog, cache, name, trace=False, seconds=0.5, **kw):
    cell = Cell(name, catalog / "BENCHMARK.json", catalog)
    return run_cell(cell, SEED, seconds, trace, device="cpu", cache=cache,
                    log=io.StringIO(), **kw)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", (False, True))
def test_cell_runs_and_checks_on_the_cpu(catalog, cache, name, trace):
    result = _run(catalog, cache, name, trace)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    cell = Cell(name, catalog / "BENCHMARK.json", catalog)
    want = cell.per_layer if trace else cell.end_to_end
    got = result["metrics"]
    assert set(got) <= {m["name"] for m in want}
    if not trace:
        assert set(got) == {m["name"] for m in want}
        assert all(v["value"] > 0 for v in got.values())
    else:  # the host clocks and spans read on the CPU too; device numbers do not
        assert "search_s" in got and "device_idle_pct" not in got
        assert "count_walk_roofline" not in got


def _broken(catalog, cache, monkeypatch, name, patch):
    patch(monkeypatch)
    return _run(catalog, cache, name)


def _threshold_plus_one(catalog, cache, name):
    cell = Cell(name, catalog / "BENCHMARK.json", catalog)
    return _run(catalog, cache, name, threshold=cell.cfg["threshold"] + 1)


def test_control_threshold_plus_one_is_not_correct(catalog, cache):
    """The control: the program's search at the match threshold + 1. Its
    answers still find every planted opening and ending."""
    for name in CELLS:
        result = _threshold_plus_one(catalog, cache, name)
        checks = {k: v["value"] for k, v in result["checks"].items()}
        assert not result["correct"] and checks["pairs_wrong"] > 0, checks
        assert result["planted_misses"] == 0


def _no_analyze(mp):
    from needle_tpu_torch.analyzer import Analyzer

    mp.setattr(Analyzer, "run", lambda self, *a, **k: [])


def _no_search(mp):
    from needle_tpu_torch.comparator import Comparator

    mp.setattr(Comparator, "run", lambda self, *a, **k: [])


def _half_the_pairs(mp):
    from needle_tpu_torch.comparator import Comparator

    real = Comparator.search_pair_infos

    def half(self, frame_hashes, pairs, threading=True):
        keep = pairs[: len(pairs) // 2 + len(pairs) % 2]
        return real(self, frame_hashes, keep, threading)

    mp.setattr(Comparator, "search_pair_infos", half)


def _flipped_hash_bit(mp):
    from needle_tpu_torch.data import FrameHashes

    real = FrameHashes.save

    def save(self, path):
        if path.name.startswith("ep01"):
            self.opening_hashes = self.opening_hashes.copy()
            self.opening_hashes[7] ^= np.uint32(1 << 5)
        real(self, path)

    mp.setattr(FrameHashes, "save", save)


def _altered_entry(mp):
    from needle_tpu_torch.comparator import Comparator

    real = Comparator.search_pair_infos

    def altered(self, frame_hashes, pairs, threading=True):
        infos = real(self, frame_hashes, pairs, threading)
        info = next(i for i in infos if i.src_openings)
        entry = info.src_openings[0]
        info.src_openings = list(info.src_openings)
        info.dst_openings = list(info.dst_openings)
        info.src_openings[0] = info.dst_openings[0] = dataclasses.replace(
            entry, src_match_hash=entry.src_match_hash ^ 1)
        return infos

    mp.setattr(Comparator, "search_pair_infos", altered)


@pytest.mark.parametrize("name,patch,caught", [
    ("season28", _no_analyze, "dat_files_wrong"),       # a step that changes nothing
    ("season28-search", _no_search, "skip_files_wrong"),
    ("season28", _half_the_pairs, "pairs_wrong"),       # half of the batch left out
    ("season28-search", _half_the_pairs, "pairs_wrong"),
    ("season28", _flipped_hash_bit, "hashes_wrong"),    # an answer altered where made
    ("small3", _flipped_hash_bit, "hashes_wrong"),
    ("season28-search", _altered_entry, "pairs_wrong"),
])
def test_a_broken_program_is_not_correct(catalog, cache, monkeypatch, name, patch, caught):
    try:
        result = _broken(catalog, cache, monkeypatch, name, patch)
    except Exception as e:  # noqa: BLE001 - a crash is a run with no result
        if caught != "dat_files_wrong":
            raise
        assert "needle.dat" in str(e)  # the search found no analysis to read
        return
    assert not result["correct"]
    assert result["checks"][caught]["value"] > result["checks"][caught]["limit"]


def test_a_flipped_hash_bit_is_caught_though_accuracy_holds(catalog, cache, monkeypatch):
    result = _broken(catalog, cache, monkeypatch, "season28", _flipped_hash_bit)
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert checks["hashes_wrong"] == 1 and checks["dat_files_wrong"] == 1
    assert result["planted_misses"] == 0


def test_cli_without_a_card_exits_nonzero_with_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "-m", "needle_bench.run", "--workload", "small3",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_cli_in_a_checkout_of_the_benchmark_alone_exits_nonzero(tmp_path):
    import shutil

    shutil.copytree(ROOT / "needle_bench", tmp_path / "needle_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "needle_bench.run", "--workload", "small3",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_modules_compared_by_whole_name(monkeypatch):
    fake = types.SimpleNamespace(modules=dict.fromkeys(
        ["numpy", "jaxtyping_like", "benchmarks_x", "needle_tpu_torch.search",
         "needle_tpu_torch.benchmark"]))
    monkeypatch.setattr(bench_run, "sys", fake)
    assert bench_run._forbidden_loaded() == []
    fake.modules.update(dict.fromkeys(["jax.numpy", "needle_tpu", "bench",
                                       "needle_tpu_torch.testing",
                                       "needle_tpu_torch.bench.run"]))
    assert bench_run._forbidden_loaded() == [
        "bench", "jax.numpy", "needle_tpu", "needle_tpu_torch.bench.run",
        "needle_tpu_torch.testing"]


def _main(folder, cache, workload="small3", trace=1):
    """The command's main() on the CPU in a fresh process, on a catalog."""
    code = (
        "import sys\n"
        "from needle_bench.run import main\n"
        "if __name__ == '__main__':\n"
        f"    sys.exit(main(['--workload', {workload!r}, '--seed', '{SEED}', "
        f"'--seconds', '0.2', '--trace', '{trace}'], bench={str(folder / 'BENCHMARK.json')!r}, "
        f"folder={str(folder)!r}, cache={str(cache)!r}, device='cpu'))\n")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)


def test_a_run_loads_nothing_forbidden(catalog, cache):
    """A whole run in a fresh process, the reference and the readers
    included, leaves no forbidden module loaded, and prints its result."""
    proc = _main(catalog, cache)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result["correct"] and list(result)[-1] == "checks"


def test_a_reader_that_loads_jax_withholds_the_result(catalog, cache, tmp_path):
    """A metric reader dropped in that imports jax runs after the window
    and after the reference: the run still exits nonzero with no result."""
    import shutil

    folder = tmp_path / "cat"
    shutil.copytree(catalog, folder)
    (folder / "metrics" / "jax_reader.py").write_text(
        "def read(rec):\n    import jax  # noqa: F401\n    return 1.0\n")
    bench = json.loads((folder / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "jax_reader", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "harness",
                               "moves": "pass_s", "workloads": ["small3"]})
    (folder / "BENCHMARK.json").write_text(json.dumps(bench))
    proc = _main(folder, cache)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "'jax'" in proc.stderr


@pytest.mark.parametrize("fmt", ("wav", "pcm"))
def test_season_writer_equals_the_ports(tmp_path, fmt):
    from needle_tpu_torch.bench.run import Season, build_small3
    from needle_tpu_torch.testing import make_synthetic_season

    spec = {**TINY, "opening_offsets": [5.0, 15.0], "rate": 16000, "format": fmt}
    ours, op, en = write_season(tmp_path / "ours", spec, SEED, formats.find(fmt), workers=2)
    if fmt == "wav":
        theirs, op2, en2 = make_synthetic_season(
            tmp_path / "theirs", num_episodes=3, episode_secs=150.0, opening_secs=25.0,
            opening_offset_range=(5.0, 15.0), ending_secs=30.0, rate=16000, seed=SEED)
    else:
        theirs, op2, en2 = build_small3(
            Season(episodes=3, episode_secs=150.0, opening_secs=25.0, ending_secs=30.0,
                   offset_range=(5.0, 15.0)), SEED, tmp_path / "theirs")
    assert [p.name for p in ours] == [p.name for p in theirs]
    assert all(filecmp.cmp(a, b, shallow=False) for a, b in zip(ours, theirs))
    assert [list(t) for t in op] == [list(t) for t in op2]
    assert [list(t) for t in en] == [list(t) for t in en2]


def test_each_seed_writes_its_own_season(tmp_path):
    spec = {**TINY, "episode_secs": 20.0, "opening_secs": 5.0, "ending_secs": 5.0,
            "episodes": 3, "opening_offsets": [1.0, 3.0], "rate": 8000, "format": "pcm"}
    d, pcm = tmp_path / "season", formats.find("pcm")
    a, op_a, _, wrote = ensure_season(d, spec, SEED, pcm)
    bytes_a = [p.read_bytes() for p in a]
    assert wrote > 0 and sorted(q.name for q in d.iterdir()) == sorted(
        [MARKER, "ep01.pcm", "ep02.pcm", "ep03.pcm"])
    (d / "ep01.needle.dat").write_bytes(b"old")
    (d / "reference.pkl").write_bytes(b"kept")
    again, op_again, _, wrote = ensure_season(d, spec, SEED, pcm)  # kept, outputs removed
    assert wrote == 0.0 and op_again == op_a
    assert not (d / "ep01.needle.dat").exists() and (d / "reference.pkl").exists()
    b, op_b, _, wrote = ensure_season(d, spec, SEED + 1, pcm)  # another seed, other audio
    assert wrote > 0 and not (d / "reference.pkl").exists()
    assert [p.name for p in b] == [p.name for p in a]
    assert all(p.stat().st_size == len(x) for p, x in zip(b, bytes_a))
    assert all(p.read_bytes() != x for p, x in zip(b, bytes_a)) and op_b != op_a


def test_the_reference_cache_holds_for_its_season_and_code(tmp_path, monkeypatch):
    import needle_bench.reference as reference

    spec = {**TINY, "episode_secs": 20.0, "opening_secs": 5.0, "ending_secs": 5.0,
            "episodes": 3, "opening_offsets": [1.0, 3.0], "rate": 16000, "format": "pcm"}
    cfg = {**json.loads((ROOT / "needle_bench/configs/small3-24min.json").read_text()),
           **spec}
    pcm = formats.find("pcm")
    paths, _, _, _ = ensure_season(tmp_path / "s", spec, SEED, pcm)
    cache = tmp_path / "s" / "reference.pkl"
    first = reference.season_reference(paths, cfg, 10, pcm, cache, workers=1)
    monkeypatch.setattr(reference, "pair_entries", None)  # a second count would raise
    assert reference.season_reference(paths, cfg, 10, pcm, cache)["entries"] == first["entries"]
    monkeypatch.setattr(reference, "code_digest", lambda fmt: "another reference")
    with pytest.raises(TypeError):
        reference.season_reference(paths, cfg, 10, pcm, cache, workers=1)


def test_files_dropped_in_are_found_by_name(catalog, cache, tmp_path):
    import shutil

    folder = tmp_path / "cat"
    shutil.copytree(catalog, folder)
    cfg = json.loads((folder / "configs" / "small3-24min.json").read_text())
    cfg["episodes"] = 2
    (folder / "configs" / "pair2.json").write_text(json.dumps(cfg))
    (folder / "traffic" / "twice.json").write_text(
        json.dumps({"setup": [], "pass": ["analyze", "search", "search"]}))
    (folder / "metrics" / "passes_per_window.py").write_text(
        "def read(rec):\n    return len(rec['passes'])\n")
    bench = json.loads((folder / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][1], "name": "pair2"})
    bench["workloads"].append({"name": "pair2.twice", "config": "pair2",
                               "traffic": "twice", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "passes_per_window", "unit": "passes",
                               "better": "higher", "source": "host_clock",
                               "layer": "harness", "moves": "pass_s",
                               "workloads": ["pair2.twice"]})
    (folder / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Cell("pair2.twice", folder / "BENCHMARK.json", folder)
    assert cell.mix["pass"] == ["analyze", "search", "search"]
    result = run_cell(cell, SEED, 0.2, True, device="cpu", cache=cache,
                      log=io.StringIO())
    assert result["correct"], result["checks"]
    assert list(result["metrics"]) == ["passes_per_window"]
    assert result["metrics"]["passes_per_window"]["value"] >= 1
