"""Season formats found by name: `wav` and `pcm` write and read byte for
byte as before the formats moved into formats/; a format dropped into a
catalog's formats/ runs a whole cell; its SPEC_KEYS reach its writer and
the season's marker; an unknown format stops the run before it writes."""

from __future__ import annotations

import hashlib
import io
import json
import re
import shutil
import subprocess

import numpy as np
import pytest

from needle_bench import formats
from needle_bench.data.season import MARKER, ensure_season
from needle_bench.reference import code_digest, season_reference
from needle_bench.reference.files import needle_dat_bytes
from needle_bench.run import Cell, main, run_cell

from .conftest import HERE, ROOT, SEED

# sha256 of what the season writer and the reference gave for the real
# configurations cut to the catalog's tiny size, taken before the formats
# moved out of data/season.py and reference/files.py
PINNED = {
    "season28": {  # wav
        "files": "6b1bb79a0483c2819be342c616060b2e8a036553e8dbb65016b03c7a592abeb8",
        "marker": "715bc9a425abeb29f082cca27d65fe304dac232d2a8dd280c67f97e91dd426ab",
        "episodes": "8f8ec70aa0f8fe9021581dd63eba196eb2c436b14cbc3c3a167a5aa32c56b64f",
        "entries": "2b49f8d69a42807a88b23a3686d8afa41fd359d04b3449448049a29a31041725",
        "skip": "44d4f160b5f52ee15f97dc49105158e3a9c9a799e8cc8ce5703959c5d0319e69",
    },
    "small3": {  # pcm
        "files": "4402d38d2f14d984f9f41f8208d2331978d0ca438c85f7f4cb7fe9ec7716ff76",
        "marker": "585e79fdfed5f644d27bda2215a62b2cf43220736d6d9836d05cf64d1e2ed74e",
        "episodes": "211e879a50687988ed340f770515f63e39dfbd49321f00574f4de02b411a6782",
        "entries": "7c4c5bced87ed5af76cb57f3ba15982762ae566fa6f58c8b821f4bb40f867a34",
        "skip": "32ded91b6fc2280b9845b3f442ebc3b9d4b571551348ac3cb38cef4dd77ab6ce",
    },
}
# a season in FLAC in Matroska, 48 kHz stereo (the decoded route)
MKV_CFG = {"episodes": 3, "episode_secs": 90.0, "opening_secs": 25.0,
           "opening_offsets": [5.0, 15.0], "ending_secs": 15.0, "rate": 48000,
           "format": "mkv_flac", "codec": "flac", "channels": 2, "min_ending_s": 10}


def _canon(x):
    """x as JSON-able values, floats as their exact hex."""
    if isinstance(x, (float, np.floating)):
        return float(x).hex()
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    return x


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_wav_and_pcm_seasons_and_references_are_as_before(catalog, tmp_path, name):
    cell = Cell(name, catalog / "BENCHMARK.json", catalog)
    season = tmp_path / "season"
    paths, _, _, _ = ensure_season(season, cell.season_spec, SEED, cell.format)
    ref = season_reference(paths, cell.cfg, cell.cfg["threshold"], cell.format,
                           workers=2)
    got = {
        "files": _sha(b"".join(p.name.encode() + b"\0" + p.read_bytes() for p in paths)),
        "marker": _sha((season / MARKER).read_bytes()),
        "episodes": _sha(b"".join(needle_dat_bytes(fh) for fh in ref["episodes"])),
        "entries": _sha(json.dumps(_canon(ref["entries"])).encode()),
        "skip": _sha(json.dumps(_canon(ref["skip"])).encode()),
    }
    assert got == PINNED[name]


def _repo_files():
    """(path, size, mtime) of the files of the checkout a run could touch."""
    out = set()
    for top in ("needle_bench", "native", ".bench_cache"):
        for p in (ROOT / top).rglob("*"):
            if p.is_file() and "__pycache__" not in p.parts:
                st = p.stat()
                out.add((str(p), st.st_size, st.st_mtime_ns))
    return out


@pytest.fixture(scope="module")
def native_lib():
    """The native ingest library, built as the port's own loader builds it
    in a fresh checkout; without FFmpeg's headers it cannot be, and the
    test skips, as the repository's tests of compressed media do."""
    lib = ROOT / "native" / "libneedle_ingest.so"
    if not lib.exists():
        proc = subprocess.run(["make", "-C", str(ROOT / "native")],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            pytest.skip(f"native ingest unavailable: make failed: {proc.stderr[-300:]}")
    return lib


def _catalog_with_mkv(catalog, folder):
    shutil.copytree(catalog, folder)
    shutil.copy(HERE / "tests" / "formats" / "mkv_flac.py", folder / "formats")
    cfg = json.loads((folder / "configs" / "small3-24min.json").read_text())
    cfg.update(MKV_CFG)
    (folder / "configs" / "mkv3.json").write_text(json.dumps(cfg))
    bench = json.loads((folder / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][1], "name": "mkv3",
                             "file": "needle_bench/configs/mkv3.json"})
    bench["workloads"].append({"name": "mkv3", "config": "mkv3", "traffic": "full",
                               "chips": 1, "why": "a format dropped in"})
    (folder / "BENCHMARK.json").write_text(json.dumps(bench))
    return folder


def test_a_format_dropped_in_runs_a_whole_cell(catalog, tmp_path, native_lib):
    """FLAC in Matroska, a new file under formats/ and a new configuration:
    the whole cell runs on the CPU, correct, touching nothing outside its
    temporary folders."""
    folder = _catalog_with_mkv(catalog, tmp_path / "cat")
    cache = tmp_path / "cache"
    before = _repo_files()
    cell = Cell("mkv3", folder / "BENCHMARK.json", folder)
    assert cell.format == folder / "formats" / "mkv_flac.py"
    result = run_cell(cell, SEED, 0.2, False, device="cpu", cache=cache,
                      log=io.StringIO())
    assert result["correct"], result["checks"]
    assert all(v["value"] == 0 for v in result["checks"].values())
    assert result["planted_misses"] == 0
    season = cache / "mkv3" / "season"
    assert sorted(p.name for p in season.glob("ep*.mkv")) == ["ep01.mkv", "ep02.mkv",
                                                              "ep03.mkv"]
    assert (season / "ep01.mkv").read_bytes()[:4] == b"\x1a\x45\xdf\xa3"  # EBML
    held = json.loads((season / MARKER).read_text())["spec"]
    assert (held["codec"], held["channels"]) == ("flac", 2)
    assert _repo_files() == before


def test_spec_keys_reach_the_writer_and_the_marker(catalog, tmp_path):
    """A format's SPEC_KEYS join the season's spec: its writer sees them,
    the marker holds them, and another value writes the season anew."""
    folder = tmp_path / "cat"
    shutil.copytree(catalog, folder)
    (folder / "formats" / "echo.py").write_text(
        "import json\n"
        "EXT = 'echo'\n"
        "SPEC_KEYS = ('gain',)\n"
        "def write(path, pcm, spec):\n"
        "    with open(path, 'wb') as f:\n"
        "        f.write(json.dumps(spec).encode() + b'\\n')\n"
        "        f.write((pcm // spec['gain']).astype('<i2').tobytes())\n"
        "def windows(path, cfg):\n"
        "    raise NotImplementedError\n")
    cfg = json.loads((folder / "configs" / "small3-24min.json").read_text())
    cfg.update(format="echo", gain=3, episode_secs=20.0, opening_secs=5.0,
               ending_secs=5.0, opening_offsets=[1.0, 3.0])
    (folder / "configs" / "echo3.json").write_text(json.dumps(cfg))
    bench = json.loads((folder / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "echo3", "config": "echo3", "traffic": "full",
                               "chips": 1, "why": "a test"})
    (folder / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Cell("echo3", folder / "BENCHMARK.json", folder)
    assert cell.season_spec["gain"] == 3 and list(cell.season_spec)[-1] == "gain"
    season = tmp_path / "season"
    paths, _, _, wrote = ensure_season(season, cell.season_spec, SEED, cell.format)
    assert wrote > 0 and [p.suffix for p in paths] == [".echo"] * 3
    head = paths[0].read_bytes().split(b"\n", 1)[0]
    assert json.loads(head) == cell.season_spec
    assert json.loads((season / MARKER).read_text())["spec"] == cell.season_spec
    assert ensure_season(season, cell.season_spec, SEED, cell.format)[3] == 0.0
    spec = {**cell.season_spec, "gain": 5}
    assert ensure_season(season, spec, SEED, cell.format)[3] > 0
    assert json.loads(paths[0].read_bytes().split(b"\n", 1)[0])["gain"] == 5


def test_an_unknown_format_stops_before_writing(catalog, tmp_path):
    folder = tmp_path / "cat"
    shutil.copytree(catalog, folder)
    cfg = json.loads((folder / "configs" / "small3-24min.json").read_text())
    (folder / "configs" / "small3-24min.json").write_text(
        json.dumps({**cfg, "format": "nosuch"}))
    cache = tmp_path / "cache"
    with pytest.raises(SystemExit, match=re.escape(str(folder / "formats"))):
        main(["--workload", "small3", "--seed", str(SEED), "--seconds", "1"],
             bench=folder / "BENCHMARK.json", folder=folder, cache=cache, device="cpu")
    assert not cache.exists()


def test_the_reference_cache_key_covers_the_format_module(tmp_path):
    wav = formats.find("wav")
    edited = tmp_path / "wav.py"
    edited.write_text(wav.read_text() + "# edited\n")
    assert code_digest(wav) == code_digest(formats.find("wav"))
    assert code_digest(edited) != code_digest(wav)
    assert code_digest(formats.find("pcm")) != code_digest(wav)
