"""The season path end to end: `analyze --include-endings` then `search
--include-endings --write-skip-files`, through the port's CLI on the CPU
and through needle_tpu's CLI on a copy of the same season. Outputs are
compared byte for byte."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from needle_tpu.duration import Duration
from needle_tpu.testing import make_synthetic_season

REPO = Path(__file__).resolve().parent.parent


def _cli(main, season, extra):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["analyze", "--include-endings", *extra, str(season)]) == 0
        assert main(["search", "--include-endings", "--write-skip-files",
                     *extra, str(season)]) == 0
    return out.getvalue().replace(str(season), "<season>")


def test_cli_slice_matches_jax(tmp_path):
    from needle_tpu.cli import main as jax_main
    from needle_tpu_torch.cli import main as torch_main

    ours, ref = tmp_path / "torch", tmp_path / "jax"
    _, op_truth, end_truth = make_synthetic_season(
        ours, num_episodes=3, episode_secs=120, opening_secs=25,
        ending_secs=25, seed=99,
    )
    shutil.copytree(ours, ref)
    out_torch = _cli(torch_main, ours, ["--device", "cpu"])
    out_jax = _cli(jax_main, ref, [])
    assert out_torch == out_jax
    names = sorted(p.name for p in ours.glob("*.needle.*"))
    assert len(names) == 6  # a .needle.dat and a skip file per episode
    for name in names:
        assert (ours / name).read_bytes() == (ref / name).read_bytes(), name
    # and the season was found
    for p, (op_s, op_e), (en_s, en_e) in zip(
        sorted(ours.glob("*.needle.skip.json")), op_truth, end_truth
    ):
        skip = json.loads(p.read_text())
        assert abs(skip["opening"][0] - op_s) < 8 and abs(skip["opening"][1] - op_e) < 8
        assert abs(skip["ending"][0] - en_s) < 8 and abs(skip["ending"][1] - en_e) < 8


_NO_JAX = """
import sys
from needle_tpu.testing import make_synthetic_season
from needle_tpu_torch.cli import main

season = sys.argv[1]
make_synthetic_season(season, num_episodes=2, episode_secs=90,
                      opening_secs=20, seed=5)
assert main(["analyze", "--device", "cpu", season]) == 0
assert main(["search", "--device", "cpu", season]) == 0
print("jax loaded:", "jax" in sys.modules)
"""


def test_port_runs_without_importing_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), NEEDLE_TPU_ALLOW_AUDIO="1")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(tmp_path / "season")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "* Opening - " in proc.stdout
    assert proc.stdout.strip().splitlines()[-1] == "jax loaded: False"


def test_cuda_without_a_card_raises(tmp_path):
    from needle_tpu_torch import Analyzer, Comparator
    from needle_tpu_torch._torch_setup import resolve_device
    from needle_tpu_torch.fingerprint.torch_impl import IngestDispatcher

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        IngestDispatcher(16000, 1, "cuda")
    paths, _, _ = make_synthetic_season(
        tmp_path, num_episodes=2, episode_secs=30, opening_secs=10, seed=1
    )
    with pytest.raises(RuntimeError, match="cuda"):
        Analyzer(paths).run(0.3, persist=False)
    fhs = Analyzer(paths, device="cpu").run(0.3, persist=False)
    with pytest.raises(RuntimeError, match="cuda"):
        Comparator(paths).run_with_frame_hashes(fhs, False, False, False)
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_compressed_media_is_refused(tmp_path):
    from needle_tpu_torch import Analyzer

    p = tmp_path / "ep.mkv"
    p.write_bytes(b"\x1a\x45\xdf\xa3" + bytes(16384))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Analyzer([p], device="cpu").run(0.3, persist=False)


def test_library_api(tmp_path):
    """run_single equals the batched run, and Comparator.run(analyze=True)
    equals searching the Analyzer's hashes."""
    from needle_tpu_torch import Analyzer, Comparator

    paths, _, _ = make_synthetic_season(
        tmp_path, num_episodes=3, episode_secs=60, opening_secs=20,
        opening_offset_range=(2.0, 8.0), seed=21,
    )
    hd = Duration.from_secs_f32(np.float32(0.3))
    batched = Analyzer(paths, device="cpu").run(hd, persist=False)
    for p, b in zip(paths, batched):
        s = Analyzer([p], device="cpu").run_single(p, hd, persist=False)
        np.testing.assert_array_equal(s.opening_hashes, b.opening_hashes)
        np.testing.assert_array_equal(s.opening_ts_nanos, b.opening_ts_nanos)
        assert s.md5() == b.md5()
    cmp = Comparator.from_analyzer(Analyzer(paths, device="cpu"))
    direct = cmp.run_with_frame_hashes(batched, False, False, False)
    in_place = cmp.run(analyze=True, display=False, use_skip_files=False,
                       write_skip_files=False)
    assert [r.opening for r in in_place] == [r.opening for r in direct]
    assert all(r.opening is not None for r in direct)
