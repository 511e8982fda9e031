"""One short run of a cell on the card, through the benchmark's own
command: `python -m pytest -m cuda needle_bench/tests` on a machine with one."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from .conftest import ROOT


@pytest.mark.cuda
def test_small3_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "needle_bench.run", "--workload", "small3",
         "--seed", "2147483659", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert 0 < result["metrics"]["count_walk_roofline"]["value"] <= 100
    assert result["device"]["busy_s"] > 0
    assert list(result)[-1] == "checks"
