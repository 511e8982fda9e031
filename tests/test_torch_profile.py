"""NEEDLE_TPU_PROFILE on the port's CLI: with the variable set, analyze and
search each write one torch.profiler Chrome trace into its directory,
holding the region's label (`tracing.device_profile`, as needle_tpu's CLI
wraps both in its jax.profiler hook); unset, they write nothing and leave
the output unchanged."""

import contextlib
import io
import json
import os

import pytest

from needle_tpu_torch.cli import main
from needle_tpu_torch.testing import make_synthetic_season


@pytest.fixture(scope="module")
def season(tmp_path_factory):
    root = tmp_path_factory.mktemp("season")
    make_synthetic_season(root, num_episodes=2, episode_secs=60.0,
                          opening_secs=12.0, opening_offset_range=(1.0, 4.0),
                          seed=8)
    return root


_SEARCH = ["search", "--min-opening-duration", "5", "--device", "cpu"]


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.mark.parametrize("command,label", [
    (["analyze", "--force", "--device", "cpu"], "needle analyze"),
    (_SEARCH, "needle search"),
])
def test_profile_writes_one_trace_with_the_label(tmp_path, monkeypatch, season,
                                                 command, label):
    plain = _cli([*command, str(season)])
    prof = tmp_path / "prof"
    monkeypatch.setenv("NEEDLE_TPU_PROFILE", str(prof))
    profiled = _cli([*command, str(season)])
    assert profiled == plain
    traces = sorted(prof.iterdir())
    assert [p.name for p in traces] == [
        f"{'_'.join(label.split())}.{os.getpid()}.pt.trace.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == label]
    assert len(spans) == 1 and spans[0]["dur"] > 0
    # the region's own work is inside it: host ops the run launched
    assert sum(e.get("ph") == "X" for e in events) > 1


def test_no_trace_without_the_variable(tmp_path, monkeypatch, season):
    monkeypatch.delenv("NEEDLE_TPU_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    out = _cli([*_SEARCH, str(season)])
    assert "* Opening - \"" in out
    assert list(tmp_path.iterdir()) == []
    assert not list(season.glob("*.json"))
