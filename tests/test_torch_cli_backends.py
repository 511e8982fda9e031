"""needle_tpu's host backends and oracle engine through the port's CLI:
`analyze --backend numpy|chromaprint` and `search --engine numpy`, run by
the port's CLI with `--device cpu` and by needle_tpu's CLI on copies of
one 2-episode, 60 s season. Exit codes, stdout, `.needle.dat` and skip
files must be equal byte for byte; `jax` is refused with exit code 2."""

import contextlib
import io
import shutil

import pytest

from needle_tpu.cli import main as jax_main
from needle_tpu_torch.cli import main as torch_main
from needle_tpu_torch.fingerprint import oracle as t_oracle
from needle_tpu_torch.testing import make_synthetic_season


@pytest.fixture(scope="module")
def base_season(tmp_path_factory):
    root = tmp_path_factory.mktemp("base")
    make_synthetic_season(root, num_episodes=2, episode_secs=60.0,
                          opening_secs=12.0, opening_offset_range=(1.0, 4.0),
                          ending_secs=8.0, seed=31)
    return root


def _both(tmp_path, base, steps):
    """Run each argv of `steps` through both CLIs, each on its own copy of
    the season. Returns {package: (exit codes, stdout, {file: bytes})}."""
    outs = {}
    for name, main, extra in (("torch", torch_main, ["--device", "cpu"]),
                              ("jax", jax_main, [])):
        season = tmp_path / name
        shutil.copytree(base, season)
        buf, codes = io.StringIO(), []
        with contextlib.redirect_stdout(buf):
            for argv in steps:
                codes.append(main([*argv, *extra, str(season)]))
        files = {p.name: p.read_bytes() for p in sorted(season.glob("*.needle*"))}
        outs[name] = (codes, buf.getvalue().replace(str(season), "<season>"),
                      files)
    return outs


_NUMPY = ["analyze", "--backend", "numpy", "--include-endings"]


@pytest.mark.parametrize("flags", [[], ["--no-threading"]])
def test_analyze_backend_numpy(tmp_path, base_season, flags):
    outs = _both(tmp_path, base_season, [[*_NUMPY, *flags]])
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == [0]
    assert sorted(outs["torch"][2]) == ["ep01.needle.dat", "ep02.needle.dat"]


def test_analyze_backend_chromaprint_force(tmp_path, base_season, monkeypatch):
    if not t_oracle.available():
        pytest.skip("libchromaprint not installed")
    calls = []
    real = t_oracle.fingerprint_oracle

    def spy(pcm, channels=1):
        calls.append(channels)
        return real(pcm, channels)

    monkeypatch.setattr(t_oracle, "fingerprint_oracle", spy)
    steps = [_NUMPY, ["analyze", "--backend", "chromaprint", "--include-endings",
                      "--force"]]
    outs = _both(tmp_path, base_season, steps)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == [0, 0]
    # --force analyzed again, through the library: stereo opening and
    # ending windows of both episodes
    assert "Skipping" not in outs["torch"][1]
    assert calls == [2, 2, 2, 2]


@pytest.mark.parametrize("flags", [
    ["--include-endings", "--write-skip-files", "--min-opening-duration", "5",
     "--min-ending-duration", "5"],
    ["--hash-match-threshold", "6", "--min-opening-duration", "5",
     "--no-threading"],
])
def test_search_engine_numpy(tmp_path, base_season, flags):
    steps = [_NUMPY, ["search", "--engine", "numpy", *flags]]
    outs = _both(tmp_path, base_season, steps)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == [0, 0]
    assert "* Opening - \"" in outs["torch"][1]
    skips = [n for n in outs["torch"][2] if n.endswith(".skip.json")]
    assert len(skips) == (2 if "--write-skip-files" in flags else 0)


@pytest.mark.parametrize("argv,option", [
    (["analyze", "--backend", "jax"], "--backend jax"),
    (["search", "--engine", "jax"], "--engine jax"),
])
def test_jax_is_refused(tmp_path, base_season, capsys, argv, option):
    with pytest.raises(SystemExit) as exit_info:
        torch_main([*argv, "--device", "cpu", str(base_season)])
    assert exit_info.value.code == 2
    assert option in capsys.readouterr().err
    assert not list(base_season.glob("*.needle*"))


def test_library_backends(tmp_path, base_season, monkeypatch):
    """The Analyzer and Comparator behind the options: run_single equals
    run on a host backend, "jax" and unknown names are refused, a missing
    libchromaprint raises instead of falling back to numpy, and engine
    "auto" is the torch engine."""
    from needle_tpu_torch import Analyzer, Comparator
    from needle_tpu_torch.search.torch_impl import TorchSearchEngine

    paths = sorted(base_season.glob("*.wav"))
    analyzer = Analyzer(paths, device="cpu", backend="numpy").with_include_endings(True)
    batched = analyzer.run(0.3, persist=False)
    for p, b in zip(paths, batched):
        s = analyzer.run_single(p, b.hash_duration(), persist=False)
        assert s.to_bytes() == b.to_bytes()
    for name in ("jax", "tpu"):
        with pytest.raises(ValueError):
            Analyzer(paths, backend=name)
    monkeypatch.setattr(t_oracle, "load_library", lambda: None)
    with pytest.raises(RuntimeError, match="libchromaprint"):
        Analyzer(paths, device="cpu", backend="chromaprint").run(0.3, persist=False)
    assert isinstance(Comparator(paths, device="cpu", engine="auto")._engine(),
                      TorchSearchEngine)
    cmp = Comparator.from_analyzer(Analyzer(paths, device="cpu"))
    assert cmp.device == "cpu" and isinstance(cmp._engine(), TorchSearchEngine)
    with pytest.raises(ValueError):
        Comparator(paths, engine="jax")
    assert not any(p.with_suffix(".needle.dat").exists() for p in paths)
