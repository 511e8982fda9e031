"""The C API of capi/needle_tpu.h served by needle_tpu_torch.

The port's library (needle_tpu_torch.capi.build) and the unedited example
programs of capi/examples, compiled against it, are driven as a C consumer
drives them, on the CPU (NEEDLE_TPU_TORCH_DEVICE=cpu): `full` on a 3 x 100 s
season writes the `.needle.dat` and skip files that needle_tpu's CLI writes
on a copy of it, byte for byte, and it runs with needle_tpu and jax refused
by the embedded interpreter's import system. The constructors keep
needle_tpu's argument checks and error codes, refuse an unknown device,
and without a card the default device makes the run functions fail
instead of running on the CPU. needle_tpu's own library is not built here.
"""

import ctypes
import os
import shutil
import subprocess

import pytest

from needle_tpu.cli import main as jax_main
from needle_tpu_torch.testing import make_synthetic_season

EXAMPLES = ("analyzer", "comparator", "full")
# NeedleError codes (capi/needle_tpu.h)
NULL_ARGUMENT, INVALID_ARGUMENT, COMPARATOR_MINIMUM_PATHS = 2, 3, 7


@pytest.fixture(scope="module")
def capi_lib():
    if not all(shutil.which(t) for t in ("g++", "make", "python3-config")):
        pytest.skip("native toolchain unavailable")
    from needle_tpu_torch import capi

    return capi.build()


@pytest.fixture(scope="module")
def programs(capi_lib, tmp_path_factory):
    from needle_tpu_torch import capi

    out = tmp_path_factory.mktemp("capi_examples")
    return {name: capi.build_example(name, out) for name in EXAMPLES}


@pytest.fixture(scope="module")
def base_season(tmp_path_factory):
    root = tmp_path_factory.mktemp("capi_season")
    make_synthetic_season(root, num_episodes=3, episode_secs=100,
                          opening_secs=25, seed=4242)
    return root


def _env(device="cpu", **extra):
    """The programs' environment: NEEDLE_TPU_TORCH_DEVICE set to `device`
    (unset for None); no PYTHONPATH or NEEDLE_TPU_PYTHON_ROOT, so the
    library finds the package from its own path."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "NEEDLE_TPU_PYTHON_ROOT",
                        "NEEDLE_TPU_TORCH_DEVICE")}
    env["NEEDLE_TPU_ALLOW_AUDIO"] = "1"
    if device is not None:
        env["NEEDLE_TPU_TORCH_DEVICE"] = device
    env.update(extra)
    return env


def _run(program, *args, env):
    return subprocess.run([str(program), *map(str, args)], capture_output=True,
                          text=True, env=env, timeout=300)


def _outputs(season):
    return {p.name: p.read_bytes() for p in sorted(season.glob("*.needle*"))}


def test_full_equals_needle_tpu_cli(programs, base_season, tmp_path, capsys):
    """`full` (analyze with hash duration 0.3 s, then search with the
    default settings, writing skip files) == needle_tpu's CLI `analyze`
    then `search --write-skip-files`: stdout's results and every output
    file's bytes. The CLI sorts the videos it finds and a C program keeps
    the order it passes (a result's tie-break follows the order), so
    `full` is given the files in sorted order."""
    ours, theirs = tmp_path / "capi", tmp_path / "cli"
    shutil.copytree(base_season, ours)
    shutil.copytree(base_season, theirs)
    r = _run(programs["full"], *sorted(ours.glob("*.wav")), env=_env())
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "found 3 videos" in r.stdout
    assert "* Opening - " in r.stdout
    assert len(list(ours.glob("*.needle.dat"))) == 3
    assert len(list(ours.glob("*.needle.skip.json"))) == 3

    assert jax_main(["analyze", str(theirs)]) == 0
    assert jax_main(["search", "--write-skip-files", str(theirs)]) == 0
    cli_out = capsys.readouterr().out
    assert _outputs(ours) == _outputs(theirs)

    def results(out, season):
        return sorted(line.replace(str(season), "<season>")
                      for line in out.splitlines()
                      if line.startswith(("* ", str(season))))

    assert results(r.stdout, ours) == results(cli_out, theirs)


def test_full_runs_with_needle_tpu_and_jax_refused(programs, base_season,
                                                   tmp_path):
    """The embedded interpreter loads a sitecustomize whose import system
    refuses jax, jaxlib, needle_tpu and needle_tpu.*, and logs every
    refusal: `full` succeeds and nothing was refused."""
    site = tmp_path / "site"
    site.mkdir()
    log = tmp_path / "refused.log"
    (site / "sitecustomize.py").write_text(f'''
import importlib.abc
import sys

FORBIDDEN = ("jax", "jaxlib", "needle_tpu")


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            with open({str(log)!r}, "a") as f:
                f.write(name + "\\n")
            raise ImportError(f"blocked: {{name}}")
        return None


sys.meta_path.insert(0, Blocker())
with open({str(tmp_path / "site_ran")!r}, "w") as f:
    f.write("ok")
''')
    season = tmp_path / "season"
    shutil.copytree(base_season, season)
    r = _run(programs["full"], season, env=_env(PYTHONPATH=str(site)))
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert (tmp_path / "site_ran").exists()
    assert not log.exists(), log.read_text()
    assert "found 3 videos" in r.stdout and "* Opening - " in r.stdout


def test_default_device_without_a_card_fails(programs, base_season, tmp_path):
    """NEEDLE_TPU_TORCH_DEVICE unset means cuda: with no card,
    needle_audio_analyzer_run and needle_audio_comparator_run return an
    error code and write nothing, instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    season = tmp_path / "season"
    shutil.copytree(base_season, season)
    wavs = sorted(season.glob("*.wav"))
    r = _run(programs["analyzer"], *wavs, env=_env(None))
    assert r.returncode == 1
    assert "failed to run analyzer: unknown error" in r.stderr
    assert not list(season.glob("*.needle*"))
    # hashes from the CPU, then the comparator on the default device
    assert _run(programs["analyzer"], *wavs, env=_env()).returncode == 0
    r = _run(programs["comparator"], *wavs, env=_env(None))
    assert r.returncode == 1
    assert "failed to run comparator: unknown error" in r.stderr
    assert not list(season.glob("*.needle.skip.json"))


def test_error_paths(capi_lib, monkeypatch):
    """needle_tpu's argument checks and error codes (tests/test_capi.py),
    and an unknown NEEDLE_TPU_TORCH_DEVICE refused by both constructors;
    none of these calls starts the interpreter."""
    lib = ctypes.CDLL(str(capi_lib))
    lib.needle_error_to_str.argtypes = [ctypes.c_int]
    lib.needle_error_to_str.restype = ctypes.c_char_p
    P = ctypes.c_void_p
    lib.needle_audio_analyzer_new_default.argtypes = [P, ctypes.c_size_t, P]
    lib.needle_audio_analyzer_new_default.restype = ctypes.c_int
    lib.needle_audio_comparator_new_default.argtypes = [P, ctypes.c_size_t, P]
    lib.needle_audio_comparator_new_default.restype = ctypes.c_int
    lib.needle_audio_comparator_new.argtypes = [
        P, ctypes.c_size_t, ctypes.c_bool, ctypes.c_uint16, ctypes.c_uint16,
        ctypes.c_uint16, ctypes.c_float, P]
    lib.needle_audio_comparator_new.restype = ctypes.c_int

    strings = [lib.needle_error_to_str(code) for code in range(12)]
    assert all(strings) and len(set(strings)) == 12
    assert lib.needle_error_to_str(0) == b"no error"

    out = ctypes.c_void_p()
    assert lib.needle_audio_analyzer_new_default(None, 0, None) == NULL_ARGUMENT
    one = (ctypes.c_char_p * 1)(b"/tmp/a.mkv")
    assert lib.needle_audio_comparator_new_default(
        one, 1, ctypes.byref(out)) == COMPARATOR_MINIMUM_PATHS
    two = (ctypes.c_char_p * 2)(b"/tmp/a.mkv", b"/tmp/b.mkv")
    assert lib.needle_audio_comparator_new(
        two, 2, False, 33, 20, 20, 0.0, ctypes.byref(out)) == INVALID_ARGUMENT

    monkeypatch.setenv("NEEDLE_TPU_TORCH_DEVICE", "tpu")
    assert lib.needle_audio_analyzer_new_default(
        two, 2, ctypes.byref(out)) == INVALID_ARGUMENT
    assert lib.needle_audio_comparator_new_default(
        two, 2, ctypes.byref(out)) == INVALID_ARGUMENT
    assert not out.value
