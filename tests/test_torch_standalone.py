"""needle_tpu_torch stands alone: no module of the port, and not
chip_smoke.py, imports jax or any module of needle_tpu.

(a) scans the source of every module, imports inside functions included
(nor may they import the repo's tools/), and the C API's C++ source for
the modules it imports; (b) and (c) import the port, and chip_smoke.py, in
a fresh interpreter whose import system refuses jax, jaxlib, needle_tpu
and needle_tpu.*, and (b) runs analyze and search end to end there."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "needle_tpu")


def _forbidden(module: str) -> bool:
    """needle_tpu and needle_tpu.x are forbidden; needle_tpu_torch is not."""
    return module.split(".")[0] in FORBIDDEN


def _sources():
    return sorted((REPO / "needle_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"
    ]


def _imports(tree):
    """(line, module) of every absolute import in a module, at any depth,
    and of every importlib.import_module / __import__ call on a literal."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.lineno, node.args[0].value


def test_sources_import_nothing_of_needle_tpu_or_jax():
    bad, n_modules = [], 0
    for path in _sources():
        n_modules += 1
        tree = ast.parse(path.read_text(), filename=str(path))
        for line, module in _imports(tree):
            if _forbidden(module) or module.split(".")[0] == "tools":
                bad.append(f"{path.relative_to(REPO)}:{line}: {module}")
    assert n_modules > 20
    assert not bad, "\n".join(bad)
    # the scan sees imports inside functions, and tells the packages apart
    probe = ast.parse(
        "def f():\n    from needle_tpu.data import FrameHashes\n"
        "import needle_tpu_torch.data\nfrom needle_tpu_torch import cli\n"
        "import importlib\nimportlib.import_module('jax.numpy')\n"
    )
    assert [m for _, m in _imports(probe) if _forbidden(m)] == [
        "needle_tpu.data", "jax.numpy"
    ]


def test_capi_source_imports_only_the_port():
    """The C API's C++ source imports needle_tpu_torch, by that literal
    name, and nothing else; it includes the header read-only."""
    src = (REPO / "needle_tpu_torch" / "capi" / "needle_tpu_torch_capi.cpp").read_text()
    calls = re.findall(r"PyImport_\w+\(([^)]*)\)", src)
    assert calls and set(calls) == {'"needle_tpu_torch"'}, calls
    includes = re.findall(r'#include\s+"([^"]+)"', src)
    assert includes == ["needle_tpu.h"], includes


_BLOCKER = '''
import importlib.abc
import sys

FORBIDDEN = ("jax", "jaxlib", "needle_tpu")


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"blocked: {name}")
        return None


for loaded in list(sys.modules):
    if loaded.split(".")[0] in FORBIDDEN:
        raise SystemExit(f"{loaded} was loaded before the blocker")
sys.meta_path.insert(0, Blocker())
try:
    import needle_tpu  # noqa: F401
except ImportError:
    pass
else:
    raise SystemExit("the blocker let needle_tpu through")
'''

_PORT_RUN = _BLOCKER + '''
import importlib
import pkgutil

import needle_tpu_torch

names = [m.name for m in pkgutil.walk_packages(
    needle_tpu_torch.__path__, "needle_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print("modules:", len(names))

from needle_tpu_torch.cli import main
from needle_tpu_torch.testing import make_synthetic_season

season = sys.argv[1]
make_synthetic_season(season, num_episodes=2, episode_secs=90,
                      opening_secs=20, seed=5)
assert main(["analyze", "--device", "cpu", season]) == 0
assert main(["search", "--device", "cpu", season]) == 0
print("forbidden loaded:", sorted(
    m for m in sys.modules if m.split(".")[0] in FORBIDDEN))
'''

_SMOKE_IMPORT = _BLOCKER + '''
import chip_smoke

print("phases:", sorted(n for n in dir(chip_smoke) if n.endswith("_phase")))
print("forbidden loaded:", sorted(
    m for m in sys.modules if m.split(".")[0] in FORBIDDEN))
'''


def _run(script, *args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(REPO), NEEDLE_TPU_ALLOW_AUDIO="1")
    return subprocess.run(
        [sys.executable, "-c", script, *args],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=300,
    )


def test_port_imports_and_runs_with_needle_tpu_blocked(tmp_path):
    proc = _run(_PORT_RUN, str(tmp_path / "season"))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert int(lines[0].split()[-1]) > 20
    assert any(line.startswith("* Opening - \"") for line in lines), proc.stdout
    assert lines[-1] == "forbidden loaded: []"


def test_chip_smoke_imports_with_needle_tpu_blocked():
    proc = _run(_SMOKE_IMPORT)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert "kernel_phase" in lines[0] and "season_phase" in lines[0]
    assert lines[-1] == "forbidden loaded: []"
