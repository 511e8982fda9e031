"""What a run of the benchmark imports, read from its sources: no jax, no
JAX package, no bench.py; of the port only the system under test; and
nothing of the port in the reference, the season writer or the season
formats."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "needle_tpu", "bench"}
FORBIDDEN_PORT = ("needle_tpu_torch.bench", "needle_tpu_torch.testing",
                  "needle_tpu_torch.parity")
# every module a run or a control imports: all of needle_bench but its tests
RUN_MODULES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


def imported(path: Path):
    """Absolute names of the modules a file imports (relative imports
    resolved against needle_bench)."""
    pkg = ["needle_bench", *path.relative_to(HERE).parent.parts]
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = pkg[: len(pkg) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            out += [mod] + [f"{mod}.{a.name}" for a in node.names] if not node.module \
                else [mod]
    return out


def test_the_guard_sees_every_run_module():
    names = {p.relative_to(HERE).as_posix() for p in RUN_MODULES}
    assert {"run.py", "control.py", "check.py", "trace.py", "roofline.py",
            "traffic/__init__.py", "reference/fingerprint.py",
            "data/season.py", "formats/wav.py", "formats/pcm.py",
            "metrics/count_walk_roofline.py"} <= names


@pytest.mark.parametrize("path", RUN_MODULES, ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_forbidden_import(path):
    for name in imported(path):
        assert name.split(".")[0] not in FORBIDDEN_TOP, (path, name)
        assert not any(name == f or name.startswith(f + ".") for f in FORBIDDEN_PORT), \
            (path, name)
        if path.relative_to(HERE).parts[0] in ("reference", "data", "formats"):
            assert name.split(".")[0] != "needle_tpu_torch", (path, name)


def test_the_guard_reads_relative_imports():
    mods = imported(HERE / "run.py")
    assert "needle_bench.check" in mods and "needle_bench.reference" in mods
    assert "needle_tpu_torch.search" in mods
