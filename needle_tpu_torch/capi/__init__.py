"""The C API of capi/needle_tpu.h, served by needle_tpu_torch.

`build()` compiles needle_tpu_torch_capi.cpp (beside this file) with g++
into a shared library that embeds CPython and drives this package's
Analyzer and Comparator, at first use, into `needle_tpu_torch/_build/`
(listed in .gitignore). The header stays where it is and is included
read-only. The library's directory name carries a hash of the source, the
header and the flags, so an edited source is rebuilt and a stale library
is never loaded; a failed build raises.

`build_example(name, out_dir)` compiles one of capi/examples/*.c, unedited,
against that library:

    cc -I<repo>/capi capi/examples/full.c -L<dir> -lneedle_tpu_torch_capi \\
        -Wl,-rpath,<dir>

The library takes its device from NEEDLE_TPU_TORCH_DEVICE (cuda, the
default, or cpu).
"""

from __future__ import annotations

import hashlib
import os
import shlex
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "needle_tpu_torch_capi.cpp"
BUILD_DIR = _HERE.parent / "_build"
# the repo's capi/ directory: the header and the example programs
CAPI_DIR = _HERE.parent.parent / "capi"
HEADER = CAPI_DIR / "needle_tpu.h"
LIB_NAME = "needle_tpu_torch_capi"
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-Wall", "-shared")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if not found:
        raise RuntimeError(f"{name} not found on PATH: the C API cannot be built")
    return found


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"exit code {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    return proc.stdout


def python_flags():
    """(compile flags, link flags) of the embedded interpreter, from
    python3-config; the link flags carry an rpath for each library
    directory, so the library finds libpython where it was linked."""
    config = _tool("python3-config")
    includes = shlex.split(_run([config, "--includes"]))
    ldflags = shlex.split(_run([config, "--embed", "--ldflags"]))
    rpaths = [f"-Wl,-rpath,{f[2:]}" for f in ldflags if f.startswith("-L")]
    return includes, ldflags + rpaths + ["-ldl"]


def build() -> Path:
    """Compile the C API into _build/ unless an up-to-date library exists.
    Returns the library path; raises RuntimeError if the build fails."""
    if not HEADER.exists():
        raise RuntimeError(f"the C API header {HEADER} is missing")
    includes, ldflags = python_flags()
    cmd = [_tool("g++"), *CXX_FLAGS, *includes, f"-I{CAPI_DIR}", str(SOURCE),
           *ldflags]
    digest = hashlib.sha256(" ".join(cmd).encode())
    digest.update(SOURCE.read_bytes())
    digest.update(HEADER.read_bytes())
    out_dir = BUILD_DIR / f"capi-{digest.hexdigest()[:16]}"
    out = out_dir / f"lib{LIB_NAME}.so"
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    _run([*cmd, "-o", str(tmp)])
    os.replace(tmp, out)
    return out


def build_example(name: str, out_dir) -> Path:
    """Compile capi/examples/<name>.c against the library from `build()`
    into out_dir/<name>; returns the program's path."""
    lib_dir = build().parent
    out = Path(out_dir) / name
    out.parent.mkdir(parents=True, exist_ok=True)
    _run([_tool("cc"), f"-I{CAPI_DIR}", str(CAPI_DIR / "examples" / f"{name}.c"),
          f"-L{lib_dir}", f"-l{LIB_NAME}", f"-Wl,-rpath,{lib_dir}",
          "-o", str(out)])
    return out
