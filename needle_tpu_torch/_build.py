"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Every `csrc/*.cu` file is compiled into ONE shared library with a plain C
interface, at first use, into `needle_tpu_torch/_build/` (listed in
.gitignore). A plain C interface keeps PyTorch's headers out of the build:
nvcc takes seconds for it, where `torch.utils.cpp_extension.load` takes
minutes. The library's file name carries a hash of the sources and flags,
so an edited source is rebuilt and a stale library is never loaded.

Each C entry point takes device pointers and the CUDA stream as `void*`
and returns the `cudaError_t` of its launch; `check` turns a nonzero code
into an exception. A failed build raises too: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argtypes; every entry point returns an int error code.
SIGNATURES = {
    # nv, mv, lm, thr, bm, n_groups, src, dst, counts, chunk, n_pad, n_out,
    # stream
    "needle_diag_runs": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P),
    "needle_diag_runs_popc": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
# wall seconds of the first load() in this process (nvcc build included)
BUILD_SECONDS = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in filter(None, (home, "/usr/local/cuda")):
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (searched PATH, CUDA_HOME and /usr/local/cuda): "
        "the CUDA kernels cannot be built"
    )


def build() -> Path:
    """Compile csrc/*.cu into _build/ unless an up-to-date library exists.
    Returns the library path; raises RuntimeError if nvcc fails."""
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out = BUILD_DIR / f"libneedle_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call; argtypes set for every
    entry point in SIGNATURES."""
    global _lib, BUILD_SECONDS
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.needle_cuda_error_string.argtypes = [ctypes.c_int]
            lib.needle_cuda_error_string.restype = ctypes.c_char_p
            BUILD_SECONDS = time.perf_counter() - t0
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load().needle_cuda_error_string(int(err)).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")
