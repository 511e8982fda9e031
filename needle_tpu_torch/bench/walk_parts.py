#!/usr/bin/env python3
"""Where the count walk kernel's time goes, on a CUDA card.

    python3 needle_tpu_torch/bench/walk_parts.py

from the root of a checkout (nvcc and PyTorch built for CUDA needed). The
card's profilers may be unavailable, so this builds variants of
csrc/diag_runs.cu with one phase of diag_runs_mma_kernel taken out (by
editing the source text, into a temporary directory) and times each on
the same operands: 512 lanes at n_pad 2560, random rows, every lane fully
valid, thr 10, l_min 81. A variant's counts are wrong; only its time
means something. Variants: the kernel; without the staging; without the
walk (the tensor-core products); without the run step; the walk alone;
and the previous design (batch_counts_popc). Two rounds, in turns; prints
each median (of 10 launches per round, CUDA events) in ms.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from needle_tpu_torch import _build  # noqa: E402
from needle_tpu_torch.search import diag_runs as D  # noqa: E402

STAGE = "    for (int h = k >> 1; h < kSrcHashes + kDstHashes; h += kBand / 2) {"
WALK_START = "    if (warp == kWarps - 1) {\n      walk_tile<3>"
WALK_END = "    }\n    __syncthreads();\n\n    // this diagonal's rows"
RUNS = "      runs_word(word & span_bits(lo - r, hi - r), l_min, run, cand);"


def _without_staging(src: str) -> str:
    return src.replace(STAGE, STAGE.replace("h < kSrcHashes + kDstHashes", "h < 0"))


def _without_walk(src: str) -> str:
    i = src.index(WALK_START)
    j = src.index(WALK_END, i) + len("    }\n")
    return src[:i] + src[j:]


def _without_runs(src: str) -> str:
    return src.replace(RUNS, "      cand += word;")


def _variants(src: str) -> dict:
    for anchor in (STAGE, WALK_START, WALK_END, RUNS):
        if anchor not in src:
            raise RuntimeError(f"anchor not found in diag_runs.cu: {anchor!r}")
    return {
        "kernel": src,
        "without staging": _without_staging(src),
        "without walk": _without_walk(src),
        "without run step": _without_runs(src),
        "walk alone": _without_runs(_without_staging(src)),
    }


def _build_variant(tmp: Path, name: str, text: str):
    cu = tmp / f"{name.replace(' ', '_')}.cu"
    cu.write_text(text)
    lib = tmp / f"lib_{cu.stem}.so"
    common = _build.CSRC / "common.cu"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu),
                    str(common)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).needle_diag_runs
    fn.argtypes = list(_build.SIGNATURES["needle_diag_runs"])
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("walk_parts: no CUDA device")
    n_pad, lanes = 2560, 512
    rng = np.random.default_rng(1)
    dev = torch.device("cuda", 0)

    def card(a):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)

    nv = card(np.full(lanes, n_pad, np.int32))
    lm = card(np.full(lanes, 81, np.int32))
    thr = card(np.full(lanes, 10, np.int32))
    src = card(rng.integers(0, 2**32, size=(lanes, n_pad), dtype=np.uint32))
    dst = card(rng.integers(0, 2**32, size=(lanes, n_pad), dtype=np.uint32))
    bm = card(np.full((lanes, D.n_groups_for(n_pad)), D.full_block_mask(n_pad),
                      np.int32))
    n_out = D.n_tiles_for(n_pad) * D.D_TILE
    out = torch.empty((lanes, n_out), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    calls = {}
    with tempfile.TemporaryDirectory(prefix="walk_parts_") as tmp:
        for name, text in _variants((_build.CSRC / "diag_runs.cu").read_text()).items():
            fn = _build_variant(Path(tmp), name, text)
            calls[name] = (lambda fn=fn: _build.check(fn(
                nv.data_ptr(), nv.data_ptr(), lm.data_ptr(), thr.data_ptr(),
                bm.data_ptr(), bm.shape[1], src.data_ptr(), dst.data_ptr(),
                out.data_ptr(), lanes, n_pad, n_out, stream), "variant"))
        calls["previous design"] = lambda: D.batch_counts_popc(
            nv, nv, lm, thr, src, dst, n_pad, bm)
        print(f"card: {torch.cuda.get_device_name(0)}; {lanes} lanes x n_pad "
              f"{n_pad}, thr 10, l_min 81", flush=True)
        for rnd in range(2):
            for name, call in calls.items():
                call()
                times = []
                for _ in range(10):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    call()
                    end.record()
                    torch.cuda.synchronize()
                    times.append(start.elapsed_time(end))
                print(f"round {rnd}: {name}: {sorted(times)[5]:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
