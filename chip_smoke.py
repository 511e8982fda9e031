#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (needle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA (no jax needed). It builds the CUDA kernels from
the checkout's sources, checks each against its plain PyTorch version on
the card, then drives the port's main path once: `analyze
--include-endings` and `search --include-endings --write-skip-files` on a
28-episode, 1200 s synthetic season (bench.py's default configuration:
16 kHz mono WAV, 85 s opening at 5-40 s, 70 s ending, seed 20260816), and
checks the result against the truth, the canonical host oracle and the
numpy search engine.

Every phase raises on failure: the script then exits nonzero and prints no
result. On success the line before the last is a JSON object describing
each kernel (launches on the main path, error against the plain version,
times of both) and the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# bench.py's default season
NUM_EPISODES = 28
EPISODE_SECS = 1200.0
OPENING_SECS = 85.0
ENDING_SECS = 70.0
RATE = 16000
SEED = 20260816
TRUTH_TOL_SECS = 8.0
# classifier-value error bound: half the 1e-5 borderline margin
VALUE_TOL = 5e-6
# the count walk's shapes on the season: 378 pairs in one power-of-two
# chunk of lanes, opening and ending buckets
PAIRS, LANES = 378, 512
N_PADS = (2560, 1536)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_phase(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    name = torch.cuda.get_device_name(0)
    log(f"card: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    return smi[0]


def _median_ms(torch, fn, reps):
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def kernel_phase(torch, np):
    """The count walk kernel against batch_counts_reference on the card,
    exactly, at the season's shapes; median times of both."""
    from needle_tpu_torch.search import diag_runs as D

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda", 0)
    result = {"max_abs_err": 0, "ms": {}, "plain_ms": {}}
    for n_pad in N_PADS:
        src = rng.integers(0, 2**32, size=(LANES, n_pad), dtype=np.uint32)
        dst = rng.integers(0, 2**32, size=(LANES, n_pad), dtype=np.uint32)
        for p in range(PAIRS):  # one planted shared run per pair
            n = int(rng.integers(60, 400))
            s0 = int(rng.integers(1, n_pad - n))
            d0 = int(rng.integers(1, n_pad - n))
            dst[p, d0 : d0 + n] = src[p, s0 : s0 + n]
            dst[p, d0 + n // 2] ^= np.uint32(1 << int(rng.integers(32)))
        nv = rng.integers(int(0.8 * n_pad), n_pad + 1, size=LANES).astype(np.int32)
        mv = rng.integers(int(0.8 * n_pad), n_pad + 1, size=LANES).astype(np.int32)
        # thr 0 / 10 and l_min 1 / the season's (20 s over ~0.25 s hashes)
        thr = np.where(np.arange(LANES) % 2 == 0, 10, 0).astype(np.int32)
        lm = np.where(np.arange(LANES) % 3 == 0, 1, 81).astype(np.int32)
        n_groups = D.n_groups_for(n_pad)
        bm = np.full((LANES, n_groups), D.full_block_mask(n_pad), np.int32)
        gaps = rng.integers(0, 2**31, size=(LANES, n_groups)).astype(np.int32)
        bm[::5] &= gaps[::5]  # band masks with gaps on every fifth pair
        # padding lanes, as the engine fills them
        lm[PAIRS:] = np.iinfo(np.int32).max
        bm[PAIRS:] = 0

        def t(a):
            a = np.ascontiguousarray(a)
            return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)

        args = [t(a) for a in (nv, mv, lm, thr, src, dst)] + [n_pad, t(bm)]
        got = D.batch_counts(*args)
        torch.cuda.synchronize()
        want = D.batch_counts_reference(*args)
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        flagged = int((want > 0).sum().item())
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"count walk kernel != reference at n_pad {n_pad}")
        if flagged < PAIRS:
            raise AssertionError(f"only {flagged} flagged diagonals at n_pad {n_pad}")
        result["max_abs_err"] = max(result["max_abs_err"], err)
        # times: plain, kernel, kernel, plain
        plain = [_median_ms(torch, lambda: D.batch_counts_reference(*args), 3)]
        kern = [_median_ms(torch, lambda: D.batch_counts(*args), 20)]
        kern.append(_median_ms(torch, lambda: D.batch_counts(*args), 20))
        plain.append(_median_ms(torch, lambda: D.batch_counts_reference(*args), 3))
        result["ms"][n_pad] = min(kern)
        result["plain_ms"][n_pad] = min(plain)
        log(
            f"count walk n_pad {n_pad}, {LANES} lanes ({PAIRS} pairs): kernel "
            f"== reference on {flagged} flagged diagonals; kernel {kern} ms, "
            f"plain {plain} ms (median per call, two rounds)"
        )
    return result


def season_phase(torch, np, workdir: Path):
    """Analyze + search the bench season through the port's CLI."""
    from needle_tpu.testing import make_synthetic_season
    from needle_tpu.tracing import metrics
    from needle_tpu_torch.cli import main
    from needle_tpu_torch.search import diag_runs

    t0 = time.perf_counter()
    paths, op_truth, end_truth = make_synthetic_season(
        workdir, num_episodes=NUM_EPISODES, episode_secs=EPISODE_SECS,
        opening_secs=OPENING_SECS, opening_offset_range=(5.0, 40.0),
        ending_secs=ENDING_SECS, rate=RATE, seed=SEED,
    )
    log(f"season: {len(paths)} x {EPISODE_SECS:.0f} s episodes written in "
        f"{time.perf_counter() - t0:.1f} s")
    os.environ["NEEDLE_TPU_ALLOW_AUDIO"] = "1"

    metrics.reset()
    diag_runs.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if main(["analyze", "--include-endings", "--force", str(workdir)]) != 0:
        raise AssertionError("analyze failed")
    torch.cuda.synchronize()
    analyze_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if main(["search", "--include-endings", "--write-skip-files",
             "--no-display", str(workdir)]) != 0:
        raise AssertionError("search failed")
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    launches = diag_runs.LAUNCHES
    stages = {k: round(v[0], 3) for k, v in sorted(metrics.snapshot().items())}
    log(f"season walls: analyze {analyze_s:.3f} s, search {search_s:.3f} s; "
        f"count walk launches {launches}")
    log(f"stage seconds: {json.dumps(stages)}")
    if launches <= 0:
        raise AssertionError("the search never launched the count walk kernel")

    ok = 0
    for p, (op_s, op_e), en in zip(paths, op_truth, end_truth):
        skip = json.loads(p.with_suffix(".needle.skip.json").read_text())
        good = skip["opening"] is not None and skip["ending"] is not None
        if good:
            good = (
                abs(skip["opening"][0] - op_s) < TRUTH_TOL_SECS
                and abs(skip["opening"][1] - op_e) < TRUTH_TOL_SECS
                and abs(skip["ending"][0] - en[0]) < TRUTH_TOL_SECS
                and abs(skip["ending"][1] - en[1]) < TRUTH_TOL_SECS
            )
        ok += bool(good)
    accuracy = ok / len(paths)
    log(f"accuracy vs truth (within {TRUTH_TOL_SECS:.0f} s): {accuracy}")
    if accuracy != 1.0:
        raise AssertionError(f"accuracy {accuracy} != 1.0")
    return paths, analyze_s, search_s, launches


def hash_phase(torch, np, paths):
    """Raw window hashes on the card == canonical oracle; the .needle.dat
    hashes are their every step_by-th; the classifier-value error."""
    from needle_tpu.data import FrameHashes
    from needle_tpu_torch.analyzer import Analyzer
    from needle_tpu_torch.fingerprint.ingest_oracle import (
        ingest_hashes_full_oracle,
        ingest_values_oracle,
    )
    from needle_tpu_torch.fingerprint.torch_impl import (
        IngestDispatcher,
        fingerprint_ingest_batch,
        ingest_classifier_values,
    )

    analyzer = Analyzer(paths, device="cuda").with_include_endings(True)
    n_checked = 0
    value_err = None
    for p in paths[:2]:
        op, op_nv, en, en_nv, rate, ch, _ = analyzer._raw_segments(p)
        stored = FrameHashes.from_path(p.with_suffix(".needle.dat"))
        d = IngestDispatcher(rate, ch, "cuda")
        raw = fingerprint_ingest_batch([op, en], rate, ch, [op_nv, en_nv],
                                       device="cuda")
        for (seg, nv), got, kept in zip(
            ((op, op_nv), (en, en_nv)), raw,
            (stored.opening_hashes, stored.ending_hashes),
        ):
            n_sub, nf_b = d.lane_geometry(nv)
            want = ingest_hashes_full_oracle(seg, nv, rate, ch, d.dec_factor,
                                             nf_b, n_sub)
            if not np.array_equal(got, want):
                bad = np.flatnonzero(got != want)
                raise AssertionError(f"{p.name}: raw hashes differ at {bad[:10]}")
            stepped, _ = Analyzer._hashes_with_timestamps(
                want, stored.hash_duration(), None
            )
            if not np.array_equal(kept, stepped):
                raise AssertionError(f"{p.name}: .needle.dat hashes != oracle")
            n_checked += len(got)
        if value_err is None:
            vals, _, dec, nf_b = ingest_classifier_values(op, rate, ch, op_nv,
                                                          device="cuda")
            ref, _ = ingest_values_oracle(op, op_nv, rate, ch, dec, nf_b,
                                          len(vals))
            value_err = float(np.max(np.abs(vals.astype(np.float64) - ref)))
    log(f"hashes: {n_checked} raw window hashes of episodes 1-2 bit-exact "
        f"against the canonical oracle")
    log(f"classifier value error on the card: {value_err:.3e} "
        f"(bound {VALUE_TOL:.0e}, margin 1e-05)")
    if not value_err < VALUE_TOL:
        raise AssertionError(f"value error {value_err} >= {VALUE_TOL}")


def engine_phase(torch, np, paths):
    """TorchSearchEngine on the card == NumpySearchEngine on episodes 1-4:
    RunEntry lists (heap order included) and SearchResults."""
    from needle_tpu.comparator import Comparator as NumpyComparator
    from needle_tpu.data import FrameHashes
    from needle_tpu_torch.comparator import Comparator

    sub = paths[:4]
    fhs = [FrameHashes.from_path(p.with_suffix(".needle.dat")) for p in sub]
    ours = Comparator(sub, device="cuda").with_include_endings(True)
    ref = NumpyComparator(sub, engine="numpy").with_include_endings(True)
    pairs = ours.pair_order(len(sub))

    def entries(cmp):
        return [
            [list(x) for x in (i.src_openings, i.dst_openings, i.src_endings,
                               i.dst_endings)]
            for i in cmp.search_pair_infos(fhs, pairs)
        ]

    got, want = entries(ours), entries(ref)
    if got != want:
        raise AssertionError("RunEntry lists differ from NumpySearchEngine")
    res = [
        [(r.opening, r.ending) for r in c.run_with_frame_hashes(
            fhs, False, False, False)]
        for c in (ours, ref)
    ]
    if res[0] != res[1]:
        raise AssertionError("SearchResults differ from NumpySearchEngine")
    n_entries = sum(len(e) for pair in got for e in pair)
    log(f"engine: {len(pairs)} pairs, {n_entries} RunEntries and "
        f"{len(res[0])} SearchResults equal to NumpySearchEngine")


def main() -> int:
    import torch

    smi_line = card_phase(torch)
    import numpy as np

    from needle_tpu_torch import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")

    kernel = kernel_phase(torch, np)
    with tempfile.TemporaryDirectory(prefix="needle_smoke_") as tmp:
        paths, analyze_s, search_s, launches = season_phase(
            torch, np, Path(tmp)
        )
        hash_phase(torch, np, paths)
        engine_phase(torch, np, paths)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    log(smi_line)
    print(json.dumps({"kernels": [{
        "name": "diag_runs",
        "route": "cuda",
        "source": "needle_tpu_torch/csrc/diag_runs.cu",
        "replaces": "needle_tpu/search/pallas_impl.py:56",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"][N_PADS[0]],
        "plain_ms": kernel["plain_ms"][N_PADS[0]],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
