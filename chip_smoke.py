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
numpy search engine. On the same season:

- profile: the CLI search again with NEEDLE_TPU_PROFILE set, whose
  torch.profiler trace must hold the count walk's kernel events, and whose
  stdout must equal the same search's unprofiled;
- distributed: a world of one over NCCL (`parallel.distributed`):
  `distributed_analyze` rewrites the season's `.needle.dat` files byte for
  byte, and `distributed_search` returns the SearchResults of a
  single-process search, which match the season's skip files;
- capi: the port's C API (`needle_tpu_torch.capi`, capi/needle_tpu.h) and
  the unedited capi/examples programs are built; `full` analyzes and
  searches a copy of the season as a C program on the card, writing the
  `.needle.dat` and skip files the port's CLI writes on another copy; in
  this process, through ctypes, the C API's search launches the count walk
  kernel as often as the season search did;
- parity: `needle_tpu_torch.parity` (tools/hw_parity.py's harness) on the
  card, every route and leg, must pass; its JSON is logged;
- bench: the benchmark's season28 cell (`python3 -m
  needle_tpu_torch.bench.run --trials 1`, in a process of its own) on the
  same season (the bench's own `build_season` wrote it), which must pass
  its checks (the timed search's RunEntry lists of all 378 pairs exact
  against a plain NumPy count) and launch the count walk.

Then the library path:

- long bucket: the count walk at n_pad 32,768 against its plain version,
  and a 2-episode search whose sides bucket there;
- library: bench.py's `mixed1000` library (1000 episodes x 2400 hashes,
  20 shows, 499,500 pairs) searched by the auto route (direct flagging)
  and by walk-all, and its first 300 episodes by the band-mask route;
- bench: the benchmark's mixed1000 configuration, one trial (256 of its
  pairs held exactly against the NumPy count);
- bench: the benchmark's small3 cell, one trial: 3 x 1440 s episodes the
  bench writes as headerless 16 kHz mono .pcm files into a directory of
  its own, analyzed through the raw route and searched (all 3 pairs exact
  against the NumPy count), launching the count walk;
- mono route: the season at 11025 Hz mono through the pre-decoded mono
  fingerprint path (lanes of the fused ingest at 11025 Hz) and the
  search.

The script imports nothing of jax and nothing of needle_tpu (the JAX
package): its references are the port's own (NumpySearchEngine,
fingerprint_numpy, the canonical ingest oracle), and it fails if either
package was loaded by its end. Every phase raises on failure: the script
then exits nonzero and prints no result. The count walk's phases print,
per timed shape, the count walk kernel's time beside its plain version's,
the cells the kernel walked (valid (i, j) cells of the real pairs on
unmasked row blocks), cells/s, and the least time the card could take for
them: the larger of 64 int8 operations per cell (a 32-deep +/-1 dot
product) at 1,979 TOP/s and the bytes the call moves (hash rows in,
counts out) at 3.35 TB/s, the H100 SXM's published peaks. On success the
line before the last is a JSON object describing each kernel (launches on
the main path, error against the plain version, times of both, the bound)
and the last line is

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
SEED = 20260816
TRUTH_TOL_SECS = 8.0
# classifier-value error bound: half the 1e-5 borderline margin
VALUE_TOL = 5e-6
# the count walk's shapes on the season: 378 pairs in one power-of-two
# chunk of lanes, opening and ending buckets
PAIRS, LANES = 378, 512
N_PADS = (2560, 1536)
# the smallest bucket whose hash rows do not fit in shared memory, and a
# side length that buckets there
LONG_N_PAD, LONG_HASHES = 32768, 30000
# bench.py's mixed1000 (search_only_config, 20 shows): episodes, seed; the
# band route runs on the first BAND_EPISODES
LIB_EPISODES, LIB_SEED = 1000, 11
BAND_EPISODES = 300
HASH_STEP_NS = 247619033
TS0_NS = 2600090703


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


def log_bound(label, launches, ms, cells, moved):
    """Log cells/s and the bound of `launches` count walk launches that
    took `ms` of kernel time; return (bound ms, "operations" or
    "bytes"): the larger of the cells' int8
    operations at the card's peak and the moved bytes at its memory rate
    (needle_tpu_torch.bench.count_walk)."""
    from needle_tpu_torch.bench.count_walk import walk_bound

    bound_ms, bound_by = walk_bound(cells, moved)
    log(f"count walk {label}: {launches} launch(es), kernel {ms:.4f} ms, "
        f"{cells} cells walked, {cells / (ms * 1e-3):.4g} cells/s; bound "
        f"{bound_ms:.4f} ms (set by {bound_by}), kernel at "
        f"{bound_ms / ms:.4f} of it")
    return bound_ms, bound_by


def log_timer(timer, label, cells):
    """log_bound of the launches a count_walk.WalkTimer timed."""
    return log_bound(label, len(timer.events), timer.ms(), cells, timer.moved)


def all_pairs_cells(lengths):
    """Cells a walk with all-ones masks visits over every pair of episodes
    with these side lengths: sum over pairs of (n_a - 1) * (n_b - 1)."""
    m = [max(0, n - 1) for n in lengths]
    return (sum(m) ** 2 - sum(x * x for x in m)) // 2


def kernel_phase(torch, np):
    """The count walk kernel against batch_counts_reference on the card,
    exactly, at the season's shapes; median times of both, and the
    kernel's bound."""
    from needle_tpu_torch.bench.count_walk import walk_bytes, walked_cells
    from needle_tpu_torch.search import diag_runs as D

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda", 0)
    result = {"max_abs_err": 0, "ms": {}, "plain_ms": {}, "cells": {},
              "bound_ms": {}, "bound_by": {}}
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
        # plain first and last; the kernel twice between
        plain = [_median_ms(torch, lambda: D.batch_counts_reference(*args), 3)]
        kern = [_median_ms(torch, lambda: D.batch_counts(*args), 20)
                for _ in range(2)]
        plain.append(_median_ms(torch, lambda: D.batch_counts_reference(*args), 3))
        ms = result["ms"][n_pad] = min(kern)
        result["plain_ms"][n_pad] = min(plain)
        log(
            f"count walk n_pad {n_pad}, {LANES} lanes ({PAIRS} pairs): kernel "
            f"== reference on {flagged} flagged diagonals; kernel {kern} ms, "
            f"plain {plain} ms (median per call, two rounds)"
        )
        cells = walked_cells(nv, mv, bm, n_pad, PAIRS)
        result["cells"][n_pad] = cells
        result["bound_ms"][n_pad], result["bound_by"][n_pad] = log_bound(
            f"{LANES} x {n_pad}", 1, ms, cells,
            walk_bytes(LANES, n_pad, int(got.shape[1])),
        )
    return result


def season_phase(torch, np, workdir: Path):
    """Analyze + search the bench season through the port's CLI. The
    bench's `build_season` writes it into workdir, where its bench phase
    finds it."""
    from needle_tpu_torch.bench.count_walk import WalkTimer
    from needle_tpu_torch.bench.run import Season, build_season
    from needle_tpu_torch.cli import main
    from needle_tpu_torch.search import diag_runs
    from needle_tpu_torch.tracing import metrics

    t0 = time.perf_counter()
    paths, op_truth, end_truth = build_season(
        Season(NUM_EPISODES, EPISODE_SECS, OPENING_SECS, ENDING_SECS,
               (5.0, 40.0)), SEED, workdir)
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
    with WalkTimer() as timer:
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
    # the rescan runs on a worker during the reads; only its wait is exposed
    log("season analyze, rescan overlap: " + json.dumps(
        {k: stages.get(k, 0.0) for k in (
            "analyze.decode", "analyze.fingerprint", "ingest.rescan",
            "ingest.rescan_wait")}))
    if launches <= 0:
        raise AssertionError("the search never launched the count walk kernel")
    from needle_tpu_torch.data import FrameHashes

    fhs = [FrameHashes.from_path(p.with_suffix(".needle.dat")) for p in paths]
    cells = (all_pairs_cells([len(f.opening_hashes) for f in fhs])
             + all_pairs_cells([len(f.ending_hashes) for f in fhs]))
    log_timer(timer, "of the season search (openings and endings, walk-all)", cells)

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
    return paths, launches


def hash_phase(torch, np, paths):
    """Raw window hashes on the card == canonical oracle; the .needle.dat
    hashes are their every step_by-th; the classifier-value error."""
    from needle_tpu_torch.analyzer import Analyzer
    from needle_tpu_torch.data import FrameHashes
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
    """TorchSearchEngine on the card == the port's NumpySearchEngine on
    episodes 1-4: RunEntry lists (heap order included) and
    SearchResults."""
    from needle_tpu_torch.comparator import Comparator
    from needle_tpu_torch.data import FrameHashes

    sub = paths[:4]
    fhs = [FrameHashes.from_path(p.with_suffix(".needle.dat")) for p in sub]
    ours = Comparator(sub, device="cuda").with_include_endings(True)
    ref = Comparator(sub, engine="numpy").with_include_endings(True)
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


def profile_phase(torch, workdir: Path):
    """`search --include-endings --device cuda` through the port's CLI,
    unprofiled and then with NEEDLE_TPU_PROFILE set: one Chrome trace
    written, holding the count walk's kernel events; equal stdout."""
    import contextlib
    import io

    from needle_tpu_torch.cli import main
    from needle_tpu_torch.search import diag_runs

    argv = ["search", "--include-endings", "--device", "cuda", str(workdir)]

    def search():
        out = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            if main(argv) != 0:
                raise AssertionError("search failed")
        torch.cuda.synchronize()
        return out.getvalue(), time.perf_counter() - t0

    plain, plain_s = search()
    with tempfile.TemporaryDirectory(prefix="needle_profile_") as prof:
        os.environ["NEEDLE_TPU_PROFILE"] = prof
        diag_runs.LAUNCHES = 0
        try:
            profiled, profiled_s = search()
        finally:
            del os.environ["NEEDLE_TPU_PROFILE"]
        launches = diag_runs.LAUNCHES
        traces = sorted(Path(prof).iterdir())
        if len(traces) != 1:
            raise AssertionError(f"profile wrote {len(traces)} files, not 1")
        events = json.loads(traces[0].read_text())["traceEvents"]
    if profiled != plain or "* Opening - \"" not in plain:
        raise AssertionError("the profiled search's stdout differs")
    walks = [e for e in events
             if e.get("cat") == "kernel" and "diag_runs" in e.get("name", "")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not walks or launches <= 0:
        raise AssertionError(
            f"the trace holds no count walk kernel events ({len(kernels)} "
            f"kernel events; {launches} launches)")
    walk_us = sum(e["dur"] for e in walks)
    kernel_us = sum(e["dur"] for e in kernels)
    # the search's own span (record_function) on the host's clock
    span_us = max(e["dur"] for e in events if e.get("name") == "needle search")
    log(f"profile: search wall {profiled_s:.3f} s profiled, {plain_s:.3f} s "
        f"not; trace {traces[0].name} holds {len(walks)} count walk kernel "
        f"events ({walk_us:.1f} us in all; {launches} launches) among "
        f"{len(kernels)} kernel events ({kernel_us:.1f} us); the search's "
        f"span {span_us:.1f} us, kernels {kernel_us / span_us:.4f} of it; "
        f"stdout equal")


def distributed_phase(torch, np, paths):
    """A world of one over NCCL on local_device(): distributed_analyze
    (force, persisted) rewrites the season's .needle.dat files byte for
    byte; distributed_search returns a single-process search's results,
    which are those the season phase wrote to its skip files."""
    import socket

    import torch.distributed

    from needle_tpu_torch.analyzer import Analyzer
    from needle_tpu_torch.comparator import Comparator
    from needle_tpu_torch.constants import DEFAULT_HASH_DURATION
    from needle_tpu_torch.data import FrameHashes, SkipFile
    from needle_tpu_torch.duration import Duration
    from needle_tpu_torch.parallel import distributed as dist
    from needle_tpu_torch.parallel import local_device
    from needle_tpu_torch.search import diag_runs

    paths = sorted(paths)
    dats = [p.with_suffix(".needle.dat") for p in paths]
    season_dat = [d.read_bytes() for d in dats]
    fhs = [FrameHashes.from_bytes(b) for b in season_dat]
    single = Comparator(paths, device="cuda").with_include_endings(True)
    want = [(r.opening, r.ending)
            for r in single.run_with_frame_hashes(fhs, False, False, False)]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.initialize(f"tcp://127.0.0.1:{port}", num_processes=1, process_id=0,
                    device="cuda")
    try:
        device = local_device()
        analyzer = Analyzer.from_files(paths, force=True, device=device)
        analyzer.with_include_endings(True)
        hd = Duration.from_secs_f32(np.float32(DEFAULT_HASH_DURATION))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        local = dist.distributed_analyze(analyzer, hd, persist=True)
        torch.cuda.synchronize()
        analyze_s = time.perf_counter() - t0
        if len(local) != len(paths) or [d.read_bytes() for d in dats] != season_dat:
            raise AssertionError("distributed_analyze's .needle.dat files differ")
        cmp = Comparator(paths, device=device).with_include_endings(True)
        diag_runs.LAUNCHES = 0
        t0 = time.perf_counter()
        res = dist.distributed_search(
            cmp, [FrameHashes.from_path(d) for d in dats])
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t0
        launches = diag_runs.LAUNCHES
    finally:
        torch.distributed.destroy_process_group()
    got = [(r.opening, r.ending) for r in res]
    if got != want:
        raise AssertionError("distributed_search != a single-process search")
    def f32(span):  # as a skip file holds it: float32 seconds
        return None if span is None else [np.float32(x) for x in span]

    for p, (op, en) in zip(paths, got):
        skip = SkipFile.read(p.with_suffix(".needle.skip.json"))
        if (f32(skip.opening), f32(skip.ending)) != (
                f32(None if op is None else [d.as_secs_f32() for d in op]),
                f32(None if en is None else [d.as_secs_f32() for d in en])):
            raise AssertionError(f"{p.name}: result != the season's skip file")
    if launches <= 0:
        raise AssertionError("distributed_search never launched the count walk")
    log(f"distributed (NCCL, world of one, {device}): analyze {analyze_s:.3f} "
        f"s, .needle.dat byte-identical; search {search_s:.3f} s, "
        f"{launches} count walk launches, {len(got)} SearchResults equal to a "
        f"single-process search and to the season's skip files")


def _capi_library(lib_path):
    """ctypes binding of the C API library, argtypes and restypes set for
    the functions the capi phase calls."""
    import ctypes

    P, S, B, U16, F = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_bool,
                       ctypes.c_uint16, ctypes.c_float)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in (
        ("needle_error_to_str", [ctypes.c_int]),
        ("needle_audio_analyzer_new_default", [P, S, P]),
        ("needle_audio_analyzer_new", [P, S, F, F, B, B, B, P]),
        ("needle_audio_analyzer_run", [P, F, B, B]),
        ("needle_audio_analyzer_free", [P]),
        ("needle_audio_comparator_new_default", [P, S, P]),
        ("needle_audio_comparator_new", [P, S, B, U16, U16, U16, F, P]),
        ("needle_audio_comparator_run", [P, B, B, B, B, B]),
        ("needle_audio_comparator_free", [P]),
    ):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_char_p if name == "needle_error_to_str" else (
            None if name.endswith("_free") else ctypes.c_int)
    return lib


def capi_phase(torch, np, paths, workdir: Path, season_launches):
    """The port's C API (capi/needle_tpu.h served by needle_tpu_torch) on
    the card. The library and capi/examples/{analyzer,comparator,full}.c
    are built from the checkout; `full` runs as a C program on a fresh
    copy of the season (NEEDLE_TPU_TORCH_DEVICE unset: the card) and must
    write the `.needle.dat` and skip files the port's CLI writes on another
    copy with full.c's settings (hash duration 0.3 s, no endings). Then,
    in this process through ctypes, analyze and search the season with
    endings: the search launches the count walk kernel as often as the
    season phase's did. And needle_tpu's error codes for bad arguments."""
    import contextlib
    import ctypes
    import io

    from needle_tpu_torch import capi
    from needle_tpu_torch.cli import main
    from needle_tpu_torch.search import diag_runs

    t0 = time.perf_counter()
    lib_path = capi.build()
    programs = {n: capi.build_example(n, workdir / "capi_bin")
                for n in ("analyzer", "comparator", "full")}
    log(f"capi: {lib_path.name} and {len(programs)} example programs built "
        f"in {time.perf_counter() - t0:.2f} s")

    paths = sorted(paths)
    copies = []
    for name in ("capi_season", "cli_season"):
        d = workdir / name
        d.mkdir()
        for p in paths:
            os.link(p, d / p.name)  # the WAVs only: outputs start afresh
        copies.append(d)
    ours, theirs = copies
    env = {k: v for k, v in os.environ.items()
           if k not in ("NEEDLE_TPU_TORCH_DEVICE", "NEEDLE_TPU_PYTHON_ROOT")}
    env["NEEDLE_TPU_ALLOW_AUDIO"] = "1"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [str(programs["full"]), *(str(ours / p.name) for p in paths)],
        capture_output=True, text=True, env=env, timeout=600,
    )
    full_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"capi full exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    openings = [line for line in proc.stdout.splitlines()
                if line.startswith("* Opening - ")]
    if f"found {len(paths)} videos" not in proc.stdout or not openings:
        raise AssertionError(f"capi full's stdout:\n{proc.stdout[-2000:]}")

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        if (main(["analyze", "--device", "cuda", str(theirs)]) != 0
                or main(["search", "--write-skip-files", "--device", "cuda",
                         str(theirs)]) != 0):
            raise AssertionError("the port's CLI failed on the season copy")
    cli_s = time.perf_counter() - t0

    def outputs(d):
        return {p.name: p.read_bytes() for p in sorted(d.glob("*.needle*"))}

    got, want = outputs(ours), outputs(theirs)
    dats = [n for n in got if n.endswith(".needle.dat")]
    skips = [n for n in got if n.endswith(".needle.skip.json")]
    if got != want or len(dats) != len(paths) or len(skips) != len(paths):
        differ = sorted(n for n in set(got) | set(want) if got.get(n) != want.get(n))
        raise AssertionError(
            f"capi full: {len(dats)} .needle.dat and {len(skips)} skip files; "
            f"differing from the port's CLI: {differ[:8]}")
    log(f"capi full (C program, card): {len(paths)} videos analyzed and "
        f"searched in {full_s:.3f} s (interpreter start and CUDA set-up "
        f"included); {len(dats)} .needle.dat and {len(skips)} skip files "
        f"byte-identical to the port's CLI (analyze + search "
        f"--write-skip-files, {cli_s:.3f} s), {len(openings)} openings shown")

    lib = _capi_library(lib_path)
    arr = (ctypes.c_char_p * len(paths))(*(str(p).encode() for p in paths))
    handle = ctypes.c_void_p()
    rc = lib.needle_audio_analyzer_new(arr, len(paths), 0.5, 0.25, True, False,
                                       True, ctypes.byref(handle))
    if rc != 0:
        raise AssertionError(f"needle_audio_analyzer_new: {rc}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = lib.needle_audio_analyzer_run(handle, 0.3, False, True)
    torch.cuda.synchronize()
    analyze_s = time.perf_counter() - t0
    lib.needle_audio_analyzer_free(handle)
    if rc != 0:
        raise AssertionError(f"needle_audio_analyzer_run: "
                             f"{lib.needle_error_to_str(rc).decode()}")
    rc = lib.needle_audio_comparator_new(arr, len(paths), True, 10, 20, 20, 0.0,
                                         ctypes.byref(handle))
    if rc != 0:
        raise AssertionError(f"needle_audio_comparator_new: {rc}")
    diag_runs.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = lib.needle_audio_comparator_run(handle, False, False, False, False, True)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    launches = diag_runs.LAUNCHES
    lib.needle_audio_comparator_free(handle)
    if rc != 0:
        raise AssertionError(f"needle_audio_comparator_run: "
                             f"{lib.needle_error_to_str(rc).decode()}")
    if launches != season_launches or launches <= 0:
        raise AssertionError(
            f"the C API's search launched the count walk {launches} times, "
            f"the season search {season_launches}")

    # needle_tpu's error codes (tests/test_capi.py), and an unknown device
    out = ctypes.c_void_p()
    one = (ctypes.c_char_p * 1)(b"/tmp/a.mkv")
    two = (ctypes.c_char_p * 2)(b"/tmp/a.mkv", b"/tmp/b.mkv")
    codes = [
        lib.needle_audio_analyzer_new_default(None, 0, None),
        lib.needle_audio_comparator_new_default(one, 1, ctypes.byref(out)),
        lib.needle_audio_comparator_new(two, 2, False, 33, 20, 20, 0.0,
                                        ctypes.byref(out)),
    ]
    os.environ["NEEDLE_TPU_TORCH_DEVICE"] = "tpu"
    try:
        codes.append(lib.needle_audio_comparator_new_default(
            two, 2, ctypes.byref(out)))
    finally:
        del os.environ["NEEDLE_TPU_TORCH_DEVICE"]
    strings = {lib.needle_error_to_str(c) for c in range(12)}
    if codes != [2, 7, 3, 3] or len(strings) != 12:
        raise AssertionError(f"capi error codes {codes}, {len(strings)} strings")
    log(f"capi in-process (ctypes, card): analyze {analyze_s:.3f} s, search "
        f"{search_s:.3f} s with endings, {launches} count walk launches "
        f"(the season search's {season_launches}); error codes {codes}")


def parity_phase(torch):
    """needle_tpu_torch.parity on the card with every route and leg at its
    defaults (trials 6, eps seconds 120): RunEntry-exact on every route under the
    kernel and the plain version; value errors under half the margin;
    hashes bit-exact on the mono route and the 44.1 kHz stereo ingest."""
    from needle_tpu_torch import parity
    from needle_tpu_torch.search import diag_runs

    diag_runs.LAUNCHES = 0
    t0 = time.perf_counter()
    out = parity.run(["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = diag_runs.LAUNCHES
    log(f"parity: {json.dumps(out)}")
    kernel_walks = sum(r["launches"]["kernel"] for r in out["routes"].values())
    if not out["ok"] or sorted(out["routes"]) != sorted(parity.ROUTES):
        raise AssertionError("the parity harness failed")
    if launches <= 0 or launches != kernel_walks:
        raise AssertionError(f"parity: {launches} kernel launches, "
                             f"{kernel_walks} walks by the kernel")
    log(f"parity harness: {out['pair_infos_checked']} pair infos exact on "
        f"{len(out['routes'])} routes x {out['kernels']} in {wall:.3f} s; "
        f"{launches} count walk launches; value error "
        f"{out['eps_max_value_err']:.3e} (mono), "
        f"{out['ingest_eps_max_value_err']:.3e} (ingest)")


def _planted_pairs(np, rng, lanes, n_pad, nv_lo):
    """Random hash rows with one planted shared run of 100-400 hashes (one
    flipped bit) per lane, and valid lengths in [nv_lo, n_pad]."""
    src = rng.integers(0, 2**32, size=(lanes, n_pad), dtype=np.uint32)
    dst = rng.integers(0, 2**32, size=(lanes, n_pad), dtype=np.uint32)
    nv = rng.integers(nv_lo, n_pad + 1, size=lanes).astype(np.int32)
    mv = rng.integers(nv_lo, n_pad + 1, size=lanes).astype(np.int32)
    for p in range(lanes):
        n = int(rng.integers(100, 400))
        s0 = int(rng.integers(1, min(nv[p], mv[p]) - n))
        d0 = int(rng.integers(1, min(nv[p], mv[p]) - n))
        dst[p, d0 : d0 + n] = src[p, s0 : s0 + n]
        dst[p, d0 + n // 2] ^= np.uint32(1 << int(rng.integers(32)))
    return src, dst, nv, mv


def _to_card(torch, np, a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).cuda()


def long_bucket_phase(torch, np):
    """The count walk at n_pad 32,768 against its plain version, exactly:
    a full-mask lane, a lane with a gapped mask, a padding lane. Then a
    2-episode search whose sides (30,000 hashes) bucket to 32,768."""
    from needle_tpu_torch.comparator import Comparator
    from needle_tpu_torch.data import FrameHashes
    from needle_tpu_torch.bench.count_walk import walk_bytes, walked_cells
    from needle_tpu_torch.duration import Duration
    from needle_tpu_torch.search import diag_runs as D

    n_pad = LONG_N_PAD
    rng = np.random.default_rng(SEED + 1)
    src, dst, nv, mv = _planted_pairs(np, rng, 3, n_pad, int(0.9 * n_pad))
    thr = np.array([10, 0, 10], np.int32)
    lm = np.array([81, 1, np.iinfo(np.int32).max], np.int32)
    n_groups = D.n_groups_for(n_pad)
    bm = np.full((3, n_groups), D.full_block_mask(n_pad), np.int32)
    bm[1] = rng.integers(0, 2**31, size=n_groups).astype(np.int32)  # gaps
    bm[2] = 0  # a padding lane, as the engine fills them
    args = [_to_card(torch, np, a) for a in (nv, mv, lm, thr, src, dst)]
    args += [n_pad, _to_card(torch, np, bm)]
    got = D.batch_counts(*args)
    torch.cuda.synchronize()
    want = D.batch_counts_reference(*args)
    torch.cuda.synchronize()
    err = int((got - want).abs().max().item())
    flagged = int((want > 0).sum().item())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"count walk kernel != reference at n_pad {n_pad}")
    if not want[0].any() or got[2].any():
        raise AssertionError(
            f"n_pad {n_pad}: the planted run of lane 0 was not flagged, or "
            "the padding lane was"
        )
    plain = _median_ms(torch, lambda: D.batch_counts_reference(*args), 1)
    kerns = [_median_ms(torch, lambda: D.batch_counts(*args), 10)
             for _ in range(2)]
    kern = min(kerns)
    log(f"count walk n_pad {n_pad}, 3 lanes: kernel == reference on {flagged} "
        f"flagged diagonals; kernel {kerns} ms, plain {plain:.1f} ms")
    cells = walked_cells(nv, mv, bm, n_pad, 2)  # lane 2 is padding
    bound_ms, bound_by = log_bound(f"3 x {n_pad}", 1, kern, cells,
                                   walk_bytes(3, n_pad, int(got.shape[1])))

    n = LONG_HASHES
    shared = rng.integers(0, 2**32, size=400, dtype=np.uint32)
    at = (n // 25, n - 500)
    fhs = []
    for e in range(2):
        h = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        h[at[e] : at[e] + 400] = shared
        ts = (TS0_NS + np.arange(n) * HASH_STEP_NS).astype(np.int64)
        fhs.append(FrameHashes(h, ts, np.zeros(0, np.uint32),
                               np.zeros(0, np.int64), Duration.from_millis(300),
                               f"{e:032x}"))
    before = D.LAUNCHES
    cmp = Comparator([f"long{e}.mkv" for e in range(2)], device="cuda")
    res = cmp.run_with_frame_hashes(fhs, False, False, False)
    launches = D.LAUNCHES - before
    if launches <= 0:
        raise AssertionError("the long-bucket search never launched the kernel")
    for r, a in zip(res, at):
        want_s = (TS0_NS + a * HASH_STEP_NS) / 1e9
        if r.opening is None or abs(r.opening[0].as_secs_f64() - want_s) > TRUTH_TOL_SECS:
            raise AssertionError(f"long-bucket run not found: {r}")
    if len(res) != 2:
        raise AssertionError(f"long-bucket search found {len(res)} of 2 runs")
    log(f"long-bucket search: 2 x {n} hashes (n_pad {n_pad}), planted run "
        f"found in both, {launches} kernel launches")
    return {"ms": kern, "plain_ms": plain, "max_abs_err": err,
            "cells": cells, "bound_ms": bound_ms, "bound_by": bound_by}


def _library_search(torch, fhs, env):
    """One search of `fhs` on the card with `env` set: (entries per pair,
    SearchResults, wall s, search.prefilter s, count walk launches and
    their timer, direct items, walk calls that got band masks)."""
    from needle_tpu_torch.bench.count_walk import WalkTimer
    from needle_tpu_torch.comparator import Comparator
    from needle_tpu_torch.search import diag_runs as D
    from needle_tpu_torch.search import torch_impl as T
    from needle_tpu_torch.tracing import metrics

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    masked = []
    real_walk = T.TorchSearchEngine._walk

    def walk(self, w_sa, w_sb, w_lm, band_masks, *rest):
        masked.append(band_masks is not None)
        return real_walk(self, w_sa, w_sb, w_lm, band_masks, *rest)

    T.TorchSearchEngine._walk = walk
    try:
        cmp = Comparator([f"ep{k:04}.mkv" for k in range(len(fhs))], device="cuda")
        pairs = cmp.pair_order(len(fhs))
        metrics.reset()
        D.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with WalkTimer() as timer:
            infos = cmp.search_pair_infos(fhs, pairs)
        data = [(i, j, info) for (i, j), info in zip(pairs, infos)
                if not info.is_empty()]
        res = cmp.finalize_results(data, False, False, False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        T.TorchSearchEngine._walk = real_walk
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    snap = metrics.snapshot()
    entries = [[list(x) for x in (i.src_openings, i.dst_openings)] for i in infos]
    results = [(r.opening, r.ending) for r in res]
    return {
        "entries": entries, "results": results, "wall": wall,
        "prefilter_s": snap.get("search.prefilter", (0.0, 0))[0],
        "launches": D.LAUNCHES, "timer": timer,
        "direct_items": snap.get("search.direct_items", (0.0, 0))[0],
        "skipped": snap.get("search.prefilter_skipped", (0.0, 0))[0],
        "masked_walks": sum(masked), "walks": len(masked),
        "n_entries": sum(len(e[0]) for e in entries),
        "stages": {k: round(v[0], 3) for k, v in sorted(snap.items())
                   if k.startswith("search.") and k not in (
                       "search.direct_items", "search.prefilter_skipped")},
    }


def library_phase(torch, np):
    """mixed1000 by the auto route (direct, no count walk) and walk-all;
    equal, every opening at its planted position. The first 300 episodes
    by the band route (count walk on real masks) == walk-all."""
    from needle_tpu_torch.bench.run import make_library

    fhs, truth = make_library(LIB_EPISODES, LIB_SEED)
    n_pairs = LIB_EPISODES * (LIB_EPISODES - 1) // 2
    auto = _library_search(torch, fhs, {"NEEDLE_TPU_SEARCH_PREFILTER": "auto",
                                        "NEEDLE_TPU_SEARCH_DIRECT": "auto"})
    walk = _library_search(torch, fhs, {"NEEDLE_TPU_SEARCH_PREFILTER": "off"})
    walls = {}
    for name, r in (("direct (auto)", auto), ("walk-all", walk)):
        log(f"mixed1000 {name}: {n_pairs} pairs, wall {r['wall']:.3f} s, "
            f"search.prefilter {r['prefilter_s']:.3f} s, count walk launches "
            f"{r['launches']}, direct items {r['direct_items']:.0f}, "
            f"{r['n_entries']} RunEntries, {len(r['results'])} SearchResults; "
            f"stage seconds {json.dumps(r['stages'])}")
        walls[name] = (r["wall"], r["prefilter_s"])
    if auto["direct_items"] <= 0 or auto["launches"] != 0 or auto["walks"]:
        raise AssertionError("mixed1000's auto route was not direct flagging")
    if walk["launches"] <= 0 or walk["direct_items"] or walk["masked_walks"]:
        raise AssertionError("walk-all did not walk every pair unmasked")
    lib_cells = all_pairs_cells([len(f.opening_hashes) for f in fhs])
    log_timer(walk["timer"], "of mixed1000 walk-all", lib_cells)
    if auto["entries"] != walk["entries"] or auto["results"] != walk["results"]:
        raise AssertionError("mixed1000: direct route != walk-all")
    if len(auto["results"]) != LIB_EPISODES:
        raise AssertionError(f"mixed1000: {len(auto['results'])} results")
    for (op, _), (s0, s1) in zip(auto["results"], truth):
        if (op is None or abs(op[0].as_secs_f64() - s0) > TRUTH_TOL_SECS
                or abs(op[1].as_secs_f64() - s1) > TRUTH_TOL_SECS):
            raise AssertionError(f"mixed1000 opening {op} != planted {(s0, s1)}")
    log(f"mixed1000: direct == walk-all; all {LIB_EPISODES} openings at "
        f"their planted positions (within {TRUTH_TOL_SECS:.0f} s)")

    sub = fhs[:BAND_EPISODES]
    n_sub = BAND_EPISODES * (BAND_EPISODES - 1) // 2
    band = _library_search(torch, sub, {"NEEDLE_TPU_SEARCH_PREFILTER": "auto",
                                        "NEEDLE_TPU_SEARCH_DIRECT": "off"})
    walk_sub = _library_search(torch, sub, {"NEEDLE_TPU_SEARCH_PREFILTER": "off"})
    for name, r in (("band", band), ("walk-all", walk_sub)):
        log(f"mixed{BAND_EPISODES} {name}: {n_sub} pairs, wall {r['wall']:.3f} s, "
            f"search.prefilter {r['prefilter_s']:.3f} s, count walk launches "
            f"{r['launches']} ({r['masked_walks']} of {r['walks']} walks on band "
            f"masks), pairs skipped {r['skipped']:.0f}; stage seconds "
            f"{json.dumps(r['stages'])}")
        walls[f"{name} {BAND_EPISODES}"] = (r["wall"], r["prefilter_s"])
    if band["launches"] <= 0 or band["masked_walks"] != band["walks"] or not band["skipped"]:
        raise AssertionError("the band route did not walk on real masks")
    if band["entries"] != walk_sub["entries"] or band["results"] != walk_sub["results"]:
        raise AssertionError(f"mixed{BAND_EPISODES}: band route != walk-all")
    log(f"mixed{BAND_EPISODES}: band route == walk-all")
    return walls


def bench_phase(cell, *argv):
    """One benchmark configuration: `python3 -m needle_tpu_torch.bench.run
    --trials 1` in a process of its own (its launch counts start at 0
    there) must exit 0 and end in a parseable JSON line at accuracy 1.0,
    with its exact check made, on the card; the season's and small3's
    searches must have launched the count walk kernel."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "needle_tpu_torch.bench.run", "--trials", "1",
         *argv],
        capture_output=True, text=True, timeout=900,
        cwd=Path(__file__).resolve().parent,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench {cell} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    head = json.loads(proc.stdout.strip().splitlines()[-1])
    if head["accuracy_vs_truth"] != 1.0 or head["device"] == "cpu":
        raise AssertionError(f"bench {cell}: {head}")
    if cell in ("season28", "small3") and head["count_walk_launches"] <= 0:
        raise AssertionError(f"bench {cell} never launched the count walk")
    if head["exact_pairs"] <= 0 or head["control_pairs_wrong"] <= 0:
        raise AssertionError(f"bench {cell}: no exact check: {head}")
    log(f"bench {cell} ({wall:.1f} s with its process): {json.dumps(head)}")


def mono_phase(torch, np, workdir: Path):
    """The season written at 11025 Hz mono and read with ingest.read_wav
    (no FFmpeg), windowed as the Analyzer windows it, through the
    pre-decoded mono route on the card: episodes 1-2 bit-exact against
    fingerprint_numpy, and the search at accuracy 1.0."""
    from needle_tpu_torch import ingest
    from needle_tpu_torch.analyzer import Analyzer
    from needle_tpu_torch.comparator import Comparator
    from needle_tpu_torch.constants import DEFAULT_HASH_DURATION
    from needle_tpu_torch.data import FrameHashes
    from needle_tpu_torch.duration import Duration
    from needle_tpu_torch.fingerprint.numpy_impl import fingerprint_numpy
    from needle_tpu_torch.fingerprint.torch_impl import fingerprint_batch
    from needle_tpu_torch.testing import make_synthetic_season

    paths, op_truth, end_truth = make_synthetic_season(
        workdir, num_episodes=NUM_EPISODES, episode_secs=EPISODE_SECS,
        opening_secs=OPENING_SECS, opening_offset_range=(5.0, 40.0),
        ending_secs=ENDING_SECS, rate=11025, seed=SEED,
    )
    analyzer = Analyzer(paths, device="cuda").with_include_endings(True)
    windows, seeks = [], []
    for p in paths:
        samples, rate, channels = ingest.read_wav(p)
        if (rate, channels) != (11025, 1):
            raise AssertionError(f"{p.name}: {rate} Hz x {channels}")
        # the Analyzer's opening and ending windows of this file
        _, n_open, ending, _, _, _, seek_to = analyzer._raw_segments(p)
        windows += [samples[:n_open], samples[len(samples) - len(ending):]]
        seeks.append(seek_to)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hashes = fingerprint_batch(windows, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k in range(4):  # episodes 1-2, opening and ending windows
        want = fingerprint_numpy(windows[k])
        if not np.array_equal(hashes[k], want):
            bad = np.flatnonzero(hashes[k] != want)
            raise AssertionError(f"mono window {k}: hashes differ at {bad[:10]}")
    hd = Duration.from_secs_f32(np.float32(DEFAULT_HASH_DURATION))
    fhs = []
    for e, seek_to in enumerate(seeks):
        oh, ot = Analyzer._hashes_with_timestamps(hashes[2 * e], hd, None)
        eh, et = Analyzer._hashes_with_timestamps(hashes[2 * e + 1], hd, seek_to)
        fhs.append(FrameHashes(oh, ot, eh, et, hd, f"{e:032x}"))
    cmp = Comparator(paths, device="cuda").with_include_endings(True)
    res = cmp.run_with_frame_hashes(fhs, False, False, False)
    ok = 0
    for r, (op_s, op_e), (en_s, en_e) in zip(res, op_truth, end_truth):
        ok += bool(
            r.opening is not None and r.ending is not None
            and abs(r.opening[0].as_secs_f64() - op_s) < TRUTH_TOL_SECS
            and abs(r.opening[1].as_secs_f64() - op_e) < TRUTH_TOL_SECS
            and abs(r.ending[0].as_secs_f64() - en_s) < TRUTH_TOL_SECS
            and abs(r.ending[1].as_secs_f64() - en_e) < TRUTH_TOL_SECS
        )
    accuracy = ok / len(paths)
    n_hashes = sum(len(h) for h in hashes)
    log(f"mono route: {len(windows)} windows at 11025 Hz mono, {n_hashes} "
        f"hashes in {wall:.3f} s (fingerprint_batch, rescan included); "
        f"windows of episodes 1-2 bit-exact against fingerprint_numpy; "
        f"search accuracy {accuracy}")
    if accuracy != 1.0:
        raise AssertionError(f"mono route accuracy {accuracy} != 1.0")


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
        paths, launches = season_phase(torch, np, Path(tmp))
        hash_phase(torch, np, paths)
        engine_phase(torch, np, paths)
        profile_phase(torch, Path(tmp))
        distributed_phase(torch, np, paths)
        capi_phase(torch, np, paths, Path(tmp), launches)
        parity_phase(torch)
        bench_phase("season28", "--season-dir", tmp)
    long_bucket_phase(torch, np)
    library_phase(torch, np)
    bench_phase("mixed1000", "--config", "mixed1000")
    with tempfile.TemporaryDirectory(prefix="needle_smoke_small3_") as tmp:
        bench_phase("small3", "--config", "small3", "--season-dir", tmp)
    with tempfile.TemporaryDirectory(prefix="needle_smoke_mono_") as tmp:
        mono_phase(torch, np, Path(tmp))
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    reference = sorted(m for m in sys.modules
                       if m == "needle_tpu" or m.startswith("needle_tpu."))
    if reference:
        raise AssertionError(f"needle_tpu modules were imported: {reference}")

    log(smi_line)
    n_pad = N_PADS[0]
    print(json.dumps({"kernels": [{
        "name": "diag_runs",
        "route": "cuda",
        "source": "needle_tpu_torch/csrc/diag_runs.cu",
        "replaces": "needle_tpu/search/pallas_impl.py:56",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"][n_pad],
        "plain_ms": kernel["plain_ms"][n_pad],
        "bound_ms": kernel["bound_ms"][n_pad],
        "bound_by": kernel["bound_by"][n_pad],
        # no PyTorch call computes per-diagonal run counts
        "library_ms": None,
        "cells": kernel["cells"][n_pad],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
