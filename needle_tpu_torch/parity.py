"""On-card parity harness of the port: the counterpart of tools/hw_parity.py.

    python3 -m needle_tpu_torch.parity [--device cuda|cpu] [--trials N]
        [--seed S] [--skip-eps] [--eps-only] [--eps-seconds T]
        [--routes walk-all,band-dense,band-pairs,pair,direct]

It runs the full search engine (`Comparator(device=...)`) on every search
route over random and adversarial hash libraries that cross the count
walk's D_TILE=512, and compares every pair's RunEntry lists (scores, run
intervals, simhashes, flags, heap backing order) with the reference-exact
NumPy engine (`Comparator(engine="numpy")`). The libraries are
hw_parity.py's, made from the same seeds (seed, and seed + 1 for the
prefilter libraries), plus one for the pair prefilter (seed + 2), whose
longest side buckets past the 31-bit band mask.

Each route is forced by needle_tpu's knobs, restored afterwards, and must
show that it was taken:

  walk-all    NEEDLE_TPU_SEARCH_PREFILTER=off; every pair walked unmasked
  band-dense  ...PREFILTER=on, NEEDLE_TPU_SEARCH_DIRECT=off,
              NEEDLE_TPU_PREFILTER_DENSE=on; episode-tile band masks,
              pairs skipped
  band-pairs  the same with NEEDLE_TPU_PREFILTER_DENSE=off; per-pair masks
  pair        ...PREFILTER=on, ...DIRECT=off on the long library;
              prefilter_pairs drops pairs
  direct      ...PREFILTER=on, ...DIRECT=on; diagonals flagged, no walk

and each under every formulation of the count walk, swapped in by
rebinding `search.torch_impl.batch_counts`: `kernel` (the CUDA kernel,
diag_runs.batch_counts), `previous` (its previous design,
batch_counts_popc) and `plain` (batch_counts_reference, on the same
device). On the CPU only `plain` runs.

It also measures the classifier values' and chroma norms' error against
the float64 oracle, on the pre-decoded mono route and on the fused ingest
(44.1 kHz stereo, decimate 4), which must stay under half the borderline
margin (NEEDLE_TPU_EXACT_EPS), and checks that both routes' hashes are
bit-exact against their oracles on music and on white noise.

It prints one JSON line with hw_parity.py's keys plus `device` (the card's
name and power limit, as nvidia-smi gives them), `kernels` (the
formulations run) and `routes` (per route: taken, pairs checked, wall
time per formulation), and
exits with 1 on any mismatch or any route not taken. It defaults to the
card and raises without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

from .comparator import Comparator
from .data import FrameHashes
from .duration import Duration

# count walk formulation -> its function in search.diag_runs
FORMULATIONS = {
    "kernel": "batch_counts",
    "previous": "batch_counts_popc",
    "plain": "batch_counts_reference",
}
# route -> (knobs, library set)
ROUTES = {
    "walk-all": ({"NEEDLE_TPU_SEARCH_PREFILTER": "off"}, "random"),
    "band-dense": ({"NEEDLE_TPU_SEARCH_PREFILTER": "on",
                    "NEEDLE_TPU_SEARCH_DIRECT": "off",
                    "NEEDLE_TPU_PREFILTER_DENSE": "on"}, "prefilter"),
    "band-pairs": ({"NEEDLE_TPU_SEARCH_PREFILTER": "on",
                    "NEEDLE_TPU_SEARCH_DIRECT": "off",
                    "NEEDLE_TPU_PREFILTER_DENSE": "off"}, "prefilter"),
    "pair": ({"NEEDLE_TPU_SEARCH_PREFILTER": "on",
              "NEEDLE_TPU_SEARCH_DIRECT": "off"}, "pair"),
    "direct": ({"NEEDLE_TPU_SEARCH_PREFILTER": "on",
                "NEEDLE_TPU_SEARCH_DIRECT": "on"}, "prefilter"),
}
# prefilter functions whose calls show which route ran
_SPIED = ("_band_masks_dense", "_chunk_band_masks", "_chunk_max_corr",
          "_tile_diag_flags")
# hashes of the pair library's long side: buckets to n_pad 16,384, whose
# 33 row blocks do not fit a 31-bit band mask
PAIR_LONG_HASHES = 16000


def _fh(h, ending=None, hash_ms=300):
    h = np.asarray(h, dtype=np.uint32)
    step = 247619033
    ts = (2600090703 + np.arange(len(h)) * step).astype(np.int64)
    if ending is None:
        eh, et = np.zeros(0, np.uint32), np.zeros(0, np.int64)
    else:
        eh = np.asarray(ending, dtype=np.uint32)
        et = (10**12 + np.arange(len(eh)) * step).astype(np.int64)
    return FrameHashes(h, ts, eh, et, Duration.from_millis(hash_ms), "f" * 32)


def make_libraries(rng, trials: int):
    """(name, [FrameHashes], threshold, min_opening_s, include_endings):
    random libraries with one episode past the 512-diagonal tile and a
    shared run with flipped bits, then identical, constant-multi-run and
    tiny adversaries (tools/hw_parity.py::make_libraries)."""
    libs = []
    for trial in range(trials):
        n_eps = int(rng.integers(2, 5))
        lens = rng.integers(60, 900, size=n_eps)
        lens[int(rng.integers(0, n_eps))] = int(rng.integers(513, 1200))
        shared_len = int(rng.integers(20, 80))
        shared = rng.integers(0, 2**32, size=shared_len, dtype=np.uint32)
        fhs = []
        for e in range(n_eps):
            h = rng.integers(0, 2**32, size=int(lens[e]), dtype=np.uint32)
            if lens[e] > shared_len + 2:
                at = int(rng.integers(1, lens[e] - shared_len))
                h[at : at + shared_len] = shared
                flips = rng.integers(0, shared_len, size=4)
                h[at + flips] ^= np.uint32(1) << rng.integers(
                    0, 32, size=4
                ).astype(np.uint32)
            ending = None
            if trial % 2 == 0:
                ending = rng.integers(0, 2**32, size=int(lens[e] // 2),
                                      dtype=np.uint32)
                if lens[e] // 2 > shared_len:
                    ending[: shared_len] = shared
            fhs.append(_fh(h, ending))
        libs.append((
            f"random{trial}", fhs, int(rng.integers(0, 16)),
            int(rng.integers(2, 12)), trial % 2 == 0,
        ))
    h = rng.integers(0, 2**32, size=640, dtype=np.uint32)
    libs.append(("identical", [_fh(h), _fh(h.copy())], 10, 5, False))
    c1 = np.zeros(600, np.uint32)
    c2 = np.zeros(600, np.uint32)
    c1[100] = 0xFFFFFFFF
    c2[480] = 0xFFFFFFFF
    libs.append(("constant-multi-run", [_fh(c1), _fh(c2)], 0, 3, False))
    libs.append(
        ("tiny", [_fh(np.zeros(1, np.uint32)), _fh(np.zeros(5, np.uint32))],
         5, 1, False)
    )
    return libs


def make_prefilter_libraries(rng):
    """Libraries whose l_min supports a W >= 8 prefilter block (20 s at
    300 ms hashes: l_min 81, W 32): a 2-show library, an unrelated one, and
    the weakest qualifying run, l_min cells each exactly at the threshold
    (tools/hw_parity.py::make_prefilter_libraries)."""
    libs = []
    shared_a = rng.integers(0, 2**32, size=120, dtype=np.uint32)
    shared_b = rng.integers(0, 2**32, size=120, dtype=np.uint32)
    fhs = []
    for shared in (shared_a, shared_b):
        for e in range(3):
            h = rng.integers(0, 2**32, size=700, dtype=np.uint32)
            at = 30 + 40 * e
            h[at : at + 120] = shared
            flips = rng.integers(0, 120, size=5)
            h[at + flips] ^= np.uint32(1) << rng.integers(
                0, 32, size=5
            ).astype(np.uint32)
            fhs.append(_fh(h))
    libs.append(("pf-mixed", fhs, 10, 20, False))
    libs.append((
        "pf-unrelated",
        [_fh(rng.integers(0, 2**32, size=600, dtype=np.uint32))
         for _ in range(4)],
        10, 20, False,
    ))
    thr = 10
    run = rng.integers(0, 2**32, size=81, dtype=np.uint32)
    h1 = rng.integers(0, 2**32, size=640, dtype=np.uint32)
    h2 = rng.integers(0, 2**32, size=640, dtype=np.uint32)
    h1[37 : 37 + 81] = run
    noisy = run.copy()
    for k in range(81):
        for b in rng.choice(32, size=thr, replace=False):
            noisy[k] ^= np.uint32(1) << np.uint32(b)
    h2[160 : 160 + 81] = noisy
    libs.append(("pf-exact-threshold", [_fh(h1), _fh(h2)], thr, 20, False))
    return libs


def make_pair_library(rng):
    """The pair prefilter's library: a long episode (PAIR_LONG_HASHES) and
    a short one sharing a 120-hash run with flipped bits, late in the long
    one, and an unrelated short episode; l_min 81. One pair is walked at
    n_pad 16,384, two are dropped."""
    shared = rng.integers(0, 2**32, size=120, dtype=np.uint32)
    long_ = rng.integers(0, 2**32, size=PAIR_LONG_HASHES, dtype=np.uint32)
    short = rng.integers(0, 2**32, size=700, dtype=np.uint32)
    at = PAIR_LONG_HASHES - 1500
    long_[at : at + 120] = shared
    short[50:170] = shared
    flips = rng.integers(0, 120, size=5)
    short[50 + flips] ^= np.uint32(1) << rng.integers(
        0, 32, size=5).astype(np.uint32)
    other = rng.integers(0, 2**32, size=650, dtype=np.uint32)
    return [("pair-long", [_fh(long_), _fh(short), _fh(other)], 10, 20, False)]


def info_fields(info):
    """A fully comparable form of an OpeningAndEndingInfo."""
    def entries(lst):
        return [e.ord_key() for e in lst]

    return {
        "src_openings": entries(info.src_openings),
        "dst_openings": entries(info.dst_openings),
        "src_endings": entries(info.src_endings),
        "dst_endings": entries(info.dst_endings),
    }


def run_engine(fhs, threshold, min_open_s, include_endings, device=None):
    """Every pair's info_fields from the torch engine on `device`, or from
    the numpy engine when device is None."""
    kw = {"engine": "numpy"} if device is None else {"device": device}
    cmp = (
        Comparator.from_files([f"v{k}.mkv" for k in range(len(fhs))], **kw)
        .with_hash_match_threshold(threshold)
        .with_min_opening_duration(Duration.from_secs(min_open_s))
        .with_min_ending_duration(Duration.from_secs(2))
        .with_include_endings(include_endings)
    )
    infos = cmp.search_pair_infos(fhs, Comparator.pair_order(len(fhs)))
    return [info_fields(i) for i in infos]


@contextlib.contextmanager
def environment(knobs):
    """Set the knobs; restore every one of them afterwards."""
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Probe:
    """Within its context the engine's count walk is the formulation's
    function (rebinding search.torch_impl.batch_counts), and the calls of
    the walk and of the prefilter's route functions are counted."""

    def __init__(self, formulation: str):
        self.formulation = formulation
        self.calls = dict.fromkeys(("walk", *_SPIED), 0)

    def _counted(self, name, fn):
        def call(*args, **kwargs):
            self.calls[name] += 1
            return fn(*args, **kwargs)

        return call

    def __enter__(self):
        from .search import diag_runs, prefilter, torch_impl

        walk = getattr(diag_runs, FORMULATIONS[self.formulation])
        self._saved = [(torch_impl, "batch_counts", torch_impl.batch_counts)]
        self._saved += [(prefilter, n, getattr(prefilter, n)) for n in _SPIED]
        torch_impl.batch_counts = self._counted("walk", walk)
        for n in _SPIED:
            setattr(prefilter, n, self._counted(n, getattr(prefilter, n)))
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)


def _route_taken(route, calls, skipped, items):
    """Whether the counted calls show that `route` ran."""
    band = calls["_band_masks_dense"] + calls["_chunk_band_masks"]
    if route == "walk-all":
        return (calls["walk"] > 0 and not band and not calls["_chunk_max_corr"]
                and not calls["_tile_diag_flags"])
    if route == "band-dense":
        return calls["_band_masks_dense"] > 0 and skipped > 0 and calls["walk"] > 0
    if route == "band-pairs":
        return (calls["_chunk_band_masks"] > 0 and not calls["_band_masks_dense"]
                and skipped > 0 and calls["walk"] > 0)
    if route == "pair":
        return (calls["_chunk_max_corr"] > 0 and not band and skipped > 0
                and calls["walk"] > 0)
    return items > 0 and calls["_tile_diag_flags"] > 0 and calls["walk"] == 0


def route_parity(route, libs, oracle, device, formulations):
    """One route over its libraries under each formulation, against the
    oracle's infos. Returns the route's record; "exact" and "taken" decide
    the pass."""
    from .search import diag_runs
    from .tracing import metrics

    knobs, _ = ROUTES[route]
    out = {"exact": True, "taken": True, "libraries": len(libs),
           "pair_infos_checked": 0, "wall_s": {}, "pairs_skipped": 0,
           "direct_items": 0, "launches": {}, "mismatches": []}
    for name in formulations:
        before = metrics.snapshot()
        launches = diag_runs.LAUNCHES, diag_runs.LAUNCHES_POPC
        t0 = time.perf_counter()
        with environment(knobs), Probe(name) as probe:
            for lib, fhs, thr, mo, endings in libs:
                got = run_engine(fhs, thr, mo, endings, device)
                out["pair_infos_checked"] += len(got)
                if got != oracle[lib]:
                    bad = [k for k, (g, o) in enumerate(zip(got, oracle[lib]))
                           if g != o]
                    out["mismatches"].append(
                        {"formulation": name, "library": lib,
                         "bad_pairs": bad[:8]})
        out["wall_s"][name] = round(time.perf_counter() - t0, 3)
        after = metrics.snapshot()

        def grew(key):
            return int(after.get(key, (0.0,))[0] - before.get(key, (0.0,))[0])

        skipped = grew("search.prefilter_skipped")
        items = grew("search.direct_items")
        out["pairs_skipped"] += skipped
        out["direct_items"] += items
        # the card's launch counters move only for their own formulation
        moved = (diag_runs.LAUNCHES - launches[0],
                 diag_runs.LAUNCHES_POPC - launches[1])
        out["launches"][name] = probe.calls["walk"]
        taken = _route_taken(route, probe.calls, skipped, items)
        if name == "kernel":
            taken = taken and moved == (probe.calls["walk"], 0)
        elif name == "previous":
            taken = taken and moved == (0, probe.calls["walk"])
        out["taken"] = out["taken"] and taken
    out["exact"] = not out["mismatches"]
    if not out["mismatches"]:
        del out["mismatches"]
    return out


def _eps_stats(v_dev, n_dev, v_np, norm):
    """Max value error, and the norm's absolute error on small-norm frames
    (the norm feeds only the `norm < 0.01` zeroing compare)."""
    n_sub = min(len(v_dev), len(v_np))
    n_frames = min(len(n_dev), len(norm))
    nd, nn = n_dev[:n_frames].astype(np.float64), norm[:n_frames]
    small = nn <= 1.0
    return {
        "max_value_err": float(np.max(np.abs(v_dev[:n_sub] - v_np[:n_sub]))),
        "max_norm_err_small": (float(np.max(np.abs(nd[small] - nn[small])))
                               if small.any() else 0.0),
        "small_norm_frames": int(small.sum()),
        "max_norm_rel_err": float(np.max(np.abs(nd - nn) / np.maximum(nn, 1e-12))),
        "subfingerprints": n_sub,
    }


def validate_exact_eps(rng, device, seconds: float = 120.0):
    """Classifier values and chroma norms of the mono route on `device`
    against the float64 oracle, on chromatically rich audio that fades out
    so that late frames have tiny norms (tools/hw_parity.py)."""
    from .fingerprint import numpy_impl as NP
    from .fingerprint.torch_impl import classifier_values

    rate = 11025
    n = int(seconds * rate)
    t = np.arange(n) / rate
    x = np.zeros(n)
    for k in range(12):
        f0, f1 = 80 * (k + 1), 120 * (k + 1)
        x += np.sin(2 * np.pi * (f0 * t + (f1 - f0) / (2 * t[-1]) * t * t
                                 + rng.uniform(0, 1)))
    x += 0.1 * rng.standard_normal(n)
    fade_from = int(0.7 * n)
    fade = np.ones(n)
    fade[fade_from:] = np.exp(-12.0 * (t[fade_from:] - t[fade_from])
                              / max(t[-1] - t[fade_from], 1e-9))
    x *= fade
    mono = np.clip(x / np.abs(x).max() * 20000, -32768, 32767).astype(np.int16)
    v_dev, n_dev = classifier_values(mono, device)
    v_np, norm = NP.classifier_values_oracle(mono)
    return _eps_stats(v_dev, n_dev, v_np, norm)


def _differing(a, b, t0):
    """Hash parity of `a` against the oracle's `b`; a hash missing from
    either side counts as differing."""
    from .search.oracle import popcount_u32

    n = min(len(a), len(b))
    d = popcount_u32(np.asarray(a[:n], np.uint32) ^ np.asarray(b[:n], np.uint32))
    return {
        "hashes": int(len(a)),
        "hashes_differing": int((d > 0).sum()) + abs(len(a) - len(b)),
        "max_hamming": int(d.max()) if len(d) else 0,
        "wall_s": round(time.perf_counter() - t0, 2),
    }


def hash_bit_exactness(rng, device, seconds: float = 60.0):
    """Mono-route hashes on `device` (with the borderline rescan) equal to
    fingerprint_numpy bit for bit, on music-like audio and white noise."""
    from .fingerprint.numpy_impl import fingerprint_numpy
    from .fingerprint.torch_impl import fingerprint
    from .testing import _music_like

    rate = 11025
    n = int(seconds * rate)
    samples = {
        # scaled to int16 (hw_parity.py casts the [-1, 1] floats, which
        # leaves near-silence)
        "music": np.clip(_music_like(rng, n, rate) * 9000, -32768, 32767
                         ).astype(np.int16),
        "noise": np.clip(rng.standard_normal(n) * 8000, -32768, 32767
                         ).astype(np.int16),
    }
    res = {}
    for name, mono in samples.items():
        t0 = time.perf_counter()
        res[name] = _differing(fingerprint(mono, device), fingerprint_numpy(mono), t0)
    return res


def validate_ingest_eps(rng, device, seconds: float = 60.0):
    """Fused-ingest classifier values and norms on `device` against the
    canonical ingest oracle, 44.1 kHz stereo (decimate 4), fading out."""
    from .fingerprint.ingest_oracle import ingest_values_oracle
    from .fingerprint.torch_impl import ingest_classifier_values
    from .testing import _music_like

    in_rate, channels = 44100, 2
    n = int(seconds * in_rate)
    mono = _music_like(rng, n, in_rate)
    fade_from = int(0.7 * n)
    fade = np.ones(n)
    fade[fade_from:] = np.exp(-12.0 * np.arange(n - fade_from)
                              / max(n - fade_from, 1))
    stereo = np.empty(2 * n)
    stereo[0::2] = mono * fade
    stereo[1::2] = np.roll(mono, 31) * fade
    seg = np.clip(stereo / np.abs(stereo).max() * 20000, -32768, 32767
                  ).astype(np.int16)
    v_dev, n_dev, dec, nf_b = ingest_classifier_values(
        seg, in_rate, channels, device=device)
    v_np, norm = ingest_values_oracle(seg, len(seg), in_rate, channels, dec,
                                      nf_b, len(v_dev))
    stats = _eps_stats(v_dev, n_dev, v_np, norm)
    del stats["max_norm_rel_err"]
    stats["dec_factor"] = dec
    return stats


def ingest_hash_exactness(rng, device, seconds: float = 45.0):
    """Fused-ingest hashes on `device` equal to the canonical oracle's bit
    for bit, music and noise, 44.1 kHz stereo."""
    from .fingerprint.ingest_oracle import ingest_hashes_full_oracle
    from .fingerprint.torch_impl import IngestDispatcher, fingerprint_ingest_batch
    from .testing import _music_like

    in_rate, channels = 44100, 2
    n = int(seconds * in_rate)
    music = _music_like(rng, n, in_rate)
    segs = {
        "music": np.clip(np.repeat(music / np.abs(music).max() * 20000, 2),
                         -32768, 32767).astype(np.int16),
        "noise": np.clip(rng.standard_normal(2 * n) * 8000, -32768, 32767
                         ).astype(np.int16),
    }
    res = {}
    for name, seg in segs.items():
        t0 = time.perf_counter()
        got = fingerprint_ingest_batch([seg], in_rate, channels, device=device)[0]
        d = IngestDispatcher(in_rate, channels, device)
        n_sub, nf_b = d.lane_geometry(len(seg))
        want = ingest_hashes_full_oracle(seg, len(seg), in_rate, channels,
                                         d.dec_factor, nf_b, n_sub)
        res[name] = _differing(got, want, t0)
    return res


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" for
    the CPU."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def run(argv=None) -> dict:
    """Run the harness; returns its result, whose "ok" says whether it
    passed."""
    from ._torch_setup import resolve_device
    from .fingerprint.plan import _exact_eps

    ap = argparse.ArgumentParser(prog="python3 -m needle_tpu_torch.parity")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--seed", type=int, default=20260817)
    ap.add_argument("--skip-eps", action="store_true")
    ap.add_argument("--eps-only", action="store_true")
    ap.add_argument("--eps-seconds", type=float, default=120.0)
    ap.add_argument("--routes", default=",".join(ROUTES),
                    help="comma-separated routes (default: all)")
    args = ap.parse_args(argv)
    routes = [r for r in args.routes.split(",") if r]
    unknown = sorted(set(routes) - set(ROUTES))
    if unknown:
        ap.error(f"unknown routes {unknown}; choose from {list(ROUTES)}")
    device = resolve_device(args.device)
    formulations = (list(FORMULATIONS) if device.type == "cuda" else ["plain"])

    rng = np.random.default_rng(args.seed)
    sets = {
        "random": make_libraries(rng, args.trials),
        "prefilter": make_prefilter_libraries(np.random.default_rng(args.seed + 1)),
        "pair": make_pair_library(np.random.default_rng(args.seed + 2)),
    }
    if args.eps_only:
        routes = []
    out = {
        "metric": "search hardware parity (RunEntry-exact vs NumPy oracle)",
        "backend": device.type,
        "device": card_line(device),
        "kernels": formulations if routes else [],
        "seed": args.seed,
    }
    oracle, route_out = {}, {}
    for route in routes:
        libs = sets[ROUTES[route][1]]
        for lib, fhs, thr, mo, endings in libs:
            if lib not in oracle:
                oracle[lib] = run_engine(fhs, thr, mo, endings)
        route_out[route] = route_parity(route, libs, oracle, device, formulations)
    out["exact"] = all(r["exact"] for r in route_out.values())
    out["routes_taken"] = all(r["taken"] for r in route_out.values())
    out["libraries"] = len(oracle)
    out["pair_infos_checked"] = sum(r["pair_infos_checked"]
                                    for r in route_out.values())
    out["kernel_times_s"] = {
        name: round(sum(r["wall_s"][name] for r in route_out.values()), 3)
        for name in out["kernels"]}
    out["routes"] = route_out
    mismatches = [{"route": route, **m} for route, r in route_out.items()
                  for m in r.get("mismatches", ())]
    if mismatches:
        out["mismatches"] = mismatches

    def summary(names, count):
        rs = [route_out[r] for r in names if r in route_out]
        return {
            "exact": all(r["exact"] for r in rs),
            "libraries": len({lib for r in names if r in route_out
                              for lib, *_ in sets[ROUTES[r][1]]}),
            "pair_infos_checked": sum(r["pair_infos_checked"] for r in rs),
            count: sum(r[count] for r in rs),
            "wall_s": round(sum(sum(r["wall_s"].values()) for r in rs), 3),
        }

    band = ("band-dense", "band-pairs", "pair")
    if any(r in route_out for r in band):
        out["prefilter"] = summary(band, "pairs_skipped")
    if "direct" in route_out:
        out["direct"] = summary(("direct",), "direct_items")

    ok = out["exact"] and out["routes_taken"]
    if not args.skip_eps:
        eps = _exact_eps()
        out["eps_margin"] = eps
        stats = validate_exact_eps(rng, device, args.eps_seconds)
        out.update({f"eps_{k}": v for k, v in stats.items()})
        out["eps_ok"] = (max(stats["max_value_err"], stats["max_norm_err_small"])
                         < 0.5 * eps and stats["small_norm_frames"] > 0)
        out["hash_parity"] = hash_bit_exactness(rng, device)
        out["hashes_bit_exact"] = all(v["hashes_differing"] == 0
                                      for v in out["hash_parity"].values())
        stats = validate_ingest_eps(rng, device)
        out.update({f"ingest_eps_{k}": v for k, v in stats.items()})
        out["ingest_eps_ok"] = (max(stats["max_value_err"],
                                    stats["max_norm_err_small"]) < 0.5 * eps)
        out["ingest_hash_parity"] = ingest_hash_exactness(rng, device)
        out["ingest_hashes_bit_exact"] = all(
            v["hashes_differing"] == 0 for v in out["ingest_hash_parity"].values())
        ok = ok and all(out[k] for k in ("eps_ok", "hashes_bit_exact",
                                         "ingest_eps_ok", "ingest_hashes_bit_exact"))
    out["ok"] = bool(ok)
    return out


def main(argv=None) -> int:
    out = run(argv)
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
