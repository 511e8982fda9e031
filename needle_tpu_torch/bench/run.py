"""Benchmark of the port on one card: the counterpart of bench.py.

    python3 -m needle_tpu_torch.bench.run [--config season|small3|mixedN]
        [--trials N] [--seed S] [--device cuda|cpu] [--season-dir DIR]
        [--episodes N] [--episode-secs T] [--opening-secs T]
        [--ending-secs T] [--lib-hashes N]

from the root of a checkout. The configurations are bench.py's
(bench.py:860-871):

  season   (default) 28 x 1200 s episodes of 16 kHz mono WAV sharing an
           85 s opening (at 5-40 s) and a 70 s ending, seed 20260816:
           analyze with endings (force, persisted), then the all-pairs
           search with endings, writing skip files. The reference's
           headline workflow (aksiksi/needle README.md:96-108).
  small3   the season's flow over 3 x 1440 s episodes (opening at 5-15 s),
           each stored as headerless 16 kHz mono i16 .pcm, which the
           analyzer reads with no WAV header (bench.py:764-857). The
           reference's smallest published workflow (README.md:96).
  mixedN   search only, over N pre-hashed episodes (default 1000) of 20
           shows, seed 11: 2400 hashes each at ~0.248 s, the episodes of a
           show sharing a 360-hash run at 40 + (e % 11) x 60; openings only.

A season's (or small3's) files are written once, from the seed, into
.bench_cache/needle_tpu_torch/<name>/ (or --season-dir) with a TRUTH.json,
and reused; that and reading them once into the page cache stay out of
every timed window. Then one cold pass (the kernels' build at first use,
the CUDA context and the libraries' handles land there), reported apart,
and N timed trials. Each wall is a host clock that starts and ends with
the card synchronised. Per trial it prints the walls, the stage seconds
(the deltas of `tracing.metrics`: host clocks that are not synchronised
with the card, so they show where the host waits, not device time) and
the count walk's kernel launches.

After the trials it checks the outputs; any failed check exits 1 with no
result. The last timed search's own per-pair RunEntry lists must equal a
plain NumPy count of diagonal runs (`reference`, independent of the
port's search code): every pair of the season, 256 pairs of a library
(192 of one show, 64 of two, drawn from the seed). The same comparison
must reject a control, the count at the match threshold + 1. Season
and small3 also: accuracy 1.0 (opening and ending within 8 s of the
planted truth, bench.py's rule), the `.needle.dat` hashes of two
episodes bit-exact against the host oracle, and the results equal to
the NumPy engine's on the first four episodes. Libraries: every
episode's opening within 8 s of its planted run.

On the card a traced pass follows: one search with CUDA events around
every count walk launch (kernel ms, cells walked, share of the bound; see
`count_walk`), and one search inside `tracing.device_profile`, whose
torch.profiler trace gives the card's busy share of the search.

The last line is one JSON object in bench.py's shape: `metric`, `value`
(the median over the trials, in s), `unit`, `vs_baseline` (value over the
reference's 17.6 s for the season, bench.py's 11.0 s for small3 and
5.617 s x pairs / 378 for a library), the min over the trials, the
component walls, accuracy, the exact check's and the control's
readings, pairs per second, the
per-layer readings and `device` (the card's name and power limit as
nvidia-smi gives them, or "cpu"; a CPU run reports no device metric). A
detail line before it holds every trial. `--device cuda` (the default)
without a card exits nonzero before any timing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..analyzer import Analyzer
from ..comparator import Comparator
from ..data import FrameHashes, frame_hash_data_path
from ..duration import Duration
from ..ingest import read_wav
from ..search import diag_runs
from ..testing import make_synthetic_season
from ..tracing import device_profile, metrics

CACHE_ROOT = Path(__file__).resolve().parents[2] / ".bench_cache" / "needle_tpu_torch"

# the reference's walls on a multi-core CPU (aksiksi/needle README.md:100-105;
# bench.py:35-37)
BASELINE_ANALYZE_S = 11.983
BASELINE_SEARCH_S = 5.617
BASELINE_TOTAL_S = BASELINE_ANALYZE_S + BASELINE_SEARCH_S
BASELINE_PAIRS = 378

# bench.py's season (bench.py:39-44)
NUM_EPISODES = 28
EPISODE_SECS = 1200.0
OPENING_SECS = 85.0
ENDING_SECS = 70.0
RATE = 16000
SEED = 20260816
HASH_DURATION_S = 0.3
TRUTH_TOL_S = 8.0
# small3's baseline: the reference's ~10 s analyze + <1 s search of 3
# episodes on an M1 (README.md:96; bench.py:847)
SMALL3_BASELINE_S = 11.0

# bench.py's libraries (search_only_config, bench.py:668-685)
LIB_SEED = 11
LIB_HASHES = 2400  # ~10 min of opening window
LIB_RUN = 360  # ~90 s shared run
LIB_SHOWS = 20
HASH_STEP_NS = 247619033  # ~0.248 s per hash
TS0_NS = 2600090703
# library pairs held exactly against the NumPy count: of one show, of two
EXACT_SAME_SHOW, EXACT_OTHER = 192, 64

# stage spans and counts reported per trial (the port's tracing names)
STAGE_KEYS = (
    "ingest.read_raw", "ingest.batch_assemble", "ingest.upload",
    "ingest.dispatch", "ingest.collect", "ingest.rescan", "analyze.decode",
    "analyze.fingerprint", "analyze.assemble", "search.pairs",
    "search.prefilter", "search.walk", "search.extract", "search.entries",
)
COUNT_KEYS = ("ingest.upload_bytes", "search.direct_items",
              "search.prefilter_skipped")
PROFILE_LABEL = "bench search"
# device activity in a torch.profiler Chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass(frozen=True)
class Season:
    """bench.py's season, at its size or cut for a run on the CPU."""

    episodes: int = NUM_EPISODES
    episode_secs: float = EPISODE_SECS
    opening_secs: float = OPENING_SECS
    ending_secs: float = ENDING_SECS
    offset_range: tuple = (5.0, 40.0)


# bench.py's small3 (bench.py:771-776): make_synthetic_season's default
# opening offsets, not the season's
SMALL3 = Season(episodes=3, episode_secs=1440.0, offset_range=(5.0, 15.0))


def log(msg: str) -> None:
    print(msg, flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"bench: check failed: {what}")


def accuracy(results, op_truth, end_truth, tol=TRUTH_TOL_S) -> float:
    """Share of results whose opening (and, where the truth has one,
    ending) lies within `tol` seconds of the truth (bench.py:637-652)."""
    ok = 0
    for r, (op_s, op_e), en in zip(results, op_truth, end_truth):
        good = (
            r.opening is not None
            and abs(r.opening[0].as_secs_f64() - op_s) < tol
            and abs(r.opening[1].as_secs_f64() - op_e) < tol
        )
        if en is not None:
            good = good and (
                r.ending is not None
                and abs(r.ending[0].as_secs_f64() - en[0]) < tol
                and abs(r.ending[1].as_secs_f64() - en[1]) < tol
            )
        ok += bool(good)
    return ok / max(1, len(results))


def _cache_dir(kind: str, spec: Season, seed: int) -> Path:
    return CACHE_ROOT / (
        f"{kind}{spec.episodes}_{spec.episode_secs:g}s_"
        f"o{spec.opening_secs:g}_e{spec.ending_secs:g}_r{RATE}_s{seed}")


def _write_season(spec: Season, seed: int, out_dir: Path):
    return make_synthetic_season(
        out_dir, num_episodes=spec.episodes, episode_secs=spec.episode_secs,
        opening_secs=spec.opening_secs, opening_offset_range=spec.offset_range,
        ending_secs=spec.ending_secs, rate=RATE, seed=seed,
    )


def build_season(spec: Season, seed: int, season_dir=None):
    """(paths, opening truth, ending truth) of the season, written from the
    seed into `season_dir` (default: a directory of its own under
    CACHE_ROOT) unless its TRUTH.json and files are there already."""
    season_dir = Path(season_dir or _cache_dir("season", spec, seed))
    marker = season_dir / "TRUTH.json"
    if marker.exists():
        truth = json.loads(marker.read_text())
        paths = [season_dir / p for p in truth["paths"]]
        if all(p.exists() for p in paths):
            return paths, truth["opening"], truth["ending"]
    paths, op_truth, end_truth = _write_season(spec, seed, season_dir)
    marker.write_text(json.dumps({"paths": [p.name for p in paths],
                                  "opening": op_truth, "ending": end_truth}))
    return paths, op_truth, end_truth


def build_small3(spec: Season, seed: int, pcm_dir=None):
    """(paths, opening truth, ending truth) of small3 as bench.py writes it
    (bench.py:771-790): the season from the seed, each WAV read back and
    stored as a headerless 16 kHz mono i16 `<stem>.pcm`, the WAV deleted,
    and a TRUTH.json of the truth; into `pcm_dir` (default: a directory of
    its own under CACHE_ROOT) unless its TRUTH.json and files are there
    already."""
    pcm_dir = Path(pcm_dir or _cache_dir("small3_ep", spec, seed))
    marker = pcm_dir / "TRUTH.json"
    paths = sorted(pcm_dir.glob("*.pcm"))
    if marker.exists() and len(paths) == spec.episodes:
        truth = json.loads(marker.read_text())
        return paths, truth["opening"], truth["ending"]
    wavs, op_truth, end_truth = _write_season(spec, seed, pcm_dir)
    for p in wavs:
        samples, _, _ = read_wav(p)
        samples.astype(np.int16).tofile(p.with_suffix(".pcm"))
        p.unlink()
    marker.write_text(json.dumps({"opening": op_truth, "ending": end_truth}))
    return [p.with_suffix(".pcm") for p in wavs], op_truth, end_truth


def make_library(n_eps: int, seed: int = LIB_SEED, n_hashes: int = LIB_HASHES):
    """bench.py's search_only_config(n_eps, n_shows=20) library: (FrameHashes
    list, planted (start s, end s) of each episode's shared run). Episode
    e belongs to show e % 20."""
    rng = np.random.default_rng(seed)
    shareds = [rng.integers(0, 2**32, size=LIB_RUN, dtype=np.uint32)
               for _ in range(LIB_SHOWS)]
    ts = (TS0_NS + np.arange(n_hashes) * HASH_STEP_NS).astype(np.int64)
    fhs, truth = [], []
    for e in range(n_eps):
        h = rng.integers(0, 2**32, size=n_hashes, dtype=np.uint32)
        at = 40 + (e % 11) * 60
        h[at : at + LIB_RUN] = shareds[e % LIB_SHOWS]
        fhs.append(FrameHashes(h, ts, np.zeros(0, np.uint32),
                               np.zeros(0, np.int64), Duration.from_millis(300),
                               f"{e:032x}"))
        truth.append((ts[at] / 1e9, ts[at + LIB_RUN - 1] / 1e9))
    return fhs, truth


def run_analyze(paths, device: str):
    return (
        Analyzer.from_files(paths, force=True, device=device)
        .with_include_endings(True)
        .run(Duration.from_secs_f32(np.float32(HASH_DURATION_S)), persist=True)
    )


def recording(cmp: Comparator, last: dict) -> Comparator:
    """Make cmp's searches leave their comparator, frame hashes, pairs and
    per-pair infos in `last`, for the checks after the timed trials."""
    search_pair_infos = cmp.search_pair_infos

    def search_and_keep(frame_hashes, pairs, threading=True):
        infos = search_pair_infos(frame_hashes, pairs, threading)
        last.update(cmp=cmp, fhs=frame_hashes, pairs=pairs, infos=infos)
        return infos

    cmp.search_pair_infos = search_and_keep
    return cmp


def run_search(paths, device: str, last=None):
    cmp = Comparator.from_files(paths, device=device).with_include_endings(True)
    if last is not None:
        recording(cmp, last)
    return cmp.run(analyze=False, display=False, use_skip_files=False,
                   write_skip_files=True)


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _timed(fn, device: str):
    """(fn(), wall s), the card synchronised at both ends."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _stage_delta(before, after):
    """(stage seconds, counts) accumulated between two metrics snapshots."""
    def grew(k):
        return after.get(k, (0.0, 0))[0] - before.get(k, (0.0, 0))[0]

    secs = {k: round(grew(k), 4) for k in STAGE_KEYS if grew(k) > 1e-4}
    counts = {k: int(grew(k)) for k in COUNT_KEYS if grew(k) > 0}
    return secs, counts


def check_hashes(paths, device: str, n: int = 2) -> int:
    """The `.needle.dat` hashes of the first n episodes, as the timed
    analyze wrote them, equal to the canonical host oracle's every
    step_by-th raw hash. Returns the hashes checked."""
    from ..fingerprint.ingest_oracle import ingest_hashes_full_oracle
    from ..fingerprint.torch_impl import IngestDispatcher

    analyzer = Analyzer(paths, device=device).with_include_endings(True)
    checked = 0
    for p in paths[:n]:
        op, op_nv, en, en_nv, rate, ch, _ = analyzer._raw_segments(p)
        stored = FrameHashes.from_path(frame_hash_data_path(p))
        d = IngestDispatcher(rate, ch, device)
        for seg, nv, kept in ((op, op_nv, stored.opening_hashes),
                              (en, en_nv, stored.ending_hashes)):
            n_sub, nf_b = d.lane_geometry(nv)
            want = ingest_hashes_full_oracle(seg, nv, rate, ch, d.dec_factor,
                                             nf_b, n_sub)
            stepped, _ = Analyzer._hashes_with_timestamps(
                want, stored.hash_duration(), None)
            _check(np.array_equal(kept, stepped),
                   f"{p.name}: .needle.dat hashes != the host oracle's")
            checked += len(kept)
    return checked


def check_engine(paths, device: str, n: int = 4) -> int:
    """The torch engine's results on the first n episodes equal to the
    NumPy engine's. Returns the pairs searched."""
    sub = paths[:n]
    fhs = [FrameHashes.from_path(frame_hash_data_path(p)) for p in sub]
    res = [[(r.opening, r.ending)
            for r in c.with_include_endings(True).run_with_frame_hashes(
                fhs, False, False, False)]
           for c in (Comparator(sub, device=device),
                     Comparator(sub, engine="numpy"))]
    _check(res[0] == res[1], "results differ from the NumPy engine's")
    return len(sub) * (len(sub) - 1) // 2


def check_exact(last: dict, pair_ids) -> dict:
    """The last timed search's own RunEntry lists on the pairs `pair_ids`
    (indices into its pair list) equal to the plain NumPy count
    (`reference`); the count at the match threshold + 1, a control, must
    differ from them in some pair, or the comparison is blind. Returns
    the readings."""
    from .reference import mismatched_pairs

    pairs = [last["pairs"][k] for k in pair_ids]
    thr = int(last["cmp"].hash_match_threshold)
    (wrong, n_entries), (control, _) = mismatched_pairs(
        last["cmp"], last["fhs"], pairs, [last["infos"][k] for k in pair_ids],
        (thr, thr + 1))
    _check(not wrong, f"the RunEntry lists of {len(wrong)} of {len(pairs)} "
                      f"pairs differ from the NumPy count (first: pair "
                      f"{pairs[wrong[0]] if wrong else None})")
    _check(bool(control), f"the control (threshold {thr + 1}) differs from "
                          f"the search in no pair: the comparison is blind")
    log(f"exact: the timed search's RunEntry lists of {len(pairs)} pairs "
        f"({n_entries} entries) equal the NumPy count; the control at "
        f"threshold {thr + 1} differs in {len(control)} of them")
    return {"exact_pairs": len(pairs), "exact_entries": n_entries,
            "control_pairs_wrong": len(control)}


def library_pairs(pairs, seed: int):
    """Indices into `pairs` held exactly on a library: EXACT_SAME_SHOW
    pairs of one show (which share a run) and EXACT_OTHER of two, drawn
    from the seed (all of a kind where there are fewer)."""
    rng = np.random.default_rng(seed)
    a = np.asarray(pairs)
    same = a[:, 0] % LIB_SHOWS == a[:, 1] % LIB_SHOWS
    picked = [rng.choice(ix, min(k, len(ix)), replace=False)
              for ix, k in ((np.flatnonzero(same), EXACT_SAME_SHOW),
                            (np.flatnonzero(~same), EXACT_OTHER))]
    return sorted(np.concatenate(picked).tolist())


def busy_share(events, label: str = PROFILE_LABEL):
    """(busy share, device events) from a torch.profiler Chrome trace's
    events: the union of the card's kernel, copy and set intervals over
    the window from the start of the host region `label` to the later of
    its end and the card's last activity."""
    region = max((e for e in events if e.get("name") == label
                  and e.get("cat") != "gpu_user_annotation"),
                 key=lambda e: e["dur"])
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in DEVICE_CATS)
    start = region["ts"]
    end = max([region["ts"] + region["dur"]] + [e for _, e in spans])
    busy, reach = 0.0, start
    for s, e in spans:
        s, e = max(s, reach), min(e, end)
        if e > s:
            busy += e - s
            reach = e
    return busy / (end - start), len(spans)


def device_busy_share(search, device: str):
    """`busy_share` of one `search()` run inside `tracing.device_profile`."""
    saved = os.environ.get("NEEDLE_TPU_PROFILE")
    with tempfile.TemporaryDirectory(prefix="needle_bench_profile_") as d:
        os.environ["NEEDLE_TPU_PROFILE"] = d
        try:
            with device_profile(PROFILE_LABEL, device):
                search()
        finally:
            if saved is None:
                del os.environ["NEEDLE_TPU_PROFILE"]
            else:
                os.environ["NEEDLE_TPU_PROFILE"] = saved
        traces = sorted(Path(d).iterdir())
        _check(len(traces) == 1, f"the profile wrote {len(traces)} traces, not 1")
        events = json.loads(traces[0].read_text())["traceEvents"]
    share, n_events = busy_share(events)
    _check(n_events > 0, "the profiled search ran nothing on the card")
    return share, n_events


def traced_pass(search, device: str) -> dict:
    """Per-layer readings of one search on the card, outside the timed
    trials: the count walk's launches timed by CUDA events, its cells and
    bound; then the card's busy share from a profiled search."""
    from .count_walk import WalkTimer, walk_bound

    with WalkTimer() as timer:
        search()
    out = {}
    if timer.events:
        ms, cells = timer.ms(), timer.cells()
        bound_ms, bound_by = walk_bound(cells, timer.moved)
        out.update(count_walk_ms=round(ms, 4), count_walk_cells=cells,
                   count_walk_bound_ms=round(bound_ms, 4),
                   count_walk_bound_by=bound_by,
                   count_walk_share_of_bound=round(bound_ms / ms, 4))
        log(f"traced: count walk {len(timer.events)} launch(es), kernel "
            f"{ms:.4f} ms (CUDA events), {cells} cells walked, bound "
            f"{bound_ms:.4f} ms (set by {bound_by}), kernel at "
            f"{bound_ms / ms:.4f} of it")
    else:
        log("traced: the search launched no count walk")
    share, n_events = device_busy_share(search, device)
    out.update(device_busy_share=round(share, 4), device_events=n_events)
    log(f"traced: card busy {share:.4f} of the profiled search "
        f"({n_events} kernel, copy and set events)")
    return out


def _trials(passes, trials: int, device: str):
    """The cold pass, then `trials` timed ones. `passes` is a list of
    (name, fn); returns (cold walls, [walls per trial], per-trial record
    of stage seconds, counts and count walk launches, last outputs)."""
    cold, walls = {}, []
    record = {"stages_per_trial_s": [], "counts_per_trial": [],
              "launches_per_trial": []}
    outs = None
    for k in range(trials + 1):
        snap, l0 = metrics.snapshot(), diag_runs.LAUNCHES
        outs, wall = {}, {}
        for name, fn in passes:
            outs[name], wall[name] = _timed(fn, device)
        secs, cnt = _stage_delta(snap, metrics.snapshot())
        launched = diag_runs.LAUNCHES - l0
        label = "cold pass" if k == 0 else f"trial {k}"
        log(f"{label}: " + ", ".join(f"{n} {w:.4f} s" for n, w in wall.items())
            + f", total {sum(wall.values()):.4f} s; count walk launches "
            f"{launched}")
        log(f"{label} stage seconds: {json.dumps(secs)}; counts "
            f"{json.dumps(cnt)}")
        if k == 0:
            cold = wall
            continue
        walls.append(wall)
        for key, v in zip(record, (secs, cnt, launched)):
            record[key].append(v)
    return cold, walls, record, outs


def season_config(spec: Season, args, device: str):
    n = spec.episodes
    return analyze_and_search(
        lambda: build_season(spec, args.seed, args.season_dir),
        f"analyze+search wall, {n}-ep season ({spec.episode_secs:g} s/ep), "
        f"{n * (n - 1) // 2} pairs", BASELINE_TOTAL_S, args, device)


def small3_config(spec: Season, args, device: str):
    n = spec.episodes
    return analyze_and_search(
        lambda: build_small3(spec, args.seed, args.season_dir),
        f"analyze+search wall, {n} x {spec.episode_secs / 60:g}-min "
        f"pre-decoded 16 kHz PCM episodes, {n * (n - 1) // 2} pairs",
        SMALL3_BASELINE_S, args, device)


def analyze_and_search(build, metric: str, baseline_s: float, args,
                       device: str):
    """The season's flow on the files `build()` gives (paths, opening
    truth, ending truth): into the page cache, the cold pass and timed
    trials of analyze then search, the checks; (head, detail, search),
    with `value` the median analyze + search wall and `vs_baseline` its
    share of `baseline_s`."""
    t0 = time.perf_counter()
    paths, op_truth, end_truth = build()
    for p in paths:  # into the page cache, as bench.py:875-882
        with open(p, "rb") as f:
            while f.read(1 << 22):
                pass
    n = len(paths)
    pairs = n * (n - 1) // 2
    log(f"season: {n} x {paths[0].suffix} episodes ready in "
        f"{time.perf_counter() - t0:.1f} s")
    last = {}
    cold, walls, record, outs = _trials(
        [("analyze", lambda: run_analyze(paths, device)),
         ("search", lambda: run_search(paths, device, last))], args.trials,
        device)
    results = outs["search"]
    launches = record["launches_per_trial"]

    acc = accuracy(results, op_truth, end_truth)
    _check(len(results) == n and acc == 1.0,
           f"accuracy {acc} over {len(results)} results of {n} episodes")
    exact = check_exact(last, range(pairs))
    hashes = check_hashes(paths, device)
    engine_pairs = check_engine(paths, device)
    if device == "cuda":
        _check(all(launches), f"a trial's search launched no count walk: {launches}")
    log(f"checks: accuracy {acc}; {hashes} hashes of 2 episodes bit-exact "
        f"against the host oracle; the results of {engine_pairs} pairs equal "
        f"to the NumPy engine's")

    a = [w["analyze"] for w in walls]
    s = [w["search"] for w in walls]
    totals = [x + y for x, y in zip(a, s)]
    head = {
        "metric": metric,
        "value": round(statistics.median(totals), 4),
        "unit": "s",
        "vs_baseline": round(statistics.median(totals) / baseline_s, 4),
        "value_min": round(min(totals), 4),
        "analyze_s": round(statistics.median(a), 4),
        "search_s": round(statistics.median(s), 4),
        "cold_analyze_s": round(cold["analyze"], 4),
        "cold_search_s": round(cold["search"], 4),
        "accuracy_vs_truth": acc,
        **exact,
        "pairs_per_sec": round(pairs / statistics.median(s), 1),
        "trials_s": [round(t, 4) for t in totals],
    }
    record.update(analyze_trials_s=[round(t, 4) for t in a],
                  search_trials_s=[round(t, 4) for t in s])
    return head, record, lambda: run_search(paths, device)


def library_config(n_eps: int, args, device: str):
    fhs, truth = make_library(n_eps, args.seed, args.lib_hashes)
    pairs = n_eps * (n_eps - 1) // 2
    last = {}
    cmp = recording(Comparator.from_files(
        [f"ep{k:04}.mkv" for k in range(n_eps)], device=device), last)

    def search():
        return cmp.run_with_frame_hashes(fhs, display=False, use_skip_files=False,
                                         write_skip_files=False)

    log(f"library: {n_eps} episodes x {args.lib_hashes} hashes, {LIB_SHOWS} "
        f"shows, {pairs} pairs")
    cold, walls, record, outs = _trials([("search", search)], args.trials,
                                        device)
    results = outs["search"]
    acc = accuracy(results, truth, [None] * n_eps)
    _check(len(results) == n_eps and acc == 1.0,
           f"accuracy {acc} over {len(results)} results of {n_eps} episodes")
    exact = check_exact(last, library_pairs(last["pairs"], args.seed))
    log(f"checks: all {n_eps} openings within {TRUTH_TOL_S:g} s of their "
        f"planted runs")

    s = [w["search"] for w in walls]
    head = {
        "metric": f"search-only wall, {n_eps}-episode {LIB_SHOWS}-show "
                  f"library, {pairs} pairs",
        "value": round(statistics.median(s), 4),
        "unit": "s",
        "vs_baseline": round(statistics.median(s)
                             / (BASELINE_SEARCH_S * pairs / BASELINE_PAIRS), 4),
        "value_min": round(min(s), 4),
        "search_s": round(statistics.median(s), 4),
        "cold_search_s": round(cold["search"], 4),
        "accuracy_vs_truth": acc,
        **exact,
        "pairs_per_sec": round(pairs / statistics.median(s), 1),
        "episodes_matched": len(results),
        "trials_s": [round(t, 4) for t in s],
    }
    for k in ("search.direct_items", "search.prefilter_skipped"):
        head[k] = statistics.median_low(
            [c.get(k, 0) for c in record["counts_per_trial"]])
    return head, record, search


def _config(name: str):
    """--config value -> episodes of a library, "small3", or None for the
    season."""
    if name == "season":
        return None
    if name == "small3":
        return name
    m = re.fullmatch(r"mixed(\d*)", name)
    if m is None:
        raise argparse.ArgumentTypeError(
            f"unknown config {name!r}: season, small3 or mixedN")
    return int(m[1]) if m[1] else 1000


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m needle_tpu_torch.bench.run")
    ap.add_argument("--config", type=_config, default="season",
                    help="season (default), small3 or mixedN")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--seed", type=int, default=None,
                    help=f"default {SEED} for the season and small3, "
                         f"{LIB_SEED} for a library")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--season-dir", default=None,
                    help="where the season's or small3's files are "
                         "(written if missing)")
    sizes = ap.add_argument_group("sizes (for small runs on the CPU)")
    sizes.add_argument("--episodes", type=int)
    sizes.add_argument("--episode-secs", type=float)
    sizes.add_argument("--opening-secs", type=float)
    sizes.add_argument("--ending-secs", type=float)
    sizes.add_argument("--lib-hashes", type=int, default=LIB_HASHES,
                       help="hashes per library episode")
    args = ap.parse_args(argv)
    if args.trials < 1:
        ap.error("--trials must be at least 1")
    if args.seed is None:
        args.seed = LIB_SEED if isinstance(args.config, int) else SEED
    return args


def run(argv=None):
    """Run the benchmark; returns (detail, headline). Raises SystemExit
    when there is no card for --device cuda or a check fails."""
    args = parse_args(argv)
    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: --device cuda, but torch.cuda.is_available() "
                         "is False")
    from ..parity import card_line

    card = card_line(torch.device(device))
    log(f"card: {card}" if device == "cuda" else "device: cpu")
    if isinstance(args.config, int):
        config = f"mixed{args.config}"
        head, detail, search = library_config(args.config, args, device)
    else:
        config = args.config or "season"
        sizes = {k: getattr(args, k) for k in
                 ("episodes", "episode_secs", "opening_secs", "ending_secs")}
        spec = dataclasses.replace(
            SMALL3 if config == "small3" else Season(),
            **{k: v for k, v in sizes.items() if v is not None})
        flow = small3_config if config == "small3" else season_config
        head, detail, search = flow(spec, args, device)
    stages = detail["stages_per_trial_s"]
    head["count_walk_launches"] = statistics.median_low(
        detail["launches_per_trial"])
    head["stages_s"] = {
        k: round(statistics.median(s.get(k, 0.0) for s in stages), 4)
        for k in STAGE_KEYS if any(k in s for s in stages)}
    head.update(trials=args.trials, seed=args.seed, config=config)
    if device == "cuda":
        head.update(traced_pass(search, device))
    head["device"] = card
    return {"detail_for": head["metric"], **detail}, head


def main(argv=None) -> int:
    detail, head = run(argv)
    print(json.dumps(detail), flush=True)
    print(json.dumps(head), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
