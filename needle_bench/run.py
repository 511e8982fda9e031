"""Run one cell of the benchmark of needle_tpu_torch on the card.

    python3 -m needle_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. One process: it writes the season of the
configuration's shapes from the run's seed under
.bench_cache/needle_bench/<config>/season/ (kept there for the next run of
the same seed), reads it into the page cache, runs the traffic mix's
set-up and one warm-up pass, then passes back to back for --seconds (the
last pass is the one that starts before the deadline, and runs to its
end), then checks what the passes wrote against the plain reference and
prints one JSON line (see README.md). With --trace 1 the line holds the
per-layer metrics, read after the window from its spans and counters and
from traced passes. Once all that is done, and before it prints, it looks
for modules a run must not load.

Everything about a cell is found by name: the cell in BENCHMARK.json,
its configuration in configs/, its traffic mix in traffic/, its season's
format in formats/, each metric's reader in metrics/.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".bench_cache" / "needle_bench"
# the configuration's keys that make its season, before its format's SPEC_KEYS
SEASON_KEYS = ("episodes", "episode_secs", "opening_secs", "opening_offsets",
               "ending_secs", "rate", "format")
# modules a run must not have loaded, compared by whole top-level name,
# and the port's modules that are not the system under test
FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "needle_tpu", "bench")
FORBIDDEN_PORT = ("needle_tpu_torch.bench", "needle_tpu_torch.testing",
                  "needle_tpu_torch.parity")
# the thread pools of the libraries the program uses, fixed for every run
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}
# whole passes profiled by a --trace 1 run: about PROFILE_S seconds of them
PROFILE_S, PROFILE_MIN, PROFILE_MAX = 2.0, 2, 12


class Cell:
    """A cell of BENCHMARK.json with its configuration, mix, season format
    and metrics. `format` is the path of the format's module; `season_spec`
    the configuration's keys that make the season (SEASON_KEYS and the
    format's SPEC_KEYS)."""

    def __init__(self, name: str, bench=ROOT / "BENCHMARK.json", folder=HERE):
        from . import formats, traffic

        spec = json.loads(Path(bench).read_text())
        found = [w for w in spec["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"needle_bench: no workload {name!r} in {bench}")
        self.name, self.spec, self.folder = name, found[0], Path(folder)
        self.cfg = json.loads(
            (self.folder / "configs" / f"{self.spec['config']}.json").read_text())
        self.mix = traffic.load(self.spec["traffic"], self.folder / "traffic")
        self.format = formats.find(self.cfg["format"], self.folder / "formats")
        keys = SEASON_KEYS + tuple(formats.load(self.format).SPEC_KEYS)
        self.season_spec = {k: self.cfg[k] for k in keys}
        mine = lambda m: name in m.get("workloads", [name])  # noqa: E731
        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]

    def reader(self, metric: str):
        path = self.folder / "metrics" / f"{metric}.py"
        mod_spec = importlib.util.spec_from_file_location(
            f"needle_bench.metrics.{metric}", path)
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
        return module.read


def _forbidden_loaded():
    return sorted(k for k in sys.modules
                  if k.split(".")[0] in FORBIDDEN_TOP
                  or any(k == f or k.startswith(f + ".") for f in FORBIDDEN_PORT))


def _cpu_s() -> float:
    """This process's CPU seconds so far, all its threads."""
    import resource

    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def _card_clocks() -> str:
    """The card's clocks, power and temperature as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def _span_totals(before: dict, after: dict) -> dict:
    return {k: v[0] - before.get(k, (0.0, 0))[0] for k, v in after.items()
            if v[1] > before.get(k, (0.0, 0))[1]}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             cache=CACHE, threshold: int = None, log=sys.stderr) -> dict:
    """One run of the cell; returns the result line's object. `threshold`
    replaces the configuration's match threshold in the program's search
    (a control), never in the reference's."""
    from needle_tpu_torch.search import diag_runs
    from needle_tpu_torch.tracing import metrics

    from . import check
    from .data.season import REFERENCE_PREFIX, ensure_season
    from .reference import season_reference
    from .traffic import Session

    cuda = device == "cuda"
    if cuda:
        import torch
    cfg = cell.cfg
    season = Path(cache) / cell.spec["config"] / "season"
    paths, op_truth, en_truth, write_s = ensure_season(
        season, cell.season_spec, seed, cell.format)
    for p in paths:  # into the page cache
        with open(p, "rb") as f:
            while f.read(1 << 24):
                pass
    session = Session(paths, cfg, device, threshold)
    session.run(cell.mix["setup"])
    session.run(cell.mix["pass"])  # warm-up: builds and loads every kernel
    # the benchmark's own writing of its inputs is not the program's set-up
    setup_s = time.perf_counter() - T0 - write_s
    clocks0 = _card_clocks() if cuda else ""
    print(f"set-up {setup_s:.3f} s, and {write_s:.3f} s writing the season of seed "
          f"{seed}; card before the window: {clocks0}", file=log, flush=True)

    def one_pass():
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        steps = session.run(cell.mix["pass"])
        return {"wall_s": time.perf_counter() - t, **steps}

    snap, launches0 = metrics.snapshot(), diag_runs.LAUNCHES
    passes, failed = [], 0
    cpu0 = _cpu_s()
    t_w0 = time.perf_counter()
    deadline = t_w0 + seconds
    while not passes or time.perf_counter() < deadline:
        try:
            passes.append(one_pass())
        except Exception:  # a pass that fails is counted, the run goes on
            failed += 1
            traceback.print_exc(file=log)
            if failed >= 3 and not passes:
                break
    window_s = time.perf_counter() - t_w0
    host = {"cpu_per_wall": (_cpu_s() - cpu0) / window_s}
    if cuda:
        host["card_before"], host["card_after"] = clocks0, _card_clocks()
    print(f"window host {host}", file=log, flush=True)
    walls = sorted(p["wall_s"] for p in passes)
    if walls:
        print(f"window {window_s:.3f} s: {len(passes)} passes, walls min "
              f"{walls[0]:.4f} median {walls[len(walls) // 2]:.4f} p95 "
              f"{walls[max(0, math.ceil(0.95 * len(walls)) - 1)]:.4f} max {walls[-1]:.4f} s; "
              f"first {[round(p['wall_s'], 4) for p in passes[:3]]}", file=log, flush=True)
    rec = {"passes": passes, "window_s": window_s,
           "spans": _span_totals(snap, metrics.snapshot()),
           "launches": diag_runs.LAUNCHES - launches0, "walk": None, "profile": None}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    outputs = check.snapshot_outputs(paths)
    searched = check.searched_entries(session.last)
    if trace and cuda:
        from . import trace as tracing

        rec["walk"] = tracing.timed_walk(lambda: session.run(cell.mix["pass"]))
        n = min(PROFILE_MAX, max(PROFILE_MIN, math.ceil(PROFILE_S * len(passes) / window_s)))
        rec["profile"] = tracing.profiled(lambda: session.run(cell.mix["pass"]), n)
    del session
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = season_reference(paths, cfg, cfg["threshold"], cell.format,
                           cache=season / f"{REFERENCE_PREFIX}.pkl")
    checks = check.compare(outputs, searched, ref)
    misses = check.planted_misses(outputs, list(zip(op_truth, en_truth)),
                                  cfg["truth_tolerance_s"])
    print(f"reference and comparison {time.perf_counter() - t_ref:.3f} s",
          file=log, flush=True)

    n_passes = len(passes)
    if trace:
        metrics_out = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(rec) if n_passes else None
            if value is not None:
                metrics_out[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s,
                  "pass_s": window_s / n_passes if n_passes else None}
        metrics_out = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in cell.end_to_end if values.get(m["name"]) is not None}
    if cuda:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {"correct": bool(n_passes and not failed and all(
                  checks[k] <= check.LIMITS[k] for k in check.LIMITS)),
              "attempted": n_passes + failed, "failed": failed,
              "metrics": metrics_out, "device": dev}
    if rec["profile"]:
        dev.update(busy_s=rec["profile"]["busy_s"], window_s=rec["profile"]["window_s"])
        result["breakdown"] = {k: rec["profile"][k] for k in ("device_ops", "idle_gaps")}
    result["host"] = host
    result["planted_misses"] = misses
    result["checks"] = {k: {"value": checks[k], "limit": check.LIMITS[k]}
                        for k in check.LIMITS}
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m needle_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=None,
                    help="default: the configuration's seed")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds <= 0:
        ap.error("--seconds must be above 0")
    return args


def main(argv=None, bench=ROOT / "BENCHMARK.json", folder=HERE, cache=CACHE,
         device="cuda") -> int:
    """The command. `bench`, `folder`, `cache` and `device` are for tests:
    a run on device "cpu" skips the look for a card."""
    args = parse_args(argv)
    cell = Cell(args.workload, bench, folder)
    os.environ.update(THREADS)  # before numpy and torch start their pools
    import torch

    chips = int(cell.spec.get("chips", 1))
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        print(f"needle_bench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    seed = cell.cfg["seed"] if args.seed is None else args.seed
    result = run_cell(cell, seed, args.seconds, bool(args.trace), device, cache)
    loaded = _forbidden_loaded()  # last: after the reference, checks and readers
    if loaded:
        print(f"needle_bench: modules loaded that a run must not load: {loaded}",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
