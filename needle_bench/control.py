"""Readings of the comparison that decides `correct`, for its limits: the
program as it runs, and the program with its controls switched on, on
several seeds of one cell, at the cell's own size, in one process.

    python3 -m needle_bench.control --workload <cell> --seeds <n,n,...> [--seconds S]

Controls (each the program's own path, as the configuration states it or
broken in one guarantee):
  threshold+1  the search at the configuration's match threshold + 1, a
               guarantee that the configuration states (every pair's runs
               at threshold 10) broken
  no-rescan    the analyzer without its exact rescan of borderline hashes
               (NEEDLE_TPU_EXACT_EPS=-1): its float32 hashes on the card,
               the precision below the canonical float64 basis

Prints one line per seed and control: the readings of every number, and
`flagged`, the hashes that the analyzer's exact rescan recomputed in one
analyze of the season (0 with the rescan off). The benchmark's own runs
never run a control. Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

from .run import Cell, run_cell


@contextlib.contextmanager
def flagged_counter():
    """Counts the hashes flagged for the exact rescan (the `flagged` field
    of the port's `ingest.rescan` spans) and the analyze calls made."""
    from needle_tpu_torch import tracing

    from .traffic import Session

    seen = {"flagged": 0, "analyzes": 0}
    real_span, real_analyze = tracing.span, Session.analyze

    def span(name, **fields):
        if name == "ingest.rescan":
            seen["flagged"] += int(fields.get("flagged", 0))
        return real_span(name, **fields)

    def analyze(self):
        seen["analyzes"] += 1
        return real_analyze(self)

    tracing.span, Session.analyze = span, analyze
    try:
        yield seen
    finally:
        tracing.span, Session.analyze = real_span, real_analyze


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m needle_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needle_bench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    thr = cell.cfg["threshold"]
    for seed in (int(s) for s in args.seeds.split(",")):
        for control in ("none", "threshold+1", "no-rescan"):
            if control == "no-rescan":
                if "analyze" not in cell.mix["pass"]:
                    continue
                os.environ["NEEDLE_TPU_EXACT_EPS"] = "-1"
            try:
                with flagged_counter() as seen:
                    result = run_cell(
                        cell, seed, args.seconds, False, log=io.StringIO(),
                        threshold=thr + 1 if control == "threshold+1" else None)
            finally:
                os.environ.pop("NEEDLE_TPU_EXACT_EPS", None)
            print(json.dumps({
                "workload": cell.name, "seed": seed, "control": control,
                "correct": result["correct"], "passes": result["attempted"],
                "flagged": seen["flagged"] / max(seen["analyzes"], 1),
                "pass_s": result["metrics"]["pass_s"]["value"],
                **{k: v["value"] for k, v in result["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
