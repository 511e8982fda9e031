"""Structured tracing, span timing, and device profiling (the port's copy
of needle_tpu/tracing.py, with its profiler hook on torch.profiler).

The reference uses the `tracing` crate: spans around `process_frames`
(analyzer.rs:164-165), `run` (analyzer.rs:332-333) and
`find_opening_and_ending` (comparator.rs:257), debug events throughout, and a
CLI-installed FmtSubscriber at INFO (main.rs:255-259). Here:

  * `span(name, **fields)` — a timed span; enter/exit logged at DEBUG with
    wall duration, and the duration recorded in the process-wide metrics
    registry (the per-stage timing the reference lacks).
  * `install_cli_subscriber()` — CLI log setup mirroring the reference's
    INFO-level subscriber; NEEDLE_TPU_LOG=debug logs every span.
  * `device_profile(label, device)` — wraps a region in a
    `torch.profiler.profile` (CPU activity, plus CUDA on a card) when
    NEEDLE_TPU_PROFILE=<dir> is set, and writes a Chrome trace of it there
    (`<label>.<pid>.pt.trace.json`); the CLI wraps analyze and search in
    it, as needle_tpu's does.
  * `metrics` / `report_metrics()` — per-stage wall-time accumulators,
    printed when NEEDLE_TPU_TIMINGS=1.

The stage names are needle_tpu's (`search.prefilter`, `ingest.rescan`,
...), so timings of the two packages read alike.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Tuple

logger = logging.getLogger("needle_tpu_torch")


class _Metrics:
    """Process-wide per-stage wall-time accumulators (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self._totals[name] += seconds
            self._counts[name] += 1

    def snapshot(self) -> Dict[str, Tuple[float, int]]:
        with self._lock:
            return {k: (self._totals[k], self._counts[k]) for k in self._totals}

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()
            self._counts.clear()


metrics = _Metrics()


@contextlib.contextmanager
def span(name: str, **fields):
    """Timed span: DEBUG logs on enter/exit, duration into `metrics`."""
    if fields:
        detail = " ".join(f"{k}={v}" for k, v in fields.items())
        logger.debug("%s{%s}: enter", name, detail)
    else:
        logger.debug("%s: enter", name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        metrics.record(name, dt)
        logger.debug("%s: exit (%.3fs)", name, dt)


def install_cli_subscriber(level: int = logging.INFO) -> None:
    """CLI log format mirroring the reference's tracing FmtSubscriber
    (main.rs:255-259): timestamp, level, target, message."""
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter(
            "%(asctime)s %(levelname)5s %(name)s: %(message)s",
            datefmt="%Y-%m-%dT%H:%M:%S",
        )
    )
    root = logging.getLogger("needle_tpu_torch")
    if not root.handlers:
        root.addHandler(handler)
    root.setLevel(
        logging.DEBUG if os.environ.get("NEEDLE_TPU_LOG") == "debug" else level
    )


@contextlib.contextmanager
def device_profile(label: str = "needle_tpu_torch", device="cpu"):
    """torch.profiler trace of a region, gated on NEEDLE_TPU_PROFILE=<dir>:
    the region runs inside `record_function(label)`, and its Chrome trace
    (kernels launched through ctypes included: the profiler records every
    kernel of the process's CUDA context) is written to
    <dir>/<label>.<pid>.pt.trace.json. `device` is where the region runs;
    a cuda device adds the CUDA activity. Unset, it does nothing."""
    profile_dir = os.environ.get("NEEDLE_TPU_PROFILE")
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        t1 = time.perf_counter()
        with record_function(label):
            yield
        if on_card:
            torch.cuda.synchronize()
        t2 = time.perf_counter()
    os.makedirs(profile_dir, exist_ok=True)
    name = "_".join(label.split()) or "profile"
    path = os.path.join(profile_dir, f"{name}.{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    # what the profiler costs around the region, for reading its walls
    logger.info(
        "device profile written to %s (region %.3f s; profiler start %.3f s, "
        "stop and export %.3f s)", path, t2 - t1, t1 - t0,
        time.perf_counter() - t2,
    )


def report_metrics(force: bool = False) -> None:
    """Print per-stage timings when NEEDLE_TPU_TIMINGS=1 (or force=True)."""
    if not force and os.environ.get("NEEDLE_TPU_TIMINGS") != "1":
        return
    snap = metrics.snapshot()
    if not snap:
        return
    width = max(len(k) for k in snap)
    print("--- needle_tpu stage timings ---")
    for name in sorted(snap, key=lambda k: -snap[k][0]):
        total, count = snap[name]
        print(f"{name:<{width}}  {total:8.3f}s  ({count} calls)")
