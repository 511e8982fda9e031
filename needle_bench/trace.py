"""The traced passes of a `--trace 1` run, after the window.

`timed_walk`: one pass with CUDA events around every launch of the count
walk (the port's `search.torch_impl.batch_counts`, wrapped from outside),
and each launch's lane lengths kept to count its work (`roofline`).

`profiled`: a few whole passes inside torch.profiler (CPU and CUDA), with
each of the port's host spans (`tracing.span`) entered as a profiler
annotation too. From its Chrome trace: the seconds in which the card ran a
kernel, copy or set (the union of their intervals), the profiled wall, the
card's operations that took most time, and its idle time by the innermost
host span open at the time.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

from . import roofline

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
REGION = "needle_bench.profiled"


class WalkTimer:
    """Context manager around passes on the card: times every count walk
    launch with CUDA events (no synchronisation inside the pass) and keeps
    each launch's lane lengths and row-block masks."""

    def __enter__(self):
        import torch
        from needle_tpu_torch.search import torch_impl

        self.events, self.launches = [], []
        self._module, self._real = torch_impl, torch_impl.batch_counts

        def counts(nv, mv, lm, thr, src, dst, n_pad, bm=None):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._real(nv, mv, lm, thr, src, dst, n_pad, bm=bm)
            end.record()
            self.events.append((start, end))
            self.launches.append((nv, mv, bm))
            return out

        torch_impl.batch_counts = counts
        return self

    def __exit__(self, *exc):
        self._module.batch_counts = self._real

    def reading(self):
        """{"kernel_s", "cells", "bytes", "banded", "launches"} of the timed
        launches, or None where there were none (see launch_sides)."""
        import torch

        if not self.events:
            return None
        torch.cuda.synchronize()
        kernel_s = sum(s.elapsed_time(e) for s, e in self.events) / 1e3
        sides, banded = [], False
        for nv, mv, bm in self.launches:
            lanes, band = launch_sides(nv.cpu().numpy(), mv.cpu().numpy(),
                                       None if bm is None else bm.cpu().numpy())
            sides += lanes
            banded |= band
        cells, moved = roofline.walk_all_work(sides)
        return {"kernel_s": kernel_s, "cells": cells, "bytes": moved,
                "banded": banded, "launches": len(self.events)}


def launch_sides(nv, mv, bm):
    """([(n, m)] of a launch's lanes that are pairs, whether it is banded).
    Padding lanes carry the mask 0; on the walk-all route every other lane
    carries the same full mask, on a band route they differ."""
    live = nv > 0 if bm is None else (bm != 0).any(axis=1)
    banded = bm is not None and bool(live.any() and (bm[live] != bm[live][0]).any())
    return list(zip(nv[live].tolist(), mv[live].tolist())), banded


def timed_walk(run_pass):
    """WalkTimer's reading of one run_pass()."""
    with WalkTimer() as timer:
        run_pass()
    return timer.reading()


@contextlib.contextmanager
def _spans_annotated():
    """Enter every span of the port's tracing as a profiler annotation."""
    from torch.profiler import record_function
    from needle_tpu_torch import tracing

    real = tracing.span

    @contextlib.contextmanager
    def span(name, **fields):
        with record_function(name), real(name, **fields):
            yield

    tracing.span = span
    try:
        yield
    finally:
        tracing.span = real


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read_trace(events, top: int = 10) -> dict:
    """Busy and idle seconds of the card over the REGION annotation of a
    Chrome trace's events."""
    region = max((e for e in events if e.get("name") == REGION
                  and e.get("cat") == "user_annotation"), key=lambda e: e["dur"])
    w0, w1 = region["ts"], region["ts"] + region["dur"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy = _union((max(w0, e["ts"]), min(w1, e["ts"] + e["dur"])) for e in device)
    busy_us = sum(e - s for s, e in busy)
    by_op = {}
    for e in device:
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + e["dur"] / 1e6
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e.get("name") != REGION),
                   key=lambda s: s[0])
    idle, reach = {}, w0
    for s, e in busy + [[w1, w1]]:
        if s > reach:
            mid = (reach + s) / 2
            open_ = [sp for sp in spans if sp[0] <= mid < sp[1]]
            name = open_[-1][2] if open_ else "outside the port's spans"
            idle[name] = idle.get(name, 0.0) + (s - reach) / 1e6
        reach = max(reach, e)
    order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": order(by_op), "idle_gaps": order(idle),
            "device_events": len(device)}


def profiled(run_pass, passes: int) -> dict:
    """read_trace() of `passes` run_pass() calls inside torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="needle_bench_trace_") as d:
        with _spans_annotated(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(REGION):
                for _ in range(passes):
                    run_pass()
                torch.cuda.synchronize()
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return read_trace(events)
