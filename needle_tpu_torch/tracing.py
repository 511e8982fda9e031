"""Structured tracing, span timing, and device profiling (the port's copy
of needle_tpu/tracing.py, with its profiler hook on torch.profiler and a
span recorder of its own).

The reference uses the `tracing` crate: spans around `process_frames`
(analyzer.rs:164-165), `run` (analyzer.rs:332-333) and
`find_opening_and_ending` (comparator.rs:257), debug events throughout, and a
CLI-installed FmtSubscriber at INFO (main.rs:255-259). Here:

  * `span(name, **fields)` — a timed span; enter/exit logged at DEBUG with
    wall duration, and the duration recorded in the process-wide metrics
    registry (the per-stage timing the reference lacks).
  * `pass_span(name, **fields)` — the root span of one pass (`analyze`,
    `search`): while the recorder is on, it gives the spans under it a
    process-wide pass id; inside another pass it is an ordinary span.
  * `carry(fn)` — fn, to be run on another thread as a child of the
    caller's open span (the read pool, the rescan worker).
  * `install_cli_subscriber()` — CLI log setup mirroring the reference's
    INFO-level subscriber; NEEDLE_TPU_LOG=debug logs every span.
  * `device_profile(label, device)` — wraps a region in a
    `torch.profiler.profile` (CPU activity, plus CUDA on a card) when
    NEEDLE_TPU_PROFILE=<dir> is set, and writes a Chrome trace of it there
    (`<label>.<pid>.pt.trace.json`); the CLI wraps analyze and search in
    it, as needle_tpu's does. While it is active every span of every
    thread is recorded (start, end, thread, span, parent and pass ids),
    and the records join the trace as "X" events on the trace's clock.
  * `metrics` / `report_metrics()` — per-stage wall-time accumulators,
    printed when NEEDLE_TPU_TIMINGS=1; counters (`metrics.record(name,
    value)`) share them, and the collector's pauses arrive as `gc.pause_s`
    and `gc.collections`.

The stage names are needle_tpu's (`search.prefilter`, `ingest.rescan`,
...), so timings of the two packages read alike.
"""

from __future__ import annotations

import contextlib
import contextvars
import gc
import itertools
import json
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
        # the collector's [seconds, collections], written by _gc_hook alone:
        # a collection can start inside record(), so the hook takes no lock
        self._gc = [0.0, 0]

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self._totals[name] += seconds
            self._counts[name] += 1

    def snapshot(self) -> Dict[str, Tuple[float, int]]:
        with self._lock:
            snap = {k: (self._totals[k], self._counts[k]) for k in self._totals}
        pause_s, collections = self._gc
        if collections:
            snap["gc.pause_s"] = (pause_s, collections)
            snap["gc.collections"] = (float(collections), collections)
        return snap

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()
            self._counts.clear()
            self._gc = [0.0, 0]


metrics = _Metrics()


class _Recorder:
    """Every span of every thread while a device profile is active: (name,
    start ns, end ns, native thread id, thread name, span id, parent span
    id, pass id, fields), on `time.perf_counter_ns`'s clock."""

    def __init__(self):
        self.records: list = []

    def add(self, name, t0, t1, span_id, parent, pass_id, fields) -> None:
        self.records.append((name, t0, t1, threading.get_native_id(),
                             threading.current_thread().name, span_id, parent,
                             pass_id, fields))


# the active recorder, or None: the one check the unrecorded path makes
_recorder = None
# (innermost open span id, pass id) of this thread's context, kept only
# while a recorder is on
_open = contextvars.ContextVar("needle_tpu_torch_open_span", default=(None, None))
_span_ids = itertools.count(1)
_pass_ids = itertools.count(1)


@contextlib.contextmanager
def span(name: str, **fields):
    """Timed span: DEBUG logs on enter/exit, duration into `metrics`, and
    one record (with its parent and pass ids) while a recorder is on."""
    debug = logger.isEnabledFor(logging.DEBUG)
    if debug:
        if fields:
            detail = " ".join(f"{k}={v}" for k, v in fields.items())
            logger.debug("%s{%s}: enter", name, detail)
        else:
            logger.debug("%s: enter", name)
    rec = _recorder
    if rec is None:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            metrics.record(name, dt)
            if debug:
                logger.debug("%s: exit (%.3fs)", name, dt)
        return
    parent, pass_id = _open.get()
    span_id = next(_span_ids)
    token = _open.set((span_id, pass_id))
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        t1 = time.perf_counter_ns()
        _open.reset(token)
        dt = (t1 - t0) / 1e9
        metrics.record(name, dt)
        rec.add(name, t0, t1, span_id, parent, pass_id, fields)
        if debug:
            logger.debug("%s: exit (%.3fs)", name, dt)


@contextlib.contextmanager
def pass_span(name: str, **fields):
    """The root span of a pass: with a recorder on, the spans under it (on
    any thread it carries work to) get a new process-wide pass id; inside
    another pass it keeps that pass's id, and it is `span` otherwise."""
    if _recorder is None or _open.get()[1] is not None:
        with span(name, **fields):
            yield
        return
    token = _open.set((_open.get()[0], next(_pass_ids)))
    try:
        with span(name, **fields):
            yield
    finally:
        _open.reset(token)


def carry(fn):
    """fn, to be run on another thread as a child of the caller's open span
    and in its pass; fn itself while no recorder is on."""
    if _recorder is None:
        return fn
    ctx = contextvars.copy_context()
    # a Context runs on one thread at a time: each call gets its own copy
    return lambda *args, **kw: ctx.copy().run(fn, *args, **kw)


_gc_start_ns = [0]


def _gc_hook(phase: str, info: dict) -> None:
    """gc.callbacks hook: the collector's pauses into `metrics` (as
    gc.pause_s and gc.collections) and, while a recorder is on, as
    `gc.collect` records under the span the collection interrupted."""
    if phase == "start":
        _gc_start_ns[0] = time.perf_counter_ns()
        return
    t0, t1 = _gc_start_ns[0], time.perf_counter_ns()
    totals = metrics._gc
    totals[0] += (t1 - t0) / 1e9
    totals[1] += 1
    rec = _recorder
    if rec is not None:
        parent, pass_id = _open.get()
        rec.add("gc.collect", t0, t1, next(_span_ids), parent, pass_id,
                {"generation": info["generation"]})


gc.callbacks.append(_gc_hook)


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
def device_profile(label: str = "needle_tpu_torch", device="cuda"):
    """torch.profiler trace of a region, gated on NEEDLE_TPU_PROFILE=<dir>:
    the region runs inside `record_function(label)`, and its Chrome trace
    (kernels launched through ctypes included: the profiler records every
    kernel of the process's CUDA context) is written to
    <dir>/<label>.<pid>.pt.trace.json. `device` is where the region runs
    (the card unless the caller asks for the CPU, as every entry of the
    port); a cuda device adds the CUDA activity. Inside the region every
    span of every thread is recorded, and the records are added to the
    trace (`_add_records`); torch.profiler itself keeps the annotations of
    the thread that started it only. Yields the recorder. Unset, it does
    nothing and yields None."""
    global _recorder
    profile_dir = os.environ.get("NEEDLE_TPU_PROFILE")
    if not profile_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    rec = _Recorder()
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        t1 = time.perf_counter()
        # the annotation's start lies in `enter`, its end in `leave`
        before = time.perf_counter_ns()
        with record_function(label):
            enter = (before, time.perf_counter_ns())
            _recorder = rec
            try:
                yield rec
            finally:
                _recorder = None
                leaving = time.perf_counter_ns()
        leave = (leaving, time.perf_counter_ns())
        if on_card:
            torch.cuda.synchronize()
        t2 = time.perf_counter()
    os.makedirs(profile_dir, exist_ok=True)
    name = "_".join(label.split()) or "profile"
    path = os.path.join(profile_dir, f"{name}.{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    _add_records(path, label, rec.records, enter, leave)
    # what the profiler costs around the region, for reading its walls
    logger.info(
        "device profile written to %s (region %.3f s, %d spans of %d threads; "
        "profiler start %.3f s, stop and export %.3f s)", path, t2 - t1,
        len(rec.records), len({r[3] for r in rec.records}), t1 - t0,
        time.perf_counter() - t2,
    )


def _add_records(path: str, label: str, records: list, enter: tuple,
                 leave: tuple) -> None:
    """Write the recorder's records into the Chrome trace at `path`: each an
    "X" event (category "span") on its thread's tid, with its span, parent
    and pass ids and its fields in args. The clocks are tied at the
    region's annotation: its start, traced by the profiler, lies between
    the two perf_counter_ns readings of `enter`, its end between those of
    `leave`; the tighter pair anchors the host clock, so every record lands
    inside the region, at most that pair's width late or early. The
    trace's "needleSpans" key says which anchor and how wide."""
    with open(path) as f:
        try:
            trace = json.load(f)
        except json.JSONDecodeError:
            logger.warning("no spans added: %s is not a Chrome trace", path)
            return
    events = trace.get("traceEvents", [])
    regions = [e for e in events
               if e.get("name") == label and e.get("cat") == "user_annotation"]
    if not regions:
        logger.warning("no spans added: %s holds no annotation %r", path, label)
        return
    region = max(regions, key=lambda e: e["dur"])
    if enter[1] - enter[0] <= leave[1] - leave[0]:
        anchor, host_ns, width = "start", enter[1], enter[1] - enter[0]
        ts_ns = region["ts"] * 1e3
    else:
        anchor, host_ns, width = "end", leave[0], leave[1] - leave[0]
        ts_ns = (region["ts"] + region["dur"]) * 1e3
    pid = region["pid"]
    named = {e["tid"] for e in events if e.get("name") == "thread_name"}
    threads = {}
    for name, t0, t1, tid, thread, span_id, parent, pass_id, fields in records:
        threads[tid] = thread
        args = {k: v if isinstance(v, (bool, int, float, str)) else str(v)
                for k, v in fields.items()}
        args.update({"span": span_id, "parent": parent, "pass": pass_id,
                     "thread": thread})
        events.append({"ph": "X", "cat": "span", "name": name, "pid": pid,
                       "tid": tid, "ts": round((ts_ns + t0 - host_ns) / 1e3, 3),
                       "dur": round((t1 - t0) / 1e3, 3), "args": args})
    events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": thread}}
               for tid, thread in threads.items() if tid not in named]
    trace["traceEvents"] = events
    trace["needleSpans"] = {
        "records": len(records), "anchor": anchor, "anchor_width_us": width / 1e3,
        "region_host_us": (leave[0] - enter[1]) / 1e3, "region_trace_us": region["dur"]}
    with open(path, "w") as f:
        json.dump(trace, f)


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
