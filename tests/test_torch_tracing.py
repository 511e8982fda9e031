"""The port's tracing (needle_tpu_torch/tracing.py) on the CPU: the spans
and counters of a season's analyze and search, on the WAV and headerless
`.pcm` routes; the span recorder that NEEDLE_TPU_PROFILE turns on, whose
records of every thread join the profiler's Chrome trace with their
pass and parent ids; nothing recorded without a profile; the collector's
pauses; and DEBUG fields formatted only when DEBUG is on."""

import contextlib
import gc
import json
import logging
import sys
import threading

import numpy as np
import pytest

from needle_tpu_torch import constants, ingest, tracing
from needle_tpu_torch.analyzer import Analyzer
from needle_tpu_torch.comparator import Comparator
from needle_tpu_torch.duration import Duration
from needle_tpu_torch.fingerprint import torch_impl as T
from needle_tpu_torch.testing import make_synthetic_season

# spans and counters an analyze and a search leave on the CPU (the card's
# ingest.kernels_card_s aside)
NEW = ("analyze", "search", "analyze.read_wait", "ingest.lane_copy",
       "ingest.lane_copy_faults", "ingest.lane_bytes", "ingest.rescan_hashes",
       "search.load", "search.finalize", "gc.pause_s", "gc.collections")


@pytest.fixture(scope="module")
def season(tmp_path_factory):
    """{"wav": 3 WAV episodes with an opening and an ending, "pcm": their
    samples as headerless 16 kHz mono .pcm}."""
    root = tmp_path_factory.mktemp("season")
    paths, _, _ = make_synthetic_season(
        root / "wav", num_episodes=3, episode_secs=40.0, opening_secs=10.0,
        opening_offset_range=(1.0, 3.0), ending_secs=8.0, seed=21)
    (root / "pcm").mkdir()
    pcms = []
    for p in paths:
        samples, rate, channels, _ = ingest.read_pcm_mmap(p)
        assert (rate, channels) == (16000, 1)
        pcms.append(root / "pcm" / f"{p.stem}.pcm")
        np.asarray(samples).tofile(pcms[-1])
    return {"wav": sorted(paths), "pcm": pcms}


def _analyze(paths, threading_=True):
    return (Analyzer.from_files(paths, False, True, device="cpu")
            .with_include_endings(True)
            .run(Duration.from_secs_f32(np.float32(constants.DEFAULT_HASH_DURATION)),
                 True, threading_))


def _comparator(paths, endings=True):
    return (Comparator.from_files(paths, device="cpu").with_include_endings(endings)
            .with_min_opening_duration(Duration.from_secs(5))
            .with_min_ending_duration(Duration.from_secs(3)))


def _analyze_and_search(paths, threading_=True):
    _analyze(paths, threading_)
    return _comparator(paths).run(False, False, False, True, threading_)


def _delta(before, after):
    """(total, count) of each name recorded between two snapshots."""
    return {k: (v[0] - before.get(k, (0.0, 0))[0], v[1] - before.get(k, (0.0, 0))[1])
            for k, v in after.items() if v[1] > before.get(k, (0.0, 0))[1]}


@contextlib.contextmanager
def _recording(what):
    before = tracing.metrics.snapshot()
    yield what
    what.update(_delta(before, tracing.metrics.snapshot()))


@pytest.fixture
def eager_gc():
    """A young-generation collection every 50 net allocations, so that a
    small pass is sure to see one."""
    thresholds = gc.get_threshold()
    gc.set_threshold(50, *thresholds[1:])
    yield
    gc.set_threshold(*thresholds)


@pytest.mark.parametrize("route", ["wav", "pcm"])
@pytest.mark.parametrize("threading_", [True, False])
def test_a_pass_leaves_every_new_span_and_counter(season, eager_gc, route,
                                                  threading_):
    got = {}
    with _recording(got):
        results = _analyze_and_search(season[route], threading_)
    assert results, "the search found nothing: the pass did not run through"
    assert set(NEW) <= set(got), sorted(set(NEW) - set(got))
    assert "ingest.kernels_card_s" not in got
    assert got["analyze"][1] == 1 and got["search"][1] == 1
    # a read wait per episode; the copy inside the assembly, once a chunk
    assert got["analyze.read_wait"][1] == len(season[route])
    assert got["ingest.lane_copy"][1] == got["ingest.batch_assemble"][1]
    assert got["ingest.lane_copy"][0] <= got["ingest.batch_assemble"][0]
    assert got["gc.collections"][0] == got["gc.collections"][1]


@pytest.mark.parametrize("route", ["wav", "pcm"])
def test_lane_bytes_are_the_windows_valid_bytes(season, route):
    a = (Analyzer.from_files(season[route], False, True, device="cpu")
         .with_include_endings(True))
    want = 0
    for p in season[route]:
        samples, n_open, ending, n_end, _, _, _ = a._raw_segments(p)
        want += (n_open + n_end) * samples.itemsize
    got = {}
    with _recording(got):
        _analyze(season[route])
    assert got["ingest.lane_bytes"][0] == want
    # the lanes' fill: what the upload moves beyond them is padding
    assert want < got["ingest.upload_bytes"][0]


def _noise_segments():
    rng = np.random.default_rng(13)
    return [(rng.standard_normal(16000 * s) * 6000).astype(np.int16)
            for s in (5, 25, 6, 25, 9)]


@pytest.mark.parametrize("eps", [None, "1e30"])
def test_rescan_hashes_are_the_flags_counted(monkeypatch, eps):
    """ingest.rescan_hashes sums the flags of every chunk, as the
    `flagged` fields of ingest.rescan do; a margin of 1e30 flags every
    hash."""
    if eps is not None:
        monkeypatch.setenv("NEEDLE_TPU_EXACT_EPS", eps)
    monkeypatch.setattr(T, "LANES", 2)
    flagged = []
    real = tracing.span

    def spy(name, **kw):
        if name == "ingest.rescan":
            flagged.append(kw["flagged"])
        return real(name, **kw)

    monkeypatch.setattr(tracing, "span", spy)
    got = {}
    with _recording(got):
        out = T.fingerprint_ingest_batch(_noise_segments(), 16000, 1, device="cpu")
    assert got["ingest.rescan_hashes"][0] == sum(flagged)
    assert got["ingest.rescan_hashes"][1] == 3  # one a chunk, flagged or not
    if eps is not None:
        assert sum(flagged) == sum(len(o) for o in out)


def _trace(tmp_path, monkeypatch, label, run):
    """The span events, the region annotation and the whole trace of
    run() under device_profile(label) on the CPU."""
    prof = tmp_path / "prof"
    monkeypatch.setenv("NEEDLE_TPU_PROFILE", str(prof))
    with tracing.device_profile(label, "cpu"):
        run()
    (path,) = prof.iterdir()
    trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    (region,) = [e for e in events if e.get("name") == label
                 and e.get("cat") == "user_annotation"]
    return [e for e in events if e.get("cat") == "span"], region, trace


def _root(by_id, e):
    while e["args"]["parent"] is not None:
        e = by_id[e["args"]["parent"]]
    return e


def test_the_profile_holds_every_thread_s_spans(season, tmp_path, monkeypatch):
    spans, region, trace = _trace(tmp_path, monkeypatch, "needle pass",
                                  lambda: _analyze_and_search(season["pcm"]))
    threads = {e["args"]["thread"] for e in spans}
    assert "MainThread" in threads
    assert any(t.startswith("needle-read") for t in threads), threads
    assert any(t.startswith("needle-rescan") for t in threads), threads
    assert trace["needleSpans"]["records"] == len(spans)
    by_id = {e["args"]["span"]: e for e in spans}
    assert len(by_id) == len(spans)
    roots = [e for e in spans if e["args"]["parent"] is None]
    assert sorted(e["name"] for e in roots) == ["analyze", "search"]
    assert len({e["args"]["pass"] for e in roots}) == 2
    w0, w1 = region["ts"], region["ts"] + region["dur"]
    for e in spans:
        assert e["ph"] == "X" and e["pid"] == region["pid"]
        assert w0 <= e["ts"] and e["ts"] + e["dur"] <= w1, (e, region)
        parent = e["args"]["parent"]
        if parent is not None:
            p = by_id[parent]
            assert p["ts"] <= e["ts"], (e, p)
        if e["name"] != "gc.collect":  # a collection may fall between passes
            assert e["args"]["pass"] == _root(by_id, e)["args"]["pass"]
    # each thread's spans on its own tid, the main thread's on the
    # profiler's own track
    main_tids = {e["tid"] for e in spans if e["args"]["thread"] == "MainThread"}
    assert main_tids == {region["tid"]}
    assert len({e["tid"] for e in spans}) == len(threads)
    # the worker's spans name the dispatch that queued their chunk, the
    # read pool's the analyze.decode that submitted the reads
    worker = [e for e in spans if e["name"] in ("ingest.collect", "ingest.rescan")]
    assert worker and all(
        by_id[e["args"]["parent"]]["name"] == "ingest.dispatch" for e in worker)
    reads = [e for e in spans if e["name"] == "ingest.read_raw"]
    assert len(reads) == 3 and all(
        by_id[e["args"]["parent"]]["name"] == "analyze.decode" for e in reads)
    copies = [e for e in spans if e["name"] == "ingest.lane_copy"]
    assert copies and all(
        by_id[e["args"]["parent"]]["name"] == "ingest.batch_assemble" for e in copies)


def test_a_search_that_analyzes_nests_the_analyze_pass(season, tmp_path, monkeypatch):
    spans, _, _ = _trace(
        tmp_path, monkeypatch, "needle search",
        # the analyze of a search takes no endings
        lambda: _comparator(season["wav"], False).run(True, False, False, False))
    by_id = {e["args"]["span"]: e for e in spans}
    (search,) = [e for e in spans if e["name"] == "search"]
    (analyze,) = [e for e in spans if e["name"] == "analyze"]
    assert search["args"]["parent"] is None
    assert analyze["args"]["parent"] == search["args"]["span"]
    assert analyze["args"]["pass"] == search["args"]["pass"]
    assert {e["args"]["pass"] for e in spans if e["name"] != "gc.collect"} == {
        search["args"]["pass"]}
    assert not [e for e in spans if e["name"] == "search.load"]
    assert {"search.pairs", "search.finalize", "ingest.dispatch"} <= {
        e["name"] for e in spans if _root(by_id, e) is search}


def test_nothing_is_recorded_without_a_profile(tmp_path, monkeypatch):
    monkeypatch.delenv("NEEDLE_TPU_PROFILE", raising=False)
    with tracing.device_profile("off", "cpu") as rec:
        assert rec is None and tracing._recorder is None
        with tracing.pass_span("p"), tracing.span("a"):
            assert tracing._open.get() == (None, None)
    fn = len
    assert tracing.carry(fn) is fn

    monkeypatch.setenv("NEEDLE_TPU_PROFILE", str(tmp_path))
    with tracing.device_profile("on", "cpu") as rec:
        with tracing.pass_span("p"), tracing.span("a"):
            pass
    names = [r[0] for r in rec.records if r[0] != "gc.collect"]
    assert names == ["a", "p"]
    assert tracing._recorder is None and tracing._open.get() == (None, None)
    n = len(rec.records)
    with tracing.pass_span("p"), tracing.span("b"):
        pass
    assert len(rec.records) == n


def test_spans_of_many_threads_are_all_recorded(tmp_path, monkeypatch):
    """More threads than cores, switching every microsecond: every span is
    recorded and counted once, under the span that carried its work."""
    monkeypatch.setenv("NEEDLE_TPU_PROFILE", str(tmp_path))
    n_threads, n_spans = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = tracing.metrics.snapshot()
        with tracing.device_profile("stress", "cpu") as rec:
            with tracing.pass_span("root"):
                def work():
                    for _ in range(n_spans):
                        with tracing.span("stress.inner"):
                            pass

                with tracing.span("stress.submit"):
                    workers = [threading.Thread(target=tracing.carry(work))
                               for _ in range(n_threads)]
                for w in workers:
                    w.start()
                for w in workers:
                    w.join(timeout=60)
                assert not any(w.is_alive() for w in workers)
        got = _delta(before, tracing.metrics.snapshot())
    finally:
        sys.setswitchinterval(interval)
    inner = [r for r in rec.records if r[0] == "stress.inner"]
    assert len(inner) == got["stress.inner"][1] == n_threads * n_spans
    (submit,) = [r for r in rec.records if r[0] == "stress.submit"]
    (root,) = [r for r in rec.records if r[0] == "root"]
    assert {r[6] for r in inner} == {submit[5]}  # parent: the submitting span
    assert {r[7] for r in inner} == {root[7]}  # pass: the root's
    assert len({r[3] for r in inner}) == n_threads
    assert len({r[5] for r in rec.records}) == len(rec.records)


def test_collections_are_counted():
    before = tracing.metrics.snapshot()
    gc.collect()
    gc.collect()
    got = _delta(before, tracing.metrics.snapshot())
    n = got["gc.collections"][1]
    assert n >= 2 and got["gc.collections"][0] == n
    assert got["gc.pause_s"][1] == n and got["gc.pause_s"][0] > 0


class _Counted:
    formatted = 0

    def __str__(self):
        _Counted.formatted += 1
        return "counted"


def test_fields_are_formatted_only_at_debug(caplog):
    logger = logging.getLogger("needle_tpu_torch")
    level = logger.level
    _Counted.formatted = 0
    try:
        logger.setLevel(logging.INFO)
        with tracing.span("lazy", field=_Counted()):
            pass
        assert _Counted.formatted == 0
        with caplog.at_level(logging.DEBUG, logger="needle_tpu_torch"):
            with tracing.span("lazy", field=_Counted()):
                pass
        assert _Counted.formatted == 1
        assert "lazy{field=counted}: enter" in caplog.text
        assert "lazy: exit" in caplog.text
    finally:
        logger.setLevel(level)
