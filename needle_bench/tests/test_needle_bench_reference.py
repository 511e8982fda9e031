"""The plain reference, the roofline's count and the trace reading, held
against the port (which the reference itself never imports)."""

from __future__ import annotations

import json

import numpy as np
import pytest

from needle_bench import formats, roofline
from needle_bench.data.season import _music_like, write_season
from needle_bench.reference import fingerprint as ref_fp
from needle_bench.reference.files import episode_hashes, needle_dat_bytes
from needle_bench.reference.search import pair_entries, pair_order, votes
from needle_bench.trace import REGION, launch_sides, read_trace

from .conftest import SEED, TINY

CFG = {"opening_window": 0.5, "ending_window": 0.25, "hash_duration_s": 0.3,
       "min_opening_s": 20, "min_ending_s": 20, "threshold": 10}


@pytest.fixture(scope="module")
def season(tmp_path_factory):
    """A tiny season analyzed by the port on the CPU: (paths, the port's
    FrameHashes, the reference's episode_hashes)."""
    from needle_tpu_torch.analyzer import Analyzer
    from needle_tpu_torch.duration import Duration

    d = tmp_path_factory.mktemp("season")
    spec = {**TINY, "opening_offsets": [5.0, 40.0], "rate": 16000, "format": "wav"}
    paths, _, _ = write_season(d, spec, SEED, formats.find("wav"), workers=2)
    fhs = Analyzer.from_files(paths, force=True, device="cpu").with_include_endings(
        True).run(Duration.from_secs_f32(np.float32(0.3)), persist=True)
    wav = formats.load(formats.find("wav"))
    ours = [episode_hashes(p, wav, CFG) for p in paths]
    return paths, fhs, ours


@pytest.mark.parametrize("rate,channels,secs", [(16000, 1, 40.0), (44100, 2, 20.0),
                                                (11025, 1, 20.0), (22050, 1, 20.0)])
def test_lane_hashes_equal_the_ports_oracle(rate, channels, secs):
    from needle_tpu_torch.fingerprint.ingest_oracle import ingest_hashes_full_oracle
    from needle_tpu_torch.fingerprint.torch_impl import IngestDispatcher

    rng = np.random.default_rng(rate + channels)
    x = _music_like(rng, int(secs * rate) * channels, rate)
    seg = np.clip(x * 9000, -32768, 32767).astype(np.int16)
    n_valid = len(seg) - 3 * channels * 1000
    d = IngestDispatcher(rate, channels, "cpu")
    n_sub, nf_b = d.lane_geometry(n_valid)
    assert ref_fp.lane_geometry(n_valid, rate, channels) == (n_sub, nf_b, d.dec_factor)
    want = ingest_hashes_full_oracle(seg, n_valid, rate, channels, d.dec_factor, nf_b, n_sub)
    np.testing.assert_array_equal(ref_fp.lane_hashes(seg, n_valid, rate, channels), want)


def test_needle_dat_bytes_equal_the_analyzers(season):
    paths, _, ours = season
    for p, fh in zip(paths, ours):
        assert p.with_name(p.stem + ".needle.dat").read_bytes() == needle_dat_bytes(fh)


def test_entries_and_votes_equal_the_numpy_engines(season):
    from needle_tpu_torch.comparator import Comparator

    from needle_bench.check import info_entries

    paths, fhs, ours = season
    pairs = pair_order(len(paths))
    for thr in (10, 7):
        cmp = Comparator(paths, engine="numpy").with_include_endings(True) \
            .with_hash_match_threshold(thr)
        infos = cmp.search_pair_infos(fhs, pairs, threading=False)
        entries = [pair_entries(ours[i], ours[j], CFG, thr) for i, j in pairs]
        assert [info_entries(i) for i in infos] == [tuple(map(list, e)) for e in entries]
        assert sum(len(o) + len(e) for o, e in entries) > 0
        results = cmp.run_with_frame_hashes(fhs, False, False, False, threading=False)
        f32 = lambda pair: None if pair is None else tuple(d.as_secs_f32() for d in pair)  # noqa: E731
        want = [{"opening": f32(r.opening), "ending": f32(r.ending)} for r in results]
        assert votes(len(paths), pairs, entries, thr) == want


def test_walk_all_work_equals_a_brute_force_count():
    rng = np.random.default_rng(3)
    sides = [tuple(int(v) for v in rng.integers(0, 40, 2)) for _ in range(30)] + [(0, 5), (1, 1)]
    brute = sum(1 for n, m in sides for i in range(1, n) for j in range(1, m))
    cells, moved = roofline.walk_all_work(sides)
    assert cells == brute
    assert moved == sum(4 * (n + m) + 4 * max(0, n + m - 1) for n, m in sides)
    ops_s, by = roofline.bound_s(10**9, 1)
    assert by == "operations" and ops_s == pytest.approx(64e9 / 1.979e15)


def test_walk_all_work_equals_the_ports_walked_cells(season):
    """On the walk-all route, the launches' lanes hold the pairs' lengths;
    the count equals the port's cell count from lengths and masks."""
    from needle_tpu_torch.bench.count_walk import walked_cells
    from needle_tpu_torch.comparator import Comparator
    from needle_tpu_torch.search import torch_impl

    paths, fhs, _ = season
    launched = []
    real = torch_impl.batch_counts

    def spy(nv, mv, lm, thr, src, dst, n_pad, bm=None):
        launched.append((nv.numpy().copy(), mv.numpy().copy(), bm.numpy().copy(), n_pad))
        return real(nv, mv, lm, thr, src, dst, n_pad, bm=bm)

    torch_impl.batch_counts = spy
    try:
        Comparator(paths, device="cpu").with_include_endings(True).search_pair_infos(
            fhs, pair_order(len(paths)), threading=False)
    finally:
        torch_impl.batch_counts = real
    assert launched
    sides = []
    for nv, mv, bm, n_pad in launched:
        s, banded = launch_sides(nv, mv, bm)
        assert not banded
        assert roofline.walk_all_work(s)[0] == walked_cells(nv, mv, bm, n_pad)
        sides += s
    want = sorted((len(a), len(b)) for i, j in pair_order(len(fhs))
                  for a, b in ((fhs[i].opening_hashes, fhs[j].opening_hashes),
                               (fhs[i].ending_hashes, fhs[j].ending_hashes)))
    assert sorted(sides) == want


def test_launch_sides_sees_a_band():
    nv = np.array([9, 9, 9, 9])
    full = np.array([[3], [3], [3], [0]])
    assert launch_sides(nv, nv, full) == ([(9, 9)] * 3, False)
    assert launch_sides(nv, nv, np.array([[3], [1], [3], [0]]))[1]


def test_read_trace_unions_device_time_and_names_idle_time():
    ev = [
        {"name": REGION, "cat": "user_annotation", "ts": 0, "dur": 100},
        {"name": "analyze.decode", "cat": "user_annotation", "ts": 0, "dur": 60},
        {"name": "ingest.upload", "cat": "user_annotation", "ts": 10, "dur": 10},
        {"name": "k1", "cat": "kernel", "ts": 20, "dur": 20},
        {"name": "k2", "cat": "kernel", "ts": 30, "dur": 20},
        {"name": "Memcpy", "cat": "gpu_memcpy", "ts": 90, "dur": 20},
        {"name": "gone", "cat": "kernel", "ts": 200, "dur": 5},
    ]
    got = read_trace(ev)
    assert got["busy_s"] == pytest.approx(40e-6)  # [20, 50) and [90, 100)
    assert got["window_s"] == pytest.approx(100e-6)
    assert got["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    idle = dict(got["idle_gaps"])
    assert idle["ingest.upload"] == pytest.approx(20e-6)       # [0, 20)
    assert "analyze.decode" not in idle
    assert idle["outside the port's spans"] == pytest.approx(40e-6)  # [50, 90)
    assert json.dumps(got)
