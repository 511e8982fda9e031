"""The port on a CUDA card: the hand-written count walk kernel against its
plain PyTorch version, and the search engine, the
prefilter, the fused ingest and the mono fingerprint route on the card
against the same code on the CPU or the numpy oracle; the fused ingest's
dispatches without a synchronisation, from page-locked slots; the exact
rescan from the card's own mid-rate windows; the card time of
the fused ingest's kernels (`ingest.kernels_card_s`) and of their source stage
on 48 kHz stereo (`ingest.decimate_card_s`); NEEDLE_TPU_PROFILE's
trace of a search on the card, `parallel.distributed` over NCCL as a
world of one, and the parity harness on every route. These tests need
an NVIDIA GPU and nvcc; elsewhere they skip. This file imports no jax, so
on a machine with a card and without jax it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

INT32_MAX = np.iinfo(np.int32).max


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _t(a, device):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(device)


def _planted_operands(rng, n_pad, chunk, thr_values, lm_values):
    """Random rows with one planted shared run (one flipped bit) per lane,
    nv/mv < n_pad, band masks with gaps on every fourth lane from the
    second, and a padding lane last."""
    from needle_tpu_torch.search import diag_runs as D

    src = rng.integers(0, 2**32, size=(chunk, n_pad), dtype=np.uint32)
    dst = rng.integers(0, 2**32, size=(chunk, n_pad), dtype=np.uint32)
    for p in range(chunk):
        n = int(rng.integers(40, 300))
        s0, d0 = rng.integers(1, n_pad - n, size=2)
        dst[p, d0 : d0 + n] = src[p, s0 : s0 + n]
        dst[p, d0 + n // 3] ^= np.uint32(1)
    nv = rng.integers(n_pad // 2, n_pad + 1, size=chunk).astype(np.int32)
    mv = rng.integers(n_pad // 2, n_pad + 1, size=chunk).astype(np.int32)
    thr = np.asarray(thr_values, np.int32)[np.arange(chunk) % len(thr_values)]
    lm = np.asarray(lm_values, np.int32)[np.arange(chunk) % len(lm_values)]
    bm = np.full((chunk, D.n_groups_for(n_pad)), D.full_block_mask(n_pad), np.int32)
    bm[1::4] &= rng.integers(0, 2**31, size=bm[1::4].shape).astype(np.int32)
    lm[-1], bm[-1] = INT32_MAX, 0  # a padding lane
    return nv, mv, lm, thr, src, dst, bm


def _check_kernel(dev, nv, mv, lm, thr, src, dst, bm, n_pad):
    """batch_counts on the card: one launch, exact against the plain
    version; returns the counts."""
    from needle_tpu_torch.search import diag_runs as D

    args = [_t(a, dev) for a in (nv, mv, lm, thr, src, dst)] + [n_pad, _t(bm, dev)]
    before = D.LAUNCHES
    got = D.batch_counts(*args)
    torch.cuda.synchronize()
    assert D.LAUNCHES == before + 1
    assert torch.equal(got, D.batch_counts_reference(*args))
    return got


@pytest.mark.parametrize(
    "n_pad,chunk,thr_values,lm_values",
    [(512, 5, (10, 0), (1, 30)), (2560, 64, (10, 0), (1, 30)),
     (7168, 3, (10, 0), (1, 30)), (2560, 64, (16, 32, 10), (31, 32, 33, 64)),
     (32768, 2, (10, 0), (1, 30))],
)
def test_kernel_equals_reference(dev, n_pad, chunk, thr_values, lm_values):
    """Exact on planted runs with nv/mv < n_pad, thr 0 and 10, l_min 1,
    band masks with gaps and a padding lane, at every size: 7168 (whose
    two hash rows take more than 48 KB) and 32768 (whose rows would not
    fit in shared memory at all) go through the same tile-by-tile
    staging as 512; at 2560 also thr 16 and 32 (a zero vector matches, so
    only the validity predicate keeps invalid cells out) and l_min 31, 32,
    33 and 64 (runs counted across word edges)."""
    rng = np.random.default_rng(n_pad + chunk + len(thr_values))
    ops = _planted_operands(rng, n_pad, chunk, thr_values, lm_values)
    got = _check_kernel(dev, *ops, n_pad)
    assert int((got > 0).sum()) > 0
    assert not got[-1].any()


@pytest.mark.parametrize("thr", [16, 32])
def test_kernel_short_lanes_at_high_thresholds(dev, thr):
    """n_pad 512, thr 16 or 32: lanes with nv or mv of 0, 1 and 2 (nothing
    or a single row valid), beside full lanes, every l_min of 1, 31, 32, 33
    and 64; exact against the plain version."""
    rng = np.random.default_rng(thr)
    n_pad = 512
    nv, mv, lm, thr_a, src, dst, bm = _planted_operands(
        rng, n_pad, 12, (thr,), (1, 31, 32, 33, 64))
    nv[:6] = [0, 1, 2, 512, 512, 512]
    mv[:6] = [512, 512, 512, 0, 1, 2]
    got = _check_kernel(dev, nv, mv, lm, thr_a, src, dst, bm, n_pad)
    assert not got[[0, 1, 3, 4]].any()
    assert got[6:-1].any()


def test_kernel_run_across_masked_gap(dev):
    """A lane whose only run crosses a masked block: the part before the
    gap counts (l_min 100 <= 1022 rows), the part after starts anew."""
    from needle_tpu_torch.search import diag_runs as D

    rng = np.random.default_rng(3)
    n_pad = 2048
    src = rng.integers(0, 2**32, size=(2, n_pad), dtype=np.uint32)
    dst = rng.integers(0, 2**32, size=(2, n_pad), dtype=np.uint32)
    dst[:, 1:] = src[:, 1:]  # the main diagonal matches on every row
    nv = np.full(2, n_pad, np.int32)
    lm = np.array([100, 600], np.int32)
    thr = np.zeros(2, np.int32)
    bm = np.full((2, D.n_groups_for(n_pad)), D.full_block_mask(n_pad), np.int32)
    bm[:, 0] &= ~np.int32(1 << 2)  # block 2 (rows 1023..1534) masked
    got = _check_kernel(dev, nv, nv, lm, thr, src, dst, bm, n_pad)
    assert got[:, n_pad - 1].tolist() == [2, 1]  # 1022 and 513 rows


def test_kernel_rejects_bad_operands(dev):
    from needle_tpu_torch.search import diag_runs as D

    x = torch.zeros((2, 500), dtype=torch.int32, device=dev)
    s = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        D.batch_counts(s, s, s, s, x, x, 500)  # n_pad not a multiple of 512
    y = torch.zeros((2, 512), dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        D.batch_counts(s, s, s, s, y, y, 512)


def test_engine_on_card_equals_cpu(dev):
    from needle_tpu_torch import Comparator, Duration, FrameHashes

    rng = np.random.default_rng(5)
    shared = rng.integers(0, 2**32, size=120, dtype=np.uint32)
    fhs = []
    for e in range(5):
        h = rng.integers(0, 2**32, size=900 + 37 * e, dtype=np.uint32)
        h[40 + 13 * e : 160 + 13 * e] = shared
        ts = (2600090703 + np.arange(len(h)) * 247619033).astype(np.int64)
        fhs.append(FrameHashes(h, ts, h[::-1].copy(), ts, Duration.from_millis(300),
                               f"{e:032x}"))

    def run(device):
        cmp = Comparator([f"e{k}.wav" for k in range(5)], device=device)
        cmp = cmp.with_include_endings(True)
        infos = cmp.search_pair_infos(fhs, cmp.pair_order(5))
        return [[list(x) for x in (i.src_openings, i.src_endings)] for i in infos]

    assert run("cuda") == run("cpu")


def test_ingest_on_card_equals_oracle(dev):
    from needle_tpu_torch.fingerprint import ingest_oracle as O
    from needle_tpu_torch.fingerprint import torch_impl as T

    rng = np.random.default_rng(11)
    for rate, ch in ((16000, 1), (44100, 2)):
        seg = (rng.standard_normal(rate * ch * 8) * 6000).astype(np.int16)
        got = T.fingerprint_ingest_batch([seg], rate, ch, device="cuda")[0]
        d = T.IngestDispatcher(rate, ch, "cuda")
        n_sub, nf_b = d.lane_geometry(len(seg))
        want = O.ingest_hashes_full_oracle(seg, len(seg), rate, ch, d.dec_factor,
                                           nf_b, n_sub)
        np.testing.assert_array_equal(got, want)
        vals, _, dec, nf_b = T.ingest_classifier_values(seg, rate, ch, device="cuda")
        ref, _ = O.ingest_values_oracle(seg, len(seg), rate, ch, dec, nf_b, len(vals))
        assert np.max(np.abs(vals - ref)) < 5e-6


@pytest.mark.parametrize("rate,channels", [(16000, 1), (48000, 2)])
def test_ingest_rescan_worker_on_card(dev, monkeypatch, rate, channels):
    """Chunks downloaded through pinned memory and rescanned on the worker
    while later chunks run: with every hash flagged, the card's hashes
    equal the inline (threading=False) path's and the oracle's. The rescan
    reads each lane's mid-rate window from the card's own source stage
    output (one window a lane, one fetch a chunk) and prepares none on the
    host."""
    from needle_tpu_torch.fingerprint import ingest_oracle as O
    from needle_tpu_torch.fingerprint import torch_impl as T
    from needle_tpu_torch.tracing import metrics

    monkeypatch.setattr(T, "LANES", 2)
    monkeypatch.setenv("NEEDLE_TPU_EXACT_EPS", "1e30")
    prepared = []
    prepare = O._prepare_mid_window

    def spy(*args, **kw):
        prepared.append(args)
        return prepare(*args, **kw)

    monkeypatch.setattr(O, "_prepare_mid_window", spy)
    rng = np.random.default_rng(13)
    segs = [(rng.standard_normal(rate * channels * s) * 6000).astype(np.int16)
            for s in (5, 25, 6, 25, 9)]
    names = ("ingest.rescan_card_windows", "ingest.rescan_window_bytes",
             "ingest.rescan_fetch")
    before = [metrics.snapshot().get(k, (0.0, 0)) for k in names]
    got = T.fingerprint_ingest_batch(segs, rate, channels, device="cuda")
    (windows, n_w), (nbytes, _), (_, n_fetch) = (
        (a[0] - b[0], a[1] - b[1])
        for a, b in zip([metrics.snapshot()[k] for k in names], before))
    assert prepared == []
    # buckets 160 (5, 6 and 9 s: two chunks) and 224 (25 s: one chunk)
    assert (windows, n_w, n_fetch) == (5, 3, 3) and nbytes > 0
    d = T.IngestDispatcher(rate, channels, "cuda", threading=False)
    for i, s in enumerate(segs):
        d.add(i, s)
    inline = d.finish()
    for i, s in enumerate(segs):
        n_sub, nf_b = d.lane_geometry(len(s))
        want = O.ingest_hashes_full_oracle(s, len(s), rate, channels,
                                           d.dec_factor, nf_b, n_sub)
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(inline[i], want)


def test_ingest_staged_without_a_sync(dev, monkeypatch):
    """Each lane chunk goes to the card without the host waiting: after a
    warm-up, three chunks' dispatches run under set_sync_debug_mode
    ("error"), staged in page-locked slots with no miss, and give the
    oracle's hashes."""
    from needle_tpu_torch.fingerprint import ingest_oracle as O
    from needle_tpu_torch.fingerprint import torch_impl as T
    from needle_tpu_torch.tracing import metrics

    monkeypatch.setattr(T, "LANES", 2)
    monkeypatch.setattr(T, "_staging", T._StagingRing())
    rng = np.random.default_rng(19)
    # buckets 224, 224 (two full chunks) and 192 (a partial one)
    segs = [(rng.standard_normal(16000 * s) * 6000).astype(np.int16)
            for s in (25, 25, 25, 25, 24)]

    def counts():
        snap = metrics.snapshot()
        return [snap.get(k, (0.0, 0))[1]
                for k in ("ingest.staging_hits", "ingest.staging_misses")]

    T.fingerprint_ingest_batch(segs, 16000, 1, device="cuda")  # warm-up
    dispatch = T.IngestDispatcher._dispatch

    def strict(self, nf_b):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(self, nf_b)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    before = counts()
    monkeypatch.setattr(T.IngestDispatcher, "_dispatch", strict)
    try:
        got = T.fingerprint_ingest_batch(segs, 16000, 1, device="cuda")
    finally:
        monkeypatch.setattr(T.IngestDispatcher, "_dispatch", dispatch)
    hits, misses = (a - b for a, b in zip(counts(), before))
    assert (hits, misses) == (3, 0)
    for slot in T._staging._slots:
        assert slot.pinned and slot.raw.is_pinned() and slot.nv.is_pinned()
    d = T.IngestDispatcher(16000, 1, "cuda")
    for g, s in zip(got, segs):
        n_sub, nf_b = d.lane_geometry(len(s))
        want = O.ingest_hashes_full_oracle(s, len(s), 16000, 1, d.dec_factor,
                                           nf_b, n_sub)
        np.testing.assert_array_equal(g, want)


def test_prefilter_on_card_equals_cpu(dev, monkeypatch):
    """Direct items, band masks (episode tiles and per pair) and the pair
    prefilter on the card equal the same calls on the CPU."""
    from needle_tpu_torch.search import prefilter as P

    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_DIRECT", "on")
    rng = np.random.default_rng(17)
    n_eps, n_pad = 24, 1024
    table = rng.integers(0, 2**32, size=(n_eps, n_pad), dtype=np.uint32)
    shared = rng.integers(0, 2**32, size=(3, 200), dtype=np.uint32)
    for e in range(n_eps):
        at = 40 + (e % 11) * 60
        table[e, at : at + 200] = shared[e % 3]
    nv = 960 - 7 * np.arange(n_eps)
    vtab = np.arange(n_pad)[None, :] < nv[:, None]
    vtab[:, 0] = False
    work = [(p, a, b) for p, (a, b) in enumerate(
        (a, b) for a in range(n_eps) for b in range(a + 1, n_eps))]
    slot = {e: e for e in range(n_eps)}

    def run(device):
        tab = _t(table, device)
        vt = torch.from_numpy(vtab).to(device)
        args = (tab, vt, work, slot, lambda p: 81, 10, n_pad)
        rows, offs = P.direct_diag_items(*args)
        out = [rows.cpu().numpy(), offs.cpu().numpy()]
        for dense in ("on", "off"):
            monkeypatch.setenv("NEEDLE_TPU_PREFILTER_DENSE", dense)
            kept, masks, skipped, w = P.prefilter_band_masks(*args)
            out += [kept, masks, skipped, w]
        out.append(P.prefilter_pairs(*args))
        return out

    got, want = run(dev), run("cpu")
    assert len(got[0]) > 0 and got[4] > 0  # items, and pairs skipped
    for g, w in zip(got, want):
        if isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_fingerprint_batch_on_card_equals_numpy(dev):
    from needle_tpu_torch.fingerprint import torch_impl as T
    from needle_tpu_torch.fingerprint.numpy_impl import fingerprint_numpy

    rng = np.random.default_rng(23)
    monos = [(rng.standard_normal(11025 * s) * 5000).astype(np.int16)
             for s in (12, 30, 13)]
    for got, m in zip(T.fingerprint_batch(monos, device="cuda"), monos):
        np.testing.assert_array_equal(got, fingerprint_numpy(m))
    vals, _ = T.classifier_values(monos[0], device="cuda")
    ref, _ = T.classifier_values(monos[0], device="cpu")
    assert np.max(np.abs(vals - ref)) < 5e-6


def test_profile_on_card_holds_the_count_walk(dev, tmp_path, monkeypatch):
    """NEEDLE_TPU_PROFILE on a card: the search's torch.profiler trace holds
    the count walk's kernel events, though it is launched through ctypes."""
    import json

    from needle_tpu_torch.cli import main
    from needle_tpu_torch.testing import make_synthetic_season

    season = tmp_path / "season"
    make_synthetic_season(season, num_episodes=3, episode_secs=60.0,
                          opening_secs=12.0, opening_offset_range=(1.0, 4.0),
                          seed=8)
    monkeypatch.setenv("NEEDLE_TPU_ALLOW_AUDIO", "1")
    assert main(["analyze", "--device", "cuda", str(season)]) == 0
    monkeypatch.setenv("NEEDLE_TPU_PROFILE", str(tmp_path / "prof"))
    assert main(["search", "--min-opening-duration", "5", "--device", "cuda",
                 str(season)]) == 0
    (trace,) = (tmp_path / "prof").iterdir()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" and "diag_runs" in e.get("name", "")
               for e in events)
    assert any(e.get("name") == "needle search" for e in events)


def test_ingest_kernels_timed_on_card(dev, tmp_path, monkeypatch):
    """ingest.kernels_card_s: the card seconds of the fused ingest's
    kernels, read once each chunk's download was waited for; above 0 and
    below the analyze's own wall."""
    import time

    from needle_tpu_torch.analyzer import Analyzer
    from needle_tpu_torch.duration import Duration
    from needle_tpu_torch.testing import make_synthetic_season
    from needle_tpu_torch.tracing import metrics

    paths, _, _ = make_synthetic_season(
        tmp_path / "season", num_episodes=3, episode_secs=60.0,
        opening_secs=12.0, opening_offset_range=(1.0, 4.0), ending_secs=10.0,
        seed=8)
    monkeypatch.setenv("NEEDLE_TPU_ALLOW_AUDIO", "1")
    analyzer = Analyzer.from_files(paths, False, True, device="cuda")
    analyzer.with_include_endings(True)
    hash_duration = Duration.from_secs_f32(np.float32(0.3))
    analyzer.run(hash_duration, False)  # warm-up
    before = metrics.snapshot().get("ingest.kernels_card_s", (0.0, 0))
    torch.cuda.synchronize()
    t = time.perf_counter()
    analyzer.run(hash_duration, False)
    torch.cuda.synchronize()
    analyze_s = time.perf_counter() - t
    total, count = metrics.snapshot()["ingest.kernels_card_s"]
    assert count > before[1]  # one reading a lane chunk
    assert 0 < total - before[0] < analyze_s


def test_source_stage_timed_on_card(dev):
    """ingest.decimate_card_s on 48 kHz stereo lanes (the /4 cascade and the
    downmix): one reading a lane chunk, as ingest.kernels_card_s has, each
    part above 0 and below the chunks' whole kernel time; the hashes are
    the oracle's."""
    from needle_tpu_torch.fingerprint import ingest_oracle as O
    from needle_tpu_torch.fingerprint import torch_impl as T
    from needle_tpu_torch.tracing import metrics

    rng = np.random.default_rng(23)
    segs = [(rng.standard_normal(48000 * 2 * 22) * 6000).astype(np.int16)
            for _ in range(T.LANES + 1)]  # a full chunk and a partial one
    T.fingerprint_ingest_batch(segs, 48000, 2, device="cuda")  # warm-up
    names = ("ingest.decimate_card_s", "ingest.kernels_card_s")
    before = [metrics.snapshot().get(k, (0.0, 0)) for k in names]
    got = T.fingerprint_ingest_batch(segs, 48000, 2, device="cuda")
    after = [metrics.snapshot()[k] for k in names]
    (stage, n_stage), (kernels, n_kernels) = (
        (a[0] - b[0], a[1] - b[1]) for a, b in zip(after, before))
    assert n_stage == n_kernels == 2
    assert 0 < stage < kernels
    d = T.IngestDispatcher(48000, 2, "cuda")
    for g, s in zip(got, segs):
        n_sub, nf_b = d.lane_geometry(len(s))
        want = O.ingest_hashes_full_oracle(s, len(s), 48000, 2, d.dec_factor,
                                           nf_b, n_sub)
        np.testing.assert_array_equal(g, want)


def test_nccl_world_of_one(dev):
    """parallel.distributed over NCCL with one process: the byte all-gather
    round-trips, and distributed_search returns a single-process search's
    results."""
    import socket

    import torch.distributed

    import needle_tpu_torch.parallel.distributed as dist
    from needle_tpu_torch.comparator import Comparator
    from needle_tpu_torch.data import FrameHashes
    from needle_tpu_torch.duration import Duration
    from needle_tpu_torch.parallel import local_device

    rng = np.random.default_rng(6)
    shared = rng.integers(0, 2**32, size=120, dtype=np.uint32)
    fhs = []
    for e in range(3):
        h = rng.integers(0, 2**32, size=600, dtype=np.uint32)
        h[30 + 20 * e : 150 + 20 * e] = shared
        ts = (2600090703 + np.arange(600) * 247619033).astype(np.int64)
        fhs.append(FrameHashes(h, ts, np.zeros(0, np.uint32),
                               np.zeros(0, np.int64), Duration.from_millis(300),
                               f"{e:032x}"))
    videos = [f"e{k}.mkv" for k in range(3)]
    want = Comparator(videos, device="cuda").run_with_frame_hashes(
        fhs, False, False, False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0)
    try:
        assert dist.is_initialized() and dist.process_count() == 1
        assert torch.distributed.get_backend() == "nccl"
        assert dist._allgather_bytes(b"\x00needle") == [b"\x00needle"]
        dist.barrier()
        got = dist.distributed_search(
            Comparator(videos, device=local_device()), fhs)
    finally:
        torch.distributed.destroy_process_group()
    assert [(r.opening, r.ending) for r in got] == [
        (r.opening, r.ending) for r in want]
    assert all(r.opening is not None for r in got)


def test_parity_harness_on_card(dev):
    """needle_tpu_torch.parity on the card: every route (walk-all, band by
    episode tiles and per pair, the pair prefilter at n_pad 16,384, direct
    flagging) taken and RunEntry-exact under the kernel and the plain
    version; value errors and hashes hold."""
    from needle_tpu_torch import parity

    out = parity.run(["--device", "cuda", "--trials", "2", "--eps-seconds", "10"])
    assert out["ok"], out
    assert out["kernels"] == ["kernel", "plain"]
    assert sorted(out["routes"]) == sorted(parity.ROUTES)
    for route, r in out["routes"].items():
        assert r["exact"] and r["taken"], (route, r)
    assert out["routes"]["pair"]["launches"]["kernel"] > 0
