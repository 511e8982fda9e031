"""The port on a CUDA card: the hand-written count walk kernel against its
plain PyTorch version and against the previous design (batch_counts_popc),
and the search engine, the
prefilter, the fused ingest and the mono fingerprint route on the card
against the same code on the CPU or the numpy oracle; NEEDLE_TPU_PROFILE's
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
    """batch_counts on the card: one launch, exact against the plain version
    and the previous design; returns the counts."""
    from needle_tpu_torch.search import diag_runs as D

    args = [_t(a, dev) for a in (nv, mv, lm, thr, src, dst)] + [n_pad, _t(bm, dev)]
    before = D.LAUNCHES
    got = D.batch_counts(*args)
    torch.cuda.synchronize()
    assert D.LAUNCHES == before + 1
    assert torch.equal(got, D.batch_counts_reference(*args))
    assert torch.equal(got, D.batch_counts_popc(*args))
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
    rows took more than 48 KB of shared memory in the previous design) and
    32768 (whose rows do not fit at all) go through the same tile-by-tile
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
    and 64; exact against the plain version and the previous design."""
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


def test_kernel_equals_previous_design(dev):
    """batch_counts == batch_counts_popc on the season's shape (512 lanes
    at n_pad 2560); the previous design is counted apart."""
    from needle_tpu_torch.search import diag_runs as D

    rng = np.random.default_rng(2560)
    nv, mv, lm, thr, src, dst, bm = _planted_operands(
        rng, 2560, 512, (10, 0), (1, 81))
    args = [_t(a, dev) for a in (nv, mv, lm, thr, src, dst)] + [2560, _t(bm, dev)]
    before, before_popc = D.LAUNCHES, D.LAUNCHES_POPC
    got, prev = D.batch_counts(*args), D.batch_counts_popc(*args)
    torch.cuda.synchronize()
    assert (D.LAUNCHES, D.LAUNCHES_POPC) == (before + 1, before_popc + 1)
    assert torch.equal(got, prev)
    assert int((got > 0).sum()) >= 500


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
    flagging) taken and RunEntry-exact under the kernel, its previous
    design and the plain version; value errors and hashes hold."""
    from needle_tpu_torch import parity

    out = parity.run(["--device", "cuda", "--trials", "2", "--eps-seconds", "10"])
    assert out["ok"], out
    assert out["kernels"] == ["kernel", "previous", "plain"]
    assert sorted(out["routes"]) == sorted(parity.ROUTES)
    for route, r in out["routes"].items():
        assert r["exact"] and r["taken"], (route, r)
    assert out["routes"]["pair"]["launches"]["kernel"] > 0
