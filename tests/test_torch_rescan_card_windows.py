"""The exact rescan fed the device's own mid-rate samples
(needle_tpu_torch/fingerprint/torch_impl.py::IngestDispatcher and
ingest_oracle.ingest_hashes_mid_oracle), on the CPU.

The windows that the dispatcher's worker takes from the source stage's
output must give bit for bit the hashes that the oracle gives from windows
it prepares on the host, on every route (/2 and /4, mono and stereo, with
and without a resample stage) and for ranges at the lane's start, at its
end, past its valid count and merged. With every hash flagged
(NEEDLE_TPU_EXACT_EPS=1e30), the dispatcher's hashes are the whole-lane
oracle's, the host never prepares a window itself, and the counters say
how many windows and bytes the rescan took from the device."""

import numpy as np
import pytest
import torch

from needle_tpu_torch.fingerprint import ingest_oracle as O
from needle_tpu_torch.fingerprint import plan
from needle_tpu_torch.fingerprint import torch_impl as T
from needle_tpu_torch.fingerprint.numpy_impl import merge_flag_ranges
from needle_tpu_torch.tracing import metrics

# (rate, channels, dec_factor, mid_rate)
ROUTES = [
    (16000, 1, 2, 8000),
    (48000, 2, 4, 12000),
    (44100, 2, 4, 11025),
    (22050, 1, 2, 11025),
    (11025, 1, 1, 11025),
]
SECS = (5, 9, 6)  # a full chunk of two lanes and a partial one


def _noise(rng, n, amp=6000):
    return (rng.standard_normal(n) * amp).astype(np.int16)


def _lanes(d, segs, n_valids):
    """The source stage's (B, in_len_mid) int16 output for segments of one
    frame bucket, staged as the dispatcher stages them, and the bucket."""
    nf_b = d.lane_geometry(n_valids[0])[1]
    assert all(d.lane_geometry(n)[1] == nf_b for n in n_valids)
    _, in_len, _ = plan._ingest_dims(d.mid_rate, nf_b)
    in_len *= d.channels * d.dec_factor
    raw = np.zeros((len(segs), in_len), np.int16)
    nv = np.zeros(len(segs), np.int32)
    for r, (s, n) in enumerate(zip(segs, n_valids)):
        nv[r] = min(n, in_len) // d.channels
        take = min(len(s), nv[r] * d.channels)
        raw[r, :take] = s[:take]
    mid = T._source_stage(torch.from_numpy(raw), torch.from_numpy(nv),
                          d.channels, d.dec_factor)
    return mid, nf_b


@pytest.mark.parametrize("rate,channels,dec,mid_rate", ROUTES)
def test_card_windows_give_the_host_oracles_hashes(rate, channels, dec, mid_rate):
    rng = np.random.default_rng(rate + channels)
    n = rate * channels * 10
    segs = [_noise(rng, n), _noise(rng, n)]
    # the second lane's valid count is odd in frames and short of its
    # segment: what lies past it must read as zeros
    n_valids = [n, n - channels * 2001]
    d = T.IngestDispatcher(rate, channels, "cpu")
    assert (d.dec_factor, d.mid_rate) == (dec, mid_rate)
    mid, nf_b = _lanes(d, segs, n_valids)
    assert mid.dtype == torch.int16
    _, in_len_mid, _ = plan._ingest_dims(mid_rate, nf_b)
    assert mid.shape == (2, in_len_mid)
    for r, (seg, n_valid) in enumerate(zip(segs, n_valids)):
        n_sub = d.lane_geometry(n_valid)[0]
        n_bucket = nf_b - 19  # the hashes the bucket's frames give
        assert n_sub + 4 <= n_bucket
        merged = merge_flag_ranges(np.r_[7, 30, 31, 40])
        assert merged == [(7, 8), (30, 41)]
        ranges = [(0, 2)] + merged + [(n_sub - 2, n_sub), (n_sub - 1, n_sub + 4),
                                      (n_bucket - 3, n_bucket)]
        rows = O.rescan_mid_rows(mid_rate, nf_b, ranges)
        assert rows[0][0] <= 0 and rows[-1][1] > n_valid // channels // dec
        windows = d._fetch_windows(mid, [(r, lo, hi) for lo, hi in rows], None)
        for (lo, hi), w in zip(rows, windows):
            want = O._prepare_mid_window(seg, n_valid, channels, dec, in_len_mid,
                                         lo, hi)
            assert w.dtype == np.int16 and np.array_equal(w, want)
        got = O.ingest_hashes_mid_oracle(windows, mid_rate, nf_b, ranges)
        want = O.ingest_hashes_ranges_oracle(seg, n_valid, rate, channels, dec,
                                             nf_b, ranges)
        assert len(got) == len(ranges)
        for (lo, hi), g, w in zip(ranges, got, want):
            assert g.dtype == np.uint32 and len(g) == hi - lo
            np.testing.assert_array_equal(g, w)


def _delta(before):
    after = metrics.snapshot()
    return {k: (v[0] - before.get(k, (0.0, 0))[0], v[1] - before.get(k, (0.0, 0))[1])
            for k, v in after.items() if v[1] > before.get(k, (0.0, 0))[1]}


@pytest.mark.parametrize("threading_", [True, False])
@pytest.mark.parametrize("rate,channels", [(16000, 1), (48000, 2)])
def test_every_hash_rescanned_from_the_card(monkeypatch, rate, channels,
                                            threading_):
    """Two lanes a chunk, every hash flagged: the hashes are the whole-lane
    oracle's, no window is prepared on the host, one window is taken from
    the device for each lane (its flags merge into one range) and one
    fetch is made for each chunk."""
    monkeypatch.setattr(T, "LANES", 2)
    monkeypatch.setenv("NEEDLE_TPU_EXACT_EPS", "1e30")
    prepared = []
    prepare = O._prepare_mid_window

    def spy(*args, **kw):
        prepared.append(args)
        return prepare(*args, **kw)

    monkeypatch.setattr(O, "_prepare_mid_window", spy)
    rng = np.random.default_rng(29)
    segs = [_noise(rng, rate * channels * s) for s in SECS]
    d = T.IngestDispatcher(rate, channels, "cpu", threading=threading_)
    before = metrics.snapshot()
    for i, s in enumerate(segs):
        d.add(i, s)
    got = d.finish()
    counted = _delta(before)
    assert prepared == []
    window_bytes, n_chunks = 0, 0
    buckets = {}
    for i, s in enumerate(segs):
        n_sub, nf_b = d.lane_geometry(len(s))
        buckets.setdefault(nf_b, []).append(i)
        want = O.ingest_hashes_full_oracle(s, len(s), rate, channels,
                                           d.dec_factor, nf_b, n_sub)
        np.testing.assert_array_equal(got[i], want)
        (lo, hi), = O.rescan_mid_rows(d.mid_rate, nf_b, [(0, n_sub)])
        window_bytes += 2 * (hi - lo)
    n_chunks = sum(-(-len(v) // T.LANES) for v in buckets.values())
    assert n_chunks >= 2
    assert counted["ingest.rescan_card_windows"] == (len(segs), n_chunks)
    assert counted["ingest.rescan_window_bytes"] == (window_bytes, n_chunks)
    assert window_bytes > 0
    assert counted["ingest.rescan_fetch"][1] == n_chunks
    assert counted["ingest.rescan_oracle"][1] == n_chunks
    assert counted["ingest.rescan_hashes"][0] == sum(len(g) for g in got.values())


def test_no_flags_fetch_nothing(monkeypatch):
    """With no hash flagged, nothing is fetched and the source stage's
    output is let go all the same."""
    monkeypatch.setattr(T, "LANES", 2)
    monkeypatch.setenv("NEEDLE_TPU_EXACT_EPS", "-1")
    rng = np.random.default_rng(31)
    segs = [_noise(rng, 16000 * s) for s in SECS]
    d = T.IngestDispatcher(16000, 1, "cpu", threading=False)
    before = metrics.snapshot()
    for i, s in enumerate(segs):
        d.add(i, s)
    kept = [chunk[2] for chunk, _ in d._chunks]
    assert kept and all(len(m) == 1 for m in kept)
    d.finish()
    counted = _delta(before)
    assert all(m == [] for m in kept)
    assert counted["ingest.rescan_hashes"][0] == 0
    for name in ("ingest.rescan_fetch", "ingest.rescan_card_windows",
                 "ingest.rescan_window_bytes"):
        assert name not in counted
