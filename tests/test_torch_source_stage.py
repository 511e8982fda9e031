"""The fused ingest's source stage (needle_tpu_torch/fingerprint/torch_impl.py),
on the CPU: a 48 kHz stereo WAV season, the input TV and disc episodes carry,
analyzed through the /4 half-band cascade and the downmix byte for byte as
needle_tpu analyzes it; the exact rescan's window stage, in int32 a channel
at a time, at full scale; the stage's counters of its work; and the raw-PCM
analyze where `resource` cannot count a thread's page faults."""

import resource
import shutil

import numpy as np
import pytest

from needle_bench import formats
from needle_tpu.analyzer import Analyzer as JaxAnalyzer
from needle_tpu.duration import Duration as JaxDuration
from needle_tpu.fingerprint import ingest_oracle as jax_oracle
from needle_tpu_torch import constants, ingest
from needle_tpu_torch.analyzer import Analyzer
from needle_tpu_torch.duration import Duration
from needle_tpu_torch.fingerprint import ingest_oracle as O
from needle_tpu_torch.fingerprint import torch_impl as T
from needle_tpu_torch.testing import make_synthetic_season
from needle_tpu_torch.tracing import metrics


def _season(root, rate, stereo, secs=60.0):
    """3 episodes with an opening and an ending at `rate`; with `stereo`,
    rewritten as the benchmark's wav_stereo format writes them."""
    paths, _, _ = make_synthetic_season(
        root, num_episodes=3, episode_secs=secs, opening_secs=15.0,
        opening_offset_range=(1.0, 4.0), ending_secs=8.0, rate=rate, seed=48)
    if stereo:
        fmt = formats.load(formats.find("wav_stereo"))
        for p in paths:
            samples, r, channels, _ = ingest.read_pcm_raw(p)
            assert (r, channels) == (rate, 1)
            fmt.write(p, samples, {"rate": rate, "channels": 2})
    return sorted(paths)


def _dat_files(paths, analyze):
    """{name: bytes} of the .needle.dat files that `analyze(paths)` writes."""
    analyze(paths)
    return {p.name: p.read_bytes()
            for p in sorted(paths[0].parent.glob("*.needle.dat"))}


def _port(paths):
    (Analyzer.from_files(paths, False, True, device="cpu").with_include_endings(True)
     .run(Duration.from_secs_f32(np.float32(constants.DEFAULT_HASH_DURATION)), True))


def _jax(paths):
    (JaxAnalyzer.from_files(paths, False, True).with_include_endings(True)
     .run(JaxDuration.from_secs_f32(np.float32(constants.DEFAULT_HASH_DURATION)), True))


def _same_as_jax(tmp_path, paths):
    ref = tmp_path / "jax"
    shutil.copytree(paths[0].parent, ref)
    want = _dat_files(sorted(ref.glob("*.wav")), _jax)
    got = _dat_files(paths, _port)
    assert len(got) == 3 and got == want


def _delta(before):
    after = metrics.snapshot()
    return {k: v[0] - before.get(k, (0.0, 0))[0] for k, v in after.items()
            if v[1] > before.get(k, (0.0, 0))[1]}


def test_48k_stereo_season_writes_needle_tpus_files(tmp_path):
    paths = _season(tmp_path / "torch", 48000, True)
    samples, rate, channels, _ = ingest.read_pcm_mmap(paths[0])
    assert (rate, channels) == (48000, 2)
    frames = np.asarray(samples).reshape(-1, 2).astype(np.int32)
    assert (frames[:, 0] != frames[:, 1]).any() and ((frames.sum(1) % 2) != 0).any()
    d = T.IngestDispatcher(48000, 2, "cpu")
    assert (d.dec_factor, d.mid_rate) == (4, 12000)
    _same_as_jax(tmp_path, paths)


def _noise(rng, n, amp=6000):
    return (rng.standard_normal(n) * amp).astype(np.int16)


@pytest.mark.parametrize("rate,channels,dec", [(48000, 2, 4), (16000, 1, 2)])
def test_stage_counts_its_work_from_the_valid_lengths(monkeypatch, rate, channels,
                                                      dec):
    """Three lanes of one bucket, two a chunk: a full chunk and a partial
    one, each lane's valid count short of its segment and odd in frames.
    No card time is recorded on the CPU."""
    monkeypatch.setattr(T, "LANES", 2)
    monkeypatch.setattr(T, "_staging", T._StagingRing())
    rng = np.random.default_rng(3)
    segs = [_noise(rng, rate * channels * 22) for _ in range(3)]
    n_valids = [len(s) - channels * (1000 + 2 * k + 1) for k, s in enumerate(segs)]
    d = T.IngestDispatcher(rate, channels, "cpu")
    assert d.dec_factor == dec
    assert len({d.lane_geometry(n)[1] for n in n_valids}) == 1
    before = metrics.snapshot()
    for i, (s, n) in enumerate(zip(segs, n_valids)):
        d.add(i, s, n)
    d.finish()
    got = _delta(before)
    frames = [n // channels for n in n_valids]
    assert got["ingest.source_frames"] == sum(frames)
    assert got["ingest.mid_samples"] == sum(f // dec for f in frames)
    assert got["ingest.lane_bytes"] == 2 * channels * sum(frames)
    assert "ingest.decimate_card_s" not in got and "ingest.kernels_card_s" not in got


@pytest.mark.parametrize("missing", ["RUSAGE_THREAD", "resource"])
def test_analyze_without_thread_fault_counts(tmp_path, monkeypatch, missing):
    """Where `resource` has no RUSAGE_THREAD (macOS) or there is no
    `resource` (Windows), the raw-PCM analyze writes needle_tpu's files and
    counts no faults."""
    paths = _season(tmp_path / "torch", 16000, False, secs=40.0)
    ref = tmp_path / "jax"
    shutil.copytree(paths[0].parent, ref)
    want = _dat_files(sorted(ref.glob("*.wav")), _jax)
    if missing == "resource":
        monkeypatch.setattr(T, "resource", None)
    else:
        monkeypatch.delattr(resource, "RUSAGE_THREAD")
    assert T._page_faults() is None
    before = metrics.snapshot()
    got = _dat_files(paths, _port)
    counted = _delta(before)
    assert len(got) == 3 and got == want
    assert "ingest.lane_copy_faults" not in counted and counted["ingest.lane_bytes"] > 0


@pytest.mark.parametrize("rate,channels,dec", [(48000, 2, 4), (16000, 1, 2)])
def test_rescan_window_is_exact_at_full_scale(rate, channels, dec):
    """The rescan's window stage (int32, each channel its own row) against
    needle_tpu's (int64, frames as rows) on full-scale input: runs of
    -32768 and 32767 of 1 to 12 frames, which drive every half-band stage's
    accumulator towards its bound."""
    rng = np.random.default_rng(7)
    frames = rate * 4

    def channel():
        runs = rng.integers(1, 13, size=frames)
        levels = np.where(rng.random(frames) < 0.5, -32768, 32767)
        return np.repeat(levels, runs)[:frames]

    seg = np.stack([channel() for _ in range(channels)], axis=1).reshape(-1).astype(np.int16)
    in_len_mid = frames // dec + 300
    args = (seg, len(seg) - 2 * channels * 1000 - 2 * channels, channels, dec, in_len_mid)
    for lo, hi in ((-50, 900), (4000, 12000), (in_len_mid - 2000, in_len_mid + 100)):
        got = O._prepare_mid_window(*args, lo, hi)
        want = jax_oracle._prepare_mid_window(*args, lo, hi)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.abs(O._ingest_prepare_mid(*args)).max() >= 16000
